// Flash-decoding on Hopper (sm_90a): one query token per sequence against
// a (B, T, Hkv, D) KV cache under a boolean validity mask.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention_grouped.
// Same arithmetic: the G query heads that share a kv head form one (G, D)
// tile, scores are scaled by D^-0.5, (m, l, acc) run in fp32, p is zeroed
// where a slot is invalid, and a row with no valid slot gives 0 (l == 0
// divides by 1).
//
// What bounds it on the H100: the bytes of the cache's valid slots. At
// B = 8, T = 2048, Hkv = 8, D = 128 in bf16 the whole of K and V is 67 MB,
// about 20 us at 3.35 TB/s, against about 0.1 GFLOP. Both paths are
// flash-decoding in two passes: pass 1 has one block per (b, kv head,
// chunk of slots), so the cache is read once for all G heads and enough
// blocks are in flight to fill the 132 SMs even at small B * Hkv; pass 2
// merges the chunks' partials and normalises, one block per query head.
// The cache is read through its strides (no transposed copy).
//
// bf16 (what the model serves): tensor cores fed by asynchronous copies;
// see namespace bf16mma below. fp32: CUDA-core FMAs, kept as they were so
// that its outputs stay bit for bit (no TF32). Its four warps take tiles of
// 32 slots (one slot per lane), q pre-scaled in fp32; a lane holds the
// (m, l, acc) of at most GMAX = 8 heads in registers, so a wider group
// (RecurrentGemma's 16) is walked in head groups of 8 inside the block.
#include "common.cuh"

namespace {

constexpr int NW = 4;       // warps per block
constexpr int GMAX = 8;     // most query heads per block
constexpr int GTOT = 16;    // most query heads per kv head
constexpr int TK = 32;      // slots per warp tile: one per lane

struct Args {
  long long sqb, sqh;         // q (B,1,H,D)
  long long skb, skt, skh;    // k cache (B,T,Hkv,D)
  long long svb, svt, svh;    // v cache (B,T,Hkv,D)
  long long smb;              // valid (B,T), unit T stride
  long long sob, soh;         // o (B,1,H,D)
  int T, Hkv, G;
  int chunk, nsplit;          // slots per split block, splits per (b, hk)
  float scale;
  int q_aligned;              // q rows 16-byte aligned (bf16 path)
};

// 16 bytes of an fp32 row
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

template <int D>
struct F32Smem {
  float qs[GMAX][D];
  float wm[NW][GMAX];
  float wl[NW][GMAX];
  float wacc[NW][GMAX][D];
};

// Pass 1, fp32, for the heads g0 .. g0 + GMAX - 1 of block (b*Hkv + hk,
// split): streams the chunk of slots and writes the unnormalised (m, l,
// acc) of each of those heads to the partials.
template <int D>
__device__ __forceinline__ void decode_partial_group(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ valid,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, const Args& a, int g0, F32Smem<D>& sm) {
  constexpr int DPL = D / 32;              // output dims per lane
  constexpr int VL = 4;                    // elements per 16-byte load
  constexpr int VJ = D >= 256 ? 4 : 8;     // V rows loaded together in P.V
  auto& qs = sm.qs;
  auto& wm = sm.wm;
  auto& wl = sm.wl;
  auto& wacc = sm.wacc;

  const int bh = blockIdx.x;
  const int b = bh / a.Hkv;
  const int hk = bh % a.Hkv;
  const int G = min(GMAX, a.G - g0);       // heads of this group
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    qs[g][d] = q[b * a.sqb + (hk * a.G + g0 + g) * a.sqh + d] * a.scale;
  }
  __syncthreads();

  float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = REPRO_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const float* kbase = k + b * a.skb + hk * a.skh;
  const float* vbase = v + b * a.svb + hk * a.svh;
  const uint8_t* vrow = valid + b * a.smb;
  const int lo = blockIdx.y * a.chunk;
  const int hi = min(lo + a.chunk, a.T);
  for (int t0 = lo + warp * TK; t0 < hi; t0 += NW * TK) {
    const int t = t0 + lane;
    const bool ok = t < hi && vrow[t] != 0;
    const unsigned live = __ballot_sync(REPRO_FULL_MASK, ok);
    if (live == 0u) continue;              // warp-uniform: nothing valid
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (ok) {
      const float* kr = kbase + t * a.skt;
#pragma unroll 8
      for (int c = 0; c < D; c += VL) {
        float kv[VL];
        load16(kr + c, kv);
#pragma unroll
        for (int e = 0; e < VL; ++e) {
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) s[g] = fmaf(qs[g][c + e], kv[e], s[g]);
        }
      }
    }
    float p[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      const float sg = ok ? s[g] : REPRO_NEG_INF;
      const float m_new = fmaxf(m[g], repro_warp_max(sg));
      p[g] = ok ? expf(sg - m_new) : 0.f;
      const float alpha = expf(m[g] - m_new);
      l[g] = alpha * l[g] + repro_warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
    }
    // P.V: VJ rows of V in flight at once, rows of invalid slots unread
#pragma unroll
    for (int j0 = 0; j0 < TK; j0 += VJ) {
      if (((live >> j0) & ((1u << VJ) - 1u)) == 0u) continue;
      float vv[VJ][DPL];
#pragma unroll
      for (int jj = 0; jj < VJ; ++jj) {
        const bool lj = (live >> (j0 + jj)) & 1u;
        const float* vr = vbase + (t0 + j0 + jj) * a.svt + lane;
#pragma unroll
        for (int i = 0; i < DPL; ++i) vv[jj][i] = lj ? vr[32 * i] : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < VJ; ++jj) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) break;
          const float pj = __shfl_sync(REPRO_FULL_MASK, p[g], j0 + jj);
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            acc[g][i] = fmaf(pj, vv[jj][i], acc[g][i]);
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) wacc[warp][g][lane + 32 * i] = acc[g][i];
  }
  __syncthreads();

  // merge the warps; the block's partial keeps its own running max
  const long long base = (static_cast<long long>(bh) * a.nsplit +
                          blockIdx.y) * a.G + g0;
  for (int i = tid; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w][g]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(wm[w][g] - mx);
      lsum = fmaf(c, wl[w][g], lsum);
      out = fmaf(c, wacc[w][g][d], out);
    }
    part_acc[(base + g) * D + d] = out;
    if (d == 0) {
      part_m[base + g] = mx;
      part_l[base + g] = lsum;
    }
  }
}

// Pass 1, fp32: block (b*Hkv + hk, split) walks the G heads in groups of at
// most GMAX, each group's arithmetic as in a block of its own.
template <int D>
__global__ void __launch_bounds__(NW * 32)
decode_partial_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, Args a) {
  __shared__ F32Smem<D> sm;
  for (int g0 = 0; g0 < a.G; g0 += GMAX) {
    if (g0 > 0) __syncthreads();           // the last group's smem is read
    decode_partial_group<D>(q, k, v, valid, part_m, part_l, part_acc, a, g0,
                            sm);
  }
}

// Pass 2: block (b*Hkv + hk, g) merges the splits of query head g and
// normalises; a row with no valid slot has l == 0 and gives 0. One block
// per head, not per (b, hk): at RecurrentGemma's B * Hkv = 8 the merge of
// 16 heads of 256 would otherwise run on 8 blocks. A thread's partials of
// the first PRE splits are loaded before the splits' weights are known, so
// the two rounds of loads overlap; the weights are formed once, by warp 0,
// and every sum runs over the splits in order.
template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      T* __restrict__ o, Args a) {
  constexpr int PRE = 16;                  // splits held in registers
  constexpr int DPT = (D + NW * 32 - 1) / (NW * 32);   // outputs a thread
  extern __shared__ float wsplit[];        // [nsplit] m, then weights
  float* lsplit = wsplit + a.nsplit;       // [nsplit] l
  __shared__ float lsum_s;
  const int bh = blockIdx.x;
  const int b = bh / a.Hkv;
  const int hk = bh % a.Hkv;
  const int G = a.G;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(bh) * a.nsplit * G + g;
  float pre[DPT][PRE];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = tid + j * NW * 32;
#pragma unroll
    for (int sp = 0; sp < PRE; ++sp)
      pre[j][sp] = d < D && sp < a.nsplit
                       ? part_acc[(base + sp * G) * D + d] : 0.f;
  }
  for (int sp = tid; sp < a.nsplit; sp += NW * 32) {
    wsplit[sp] = part_m[base + sp * G];
    lsplit[sp] = part_l[base + sp * G];
  }
  __syncthreads();
  if (tid < 32) {
    float mx = REPRO_NEG_INF;
    for (int sp = tid; sp < a.nsplit; sp += 32) mx = fmaxf(mx, wsplit[sp]);
    mx = repro_warp_max(mx);
    for (int sp = tid; sp < a.nsplit; sp += 32)
      wsplit[sp] = expf(wsplit[sp] - mx);
    __syncwarp();
    if (tid == 0) {
      float lsum = 0.f;
      for (int sp = 0; sp < a.nsplit; ++sp)
        lsum = fmaf(wsplit[sp], lsplit[sp], lsum);
      lsum_s = lsum == 0.f ? 1.f : lsum;   // no valid slot: output 0
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = tid + j * NW * 32;
    if (d >= D) break;
    float out = 0.f;
#pragma unroll
    for (int sp = 0; sp < PRE; ++sp)
      if (sp < a.nsplit) out = fmaf(wsplit[sp], pre[j][sp], out);
    for (int sp = PRE; sp < a.nsplit; ++sp)
      out = fmaf(wsplit[sp], part_acc[(base + sp * G) * D + d], out);
    o[b * a.sob + (hk * G + g) * a.soh + d] =
        repro_from_float<T>(out / lsum_s);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores fed by asynchronous copies
// ---------------------------------------------------------------------------
//
// The G query heads of a kv head are the M rows of mma.m16n8k16, padded to
// 16 with zero rows, so one pass over the cache serves all of them (G <=
// 16: llama3-3b's 3 and RecurrentGemma's 16 alike). Slots are the N (and,
// for P V, the K) dimension. A block of NW warps takes one chunk of slots
// of one (b, kv head):
//
// - It reads the chunk's validity once and lists its 16-slot tiles that
//   hold a valid slot; a tile with none is never loaded.
// - Stages of NW listed tiles (one per warp) reach shared memory through
//   16-byte cp.async copies into a ring of NST stages (as many as the chunk
//   has, up to NST_MAX; one stage loads, waits and computes in turn),
//   neighbouring threads on neighbouring 16 bytes of a row. Invalid slots
//   inside a listed tile are zero-filled by the copy (src-size 0), not
//   read. Rows are padded by 16 bytes so the ldmatrix reads of 8 rows hit
//   8 distinct bank groups.
// - Each warp forms its tile's S = Q K^T (16 x 16) from ldmatrix fragments,
//   scales it in fp32 (a q pre-scaled in bf16 would round the scale into q
//   and miss the kernel checks' relative L2 of 1e-3 at D 128), selects
//   -1e30 at invalid slots, and updates its own running (m, l, acc); p is 0
//   at invalid slots. P enters P V as hi = bf16(P) plus lo = bf16(P - hi),
//   two MMAs into one fp32 accumulator (one bf16 P also misses 1e-3); l
//   sums the fp32 P.
// - After the chunk the warps' (m, l, acc) merge through shared memory
//   (the ring's space) into the block's partial, which pass 2 merges.
//
// Registers: acc is 16 x D fp32 over a warp, D / 2 a lane (128 at D 256);
// Q's fragments are read from shared memory per tile, not held.

namespace bf16mma {

constexpr int NW = 4;                // warps per block
constexpr int WT = 16;               // slots per warp tile
constexpr int ST = NW * WT;          // slots per stage
constexpr int CHUNK_MAX = 1024;      // most slots per block
constexpr int MAXT = CHUNK_MAX / WT; // most tiles per block

// most stages of the K/V ring, by head dim: at D 128 two stages leave room
// for three blocks on an SM, which ran faster on the H100 than two blocks
// of three stages (tools/tune_attention.py's decode shapes)
template <int D>
constexpr int NST_MAX = D == 128 ? 2 : 3;

__host__ __device__ constexpr size_t cmax(size_t x, size_t y) {
  return x > y ? x : y;
}

template <int D>  // a padded row, in elements
__host__ __device__ constexpr int ld() { return D + 8; }

// the warps' partials, in the ring's space once the chunk is done
template <int D>
__host__ __device__ constexpr int wld() { return D + 4; }

// the ring of NST stages, or the warps' partials if those take more
template <int D, int NST>
__host__ __device__ constexpr size_t ring_bytes() {
  return cmax(sizeof(__nv_bfloat16) * 2 * NST * ST * ld<D>(),
              sizeof(float) * (NW * 16 * (wld<D>() + 3) + 32));
}

template <int D, int NST>
constexpr size_t smem_bytes() {
  return ring_bytes<D, NST>() + sizeof(__nv_bfloat16) * 16 * ld<D>() +
         CHUNK_MAX + sizeof(int) * (MAXT + 1);
}

template <int D, int NST>
__global__ void __launch_bounds__(NW * 32)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, Args a) {
  constexpr int LD = ld<D>();
  constexpr int CPR = D / 8;         // 16-byte chunks per row
  constexpr int NT = D / 8;          // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + NST * ST * LD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ring_bytes<D, NST>());                      // [16][LD]
  uint8_t* vflag = reinterpret_cast<uint8_t*>(qs + 16 * LD); // [CHUNK_MAX]
  int* tiles = reinterpret_cast<int*>(vflag + CHUNK_MAX);  // [MAXT]
  int* ntiles = tiles + MAXT;

  const int bh = blockIdx.x;
  const int b = bh / a.Hkv;
  const int hk = bh % a.Hkv;
  const int G = a.G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int lo = blockIdx.y * a.chunk;
  const int n = min(a.chunk, a.T - lo);                   // slots here
  const int nt = (n + WT - 1) / WT;

  // q: the group's G rows, zero rows up to 16
  for (int i = tid; i < 16 * CPR; i += NW * 32) {
    const int r = i / CPR, c = i % CPR;
    repro_copy16(qs + r * LD + c * 8,
                 q + b * a.sqb + (hk * G + min(r, G - 1)) * a.sqh + c * 8,
                 r < G, a.q_aligned);
  }
  repro_cp_async_commit();
  // the chunk's validity, zero past its end up to a whole tile
  const uint8_t* vrow = valid + b * a.smb + lo;
  for (int i = tid; i < nt * WT; i += NW * 32)
    vflag[i] = i < n ? vrow[i] : 0;
  __syncthreads();
  if (warp == 0) {                   // list the tiles with a valid slot
    int cnt = 0;
    for (int base = 0; base < nt; base += 32) {
      const int j = base + lane;
      bool live = false;
      if (j < nt) {
        const uint4 f = *reinterpret_cast<const uint4*>(vflag + j * WT);
        live = (f.x | f.y | f.z | f.w) != 0u;
      }
      const unsigned bal = __ballot_sync(REPRO_FULL_MASK, live);
      if (live) tiles[cnt + __popc(bal & ((1u << lane) - 1u))] = j;
      cnt += __popc(bal);
    }
    if (lane == 0) *ntiles = cnt;
  }
  __syncthreads();
  const int nlive = *ntiles;
  const int nstage = (nlive + NW - 1) / NW;

  const __nv_bfloat16* kb = k + b * a.skb + hk * a.skh;
  const __nv_bfloat16* vb = v + b * a.svb + hk * a.svh;
  auto load_stage = [&](int s) {
    __nv_bfloat16* kd = ks + (s % NST) * ST * LD;
    __nv_bfloat16* vd = vs + (s % NST) * ST * LD;
    for (int i = tid; i < ST * CPR; i += NW * 32) {
      const int r = i / CPR, c = i % CPR;
      const int ti = s * NW + r / WT;
      if (ti >= nlive) break;        // rows only grow with i
      const int rel = tiles[ti] * WT + r % WT;
      const bool ok = vflag[rel] != 0;
      const long long t = lo + (ok ? rel : 0);
      repro_cp_async16(kd + r * LD + c * 8, kb + t * a.skt + c * 8, ok);
      repro_cp_async16(vd + r * LD + c * 8, vb + t * a.svt + c * 8, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nstage) load_stage(s);
    repro_cp_async_commit();
  }

  float m_a = REPRO_NEG_INF, m_b = REPRO_NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int s = 0; s < nstage; ++s) {
    if constexpr (NST == 1) {        // load, wait, compute, one at a time
      if (s > 0) __syncthreads();    // stage s - 1 consumed
      load_stage(s);
      repro_cp_async_commit();
      repro_cp_async_wait<0>();
      __syncthreads();
    } else {
      repro_cp_async_wait<NST - 2>();
      __syncthreads();               // stage s landed; stage s - 1 consumed
      if (s + NST - 1 < nstage) load_stage(s + NST - 1);
      repro_cp_async_commit();
    }
    const int ti = s * NW + warp;
    if (ti >= nlive) continue;       // warp-uniform: no tile for this warp
    const __nv_bfloat16* kt = ks + ((s % NST) * ST + warp * WT) * LD;
    const __nv_bfloat16* vt = vs + ((s % NST) * ST + warp * WT) * LD;
    const int rel0 = tiles[ti] * WT;

    float sc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4], kf[4];
      repro_ldsm_x4(qf, qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      repro_ldsm_x4(kf, kt + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
      repro_mma_bf16(sc[0], qf, kf[0], kf[1]);
      repro_mma_bf16(sc[1], qf, kf[2], kf[3]);
    }
    // this lane's slots: rel0 + 8j + 2 tig + (e & 1); rows gid and gid + 8
    bool ok[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ok[j][0] = vflag[rel0 + 8 * j + 2 * tig] != 0;
      ok[j][1] = vflag[rel0 + 8 * j + 2 * tig + 1] != 0;
    }
    float mx_a = REPRO_NEG_INF, mx_b = REPRO_NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = ok[j][e & 1] ? sc[j][e] * a.scale : REPRO_NEG_INF;
        sc[j][e] = sv;
        if (e < 2) mx_a = fmaxf(mx_a, sv); else mx_b = fmaxf(mx_b, sv);
      }
    }
    const float mn_a = fmaxf(m_a, repro_quad_max(mx_a));
    const float mn_b = fmaxf(m_b, repro_quad_max(mx_b));
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            ok[j][e & 1] ? expf(sc[j][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
        sc[j][e] = p;
        if (e < 2) ps_a += p; else ps_b += p;
      }
    }
    l_a = al_a * l_a + ps_a;         // per-lane partial; quad-summed below
    l_b = al_b * l_b + ps_b;
    uint32_t ph[4], pl[4];
    repro_p_frags(sc[0], sc[1], ph, pl);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];
      repro_ldsm_x4_trans(vf, vt + (lane & 15) * LD + dp * 16 +
                                  (lane >> 4) * 8);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float (&c)[4] = acc[2 * dp + h2];
        c[0] *= al_a;
        c[1] *= al_a;
        c[2] *= al_b;
        c[3] *= al_b;
        repro_mma_bf16(c, ph, vf[2 * h2], vf[2 * h2 + 1]);
        repro_mma_bf16(c, pl, vf[2 * h2], vf[2 * h2 + 1]);
      }
    }
  }
  repro_cp_async_wait<0>();
  __syncthreads();                   // the ring is free: merge the warps
  constexpr int WLD = wld<D>();
  float* wacc = reinterpret_cast<float*>(smem_raw);       // [NW][16][WLD]
  float* wm = wacc + NW * 16 * WLD;                       // [NW][16]
  float* wl = wm + NW * 16;                               // [NW][16]
  l_a = repro_quad_sum(l_a);
  l_b = repro_quad_sum(l_b);
  float* wa = wacc + (warp * 16 + gid) * WLD + 2 * tig;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<float2*>(wa + j * 8) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(wa + 8 * WLD + j * 8) =
        make_float2(acc[j][2], acc[j][3]);
  }
  if (tig == 0) {
    wm[warp * 16 + gid] = m_a;
    wm[warp * 16 + gid + 8] = m_b;
    wl[warp * 16 + gid] = l_a;
    wl[warp * 16 + gid + 8] = l_b;
  }
  __syncthreads();
  // the block's partial: each row's weights of the warps, once
  float* wt = wl + NW * 16;                               // [NW][16]
  float* bm = wt + NW * 16;                               // [16]
  float* bl = bm + 16;                                    // [16]
  if (tid < 16) {
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * 16 + tid]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(wm[w * 16 + tid] - mx);
      wt[w * 16 + tid] = c;
      lsum = fmaf(c, wl[w * 16 + tid], lsum);
    }
    bm[tid] = mx;
    bl[tid] = lsum;
  }
  __syncthreads();
  const long long base =
      (static_cast<long long>(bh) * a.nsplit + blockIdx.y) * G;
  for (int i = tid; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float out = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      out = fmaf(wt[w * 16 + g], wacc[(w * 16 + g) * WLD + d], out);
    part_acc[(base + g) * D + d] = out;
  }
  if (tid < G) {
    part_m[base + tid] = bm[tid];
    part_l[base + tid] = bl[tid];
  }
}

template <int D, int NST>
cudaError_t launch_nst(const void* q, const void* k, const void* v,
                       const void* valid, float* part_m, float* part_l,
                       float* part_acc, int B, const Args& a,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, NST>();
  static bool optin[REPRO_MAX_DEVICES] = {};
  cudaError_t err = repro_smem_optin(decode_mma_kernel<D, NST>, smem, optin);
  if (err != cudaSuccess) return err;
  decode_mma_kernel<D, NST>
      <<<dim3(B * a.Hkv, a.nsplit), NW * 32, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const uint8_t*>(valid), part_m, part_l, part_acc, a);
  return cudaGetLastError();
}

// The ring's depth: as many stages as the chunk has, up to NST_MAX; a
// shallower ring leaves room for more blocks on an SM.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, float* part_m, float* part_l,
                   float* part_acc, int B, const Args& a,
                   cudaStream_t stream) {
  const int stages = min(a.chunk / ST, NST_MAX<D>);
  if (stages == 1)
    return launch_nst<D, 1>(q, k, v, valid, part_m, part_l, part_acc, B, a,
                            stream);
  if (stages == 2)
    return launch_nst<D, 2>(q, k, v, valid, part_m, part_l, part_acc, B, a,
                            stream);
  return launch_nst<D, 3>(q, k, v, valid, part_m, part_l, part_acc, B, a,
                          stream);
}

}  // namespace bf16mma

// The partials of pass 1 in the caller's scratch: B * Hkv * nsplit * G
// rows of m, then of l, then of acc (D floats a row).
struct Partials {
  float *m, *l, *acc;
};

// Pass 2, after either first pass.
template <typename T, int D>
cudaError_t combine(const Partials& p, void* o, int B, const Args& a,
                    cudaStream_t stream) {
  decode_combine_kernel<T, D>
      <<<dim3(B * a.Hkv, a.G), NW * 32, 2 * sizeof(float) * a.nsplit,
         stream>>>(p.m, p.l, p.acc, static_cast<T*>(o), a);
  return cudaGetLastError();
}

// fp32: pass 1 on CUDA cores, then the merge
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* valid, void* o, const Partials& p, int B,
                       const Args& a, cudaStream_t stream) {
  decode_partial_kernel<D><<<dim3(B * a.Hkv, a.nsplit), NW * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(valid), p.m,
      p.l, p.acc, a);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : combine<float, D>(p, o, B, a, stream);
}

// bf16: pass 1 on tensor cores, then the merge
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* valid, void* o, const Partials& p, int B,
                        const Args& a, cudaStream_t stream) {
  const cudaError_t err =
      bf16mma::launch<D>(q, k, v, valid, p.m, p.l, p.acc, B, a, stream);
  return err != cudaSuccess ? err
                            : combine<__nv_bfloat16, D>(p, o, B, a, stream);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q (B,1,H,D); k/v (B,T,Hkv,D) caches; valid (B,T) bytes (torch.bool);
// o (B,1,H,D); part: fp32 scratch of B*Hkv*nsplit*G*(D+2) floats. D stride
// 1 everywhere, K/V rows 16-byte aligned; strides in elements. D is 64,
// 128 or 256, H / Hkv at most 16; nsplit * chunk >= T, chunk a multiple of
// 128 (fp32) or of 64 and at most 1024 (bf16); dtype REPRO_F32/REPRO_BF16.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* part, int dtype, int B, int T, int H, int Hkv, int D, int chunk,
    int nsplit, long long sqb, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh,
    long long smb, long long sob, long long soh, float scale, void* stream) {
  const bool chunk_ok =
      dtype == REPRO_F32
          ? chunk % (NW * TK) == 0
          : chunk % bf16mma::ST == 0 && chunk <= bf16mma::CHUNK_MAX;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > GTOT || T <= 0 || B <= 0 ||
      chunk <= 0 || !chunk_ok || static_cast<long long>(chunk) * nsplit < T ||
      static_cast<long long>(chunk) * (nsplit - 1) >= T)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                        (sqb * 2) % 16 == 0 && (sqh * 2) % 16 == 0;
  Args a{sqb, sqh, skb, skt, skh, svb, svt, svh, smb, sob, soh,
         T, Hkv, H / Hkv, chunk, nsplit, scale, q_aligned};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * Hkv * nsplit * a.G;
  float* pf = static_cast<float*>(part);
  const Partials p{pf, pf + rows, pf + 2 * rows};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == REPRO_F32) {
    if (D == 64) err = launch_f32<64>(q, k, v, valid, o, p, B, a, st);
    if (D == 128) err = launch_f32<128>(q, k, v, valid, o, p, B, a, st);
    if (D == 256) err = launch_f32<256>(q, k, v, valid, o, p, B, a, st);
  } else if (dtype == REPRO_BF16) {
    if (D == 64) err = launch_bf16<64>(q, k, v, valid, o, p, B, a, st);
    if (D == 128) err = launch_bf16<128>(q, k, v, valid, o, p, B, a, st);
    if (D == 256) err = launch_bf16<256>(q, k, v, valid, o, p, B, a, st);
  }
  return static_cast<int>(err);
}
