// MLA decode in the latent space on Hopper (sm_90a): one query token per
// sequence, its H <= 16 heads already taken into the latent space, against
// the latent cache (B, T, R) and the shared rope keys (B, T, RP) under a
// boolean validity mask. A second entry, mla_decode_wide_fwd (namespace wide
// below), takes up to 128 heads in bf16.
//
// Replaces no Pallas kernel. The JAX package computes MLA decode with
// einsums that up-project every cached latent through w_uk and w_uv
// (src/repro/models/attention.py::mla_decode), and the port did the same
// (models/attention.py _mla_up, then the fp32 casts of _mla_logits and
// _mla_scores): each layer wrote and read K and V of (B, T, H, 128) in bf16
// and again in fp32. The caller now absorbs w_uk into the query and w_uv
// into the output (DeepSeek-V2, arXiv:2405.04434 §2.1.2), so attention runs
// over the (R + RP)-wide latent rows, one key and value that every head
// shares (MQA in the latent space): s = (q_lat . c_kv + q_rope . k_rope) *
// scale in fp32, o_lat = softmax(s) . c_kv, R wide.
//
// What bounds it on the H100: the bytes of the valid latent rows. At
// deepseek-v2-lite's R 512 + RP 64 in bf16 a row is 1152 bytes, and 32 rows
// of 2048 slots are 75.5 MB a layer, 23 us at 3.35 TB/s, against about
// 16 x (576 + 2 x 512) x 2 flops a slot (about 44 flops a byte, far under
// the ~295 a byte at which bf16 tensor cores bound). So every valid latent
// row is read from device memory once, for all heads, as key and as value,
// and a 16-slot tile with no valid slot is never read.
//
// Flash-decoding in two passes, as csrc/decode_attention.cu, behind a
// listing pass. The work is the batch's live tiles (16 slots of a row with
// a valid one), which the rows' contexts share out unevenly: at the
// benchmark's `normal` mix the longest of 32 rows holds 1.8 times the
// mean. So the list pass (one block a row) lists each row's live tiles in
// order and counts them, and pass 1 cuts the batch's N live tiles, row
// after row, into G equal runs, one a block (G: a block an SM): block g
// takes ordinals [g N / G, (g + 1) N / G), which may end one row and start
// the next. For each row it touches it leaves one partial (m, l, acc) at
// index g + row (unique: a later block touches no earlier row), and the
// blocks that hold a row's first and last live tiles record themselves.
// Pass 2 merges each row's partials and normalises, one block per (row,
// head); a row with no valid slot gives 0.
//
// bf16 (what the model serves): tensor cores, namespace tc below. fp32 (the
// checks of a model run in fp32): CUDA-core FMAs, namespace f32.
#include "common.cuh"

namespace {

constexpr int WT = 16;             // slots per tile
constexpr int HMAX = 16;           // most heads: the rows of one MMA tile
constexpr int TMAX = 32768;        // most slots a row
constexpr int NTILE_MAX = TMAX / WT;
constexpr int BMAX = 1024;         // most rows
constexpr int MAXT = 64;           // most live tiles a block takes
constexpr int GMAX = 4096;         // most blocks: the merge's 2 G floats
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  long long sqb, sqh;      // q (B, H, R + RP), unit last stride
  long long scb, sct;      // c_kv (B, T, R)
  long long srb, srt;      // k_rope (B, T, RP)
  long long smb;           // valid (B, T), unit T stride
  long long sob, soh;      // o (B, H, R)
  int B, T, H, R, RP, G;   // G: blocks of pass 1
  float scale;
};

// The validity of slots 16 j .. 16 j + 15 of a row as a mask (bit i: slot
// 16 j + i is valid); no bit past T.
__device__ __forceinline__ uint32_t tile_mask(const uint8_t* vrow, int j,
                                              int T, bool aligned) {
  uint32_t m = 0u;
  const int t0 = j * WT;
  if (aligned && t0 + WT <= T) {
    const uint4 f = *reinterpret_cast<const uint4*>(vrow + t0);
    const uint32_t w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((w[k] >> (8 * e)) & 0xffu) m |= 1u << (4 * k + e);
  } else {
    for (int i = 0; i < WT && t0 + i < T; ++i)
      if (vrow[t0 + i]) m |= 1u << i;
  }
  return m;
}

// The list pass: block b lists row b's live tiles in order,
// list[b * ntile + k] = tile | mask << 16 for the k-th, and counts them;
// it marks the row's range of first-pass blocks empty (first 0, last -1)
// and, with the other blocks, zeroes every partial's l (a pair of block
// and row that no run makes keeps l = 0, which the merge skips).
__device__ __forceinline__ void list_body(const uint8_t* __restrict__ valid,
                                          int* __restrict__ counts,
                                          int* __restrict__ first,
                                          int* __restrict__ last,
                                          int* __restrict__ list,
                                          float* __restrict__ part_l,
                                          const Args& a) {
  __shared__ uint16_t masks[NTILE_MAX];
  const int b = blockIdx.x;
  const long long nl = static_cast<long long>(a.G + a.B) * a.H;
  for (long long i = static_cast<long long>(b) * blockDim.x + threadIdx.x;
       i < nl; i += static_cast<long long>(a.B) * blockDim.x)
    part_l[i] = 0.f;
  const int ntile = (a.T + WT - 1) / WT;
  const uint8_t* vrow = valid + b * a.smb;
  const bool aligned = reinterpret_cast<uintptr_t>(vrow) % 16 == 0;
  for (int j = threadIdx.x; j < ntile; j += blockDim.x)
    masks[j] = static_cast<uint16_t>(tile_mask(vrow, j, a.T, aligned));
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int* out = list + static_cast<long long>(b) * ntile;
  int cnt = 0;
  for (int base = 0; base < ntile; base += 32) {
    const int j = base + lane;
    const bool live = j < ntile && masks[j] != 0;
    const unsigned bal = __ballot_sync(REPRO_FULL_MASK, live);
    if (live)
      out[cnt + __popc(bal & ((1u << lane) - 1u))] =
          j | (static_cast<int>(masks[j]) << 16);
    cnt += __popc(bal);
  }
  if (lane == 0) {
    counts[b] = cnt;
    first[b] = 0;
    last[b] = -1;
  }
}

__global__ void __launch_bounds__(256)
mla_decode_list_kernel(const uint8_t* __restrict__ valid,
                       int* __restrict__ counts, int* __restrict__ first,
                       int* __restrict__ last, int* __restrict__ list,
                       float* __restrict__ part_l, Args a) {
  list_body(valid, counts, first, last, list, part_l, a);
}

// The same pass under its own name for the wide-head kernel's launches
// (namespace wide), so that a device trace tells the two entry points apart.
__global__ void __launch_bounds__(256)
mla_wide_list_kernel(const uint8_t* __restrict__ valid,
                     int* __restrict__ counts, int* __restrict__ first,
                     int* __restrict__ last, int* __restrict__ list,
                     float* __restrict__ part_l, Args a) {
  list_body(valid, counts, first, last, list, part_l, a);
}

// The first ordinal of block g's run: g N / G (in 32 bits where g N fits).
__host__ __device__ __forceinline__ int run_start(int g, int N, int G) {
  const long long p = static_cast<long long>(g) * N;
  return p <= 0x7fffffffLL ? static_cast<int>(p) / G
                           : static_cast<int>(p / G);
}

// A block's share of the batch's live tiles, in shared memory: its entries
// (row, and tile | mask << 16) and its stages, runs of at most tps entries
// of one row; per stage, the q buffer its row uses (the rows a block
// touches take turns in two).
struct Share {
  int* prefix;      // [B + 1] live tiles before each row
  int* row;         // [MAXT]
  int* tm;          // [MAXT]
  int* stage_at;    // [MAXT + 1] first entry of each stage
  int* stage_q;     // [MAXT] its q buffer
  int* nstage;
  int* lo;          // the run's first ordinal
};

__host__ __device__ constexpr size_t share_bytes() {
  return sizeof(int) * ((BMAX + 1) + 4 * MAXT + 3);
}

__device__ __forceinline__ Share share_at(void* p) {
  int* x = static_cast<int*>(p);
  int* row = x + BMAX + 1;
  return Share{x, row, row + MAXT, row + 2 * MAXT, row + 3 * MAXT + 1,
               row + 4 * MAXT + 1, row + 4 * MAXT + 2};
}

// Fills the share of run g (every thread calls it); returns its stages, the
// block synchronised. At most MAXT entries (the wide kernel's MAXTW): the
// host makes G at least ceil(B x tiles a row / MAXT).
__device__ int block_share(const int* __restrict__ counts,
                           const int* __restrict__ list, const Args& a,
                           int tps, const Share& sh, int g) {
  const int ntile = (a.T + WT - 1) / WT;
  if (threadIdx.x < 32) {               // prefix[b] = live tiles before b
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < a.B; base += 32) {
      const int b = base + lane;
      int v = b < a.B ? counts[b] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(REPRO_FULL_MASK, v, o);
        if (lane >= o) v += u;
      }
      if (b < a.B) sh.prefix[b + 1] = carry + v;
      carry += __shfl_sync(REPRO_FULL_MASK, v, 31);
    }
    if (lane == 0) sh.prefix[0] = 0;
  }
  __syncthreads();
  const int N = sh.prefix[a.B];
  const int lo = run_start(g, N, a.G);
  const int n = run_start(g + 1, N, a.G) - lo;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = lo + i;
    int r0 = 0, r1 = a.B;               // prefix[r0] <= t < prefix[r1]
    while (r1 - r0 > 1) {
      const int mid = (r0 + r1) >> 1;
      if (sh.prefix[mid] <= t) r0 = mid; else r1 = mid;
    }
    sh.row[i] = r0;
    sh.tm[i] = list[static_cast<long long>(r0) * ntile + t - sh.prefix[r0]];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0, qb = 0;
    for (int i = 0; i < n; ++i) {
      const bool new_row = i == 0 || sh.row[i] != sh.row[i - 1];
      if (new_row || i - sh.stage_at[s - 1] == tps) {
        if (new_row && i > 0) qb ^= 1;
        sh.stage_q[s] = qb;
        sh.stage_at[s++] = i;
      }
    }
    sh.stage_at[s] = n;
    *sh.nstage = s;
    *sh.lo = lo;
  }
  __syncthreads();
  return *sh.nstage;
}

// Whether stage s is the last of its row's run in the block.
__device__ __forceinline__ bool ends_row(const Share& sh, int s, int nst) {
  return s + 1 == nst ||
         sh.row[sh.stage_at[s + 1]] != sh.row[sh.stage_at[s]];
}

// At the end of run g's part of row b (its entries up to, not including,
// end): where that part holds the row's first or last live tile, run g is
// the first or last of the runs whose partials the merge reads for the
// row. One thread calls it.
__device__ __forceinline__ void mark_row(const Share& sh, int b, int end,
                                         int* first, int* last, int g) {
  int e = end - 1;
  while (e > 0 && sh.row[e - 1] == b) --e;
  if (*sh.lo + e == sh.prefix[b]) first[b] = g;
  if (*sh.lo + end == sh.prefix[b + 1]) last[b] = g;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores fed by asynchronous copies
// ---------------------------------------------------------------------------
//
// The H heads of a row are the M rows of mma.m16n8k16 (zero rows up to 16),
// so one pass over the latents serves all of them. A block of NW = 8 warps
// walks its entries in stages of up to TPS = 4 tiles (64 slots) of one row,
// two stages in a ring of shared memory: stage s + 1 is copied (16-byte
// cp.async, zero fill at invalid slots, which are never read; with it the
// q of a row the block starts there, into the q buffer the row before last
// used) while stage s is computed. A latent row lands once, c_kv's R
// columns then k_rope's RP, and serves as the key (all R + RP columns) and
// as the value (the first R).
//
// - S = Q K^T: warp w takes tile w % 4 of the stage and half of the k-steps
//   (w / 4), and writes its fp32 partial to shared memory; the halves are
//   added in a fixed order.
// - Softmax, each value once: warp w takes n-tile w / 4 of tile w % 4 (8
//   slots), scales its scores in fp32 by scale x log2(e) (-1e30 at invalid
//   slots), and leaves its row maxima in shared memory; every warp then
//   forms the same running max m of each head (base 2) and its rescale,
//   and warp w writes p = exp2(s - m) (0 at invalid slots) as hi = bf16(p)
//   and lo = bf16(p - hi) into shared memory, and its row sums, which warp
//   0 adds into l. On the H100, at 32 full rows of 2048 slots, the first
//   pass took 63 us with expf, 56 with exp2f, and 46 once each value was
//   raised and split by one warp, not by all eight.
// - P V: the 16 x R fp32 accumulator is split over the warps by value
//   column, 16-column blocks w, w + 8, ... (64 columns a warp at R 512, 32
//   registers a lane). P enters as its hi and lo parts (ldmatrix), two MMAs
//   into the fp32 accumulator, as in decode_attention.cu (one bf16 P loses
//   about 8 bits of the fp32 P and misses the checks' relative L2 of 1e-3).
// - At the end of a row's run each warp writes its own columns of the
//   partial, warp 0 (m, l), and the running state starts again.
//
// Shared memory at R 512, RP 64: the ring 149,504 B, two q buffers 37,376,
// S 9,216, P 4,608, the row maxima and sums 1,024, the share 5,132: one
// block an SM. Before the softmax was shared out, a stage of 64 slots cost
// ~5 us on the H100 with its products cut out and as much with its copies
// cut out, and 16 warps (a quarter of the k-steps each) ran no faster.

namespace tc {

constexpr int NW = 8;                // warps per block
constexpr int TPS = 4;               // tiles per stage
constexpr int KSPLIT = NW / TPS;     // warps that share a tile's S
constexpr int ST = TPS * WT;         // slots per stage
constexpr int NST = 2;               // stages in the ring
static_assert(NW == 2 * TPS, "two warps a tile: its k-steps in halves "
              "for S, its two n-tiles for the softmax");

template <int R, int RP>
struct Shape {
  static constexpr int DK = R + RP;                 // key width
  static constexpr int LD = DK + 8;                 // padded row, elements
  static constexpr int KS = DK / 16;                // k-steps of Q K^T
  static constexpr int CPR = DK / 8;                // 16-byte chunks a row
  static constexpr int RC = R / 8;                  // of them c_kv's
  static constexpr int VB = R / 16;                 // 16-column blocks of V
  static constexpr int CB = (VB + NW - 1) / NW;     // of them a warp
  static constexpr int SLD = ST + 8;                // S row, floats
  static constexpr int PLD = ST + 8;                // P row, elements
  static constexpr size_t ring = sizeof(__nv_bfloat16) * NST * ST * LD;
  static constexpr size_t qs = sizeof(__nv_bfloat16) * 2 * HMAX * LD;
  static constexpr size_t sb = sizeof(float) * KSPLIT * HMAX * SLD;
  static constexpr size_t pb = sizeof(__nv_bfloat16) * 2 * HMAX * PLD;
  static constexpr size_t stats = sizeof(float) * 2 * NW * HMAX;
  static constexpr size_t smem = ring + qs + sb + pb + stats + share_bytes();
  static_assert(R % 16 == 0 && RP % 8 == 0 && DK % 16 == 0, "widths");
};

template <int R, int RP>
__global__ void __launch_bounds__(NW * 32, 1)
mla_decode_tile_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ ckv,
                       const __nv_bfloat16* __restrict__ krope,
                       const int* __restrict__ counts,
                       const int* __restrict__ list,
                       int* __restrict__ first, int* __restrict__ last,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, Args a) {
  using S = Shape<R, RP>;
  constexpr int LD = S::LD, CPR = S::CPR, RC = S::RC, SLD = S::SLD;
  constexpr int PLD = S::PLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* at = smem_raw;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(at);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(at += S::ring);
  float* sb = reinterpret_cast<float*>(at += S::qs);     // [KSPLIT][16][SLD]
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(at += S::sb);
  __nv_bfloat16* pls = ph + HMAX * PLD;                  // P's hi, lo parts
  float* rmax = reinterpret_cast<float*>(at += S::pb);   // [NW][16]
  float* rsum = rmax + NW * HMAX;                        // [NW][16]
  const Share sh = share_at(at + S::stats);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int nst = block_share(counts, list, a, TPS, sh, blockIdx.x);

  // stage s: its row's q (when the row starts there) and its tiles' rows
  auto load_stage = [&](int s) {
    const int e0 = sh.stage_at[s], ne = sh.stage_at[s + 1] - e0;
    const int b = sh.row[e0];
    if (s == 0 || sh.row[sh.stage_at[s - 1]] != b) {
      __nv_bfloat16* qd = qs + sh.stage_q[s] * HMAX * LD;
      const __nv_bfloat16* qb = q + b * a.sqb;
      for (int i = tid; i < HMAX * CPR; i += NW * 32) {
        const int r = i / CPR, c = i % CPR;
        repro_cp_async16(qd + r * LD + c * 8,
                         qb + min(r, a.H - 1) * a.sqh + c * 8, r < a.H);
      }
    }
    const __nv_bfloat16* cb = ckv + b * a.scb;
    const __nv_bfloat16* rb = krope + b * a.srb;
    __nv_bfloat16* kd = ring + (s % NST) * ST * LD;
    for (int i = tid; i < ne * WT * CPR; i += NW * 32) {
      const int r = i / CPR, c = i % CPR;
      const int tm = sh.tm[e0 + r / WT];
      const bool ok = (tm >> (16 + r % WT)) & 1;
      const long long t = (tm & 0xffff) * WT + (ok ? r % WT : 0);
      const __nv_bfloat16* src =
          c < RC ? cb + t * a.sct + c * 8 : rb + t * a.srt + (c - RC) * 8;
      repro_cp_async16(kd + r * LD + c * 8, src, ok);
    }
  };
  if (nst > 0) load_stage(0);
  repro_cp_async_commit();

  const int qk_tile = warp % TPS;              // this warp's tile of S
  const int kpart = warp / TPS;                // and its part of the k-steps
  const int k0 = kpart * S::KS / KSPLIT, k1 = (kpart + 1) * S::KS / KSPLIT;
  const float scale2 = a.scale * kLog2e;
  float m_a = REPRO_NEG_INF, m_b = REPRO_NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[S::CB][2][4];
#pragma unroll
  for (int cb2 = 0; cb2 < S::CB; ++cb2)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      acc[cb2][h2][0] = acc[cb2][h2][1] = acc[cb2][h2][2] =
          acc[cb2][h2][3] = 0.f;

  for (int s = 0; s < nst; ++s) {
    repro_cp_async_wait<0>();
    __syncthreads();   // stage s (and its q) landed; stage s - 1 consumed
    if (s + 1 < nst) load_stage(s + 1);
    repro_cp_async_commit();
    const __nv_bfloat16* kt = ring + (s % NST) * ST * LD;
    const __nv_bfloat16* qt = qs + sh.stage_q[s] * HMAX * LD;
    const int e0 = sh.stage_at[s], ne = sh.stage_at[s + 1] - e0;

    if (qk_tile < ne) {                        // warp-uniform
      float sc[2][4] = {};
      const __nv_bfloat16* kw = kt + qk_tile * WT * LD;
      for (int kk = k0; kk < k1; ++kk) {
        uint32_t qf[4], kf[4];
        repro_ldsm_x4(qf, qt + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
        repro_ldsm_x4(kf, kw + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
        repro_mma_bf16(sc[0], qf, kf[0], kf[1]);
        repro_mma_bf16(sc[1], qf, kf[2], kf[3]);
      }
      float* sw = sb + kpart * HMAX * SLD + qk_tile * WT + 2 * tig;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float2*>(sw + gid * SLD + 8 * j) =
            make_float2(sc[j][0], sc[j][1]);
        *reinterpret_cast<float2*>(sw + (gid + 8) * SLD + 8 * j) =
            make_float2(sc[j][2], sc[j][3]);
      }
    }
    __syncthreads();                           // the stage's S is whole

    // softmax, each value once: warp w takes n-tile w / 4 (8 slots) of
    // tile w % 4; lane values at rows gid and gid + 8, slots 2 tig + (e & 1)
    const int st = warp % TPS, sj = warp / TPS;
    const bool live = st < ne;
    const uint32_t msk =
        live ? static_cast<uint32_t>(sh.tm[e0 + st]) >> (16 + 8 * sj) : 0u;
    const int col = st * WT + 8 * sj + 2 * tig;
    float sv[4];
    {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
#pragma unroll
        for (int kp = 0; kp < KSPLIT; ++kp) {
          const float* part = sb + kp * HMAX * SLD + col;
          const float2 a2 = *reinterpret_cast<const float2*>(part + gid * SLD);
          const float2 b2 =
              *reinterpret_cast<const float2*>(part + (gid + 8) * SLD);
          v[0] += a2.x;
          v[1] += a2.y;
          v[2] += b2.x;
          v[3] += b2.y;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sv[e] = (msk >> (2 * tig + (e & 1))) & 1u ? v[e] * scale2
                                                  : REPRO_NEG_INF;
    }
    const float wx_a = repro_quad_max(fmaxf(sv[0], sv[1]));
    const float wx_b = repro_quad_max(fmaxf(sv[2], sv[3]));
    if (tig == 0) {
      rmax[warp * HMAX + gid] = wx_a;
      rmax[warp * HMAX + gid + 8] = wx_b;
    }
    __syncthreads();                           // the warps' row maxima
    float mx_a = REPRO_NEG_INF, mx_b = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      mx_a = fmaxf(mx_a, rmax[w * HMAX + gid]);
      mx_b = fmaxf(mx_b, rmax[w * HMAX + gid + 8]);
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = (msk >> (2 * tig + (e & 1))) & 1u
                 ? exp2f(sv[e] - (e < 2 ? mn_a : mn_b)) : 0.f;
    if (live) {
      uint32_t hi, lo;
      repro_split_bf16(p[0], p[1], hi, lo);
      *reinterpret_cast<uint32_t*>(ph + gid * PLD + col) = hi;
      *reinterpret_cast<uint32_t*>(pls + gid * PLD + col) = lo;
      repro_split_bf16(p[2], p[3], hi, lo);
      *reinterpret_cast<uint32_t*>(ph + (gid + 8) * PLD + col) = hi;
      *reinterpret_cast<uint32_t*>(pls + (gid + 8) * PLD + col) = lo;
    }
    const float ws_a = repro_quad_sum(p[0] + p[1]);
    const float ws_b = repro_quad_sum(p[2] + p[3]);
    if (tig == 0) {
      rsum[warp * HMAX + gid] = ws_a;
      rsum[warp * HMAX + gid + 8] = ws_b;
    }
    __syncthreads();                           // P and the row sums
    if (warp == 0) {                           // l: warp 0's alone
      float s_a = 0.f, s_b = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        s_a += rsum[w * HMAX + gid];
        s_b += rsum[w * HMAX + gid + 8];
      }
      l_a = al_a * l_a + s_a;
      l_b = al_b * l_b + s_b;
    }
#pragma unroll
    for (int cb2 = 0; cb2 < S::CB; ++cb2)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        acc[cb2][h2][0] *= al_a;
        acc[cb2][h2][1] *= al_a;
        acc[cb2][h2][2] *= al_b;
        acc[cb2][h2][3] *= al_b;
      }
#pragma unroll
    for (int t = 0; t < TPS; ++t) {
      if (t >= ne) continue;                   // warp-uniform
      uint32_t fh[4], fl[4];
      repro_ldsm_x4(fh, ph + (lane & 15) * PLD + t * WT + (lane >> 4) * 8);
      repro_ldsm_x4(fl, pls + (lane & 15) * PLD + t * WT + (lane >> 4) * 8);
      const __nv_bfloat16* vt = kt + t * WT * LD;
#pragma unroll
      for (int cb2 = 0; cb2 < S::CB; ++cb2) {
        const int blk = warp + NW * cb2;
        if (blk >= S::VB) continue;            // warp-uniform
        uint32_t vf[4];
        repro_ldsm_x4_trans(vf, vt + (lane & 15) * LD + blk * 16 +
                                    (lane >> 4) * 8);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          repro_mma_bf16(acc[cb2][h2], fh, vf[2 * h2], vf[2 * h2 + 1]);
          repro_mma_bf16(acc[cb2][h2], fl, vf[2 * h2], vf[2 * h2 + 1]);
        }
      }
    }
    if (!ends_row(sh, s, nst)) continue;       // block-uniform

    // the row's partial, at g + row: (m, l) by warp 0, each warp its value
    // columns; then the running state starts again
    const long long base =
        (static_cast<long long>(blockIdx.x) + sh.row[e0]) * a.H;
    if (tid == 0) mark_row(sh, sh.row[e0], sh.stage_at[s + 1], first, last,
                             blockIdx.x);
    if (warp == 0 && tig == 0) {
      if (gid < a.H) {
        part_m[base + gid] = m_a;
        part_l[base + gid] = l_a;
      }
      if (gid + 8 < a.H) {
        part_m[base + gid + 8] = m_b;
        part_l[base + gid + 8] = l_b;
      }
    }
#pragma unroll
    for (int cb2 = 0; cb2 < S::CB; ++cb2) {
      const int blk = warp + NW * cb2;
      if (blk >= S::VB) continue;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = blk * 16 + h2 * 8 + 2 * tig;
        if (gid < a.H)
          *reinterpret_cast<float2*>(part_acc + (base + gid) * R + col) =
              make_float2(acc[cb2][h2][0], acc[cb2][h2][1]);
        if (gid + 8 < a.H)
          *reinterpret_cast<float2*>(part_acc + (base + gid + 8) * R +
                                     col) =
              make_float2(acc[cb2][h2][2], acc[cb2][h2][3]);
        acc[cb2][h2][0] = acc[cb2][h2][1] = acc[cb2][h2][2] =
            acc[cb2][h2][3] = 0.f;
      }
    }
    m_a = m_b = REPRO_NEG_INF;
    l_a = l_b = 0.f;
  }
  repro_cp_async_wait<0>();
}

template <int R, int RP>
cudaError_t launch(const void* q, const void* ckv, const void* krope,
                   const int* counts, const int* list, int* first, int* last,
                   float* part_m, float* part_l, float* part_acc,
                   const Args& a, cudaStream_t stream) {
  constexpr size_t smem = Shape<R, RP>::smem;
  static bool optin[REPRO_MAX_DEVICES] = {};
  cudaError_t err =
      repro_smem_optin(mla_decode_tile_kernel<R, RP>, smem, optin);
  if (err != cudaSuccess) return err;
  mla_decode_tile_kernel<R, RP><<<a.G, NW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const __nv_bfloat16*>(krope), counts, list, first, last,
      part_m, part_l, part_acc, a);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
//
// For a model run in fp32 (the checks of the kernels against the plain
// path), any R <= 512 and R + RP <= 576 with H <= 16; base-2 scores as the
// bf16 path's. The block's entries
// one tile at a time: the tile's latent rows are copied into shared memory
// (invalid slots as zeros), thread (h, j) forms head h's score at slot j,
// the 16 threads of a head (half a warp) update its running (m, l), and
// thread d accumulates value columns d and d + 256 of every head.

namespace f32 {

constexpr int NT = 256;              // threads per block
constexpr int CPT = 2;               // most value columns a thread
constexpr int RMAX = NT * CPT;
constexpr int DKMAX = 576;
static_assert(HMAX * WT == NT, "a thread a (head, slot) score");

__host__ __device__ constexpr size_t smem_floats(int dk) {
  return static_cast<size_t>(2 * HMAX * (dk + 1) + HMAX * WT + HMAX);
}

__host__ __device__ constexpr size_t smem_bytes(int dk) {
  return sizeof(float) * smem_floats(dk) + share_bytes();
}

__global__ void __launch_bounds__(NT)
mla_decode_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ ckv,
                      const float* __restrict__ krope,
                      const int* __restrict__ counts,
                      const int* __restrict__ list,
                      int* __restrict__ first, int* __restrict__ last,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, Args a) {
  const int R = a.R, DK = a.R + a.RP, LD = DK + 1;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                                  // [16][LD]
  float* ks = qs + HMAX * LD;                      // [16][LD]
  float* ps = ks + WT * LD;                        // [16 heads][16 slots]
  float* al = ps + HMAX * WT;                      // [16]
  const Share sh = share_at(sm + smem_floats(DK));

  const int tid = threadIdx.x;
  const int h = tid / WT, j = tid % WT;     // this thread's score
  const int nst = block_share(counts, list, a, 1, sh, blockIdx.x);   // a tile a stage
  float m = REPRO_NEG_INF, l = 0.f;          // head h's, in all 16 threads
  float acc[CPT][HMAX];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int g = 0; g < HMAX; ++g) acc[i][g] = 0.f;

  for (int s = 0; s < nst; ++s) {
    const int b = sh.row[s];
    const int tm = sh.tm[s];
    const int t0 = (tm & 0xffff) * WT;
    const uint32_t msk = static_cast<uint32_t>(tm) >> 16;
    if (s > 0) __syncthreads();              // the last tile consumed
    if (s == 0 || sh.row[s - 1] != b)
      for (int i = tid; i < HMAX * DK; i += NT) {
        const int r = i / DK, c = i % DK;
        qs[r * LD + c] = r < a.H ? q[b * a.sqb + r * a.sqh + c] : 0.f;
      }
    const float* cb = ckv + b * a.scb;
    const float* rb = krope + b * a.srb;
    for (int i = tid; i < WT * DK; i += NT) {
      const int r = i / DK, c = i % DK;
      float x = 0.f;
      if ((msk >> r) & 1u) {
        const long long t = t0 + r;
        x = c < R ? cb[t * a.sct + c] : rb[t * a.srt + (c - R)];
      }
      ks[r * LD + c] = x;
    }
    __syncthreads();
    const bool ok = (msk >> j) & 1u;
    float sc = 0.f;
    for (int c = 0; c < DK; ++c) sc = fmaf(qs[h * LD + c], ks[j * LD + c], sc);
    sc = ok ? sc * (a.scale * kLog2e) : REPRO_NEG_INF;
    float mx = sc;
#pragma unroll
    for (int o = WT / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(REPRO_FULL_MASK, mx, o));
    const float mn = fmaxf(m, mx);
    const float p = ok ? exp2f(sc - mn) : 0.f;
    float psum = p;
#pragma unroll
    for (int o = WT / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(REPRO_FULL_MASK, psum, o);
    const float alpha = exp2f(m - mn);
    l = alpha * l + psum;
    m = mn;
    ps[h * WT + j] = p;
    if (j == 0) al[h] = alpha;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int d = tid + i * NT;
      if (d >= R) break;
#pragma unroll
      for (int g = 0; g < HMAX; ++g) {
        float x = acc[i][g] * al[g];
#pragma unroll
        for (int jj = 0; jj < WT; ++jj)
          x = fmaf(ps[g * WT + jj], ks[jj * LD + d], x);
        acc[i][g] = x;
      }
    }
    if (!ends_row(sh, s, nst)) continue;     // block-uniform

    const long long base = (static_cast<long long>(blockIdx.x) + b) * a.H;
    if (tid == 0) mark_row(sh, b, s + 1, first, last, blockIdx.x);
    if (j == 0 && h < a.H) {
      part_m[base + h] = m;
      part_l[base + h] = l;
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int d = tid + i * NT;
#pragma unroll
      for (int g = 0; g < HMAX; ++g) {
        if (d < R && g < a.H) part_acc[(base + g) * R + d] = acc[i][g];
        acc[i][g] = 0.f;
      }
    }
    m = REPRO_NEG_INF;
    l = 0.f;
  }
}

cudaError_t launch(const void* q, const void* ckv, const void* krope,
                   const int* counts, const int* list, int* first, int* last,
                   float* part_m, float* part_l, float* part_acc,
                   const Args& a, cudaStream_t stream) {
  static bool optin[REPRO_MAX_DEVICES] = {};
  cudaError_t err =
      repro_smem_optin(mla_decode_f32_kernel, smem_bytes(DKMAX), optin);
  if (err != cudaSuccess) return err;
  mla_decode_f32_kernel<<<a.G, NT, smem_bytes(a.R + a.RP), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(ckv),
      static_cast<const float*>(krope), counts, list, first, last, part_m,
      part_l, part_acc, a);
  return cudaGetLastError();
}

}  // namespace f32

// Pass 2: block (b, h) merges head h's partials of row b, those of blocks
// first[b] .. last[b] (at g + b; one with l = 0, a block whose run missed
// the row, as where N < G, is skipped) and normalises; a row with no live
// tile (first 0, last -1) gives 0. Each partial's (m, l), base 2, is read
// once into shared memory: two round trips to device memory before the
// acc's.
template <typename T>
__device__ __forceinline__ void merge_body(const int* __restrict__ first,
                                           const int* __restrict__ last,
                                           const float* __restrict__ part_m,
                                           const float* __restrict__ part_l,
                                           const float* __restrict__ part_acc,
                                           T* __restrict__ o, const Args& a) {
  extern __shared__ float wsplit[];          // [G] m, then weights; [G] l
  float* lsplit = wsplit + a.G;
  __shared__ float lsum_s;
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int H = a.H, R = a.R;
  const int g0 = first[b], nparts = last[b] - g0 + 1;
  if (tid < 32) {
    float mx = REPRO_NEG_INF;
    for (int k = tid; k < nparts; k += 32) {
      const long long p = (static_cast<long long>(g0) + k + b) * H + h;
      const float l = part_l[p], m = part_m[p];   // both loads in flight
      wsplit[k] = m;
      lsplit[k] = l;
      if (l > 0.f) mx = fmaxf(mx, m);
    }
    mx = repro_warp_max(mx);
    float lsum = 0.f;
    for (int k = tid; k < nparts; k += 32) {
      const float l = lsplit[k];
      const float w = l > 0.f ? exp2f(wsplit[k] - mx) : 0.f;
      wsplit[k] = w;
      lsum = fmaf(w, l, lsum);
    }
    lsum = repro_warp_sum(lsum);
    if (tid == 0) lsum_s = lsum == 0.f ? 1.f : lsum;
  }
  __syncthreads();
  const long long base = (static_cast<long long>(g0) + b) * H + h;
#pragma unroll 4
  for (int d = tid; d < R; d += 128) {
    float out = 0.f;
    for (int k = 0; k < nparts; ++k)
      if (wsplit[k] != 0.f)
        out = fmaf(wsplit[k], part_acc[(base + k * H) * R + d], out);
    o[b * a.sob + h * a.soh + d] = repro_from_float<T>(out / lsum_s);
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
mla_decode_merge_kernel(const int* __restrict__ first,
                        const int* __restrict__ last,
                        const float* __restrict__ part_m,
                        const float* __restrict__ part_l,
                        const float* __restrict__ part_acc,
                        T* __restrict__ o, Args a) {
  merge_body(first, last, part_m, part_l, part_acc, o, a);
}

// The same pass under its own name for the wide-head kernel's launches.
__global__ void __launch_bounds__(128)
mla_wide_merge_kernel(const int* __restrict__ first,
                      const int* __restrict__ last,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      __nv_bfloat16* __restrict__ o, Args a) {
  merge_body(first, last, part_m, part_l, part_acc, o, a);
}

template <typename T>
cudaError_t merge(const int* first, const int* last, const float* pm,
                  const float* pl, const float* pacc, void* o, const Args& a,
                  cudaStream_t stream) {
  mla_decode_merge_kernel<T>
      <<<dim3(a.B, a.H), 128, 2 * sizeof(float) * a.G, stream>>>(
          first, last, pm, pl, pacc, static_cast<T*>(o), a);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 at up to 128 heads: namespace wide (entry mla_decode_wide_fwd)
// ---------------------------------------------------------------------------
//
// At DeepSeek-V3's 128 heads a latent row (R 512 + RP 64, 1,152 B) feeds
// 128 x (576 + 512) x 2 = 278,528 flops: ~241 a byte against the H100's
// ridge of ~295, so the products weigh as much as the bytes. The fp32
// accumulators of a row's run are 128 x 512 x 4 = 256 KB, the whole
// register file of an SM, so no block can hold them all: a block takes 64
// heads (four 16-head m-tiles, 128 KB of accumulators over 16 warps, 64
// registers a lane), and each valid latent is read from device memory by
// the two blocks of its run, ceil(H / 64) times in all. The grid is (head
// group, run) with the head group fastest, so the two blocks of a run are
// launched together and read the same tiles at about the same time, the
// second mostly from L2.
//
// The listing and merging passes are the narrow kernel's (under the names
// mla_wide_list_kernel and mla_wide_merge_kernel), with longer runs: at most
// MAXTW = 256 live tiles a run, so that each run's partials (64 heads x 512
// fp32 a row it touches) stay a small share of the latents it reads. A run
// walks its entries in stages of TPS = 2 tiles (32 slots), three in a ring
// of shared memory: stage s + 2 is copied while stage s is computed.
//
// - S = Q K^T: warp w takes m-tile w / 4, tile w % 2 of the stage and half
//   of the 36 k-steps ((w / 2) % 2); the halves meet in shared memory.
// - Softmax: thread t takes head t / 8 and 4 slots; the 8 threads of a head
//   (lanes of one warp) reduce its max and sum by shuffles; the running
//   (m, l) of each head and its rescale live in shared memory. P is one bf16
//   value (the narrow kernel's hi + lo split would double the P V products,
//   which here weigh as much as the bytes).
// - P V: warp w owns value columns 32 w .. 32 w + 31 of all 64 heads: per
//   tile it loads those columns of V once and runs them against each
//   m-tile's P.
// - The q of the run's row is staged once per row in one buffer of 64 x 584
//   bf16; a new row within a run loads it after the last stage of the row
//   before has been consumed.
//
// Shared memory: the ring 112,128 B, q 74,752, S 20,480, P 5,120, the
// running (m, l, rescale) 768, the share 8,208: 221,456 B, one block an SM.

namespace wide {

constexpr int HWMAX = 128;           // most heads
constexpr int MT = 4;                // 16-head m-tiles a block
constexpr int HB = 16 * MT;          // heads a block
constexpr int NW = 16;               // warps per block
constexpr int TPS = 2;               // tiles per stage
constexpr int KSPLIT = 2;            // warps that share a tile's S
constexpr int ST = TPS * WT;         // slots per stage
constexpr int NST = 3;               // stages in the ring
constexpr int MAXTW = 256;           // most live tiles a run takes
constexpr int R = 512, RP = 64;      // the widths it is built for
constexpr int DK = R + RP;           // key width
constexpr int LD = DK + 8;           // padded row, elements
constexpr int KS = DK / 16;          // k-steps of Q K^T
constexpr int CPR = DK / 8;          // 16-byte chunks a row
constexpr int RC = R / 8;            // of them c_kv's
constexpr int CB = R / 16 / NW;      // 16-column blocks of V a warp
constexpr int SLD = ST + 8;          // S row, floats
constexpr int PLD = ST + 8;          // P row, elements
static_assert(NW == MT * TPS * KSPLIT, "a warp an (m-tile, tile, k-half)");
static_assert(NW * 32 == HB * ST / 4, "a thread 4 scores of one head");
static_assert(CB * 16 * NW == R, "the value columns over the warps");

constexpr size_t ring_bytes = sizeof(__nv_bfloat16) * NST * ST * LD;
constexpr size_t q_bytes = sizeof(__nv_bfloat16) * HB * LD;
constexpr size_t s_bytes = sizeof(float) * KSPLIT * HB * SLD;
constexpr size_t p_bytes = sizeof(__nv_bfloat16) * HB * PLD;
constexpr size_t stat_bytes = sizeof(float) * 3 * HB;
constexpr size_t share_w_bytes = sizeof(int) * ((BMAX + 1) + 4 * MAXTW + 3);
constexpr size_t smem =
    ring_bytes + q_bytes + s_bytes + p_bytes + stat_bytes + share_w_bytes;

__device__ __forceinline__ Share share_w_at(void* p) {
  int* x = static_cast<int*>(p);
  int* row = x + BMAX + 1;
  return Share{x, row, row + MAXTW, row + 2 * MAXTW, row + 3 * MAXTW + 1,
               row + 4 * MAXTW + 1, row + 4 * MAXTW + 2};
}

__global__ void __launch_bounds__(NW * 32, 1)
mla_wide_tile_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ ckv,
                     const __nv_bfloat16* __restrict__ krope,
                     const int* __restrict__ counts,
                     const int* __restrict__ list, int* __restrict__ first,
                     int* __restrict__ last, float* __restrict__ part_m,
                     float* __restrict__ part_l, float* __restrict__ part_acc,
                     Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* at = smem_raw;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(at);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(at += ring_bytes);
  float* sb = reinterpret_cast<float*>(at += q_bytes);   // [KSPLIT][HB][SLD]
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(at += s_bytes);
  float* mrun = reinterpret_cast<float*>(at += p_bytes);  // [HB] each
  float* lrun = mrun + HB;
  float* alph = lrun + HB;
  const Share sh = share_w_at(at + stat_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int hg = blockIdx.x, g = blockIdx.y;     // head group, run
  const int h0 = hg * HB;
  if (tid < HB) {
    mrun[tid] = REPRO_NEG_INF;
    lrun[tid] = 0.f;
  }
  const int nst = block_share(counts, list, a, TPS, sh, g);

  auto load_q = [&](int b) {
    const __nv_bfloat16* qb = q + b * a.sqb;
    for (int i = tid; i < HB * CPR; i += NW * 32) {
      const int r = i / CPR, c = i % CPR, h = h0 + r;
      repro_cp_async16(qs + r * LD + c * 8,
                       qb + min(h, a.H - 1) * a.sqh + c * 8, h < a.H);
    }
  };
  auto load_stage = [&](int s) {
    const int e0 = sh.stage_at[s], ne = sh.stage_at[s + 1] - e0;
    const int b = sh.row[e0];
    const __nv_bfloat16* cb = ckv + b * a.scb;
    const __nv_bfloat16* rb = krope + b * a.srb;
    __nv_bfloat16* kd = ring + (s % NST) * ST * LD;
    for (int i = tid; i < ne * WT * CPR; i += NW * 32) {
      const int r = i / CPR, c = i % CPR;
      const int tm = sh.tm[e0 + r / WT];
      const bool ok = (tm >> (16 + r % WT)) & 1;
      const long long t = (tm & 0xffff) * WT + (ok ? r % WT : 0);
      const __nv_bfloat16* src =
          c < RC ? cb + t * a.sct + c * 8 : rb + t * a.srt + (c - RC) * 8;
      repro_cp_async16(kd + r * LD + c * 8, src, ok);
    }
  };
  if (nst > 0) {
    load_q(sh.row[0]);
    load_stage(0);
  }
  repro_cp_async_commit();
  if (nst > 1) load_stage(1);
  repro_cp_async_commit();

  const int mt_s = warp >> 2;                  // this warp's m-tile of S,
  const int tile_s = warp & 1;                 // its tile
  const int kpart = (warp >> 1) & 1;           // and its half of the k-steps
  const int k0 = kpart * KS / KSPLIT, k1 = (kpart + 1) * KS / KSPLIT;
  const int hs = tid >> 3, j0 = (tid & 7) * 4; // softmax: head, first slot
  const float scale2 = a.scale * kLog2e;
  float acc[MT][CB][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        acc[m][c][h2][0] = acc[m][c][h2][1] = acc[m][c][h2][2] =
            acc[m][c][h2][3] = 0.f;

  for (int s = 0; s < nst; ++s) {
    repro_cp_async_wait<1>();
    __syncthreads();   // stage s (and its q) landed; stage s - 1 consumed
    const int e0 = sh.stage_at[s], ne = sh.stage_at[s + 1] - e0;
    const int b = sh.row[e0];
    if (s > 0 && sh.row[sh.stage_at[s - 1]] != b) {      // block-uniform
      load_q(b);
      repro_cp_async_commit();
      repro_cp_async_wait<0>();
      __syncthreads();
    }
    if (s + 2 < nst) load_stage(s + 2);
    repro_cp_async_commit();
    const __nv_bfloat16* kt = ring + (s % NST) * ST * LD;

    if (tile_s < ne) {                         // warp-uniform
      float sc[2][4] = {};
      const __nv_bfloat16* kw = kt + tile_s * WT * LD;
      const __nv_bfloat16* qw = qs + mt_s * 16 * LD;
      for (int kk = k0; kk < k1; ++kk) {
        uint32_t qf[4], kf[4];
        repro_ldsm_x4(qf, qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
        repro_ldsm_x4(kf, kw + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
        repro_mma_bf16(sc[0], qf, kf[0], kf[1]);
        repro_mma_bf16(sc[1], qf, kf[2], kf[3]);
      }
      float* sw = sb + (kpart * HB + mt_s * 16) * SLD + tile_s * WT + 2 * tig;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float2*>(sw + gid * SLD + 8 * j) =
            make_float2(sc[j][0], sc[j][1]);
        *reinterpret_cast<float2*>(sw + (gid + 8) * SLD + 8 * j) =
            make_float2(sc[j][2], sc[j][3]);
      }
    }
    __syncthreads();                           // the stage's S is whole

    {  // softmax: head hs, slots j0 .. j0 + 3 of the stage
      const int tl = j0 / WT;
      const uint32_t msk =
          tl < ne ? (static_cast<uint32_t>(sh.tm[e0 + tl]) >> 16) >>
                        (j0 % WT)
                  : 0u;
      const float4 x0 = *reinterpret_cast<const float4*>(sb + hs * SLD + j0);
      const float4 x1 =
          *reinterpret_cast<const float4*>(sb + (HB + hs) * SLD + j0);
      const float v[4] = {x0.x + x1.x, x0.y + x1.y, x0.z + x1.z,
                          x0.w + x1.w};
      float sv[4], mx = REPRO_NEG_INF;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv[e] = (msk >> e) & 1u ? v[e] * scale2 : REPRO_NEG_INF;
        mx = fmaxf(mx, sv[e]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(REPRO_FULL_MASK, mx, o));
      const float m_old = mrun[hs];
      const float mn = fmaxf(m_old, mx);
      float p[4], sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = (msk >> e) & 1u ? exp2f(sv[e] - mn) : 0.f;
        sum += p[e];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(REPRO_FULL_MASK, sum, o);
      __nv_bfloat162* pw =
          reinterpret_cast<__nv_bfloat162*>(pb + hs * PLD + j0);
      pw[0] = __floats2bfloat162_rn(p[0], p[1]);
      pw[1] = __floats2bfloat162_rn(p[2], p[3]);
      if ((tid & 7) == 0) {
        const float al = exp2f(m_old - mn);
        mrun[hs] = mn;
        lrun[hs] = al * lrun[hs] + sum;
        alph[hs] = al;
      }
    }
    __syncthreads();                           // P and the rescales

#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float al_a = alph[m * 16 + gid], al_b = alph[m * 16 + gid + 8];
#pragma unroll
      for (int c = 0; c < CB; ++c)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          acc[m][c][h2][0] *= al_a;
          acc[m][c][h2][1] *= al_a;
          acc[m][c][h2][2] *= al_b;
          acc[m][c][h2][3] *= al_b;
        }
    }
#pragma unroll
    for (int t = 0; t < TPS; ++t) {
      if (t >= ne) continue;                   // block-uniform
      const __nv_bfloat16* vt = kt + t * WT * LD;
      uint32_t vf[CB][4];
#pragma unroll
      for (int c = 0; c < CB; ++c)
        repro_ldsm_x4_trans(vf[c], vt + (lane & 15) * LD +
                                       (warp * CB + c) * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t pf[4];
        repro_ldsm_x4(pf, pb + (m * 16 + (lane & 15)) * PLD + t * WT +
                              (lane >> 4) * 8);
#pragma unroll
        for (int c = 0; c < CB; ++c)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            repro_mma_bf16(acc[m][c][h2], pf, vf[c][2 * h2],
                           vf[c][2 * h2 + 1]);
      }
    }
    if (!ends_row(sh, s, nst)) continue;       // block-uniform

    // the row's partial of this head group, at g + row; then the running
    // state starts again
    const long long base = (static_cast<long long>(g) + b) * a.H + h0;
    if (tid == 0 && hg == 0)
      mark_row(sh, b, sh.stage_at[s + 1], first, last, g);
    if (tid < HB) {
      if (h0 + tid < a.H) {
        part_m[base + tid] = mrun[tid];
        part_l[base + tid] = lrun[tid];
      }
      mrun[tid] = REPRO_NEG_INF;
      lrun[tid] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CB; ++c)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int col = (warp * CB + c) * 16 + h2 * 8 + 2 * tig;
          const int ha = m * 16 + gid, hb = ha + 8;
          if (h0 + ha < a.H)
            *reinterpret_cast<float2*>(part_acc + (base + ha) * R + col) =
                make_float2(acc[m][c][h2][0], acc[m][c][h2][1]);
          if (h0 + hb < a.H)
            *reinterpret_cast<float2*>(part_acc + (base + hb) * R + col) =
                make_float2(acc[m][c][h2][2], acc[m][c][h2][3]);
          acc[m][c][h2][0] = acc[m][c][h2][1] = acc[m][c][h2][2] =
              acc[m][c][h2][3] = 0.f;
        }
  }
  repro_cp_async_wait<0>();
}

cudaError_t launch(const void* q, const void* ckv, const void* krope,
                   const void* valid, void* o, int* counts, int* first,
                   int* last, int* list, float* pm, float* pl, float* pacc,
                   const Args& a, cudaStream_t st) {
  static bool optin[REPRO_MAX_DEVICES] = {};
  mla_wide_list_kernel<<<a.B, 256, 0, st>>>(
      static_cast<const uint8_t*>(valid), counts, first, last, list, pl, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = repro_smem_optin(mla_wide_tile_kernel, smem, optin);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.H + HB - 1) / HB, a.G);
  mla_wide_tile_kernel<<<grid, NW * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const __nv_bfloat16*>(krope), counts, list, first, last, pm,
      pl, pacc, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_wide_merge_kernel<<<dim3(a.B, a.H), 128, 2 * sizeof(float) * a.G, st>>>(
      first, last, pm, pl, pacc, static_cast<__nv_bfloat16*>(o), a);
  return cudaGetLastError();
}

}  // namespace wide

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q (B, H, R + RP); c_kv (B, T, R); k_rope (B, T, RP); valid (B, T) bytes
// (torch.bool); o (B, H, R). idx: int scratch of B * (3 + ceil(T / 16));
// part: fp32 scratch of (G + B) * H * (R + 2). Unit last stride
// everywhere; strides in elements; bf16 rows 16-byte aligned. B <= 1024,
// H <= 16, T <= 32768, ceil(B * ceil(T / 16) / 64) <= G <= 4096. bf16:
// (R, RP) =
// (512, 64) or (64, 16); fp32: R <= 512, R + RP <= 576. dtype REPRO_F32 or
// REPRO_BF16.
extern "C" int mla_decode_fwd(const void* q, const void* ckv,
                              const void* krope, const void* valid, void* o,
                              void* idx, void* part, int dtype, int B, int T,
                              int H, int R, int RP, int G, long long sqb,
                              long long sqh, long long scb, long long sct,
                              long long srb, long long srt, long long smb,
                              long long sob, long long soh, float scale,
                              void* stream) {
  const long long ntile = (T + WT - 1) / WT;
  if (B <= 0 || B > BMAX || T <= 0 || T > TMAX || H <= 0 || H > HMAX ||
      R <= 0 || RP < 0 || G <= 0 || G > GMAX ||
      (B * ntile + G - 1) / G > MAXT)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{sqb, sqh, scb, sct, srb, srt, smb, sob, soh,
         B, T, H, R, RP, G, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* counts = static_cast<int*>(idx);
  int* first = counts + B;
  int* last = first + B;
  int* list = last + B;
  const long long rows = static_cast<long long>(G + B) * H;
  float* pm = static_cast<float*>(part);
  float* pl = pm + rows;
  float* pacc = pm + 2 * rows;
  const bool bf16 = dtype == REPRO_BF16 &&
                    ((R == 512 && RP == 64) || (R == 64 && RP == 16));
  const bool f32 = dtype == REPRO_F32 && R <= f32::RMAX &&
                   R + RP <= f32::DKMAX;
  if (!bf16 && !f32) return static_cast<int>(cudaErrorInvalidValue);
  mla_decode_list_kernel<<<B, 256, 0, st>>>(
      static_cast<const uint8_t*>(valid), counts, first, last, list, pl, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16) {
    err = R == 512 ? tc::launch<512, 64>(q, ckv, krope, counts, list,
                                         first, last, pm, pl, pacc, a, st)
                   : tc::launch<64, 16>(q, ckv, krope, counts, list, first,
                                        last, pm, pl, pacc, a, st);
    if (err == cudaSuccess)
      err = merge<__nv_bfloat16>(first, last, pm, pl, pacc, o, a, st);
  } else {
    err = f32::launch(q, ckv, krope, counts, list, first, last, pm, pl, pacc,
                      a, st);
    if (err == cudaSuccess)
      err = merge<float>(first, last, pm, pl, pacc, o, a, st);
  }
  return static_cast<int>(err);
}

// The wide-head entry: as mla_decode_fwd, bf16 only, (R, RP) = (512, 64),
// 1 <= H <= 128, and ceil(B * ceil(T / 16) / 256) <= G <= 4096.
extern "C" int mla_decode_wide_fwd(const void* q, const void* ckv,
                                   const void* krope, const void* valid,
                                   void* o, void* idx, void* part, int dtype,
                                   int B, int T, int H, int R, int RP, int G,
                                   long long sqb, long long sqh,
                                   long long scb, long long sct,
                                   long long srb, long long srt,
                                   long long smb, long long sob,
                                   long long soh, float scale, void* stream) {
  const long long ntile = (T + WT - 1) / WT;
  if (dtype != REPRO_BF16 || R != wide::R || RP != wide::RP || B <= 0 ||
      B > BMAX || T <= 0 || T > TMAX || H <= 0 || H > wide::HWMAX ||
      G <= 0 || G > GMAX || (B * ntile + G - 1) / G > wide::MAXTW)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{sqb, sqh, scb, sct, srb, srt, smb, sob, soh,
         B, T, H, R, RP, G, scale};
  int* counts = static_cast<int*>(idx);
  int* first = counts + B;
  int* last = first + B;
  int* list = last + B;
  const long long rows = static_cast<long long>(G + B) * H;
  float* pm = static_cast<float*>(part);
  return static_cast<int>(wide::launch(
      q, ckv, krope, valid, o, counts, first, last, list, pm, pm + rows,
      pm + 2 * rows, a, static_cast<cudaStream_t>(stream)));
}
