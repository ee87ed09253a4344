// Flash-decoding on Hopper (sm_90a): one query token per sequence against
// a (B, T, Hkv, D) KV cache under a boolean validity mask.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention_grouped.
// Same arithmetic: the G query heads that share a kv head form one (G, D)
// tile, q is pre-scaled by D^-0.5, (m, l, acc) run in fp32, p is zeroed
// where a slot is invalid, and a row with no valid slot gives 0 (l == 0
// divides by 1).
//
// What bounds it on the H100: the bytes of the cache's valid slots. At
// B = 8, T = 2048, Hkv = 8, D = 128 in bf16 the whole of K and V is 67 MB,
// about 20 us at 3.35 TB/s, against about 0.1 GFLOP. The design is
// flash-decoding in two passes. Pass 1 has one block per (b, kv head,
// chunk of slots, group of up to GMAX = 8 query heads), so for G <= 8 the
// cache is read once for all G heads and enough blocks are in flight to
// fill the 132 SMs even at small B * Hkv. A wider group (RecurrentGemma's
// 16 query heads over one kv head, at D = 256) is split into head groups
// of at most 8 along the grid's third axis: each lane then still holds the
// (m, l, acc) of at most 8 heads in registers, and the blocks of one chunk
// read the same K/V rows, which the second of them finds in L2. Its four
// warps take tiles of 32 slots (one slot per lane), keep their own
// (m, l, acc), and merge them through shared memory into the block's
// partial. Pass 2 merges the chunks' partials and normalises. A lane reads
// its K row with 16-byte loads straight from the cache through its strides
// (no transposed copy); V rows are read eight at a time per warp; only the
// rows of valid slots are read at all.
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
};

// 16 bytes of a row as fp32 values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Pass 1: block (b*Hkv + hk, split, head group) streams its chunk of slots
// and writes the unnormalised (m, l, acc) of each of its heads to the
// partials.
template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, Args a) {
  constexpr int DPL = D / 32;              // output dims per lane
  constexpr int VL = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int VJ = D >= 256 ? 4 : 8;     // V rows loaded together in P.V
  __shared__ float qs[GMAX][D];
  __shared__ float wm[NW][GMAX];
  __shared__ float wl[NW][GMAX];
  __shared__ float wacc[NW][GMAX][D];

  const int bh = blockIdx.x;
  const int b = bh / a.Hkv;
  const int hk = bh % a.Hkv;
  const int g0 = blockIdx.z * GMAX;        // first head of this block
  const int G = min(GMAX, a.G - g0);       // heads of this block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    qs[g][d] = repro_to_float(
                   q[b * a.sqb + (hk * a.G + g0 + g) * a.sqh + d]) *
               a.scale;
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

  const T* kbase = k + b * a.skb + hk * a.skh;
  const T* vbase = v + b * a.svb + hk * a.svh;
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
      const T* kr = kbase + t * a.skt;
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
        const T* vr = vbase + (t0 + j0 + jj) * a.svt + lane;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          vv[jj][i] = lj ? repro_to_float(vr[32 * i]) : 0.f;
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

// Pass 2: block (b*Hkv + hk, g) merges the splits of query head g and
// normalises; a row with no valid slot has l == 0 and gives 0. One block
// per head, not per (b, hk): at RecurrentGemma's B * Hkv = 8 the merge of
// 16 heads of 256 would otherwise run on 8 blocks.
template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      T* __restrict__ o, Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.Hkv;
  const int hk = bh % a.Hkv;
  const int G = a.G;
  const int g = blockIdx.y;
  const long long base = static_cast<long long>(bh) * a.nsplit * G;
  for (int d = threadIdx.x; d < D; d += NW * 32) {
    float mx = REPRO_NEG_INF;
    for (int sp = 0; sp < a.nsplit; ++sp)
      mx = fmaxf(mx, part_m[base + sp * G + g]);
    float lsum = 0.f, out = 0.f;
    for (int sp = 0; sp < a.nsplit; ++sp) {
      const long long r = base + sp * G + g;
      const float c = expf(part_m[r] - mx);
      lsum = fmaf(c, part_l[r], lsum);
      out = fmaf(c, part_acc[r * D + d], out);
    }
    if (lsum == 0.f) lsum = 1.f;           // no valid slot: output 0
    o[b * a.sob + (hk * G + g) * a.soh + d] = repro_from_float<T>(out / lsum);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* o, float* part, int B,
                   const Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * a.Hkv * a.nsplit * a.G;
  float* part_m = part;
  float* part_l = part + rows;
  float* part_acc = part + 2 * rows;
  dim3 grid(B * a.Hkv, a.nsplit, (a.G + GMAX - 1) / GMAX);
  decode_partial_kernel<T, D><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid), part_m,
      part_l, part_acc, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D><<<dim3(B * a.Hkv, a.G), NW * 32, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), a);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q (B,1,H,D); k/v (B,T,Hkv,D) caches; valid (B,T) bytes (torch.bool);
// o (B,1,H,D); part: fp32 scratch of B*Hkv*nsplit*G*(D+2) floats. D stride
// 1 everywhere, K/V rows 16-byte aligned; strides in elements. D is 64,
// 128 or 256, H / Hkv at most 16; chunk a multiple of 128 with
// nsplit * chunk >= T;
// dtype REPRO_F32/REPRO_BF16.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* part, int dtype, int B, int T, int H, int Hkv, int D, int chunk,
    int nsplit, long long sqb, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh,
    long long smb, long long sob, long long soh, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > GTOT || T <= 0 || B <= 0 ||
      chunk <= 0 || chunk % (NW * TK) != 0 ||
      static_cast<long long>(chunk) * nsplit < T)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{sqb, sqh, skb, skt, skh, svb, svt, svh, smb, sob, soh,
         T, Hkv, H / Hkv, chunk, nsplit, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == REPRO_F32 && D == 64)
    err = launch<float, 64>(q, k, v, valid, o, pf, B, a, st);
  else if (dtype == REPRO_F32 && D == 128)
    err = launch<float, 128>(q, k, v, valid, o, pf, B, a, st);
  else if (dtype == REPRO_BF16 && D == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, valid, o, pf, B, a, st);
  else if (dtype == REPRO_BF16 && D == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, valid, o, pf, B, a, st);
  else if (dtype == REPRO_F32 && D == 256)
    err = launch<float, 256>(q, k, v, valid, o, pf, B, a, st);
  else if (dtype == REPRO_BF16 && D == 256)
    err = launch<__nv_bfloat16, 256>(q, k, v, valid, o, pf, B, a, st);
  return static_cast<int>(err);
}
