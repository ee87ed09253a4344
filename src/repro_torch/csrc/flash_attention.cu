// Causal (or non-causal) GQA flash attention for prefill on Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_bhsd, the
// Pallas streaming-softmax kernel. Same arithmetic: q pre-scaled by
// D^-0.5, running (m, l, acc) in fp32 over KV tiles, query head h reads kv
// head h / G, rows with l == 0 divide by 1.
//
// What bounds it on the H100: at the serving path's prefill shapes
// (S <= 64, H = 24, D = 128) the inputs are under 1 MB, so a launch costs
// more than its bytes (about 0.2 us at 3.35 TB/s) or its operations.
// The design is the simple one: one block per (b*h, 32-row query tile),
// four warps with eight query rows each, K/V tiles of 32 keys staged in
// shared memory as fp32, one key per lane for the scores and strided
// output dims per lane for P.V. No tensor cores: fp32 inputs stay full
// fp32 (no TF32), and bf16 inputs are widened to fp32 on load. Tiles wholly
// above the causal diagonal are never loaded. q, k and v are read through
// their (B, S, H, D) strides, so no transposed copy is made.
#include "common.cuh"

namespace {

constexpr int BQ = 32;               // query rows per block
constexpr int BK = 32;               // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int RPW = BQ / NWARPS;     // query rows per warp

struct Strides {
  long long b, s, h;                 // element strides; the D stride is 1
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int G, Strides sq, Strides sk, Strides sv, Strides so,
                 float scale, int causal) {
  constexpr int DPL = D / 32;        // output dims per lane: lane + 32*i
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D], pre-scaled
  float* ks = qs + BQ * D;           // [BK][D + 1]: padded, no bank clash
  float* vs = ks + BK * (D + 1);     // [BK][D]

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < BQ * D; i += NWARPS * 32) {
    const int r = i / D, d = i % D, s = q0 + r;
    qs[i] = s < S ? repro_to_float(q[b * sq.b + s * sq.s + h * sq.h + d]) *
                        scale
                  : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = REPRO_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;   // skip tiles above diagonal
  for (int t0 = 0; t0 < kv_end; t0 += BK) {
    __syncthreads();                 // Q staged / previous tile consumed
    for (int i = tid; i < BK * D; i += NWARPS * 32) {
      const int j = i / D, d = i % D, t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < S) {
        kx = repro_to_float(k[b * sk.b + t * sk.s + hk * sk.h + d]);
        vx = repro_to_float(v[b * sv.b + t * sv.s + hk * sv.h + d]);
      }
      ks[j * (D + 1) + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int s = q0 + r;
      // warp-uniform skips: padded rows, tiles above this row's diagonal
      if (s >= S || (causal && t0 > s)) continue;
      const float* qr = qs + r * D;
      const float* kr = ks + lane * (D + 1);
      float sc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
      const int t = t0 + lane;
      const bool ok = t < S && (!causal || t <= s);
      sc = ok ? sc : REPRO_NEG_INF;
      const float m_new = fmaxf(m[rr], repro_warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = alpha * l[rr] + repro_warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(REPRO_FULL_MASK, p, j);
        const float* vr = vs + j * D + lane;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[rr][i] = fmaf(pj, vr[32 * i],
                                                         acc[rr][i]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int s = q0 + warp * RPW + rr;
    if (s >= S) continue;
    const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
    T* orow = o + b * so.b + s * so.s + h * so.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      orow[lane + 32 * i] = repro_from_float<T>(acc[rr][i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int G, Strides sq, Strides sk,
                   Strides sv, Strides so, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB of dynamic shared memory needs an opt-in, which holds per
  // device: set it on every launch (a cheap host call), so a launch on any
  // card of the process gets it.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, G, sq, sk, sv, so,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q (B,S,H,D), k/v (B,S,Hkv,D), o (B,S,H,D), each with a unit D stride;
// strides in elements. D is 64 or 128; dtype is REPRO_F32 or REPRO_BF16.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int Hkv, int D, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, long long sob,
    long long sos, long long soh, float scale, int causal, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || S <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh},
      so{sob, sos, soh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == REPRO_F32 && D == 64)
    err = launch<float, 64>(q, k, v, o, B, S, H, G, sq, sk, sv, so, scale,
                            causal, st);
  else if (dtype == REPRO_F32 && D == 128)
    err = launch<float, 128>(q, k, v, o, B, S, H, G, sq, sk, sv, so, scale,
                             causal, st);
  else if (dtype == REPRO_BF16 && D == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, G, sq, sk, sv, so,
                                    scale, causal, st);
  else if (dtype == REPRO_BF16 && D == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, G, sq, sk, sv,
                                     so, scale, causal, st);
  return static_cast<int>(err);
}
