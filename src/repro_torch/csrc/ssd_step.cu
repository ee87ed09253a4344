// Mamba-2's recurrent decode step on Hopper (sm_90a): one token through the
// SSD state of every (row, head), the state updated in place.
//
// Replaces no Pallas kernel: the JAX package computes the step in plain jnp
// (src/repro/models/blocks.py::ssd_block_forward, its S == 1 branch), and so
// did the port, in six PyTorch passes over the (B, H, P, N) fp32 state (the
// outer product B x^T into a full-size temporary, its scaling by dt, the
// state's scaling by exp(-dt A), the add, and the C . S' product): about
// nine state-sized transfers a layer. For each (row b, head h) the kernel
// computes
//
//   S' = exp(-dt A) S + dt (B x^T)     (P x N, written over S)
//   y  = S' C + D x                     (P)
//
// with the update rounded as the plain step rounds it: dt * (B * x), then
// S * dA, then their sum, each product and sum rounded alone (__fmul_rn and
// __fadd_rn, which are never contracted into an FMA), and dA = exp(-(dt A))
// in the same order. The new state so equals the plain step's bit for bit;
// only y's sum over N runs in another order than the plain product's.
//
// What bounds it on the H100: the state's bytes, read once and written
// once: P x N fp32 each way a (row, head), 32 KB at mamba2-1.3b's 64 x 128,
// so 268 MB a layer at batch 64 (80 us at 3.35 TB/s); x, B, C, dt and y add
// under 1%. The design is a plain stream. One block takes a (row, head),
// 4,096 blocks a layer at batch 64, so every SM holds several. Each row p
// of S is read as float4s by N / 4 lanes (at N = 128 one warp a row, one
// float4 a lane), and each thread issues the loads of all of its rows (8,
// 128 bytes) before it uses any, so that a block keeps 32 KB in flight.
// The loads and stores of the state carry the evict-first hint, since
// nothing reads it again within the step. B and C of the head's group, x,
// dt, A and D come through the read-only path: they are small, and the
// heads of a row share B and C. y_p is summed over N by the lanes of its
// row, by shuffles: no atomics and no second pass, so the result does not
// depend on the order in which blocks run, and a CUDA graph replays the
// eager step bit for bit.
#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 8;
constexpr int LOADS = 8;   // float4 loads of the state a thread issues first

// How a block walks a (P x N) state of width N: float4s a row, lanes a row
// (up to a warp), float4s a lane of a row, rows a warp, and rows a thread
// takes at once (LOADS float4s).
template <int N>
struct Walk {
  static_assert(N % 4 == 0, "N must be a whole number of float4s");
  static constexpr int VECS = N / 4;
  static constexpr int LANES = VECS < 32 ? VECS : 32;
  static_assert(32 % LANES == 0 && VECS % LANES == 0, "no such walk");
  static constexpr int PER_LANE = VECS / LANES;
  static constexpr int ROWS_WARP = 32 / LANES;
  static constexpr int K = LOADS / PER_LANE > 0 ? LOADS / PER_LANE : 1;
};

// S * dA + dt * (B * x), rounded as the plain step rounds it
__device__ __forceinline__ float update(float s, float b, float x, float dt,
                                        float dA) {
  return __fadd_rn(__fmul_rn(s, dA), __fmul_rn(dt, __fmul_rn(b, x)));
}

template <int N>
__global__ void __launch_bounds__(MAX_WARPS * 32)
ssd_step_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                float* __restrict__ state, float* __restrict__ y, int H,
                int P, int rep, long long sxb, long long sxh, long long sdb,
                long long sbb, long long sbg, long long scb, long long scg,
                long long ssb, long long ssh, long long ssp, long long syb,
                long long syh) {
  using W = Walk<N>;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H, g = h / rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int sub = lane / W::LANES;   // the warp's row this lane takes
  const int col = lane % W::LANES;   // its float4 within the row's lanes
  const float dtv = __ldg(dt + b * sdb + h);
  const float dA = expf(-__fmul_rn(dtv, __ldg(A + h)));
  const float Dv = __ldg(D + h);
  const float* xr = x + b * sxb + h * sxh;
  const float* br = Bm + b * sbb + g * sbg;
  const float* cr = Cm + b * scb + g * scg;
  float* sr = state + b * ssb + h * ssh;
  float* yr = y + b * syb + h * syh;
  // this lane's columns of B and C: n = 4 (v LANES + col) + j
  float bv[W::PER_LANE][4], cv[W::PER_LANE][4];
#pragma unroll
  for (int v = 0; v < W::PER_LANE; ++v)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * (v * W::LANES + col) + j;
      bv[v][j] = __ldg(br + n);
      cv[v][j] = __ldg(cr + n);
    }
  const int rows_pass = warps * W::ROWS_WARP * W::K;
  for (int p0 = 0; p0 < P; p0 += rows_pass) {
    float4 s[W::K][W::PER_LANE];
    float xv[W::K];
    // every load of the pass first
#pragma unroll
    for (int k = 0; k < W::K; ++k) {
      const int p = p0 + (k * warps + warp) * W::ROWS_WARP + sub;
      xv[k] = 0.0f;
#pragma unroll
      for (int v = 0; v < W::PER_LANE; ++v) {
        s[k][v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (p < P)
          s[k][v] = __ldcs(reinterpret_cast<const float4*>(sr + p * ssp) +
                           v * W::LANES + col);
      }
      if (p < P) xv[k] = __ldg(xr + p);
    }
#pragma unroll
    for (int k = 0; k < W::K; ++k) {
      const int p = p0 + (k * warps + warp) * W::ROWS_WARP + sub;
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < W::PER_LANE; ++v) {
        float4 t = s[k][v];
        t.x = update(t.x, bv[v][0], xv[k], dtv, dA);
        t.y = update(t.y, bv[v][1], xv[k], dtv, dA);
        t.z = update(t.z, bv[v][2], xv[k], dtv, dA);
        t.w = update(t.w, bv[v][3], xv[k], dtv, dA);
        acc = fmaf(cv[v][0], t.x, acc);
        acc = fmaf(cv[v][1], t.y, acc);
        acc = fmaf(cv[v][2], t.z, acc);
        acc = fmaf(cv[v][3], t.w, acc);
        if (p < P)
          __stcs(reinterpret_cast<float4*>(sr + p * ssp) + v * W::LANES + col,
                 t);
      }
      // the row's sum over its lanes (every lane of the warp shuffles)
#pragma unroll
      for (int o = W::LANES / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(REPRO_FULL_MASK, acc, o);
      if (p < P && col == 0) yr[p] = __fadd_rn(acc, __fmul_rn(Dv, xv[k]));
    }
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* B, const float* C, const float* D,
                   float* state, float* y, int batch, int H, int P, int G,
                   long long sxb, long long sxh, long long sdb, long long sbb,
                   long long sbg, long long scb, long long scg,
                   long long ssb, long long ssh, long long ssp,
                   long long syb, long long syh, cudaStream_t st) {
  using W = Walk<N>;
  const int per_warp = W::ROWS_WARP * W::K;
  int warps = (P + per_warp - 1) / per_warp;
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  ssd_step_kernel<N><<<batch * H, warps * 32, 0, st>>>(
      x, dt, A, B, C, D, state, y, H, P, H / G, sxb, sxh, sdb, sbb, sbg, scb,
      scg, ssb, ssh, ssp, syb, syh);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (batch, H, P); dt (batch, H); A, D (H,); B, C (batch, G, N); state
// (batch, H, P, N), updated in place; y (batch, H, P). All fp32, each last
// dim unit-strided, the state's rows 16-byte aligned. N is one of 16, 32,
// 64, 128 and 256.
extern "C" int ssd_step_fwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* D,
                            void* state, void* y, int batch, int H, int P,
                            int N, int G, long long sxb, long long sxh,
                            long long sdb, long long sbb, long long sbg,
                            long long scb, long long scg, long long ssb,
                            long long ssh, long long ssp, long long syb,
                            long long syh, void* stream) {
  if (batch <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G ||
      static_cast<long long>(batch) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x),
              *df = static_cast<const float*>(dt),
              *af = static_cast<const float*>(A),
              *bf = static_cast<const float*>(B),
              *cf = static_cast<const float*>(C),
              *Df = static_cast<const float*>(D);
  float* sf = static_cast<float*>(state);
  float* yf = static_cast<float*>(y);
#define REPRO_SSD_STEP(NN)                                                  \
  case NN:                                                                  \
    return static_cast<int>(launch<NN>(xf, df, af, bf, cf, Df, sf, yf,      \
                                       batch, H, P, G, sxb, sxh, sdb, sbb, \
                                       sbg, scb, scg, ssb, ssh, ssp, syb,  \
                                       syh, st));
  switch (N) {
    REPRO_SSD_STEP(16)
    REPRO_SSD_STEP(32)
    REPRO_SSD_STEP(64)
    REPRO_SSD_STEP(128)
    REPRO_SSD_STEP(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SSD_STEP
}
