// RG-LRU linear recurrence on Hopper (sm_90a).
//
// Replaces src/repro/kernels/rglru.py::rglru_scan_kernel. Same arithmetic,
// in fp32: a_t = exp(log_a_t), h_t = a_t h_{t-1} + sqrt(clip(1 - a_t^2,
// 1e-9, 1)) x_t from h_0, returning every h_t and the last one. The
// products a*a and a*h are rounded before the sums, as the reference
// rounds them, rather than contracted into FMAs.
//
// What bounds it on the H100: bytes. Per element it reads x and log_a and
// writes y (12 bytes) for a handful of operations. The design: one thread
// per (batch, width) lane walking time in registers, so the recurrence
// needs no communication at all; neighbouring threads take neighbouring
// lanes, so every load and store of a time step is coalesced along W. A
// thread issues the loads of U time steps before it uses any of them, to
// keep U loads in flight against the memory latency. With B = 1 and
// W = 4096 that is only 4096 threads, so at short lengths the kernel is
// bound by latency, not by bandwidth; splitting time across blocks is work
// for a later change.
#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads per block: lanes of W
constexpr int U = 16;     // time steps loaded ahead

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ x,
                  const float* __restrict__ log_a,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int W, long long sxb,
                  long long sxs, long long sab, long long sas,
                  long long shb) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const float* xp = x + b * sxb + w;
  const float* ap = log_a + b * sab + w;
  float* yp = y + static_cast<long long>(b) * S * W + w;
  float h = h0[b * shb + w];
  for (int t0 = 0; t0 < S; t0 += U) {
    float xv[U], av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        xv[u] = xp[(t0 + u) * sxs];
        av[u] = ap[(t0 + u) * sas];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        const float at = expf(av[u]);
        const float om = fminf(fmaxf(1.f - __fmul_rn(at, at), 1e-9f), 1.f);
        h = __fmul_rn(at, h) + __fmul_rn(sqrtf(om), xv[u]);
        yp[static_cast<long long>(t0 + u) * W] = h;
      }
    }
  }
  h_last[static_cast<long long>(b) * W + w] = h;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x, log_a (B,S,W) fp32 with unit W stride, strides in elements; h0 (B,W)
// fp32 with unit W stride; y (B,S,W) and h_last (B,W) fp32, contiguous.
extern "C" int rglru_scan_fwd(const void* x, const void* log_a,
                              const void* h0, void* y, void* h_last, int B,
                              int S, int W, long long sxb, long long sxs,
                              long long sab, long long sas, long long shb,
                              void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + NT - 1) / NT, B);
  rglru_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(log_a),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), S, W, sxb, sxs, sab, sas, shb);
  return static_cast<int>(cudaGetLastError());
}
