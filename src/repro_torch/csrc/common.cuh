// Shared helpers of the port's CUDA kernels: element loads and stores in
// fp32 or bf16, warp reductions, and the error-string export every library
// carries. The kernels are bound through a plain C interface (ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_NEG_INF (-1e30f)
#define REPRO_FULL_MASK 0xffffffffu

// dtype codes shared with the Python wrappers
enum ReproDType { REPRO_F32 = 0, REPRO_BF16 = 1 };

__device__ __forceinline__ float repro_to_float(float x) { return x; }
__device__ __forceinline__ float repro_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T repro_from_float(float x);
template <>
__device__ __forceinline__ float repro_from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 repro_from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast does
}

__device__ __forceinline__ float repro_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(REPRO_FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float repro_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, o);
  return v;
}

#define REPRO_EXPORT_ERROR_STRING                             \
  extern "C" const char* repro_error_string(int code) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
