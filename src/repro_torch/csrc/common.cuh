// Shared helpers of the port's CUDA kernels: element loads and stores in
// fp32 or bf16, warp reductions, the shared-memory opt-in, the tensor-core
// and asynchronous-copy helpers of the bf16 attention kernels, and the
// error-string export every library carries. The kernels are bound
// through a plain C interface (ctypes).
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

// The opt-in to more than 48 KB of dynamic shared memory holds per (kernel,
// device): set it on the first launch on each device and remember that in
// the caller's flags (one static array per kernel).
constexpr int REPRO_MAX_DEVICES = 64;

template <typename Kernel>
inline cudaError_t repro_smem_optin(Kernel* kernel, size_t bytes,
                                    bool (&done)[REPRO_MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < REPRO_MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < REPRO_MAX_DEVICES) done[dev] = true;
  return err;
}

// Tensor-core and asynchronous-copy helpers of the bf16 attention kernels
// (sm_80 and later; the kernels are built for sm_90a): 16-byte cp.async
// copies with zero fill, ldmatrix fragment loads, mma.sync m16n8k16 bf16 ->
// fp32, and the hi + lo bf16 split of an fp32 P.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * gid + tig): A (16 x 16, row
// major) a0 = (gid, 2tig..+1), a1 = (gid + 8, 2tig..+1), a2 = (gid, 8 +
// 2tig..+1), a3 = (gid + 8, 8 + 2tig..+1); B (16 x 8, k x n) b0 = (2tig..+1,
// gid), b1 = (8 + 2tig..+1, gid); C (16 x 8) c0, c1 = (gid, 2tig..+1), c2, c3
// = (gid + 8, 2tig..+1).

__device__ __forceinline__ uint32_t repro_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with pred false nothing is read and the 16
// bytes are zero-filled (src-size 0), so src need not hold data.
__device__ __forceinline__ void repro_cp_async16(void* dst, const void* src,
                                                 bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   repro_smem_addr(dst)),
               "l"(src), "r"(n));
}

// The same 16 bytes through registers, for a source that is not 16-byte
// aligned: eight 2-byte loads, zero where pred is false.
__device__ __forceinline__ void repro_copy16_sync(void* dst, const void* src,
                                                  bool pred) {
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (pred) {
    const unsigned short* s = static_cast<const unsigned short*>(src);
    unsigned short* e = reinterpret_cast<unsigned short*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = s[i];
  }
  *static_cast<uint4*>(dst) = val;
}

__device__ __forceinline__ void repro_copy16(void* dst, const void* src,
                                             bool pred, bool aligned) {
  if (aligned)
    repro_cp_async16(dst, src, pred);
  else
    repro_copy16_sync(dst, src, pred);
}

__device__ __forceinline__ void repro_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void repro_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lane l gives the address of row (l & 7) of
// matrix (l >> 3), and register i receives matrix i
__device__ __forceinline__ void repro_ldsm_x4(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro_smem_addr(p)));
}

__device__ __forceinline__ void repro_ldsm_x4_trans(uint32_t (&r)[4],
                                                    const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(repro_smem_addr(p)));
}

// c += a . b, bf16 operands, fp32 accumulate
__device__ __forceinline__ void repro_mma_bf16(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t repro_pack_bf16(__nv_bfloat16 lo,
                                                    __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two fp32 values (x at the lower column) as hi = bf16(x) and lo =
// bf16(x - hi): hi + lo carries about 16 bits of x, so P . V through two
// bf16 products keeps the fp32 P's precision where one bf16 P would not.
__device__ __forceinline__ void repro_split_bf16(float x, float y,
                                                 uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 xh = __float2bfloat16(x), yh = __float2bfloat16(y);
  hi = repro_pack_bf16(xh, yh);
  lo = repro_pack_bf16(__float2bfloat16(x - __bfloat162float(xh)),
                       __float2bfloat16(y - __bfloat162float(yh)));
}

// The A fragments (hi, lo) of 16 columns of an fp32 P held as the C
// fragments of two adjacent n-tiles (columns 8j.. and 8j + 8..).
__device__ __forceinline__ void repro_p_frags(const float (&c0)[4],
                                              const float (&c1)[4],
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  repro_split_bf16(c0[0], c0[1], hi[0], lo[0]);
  repro_split_bf16(c0[2], c0[3], hi[1], lo[1]);
  repro_split_bf16(c1[0], c1[1], hi[2], lo[2]);
  repro_split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// max and sum over the four lanes of a quad (one row of a C fragment)
__device__ __forceinline__ float repro_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float repro_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

#define REPRO_EXPORT_ERROR_STRING                             \
  extern "C" const char* repro_error_string(int code) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
