// RMSNorm on Hopper (sm_90a), alone or with the residual add before it.
//
// Replaces src/repro/kernels/rmsnorm.py::rmsnorm_kernel: per row, the fp32
// mean of squares, rsqrt(var + eps), times the weight, cast back to the
// input dtype. The fused form takes the residual add that precedes almost
// every norm of the models: s = x + r, rounded once to x's dtype exactly as
// a PyTorch add rounds (the fp32 sum, then one round to nearest even), is
// written out, and y = rmsnorm(s) is computed from the rounded s.
//
// What bounds it on the H100: its launch. On the serving path a row is
// d_model wide (2048-4096) and there are 8 rows at decode and up to 64 at
// prefill: under 1 MB in all, a fraction of a microsecond at 3.35 TB/s,
// against a few microseconds to launch. Taking the add in saves the add's
// own launch and one round trip of the residual through memory. The design
// spends nothing on tiling: one block per row, D/8 threads (bf16) or D/4
// (fp32), rounded up to a warp and at most 512 (a wider row loops); each
// thread makes one 16-byte read-only load of x, of r and of the weight, all
// issued before any is used and with no branch around them, keeps its
// values in registers, and stores 16 bytes of s and of y. Elements move
// between registers and words by value, so nothing goes through local
// memory. The fp32 sum of squares reduces through warp shuffles, then
// through one partial a warp in shared memory behind a single barrier. The
// host picks this vector kernel when every row is 16-byte aligned and D a
// multiple of the vector width, else a scalar one. The weight may be fp32 or
// bf16 whatever x's dtype (an fp32 model keeps bf16 weights and widens them
// where they are used). Tried on the card and dropped as no faster: two or
// more vectors a thread, 8-byte vectors, 256-thread blocks as Triton
// launches them, 32-bit row offsets, two partial sums a thread.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 512;   // a wider row loops

// The floats in one 32-bit word of U values (one fp32 or two bf16), and
// back, by value: no register is addressed through a pointer, so nothing
// is put in local memory.
template <typename U>
struct Words;
template <>
struct Words<float> {
  static constexpr int PER = 1;
  __device__ __forceinline__ static void get(uint32_t w, float* o) {
    o[0] = __uint_as_float(w);
  }
  __device__ __forceinline__ static uint32_t put(const float* v) {
    return __float_as_uint(v[0]);
  }
};
template <>
struct Words<__nv_bfloat16> {
  static constexpr int PER = 2;
  __device__ __forceinline__ static void get(uint32_t w, float* o) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t put(const float* v) {
    // round to nearest even, as a cast does
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[0])))
           | (static_cast<uint32_t>(
                  __bfloat16_as_ushort(__float2bfloat16(v[1]))) << 16);
  }
};

// NUM elements of U from p (aligned to their size) as floats; LDG takes the
// read-only path, for inputs the kernel never writes
template <typename U, int NUM, bool LDG>
__device__ __forceinline__ void load_vec(const U* p, float (&out)[NUM]) {
  constexpr int PER = Words<U>::PER;
  constexpr int BYTES = static_cast<int>(sizeof(U)) * NUM;
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4* q = reinterpret_cast<const uint4*>(p) + c;
      const uint4 raw = LDG ? __ldg(q) : *q;
      float* o = out + c * 4 * PER;
      Words<U>::get(raw.x, o);
      Words<U>::get(raw.y, o + PER);
      Words<U>::get(raw.z, o + 2 * PER);
      Words<U>::get(raw.w, o + 3 * PER);
    }
  } else {
    static_assert(BYTES == 8, "load_vec: 8 or a multiple of 16 bytes");
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 raw = LDG ? __ldg(q) : *q;
    Words<U>::get(raw.x, out);
    Words<U>::get(raw.y, out + PER);
  }
}

// 16 bytes of T from floats, each rounded as a cast rounds
template <typename T, int NUM>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[NUM]) {
  constexpr int PER = Words<T>::PER;
  static_assert(sizeof(T) * NUM == 16, "store_vec: 16 bytes");
  *reinterpret_cast<uint4*>(p) =
      make_uint4(Words<T>::put(v), Words<T>::put(v + PER),
                 Words<T>::put(v + 2 * PER), Words<T>::put(v + 3 * PER));
}

// vector i of the row as floats: x, or with ADD s = round(x + r), which is
// also stored (the rows past what a thread keeps in registers)
template <typename T, bool ADD, int VEC>
__device__ __forceinline__ void load_row(const T* xr, const T* rr, T* so,
                                         int i, float (&v)[VEC]) {
  load_vec<T, VEC, true>(xr + i * VEC, v);
  if constexpr (ADD) {
    float rv[VEC];
    load_vec<T, VEC, true>(rr + i * VEC, rv);
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      v[u] = repro_to_float(repro_from_float<T>(v[u] + rv[u]));
    store_vec<T, VEC>(so + i * VEC, v);
  }
}

template <typename T, typename TW, int VEC>
__device__ __forceinline__ void store_row(T* yr, const TW* w, int i,
                                          const float (&v)[VEC], float inv) {
  float wv[VEC], out[VEC];
  load_vec<TW, VEC, true>(w + i * VEC, wv);
#pragma unroll
  for (int u = 0; u < VEC; ++u) out[u] = v[u] * inv * wv[u];
  store_vec<T, VEC>(yr + i * VEC, out);
}

// the block's sum of v, in every thread: one partial a warp in shared
// memory, one barrier, then every warp sums the partials itself
__device__ __forceinline__ float block_sum(float v, float* partial) {
  v = repro_warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  return repro_warp_sum(lane < static_cast<int>(blockDim.x >> 5)
                            ? partial[lane] : 0.f);
}

// 1/sqrt(x) for x >= eps > 0 (never subnormal): the hardware's
// approximation, relative error under 2^-22
__device__ __forceinline__ float rsqrt_pos(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// One block per row. x and r rows at strides sx and sr (elements, unit
// stride along D); s and y contiguous (rows, D); r and s unused without ADD.
// VECP: every row of x, r, s and y and the weight are 16-byte aligned and D
// is a multiple of the vector width (the host checks), so 16-byte vectors;
// else a scalar loop. The vector path issues every load of a thread (x, r
// and the weight; a thread past the row loads the row's last vector, and
// drops it) before it uses any, with no branch around them, so the row
// costs one round trip to memory before the sum.
template <typename T, typename TW, bool ADD, bool VECP>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const TW* __restrict__ w, T* __restrict__ s,
               T* __restrict__ y, int D, long long sx, long long sr,
               float inv_d, float eps) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  __shared__ float partial[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * sx;
  const T* rr = ADD ? r + row * sr : nullptr;
  T* so = ADD ? s + row * D : nullptr;
  T* yr = y + row * D;
  float ss = 0.f;
  if constexpr (VECP) {
    const int nv = D / VEC;
    const int nt = blockDim.x;
    // this thread's vector: loads with no branch (a thread past the row
    // loads its last vector, and drops it)
    const int i = threadIdx.x;
    const int ic = min(i, nv - 1);
    float v[VEC], rv[VEC], wv[VEC];
    load_vec<T, VEC, true>(xr + ic * VEC, v);
    if constexpr (ADD) load_vec<T, VEC, true>(rr + ic * VEC, rv);
    load_vec<TW, VEC, true>(w + ic * VEC, wv);
    if constexpr (ADD) {
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        v[u] = repro_to_float(repro_from_float<T>(v[u] + rv[u]));
      if (i < nv) store_vec<T, VEC>(so + i * VEC, v);
    }
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < VEC; ++u) part += v[u] * v[u];
    ss = i < nv ? part : 0.f;
    for (int j = i + nt; j < nv; j += nt) {   // past the block's width
      float t[VEC];
      load_row<T, ADD, VEC>(xr, rr, so, j, t);
#pragma unroll
      for (int u = 0; u < VEC; ++u) ss += t[u] * t[u];
    }
    const float inv = rsqrt_pos(block_sum(ss, partial) * inv_d + eps);
    float out[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) out[u] = v[u] * inv * wv[u];
    if (i < nv) store_vec<T, VEC>(yr + i * VEC, out);
    for (int j = i + nt; j < nv; j += nt) {   // re-read s (or x)
      float t[VEC];
      if constexpr (ADD)
        load_vec<T, VEC, false>(so + j * VEC, t);
      else
        load_vec<T, VEC, true>(xr + j * VEC, t);
      store_row<T, TW, VEC>(yr, w, j, t, inv);
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      float v = repro_to_float(xr[i]);
      if constexpr (ADD) {
        const T sv = repro_from_float<T>(v + repro_to_float(rr[i]));
        so[i] = sv;
        v = repro_to_float(sv);
      }
      ss += v * v;
    }
    const float inv = rsqrt_pos(block_sum(ss, partial) * inv_d + eps);
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float v = repro_to_float(ADD ? so[i] : xr[i]);
      yr[i] = repro_from_float<T>(v * inv * repro_to_float(w[i]));
    }
  }
}

inline bool aligned16h(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, typename TW, bool ADD, bool VECP>
void launch_one(const void* x, const void* r, const void* w, void* s,
                void* y, int rows, int threads, int D, long long sx,
                long long sr, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, TW, ADD, VECP><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const TW*>(w), static_cast<T*>(s), static_cast<T*>(y), D,
      sx, sr, 1.f / D, eps);
}

template <typename T, typename TW>
cudaError_t launch(const void* x, const void* r, const void* w, void* s,
                   void* y, int rows, int D, long long sx, long long sr,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const bool add = r != nullptr;
  // every row 16-byte aligned: the bases and the row strides
  const bool vecp = D % VEC == 0 && aligned16h(x) && sx % VEC == 0 &&
                    aligned16h(y) && aligned16h(w) &&
                    (!add || (aligned16h(r) && sr % VEC == 0 &&
                              aligned16h(s)));
  const int per = vecp ? (D + VEC - 1) / VEC : D;   // threads wanted
  const int threads = per > MAX_THREADS ? MAX_THREADS : (per + 31) / 32 * 32;
  if (add && vecp)
    launch_one<T, TW, true, true>(x, r, w, s, y, rows, threads, D, sx, sr,
                                  eps, stream);
  else if (add)
    launch_one<T, TW, true, false>(x, r, w, s, y, rows, threads, D, sx, sr,
                                   eps, stream);
  else if (vecp)
    launch_one<T, TW, false, true>(x, r, w, s, y, rows, threads, D, sx, 0,
                                   eps, stream);
  else
    launch_one<T, TW, false, false>(x, r, w, s, y, rows, threads, D, sx, 0,
                                    eps, stream);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (rows, D) at row stride sx; r (rows, D) at row stride sr, or null for
// the norm alone; w (D,) contiguous; s and y (rows, D) contiguous, s unused
// when r is null. dtype codes (ReproDType) of x, r, s, y and of w.
extern "C" int rmsnorm_fwd(const void* x, const void* r, const void* w,
                           void* s, void* y, int rows, int D, long long sx,
                           long long sr, int dtype, int wdtype, float eps,
                           void* stream) {
  if (rows <= 0 || D <= 0 || (r != nullptr && s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == REPRO_F32 && wdtype == REPRO_F32)
    err = launch<float, float>(x, r, w, s, y, rows, D, sx, sr, eps, st);
  else if (dtype == REPRO_F32 && wdtype == REPRO_BF16)
    err = launch<float, __nv_bfloat16>(x, r, w, s, y, rows, D, sx, sr, eps,
                                       st);
  else if (dtype == REPRO_BF16 && wdtype == REPRO_F32)
    err = launch<__nv_bfloat16, float>(x, r, w, s, y, rows, D, sx, sr, eps,
                                       st);
  else if (dtype == REPRO_BF16 && wdtype == REPRO_BF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, s, y, rows, D, sx,
                                               sr, eps, st);
  return static_cast<int>(err);
}
