// Mamba-2 SSD chunked scan on Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd.py::ssd_scan_kernel. Same arithmetic, in
// fp32 throughout: per (batch, head), walk the chunks in order carrying the
// (P, N) state; inside a chunk of c positions, with dA = dt * A and
// seg = cumsum(dA),
//   y_i   = sum_{j <= i} (C_i . B_j) exp(-(seg_i - seg_j)) dt_j x_j
//           + exp(-seg_i) C_i . S_prev
//   S_new = exp(-seg_last) S_prev + sum_j exp(-(seg_last - seg_j)) dt_j x_j B_j^T
// Head h reads B and C of group h / (H / G) in place, with no copy. The
// state starts at 0, and y and the final state come out in fp32.
//
// What bounds it on the H100: operations over long prompts (at one chunk of
// 64 tokens, bytes and operations about even). At Mamba-2's serving shapes
// (H = 64, P = 64, N = 128, chunks of up to 128) a chunk costs about
// c^2 N / 2 + c P (c / 2 + N) + c P N multiply-adds per head (the first
// chunk skips the c P N of C.S_prev: its incoming state is 0) against
// c (2N + P) input floats, so it is compute-heavy, and it must stay fp32
// (no TF32: the model holds it to 2e-4). The design is the simple one:
// one block of 256 threads per (batch, head), the state in shared memory
// for the whole sequence, and per chunk the chunk's B, C and x staged in
// shared memory (B and C rows padded to N + 1 so that lanes walking
// different rows hit different banks). The (c, c) decay-masked C.B^T
// matrix is never held whole: it is built RT rows at a time, used for those
// rows' outputs, and dropped, so chunk 128 at N 128 fits in 208 KB. All
// products are fp32 FMAs on the CUDA cores, and entries above the causal
// diagonal are skipped.
//
// The cumulative log-decay seg is summed and kept in fp64. At Mamba-2's
// decay rates (A up to 16, dt about 1) seg reaches several hundred within
// a chunk, where an fp32 ulp is about 6e-5, and the decays
// exp(-(seg_i - seg_j)) take a difference of two such sums: in fp32 that
// cancellation alone puts errors of 1e-5 to 1e-4 into every decay, which
// 48 layers of mamba2-1.3b grow past the model's 2e-4 tolerance. In fp64
// the differences are exact to fp32 precision, as the token-by-token
// recurrence is.
#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads per block
constexpr int RT = 16;         // rows of the decay-masked C.B^T built at once
constexpr int CMAX = 128;      // longest chunk

struct Args {
  long long sxb, sxs, sxh;     // x (b, s, h, p), unit p stride
  long long sdb, sds, sdh;     // dt (b, s, h)
  long long sbb, sbs, sbg;     // B (b, s, g, n), unit n stride
  long long scb, scs, scg;     // C (b, s, g, n), unit n stride
  int S, H, P, G, N, chunk;
};

inline size_t smem_floats(int c, int P, int N) {
  return static_cast<size_t>(P) * (N + 1)      // state
         + 2 * static_cast<size_t>(c) * (N + 1)  // B, C
         + static_cast<size_t>(c) * P          // x
         + static_cast<size_t>(RT) * c         // rows of C.B^T
         + 5 * static_cast<size_t>(c);         // seg (fp64), dt, exp(-seg), w
}

__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state_out, Args a) {
  const int P = a.P, N = a.N, c = a.chunk, NP = N + 1;
  extern __shared__ __align__(16) float smem[];
  double* segs = reinterpret_cast<double*>(smem);   // [c], fp64
  float* Ss = smem + 2 * c;                // [P][N + 1]
  float* Bs = Ss + P * NP;                 // [c][N + 1]
  float* Cs = Bs + c * NP;                 // [c][N + 1]
  float* xs = Cs + c * NP;                 // [c][P]
  float* att = xs + c * P;                 // [RT][c]
  float* dts = att + RT * c;               // [c]
  float* es = dts + c;                     // [c] exp(-seg_i)
  float* ws = es + c;                      // [c] exp(-(seg_last - seg_j)) dt_j

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int grp = h / (a.H / a.G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float Ah = A[h];

  for (int e = tid; e < P * N; e += NT) Ss[(e / N) * NP + e % N] = 0.f;

  const float* xb = x + b * a.sxb + h * a.sxh;
  const float* db = dt + b * a.sdb + h * a.sdh;
  const float* Bb = Bm + b * a.sbb + grp * a.sbg;
  const float* Cb = Cm + b * a.scb + grp * a.scg;
  float* yb = y + (static_cast<long long>(b) * a.S * a.H + h) * P;

  for (int t0 = 0; t0 < a.S; t0 += c) {
    // stage the chunk's B, C, x and dt
    for (int e = tid; e < c * N; e += NT) {
      const int i = e / N, n = e % N;
      Bs[i * NP + n] = Bb[(t0 + i) * a.sbs + n];
      Cs[i * NP + n] = Cb[(t0 + i) * a.scs + n];
    }
    for (int e = tid; e < c * P; e += NT) {
      const int i = e / P, p = e % P;
      xs[e] = xb[(t0 + i) * a.sxs + p];
    }
    for (int i = tid; i < c; i += NT) dts[i] = db[(t0 + i) * a.sds];
    __syncthreads();

    // seg = cumsum(dt * A) in fp64: warp 0, up to four consecutive entries
    // a lane
    if (tid < 32) {
      const int per = (c + 31) / 32;
      const int lo = lane * per;
      double run = 0.0;
      double loc[CMAX / 32];
#pragma unroll
      for (int u = 0; u < CMAX / 32; ++u) {
        if (u < per && lo + u < c)
          run += static_cast<double>(dts[lo + u] * Ah);
        loc[u] = run;
      }
      double incl = run;                   // inclusive scan of lane totals
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(REPRO_FULL_MASK, incl, o);
        if (lane >= o) incl += v;
      }
      const double off = incl - run;
#pragma unroll
      for (int u = 0; u < CMAX / 32; ++u)
        if (u < per && lo + u < c) segs[lo + u] = loc[u] + off;
    }
    __syncthreads();
    const double seg_last = segs[c - 1];
    for (int i = tid; i < c; i += NT) {
      es[i] = expf(-static_cast<float>(segs[i]));
      ws[i] = expf(-static_cast<float>(seg_last - segs[i])) * dts[i];
    }
    __syncthreads();

    for (int i0 = 0; i0 < c; i0 += RT) {
      const int rows = min(RT, c - i0);
      // rows i0.. of att = (C.B^T) * decay * dt_j, zero above the diagonal
      for (int e = tid; e < rows * c; e += NT) {
        const int ii = e / c, j = e % c, i = i0 + ii;
        float v = 0.f;
        if (j <= i) {
          const float* cr = Cs + i * NP;
          const float* br = Bs + j * NP;
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot = fmaf(cr[n], br[n], dot);
          v = dot * expf(-static_cast<float>(segs[i] - segs[j])) * dts[j];
        }
        att[ii * c + j] = v;
      }
      __syncthreads();
      // y rows: att . x plus the incoming state's term
      for (int e = tid; e < rows * P; e += NT) {
        const int ii = e / P, p = e % P, i = i0 + ii;
        float acc = 0.f;
        for (int j = 0; j <= i; ++j)
          acc = fmaf(att[ii * c + j], xs[j * P + p], acc);
        float inter = 0.f;
        if (t0 > 0) {                      // the state is 0 before chunk 0
          const float* cr = Cs + i * NP;
          const float* sr = Ss + p * NP;
          for (int n = 0; n < N; ++n) inter = fmaf(cr[n], sr[n], inter);
        }
        yb[static_cast<long long>(t0 + i) * a.H * P + p] = acc + es[i] * inter;
      }
      __syncthreads();
    }

    // S = exp(-seg_last) S + sum_j w_j x_j B_j^T; each entry is read and
    // written by one thread, after every y row has read the old state
    const float decay = expf(-static_cast<float>(seg_last));
    for (int e = tid; e < P * N; e += NT) {
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int j = 0; j < c; ++j)
        acc = fmaf(xs[j * P + p] * ws[j], Bs[j * NP + n], acc);
      Ss[p * NP + n] = decay * Ss[p * NP + n] + acc;
    }
    __syncthreads();
  }

  float* so = state_out + static_cast<long long>(bh) * P * N;
  for (int e = tid; e < P * N; e += NT) so[e] = Ss[(e / N) * NP + e % N];
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,g,n): fp32, strides in
// elements, unit stride on p and n, A contiguous. y (b,s,h,p) and
// state (b,h,p,n): fp32, contiguous. chunk divides s and is at most 128;
// h is a multiple of g. A launch whose shared memory exceeds the card's
// opt-in limit is refused by cudaFuncSetAttribute, and its error returned.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, int b, int s, int h, int p, int g,
    int n, int chunk, long long sxb, long long sxs, long long sxh,
    long long sdb, long long sds, long long sdh, long long sbb,
    long long sbs, long long sbg, long long scb, long long scs,
    long long scg, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || g <= 0 || n <= 0 ||
      h % g != 0 || chunk <= 0 || chunk > CMAX || s % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(chunk, p, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg,
         s, h, p, g, n, chunk};
  ssd_scan_kernel<<<b * h, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(state), a);
  return static_cast<int>(cudaGetLastError());
}
