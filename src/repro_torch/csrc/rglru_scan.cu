// RG-LRU linear recurrence on Hopper (sm_90a), alone or with the recurrent
// block's gates around it.
//
// Replaces src/repro/kernels/rglru.py::rglru_scan_kernel. Same arithmetic,
// in fp32: a_t = exp(log_a_t), h_t = a_t h_{t-1} + sqrt(clip(1 - a_t^2,
// 1e-9, 1)) x_t from h_0, returning every h_t and the last one. The
// products are rounded before the sums (__fmul_rn), as the reference rounds
// them, rather than contracted into FMAs; exp and sqrt are the
// full-precision expf and sqrtf.
//
// The fused form (rglru_gated_scan_fwd) is the recurrent block of
// src/repro/models/blocks.py::rglru_block_forward from its three products
// on. From xc, the gate pre-activations pre_i = xc W_i and pre_r = xc W_r
// (fp32), lambda and the y branch pre_y = x W_y (fp32 or bf16) it computes,
// in the block's order, gate_i = sigmoid(pre_i), log_a = -8
// softplus(lambda) sigmoid(pre_r) (softplus past 20 is the identity, as in
// PyTorch), x = gate_i xc, the scan, and out = h_t gelu_tanh(pre_y) cast to
// pre_y's dtype. No gate and no h_t goes to memory: it writes out and
// h_last. The block calls it at every length, a decode step's one token
// included, where it made 16 elementwise launches around the scan.
//
// What bounds it on the H100: bytes in principle (x and log_a in, y out:
// 12 bytes an element; the fused form 16 in bf16), but at the serving
// shapes (x (1, 64, 4096) at prefill, (8, 1, 4096) at decode, 0.4-4 MB)
// the latency of one round of loads and then instruction throughput: the fused
// form spends some 100 instructions an element on two sigmoids, two expf,
// a sqrtf, a tanhf and an IEEE division. One thread per lane walking all
// of time (the first port) put batch 1 on 32 of 132 SMs, each thread 64
// steps deep. So the design splits time as well as width, and gives each
// thread few elements so that an SM holds many warps to hide the latency:
// a block owns a tile of tw lanes of W (a warp reads tw consecutive floats,
// 64 or 128 bytes) and a time tile of nc chunks of CH steps (4; 1 at a
// decode step); thread (g, c) takes lane g of chunk c. It starts every
// load of its chunk before it uses any, scans the chunk from zero keeping
// the running product of a, and puts the chunk's (product, end state) in
// shared memory. After one barrier each thread folds the chunks before its
// own onto the tile's incoming state, which is the recurrence at chunk
// granularity, to get its carry, and fixes its steps up: y_t = local_t +
// A_t carry, A_t the running product. Every thread folds all nc chunks, so
// all hold the tile's end state, which carries to the next time tile in
// registers (shared memory is double-buffered: one barrier a tile). The
// fold of the last chunk is the fix-up of its last step, so h_last is the
// last y bit for bit. rglru.plan halves tw until the grid holds two blocks
// an SM: at batch 1, S = 64, W = 4096, 256 blocks of 16 lanes x 16 chunks.
// Tried on the H100 and dropped as slower at these shapes: 16-byte vector
// loads of 4 lanes a thread (fewer threads an SM, or a deeper fold),
// chunks of 8 steps, and 512-thread blocks. tools/rglru_plans.py times the
// kernel under other tiles and chunk lengths.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // threads of a block (rglru.MAX_THREADS)

struct Args {
  const float* in0;   // x (scan) or xc (fused)
  const float* in1;   // log_a (scan) or pre_i (fused)
  const float* in2;   // pre_r (fused)
  const float* lam;   // lambda, (W,) (fused)
  const void* pre_y;  // (fused) in the output's dtype
  const float* h0;
  void* y;            // ys fp32 (scan) or out (fused), contiguous (B,S,W)
  float* h_last;      // contiguous (B,W)
  int S, W, tw, nc;
  long long sb[4], ss[4];  // batch and seq strides of in0, in1, in2, pre_y
  long long shb;           // batch stride of h0
};

// read-only loads as floats
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// the formulas of PyTorch's CUDA sigmoid, softplus (beta 1, threshold 20)
// and tanh-approximated gelu
__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ float softplus(float z) {
  return z > 20.f ? z : log1pf(expf(z));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// Grid (ceil(W / tw), B), tw * nc threads, 16 nc tw bytes of dynamic shared
// memory: [2 buffers][products, end states][nc chunks][tw lanes]. Thread
// (g, c) = (threadIdx.x % tw, threadIdx.x / tw).
template <int CH, bool FUSED, typename TY>
__global__ void __launch_bounds__(MAX_THREADS)
rglru_scan_kernel(const Args p) {
  extern __shared__ float smem[];
  const int g = threadIdx.x % p.tw, c = threadIdx.x / p.tw;
  const int w = blockIdx.x * p.tw + g;
  const int b = blockIdx.y;
  const int S = p.S;
  const bool lane = w < p.W;
  const float* in0 = p.in0 + b * p.sb[0] + w;
  const float* in1 = p.in1 + b * p.sb[1] + w;
  const float* in2 = FUSED ? p.in2 + b * p.sb[2] + w : nullptr;
  const TY* py = FUSED ? static_cast<const TY*>(p.pre_y) + b * p.sb[3] + w
                       : nullptr;
  TY* yo = static_cast<TY*>(p.y) + static_cast<long long>(b) * S * p.W + w;

  float h = 0.f, cneg = 0.f;  // the carry; -8 softplus(lambda)
  if (lane) {
    h = load(p.h0 + b * p.shb + w);
    if constexpr (FUSED) cneg = -8.f * softplus(load(p.lam + w));
  }

  const int tile = p.nc * p.tw;
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += CH * p.nc, buf ^= 1) {
    const int ts = t0 + c * CH;
    // every load of the chunk, before any is used
    float r0[CH], r1[CH], r2[CH], ry[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      if (lane && ts + u < S) {
        const long long t = ts + u;
        r0[u] = load(in0 + t * p.ss[0]);
        r1[u] = load(in1 + t * p.ss[1]);
        if constexpr (FUSED) {
          r2[u] = load(in2 + t * p.ss[2]);
          ry[u] = load(py + t * p.ss[3]);
        }
      }
    }
    // a and the scaled input; a step past S is the identity (a 1, x 0)
    float a[CH], gx[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      a[u] = 1.f;
      gx[u] = 0.f;
      if (lane && ts + u < S) {
        float la = r1[u], xv = r0[u];
        if constexpr (FUSED) {
          la = __fmul_rn(cneg, sigmoid(r2[u]));
          xv = __fmul_rn(sigmoid(r1[u]), r0[u]);
          ry[u] = gelu_tanh(ry[u]);
        }
        const float at = expf(la);
        const float om = fminf(fmaxf(1.f - __fmul_rn(at, at), 1e-9f), 1.f);
        a[u] = at;
        gx[u] = __fmul_rn(sqrtf(om), xv);
      }
    }
    // the chunk from zero: gx becomes the local state, a the running
    // product of a
#pragma unroll
    for (int u = 1; u < CH; ++u) {
      gx[u] = __fmul_rn(a[u], gx[u - 1]) + gx[u];
      a[u] = __fmul_rn(a[u - 1], a[u]);
    }
    float* sA = smem + buf * 2 * tile;
    float* sH = sA + tile;
    sA[c * p.tw + g] = a[CH - 1];
    sH[c * p.tw + g] = gx[CH - 1];
    __syncthreads();
    // the fold: the carry into chunk c, and the tile's end state
    float cin = h;
#pragma unroll 4
    for (int j = 0; j < p.nc; ++j) {
      if (j == c) cin = h;
      h = __fmul_rn(sA[j * p.tw + g], h) + sH[j * p.tw + g];
    }
    // the fix-up, and the output gate of the fused form
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      if (lane && ts + u < S) {
        float yv = __fmul_rn(a[u], cin) + gx[u];
        if constexpr (FUSED) yv = __fmul_rn(yv, ry[u]);
        yo[static_cast<long long>(ts + u) * p.W] = repro_from_float<TY>(yv);
      }
    }
  }
  if (lane && c == 0) p.h_last[static_cast<long long>(b) * p.W + w] = h;
}

bool plan_ok(int B, int S, int W, int tw, int ch, int nc) {
  return B > 0 && S > 0 && W > 0 && B <= 65535 &&
         (ch == 1 || ch == 2 || ch == 4) && tw >= 1 && tw <= 32 &&
         nc >= 1 && tw * nc <= MAX_THREADS;
}

template <int CH, bool FUSED, typename TY>
int launch(const Args& a, int B, void* stream) {
  const dim3 grid((a.W + a.tw - 1) / a.tw, B);
  const size_t smem = 4 * sizeof(float) * a.nc * a.tw;
  rglru_scan_kernel<CH, FUSED, TY>
      <<<grid, a.tw * a.nc, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool FUSED, typename TY>
int dispatch(const Args& a, int B, int ch, void* stream) {
  if (ch == 1) return launch<1, FUSED, TY>(a, B, stream);
  if (ch == 2) return launch<2, FUSED, TY>(a, B, stream);
  return launch<4, FUSED, TY>(a, B, stream);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x, log_a (B,S,W) fp32 with unit W stride, strides in elements; h0 (B,W)
// fp32 with unit W stride; y (B,S,W) and h_last (B,W) fp32, contiguous. tw,
// ch and nc from rglru.plan.
extern "C" int rglru_scan_fwd(const void* x, const void* log_a,
                              const void* h0, void* y, void* h_last, int B,
                              int S, int W, long long sxb, long long sxs,
                              long long sab, long long sas, long long shb,
                              int tw, int ch, int nc, void* stream) {
  if (!plan_ok(B, S, W, tw, ch, nc))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.in0 = static_cast<const float*>(x);
  a.in1 = static_cast<const float*>(log_a);
  a.h0 = static_cast<const float*>(h0);
  a.y = y;
  a.h_last = static_cast<float*>(h_last);
  a.S = S, a.W = W, a.tw = tw, a.nc = nc;
  a.sb[0] = sxb, a.ss[0] = sxs, a.sb[1] = sab, a.ss[1] = sas, a.shb = shb;
  return dispatch<false, float>(a, B, ch, stream);
}

// The fused form. xc, pre_i, pre_r (B,S,W) fp32 and pre_y (B,S,W) in
// dtype (ReproDType: fp32 or bf16), each with unit W stride and its own
// batch and seq strides; lam (W,) fp32 contiguous; h0 (B,W) fp32 with unit
// W stride; out (B,S,W) in dtype and h_last (B,W) fp32, contiguous.
extern "C" int rglru_gated_scan_fwd(
    const void* xc, const void* pre_i, const void* pre_r, const void* lam,
    const void* pre_y, const void* h0, void* out, void* h_last, int B, int S,
    int W, long long sxb, long long sxs, long long sib, long long sis,
    long long srb, long long srs, long long syb, long long sys,
    long long shb, int tw, int ch, int nc, int dtype, void* stream) {
  if (!plan_ok(B, S, W, tw, ch, nc) ||
      (dtype != REPRO_F32 && dtype != REPRO_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.in0 = static_cast<const float*>(xc);
  a.in1 = static_cast<const float*>(pre_i);
  a.in2 = static_cast<const float*>(pre_r);
  a.lam = static_cast<const float*>(lam);
  a.pre_y = pre_y;
  a.h0 = static_cast<const float*>(h0);
  a.y = out;
  a.h_last = static_cast<float*>(h_last);
  a.S = S, a.W = W, a.tw = tw, a.nc = nc;
  a.sb[0] = sxb, a.ss[0] = sxs, a.sb[1] = sib, a.ss[1] = sis;
  a.sb[2] = srb, a.ss[2] = srs, a.sb[3] = syb, a.ss[3] = sys, a.shb = shb;
  return dtype == REPRO_BF16
             ? dispatch<true, __nv_bfloat16>(a, B, ch, stream)
             : dispatch<true, float>(a, B, ch, stream);
}
