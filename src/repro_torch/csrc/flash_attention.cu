// Causal (or non-causal) GQA flash attention for prefill on Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_bhsd, the
// Pallas streaming-softmax kernel. Same arithmetic: scores scaled by
// D^-0.5, running (m, l, acc) in fp32 over KV tiles, query head h reads kv
// head h / G, rows with l == 0 divide by 1, tiles wholly above the causal
// diagonal never loaded. q, k and v are read through their (B, S, H, D)
// strides, so no transposed copy is made.
//
// What bounds it on the H100: at the serving path's prefill shapes
// (S <= 64, H = 24, D = 128) the inputs are under 1 MB, so latency bounds
// it (a launch, a round of loads, the dependent steps of each tile), not
// its bytes (about 0.3 us at 3.35 TB/s) or its operations.
//
// Two paths. bf16 (what the model serves): tensor cores, mma.sync
// m16n8k16 bf16 -> fp32 on K/V tiles that 16-byte cp.async copies stream
// into a ring in shared memory; see namespace bf16mma below. fp32: the
// CUDA-core design, kept as it was so that its outputs stay bit for bit
// (no TF32): one block per (b*h, 32-row query tile), four warps with eight
// query rows each, K/V tiles of 32 keys staged as fp32, q pre-scaled in
// fp32, one key per lane for the scores and strided output dims per lane
// for P.V.
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

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int G, Strides sq, Strides sk, Strides sv,
                 Strides so, float scale, int causal) {
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
    qs[i] = s < S ? q[b * sq.b + s * sq.s + h * sq.h + d] * scale : 0.f;
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
        kx = k[b * sk.b + t * sk.s + hk * sk.h + d];
        vx = v[b * sv.b + t * sv.s + hk * sv.h + d];
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
    float* orow = o + b * so.b + s * so.s + h * so.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = acc[rr][i] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores fed by asynchronous copies
// ---------------------------------------------------------------------------
//
// A warp owns 16 query rows of one head: the rows are the M of
// mma.m16n8k16. A block holds RW such row tiles of one head (RW warps, at
// most MW: 64 query rows), and streams its kv head's K and V once for all
// of them, in tiles of BK keys through a ring of NST stages of
// 16-byte cp.async copies (rows padded by 16 bytes, so the ldmatrix reads
// of 8 rows hit 8 distinct bank groups). Per tile a warp forms S = Q K^T
// (16 x BK) with Q's fragments held in registers, scales S in fp32, masks
// it, updates its running (m, l), and adds P V with P split into hi + lo
// bf16 (two MMAs into one fp32 accumulator): one bf16 P would miss the
// kernel checks' relative L2 of 1e-3. Rows and keys past S are zero-filled
// by the copies (src-size 0) and masked, not padded in memory.

namespace bf16mma {

constexpr int BK = 64;               // keys per K/V tile
constexpr int NST = 2;               // stages of the K/V ring
constexpr int MW = 4;                // most warps (16-row tiles) a block

template <int D>  // a padded row, in elements
__host__ __device__ constexpr int ld() { return D + 8; }

template <int D>  // the K/V ring
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(__nv_bfloat16) * 2 * NST * BK * ld<D>();
}

template <int D>
constexpr size_t smem_bytes() {
  return ring_bytes<D>() + sizeof(__nv_bfloat16) * MW * 16 * ld<D>();
}

template <int D>
__global__ void __launch_bounds__(MW * 32)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int S, int H, int G,
                 int RW, Strides sq, Strides sk, Strides sv, Strides so,
                 float scale, int causal, int aligned) {
  constexpr int LD = ld<D>();
  constexpr int CPR = D / 8;         // 16-byte chunks per row
  constexpr int NT = D / 8;          // n-tiles of the output
  constexpr int KT = D / 16;         // k-steps of Q K^T
  constexpr int SN = BK / 8;         // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + NST * BK * LD;
  __nv_bfloat16* qs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + ring_bytes<D>());

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / G;
  const int q_blk = blockIdx.x * 16 * RW;
  const int q0 = q_blk + warp * 16;
  const int kv_end = causal ? min(q_blk + 16 * RW, S) : S;
  const int ntile = (kv_end + BK - 1) / BK;

  // the block's Q rows, one 16-row tile a warp, rows past S zero-filled
  for (int i = tid; i < RW * 16 * CPR; i += nthreads) {
    const int r = i / CPR, c = i % CPR, s = q_blk + r;
    const bool ok = s < S;
    repro_copy16(qs + r * LD + c * 8,
                 q + b * sq.b + (ok ? s : 0) * sq.s + h * sq.h + c * 8, ok,
                 aligned);
  }
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  auto load_tile = [&](int t) {
    __nv_bfloat16* kd = ks + (t % NST) * BK * LD;
    __nv_bfloat16* vd = vs + (t % NST) * BK * LD;
    for (int i = tid; i < BK * CPR; i += nthreads) {
      const int r = i / CPR, c = i % CPR, key = t * BK + r;
      const bool ok = key < kv_end;
      const long long kr = ok ? key : 0;
      repro_copy16(kd + r * LD + c * 8, kb + kr * sk.s + c * 8, ok, aligned);
      repro_copy16(vd + r * LD + c * 8, vb + kr * sv.s + c * 8, ok, aligned);
    }
  };
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < ntile) load_tile(t);
    repro_cp_async_commit();
  }

  const int ra = q0 + gid, rb = ra + 8;           // this lane's two rows
  const int warp_last = min(q0 + 15, S - 1);
  const bool live = q0 < S;
  const __nv_bfloat16* qw = qs + warp * 16 * LD;
  uint32_t qf[KT][4];
  float m_a = REPRO_NEG_INF, m_b = REPRO_NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < ntile; ++t) {
    repro_cp_async_wait<NST - 2>();
    __syncthreads();                 // tile t landed; tile t - 1 consumed
    if (t + NST - 1 < ntile) load_tile(t + NST - 1);
    repro_cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        repro_ldsm_x4(qf[kk], qw + (lane & 15) * LD + kk * 16 +
                                  (lane >> 4) * 8);
    }
    const int t0 = t * BK;
    if (!live || (causal && t0 > warp_last)) continue;   // warp-uniform
    const __nv_bfloat16* kt = ks + (t % NST) * BK * LD;
    const __nv_bfloat16* vt = vs + (t % NST) * BK * LD;

    float sc[SN][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t kf[4];
        repro_ldsm_x4(kf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD + kk * 16 + ((lane >> 3) & 1) * 8);
        repro_mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
        repro_mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }
    // scale in fp32, mask, and the running softmax of rows ra and rb
    float mx_a = REPRO_NEG_INF, mx_b = REPRO_NEG_INF;
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + n * 8 + 2 * tig + (e & 1);
        const int row = e < 2 ? ra : rb;
        const bool ok = key < S && (!causal || key <= row);
        const float s = ok ? sc[n][e] * scale : REPRO_NEG_INF;
        sc[n][e] = s;
        if (e < 2) mx_a = fmaxf(mx_a, s); else mx_b = fmaxf(mx_b, s);
      }
    }
    const float mn_a = fmaxf(m_a, repro_quad_max(mx_a));
    const float mn_b = fmaxf(m_b, repro_quad_max(mx_b));
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sc[n][e];
        const float p = s > 0.5f * REPRO_NEG_INF
                            ? expf(s - (e < 2 ? mn_a : mn_b)) : 0.f;
        sc[n][e] = p;
        if (e < 2) ps_a += p; else ps_b += p;
      }
    }
    l_a = al_a * l_a + ps_a;         // per-lane partial; quad-summed at the end
    l_b = al_b * l_b + ps_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (causal && t0 + kk * 16 > warp_last) break;    // p is 0 there
      uint32_t ph[4], pl[4];
      repro_p_frags(sc[2 * kk], sc[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        repro_ldsm_x4_trans(vf, vt + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                                    (lane >> 4) * 8);
        repro_mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        repro_mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        repro_mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
        repro_mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
  }
  repro_cp_async_wait<0>();

  l_a = repro_quad_sum(l_a);
  l_b = repro_quad_sum(l_b);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  __nv_bfloat16* oa = o + b * so.b + ra * so.s + h * so.h + 2 * tig;
  __nv_bfloat16* ob = o + b * so.b + rb * so.s + h * so.h + 2 * tig;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(oa + n * 8) =
          __floats2bfloat162_rn(acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + n * 8) =
          __floats2bfloat162_rn(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int G, Strides sq, Strides sk,
                   Strides sv, Strides so, float scale, int causal,
                   int aligned, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool optin[REPRO_MAX_DEVICES] = {};
  cudaError_t err = repro_smem_optin(flash_mma_kernel<D>, smem, optin);
  if (err != cudaSuccess) return err;
  // a warp per 16-row tile, up to MW of them (64 rows) a block: on the
  // H100 the fastest block at llama3-3b's 64-token bucket
  const int RW = min(MW, (S + 15) / 16);
  dim3 grid((S + 16 * RW - 1) / (16 * RW), B * H);
  flash_mma_kernel<D><<<grid, RW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, G, RW, sq, sk, sv, so, scale, causal, aligned);
  return cudaGetLastError();
}

}  // namespace bf16mma

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int G, Strides sq, Strides sk,
                       Strides sv, Strides so, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool optin[REPRO_MAX_DEVICES] = {};
  cudaError_t err = repro_smem_optin(flash_fwd_kernel<D>, smem, optin);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, G, sq, sk,
      sv, so, scale, causal);
  return cudaGetLastError();
}

bool aligned16(const void* p, const Strides& s) {
  const long long e = sizeof(__nv_bfloat16);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * e) % 16 == 0 &&
         (s.s * e) % 16 == 0 && (s.h * e) % 16 == 0;
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
  if (dtype == REPRO_F32) {
    if (D == 64)
      return static_cast<int>(launch_f32<64>(q, k, v, o, B, S, H, G, sq, sk,
                                             sv, so, scale, causal, st));
    if (D == 128)
      return static_cast<int>(launch_f32<128>(q, k, v, o, B, S, H, G, sq,
                                              sk, sv, so, scale, causal, st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = aligned16(q, sq) && aligned16(k, sk) &&
                      aligned16(v, sv);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64)
    err = bf16mma::launch<64>(q, k, v, o, B, S, H, G, sq, sk, sv, so, scale,
                              causal, aligned, st);
  else if (D == 128)
    err = bf16mma::launch<128>(q, k, v, o, B, S, H, G, sq, sk, sv, so,
                               scale, causal, aligned, st);
  return static_cast<int>(err);
}
