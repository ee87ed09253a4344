// Mamba-2 SSD chunked scan on Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd.py::ssd_scan_kernel. Same arithmetic, to
// fp32 accuracy: per (batch, head), walk the chunks in order carrying the
// (P, N) state; inside a chunk of c positions, with dA = dt * A and
// seg = cumsum(dA),
//   y_i   = sum_{j <= i} (C_i . B_j) exp(-(seg_i - seg_j)) dt_j x_j
//           + exp(-seg_i) C_i . S_prev
//   S_new = exp(-seg_last) S_prev + sum_j exp(-(seg_last - seg_j)) dt_j x_j B_j^T
// Head h reads B and C of group h / (H / G) in place, with no copy. The
// state starts at 0, and y and the final state come out in fp32.
//
// What bounds it on the H100: at Mamba-2's serving shapes (H = 64, P = 64,
// N = 128, one chunk of up to 64 tokens at batch 1) neither bytes nor
// operations but latency and issue: the work of a head is a few chains of
// small matrix products, and 64 heads alone would leave half the card idle.
// The design:
//
// * The grid is (batch, head, P-slice): state rows are independent in p,
//   so a block carries only its PS x N slice of the state across the chunks
//   and writes y for its own p columns. The wrapper picks PS (a power of
//   two from 16) to give about a block an SM: at (1, 64, 64, 64) that is 2 slices
//   of 32, 128 blocks. (Four slices of 16, two blocks an SM, took longer:
//   each block repeats the staging and its share of C.B^T, and the SM's
//   instruction issue, not its occupancy, is what binds.)
// * The blocks of one group are launched as thread-block clusters (up to 8;
//   the launch takes the largest that keeps every block of the grid
//   resident at once). B and C depend only on (batch, group, chunk), so the
//   blocks of a cluster share their loads: each block copies its share of
//   the chunk's rows with a bulk asynchronous copy multicast to every block
//   of the cluster (`cp.async.bulk ... multicast::cluster`, completion
//   counted in bytes on an mbarrier), so L2 serves each row once per
//   cluster instead of once per block. C.B^T is shared too: each block
//   builds its share of the causal 16 x 8 tiles and stores each tile into
//   every block of the cluster (distributed shared memory, `mapa` +
//   `st.async`), so the matrix is computed once per cluster and
//   never leaves the chip. Each block then turns it, in place, into its own
//   head's att = CB * exp(-(seg_i - seg_j)) * dt_j.
// * The four products (C.B^T, att.x, C.S_prev^T, (x * w)^T.B) run on the
//   tensor cores, `mma.sync.m16n8k8` TF32, with the 3xTF32 split: each fp32
//   operand is a TF32 high part (rounded to nearest) plus the remainder
//   (truncated to TF32), and hi.hi + hi.lo + lo.hi is accumulated in fp32,
//   the big and the small terms in two accumulators (two independent
//   chains). The split is four integer and float instructions an operand;
//   x * w, the A operand that every warp of the state update reads, is
//   split once per chunk into hi and lo planes in shared memory.
//   One-pass TF32 would keep about three decimal digits and miss the
//   model's 2e-4; the split keeps about 21 bits of each operand.
// * The x slice is staged by 16-byte `cp.async` copies. Rows that are not
//   16-byte aligned, or an N that is not a multiple of 4, take per-block
//   copies, synchronous where a segment is not aligned. With more than one
//   chunk and room for two, the next chunk's copies run during this one's
//   products. Rows are padded (B and C to N + 4 floats, x to PS + 8, C.B^T
//   to c + 4) so that the fragment loads of a warp hit distinct banks.
//
// Arrivals are counted on mbarriers, so no block waits for the cluster to
// use what has reached it: the chunk's B and C on the stage's mbarrier
// (bytes), the other blocks' C.B^T tiles on a third (`st.async` with
// complete_tx). Cluster barriers remain where a block's buffers are
// written by the others: once at the start (every mbarrier initialised
// before the first copy), between chunks (no block still reads what the
// next chunk's copies and tiles overwrite), and, split around the last
// chunk's products, before a block exits.
//
// Shared memory, in floats: seg (fp64) 2c', and per stage B and C
// c' (N' + 4) each and x c' (PS + 8); C.B^T c' (c' + 4) (or room for the
// split x * w, two planes of c' (PS + 8), where C cannot hold them); the
// state PS (N' + 4); 3c' of decays; four mbarriers; with c' = max(c, 16)
// and N' = N rounded up to 8. At N = 128: chunk 64 with PS = 32 takes
// 113,440 B with one stage and 191,264 with two; chunk 128 takes 226,080 B
// with PS = 16 and one stage (PS = 32 does not fit).
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
constexpr int NW = NT / 32;    // warps per block
constexpr int CMAX = 128;      // longest chunk
constexpr int MAX_CLUSTER = 8;
constexpr long long SPIN_LIMIT = 1LL << 26;   // mbarrier polls before a trap

struct Args {
  long long sxb, sxs, sxh;     // x (b, s, h, p), unit p stride
  long long sdb, sds, sdh;     // dt (b, s, h)
  long long sbb, sbs, sbg;     // B (b, s, g, n), unit n stride
  long long scb, scs, scg;     // C (b, s, g, n), unit n stride
  int S, H, P, G, N, chunk, PS, stages, cluster, bulk;
};

struct Layout {                // shared-memory layout, in floats
  int cp, n8, ldn, ldx, lda, lds, cbsz;
  bool xw_in_c;
  size_t stage, total;
  __host__ __device__ Layout(int c, int N, int PS, int stages) {
    cp = c < 16 ? 16 : c;
    n8 = (N + 7) / 8 * 8;
    ldn = n8 + 4;
    ldx = PS + 8;
    lda = cp + 4;
    lds = n8 + 4;
    // the split x * w (two planes shaped as the x slice) goes where C was,
    // when it fits there and C has no padding to keep zero; else after
    // C.B^T, in a region large enough for either
    xw_in_c = c == cp && N == n8 && 2 * cp * ldx <= cp * ldn;
    cbsz = xw_in_c || cp * lda > 2 * cp * ldx ? cp * lda : 2 * cp * ldx;
    stage = 2 * static_cast<size_t>(cp) * ldn + static_cast<size_t>(cp) * ldx;
    total = 2 * static_cast<size_t>(cp) + stages * stage + cbsz +
            static_cast<size_t>(PS) * lds + 3 * static_cast<size_t>(cp) +
            8;                         // + four 8-byte mbarriers
  }
};

// ---- 3xTF32 on mma.sync.m16n8k8 ------------------------------------------
// Fragments (lane = 4 * gid + tig): A (16 x 8, row major) a0 = (gid, tig),
// a1 = (gid + 8, tig), a2 = (gid, tig + 4), a3 = (gid + 8, tig + 4); B
// (8 x 8, k x n) b0 = (tig, gid), b1 = (tig + 4, gid); C (16 x 8) c0, c1 =
// (gid, 2 tig..+1), c2, c3 = (gid + 8, 2 tig..+1).

constexpr uint32_t TF32_MASK = 0xffffe000u;

// x = hi + lo + (under 2^-21 |x|): hi is x rounded to TF32 (to nearest,
// ties away, as cvt.rna rounds), lo the exact remainder truncated to TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {                 // an A fragment, split
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ FragA() {}
  __device__ __forceinline__ explicit FragA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
  }
  // from planes already split, at the offsets of a0..a3
  __device__ __forceinline__ static FragA planes(const float* h,
                                                 const float* l, int o0,
                                                 int o1, int o2, int o3) {
    FragA f;
    f.hi[0] = __float_as_uint(h[o0]);
    f.hi[1] = __float_as_uint(h[o1]);
    f.hi[2] = __float_as_uint(h[o2]);
    f.hi[3] = __float_as_uint(h[o3]);
    f.lo[0] = __float_as_uint(l[o0]);
    f.lo[1] = __float_as_uint(l[o1]);
    f.lo[2] = __float_as_uint(l[o2]);
    f.lo[3] = __float_as_uint(l[o3]);
    return f;
  }
};

// big += a_hi b_hi; small += a_hi b_lo + a_lo b_hi
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const FragA& a, float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(small, a.lo, bh0, bh1);
  mma_tf32(small, a.hi, bl0, bl1);
  mma_tf32(big, a.hi, bh0, bh1);
}

// ---- clusters, mbarriers, bulk copies -------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// an arrival that orders nothing: for barriers whose data is ordered by
// mbarriers (or by the mbarrier initialisation's own fence)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `local` in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(repro_smem_addr(local)), "r"(rank));
  return addr;
}

// 8 bytes into the same shared-memory offset of block `rank`, whose
// mbarrier at `bar`'s offset counts them on arrival
__device__ __forceinline__ void store_async8(float* local, uint64_t* bar,
                                             int rank, float a, float b) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
      "[%0], {%1, %2}, [%3];\n" ::"r"(cluster_addr(local, rank)),
      "f"(a), "f"(b), "r"(cluster_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   repro_smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          repro_smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of the given parity to complete; a wait that never
// ends (a fault in the byte count) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = repro_smem_addr(bar);
  for (long long n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n > SPIN_LIMIT) __trap();
  }
}

// `bytes` from global memory to the same shared-memory offset of every
// block in `mask`, each block's mbarrier at `bar` counting them
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
          repro_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(repro_smem_addr(bar)), "h"(mask)
      : "memory");
}

// ---- staging ----------------------------------------------------------------

// `valid` (0..4) floats of src into the 16 bytes at dst, zeros after them:
// by cp.async when all four are there and src is 16-byte aligned, else
// synchronously
__device__ __forceinline__ void stage16(float* dst, const float* src,
                                        int valid) {
  if (valid == 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    repro_cp_async16(dst, src, true);
  } else {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid > 0) v.x = src[0];
    if (valid > 1) v.y = src[1];
    if (valid > 2) v.z = src[2];
    if (valid > 3) v.w = src[3];
    *reinterpret_cast<float4*>(dst) = v;
  }
}

// the causal 16 x 8 tiles of C.B^T: row tile r holds min(2r + 2, qmax)
__device__ __forceinline__ void cb_tile(int t, int qmax, int& r, int& q) {
  r = 0;
  while (t >= min(2 * r + 2, qmax)) {
    t -= min(2 * r + 2, qmax);
    ++r;
  }
  q = t;
}

__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state_out, Args a) {
  const int P = a.P, N = a.N, c = a.chunk, PS = a.PS;
  const Layout L(c, N, PS, a.stages);
  const int cp = L.cp, ldn = L.ldn, ldx = L.ldx, lda = L.lda, lds = L.lds;
  extern __shared__ __align__(16) float smem[];
  double* segs = reinterpret_cast<double*>(smem);   // [cp], fp64
  float* stage0 = smem + 2 * cp;                    // stages: C, B, x
  float* CB = stage0 + a.stages * L.stage;          // [cp][lda]
  float* Ss = CB + L.cbsz;                          // [PS][lds] state
  float* dts = Ss + PS * lds;                       // [cp]
  float* es = dts + cp;                             // [cp] exp(-seg_i)
  float* ws = es + cp;                              // [cp] w_j
  uint64_t* bars = reinterpret_cast<uint64_t*>(ws + cp);   // stages, C.B^T

  const int ns = (P + PS - 1) / PS;
  const int sl = blockIdx.x % ns;
  const int bh = blockIdx.x / ns;
  const int bb = bh / a.H, h = bh % a.H;
  const int grp = h / (a.H / a.G);
  const int p0 = sl * PS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rank = static_cast<int>(cluster_rank());
  const int ncl = a.cluster;
  const bool bulk = a.bulk != 0;
  const float Ah = A[h];

  const float* xb = x + bb * a.sxb + h * a.sxh + p0;
  const float* db = dt + bb * a.sdb + h * a.sdh;
  const float* Bb = Bm + bb * a.sbb + grp * a.sbg;
  const float* Cb = Cm + bb * a.scb + grp * a.scg;
  const int n4 = L.n8 / 4, x4 = PS / 4, lgx4 = __ffs(x4) - 1;
  const int nchunks = a.S / c;
  const int qmax = (c + 7) / 8;        // 8-wide column tiles with data
  int ncb = 0;                         // causal tiles of C.B^T
  for (int r = 0; r < cp / 16; ++r) ncb += min(2 * r + 2, qmax);
  // C.B^T bytes this block receives from the others a chunk
  const uint32_t cb_bytes =
      (ncb - (ncb - rank + ncl - 1) / ncl) * 16 * 8 * sizeof(float);

  // warp 0 sums seg: it loads each chunk's dt ahead (the first chunk's
  // here, before anything waits on it), up to four entries a lane
  const int per = (c + 31) / 32, lo = lane * per;
  float dv[CMAX / 32];
  auto load_dt = [&](int k) {
#pragma unroll
    for (int u = 0; u < CMAX / 32; ++u)
      dv[u] = u < per && lo + u < c ? db[(k * c + lo + u) * a.sds] : 0.f;
  };
  if (warp == 0) load_dt(0);
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();            // I: every mbarrier is ready

  // the state starts at 0; with bulk copies, which fill only a chunk's rows
  // and N columns, the padding of B and C is zeroed once here
  for (int e = tid; e < PS * lds; e += NT) Ss[e] = 0.f;
  if (bulk && (c < cp || N < L.n8))
    for (int m = 0; m < 2 * a.stages; ++m) {   // C and B of each stage
      float* buf = stage0 + (m >> 1) * L.stage + (m & 1) * cp * ldn;
      for (int i = warp; i < cp; i += NW)
        for (int n = (i < c ? N : 0) + lane; n < ldn; n += 32)
          buf[i * ldn + n] = 0.f;
    }

  // chunk k's x slice, by this block alone; then its B and C, by multicast
  // (this block's share of the rows, and the byte count it will receive)
  // or by this block alone
  auto issue_x = [&](int k) {
    float* xs = stage0 + (a.stages == 2 ? k & 1 : 0) * L.stage + 2 * cp * ldn;
    for (int e = tid; e < cp * x4; e += NT) {
      const int i = e >> lgx4, pp = 4 * (e & (x4 - 1));
      const int valid = i < c ? max(0, min(4, P - p0 - pp)) : 0;
      stage16(xs + i * ldx + pp, xb + (k * c + i) * a.sxs + pp, valid);
    }
    repro_cp_async_commit();
  };
  auto issue_bc = [&](int k) {
    const int st = a.stages == 2 ? k & 1 : 0;
    float* Cs = stage0 + st * L.stage;
    float* Bs = Cs + cp * ldn;
    const int t0 = k * c;
    if (bulk) {
      if (tid == 0) mbar_expect(&bars[st], 2u * c * N * sizeof(float));
      for (int e = tid; e < 2 * c; e += NT) {
        if (e % ncl != rank) continue;
        const int i = e >> 1;
        const bool isC = (e & 1) == 0;
        bulk_multicast((isC ? Cs : Bs) + i * ldn,
                       isC ? Cb + (t0 + i) * a.scs : Bb + (t0 + i) * a.sbs,
                       N * sizeof(float), &bars[st],
                       static_cast<uint16_t>((1u << ncl) - 1));
      }
    } else {
      for (int e = tid; e < cp * n4; e += NT) {
        const int i = e / n4, n = 4 * (e % n4);
        const int valid = i < c ? max(0, min(4, N - n)) : 0;
        stage16(Cs + i * ldn + n, Cb + (t0 + i) * a.scs + n, valid);
        stage16(Bs + i * ldn + n, Bb + (t0 + i) * a.sbs + n, valid);
      }
      repro_cp_async_commit();
    }
  };
  issue_x(0);

  for (int k = 0; k < nchunks; ++k) {
    const int t0 = k * c;
    const int st = a.stages == 2 ? (k & 1) : 0;
    const uint32_t parity = (a.stages == 2 ? k >> 1 : k) & 1;
    const bool prefetch = a.stages == 2 && k + 1 < nchunks;
    if (a.stages == 1 && k > 0) issue_x(k);   // this block's own buffer

    // seg = cumsum(dt * A) in fp64, by warp 0 while the copies land; the
    // padded rows past c repeat seg_last
    if (warp == 0) {
      if (k > 0) load_dt(k);
      double run = 0.0;
      double loc[CMAX / 32];
#pragma unroll
      for (int u = 0; u < CMAX / 32; ++u) {
        run += static_cast<double>(dv[u] * Ah);
        loc[u] = run;
      }
      double incl = run;               // inclusive scan of lane totals
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(REPRO_FULL_MASK, incl, o);
        if (lane >= o) incl += v;
      }
      const double off = incl - run;
#pragma unroll
      for (int u = 0; u < CMAX / 32; ++u)
        if (u < per && lo + u < c) {
          segs[lo + u] = loc[u] + off;
          dts[lo + u] = dv[u];
        }
      const double last = __shfl_sync(REPRO_FULL_MASK, incl, 31);
      for (int i = c + lane; i < cp; i += 32) {
        segs[i] = last;
        dts[i] = 0.f;
      }
    }
    // k = 0: the mbarriers are ready; else the cluster is done with chunk
    // k - 1, so its B, C and C.B^T buffers may be written again
    cluster_wait();
    if (a.stages == 1 || k == 0) issue_bc(k);
    if (prefetch) {
      issue_x(k + 1);
      issue_bc(k + 1);
    }
    if (tid == 0 && cb_bytes) mbar_expect(&bars[2], cb_bytes);
    __syncthreads();                   // seg, dt
    const double seg_last = segs[c - 1];
    for (int i = tid; i < cp; i += NT) {
      es[i] = expf(-static_cast<float>(segs[i]));
      ws[i] = i < c ? expf(-static_cast<float>(seg_last - segs[i])) * dts[i]
                    : 0.f;
    }
    if (prefetch && bulk)              // x of k + 1 may be in flight
      repro_cp_async_wait<1>();
    else if (prefetch)                 // and its B and C
      repro_cp_async_wait<2>();
    else
      repro_cp_async_wait<0>();
    if (bulk) mbar_wait(&bars[st], parity);
    __syncthreads();                   // the stage, es and ws
    const float* Cs = stage0 + st * L.stage;
    const float* Bs = Cs + cp * ldn;
    const float* xs = Bs + cp * ldn;

    // this block's tiles of C.B^T, stored here and, asynchronously, into
    // every other block of the cluster, whose mbarrier counts the bytes;
    // even and odd steps of n in two pairs of accumulators
    for (int t = rank + ncl * warp; t < ncb; t += ncl * NW) {
      int r, q;
      cb_tile(t, qmax, r, q);
      float big[2][4] = {}, small[2][4] = {};
      const float* c0 = Cs + (16 * r + gid) * ldn + tig;
      const float* b0 = Bs + (8 * q + gid) * ldn + tig;
      const int nk = L.n8 / 8;
#pragma unroll 2
      for (int kk = 0; kk + 1 < nk; kk += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int k8 = 8 * (kk + u);
          const FragA af({c0[k8], c0[8 * ldn + k8], c0[k8 + 4],
                          c0[8 * ldn + k8 + 4]});
          mma_3xtf32(big[u], small[u], af, b0[k8], b0[k8 + 4]);
        }
      }
      if (nk & 1) {
        const int k8 = 8 * (nk - 1);
        const FragA af({c0[k8], c0[8 * ldn + k8], c0[k8 + 4],
                        c0[8 * ldn + k8 + 4]});
        mma_3xtf32(big[0], small[0], af, b0[k8], b0[k8 + 4]);
      }
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = (big[0][i] + small[0][i]) + (big[1][i] + small[1][i]);
      float* o = CB + (16 * r + gid) * lda + 8 * q + 2 * tig;
      *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(o + 8 * lda) = make_float2(v[2], v[3]);
      for (int rk = 0; rk < ncl; ++rk) {
        if (rk == rank) continue;
        store_async8(o, &bars[2], rk, v[0], v[1]);
        store_async8(o + 8 * lda, &bars[2], rk, v[2], v[3]);
      }
    }
    __syncthreads();                   // this block's own tiles
    if (cb_bytes) mbar_wait(&bars[2], k & 1);   // and the others'
    if (k + 1 == nchunks) cluster_arrive_relaxed();   // F: nothing more
                                                      // arrives here

    // att = CB * exp(-(seg_i - seg_j)) * dt_j, in place, zero above the
    // diagonal, over the causal tiles: a thread a column (cp is a power of
    // two no larger than NT), its rows strided, with no branch but the store
    {
      const int j = tid & (cp - 1), rstep = NT / cp;
      const double sj = segs[j];
      const float dj = dts[j];
#pragma unroll 4
      for (int i = tid / cp; i < cp; i += rstep) {
        float* v = CB + i * lda + j;
        const float att =
            *v * expf(-static_cast<float>(segs[i] - sj)) * dj;
        if (j < 16 * ((i >> 4) + 1) && j < 8 * qmax) *v = j <= i ? att : 0.f;
      }
    }
    __syncthreads();

    // y for this block's columns: att.x + exp(-seg_i) C.S_prev^T, a warp
    // per 16 rows and two 8-column tiles (sharing the A fragments)
    const int nyq = PS / 8, nyp = (nyq + 1) / 2;
    for (int t = warp; t < (cp / 16) * nyp; t += NW) {
      const int r = t / nyp, qp = 2 * (t % nyp);
      const bool two = qp + 1 < nyq;
      const int i0 = 16 * r + gid, i1 = i0 + 8;
      float big[2][4] = {}, small[2][4] = {};
      const int kend = min(2 * r + 2, qmax);
      const float* a0 = CB + i0 * lda + tig;
      const float* x0 = xs + tig * ldx + 8 * qp + gid;
#pragma unroll 2
      for (int kk = 0; kk < kend; ++kk) {
        const FragA af({a0[8 * kk], a0[8 * lda + 8 * kk], a0[8 * kk + 4],
                        a0[8 * lda + 8 * kk + 4]});
        const float* xk = x0 + 8 * kk * ldx;
        mma_3xtf32(big[0], small[0], af, xk[0], xk[4 * ldx]);
        if (two) mma_3xtf32(big[1], small[1], af, xk[8], xk[4 * ldx + 8]);
      }
      float ibig[2][4] = {}, ismall[2][4] = {};
      if (k > 0) {                     // the state is 0 before chunk 0
        const float* c0 = Cs + i0 * ldn + tig;
        const float* s0 = Ss + (8 * qp + gid) * lds + tig;
#pragma unroll 2
        for (int kk = 0; kk < L.n8; kk += 8) {
          const FragA af({c0[kk], c0[8 * ldn + kk], c0[kk + 4],
                          c0[8 * ldn + kk + 4]});
          mma_3xtf32(ibig[0], ismall[0], af, s0[kk], s0[kk + 4]);
          if (two)
            mma_3xtf32(ibig[1], ismall[1], af, s0[8 * lds + kk],
                       s0[8 * lds + kk + 4]);
        }
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (w == 1 && !two) break;
        const int pc = p0 + 8 * (qp + w) + 2 * tig;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {       // rows i0 and i1
          const int i = hh ? i1 : i0;
          if (i >= c || pc >= P) continue;
          const float v0 = (big[w][2 * hh] + small[w][2 * hh]) +
                           es[i] * (ibig[w][2 * hh] + ismall[w][2 * hh]);
          const float v1 = (big[w][2 * hh + 1] + small[w][2 * hh + 1]) +
                           es[i] * (ibig[w][2 * hh + 1] + ismall[w][2 * hh + 1]);
          float* o =
              y + ((static_cast<long long>(bb) * a.S + t0 + i) * a.H + h) * P +
              pc;
          if (pc + 1 < P && (P & 1) == 0)
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          else {
            o[0] = v0;
            if (pc + 1 < P) o[1] = v1;
          }
        }
      }
    }
    __syncthreads();                   // att and the old state are read

    // x * w, split once into TF32 hi and lo planes (where C or C.B^T
    // was): the A fragments every warp of the state update reads
    float* xwh = L.xw_in_c ? stage0 + st * L.stage : CB;   // [cp][ldx]
    float* xwl = xwh + cp * ldx;                            // [cp][ldx]
    {
      const int lg = __ffs(PS) - 1;
#pragma unroll 4
      for (int e = tid; e < cp * PS; e += NT) {
        const int j = e >> lg, p = e & (PS - 1);
        uint32_t hi, lo;
        split_tf32(xs[j * ldx + p] * ws[j], hi, lo);
        xwh[j * ldx + p] = __uint_as_float(hi);
        xwl[j * ldx + p] = __uint_as_float(lo);
      }
    }
    __syncthreads();

    // S = exp(-seg_last) S + (x * w)^T . B, a warp per 32 x 16 (two 16-row
    // tiles and two 8-column tiles, sharing their fragments)
    const float decay = expf(-static_cast<float>(seg_last));
    const int nmt = PS / 16, nmp = (nmt + 1) / 2;
    const int nsq = L.n8 / 8, npair = (nsq + 1) / 2;
    for (int t = warp; t < nmp * npair; t += NW) {
      const int mp = 2 * (t / npair), nq = 2 * (t % npair);
      const bool twom = mp + 1 < nmt, twon = nq + 1 < nsq;
      float big[2][2][4] = {}, small[2][2][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < qmax; ++kk) {
        const int j0 = 8 * kk + tig, j1 = j0 + 4;
        const float* b0 = Bs + j0 * ldn + 8 * nq + gid;
        const float* b1 = Bs + j1 * ldn + 8 * nq + gid;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m == 1 && !twom) break;
          const int o0 = j0 * ldx + 16 * (mp + m) + gid;
          const int o1 = j1 * ldx + 16 * (mp + m) + gid;
          const FragA af = FragA::planes(xwh, xwl, o0, o0 + 8, o1, o1 + 8);
          mma_3xtf32(big[m][0], small[m][0], af, b0[0], b1[0]);
          if (twon) mma_3xtf32(big[m][1], small[m][1], af, b0[8], b1[8]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !twom) break;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !twon) break;
          float* o = Ss + (16 * (mp + m) + gid) * lds + 8 * (nq + u) + 2 * tig;
          const float2 s0 = *reinterpret_cast<float2*>(o);
          const float2 s1 = *reinterpret_cast<float2*>(o + 8 * lds);
          *reinterpret_cast<float2*>(o) =
              make_float2(decay * s0.x + (big[m][u][0] + small[m][u][0]),
                          decay * s0.y + (big[m][u][1] + small[m][u][1]));
          *reinterpret_cast<float2*>(o + 8 * lds) =
              make_float2(decay * s1.x + (big[m][u][2] + small[m][u][2]),
                          decay * s1.y + (big[m][u][3] + small[m][u][3]));
        }
      }
    }
    __syncthreads();                   // the new state; the stage is free
    if (k + 1 < nchunks) cluster_arrive();   // B: done with chunk k
  }

  float* so = state_out + (static_cast<long long>(bh) * P + p0) * N;
  const int prow = min(PS, P - p0);
  if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(so) & 15) == 0) {
    const int n4o = N / 4;             // 16-byte pieces of a state row
#pragma unroll 4
    for (int e = tid; e < prow * n4o; e += NT) {
      const int p = e / n4o, n = 4 * (e - p * n4o);
      *reinterpret_cast<float4*>(so + p * N + n) =
          *reinterpret_cast<const float4*>(Ss + p * lds + n);
    }
  } else {
    for (int p = warp; p < prow; p += NW)
      for (int n = lane; n < N; n += 32) so[p * N + n] = Ss[p * lds + n];
  }
  cluster_wait();                      // F: no block leaves while written
}

int optin_smem() {
  static int bytes[REPRO_MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < REPRO_MAX_DEVICES && bytes[dev]) return bytes[dev];
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (dev < REPRO_MAX_DEVICES) bytes[dev] = v;
  return v;
}

// Blocks of a grid of `grid` that can be resident at once in clusters of
// `cl`, with this much shared memory a block.
int resident(int cl, size_t smem, int grid) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, ssd_scan_kernel, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();                // clear the refusal
    return 0;
  }
  return n * cl;
}

// The largest cluster of at most `want` blocks that keeps as many blocks of
// the grid resident at once as clusters of one do (clusters of 8 pack worse
// into the card's GPCs than single blocks), cached by size and device. A
// slot is claimed atomically and published by its `ready` flag, so
// concurrent callers at worst ask the occupancy calculator twice.
int pick_cluster(int want, size_t smem, int grid) {
  struct Entry {
    int dev, want, grid;
    size_t smem;
    int got;
    volatile int ready;
  };
  constexpr int SLOTS = 32;
  static Entry cache[SLOTS];
  static int used = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < SLOTS; ++i)
    if (cache[i].ready && cache[i].dev == dev && cache[i].want == want &&
        cache[i].grid == grid && cache[i].smem == smem)
      return cache[i].got;
  const int alone = resident(1, smem, grid);
  const int need = grid < alone ? grid : alone;
  int cl = want;
  while (cl > 1 && resident(cl, smem, grid) < need) cl /= 2;
  const int slot = __sync_fetch_and_add(&used, 1);
  if (slot < SLOTS) {
    cache[slot].dev = dev;
    cache[slot].want = want;
    cache[slot].grid = grid;
    cache[slot].smem = smem;
    cache[slot].got = cl;
    __sync_synchronize();
    cache[slot].ready = 1;
  }
  return cl;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// Shared memory of one block, in bytes, for the plan of the wrapper.
extern "C" long long ssd_scan_smem_bytes(int chunk, int n, int ps,
                                         int stages) {
  return static_cast<long long>(sizeof(float) *
                                Layout(chunk, n, ps, stages).total);
}

// The cluster size a launch of this plan takes (see pick_cluster).
extern "C" int ssd_scan_cluster(int b, int h, int p, int n, int chunk,
                                int ps, int stages, int cluster) {
  const int ns = (p + ps - 1) / ps;
  static bool done[REPRO_MAX_DEVICES] = {};
  if (repro_smem_optin(ssd_scan_kernel, optin_smem(), done) != cudaSuccess)
    return 0;
  return pick_cluster(cluster, sizeof(float) * Layout(chunk, n, ps, stages)
                                   .total, b * h * ns);
}

// x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,g,n): fp32, strides in
// elements, unit stride on p and n, A contiguous. y (b,s,h,p) and
// state (b,h,p,n): fp32, contiguous. chunk divides s and is at most 128;
// h is a multiple of g. ps (a power of two from 16) is the P-slice of a block,
// stages (1 or 2) the chunks staged at once, cluster (1, 2, 4 or 8) the
// most blocks that share B, C and C.B^T, dividing the (h / g) *
// ceil(p / ps) blocks of a group (the launch may take fewer: see
// pick_cluster). bulk (0 or 1): B and C rows are 16-byte aligned (their
// base and the b, s and g strides) and n is a multiple of 4, so they may be
// copied by multicast. A plan whose shared memory exceeds the card's
// opt-in limit is refused.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, int b, int s, int h, int p, int g,
    int n, int chunk, int ps, int stages, int cluster, int bulk,
    long long sxb, long long sxs, long long sxh, long long sdb,
    long long sds, long long sdh, long long sbb, long long sbs,
    long long sbg, long long scb, long long scs, long long scg,
    void* stream) {
  const int ns = ps > 0 ? (p + ps - 1) / ps : 0;
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || g <= 0 || n <= 0 ||
      h % g != 0 || chunk <= 0 || chunk > CMAX || (chunk & (chunk - 1)) ||
      s % chunk != 0 || ps < 16 || (ps & (ps - 1)) || stages < 1 ||
      stages > 2 || cluster < 1 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) || ((h / g) * ns) % cluster != 0 ||
      (bulk && n % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(b) * h * ns;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * Layout(chunk, n, ps, stages).total;
  const int optin = optin_smem();
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool done[REPRO_MAX_DEVICES] = {};
  cudaError_t err = repro_smem_optin(ssd_scan_kernel, optin, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cl = pick_cluster(cluster, smem, static_cast<int>(blocks));
  Args a{sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg,
         s,   h,   p,   g,   n,   chunk, ps, stages, cl, bulk};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_scan_kernel,
                           static_cast<const float*>(x),
                           static_cast<const float*>(dt),
                           static_cast<const float*>(A),
                           static_cast<const float*>(B),
                           static_cast<const float*>(C),
                           static_cast<float*>(y), static_cast<float*>(state),
                           a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
