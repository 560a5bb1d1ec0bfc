// Tiled weighted log-sum-exp of a diagonal-Gaussian mixture, for Hopper
// (sm_90a).
//
// Replaces kde_tpu/ops/pallas_eval.py::_eval_kernel, the TPU Pallas kernel
// reached through pallas_log_eval.  For each query row m it computes
//
//   out[m] = log sum_n w_n prod_k N(q_mk; mu_nk, var_nk)
//
// from the raw means, variances and weights.  With loo, component
// m + diag is skipped for query m (diag = 0: the diagonal; a shard of the
// pairs passes the global start of its query rows minus that of its
// components); the caller applies the -log1p(-w) rescale.  A row whose
// every component is skipped (or has zero weight) gives -inf, as the
// Pallas kernel's guard does.
//
// What bounds it: the bytes are O((M + N) d), which is nothing.  Every
// (query, component) pair needs one exp that nothing can share, and the SFU
// gives 16 ex2 a clock per SM, so the SFU is the bound.  The FP32 pipe
// comes next: the direct form takes 3 instructions per dim per pair plus
// the offset by the running max and the add, so at d = 2 the instruction
// rate (about 10 instructions a pair, one a clock per SM sub-partition)
// binds before the SFU does.
// Design, one point per limit:
//   * register tiling: a thread keeps R queries and their running state in
//     registers; every component read from shared memory serves R pairs
//     (d = 1: two components' (mu, hinv) in one LDS.128; d = 2: one; four
//     c's in one LDS.128), so there is under one shared load per pair.  R
//     is 2 at d <= 2: more warps hid latency better than fewer loads;
//   * log2 domain: log2 e is folded into hinv and c when a tile is staged,
//     the exp is one ex2.approx.ftz, and the result goes back with one
//     multiply by ln 2.  The difference t = q - mu stays direct (no matmul
//     expansion, no q*s - mu*s form), so data far from the origin keeps
//     its digits;
//   * chunked online log-sum-exp: J components at a time, their J*R logits
//     in registers, no branch per pair.  A logit never exceeds its
//     component's c, so while the chunk's largest c (found once, when the
//     tile is staged) is within 64 (log2 units) of a query's running max,
//     that query needs no max at all; a query further off takes its chunk
//     max and rescales only when it passes the running max by more than 8
//     (FA4's lazy rescale).  Every exp argument stays <= 64, so a sum stays
//     far below FLT_MAX; each query keeps four partial sums.  The running
//     max starts at -FLT_MAX, so -inf logits (zero weights, the LOO
//     diagonal) add ex2(-inf) = 0 and never make a NaN;
//   * in-kernel preparation: hinv = log2 e / (2 var) and
//     c = log2 w - 1/2 sum log2 var are computed as a tile is staged (one
//     tile is O(TILE d) work against TILE * R * threads pairs);
//   * overlap: the next tile's raw values are loaded into registers before
//     the current tile is consumed and staged into the other shared buffer
//     after it, so one __syncthreads per tile and no staging bubble;
//   * the component axis is split over a thread-block cluster (<= 8 blocks,
//     gridDim.y); the blocks merge their (max, sum) partials through
//     distributed shared memory and rank 0 writes out: one launch, no
//     scratch in device memory;
//   * the LOO mask is applied only in the chunks that overlap the block's
//     own query range shifted by diag, the columns its rows skip; a diag
//     with no column in [0, N) for any row runs the kernel without a mask,
//     and diag = 0 runs an instantiation with the offset folded away (a
//     runtime offset of 0 ran the 100k 1-D LOO case 1.4 % slower);
//   * the dimension is a compile-time constant for d = 1..8; d = 9..16 run
//     at a padded width DS of 12 or 16 (a padded dim has q = mu = 0 and
//     var = 1, so it adds nothing), without a per-dim branch, and without
//     the register prefetch, whose 2 DS registers cost more warps than the
//     staging latency it hides.  The ragged edges of M and N are masked
//     here (staged padding has weight 0), nothing is padded in device
//     memory.
// The wrapper (kde_tpu_torch/ops/tiled_eval.py::launch_plan) picks the
// threads per block and the split count from the shape and the SM count;
// the clusters are placed with the load-balancing scheduling policy.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libtiled_eval.so tiled_eval.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDim = 16;
constexpr int kMaxSplits = 8;          // the portable cluster size
constexpr int kMinThreads = 64;        // threads per block: 64 or 128
constexpr int kMaxThreads = 128;
constexpr float kHalfLog2e = 0.72134752044448170f;   // log2(e) / 2
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2Pi = 1.8378770664093453f;       // ln(2 pi)
constexpr float kRescale = 8.f;        // lazy rescale threshold, log2 units
constexpr float kBound = 64.f;         // largest exp argument, log2 units:
                                       // a term <= 2^64, a sum << FLT_MAX
constexpr float kNone = -FLT_MAX;      // running max before a finite logit

// Per-width shape, DS = d for d <= 8, else 12 or 16: queries per thread
// R, components per chunk J, components per staged tile TILE, and whether
// the next tile is prefetched into registers.  R is also
// kde_tpu_torch/ops/tiled_eval.py::rows_per_thread, which sizes the grid;
// the C entry refuses a launch whose rows_per_thread differs.
template <int DS> struct Shape {
  static constexpr int R = (DS >= 3 && DS <= 8) ? 4 : 2;
  static constexpr int J = DS <= 2 ? 16 : 8;
  static constexpr int TILE = DS <= 2 ? 256 : DS <= 4 ? 128 : 64;
  static constexpr bool PREFETCH = DS <= 8;
};

// What a launch leaves out: nothing, component m for query m, or
// component m + diag.
enum Loo { kNoLoo = 0, kDiagonal = 1, kOffset = 2 };

__device__ __forceinline__ float fast_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One chunk of J staged components against the thread's R queries.
// cs: the chunk's (mu[DS], hinv[DS]) records; cc: its J c's (16-byte
// aligned); cmax: the largest of them; n_first: the global index of its
// first component; skip_first: the component the thread's query 0 skips
// under MASK, its global index plus diag (query r skips skip_first + r * T).
// Query r's state: its running max m[r], lim[r] = m[r] + kBound and four
// partial sums a[r][0..3] relative to m[r].
template <int DS, bool MASK>
__device__ __forceinline__ void chunk(const float* __restrict__ cs,
                                      const float* __restrict__ cc,
                                      float cmax,
                                      const float (&qv)[Shape<DS>::R][DS],
                                      float (&m)[Shape<DS>::R],
                                      float (&lim)[Shape<DS>::R],
                                      float (&a)[Shape<DS>::R][4],
                                      int n_first, int skip_first, int T) {
  constexpr int R = Shape<DS>::R, J = Shape<DS>::J;
  float l[J][R];
#pragma unroll
  for (int j4 = 0; j4 < J; j4 += 4) {
    const float4 c4 = *reinterpret_cast<const float4*>(cc + j4);
    const float cj[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jj = j4 + u;
      float mu[DS], h[DS];
      if constexpr (DS == 1) {         // two components per LDS.128
        const float4 v = *reinterpret_cast<const float4*>(cs + (jj & ~1) * 2);
        mu[0] = (u & 1) ? v.z : v.x;
        h[0] = (u & 1) ? v.w : v.y;
      } else if constexpr (DS % 4 == 0) {   // LDS.128 throughout
        const float4* rec = reinterpret_cast<const float4*>(cs + jj * 2 * DS);
#pragma unroll
        for (int k4 = 0; k4 < DS / 4; ++k4) {
          const float4 x = rec[k4], y = rec[DS / 4 + k4];
          mu[4 * k4] = x.x; mu[4 * k4 + 1] = x.y;
          mu[4 * k4 + 2] = x.z; mu[4 * k4 + 3] = x.w;
          h[4 * k4] = y.x; h[4 * k4 + 1] = y.y;
          h[4 * k4 + 2] = y.z; h[4 * k4 + 3] = y.w;
        }
      } else if constexpr (DS == 2) {
        const float4 v = *reinterpret_cast<const float4*>(cs + jj * 4);
        mu[0] = v.x; mu[1] = v.y; h[0] = v.z; h[1] = v.w;
      } else {
        const float* rec = cs + jj * 2 * DS;
#pragma unroll
        for (int k = 0; k < DS; ++k) {
          mu[k] = rec[k];
          h[k] = rec[DS + k];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float acc = cj[u];
#pragma unroll
        for (int k = 0; k < DS; ++k) {
          const float t = qv[r][k] - mu[k];
          acc = fmaf(-(t * h[k]), t, acc);
        }
        if (MASK && n_first + jj == skip_first + r * T) acc = -INFINITY;
        l[jj][r] = acc;
      }
    }
  }
  // Every logit is at most its component's c, so a query whose running max
  // is within kBound of cmax needs neither the chunk max nor a rescale;
  // only the others take the max and rescale when it passes m + kRescale.
  // Either way each exp argument is <= kBound.
  bool far[R];
  bool any_far = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    far[r] = cmax > lim[r];
    any_far |= far[r];
  }
  if (any_far) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float cm = l[0][r];
#pragma unroll
      for (int jj = 1; jj < J; ++jj) cm = fmaxf(cm, l[jj][r]);
      if (far[r] && cm > m[r] + kRescale) {
        const float f = fast_ex2(m[r] - cm);
#pragma unroll
        for (int k = 0; k < 4; ++k) a[r][k] *= f;
        m[r] = cm;
        lim[r] = cm + kBound;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int jj = 0; jj < J; ++jj) a[r][jj & 3] += fast_ex2(l[jj][r] - m[r]);
  }
}

// Width DS: d = DS for DS <= 8, d = 9..DS (runtime) for DS = 12 or 16.
// Grid (ceil(M / (T * R)), splits), cluster (1, splits, 1).  diag is read
// only when LOO is kOffset.
template <int DS, int LOO>
__global__ void __launch_bounds__(kMaxThreads)
tiled_eval(const float* __restrict__ q, const float* __restrict__ mu,
           const float* __restrict__ var, const float* __restrict__ w,
           float* __restrict__ out, int M, int N, int d_rt, int per_split,
           int diag) {
  using S = Shape<DS>;
  constexpr int R = S::R, J = S::J, TILE = S::TILE;
  constexpr int STRIDE = 2 * DS;
  static_assert(TILE % 32 == 0 && 32 % J == 0, "a warp stages whole chunks");
  constexpr int P = (TILE + kMinThreads - 1) / kMinThreads;
  const int d = DS <= 8 ? DS : d_rt;
  __shared__ __align__(16) float comp_s[2][TILE * STRIDE];
  __shared__ __align__(16) float c_s[2][TILE];
  __shared__ float cmax_s[2][TILE / J];
  __shared__ float part_s[2][kMaxThreads * R];

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int q_base = blockIdx.x * T * R;
  const int q_first = q_base + tid;
  const int dg = LOO == kOffset ? diag : 0;

  float qv[R][DS];
  float m[R], lim[R], a[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q_first + r * T;
#pragma unroll
    for (int k = 0; k < DS; ++k)
      qv[r][k] = (qi < M && k < d) ? q[(size_t)qi * d + k] : 0.f;
    m[r] = kNone;
    lim[r] = kNone + kBound;
#pragma unroll
    for (int k = 0; k < 4; ++k) a[r][k] = 0.f;
  }

  const int n_begin = blockIdx.y * per_split;
  const int n_end = min(N, n_begin + per_split);
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + TILE - 1) / TILE : 0;

  // the next tile's raw values, held in registers across a tile's compute
  float pm[P][DS], pv[P][DS], pw[P];
  auto fetch = [&](int tile) {
    const int n0 = n_begin + tile * TILE;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = tid + p * T;
      const bool ok = j < TILE && n0 + j < n_end;
      const size_t base = (size_t)(n0 + j) * d;
#pragma unroll
      for (int k = 0; k < DS; ++k) {   // a padded dim: mu 0, var 1
        const bool dim = DS <= 8 || k < d;
        pm[p][k] = ok && dim ? mu[base + k] : 0.f;
        pv[p][k] = ok && dim ? var[base + k] : 1.f;
      }
      pw[p] = ok ? w[n0 + j] : 0.f;     // padding: weight 0, logit -inf
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = tid + p * T;
      if (j < TILE) {
        float lv = 0.f;
#pragma unroll
        for (int k = 0; k < DS; ++k) {
          comp_s[buf][j * STRIDE + k] = pm[p][k];
          comp_s[buf][j * STRIDE + DS + k] = kHalfLog2e / pv[p][k];
          lv += log2f(pv[p][k]);
        }
        // the chunk's largest c: its J components sit on J neighbouring
        // lanes, and a warp stages whole chunks (TILE and T are multiples
        // of 32)
        const float c = log2f(pw[p]) - 0.5f * lv;
        c_s[buf][j] = c;
        float cm = c;
#pragma unroll
        for (int o = J / 2; o > 0; o /= 2)
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
        if (j % J == 0) cmax_s[buf][j / J] = cm;
      }
    }
  };

  if (n_tiles > 0) {
    fetch(0);
    stage(0);
  }
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (S::PREFETCH && t + 1 < n_tiles) fetch(t + 1);
    const int n0 = n_begin + t * TILE;
    const int cnt = min(TILE, n_end - n0);
    for (int j0 = 0; j0 < cnt; j0 += J) {
      const float* cs = &comp_s[buf][j0 * STRIDE];
      const float* cc = &c_s[buf][j0];
      // the block's rows skip the columns [q_base + dg, + T * R)
      const bool masked = LOO != kNoLoo && n0 + j0 < q_base + dg + T * R &&
                          n0 + j0 + J > q_base + dg;
      const float cmax = cmax_s[buf][j0 / J];
      if (masked)
        chunk<DS, true>(cs, cc, cmax, qv, m, lim, a, n0 + j0, q_first + dg,
                        T);
      else
        chunk<DS, false>(cs, cc, cmax, qv, m, lim, a, n0 + j0, q_first, T);
    }
    if (t + 1 < n_tiles) {
      if (!S::PREFETCH) fetch(t + 1);
      stage(buf ^ 1);
    }
    __syncthreads();
  }

  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = (a[r][0] + a[r][1]) + (a[r][2] + a[r][3]);

  // merge the splits' partials on rank 0 through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned nsplit = cluster.num_blocks();
  if (nsplit > 1) {
    if (rank != 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        part_s[0][r * T + tid] = m[r];
        part_s[1][r * T + tid] = s[r];
      }
    }
    cluster.sync();
    if (rank == 0) {
      for (unsigned i = 1; i < nsplit; ++i) {
        const float* pm_r = cluster.map_shared_rank(&part_s[0][0], i);
        const float* ps_r = cluster.map_shared_rank(&part_s[1][0], i);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float mi = pm_r[r * T + tid];
          const float si = ps_r[r * T + tid];
          const float mn = fmaxf(m[r], mi);
          s[r] = s[r] * fast_ex2(m[r] - mn) + si * fast_ex2(mi - mn);
          m[r] = mn;
        }
      }
    }
    cluster.sync();                      // rank 0 is done reading
  }
  if (rank == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q_first + r * T;
      // s == 0 (every component masked): log2(0) = -inf
      if (qi < M) out[qi] = (log2f(s[r]) + m[r]) * kLn2 - 0.5f * d * kLog2Pi;
    }
  }
}

template <int DS>
int launch(const float* q, const float* mu, const float* var, const float* w,
           float* out, int M, int N, int d, bool loo, int diag, int threads,
           int rows_per_thread, int splits, int per_split, cudaStream_t st) {
  if (rows_per_thread != Shape<DS>::R) return (int)cudaErrorInvalidValue;
  const int rows = threads * Shape<DS>::R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + rows - 1) / rows), (unsigned)splits, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  // the default policy left SMs without a block and put 6 on others
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t e;
  if (!loo)
    e = cudaLaunchKernelEx(&cfg, tiled_eval<DS, kNoLoo>, q, mu, var, w, out,
                           M, N, d, per_split, 0);
  else if (diag == 0)
    e = cudaLaunchKernelEx(&cfg, tiled_eval<DS, kDiagonal>, q, mu, var, w,
                           out, M, N, d, per_split, 0);
  else
    e = cudaLaunchKernelEx(&cfg, tiled_eval<DS, kOffset>, q, mu, var, w,
                           out, M, N, d, per_split, diag);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing, returns a CUDA error code (0 on
// success).  threads, rows_per_thread, splits and per_split come from the
// wrapper's launch plan; rows_per_thread must equal the kernel's R for d.
// With loo, query m skips component m + diag; any diag may be given, and
// one at or beyond N, or at or below -M, skips nothing.
extern "C" int kde_tiled_log_eval(const float* q, const float* mu,
                                  const float* var, const float* w,
                                  float* out, int M, int N, int d, int loo,
                                  int diag, int threads, int rows_per_thread,
                                  int splits, int per_split, void* stream) {
  if (d < 1 || d > kMaxDim || N < 0 || splits < 1 || splits > kMaxSplits ||
      (threads != kMinThreads && threads != kMaxThreads) || per_split < 1 ||
      (long long)per_split * splits < N)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // no row's skipped column lies in [0, N): nothing to mask
  const bool l = loo != 0 && diag < N && diag > -M;
#define KDE_LAUNCH(DIM)                                                      \
  launch<DIM>(q, mu, var, w, out, M, N, d, l, diag, threads,                 \
              rows_per_thread, splits, per_split, st)
  switch (d) {
    case 1: return KDE_LAUNCH(1);
    case 2: return KDE_LAUNCH(2);
    case 3: return KDE_LAUNCH(3);
    case 4: return KDE_LAUNCH(4);
    case 5: return KDE_LAUNCH(5);
    case 6: return KDE_LAUNCH(6);
    case 7: return KDE_LAUNCH(7);
    case 8: return KDE_LAUNCH(8);
    default: return d <= 12 ? KDE_LAUNCH(12) : KDE_LAUNCH(16);
  }
#undef KDE_LAUNCH
}
