// float64 kernels of the small-problem routes (ops/host_small.py), for
// Hopper (sm_90a).  Built with --fmad=false: no a*b+c is contracted into an
// FMA, so each expression rounds as the Python and NumPy code it mirrors.
//
// ksize_golden replaces kde_tpu/native/hostops.cpp::kde_loo_golden_1d /
// kde_loo_golden / golden_over_D and kde_tpu/ops/host_small.py::
// ksize_host_np with bracket_rows_np and _golden_scalar: the whole LOOCV
// bandwidth selection of one row (one dimension), the neighborMinMax
// bracket and then the golden-section search, every row of the call in one
// launch.  Each probe alpha evaluates
//
//   nll(alpha) = -sum_i w_i log sum_{j != i} w_j exp(a (d2_ij - dmin_i))
//                + the probe-independent tail,  a = -1 / (2 base_var alpha^2)
//
// with dmin_i the squared distance to i's nearest positive-weight
// neighbour (0 when there is none: n == 1, or no live neighbour).  Dead
// (zero-weight) columns add exactly nothing and dead rows are left out,
// ksize_host_np's zero-weight branch; with all weights positive the tail is
// folded as in its all-positive branch.
//
// What bounds it: at the sizes the route takes (N * N * d <= 2^16) a row is
// a few thousand exps a probe, nanoseconds of the FP64 pipe; the time is
// the launch and the chain of ~20 dependent probes, each a reduction over
// the row.  So the design shortens the chain's links:
//   * a row is split over a thread-block cluster of C blocks (gridDim.x =
//     R * C, cluster (C, 1, 1); C <= 8 portable, 16 with the non-portable
//     attribute).  Every block holds the row's x and w in shared memory and
//     the shifts dmin of its own slice of rows i; a warp takes a row i, its
//     lanes the columns j, so at C = 8 and N <= 128, or C = 16 and
//     N <= 256, a probe costs one row's exps and one cluster barrier;
//   * a probe's sum: each warp sums its rows in order, thread 0 sums the
//     warps in order into the block's partial, and after one cluster.sync()
//     every block reads all C partials through distributed shared memory in
//     rank order.  So every thread of every block holds the same double,
//     takes the same golden branch and runs the same number of probes (a
//     block that decided on its own partial would hang the next barrier).
//     The partials are double-buffered by parity, so one barrier a probe is
//     enough; the sums of w dmin and of the tail constants go the same way;
//   * the bracket is the kernel's prologue, bitwise ops/loocv.py::
//     bracket_rows: every block sorts the row in shared memory by a stable
//     rank count (N <= 256 under the gate), takes the internal nodes'
//     extents s[hi] - s[lo] from the (lo, hi) table the wrapper uploads once
//     per (N, device), and forms base, ax, bx = 1, cx in IEEE double;
//   * the search is _golden_scalar, the same IEEE double operations in the
//     same order (every thread runs it on the same values), with the golden
//     constants passed in from Python; the result is xmin * base.
// With the bracket passed in (kde_loo_golden) the same kernel runs the
// search alone and returns xmin.  The sums are taken in a fixed order for a
// given C, so a selection does not change from launch to launch; C = 1 is
// one block a row, in the order of the one-block kernel it replaces.
//
// small_log_eval replaces hostops.cpp::kde_log_eval_1d and host_small.py::
// log_eval_np / log_eval_loo_np: for each query row m,
//
//   out[m] = log sum_n w_n prod_k N(q_mk; mu_nk, var_nk)
//
// for any d and per-kernel variances, in the direct (q - mu)^2 / var form.
// A block stages tiles of components' constants c_n = log w_n - 1/2
// sum_k log var_nk in shared memory (a zero weight gives -inf), so a pair
// costs d differences, squares and divisions and one exp: a warp a query,
// each lane an online (max, sum) over its components, then the lanes'
// partials merged in a fixed shuffle order.  With loo, component m is
// skipped for query m and log1p(-w_m) is subtracted, as log_eval_loo_np
// does.  exp and log are CUDA's double functions: a hand-rolled polynomial
// exp is what broke hostops.cpp's masked tail.  Bound: like the search, the
// launch, not the FP64 pipe (M * N * d <= 2^18).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;              // ksize_golden: a block of a cluster
constexpr int kWarps = kThreads / 32;
constexpr int kEvalThreads = 128;          // small_log_eval: a warp a query
constexpr int kEvalQueries = kEvalThreads / 32;
// The most points a row may have: x, w and dmin (3 N doubles) in dynamic
// shared memory; ops/host_small.py::GOLDEN_MAX_N is the same.
constexpr int kMaxGoldenN = 6000;
constexpr int kMaxGoldenSmem = 3 * kMaxGoldenN * (int)sizeof(double);
constexpr int kMaxDevices = 64;
// float(np.log(2 * np.pi)), host_small.py's LOG_2PI (shortest round trip)
constexpr double kLog2Pi = 1.8378770664093453;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ double warp_min(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmin(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The cluster's reductions: partials by parity, so that one cluster
// barrier a reduction is enough (see the header).
struct Reducer {
  double (*red)[kWarps];   // [2][kWarps] shared: the warps' partials
  double* part;            // [2] shared: the block's partial
  int parity;
};

// Sum over the cluster of v, held by lane 0 of each warp: warps in order,
// then the blocks' partials in rank order.  Every thread of every block
// gets the same value.
__device__ double cluster_sum(double v, Reducer& rd, cg::cluster_group& cl) {
  const int p = rd.parity;
  rd.parity ^= 1;
  if ((threadIdx.x & 31) == 0) rd.red[p][threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int k = 0; k < kWarps; ++k) s += rd.red[p][k];
    rd.part[p] = s;
  }
  cl.sync();
  double t = 0.0;
  const unsigned nb = cl.num_blocks();
  for (unsigned r = 0; r < nb; ++r) t += *cl.map_shared_rank(&rd.part[p], r);
  return t;
}

struct LooRow {
  const double* x;     // shared [n]: this row's coordinates
  const double* w;     // shared [n]: weights, shared by every row
  const double* dmin;  // shared [n]: nearest live neighbour's d2, [i0, i1)
  int n, i0, i1;       // this block's rows i
  bool all_pos;
  double w_dmin;       // sum_i w_i dmin_i
  double w_const;      // sum_i w_i c_i, c_i = -LOG_2PI / 2 - log1p(-w_i)
};

// One probe: nll(alpha), the same value in every thread of the cluster.
__device__ double loo_nll(const LooRow& r, double alpha, double base_var,
                          Reducer& rd, cg::cluster_group& cl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const double var = base_var * alpha * alpha;
  const double a = -0.5 / var;
  const double half_log_var = 0.5 * log(var);
  double acc = 0.0;
  for (int i = r.i0 + warp; i < r.i1; i += kWarps) {
    const double wi = r.w[i];
    if (!r.all_pos && !(wi > 0.0)) continue;          // dead rows: nothing
    const double xi = r.x[i];
    const double dm = r.dmin[i];
    double s = 0.0;
    for (int j = lane; j < r.n; j += 32) {
      const double wj = r.w[j];
      if (j == i || !(wj > 0.0)) continue;            // dead columns: 0
      const double dx = xi - r.x[j];
      s += wj * exp((dx * dx - dm) * a);
    }
    s = warp_sum(s);
    const double ls = log(s);
    if (r.all_pos) {
      acc += wi * ls;
    } else {
      const double ci = -0.5 * kLog2Pi - log1p(-wi);
      acc += wi * (ls + a * dm + (ci - half_log_var));
    }
  }
  const double tot = cluster_sum(acc, rd, cl);
  if (r.all_pos) return -tot - a * r.w_dmin - r.w_const + half_log_var;
  return -tot;
}

// The bracket of ops/loocv.py::bracket_rows for the row in x [n]: sorted
// into s [n] (shared scratch) by a stable rank count, the internal nodes'
// extents s[hi] - s[lo], maxm the root's, minm their least, at least 1e-6.
__device__ void bracket(const double* x, double* s, int n,
                        const long long* __restrict__ lo,
                        const long long* __restrict__ hi, int n_nodes,
                        double* mred, double& minm, double& maxm) {
  if (n < 2 || n_nodes == 0) {
    minm = maxm = 1e-6;
    return;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double v = x[i];
    int k = 0;
    for (int j = 0; j < n; ++j) {
      const double u = x[j];
      k += (u < v) || (u == v && j < i);
    }
    s[k] = v;
  }
  __syncthreads();
  double m = INFINITY;
  for (int k = threadIdx.x; k < n_nodes; k += kThreads)
    m = fmin(m, s[hi[k]] - s[lo[k]]);
  m = warp_min(m);
  if ((threadIdx.x & 31) == 0) mred[threadIdx.x >> 5] = m;
  __syncthreads();
  m = mred[0];
  for (int k = 1; k < kWarps; ++k) m = fmin(m, mred[k]);   // exact: a min
  maxm = s[hi[0]] - s[lo[0]];
  minm = fmax(m, 1e-6);
  __syncthreads();                      // s is read; the caller reuses it
}

// One row's bandwidth selection on a cluster of C blocks, row = blockIdx.x
// / C.  kFused: the bracket from lo/hi, out = xmin * base; otherwise the
// bracket from base_var/ax/bx/cx, out = xmin.
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
ksize_golden_kernel(const double* __restrict__ rows,
                    const double* __restrict__ w,
                    const long long* __restrict__ lo,
                    const long long* __restrict__ hi, int n_nodes,
                    const double* __restrict__ base_var_in,
                    const double* __restrict__ ax, const double* __restrict__ bx,
                    const double* __restrict__ cx, double* __restrict__ out,
                    int n, double tol, int max_iters, double gc, double gr) {
  __shared__ double red[2][kWarps];
  __shared__ double part[2];
  __shared__ double mred[kWarps];
  extern __shared__ double smem[];     // x [n], w [n], dmin [n]
  cg::cluster_group cl = cg::this_cluster();
  const unsigned nblk = cl.num_blocks(), rank = cl.block_rank();
  const int row = (int)(blockIdx.x / nblk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* x_s = smem;
  double* w_s = smem + n;
  double* dmin_s = smem + 2 * n;
  const double* xg = rows + (size_t)row * n;
  int dead = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    x_s[j] = xg[j];
    const double wj = w[j];
    w_s[j] = wj;
    dead |= !(wj > 0.0);
  }
  LooRow r;
  r.x = x_s;
  r.w = w_s;
  r.dmin = dmin_s;
  r.n = n;
  r.all_pos = __syncthreads_or(dead) == 0;          // also publishes x, w

  // the bracket: every block forms the same one
  double bv, x0, b, x3, base = 1.0;
  if constexpr (kFused) {
    double minm, maxm;
    bracket(x_s, dmin_s, n, lo, hi, n_nodes, mred, minm, maxm);
    base = (minm + maxm) / 2.0;
    x0 = 2.0 * minm / (minm + maxm);
    b = 1.0;
    x3 = 2.0 * maxm / (minm + maxm);
    bv = base * base;
  } else {
    bv = base_var_in[row];
    x0 = ax[row];
    b = bx[row];
    x3 = cx[row];
  }

  // probe-independent: the nearest live neighbour of this block's rows i,
  // and the cluster's sums
  const int per = (n + (int)nblk - 1) / (int)nblk;
  r.i0 = min(n, (int)rank * per);
  r.i1 = min(n, r.i0 + per);
  double wd = 0.0, wc = 0.0;
  for (int i = r.i0 + warp; i < r.i1; i += kWarps) {
    const double xi = x_s[i];
    double dm = INFINITY;
    for (int j = lane; j < n; j += 32) {
      if (j == i || !(w_s[j] > 0.0)) continue;
      const double dx = xi - x_s[j];
      dm = fmin(dm, dx * dx);
    }
    dm = warp_min(dm);
    if (!(dm < INFINITY)) dm = 0.0;                 // n == 1 / no live nbr
    if (lane == 0) {
      dmin_s[i] = dm;
      wd += w_s[i] * dm;
      wc += w_s[i] * (-0.5 * kLog2Pi - log1p(-w_s[i]));
    }
  }
  Reducer rd{red, part, 0};
  r.w_dmin = cluster_sum(wd, rd, cl);               // also publishes dmin
  r.w_const = cluster_sum(wc, rd, cl);

  // _golden_scalar, line for line
  double x1, x2;
  if (fabs(x3 - b) > fabs(b - x0)) {
    x1 = b;
    x2 = b + gc * (x3 - b);
  } else {
    x1 = b - gc * (b - x0);
    x2 = b;
  }
  double f1 = loo_nll(r, x1, bv, rd, cl);
  double f2 = loo_nll(r, x2, bv, rd, cl);
  int it = 0;
  while (fabs(x3 - x0) > tol * (fabs(x1) + fabs(x2)) && it < max_iters) {
    if (f2 < f1) {
      x0 = x1;
      x1 = x2;
      x2 = gr * x2 + gc * x3;
      f1 = f2;
      f2 = loo_nll(r, x2, bv, rd, cl);
    } else {
      x3 = x2;
      x2 = x1;
      x1 = gr * x1 + gc * x0;
      f2 = f1;
      f1 = loo_nll(r, x1, bv, rd, cl);
    }
    ++it;
  }
  const double xmin = f1 < f2 ? x1 : x2;
  if (rank == 0 && threadIdx.x == 0) out[row] = kFused ? xmin * base : xmin;
  cl.sync();             // no block leaves while another reads its partial
}

__global__ void __launch_bounds__(kEvalThreads)
small_log_eval_kernel(const double* __restrict__ q,
                      const double* __restrict__ mu,
                      const double* __restrict__ var,
                      const double* __restrict__ w, double* __restrict__ out,
                      int M, int N, int d, int loo) {
  __shared__ double c_s[kEvalThreads];
  const int lane = threadIdx.x & 31;
  const long long m =
      (long long)blockIdx.x * kEvalQueries + (threadIdx.x >> 5);
  const bool live = m < M;              // the whole warp: it still stages
  const double* qi = q + (size_t)(live ? m : 0) * d;
  double mx = -INFINITY, s = 0.0;       // this lane's online (max, sum)
  for (int t0 = 0; t0 < N; t0 += kEvalThreads) {
    const int jt = t0 + (int)threadIdx.x;
    if (jt < N) {
      double lv = 0.0;
      for (int k = 0; k < d; ++k) lv += log(var[(size_t)jt * d + k]);
      c_s[threadIdx.x] = log(w[jt]) - 0.5 * lv;
    }
    __syncthreads();
    const int tn = min(kEvalThreads, N - t0);
    if (live) {
      for (int jj = lane; jj < tn; jj += 32) {
        const int j = t0 + jj;
        if (loo && j == m) continue;
        const double* mj = mu + (size_t)j * d;
        const double* vj = var + (size_t)j * d;
        double quad = 0.0;
        for (int k = 0; k < d; ++k) {
          const double t = qi[k] - mj[k];
          quad += t * t / vj[k];
        }
        const double l = c_s[jj] - 0.5 * quad;
        if (l > mx) {                   // one exp either way
          s = s * exp(mx - l) + 1.0;
          mx = l;
        } else if (l > -INFINITY) {
          s += exp(l - mx);
        }
      }
    }
    __syncthreads();                    // the tile is read
  }
  if (!live) return;
  const double wm = warp_max(mx);
  const double t = warp_sum(mx > -INFINITY ? s * exp(mx - wm) : 0.0);
  if (lane == 0) {
    double r = wm + log(t) - 0.5 * d * kLog2Pi;   // all -inf: -inf
    if (loo) r -= log1p(-w[m]);
    out[m] = r;
  }
}

// Does nothing.  Only chip_smoke.py launches it, through kde_empty_launch:
// the floor that the two kernels' times are read against.
__global__ void empty_kernel() {}

template <bool kFused>
cudaError_t golden_attributes() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static bool done[kMaxDevices] = {};
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(ksize_golden_kernel<kFused>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxGoldenSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ksize_golden_kernel<kFused>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) cudaGetLastError();
  else if (dev < kMaxDevices) done[dev] = true;
  return e;
}

// The launch configuration of R rows on clusters of `cluster` blocks.
struct GoldenLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  GoldenLaunch(int R, int n, int cluster, cudaStream_t st) : cfg() {
    cfg.gridDim = dim3((unsigned)R * (unsigned)cluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = 3 * (size_t)n * sizeof(double);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

bool golden_args_ok(int R, int n, int max_iters, int cluster) {
  return R >= 0 && n >= 1 && n <= kMaxGoldenN && max_iters >= 0 &&
         cluster >= 1 && (long long)R * cluster <= 0x7fffffffLL;
}

template <bool kFused>
int launch_golden(const double* rows, const double* w, const long long* lo,
                  const long long* hi, int n_nodes, const double* base_var,
                  const double* ax, const double* bx, const double* cx,
                  double* out, int R, int n, double tol, int max_iters,
                  double gc, double gr, int cluster, void* stream) {
  if (R == 0) return 0;
  cudaError_t e = golden_attributes<kFused>();
  if (e != cudaSuccess) return (int)e;
  GoldenLaunch l(R, n, cluster, (cudaStream_t)stream);
  e = cudaLaunchKernelEx(&l.cfg, ksize_golden_kernel<kFused>, rows, w, lo, hi,
                         n_nodes, base_var, ax, bx, cx, out, n, tol,
                         max_iters, gc, gr);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch must not fail the next caller
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The whole LOOCV bandwidth selection of R rows in one launch: rows [R, n],
// w [n], the internal nodes' leaf slices lo/hi [n_nodes] (int64, root
// first; n_nodes = n - 1, 0 for n = 1) and out [R] = xmin * base; float64,
// contiguous on the stream's device, 1 <= n <= kMaxGoldenN, each row on a
// cluster of `cluster` blocks.  A refused cluster size is the launch's
// error.  Returns a cudaError_t.
extern "C" int kde_ksize_small(const double* rows, const double* w,
                               const long long* lo, const long long* hi,
                               int n_nodes, double* out, int R, int n,
                               double tol, int max_iters, double gc, double gr,
                               int cluster, void* stream) {
  if (!golden_args_ok(R, n, max_iters, cluster) ||
      n_nodes != (n > 1 ? n - 1 : 0))
    return (int)cudaErrorInvalidValue;
  return launch_golden<true>(rows, w, lo, hi, n_nodes, nullptr, nullptr,
                             nullptr, nullptr, out, R, n, tol, max_iters, gc,
                             gr, cluster, stream);
}

// The golden search alone, from a given bracket: rows [R, n], w [n],
// base_var/ax/bx/cx/xmin [R]; otherwise as kde_ksize_small.  Returns a
// cudaError_t.
extern "C" int kde_loo_golden(const double* rows, const double* w,
                              const double* base_var, const double* ax,
                              const double* bx, const double* cx,
                              double* xmin, int R, int n, double tol,
                              int max_iters, double gc, double gr,
                              int cluster, void* stream) {
  if (!golden_args_ok(R, n, max_iters, cluster))
    return (int)cudaErrorInvalidValue;
  return launch_golden<false>(rows, w, nullptr, nullptr, 0, base_var, ax, bx,
                              cx, xmin, R, n, tol, max_iters, gc, gr,
                              cluster, stream);
}

// How many clusters of `cluster` blocks of the search kernel for rows of
// n points can be resident at once on the current device, into *count (0:
// the size is not admitted).  Both instantiations use the same resources
// but the fused one's bracket scratch, so the fused one is asked.
// Returns a cudaError_t.
extern "C" int kde_golden_max_clusters(int n, int cluster, int* count) {
  if (!golden_args_ok(1, n, 0, cluster)) return (int)cudaErrorInvalidValue;
  cudaError_t e = golden_attributes<true>();
  if (e != cudaSuccess) return (int)e;
  GoldenLaunch l(1, n, cluster, nullptr);
  e = cudaOccupancyMaxActiveClusters(count, ksize_golden_kernel<true>,
                                     &l.cfg);
  if (e != cudaSuccess) {
    *count = 0;
    cudaGetLastError();   // a refused size must not fail the next caller
    return (int)e;
  }
  return 0;
}

// q [M, d], mu/var [N, d], w [N], out [M]; float64, contiguous.  With loo,
// M == N and q is mu.  Returns a cudaError_t.
extern "C" int kde_small_log_eval(const double* q, const double* mu,
                                  const double* var, const double* w,
                                  double* out, int M, int N, int d, int loo,
                                  void* stream) {
  if (M < 0 || N < 1 || d < 1 || (loo && M != N))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int blocks = (M + kEvalQueries - 1) / kEvalQueries;
  small_log_eval_kernel<<<blocks, kEvalThreads, 0, (cudaStream_t)stream>>>(
      q, mu, var, w, out, M, N, d, loo);
  return (int)cudaGetLastError();
}

// One launch of the empty kernel on the stream, for chip_smoke.py's timing
// floor; the package never calls it.  Returns a cudaError_t.
extern "C" int kde_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
