// float64 kernels of the small-problem routes (ops/host_small.py), for
// Hopper (sm_90a).  Built with --fmad=false: no a*b+c is contracted into an
// FMA, so each expression rounds as the Python and NumPy code it mirrors.
//
// loo_golden replaces kde_tpu/native/hostops.cpp::kde_loo_golden_1d /
// kde_loo_golden / golden_over_D and kde_tpu/ops/host_small.py::
// ksize_host_np with its _golden_scalar: the whole LOOCV golden-section
// search of one row (one dimension) in one thread block, every row of the
// call in one launch.  Each probe alpha evaluates
//
//   nll(alpha) = -sum_i w_i log sum_{j != i} w_j exp(a (d2_ij - dmin_i))
//                + the probe-independent tail,  a = -1 / (2 base_var alpha^2)
//
// with dmin_i the squared distance to i's nearest positive-weight
// neighbour (0 when there is none: n == 1, or no live neighbour).  Dead
// (zero-weight) columns add exactly nothing and dead rows are left out,
// ksize_host_np's zero-weight branch; with all weights positive the tail is
// folded as in its all-positive branch.  dmin lives in dynamic shared memory
// (n doubles, so n <= kMaxGoldenN), d2 is recomputed from x at every probe
// (no [N, N] matrix), a row's sum over j is taken by one warp, and
// the block's sum over i in a fixed order, so the result does not change
// from run to run.  The bracket arithmetic is _golden_scalar's, the same
// IEEE double operations in the same order (every thread runs it on the
// same values), with the golden constants passed in from Python.
//
// small_log_eval replaces hostops.cpp::kde_log_eval_1d and host_small.py::
// log_eval_np / log_eval_loo_np: for each query row m,
//
//   out[m] = log sum_n w_n prod_k N(q_mk; mu_nk, var_nk)
//
// for any d and per-kernel variances, in the direct (q - mu)^2 / var form.
// One warp per query takes the maximum logit, then the shifted sum; a zero
// weight gives a -inf logit.  With loo, component m is skipped for query m
// and log1p(-w_m) is subtracted, as log_eval_loo_np does.  exp and log are
// CUDA's double functions: a hand-rolled polynomial exp is what broke
// hostops.cpp's masked tail.
//
// What bounds them: at the sizes the routes take (N * N * d <= 2^16 for the
// search, M * N * d <= 2^18 for the evaluation) the work is a few hundred
// thousand exps, microseconds of the FP64 pipe even on one SM, so a launch
// (and the search's chain of ~25 dependent block-wide probes) bounds them,
// not the FP64 pipe.  One block per row uses a sliver of the card by
// design: the problems are tiny, and splitting a row over a cluster is
// later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;              // loo_golden: one block per row
constexpr int kWarps = kThreads / 32;
constexpr int kEvalThreads = 256;          // small_log_eval: a warp a query
// loo_golden's dmin (n doubles) and red fit the 48 KiB of shared memory a
// block gets without opting in; ops/host_small.py::GOLDEN_MAX_N is the same.
constexpr int kMaxGoldenN = 6000;
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

// Sum of v over the block in a fixed order (warps by a fixed shuffle tree,
// then their partials in warp order); every thread gets the same value.
__device__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  __syncthreads();                      // the last call's result is read
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int k = 0; k < kWarps; ++k) s += red[k];
    red[kWarps] = s;
  }
  __syncthreads();
  return red[kWarps];
}

struct LooRow {
  const double* x;     // [n] this row's coordinates
  const double* w;     // [n] weights, shared by every row
  double* dmin;        // [n] shared: nearest live neighbour's d2
  int n;
  bool all_pos;
  double w_dmin;       // sum_i w_i dmin_i
  double w_const;      // sum_i w_i c_i, c_i = -LOG_2PI / 2 - log1p(-w_i)
};

// One probe: nll(alpha), the same value in every thread.
__device__ double loo_nll(const LooRow& r, double alpha, double base_var,
                          double* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const double var = base_var * alpha * alpha;
  const double a = -0.5 / var;
  const double half_log_var = 0.5 * log(var);
  double acc = 0.0;
  for (int i = warp; i < r.n; i += kWarps) {
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
  const double tot = block_sum(lane == 0 ? acc : 0.0, red);
  if (r.all_pos) return -tot - a * r.w_dmin - r.w_const + half_log_var;
  return -tot;
}

__global__ void __launch_bounds__(kThreads)
loo_golden_kernel(const double* __restrict__ rows,
                  const double* __restrict__ w,
                  const double* __restrict__ base_var,
                  const double* __restrict__ ax, const double* __restrict__ bx,
                  const double* __restrict__ cx, double* __restrict__ xmin,
                  int n, double tol, int max_iters, double gc, double gr) {
  __shared__ double red[kWarps + 1];
  extern __shared__ double dmin_s[];
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  LooRow r;
  r.x = rows + (size_t)row * n;
  r.w = w;
  r.dmin = dmin_s;
  r.n = n;
  int dead = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) dead |= !(w[j] > 0.0);
  r.all_pos = __syncthreads_or(dead) == 0;

  // probe-independent: each row's nearest live neighbour and the sums
  double wd = 0.0, wc = 0.0;
  for (int i = warp; i < n; i += kWarps) {
    const double xi = r.x[i];
    double dm = INFINITY;
    for (int j = lane; j < n; j += 32) {
      if (j == i || !(w[j] > 0.0)) continue;
      const double dx = xi - r.x[j];
      dm = fmin(dm, dx * dx);
    }
    dm = warp_min(dm);
    if (!(dm < INFINITY)) dm = 0.0;                 // n == 1 / no live nbr
    if (lane == 0) {
      r.dmin[i] = dm;
      wd += w[i] * dm;
      wc += w[i] * (-0.5 * kLog2Pi - log1p(-w[i]));
    }
  }
  r.w_dmin = block_sum(wd, red);                   // also publishes dmin
  r.w_const = block_sum(wc, red);

  // _golden_scalar, line for line
  const double bv = base_var[row];
  double x0 = ax[row], x3 = cx[row], x1, x2;
  const double b = bx[row];
  if (fabs(x3 - b) > fabs(b - x0)) {
    x1 = b;
    x2 = b + gc * (x3 - b);
  } else {
    x1 = b - gc * (b - x0);
    x2 = b;
  }
  double f1 = loo_nll(r, x1, bv, red);
  double f2 = loo_nll(r, x2, bv, red);
  int it = 0;
  while (fabs(x3 - x0) > tol * (fabs(x1) + fabs(x2)) && it < max_iters) {
    if (f2 < f1) {
      x0 = x1;
      x1 = x2;
      x2 = gr * x2 + gc * x3;
      f1 = f2;
      f2 = loo_nll(r, x2, bv, red);
    } else {
      x3 = x2;
      x2 = x1;
      x1 = gr * x1 + gc * x0;
      f2 = f1;
      f1 = loo_nll(r, x1, bv, red);
    }
    ++it;
  }
  if (threadIdx.x == 0) xmin[row] = f1 < f2 ? x1 : x2;
}

__device__ __forceinline__ double logit(const double* qi,
                                        const double* __restrict__ mu,
                                        const double* __restrict__ var,
                                        const double* __restrict__ w, int j,
                                        int d) {
  double quad = 0.0, lv = 0.0;
  for (int k = 0; k < d; ++k) {
    const double t = qi[k] - mu[(size_t)j * d + k];
    const double v = var[(size_t)j * d + k];
    quad += t * t / v;
    lv += log(v);
  }
  return log(w[j]) - 0.5 * (quad + lv);
}

__global__ void __launch_bounds__(kEvalThreads)
small_log_eval_kernel(const double* __restrict__ q,
                      const double* __restrict__ mu,
                      const double* __restrict__ var,
                      const double* __restrict__ w, double* __restrict__ out,
                      int M, int N, int d, int loo) {
  const int lane = threadIdx.x & 31;
  const long long m =
      (long long)blockIdx.x * (kEvalThreads / 32) + (threadIdx.x >> 5);
  if (m >= M) return;                   // the whole warp leaves together
  const double* qi = q + (size_t)m * d;
  double mx = -INFINITY;
  for (int j = lane; j < N; j += 32) {
    if (loo && j == m) continue;
    mx = fmax(mx, logit(qi, mu, var, w, j, d));
  }
  mx = warp_max(mx);
  double s = 0.0;
  if (mx > -INFINITY) {                 // the same in every lane
    for (int j = lane; j < N; j += 32) {
      if (loo && j == m) continue;
      s += exp(logit(qi, mu, var, w, j, d) - mx);
    }
    s = warp_sum(s);
  }
  if (lane == 0) {
    double r = mx + log(s) - 0.5 * d * kLog2Pi;   // all -inf: -inf
    if (loo) r -= log1p(-w[m]);
    out[m] = r;
  }
}

// Does nothing.  Only chip_smoke.py launches it, through kde_empty_launch:
// the floor that the two kernels' times are read against.
__global__ void empty_kernel() {}

}  // namespace

// rows [R, n], w [n], base_var/ax/bx/cx/xmin [R]; all float64 and
// contiguous on the stream's device, 1 <= n <= kMaxGoldenN.  Returns a
// cudaError_t.
extern "C" int kde_loo_golden(const double* rows, const double* w,
                              const double* base_var, const double* ax,
                              const double* bx, const double* cx,
                              double* xmin, int R, int n, double tol,
                              int max_iters, double gc, double gr,
                              void* stream) {
  if (R < 0 || n < 1 || n > kMaxGoldenN || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  loo_golden_kernel<<<R, kThreads, n * sizeof(double), (cudaStream_t)stream>>>(
      rows, w, base_var, ax, bx, cx, xmin, n, tol, max_iters, gc, gr);
  return (int)cudaGetLastError();
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
  const int per_block = kEvalThreads / 32;
  const int blocks = (M + per_block - 1) / per_block;
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
