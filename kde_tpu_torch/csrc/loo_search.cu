// K4: the whole LOOCV golden-section search of R independent 1-D rows in
// one launch, for Hopper (sm_90a), in float32 and float64.
//
// Replaces kde_tpu/ops/loocv.py::_ksize_search (one jitted program: the
// golden search _golden_core in a lax.while_loop with no host read), with
// the Pallas probe it runs above LOOCV_PAIR_LIMIT (kde_tpu/ops/kernels.py::
// batched_loo_entropy, impl "pallas", which reaches pallas_eval.py::
// pallas_log_eval).  Its plain twin is kde_tpu_torch/ops/loo_search.py::
// loo_search_ref (the eager golden loop over the dense, chunk or tiled
// probe).  Row r holds N points x_rj; the shared weights w_j sum to 1.  A
// probe of row r at x is the LOO entropy with variance var = (x x) bv_r:
//
//   f(x) = -sum_{i: w_i > 0} w_i log p_-i(x_ri),
//   log p_-i = log sum_{j != i} w_j exp(-(x_ri - x_rj)^2 / (2 var))
//              - log(var) / 2 - log(2 pi) / 2 - log1p(-w_i),
//
// +inf when a positive-weight point has p = 0; zero-weight components add
// nothing and zero-weight points count for nothing.  The search is
// _golden_core step for step (bracket ax < bx < cx, masked updates, the
// stop rule |x3 - x0| > tol (|x1| + |x2|), max_iters, the final pick
// x1 if f1 < f2 else x2), in T with the golden constants and tol rounded
// to T as torch rounds a Python scalar; built with --fmad=false, so the
// bracket arithmetic rounds as the twin's separate torch ops do.
//
// What bounds it: every probe of a row is N (N - 1) pairs, each one exp
// that nothing shares.  float32 takes one MUFU ex2 a pair (16 a clock per
// SM), so the SFU is the bound; float64's exp is a polynomial on the FP64
// pipe (64 operations a clock per SM), so that pipe is, at the FP64
// instructions a pair that chip_smoke.py counts in the SASS.  The bytes
// (the rows, a few hundred kB) are nothing; the host round trips and the
// per-probe launches of the twin are what the design removes:
//   * one cooperative, persistent launch: the grid is the blocks that fit
//     on the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//     SMs, capped at the work items of the widest sweep) and grid.sync()
//     separates the phases; a grid that cannot be co-resident is the
//     launch's error;
//   * a probe is spread over every SM: the work items of a sweep are
//     (probe, row, group of kGroup queries), handed out by an atomic
//     counter per sweep (a block takes the next item when it finishes
//     one).  A warp takes kQ queries, its lanes the components; a block
//     streams the row through shared memory in tiles of kTile components
//     with cp.async (double-buffered), so each staged component serves the
//     block's kGroup queries;
//   * no running max: a query's sum is shifted by its nearest live
//     neighbour's squared distance dmin_i (found once, in the first sweep,
//     since it does not depend on the probe), so every term is w_j 2^t with
//     t <= 0 and the nearest term is w_nn: the sum lies in [w_nn, 1] and a
//     small ax cannot underflow it to 0 (for uniform weights the shift is
//     the exact max; for others it is within log w_nn of it).  Zero-weight
//     components are staged as x = +inf, so they add exactly 0 with no
//     branch; the LOO diagonal is masked in the one tile that holds the
//     item's queries;
//   * float32: the exp is one ex2.approx.ftz with log2 e folded into the
//     probe's scale and the shift; a lane sums a tile's 32 terms of a query
//     in float and adds that to a double, so a 100k-point row loses no
//     digits to the running sum;
//   * deterministic sums: a warp reduces its lanes in a fixed butterfly,
//     thread 0 the warps in order into the item's slot (float64, its
//     sum_i w_i log p_i; -inf carries the p = 0 case).  After the grid
//     sync every block reduces each row's slots in the same fixed order and
//     applies the same golden update to its own copy of the state (no
//     second sync), so every block takes the same branch and repeated calls
//     give equal bits.  Slots are double-buffered by the sweep's parity;
//   * the first sweep evaluates both x1 and x2 of every row; later sweeps
//     take only the rows still searching (frozen rows get no items).
//
// The probe arithmetic (the exp, a pair's term, the staging of a tile and
// a tile's pass) is csrc/loo_probe.cuh, which K7 (csrc/sharded_loo.cu)
// includes too.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libloo_search.so loo_search.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "loo_probe.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace kde_loo;

constexpr int kMaxRows = 1024;             // ops/loo_search.py::MAX_ROWS
constexpr int kMaxDevices = 64;
static_assert(kTile % kGroup == 0, "an item's queries lie in one tile");

template <typename T> struct Args {
  const T* rows;      // [R, n]
  const T* w;         // [n]
  const T* base_var;  // [R]
  const T* ax;        // [R]
  const T* bx;
  const T* cx;
  T* xmin;            // [R]
  T* trace;           // [R, max_iters + 2, 2] (probe, f), or null
  T* xs;              // scratch [R, n_pad]: x, +inf for dead and padding
  T* wp;              // scratch [n_pad]: w, 0 for padding
  T* dmin;            // scratch [R, n]
  double* slots;      // scratch [2 parity][2 probe][R][G]
  int* ctr;           // scratch [max_iters + 2]: one item counter a sweep
  int R, n, n_pad, G, max_iters;
  T tol, gc, gr;
};

// The block's copy of the search state, in dynamic shared memory after the
// two tile buffers.
template <typename T> struct State {
  T *x0, *x1, *x2, *x3, *f1, *f2, *pr0, *pr1;
  double* fval;       // [2][R]: the last sweep's entropies
  int* flag;          // [R]: bit 0 take2, bit 1 active
  int* act;           // [R]: the rows a sweep covers
};

template <typename T>
__device__ State<T> carve(unsigned char* smem, int R) {
  T* t = reinterpret_cast<T*>(smem) + 4 * kTile;
  State<T> s;
  s.x0 = t; s.x1 = t + R; s.x2 = t + 2 * R; s.x3 = t + 3 * R;
  s.f1 = t + 4 * R; s.f2 = t + 5 * R; s.pr0 = t + 6 * R; s.pr1 = t + 7 * R;
  s.fval = reinterpret_cast<double*>(t + 8 * R);
  s.flag = reinterpret_cast<int*>(s.fval + 2 * R);
  s.act = s.flag + R;
  return s;
}

template <typename T>
size_t smem_bytes(int R) {
  return 4 * kTile * sizeof(T) + 8 * (size_t)R * sizeof(T) +
         2 * (size_t)R * sizeof(double) + 2 * (size_t)R * sizeof(int);
}

// One work item: row r, queries [g kGroup, (g + 1) kGroup), probe x (kDmin:
// none).  kDmin writes dmin of its queries; else the item's
// sum_i w_i log p_i goes to *slot.
template <typename T, bool kDmin>
__device__ void run_item(const Args<T>& a, T* tiles, double* red, int r,
                         int g, T x, double* slot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = a.n;
  const T* row = a.rows + (size_t)r * n;
  const T* xs = a.xs + (size_t)r * a.n_pad;
  T xq[kQ], off[kQ], mn[kQ];
  int iq[kQ];
  double acc[kQ];
  T nh = T(0);
  double var = 0.0;
  if (!kDmin) {
    const T v = (x * x) * a.base_var[r];
    var = (double)v;
    nh = (T)(-0.5 * Num<T>::kScale / var);
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = g * kGroup + warp * kQ + q;
    iq[q] = i;
    xq[q] = i < n ? row[i] : T(0);
    mn[q] = (T)INFINITY;
    acc[q] = 0.0;
    off[q] = T(0);
    if (!kDmin && i < n)
      off[q] = -(__ldcg(a.dmin + (size_t)r * n + i) * nh);
  }
  const int n_tiles = a.n_pad / kTile;
  const int t_mask = (g * kGroup) / kTile;
  stage(tiles, 0, xs, a.wp, 0);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();              // tile t is in; tile t - 1 is read
    if (t + 1 < n_tiles) stage(tiles, (t + 1) & 1, xs, a.wp, t + 1);
    const T* sx = tiles + (t & 1) * 2 * kTile;
    const T* sw = sx + kTile;
    if (t == t_mask)
      tile_pass<T, kDmin, true>(sx, sw, t * kTile, xq, off, iq, nh, mn, acc);
    else
      tile_pass<T, kDmin, false>(sx, sw, t * kTile, xq, off, iq, nh, mn,
                                 acc);
  }
  if (kDmin) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      T m = warp_min(mn[q]);
      if (!(m < (T)INFINITY)) m = T(0);       // n == 1 / no live neighbour
      if (lane == q && iq[q] < n) a.dmin[(size_t)r * n + iq[q]] = m;
    }
    __syncthreads();              // the buffers are free for the next item
    return;
  }
  const double tail = -0.5 * log(var) - 0.5 * kLog2Pi;
  double c = 0.0;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const double s = warp_sum(acc[q]);
    const int i = iq[q];
    if (i < n) {
      const double wi = (double)a.w[i];
      if (wi > 0.0) {
        const double logp = log(s) - (double)off[q] / Num<T>::kScale + tail -
                            log1p(-wi);
        c += wi * logp;           // p = 0: -inf
      }
    }
  }
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int k = 0; k < kWarps; ++k) s += red[k];
    *slot = s;
  }
}

// A sweep: n_probe probes (slot p in 0..n_probe-1, probe x = pr0 / pr1) of
// the n_act rows in st.act, items handed out by counter a.ctr[sweep].
template <typename T, bool kDmin>
__device__ void sweep(const Args<T>& a, T* tiles, const State<T>& st,
                      int n_act, int n_probe, int sweep_ix, int parity,
                      double* red, int* s_item) {
  const int n_items = n_probe * n_act * a.G;
  for (;;) {
    if (threadIdx.x == 0) *s_item = atomicAdd(a.ctr + sweep_ix, 1);
    __syncthreads();
    const int item = *s_item;
    __syncthreads();
    if (item >= n_items) return;
    const int g = item % a.G, pk = item / a.G;
    const int p = pk / n_act, r = st.act[pk - p * n_act];
    const T x = kDmin ? T(0) : (p ? st.pr1[r] : st.pr0[r]);
    double* slot = a.slots + (((size_t)parity * 2 + p) * a.R + r) * a.G + g;
    run_item<T, kDmin>(a, tiles, red, r, g, x, slot);
  }
}

// After a sweep's grid sync: every block sums each covered row's slots in
// the same order into st.fval[p][r] = f = -sum.
template <typename T>
__device__ void reduce_slots(const Args<T>& a, const State<T>& st, int n_act,
                             int n_probe, int parity) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pk = warp; pk < n_probe * n_act; pk += kWarps) {
    const int p = pk / n_act, r = st.act[pk - p * n_act];
    const double* s = a.slots + (((size_t)parity * 2 + p) * a.R + r) * a.G;
    double v = 0.0;
#pragma unroll 4
    for (int g = lane; g < a.G; g += 32) v += __ldcg(s + g);
    v = warp_sum(v);
    if (lane == 0) st.fval[p * a.R + r] = -v;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void put_trace(const Args<T>& a, int r, int k, T x,
                                          T f) {
  T* t = a.trace + ((size_t)r * (a.max_iters + 2) + k) * 2;
  t[0] = x;
  t[1] = f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
loo_search_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kWarps];
  __shared__ int s_item, s_nact;
  cg::grid_group grid = cg::this_grid();
  T* tiles = reinterpret_cast<T*>(smem);
  const State<T> st = carve<T>(smem, a.R);
  const int R = a.R, n = a.n;
  const bool tracing = a.trace != nullptr && blockIdx.x == 0;

  // prologue: the staged rows, the counters, every block's state
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (size_t k = tid; k < (size_t)R * a.n_pad; k += stride) {
    const int r = (int)(k / a.n_pad), j = (int)(k % a.n_pad);
    a.xs[k] = staged_x(a.rows + (size_t)r * n, a.w, j, n);
  }
  for (size_t j = tid; j < (size_t)a.n_pad; j += stride)
    a.wp[j] = (int)j < n ? a.w[j] : T(0);
  if (blockIdx.x == 0)
    for (int k = threadIdx.x; k < a.max_iters + 2; k += kThreads) a.ctr[k] = 0;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const T x0 = a.ax[r], b = a.bx[r], x3 = a.cx[r];
    const bool wide = fabs(x3 - b) > fabs(b - x0);
    st.x0[r] = x0;
    st.x3[r] = x3;
    st.x1[r] = st.pr0[r] = wide ? b : b - a.gc * (b - x0);
    st.x2[r] = st.pr1[r] = wide ? b + a.gc * (x3 - b) : b;
    st.act[r] = r;
  }
  grid.sync();

  // the nearest live neighbours, then x1 and x2 of every row
  sweep<T, true>(a, tiles, st, R, 1, 0, 0, red, &s_item);
  grid.sync();
  sweep<T, false>(a, tiles, st, R, 2, 1, 0, red, &s_item);
  grid.sync();
  reduce_slots(a, st, R, 2, 0);
  for (int r = threadIdx.x; r < R; r += kThreads) {
    st.f1[r] = (T)st.fval[r];
    st.f2[r] = (T)st.fval[R + r];
    if (tracing) {
      put_trace(a, r, 0, st.x1[r], st.f1[r]);
      put_trace(a, r, 1, st.x2[r], st.f2[r]);
    }
  }

  int parity = 1;
  for (int it = 0;; ++it) {
    // _golden_core's step: the active rows' new bracket and probe
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const T x0 = st.x0[r], x1 = st.x1[r], x2 = st.x2[r], x3 = st.x3[r];
      const bool active =
          it < a.max_iters && fabs(x3 - x0) > a.tol * (fabs(x1) + fabs(x2));
      const bool take2 = active && st.f2[r] < st.f1[r];
      if (active && take2) {
        const T nx2 = a.gr * x2 + a.gc * x3;
        st.x0[r] = x1;
        st.x1[r] = x2;
        st.x2[r] = nx2;
        st.pr0[r] = nx2;
      } else if (active) {
        const T nx1 = a.gr * x1 + a.gc * x0;
        st.x3[r] = x2;
        st.x2[r] = x1;
        st.x1[r] = nx1;
        st.pr0[r] = nx1;
      }
      st.flag[r] = (int)take2 | ((int)active << 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {       // warp 0 lists the active rows in order
      int count = 0;
      for (int base = 0; base < R; base += 32) {
        const int r = base + (int)threadIdx.x;
        const bool on = r < R && (st.flag[r] & 2);
        const unsigned m = __ballot_sync(kFull, on);
        if (on) st.act[count + __popc(m & ((1u << threadIdx.x) - 1u))] = r;
        count += __popc(m);
      }
      if (threadIdx.x == 0) s_nact = count;
    }
    __syncthreads();
    const int n_act = s_nact;
    if (n_act == 0) break;
    sweep<T, false>(a, tiles, st, n_act, 1, 2 + it, parity, red, &s_item);
    grid.sync();
    reduce_slots(a, st, n_act, 1, parity);
    for (int k = threadIdx.x; k < n_act; k += kThreads) {
      const int r = st.act[k];
      const T fp = (T)st.fval[r];
      if (st.flag[r] & 1) {
        st.f1[r] = st.f2[r];
        st.f2[r] = fp;
      } else {
        st.f2[r] = st.f1[r];
        st.f1[r] = fp;
      }
      if (tracing) put_trace(a, r, 2 + it, st.pr0[r], fp);
    }
    __syncthreads();
    parity ^= 1;
  }
  if (blockIdx.x == 0)
    for (int r = threadIdx.x; r < R; r += kThreads)
      a.xmin[r] = st.f1[r] < st.f2[r] ? st.x1[r] : st.x2[r];
}

template <typename T>
cudaError_t kernel_attributes() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static bool done[kMaxDevices] = {};
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(loo_search_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<T>(kMaxRows));
  if (e != cudaSuccess) cudaGetLastError();
  else if (dev < kMaxDevices) done[dev] = true;
  return e;
}

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

int n_padded(int n) { return (n + kTile - 1) / kTile * kTile; }
int n_groups(int n) { return (n + kGroup - 1) / kGroup; }

// Scratch layout: xs, wp, dmin, slots, ctr, each 256-byte aligned.
template <typename T>
size_t scratch_layout(int R, int n, int max_iters, size_t (&off)[5]) {
  const size_t np = (size_t)n_padded(n), G = (size_t)n_groups(n);
  const size_t sizes[5] = {(size_t)R * np * sizeof(T), np * sizeof(T),
                           (size_t)R * n * sizeof(T),
                           4 * (size_t)R * G * sizeof(double),
                           (size_t)(max_iters + 2) * sizeof(int)};
  size_t at = 0;
  for (int k = 0; k < 5; ++k) {
    off[k] = at;
    at += align256(sizes[k]);
  }
  return at;
}

bool args_ok(int R, int n, int max_iters) {
  return R >= 1 && R <= kMaxRows && n >= 0 && max_iters >= 0 &&
         (long long)R * n_padded(n) <= 0x7fffffffLL &&
         (long long)4 * R * n_groups(n) <= 0x7fffffffLL;
}

// The grid of a launch: the blocks the card holds at once, at most the
// widest sweep's items.
template <typename T>
cudaError_t grid_blocks(int R, int n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = kernel_attributes<T>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, loo_search_kernel<T>, kThreads, smem_bytes<T>(R));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long items = 2LL * R * (long long)n_groups(n);
  long long b = (long long)per_sm * sms;
  if (items < b) b = items < 1 ? 1 : items;
  *blocks = (int)b;
  return cudaSuccess;
}

template <typename T>
int launch(const T* rows, const T* w, const T* base_var, const T* ax,
           const T* bx, const T* cx, T* xmin, T* trace, void* scratch, int R,
           int n, double tol, int max_iters, double gc, double gr,
           void* stream) {
  if (!args_ok(R, n, max_iters)) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = grid_blocks<T>(R, n, &blocks);
  if (e != cudaSuccess) return (int)e;
  size_t off[5];
  scratch_layout<T>(R, n, max_iters, off);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  Args<T> a;
  a.rows = rows; a.w = w; a.base_var = base_var;
  a.ax = ax; a.bx = bx; a.cx = cx; a.xmin = xmin; a.trace = trace;
  a.xs = reinterpret_cast<T*>(s + off[0]);
  a.wp = reinterpret_cast<T*>(s + off[1]);
  a.dmin = reinterpret_cast<T*>(s + off[2]);
  a.slots = reinterpret_cast<double*>(s + off[3]);
  a.ctr = reinterpret_cast<int*>(s + off[4]);
  a.R = R; a.n = n; a.n_pad = n_padded(n); a.G = n_groups(n);
  a.max_iters = max_iters;
  a.tol = (T)tol; a.gc = (T)gc; a.gr = (T)gr;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<T>(R);
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, loo_search_kernel<T>, a);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a refused launch must not fail the next caller
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the scratch buffer a launch of R rows of n points needs.
extern "C" long long kde_loo_search_scratch(int R, int n, int max_iters,
                                            int f64) {
  if (!args_ok(R, n, max_iters)) return -1;
  size_t off[5];
  return (long long)(f64 ? scratch_layout<double>(R, n, max_iters, off)
                         : scratch_layout<float>(R, n, max_iters, off));
}

// The golden search of R rows in one cooperative launch: rows [R, n],
// w [n], base_var/ax/bx/cx/xmin [R], trace [R, max_iters + 2, 2] or null,
// all float32 (f64 = 0) or float64, contiguous on the stream's device;
// scratch of kde_loo_search_scratch bytes, 256-byte aligned.  Returns a
// cudaError_t.
extern "C" int kde_loo_search(const void* rows, const void* w,
                              const void* base_var, const void* ax,
                              const void* bx, const void* cx, void* xmin,
                              void* trace, void* scratch, int R, int n,
                              double tol, int max_iters, double gc, double gr,
                              int f64, void* stream) {
  if (f64)
    return launch<double>((const double*)rows, (const double*)w,
                          (const double*)base_var, (const double*)ax,
                          (const double*)bx, (const double*)cx,
                          (double*)xmin, (double*)trace, scratch, R, n, tol,
                          max_iters, gc, gr, stream);
  return launch<float>((const float*)rows, (const float*)w,
                       (const float*)base_var, (const float*)ax,
                       (const float*)bx, (const float*)cx, (float*)xmin,
                       (float*)trace, scratch, R, n, tol, max_iters, gc, gr,
                       stream);
}

// Never launched: one float64 pair term, compiled (external linkage, so it
// is kept) for chip_smoke.py to count its FP64 instructions in the SASS.
extern "C" __global__ void loo_pair_probe(const double* in, double* out) {
  out[0] = pair_term<double>(in[0], in[1], in[2], in[3], in[4], in[5]);
}
