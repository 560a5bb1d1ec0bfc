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
// per-probe launches of the twin are what the design removes.  A launch
// takes one of two plans, chosen by ops/loo_search.py::launch_plan from
// the shape, with the same bits: the rows plan (below, at
// loo_rows_kernel) for rows that fit a block's shared memory, and for
// longer rows the grid plan:
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

#include <type_traits>

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
                      // (rows plan, no cluster: [R] arrivals a row)
  int R, n, n_pad, G, max_iters;
  int B, gpb;         // rows plan: blocks a row, query groups a block
  T tol, gc, gr;
#ifdef K4_DIAG
  unsigned long long* diag;  // [gridDim.x][max_iters + 2][kDiag], see below
#endif
};

#ifdef K4_DIAG
// The diag build (-DK4_DIAG) writes, for each block and sweep (0 the
// nearest neighbours, 1 the first two probes, 2 + it an iteration's),
// %globaltimer stamps: [0] the sweep's start (sweep 0: the block's), [1]
// after the golden step (sweep 0: after the staging prologue),
// [2] its items done, [3] past the barrier, [4] past the slot reduction
// and fold; [5] the ns its items computed, [6] its items, [7] %smid + 1.
// chip_smoke.py --k4-diag reads them; the release build has none.
constexpr int kDiag = 8;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
template <typename T>
__device__ __forceinline__ unsigned long long* diag_rec(const Args<T>& a,
                                                         int sweep) {
  return a.diag + ((size_t)blockIdx.x * (a.max_iters + 2) + sweep) * kDiag;
}
#define K4_STAMP(a, sweep, f)                                              \
  if (threadIdx.x == 0 && (a).diag) diag_rec(a, sweep)[f] = gtime()
#define K4_NOTE(a, sweep, f, v)                                            \
  if (threadIdx.x == 0 && (a).diag) diag_rec(a, sweep)[f] = (v)
#else
#define K4_STAMP(a, sweep, f)
#define K4_NOTE(a, sweep, f, v)
#endif

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

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

#ifdef K4_DIAG
void* g_diag = nullptr;   // kde_loo_set_diag's buffer
#endif

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
#ifdef K4_DIAG
  unsigned long long busy = 0, items = 0;
#endif
  for (;;) {
    if (threadIdx.x == 0) *s_item = atomicAdd(a.ctr + sweep_ix, 1);
    __syncthreads();
    const int item = *s_item;
    __syncthreads();
    if (item >= n_items) break;
    const int g = item % a.G, pk = item / a.G;
    const int p = pk / n_act, r = st.act[pk - p * n_act];
    const T x = kDmin ? T(0) : (p ? st.pr1[r] : st.pr0[r]);
    double* slot = a.slots + (((size_t)parity * 2 + p) * a.R + r) * a.G + g;
#ifdef K4_DIAG
    const unsigned long long t0 = gtime();
#endif
    run_item<T, kDmin>(a, tiles, red, r, g, x, slot);
#ifdef K4_DIAG
    busy += gtime() - t0;
    ++items;
#endif
  }
  K4_STAMP(a, sweep_ix, 2);
  K4_NOTE(a, sweep_ix, 5, busy);
  K4_NOTE(a, sweep_ix, 6, items);
  K4_NOTE(a, sweep_ix, 7, sm_id() + 1);
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
  K4_STAMP(a, 0, 0);

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
  K4_STAMP(a, 0, 1);
  sweep<T, true>(a, tiles, st, R, 1, 0, 0, red, &s_item);
  grid.sync();
  K4_STAMP(a, 0, 3);
  K4_STAMP(a, 0, 4);
  K4_STAMP(a, 1, 0);
  K4_STAMP(a, 1, 1);
  sweep<T, false>(a, tiles, st, R, 2, 1, 0, red, &s_item);
  grid.sync();
  K4_STAMP(a, 1, 3);
  reduce_slots(a, st, R, 2, 0);
  for (int r = threadIdx.x; r < R; r += kThreads) {
    st.f1[r] = (T)st.fval[r];
    st.f2[r] = (T)st.fval[R + r];
    if (tracing) {
      put_trace(a, r, 0, st.x1[r], st.f1[r]);
      put_trace(a, r, 1, st.x2[r], st.f2[r]);
    }
  }
#ifdef K4_DIAG
  __syncthreads();
#endif
  K4_STAMP(a, 1, 4);

  int parity = 1;
  for (int it = 0;; ++it) {
    K4_STAMP(a, 2 + it, 0);
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
    K4_STAMP(a, 2 + it, 1);
    sweep<T, false>(a, tiles, st, n_act, 1, 2 + it, parity, red, &s_item);
    grid.sync();
    K4_STAMP(a, 2 + it, 3);
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
    K4_STAMP(a, 2 + it, 4);
    parity ^= 1;
  }
  if (blockIdx.x == 0)
    for (int r = threadIdx.x; r < R; r += kThreads)
      a.xmin[r] = st.f1[r] < st.f2[r] ? st.x1[r] : st.x2[r];
}

// ---- the rows plan: each block keeps its row resident --------------------
//
// For rows that fit a block's shared memory (ops/loo_search.py::
// launch_plan chooses it from the shape).  Row r has B blocks, block k the
// query groups [k gpb, (k + 1) gpb) (static: no atomic hands out items),
// and the grid is R B blocks, about one an SM.  A block is `teams` teams
// of kWarps warps (blockDim.x = teams kThreads); team t takes the block's
// groups t, t + teams, ..., so up to `teams` groups share the SM at once.
// Each block stages its row (x, and +inf where w = 0) and the weights into
// shared memory once a launch and keeps them for the whole search: no
// item restages them and no tile costs a barrier; a pass stops at the
// row's last column.  What a query needs in every sweep (its x, log1p(-w),
// its nearest-neighbour shift) stays in the block's shared memory too.
// A row's blocks meet at a barrier of their own after each sweep, never a
// grid-wide one: on a thread-block cluster of the B blocks (B <=
// kMaxCluster) barrier.cluster, the group sums read from the blocks'
// shared memory; else each block's thread 0 adds one to the row's arrival
// counter and waits until all B have arrived, the group sums read from
// global scratch (a cooperative launch, only so that the row's blocks are
// co-resident).  The cluster is the faster where both can run (0.4-0.6
// us less a sweep on an H100, PERF.md) and the only one for grids larger
// than the card holds at once.  Every block of a row then reduces the
// row's group sums in reduce_slots' order and takes the same golden step,
// so a converged row's blocks leave together.  A group's sum is run_item's bit for bit
// (the same warps, queries and lane order, the same operations on the
// same values; the columns the grid plan takes past the row's end add
// exactly 0), so both plans give the same bits.

constexpr int kMaxCluster = 8;              // portable cluster size
constexpr int kMaxTeams = 2;                // teams of kWarps warps a block
constexpr int kRowsSmemMax = 232448 - 2048;  // opt-in, less the static state

__host__ __device__ inline int n_stage(int n) {   // whole 16-byte vectors
  return (n + 3) / 4 * 4;
}

// [2 parity][2 probe][gpb] group sums and [gpb kGroup] log1p(-w_i)
// in float64; the staged row and weights [n_stage]; the queries' shifts
// and x [gpb kGroup].
template <typename T>
size_t rows_smem_bytes(int n, int gpb) {
  return (4 + (size_t)kGroup) * gpb * sizeof(double) +
         (2 * (size_t)n_stage(n) + 2 * (size_t)gpb * kGroup) * sizeof(T);
}

template <typename T> struct RowSmem {
  double* cs;   // [2][2][gpb]: this block's group sums
  double* ql;   // [gpb kGroup]: log1p(-w_i) of the block's queries
  T *sx, *sw;   // [n_stage]: the staged row and the weights
  T *sd, *qx;   // [gpb kGroup]: the queries' shifts and x
};

template <typename T>
__device__ RowSmem<T> carve_rows(unsigned char* smem, int n, int gpb) {
  RowSmem<T> m;
  m.cs = reinterpret_cast<double*>(smem);
  m.ql = m.cs + 4 * gpb;
  m.sx = reinterpret_cast<T*>(m.ql + gpb * kGroup);
  m.sw = m.sx + n_stage(n);
  m.sd = m.sw + n_stage(n);
  m.qx = m.sd + gpb * kGroup;
  return m;
}

// One column j (x_j, w_j) against a warp's kQ queries, as tile_pass.
template <typename T, bool kDmin, bool kMask>
__device__ __forceinline__ void pair_step(const T (&xq)[kQ],
                                          const T (&off)[kQ],
                                          const int (&iq)[kQ], T nh, int j,
                                          T xj, T wj, T (&mn)[kQ],
                                          T (&ts)[kQ]) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (kDmin) {
      const T d = xq[q] - xj;
      const T dd = d * d;
      if (!kMask || j != iq[q]) mn[q] = fmin(mn[q], dd);
    } else {
      const T t = pair_term(xq[q], xj, wj, nh, off[q], ts[q]);
      ts[q] = (kMask && j == iq[q]) ? ts[q] : t;
    }
  }
}

// Columns [col0, col0 + width) of the resident row against a warp's kQ
// queries: tile_pass's terms in its order (lane takes the vectors lane,
// lane + 32, ...), the last vector cut at the tile's last column.
template <typename T, bool kDmin, bool kMask>
__device__ __forceinline__ void row_tile(const T* sx, const T* sw, int col0,
                                         int width, const T (&xq)[kQ],
                                         const T (&off)[kQ],
                                         const int (&iq)[kQ], T nh,
                                         T (&mn)[kQ], double (&acc)[kQ]) {
  using N = Num<T>;
  using V = typename N::V;
  constexpr int kV = N::kVec;
  const int full = width / kV, rest = width - full * kV;
  const V* vx = reinterpret_cast<const V*>(sx + col0);
  const V* vw = reinterpret_cast<const V*>(sw + col0);
  T ts[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) ts[q] = T(0);
  int v = threadIdx.x & 31;
#pragma unroll 2
  for (; v < full; v += 32) {
    T xv[kV], wv[kV];
    N::unpack(vx[v], xv);
    if (!kDmin) N::unpack(vw[v], wv);
#pragma unroll
    for (int u = 0; u < kV; ++u)
      pair_step<T, kDmin, kMask>(xq, off, iq, nh, col0 + v * kV + u, xv[u],
                                 kDmin ? xv[u] : wv[u], mn, ts);
  }
  if (v == full && rest > 0) {    // the partial vector, in its lane's turn
    T xv[kV], wv[kV];
    N::unpack(vx[v], xv);
    if (!kDmin) N::unpack(vw[v], wv);
    for (int u = 0; u < rest; ++u)
      pair_step<T, kDmin, kMask>(xq, off, iq, nh, col0 + v * kV + u, xv[u],
                                 kDmin ? xv[u] : wv[u], mn, ts);
  }
  if (!kDmin) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] += (double)ts[q];
  }
}

// A team's barrier (named barrier 1 + team over its kThreads threads).
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(kThreads)
               : "memory");
}

// Query group g (the block's lg-th) of the row against the resident row,
// by the calling team; nh and tail are the probe's (run_item's values).
// kDmin writes the queries' shifts to m.sd; else the team's first thread
// returns the group's sum_i w_i log p_i, run_item's slot value bit for
// bit.  red: the team's [kWarps], alternated by the caller so that one
// team barrier a group is enough.
template <typename T, bool kDmin>
__device__ double rows_group(const Args<T>& a, const RowSmem<T>& m,
                             double* red, int team, int g, int lg, T nh,
                             double tail) {
  const int wt = (threadIdx.x >> 5) - team * kWarps;   // warp in the team
  const int lane = threadIdx.x & 31;
  const int n = a.n, i0 = g * kGroup + wt * kQ, at = lg * kGroup + wt * kQ;
  double c = 0.0;
  if (i0 < n) {                   // a warp past the row's end adds 0
    T xq[kQ], off[kQ], mn[kQ];
    int iq[kQ];
    double acc[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = i0 + q;
      iq[q] = i;
      xq[q] = m.qx[at + q];
      mn[q] = (T)INFINITY;
      acc[q] = 0.0;
      off[q] = T(0);
      if (!kDmin && i < n) off[q] = -(m.sd[at + q] * nh);
    }
    const int t_mask = (g * kGroup) / kTile;
    for (int t = 0; t * kTile < n; ++t) {
      const int col0 = t * kTile, width = min(kTile, n - col0);
      if (t == t_mask)
        row_tile<T, kDmin, true>(m.sx, m.sw, col0, width, xq, off, iq, nh,
                                 mn, acc);
      else
        row_tile<T, kDmin, false>(m.sx, m.sw, col0, width, xq, off, iq, nh,
                                  mn, acc);
    }
    if (kDmin) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        T mq = warp_min(mn[q]);
        if (!(mq < (T)INFINITY)) mq = T(0);   // n == 1 / no live neighbour
        if (lane == q && iq[q] < n) m.sd[at + q] = mq;
      }
      return 0.0;
    }
    // lane q < kQ takes query q's log; lane 0 adds the terms in q order
    double s = 0.0, term = 0.0;
    T oq = T(0);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const double sum = warp_sum(acc[q]);
      if (lane == q) {
        s = sum;
        oq = off[q];
      }
    }
    const int i = i0 + lane;
    const bool on = lane < kQ && i < n && (double)m.sw[i] > 0.0;
    if (on) {
      const double wi = (double)m.sw[i];
      const double logp = log(s) - (double)oq / Num<T>::kScale + tail -
                          m.ql[at + lane];
      term = wi * logp;           // p = 0: -inf
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const double tq = __shfl_sync(kFull, term, q);
      const bool oq_on = __shfl_sync(kFull, (int)on, q) != 0;
      if (oq_on) c += tq;
    }
  }
  if (kDmin) return 0.0;
  if (lane == 0) red[wt] = c;
  team_sync(team);
  double sum = 0.0;
  if (wt == 0 && lane == 0)
    for (int k = 0; k < kWarps; ++k) sum += red[k];
  return sum;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// The row's barrier after its sweep number `sweeps` (1, 2, ...), entered
// after a block barrier: every team's first thread has written its
// groups' sums.  The block runs `meanwhile()` between its arrival and
// its wait.
template <typename T, bool kCluster, typename F>
__device__ __forceinline__ void row_barrier(const Args<T>& a, int r,
                                            int sweeps, F&& meanwhile) {
  if constexpr (kCluster) {
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
    meanwhile();
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
    return;
  }
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(a.ctr + r, 1);
  }
  meanwhile();
  if (threadIdx.x == 0) {
    const int target = a.B * sweeps;
    const unsigned long long t0 = clock64();
    while (ld_acquire(a.ctr + r) < target) {
      // the row's blocks are co-resident (a cooperative launch), so this
      // never waits long; a launch that broke that traps, not hangs
      if (clock64() - t0 > (1ull << 35)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Group g's sum of probe p at `parity`: in block g / gpb's shared memory
// (cs) on a cluster, else in the global slots, laid out as the grid plan's.
template <typename T, bool kCluster>
__device__ __forceinline__ double* rows_slot(const Args<T>& a, double* cs,
                                             int parity, int p, int r,
                                             int g) {
  if constexpr (kCluster) {
    const int b = g / a.gpb;
    return cg::this_cluster().map_shared_rank(
        cs + (parity * 2 + p) * a.gpb + (g - b * a.gpb), b);
  }
  return a.slots + (((size_t)parity * 2 + p) * a.R + r) * a.G + g;
}

// After the row's barrier: f = -sum of the row's group sums into fval[p],
// in reduce_slots' order (lane g, g + 32, ..., then the butterfly).
template <typename T, bool kCluster>
__device__ __forceinline__ void rows_reduce(const Args<T>& a, double* cs,
                                            int parity, int n_probe, int r,
                                            double* fval) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < n_probe) {
    double v = 0.0;
    for (int g = lane; g < a.G; g += 32) {
      const double* slot = rows_slot<T, kCluster>(a, cs, parity, warp, r, g);
      if constexpr (kCluster) v += *slot;
      else v += __ldcg(slot);
    }
    v = warp_sum(v);
    if (lane == 0) fval[warp] = -v;
  }
  __syncthreads();
}

template <typename T, bool kCluster>
__global__ void __launch_bounds__(kMaxTeams * kThreads)
loo_rows_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[2][kMaxTeams][kWarps];
  // s_nh / s_tail: the probes' constants, then those of the next step's
  // two possible probes (2 if it takes x2, 3 if not)
  __shared__ double fval[2], s_tail[4];
  __shared__ T sx0, sx1, sx2, sx3, sf1, sf2, spr0, spr1, s_nh[4];
  __shared__ int s_flag;
#ifdef K4_DIAG
  unsigned long long t1 = 0;
  K4_STAMP(a, 0, 0);
#define K4_ROWS_ITEMS(a, s, items)                                         \
  K4_STAMP(a, s, 2);                                                       \
  K4_NOTE(a, s, 5, gtime() - t1);                                          \
  K4_NOTE(a, s, 6, items);                                                 \
  K4_NOTE(a, s, 7, sm_id() + 1)
#define K4_ROWS_T1(a, s)                                                   \
  t1 = gtime();                                                            \
  K4_NOTE(a, s, 1, t1)
#else
#define K4_ROWS_ITEMS(a, s, items)
#define K4_ROWS_T1(a, s)
#endif
  const int r = blockIdx.x / a.B, k = blockIdx.x - r * a.B;
  const int g0 = k * a.gpb, ng = min(a.gpb, a.G - g0);
  const int n = a.n, ns = n_stage(n);
  const int teams = blockDim.x / kThreads, team = threadIdx.x / kThreads;
  const RowSmem<T> m = carve_rows<T>(smem, n, a.gpb);
  const bool tracing = a.trace != nullptr && k == 0;
  const T* row = a.rows + (size_t)r * n;
  int calls = 0;
  // the team's groups of probe p (x, slot [parity][p]) or, with kDmin,
  // their shifts; each sum kept where rows_reduce finds it
  auto groups = [&](auto dmin, int parity, int p) {
    for (int lg = team; lg < ng; lg += teams) {
      const double v = rows_group<T, decltype(dmin)::value>(
          a, m, red[calls++ & 1][team], team, g0 + lg, lg, s_nh[p],
          s_tail[p]);
      if (decltype(dmin)::value || threadIdx.x != team * kThreads) continue;
      if constexpr (kCluster)
        m.cs[(parity * 2 + p) * a.gpb + lg] = v;
      else *rows_slot<T, false>(a, m.cs, parity, p, r, g0 + lg) = v;
    }
  };
  // run_item's nh and tail of probe x, into slot p
  auto probe_consts = [&](int p, T x) {
    const T v = (x * x) * a.base_var[r];
    const double var = (double)v;
    s_nh[p] = (T)(-0.5 * Num<T>::kScale / var);
    s_tail[p] = -0.5 * log(var) - 0.5 * kLog2Pi;
  };
  // while the row meets: the constants of both probes the next golden
  // step may take (its bracket is this sweep's), one lane of warp 1 each
  auto next_consts = [&]() {
    const int c = threadIdx.x - 32;
    if (c == 0 || c == 1)
      probe_consts(2 + c, c == 0 ? a.gr * sx2 + a.gc * sx3
                                 : a.gr * sx1 + a.gc * sx0);
    __syncwarp();
  };

#pragma unroll 4
  for (int j = threadIdx.x; j < ns; j += blockDim.x) {
    // staged_x's value, with both loads issued before the select
    const T xj = j < n ? row[j] : T(0), wj = j < n ? a.w[j] : T(0);
    m.sx[j] = wj > T(0) ? xj : (T)INFINITY;
    m.sw[j] = wj;
  }
  for (int q = threadIdx.x; q < ng * kGroup; q += blockDim.x) {
    const int i = g0 * kGroup + q;
    m.qx[q] = i < n ? row[i] : T(0);
    m.ql[q] = i < n ? log1p(-(double)a.w[i]) : 0.0;
  }
  if (threadIdx.x == 0) {
    const T x0 = a.ax[r], b = a.bx[r], x3 = a.cx[r];
    const bool wide = fabs(x3 - b) > fabs(b - x0);
    sx0 = x0;
    sx3 = x3;
    sx1 = spr0 = wide ? b : b - a.gc * (b - x0);
    sx2 = spr1 = wide ? b + a.gc * (x3 - b) : b;
    probe_consts(0, spr0);
    probe_consts(1, spr1);
  }
  __syncthreads();

  // the nearest live neighbours of the block's queries, then x1 and x2
  K4_ROWS_T1(a, 0);
  groups(std::true_type{}, 0, 0);
  __syncthreads();
  K4_ROWS_ITEMS(a, 0, ng);
  K4_STAMP(a, 0, 3);
  K4_STAMP(a, 0, 4);
  K4_STAMP(a, 1, 0);
  K4_ROWS_T1(a, 1);
  groups(std::false_type{}, 0, 0);
  groups(std::false_type{}, 0, 1);
  __syncthreads();
  K4_ROWS_ITEMS(a, 1, 2 * ng);
  row_barrier<T, kCluster>(a, r, 1, next_consts);
  K4_STAMP(a, 1, 3);
  rows_reduce<T, kCluster>(a, m.cs, 0, 2, r, fval);
  if (threadIdx.x == 0) {
    sf1 = (T)fval[0];
    sf2 = (T)fval[1];
    if (tracing) {
      put_trace(a, r, 0, sx1, sf1);
      put_trace(a, r, 1, sx2, sf2);
    }
  }
  K4_STAMP(a, 1, 4);

  int parity = 1, sweeps = 1;
  for (int it = 0;; ++it) {
    K4_STAMP(a, 2 + it, 0);
    if (threadIdx.x == 0) {       // _golden_core's step, as the grid plan's
      const T x0 = sx0, x1 = sx1, x2 = sx2, x3 = sx3;
      const bool active =
          it < a.max_iters && fabs(x3 - x0) > a.tol * (fabs(x1) + fabs(x2));
      const bool take2 = active && sf2 < sf1;
      if (active && take2) {
        const T nx2 = a.gr * x2 + a.gc * x3;
        sx0 = x1;
        sx1 = x2;
        sx2 = nx2;
        spr0 = nx2;
      } else if (active) {
        const T nx1 = a.gr * x1 + a.gc * x0;
        sx3 = x2;
        sx2 = x1;
        sx1 = nx1;
        spr0 = nx1;
      }
      s_flag = (int)take2 | ((int)active << 1);
      const int c = take2 ? 2 : 3;   // found while the row met
      s_nh[0] = s_nh[c];
      s_tail[0] = s_tail[c];
    }
    __syncthreads();
    const int flag = s_flag;      // thread 0 rewrites it next iteration
    if (!(flag & 2)) break;
    K4_ROWS_T1(a, 2 + it);
    groups(std::false_type{}, parity, 0);
    __syncthreads();
    K4_ROWS_ITEMS(a, 2 + it, ng);
    row_barrier<T, kCluster>(a, r, ++sweeps, next_consts);
    K4_STAMP(a, 2 + it, 3);
    rows_reduce<T, kCluster>(a, m.cs, parity, 1, r, fval);
    if (threadIdx.x == 0) {
      const T fp = (T)fval[0];
      if (flag & 1) {
        sf1 = sf2;
        sf2 = fp;
      } else {
        sf2 = sf1;
        sf1 = fp;
      }
      if (tracing) put_trace(a, r, 2 + it, spr0, fp);
    }
    K4_STAMP(a, 2 + it, 4);
    parity ^= 1;
  }
  if (k == 0 && threadIdx.x == 0) a.xmin[r] = sf1 < sf2 ? sx1 : sx2;
  if constexpr (kCluster) cg::this_cluster().sync();  // none leaves while read
#undef K4_ROWS_ITEMS
#undef K4_ROWS_T1
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
#ifdef K4_DIAG
  a.diag = static_cast<unsigned long long*>(g_diag);
#endif
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

// The rows plan's checks: B blocks of gpb groups cover a row's groups,
// the last one holds at least one, a block has 1 to kMaxTeams teams, a
// cluster is at most kMaxCluster blocks and a block's shared memory fits.
template <typename T>
bool rows_ok(int R, int n, int max_iters, int B, int gpb, int teams,
             int cluster) {
  const long long G = n_groups(n);
  return args_ok(R, n, max_iters) && n >= 1 && B >= 1 && gpb >= 1 &&
         teams >= 1 && teams <= kMaxTeams &&
         (long long)B * gpb >= G && (long long)(B - 1) * gpb < G &&
         (!cluster || B <= kMaxCluster) && (long long)R * B <= 0x7fffffffLL &&
         rows_smem_bytes<T>(n, gpb) <= (size_t)kRowsSmemMax;
}

// The rows plan's scratch: none on a cluster; else slots [2][2][R][G] and
// the rows' arrival counters [R], 256-byte aligned.
size_t rows_scratch(int R, int n, int cluster, size_t* ctr_off) {
  if (cluster) return 0;
  *ctr_off = align256(4 * (size_t)R * n_groups(n) * sizeof(double));
  return *ctr_off + align256((size_t)R * sizeof(int));
}

template <typename T, bool kCluster>
cudaError_t rows_attributes() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static bool done[kMaxDevices] = {};
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(loo_rows_kernel<T, kCluster>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kRowsSmemMax);
  if (e != cudaSuccess) cudaGetLastError();
  else if (dev < kMaxDevices) done[dev] = true;
  return e;
}

template <typename T>
int launch_rows(const T* rows, const T* w, const T* base_var, const T* ax,
                const T* bx, const T* cx, T* xmin, T* trace, void* scratch,
                int R, int n, double tol, int max_iters, double gc, double gr,
                int B, int gpb, int teams, int cluster, void* stream) {
  if (!rows_ok<T>(R, n, max_iters, B, gpb, teams, cluster))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cluster ? rows_attributes<T, true>()
                          : rows_attributes<T, false>();
  if (e != cudaSuccess) return (int)e;
  size_t ctr_off = 0;
  rows_scratch(R, n, cluster, &ctr_off);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  Args<T> a = {};
  a.rows = rows; a.w = w; a.base_var = base_var;
  a.ax = ax; a.bx = bx; a.cx = cx; a.xmin = xmin; a.trace = trace;
  if (!cluster) {
    a.slots = reinterpret_cast<double*>(s);
    a.ctr = reinterpret_cast<int*>(s + ctr_off);
  }
  a.R = R; a.n = n; a.G = n_groups(n);
  a.max_iters = max_iters; a.B = B; a.gpb = gpb;
  a.tol = (T)tol; a.gc = (T)gc; a.gr = (T)gr;
#ifdef K4_DIAG
  a.diag = static_cast<unsigned long long*>(g_diag);
#endif
  const cudaStream_t st = (cudaStream_t)stream;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)(R * B), 1, 1);
  cfg.blockDim = dim3((unsigned)(teams * kThreads), 1, 1);
  cfg.dynamicSmemBytes = rows_smem_bytes<T>(n, gpb);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)B;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    e = cudaLaunchKernelEx(&cfg, loo_rows_kernel<T, true>, a);
  } else {
    e = cudaMemsetAsync(a.ctr, 0, (size_t)R * sizeof(int), st);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, loo_rows_kernel<T, false>, a);
  }
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

// Bytes of the scratch buffer a rows-plan launch needs (-1: a plan the
// kernel does not take).
extern "C" long long kde_loo_rows_scratch(int R, int n, int max_iters,
                                          int f64, int B, int gpb, int teams,
                                          int cluster) {
  const bool ok =
      f64 ? rows_ok<double>(R, n, max_iters, B, gpb, teams, cluster)
          : rows_ok<float>(R, n, max_iters, B, gpb, teams, cluster);
  if (!ok) return -1;
  size_t ctr_off = 0;
  return (long long)rows_scratch(R, n, cluster, &ctr_off);
}

// The golden search of R rows on the rows plan: B blocks a row, gpb query
// groups a block, teams teams of kThreads threads a block, on a cluster
// of the B blocks (cluster = 1) or meeting at a per-row counter;
// otherwise as kde_loo_search.  A plan the kernel
// does not take, or one the card refuses, is the launch's error.  Returns
// a cudaError_t.
extern "C" int kde_loo_rows(const void* rows, const void* w,
                            const void* base_var, const void* ax,
                            const void* bx, const void* cx, void* xmin,
                            void* trace, void* scratch, int R, int n,
                            double tol, int max_iters, double gc, double gr,
                            int f64, int B, int gpb, int teams, int cluster,
                            void* stream) {
  if (f64)
    return launch_rows<double>(
        (const double*)rows, (const double*)w, (const double*)base_var,
        (const double*)ax, (const double*)bx, (const double*)cx,
        (double*)xmin, (double*)trace, scratch, R, n, tol, max_iters, gc, gr,
        B, gpb, teams, cluster, stream);
  return launch_rows<float>(
      (const float*)rows, (const float*)w, (const float*)base_var,
      (const float*)ax, (const float*)bx, (const float*)cx, (float*)xmin,
      (float*)trace, scratch, R, n, tol, max_iters, gc, gr, B, gpb, teams,
      cluster, stream);
}

#ifdef K4_DIAG
// The diag build's stamp buffer for the launches that follow: [blocks]
// [max_iters + 2][8] uint64, zeroed by the caller, with a record for
// every block of the grid (the grid plan's is at most 2,048 / kThreads
// blocks an SM).
extern "C" void kde_loo_set_diag(void* buf) { g_diag = buf; }
#endif

// Never launched: one float64 pair term, compiled (external linkage, so it
// is kept) for chip_smoke.py to count its FP64 instructions in the SASS.
extern "C" __global__ void loo_pair_probe(const double* in, double* out) {
  out[0] = pair_term<double>(in[0], in[1], in[2], in[3], in[4], in[5]);
}
