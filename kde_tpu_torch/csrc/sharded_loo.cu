// K7: the local work of the sharded LOOCV golden search, for Hopper
// (sm_90a), in float32 and float64.
//
// Replaces the local work of kde_tpu/parallel/eval.py::
// ksize_bandwidths_sharded (:151-191, XLA-fused inline jnp in the
// shard_map program around the lax.while_loop of kde_tpu/ops/loocv.py:180;
// no Pallas kernel).  The wrapper is kde_tpu_torch/ops/sharded_loo.py,
// whose plain twins *_ref compute each launch in eager torch.
//
// The padded query rows are split over every rank of the mesh: a rank
// holds the queries q [mq, d] (global rows q0 + i) with weights qw [mq],
// and stages all N components m [N, d] with weights mw [N], which sum to 1
// (padding has weight 0).  Row k of a probe at x is dimension k with
// variance var = (x x)(b_k b_k), b the bracket's base:
//
//   f_k(x) = -sum_{i: w_i > 0} w_i log p_i,
//   log p_i = log sum_{j != i} w_j exp(-(q_ik - m_jk)^2 / (2 var))
//             - log(var) / 2 - log(2 pi) / 2 - log1p(-w_i),
//
// +inf when a positive-weight query has p = 0.  A search is:
//
//   stage              the columns staged per dimension (x, +inf where w =
//                      0), the golden state (buffer 0) from the bracket;
//   nn_shift           each query's least squared distance to a live
//                      column j != i: shift [d, mq];
//   per sweep s = 0, 1, ...: one launch of sweep_kernel, then the psum of
//                      its [rows, 2] over every rank of the mesh;
//   golden_step        the last sweep's golden step, the picks.
//
// sweep_kernel, in one launch:
//   * head: every block applies the golden step of sweep s - 1 from its
//     all-reduced entropies (the same arithmetic in every block, so every
//     block gets the same probes, bit for bit); block 0 writes the state
//     (double-buffered by the sweep's parity: the step reads buffer
//     (s - 1) & 1 and writes s & 1), the picks, the trace and the flag:
//     the active test of the next step, so the host, reading it some
//     sweeps late, knows when the sweeps it issued have no work left;
//   * body: a block takes kGroup queries of one probe row and streams a
//     chunk of the row's staged columns through shared memory in kTile
//     tiles with cp.async (csrc/loo_probe.cuh, K4's arithmetic); frozen
//     rows return at once;
//   * tail: each query's log p and weighted term in registers (no [rows,
//     mq] sums reach device memory), the block's (h, bad) partial; the
//     grid's last block (a counter behind __threadfence, reset for the
//     next launch) sums the partials in block order into ent [rows, 2].
//     Where the plan cuts the columns into chunks (few queries a rank, so
//     that every SM gets two blocks), a group's last chunk block adds its
//     chunks' query sums in chunk order before the log.
//
// So a sweep costs one launch and one collective where the column split
// of the JAX program costs three launches and two collectives (the kernels
// psum of the [rows, mq] sums, the chains psum of the entropies), and a
// search no pmin: every rank holds every column, so the shift is local and
// is the pmin of shard minima bit for bit.  The shift is K4's
// (csrc/loo_search.cu): it does not depend on the probe, and every term is
// w_j 2^t, t <= 0, so a sum lies in [w_nn, 1] and cannot underflow.  A
// query with no live neighbour keeps shift +inf: its sum uses 0 in its
// place, adds no term, gives S = 0, log p = -inf and the row's +inf
// objective, never NaN.
//
// What bounds it: every probe row is N (mq - 1) pairs on a rank, each one
// exp that nothing shares; float32 takes one MUFU ex2 a pair (16 a clock
// per SM), float64 the FP64 pipe.  The bytes are O(d (mq + N)) a sweep,
// and no [mq, N] tensor exists: the peak is O(d (mq + N)).  The host
// issues sweeps without reading the card: every launch reads its sweep's
// state from device memory.
//
// Determinism across ranks: the head reads only replicated values (the
// bracket, and entropies after the psum, bitwise equal on every rank), so
// every rank takes the same branch and issues the same collectives.
// Every sum is in a fixed order (a warp's butterfly, a block's tree, the
// chunks and the blocks in index order), and the plan depends only on the
// shapes and the card's SM count, so repeated calls give equal bits.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libsharded_loo.so sharded_loo.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "loo_probe.cuh"

// One search's sweep arguments, filled once by the wrapper (a ctypes
// Structure of this layout: sixteen pointers, an int64, three doubles and
// eight ints, so no padding).
struct K7Search {
  const void* q;          // [mq, d]
  const void* qw;         // [mq]
  const void* xs;         // [d, n_pad]
  const void* wp;         // [n_pad]
  const void* shift;      // [d, mq]
  const void* base;       // [d]
  void* st;               // [2][8][d]
  void* fl;               // [2][d]
  void* ent;              // [max_iters + 1][2d][2] float64
  void* xmin;             // [d]
  void* trace;            // [d, max_iters + 2, 2] or null
  void* flags;            // [max_iters + 2] int32
  void* part;             // the plans' scratch
  void* hb;
  void* ctr;
  void* stream;
  long long q0;
  double tol, gc, gr;
  int mq, n_pad, d, max_iters, tiles0, tiles1, f64, reserved;
};

namespace {

using namespace kde_loo;

constexpr int kStepThreads = 256;         // golden_step: one block

// The golden state, st [2][8][d] of T (a buffer a sweep's parity): x0, x1,
// x2, x3, f1, f2, pr0, pr1; fl [2][d] of int: bit 0 take2, bit 1 active
// (for the sweep to come).
enum { kX0, kX1, kX2, kX3, kF1, kF2, kPr0, kPr1, kStRows };

// A row's probe at x: var = (x x)(b b), the exponent's scale nh in T's
// units.  The body's offsets and the tail's log p use the same nh.
template <typename T>
struct Probe {
  double var;
  T nh;
};

template <typename T>
__device__ __forceinline__ Probe<T> probe_at(T x, T b) {
  const T v = (x * x) * (b * b);
  Probe<T> pr;
  pr.var = (double)v;
  pr.nh = (T)(-0.5 * Num<T>::kScale / pr.var);
  return pr;
}

// The shift a query's sum uses: its nearest live neighbour's squared
// distance, 0 where it has none (+inf), so that no offset is infinite.
template <typename T>
__device__ __forceinline__ T usable_shift(T s) {
  return s < (T)INFINITY ? s : T(0);
}

template <typename T>
__device__ __forceinline__ T objective(const double* ent, int row) {
  return ent[2 * row + 1] > 0.0 ? (T)INFINITY : (T)ent[2 * row];
}

template <typename T>
__device__ __forceinline__ bool searching(T x0, T x1, T x2, T x3, T tol,
                                          int step, int max_iters) {
  return step < max_iters && fabs(x3 - x0) > tol * (fabs(x1) + fabs(x2));
}

template <typename T>
__device__ __forceinline__ void put_trace(T* trace, int max_iters, int k,
                                          int slot, T x, T f) {
  T* t = trace + ((size_t)k * (max_iters + 2) + slot) * 2;
  t[0] = x;
  t[1] = f;
}

// Dimension k after _golden_core's step j: the state for sweep j (buffer
// j & 1) folded with sweep j's objectives, the active test, the masked
// bracket update and the next probe; next is the active test of step j +
// 1 on the new bracket.  trace (or null) receives step j's probes.
template <typename T>
struct Dim {
  T v[kStRows];
  int fl;
  bool next;
};

template <typename T>
__device__ Dim<T> golden_dim(const T* st, const int* fl, const double* ent,
                             int j, int d, int k, int max_iters, T tol, T gc,
                             T gr, T* trace) {
  Dim<T> o;
  const T* in = st + (size_t)(j & 1) * kStRows * d;
#pragma unroll
  for (int r = 0; r < kStRows; ++r) o.v[r] = in[(size_t)r * d + k];
  T x0 = o.v[kX0], x1 = o.v[kX1], x2 = o.v[kX2], x3 = o.v[kX3];
  T f1 = o.v[kF1], f2 = o.v[kF2], pr0 = o.v[kPr0];
  const int was = fl[(size_t)(j & 1) * d + k];
  if (j == 0) {
    f1 = objective<T>(ent, k);
    f2 = objective<T>(ent, d + k);
    if (trace) {
      put_trace(trace, max_iters, k, 0, x1, f1);
      put_trace(trace, max_iters, k, 1, x2, f2);
    }
  } else if (was & 2) {
    const T fp = objective<T>(ent, k);
    if (was & 1) {
      f1 = f2;
      f2 = fp;
    } else {
      f2 = f1;
      f1 = fp;
    }
    if (trace) put_trace(trace, max_iters, k, 1 + j, pr0, fp);
  }
  const bool active = searching(x0, x1, x2, x3, tol, j, max_iters);
  const bool take2 = active && f2 < f1;
  if (active && take2) {
    const T nx2 = gr * x2 + gc * x3;
    x0 = x1;
    x1 = x2;
    x2 = nx2;
    pr0 = nx2;
  } else if (active) {
    const T nx1 = gr * x1 + gc * x0;
    x3 = x2;
    x2 = x1;
    x1 = nx1;
    pr0 = nx1;
  }
  o.v[kX0] = x0;
  o.v[kX1] = x1;
  o.v[kX2] = x2;
  o.v[kX3] = x3;
  o.v[kF1] = f1;
  o.v[kF2] = f2;
  o.v[kPr0] = pr0;
  o.fl = (int)take2 | ((int)active << 1);
  o.next = searching(x0, x1, x2, x3, tol, j + 1, max_iters);
  return o;
}

// Dimension k's state for sweep j + 1 into buffer (j + 1) & 1, and its
// pick (x1 if f1 < f2 else x2, times the base).
template <typename T>
__device__ __forceinline__ void put_dim(const Dim<T>& o, T* st, int* fl,
                                        T* xmin, const T* base, int j, int d,
                                        int k) {
  T* out = st + (size_t)((j + 1) & 1) * kStRows * d;
#pragma unroll
  for (int r = 0; r < kStRows; ++r) out[(size_t)r * d + k] = o.v[r];
  fl[(size_t)((j + 1) & 1) * d + k] = o.fl;
  xmin[k] = (o.v[kF1] < o.v[kF2] ? o.v[kX1] : o.v[kX2]) * base[k];
}

// A fixed-order tree over the block's threads; every thread gets the sum.
template <int kN>
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();                // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kN / 32; ++w) s += red[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const T* m, const T* mw, const T* ax, const T* bx, const T* cx,
             T* xs, T* wp, T* st, int* fl, int nk, int n_pad, int d, T gc) {
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (size_t e = tid; e < (size_t)d * n_pad; e += stride) {
    const int k = (int)(e / n_pad), j = (int)(e % n_pad);
    xs[e] = staged_x(m + k, mw, j, nk, d);
  }
  for (size_t j = tid; j < (size_t)n_pad; j += stride)
    wp[j] = (int)j < nk ? mw[j] : T(0);
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < d; k += kThreads) {
      const T x0 = ax[k], b = bx[k], x3 = cx[k];
      const bool wide = fabs(x3 - b) > fabs(b - x0);
      const T x1 = wide ? b : b - gc * (b - x0);
      const T x2 = wide ? b + gc * (x3 - b) : b;
      st[(size_t)kX0 * d + k] = x0;
      st[(size_t)kX3 * d + k] = x3;
      st[(size_t)kX1 * d + k] = st[(size_t)kPr0 * d + k] = x1;
      st[(size_t)kX2 * d + k] = st[(size_t)kPr1 * d + k] = x2;
      st[(size_t)kF1 * d + k] = st[(size_t)kF2 * d + k] = (T)NAN;
      fl[k] = 2;
    }
  }
}

// Dimension k (blockIdx.y), queries [g kGroup, (g + 1) kGroup) (blockIdx.x)
// of the rank: the least squared distance to a live column j != i, into
// shift [d, mq] (+inf where none).
template <typename T>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const T* q, const T* xs, const T* wp, long long q0, int mq,
          int n_pad, int d, T* shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const int g = blockIdx.x, k = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* row = xs + (size_t)k * n_pad;
  T xq[kQ], off[kQ], mn[kQ];
  int iq[kQ];
  double acc[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = g * kGroup + warp * kQ + u;
    const long long gi = q0 + i;       // the query's column
    iq[u] = gi < (long long)n_pad ? (int)gi : -1;
    xq[u] = i < mq ? q[(size_t)i * d + k] : T(0);
    mn[u] = (T)INFINITY;
    off[u] = T(0);
    acc[u] = 0.0;
  }
  const long long lo = q0 + (long long)g * kGroup, hi = lo + kGroup;
  const int n_tiles = n_pad / kTile;
  stage(tiles, 0, row, wp, 0);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();              // tile t is in; tile t - 1 is read
    if (t + 1 < n_tiles) stage(tiles, (t + 1) & 1, row, wp, t + 1);
    const T* sx = tiles + (t & 1) * 2 * kTile;
    const T* sw = sx + kTile;
    const long long c0 = (long long)t * kTile;
    if (c0 < hi && lo < c0 + kTile)
      tile_pass<T, true, true>(sx, sw, t * kTile, xq, off, iq, T(0), mn, acc);
    else
      tile_pass<T, true, false>(sx, sw, t * kTile, xq, off, iq, T(0), mn,
                                acc);
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = g * kGroup + warp * kQ + u;
    const T m = warp_min(mn[u]);
    if (lane == u && i < mq) shift[(size_t)k * mq + i] = m;
  }
}

template <typename T>
struct Sweep {
  const T* q;             // [mq, d]
  const T* qw;            // [mq]
  const T* xs;            // [d, n_pad]
  const T* wp;            // [n_pad]
  const T* shift;         // [d, mq]
  const T* base;          // [d]
  T* st;                  // [2][8][d]
  int* fl;                // [2][d]
  const double* ent_prev; // sweep s - 1's all-reduced [2d or d][2]
  double* ent;            // sweep s's [rows][2] over this rank's queries
  T* xmin;                // [d]
  T* trace;               // [d, max_iters + 2, 2] or null
  int* flag;              // [1]: the active test of step s, any row
  double* part;           // [rows][groups][chunks][kGroup] (chunks > 1)
  double* hb;             // [rows][groups][2]
  int* ctr;               // [1 + rows groups], 0 between launches
  long long q0;
  int s, mq, n_pad, d, max_iters, groups, chunks, tiles;
  T tol, gc, gr;
};

// Sweep s: block b is (row pk, query group g, column chunk c), b = (pk
// groups + g) chunks + c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const __grid_constant__ Sweep<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  __shared__ double red[kWarps];
  __shared__ T s_x;
  __shared__ int s_on, s_last;
  const int d = a.d;
  const int rows = a.s == 0 ? 2 * d : d;
  const int c = blockIdx.x % a.chunks;
  const int rg = blockIdx.x / a.chunks;          // (row, group)
  const int g = rg % a.groups, pk = rg / a.groups;
  const int p = pk / d, k = pk - p * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // head: the golden step of sweep s - 1 (at s = 0, the staged state)
  if (blockIdx.x == 0) {
    int any = 0;
    for (int kk = threadIdx.x; kk < d; kk += kThreads) {
      if (a.s == 0) {
        const T* st = a.st;
        any |= (int)searching(st[(size_t)kX0 * d + kk],
                              st[(size_t)kX1 * d + kk],
                              st[(size_t)kX2 * d + kk],
                              st[(size_t)kX3 * d + kk], a.tol, 0,
                              a.max_iters);
      } else {
        const Dim<T> o = golden_dim(a.st, a.fl, a.ent_prev, a.s - 1, d, kk,
                                    a.max_iters, a.tol, a.gc, a.gr, a.trace);
        put_dim(o, a.st, a.fl, a.xmin, a.base, a.s - 1, d, kk);
        any |= (int)o.next;
      }
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) *a.flag = any;
  }
  if (threadIdx.x == 0) {
    if (a.s == 0) {
      s_x = a.st[(size_t)(p ? kPr1 : kPr0) * d + k];
      s_on = 1;
    } else {
      const Dim<T> o = golden_dim(a.st, a.fl, a.ent_prev, a.s - 1, d, k,
                                  a.max_iters, a.tol, a.gc, a.gr,
                                  (T*)nullptr);
      s_x = o.v[kPr0];
      s_on = (o.fl & 2) != 0;
    }
  }
  __syncthreads();
  const bool on = s_on;
  if (!on && c > 0) return;       // a frozen row: one block counts it

  // body: the group's queries against the chunk's columns
  double cw = 0.0, bad = 0.0;     // this thread's w_i log p_i, p = 0 count
  if (on) {
    const Probe<T> pr = probe_at(s_x, a.base[k]);
    const T nh = pr.nh;
    const T* row = a.xs + (size_t)k * a.n_pad;
    T xq[kQ], off[kQ], mn[kQ];
    int iq[kQ];
    double acc[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const int i = g * kGroup + warp * kQ + u;
      const bool real = i < a.mq;
      const long long gi = a.q0 + i;
      iq[u] = gi < (long long)a.n_pad ? (int)gi : -1;
      xq[u] = real ? a.q[(size_t)i * d + k] : T(0);
      off[u] = real ? -(usable_shift(a.shift[(size_t)k * a.mq + i]) * nh)
                    : T(0);
      mn[u] = T(0);
      acc[u] = 0.0;
    }
    const long long lo = a.q0 + (long long)g * kGroup, hi = lo + kGroup;
    const int n_tiles = a.n_pad / kTile;
    const int t0 = c * a.tiles;
    const int t1 = min(n_tiles, t0 + a.tiles);
    stage(tiles, 0, row, a.wp, t0);
    for (int t = t0; t < t1; ++t) {
      cp_async_wait_all();
      __syncthreads();            // tile t is in; tile t - 1 is read
      if (t + 1 < t1) stage(tiles, (t + 1 - t0) & 1, row, a.wp, t + 1);
      const T* sx = tiles + ((t - t0) & 1) * 2 * kTile;
      const T* sw = sx + kTile;
      const long long c0 = (long long)t * kTile;
      if (c0 < hi && lo < c0 + kTile)
        tile_pass<T, false, true>(sx, sw, t * kTile, xq, off, iq, nh, mn,
                                  acc);
      else
        tile_pass<T, false, false>(sx, sw, t * kTile, xq, off, iq, nh, mn,
                                   acc);
    }
    // lane u holds query u's sum over the chunk
    double sum = 0.0;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const double v = warp_sum(acc[u]);
      if (lane == u) sum = v;
    }
    const size_t at = ((size_t)rg * a.chunks) * kGroup + warp * kQ + lane;
    if (a.chunks > 1) {
      if (lane < kQ) a.part[at + (size_t)c * kGroup] = sum;
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        s_last = atomicAdd(a.ctr + 1 + rg, 1) == a.chunks - 1;
      __syncthreads();
      if (!s_last) return;
      __threadfence();
      if (lane < kQ) {
        sum = 0.0;
        for (int cc = 0; cc < a.chunks; ++cc)
          sum += __ldcg(a.part + at + (size_t)cc * kGroup);
      }
      if (threadIdx.x == 0) a.ctr[1 + rg] = 0;   // for the next launch
    }
    // tail: lane u's query's log p and weighted term (its offset read
    // again: off[] is indexed by u, not by the lane)
    const int i = g * kGroup + warp * kQ + lane;
    if (lane < kQ && i < a.mq) {
      const double wi = (double)a.qw[i];
      if (wi > 0.0) {
        const T o = -(usable_shift(a.shift[(size_t)k * a.mq + i]) * nh);
        const double tail = -0.5 * log(pr.var) - 0.5 * kLog2Pi;
        const double logp = log(sum) - (double)o / Num<T>::kScale + tail -
                            log1p(-wi);
        cw = wi * logp;           // p = 0: -inf
        bad = (logp == -INFINITY) ? 1.0 : 0.0;
      }
    }
  }
  cw = block_sum<kThreads>(cw, red);
  bad = block_sum<kThreads>(bad, red);
  if (threadIdx.x == 0) {
    a.hb[2 * (size_t)rg] = cw;
    a.hb[2 * (size_t)rg + 1] = bad;
  }

  // the grid's last group sums every row's groups in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(a.ctr, 1) == rows * a.groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int r = 0; r < rows; ++r) {
    double cr = 0.0, br = 0.0;
    for (int gg = threadIdx.x; gg < a.groups; gg += kThreads) {
      cr += __ldcg(a.hb + 2 * ((size_t)r * a.groups + gg));
      br += __ldcg(a.hb + 2 * ((size_t)r * a.groups + gg) + 1);
    }
    cr = block_sum<kThreads>(cr, red);
    br = block_sum<kThreads>(br, red);
    if (threadIdx.x == 0) {
      a.ent[2 * r] = 0.0 - cr;
      a.ent[2 * r + 1] = br;
    }
  }
  if (threadIdx.x == 0) a.ctr[0] = 0;            // for the next launch
}

// _golden_core's step j after the last sweep: one block.
template <typename T>
__global__ void __launch_bounds__(kStepThreads)
golden_kernel(const double* ent, const T* base, T* st, int* fl, T* xmin,
              T* trace, int* flag, int j, int d, int max_iters, T tol, T gc,
              T gr) {
  int any = 0;
  for (int k = threadIdx.x; k < d; k += kStepThreads) {
    const Dim<T> o = golden_dim(st, fl, ent, j, d, k, max_iters, tol, gc, gr,
                                trace);
    put_dim(o, st, fl, xmin, base, j, d, k);
    any |= (int)o.next;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) *flag = any;
}

size_t tile_smem(int f64) {
  return 4 * (size_t)kTile * (f64 ? sizeof(double) : sizeof(float));
}

int groups(int mq) { return (mq + kGroup - 1) / kGroup; }

bool sizes_ok(int mq, int n_pad, int d) {
  return mq >= 1 && d >= 1 && n_pad >= kTile && n_pad % kTile == 0 &&
         2LL * d * mq <= 0x7fffffffLL && (long long)d * n_pad <= 0x7fffffffLL &&
         2LL * d <= 65535;
}

int finish() {
  const cudaError_t e = cudaGetLastError();   // a refused launch
  return (int)e;
}

template <typename T>
int stage_t(const void* m, const void* mw, const void* ax, const void* bx,
            const void* cx, void* xs, void* wp, void* st, void* fl, int nk,
            int n_pad, int d, double gc, cudaStream_t stream) {
  long long work = (long long)d * n_pad;
  int blocks = (int)((work + kThreads - 1) / kThreads);
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  stage_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)m, (const T*)mw, (const T*)ax, (const T*)bx, (const T*)cx,
      (T*)xs, (T*)wp, (T*)st, (int*)fl, nk, n_pad, d, (T)gc);
  return finish();
}

template <typename T>
int nn_t(const void* q, const void* xs, const void* wp, long long q0, int mq,
         int n_pad, int d, void* shift, cudaStream_t stream) {
  const dim3 grid((unsigned)groups(mq), (unsigned)d, 1);
  nn_kernel<T><<<grid, kThreads, tile_smem(sizeof(T) == 8), stream>>>(
      (const T*)q, (const T*)xs, (const T*)wp, q0, mq, n_pad, d, (T*)shift);
  return finish();
}

template <typename T>
int sweep_t(const K7Search& c, int s) {
  Sweep<T> a;
  const int d = c.d;
  a.q = (const T*)c.q;
  a.qw = (const T*)c.qw;
  a.xs = (const T*)c.xs;
  a.wp = (const T*)c.wp;
  a.shift = (const T*)c.shift;
  a.base = (const T*)c.base;
  a.st = (T*)c.st;
  a.fl = (int*)c.fl;
  double* ent = (double*)c.ent;
  a.ent_prev = s > 0 ? ent + (size_t)(s - 1) * 4 * d : nullptr;
  a.ent = ent + (size_t)s * 4 * d;
  a.xmin = (T*)c.xmin;
  a.trace = (T*)c.trace;
  a.flag = (int*)c.flags + s;
  a.part = (double*)c.part;
  a.hb = (double*)c.hb;
  a.ctr = (int*)c.ctr;
  a.q0 = c.q0;
  a.s = s;
  a.mq = c.mq;
  a.n_pad = c.n_pad;
  a.d = d;
  a.max_iters = c.max_iters;
  a.groups = groups(c.mq);
  a.tiles = s == 0 ? c.tiles0 : c.tiles1;
  a.chunks = (c.n_pad / kTile + a.tiles - 1) / a.tiles;
  a.tol = (T)c.tol;
  a.gc = (T)c.gc;
  a.gr = (T)c.gr;
  const int rows = s == 0 ? 2 * d : d;
  const long long blocks = (long long)rows * a.groups * a.chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sweep_kernel<T><<<(unsigned)blocks, kThreads, tile_smem(sizeof(T) == 8),
                    (cudaStream_t)c.stream>>>(a);
  return finish();
}

}  // namespace

// Stage the columns m [nk, d] (weights mw [nk]) as xs [d, n_pad] (+inf for
// a zero weight or padding) and wp [n_pad], and set the golden state for
// sweep 0, buffer 0 of st [2][8][d] and fl [2][d], from the bracket ax, bx,
// cx [d].
extern "C" int kde_k7_stage(const void* m, const void* mw, const void* ax,
                            const void* bx, const void* cx, void* xs,
                            void* wp, void* st, void* fl, int nk, int n_pad,
                            int d, double gc, int f64, void* stream) {
  if (nk < 1 || nk > n_pad || !sizes_ok(1, n_pad, d))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return f64 ? stage_t<double>(m, mw, ax, bx, cx, xs, wp, st, fl, nk, n_pad,
                               d, gc, s)
             : stage_t<float>(m, mw, ax, bx, cx, xs, wp, st, fl, nk, n_pad,
                              d, gc, s);
}

// Each query's (q [mq, d], global rows q0 + i) least squared distance to a
// live staged column j != q0 + i: shift [d, mq], +inf where it has none.
extern "C" int kde_k7_nn_shift(const void* q, const void* xs,
                               const void* wp, long long q0, int mq,
                               int n_pad, int d, void* shift, int f64,
                               void* stream) {
  if (!sizes_ok(mq, n_pad, d) || q0 < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return f64 ? nn_t<double>(q, xs, wp, q0, mq, n_pad, d, shift, s)
             : nn_t<float>(q, xs, wp, q0, mq, n_pad, d, shift, s);
}

// Sweep s of the search ``a`` in one launch: the golden step of sweep s -
// 1 from its all-reduced ent[s - 1] (s > 0: state buffer (s - 1) & 1 -> s
// & 1, xmin, the trace, flags[s]), then sweep s's (h, bad) of every
// searching row over this rank's queries into ent[s] [rows, 2] (frozen
// rows 0), rows = 2d at s = 0 (pr0, then pr1, of every dimension), else d;
// the columns cut into chunks of tiles0 (s = 0) or tiles1 staged tiles
// (the last may hold fewer).  part, hb and ctr are scratch sized by the
// wrapper's plans, ctr zero before the first launch.
extern "C" int kde_k7_sweep(const K7Search* a, int s) {
  if (a == nullptr || !sizes_ok(a->mq, a->n_pad, a->d) || s < 0 ||
      s > a->max_iters || a->q0 < 0 || a->tiles0 < 1 || a->tiles1 < 1)
    return (int)cudaErrorInvalidValue;
  return a->f64 ? sweep_t<double>(*a, s) : sweep_t<float>(*a, s);
}

// The golden step j from sweep j's all-reduced ent: state buffer j & 1 ->
// (j + 1) & 1 of st, fl, the picks xmin [d] (x times the base), the trace
// [d, max_iters + 2, 2] or null, and *flag = 1 while the next step has a
// row to search.
extern "C" int kde_k7_golden_step(const void* ent, const void* base, void* st,
                                  void* fl, void* xmin, void* trace,
                                  void* flag, int j, int d, int max_iters,
                                  double tol, double gc, double gr, int f64,
                                  void* stream) {
  if (d < 1 || j < 0 || max_iters < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    golden_kernel<double><<<1, kStepThreads, 0, s>>>(
        (const double*)ent, (const double*)base, (double*)st, (int*)fl,
        (double*)xmin, (double*)trace, (int*)flag, j, d, max_iters, tol, gc,
        gr);
  else
    golden_kernel<float><<<1, kStepThreads, 0, s>>>(
        (const double*)ent, (const float*)base, (float*)st, (int*)fl,
        (float*)xmin, (float*)trace, (int*)flag, j, d, max_iters,
        (float)tol, (float)gc, (float)gr);
  return finish();
}
