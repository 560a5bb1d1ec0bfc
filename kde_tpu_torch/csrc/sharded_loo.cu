// K7: the local work of the sharded LOOCV golden search, between its
// collectives, for Hopper (sm_90a), in float32 and float64.
//
// Replaces the local work of kde_tpu/parallel/eval.py::
// ksize_bandwidths_sharded (:151-191, XLA-fused inline jnp in the
// shard_map program around the lax.while_loop of kde_tpu/ops/loocv.py:180;
// no Pallas kernel).  The wrapper is kde_tpu_torch/ops/sharded_loo.py,
// whose plain twins *_ref compute each phase in eager torch.
//
// A rank holds the queries q [mq, d] of its chains shard (global rows q0 +
// i) with weights qw [mq], and the components m [nk, d] of its kernels
// shard (global columns k0 + j) with weights mw [nk]; the weights of the
// whole problem sum to 1 and padding has weight 0.  Row k of a probe at x
// is dimension k with variance var = (x x)(b_k b_k), b the bracket's base:
//
//   f_k(x) = -sum_{i: w_i > 0} w_i log p_i,
//   log p_i = log sum_{j != i} w_j exp(-(q_ik - m_jk)^2 / (2 var))
//             - log(var) / 2 - log(2 pi) / 2 - log1p(-w_i),
//
// +inf when a positive-weight query has p = 0.  A search is:
//
//   stage                      the shard's columns staged per dimension
//                              (x, +inf where w = 0), the golden state
//                              from the bracket;
//   nn_shift     -> pmin       each query's least squared distance to a
//                              live column j != i: shift [d, mq];
//   per sweep s = 0, 1, ...:
//     probe_sums   -> psum     [rows, mq] float64 shifted sums of every
//                              searching row at its probe (s = 0: x1 and
//                              x2 of every dimension, 2d rows; then d);
//     probe_entropy -> psum    [rows, 2] (h, bad) over this chains shard;
//     golden_step              _golden_core's masked update, the next
//                              probes and the active flag.
//
// So a sweep costs two collectives and a search one more (the pmin), where
// the eager probe issued 2d + 1 a probe.  The shift is K4's
// (csrc/loo_search.cu), made global: it does not depend on the probe, so
// the d pmax a probe of the JAX program go, and every term is
// w_j 2^t, t <= 0, so a sum lies in [w_nn, 1] and cannot underflow.  A
// query with no live neighbour on any shard keeps shift +inf: its sum
// uses 0 in its place, adds no term (every column it sees is staged +inf
// or is its own diagonal), gives S = 0, log p = -inf and the row's +inf
// objective, never NaN.
//
// What bounds it: every probe row is nk (mq - 1) pairs on a shard, each
// one exp that nothing shares; float32 takes one MUFU ex2 a pair (16 a
// clock per SM), float64 the FP64 pipe.  The bytes are O(d (mq + nk)) a
// sweep.  The design follows K4 (csrc/loo_probe.cuh holds the arithmetic
// both issue): a block takes kGroup queries of one row and streams the
// row's staged columns through shared memory in kTile tiles with cp.async,
// each staged column serving the block's kGroup queries; the diagonal is
// masked where the tile's global columns meet the block's global queries.
// No [mq, nk] tensor exists: the peak is O(d (mq + nk)).  Frozen rows get
// no work (their blocks return), and every phase reads its sweep's state
// from device memory, so the host issues sweeps without reading the card.
//
// Determinism across ranks: golden_step reads only replicated values
// (the bracket, and entropies after the chains psum, bitwise equal on
// every rank), so every rank takes the same branch and issues the same
// collectives.  Every sum is in a fixed order (a warp's butterfly, a
// block's tree), so repeated calls give equal bits.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libsharded_loo.so sharded_loo.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "loo_probe.cuh"

namespace {

using namespace kde_loo;

constexpr int kRowThreads = 512;          // probe_entropy: a block a row
constexpr int kStepThreads = 256;         // golden_step: one block

// The golden state, st [8, d] of T: x0, x1, x2, x3, f1, f2, pr0, pr1; fl
// [d] of int: bit 0 take2, bit 1 active (for the sweep to come).
enum { kX0, kX1, kX2, kX3, kF1, kF2, kPr0, kPr1 };

template <typename T>
__device__ __forceinline__ T* st_row(T* st, int d, int r) {
  return st + (size_t)r * d;
}

// A row's probe: x (pr0 or pr1 of dimension k), var = (x x)(b b), the
// exponent's scale nh in T's units.  Identical in probe_sums and
// probe_entropy, so the shift's offset rounds the same in both.
template <typename T>
struct Probe {
  double var;
  T nh;
};

template <typename T>
__device__ __forceinline__ Probe<T> probe_of(const T* st, const T* base,
                                             int d, int p, int k) {
  const T x = p ? st[(size_t)kPr1 * d + k] : st[(size_t)kPr0 * d + k];
  const T b = base[k];
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
      st_row(st, d, kX0)[k] = x0;
      st_row(st, d, kX3)[k] = x3;
      st_row(st, d, kX1)[k] = st_row(st, d, kPr0)[k] = x1;
      st_row(st, d, kX2)[k] = st_row(st, d, kPr1)[k] = x2;
      fl[k] = 2;
    }
  }
}

// Row pk (probe p = pk / d of dimension k = pk % d), queries [g kGroup,
// (g + 1) kGroup) of the shard.  kDmin: the least squared distance to a
// live column j != i, written to out [d, mq] (+inf where none); else the
// shifted sum, written to out [rows, mq] (float64).
template <typename T, bool kDmin>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* q, const T* xs, const T* wp, const T* shift,
            const T* base, const T* st, const int* fl, int sweep, long long q0,
            long long k0, int mq, int n_pad, int d, void* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const int g = blockIdx.x, pk = blockIdx.y;
  const int p = pk / d, k = pk - p * d;
  if (!kDmin && sweep > 0 && !(fl[k] & 2)) return;   // a frozen row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* row = xs + (size_t)k * n_pad;
  T nh = T(0);
  if (!kDmin) nh = probe_of(st, base, d, p, k).nh;
  T xq[kQ], off[kQ], mn[kQ];
  int iq[kQ];
  double acc[kQ];
  // global indices relative to the tile's: the mask compares j - k0 with
  // i - k0, both within int range of the shard's tiles
  const long long rel = q0 - k0;
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = g * kGroup + warp * kQ + u;
    const bool real = i < mq;
    const long long gi = rel + i;      // the query's column index here
    iq[u] = (gi >= 0 && gi < (long long)n_pad) ? (int)gi : -1;
    xq[u] = real ? q[(size_t)i * d + k] : T(0);
    mn[u] = (T)INFINITY;
    acc[u] = 0.0;
    off[u] = T(0);
    if (!kDmin && real)
      off[u] = -(usable_shift(shift[(size_t)k * mq + i]) * nh);
  }
  // the tiles that hold the block's queries' own columns
  const long long lo = rel + (long long)g * kGroup;
  const long long hi = lo + kGroup;      // exclusive
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
      tile_pass<T, kDmin, true>(sx, sw, t * kTile, xq, off, iq, nh, mn, acc);
    else
      tile_pass<T, kDmin, false>(sx, sw, t * kTile, xq, off, iq, nh, mn,
                                 acc);
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = g * kGroup + warp * kQ + u;
    if (kDmin) {
      const T m = warp_min(mn[u]);
      if (lane == u && i < mq) static_cast<T*>(out)[(size_t)k * mq + i] = m;
    } else {
      const double s = warp_sum(acc[u]);
      if (lane == u && i < mq)
        static_cast<double*>(out)[(size_t)pk * mq + i] = s;
    }
  }
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

// Row pk's (h, bad) over the shard's queries from the summed sums.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
entropy_kernel(const double* sums, const T* shift, const T* qw,
               const T* base, const T* st, const int* fl, int sweep, int mq,
               int d, double* ent) {
  __shared__ double red[kRowThreads / 32];
  const int pk = blockIdx.x;
  const int p = pk / d, k = pk - p * d;
  if (sweep > 0 && !(fl[k] & 2)) {
    if (threadIdx.x == 0) ent[2 * pk] = ent[2 * pk + 1] = 0.0;
    return;
  }
  const Probe<T> pr = probe_of(st, base, d, p, k);
  const double tail = -0.5 * log(pr.var) - 0.5 * kLog2Pi;
  double c = 0.0, bad = 0.0;
  for (int i = threadIdx.x; i < mq; i += kRowThreads) {
    const double wi = (double)qw[i];
    if (wi > 0.0) {
      const T off = -(usable_shift(shift[(size_t)k * mq + i]) * pr.nh);
      const double logp = log(sums[(size_t)pk * mq + i]) -
                          (double)off / Num<T>::kScale + tail - log1p(-wi);
      c += wi * logp;             // p = 0: -inf
      bad += (logp == -INFINITY) ? 1.0 : 0.0;
    }
  }
  c = block_sum<kRowThreads>(c, red);
  bad = block_sum<kRowThreads>(bad, red);
  if (threadIdx.x == 0) {
    ent[2 * pk] = -c;
    ent[2 * pk + 1] = bad;
  }
}

template <typename T>
__device__ __forceinline__ T objective(const double* ent, int row) {
  return ent[2 * row + 1] > 0.0 ? (T)INFINITY : (T)ent[2 * row];
}

template <typename T>
__device__ __forceinline__ void put_trace(T* trace, int max_iters, int k,
                                          int slot, T x, T f) {
  T* t = trace + ((size_t)k * (max_iters + 2) + slot) * 2;
  t[0] = x;
  t[1] = f;
}

// _golden_core's step after sweep s: take the sweep's objectives, then
// iteration s's active test, bracket update and probe.  One block.
template <typename T>
__global__ void __launch_bounds__(kStepThreads)
golden_kernel(const double* ent, const T* base, T* st, int* fl, T* xmin,
              T* trace, int* flag, int sweep, int d, int max_iters, T tol,
              T gc, T gr) {
  int any = 0;
  for (int k = threadIdx.x; k < d; k += kStepThreads) {
    T x0 = st_row(st, d, kX0)[k], x1 = st_row(st, d, kX1)[k];
    T x2 = st_row(st, d, kX2)[k], x3 = st_row(st, d, kX3)[k];
    T f1 = st_row(st, d, kF1)[k], f2 = st_row(st, d, kF2)[k];
    T pr0 = st_row(st, d, kPr0)[k];
    if (sweep == 0) {
      f1 = objective<T>(ent, k);
      f2 = objective<T>(ent, d + k);
      if (trace) {
        put_trace(trace, max_iters, k, 0, x1, f1);
        put_trace(trace, max_iters, k, 1, x2, f2);
      }
    } else if (fl[k] & 2) {
      const T fp = objective<T>(ent, k);
      if (fl[k] & 1) {
        f1 = f2;
        f2 = fp;
      } else {
        f2 = f1;
        f1 = fp;
      }
      if (trace) put_trace(trace, max_iters, k, 1 + sweep, pr0, fp);
    }
    const bool active =
        sweep < max_iters && fabs(x3 - x0) > tol * (fabs(x1) + fabs(x2));
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
    st_row(st, d, kX0)[k] = x0;
    st_row(st, d, kX1)[k] = x1;
    st_row(st, d, kX2)[k] = x2;
    st_row(st, d, kX3)[k] = x3;
    st_row(st, d, kF1)[k] = f1;
    st_row(st, d, kF2)[k] = f2;
    st_row(st, d, kPr0)[k] = pr0;
    fl[k] = (int)take2 | ((int)active << 1);
    xmin[k] = (f1 < f2 ? x1 : x2) * base[k];
    any |= (int)active;
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

template <typename T, bool kDmin>
int rows_t(const void* q, const void* xs, const void* wp, const void* shift,
           const void* base, const void* st, const void* fl, int sweep,
           long long q0, long long k0, int mq, int n_pad, int d, int rows,
           void* out, cudaStream_t stream) {
  const dim3 grid((unsigned)groups(mq), (unsigned)rows, 1);
  rows_kernel<T, kDmin><<<grid, kThreads, tile_smem(sizeof(T) == 8), stream>>>(
      (const T*)q, (const T*)xs, (const T*)wp, (const T*)shift,
      (const T*)base, (const T*)st, (const int*)fl, sweep, q0, k0, mq, n_pad,
      d, out);
  return finish();
}

}  // namespace

// Stage the shard's columns m [nk, d] (weights mw [nk]) as xs [d, n_pad]
// (+inf for a zero weight or padding) and wp [n_pad], and set the golden
// state st [8, d], fl [d] from the bracket ax, bx, cx [d].
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
// live staged column j != i (global k0 + j): shift [d, mq], +inf where it
// has none on this shard.
extern "C" int kde_k7_nn_shift(const void* q, const void* xs,
                               const void* wp, long long q0, long long k0,
                               int mq, int n_pad, int d, void* shift, int f64,
                               void* stream) {
  if (!sizes_ok(mq, n_pad, d)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return f64 ? rows_t<double, true>(q, xs, wp, nullptr, nullptr, nullptr,
                                    nullptr, 0, q0, k0, mq, n_pad, d, d,
                                    shift, s)
             : rows_t<float, true>(q, xs, wp, nullptr, nullptr, nullptr,
                                   nullptr, 0, q0, k0, mq, n_pad, d, d, shift,
                                   s);
}

// Sweep s's shifted sums of every searching row: sums [rows, mq] float64,
// rows = 2d at s = 0 (pr0, then pr1, of every dimension), else d.
extern "C" int kde_k7_probe_sums(const void* q, const void* xs,
                                 const void* wp, const void* shift,
                                 const void* base, const void* st,
                                 const void* fl, int sweep, long long q0,
                                 long long k0, int mq, int n_pad, int d,
                                 void* sums, int f64, void* stream) {
  if (!sizes_ok(mq, n_pad, d) || sweep < 0) return (int)cudaErrorInvalidValue;
  const int rows = sweep == 0 ? 2 * d : d;
  const cudaStream_t s = (cudaStream_t)stream;
  return f64 ? rows_t<double, false>(q, xs, wp, shift, base, st, fl, sweep,
                                     q0, k0, mq, n_pad, d, rows, sums, s)
             : rows_t<float, false>(q, xs, wp, shift, base, st, fl, sweep, q0,
                                    k0, mq, n_pad, d, rows, sums, s);
}

// Sweep s's (h, bad) of every searching row over the shard's queries (qw
// [mq]) from the summed sums: ent [rows, 2] float64; frozen rows (0, 0).
extern "C" int kde_k7_probe_entropy(const void* sums, const void* shift,
                                    const void* qw, const void* base,
                                    const void* st, const void* fl, int sweep,
                                    int mq, int d, void* ent, int f64,
                                    void* stream) {
  if (mq < 1 || d < 1 || sweep < 0) return (int)cudaErrorInvalidValue;
  const int rows = sweep == 0 ? 2 * d : d;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    entropy_kernel<double><<<rows, kRowThreads, 0, s>>>(
        (const double*)sums, (const double*)shift, (const double*)qw,
        (const double*)base, (const double*)st, (const int*)fl, sweep, mq, d,
        (double*)ent);
  else
    entropy_kernel<float><<<rows, kRowThreads, 0, s>>>(
        (const double*)sums, (const float*)shift, (const float*)qw,
        (const float*)base, (const float*)st, (const int*)fl, sweep, mq, d,
        (double*)ent);
  return finish();
}

// The golden step after sweep s from the summed ent: the state st, fl, the
// picks xmin [d] (x times the base), the trace [d, max_iters + 2, 2] or
// null, and *flag = 1 while a row still searches.
extern "C" int kde_k7_golden_step(const void* ent, const void* base, void* st,
                                  void* fl, void* xmin, void* trace,
                                  void* flag, int sweep, int d, int max_iters,
                                  double tol, double gc, double gr, int f64,
                                  void* stream) {
  if (d < 1 || sweep < 0 || max_iters < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    golden_kernel<double><<<1, kStepThreads, 0, s>>>(
        (const double*)ent, (const double*)base, (double*)st, (int*)fl,
        (double*)xmin, (double*)trace, (int*)flag, sweep, d, max_iters, tol,
        gc, gr);
  else
    golden_kernel<float><<<1, kStepThreads, 0, s>>>(
        (const double*)ent, (const float*)base, (float*)st, (int*)fl,
        (float*)xmin, (float*)trace, (int*)flag, sweep, d, max_iters,
        (float)tol, (float)gc, (float)gr);
  return finish();
}
