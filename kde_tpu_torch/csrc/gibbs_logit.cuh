// The candidate logit of a Gibbs selection and the row reductions around
// it, shared by csrc/gibbs_select.cu (K2) and csrc/sharded_select.cu (K6),
// so both issue the same instructions for a candidate's logit.
//
// candidate_logit is ops/gibbs.py::_kernel_logits_raw for one candidate,
// step for step: per active dim k (flags bit 0; bit 1 wraps the difference
// as manifolds.circular_diff does, multiplying by the float reciprocal of
// 2 pi as torch does for a scalar divisor on the card)
//
//   c = bw_k (+ cov_k),  delta = mean_k - mu_k,  pd = delta^2 / c + log c
//
// (a NaN pd gives 0), then logw - 0.5 * sum pd (a NaN logit -inf).  Built
// with --fmad=false, CUDA's logf/log and IEEE division, so the logits are
// bitwise the twin's.  K2 issues candidate_logit; K6 issues row_logit, the
// same value from a row's constants (log c once a row where the level's
// bandwidth is uniform in a dim).

#pragma once

#include <math.h>

namespace kde_gibbs {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float rnd(float x) { return rintf(x); }
__device__ __forceinline__ double rnd(double x) { return rint(x); }

template <typename T>
__device__ __forceinline__ T neg_inf() { return -(T)INFINITY; }

// The logit of the candidate whose mean and bandwidth rows are m[d], s[d]
// and log-weight logw, against the row's mu[d] and, with has_cov,
// cov[d]; flags[d] as above.
template <typename T>
__device__ __forceinline__ T candidate_logit(
    const T* m, const T* s, T logw, const T* mu, const T* cov, bool has_cov,
    const unsigned char* flags, int d, T two_pi, T inv_two_pi) {
  T acc = (T)0;
  for (int k = 0; k < d; ++k) {
    const unsigned char f = flags[k];
    if (!(f & 1)) continue;
    T cc = s[k];
    if (has_cov) cc = cc + cov[k];
    T dl = m[k] - mu[k];
    if (f & 2) {
      const T q = dl * inv_two_pi;
      const T r = two_pi * rnd(q);
      dl = dl - r;
    }
    const T sq = dl * dl;
    const T quad = sq / cc;
    T pd = quad + lg(cc);
    if (isnan(pd)) pd = (T)0;
    acc = acc + pd;
  }
  const T half = (T)0.5 * acc;
  T l = logw - half;
  if (isnan(l)) l = neg_inf<T>();
  return l;
}

// A row's constants for row_logit: per dim k its flags f (candidate_logit's
// bits 0 and 1, and bit 2: every candidate of the level has the same
// bandwidth in k), mu_k, cov_k (0 without cov) and, on uniform dims, c_k =
// bw_k (+ cov_k) of that one bandwidth and lc_k = lg(c_k).  In registers
// for a d known at compile time (D > 0); in shared memory otherwise.
template <typename T, int D>
struct RowQ {
  T x[D], q[D], c[D], lc[D];
  unsigned char f[D];
  __device__ __forceinline__ int dims() const { return D; }
  __device__ __forceinline__ T X(int k) const { return x[k]; }
  __device__ __forceinline__ T Q(int k) const { return q[k]; }
  __device__ __forceinline__ T C(int k) const { return c[k]; }
  __device__ __forceinline__ T LC(int k) const { return lc[k]; }
  __device__ __forceinline__ unsigned char F(int k) const { return f[k]; }
};
template <typename T>
struct RowQ<T, 0> {
  const T *x, *q, *c, *lc;
  const unsigned char* f;
  int d;
  __device__ __forceinline__ int dims() const { return d; }
  __device__ __forceinline__ T X(int k) const { return x[k]; }
  __device__ __forceinline__ T Q(int k) const { return q[k]; }
  __device__ __forceinline__ T C(int k) const { return c[k]; }
  __device__ __forceinline__ T LC(int k) const { return lc[k]; }
  __device__ __forceinline__ unsigned char F(int k) const { return f[k]; }
};

// candidate_logit against a row's constants r: the same operations in the
// same order, but on a uniform dim c and log c are the row's, the very
// values candidate_logit computes for every candidate there, so the logit
// is bitwise candidate_logit's; s is read only on the other dims.
template <typename T, int D>
__device__ __forceinline__ T row_logit(const RowQ<T, D>& r, const T* m,
                                       const T* s, T logw, bool has_cov,
                                       T two_pi, T inv_two_pi) {
  T acc = (T)0;
#pragma unroll
  for (int k = 0; k < r.dims(); ++k) {
    const unsigned char f = r.F(k);
    if (!(f & 1)) continue;
    T cc, lc;
    if (f & 4) {
      cc = r.C(k);
      lc = r.LC(k);
    } else {
      cc = s[k];
      if (has_cov) cc = cc + r.Q(k);
      lc = lg(cc);
    }
    T dl = m[k] - r.X(k);
    if (f & 2) {
      const T q = dl * inv_two_pi;
      const T rr = two_pi * rnd(q);
      dl = dl - rr;
    }
    const T sq = dl * dl;
    const T quad = sq / cc;
    T pd = quad + lc;
    if (isnan(pd)) pd = (T)0;
    acc = acc + pd;
  }
  const T half = (T)0.5 * acc;
  T l = logw - half;
  if (isnan(l)) l = neg_inf<T>();
  return l;
}

// ---- reductions over a row's group of G threads (a warp, or a block) ----

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 32) __syncwarp(); else __syncthreads();
}

// v combined over the group by op; every thread gets the same value (a
// butterfly, then the warps' values in warp order).
template <int G, typename V, typename Op>
__device__ V group_all(V v, Op op, V* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  if constexpr (G == 32) {
    return v;
  } else {
    const int warp = threadIdx.x / 32;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) scratch[warp] = v;
    __syncthreads();
    V r = scratch[0];
    for (int i = 1; i < G / 32; ++i) r = op(r, scratch[i]);
    return r;
  }
}

// Exclusive prefix of v over the group's threads in thread order, and the
// group's total.
template <int G>
__device__ double group_scan(double v, double* scratch, double& total) {
  const int lane = threadIdx.x & 31;
  double inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  double excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = 0.0;
  if constexpr (G == 32) {
    total = __shfl_sync(kFull, inc, 31);
    return excl;
  } else {
    const int warp = threadIdx.x / 32;
    __syncthreads();
    if (lane == 31) scratch[warp] = inc;
    __syncthreads();
    double before = 0.0, all = 0.0;
    for (int i = 0; i < G / 32; ++i) {
      if (i == warp) before = all;
      all += scratch[i];
    }
    total = all;
    return before + excl;
  }
}

struct MaxOp {
  template <typename V>
  __device__ V operator()(V a, V b) const { return b > a ? b : a; }
};
struct SumOp {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a + b; }
};
struct MinOp {
  template <typename V>
  __device__ V operator()(V a, V b) const { return b < a ? b : a; }
};

}  // namespace kde_gibbs
