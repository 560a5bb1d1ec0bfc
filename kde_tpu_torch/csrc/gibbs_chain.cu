// The whole multiscale Gibbs chain in one launch, for Hopper (sm_90a): the
// hand kernel behind ops/gibbs_chain.py::gibbs_chain (the port's K3, with
// K2's selection step, csrc/gibbs_select.cu, as its inner step).
//
// It replaces kde_tpu/ops/gibbs.py::_run_chain (:498-651), which the TPU runs
// as one XLA-fused program (the chain has no Pallas kernel), for the flat
// inverse-CDF draw ("cdf") and the Gumbel-max draw ("gumbel").  A group of
// threads owns one chain (set b, chain c) and walks it from the roots to
// the final draw:
//
//   for each level l:
//     x = the product of the current selections, + sqrt(cov) n (or addop)
//     every density j re-selects against N(x, bw)           (u_cond)
//     n_iter sweeps: for each j, (mu, cov) = the product leaving j out,
//       j re-selects against N(mu, bw + cov)                 (u_gibbs)
//     the level's labels are written out
//   the final draw (with or without the step)
//
// A selection of density j scores its level's w candidates
//
//   l_i = logw_i - 1/2 sum_{k active} [delta_ik^2 / c_ik + log c_ik],
//   c_ik = bw_ik (+ cov_k),  delta_ik = mean_ik - mu_k (wrapped: circular)
//
// (a NaN dim gives 0, a NaN logit -inf), takes the degenerate test
// max + log sum exp(l - max) < log(1e-99) with its fallback (1 for real
// candidates, 0 for padding), and draws
//
//   cdf:    the first index whose running sum of e_i = exp(l_i - max) (the
//           chain's type, widened to float64) is not below u * sum e;
//   gumbel: argmax_i l_i - log(-log g_i) (dead: -log(-log g_i) over the
//           real candidates), the first index winning ties, g the counter
//           draw of csrc/counter_rng.cuh for the set's seed, the chain,
//           the selection id (the column cdf reads in u) and candidate i.
//
// Gumbel is one pass over a level's candidates: the logit, the noise, the
// max and both argmaxes; the sum of exps for the dead test is taken only
// where the max is below log(1e-99) (the sum holds exp(0) = 1 and no
// negative term, so a row whose max reaches the threshold is live in any
// rounding), from L2, in a fixed order.  Its argmaxes merge exactly, so
// its labels do not depend on the layout.  For cdf the twin
// (ops/gibbs_chain.py::gibbs_chain_ref) takes the
// count of entries of cumsum(e / sum e) below u: the two differ only where
// the float64 sums, taken in another order, put a CDF entry within an ulp
// of u.  Every other step is the twin's operation in the twin's order:
// the information-form product (IEEE reciprocals, the sums over densities
// in the order torch's CUDA reduction takes them), sqrtf/sqrt, the circular wrap as torch forms it on the
// card (times the float reciprocal of 2 pi, rint), the first-max anchor of
// circular_mu, logf/log and expf/exp, built with --fmad=false, so points and
// labels are meant to be bitwise the twin's.
//
// What bounds it: per (chain, candidate) pair d IEEE divisions, d logs
// (none where the level's bandwidth is uniform in that dim: log c is then
// taken once a selection, bitwise the same value) and, for cdf, an exp in
// two passes (pass 1 finds the max, pass 2 the sums); for gumbel, in one
// pass, two logs and half a Threefry block (about 37 integer operations) a
// float candidate instead of the exp.  chip_smoke.py --k3-diag's
// ablations on the H100 bind the kernel by the instruction throughput of
// that arithmetic, not by its loads: at the slice pass 1 is 42 % of the
// time, the accurate logf 28 %, the division 14 %, and making the
// candidates from their index instead of loading them is no faster
// (PERF.md §6).  With the bits fixed
// by the twin, none of that arithmetic can go; what the layouts change is
// how the chains share the card.
//
// Layouts (the wrapper's launch_plan picks one from the set's dtype, d,
// chain count and widest level, so a set drawn in a batch runs as alone):
//   * staged (float32, d = 1, 2, 3, many chains over wide levels;
//     gibbs_chain_staged): a block holds up to 16 chains of one set, a warp
//     a chain, all in lockstep (every chain of a set makes the same
//     selections in the same order).  A level's candidates (the contiguous
//     [w, d] means and, where an active dim's bandwidth varies, bandwidths,
//     and [w] log weights) go to shared memory by cp.async: where the level
//     of every density fits the block's stage, once for all the level's
//     selections (the warps then run them without a block barrier);
//     otherwise each selection streams them through a ring of kStages
//     slots.  Either way a candidate leaves L2 once a block, not once a
//     chain; 4-byte copies keep any level offset aligned.  A set's last
//     block may hold fewer chains (its spare warps follow a copy of the
//     last chain and write nothing).
//   * warp and block (the first layouts, gibbs_chain_kernel): a warp a chain
//     (8 chains a 256-thread block), or a 512-thread block a chain; every
//     chain reads its candidates from L2.  Float64 (the replay paths) and
//     d >= 4 take these by shape, and so do the float32 shapes where they
//     measured faster or were not measured against the staged layout:
//     narrow levels and up to about a thousand chains (a warp a chain) and
//     a few hundred chains over wide levels (a block a chain).
// Common to all:
//   * no host step between stages: the chain's state (selections [dn, d],
//     labels [dn], x, mu, cov) stays in shared memory for the whole chain;
//   * no logits cache and no per-candidate float64 division: pass 2 the
//     exps, their sum in the chain's type (the dead test) and fixed-order
//     float64 sums of at most kMaxTiles contiguous tiles of a multiple of
//     32 candidates (of the block's threads on the block layout); the
//     label from a scan of the tile sums against u * sum, then a scan
//     inside that one tile from L2.  A lane adds its candidates in the
//     same order on the warp and the staged layouts, so their draws are
//     the same bits;
//   * every reduction in a fixed order, so a chain's draw does not depend
//     on the launch it is part of.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "counter_rng.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpChains = 8;      // chains of a 256-thread block, warp layout
constexpr int kCtaThreads = 512;    // threads of a block, block layout
constexpr int kMaxWarps = kCtaThreads / 32;
constexpr int kPer = 4;             // consecutive candidates a thread scans
constexpr int kMaxTiles = 64;       // tiles a selection's row splits into
constexpr int kMaxDens = 16;
constexpr int kMaxDim = 16;

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float rnd(float x) { return rintf(x); }
__device__ __forceinline__ double rnd(double x) { return rint(x); }
__device__ __forceinline__ float sq_root(float x) { return sqrtf(x); }
__device__ __forceinline__ double sq_root(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T neg_inf() { return -(T)INFINITY; }

// Ablations for chip_smoke.py --k3-diag, built into a separate library with
// -DK3_DIAG and one of the defines below; the package's build takes none.
//   K3_DIAG_PASS2_ONLY  no pass 1: the max is given (0)
//   K3_DIAG_NO_LOADS    candidates made from their index, no loads
//   K3_DIAG_NO_LOG      c instead of log c off the uniform dims
//   K3_DIAG_DIV_MUL     d^2 * c instead of d^2 / c
//   K3_DIAG_NO_RNG      gumbel's uniforms from a few integer operations
//                       instead of the counter generator
#ifdef K3_DIAG_NO_LOADS
#define K3_CAND(load, alt) (alt)
#else
#define K3_CAND(load, alt) (load)
#endif
#ifdef K3_DIAG_NO_LOG
#define K3_LOG_C(x) (x)
#else
#define K3_LOG_C(x) lg(x)
#endif
#ifdef K3_DIAG_DIV_MUL
#define K3_QUAD(a, b) ((a) * (b))
#else
#define K3_QUAD(a, b) ((a) / (b))
#endif

// gumbel's uniforms of generator block q (csrc/counter_rng.cuh)
template <typename T, int P>
__device__ __forceinline__ void draw_uniforms(kde_rng::Key k, int q,
                                              T (&g)[P]) {
#ifdef K3_DIAG_NO_RNG
#pragma unroll
  for (int v = 0; v < P; ++v)
    g[v] = (T)(((k.k0 ^ (unsigned)(q * P + v)) & 0xffffu) + 1u)
           * (T)(1.0 / 65538.0);
#else
  kde_rng::Uniform<T>::draw(k, q, g);
#endif
}

template <typename T>
__device__ __forceinline__ T circ_wrap(T x, T two_pi, T inv_two_pi) {
  const T q = x * inv_two_pi;
  return x - two_pi * rnd(q);
}

// A selection's per-dim query constants: the query mean x, the added
// covariance q and, for uniform dims, c and log c; flags f (1 active, 2
// circular, 4 uniform).  In registers for a d known at compile time (D >
// 0); read from shared memory otherwise.
template <typename T, int D>
struct Sel {
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
struct Sel<T, 0> {
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

// The logit of candidate i (mean m[0..d), bandwidth bw[0..d), log weight
// *lw, read after the dims, which holds one register less
// across them): logw - 1/2 sum_{k active} [delta^2 / c + log c], a NaN
// dim 0, a NaN logit -inf; the twin's operations in the twin's order.
template <typename T, int D>
__device__ __forceinline__ T logit_at(const Sel<T, D>& s, bool has_cov,
                                      const T* m, const T* bw, const T* lw,
                                      int i, T two_pi, T inv_two_pi) {
  const T zero = (T)0;
  T acc = zero;
#pragma unroll
  for (int k = 0; k < s.dims(); ++k) {
    const unsigned char f = s.F(k);
    if (!(f & 1)) continue;
    const T qk = s.X(k);
    T cv, lcv;
    if (f & 4) {
      cv = s.C(k);
      lcv = s.LC(k);
    } else {
      cv = K3_CAND(bw[k], (T)0.5 + (T)(i & 7) * (T)0.125);
      if (has_cov) cv = cv + s.Q(k);
      lcv = K3_LOG_C(cv);
    }
    const T mk = K3_CAND(m[k], qk + (T)(i & 63) * (T)0.015625);
    const T dl = (f & 2) ? circ_wrap(mk - qk, two_pi, inv_two_pi) : mk - qk;
    const T sq = dl * dl;
    const T quad = K3_QUAD(sq, cv);
    T pd = quad + lcv;
    if (isnan(pd)) pd = zero;
    acc = acc + pd;
  }
  const T half = (T)0.5 * acc;
  T lv = K3_CAND(*lw, -(T)(i & 15)) - half;
  if (isnan(lv)) lv = neg_inf<T>();
  return lv;
}

struct Params {
  const void* t_mean;        // [B, dn, 2N, d]: slot 0, the roots, is read
  const void* t_bw;
  long long ts_b, ts_j;
  const void* mean;          // [B, dn, T, d] level slices, strides below
  const void* bw;
  const void* logw;          // [B, dn, T]
  const long long* perm;
  long long ms_b, ms_j, ls_b, ls_j;
  const int* offsets;        // [L, 2]: (start, width) of level l + 1
  const unsigned char* uniform;  // [B, dn, L, d]: bandwidth uniform
  const unsigned char* mask;     // [B, dn, d] bool
  const unsigned char* codes;    // [d]: 0 Euclidean, 1 circular hooks
  const void* u;             // [B, C, bu] uniforms, last axis contiguous (cdf)
  long long us_b, us_c;
  const long long* seeds;    // [B, 2] counter seeds (gumbel)
  const void* nrm;           // [B, C, bn] normals
  long long ns_b, ns_c;
  void* out_x;               // [B, C, d]
  long long* out_labels;     // [B, C, L, dn]
  long long rows;            // B * C
  int C, dn, d, L, n_iter, add_entropy;
  double two_pi, inv_two_pi, log_dead;
};

// ---- a chain's products ----------------------------------------------------

// ops/gibbs.py::_gauss_product and _sample_point over a chain's current
// selections (mask mk, means mu_sel, bandwidths var_sel, all [dn * d]):
// the twin's IEEE reciprocals and circular wrap, and its sums over the
// densities in the order torch's CUDA reduction takes them.  Not on the
// fastest-striding dim (the unhooked [B, C, dn, d] sums with d > 1): one
// thread, the j-th term into accumulator j % 4, then ((a0 + a1) + a2) + a3.
// On it (`tree`: d = 1, and every hooked sum, a dim-k slice or a fresh
// [B, C, dn] product): last_pow2(dn) lanes, lane t adding terms t and
// t + lanes the same way, then a shuffle tree at offsets lanes / 2, ..., 1.
template <typename T>
struct Products {
  const unsigned char* mk;
  const T* mu_sel;
  const T* var_sel;
  const unsigned char* codes;
  int dn, d;
  bool tree;
  T two_pi, inv_two_pi;

  template <typename F>
  __device__ T dn_sum(F term) const {
    const T zero = (T)0;
    if (!tree) {
      T acc[4] = {zero, zero, zero, zero};
      for (int j = 0; j < dn; ++j) acc[j & 3] = acc[j & 3] + term(j);
      return ((acc[0] + acc[1]) + acc[2]) + acc[3];
    }
    T v[kMaxDens];
    int lanes = 1;
    while (2 * lanes <= dn) lanes *= 2;
    for (int t = 0; t < lanes; ++t) {
      const T a0 = zero + term(t);
      const T a1 = t + lanes < dn ? zero + term(t + lanes) : zero;
      v[t] = ((a0 + a1) + zero) + zero;
    }
    for (int o = lanes >> 1; o > 0; o >>= 1)
      for (int t = 0; t < o; ++t) v[t] = v[t] + v[t + o];
    return v[0];
  }

  // dim k of the product leaving out `skip` (-1: none): mean and cov
  __device__ void dim(int k, int skip, T& m_out, T& c_out) const {
    const T zero = (T)0;
    bool has = false;
    for (int j = 0; j < dn; ++j) has = has || (mk[j * d + k] && j != skip);
    auto lam_of = [&](int j) -> T {
      const T v = var_sel[j * d + k];
      return (mk[j * d + k] && j != skip && v > zero) ? (T)1 / v : zero;
    };
    const T lt = dn_sum(lam_of);
    const T cov = has ? (T)1 / lt : zero;
    c_out = cov;
    if (codes[k] == 0) {
      const T s = dn_sum([&](int j) -> T {
        return lam_of(j) * mu_sel[j * d + k];
      });
      m_out = cov * s;
    } else if (!has) {
      m_out = zero;
    } else {
      int anchor = 0;
      T best = lam_of(0);
      for (int j = 1; j < dn; ++j) {
        const T lj = lam_of(j);
        if (lj > best) { best = lj; anchor = j; }
      }
      const T ref = mu_sel[anchor * d + k];
      const T s = dn_sum([&](int j) -> T {
        return circ_wrap(mu_sel[j * d + k] - ref, two_pi, inv_two_pi)
               * lam_of(j);
      });
      m_out = circ_wrap(ref + cov * s, two_pi, inv_two_pi);
    }
  }

  // dim k of the product of every selection, then (jitter) the step
  __device__ T point(int k, const T* normals, bool jitter) const {
    T m, cv;
    dim(k, -1, m, cv);
    if (!jitter) return m;
    const T step = sq_root(cv) * normals[k];
    return codes[k] ? circ_wrap(m + step, two_pi, inv_two_pi) : m + step;
  }
};

// ---- reductions over a chain's group of G threads ----------------------

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

// (value, index) argmax over the group: the larger value, on a tie the
// smaller index; index -1 holds nothing.  Exact, so any merge order gives
// the same pick.
template <typename T>
struct Best {
  T v;
  int i;
};

template <typename T>
__device__ __forceinline__ Best<T> better(Best<T> a, Best<T> b) {
  if (a.i < 0) return b;
  if (b.i < 0) return a;
  if (a.v > b.v) return a;
  if (b.v > a.v) return b;
  return a.i < b.i ? a : b;
}

template <int G, typename T>
__device__ Best<T> group_best(Best<T> b, T* sv, int* si) {
  for (int o = 16; o > 0; o >>= 1) {
    Best<T> y{__shfl_xor_sync(kFull, b.v, o), __shfl_xor_sync(kFull, b.i, o)};
    b = better(b, y);
  }
  if constexpr (G == 32) {
    return b;
  } else {
    const int warp = threadIdx.x / 32;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) { sv[warp] = b.v; si[warp] = b.i; }
    __syncthreads();
    Best<T> r{sv[0], si[0]};
    for (int i = 1; i < G / 32; ++i) r = better(r, Best<T>{sv[i], si[i]});
    return r;
  }
}

// One candidate of the Gumbel pass: logit l, uniform g, real or padding;
// folds it into the max and the live and dead argmaxes.
template <typename T>
__device__ __forceinline__ void gumbel_take(T l, T g, bool real, int i,
                                            T& mx, Best<T>& live,
                                            Best<T>& dead) {
  if (l > mx) mx = l;
  const T gn = lg(-lg(g));
  const T lv = l - gn;
  if (live.i < 0 || lv > live.v) live = Best<T>{lv, i};
  const T dv = real ? (T)0 - gn : neg_inf<T>();
  if (dead.i < 0 || dv > dead.v) dead = Best<T>{dv, i};
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

// ---- a chain's shared memory ---------------------------------------------

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Per group: tile partials (float64 sums and real counts, per warp), tile
// sums, labels [dn], then the T arrays mu_sel, var_sel [dn * d], xq, cq,
// cc, lc [d], then the byte arrays mask, act [dn * d], flags [d].
__host__ __device__ inline size_t group_bytes(int warps, int dn, int d,
                                              size_t item) {
  size_t n = (size_t)kMaxTiles * warps * 8 + (size_t)kMaxTiles * warps * 4
             + (size_t)kMaxTiles * 8 + (size_t)dn * 8;
  n += (2 * (size_t)dn * d + 4 * (size_t)d) * item;
  n += 2 * (size_t)dn * d + (size_t)d;
  return align16(n);
}

// ---- the kernel ---------------------------------------------------------

// D > 0: the launch's d, known at compile time (the query's per-dim
// parameters then sit in registers); D = 0: any d, read from shared memory.
// kGumbel: the Gumbel-max draw, else cdf.  At most 64 registers a thread:
// 4 blocks (32 warps) an SM on the warp layout, 2 on the block layout;
// more registers and fewer warps measured slower on the card.
template <typename T, int G, int D, bool kGumbel>
__global__ void __launch_bounds__(G == 32 ? 32 * kWarpChains : G,
                                  G == 32 ? 4 : 2)
gibbs_chain_kernel(const Params p) {
  constexpr int R = G == 32 ? kWarpChains : 1;      // chains a block
  constexpr int W = G / 32;                          // warps a chain
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_d[kMaxWarps];
  __shared__ T s_t[kMaxWarps];
  __shared__ int s_i[kMaxWarps];
  __shared__ T s_v[kMaxWarps];

  const int g = threadIdx.x / G;                     // the block's chain
  const int t = threadIdx.x % G;                     // thread of the chain
  const int warp = t / 32, lane = t & 31;
  const long long row = (long long)blockIdx.x * R + g;
  if (row >= p.rows) return;                         // warp layout only
  const int dn = p.dn, d = D > 0 ? D : p.d, L = p.L;
  const long long b = row / p.C, c = row % p.C;

  unsigned char* base = smem + (size_t)g * group_bytes(W, dn, d, sizeof(T));
  double* pe = reinterpret_cast<double*>(base);      // [kMaxTiles][W]
  int* pc = reinterpret_cast<int*>(pe + kMaxTiles * W);
  double* tsum = reinterpret_cast<double*>(pc + kMaxTiles * W);
  long long* perms = reinterpret_cast<long long*>(tsum + kMaxTiles);
  T* mu_sel = reinterpret_cast<T*>(perms + dn);
  T* var_sel = mu_sel + dn * d;
  T* xq = var_sel + dn * d;      // the selection's query mean
  T* cq = xq + d;                // its added covariance
  T* cc = cq + d;                // uniform dims: c, the same for every i
  T* lc = cc + d;                // and its log
  unsigned char* mk = reinterpret_cast<unsigned char*>(lc + d);
  unsigned char* act = mk + dn * d;
  unsigned char* fl = act + dn * d;  // 1 active, 2 circular, 4 uniform

  const T two_pi = (T)p.two_pi, inv_two_pi = (T)p.inv_two_pi;
  const T zero = (T)0;
  // the roots, the masks and the LOO active dims (mask and carried by
  // another density)
  const unsigned char* mask_b = p.mask + b * dn * d;
  const T* root_m = static_cast<const T*>(p.t_mean) + b * p.ts_b;
  const T* root_v = static_cast<const T*>(p.t_bw) + b * p.ts_b;
  for (int e = t; e < dn * d; e += G) {
    const int j = e / d, k = e % d;
    const bool m = mask_b[e] != 0;
    bool other = false;
    for (int jj = 0; jj < dn; ++jj)
      if (jj != j && mask_b[jj * d + k]) other = true;
    mk[e] = m ? 1 : 0;
    act[e] = (m && other) ? 1 : 0;
    mu_sel[e] = m ? root_m[j * p.ts_j + k] : zero;
    var_sel[e] = m ? root_v[j * p.ts_j + k] : zero;
  }
  for (int j = t; j < dn; j += G) perms[j] = 0;
  group_sync<G>();

  const T* U = kGumbel ? nullptr
                       : static_cast<const T*>(p.u) + b * p.us_b + c * p.us_c;
  const T* NR = static_cast<const T*>(p.nrm) + b * p.ns_b + c * p.ns_c;

  bool hooked = false;
  for (int k = 0; k < d; ++k) hooked = hooked || p.codes[k] != 0;
  const Products<T> prod{mk, mu_sel, var_sel, p.codes, dn, d,
                         hooked || d == 1, two_pi, inv_two_pi};
  auto product_dim = [&](int k, int skip, T& m_out, T& c_out) {
    prod.dim(k, skip, m_out, c_out);
  };
  auto sample_point = [&](const T* normals, bool jitter, T* out) {
    for (int k = t; k < d; k += G) out[k] = prod.point(k, normals, jitter);
  };

  // one selection of density j at level l against N(xq, bw (+ cq)), the
  // col-th of the chain (cdf reads u[col]); returns the candidate index,
  // the same on every thread of the group
  auto select = [&](int j, int l, int o, int w, bool has_cov, int col) -> int {
    const long long sb = b * p.ms_b + j * p.ms_j + (long long)o * d;
    const T* mean = static_cast<const T*>(p.mean) + sb;
    const T* bw = static_cast<const T*>(p.bw) + sb;
    const T* logw = static_cast<const T*>(p.logw) + b * p.ls_b + j * p.ls_j + o;
    const unsigned char* uni = p.uniform + ((b * dn + j) * L + l) * d;
    for (int k = t; k < d; k += G) {
      const bool un = uni[k] != 0;
      T c0 = bw[k];
      if (has_cov) c0 = c0 + cq[k];
      cc[k] = c0;
      lc[k] = un ? lg(c0) : zero;
      fl[k] = (unsigned char)((act[j * d + k] ? 1 : 0) | (p.codes[k] ? 2 : 0)
                              | (un ? 4 : 0));
    }
    group_sync<G>();
    Sel<T, D> sel;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        sel.x[k] = xq[k];
        sel.q[k] = cq[k];
        sel.c[k] = cc[k];
        sel.lc[k] = lc[k];
        sel.f[k] = fl[k];
      }
    } else {
      sel = Sel<T, 0>{xq, cq, cc, lc, fl, d};
    }
    auto logit = [&](int i) -> T {
      return logit_at<T, D>(sel, has_cov, mean + (long long)i * d,
                            bw + (long long)i * d, logw + i, i, two_pi,
                            inv_two_pi);
    };
    auto real = [&](int i) -> bool {
      return K3_CAND(logw[i], -(T)(i & 15)) != neg_inf<T>();
    };

    if constexpr (kGumbel) {
      // one pass: the logits, the noise, the max and both argmaxes, a
      // thread the candidates of one generator block at a time
      using Un = kde_rng::Uniform<T>;
      const kde_rng::Key key = kde_rng::selection_key(
          p.seeds + 2 * b, (unsigned)c, (unsigned)col);
      T mx = neg_inf<T>();
      Best<T> lbest{neg_inf<T>(), -1}, dbest{neg_inf<T>(), -1};
      for (int q = t; q * Un::kPer < w; q += G) {
        T gq[Un::kPer];
        draw_uniforms<T>(key, q, gq);
#pragma unroll
        for (int v = 0; v < Un::kPer; ++v) {
          const int i = q * Un::kPer + v;
          if (i < w) gumbel_take<T>(logit(i), gq[v], real(i), i, mx, lbest,
                                    dbest);
        }
      }
      mx = group_all<G>(mx, MaxOp(), s_t);
      // the dead test, only where the max is below log(1e-99)
      bool is_dead = false;
      if (!(mx >= (T)p.log_dead)) {
        const T ms = mx == neg_inf<T>() ? zero : mx;
        T sum_t = zero;
        for (int i = t; i < w; i += G) sum_t = sum_t + ex(logit(i) - ms);
        sum_t = group_all<G>(sum_t, SumOp(), s_t);
        is_dead = ms + lg(sum_t) < (T)p.log_dead;
      }
      return group_best<G>(is_dead ? dbest : lbest, s_v, s_i).i;
    }
    const T uval = U[col];

    // pass 1: the max, two candidates a step for the loads in flight
    T mx = neg_inf<T>();
#ifndef K3_DIAG_PASS2_ONLY
    for (int i = t; i < w; i += 2 * G) {
      const T l0 = logit(i);
      const T l1 = i + G < w ? logit(i + G) : neg_inf<T>();
      if (l0 > mx) mx = l0;
      if (l1 > mx) mx = l1;
    }
#endif
    mx = group_all<G>(mx, MaxOp(), s_t);
    const T ms = mx == neg_inf<T>() ? zero : mx;

    // pass 2: the exps in the chain's type (their sum is the dead test)
    // and, per tile, their float64 sum and the real candidates
    const int per_tile = (w + kMaxTiles - 1) / kMaxTiles;
    const int tile = G * ((per_tile + G - 1) / G);
    const int ntiles = (w + tile - 1) / tile;
    T sum_t = zero;
    for (int tau = 0; tau < ntiles; ++tau) {
      const int tb = tau * tile, te = min(tb + tile, w);
      double acc = 0.0;
      int cnt = 0;
      for (int i = tb + t; i < te; i += 2 * G) {
        const bool two = i + G < te;
        const T l0 = logit(i);
        const T l1 = two ? logit(i + G) : zero;
        const T e0 = ex(l0 - ms);
        sum_t = sum_t + e0;
        acc += (double)e0;
        cnt += real(i) ? 1 : 0;
        if (two) {
          const T e1 = ex(l1 - ms);
          sum_t = sum_t + e1;
          acc += (double)e1;
          cnt += real(i + G) ? 1 : 0;
        }
      }
      for (int s = 16; s > 0; s >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, s);
        cnt += __shfl_xor_sync(kFull, cnt, s);
      }
      if (lane == 0) {
        pe[tau * W + warp] = acc;
        pc[tau * W + warp] = cnt;
      }
    }
    sum_t = group_all<G>(sum_t, SumOp(), s_t);   // syncs the partials too
    if constexpr (G == 32) __syncwarp();
    const bool dead = ms + lg(sum_t) < (T)p.log_dead;
    for (int tau = t; tau < ntiles; tau += G) {
      double s = 0.0;
      for (int v = 0; v < W; ++v)
        s += dead ? (double)pc[tau * W + v] : pe[tau * W + v];
      tsum[tau] = s;
    }
    group_sync<G>();

    // the tile where the running sum reaches u * sum, then the scan in it
    double total = 0.0;
    for (int tau = 0; tau < ntiles; ++tau) total += tsum[tau];
    const double target = (double)uval * total;
    double off = 0.0;
    int ft = -1;
    for (int tau = 0; tau < ntiles; ++tau) {
      const double next = off + tsum[tau];
      if (!(next < target)) { ft = tau; break; }
      off = next;
    }
    if (ft < 0) return w - 1;
    const int tb = ft * tile, te = min(tb + tile, w);
    int z = -1;
    for (int sb2 = tb; z < 0 && sb2 < te; sb2 += G * kPer) {
      const int i0 = sb2 + t * kPer;
      double loc[kPer];
      double run = 0.0;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        double q = 0.0;
        if (i < te) {
          T e;
          if (dead) e = real(i) ? (T)1 : zero;
          else e = ex(logit(i) - ms);
          q = (double)e;
        }
        run += q;
        loc[v] = run;
      }
      double sub;
      const double start = off + group_scan<G>(run, s_d, sub);
      int found = 0x7fffffff;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        if (i < te && found == 0x7fffffff && !(start + loc[v] < target))
          found = i;
      }
      found = group_all<G>(found, MinOp(), s_i);
      if (found != 0x7fffffff) z = found;
      off = off + sub;
    }
    return z < 0 ? te - 1 : z;
  };

  // the winner's statistics into the selection, masked
  auto pick = [&](int j, int o, int z) {
    const long long sb = b * p.ms_b + j * p.ms_j + (long long)(o + z) * d;
    const T* mean = static_cast<const T*>(p.mean) + sb;
    const T* bw = static_cast<const T*>(p.bw) + sb;
    for (int k = t; k < d; k += G) {
      const bool m = mk[j * d + k] != 0;
      mu_sel[j * d + k] = m ? mean[k] : zero;
      var_sel[j * d + k] = m ? bw[k] : zero;
    }
    if (t == 0) perms[j] = p.perm[b * p.ls_b + j * p.ls_j + o + z];
    group_sync<G>();
  };

  const int per_level = (1 + p.n_iter) * dn;
  long long* labels = p.out_labels + row * L * dn;
  for (int l = 0; l < L; ++l) {
    const int o = p.offsets[2 * l], w = p.offsets[2 * l + 1];
    const int cl = dn + l * per_level;     // the level's first selection
    // (1) x from the product of the current selections
    sample_point(NR + (long long)l * d, true, xq);
    group_sync<G>();
    // (2) every density re-selects conditioned on x
    for (int j = 0; j < dn; ++j) pick(j, o, select(j, l, o, w, false, cl + j));
    // (3) n_iter sweeps of leave-one-out Gibbs over the densities
    for (int it = 0; it < p.n_iter; ++it) {
      for (int j = 0; j < dn; ++j) {
        for (int k = t; k < d; k += G) product_dim(k, j, xq[k], cq[k]);
        group_sync<G>();
        pick(j, o, select(j, l, o, w, true, cl + dn + it * dn + j));
      }
    }
    for (int j = t; j < dn; j += G) labels[l * dn + j] = perms[j];
    group_sync<G>();
  }
  // the final draw
  sample_point(NR + (long long)L * d, p.add_entropy != 0,
               static_cast<T*>(p.out_x) + row * d);
}

template <typename T, int G, int D, bool kGumbel>
int launch(const Params& p, cudaStream_t st) {
  auto kern = gibbs_chain_kernel<T, G, D, kGumbel>;
  constexpr int R = G == 32 ? kWarpChains : 1;
  const size_t smem = (size_t)R * group_bytes(G / 32, p.dn, p.d, sizeof(T));
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const long long blocks = (p.rows + R - 1) / R;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, G == 32 ? 32 * kWarpChains : G, smem, st>>>(p);
  return (int)cudaGetLastError();
}


// ---- the staged layout: float, d = 1, 2, 3 ---------------------------------

constexpr int kStages = 3;            // ring slots
constexpr int kStageCands = 512;      // candidates a ring slot holds
constexpr int kBlockChains = 16;      // chains a block (a warp each)
constexpr int kStagedDim = 3;         // the largest d of the layout
constexpr int kStagedMinBlocks = 2;   // up to 64 registers a thread

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Floats of the stage: kStages ring slots, each kStageCands candidates'
// means [.., D], log weights and bandwidths [.., D].
__host__ __device__ constexpr int stage_floats(int D) {
  return kStages * kStageCands * (2 * D + 1);
}

// A chain's shared memory (a warp's): its float64 tile sums, labels, real
// counts a tile, selections (means, bandwidths [dn * d]) and query (x,
// cov [d]), at fixed offsets so that one register addresses them all.
struct ChainSmem {
  double tsum[kMaxTiles];
  long long perms[kMaxDens];
  int tcnt[kMaxTiles];
  float mu[kMaxDens * kStagedDim];
  float var[kMaxDens * kStagedDim];
  float xq[kStagedDim];
  float cq[kStagedDim];
};

// A block's: its chains' and the set's mask and active dims [dn * d]; the
// stage (stage_floats(D): the ring, or a level's candidates of every
// density, resident for all its selections) follows, from kStagedHead
// bytes.
struct BlockSmem {
  ChainSmem ch[kBlockChains];
  unsigned char mk[kMaxDens * kStagedDim];
  unsigned char act[kMaxDens * kStagedDim];
};
constexpr size_t kStagedHead = (sizeof(BlockSmem) + 15) & ~(size_t)15;

template <int D>
__device__ __forceinline__ void load_cand(const float* src, float (&dst)[D]) {
  if constexpr (D == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) dst[k] = src[k];
  }
}

__device__ __forceinline__ float warp_fmax(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, v, o);
    v = y > v ? y : v;
  }
  return v;
}

// A block holds up to kBlockChains chains of one set, a warp a chain, all
// in lockstep.  gridDim.x = B * groups, groups = ceil(C / kBlockChains).
// kGumbel: the Gumbel-max draw (one pass over the stage), else cdf.
template <int D, bool kGumbel>
__global__ void __launch_bounds__(32 * kBlockChains, kStagedMinBlocks)
gibbs_chain_staged(const Params p, int groups) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long blk = blockIdx.x;
  const long long b = blk / groups;
  const int c_real = (int)(blk % groups) * kBlockChains + warp;
  // a set's last block may hold fewer than kBlockChains chains: its other
  // warps run a copy of the set's last chain (the block moves in lockstep)
  // and write nothing
  const bool live = c_real < p.C;
  const long long c = live ? c_real : p.C - 1;
  const long long row = b * p.C + c;
  const int dn = p.dn, L = p.L;
  constexpr int kSlot = kStageCands * (2 * D + 1);
  constexpr int kCap = stage_floats(D);

  extern __shared__ __align__(16) unsigned char smem[];
  BlockSmem& sm = *reinterpret_cast<BlockSmem*>(smem);
  ChainSmem& me = sm.ch[warp];
  float* stage = reinterpret_cast<float*>(smem + kStagedHead);
  double* tsum = me.tsum;
  int* tcnt = me.tcnt;
  long long* perms = me.perms;
  float* mu_sel = me.mu;
  float* var_sel = me.var;
  float* xq = me.xq;
  float* cq = me.cq;
  unsigned char* mk = sm.mk;
  unsigned char* act = sm.act;

  const float two_pi = (float)p.two_pi, inv_two_pi = (float)p.inv_two_pi;
  const float ninf = neg_inf<float>();

  // the set's masks and LOO active dims; the chain's roots
  const unsigned char* mask_b = p.mask + b * dn * D;
  for (int e = threadIdx.x; e < dn * D; e += blockDim.x) {
    const int j = e / D, k = e % D;
    bool other = false;
    for (int jj = 0; jj < dn; ++jj)
      if (jj != j && mask_b[jj * D + k]) other = true;
    mk[e] = mask_b[e] ? 1 : 0;
    act[e] = (mask_b[e] && other) ? 1 : 0;
  }
  const float* root_m = static_cast<const float*>(p.t_mean) + b * p.ts_b;
  const float* root_v = static_cast<const float*>(p.t_bw) + b * p.ts_b;
  for (int e = lane; e < dn * D; e += 32) {
    const int j = e / D, k = e % D;
    const bool m = mask_b[e] != 0;
    mu_sel[e] = m ? root_m[j * p.ts_j + k] : 0.0f;
    var_sel[e] = m ? root_v[j * p.ts_j + k] : 0.0f;
  }
  for (int j = lane; j < dn; j += 32) perms[j] = 0;
  __syncthreads();

  bool hooked = false;
  for (int k = 0; k < D; ++k) hooked = hooked || p.codes[k] != 0;
  const Products<float> prod{mk, mu_sel, var_sel, p.codes, dn, D,
                             hooked || D == 1, two_pi, inv_two_pi};
  const float* U = kGumbel ? nullptr
                           : static_cast<const float*>(p.u) + b * p.us_b
                                 + c * p.us_c;
  const float* NR = static_cast<const float*>(p.nrm) + b * p.ns_b + c * p.ns_c;

  // level l's tile partition (K3's: at most kMaxTiles tiles of a multiple
  // of 32 candidates)
  int tile = 0, ntiles = 0;
  // does density j need its bandwidths at level l (an active dim whose
  // bandwidth is not uniform)?
  auto needs_bw = [&](int j, int l) {
    const unsigned char* uni = p.uniform + ((b * dn + j) * L + l) * D;
    bool need = false;
    for (int k = 0; k < D; ++k) need = need || (act[j * D + k] && !uni[k]);
    return need;
  };
  // a level of n candidates on the stage: means [n, D], log weights [n]
  // and, where needed, bandwidths [n, D], each from a multiple of 4 floats
  auto pad4 = [](int x) { return (x + 3) & ~3; };
  auto part_floats = [&](int j, int l, int n) {
    return pad4(n * D) + pad4(n) + (needs_bw(j, l) ? pad4(n * D) : 0);
  };
  bool resident = false;

  // one selection of density j at level l against N(xq, bw (+ cq)), the
  // col-th of the chain (cdf reads u[col]); returns the candidate index,
  // the same on every lane
  auto select = [&](int j, int l, int o, int w, bool has_cov,
                    int col) -> int {
    const long long sb = b * p.ms_b + j * p.ms_j + (long long)o * D;
    const float* gmean = static_cast<const float*>(p.mean) + sb;
    const float* gbw = static_cast<const float*>(p.bw) + sb;
    const float* glogw =
        static_cast<const float*>(p.logw) + b * p.ls_b + j * p.ls_j + o;
    const unsigned char* uni = p.uniform + ((b * dn + j) * L + l) * D;
    Sel<float, D> sel;
    const bool need_bw = needs_bw(j, l);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const bool un = uni[k] != 0, ac = act[j * D + k] != 0;
      float c0 = gbw[k];
      if (has_cov) c0 = c0 + cq[k];
      sel.x[k] = xq[k];
      sel.q[k] = cq[k];
      sel.c[k] = c0;
      sel.lc[k] = un ? lg(c0) : 0.0f;
      sel.f[k] = (unsigned char)((ac ? 1 : 0) | (p.codes[k] ? 2 : 0)
                                 | (un ? 4 : 0));
    }
    auto glogit = [&](int i) -> float {
      return logit_at<float, D>(sel, has_cov, gmean + (long long)i * D,
                                gbw + (long long)i * D, glogw + i, i, two_pi,
                                inv_two_pi);
    };

    // pass 1, on `cnt` staged candidates whose first is candidate i0: the
    // max, two candidates a lane in flight
    float mx = ninf;
    auto pass1 = [&](auto nb, const float* tm, const float* tlw,
                     const float* ts, int i0, int cnt) {
      constexpr bool NB = decltype(nb)::value;
      auto cand = [&](int ii, float (&m)[D], float (&s)[D]) {
        load_cand<D>(tm + ii * D, m);
        if constexpr (NB) load_cand<D>(ts + ii * D, s);
      };
      for (int ii = lane; ii < cnt; ii += 64) {
        float m[D], s[D];
        cand(ii, m, s);
        const float l0 = logit_at<float, D>(sel, has_cov, m, s, tlw + ii,
                                            i0 + ii, two_pi, inv_two_pi);
        float l1 = ninf;
        if (ii + 32 < cnt) {
          cand(ii + 32, m, s);
          l1 = logit_at<float, D>(sel, has_cov, m, s, tlw + ii + 32,
                                  i0 + ii + 32, two_pi, inv_two_pi);
        }
        if (l0 > mx) mx = l0;
        if (l1 > mx) mx = l1;
      }
    };

    // pass 2: the exps (their sum in float is the dead test) and, per
    // tile, their float64 sum and the real candidates; a lane adds its
    // candidates in the order the warp layout does, so the sums are its
    // bits
    float ms = 0.0f, sum_t = 0.0f;
    double acc = 0.0;
    int cnt = 0, cur = -1;
    auto flush = [&]() {
      for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, o);
        cnt += __shfl_xor_sync(kFull, cnt, o);
      }
      if (lane == 0) {
        tsum[cur] = acc;
        tcnt[cur] = cnt;
      }
      acc = 0.0;
      cnt = 0;
    };
    auto add = [&](int tau, bool valid, float e, bool real) {
      if (tau != cur) {
        if (cur >= 0) flush();
        cur = tau;
      }
      if (valid) {
        sum_t = sum_t + e;
        acc += (double)e;
        cnt += real ? 1 : 0;
      }
    };
    auto pass2 = [&](auto nb, const float* tm, const float* tlw,
                     const float* ts, int i0, int cnt_) {
      constexpr bool NB = decltype(nb)::value;
      auto exp_of = [&](int ii) -> float {
        float m[D], s[D];
        load_cand<D>(tm + ii * D, m);
        if constexpr (NB) load_cand<D>(ts + ii * D, s);
        return ex(logit_at<float, D>(sel, has_cov, m, s, tlw + ii, i0 + ii,
                                     two_pi, inv_two_pi) - ms);
      };
      auto real = [&](int ii) {
        return K3_CAND(tlw[ii], -(float)((i0 + ii) & 15)) != ninf;
      };
      for (int k0 = 0; k0 < cnt_; k0 += 64) {
        const int ia = k0 + lane, ib = ia + 32;
        float ea = 0.0f, eb = 0.0f;
        bool ra = false, rb = false;
        if (ia < cnt_) {
          ea = exp_of(ia);
          ra = real(ia);
        }
        if (ib < cnt_) {
          eb = exp_of(ib);
          rb = real(ib);
        }
        add((i0 + k0) / tile, ia < cnt_, ea, ra);
        if (k0 + 32 < cnt_) add((i0 + k0 + 32) / tile, ib < cnt_, eb, rb);
      }
    };

    const int nst = (w + kStageCands - 1) / kStageCands;
#ifdef K3_DIAG_PASS2_ONLY
    const int njobs = resident ? 0 : nst;
#else
    const int njobs = resident ? 0 : (kGumbel ? 1 : 2) * nst;
#endif
    // ring job q stages tile q mod nst of the level into slot q mod kStages
    auto copy_job = [&](int q) {
      if (q < njobs) {
        const int i0 = (q % nst) * kStageCands;
        const int cnt = min(kStageCands, w - i0);
        float* sl = stage + (q % kStages) * kSlot;
#ifndef K3_DIAG_NO_LOADS
        const float* gm = gmean + (long long)i0 * D;
        for (int e = threadIdx.x; e < cnt * D; e += blockDim.x)
          cp_async4(sl + e, gm + e);
        for (int e = threadIdx.x; e < cnt; e += blockDim.x)
          cp_async4(sl + kStageCands * D + e, glogw + i0 + e);
        if (need_bw) {
          const float* gb = gbw + (long long)i0 * D;
          for (int e = threadIdx.x; e < cnt * D; e += blockDim.x)
            cp_async4(sl + kStageCands * (D + 1) + e, gb + e);
        }
#endif
      }
      cp_async_commit();
    };
    // the slot of job q once every thread's copies have landed; the
    // barrier also frees the slot of job q - 1 for job q + kStages - 1
    auto arrive = [&](int q) -> const float* {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      copy_job(q + kStages - 1);
      return stage + (q % kStages) * kSlot;
    };
    const float* rm = nullptr;   // the resident level of density j
    if (resident) {
      int off = 0;
      for (int jj = 0; jj < j; ++jj) off += part_floats(jj, l, w);
      rm = stage + off;
    } else {
      __syncthreads();   // the previous selection's slots are free
      for (int q = 0; q < kStages - 1; ++q) copy_job(q);
    }
    const float* rlw = rm + pad4(w * D);
    const float* rs = rlw + pad4(w);
    // each pass over the level: resident, or job by job through the ring
    auto max_pass = [&](auto nb) {
      if (resident) {
#ifndef K3_DIAG_PASS2_ONLY
        pass1(nb, rm, rlw, rs, 0, w);
#endif
        return;
      }
#ifndef K3_DIAG_PASS2_ONLY
      for (int q = 0; q < nst; ++q) {
        const float* sl = arrive(q);
        const int i0 = q * kStageCands;
        pass1(nb, sl, sl + kStageCands * D, sl + kStageCands * (D + 1), i0,
              min(kStageCands, w - i0));
      }
#endif
    };
    auto sum_pass = [&](auto nb) {
      if (resident) {
        pass2(nb, rm, rlw, rs, 0, w);
        return;
      }
      for (int q = njobs - nst; q < njobs; ++q) {
        const float* sl = arrive(q);
        const int i0 = (q - (njobs - nst)) * kStageCands;
        pass2(nb, sl, sl + kStageCands * D, sl + kStageCands * (D + 1), i0,
              min(kStageCands, w - i0));
      }
    };
    if constexpr (kGumbel) {
      // one pass: the logits, the noise, the max and both argmaxes, a lane
      // the two candidates of one generator block at a time (a slot starts
      // at a multiple of kStageCands, so a block's pair shares a slot)
      const kde_rng::Key key = kde_rng::selection_key(
          p.seeds + 2 * b, (unsigned)c, (unsigned)col);
      Best<float> lbest{ninf, -1}, dbest{ninf, -1};
      auto gpass = [&](auto nb, const float* tm, const float* tlw,
                       const float* ts, int i0, int cnt_) {
        constexpr bool NB = decltype(nb)::value;
        for (int ii = 2 * lane; ii < cnt_; ii += 64) {
          float gq[2];
          draw_uniforms<float>(key, (i0 + ii) >> 1, gq);
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int iv = ii + v;
            if (iv < cnt_) {
              float m[D], bwv[D];
              load_cand<D>(tm + iv * D, m);
              if constexpr (NB) load_cand<D>(ts + iv * D, bwv);
              const float lv = logit_at<float, D>(sel, has_cov, m, bwv,
                                                  tlw + iv, i0 + iv, two_pi,
                                                  inv_two_pi);
              gumbel_take<float>(lv, gq[v],
                                 K3_CAND(tlw[iv], -(float)((i0 + iv) & 15))
                                     != ninf,
                                 i0 + iv, mx, lbest, dbest);
            }
          }
        }
      };
      auto gumbel_pass = [&](auto nb) {
        if (resident) {
          gpass(nb, rm, rlw, rs, 0, w);
          return;
        }
        for (int q = 0; q < nst; ++q) {
          const float* sl = arrive(q);
          const int i0 = q * kStageCands;
          gpass(nb, sl, sl + kStageCands * D, sl + kStageCands * (D + 1), i0,
                min(kStageCands, w - i0));
        }
      };
      if (need_bw) gumbel_pass(std::true_type{});
      else gumbel_pass(std::false_type{});
      mx = warp_fmax(mx);
      // the dead test, only where the max is below log(1e-99): the row
      // alone, from L2, in the warp layout's order
      bool is_dead = false;
      if (!(mx >= (float)p.log_dead)) {
        const float m0 = mx == ninf ? 0.0f : mx;
        float st = 0.0f;
        for (int i = lane; i < w; i += 32) st = st + ex(glogit(i) - m0);
        st = group_all<32>(st, SumOp(), (float*)nullptr);
        is_dead = m0 + lg(st) < (float)p.log_dead;
      }
      return group_best<32>(is_dead ? dbest : lbest, (float*)nullptr,
                            (int*)nullptr).i;
    }
    const float uval = U[col];
    if (need_bw) max_pass(std::true_type{}); else max_pass(std::false_type{});
    mx = warp_fmax(mx);
    ms = mx == ninf ? 0.0f : mx;
    if (need_bw) sum_pass(std::true_type{}); else sum_pass(std::false_type{});
    if (cur >= 0) flush();
    for (int o = 16; o > 0; o >>= 1)
      sum_t = sum_t + __shfl_xor_sync(kFull, sum_t, o);
    __syncwarp();
    const bool dead = ms + lg(sum_t) < (float)p.log_dead;
    auto tval = [&](int tau) -> double {
      return dead ? (double)tcnt[tau] : tsum[tau];
    };

    // the tile where the running sum reaches u * sum, then the scan in it
    // with the exps from L2
    double total = 0.0;
    for (int tau = 0; tau < ntiles; ++tau) total += tval(tau);
    const double target = (double)uval * total;
    double off = 0.0;
    int ft = -1;
    for (int tau = 0; tau < ntiles; ++tau) {
      const double next = off + tval(tau);
      if (!(next < target)) { ft = tau; break; }
      off = next;
    }
    if (ft < 0) return w - 1;
    const int tb = ft * tile, te = min(tb + tile, w);
    int z = -1;
    for (int sb2 = tb; z < 0 && sb2 < te; sb2 += 32 * kPer) {
      const int i0 = sb2 + lane * kPer;
      double loc[kPer];
      double run_s = 0.0;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        double qv = 0.0;
        if (i < te) {
          float e;
          if (dead)
            e = K3_CAND(glogw[i], -(float)(i & 15)) != ninf ? 1.0f : 0.0f;
          else
            e = ex(glogit(i) - ms);
          qv = (double)e;
        }
        run_s += qv;
        loc[v] = run_s;
      }
      double sub;
      const double start = off + group_scan<32>(run_s, nullptr, sub);
      int found = 0x7fffffff;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        if (i < te && found == 0x7fffffff && !(start + loc[v] < target))
          found = i;
      }
      found = group_all<32>(found, MinOp(), (int*)nullptr);
      if (found != 0x7fffffff) z = found;
      off = off + sub;
    }
    return z < 0 ? te - 1 : z;
  };

  // the winner's statistics into the selection, masked
  auto pick = [&](int j, int o, int z) {
    const long long sb = b * p.ms_b + j * p.ms_j + (long long)(o + z) * D;
    const float* mean = static_cast<const float*>(p.mean) + sb;
    const float* bw = static_cast<const float*>(p.bw) + sb;
    for (int k = lane; k < D; k += 32) {
      const bool m = mk[j * D + k] != 0;
      mu_sel[j * D + k] = m ? mean[k] : 0.0f;
      var_sel[j * D + k] = m ? bw[k] : 0.0f;
    }
    if (lane == 0) perms[j] = p.perm[b * p.ls_b + j * p.ls_j + o + z];
    __syncwarp();
  };

  const int per_level = (1 + p.n_iter) * dn;
  long long* labels = p.out_labels + row * L * dn;
  for (int l = 0; l < L; ++l) {
    const int o = p.offsets[2 * l], w = p.offsets[2 * l + 1];
    tile = 32 * (((w + kMaxTiles - 1) / kMaxTiles + 31) / 32);
    ntiles = (w + tile - 1) / tile;
    // the level of every density on the stage, for all its selections,
    // where it fits
    int need = 0;
    for (int j = 0; j < dn; ++j) need += part_floats(j, l, w);
    resident = need <= kCap;
#ifdef K3_DIAG_NO_LOADS
    resident = false;
#endif
    if (resident) {
      __syncthreads();   // the stage's last readers are done
      float* dst = stage;
      for (int j = 0; j < dn; ++j) {
        const long long sb = b * p.ms_b + j * p.ms_j + (long long)o * D;
        const float* gm = static_cast<const float*>(p.mean) + sb;
        const float* gb = static_cast<const float*>(p.bw) + sb;
        const float* gl = static_cast<const float*>(p.logw) + b * p.ls_b
                          + j * p.ls_j + o;
        float* dl = dst + pad4(w * D);
        for (int e = threadIdx.x; e < w * D; e += blockDim.x)
          cp_async4(dst + e, gm + e);
        for (int e = threadIdx.x; e < w; e += blockDim.x)
          cp_async4(dl + e, gl + e);
        if (needs_bw(j, l))
          for (int e = threadIdx.x; e < w * D; e += blockDim.x)
            cp_async4(dl + pad4(w) + e, gb + e);
        dst += part_floats(j, l, w);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const int cl = dn + l * per_level;     // the level's first selection
    // (1) x from the product of the current selections
    for (int k = lane; k < D; k += 32)
      xq[k] = prod.point(k, NR + (long long)l * D, true);
    __syncwarp();
    // (2) every density re-selects conditioned on x
    for (int j = 0; j < dn; ++j) pick(j, o, select(j, l, o, w, false, cl + j));
    // (3) n_iter sweeps of leave-one-out Gibbs over the densities
    for (int it = 0; it < p.n_iter; ++it) {
      for (int j = 0; j < dn; ++j) {
        for (int k = lane; k < D; k += 32) prod.dim(k, j, xq[k], cq[k]);
        __syncwarp();
        pick(j, o, select(j, l, o, w, true, cl + dn + it * dn + j));
      }
    }
    if (live)
      for (int j = lane; j < dn; j += 32) labels[l * dn + j] = perms[j];
    __syncwarp();
  }
  // the final draw
  if (live) {
    float* out = static_cast<float*>(p.out_x) + row * D;
    for (int k = lane; k < D; k += 32)
      out[k] = prod.point(k, NR + (long long)L * D, p.add_entropy != 0);
  }
}

template <int D, bool kGumbel>
int launch_staged(const Params& p, cudaStream_t st) {
  auto kern = gibbs_chain_staged<D, kGumbel>;
  const size_t smem = kStagedHead + align16((size_t)stage_floats(D) * 4);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const long long groups = (p.C + kBlockChains - 1) / kBlockChains;
  const long long blocks = (p.rows / p.C) * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, 32 * kBlockChains, smem, st>>>(p, (int)groups);
  return (int)cudaGetLastError();
}

template <bool kGumbel>
int dispatch(const Params& p, int layout, int itemsize, cudaStream_t st) {
  const int d = p.d;
  if (layout == 2) {
    switch (d) {
      case 1: return launch_staged<1, kGumbel>(p, st);
      case 2: return launch_staged<2, kGumbel>(p, st);
      default: return launch_staged<3, kGumbel>(p, st);
    }
  }
  const int group = layout == 0 ? 32 : kCtaThreads;
  if (itemsize == 8)
    return group == 32 ? launch<double, 32, 0, kGumbel>(p, st)
                       : launch<double, kCtaThreads, 0, kGumbel>(p, st);
  // float chains (the keyed paths) at d = 1, 2, 3 take a kernel of that d
  if (group == 32) {
    switch (d) {
      case 1: return launch<float, 32, 1, kGumbel>(p, st);
      case 2: return launch<float, 32, 2, kGumbel>(p, st);
      case 3: return launch<float, 32, 3, kGumbel>(p, st);
      default: return launch<float, 32, 0, kGumbel>(p, st);
    }
  }
  switch (d) {
    case 1: return launch<float, kCtaThreads, 1, kGumbel>(p, st);
    case 2: return launch<float, kCtaThreads, 2, kGumbel>(p, st);
    case 3: return launch<float, kCtaThreads, 3, kGumbel>(p, st);
    default: return launch<float, kCtaThreads, 0, kGumbel>(p, st);
  }
}

}  // namespace

#ifdef K3_DIAG
// One logit a thread at d = D (chip_smoke.py --k3-diag counts its SASS):
// qv holds x, q, c, lc and the flags, D values each.
template <int D>
__global__ void k3_logit_probe(const float* m, const float* bw,
                               const float* lw, const float* qv, float* out,
                               int has_cov) {
  Sel<float, D> s;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    s.x[k] = qv[k];
    s.q[k] = qv[D + k];
    s.c[k] = qv[2 * D + k];
    s.lc[k] = qv[3 * D + k];
    s.f[k] = (unsigned char)qv[4 * D + k];
  }
  const int i = threadIdx.x;
  out[i] = logit_at<float, D>(s, has_cov != 0, m + i * D, bw + i * D, lw + i,
                              i, qv[5 * D], qv[5 * D + 1]);
}
template __global__ void k3_logit_probe<2>(const float*, const float*,
                                           const float*, const float*,
                                           float*, int);

#endif

// Every chain of B sets x C chains (see the header).  itemsize 4 or 8 picks
// float or double; layout 0 is a warp a chain, 1 a block a chain, 2 the
// staged layout (float, d <= 3); gumbel 1 draws from `seeds` (chain c of
// the launch is global chain c), 0 reads `u`.  Strides are in elements.
// Returns the CUDA error of the launch (an argument the kernel does not
// take: cudaErrorInvalidValue).
extern "C" int kde_gibbs_chain(
    int itemsize, int layout, int gumbel,
    const void* t_mean, const void* t_bw, long long ts_b, long long ts_j,
    const void* mean, const void* bw, const void* logw, const long long* perm,
    long long ms_b, long long ms_j, long long ls_b, long long ls_j,
    const int* offsets, const unsigned char* uniform,
    const unsigned char* mask, const unsigned char* codes,
    const void* u, long long us_b, long long us_c, const long long* seeds,
    const void* nrm, long long ns_b, long long ns_c,
    void* out_x, long long* out_labels,
    int B, int C, int dn, int d, int L, int n_iter, int add_entropy,
    double two_pi, double inv_two_pi, double log_dead, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || layout < 0 || layout > 2
      || (layout == 2 && (itemsize != 4 || d > 3))
      || B < 0 || C < 0 || dn < 1 || dn > kMaxDens || d < 1 || d > kMaxDim
      || L < 1 || n_iter < 0 || nrm == nullptr
      || (gumbel ? seeds == nullptr : u == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{t_mean, t_bw, ts_b, ts_j, mean, bw, logw, perm, ms_b, ms_j, ls_b,
           ls_j, offsets, uniform, mask, codes, u, us_b, us_c, seeds, nrm,
           ns_b, ns_c, out_x, out_labels, (long long)B * C, C, dn, d, L,
           n_iter, add_entropy, two_pi, inv_two_pi, log_dead};
  if (p.rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return gumbel ? dispatch<true>(p, layout, itemsize, st)
                : dispatch<false>(p, layout, itemsize, st);
}
