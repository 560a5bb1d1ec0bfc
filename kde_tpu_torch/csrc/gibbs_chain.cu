// The whole multiscale Gibbs chain in one launch, for Hopper (sm_90a): the
// hand kernel behind ops/gibbs_chain.py::gibbs_chain (the port's K3, with
// K2's selection step, csrc/gibbs_select.cu, as its inner step).
//
// It replaces kde_tpu/ops/gibbs.py::_run_chain (:498-651), which the TPU runs
// as one XLA-fused program (the chain has no Pallas kernel), for the flat
// inverse-CDF draw ("cdf").  A group of threads owns one chain (set b,
// chain c) and walks it from the roots to the final draw:
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
// candidates, 0 for padding), and draws the first index whose running sum of
// e_i = exp(l_i - max) (the chain's type, widened to float64) is not below
// u * sum e.  The twin (ops/gibbs_chain.py::gibbs_chain_ref) takes the
// count of entries of cumsum(e / sum e) below u: the two differ only where
// the float64 sums, taken in another order, put a CDF entry within an ulp
// of u.  Every other step is the twin's operation in the twin's order:
// the information-form product (IEEE reciprocals, the sums over densities
// in the order torch's CUDA reduction takes them), sqrtf/sqrt, the circular wrap as torch forms it on the
// card (times the float reciprocal of 2 pi, rint), the first-max anchor of
// circular_mu, logf/log and expf/exp, built with --fmad=false, so points and
// labels are meant to be bitwise the twin's.
//
// What bounds it: per (row, candidate) pair d IEEE divisions, d logs (none
// where the level's bandwidth is uniform in that dim: log c is then taken
// once a selection, bitwise the same value) and an exp, twice (pass 1 finds
// the max, pass 2 the sums), from L2 (a level of both densities sits in the
// 50 MB L2; a uniform dim reads no bandwidth).  The design:
//   * no host step between stages: the chain's state (selections [dn, d],
//     labels [dn], x, mu, cov) stays in shared memory for the whole chain;
//   * a warp a chain (8 chains a 256-thread block) when the launch has
//     chains enough to fill the card or its levels are narrow; a 512-thread
//     block a chain otherwise (the wrapper's launch_plan picks, from the
//     set's chain count and widest level, so a set drawn in a batch runs as
//     it runs alone);
//   * no logits cache and no per-candidate float64 division: pass 1 the
//     max; pass 2 the exps, their sum in the chain's type (the dead test)
//     and fixed-order float64 sums of at most kMaxTiles contiguous tiles;
//     the label from a scan of the tile sums against u * sum, then a scan
//     inside that one tile;
//   * every reduction in a fixed order, so a chain's draw does not depend
//     on the launch it is part of.

#include <cuda_runtime.h>
#include <math.h>

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
  const void* u;             // [B, C, bu] uniforms, last axis contiguous
  long long us_b, us_c;
  const void* nrm;           // [B, C, bn] normals
  long long ns_b, ns_c;
  void* out_x;               // [B, C, d]
  long long* out_labels;     // [B, C, L, dn]
  long long rows;            // B * C
  int C, dn, d, L, n_iter, add_entropy;
  double two_pi, inv_two_pi, log_dead;
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
// At most 64 registers a thread: 4 blocks (32 warps) an SM on the warp
// layout, 2 on the block layout; more registers and fewer warps measured
// slower on the card.
template <typename T, int G, int D>
__global__ void __launch_bounds__(G == 32 ? 32 * kWarpChains : G,
                                  G == 32 ? 4 : 2)
gibbs_chain_kernel(const Params p) {
  constexpr int R = G == 32 ? kWarpChains : 1;      // chains a block
  constexpr int W = G / 32;                          // warps a chain
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_d[kMaxWarps];
  __shared__ T s_t[kMaxWarps];
  __shared__ int s_i[kMaxWarps];

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
  auto circ_diff = [&](T a, T r) -> T {
    const T dl = a - r;
    const T q = dl * inv_two_pi;
    return dl - two_pi * rnd(q);
  };
  auto circ_add = [&](T a, T s) -> T {
    const T x = a + s;
    const T q = x * inv_two_pi;
    return x - two_pi * rnd(q);
  };

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

  const T* U = static_cast<const T*>(p.u) + b * p.us_b + c * p.us_c;
  const T* NR = static_cast<const T*>(p.nrm) + b * p.ns_b + c * p.ns_c;

  // A sum over the densities in the order torch's CUDA reduction takes.
  // Not on the fastest-striding dim (the unhooked [B, C, dn, d] sums with
  // d > 1): one thread, the j-th term into accumulator j % 4, then
  // ((a0 + a1) + a2) + a3.  On it (d = 1, and every hooked sum: a dim-k
  // slice or a fresh [B, C, dn] product): last_pow2(dn) lanes, lane t
  // adding terms t and t + lanes the same way, then a shuffle tree at
  // offsets lanes / 2, ..., 2, 1.
  bool hooked = false;
  for (int k = 0; k < d; ++k) hooked = hooked || p.codes[k] != 0;
  const bool tree = hooked || d == 1;
  auto dn_sum = [&](auto term) -> T {
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
  };

  // _gauss_product for dim k leaving out `skip` (-1: none): mean and cov
  auto product_dim = [&](int k, int skip, T& m_out, T& c_out) {
    bool has = false;
    for (int j = 0; j < dn; ++j) has = has || (mk[j * d + k] && j != skip);
    auto lam_of = [&](int j) -> T {
      const T v = var_sel[j * d + k];
      return (mk[j * d + k] && j != skip && v > zero) ? (T)1 / v : zero;
    };
    const T lt = dn_sum(lam_of);
    const T cov = has ? (T)1 / lt : zero;
    c_out = cov;
    if (p.codes[k] == 0) {
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
        return circ_diff(mu_sel[j * d + k], ref) * lam_of(j);
      });
      m_out = circ_add(ref, cov * s);
    }
  };

  // _sample_point: the product of every selection, then the step
  auto sample_point = [&](const T* normals, bool jitter, T* out) {
    for (int k = t; k < d; k += G) {
      T m, cv;
      product_dim(k, -1, m, cv);
      T x = m;
      if (jitter) {
        const T step = sq_root(cv) * normals[k];
        x = p.codes[k] ? circ_add(m, step) : m + step;
      }
      out[k] = x;
    }
  };

  // one selection of density j at level l against N(xq, bw (+ cq)); returns
  // the candidate index, the same on every thread of the group
  auto select = [&](int j, int l, int o, int w, bool has_cov, T uval) -> int {
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
    constexpr int DR = D > 0 ? D : 1;
    T rx[DR], rq[DR], rc[DR], rl[DR];
    unsigned char rf[DR];
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        rx[k] = xq[k];
        rq[k] = cq[k];
        rc[k] = cc[k];
        rl[k] = lc[k];
        rf[k] = fl[k];
      }
    }

    auto logit = [&](int i) -> T {
      const T* m = mean + (long long)i * d;
      const T* s = bw + (long long)i * d;
      T acc = zero;
#pragma unroll (D > 0 ? D : 1)
      for (int k = 0; k < d; ++k) {
        const unsigned char f = D > 0 ? rf[k] : fl[k];
        if (!(f & 1)) continue;
        const T qk = D > 0 ? rx[k] : xq[k];
        T cv, lcv;
        if (f & 4) {
          cv = D > 0 ? rc[k] : cc[k];
          lcv = D > 0 ? rl[k] : lc[k];
        } else {
          cv = s[k];
          if (has_cov) cv = cv + (D > 0 ? rq[k] : cq[k]);
          lcv = lg(cv);
        }
        const T dl = (f & 2) ? circ_diff(m[k], qk) : m[k] - qk;
        const T sq = dl * dl;
        const T quad = sq / cv;
        T pd = quad + lcv;
        if (isnan(pd)) pd = zero;
        acc = acc + pd;
      }
      const T half = (T)0.5 * acc;
      T lv = logw[i] - half;
      if (isnan(lv)) lv = neg_inf<T>();
      return lv;
    };

    // pass 1: the max, two candidates a step for the loads in flight
    T mx = neg_inf<T>();
    for (int i = t; i < w; i += 2 * G) {
      const T l0 = logit(i);
      const T l1 = i + G < w ? logit(i + G) : neg_inf<T>();
      if (l0 > mx) mx = l0;
      if (l1 > mx) mx = l1;
    }
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
        cnt += logw[i] == neg_inf<T>() ? 0 : 1;
        if (two) {
          const T e1 = ex(l1 - ms);
          sum_t = sum_t + e1;
          acc += (double)e1;
          cnt += logw[i + G] == neg_inf<T>() ? 0 : 1;
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
          if (dead) e = logw[i] == neg_inf<T>() ? zero : (T)1;
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
    const T* ul = U + dn + (long long)l * per_level;
    // (1) x from the product of the current selections
    sample_point(NR + (long long)l * d, true, xq);
    group_sync<G>();
    // (2) every density re-selects conditioned on x
    for (int j = 0; j < dn; ++j) pick(j, o, select(j, l, o, w, false, ul[j]));
    // (3) n_iter sweeps of leave-one-out Gibbs over the densities
    for (int it = 0; it < p.n_iter; ++it) {
      for (int j = 0; j < dn; ++j) {
        for (int k = t; k < d; k += G) product_dim(k, j, xq[k], cq[k]);
        group_sync<G>();
        pick(j, o, select(j, l, o, w, true, ul[dn + it * dn + j]));
      }
    }
    for (int j = t; j < dn; j += G) labels[l * dn + j] = perms[j];
    group_sync<G>();
  }
  // the final draw
  sample_point(NR + (long long)L * d, p.add_entropy != 0,
               static_cast<T*>(p.out_x) + row * d);
}

template <typename T, int G, int D>
int launch(const Params& p, cudaStream_t st) {
  auto kern = gibbs_chain_kernel<T, G, D>;
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

}  // namespace

// Every chain of B sets x C chains (see the header).  itemsize 4 or 8 picks
// float or double; strides are in elements.  Returns the CUDA error of the
// launch (an argument the kernel does not take: cudaErrorInvalidValue).
extern "C" int kde_gibbs_chain(
    int itemsize, int group,
    const void* t_mean, const void* t_bw, long long ts_b, long long ts_j,
    const void* mean, const void* bw, const void* logw, const long long* perm,
    long long ms_b, long long ms_j, long long ls_b, long long ls_j,
    const int* offsets, const unsigned char* uniform,
    const unsigned char* mask, const unsigned char* codes,
    const void* u, long long us_b, long long us_c,
    const void* nrm, long long ns_b, long long ns_c,
    void* out_x, long long* out_labels,
    int B, int C, int dn, int d, int L, int n_iter, int add_entropy,
    double two_pi, double inv_two_pi, double log_dead, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || (group != 32 && group != kCtaThreads)
      || B < 0 || C < 0 || dn < 1 || dn > kMaxDens || d < 1 || d > kMaxDim
      || L < 1 || n_iter < 0 || u == nullptr || nrm == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{t_mean, t_bw, ts_b, ts_j, mean, bw, logw, perm, ms_b, ms_j, ls_b,
           ls_j, offsets, uniform, mask, codes, u, us_b, us_c, nrm, ns_b, ns_c,
           out_x, out_labels, (long long)B * C, C, dn, d, L, n_iter,
           add_entropy, two_pi, inv_two_pi, log_dead};
  if (p.rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (itemsize == 8)
    return group == 32 ? launch<double, 32, 0>(p, st)
                       : launch<double, kCtaThreads, 0>(p, st);
  // float chains (the keyed paths) at d = 1, 2, 3 take a kernel of that d
  if (group == 32) {
    switch (d) {
      case 1: return launch<float, 32, 1>(p, st);
      case 2: return launch<float, 32, 2>(p, st);
      case 3: return launch<float, 32, 3>(p, st);
      default: return launch<float, 32, 0>(p, st);
    }
  }
  switch (d) {
    case 1: return launch<float, kCtaThreads, 1>(p, st);
    case 2: return launch<float, kCtaThreads, 2>(p, st);
    case 3: return launch<float, kCtaThreads, 3>(p, st);
    default: return launch<float, kCtaThreads, 0>(p, st);
  }
}
