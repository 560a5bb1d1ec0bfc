// One selection step of the multiscale Gibbs chain, for Hopper (sm_90a):
// the hand kernel behind ops/gibbs_select.py::gibbs_select.
//
// It replaces the part of kde_tpu/ops/gibbs.py::_run_chain that XLA fuses on
// the TPU (no Pallas kernel there): _kernel_logits_raw (:267-282),
// _dead_predicate (:290-308), _apply_dead_fallback (:311-319), then
// _select_label (:335-354) or the Gumbel-max draw of _select_label_gumbel
// (:400-414), then select_stats (:557-564).  A row is one (set b, chain c,
// density j) of the launch; for its level's w candidates i it computes
//
//   l_i = logw_i - 1/2 sum_{k active} [delta_ik^2 / c_ik + log c_ik],
//   c_ik = bw_ik (+ cov_k),  delta_ik = mean_ik - mu_k (wrapped: circular)
//
// (a NaN dim gives 0, a NaN logit -inf), the degenerate test
// max + log sum exp(l - max) < log(1e-99) (an all -inf row is dead) with
// its fallback (0 for real candidates, -inf for padding), then the label
//
//   cdf:    the count of i with cdf_i < u, clamped to [0, w - 1], where
//           cdf is the float64 running sum of exp(l_i - max) / s, the exps in
//           the chain's type widened to float64 and s their float64 sum;
//   gumbel: argmax_i l_i - log(-log g_i), the first index winning ties, g
//           the counter draw of csrc/counter_rng.cuh for the set's seed,
//           the row's global chain index and selection id and candidate i
//           (a pure function of the four, so the draw depends on no block
//           or launch; ops/gibbs.py::_gumbel_noise is its twin);
//
// and writes the winner's mean, variance and permutation label.  Every
// step is the twin's operation in the twin's order (built with
// --fmad=false, CUDA's logf/expf and log/exp, IEEE division; the circular
// wrap multiplies by the reciprocal of 2 pi as torch does for a scalar
// divisor on the card), so the logits are meant to be bitwise the twin's;
// only the sums are taken in another order.
//
// What bounds it: per candidate d logs and d divisions and, for cdf, one
// exp and a float64 division on the part of the row the scan reaches, for
// gumbel two logs and the generator's integer work (a Threefry block gives
// two float candidates); the FP32 and INT32 pipes and the SFU, not bytes
// (a row's candidates are read from L2).  The design, simple first:
//   * a row on one warp (8 rows a 256-thread block) for narrow levels, on
//     one 512-thread block for wide ones (the wrapper's launch_plan picks);
//   * pass 1 computes the logits, their max and (gumbel) both argmaxes, the
//     live one and the dead-fallback one, drawing the noise as it goes, a
//     thread the candidates of one generator block at a time; the logits
//     go to dynamic shared memory when the wrapper says they fit (cache),
//     and are recomputed in the later passes otherwise;
//   * pass 2 sums the exps for the degenerate test (in the chain's type, as
//     the twin) and, for cdf, in float64 for the normaliser.  Gumbel takes
//     it only on rows whose max is below log(1e-99): the sum holds
//     exp(0) = 1 and no negative term, so its log is >= 0 and a row whose
//     max reaches the threshold is live in any rounding;
//   * pass 3 (cdf) scans tiles of G x kPer candidates in index order, a
//     thread's kPer consecutive ones in registers, the threads' sums by a
//     shuffle scan; it stops at the tile where the CDF reaches u.
// All reductions run in a fixed order, so a row's label does not depend on
// the launch it is part of.  The candidate logit and the row reductions
// live in gibbs_logit.cuh, shared with csrc/sharded_select.cu (K6).

#include <cuda_runtime.h>
#include <math.h>

#include "counter_rng.cuh"
#include "gibbs_logit.cuh"

namespace {

using kde_gibbs::ex;
using kde_gibbs::group_all;
using kde_gibbs::group_scan;
using kde_gibbs::group_sync;
using kde_gibbs::kFull;
using kde_gibbs::lg;
using kde_gibbs::MaxOp;
using kde_gibbs::MinOp;
using kde_gibbs::neg_inf;
using kde_gibbs::SumOp;

constexpr int kWarpRows = 8;          // rows of a 256-thread block, warp route
constexpr int kCtaThreads = 512;      // threads of a block, block route
constexpr int kMaxWarps = kCtaThreads / 32;
constexpr int kPer = 4;               // consecutive candidates a thread scans
// dynamic shared memory a block may opt in to, under the card's 227 KB
// less the static reduction scratch
constexpr int kMaxSmem = 226 * 1024;

struct Params {
  const void* mean;          // [B, dn, w, d] level slices, strides below
  const void* bw;
  const void* logw;          // [B, dn, w]
  const long long* perm;     // [B, dn, w]
  long long ms_b, ms_j;      // mean/bw strides of the set and density axes
  long long ls_b, ls_j;      // logw/perm strides
  const void* mu;            // [B, C, d]
  const void* cov;           // [B, C, d] or null
  const unsigned char* active;   // [B, dn, d] bool
  const unsigned char* codes;    // [d]: 0 Euclidean, 1 circular
  const void* u;             // [B, C, J] (cdf)
  const long long* seeds;    // [B, 2] counter seeds (gumbel)
  long long chain0, sel0;    // global index of chain 0, id of selection j0
  void* out_mean;            // [B, C, J, d]
  void* out_var;
  long long* out_label;      // [B, C, J]
  long long rows;            // B * C * J
  int C, J, j0, dn, w, d, cache;
  double two_pi, inv_two_pi, log_dead;
};

// ---- the argmax over a row's group of G threads (gumbel) -----------

// (value, index) argmax over the group: the larger value, on a tie the
// smaller index; index -1 holds nothing.
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

// ---- the kernel ---------------------------------------------------------

template <typename T, int G, bool kGumbel>
__global__ void __launch_bounds__(G == 32 ? 32 * kWarpRows : G)
gibbs_select_kernel(const Params p) {
  constexpr int R = G == 32 ? kWarpRows : 1;      // rows a block
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_d[kMaxWarps];
  __shared__ T s_t[kMaxWarps];
  __shared__ T s_v[kMaxWarps];
  __shared__ int s_i[kMaxWarps];

  const int g = threadIdx.x / G;                   // the block's row
  const int t = threadIdx.x % G;                   // thread of the row
  const long long row = (long long)blockIdx.x * R + g;
  if (row >= p.rows) return;                       // warp route only
  const int w = p.w, d = p.d;
  const int jj = (int)(row % p.J);
  const long long bc = row / p.J;
  const long long b = bc / p.C, c = bc % p.C;
  const int j = p.j0 + jj;

  // shared memory: per row mu[d], cov[d], cache[w or 0] (T), then flags[d]
  const int cw = p.cache ? w : 0;
  T* qmu = reinterpret_cast<T*>(smem) + (size_t)g * (2 * d + cw);
  T* qcov = qmu + d;
  T* cache = qcov + d;
  unsigned char* flags = smem + (size_t)R * (2 * d + cw) * sizeof(T)
                         + (size_t)g * d;

  const T* mean = static_cast<const T*>(p.mean) + b * p.ms_b + j * p.ms_j;
  const T* bw = static_cast<const T*>(p.bw) + b * p.ms_b + j * p.ms_j;
  const T* logw = static_cast<const T*>(p.logw) + b * p.ls_b + j * p.ls_j;
  const long long* perm = p.perm + b * p.ls_b + j * p.ls_j;
  const bool has_cov = p.cov != nullptr;
  for (int k = t; k < d; k += G) {
    qmu[k] = static_cast<const T*>(p.mu)[bc * d + k];
    qcov[k] = has_cov ? static_cast<const T*>(p.cov)[bc * d + k] : (T)0;
    flags[k] = (unsigned char)((p.active[(b * p.dn + j) * d + k] ? 1 : 0)
                               | (p.codes[k] ? 2 : 0));
  }
  group_sync<G>();

  const T two_pi = (T)p.two_pi, inv_two_pi = (T)p.inv_two_pi;
  // _kernel_logits_raw of candidate i, step for step (gibbs_logit.cuh)
  auto logit = [&](int i) -> T {
    return kde_gibbs::candidate_logit<T>(
        mean + (long long)i * d, bw + (long long)i * d, logw[i], qmu, qcov,
        has_cov, flags, d, two_pi, inv_two_pi);
  };

  // pass 1: logits, their max; gumbel: the live and dead argmaxes
  T mx = neg_inf<T>();
  int nreal = 0;
  Best<T> live{neg_inf<T>(), -1}, dead_best{neg_inf<T>(), -1};
  if constexpr (kGumbel) {
    using U = kde_rng::Uniform<T>;
    const kde_rng::Key key = kde_rng::selection_key(
        p.seeds + 2 * b, (unsigned)(p.chain0 + c), (unsigned)(p.sel0 + jj));
    for (int q = t; q * U::kPer < w; q += G) {
      T g[U::kPer];
      U::draw(key, q, g);
#pragma unroll
      for (int v = 0; v < U::kPer; ++v) {
        const int i = q * U::kPer + v;
        if (i < w) {
          const T l = logit(i);
          if (p.cache) cache[i] = l;
          if (l > mx) mx = l;
          const T gn = lg(-lg(g[v]));
          const T lv = l - gn;
          if (live.i < 0 || lv > live.v) live = Best<T>{lv, i};
          const T vd = logw[i] == neg_inf<T>() ? neg_inf<T>() : (T)0 - gn;
          if (dead_best.i < 0 || vd > dead_best.v) dead_best = Best<T>{vd, i};
        }
      }
    }
  } else {
    for (int i = t; i < w; i += G) {
      const T l = logit(i);
      if (p.cache) cache[i] = l;
      if (l > mx) mx = l;
      nreal += logw[i] == neg_inf<T>() ? 0 : 1;
    }
  }
  mx = group_all<G>(mx, MaxOp(), s_t);
  const T ms = mx == neg_inf<T>() ? (T)0 : mx;
  auto lval = [&](int i) -> T { return p.cache ? cache[i] : logit(i); };

  // pass 2: the degenerate test; cdf also takes the float64 normaliser.
  // Gumbel skips it where the max reaches log(1e-99) (see the header).
  bool dead = false;
  double sum_d = 0.0;
  if (!kGumbel || !(mx >= (T)p.log_dead)) {
    if constexpr (kGumbel) group_sync<G>();   // pass 1 cached others' i
    T sum_t = (T)0;
    for (int i = t; i < w; i += G) {
      const T e = ex(lval(i) - ms);
      sum_t = sum_t + e;
      if constexpr (!kGumbel) sum_d += (double)e;
    }
    sum_t = group_all<G>(sum_t, SumOp(), s_t);
    dead = ms + lg(sum_t) < (T)p.log_dead;
  }

  int z;
  if constexpr (kGumbel) {
    const Best<T> pick = dead ? dead_best : live;
    z = group_best<G>(pick, s_v, s_i).i;   // `dead` is the same on every thread
  } else {
    sum_d = group_all<G>(sum_d, SumOp(), s_d);
    nreal = group_all<G>(nreal, SumOp(), s_i);
    const double u = (double)static_cast<const T*>(p.u)[row];
    const T m2 = dead ? (nreal > 0 ? (T)0 : neg_inf<T>()) : mx;
    const double s = dead ? (double)nreal : sum_d;
    z = -1;
    if (dead && nreal == 0) z = 0;   // the twin's CDF is NaN: no entry < u
    group_sync<G>();                 // the scan reads other threads' logits
    // pass 3: the scan, tile by tile, up to the tile that reaches u
    double off = 0.0;
    for (int base = 0; z < 0 && base < w; base += G * kPer) {
      const int i0 = base + t * kPer;
      double loc[kPer];
      double run = 0.0;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        double q = 0.0;
        if (i < w) {
          T e;
          if (dead) e = logw[i] == neg_inf<T>() ? (T)0 : (T)1;
          else e = ex(lval(i) - m2);
          q = (double)e / s;
        }
        run += q;
        loc[v] = run;
      }
      double total;
      const double start = off + group_scan<G>(run, s_d, total);
      int found = 0x7fffffff;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        if (i < w && found == 0x7fffffff && start + loc[v] >= u) found = i;
      }
      found = group_all<G>(found, MinOp(), s_i);
      if (found != 0x7fffffff) z = found;
      off = off + total;
    }
    if (z < 0 || z > w - 1) z = w - 1;
  }

  // the winner's mean, variance and label
  T* om = static_cast<T*>(p.out_mean) + row * d;
  T* ov = static_cast<T*>(p.out_var) + row * d;
  for (int k = t; k < d; k += G) {
    om[k] = mean[(long long)z * d + k];
    ov[k] = bw[(long long)z * d + k];
  }
  if (t == 0) p.out_label[row] = perm[z];
}

size_t smem_bytes(int group, int cache, int w, int d, size_t item) {
  const size_t rows = group == 32 ? kWarpRows : 1;
  return rows * ((2 * (size_t)d + (cache ? (size_t)w : 0)) * item + d);
}

template <typename T, int G, bool kGumbel>
int launch(const Params& p, size_t smem, cudaStream_t st) {
  auto kern = gibbs_select_kernel<T, G, kGumbel>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const long long rows_a_block = G == 32 ? kWarpRows : 1;
  const long long blocks = (p.rows + rows_a_block - 1) / rows_a_block;
  const int threads = G == 32 ? 32 * kWarpRows : G;
  kern<<<(unsigned)blocks, threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int gumbel, int group, size_t smem,
             cudaStream_t st) {
  if (group == 32)
    return gumbel ? launch<T, 32, true>(p, smem, st)
                  : launch<T, 32, false>(p, smem, st);
  return gumbel ? launch<T, kCtaThreads, true>(p, smem, st)
                : launch<T, kCtaThreads, false>(p, smem, st);
}

}  // namespace

// One selection step of B * C * J rows (see the header).  itemsize 4 or 8
// picks float or double; gumbel 1 draws from `seeds` (chain c of the launch
// is global chain chain0 + c, density j0 + jj selection sel0 + jj), 0 reads
// `u`; group is 32 (a warp a row) or 512 (a block a row), cache 1 keeps the
// row's logits in shared memory.  Strides are in elements.  Returns the CUDA error of the
// launch (an argument the kernel does not take: cudaErrorInvalidValue).
extern "C" int kde_gibbs_select(
    int itemsize, int gumbel, int group, int cache,
    const void* mean, const void* bw, const void* logw, const long long* perm,
    long long ms_b, long long ms_j, long long ls_b, long long ls_j,
    const void* mu, const void* cov, const unsigned char* active,
    const unsigned char* codes, const void* u, const long long* seeds,
    long long chain0, long long sel0, void* out_mean, void* out_var,
    long long* out_label,
    int B, int C, int J, int j0, int dn, int w, int d,
    double two_pi, double inv_two_pi, double log_dead, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || (group != 32 && group != kCtaThreads)
      || B < 0 || C < 0 || J < 1 || j0 < 0 || j0 + J > dn || w < 1 || d < 1
      || (gumbel ? seeds == nullptr : u == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(group, cache, w, d, (size_t)itemsize);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{mean, bw, logw, perm, ms_b, ms_j, ls_b, ls_j, mu, cov, active,
           codes, u, seeds, chain0, sel0, out_mean, out_var, out_label,
           (long long)B * C * J, C, J, j0, dn, w, d, cache,
           two_pi, inv_two_pi, log_dead};
  if (p.rows == 0) return 0;
  const long long rows_a_block = group == 32 ? kWarpRows : 1;
  if ((p.rows + rows_a_block - 1) / rows_a_block > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return itemsize == 4 ? dispatch<float>(p, gumbel, group, smem, st)
                       : dispatch<double>(p, gumbel, group, smem, st);
}
