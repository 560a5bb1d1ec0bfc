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
// only the sums are taken in another order.  cdf takes c and log c once a
// row on the dims where the wrapper flags the level's bandwidth uniform
// (gibbs_logit.cuh's row_logit: the same values, bit for bit); gumbel
// issues candidate_logit on every dim.
//
// What bounds it: per candidate d divisions and, on the varied dims, d
// logs; for cdf one exp and a float64 division on the part of the row the
// scan reaches, for gumbel two logs and the generator's integer work (a
// Threefry block gives two float candidates); the FP32 and INT32 pipes and
// the SFU, not bytes.  Three layouts (the wrapper's launch_plan picks):
//
//   * warp: a row on one warp (8 rows a 256-thread block), for levels of
//     up to 1,024 candidates; block: a row on one 512-thread block, for
//     wide levels with few rows, and for gumbel.  Pass 1 computes the
//     logits, their max and (gumbel) both argmaxes, the live one and the
//     dead-fallback one, drawing the noise as it goes; the logits go to
//     dynamic shared memory when the wrapper says they fit (cache), and
//     are recomputed in the later passes otherwise.  Pass 2 sums the exps
//     for the degenerate test (in the chain's type, as the twin) and, for
//     cdf, in float64 for the normaliser; gumbel takes it only on rows
//     whose max is below log(1e-99) (the sum holds exp(0) = 1 and no
//     negative term, so a row whose max reaches the threshold is live in
//     any rounding).  Pass 3 (cdf) scans tiles of G x kPer candidates in
//     index order and stops at the tile where the CDF reaches u.
//   * tiles (cdf, wide levels with many rows): a block holds R rows of one
//     (set, density), a warp a row, and streams the level through shared
//     memory by a cp.async ring of kStages slots, so a candidate leaves L2
//     once a block, not once a row; a stage without cov (conditioning)
//     takes the logs of the slot's bandwidths once a block, not once a
//     row (staged_logit, bitwise row_logit).  Pass 1 takes the logits,
//     the row max and the count of real candidates; pass 2 the float32
//     sum of the dead test and the float64 exp sums of each chunk of the
//     level (whole slots), kept per (row, chunk) in shared memory; it
//     recomputes the logits from the ring (the rows' logits do not fit on
//     the chip: 80 KB a row at 20,000 float32 candidates).  Pass 3, on the
//     row's warp alone: the chunk where the CDF first reaches u, from the
//     chunk sums in chunk
//     order, then a warp-local scan (and division) of that chunk only, in
//     index order, from that chunk's prefix; where the chunk's own running
//     sum, taken in another order, stays below u, the count is the chunk's
//     end -- a float64 tie at the chunk boundary.  A dead row scans its
//     real candidates from index 0.  A block owns its rows from the first
//     pass to the winner's stats: no cross-block combine, one launch.
//
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
using kde_gibbs::row_logit;
using kde_gibbs::RowQ;
using kde_gibbs::SumOp;

constexpr int kWarpRows = 8;          // rows of a 256-thread block, warp route
constexpr int kCtaThreads = 512;      // threads of a block, block route
constexpr int kMaxWarps = kCtaThreads / 32;
constexpr int kPer = 4;               // consecutive candidates a thread scans
// dynamic shared memory a block may opt in to, under the card's 227 KB
// less the static reduction scratch
constexpr int kMaxSmem = 226 * 1024;
constexpr int kTileThreads = 512;     // threads of a tile block at most
constexpr int kStages = 3;            // ring slots of a tile block
constexpr int kInFlight = 4;          // a thread's candidates at a time
constexpr int kMaxChunks = 64;        // chunks of the CDF search a row
constexpr int kNone = 0x7fffffff;

enum Layout { kWarp = 0, kBlock = 1, kTiles = 2 };

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
  const unsigned char* uniform;  // [B, dn, d]: bandwidth uniform, or null
  const void* u;             // [B, C, J] (cdf)
  const long long* seeds;    // [B, 2] counter seeds (gumbel)
  long long chain0, sel0;    // global index of chain 0, id of selection j0
  void* out_mean;            // [B, C, J, d]
  void* out_var;
  long long* out_label;      // [B, C, J]
  long long rows;            // B * C * J
  int C, J, j0, dn, w, d, cache;
  int R, chunk, chunks, slot;      // tiles: rows a block, the chunk and
                                   // ring slot in candidates
  double two_pi, inv_two_pi, log_dead;
};

// Row (b, c, j)'s constants for row_logit (gibbs_logit.cuh).  D > 0: every
// thread its own copy in registers.  D == 0: threads t < d of the row's
// group of G write them to the row's shared memory q ([4][d] T: mu, cov,
// c, log c) and f ([d]); the caller makes them visible with a barrier.
// bw0 is the slab's first bandwidth row; c and log c are taken from it on
// the dims flagged uniform (gumbel passes no flags: every dim varied).
template <typename T, int D>
__device__ __forceinline__ void row_consts(RowQ<T, D>& r, const Params& p,
                                           long long b, long long bc, int j,
                                           const T* bw0, T* q,
                                           unsigned char* f, int t, int G) {
  const int d = D > 0 ? D : p.d;
  const bool has_cov = p.cov != nullptr;
  const long long a0 = (b * p.dn + j) * d;
  auto one = [&](int k, T& x, T& qq, T& cc, T& lc, unsigned char& fl) {
    const bool act = p.active[a0 + k] != 0;
    const bool un = p.uniform != nullptr && p.uniform[a0 + k] != 0;
    x = static_cast<const T*>(p.mu)[bc * d + k];
    qq = has_cov ? static_cast<const T*>(p.cov)[bc * d + k] : (T)0;
    T c0 = bw0[k];
    if (has_cov) c0 = c0 + qq;
    cc = c0;
    lc = un ? lg(c0) : (T)0;
    fl = (unsigned char)((act ? 1 : 0) | (p.codes[k] ? 2 : 0) | (un ? 4 : 0));
  };
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k)
      one(k, r.x[k], r.q[k], r.c[k], r.lc[k], r.f[k]);
  } else {
    for (int k = t; k < d; k += G)
      one(k, q[k], q[d + k], q[2 * d + k], q[3 * d + k], f[k]);
    r = RowQ<T, 0>{q, q + d, q + 2 * d, q + 3 * d, f, d};
  }
}

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

// ---- the warp and block layouts ----------------------------------------

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

  // shared memory: per row the constants [4][d] and the cache [w or 0]
  // (T), then flags [d]
  const int cw = p.cache ? w : 0;
  T* qsm = reinterpret_cast<T*>(smem) + (size_t)g * (4 * d + cw);
  T* cache = qsm + 4 * d;
  unsigned char* flags = smem + (size_t)R * (4 * d + cw) * sizeof(T)
                         + (size_t)g * d;

  const T* mean = static_cast<const T*>(p.mean) + b * p.ms_b + j * p.ms_j;
  const T* bw = static_cast<const T*>(p.bw) + b * p.ms_b + j * p.ms_j;
  const T* logw = static_cast<const T*>(p.logw) + b * p.ls_b + j * p.ls_j;
  const long long* perm = p.perm + b * p.ls_b + j * p.ls_j;
  const bool has_cov = p.cov != nullptr;
  RowQ<T, 0> rq;
  row_consts<T, 0>(rq, p, b, bc, j, bw, qsm, flags, t, G);
  group_sync<G>();

  const T two_pi = (T)p.two_pi, inv_two_pi = (T)p.inv_two_pi;
  // _kernel_logits_raw of candidate i, step for step (gibbs_logit.cuh)
  auto logit = [&](int i) -> T {
    if constexpr (kGumbel)
      return kde_gibbs::candidate_logit<T>(
          mean + (long long)i * d, bw + (long long)i * d, logw[i], rq.x,
          rq.q, has_cov, flags, d, two_pi, inv_two_pi);
    else
      return row_logit<T, 0>(rq, mean + (long long)i * d,
                             bw + (long long)i * d, logw[i], has_cov,
                             two_pi, inv_two_pi);
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
      int found = kNone;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        if (i < w && found == kNone && start + loc[v] >= u) found = i;
      }
      found = group_all<G>(found, MinOp(), s_i);
      if (found != kNone) z = found;
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

// ---- the tile layout (cdf) ---------------------------------------------

template <typename T>
__device__ __forceinline__ void cp_async_el(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
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

// row_logit (gibbs_logit.cuh) of a row without cov whose varied dims take
// log c from lcs[k], lg of the candidate's bandwidth taken once a block:
// the same values in the same order, so the logit is bitwise row_logit's.
template <typename T, int D>
__device__ __forceinline__ T staged_logit(const RowQ<T, D>& r, const T* m,
                                          const T* s, const T* lcs, T logw,
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
      lc = lcs[k];
    }
    T dl = m[k] - r.X(k);
    if (f & 2) {
      const T q = dl * inv_two_pi;
      const T rr = two_pi * kde_gibbs::rnd(q);
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

// Dynamic shared memory of a tile block (the wrapper's launch_plan counts
// the same): the chunk sums [R][chunks] double, the ring of kStages slots
// of slot x (3d + 1) T (means, log weights, bandwidths and their logs),
// then for a d not known at compile time the rows' constants [R][4][d] T
// and flags [R][d].
size_t tile_smem(int R, int chunks, int slot, int d, size_t item,
                 bool generic) {
  return (size_t)R * chunks * 8
         + (size_t)kStages * slot * (3 * d + 1) * item
         + (generic ? (size_t)R * (4 * d * item + d) : 0);
}

// Blocks of a tile launch walk (set, density) slabs in order, each slab's
// row tiles of R chains (chains past C only copy), so the blocks in flight
// share their slab in L2.  blockDim.x = 32 R.
template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads, sizeof(T) == 4 ? 2 : 1)
k2_tiles(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tps = ((long long)p.C + p.R - 1) / p.R;   // tiles a slab
  const long long slab = blockIdx.x / tps;                  // b * J + jj
  const long long c_real = (blockIdx.x % tps) * p.R + warp;
  const bool live = c_real < p.C;
  const long long c = live ? c_real : p.C - 1;
  const long long b = slab / p.J;
  const int jj = (int)(slab % p.J), j = p.j0 + jj;
  const long long bc = b * p.C + c, row = bc * p.J + jj;
  const int w = p.w, d = D > 0 ? D : p.d;
  const T* gmean = static_cast<const T*>(p.mean) + b * p.ms_b + j * p.ms_j;
  const T* gbw = static_cast<const T*>(p.bw) + b * p.ms_b + j * p.ms_j;
  const T* glogw = static_cast<const T*>(p.logw) + b * p.ls_b + j * p.ls_j;
  const bool has_cov = p.cov != nullptr;
  const T two_pi = (T)p.two_pi, inv_two_pi = (T)p.inv_two_pi;

  const int S = p.slot, slot_el = S * (3 * d + 1);
  double* part = reinterpret_cast<double*>(smem);
  T* ring = reinterpret_cast<T*>(part + (size_t)p.R * p.chunks);
  T* head = ring + (size_t)kStages * slot_el;
  unsigned char* fsm = reinterpret_cast<unsigned char*>(head + p.R * 4 * d)
                       + warp * d;
  RowQ<T, D> rq;
  row_consts<T, D>(rq, p, b, bc, j, gbw, head + warp * 4 * d, fsm, lane, 32);

  // does the ring need the bandwidths (an active dim whose bandwidth
  // varies)?  The same for every row of the block: one slab.  Without
  // cov, c is the bandwidth itself, so the block takes its logs once a
  // slot (stage_lc) for all its rows.
  bool need_bw = false;
  for (int k = 0; k < d; ++k) {
    const long long a = (b * p.dn + j) * d + k;
    need_bw = need_bw || (p.active[a] && !(p.uniform && p.uniform[a]));
  }
  const bool stage_lc = need_bw && !has_cov;
  __syncthreads();                   // D == 0: the row constants are in place

  const int nslots = (w + S - 1) / S;
  auto copy_job = [&](int q) {
    if (q < nslots) {
      const int i0 = q * S, cnt = min(S, w - i0);
      T* sl = ring + (q % kStages) * slot_el;
      const T* gm = gmean + (long long)i0 * d;
      for (int e = threadIdx.x; e < cnt * d; e += blockDim.x)
        cp_async_el(sl + e, gm + e);
      for (int e = threadIdx.x; e < cnt; e += blockDim.x)
        cp_async_el(sl + S * d + e, glogw + i0 + e);
      if (need_bw) {
        const T* gb = gbw + (long long)i0 * d;
        for (int e = threadIdx.x; e < cnt * d; e += blockDim.x)
          cp_async_el(sl + S * (d + 1) + e, gb + e);
      }
    }
    cp_async_commit();
  };
  // the level through the ring: body(q, slot, count) on slot q once every
  // thread's copies of it have landed (and, with stage_lc, the logs of
  // its bandwidths are in place)
  auto stream = [&](auto&& body) {
    for (int q = 0; q < kStages - 1; ++q) copy_job(q);
    for (int q = 0; q < nslots; ++q) {
      // the barrier also frees the slot of job q - 1 for job q + kStages - 1
      cp_async_wait<kStages - 2>();
      __syncthreads();
      copy_job(q + kStages - 1);
      T* sl = ring + (q % kStages) * slot_el;
      const int cnt = min(S, w - q * S);
      if (stage_lc) {
        for (int e = threadIdx.x; e < cnt * d; e += blockDim.x)
          sl[S * (2 * d + 1) + e] = lg(sl[S * (d + 1) + e]);
        __syncthreads();
      }
      body(q, (const T*)sl, cnt);
    }
    cp_async_wait<0>();
    __syncthreads();                 // the ring is free for the next pass
  };
  // a pass's work on one slot with the logit the stage takes:
  // run(logit(i)) on the slot's candidates i
  auto on_slot = [&](const T* sm, auto&& run) {
    const T* slw = sm + S * d;
    const T* sbw = sm + S * (d + 1);
    const T* slc = sm + S * (2 * d + 1);
    if (stage_lc)
      run([&](int i) {
        return staged_logit<T, D>(rq, sm + i * d, sbw + i * d, slc + i * d,
                                  slw[i], two_pi, inv_two_pi);
      });
    else
      run([&](int i) {
        return row_logit<T, D>(rq, sm + i * d, sbw + i * d, slw[i],
                               has_cov, two_pi, inv_two_pi);
      });
  };

  // pass 1: the logits, their max and the count of real candidates
  T mx = neg_inf<T>();
  int nreal = 0;
  stream([&](int q, const T* sm, int cnt) {
    if (!live) return;
    const T* slw = sm + S * d;
    on_slot(sm, [&](auto&& logit) {
      for (int ii = lane; ii < cnt; ii += 32 * kInFlight) {
        T v[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          const int i = ii + 32 * k;
          if (i < cnt) v[k] = logit(i);
        }
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          const int i = ii + 32 * k;
          if (i < cnt) {
            if (v[k] > mx) mx = v[k];
            nreal += slw[i] == neg_inf<T>() ? 0 : 1;
          }
        }
      }
    });
  });
  mx = group_all<32>(mx, MaxOp(), (T*)nullptr);
  const T ms = mx == neg_inf<T>() ? (T)0 : mx;

  // pass 2: the dead test's sum in T, and each chunk's float64 sum of the
  // row's candidates (in chunk order, lanes by a butterfly)
  T sum_t = (T)0;
  double dch = 0.0;
  const int spc = p.chunk / S;         // slots a chunk
  double* pr = part + (size_t)warp * p.chunks;
  stream([&](int q, const T* sm, int cnt) {
    if (!live) return;
    on_slot(sm, [&](auto&& logit) {
      for (int ii = lane; ii < cnt; ii += 32 * kInFlight) {
        T v[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          const int i = ii + 32 * k;
          if (i < cnt) v[k] = ex(logit(i) - ms);
        }
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          if (ii + 32 * k < cnt) {
            sum_t = sum_t + v[k];
            dch += (double)v[k];
          }
        }
      }
    });
    if ((q + 1) % spc == 0 || q == nslots - 1) {
      for (int o = 16; o > 0; o >>= 1) dch += __shfl_xor_sync(kFull, dch, o);
      if (lane == 0) pr[q / spc] = dch;
      dch = 0.0;
    }
  });
  if (!live) return;
  sum_t = group_all<32>(sum_t, SumOp(), (T*)nullptr);
  nreal = group_all<32>(nreal, SumOp(), (int*)nullptr);
  const bool dead = ms + lg(sum_t) < (T)p.log_dead;
  __syncwarp();                      // the row's chunk sums are in place

  // pass 3: the chunk, then the scan inside it
  const double u = (double)static_cast<const T*>(p.u)[row];
  auto ev = [&](int i) -> double {   // candidate i's term of the scan
    if (dead) return glogw[i] == neg_inf<T>() ? 0.0 : 1.0;
    const T l = row_logit<T, D>(rq, gmean + (long long)i * d,
                                gbw + (long long)i * d, glogw[i], has_cov,
                                two_pi, inv_two_pi);
    return (double)ex(l - ms);
  };
  int lo = 0, hi = w;
  double s, off = 0.0;
  if (dead) {
    s = (double)nreal;               // uniform over the real candidates
  } else {
    s = 0.0;
    for (int k = 0; k < p.chunks; ++k) s = s + pr[k];
    // the first chunk whose end is not below u, and the sum before it
    double run = 0.0;
    lo = w;
    for (int k = 0; k < p.chunks; ++k) {
      const double next = run + pr[k];
      if (!(next / s < u)) {
        lo = k * p.chunk;
        hi = min(w, lo + p.chunk);
        break;
      }
      run = next;
    }
    off = run / s;
  }
  int z = hi;
  if (dead && nreal == 0) {
    z = 0;                           // the twin's CDF is NaN: no entry < u
  } else {
    for (int base = lo; base < hi; base += 32 * kPer) {
      const int i0 = base + lane * kPer;
      double loc[kPer];
      double run = 0.0;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        if (i < hi) run += ev(i) / s;
        loc[v] = run;
      }
      double total;
      const double start = off + group_scan<32>(run, nullptr, total);
      int found = kNone;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        if (i < hi && found == kNone && !(start + loc[v] < u)) found = i;
      }
      found = group_all<32>(found, MinOp(), (int*)nullptr);
      if (found != kNone) {
        z = found;
        break;
      }
      off = off + total;
    }
  }
  if (z > w - 1) z = w - 1;

  // the winner's mean, variance and label
  T* om = static_cast<T*>(p.out_mean) + row * d;
  T* ov = static_cast<T*>(p.out_var) + row * d;
  for (int k = lane; k < d; k += 32) {
    om[k] = gmean[(long long)z * d + k];
    ov[k] = gbw[(long long)z * d + k];
  }
  if (lane == 0)
    p.out_label[row] = (p.perm + b * p.ls_b + j * p.ls_j)[z];
}

size_t smem_bytes(int group, int cache, int w, int d, size_t item) {
  const size_t rows = group == 32 ? kWarpRows : 1;
  return rows * ((4 * (size_t)d + (cache ? (size_t)w : 0)) * item + d);
}

// Above 48 KB less the static scratch, a block's shared memory needs the
// kernel's opt-in.
constexpr size_t kOptInFrom = 47 * 1024;

template <typename K>
int go(K kern, long long blocks, int threads, size_t smem, const Params& p,
       cudaStream_t st) {
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > kOptInFrom) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  kern<<<(unsigned)blocks, threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_tiles(const Params& p, size_t smem, cudaStream_t st) {
  const long long blocks =
      (long long)(p.rows / p.C) * ((p.C + p.R - 1) / p.R);
  return go(k2_tiles<T, D>, blocks, 32 * p.R, smem, p, st);
}

template <typename T>
int dispatch(const Params& p, int gumbel, int layout, size_t smem,
             cudaStream_t st) {
  if (layout == kTiles) {
    switch (p.d) {
      case 1: return launch_tiles<T, 1>(p, smem, st);
      case 2: return launch_tiles<T, 2>(p, smem, st);
      case 3: return launch_tiles<T, 3>(p, smem, st);
      default: return launch_tiles<T, 0>(p, smem, st);
    }
  }
  if (layout == kWarp) {
    const long long blocks = (p.rows + kWarpRows - 1) / kWarpRows;
    return gumbel ? go(gibbs_select_kernel<T, 32, true>, blocks,
                       32 * kWarpRows, smem, p, st)
                  : go(gibbs_select_kernel<T, 32, false>, blocks,
                       32 * kWarpRows, smem, p, st);
  }
  return gumbel ? go(gibbs_select_kernel<T, kCtaThreads, true>, p.rows,
                     kCtaThreads, smem, p, st)
                : go(gibbs_select_kernel<T, kCtaThreads, false>, p.rows,
                     kCtaThreads, smem, p, st);
}

}  // namespace

// One selection step of B * C * J rows (see the header).  itemsize 4 or 8
// picks float or double; gumbel 1 draws from `seeds` (chain c of the launch
// is global chain chain0 + c, density j0 + jj selection sel0 + jj), 0 reads
// `u`; layout 0 is a warp a row, 1 a 512-thread block a row (cache 1 keeps
// the row's logits in shared memory), 2 the tiles of cdf: R rows of a warp
// a block, the level through a ring of `slot` candidates a slot, the CDF
// search over chunks of `chunk` candidates (a multiple of slot; at most 64
// chunks).  uniform
// [B, dn, d] (or null: every dim varied) flags the dims whose bandwidth is
// the same for every candidate of the level; gumbel does not read it.
// Strides are in elements.  Returns the CUDA error of the launch (an
// argument the kernel does not take: cudaErrorInvalidValue).
extern "C" int kde_gibbs_select(
    int itemsize, int gumbel, int layout, int cache, int R, int chunk,
    int slot,
    const void* mean, const void* bw, const void* logw, const long long* perm,
    long long ms_b, long long ms_j, long long ls_b, long long ls_j,
    const void* mu, const void* cov, const unsigned char* active,
    const unsigned char* codes, const unsigned char* uniform, const void* u,
    const long long* seeds, long long chain0, long long sel0, void* out_mean,
    void* out_var, long long* out_label,
    int B, int C, int J, int j0, int dn, int w, int d,
    double two_pi, double inv_two_pi, double log_dead, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || layout < kWarp || layout > kTiles
      || B < 0 || C < 0 || J < 1 || j0 < 0 || j0 + J > dn || w < 1 || d < 1
      || (gumbel ? seeds == nullptr : u == nullptr)
      || (layout == kTiles && gumbel))
    return (int)cudaErrorInvalidValue;
  int chunks = 1;
  size_t smem;
  if (layout == kTiles) {
    if (R < 1 || 32 * R > kTileThreads || slot < 32 || slot % 32 != 0
        || chunk < slot || chunk % slot != 0)
      return (int)cudaErrorInvalidValue;
    chunks = (w + chunk - 1) / chunk;
    if (chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
    smem = tile_smem(R, chunks, slot, d, (size_t)itemsize, d > 3);
  } else {
    smem = smem_bytes(layout == kWarp ? 32 : kCtaThreads, cache, w, d,
                      (size_t)itemsize);
  }
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{mean, bw, logw, perm, ms_b, ms_j, ls_b, ls_j, mu, cov, active,
           codes, uniform, u, seeds, chain0, sel0, out_mean, out_var,
           out_label, (long long)B * C * J, C, J, j0, dn, w, d, cache,
           R, chunk, chunks, slot, two_pi, inv_two_pi, log_dead};
  if (p.rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return itemsize == 4 ? dispatch<float>(p, gumbel, layout, smem, st)
                       : dispatch<double>(p, gumbel, layout, smem, st);
}
