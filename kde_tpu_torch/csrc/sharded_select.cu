// The local work of one kernel-sharded Gibbs selection, for Hopper
// (sm_90a): the hand kernels behind ops/sharded_select.py (the port's K6).
//
// On the TPU the kernel-sharded product is one jitted shard_map program
// (kde_tpu/parallel/gibbs_kernel_sharded.py:285-317 _build_ks_program),
// and XLA fuses each shard's candidate scoring, degenerate test, CDF and
// one-hot pick (_select_sharded :158-187, the local work of _run_chain_ks
// :190-283) around the collectives.  Here the collectives stay
// torch.distributed calls, and each piece of local work between two of
// them is one launch over every density of the stage and every chain of
// the block.  A row is one (density j = j0 + jj, chain c), written at
// jj * C + c; its candidates are this shard's w slots of the level, whose
// logits are gibbs_logit.cuh's candidate_logit (bitwise the twin's):
//
//   kMax   the local max of the logits                     -> pmax: m0
//   kSum   the shifted sum of exp(l - ms0), ms0 = m0 or 0 where m0 is
//          -inf, in the chain's type; a row whose m0 reaches log(1e-99)
//          writes 1 (the global sum holds exp(0) = 1 and no negative
//          term, so its log is >= 0 and the row is live in any rounding,
//          as with S = 1 written here)                     -> psum: ssum
//   dead_max  dead = ms0 + log ssum < log(1e-99), and the max of the rows
//          as the fallback leaves them: m where live, 0 where dead and the
//          shard has a real candidate, -inf where it has none -> pmax: gmax
//   kEsum  the float64 sum of exp(l' - gmax), l' the fallback logits (0
//          for real candidates, -inf for padding) on dead rows, the exps
//          in the chain's type widened             -> all_gather: [S] sums
//   kCount the count of CDF entries (offset + local cumsum) / total below
//          u, in float64, offset the sum of the earlier shards' sums and
//          total all of them in shard order             -> psum: the index
//   owner_stats  the row z of this shard's float64 stats where it owns the
//          global index z (clamped into [0, S w - 1]), zeros elsewhere
//                                                     -> psum: the winner
//
// No phase keeps the [rows, w] logits: each recomputes them.  kCount scans
// tiles of G x kPer candidates in index order (a thread's kPer consecutive
// ones in registers, the threads' sums by a shuffle scan) and stops at the
// tile where the CDF first reaches u: the CDF does not decrease, so the
// count below u is that index (w where none does).
//
// What bounds it: per candidate and pass, d logs and d divisions on the
// SFU and ~5d FP32 operations (and an exp in kSum, kEsum and kCount), not
// bytes: a level's candidates are read from L2 by every row.  The design,
// simple first: a row on one warp (8 rows a 256-thread block) up to
// kWarpMaxWidth candidates, on one 512-thread block above; every sum in a
// fixed order, so a row's result does not depend on the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "gibbs_logit.cuh"

namespace {

using kde_gibbs::candidate_logit;
using kde_gibbs::ex;
using kde_gibbs::group_all;
using kde_gibbs::group_scan;
using kde_gibbs::group_sync;
using kde_gibbs::lg;
using kde_gibbs::MaxOp;
using kde_gibbs::MinOp;
using kde_gibbs::neg_inf;
using kde_gibbs::SumOp;

constexpr int kWarpRows = 8;          // rows of a 256-thread block, warp route
constexpr int kCtaThreads = 512;      // threads of a block, block route
constexpr int kMaxWarps = kCtaThreads / 32;
constexpr int kPer = 4;               // consecutive candidates a thread scans
constexpr int kMaxSmem = 48 * 1024;   // per-row mu, cov and flags
constexpr int kNone = 0x7fffffff;

enum Phase { kMax = 0, kSum = 1, kEsum = 2, kCount = 3 };

struct Params {
  const void* mean;              // [dn, w, d] level slices of this shard
  const void* bw;
  const void* logw;              // [dn, w]
  long long ms_j, ls_j;          // density strides of mean/bw and logw
  const void* mu;                // [C, d]
  const void* cov;               // [C, d] or null
  const unsigned char* active;   // [dn, d] bool
  const unsigned char* codes;    // [d]: 0 Euclidean, 1 circular
  const void* m0;                // [J, C] the global max (kSum)
  const void* gmax;              // [J, C] the global fallback max
  const unsigned char* dead;     // [J, C] bool
  const double* tots;            // [S, J, C] every shard's kEsum
  const void* u;                 // [C, J], strides u_c, u_j
  long long u_c, u_j;
  void* out;                     // [J, C]: T (kMax, kSum), double, int64
  long long rows;                // J * C
  int C, J, j0, w, d, S, sid;
  double two_pi, inv_two_pi, log_dead;
};

template <typename T, int G, int kPhase>
__global__ void __launch_bounds__(G == 32 ? 32 * kWarpRows : G)
k6_rows(const Params p) {
  constexpr int R = G == 32 ? kWarpRows : 1;       // rows a block
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_d[kMaxWarps];
  __shared__ T s_t[kMaxWarps];
  __shared__ int s_i[kMaxWarps];

  const int g = threadIdx.x / G;                   // the block's row
  const int t = threadIdx.x % G;                   // thread of the row
  const long long row = (long long)blockIdx.x * R + g;
  if (row >= p.rows) return;                       // warp route only
  const int w = p.w, d = p.d;
  const int jj = (int)(row / p.C);
  const long long c = row % p.C;
  const int j = p.j0 + jj;

  // shared memory: per row mu[d], cov[d] (T), then flags[d]
  T* qmu = reinterpret_cast<T*>(smem) + (size_t)g * 2 * d;
  T* qcov = qmu + d;
  unsigned char* flags = smem + (size_t)R * 2 * d * sizeof(T) + (size_t)g * d;
  const T* mean = static_cast<const T*>(p.mean) + j * p.ms_j;
  const T* bw = static_cast<const T*>(p.bw) + j * p.ms_j;
  const T* logw = static_cast<const T*>(p.logw) + j * p.ls_j;
  const bool has_cov = p.cov != nullptr;
  for (int k = t; k < d; k += G) {
    qmu[k] = static_cast<const T*>(p.mu)[c * d + k];
    qcov[k] = has_cov ? static_cast<const T*>(p.cov)[c * d + k] : (T)0;
    flags[k] = (unsigned char)((p.active[(long long)j * d + k] ? 1 : 0)
                               | (p.codes[k] ? 2 : 0));
  }
  group_sync<G>();

  const T two_pi = (T)p.two_pi, inv_two_pi = (T)p.inv_two_pi;
  auto logit = [&](int i) -> T {
    return candidate_logit<T>(mean + (long long)i * d, bw + (long long)i * d,
                              logw[i], qmu, qcov, has_cov, flags, d, two_pi,
                              inv_two_pi);
  };

  if constexpr (kPhase == kMax) {
    T mx = neg_inf<T>();
    for (int i = t; i < w; i += G) {
      const T l = logit(i);
      if (l > mx) mx = l;
    }
    mx = group_all<G>(mx, MaxOp(), s_t);
    if (t == 0) static_cast<T*>(p.out)[row] = mx;
  } else if constexpr (kPhase == kSum) {
    const T m0 = static_cast<const T*>(p.m0)[row];
    T sum = (T)1;
    if (!(m0 >= (T)p.log_dead)) {                  // uniform over the row
      const T ms = m0 == neg_inf<T>() ? (T)0 : m0;
      T acc = (T)0;
      for (int i = t; i < w; i += G) acc = acc + ex(logit(i) - ms);
      sum = group_all<G>(acc, SumOp(), s_t);
    }
    if (t == 0) static_cast<T*>(p.out)[row] = sum;
  } else {
    const T gm = static_cast<const T*>(p.gmax)[row];
    const bool dead = p.dead[row] != 0;
    // the row's logit after the degenerate fallback
    auto lval = [&](int i) -> T {
      if (dead) return logw[i] == neg_inf<T>() ? neg_inf<T>() : (T)0;
      return logit(i);
    };
    if constexpr (kPhase == kEsum) {
      double acc = 0.0;
      for (int i = t; i < w; i += G) acc += (double)ex(lval(i) - gm);
      acc = group_all<G>(acc, SumOp(), s_d);
      if (t == 0) static_cast<double*>(p.out)[row] = acc;
    } else {
      double total = 0.0, offset = 0.0;
      for (int s = 0; s < p.S; ++s) {
        const double v = p.tots[(long long)s * p.rows + row];
        total = total + v;
        if (s < p.sid) offset = offset + v;
      }
      const double u =
          (double)static_cast<const T*>(p.u)[c * p.u_c + jj * p.u_j];
      int z = -1;
      double off = 0.0;
      for (int base = 0; z < 0 && base < w; base += G * kPer) {
        const int i0 = base + t * kPer;
        double loc[kPer];
        double run = 0.0;
#pragma unroll
        for (int v = 0; v < kPer; ++v) {
          const int i = i0 + v;
          if (i < w) run += (double)ex(lval(i) - gm);
          loc[v] = run;
        }
        double tile;
        const double start = off + group_scan<G>(run, s_d, tile);
        int found = kNone;
#pragma unroll
        for (int v = 0; v < kPer; ++v) {
          const int i = i0 + v;
          // the first entry not below u (a NaN CDF is not below u)
          if (i < w && found == kNone
              && !((offset + (start + loc[v])) / total < u))
            found = i;
        }
        found = group_all<G>(found, MinOp(), s_i);
        if (found != kNone) z = found;
        off = off + tile;
      }
      if (t == 0) static_cast<long long*>(p.out)[row] = z < 0 ? w : z;
    }
  }
}

template <typename T>
__global__ void k6_dead_max(const T* m0, const T* ssum, const T* m,
                            const unsigned char* real, long long C,
                            long long rows, double log_dead,
                            unsigned char* dead, T* mfb) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const T a = m0[row];
  const T ms = a == neg_inf<T>() ? (T)0 : a;
  const T lse = ms + lg(ssum[row]);
  const bool dd = lse < (T)log_dead;
  dead[row] = dd ? 1 : 0;
  mfb[row] = dd ? (real[row / C] ? (T)0 : neg_inf<T>()) : m[row];
}

__global__ void k6_owner_stats(const long long* z, const double* stats,
                               long long st_j, int j0, long long C, int w,
                               int F, int S, int sid, long long n,
                               double* out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long row = idx / F;
  const int f = (int)(idx % F);
  const int jj = (int)(row / C);
  long long zz = z[row];
  const long long last = (long long)S * w - 1;
  zz = zz < 0 ? 0 : (zz > last ? last : zz);
  long long zl = zz - (long long)sid * w;
  const bool own = zl >= 0 && zl < w;
  zl = zl < 0 ? 0 : (zl > w - 1 ? w - 1 : zl);
  out[idx] = own ? stats[(long long)(j0 + jj) * st_j + zl * F + f] : 0.0;
}

size_t smem_bytes(int group, int d, size_t item) {
  const size_t rows = group == 32 ? kWarpRows : 1;
  return rows * (2 * (size_t)d * item + d);
}

template <typename T, int G>
int launch_rows(const Params& p, int phase, cudaStream_t st) {
  const size_t smem = smem_bytes(G, p.d, sizeof(T));
  const long long per = G == 32 ? kWarpRows : 1;
  const long long blocks = (p.rows + per - 1) / per;
  const int threads = G == 32 ? 32 * kWarpRows : G;
  switch (phase) {
    case kMax: k6_rows<T, G, kMax><<<(unsigned)blocks, threads, smem, st>>>(p);
      break;
    case kSum: k6_rows<T, G, kSum><<<(unsigned)blocks, threads, smem, st>>>(p);
      break;
    case kEsum: k6_rows<T, G, kEsum><<<(unsigned)blocks, threads, smem, st>>>(
        p);
      break;
    default: k6_rows<T, G, kCount><<<(unsigned)blocks, threads, smem, st>>>(
        p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(const Params& p, int phase, int group, cudaStream_t st) {
  return group == 32 ? launch_rows<T, 32>(p, phase, st)
                     : launch_rows<T, kCtaThreads>(p, phase, st);
}

}  // namespace

// One phase (0 kMax, 1 kSum, 2 kEsum, 3 kCount; see the header) over the
// J * C rows of densities j0 .. j0 + J - 1 and C chains.  itemsize 4 or 8
// picks float or double; group is 32 (a warp a row) or 512 (a block a
// row).  Strides are in elements.  Returns the CUDA error of the launch
// (an argument the kernel does not take: cudaErrorInvalidValue).
extern "C" int kde_k6_rows(
    int phase, int itemsize, int group, const void* mean, const void* bw,
    const void* logw, long long ms_j, long long ls_j, const void* mu,
    const void* cov, const unsigned char* active, const unsigned char* codes,
    const void* m0, const void* gmax, const unsigned char* dead,
    const double* tots, const void* u, long long u_c, long long u_j,
    void* out, int C, int J, int j0, int dn, int w, int d, int S, int sid,
    double two_pi, double inv_two_pi, double log_dead, void* stream) {
  if (phase < kMax || phase > kCount || (itemsize != 4 && itemsize != 8)
      || (group != 32 && group != kCtaThreads) || C < 0 || J < 1 || j0 < 0
      || j0 + J > dn || w < 1 || d < 1 || S < 1 || sid < 0 || sid >= S
      || (phase == kSum && m0 == nullptr)
      || (phase >= kEsum && (gmax == nullptr || dead == nullptr))
      || (phase == kCount && (tots == nullptr || u == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes(group, d, (size_t)itemsize) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Params p{mean, bw, logw, ms_j, ls_j, mu, cov, active, codes, m0, gmax,
           dead, tots, u, u_c, u_j, out, (long long)J * C, C, J, j0, w, d,
           S, sid, two_pi, inv_two_pi, log_dead};
  if (p.rows == 0) return 0;
  const long long per = group == 32 ? kWarpRows : 1;
  if ((p.rows + per - 1) / per > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return itemsize == 4 ? dispatch_rows<float>(p, phase, group, st)
                       : dispatch_rows<double>(p, phase, group, st);
}

// The degenerate test and the fallback max of J * C rows (see the header):
// real[jj] is whether this shard holds a real candidate of density jj.
extern "C" int kde_k6_dead_max(int itemsize, const void* m0, const void* ssum,
                               const void* m, const unsigned char* real,
                               int J, int C, double log_dead,
                               unsigned char* dead, void* mfb, void* stream) {
  if ((itemsize != 4 && itemsize != 8) || J < 1 || C < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)J * C;
  if (rows == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (itemsize == 4)
    k6_dead_max<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(m0), static_cast<const float*>(ssum),
        static_cast<const float*>(m), real, C, rows, log_dead, dead,
        static_cast<float*>(mfb));
  else
    k6_dead_max<double><<<blocks, threads, 0, st>>>(
        static_cast<const double*>(m0), static_cast<const double*>(ssum),
        static_cast<const double*>(m), real, C, rows, log_dead, dead,
        static_cast<double*>(mfb));
  return (int)cudaGetLastError();
}

// The owner's stats rows of J * C rows: stats is [dn, w, F] with density
// stride st_j (elements) and rows of F contiguous doubles; out [J, C, F].
extern "C" int kde_k6_owner_stats(const long long* z, const double* stats,
                                  long long st_j, int j0, int J, int C,
                                  int dn, int w, int F, int S, int sid,
                                  double* out, void* stream) {
  if (J < 1 || C < 0 || j0 < 0 || j0 + J > dn || w < 1 || F < 1 || S < 1
      || sid < 0 || sid >= S)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)J * C * F;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  k6_owner_stats<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      z, stats, st_j, j0, C, w, F, S, sid, n, out);
  return (int)cudaGetLastError();
}
