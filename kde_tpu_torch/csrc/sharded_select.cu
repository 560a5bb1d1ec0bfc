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
// logits are gibbs_logit.cuh's row_logit (bitwise the twin's):
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
// What bounds it: per (row, candidate) pair and pass, d IEEE divisions, d
// accurate logs (none on a dim where the level's bandwidth is uniform:
// log c is then taken once a row, bitwise the same value), ~5d FP32
// operations and an exp -- instruction throughput, not bytes.  The design:
//
//   * kMax, kSum and kEsum run on a grid of row tiles x candidate chunks.
//     A block holds R rows of one density, a warp a row, and one chunk of
//     the level; the chunk's means, log weights and (where an active dim's
//     bandwidth varies) bandwidths reach shared memory through a cp.async
//     ring of kStages slots, so a candidate leaves L2 once a block, not
//     once a row.  The wrapper's plan (ops/sharded_select.py::plan) sizes
//     the chunks so that the grid fills the card.
//   * Each block writes its rows' partials for its chunk ([rows, chunks]
//     scratch: the max, the sum in the chain's type, the float64 sum); the
//     last block of a row tile to finish (a counter behind a
//     __threadfence) combines them in chunk order in the same launch.  The
//     maxima combine exactly in any order; the sums are fixed-order sums
//     of fixed-order partials, so a row's result does not depend on the
//     launch.
//   * kCount reads kEsum's float64 chunk sums of the same stage, finds the
//     chunk where (offset + prefix) / total first reaches u, and scans (and
//     divides) only inside that chunk, in index order from that chunk's
//     prefix.  The CDF does not decrease, so the count below u is the first
//     index where it reaches u (w where none does); where the chunk's own
//     running sum, taken in another order, stays below u, the count is the
//     chunk's end -- a float64 tie at the chunk boundary.
//   * No phase keeps the [rows, w] logits: kMax and kEsum recompute them,
//     kSum only on rows whose max is below log(1e-99).

#include <cuda_runtime.h>
#include <math.h>

#include "gibbs_logit.cuh"

// A stage: this shard's level slice and the rows of one selection, with
// the plan and the scratch, filled once by the wrapper (its ctypes
// Structure in ops/sharded_select.py must match field for field).  At
// namespace scope: the C entries take it, and keep external linkage.
struct K6Stage {
  const void* mean;              // [dn, w, d] level slices of this shard
  const void* bw;
  const void* logw;              // [dn, w]
  const void* mu;                // [C, d]
  const void* cov;               // [C, d] or null
  const unsigned char* active;   // [dn, d] bool
  const unsigned char* codes;    // [d]: 0 Euclidean, 1 circular
  const unsigned char* uniform;  // [dn, d] bool: bandwidth uniform in d
  void* part;                    // [rows, chunks] T: kMax's, kSum's partials
  double* part_e;                // [rows, chunks]: kEsum's (kCount reads);
                                 // may alias part (each phase's partials
                                 // are dead before the next launch)
  int* counters;                 // [tiles], 0 between launches
  long long ms_j, ls_j;          // density strides of mean/bw and logw
  int itemsize, C, J, j0, dn, w, d;
  int R, chunks, chunk, slot, count_group;
  double two_pi, inv_two_pi, log_dead;
};

namespace {

using Stage = K6Stage;
using kde_gibbs::ex;
using kde_gibbs::group_all;
using kde_gibbs::group_scan;
using kde_gibbs::group_sync;
using kde_gibbs::lg;
using kde_gibbs::MaxOp;
using kde_gibbs::MinOp;
using kde_gibbs::neg_inf;
using kde_gibbs::row_logit;
using kde_gibbs::RowQ;
using kde_gibbs::SumOp;

constexpr int kStages = 3;            // ring slots of a tile block
constexpr int kMaxRows = 16;          // rows (warps) of a tile block
constexpr int kWarpRows = 8;          // rows of a 256-thread block, kCount
constexpr int kCtaThreads = 512;      // threads of a row, kCount's block route
constexpr int kMaxWarps = kCtaThreads / 32;
constexpr int kPer = 4;               // consecutive candidates a thread scans
constexpr int kInFlight = 4;          // a lane's staged candidates at a time
constexpr size_t kSmemMax = 232448;   // dynamic shared memory a block may use
constexpr int kNone = 0x7fffffff;

enum Phase { kMax = 0, kSum = 1, kEsum = 2, kCount = 3 };

struct Params {
  Stage s;
  const void* m0;                // [J, C] the global max (kSum)
  const void* gmax;              // [J, C] the global fallback max
  const unsigned char* dead;     // [J, C] bool
  const double* tots;            // [S, J, C] every shard's kEsum
  const void* u;                 // [C, J], strides u_c, u_j
  long long u_c, u_j;
  void* out;                     // [J, C]: T (kMax, kSum), double, int64
  long long rows;                // J * C
  int tiles_per_dens, tiles, S, sid;
};

// Bytes of a row's constants in shared memory for a d known only at run
// time: mu, cov, c, lc [d] of T, then flags [d].
__host__ __device__ __forceinline__ size_t row_bytes(int d, size_t item) {
  return 4 * (size_t)d * item + d;
}
__host__ __device__ __forceinline__ size_t tile_head(int R, int d,
                                                     size_t item,
                                                     bool generic) {
  return generic ? ((R * row_bytes(d, item) + 15) & ~(size_t)15) : 0;
}
size_t tile_smem(int R, int slot, int d, size_t item, bool generic) {
  return tile_head(R, d, item, generic)
         + (size_t)kStages * slot * (2 * d + 1) * item;
}
size_t count_smem(int group, int d, size_t item, bool generic) {
  return generic ? (group == 32 ? kWarpRows : 1) * row_bytes(d, item) : 0;
}

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

// Row (j, c)'s constants into r.  D > 0: every thread its own copy in
// registers.  D == 0: threads t < d of the row's group of G write them to
// the row's shared memory q ([4][d] T) and f ([d]); the caller makes them
// visible with a barrier.  bw0 is the level's first bandwidth row of j.
template <typename T, int D>
__device__ __forceinline__ void row_consts(RowQ<T, D>& r, const Stage& s,
                                           long long c, int j, const T* bw0,
                                           T* q, unsigned char* f, int t,
                                           int G) {
  const int d = s.d;
  const bool has_cov = s.cov != nullptr;
  auto one = [&](int k, T& x, T& qq, T& cc, T& lc, unsigned char& fl) {
    const bool act = s.active[(long long)j * d + k] != 0;
    const bool un = s.uniform[(long long)j * d + k] != 0;
    x = static_cast<const T*>(s.mu)[c * d + k];
    qq = has_cov ? static_cast<const T*>(s.cov)[c * d + k] : (T)0;
    T c0 = bw0[k];
    if (has_cov) c0 = c0 + qq;
    cc = c0;
    lc = un ? lg(c0) : (T)0;
    fl = (unsigned char)((act ? 1 : 0) | (s.codes[k] ? 2 : 0) | (un ? 4 : 0));
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

// kMax, kSum, kEsum on the grid of row tiles x chunks (chunk-major:
// blockIdx.x = chunk * tiles + tile, so the blocks in flight share their
// chunks in L2).  blockDim.x = 32 R.
template <typename T, int D, int kPhase>
__global__ void __launch_bounds__(32 * kMaxRows, sizeof(T) == 4 ? 2 : 1)
k6_tiles(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const Stage& s = p.s;
  const int R = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x % p.tiles;
  const int chunk = blockIdx.x / p.tiles;
  const int jj = tile / p.tiles_per_dens;
  const int c_real = (tile % p.tiles_per_dens) * R + warp;
  const bool live = c_real < s.C;      // a tile's spare warps only copy
  const long long c = live ? c_real : s.C - 1;
  const long long row = (long long)jj * s.C + c;
  const int j = s.j0 + jj;
  const int d = D > 0 ? D : s.d;
  const int i_lo = chunk * s.chunk;
  const int i_hi = min(s.w, i_lo + s.chunk);
  const T* gmean = static_cast<const T*>(s.mean) + j * s.ms_j;
  const T* gbw = static_cast<const T*>(s.bw) + j * s.ms_j;
  const T* glogw = static_cast<const T*>(s.logw) + j * s.ls_j;
  const bool has_cov = s.cov != nullptr;
  const T two_pi = (T)s.two_pi, inv_two_pi = (T)s.inv_two_pi;

  T* qsm = reinterpret_cast<T*>(smem) + (size_t)warp * 4 * d;
  unsigned char* fsm = smem + (size_t)R * 4 * d * sizeof(T) + warp * d;
  T* ring = reinterpret_cast<T*>(
      smem + tile_head(R, d, sizeof(T), D == 0));
  RowQ<T, D> rq;
  row_consts<T, D>(rq, s, c, j, gbw, qsm, fsm, lane, 32);

  // does the chunk need the bandwidths (an active dim whose bandwidth
  // varies)?  The same for every row of the block: one density.
  bool need_bw = false;
  for (int k = 0; k < d; ++k)
    need_bw = need_bw || (s.active[(long long)j * d + k]
                          && !s.uniform[(long long)j * d + k]);

  // the row's phase inputs; work: the row needs the chunk's candidates
  T mx = neg_inf<T>(), ms = (T)0, gm = (T)0, tsum = (T)0;
  double dsum = 0.0;
  bool work = live, dead = false;
  if constexpr (kPhase == kSum) {
    const T m0 = static_cast<const T*>(p.m0)[row];
    ms = m0 == neg_inf<T>() ? (T)0 : m0;
    work = live && !(m0 >= (T)s.log_dead);     // uniform over the row
  } else if constexpr (kPhase == kEsum) {
    gm = static_cast<const T*>(p.gmax)[row];
    dead = p.dead[row] != 0;
  }
  // a barrier (D == 0: the row constants are in place) that also tells
  // whether any row of the tile needs the chunk
  const bool any = __syncthreads_or(work) != 0;

  if (any) {
    const int S = s.slot;
    const int n = i_hi - i_lo;
    const int nslots = (n + S - 1) / S;
    const int slot_el = S * (2 * d + 1);
    auto copy_job = [&](int q) {
      if (q < nslots) {
        const int i0 = i_lo + q * S;
        const int cnt = min(S, i_hi - i0);
        T* sl = ring + (q % kStages) * slot_el;
        const T* gm_ = gmean + (long long)i0 * d;
        for (int e = threadIdx.x; e < cnt * d; e += blockDim.x)
          cp_async_el(sl + e, gm_ + e);
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
    for (int q = 0; q < kStages - 1; ++q) copy_job(q);
    for (int q = 0; q < nslots; ++q) {
      // job q has landed for every thread; the barrier also frees the
      // slot of job q - 1 for job q + kStages - 1
      cp_async_wait<kStages - 2>();
      __syncthreads();
      copy_job(q + kStages - 1);
      const T* sm = ring + (q % kStages) * slot_el;
      const T* slw = sm + S * d;
      const T* sbw = sm + S * (d + 1);
      const int cnt = min(S, i_hi - (i_lo + q * S));
      if (!work) continue;
      auto logit = [&](int ii) -> T {
        return row_logit<T, D>(rq, sm + ii * d, sbw + ii * d, slw[ii],
                               has_cov, two_pi, inv_two_pi);
      };
      // the logit after the degenerate fallback (kEsum)
      auto lval = [&](int i) -> T {
        if (kPhase == kEsum && dead)
          return slw[i] == neg_inf<T>() ? neg_inf<T>() : (T)0;
        return logit(i);
      };
      // a lane's candidates in index order, kInFlight at a time
      for (int ii = lane; ii < cnt; ii += 32 * kInFlight) {
        T v[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          const int i = ii + 32 * k;
          if (i < cnt) {
            v[k] = lval(i);
            if constexpr (kPhase == kSum) v[k] = ex(v[k] - ms);
            if constexpr (kPhase == kEsum) v[k] = ex(v[k] - gm);
          }
        }
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          if (ii + 32 * k < cnt) {
            if constexpr (kPhase == kMax) {
              if (v[k] > mx) mx = v[k];
            } else if constexpr (kPhase == kSum) {
              tsum = tsum + v[k];
            } else {
              dsum += (double)v[k];
            }
          }
        }
      }
    }
  }

  // the row's partial for this chunk
  const long long at = row * s.chunks + chunk;
  if constexpr (kPhase == kMax) {
    mx = group_all<32>(mx, MaxOp(), (T*)nullptr);
    if (live && lane == 0) static_cast<T*>(s.part)[at] = mx;
  } else if constexpr (kPhase == kSum) {
    tsum = group_all<32>(tsum, SumOp(), (T*)nullptr);
    if (work && lane == 0) static_cast<T*>(s.part)[at] = tsum;
  } else {
    dsum = group_all<32>(dsum, SumOp(), (double*)nullptr);
    if (live && lane == 0) s.part_e[at] = dsum;
  }

  // the last block of the tile to finish combines the chunks in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&s.counters[tile], 1) == s.chunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (live && lane == 0) {
    const long long base = row * s.chunks;
    if constexpr (kPhase == kMax) {
      const T* pt = static_cast<const T*>(s.part) + base;
      T m = neg_inf<T>();
      for (int q = 0; q < s.chunks; ++q) {
        const T v = __ldcg(pt + q);
        if (v > m) m = v;
      }
      static_cast<T*>(p.out)[row] = m;
    } else if constexpr (kPhase == kSum) {
      T sum = (T)1;
      if (work) {
        const T* pt = static_cast<const T*>(s.part) + base;
        sum = (T)0;
        for (int q = 0; q < s.chunks; ++q) sum = sum + __ldcg(pt + q);
      }
      static_cast<T*>(p.out)[row] = sum;
    } else {
      double acc = 0.0;
      for (int q = 0; q < s.chunks; ++q)
        acc = acc + __ldcg(s.part_e + base + q);
      static_cast<double*>(p.out)[row] = acc;
    }
  }
  if (threadIdx.x == 0) s.counters[tile] = 0;   // for the next launch
}

// kCount: a row on a warp (8 rows a 256-thread block) where a chunk holds
// at most 1,024 candidates, on a 512-thread block above.
template <typename T, int D, int G>
__global__ void __launch_bounds__(G == 32 ? 32 * kWarpRows : G)
k6_count(const __grid_constant__ Params p) {
  constexpr int RB = G == 32 ? kWarpRows : 1;      // rows a block
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_d[kMaxWarps];
  __shared__ int s_i[kMaxWarps];
  const Stage& s = p.s;
  const int g = threadIdx.x / G;                   // the block's row
  const int t = threadIdx.x % G;                   // thread of the row
  const long long row = (long long)blockIdx.x * RB + g;
  if (row >= p.rows) return;                       // warp route only
  const int w = s.w;
  const int d = D > 0 ? D : s.d;
  const int jj = (int)(row / s.C);
  const long long c = row % s.C;
  const int j = s.j0 + jj;
  const T* mean = static_cast<const T*>(s.mean) + j * s.ms_j;
  const T* bw = static_cast<const T*>(s.bw) + j * s.ms_j;
  const T* logw = static_cast<const T*>(s.logw) + j * s.ls_j;
  const bool has_cov = s.cov != nullptr;
  const T two_pi = (T)s.two_pi, inv_two_pi = (T)s.inv_two_pi;

  T* qsm = reinterpret_cast<T*>(smem) + (size_t)g * 4 * d;
  unsigned char* fsm = smem + (size_t)RB * 4 * d * sizeof(T) + g * d;
  RowQ<T, D> rq;
  row_consts<T, D>(rq, s, c, j, bw, qsm, fsm, t, G);
  group_sync<G>();

  const T gm = static_cast<const T*>(p.gmax)[row];
  const bool dead = p.dead[row] != 0;
  auto lval = [&](int i) -> T {
    if (dead) return logw[i] == neg_inf<T>() ? neg_inf<T>() : (T)0;
    return row_logit<T, D>(rq, mean + (long long)i * d, bw + (long long)i * d,
                           logw[i], has_cov, two_pi, inv_two_pi);
  };
  double total = 0.0, offset = 0.0;
  for (int k = 0; k < p.S; ++k) {
    const double v = p.tots[(long long)k * p.rows + row];
    total = total + v;
    if (k < p.sid) offset = offset + v;
  }
  const double u = (double)static_cast<const T*>(p.u)[c * p.u_c + jj * p.u_j];

  // the first chunk whose end is not below u (a NaN CDF is not below u),
  // from kEsum's chunk sums in chunk order, and the sum before it
  const double* pe = s.part_e + row * s.chunks;
  int q = -1;
  double before = 0.0;
  {
    double run = 0.0;
    for (int k = 0; k < s.chunks; ++k) {
      const double next = run + pe[k];
      if (!((offset + next) / total < u)) {
        q = k;
        before = run;
        break;
      }
      run = next;
    }
  }
  long long z = w;
  if (q >= 0) {
    const int i_lo = q * s.chunk, i_hi = min(w, i_lo + s.chunk);
    z = i_hi;
    double off = before;
    for (int base = i_lo; base < i_hi; base += G * kPer) {
      const int i0 = base + t * kPer;
      double loc[kPer];
      double run = 0.0;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        if (i < i_hi) run += (double)ex(lval(i) - gm);
        loc[v] = run;
      }
      double tile;
      const double start = off + group_scan<G>(run, s_d, tile);
      int found = kNone;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int i = i0 + v;
        // the first entry not below u (a NaN CDF is not below u)
        if (i < i_hi && found == kNone
            && !((offset + (start + loc[v])) / total < u))
          found = i;
      }
      found = group_all<G>(found, MinOp(), s_i);
      if (found != kNone) {
        z = found;
        break;
      }
      off = off + tile;
    }
  }
  if (t == 0) static_cast<long long*>(p.out)[row] = z;
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

template <typename K>
int go(K kern, unsigned blocks, int threads, size_t smem, const Params& p,
       cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const Params& p, int phase, cudaStream_t st) {
  const Stage& s = p.s;
  const size_t item = sizeof(T);
  if (phase == kCount) {
    const size_t smem = count_smem(s.count_group, s.d, item, D == 0);
    if (s.count_group == 32)
      return go(k6_count<T, D, 32>,
                (unsigned)((p.rows + kWarpRows - 1) / kWarpRows),
                32 * kWarpRows, smem, p, st);
    return go(k6_count<T, D, kCtaThreads>, (unsigned)p.rows, kCtaThreads,
              smem, p, st);
  }
  const size_t smem = tile_smem(s.R, s.slot, s.d, item, D == 0);
  const unsigned blocks = (unsigned)p.tiles * (unsigned)s.chunks;
  const int threads = 32 * s.R;
  switch (phase) {
    case kMax: return go(k6_tiles<T, D, kMax>, blocks, threads, smem, p, st);
    case kSum: return go(k6_tiles<T, D, kSum>, blocks, threads, smem, p, st);
    default: return go(k6_tiles<T, D, kEsum>, blocks, threads, smem, p, st);
  }
}

template <typename T>
int dispatch(const Params& p, int phase, cudaStream_t st) {
  switch (p.s.d) {
    case 1: return launch<T, 1>(p, phase, st);
    case 2: return launch<T, 2>(p, phase, st);
    case 3: return launch<T, 3>(p, phase, st);
    default: return launch<T, 0>(p, phase, st);
  }
}

bool generic(int d) { return d < 1 || d > 3; }

}  // namespace

// sizeof the Stage the wrapper fills (its ctypes Structure must match).
extern "C" int kde_k6_stage_bytes() { return (int)sizeof(K6Stage); }

// Dynamic shared memory of a phase's launch for stage st (the wrapper's
// plan computes the same).
extern "C" long long kde_k6_smem(const K6Stage* st, int phase) {
  const size_t item = (size_t)st->itemsize;
  return (long long)(phase == kCount
                         ? count_smem(st->count_group, st->d, item,
                                      generic(st->d))
                         : tile_smem(st->R, st->slot, st->d, item,
                                     generic(st->d)));
}

// One phase (0 kMax, 1 kSum, 2 kEsum, 3 kCount; see the header) of stage
// st over its J * C rows: m0 (kSum), gmax and dead (kEsum, kCount), tots
// [S, J, C], this shard's sid and u [C, J] with element strides u_c, u_j
// (kCount).  Returns the CUDA error of the launch (an argument the kernel
// does not take: cudaErrorInvalidValue).
extern "C" int kde_k6_phase(int phase, const K6Stage* st, const void* m0,
                            const void* gmax, const unsigned char* dead,
                            const double* tots, int S, int sid,
                            const void* u, long long u_c, long long u_j,
                            void* out, void* stream) {
  if (st == nullptr || phase < kMax || phase > kCount)
    return (int)cudaErrorInvalidValue;
  const Stage& s = *st;
  if ((s.itemsize != 4 && s.itemsize != 8) || s.C < 0 || s.J < 1
      || s.j0 < 0 || s.j0 + s.J > s.dn || s.w < 1 || s.d < 1 || s.R < 1
      || s.R > kMaxRows || (s.R & (s.R - 1)) != 0 || s.slot < 32
      || s.slot % 32 != 0 || s.chunk < 1 || s.chunks < 1
      || (long long)s.chunk * (s.chunks - 1) >= s.w
      || (long long)s.chunk * s.chunks < s.w
      || (s.count_group != 32 && s.count_group != kCtaThreads)
      || s.mean == nullptr || s.bw == nullptr || s.logw == nullptr
      || s.mu == nullptr || s.active == nullptr || s.codes == nullptr
      || s.uniform == nullptr || s.part == nullptr || s.part_e == nullptr
      || s.counters == nullptr || out == nullptr
      || (phase == kSum && m0 == nullptr)
      || (phase >= kEsum && (gmax == nullptr || dead == nullptr))
      || (phase == kCount && (tots == nullptr || u == nullptr || S < 1
                              || sid < 0 || sid >= S)))
    return (int)cudaErrorInvalidValue;
  if ((size_t)kde_k6_smem(st, phase) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  Params p{s, m0, gmax, dead, tots, u, u_c, u_j, out, (long long)s.J * s.C,
           0, 0, S, sid};
  if (p.rows == 0) return 0;
  p.tiles_per_dens = (s.C + s.R - 1) / s.R;
  p.tiles = p.tiles_per_dens * s.J;
  if ((long long)p.tiles * s.chunks > 0x7fffffffLL
      || p.rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = (cudaStream_t)stream;
  return s.itemsize == 4 ? dispatch<float>(p, phase, cs)
                         : dispatch<double>(p, phase, cs);
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
