// K8 tree_build: the device product plan of ops/device_plan.py built by
// hand-written kernels for Hopper (sm_90a), bitwise its plain twin
// ops/device_plan.py::device_tree_stats and _eager_arrays (the eager
// median-split build that ports kde_tpu/ops/device_plan.py:140-210, an
// XLA-fused jnp program on the TPU; there is no Pallas kernel to port),
// save where two dims' spreads tie in real arithmetic and the float64
// sums' rounding order picks the split dim.  Built with --fmad=false, so
// every expression rounds as the twin's eager ops do.
//
// For every (set, density) of a plan, in the same launches (densities on
// grid axis y, sets on z; a plan of more than kMaxDens densities takes
// one group of launches per kMaxDens of them, each writing its own
// densities' slots):
//
//   split, per depth k: the slices that still split are the nodes of the
//     recursion split = (lo + hi) // 2 (ops/balltree.py::topology), found
//     here by walking it (walk_path, walk_pos: k integer steps, no table).
//     For each slice: the unweighted mean and the sum of squared deviations
//     of every dim in float64, the first argmax dim, then a stable sort of
//     the slice's positions by that coordinate, ties broken by the current
//     order; that is a sort by the unique key (coordinate, position).  The
//     order (point index at each position) lives in two ping-pong int32
//     buffers; the coordinates are gathered from the input through it;
//   moments, bottom-up (reference calcStatsDensity!,
//     src/BallTreeDensity01.jl:141-187): tot = wl + wr + eps, fl = wl/tot,
//     m = fl ml + fr mr, bw = fl (bl + ml^2) + fr (br + mr^2) - m^2, in the
//     plan's dtype and the twin's operation order.  Slot numbers follow
//     the tree's depth-first slot allocation, computed on the same walk;
//   epilogue: t_mean, t_bw, t_logw = log(max(w, tiny)) and t_perm at the
//     (set, density)'s slot range, the unused slots filled as the twin's;
//     then the level arrays (lvl_mean, lvl_bw, lvl_logw with the padding's
//     -inf, lvl_perm) and lvl_uniform from the cached level table.
//
// What bounds it: a plan is a few MB of gathers and a sort a depth, ~3 ms
// of the eager twin's device time at 2 x 20k, but the twin spends ~40 ms
// of host time in ~2,000 launches.  So the design is about launches, and
// then about spreading a depth's sorts over the SMs:
//   * a slice of at most SUBTREE_MAX_WIDTH points (ops/tree_build.py, a
//     few hundred; up to ~28k fit one block's shared memory at 8 bytes a
//     key in float32, 12 in float64) is finished by one block: every
//     depth of its subtree, then its moments, in one launch
//     (subtree_kernel).  Inside it a position's place in its sub-slice
//     is the count of the sub-slice's keys below its own, a few hundred
//     comparisons of shared keys at most and no barrier but the depth's;
//   * wider slices take the multi-block route a depth at a time: a block
//     a slice for the split dim (multi_stats_kernel), a block a chunk
//     sorting it in shared memory by a bitonic network (all comparators
//     ascending, the padding to a power of two virtual; multi_sort_kernel),
//     a thread an element
//     finding its rank in the slice by a binary search of every other
//     chunk (multi_rank_kernel); the moments above the subtrees in one
//     more launch (top_kernel).  One block a 20k slice would leave 130 of
//     the 132 SMs idle for ~5 ms.
// Sums take a fixed order for a given shape (no atomics), so a plan is the
// same from launch to launch.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDens = 16;     // densities a group of launches takes
constexpr int kMaxLevels = 64;   // ops/tree_build.py MAX_LEVELS
constexpr int kKeysOffset = 256;  // a subtree block's keys follow 32 doubles
constexpr unsigned kFull = 0xffffffffu;

// A group of densities j0 .. j0 + g - 1 of dn; the per-density entries
// are the group's, the slabs (set, density) those of the whole plan.
struct Args {
  int B, dn, j0, g, d, max_n, two_n, max_slices, chunk, depth, cap;
  int n[kMaxDens];
  int k0[kMaxDens];           // depths this density takes on the multi route
  const void* pts[kMaxDens];  // [B, n, d]
  const void* var[kMaxDens];  // [B, n, d]
  const void* w[kMaxDens];    // [B, n]
  void* t_mean;               // [B, dn, two_n, d]
  void* t_bw;
  void* t_logw;               // [B, dn, two_n]
  long long* t_perm;
  void* wts;                  // [B, dn, two_n]: the weights the sweep reads
  int* idx0;                  // [B, dn, max_n] x 2: the order, ping-pong
  int* idx1;
  uint64_t* keys;             // [B, dn, max_n]: chunk-sorted keys
  unsigned* ranks;            // [B, dn, max_n]: their positions (float64)
  int* dims;                  // [B, dn, max_slices]: the split dims
};

struct LevelArgs {
  int B, dn, d, two_n, T, L;
  int off[kMaxLevels];
  int wid[kMaxLevels];
  const int* nodes;             // [dn, T]
  const unsigned char* valid;   // [dn, T]
  const void* t_mean;
  const void* t_bw;
  const void* t_logw;
  const long long* t_perm;
  void* l_mean;                 // [B, dn, T, d]
  void* l_bw;
  void* l_logw;                 // [B, dn, T]
  long long* l_perm;
  unsigned char* l_uni;         // [B, dn, L, d]
};

// A node of the recursion: positions [lo, end), its slot, and c: its
// first internal child's slot is 1 + c (the depth-first allocation of
// ops/balltree.py::topology: a node's internal children take the next
// slots when it is popped, left first).
struct Node {
  int lo, end, slot, c;
};

// Node (k, t) of an n-point tree, t's bits the turns from the root (1 =
// right).  pre counts the internal nodes before the node in preorder, pend
// the internal right children of its ancestors still on the stack, so
// the slots allocated before its children are pre + pend.  Past a leaf the
// walk goes on through virtual nodes of size 1 and 0.
__device__ __forceinline__ Node walk_path(int n, int k, unsigned t) {
  int lo = 0, hi = n - 1, slot = 0, pre = 0, pend = 0;
  for (int j = k - 1; j >= 0; --j) {
    const int mid = (lo + hi) >> 1;
    const int ls = mid - lo + 1, rs = hi - mid;
    const int c = (j == k - 1) ? 0 : pre + pend;
    if (((t >> j) & 1u) == 0u) {
      pend += rs >= 2;
      slot = 1 + c;
      pre += 1;
      hi = mid;
    } else {
      slot = 1 + c + (ls >= 2);
      pre += ls;
      lo = mid + 1;
    }
  }
  Node nd;
  nd.lo = lo;
  nd.end = hi + 1;
  nd.slot = slot;
  nd.c = k == 0 ? 0 : pre + pend;
  return nd;
}

// Bounds [lo, end) of node t at depth r below a node of w positions,
// relative to its start ((lo + hi) // 2 shifts with an even offset).
__device__ __forceinline__ void walk_bounds(int w, int r, unsigned t, int& lo,
                                            int& end) {
  int a = 0, h = w - 1;
  for (int j = r - 1; j >= 0; --j) {
    const int mid = (a + h) >> 1;
    if (((t >> j) & 1u) == 0u) h = mid; else a = mid + 1;
  }
  lo = a;
  end = h + 1;
}

// The node at depth r below a node of w positions that holds position p.
__device__ __forceinline__ void walk_pos(int w, int r, int p, int& lo,
                                         int& end) {
  int a = 0, h = w - 1;
  for (int j = 0; j < r; ++j) {
    const int mid = (a + h) >> 1;
    if (p <= mid) h = mid; else a = mid + 1;
  }
  lo = a;
  end = h + 1;
}

__device__ __forceinline__ int at(const int* cur, int p) {
  return cur == nullptr ? p : cur[p];
}

// Order-preserving keys.  float32: the coordinate's bits in the high word
// (-0 as +0, as the twin's radix sort takes it) and the position in the
// low word, one unique 64-bit key; float64: the coordinate's bits, the
// position apart.
template <typename T> struct Key;
template <> struct Key<float> {
  static constexpr bool kRank = false;
  __device__ static uint64_t make(float x, unsigned pos) {
    unsigned u = x == 0.0f ? 0u : __float_as_uint(x);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((uint64_t)u << 32) | pos;
  }
};
template <> struct Key<double> {
  static constexpr bool kRank = true;
  __device__ static uint64_t make(double x, unsigned) {
    uint64_t u = x == 0.0 ? 0ull : (uint64_t)__double_as_longlong(x);
    return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
  }
};

template <bool R, typename RT>
__device__ __forceinline__ bool less(uint64_t ka, RT ra, uint64_t kb, RT rb) {
  if constexpr (R) return ka < kb || (ka == kb && ra < rb);
  return ka < kb;
}

template <bool R, typename RT>
__device__ __forceinline__ void exchange(uint64_t* keys, RT* ranks, int i,
                                         int j) {
  const uint64_t ki = keys[i], kj = keys[j];
  if constexpr (R) {
    const RT ri = ranks[i], rj = ranks[j];
    if (less<R, RT>(kj, rj, ki, ri)) {
      keys[i] = kj; keys[j] = ki;
      ranks[i] = rj; ranks[j] = ri;
    }
  } else {
    if (kj < ki) { keys[i] = kj; keys[j] = ki; }
  }
}

// Sorts the block's cnt shared keys, cnt <= P (P a power of two >= 2):
// the bitonic network whose comparators all put the smaller key first
// (the first step of each merge compares mirrored positions), so the
// padding to P is a run of virtual maxima that no comparator moves and
// every pair with its upper end past cnt is skipped.  Ends on a barrier.
template <bool R, typename RT>
__device__ void bitonic(uint64_t* keys, RT* ranks, int cnt, int P) {
  const int half = P >> 1;
  for (int size = 2; size <= P; size <<= 1) {
    const int hs = size >> 1, lhs = __ffs(hs) - 1;
    for (int q = threadIdx.x; q < half; q += blockDim.x) {
      const int i = ((q >> lhs) << (lhs + 1)) + (q & (hs - 1));
      const int j = i ^ (size - 1);
      if (j < cnt) exchange<R, RT>(keys, ranks, i, j);
    }
    __syncthreads();
    for (int st = hs >> 1; st > 0; st >>= 1) {
      const int ls = __ffs(st) - 1;
      for (int q = threadIdx.x; q < half; q += blockDim.x) {
        const int i = ((q >> ls) << (ls + 1)) + (q & (st - 1));
        const int j = i + st;
        if (j < cnt) exchange<R, RT>(keys, ranks, i, j);
      }
      __syncthreads();
    }
  }
}

// A warp's sum, the same double in every lane.
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}

// The sum over each group of G threads (a power of two >= 32) of the
// block, the same double in every thread of a group; every thread of the
// block calls it.
__device__ __forceinline__ double group_sum(double v, int G, double* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, wpg = G >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int g0 = warp - warp % wpg;
  double s = 0.0;
  for (int i = 0; i < wpg; ++i) s += red[g0 + i];
  __syncthreads();
  return s;
}

// The split dim of positions [lo, end) taken by G threads (this one the
// lane-th): the first argmax over dims of the sum of squared deviations
// from the unweighted mean, in float64.
template <typename T, typename Red>
__device__ int split_dim(const T* pts, const int* cur, int d, int lo, int end,
                         int lane, int G, Red red) {
  const double cnt = (double)(end - lo);
  double best = 0.0;
  int dim = 0;
  for (int kd = 0; kd < d; ++kd) {
    double s = 0.0;
    for (int p = lo + lane; p < end; p += G)
      s += (double)pts[(size_t)at(cur, p) * d + kd];
    const double mean = red(s) / cnt;
    double q = 0.0;
    for (int p = lo + lane; p < end; p += G) {
      const double dv = (double)pts[(size_t)at(cur, p) * d + kd] - mean;
      q += dv * dv;
    }
    q = red(q);
    if (kd == 0 || q > best) {
      best = q;
      dim = kd;
    }
  }
  return dim;
}

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// log(max(w, tiny)) as the twin's clamp_min and log (a NaN stays NaN)
template <typename T>
__device__ __forceinline__ T log_weight(T w) {
  return log_of(w < tiny<T>() ? tiny<T>() : w);
}

// Slot g from its children l and r (r == l for the lone root of N = 1).
template <typename T>
__device__ __forceinline__ void merge(T* mean, T* bw, T* wts, T* logw,
                                      long long* perm, int d, int g, int l,
                                      int r) {
  const T wl = wts[l], wr = wts[r];
  const T tot = (wl + wr) + (T)2.220446049250313e-16;
  const T fl = wl / tot, fr = wr / tot;
  for (int kd = 0; kd < d; ++kd) {
    const T ml = mean[(size_t)l * d + kd], mr = mean[(size_t)r * d + kd];
    const T bl = bw[(size_t)l * d + kd], br = bw[(size_t)r * d + kd];
    const T m = fl * ml + fr * mr;
    mean[(size_t)g * d + kd] = m;
    bw[(size_t)g * d + kd] = fl * (bl + ml * ml) + fr * (br + mr * mr) - m * m;
  }
  const T wg = l == r ? wl : wl + wr;
  wts[g] = wg;
  logw[g] = log_weight(wg);
  perm[g] = 0;
}

struct Slab {
  size_t sj;  // (set, density)
  int n;
};

__device__ __forceinline__ Slab slab(const Args& a) {
  Slab s;
  s.sj = (size_t)blockIdx.z * a.dn + a.j0 + blockIdx.y;
  s.n = a.n[blockIdx.y];
  return s;
}

// One block a slice of depth k0: every depth of its subtree, its leaves,
// its moments; block 0 of a (set, density) also fills the unused slots.
template <typename T>
__global__ void __launch_bounds__(1024) subtree_kernel(Args a) {
  using K = Key<T>;
  constexpr bool R = K::kRank;
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem + kKeysOffset);
  unsigned* ranks = reinterpret_cast<unsigned*>(keys + a.cap);
  const int j = blockIdx.y, b = blockIdx.z, d = a.d;
  const Slab sl = slab(a);
  const int n = sl.n, k0 = a.k0[j];
  if (blockIdx.x >= (1u << k0)) return;
  const Node root = walk_path(n, k0, blockIdx.x);
  const int Lo = root.lo, W = root.end - root.lo;
  if (W <= 0) return;
  const T* pts = static_cast<const T*>(a.pts[j]) + (size_t)b * n * d;
  const T* var = static_cast<const T*>(a.var[j]) + (size_t)b * n * d;
  const T* w = static_cast<const T*>(a.w[j]) + (size_t)b * n;
  int* buf[2] = {a.idx0 + sl.sj * a.max_n, a.idx1 + sl.sj * a.max_n};
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nw = nt >> 5;
  int k = k0, r = 0;
  for (;; ++r, ++k) {
    const int smax = (int)(((long long)W + (1ll << r) - 1) >> r);
    if (smax < 2) break;
    const int* cur = k == 0 ? nullptr : buf[k & 1];
    int* nxt = buf[(k + 1) & 1];
    const int S = 1 << r;
    // 1. each sub-slice's split dim and its keys
    auto put = [&](int lo, int end, int dim, int first, int step) {
      for (int p = lo + first; p < end; p += step) {
        keys[p] = K::make(pts[(size_t)at(cur, Lo + p) * d + dim], p);
        if constexpr (R) ranks[p] = (unsigned)p;
      }
    };
    if (S < nw) {
      const int G = nt / S, t = tid / G;
      int lo, end;
      walk_bounds(W, r, t, lo, end);
      const int dim = split_dim<T>(
          pts, cur, d, Lo + lo, Lo + end, tid % G, G,
          [&](double v) { return group_sum(v, G, red); });
      if (end - lo >= 2) put(lo, end, dim, tid % G, G);
    } else {
      for (int t = warp; t < S; t += nw) {
        int lo, end;
        walk_bounds(W, r, t, lo, end);
        if (end - lo < 2) continue;
        const int dim = split_dim<T>(pts, cur, d, Lo + lo, Lo + end, lane, 32,
                                     [](double v) { return warp_sum(v); });
        put(lo, end, dim, lane, 32);
      }
    }
    __syncthreads();
    // 2. each position's place in its sub-slice by (key, position): the
    // count of the keys below its own; the new order
    for (int p = tid; p < W; p += nt) {
      int lo, end;
      walk_pos(W, r, p, lo, end);
      int dst = p;
      if (end - lo >= 2) {
        const uint64_t kp = keys[p];
        unsigned rp = 0;
        if constexpr (R) rp = ranks[p];
        int c = 0;
        for (int q = lo; q < end; ++q) {
          unsigned rq = 0;
          if constexpr (R) rq = ranks[q];
          c += less<R, unsigned>(keys[q], rq, kp, rp);
        }
        dst = lo + c;
      }
      nxt[Lo + dst] = at(cur, Lo + p);
    }
    __syncthreads();
  }
  // 3. leaves, in the final order
  const int* fin = k == 0 ? nullptr : buf[k & 1];
  T* mean = static_cast<T*>(a.t_mean) + sl.sj * a.two_n * d;
  T* bw = static_cast<T*>(a.t_bw) + sl.sj * a.two_n * d;
  T* logw = static_cast<T*>(a.t_logw) + sl.sj * a.two_n;
  T* wts = static_cast<T*>(a.wts) + sl.sj * a.two_n;
  long long* perm = a.t_perm + sl.sj * a.two_n;
  for (int p = tid; p < W; p += nt) {
    const int i = at(fin, Lo + p);
    const size_t s = (size_t)n + Lo + p;
    for (int kd = 0; kd < d; ++kd) {
      mean[s * d + kd] = pts[(size_t)i * d + kd];
      bw[s * d + kd] = var[(size_t)i * d + kd];
    }
    const T wi = w[i];
    wts[s] = wi;
    logw[s] = log_weight(wi);
    perm[s] = i;
  }
  if (blockIdx.x == 0) {
    // the unused slots: n - 1 (between the internal nodes and the
    // leaves) and those past 2n up to the plan's widest density
    const int extra = a.two_n - 2 * n;
    for (int e = tid; e < extra + 1; e += nt) {
      int s;
      if (e == extra) {
        if (n < 2) continue;
        s = n - 1;
      } else {
        s = 2 * n + e;
      }
      for (int kd = 0; kd < d; ++kd) {
        mean[(size_t)s * d + kd] = (T)0;
        bw[(size_t)s * d + kd] = (T)1;
      }
      wts[s] = (T)0;
      logw[s] = s < 2 * n ? log_weight((T)0) : (T)(-INFINITY);
      perm[s] = 0;
    }
  }
  __syncthreads();
  // 4. the subtree's moments, bottom-up
  if (n == 1) {
    if (tid == 0) merge<T>(mean, bw, wts, logw, perm, d, 0, 1, 1);
    return;
  }
  for (int rr = r - 1; rr >= 0; --rr) {
    for (int t = tid; t < (1 << rr); t += nt) {
      const Node nd = walk_path(n, k0 + rr, (blockIdx.x << rr) | (unsigned)t);
      if (nd.end - nd.lo < 2) continue;
      const int hi = nd.end - 1, mid = (nd.lo + hi) >> 1;
      const int ls = mid - nd.lo + 1, rs = hi - mid;
      const int lslot = ls >= 2 ? 1 + nd.c : n + nd.lo;
      const int rslot = rs >= 2 ? 1 + nd.c + (ls >= 2) : n + hi;
      merge<T>(mean, bw, wts, logw, perm, d, nd.slot, lslot, rslot);
    }
    __syncthreads();
  }
}

// The moments of the nodes above the subtrees (depths < k0), a block a
// (set, density).
template <typename T>
__global__ void __launch_bounds__(1024) top_kernel(Args a) {
  const Slab sl = slab(a);
  const int n = sl.n, k0 = a.k0[blockIdx.y], d = a.d;
  T* mean = static_cast<T*>(a.t_mean) + sl.sj * a.two_n * d;
  T* bw = static_cast<T*>(a.t_bw) + sl.sj * a.two_n * d;
  T* logw = static_cast<T*>(a.t_logw) + sl.sj * a.two_n;
  T* wts = static_cast<T*>(a.wts) + sl.sj * a.two_n;
  long long* perm = a.t_perm + sl.sj * a.two_n;
  for (int k = k0 - 1; k >= 0; --k) {
    for (int t = threadIdx.x; t < (1 << k); t += blockDim.x) {
      const Node nd = walk_path(n, k, (unsigned)t);
      const int hi = nd.end - 1, mid = (nd.lo + hi) >> 1;
      const int ls = mid - nd.lo + 1, rs = hi - mid;
      const int lslot = ls >= 2 ? 1 + nd.c : n + nd.lo;
      const int rslot = rs >= 2 ? 1 + nd.c + (ls >= 2) : n + hi;
      merge<T>(mean, bw, wts, logw, perm, d, nd.slot, lslot, rslot);
    }
    __syncthreads();
  }
}

// Multi-block route, depth a.depth: a block a slice, its split dim.
template <typename T>
__global__ void __launch_bounds__(1024) multi_stats_kernel(Args a) {
  __shared__ double red[32];
  const int j = blockIdx.y, k = a.depth;
  const Slab sl = slab(a);
  if (k >= a.k0[j] || blockIdx.x >= (1u << k)) return;
  const Node nd = walk_path(sl.n, k, blockIdx.x);
  const T* pts =
      static_cast<const T*>(a.pts[j]) + (size_t)blockIdx.z * sl.n * a.d;
  const int* cur = k == 0 ? nullptr
                          : (k & 1 ? a.idx1 : a.idx0) + sl.sj * a.max_n;
  const int nt = blockDim.x;
  const int dim = split_dim<T>(pts, cur, a.d, nd.lo, nd.end, threadIdx.x, nt,
                               [&](double v) { return group_sum(v, nt, red); });
  if (threadIdx.x == 0) a.dims[sl.sj * a.max_slices + blockIdx.x] = dim;
}

// Multi-block route: a block a chunk of a.chunk positions of a slice, its
// keys sorted in shared memory and written back in place.
template <typename T>
__global__ void __launch_bounds__(1024) multi_sort_kernel(Args a) {
  using K = Key<T>;
  constexpr bool R = K::kRank;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
  unsigned* ranks = reinterpret_cast<unsigned*>(keys + a.chunk);
  const int j = blockIdx.y, k = a.depth;
  const Slab sl = slab(a);
  const int n = sl.n;
  if (k >= a.k0[j]) return;
  const int smax = (int)(((long long)n + (1ll << k) - 1) >> k);
  const int cps = (smax + a.chunk - 1) / a.chunk;
  if (blockIdx.x >= (unsigned)cps << k) return;
  const int t = blockIdx.x / cps, c = blockIdx.x % cps;
  const Node nd = walk_path(n, k, (unsigned)t);
  const int clo = nd.lo + c * a.chunk;
  const int cend = min(clo + a.chunk, nd.end);
  if (clo >= cend) return;
  const int cnt = cend - clo, dim = a.dims[sl.sj * a.max_slices + t];
  const T* pts =
      static_cast<const T*>(a.pts[j]) + (size_t)blockIdx.z * n * a.d;
  const int* cur = k == 0 ? nullptr
                          : (k & 1 ? a.idx1 : a.idx0) + sl.sj * a.max_n;
  for (int p = threadIdx.x; p < cnt; p += blockDim.x) {
    const unsigned pos = (unsigned)(clo + p - nd.lo);
    keys[p] = K::make(pts[(size_t)at(cur, clo + p) * a.d + dim], pos);
    if constexpr (R) ranks[p] = pos;
  }
  __syncthreads();
  int P = 2;
  while (P < cnt) P <<= 1;
  bitonic<R, unsigned>(keys, ranks, cnt, P);
  uint64_t* gk = a.keys + sl.sj * a.max_n + clo;
  for (int p = threadIdx.x; p < cnt; p += blockDim.x) {
    gk[p] = keys[p];
    if constexpr (R) a.ranks[sl.sj * a.max_n + clo + p] = ranks[p];
  }
}

// Multi-block route: a thread a position; its key's rank in its slice is
// its place in its own chunk plus the keys below it in every other chunk
// (a binary search each); the new order at the slice's start plus it.
template <typename T>
__global__ void multi_rank_kernel(Args a) {
  constexpr bool R = Key<T>::kRank;
  const int j = blockIdx.y, k = a.depth;
  const Slab sl = slab(a);
  const int n = sl.n;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.k0[j] || p >= n) return;
  int lo, end;
  walk_pos(n, k, p, lo, end);
  const int rel = p - lo, c = rel / a.chunk;
  const int nch = (end - lo + a.chunk - 1) / a.chunk;
  const uint64_t* keys = a.keys + sl.sj * a.max_n;
  const unsigned* ranks = R ? a.ranks + sl.sj * a.max_n : nullptr;
  const uint64_t kp = keys[p];
  unsigned rp = 0;
  if constexpr (R) rp = ranks[p];
  int rank = rel - c * a.chunk;
  for (int cc = 0; cc < nch; ++cc) {
    if (cc == c) continue;
    int L = lo + cc * a.chunk, H = min(L + a.chunk, end);
    const int x0 = L;
    while (L < H) {
      const int m = (L + H) >> 1;
      unsigned rm = 0;
      if constexpr (R) rm = ranks[m];
      if (less<R, unsigned>(keys[m], rm, kp, rp)) L = m + 1; else H = m;
    }
    rank += L - x0;
  }
  unsigned src;
  if constexpr (R) src = rp; else src = (unsigned)kp;
  const int* cur = k == 0 ? nullptr
                          : (k & 1 ? a.idx1 : a.idx0) + sl.sj * a.max_n;
  int* nxt = ((k + 1) & 1 ? a.idx1 : a.idx0) + sl.sj * a.max_n;
  nxt[lo + rank] = at(cur, lo + (int)src);
}

// The level arrays: a block a (level, density, set).
template <typename T>
__global__ void levels_kernel(LevelArgs a) {
  const int l = blockIdx.x, j = blockIdx.y, d = a.d;
  const size_t sj = (size_t)blockIdx.z * a.dn + j;
  const int o = a.off[l], wd = a.wid[l];
  const int* nodes = a.nodes + (size_t)j * a.T + o;
  const unsigned char* valid = a.valid + (size_t)j * a.T + o;
  const T* tm = static_cast<const T*>(a.t_mean) + sj * a.two_n * d;
  const T* tb = static_cast<const T*>(a.t_bw) + sj * a.two_n * d;
  const T* tl = static_cast<const T*>(a.t_logw) + sj * a.two_n;
  const long long* tp = a.t_perm + sj * a.two_n;
  T* lm = static_cast<T*>(a.l_mean) + (sj * a.T + o) * d;
  T* lb = static_cast<T*>(a.l_bw) + (sj * a.T + o) * d;
  T* ll = static_cast<T*>(a.l_logw) + sj * a.T + o;
  long long* lp = a.l_perm + sj * a.T + o;
  for (int i = threadIdx.x; i < wd; i += blockDim.x) {
    const size_t s = (size_t)nodes[i];
    for (int kd = 0; kd < d; ++kd) {
      lm[(size_t)i * d + kd] = tm[s * d + kd];
      lb[(size_t)i * d + kd] = tb[s * d + kd];
    }
    const T lw = tl[s];
    ll[i] = valid[i] ? lw : lw + (T)(-INFINITY);
    lp[i] = tp[s];
  }
  const size_t s0 = (size_t)nodes[0];
  for (int kd = 0; kd < d; ++kd) {
    const T ref = tb[s0 * d + kd];
    int same = 1;
    for (int i = threadIdx.x; i < wd; i += blockDim.x)
      same &= tb[(size_t)nodes[i] * d + kd] == ref;
    same = __syncthreads_and(same);
    if (threadIdx.x == 0)
      a.l_uni[(sj * a.L + l) * d + kd] = (unsigned char)same;
  }
}

#define KDE_CHECK()                               \
  do {                                            \
    const cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)

// One group's launches: the multi-block route's depths, the subtree
// launch, the moments above the subtrees.
template <typename T>
int run_group(Args a, int sub_threads, int sub_smem, int sort_smem,
              cudaStream_t st) {
  int max_k0 = 0;
  for (int j = 0; j < a.g; ++j) max_k0 = max(max_k0, a.k0[j]);
  cudaError_t e;
  if (max_k0 > 0) {
    e = cudaFuncSetAttribute(multi_sort_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sort_smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  for (int k = 0; k < max_k0; ++k) {
    a.depth = k;
    int grid = 1;
    for (int j = 0; j < a.g; ++j) {
      if (a.k0[j] <= k) continue;
      const int smax = (int)(((long long)a.n[j] + (1ll << k) - 1) >> k);
      grid = max(grid, ((smax + a.chunk - 1) / a.chunk) << k);
    }
    multi_stats_kernel<T><<<dim3(1u << k, a.g, a.B), 1024, 0, st>>>(a);
    KDE_CHECK();
    multi_sort_kernel<T><<<dim3(grid, a.g, a.B), 1024, sort_smem, st>>>(a);
    KDE_CHECK();
    multi_rank_kernel<T><<<dim3((a.max_n + 255) / 256, a.g, a.B), 256, 0,
                           st>>>(a);
    KDE_CHECK();
  }
  e = cudaFuncSetAttribute(subtree_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sub_smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  subtree_kernel<T><<<dim3(1u << max_k0, a.g, a.B), sub_threads, sub_smem,
                      st>>>(a);
  KDE_CHECK();
  if (max_k0 > 0) {
    top_kernel<T><<<dim3(1, a.g, a.B), 1024, 0, st>>>(a);
    KDE_CHECK();
  }
  return 0;
}

template <typename T>
int run_levels(const LevelArgs& lv, cudaStream_t st) {
  levels_kernel<T><<<dim3(lv.L, lv.dn, lv.B), 256, 0, st>>>(lv);
  KDE_CHECK();
  return 0;
}

}  // namespace

// One plan's launches (ops/tree_build.py::launch): for each group of at
// most kMaxDens densities the multi-block route for the depths k < k0[j],
// the subtree launch and the moments above the subtrees; then, with L >
// 0, the level arrays of every density.  ins holds each density's points,
// variances and weights pointers; offs the levels' (start, width).
// Returns the first CUDA error, 0 on success.
extern "C" int kde_tree_build(
    int itemsize, int B, int dn, int d, int max_n, int two_n, const int* n,
    const int* k0, const unsigned long long* ins, void* t_mean, void* t_bw,
    void* t_logw, void* t_perm, void* wts, void* idx, void* keys, void* ranks,
    void* dims, int max_slices, int chunk, int sub_threads, int sub_width,
    int sub_smem, int sort_smem, int L, int T, const int* offs,
    const void* nodes, const void* valid, void* l_mean, void* l_bw,
    void* l_logw, void* l_perm, void* l_uni, void* stream) {
  if (dn < 1 || L > kMaxLevels || (itemsize != 4 && itemsize != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.B = B; a.dn = dn; a.d = d; a.max_n = max_n; a.two_n = two_n;
  a.max_slices = max_slices; a.chunk = chunk; a.depth = 0; a.cap = sub_width;
  a.t_mean = t_mean; a.t_bw = t_bw; a.t_logw = t_logw;
  a.t_perm = static_cast<long long*>(t_perm); a.wts = wts;
  a.idx0 = static_cast<int*>(idx);
  a.idx1 = static_cast<int*>(idx) + (size_t)B * dn * max_n;
  a.keys = static_cast<uint64_t*>(keys);
  a.ranks = static_cast<unsigned*>(ranks);
  a.dims = static_cast<int*>(dims);
  for (int j0 = 0; j0 < dn; j0 += kMaxDens) {
    a.j0 = j0;
    a.g = min(kMaxDens, dn - j0);
    for (int j = 0; j < a.g; ++j) {
      const int jj = j0 + j;
      a.n[j] = n[jj];
      a.k0[j] = k0[jj];
      a.pts[j] = reinterpret_cast<const void*>(ins[3 * jj]);
      a.var[j] = reinterpret_cast<const void*>(ins[3 * jj + 1]);
      a.w[j] = reinterpret_cast<const void*>(ins[3 * jj + 2]);
    }
    const int rc = itemsize == 4
        ? run_group<float>(a, sub_threads, sub_smem, sort_smem, st)
        : run_group<double>(a, sub_threads, sub_smem, sort_smem, st);
    if (rc != 0) return rc;
  }
  if (L > 0) {
    LevelArgs lv;
    lv.B = B; lv.dn = dn; lv.d = d; lv.two_n = two_n; lv.T = T; lv.L = L;
    for (int l = 0; l < L; ++l) {
      lv.off[l] = offs[2 * l];
      lv.wid[l] = offs[2 * l + 1];
    }
    lv.nodes = static_cast<const int*>(nodes);
    lv.valid = static_cast<const unsigned char*>(valid);
    lv.t_mean = t_mean; lv.t_bw = t_bw; lv.t_logw = t_logw;
    lv.t_perm = static_cast<const long long*>(t_perm);
    lv.l_mean = l_mean; lv.l_bw = l_bw; lv.l_logw = l_logw;
    lv.l_perm = static_cast<long long*>(l_perm);
    lv.l_uni = static_cast<unsigned char*>(l_uni);
    return itemsize == 4 ? run_levels<float>(lv, st)
                         : run_levels<double>(lv, st);
  }
  return 0;
}
