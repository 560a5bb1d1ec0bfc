// Native ball-tree construction for kde_tpu_torch: the host-side
// preprocessing of host-backed densities (KDE.tree), the counterpart of
// kde_tpu/native/balltree.cpp with the same C entry and argument order.
//
// Semantics are identical to the NumPy builder in ops/balltree.py (itself
// behavior-parity with the reference's Julia construction, reference
// src/BallTree01.jl + src/BallTreeDensity01.jl): median split via
// quickselect (Lomuto partition, middle-element pivot), split dimension =
// max variance over the leaf slice computed over leaves low..high-1 with
// weight 1/(high-low), DFS slot allocation (children allocated left-then-
// right before recursing), and bottom-up bounding-box + moment-matched
// Gaussian statistics.  The output must stay bit-identical to the NumPy
// builder, so it is compiled with -ffp-contract=off (no fused a*b+c) and
// never with -ffast-math (kde_tpu_torch/native.py); the tests compare the
// two array for array (tests/test_torch_native_balltree.py).
//
// Built as a shared library with g++ and bound with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

namespace {

struct Builder {
  int64_t n;            // number of points
  int64_t d;            // dims
  const double* pts;    // [n, d] row-major
  int64_t* order;       // [n] leaf-slot -> point index, permuted in place
  int64_t next_slot;
  // outputs, all length 2n (x d where noted)
  double* centers;      // [2n, d]
  double* ranges;       // [2n, d]
  double* weights;      // [2n]
  int64_t* left;
  int64_t* right;
  int64_t* lowest;
  int64_t* highest;
  int64_t* perm;
  double* means;        // [2n, d]
  double* bw;           // [2n, d]
  double* bw_min;       // [2n, d] (multibw) or unused
  double* bw_max;
  int multibw;
  int64_t* depth;

  // reference src/BallTree01.jl:142-173 -- mean/variance over leaves
  // low..high-1 (last excluded) with weight 1/(high-low); ties keep the
  // lowest dimension (strict > from 0).
  int most_spread_dim(int64_t low, int64_t high) const {
    double max_var = 0.0;
    int max_dim = 0;
    const double w = 1.0 / static_cast<double>(high - low);
    for (int k = 0; k < d; ++k) {
      double mean = 0.0;
      for (int64_t i = low; i < high; ++i)
        mean += w * pts[order[i] * d + k];
      double var = 0.0;
      for (int64_t i = low; i < high; ++i) {
        const double dx = pts[order[i] * d + k] - mean;
        var += dx * dx;
      }
      if (var > max_var) {
        max_var = var;
        max_dim = k;
      }
    }
    return max_dim;
  }

  // reference src/BallTree01.jl:223-242 -- quickselect, Lomuto partition
  // with the middle element as pivot.
  void select(int dim, int64_t position, int64_t low, int64_t high) {
    while (low < high) {
      const int64_t r = (low + high) / 2;
      std::swap(order[r], order[low]);
      const double pivot = pts[order[low] * d + dim];
      int64_t m = low;
      for (int64_t i = low; i <= high; ++i) {
        if (pts[order[i] * d + dim] < pivot) {
          ++m;
          std::swap(order[m], order[i]);
        }
      }
      std::swap(order[low], order[m]);
      if (m <= position) low = m + 1;
      if (m >= position) high = m - 1;
    }
  }

  // reference src/BallTree01.jl:342-411.  Topology + permutation only; all
  // node statistics are computed afterwards in one bottom-up pass
  // (kde_recalc_stats), once the leaf payloads are in place.
  void build(int64_t low, int64_t high, int64_t slot, int64_t dep) {
    depth[slot] = dep;
    if (low == high) {  // single-point tree (root only)
      lowest[slot] = n + low;
      highest[slot] = n + high;
      left[slot] = n + low;
      right[slot] = -1;
      return;
    }
    const int dim = most_spread_dim(low, high);
    const int64_t split = (low + high) / 2;
    select(dim, split, low, high);
    int64_t lslot, rslot;
    if (split <= low) lslot = n + low; else lslot = next_slot++;
    if (split + 1 >= high) rslot = n + high; else rslot = next_slot++;
    lowest[slot] = n + low;
    highest[slot] = n + high;
    left[slot] = lslot;
    right[slot] = rslot;
    if (lslot < n) build(low, split, lslot, dep + 1);
    else depth[lslot] = dep + 1;
    if (rslot < n) build(split + 1, high, rslot, dep + 1);
    else depth[rslot] = dep + 1;
  }
};

}  // namespace

extern "C" {

void kde_recalc_stats(int64_t n, int64_t d, int multibw,
                      double* centers, double* ranges, double* weights,
                      const int64_t* left, const int64_t* right,
                      const int64_t* depth,
                      double* means, double* bw, double* bw_min,
                      double* bw_max);

// All output arrays must be zero-initialized by the caller (unused slots
// stay zero, matching the golden fixtures).  bw_leaf is [n, d] variances.
void kde_build_balltree(const double* pts, const double* w,
                        const double* bw_leaf, int64_t n, int64_t d,
                        int multibw,
                        double* centers, double* ranges, double* weights,
                        int64_t* left, int64_t* right, int64_t* lowest,
                        int64_t* highest, int64_t* perm,
                        double* means, double* bw, double* bw_min,
                        double* bw_max, int64_t* depth) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;

  Builder b{n, d, pts, order.data(), 1,
            centers, ranges, weights, left, right, lowest, highest, perm,
            means, bw, bw_min, bw_max, multibw, depth};
  for (int64_t i = 0; i < 2 * n; ++i) depth[i] = -1;
  b.build(0, n - 1, 0, 0);

  // leaves (reference src/BallTree01.jl:415-429 + density overlay)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = n + i;
    const int64_t p = order[i];
    perm[s] = p;
    weights[s] = w[p];
    lowest[s] = s;
    highest[s] = s;
    left[s] = s;
    right[s] = -1;
    for (int64_t k = 0; k < d; ++k) {
      centers[s * d + k] = pts[p * d + k];
      means[s * d + k] = pts[p * d + k];
      ranges[s * d + k] = 0.0;
      bw[s * d + k] = bw_leaf[p * d + k];
      if (multibw) {
        bw_min[s * d + k] = bw_leaf[p * d + k];
        bw_max[s * d + k] = bw_leaf[p * d + k];
      }
    }
  }
  kde_recalc_stats(n, d, multibw, centers, ranges, weights, left, right,
                   depth, means, bw, bw_min, bw_max);
}

// Recompute all internal-node statistics bottom-up (called after leaves are
// final; processing slots in descending order guarantees children first,
// since child slots are always greater than their parent's).
void kde_recalc_stats(int64_t n, int64_t d, int multibw,
                      double* centers, double* ranges, double* weights,
                      const int64_t* left, const int64_t* right,
                      const int64_t* depth,
                      double* means, double* bw, double* bw_min,
                      double* bw_max) {
  for (int64_t slot = n - 1; slot >= 0; --slot) {
    if (depth[slot] < 0) continue;  // unallocated
    const int64_t li = left[slot];
    int64_t ri = right[slot];
    if (ri < 0) ri = li;
    const double wl = weights[li];
    const double wr = weights[ri];
    weights[slot] = (li == ri) ? wl : wl + wr;
    const double wt = wl + wr + std::numeric_limits<double>::epsilon();
    const double fl = wl / wt, fr = wr / wt;
    for (int64_t k = 0; k < d; ++k) {
      const double cl = centers[li * d + k], rl = ranges[li * d + k];
      const double cr = centers[ri * d + k], rr = ranges[ri * d + k];
      const double maxi = std::max(cl + rl, cr + rr);
      const double mini = std::min(cl - rl, cr - rr);
      const double half = (maxi - mini) / 2.0;
      ranges[slot * d + k] = half;
      centers[slot * d + k] = mini + half;
      const double ml = means[li * d + k], mr = means[ri * d + k];
      const double m = fl * ml + fr * mr;
      means[slot * d + k] = m;
      bw[slot * d + k] = fl * (bw[li * d + k] + ml * ml) +
                         fr * (bw[ri * d + k] + mr * mr) - m * m;
      if (multibw) {
        bw_max[slot * d + k] = std::max(bw_max[li * d + k], bw_max[ri * d + k]);
        bw_min[slot * d + k] = std::min(bw_min[li * d + k], bw_min[ri * d + k]);
      }
    }
  }
}

}  // extern "C"
