// The probe arithmetic of a LOOCV golden search, shared by
// csrc/loo_search.cu (K4) and csrc/sharded_loo.cu (K7), so both issue the
// same instructions for a probe's terms and sums:
//
//   * Num<T>: a term's exp in T's units.  float32 is one ex2.approx.ftz
//     with log2 e folded into the probe's scale and the shift; float64 is
//     exp in natural units;
//   * pair_term: w_j exp(-(x_i - x_j)^2 / (2 var)), shifted by x_i's
//     nearest live neighbour, as one FMA into the running sum;
//   * stage: a tile of kTile staged components (x, w) into shared memory
//     with cp.async.  Components whose weight is 0, and the padding past
//     the last one, are staged as x = +inf (staged_x), so they add exactly
//     0 to a sum and nothing to a nearest-neighbour min, with no branch;
//   * tile_pass: one staged tile against a warp's kQ queries: the least
//     squared distance to a live component (kDmin), or the tile's shifted
//     terms of each query summed in T and added to a double.  With kMask
//     the LOO diagonal is masked: col0 is the tile's first column and
//     iq[q] the query's index, both global, so a shard passes its column
//     offset and its query offset and the diagonal of the whole [N, N]
//     problem is the one masked.
//
// Built with --fmad=false by both, so a term rounds as in K4 wherever it
// is computed.

#pragma once

#include <math.h>
#include <stdint.h>

namespace kde_loo {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 4;                      // queries a warp
constexpr int kGroup = kWarps * kQ;        // queries a work item
constexpr int kTile = 1024;                // components a staged tile
constexpr double kLog2Pi = 1.8378770664093453;   // float(np.log(2 * np.pi))
constexpr double kLog2e = 1.4426950408889634;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The exp of a term in T's units: float32 works in log2 units (its scale
// is log2 e), float64 in natural ones.
template <typename T> struct Num;
template <> struct Num<float> {
  using V = float4;
  static constexpr int kVec = 4;
  static constexpr double kScale = kLog2e;
  static __device__ __forceinline__ float exp_(float t) { return ex2(t); }
  static __device__ __forceinline__ float fma_(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  static __device__ __forceinline__ void unpack(const V& v, float (&o)[4]) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Num<double> {
  using V = double2;
  static constexpr int kVec = 2;
  static constexpr double kScale = 1.0;
  static __device__ __forceinline__ double exp_(double t) { return exp(t); }
  static __device__ __forceinline__ double fma_(double a, double b,
                                                double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ __forceinline__ void unpack(const V& v, double (&o)[2]) {
    o[0] = v.x; o[1] = v.y;
  }
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmin(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One term of a probe: w_j exp(-(x_i - x_j)^2 / (2 var)) shifted by x_i's
// nearest live neighbour, nh = -scale / (2 var), off = -dmin nh.  K4's
// never-launched kernel loo_pair_probe holds it once, so that
// chip_smoke.py can count its FP64 instructions in the SASS.
template <typename T>
__device__ __forceinline__ T pair_term(T xq, T xj, T wj, T nh, T off, T acc) {
  const T d = xq - xj;
  return Num<T>::fma_(wj, Num<T>::exp_(Num<T>::fma_(d * d, nh, off)), acc);
}

// Component j of a row x (element j at x[j stride]) with weights w[n] as
// staged: x_j where it is live, +inf for a zero weight or the padding past
// the last component.
template <typename T>
__device__ __forceinline__ T staged_x(const T* x, const T* w, int j, int n,
                                      int stride = 1) {
  return (j < n && w[j] > T(0)) ? x[j * stride] : (T)INFINITY;
}

// Stage tile t of row xs (and of wp) into buffer b: 16-byte cp.async,
// every thread a share.
template <typename T>
__device__ __forceinline__ void stage(T* tiles, int b, const T* xs,
                                      const T* wp, int t) {
  T* sx = tiles + b * 2 * kTile;
  T* sw = sx + kTile;
  constexpr int kChunks = kTile * (int)sizeof(T) / 16;
  constexpr int kPer = 16 / (int)sizeof(T);
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    cp_async16(sx + c * kPer, xs + (size_t)t * kTile + c * kPer);
    cp_async16(sw + c * kPer, wp + (size_t)t * kTile + c * kPer);
  }
  cp_async_commit();
}

// One staged tile against a warp's kQ queries.  kDmin: the least squared
// distance to a live component; else the probe's shifted sum, a tile's
// terms summed in T and added to the double accumulator.
template <typename T, bool kDmin, bool kMask>
__device__ __forceinline__ void tile_pass(const T* sx, const T* sw, int col0,
                                          const T (&xq)[kQ],
                                          const T (&off)[kQ],
                                          const int (&iq)[kQ], T nh,
                                          T (&mn)[kQ], double (&acc)[kQ]) {
  using N = Num<T>;
  using V = typename N::V;
  constexpr int kV = N::kVec;
  const int lane = threadIdx.x & 31;
  T ts[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) ts[q] = T(0);
#pragma unroll 2
  for (int k = 0; k < kTile / (32 * kV); ++k) {
    const int v = lane + 32 * k;
    T xv[kV], wv[kV];
    N::unpack(reinterpret_cast<const V*>(sx)[v], xv);
    if (!kDmin) N::unpack(reinterpret_cast<const V*>(sw)[v], wv);
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int j = col0 + v * kV + u;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (kDmin) {
          const T d = xq[q] - xv[u];
          const T dd = d * d;
          if (!kMask || j != iq[q]) mn[q] = fmin(mn[q], dd);
        } else {
          // the diagonal adds nothing (its shifted exp may be +inf)
          const T t = pair_term(xq[q], xv[u], wv[u], nh, off[q], ts[q]);
          ts[q] = (kMask && j == iq[q]) ? ts[q] : t;
        }
      }
    }
  }
  if (!kDmin) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] += (double)ts[q];
  }
}

}  // namespace kde_loo
