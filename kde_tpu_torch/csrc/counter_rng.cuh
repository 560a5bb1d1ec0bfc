// Counter-based uniforms for the Gumbel-max draw of the Gibbs kernels
// (csrc/gibbs_select.cu and csrc/gibbs_chain.cu include this header; the
// torch twin is kde_tpu_torch/utils/random.py: threefry2x32, fold_in,
// counter_uniform).
//
// On the TPU the chain's Gumbel noise is a pure function of the chain's key
// and a static stage id (kde_tpu/ops/gibbs.py::_gibbs_from_key splits one
// key a chain, _run_chain folds the stage id in), so XLA fuses the draw
// into the chain.  Here the noise is a pure function of
//
//   (the set's seed, the global chain index, the selection id, the candidate)
//
// drawn in registers where it is used:
//   * Threefry-2x32 with 20 rounds, the block function JAX's threefry_2x32
//     computes (Salmon et al., "Parallel random numbers: as easy as 1, 2,
//     3", SC 2011): integer adds, rotates and xors only;
//   * the selection's key: fold_in(fold_in(seed, chain), selection), where
//     fold_in(k, x) = threefry2x32(k, (0, x)) as jax.random.fold_in;
//   * the block at counter (2q, 2q + 1) under that key gives float
//     candidates 2q and 2q + 1 a word each, or double candidate q both
//     words;
//   * a word maps to float as ((bits >> 9) | 0x3f800000) read as a float,
//     minus 1 (23 bits); two words to double as the top 52 bits of
//     (hi << 32 | lo) under the exponent of 1, minus 1; then the clamp to
//     [tiny, 1 - eps] of ops/gibbs.py::_gumbel_noise.
// Every step is exact integer or exactly rounded float arithmetic, so the
// twin gives the same bits on any device.

#pragma once

#include <cfloat>

namespace kde_rng {

struct Key {
  unsigned k0, k1;
};

__device__ __forceinline__ unsigned rotl32(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: the block of counter (x0, x1) under key k.
__device__ __forceinline__ uint2 threefry2x32(Key k, unsigned x0,
                                              unsigned x1) {
  const unsigned k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += k.k0;
  x1 += k.k1;
#define KDE_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl32(x1, r);   \
  x1 ^= x0;
#define KDE_TF_GROUP(a, b, c, d) \
  KDE_TF_ROUND(a) KDE_TF_ROUND(b) KDE_TF_ROUND(c) KDE_TF_ROUND(d)
  KDE_TF_GROUP(13, 15, 26, 6)
  x0 += k.k1;
  x1 += k2 + 1u;
  KDE_TF_GROUP(17, 29, 16, 24)
  x0 += k2;
  x1 += k.k0 + 2u;
  KDE_TF_GROUP(13, 15, 26, 6)
  x0 += k.k0;
  x1 += k.k1 + 3u;
  KDE_TF_GROUP(17, 29, 16, 24)
  x0 += k.k1;
  x1 += k2 + 4u;
  KDE_TF_GROUP(13, 15, 26, 6)
  x0 += k2;
  x1 += k.k0 + 5u;
#undef KDE_TF_GROUP
#undef KDE_TF_ROUND
  return make_uint2(x0, x1);
}

__device__ __forceinline__ Key fold_in(Key k, unsigned x) {
  const uint2 y = threefry2x32(k, 0u, x);
  return Key{y.x, y.y};
}

// The key of one selection of one chain; seed: the set's two words.
__device__ __forceinline__ Key selection_key(const long long* seed,
                                             unsigned chain, unsigned sel) {
  const Key s{(unsigned)seed[0], (unsigned)seed[1]};
  return fold_in(fold_in(s, chain), sel);
}

// The clamped uniforms of block q: float candidates 2q and 2q + 1
// (kPer = 2), or double candidate q (kPer = 1).
template <typename T>
struct Uniform;

template <>
struct Uniform<float> {
  static constexpr int kPer = 2;
  __device__ static __forceinline__ float unit(unsigned w) {
    const float u = __uint_as_float((w >> 9) | 0x3f800000u) - 1.0f;
    return fminf(fmaxf(u, FLT_MIN), 1.0f - FLT_EPSILON);
  }
  __device__ static __forceinline__ void draw(Key k, int q, float (&g)[2]) {
    const uint2 y = threefry2x32(k, 2u * (unsigned)q, 2u * (unsigned)q + 1u);
    g[0] = unit(y.x);
    g[1] = unit(y.y);
  }
};

template <>
struct Uniform<double> {
  static constexpr int kPer = 1;
  __device__ static __forceinline__ void draw(Key k, int q, double (&g)[1]) {
    const uint2 y = threefry2x32(k, 2u * (unsigned)q, 2u * (unsigned)q + 1u);
    const unsigned long long m =
        ((unsigned long long)y.x << 20) | (unsigned long long)(y.y >> 12);
    const double u =
        __longlong_as_double((long long)(m | 0x3ff0000000000000ull)) - 1.0;
    g[0] = fmin(fmax(u, DBL_MIN), 1.0 - DBL_EPSILON);
  }
};

}  // namespace kde_rng
