// Tiled weighted log-sum-exp of a diagonal-Gaussian mixture, for Hopper
// (sm_90a).
//
// Replaces kde_tpu/ops/pallas_eval.py::_eval_kernel, the TPU Pallas kernel
// reached through pallas_log_eval.  For each query row m it computes
//
//   out[m] = log sum_n exp(c_n - sum_k (q_mk - mu_nk)^2 * hinv_nk)
//            - d/2 log(2 pi)
//
// with c_n = log w_n - 1/2 sum_k log var_nk and hinv = 1 / (2 var), both
// prepared by the wrapper (kde_tpu_torch/ops/tiled_eval.py) in O(N d).
// With loo, component m is skipped for query m; the caller applies the
// -log1p(-w) rescale.  A row whose every component is skipped gives -inf,
// as the Pallas kernel's guard does.
//
// What bounds it: the bytes are O((M + N) d), which is nothing, so the
// kernel is bound by one exp and about 2d FMAs per (query, component) pair.
// Design:
//   * one query per thread; its d coordinates and a running (max, sum)
//     live in registers, and the online log-sum-exp spends one exp per
//     pair;
//   * a block stages component tiles (mu, hinv, c) in shared memory; every
//     thread reads the same element at once (a broadcast, no bank
//     conflicts);
//   * the component axis is split over gridDim.y so that a few thousand
//     queries still put enough blocks on the 132 SMs; a second kernel
//     combines the per-split partial (max, sum) pairs;
//   * the ragged edges of M and N are masked here; nothing is padded in
//     device memory.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libtiled_eval.so tiled_eval.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kTile = 256;      // components per shared-memory tile
constexpr int kMaxDim = 16;     // largest d the kernel takes
constexpr float kLog2Pi = 1.8378770664093453f;

// D > 0: the dimension is a compile-time constant; D == 0: runtime d,
// at most kMaxDim.
template <int D, bool LOO>
__global__ void __launch_bounds__(kThreads)
tiled_eval_partial(const float* __restrict__ q,
                   const float* __restrict__ mu,
                   const float* __restrict__ hinv,
                   const float* __restrict__ c,
                   float* __restrict__ m_part,
                   float* __restrict__ s_part,
                   int M, int N, int d_rt, int per_split) {
  constexpr int DS = D > 0 ? D : kMaxDim;
  const int d = D > 0 ? D : d_rt;
  __shared__ float mu_s[kTile * DS];
  __shared__ float hinv_s[kTile * DS];
  __shared__ float c_s[kTile];

  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool live = qi < M;
  float qv[DS];
#pragma unroll
  for (int k = 0; k < DS; ++k)
    qv[k] = (live && k < d) ? q[(size_t)qi * d + k] : 0.f;

  const int n_begin = blockIdx.y * per_split;
  const int n_end = min(N, n_begin + per_split);
  float m = -INFINITY;
  float s = 0.f;
  for (int n0 = n_begin; n0 < n_end; n0 += kTile) {
    const int cnt = min(kTile, n_end - n0);
    __syncthreads();                       // the previous tile is consumed
    for (int i = threadIdx.x; i < cnt * d; i += kThreads) {
      mu_s[i] = mu[(size_t)n0 * d + i];
      hinv_s[i] = hinv[(size_t)n0 * d + i];
    }
    for (int i = threadIdx.x; i < cnt; i += kThreads) c_s[i] = c[n0 + i];
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      if (LOO && n0 + j == qi) continue;
      float l = c_s[j];
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        if (k < d) {
          const float t = qv[k] - mu_s[j * d + k];
          l = fmaf(-t * t, hinv_s[j * d + k], l);
        }
      }
      // online log-sum-exp; -inf logits (zero weight) add nothing
      if (l > m) {
        s = fmaf(s, __expf(m - l), 1.f);
        m = l;
      } else if (l > -INFINITY) {
        s += __expf(l - m);
      }
    }
  }
  if (live) {
    m_part[(size_t)blockIdx.y * M + qi] = m;
    s_part[(size_t)blockIdx.y * M + qi] = s;
  }
}

__global__ void tiled_eval_combine(const float* __restrict__ m_part,
                                   const float* __restrict__ s_part,
                                   float* __restrict__ out,
                                   int M, int splits, int d) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= M) return;
  float mx = -INFINITY;
  for (int p = 0; p < splits; ++p)
    mx = fmaxf(mx, m_part[(size_t)p * M + qi]);
  if (mx == -INFINITY) {                   // every component masked
    out[qi] = -INFINITY;
    return;
  }
  float s = 0.f;
  for (int p = 0; p < splits; ++p) {
    const float mp = m_part[(size_t)p * M + qi];
    if (mp > -INFINITY) s += s_part[(size_t)p * M + qi] * expf(mp - mx);
  }
  out[qi] = logf(s) + mx - 0.5f * d * kLog2Pi;
}

template <int D>
void launch_partial(dim3 grid, cudaStream_t st, bool loo, const float* q,
                    const float* mu, const float* hinv, const float* c,
                    float* m_part, float* s_part, int M, int N, int d,
                    int per_split) {
  if (loo)
    tiled_eval_partial<D, true><<<grid, kThreads, 0, st>>>(
        q, mu, hinv, c, m_part, s_part, M, N, d, per_split);
  else
    tiled_eval_partial<D, false><<<grid, kThreads, 0, st>>>(
        q, mu, hinv, c, m_part, s_part, M, N, d, per_split);
}

}  // namespace

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
// m_part and s_part hold splits * M floats each.
extern "C" int kde_tiled_log_eval(const float* q, const float* mu,
                                  const float* hinv, const float* c,
                                  float* m_part, float* s_part, float* out,
                                  int M, int N, int d, int loo, int splits,
                                  void* stream) {
  if (d < 1 || d > kMaxDim || splits < 1 || splits > 65535 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int per_split = ((N + splits - 1) / splits + kTile - 1) / kTile * kTile;
  const dim3 grid((M + kThreads - 1) / kThreads, splits);
  const bool l = loo != 0;
  switch (d) {
    case 1: launch_partial<1>(grid, st, l, q, mu, hinv, c, m_part, s_part, M, N, d, per_split); break;
    case 2: launch_partial<2>(grid, st, l, q, mu, hinv, c, m_part, s_part, M, N, d, per_split); break;
    case 3: launch_partial<3>(grid, st, l, q, mu, hinv, c, m_part, s_part, M, N, d, per_split); break;
    case 4: launch_partial<4>(grid, st, l, q, mu, hinv, c, m_part, s_part, M, N, d, per_split); break;
    case 5: launch_partial<5>(grid, st, l, q, mu, hinv, c, m_part, s_part, M, N, d, per_split); break;
    case 6: launch_partial<6>(grid, st, l, q, mu, hinv, c, m_part, s_part, M, N, d, per_split); break;
    case 7: launch_partial<7>(grid, st, l, q, mu, hinv, c, m_part, s_part, M, N, d, per_split); break;
    case 8: launch_partial<8>(grid, st, l, q, mu, hinv, c, m_part, s_part, M, N, d, per_split); break;
    default: launch_partial<0>(grid, st, l, q, mu, hinv, c, m_part, s_part, M, N, d, per_split); break;
  }
  tiled_eval_combine<<<(M + 255) / 256, 256, 0, st>>>(m_part, s_part, out, M,
                                                     splits, d);
  return (int)cudaGetLastError();
}
