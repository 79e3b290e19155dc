// What the learner's libraries (`net_train_epilogue.cu`,
// `nbt_train_epilogue.cu`) share: a pass's per-block partial sums and the
// finishing launches that add them up, each in a fixed order (no atomics),
// so that two calls on the same input give the same bits and a plain
// version can follow the order.  Included after `lanes.cuh`, into the
// library's own unnamed namespace.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kFinishX = 32;    // a finishing block: 32 channels ...
constexpr int kFinishY = 8;     // ... x 8 rows of partials

// Writes a block's sums over its rows of K per-lane accumulators, in row
// order, to partials[blockIdx.x][k][c]; red holds a block's threads' L
// lanes.
template <int K, int L, int N>
__device__ __forceinline__ void block_partials(float (&red)[K][N],
                                               const float (&acc)[K][L],
                                               float* __restrict__ partials,
                                               int C) {
  const int at = threadIdx.y * C + threadIdx.x * L;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < L; ++j) red[k][at + j] = acc[k][j];
  __syncthreads();
  const int nt = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < K * C; i += nt) {
    const int k = i / C, c = i - k * C;
    float a = 0.0f;
    for (int r = 0; r < static_cast<int>(blockDim.y); ++r)
      a = __fadd_rn(a, red[k][r * C + c]);
    partials[(static_cast<long long>(blockIdx.x) * K + k) * C + c] = a;
  }
}

// Sums K partials [G][K][C] of channel c over the G blocks in double, in a
// fixed order: thread (x, y) sums blocks y, y + 8, ... and row 0 sums the 8
// rows.  True on the threads that hold a channel's sums.
template <int K>
__device__ __forceinline__ bool finish_sums(const float* __restrict__ partials,
                                            int G, int C, double (&out)[K],
                                            int& c) {
  __shared__ double red[K][kFinishY][kFinishX];
  c = blockIdx.x * kFinishX + threadIdx.x;
  double a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = 0.0;
  if (c < C)
    for (int g = threadIdx.y; g < G; g += kFinishY)
#pragma unroll
      for (int k = 0; k < K; ++k)
        a[k] = __dadd_rn(
            a[k], partials[(static_cast<long long>(g) * K + k) * C + c]);
#pragma unroll
  for (int k = 0; k < K; ++k) red[k][threadIdx.y][threadIdx.x] = a[k];
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double t = 0.0;
    for (int r = 0; r < kFinishY; ++r)
      t = __dadd_rn(t, red[k][r][threadIdx.x]);
    out[k] = t;
  }
  return true;
}

__device__ __forceinline__ double rstd_of(float var, double eps) {
  return __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(static_cast<double>(var), eps)));
}

// The backward's per-channel results from the reduce pass's partials of
// S1 = sum(gy) and S2 = sum(gy (f - mean)): d bias = S1, d weight = S2
// rstd, and the apply pass's coefficients -mul S1 / n and -gate mul rstd^2
// S2 / n
__global__ void __launch_bounds__(kFinishX* kFinishY)
    grad_finish(const float* __restrict__ partials, int G, int C, double n,
                double eps, const float* __restrict__ var,
                const float* __restrict__ mul, const float* __restrict__ gate,
                float* __restrict__ dweight, float* __restrict__ dbias,
                float* __restrict__ coef1, float* __restrict__ coef2) {
  double s[2];
  int c;
  if (!finish_sums<2>(partials, G, C, s, c)) return;
  const double rstd = rstd_of(var[c], eps);
  const double k = mul[c];
  dbias[c] = static_cast<float>(s[0]);
  dweight[c] = static_cast<float>(s[1] * rstd);
  coef1[c] = static_cast<float>(-k * s[0] / n);
  coef2[c] = static_cast<float>(-k * gate[c] * s[1] * rstd * rstd / n);
}

inline int finish_grid(int C) { return (C + kFinishX - 1) / kFinishX; }

}  // namespace
