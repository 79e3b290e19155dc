// Batch-statistics BatchNorm of the learner's trunk, forward statistics and
// backward, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves flax's BatchNorm in
// training mode to XLA, which fuses its reductions and elementwise passes
// into the convolutions' neighbours.  The port's training forward ran each
// trunk BatchNorm as torch passes in fp32 (an upcast, a mean, x * x, a
// second mean, the normalisation, ReLU, a cast back, the skip add), each
// with its autograd backward: about 12 GB of traffic a layer forward and 18
// GB backward at B = 2048, 19x19 and 256 channels.
//
// A trunk layer of a training step, for v the convolution's NHWC output
// without its bias, n = B H W pixels and channel c = index % C:
//   u    = T(float(v) + float(conv_bias[c]))           (with a conv bias)
//   mean = sum(u) / n,  var = max(0, sum(u^2) / n - mean^2)     (flax's)
//   mul  = rsqrt(var + eps) * weight
//   out  = T(relu((u - mean) * mul + bias))     (skip: T(relu(skip + out)))
// The last line is the serving epilogue (`net_epilogue.cu`'s
// `epilogue_kernel`), which the caller launches unchanged with this mean
// and mul.  This file computes the statistics (`net_train_stats`) and the
// backward (`net_train_grad`), given g = d out:
//   gs     = out > 0 ? g : 0               (skip layers; it is also d skip)
//   d      = u - mean,  y = d * mul + bias (the forward's roundings)
//   gy     = y > 0 ? float(gs) : 0
//   S1     = sum(gy),   S2 = sum(gy * d)
//   d bias = S1,        d weight = S2 * rstd          (rstd = rsqrt(var + eps))
//   du     = T(mul * gy - mul * S1 / n - gate * mul * rstd^2 * S2 / n * d)
//   d conv_bias = sum(float(du))
// where gate is 1 if E[u^2] - mean^2 >= 0 (the clamp passes the gradient)
// and 0 where it was clamped: the standard BatchNorm-training gradient for
// flax's variance, whose derivative in u is that of the centred variance.
// The masks follow torch's ReLU backward (a NaN output passes the
// gradient), and y is recomputed with the forward's roundings
// (__fsub_rn / __fmul_rn / __fadd_rn: no contraction into an FMA), so the
// inner mask is the forward's.  Nothing in fp32 is saved between the passes.
//
// Determinism: every sum is taken in a fixed order, with no atomics.  Each
// thread sums its pixels in order, a block sums its rows in order into one
// partial a channel, and a second, small launch sums the blocks' partials
// in order, in double.  The number of blocks depends on the card and the
// shape only, so two calls on the same input give the same bits, which the
// learner's block remat relies on: the recomputed forward is the forward.
//
// What bounds it: bytes.  At B = 2048, 19x19 and 256 channels an activation
// is 0.379 GB in bf16.  The statistics read v once (0.11 ms at 3.35 TB/s);
// the backward's reduce pass reads v and g (and out on a skip layer), its
// apply pass reads them again and writes du (and d skip).  Design, as the
// serving epilogue's:
//   - each thread moves 16-byte vectors: 8 bf16 channels (4 fp32) of one
//     pixel, so a warp reads 512 contiguous bytes;
//   - a block is (C / lanes) x rows threads: threadIdx.x picks the channel
//     group, fixed for every pixel the thread visits, so the per-channel
//     constants sit in registers and no index is divided;
//   - a grid-stride loop over pixels with one wave of blocks, two pixels in
//     flight per thread;
//   - a block's partial sums go through shared memory, one row after the
//     other; the finishing launches are 32 channels x 8 rows a block;
//   - launched on the caller's stream; no allocation, no synchronisation.

#include <climits>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 256;   // the most threads of a pass's block
constexpr int kFinishX = 32;    // a finishing block: 32 channels ...
constexpr int kFinishY = 8;     // ... x 8 rows of partials

// torch's ReLU backward passes the gradient unless the output is <= 0
__device__ __forceinline__ bool passes(float out) { return !(out <= 0.0f); }

// u of the forward: the convolution's output with its bias added, rounded
// to T as cuDNN's own bias add rounds it
template <typename T, bool kBias>
__device__ __forceinline__ float unbiased(T v, float cb) {
  float f = to_f(v);
  if constexpr (kBias) f = to_f(from_f<T>(__fadd_rn(f, cb)));
  return f;
}

// Writes a block's sums over its rows of K per-lane accumulators, in row
// order, to partials[blockIdx.x][k][c].
template <int K, int L>
__device__ __forceinline__ void block_partials(float (&red)[K][kThreads * L],
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
      a += red[k][r * C + c];
    partials[(static_cast<long long>(blockIdx.x) * K + k) * C + c] = a;
  }
}

// ------------------------------------------------------------ statistics

template <typename T, bool kBias>
__device__ __forceinline__ void moments(uint4 rv, const float* cb,
                                        float (&acc)[2][16 / sizeof(T)]) {
  constexpr int L = 16 / sizeof(T);
  const T* lv = reinterpret_cast<const T*>(&rv);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float u = unbiased<T, kBias>(lv[j], cb[j]);
    acc[0][j] += u;
    acc[1][j] = fmaf(u, u, acc[1][j]);
  }
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ v, const T* __restrict__ conv_bias,
                 float* __restrict__ partials, long long pixels, int C) {
  constexpr int L = 16 / sizeof(T);
  __shared__ float red[2][kThreads * L];
  const int c0 = threadIdx.x * L;
  float cb[L], acc[2][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    cb[j] = kBias ? to_f(conv_bias[c0 + j]) : 0.0f;
    acc[0][j] = acc[1][j] = 0.0f;
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       p < pixels; p += 2 * step) {
    const long long q = p + step;
    const bool has_q = q < pixels;
    // both pixels' loads first, then the arithmetic
    const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(v + p * C + c0));
    const uint4 v1 = has_q ? __ldg(reinterpret_cast<const uint4*>(
                                 v + q * C + c0))
                           : make_uint4(0, 0, 0, 0);
    moments<T, kBias>(v0, cb, acc);
    if (has_q) moments<T, kBias>(v1, cb, acc);
  }
  block_partials<2, L>(red, acc, partials, C);
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
        a[k] += partials[(static_cast<long long>(g) * K + k) * C + c];
#pragma unroll
  for (int k = 0; k < K; ++k) red[k][threadIdx.y][threadIdx.x] = a[k];
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double t = 0.0;
    for (int r = 0; r < kFinishY; ++r) t += red[k][r][threadIdx.x];
    out[k] = t;
  }
  return true;
}

__device__ __forceinline__ double rstd_of(float var, double eps) {
  return 1.0 / sqrt(static_cast<double>(var) + eps);
}

__global__ void __launch_bounds__(kFinishX* kFinishY)
    stats_finish(const float* __restrict__ partials, int G, int C, double n,
                 double eps, const float* __restrict__ weight,
                 float* __restrict__ mean, float* __restrict__ var,
                 float* __restrict__ mul, float* __restrict__ gate) {
  double s[2];
  int c;
  if (!finish_sums<2>(partials, G, C, s, c)) return;
  const double m = s[0] / n;
  const double raw = s[1] / n - m * m;
  const float vf = static_cast<float>(raw < 0.0 ? 0.0 : raw);  // NaN stays
  mean[c] = static_cast<float>(m);
  var[c] = vf;
  mul[c] = static_cast<float>(rstd_of(vf, eps) * weight[c]);
  gate[c] = raw >= 0.0 ? 1.0f : 0.0f;
}

// -------------------------------------------------------------- backward

// gy and d = u - mean of one pixel's lanes; gs = the gradient past the
// skip layer's outer ReLU
template <typename T, bool kBias, bool kSkip>
__device__ __forceinline__ void grad_terms(uint4 rv, uint4 rg, uint4 ro,
                                           const float* cb, const float* m,
                                           const float* k, const float* b,
                                           float* gy, float* d) {
  constexpr int L = 16 / sizeof(T);
  const T* lv = reinterpret_cast<const T*>(&rv);
  const T* lg = reinterpret_cast<const T*>(&rg);
  const T* lo = reinterpret_cast<const T*>(&ro);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    d[j] = __fsub_rn(unbiased<T, kBias>(lv[j], cb[j]), m[j]);
    const float y = __fadd_rn(__fmul_rn(d[j], k[j]), b[j]);
    float g = to_f(lg[j]);
    if constexpr (kSkip) g = passes(to_f(lo[j])) ? g : 0.0f;
    gy[j] = passes(y) ? g : 0.0f;
  }
}

template <typename T, bool kBias, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    grad_reduce(const T* __restrict__ v, const T* __restrict__ conv_bias,
                const float* __restrict__ mean, const float* __restrict__ mul,
                const float* __restrict__ bias, const T* __restrict__ out,
                const T* __restrict__ g, float* __restrict__ partials,
                long long pixels, int C) {
  constexpr int L = 16 / sizeof(T);
  __shared__ float red[2][kThreads * L];
  const int c0 = threadIdx.x * L;
  float cb[L], m[L], k[L], b[L], acc[2][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    cb[j] = kBias ? to_f(conv_bias[c0 + j]) : 0.0f;
    m[j] = mean[c0 + j];
    k[j] = mul[c0 + j];
    b[j] = bias[c0 + j];
    acc[0][j] = acc[1][j] = 0.0f;
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       p < pixels; p += 2 * step) {
    const long long q = p + step;
    const bool has_q = q < pixels;
    const long long op = p * C + c0, oq = q * C + c0;
    const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(v + op));
    const uint4 g0 = __ldg(reinterpret_cast<const uint4*>(g + op));
    uint4 v1 = zero, g1 = zero, o0 = zero, o1 = zero;
    if (has_q) {
      v1 = __ldg(reinterpret_cast<const uint4*>(v + oq));
      g1 = __ldg(reinterpret_cast<const uint4*>(g + oq));
    }
    if constexpr (kSkip) {
      o0 = __ldg(reinterpret_cast<const uint4*>(out + op));
      if (has_q) o1 = __ldg(reinterpret_cast<const uint4*>(out + oq));
    }
    float gy[L], d[L];
    grad_terms<T, kBias, kSkip>(v0, g0, o0, cb, m, k, b, gy, d);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      acc[0][j] += gy[j];
      acc[1][j] = fmaf(gy[j], d[j], acc[1][j]);
    }
    if (has_q) {
      grad_terms<T, kBias, kSkip>(v1, g1, o1, cb, m, k, b, gy, d);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        acc[0][j] += gy[j];
        acc[1][j] = fmaf(gy[j], d[j], acc[1][j]);
      }
    }
  }
  block_partials<2, L>(red, acc, partials, C);
}

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

template <typename T, bool kBias, bool kSkip>
__device__ __forceinline__ void apply_one(uint4 rv, uint4 rg, uint4 ro,
                                          const float* cb, const float* m,
                                          const float* k, const float* b,
                                          const float* a1, const float* a2,
                                          float* sum, T* __restrict__ dv,
                                          T* __restrict__ dskip) {
  constexpr int L = 16 / sizeof(T);
  float gy[L], d[L];
  grad_terms<T, kBias, kSkip>(rv, rg, ro, cb, m, k, b, gy, d);
  uint4 rd;
  T* ld = reinterpret_cast<T*>(&rd);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    ld[j] = from_f<T>(fmaf(k[j], gy[j], fmaf(a2[j], d[j], a1[j])));
    if constexpr (kBias) sum[j] += to_f(ld[j]);
  }
  *reinterpret_cast<uint4*>(dv) = rd;
  if constexpr (kSkip) {
    const T* lg = reinterpret_cast<const T*>(&rg);
    const T* lo = reinterpret_cast<const T*>(&ro);
    uint4 rs;
    T* ls = reinterpret_cast<T*>(&rs);
#pragma unroll
    for (int j = 0; j < L; ++j)
      ls[j] = passes(to_f(lo[j])) ? lg[j] : from_f<T>(0.0f);
    *reinterpret_cast<uint4*>(dskip) = rs;
  }
}

template <typename T, bool kBias, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    grad_apply(const T* __restrict__ v, const T* __restrict__ conv_bias,
               const float* __restrict__ mean, const float* __restrict__ mul,
               const float* __restrict__ bias,
               const float* __restrict__ coef1,
               const float* __restrict__ coef2, const T* __restrict__ out,
               const T* __restrict__ g, T* __restrict__ dv,
               T* __restrict__ dskip, float* __restrict__ partials,
               long long pixels, int C) {
  constexpr int L = 16 / sizeof(T);
  const int c0 = threadIdx.x * L;
  float cb[L], m[L], k[L], b[L], a1[L], a2[L], acc[1][L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    cb[j] = kBias ? to_f(conv_bias[c0 + j]) : 0.0f;
    m[j] = mean[c0 + j];
    k[j] = mul[c0 + j];
    b[j] = bias[c0 + j];
    a1[j] = coef1[c0 + j];
    a2[j] = coef2[c0 + j];
    acc[0][j] = 0.0f;
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       p < pixels; p += 2 * step) {
    const long long q = p + step;
    const bool has_q = q < pixels;
    const long long op = p * C + c0, oq = q * C + c0;
    const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(v + op));
    const uint4 g0 = __ldg(reinterpret_cast<const uint4*>(g + op));
    uint4 v1 = zero, g1 = zero, o0 = zero, o1 = zero;
    if (has_q) {
      v1 = __ldg(reinterpret_cast<const uint4*>(v + oq));
      g1 = __ldg(reinterpret_cast<const uint4*>(g + oq));
    }
    if constexpr (kSkip) {
      o0 = __ldg(reinterpret_cast<const uint4*>(out + op));
      if (has_q) o1 = __ldg(reinterpret_cast<const uint4*>(out + oq));
    }
    apply_one<T, kBias, kSkip>(v0, g0, o0, cb, m, k, b, a1, a2, acc[0],
                               dv + op, dskip + op);
    if (has_q)
      apply_one<T, kBias, kSkip>(v1, g1, o1, cb, m, k, b, a1, a2, acc[0],
                                 dv + oq, dskip + oq);
  }
  if constexpr (kBias) {
    __shared__ float red[1][kThreads * L];
    block_partials<1, L>(red, acc, partials, C);
  }
}

__global__ void __launch_bounds__(kFinishX* kFinishY)
    bias_finish(const float* __restrict__ partials, int G, int C,
                float* __restrict__ dconv_bias) {
  double s[1];
  int c;
  if (!finish_sums<1>(partials, G, C, s, c)) return;
  dconv_bias[c] = static_cast<float>(s[0]);
}

// ------------------------------------------------------------- launching

struct Shape {
  int groups, rows;
};

template <typename T>
Shape shape_of(int C) {
  const int groups = C / (16 / static_cast<int>(sizeof(T)));
  return {groups, kThreads / groups};
}

int blocks(long long pixels, int rows, int wave, int capacity) {
  const int grid = grid_of(pixels, rows, wave);
  return grid < capacity ? grid : capacity;
}

int finish_grid(int C) { return (C + kFinishX - 1) / kFinishX; }

struct StatsArgs {
  const void *v, *conv_bias;
  const float* weight;
  float* partials;
  int capacity;
  float *mean, *var, *mul, *gate;
  long long pixels;
  int C;
  double eps;
};

template <typename T, bool kBias>
int stats(const StatsArgs& a, cudaStream_t stream) {
  const Shape sh = shape_of<T>(a.C);
  const int w = wave<stats_kernel<T, kBias>>(sh.groups, sh.rows);
  if (w < 0) return -w;
  const int grid = blocks(a.pixels, sh.rows, w, a.capacity);
  stats_kernel<T, kBias><<<grid, dim3(sh.groups, sh.rows), 0, stream>>>(
      static_cast<const T*>(a.v), static_cast<const T*>(a.conv_bias),
      a.partials, a.pixels, a.C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stats_finish<<<finish_grid(a.C), dim3(kFinishX, kFinishY), 0, stream>>>(
      a.partials, grid, a.C, static_cast<double>(a.pixels), a.eps, a.weight,
      a.mean, a.var, a.mul, a.gate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stats_dispatch(const StatsArgs& a, cudaStream_t s) {
  return a.conv_bias ? stats<T, true>(a, s) : stats<T, false>(a, s);
}

struct GradArgs {
  const void *v, *conv_bias;
  const float *mean, *var, *mul, *gate, *bias;
  const void *out, *g;
  void *dv, *dskip;
  float* partials;
  int capacity;
  float *coef1, *coef2, *dweight, *dbias, *dconv_bias;
  long long pixels;
  int C;
  double eps;
};

template <typename T, bool kBias, bool kSkip>
int grad(const GradArgs& a, cudaStream_t stream) {
  const Shape sh = shape_of<T>(a.C);
  const dim3 block(sh.groups, sh.rows);
  const auto* v = static_cast<const T*>(a.v);
  const auto* cb = static_cast<const T*>(a.conv_bias);
  const auto* out = static_cast<const T*>(a.out);
  const auto* g = static_cast<const T*>(a.g);
  auto reduce = grad_reduce<T, kBias, kSkip>;
  auto apply = grad_apply<T, kBias, kSkip>;
  const int w0 = wave<grad_reduce<T, kBias, kSkip>>(sh.groups, sh.rows);
  if (w0 < 0) return -w0;
  const int w1 = wave<grad_apply<T, kBias, kSkip>>(sh.groups, sh.rows);
  if (w1 < 0) return -w1;
  const double n = static_cast<double>(a.pixels);
  const int g0 = blocks(a.pixels, sh.rows, w0, a.capacity);
  reduce<<<g0, block, 0, stream>>>(v, cb, a.mean, a.mul, a.bias, out, g,
                                   a.partials, a.pixels, a.C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grad_finish<<<finish_grid(a.C), dim3(kFinishX, kFinishY), 0, stream>>>(
      a.partials, g0, a.C, n, a.eps, a.var, a.mul, a.gate, a.dweight,
      a.dbias, a.coef1, a.coef2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int g1 = blocks(a.pixels, sh.rows, w1, a.capacity);
  apply<<<g1, block, 0, stream>>>(v, cb, a.mean, a.mul, a.bias, a.coef1,
                                  a.coef2, out, g, static_cast<T*>(a.dv),
                                  static_cast<T*>(a.dskip), a.partials,
                                  a.pixels, a.C);
  e = cudaGetLastError();
  if (e != cudaSuccess || !kBias) return static_cast<int>(e);
  bias_finish<<<finish_grid(a.C), dim3(kFinishX, kFinishY), 0, stream>>>(
      a.partials, g1, a.C, a.dconv_bias);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int grad_dispatch(const GradArgs& a, cudaStream_t s) {
  const bool bias = a.conv_bias != nullptr, skip = a.out != nullptr;
  if (bias && skip) return grad<T, true, true>(a, s);
  if (bias) return grad<T, true, false>(a, s);
  if (skip) return grad<T, false, true>(a, s);
  return grad<T, false, false>(a, s);
}

template <typename T>
int capacity(int C) {
  const Shape sh = shape_of<T>(C);
  const int g = sh.groups, r = sh.rows;
  const int waves[] = {wave<stats_kernel<T, false>>(g, r),
                       wave<stats_kernel<T, true>>(g, r),
                       wave<grad_reduce<T, false, false>>(g, r),
                       wave<grad_reduce<T, false, true>>(g, r),
                       wave<grad_reduce<T, true, false>>(g, r),
                       wave<grad_reduce<T, true, true>>(g, r),
                       wave<grad_apply<T, false, false>>(g, r),
                       wave<grad_apply<T, false, true>>(g, r),
                       wave<grad_apply<T, true, false>>(g, r),
                       wave<grad_apply<T, true, true>>(g, r)};
  int most = 0;
  for (int w : waves) {
    if (w < 0) return w;
    if (w > most) most = w;
  }
  return most;
}

bool valid(long long pixels, int C, int dtype) {
  const int lanes = lanes_of(dtype);
  return lanes != 0 && C > 0 && C % lanes == 0 && C / lanes <= kThreads &&
         pixels > 0 && pixels <= LLONG_MAX / C;
}

}  // namespace

// The most blocks a pass over C channels may launch on the current card:
// the largest of its kernels' waves, which the partials buffers hold as
// rows.  A negative CUDA error on failure.
extern "C" int net_train_capacity(int C, int dtype) {
  if (!valid(1, C, dtype)) return -static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0 ? capacity<__nv_bfloat16>(C) : capacity<float>(C);
}

// dtype 0: bf16, 1: fp32.  v: [pixels, C] contiguous (an NHWC activation),
// 16-byte aligned; conv_bias (dtype of v) may be null; weight fp32 [C];
// partials fp32 [capacity, 2, C]; mean, var, mul, gate: fp32 [C] out.
// C a multiple of the 16-byte vector's lanes (8 bf16, 4 fp32), at most 256
// vectors a pixel.
extern "C" int net_train_stats(const void* v, const void* conv_bias,
                               const void* weight, void* partials,
                               int capacity, void* mean, void* var,
                               void* mul, void* gate, long long pixels,
                               int C, int dtype, double eps, void* stream) {
  if (!valid(pixels, C, dtype) || capacity <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](void* p) { return static_cast<float*>(p); };
  const StatsArgs a{v,        conv_bias, static_cast<const float*>(weight),
                    f(partials), capacity, f(mean), f(var), f(mul),
                    f(gate),     pixels,    C,       eps};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return stats_dispatch<__nv_bfloat16>(a, s);
  return stats_dispatch<float>(a, s);
}

// The backward of a trunk layer.  v, conv_bias, dtype, C, pixels as for
// net_train_stats; mean, var, mul, gate: its outputs; bias: BN's fp32 [C];
// out: the layer's output on a skip layer, else null; g: d out; dv (and
// dskip on a skip layer): [pixels, C] in v's dtype, out; partials fp32
// [capacity, 2, C]; coef1, coef2 fp32 [C] scratch; dweight, dbias and (with
// a conv bias) dconv_bias fp32 [C] out.  g, out, dv and dskip contiguous
// and 16-byte aligned as v.
extern "C" int net_train_grad(const void* v, const void* conv_bias,
                              const void* mean, const void* var,
                              const void* mul, const void* gate,
                              const void* bias, const void* out,
                              const void* g, void* dv, void* dskip,
                              void* partials, int capacity, void* coef1,
                              void* coef2, void* dweight, void* dbias,
                              void* dconv_bias, long long pixels, int C,
                              int dtype, double eps, void* stream) {
  if (!valid(pixels, C, dtype) || capacity <= 0 ||
      (out != nullptr) != (dskip != nullptr) ||
      (conv_bias != nullptr) != (dconv_bias != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  const GradArgs a{v,          conv_bias, cf(mean),        cf(var),
                   cf(mul),    cf(gate),  cf(bias),        out,
                   g,          dv,        dskip,           f(partials),
                   capacity,   f(coef1),  f(coef2),        f(dweight),
                   f(dbias),   f(dconv_bias), pixels,      C,
                   eps};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return grad_dispatch<__nv_bfloat16>(a, s);
  return grad_dispatch<float>(a, s);
}
