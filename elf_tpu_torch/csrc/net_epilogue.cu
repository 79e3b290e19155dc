// Epilogue of the serving net's trunk convolutions, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves flax's BatchNorm to XLA,
// which fuses it into the convolution's consumers.  The port's serving
// forward ran each trunk BatchNorm (running statistics) as torch passes over
// the whole activation: the convolution's bias add in bf16, an upcast to
// fp32, a subtract, a multiply and an add in fp32, a ReLU and a cast back,
// and in each residual block a bf16 add and a ReLU more: about 86 bytes of
// traffic per activation element a block.  This kernel moves 4 bytes per
// element a layer (6 with the skip), 10 a block.
//
// What it computes, for an NHWC activation (channel c = index % C):
//   v   = T(float(conv[i]) + float(conv_bias[c]))      (with a conv bias)
//   y   = relu((float(v) - mean[c]) * mul[c] + bias[c]) (fp32, each op rounded)
//   out = T(y)                                          (no skip)
//   out = T(relu(float(T(float(skip[i]) + float(T(y))))))   (skip)
// with mul = rsqrt(running_var + eps) * weight computed once by the caller.
// Those are the roundings and the order of operations of the torch passes it
// replaces, bit for bit: __fadd_rn / __fsub_rn / __fmul_rn keep nvcc from
// contracting a multiply and an add into an FMA, every cast to bf16 rounds
// to nearest even, and the ReLU is torch's clamp_min(v, 0) (fmaxf, a NaN
// passed on).  T is bf16 or fp32 (then the casts are identities).
//
// What bounds it: bytes.  At B = 2048, 19x19 and 256 channels one pass
// reads 2 bytes and writes 2 bytes per element (4 more read with the skip):
// 0.76 GB (1.14 GB), 0.23 ms (0.34 ms) at 3.35 TB/s, against a handful of
// flops per element.  Design:
//   - each thread moves 16-byte vectors: 8 bf16 channels (4 fp32) of one
//     pixel, so a warp reads 512 contiguous bytes;
//   - a block is (C / lanes) x rows threads: threadIdx.x picks the channel
//     group, which stays the same for every pixel the thread visits, so the
//     per-channel constants are loaded once per thread into registers and
//     no index is divided;
//   - a grid-stride loop over pixels with one wave of blocks (occupancy x
//     SMs), two pixels in flight per thread, so that enough loads are
//     outstanding to cover the memory latency;
//   - launched on the caller's stream; no allocation, no synchronisation.

#include <climits>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kBias, bool kSkip>
__device__ __forceinline__ uint4 pass(uint4 rv, uint4 rx, const float* cb,
                                      const float* m, const float* k,
                                      const float* b) {
  constexpr int L = 16 / sizeof(T);
  const T* lv = reinterpret_cast<const T*>(&rv);
  const T* lx = reinterpret_cast<const T*>(&rx);
  uint4 ro;
  T* lo = reinterpret_cast<T*>(&ro);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float f = to_f(lv[j]);
    if constexpr (kBias) f = to_f(from_f<T>(__fadd_rn(f, cb[j])));
    float y = relu(__fadd_rn(__fmul_rn(__fsub_rn(f, m[j]), k[j]), b[j]));
    if constexpr (kSkip)
      y = relu(to_f(from_f<T>(__fadd_rn(to_f(lx[j]), to_f(from_f<T>(y))))));
    lo[j] = from_f<T>(y);
  }
  return ro;
}

template <typename T, bool kBias, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const T* __restrict__ v, const T* __restrict__ conv_bias,
                    const float* __restrict__ mean,
                    const float* __restrict__ mul,
                    const float* __restrict__ bias,
                    const T* __restrict__ skip, T* __restrict__ out,
                    long long pixels, int C) {
  constexpr int L = 16 / sizeof(T);
  const int c0 = threadIdx.x * L;
  float cb[L], m[L], k[L], b[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if constexpr (kBias) cb[j] = to_f(conv_bias[c0 + j]);
    m[j] = mean[c0 + j];
    k[j] = mul[c0 + j];
    b[j] = bias[c0 + j];
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       p < pixels; p += 2 * step) {
    const long long q = p + step;
    const bool has_q = q < pixels;
    const long long op = p * C + c0, oq = q * C + c0;
    // both pixels' loads first, then the arithmetic
    const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(v + op));
    const uint4 v1 =
        has_q ? __ldg(reinterpret_cast<const uint4*>(v + oq)) : zero;
    uint4 x0 = zero, x1 = zero;
    if constexpr (kSkip) {
      x0 = __ldg(reinterpret_cast<const uint4*>(skip + op));
      if (has_q) x1 = __ldg(reinterpret_cast<const uint4*>(skip + oq));
    }
    *reinterpret_cast<uint4*>(out + op) =
        pass<T, kBias, kSkip>(v0, x0, cb, m, k, b);
    if (has_q)
      *reinterpret_cast<uint4*>(out + oq) =
          pass<T, kBias, kSkip>(v1, x1, cb, m, k, b);
  }
}

template <typename T, bool kBias, bool kSkip>
int launch(const void* v, const void* conv_bias, const float* mean,
           const float* mul, const float* bias, const void* skip, void* out,
           long long pixels, int C, cudaStream_t stream) {
  constexpr int L = 16 / sizeof(T);
  const int groups = C / L;
  const int rows = kThreads / groups;
  auto kernel = epilogue_kernel<T, kBias, kSkip>;
  const int w = wave<epilogue_kernel<T, kBias, kSkip>>(groups, rows);
  if (w < 0) return -w;
  kernel<<<grid_of(pixels, rows, w), dim3(groups, rows), 0, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(conv_bias), mean, mul,
      bias, static_cast<const T*>(skip), static_cast<T*>(out), pixels, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* v, const void* conv_bias, const float* mean,
             const float* mul, const float* bias, const void* skip,
             void* out, long long pixels, int C, cudaStream_t stream) {
  if (conv_bias && skip)
    return launch<T, true, true>(v, conv_bias, mean, mul, bias, skip, out,
                                 pixels, C, stream);
  if (conv_bias)
    return launch<T, true, false>(v, conv_bias, mean, mul, bias, skip, out,
                                  pixels, C, stream);
  if (skip)
    return launch<T, false, true>(v, conv_bias, mean, mul, bias, skip, out,
                                  pixels, C, stream);
  return launch<T, false, false>(v, conv_bias, mean, mul, bias, skip, out,
                                 pixels, C, stream);
}

}  // namespace

// dtype 0: bf16, 1: fp32.  v, skip and out: [pixels, C] contiguous (an NHWC
// activation), 16-byte aligned; conv_bias (dtype of v) and skip may be null;
// mean, mul, bias: fp32 [C].  C a multiple of the 16-byte vector's lanes
// (8 bf16, 4 fp32), at most 256 vectors a pixel.
extern "C" int net_epilogue(const void* v, const void* conv_bias,
                            const void* mean, const void* mul,
                            const void* bias, const void* skip, void* out,
                            long long pixels, int C, int dtype,
                            void* stream) {
  const int lanes = lanes_of(dtype);
  if (lanes == 0 || C <= 0 || C % lanes != 0 || C / lanes > kThreads ||
      pixels < 0 || pixels > LLONG_MAX / C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pixels == 0) return 0;
  const auto* fm = static_cast<const float*>(mean);
  const auto* fk = static_cast<const float*>(mul);
  const auto* fb = static_cast<const float*>(bias);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(v, conv_bias, fm, fk, fb, skip, out,
                                   pixels, C, s);
  return dispatch<float>(v, conv_bias, fm, fk, fb, skip, out, pixels, C, s);
}
