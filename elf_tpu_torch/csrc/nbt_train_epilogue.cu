// Batch-statistics norms of the nested-bottleneck net's learner (KataGo's
// b18c384nbt, `models/nbt.py`'s training forward): the forward statistics
// and the backward of each norm-and-activation, hand-written for Hopper
// (sm_90a).  A library of its own, built and loaded the first time such a
// net trains on the card.
//
// Replaces no TPU kernel: the JAX package has no such net.  The training
// forward ran each norm as torch passes in fp32 (an upcast, a mean, x * x,
// a second mean, the normalisation, mish, a cast back, the residual add,
// the pooled row bias, the board's mean and max), each with its autograd
// backward: about 89 % of the device time of a batch-2048 step.
//
// A layer, for an NHWC activation v (the convolution's output, T bf16 or
// fp32), n = B H W pixels, channel c = index % C, board b = pixel / (H W):
//   f    = float(v)                                     ("normact", "pool")
//        = float(T(float(r) + float(v)))  (the sum s:   "skip")
//        = float(v) + rowbias[b, c]                     ("row")
//   mean = sum(f) / n,  var = max(0, sum(f^2) / n - mean^2)
//   mul  = rsqrt(var + eps) * weight
//   y    = (f - mean) * mul + bias,   out = T(act(y))
// or, "pool", act(y) pooled over the board, never written: [mean, mean k1,
// max] ("gpool") or [mean, mean k1, mean k2] ("value").  The statistics are
// `nbt_train_stats`; the apply pass is the serving kernel
// (`nbt_epilogue.cu`'s `nbt_normact_kernel` or `nbt_pool_kernel`), which
// the caller launches unchanged with this mean and mul.  The backward,
// `nbt_train_grad`, given the output's gradient, recomputes y from f with
// the forward's roundings (nothing in fp32 is saved) and forms
//   ga   = float(d out)                       (normact, skip, row)
//        = d mean[b, c] + [act(y) == max] d max[b, c] / ties[b, c]   (pool)
//   gy   = ga * act'(y)        (relu: y > 0 or NaN passes ga, as torch's)
//   S1   = sum(gy),  S2 = sum(gy * (f - mean))
//   d bias = S1,  d weight = S2 * rstd            (rstd = rsqrt(var + eps))
//   df   = mul gy - mul S1 / n - gate mul rstd^2 S2 / n (f - mean)
//   d v  = T(df); skip: d s = T(df + float(d s_out)), the gradient of r and
//   v both; row: d rowbias[b, c] = sum of df over the board
// where gate is 1 unless E[f^2] - mean^2 was clamped, d mean[b, c] is the
// pooled mean's gradient over the board's points (the caller's, as
// torch's mean backward divides it) and the max's gradient goes evenly to
// the board's tied maxima, as `torch.amax`'s backward sends it (a NaN on
// the board makes them NaN, as there).  mish' is r (n + 4 y e (e + 1) r)
// with e = exp(y), n = e (e + 2), r = 1 / (n + 2), y held at 20 above.
//
// Determinism: every sum is taken in a fixed order, with no atomics.  A
// pass walks chunks of `span` pixels (a whole board where a board's row
// bias or pooled gradient is needed, else two pixels a thread): block i
// takes chunks i, i + grid, ...; thread row y its pixels y, y + rows, ...
// of each, summing in fp32 in that order; a block sums its rows in order,
// and a small launch sums the blocks' partials in a fixed order in double.
// The grid is the caller's (`models/epilogue.py`: one wave of the card's
// threads, from its shape), so two calls on the same input give the same
// bits, which block remat relies on, and the plain version can follow the
// order of the statistics exactly.
//
// What bounds it: bytes.  At B = 2048, 19x19, an activation of 192 bf16
// channels is 0.28 GB.  The statistics read v (skip: r and v) once; the
// backward's reduce pass reads v (s) and d out, its apply pass reads them
// again (and d s_out) and writes d v; a pool's backward sweeps each board
// twice (its maxima, then the sums) and once more to apply.  Design, as
// `net_train_epilogue.cu`'s:
//   - each thread moves 16-byte vectors: 8 bf16 channels (4 fp32) of one
//     pixel; a block is (C / lanes) x rows threads, threadIdx.x fixing the
//     channel group, so the per-channel constants sit in registers;
//   - two pixels in flight per thread, their loads before their arithmetic;
//   - a block's partials, a board's maxima and its row-bias gradient meet
//     in shared memory; the finishing launches are 32 channels x 8 rows;
//   - launched on the caller's stream; no allocation, no synchronisation.

#include <climits>

#include "lanes.cuh"
#include "train_sums.cuh"

namespace {

constexpr int kThreads = 256;   // the most threads of a pass's block

// the layer modes of `nbt_train_grad`; the statistics take the first three
constexpr int kNormact = 0, kSkip = 1, kRow = 2, kGpool = 3, kValue = 4;

// torch's ReLU backward passes the gradient unless the value is <= 0
__device__ __forceinline__ bool passes(float y) { return !(y <= 0.0f); }

// gy = ga * act'(y); 1 / (n + 2) rounded to nearest, as torch.reciprocal
template <int kAct>
__device__ __forceinline__ float grad_act(float y, float ga) {
  if constexpr (kAct == 0) {
    return passes(y) ? ga : 0.0f;
  } else {
    const float x = y > 20.0f ? 20.0f : y;   // NaN stays
    const float e = exp2f(__fmul_rn(x, 1.4426950408889634f));
    const float n = __fmul_rn(e, __fadd_rn(e, 2.0f));
    const float r = rcp_rn_normal(__fadd_rn(n, 2.0f));   // n + 2 < 2^58
    const float q = __fmul_rn(__fmul_rn(__fmul_rn(4.0f, x), e),
                              __fadd_rn(e, 1.0f));
    return __fmul_rn(ga, __fmul_rn(r, __fadd_rn(n, __fmul_rn(q, r))));
  }
}

template <typename T>
__device__ __forceinline__ uint4 load(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <int L>
__device__ __forceinline__ void load_f(const float* __restrict__ p,
                                       float (&out)[L]) {
#pragma unroll
  for (int j = 0; j < L; j += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + j));
    out[j] = a.x;
    out[j + 1] = a.y;
    out[j + 2] = a.z;
    out[j + 3] = a.w;
  }
}

// ------------------------------------------------------------ statistics

// f of one pixel's lanes: v (kIn 0), the sum T(r + v) (kIn 1: r in rx), or
// v plus the row bias (kIn 2)
template <typename T, int kIn>
__device__ __forceinline__ void layer_in(uint4 rv, uint4 rx, const float* rb,
                                         float* f) {
  constexpr int L = 16 / sizeof(T);
  const T* lv = reinterpret_cast<const T*>(&rv);
  const T* lx = reinterpret_cast<const T*>(&rx);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float u = to_f(lv[j]);
    if constexpr (kIn == kSkip) u = to_f(from_f<T>(__fadd_rn(to_f(lx[j]), u)));
    if constexpr (kIn == kRow) u = __fadd_rn(u, rb[j]);
    f[j] = u;
  }
}

template <int L>
__device__ __forceinline__ void moments(const float* f, float (&acc)[2][L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    acc[0][j] = __fadd_rn(acc[0][j], f[j]);
    acc[1][j] = __fadd_rn(acc[1][j], __fmul_rn(f[j], f[j]));
  }
}

template <typename T, int kIn>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ v, const T* __restrict__ r,
                 const float* __restrict__ rowbias,
                 float* __restrict__ partials, long long pixels,
                 long long span, int C) {
  constexpr int L = 16 / sizeof(T);
  __shared__ float red[2][kThreads * L];
  const int c0 = threadIdx.x * L, rows = blockDim.y;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float acc[2][L], rb[L], f[L];
#pragma unroll
  for (int j = 0; j < L; ++j) acc[0][j] = acc[1][j] = rb[j] = 0.0f;
  for (long long u = blockIdx.x; u * span < pixels; u += gridDim.x) {
    const long long base = u * span;
    const int n = static_cast<int>(span < pixels - base ? span
                                                        : pixels - base);
    if constexpr (kIn == kRow) load_f<L>(rowbias + u * C + c0, rb);
    for (int i = threadIdx.y; i < n; i += 2 * rows) {
      const bool has1 = i + rows < n;
      const long long o0 = (base + i) * C + c0;
      const long long o1 = o0 + static_cast<long long>(rows) * C;
      const uint4 v0 = load(v + o0), v1 = has1 ? load(v + o1) : zero;
      uint4 r0 = zero, r1 = zero;
      if constexpr (kIn == kSkip) {
        r0 = load(r + o0);
        if (has1) r1 = load(r + o1);
      }
      layer_in<T, kIn>(v0, r0, rb, f);
      moments<L>(f, acc);
      if (has1) {
        layer_in<T, kIn>(v1, r1, rb, f);
        moments<L>(f, acc);
      }
    }
  }
  block_partials<2, L>(red, acc, partials, C);
}

__global__ void __launch_bounds__(kFinishX* kFinishY)
    stats_finish(const float* __restrict__ partials, int G, int C, double n,
                 double eps, const float* __restrict__ weight,
                 float* __restrict__ mean, float* __restrict__ var,
                 float* __restrict__ mul, float* __restrict__ gate) {
  double s[2];
  int c;
  if (!finish_sums<2>(partials, G, C, s, c)) return;
  const double m = __ddiv_rn(s[0], n);
  const double raw = __dsub_rn(__ddiv_rn(s[1], n), __dmul_rn(m, m));
  const float vf = static_cast<float>(raw < 0.0 ? 0.0 : raw);  // NaN stays
  mean[c] = static_cast<float>(m);
  var[c] = vf;
  mul[c] = static_cast<float>(__dmul_rn(rstd_of(vf, eps),
                                        static_cast<double>(weight[c])));
  gate[c] = raw >= 0.0 ? 1.0f : 0.0f;
}

// -------------------------------------------------------------- backward

struct GradArgs {
  const void* x;            // v, or s on a skip layer
  const float* rowbias;     // row: [B, C]
  const float *mean, *var, *mul, *gate, *bias;
  const void* g;            // d out (normact, skip, row)
  const void* gs;           // skip: d s_out
  const float* dmean;       // pool: [B, C]
  const float* dmax;        // gpool: [B, C]
  float* scratch;           // gpool: [B][2][C], a board's max and d max / ties
  void* dx;                 // d v (skip: d s)
  float* drowbias;          // row: [B, C]
  float* partials;          // [grid][2][C]
  int grid;
  float *coef1, *coef2, *dweight, *dbias;
  long long pixels, span;
  int C;
  double eps;
};

// gy and d = f - mean of one pixel's lanes, from x (v or s), the row
// bias, the pooled gradient (dm, and mx, dxc of "gpool") and d out
template <typename T, int kAct, int kMode>
__device__ __forceinline__ void grad_terms(uint4 rx, uint4 rg, const float* rb,
                                           const float* dm, const float* mx,
                                           const float* dxc, const float* m,
                                           const float* k, const float* b,
                                           float* gy, float* d) {
  constexpr int L = 16 / sizeof(T);
  const T* lx = reinterpret_cast<const T*>(&rx);
  const T* lg = reinterpret_cast<const T*>(&rg);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float f = to_f(lx[j]);
    if constexpr (kMode == kRow) f = __fadd_rn(f, rb[j]);
    d[j] = __fsub_rn(f, m[j]);
    const float y = __fadd_rn(__fmul_rn(d[j], k[j]), b[j]);
    float ga;
    if constexpr (kMode == kGpool)
      ga = __fadd_rn(dm[j],
                     __fmul_rn(act<kAct>(y) == mx[j] ? 1.0f : 0.0f, dxc[j]));
    else if constexpr (kMode == kValue)
      ga = dm[j];
    else
      ga = to_f(lg[j]);
    gy[j] = grad_act<kAct>(y, ga);
  }
}

// The per-channel constants of a layer, in registers
template <int L>
__device__ __forceinline__ void constants(const GradArgs& a, int c0,
                                          float (&m)[L], float (&k)[L],
                                          float (&b)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    m[j] = a.mean[c0 + j];
    k[j] = a.mul[c0 + j];
    b[j] = a.bias[c0 + j];
  }
}

// "gpool": the board u's max of act(y) and its ties, per lane, over the
// block's threads; thread row 0 writes them, with d max / ties, to scratch.
// A NaN on the board makes the max NaN and the ties 0, as torch's amax.
template <typename T, int kAct, int L>
__device__ __forceinline__ void board_max(const GradArgs& a, long long u,
                                          long long base, int n,
                                          const float* m, const float* k,
                                          const float* b,
                                          float (&red)[2][kThreads * L],
                                          float (&mx)[L], float (&dxc)[L]) {
  const int C = a.C, c0 = threadIdx.x * L, rows = blockDim.y;
  const T* x = static_cast<const T*>(a.x);
  float tm[L], tc[L];
  unsigned nan = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    tm[j] = __int_as_float(0xff800000);   // -inf
    tc[j] = 0.0f;
  }
  for (int i = threadIdx.y; i < n; i += rows) {
    const uint4 rx = load(x + (base + i) * C + c0);
    const T* lx = reinterpret_cast<const T*>(&rx);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float y = __fadd_rn(
          __fmul_rn(__fsub_rn(to_f(lx[j]), m[j]), k[j]), b[j]);
      const float g = act<kAct>(y);
      if (g > tm[j]) {
        tm[j] = g;
        tc[j] = 1.0f;
      } else if (g == tm[j]) {
        tc[j] = __fadd_rn(tc[j], 1.0f);
      } else if (g != g) {
        nan |= 1u << j;
      }
    }
  }
  const int at = threadIdx.y * C + c0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    red[0][at + j] = (nan >> j) & 1u ? __int_as_float(0x7fffffff) : tm[j];
    red[1][at + j] = tc[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float top = __int_as_float(0xff800000), ties = 0.0f;
    bool any_nan = false;
    for (int r = 0; r < rows; ++r) {
      const float t = red[0][r * C + c0 + j];
      if (t != t) any_nan = true;
      else top = fmaxf(top, t);
    }
    for (int r = 0; r < rows; ++r)
      if (red[0][r * C + c0 + j] == top)
        ties = __fadd_rn(ties, red[1][r * C + c0 + j]);
    if (any_nan) {
      top = __int_as_float(0x7fffffff);
      ties = 0.0f;
    }
    mx[j] = top;
    dxc[j] = __fdiv_rn(a.dmax[u * C + c0 + j], ties);
  }
  __syncthreads();
  if (threadIdx.y == 0) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      a.scratch[(u * 2) * C + c0 + j] = mx[j];
      a.scratch[(u * 2 + 1) * C + c0 + j] = dxc[j];
    }
  }
}

template <typename T, int kAct, int kMode>
__global__ void __launch_bounds__(kThreads) grad_reduce(GradArgs a) {
  constexpr int L = 16 / sizeof(T);
  __shared__ float red[2][kThreads * L];
  const int C = a.C, c0 = threadIdx.x * L, rows = blockDim.y;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float m[L], k[L], b[L], acc[2][L], rb[L], dm[L], mx[L], dxc[L];
  constants<L>(a, c0, m, k, b);
#pragma unroll
  for (int j = 0; j < L; ++j)
    acc[0][j] = acc[1][j] = rb[j] = dm[j] = mx[j] = dxc[j] = 0.0f;
  for (long long u = blockIdx.x; u * a.span < a.pixels; u += gridDim.x) {
    const long long base = u * a.span;
    const int n = static_cast<int>(a.span < a.pixels - base ? a.span
                                                            : a.pixels - base);
    if constexpr (kMode == kRow) load_f<L>(a.rowbias + u * C + c0, rb);
    if constexpr (kMode == kGpool || kMode == kValue)
      load_f<L>(a.dmean + u * C + c0, dm);
    if constexpr (kMode == kGpool)
      board_max<T, kAct, L>(a, u, base, n, m, k, b, red, mx, dxc);
    for (int i = threadIdx.y; i < n; i += 2 * rows) {
      const bool has1 = i + rows < n;
      const long long o0 = (base + i) * C + c0;
      const long long o1 = o0 + static_cast<long long>(rows) * C;
      const uint4 x0 = load(x + o0), x1 = has1 ? load(x + o1) : zero;
      uint4 g0 = zero, g1 = zero;
      if constexpr (kMode <= kRow) {
        g0 = load(g + o0);
        if (has1) g1 = load(g + o1);
      }
      float gy[L], d[L];
      grad_terms<T, kAct, kMode>(x0, g0, rb, dm, mx, dxc, m, k, b, gy, d);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        acc[0][j] = __fadd_rn(acc[0][j], gy[j]);
        acc[1][j] = __fadd_rn(acc[1][j], __fmul_rn(gy[j], d[j]));
      }
      if (has1) {
        grad_terms<T, kAct, kMode>(x1, g1, rb, dm, mx, dxc, m, k, b, gy, d);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          acc[0][j] = __fadd_rn(acc[0][j], gy[j]);
          acc[1][j] = __fadd_rn(acc[1][j], __fmul_rn(gy[j], d[j]));
        }
      }
    }
  }
  block_partials<2, L>(red, acc, a.partials, C);
}

// d v (skip: d s) of one pixel; row: df added to the board's sums
template <typename T, int kAct, int kMode>
__device__ __forceinline__ void apply_one(uint4 rx, uint4 rg, uint4 rs,
                                          const float* rb, const float* dm,
                                          const float* mx, const float* dxc,
                                          const float* m, const float* k,
                                          const float* b, const float* a1,
                                          const float* a2, float* sum,
                                          T* __restrict__ dx) {
  constexpr int L = 16 / sizeof(T);
  float gy[L], d[L];
  grad_terms<T, kAct, kMode>(rx, rg, rb, dm, mx, dxc, m, k, b, gy, d);
  const T* ls = reinterpret_cast<const T*>(&rs);
  uint4 rd;
  T* ld = reinterpret_cast<T*>(&rd);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float df = fmaf(k[j], gy[j], fmaf(a2[j], d[j], a1[j]));
    if constexpr (kMode == kRow) sum[j] = __fadd_rn(sum[j], df);
    if constexpr (kMode == kSkip) df = __fadd_rn(df, to_f(ls[j]));
    ld[j] = from_f<T>(df);
  }
  *reinterpret_cast<uint4*>(dx) = rd;
}

template <typename T, int kAct, int kMode>
__global__ void __launch_bounds__(kThreads) grad_apply(GradArgs a) {
  constexpr int L = 16 / sizeof(T);
  __shared__ float red[kMode == kRow ? kThreads * L : 1];
  const int C = a.C, c0 = threadIdx.x * L, rows = blockDim.y;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const T* gs = static_cast<const T*>(a.gs);
  T* dx = static_cast<T*>(a.dx);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float m[L], k[L], b[L], a1[L], a2[L], rb[L], dm[L], mx[L], dxc[L], sum[L];
  constants<L>(a, c0, m, k, b);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    a1[j] = a.coef1[c0 + j];
    a2[j] = a.coef2[c0 + j];
    rb[j] = dm[j] = mx[j] = dxc[j] = 0.0f;
  }
  for (long long u = blockIdx.x; u * a.span < a.pixels; u += gridDim.x) {
    const long long base = u * a.span;
    const int n = static_cast<int>(a.span < a.pixels - base ? a.span
                                                            : a.pixels - base);
    if constexpr (kMode == kRow) load_f<L>(a.rowbias + u * C + c0, rb);
    if constexpr (kMode == kGpool || kMode == kValue)
      load_f<L>(a.dmean + u * C + c0, dm);
    if constexpr (kMode == kGpool) {
      load_f<L>(a.scratch + (u * 2) * C + c0, mx);
      load_f<L>(a.scratch + (u * 2 + 1) * C + c0, dxc);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) sum[j] = 0.0f;
    for (int i = threadIdx.y; i < n; i += 2 * rows) {
      const bool has1 = i + rows < n;
      const long long o0 = (base + i) * C + c0;
      const long long o1 = o0 + static_cast<long long>(rows) * C;
      const uint4 x0 = load(x + o0), x1 = has1 ? load(x + o1) : zero;
      uint4 g0 = zero, g1 = zero, s0 = zero, s1 = zero;
      if constexpr (kMode <= kRow) {
        g0 = load(g + o0);
        if (has1) g1 = load(g + o1);
      }
      if constexpr (kMode == kSkip) {
        s0 = load(gs + o0);
        if (has1) s1 = load(gs + o1);
      }
      apply_one<T, kAct, kMode>(x0, g0, s0, rb, dm, mx, dxc, m, k, b, a1, a2,
                                sum, dx + o0);
      if (has1)
        apply_one<T, kAct, kMode>(x1, g1, s1, rb, dm, mx, dxc, m, k, b, a1,
                                  a2, sum, dx + o1);
    }
    if constexpr (kMode == kRow) {
      // the board's sums of df, over the block's rows in order
      const int at = threadIdx.y * C + c0;
#pragma unroll
      for (int j = 0; j < L; ++j) red[at + j] = sum[j];
      __syncthreads();
      if (threadIdx.y == 0) {
#pragma unroll
        for (int j = 0; j < L; ++j) {
          float t = 0.0f;
          for (int r = 0; r < rows; ++r) t = __fadd_rn(t, red[r * C + c0 + j]);
          a.drowbias[u * C + c0 + j] = t;
        }
      }
      __syncthreads();
    }
  }
}

// ------------------------------------------------------------- launching

template <typename T>
dim3 block_of(int C) {
  const int groups = C / (16 / static_cast<int>(sizeof(T)));
  return dim3(groups, kThreads / groups);
}

template <typename T, int kIn>
int stats(const void* v, const void* r, const float* rowbias,
          const float* weight, float* partials, int grid, float* mean,
          float* var, float* mul, float* gate, long long pixels,
          long long span, int C, double eps, cudaStream_t stream) {
  stats_kernel<T, kIn><<<grid, block_of<T>(C), 0, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(r), rowbias, partials,
      pixels, span, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stats_finish<<<finish_grid(C), dim3(kFinishX, kFinishY), 0, stream>>>(
      partials, grid, C, static_cast<double>(pixels), eps, weight, mean, var,
      mul, gate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kAct, int kMode>
int grad(const GradArgs& a, cudaStream_t stream) {
  const dim3 block = block_of<T>(a.C);
  grad_reduce<T, kAct, kMode><<<a.grid, block, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grad_finish<<<finish_grid(a.C), dim3(kFinishX, kFinishY), 0, stream>>>(
      a.partials, a.grid, a.C, static_cast<double>(a.pixels), a.eps, a.var,
      a.mul, a.gate, a.dweight, a.dbias, a.coef1, a.coef2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grad_apply<T, kAct, kMode><<<a.grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kAct>
int grad_mode(const GradArgs& a, int mode, cudaStream_t s) {
  switch (mode) {
    case kNormact: return grad<T, kAct, kNormact>(a, s);
    case kSkip: return grad<T, kAct, kSkip>(a, s);
    case kRow: return grad<T, kAct, kRow>(a, s);
    case kGpool: return grad<T, kAct, kGpool>(a, s);
    default: return grad<T, kAct, kValue>(a, s);
  }
}

bool valid(long long pixels, long long span, int C, int dtype, int grid) {
  const int lanes = lanes_of(dtype);
  return lanes != 0 && C > 0 && C % lanes == 0 && C / lanes <= kThreads &&
         pixels > 0 && pixels <= LLONG_MAX / C && span > 0 && grid > 0;
}

}  // namespace

// dtype 0: bf16, 1: fp32.  v (and r): [pixels, C] contiguous (an NHWC
// activation), 16-byte aligned; r (the skip: the statistics of T(r + v))
// and rowbias (fp32 [pixels / span, C], 16-byte aligned: span is then the
// board's H W) may each be null, not both given; weight fp32 [C];
// partials fp32 [grid, 2, C]; mean, var, mul, gate: fp32 [C] out.  C a
// multiple of the 16-byte vector's lanes (8 bf16, 4 fp32), at most 256
// vectors a pixel; the pass walks chunks of span pixels with grid blocks.
extern "C" int nbt_train_stats(const void* v, const void* r,
                               const void* rowbias, const void* weight,
                               void* partials, int grid, void* mean,
                               void* var, void* mul, void* gate,
                               long long pixels, long long span, int C,
                               int dtype, double eps, void* stream) {
  if (!valid(pixels, span, C, dtype, grid) || (r && rowbias) ||
      (rowbias && pixels % span))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rb = static_cast<const float*>(rowbias);
  const auto* w = static_cast<const float*>(weight);
  auto f = [](void* p) { return static_cast<float*>(p); };
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    if (r)
      return stats<T, kSkip>(v, r, rb, w, f(partials), grid, f(mean), f(var),
                             f(mul), f(gate), pixels, span, C, eps, s);
    if (rb)
      return stats<T, kRow>(v, r, rb, w, f(partials), grid, f(mean), f(var),
                            f(mul), f(gate), pixels, span, C, eps, s);
    return stats<T, kNormact>(v, r, rb, w, f(partials), grid, f(mean),
                              f(var), f(mul), f(gate), pixels, span, C, eps,
                              s);
  }
  if (r)
    return stats<float, kSkip>(v, r, rb, w, f(partials), grid, f(mean),
                               f(var), f(mul), f(gate), pixels, span, C, eps,
                               s);
  if (rb)
    return stats<float, kRow>(v, r, rb, w, f(partials), grid, f(mean),
                              f(var), f(mul), f(gate), pixels, span, C, eps,
                              s);
  return stats<float, kNormact>(v, r, rb, w, f(partials), grid, f(mean),
                                f(var), f(mul), f(gate), pixels, span, C, eps,
                                s);
}

// The backward of a layer of mode 0 normact, 1 skip, 2 row, 3 gpool, 4
// value; act 0 relu, 1 mish.  x: v (skip: s), as for nbt_train_stats;
// mean, var, mul, gate: its outputs; bias: the norm's fp32 [C]; g: d out
// (modes 0-2) and gs: d s_out (mode 1), like x; rowbias (mode 2) fp32
// [B, C]; dmean (modes 3, 4: the pooled mean's gradient over the board's
// points) and dmax (mode 3) fp32 [B, C]; scratch (mode 3) fp32 [B, 2, C];
// dx: like x, out; drowbias (mode 2) fp32 [B, C], out; partials fp32
// [grid, 2, C]; coef1, coef2 fp32 [C] scratch; dweight, dbias fp32 [C]
// out.  Modes 2-4 walk whole boards: span = H W, pixels = B span.
extern "C" int nbt_train_grad(const void* x, const void* rowbias,
                              const void* mean, const void* var,
                              const void* mul, const void* gate,
                              const void* bias, const void* g, const void* gs,
                              const void* dmean, const void* dmax,
                              void* scratch, void* dx, void* drowbias,
                              void* partials, int grid, void* coef1,
                              void* coef2, void* dweight, void* dbias,
                              long long pixels, long long span, int C,
                              int dtype, int act, int mode, double eps,
                              void* stream) {
  const bool board = mode >= kRow;
  if (!valid(pixels, span, C, dtype, grid) || mode < 0 || mode > kValue ||
      (act >> 1) || (board && pixels % span) || (mode <= kRow && !g) ||
      (mode == kSkip && !gs) || (mode == kRow && (!rowbias || !drowbias)) ||
      (mode >= kGpool && !dmean) || (mode == kGpool && (!dmax || !scratch)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  const GradArgs a{x,        cf(rowbias), cf(mean),   cf(var),     cf(mul),
                   cf(gate), cf(bias),    g,          gs,          cf(dmean),
                   cf(dmax), f(scratch),  dx,         f(drowbias), f(partials),
                   grid,     f(coef1),    f(coef2),   f(dweight),  f(dbias),
                   pixels,   span,        C,          eps};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return act ? grad_mode<__nv_bfloat16, 1>(a, mode, s)
               : grad_mode<__nv_bfloat16, 0>(a, mode, s);
  return act ? grad_mode<float, 1>(a, mode, s)
             : grad_mode<float, 0>(a, mode, s);
}
