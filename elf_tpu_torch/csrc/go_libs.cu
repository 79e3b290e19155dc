// Liberty-fixpoint kernels of the Go engine, hand-written for Hopper (sm_90a).
//
// Replaces the two TPU kernels of elf_tpu/env/go/pallas_kernels.py:
//   go_analyze_libs  <- analyze_libs_pallas (kernel body _libs_kernel)
//   go_step_analysis <- step_analysis_pallas (kernel body _step_kernel)
//
// What they compute, per board (flat point index p = row * N + col):
//   lib_min[p] / lib_max[p] = min / max flat index of any EMPTY point
//   adjacent to the chain of the stone at p (same-colour 4-connectivity);
//   INF (2^20) and -1 on empty points and on chains without liberties.
// step_analysis first places `color` at `action` (0 <= action < N^2; an
// occupied point is overwritten, a pass or negative action places nothing),
// runs a min-only fixpoint, removes the opponent chains with lib_min == INF,
// then runs the full min/max fixpoint on the post-capture board.
//
// Design: one thread per point, the threads of a board padded to a whole
// number of warps; a CTA of 384 threads holds one 19x19 board (361 points)
// or several small boards (four 9x9 boards).  The board and both fields
// live in shared memory (9 bytes per point, ~3.4 KB per 19x19 board).  Each
// round a stone takes the min/max of its same-colour neighbours in place
// and the rounds repeat until __syncthreads_or(changed) == 0.  The fixpoint
// is unique (the min and max over each chain), so in-place (Gauss-Seidel)
// updates converge to the same integers as the TPU kernel's Jacobi rounds.
// Device memory is read once and written once per call; the int8 board is
// read as is.
//
// Bound: at large B both kernels are memory-bound.  Per 19x19 board
// step_analysis moves 361 + 8 bytes in and 361 * (1 + 4 + 4 + 1) bytes out;
// at B = 4096 that is ~16 MB, ~5 us at 3.35 TB/s.  The integer work is a
// few compares per point per round.  At the self-play batch (B = 32) a
// launch is latency-bound: 32 CTAs on 132 SMs, each running ~10-40
// dependent rounds of a block-wide barrier.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 20;
constexpr int kCtaThreads = 384;

// Min (and, WITH_MAX, max) liberty fixpoint of one board held in shared
// memory.  Every thread of the CTA calls it (it contains barriers);
// `active` threads own point p of board `s`.  Returns the converged values
// of point p in my_lm / my_lx.
template <bool WITH_MAX>
__device__ void liberty_fixpoint(const int8_t* s, int32_t* lm, int32_t* lx,
                                 int p, int size, bool active,
                                 int& my_lm, int& my_lx) {
  my_lm = kInf;
  my_lx = -1;
  int nbr[4];
  int nn = 0;
  if (active) {
    const int8_t me = s[p];
    if (me != 0) {
      const int r = p / size;
      const int c = p - r * size;
      int cand[4];
      int nc = 0;
      if (r > 0) cand[nc++] = p - size;
      if (r < size - 1) cand[nc++] = p + size;
      if (c > 0) cand[nc++] = p - 1;
      if (c < size - 1) cand[nc++] = p + 1;
      for (int i = 0; i < nc; ++i) {
        const int q = cand[i];
        const int8_t sq = s[q];
        if (sq == 0) {
          my_lm = min(my_lm, q);
          my_lx = max(my_lx, q);
        } else if (sq == me) {
          nbr[nn++] = q;
        }
      }
    }
    lm[p] = my_lm;
    if (WITH_MAX) lx[p] = my_lx;
  }
  __syncthreads();
  while (true) {
    bool changed = false;
    for (int i = 0; i < nn; ++i) {
      const int v = lm[nbr[i]];
      if (v < my_lm) {
        my_lm = v;
        changed = true;
      }
      if (WITH_MAX) {
        const int x = lx[nbr[i]];
        if (x > my_lx) {
          my_lx = x;
          changed = true;
        }
      }
    }
    if (changed) {
      lm[p] = my_lm;
      if (WITH_MAX) lx[p] = my_lx;
    }
    if (!__syncthreads_or(changed)) break;
  }
}

struct Slot {
  int b;        // board index
  int p;        // point index within the board
  bool active;  // thread owns a real point of a real board
  int32_t* lm;
  int32_t* lx;
  int8_t* s;
};

// Shared-memory layout: lm[bpc * tpb] | lx[bpc * tpb] | s[bpc * tpb] (int8).
__device__ Slot make_slot(int32_t* smem, int B, int n2, int tpb) {
  const int bpc = blockDim.x / tpb;
  const int slot = threadIdx.x / tpb;
  Slot t;
  t.p = threadIdx.x - slot * tpb;
  t.b = blockIdx.x * bpc + slot;
  t.active = t.b < B && t.p < n2;
  t.lm = smem + slot * tpb;
  t.lx = smem + bpc * tpb + slot * tpb;
  t.s = reinterpret_cast<int8_t*>(smem + 2 * bpc * tpb) + slot * tpb;
  return t;
}

__global__ void analyze_libs_kernel(const int8_t* __restrict__ stones,
                                    int32_t* __restrict__ lm_out,
                                    int32_t* __restrict__ lx_out,
                                    int B, int size, int tpb) {
  extern __shared__ int32_t smem[];
  const int n2 = size * size;
  Slot t = make_slot(smem, B, n2, tpb);
  const size_t g = static_cast<size_t>(t.b) * n2 + t.p;
  if (t.active) t.s[t.p] = stones[g];
  __syncthreads();
  int my_lm, my_lx;
  liberty_fixpoint<true>(t.s, t.lm, t.lx, t.p, size, t.active, my_lm, my_lx);
  if (t.active) {
    lm_out[g] = my_lm;
    lx_out[g] = my_lx;
  }
}

__global__ void step_analysis_kernel(const int8_t* __restrict__ stones,
                                     const int32_t* __restrict__ action,
                                     const int32_t* __restrict__ color,
                                     int8_t* __restrict__ s2_out,
                                     int32_t* __restrict__ lm_out,
                                     int32_t* __restrict__ lx_out,
                                     uint8_t* __restrict__ cap_out,
                                     int B, int size, int tpb) {
  extern __shared__ int32_t smem[];
  const int n2 = size * size;
  Slot t = make_slot(smem, B, n2, tpb);
  const size_t g = static_cast<size_t>(t.b) * n2 + t.p;
  const int a = t.b < B ? action[t.b] : -1;
  const int col = t.b < B ? color[t.b] : 1;

  // 1. tentative placement (p < n2 here, so a pass or negative action
  //    never matches; an occupied point is overwritten)
  int8_t v = 0;
  if (t.active) {
    v = stones[g];
    if (t.p == a) v = static_cast<int8_t>(col);
    t.s[t.p] = v;
  }
  __syncthreads();

  // 2. min-only fixpoint: a chain without liberties keeps lib_min == INF
  int my_lm, my_lx;
  liberty_fixpoint<false>(t.s, t.lm, t.lx, t.p, size, t.active, my_lm, my_lx);

  // 3. remove zero-liberty opponent chains (the fixpoint ended on a
  //    barrier, so no thread still reads the pre-capture board)
  const bool cap = t.active && my_lm == kInf && v == 3 - col;
  if (cap) {
    v = 0;
    t.s[t.p] = 0;
  }
  __syncthreads();

  // 4. full min/max fixpoint on the post-capture board
  liberty_fixpoint<true>(t.s, t.lm, t.lx, t.p, size, t.active, my_lm, my_lx);
  if (t.active) {
    s2_out[g] = v;
    lm_out[g] = my_lm;
    lx_out[g] = my_lx;
    cap_out[g] = cap ? 1 : 0;
  }
}

struct Launch {
  int tpb;
  dim3 grid;
  dim3 block;
  size_t smem;
};

Launch launch_shape(int B, int size) {
  const int n2 = size * size;
  Launch l;
  l.tpb = (n2 + 31) / 32 * 32;
  int bpc = kCtaThreads / l.tpb;
  if (bpc < 1) bpc = 1;
  l.grid = dim3((B + bpc - 1) / bpc);
  l.block = dim3(bpc * l.tpb);
  l.smem = static_cast<size_t>(bpc) * l.tpb * (4 + 4 + 1);
  return l;
}

}  // namespace

extern "C" int go_analyze_libs(const void* stones, void* lm, void* lx,
                               int B, int size, void* stream) {
  const Launch l = launch_shape(B, size);
  analyze_libs_kernel<<<l.grid, l.block, l.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(stones), static_cast<int32_t*>(lm),
      static_cast<int32_t*>(lx), B, size, l.tpb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int go_step_analysis(const void* stones, const void* action,
                                const void* color, void* s2, void* lm,
                                void* lx, void* cap, int B, int size,
                                void* stream) {
  const Launch l = launch_shape(B, size);
  step_analysis_kernel<<<l.grid, l.block, l.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(stones), static_cast<const int32_t*>(action),
      static_cast<const int32_t*>(color), static_cast<int8_t*>(s2),
      static_cast<int32_t*>(lm), static_cast<int32_t*>(lx),
      static_cast<uint8_t*>(cap), B, size, l.tpb);
  return static_cast<int>(cudaGetLastError());
}
