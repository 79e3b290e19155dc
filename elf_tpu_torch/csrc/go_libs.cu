// Liberty kernels of the Go engine, hand-written for Hopper (sm_90a).
//
// Replaces the two TPU kernels of elf_tpu/env/go/pallas_kernels.py:
//   go_analyze_libs  <- analyze_libs_pallas (pallas_call :269, body _libs_kernel)
//   go_step_analysis <- step_analysis_pallas (pallas_call :228, body _step_kernel)
//
// What they compute, per board (flat point index p = row * N + col):
//   lib_min[p] / lib_max[p] = min / max flat index of any EMPTY point
//   adjacent to the chain of the stone at p (same-colour 4-connectivity);
//   INF (2^20) and -1 on empty points and on chains without liberties.
// step_analysis first places `color` at `action` (0 <= action < N^2; an
// occupied point is overwritten, a pass or negative action places nothing),
// removes the opponent chains that then have no liberty, and analyses the
// board after captures.
//
// Design: union-find chain labelling in shared memory.  One thread per
// point: a CTA is a (size, size, boards) block, thread (c, r, k) owns
// column c of row r of the CTA's k-th board, so no thread divides to find
// its point.  A CTA holds one 19x19 board (361 threads), several small
// boards (four 9x9 boards; up to 384 threads, at most 64 boards) or one
// 32x32 board (1024 threads).  Shared memory per point: parent, lib_min
// and lib_max (int32; step_analysis adds a has-liberty flag) and the int8
// board, 13 or 17 bytes: 6.1 KB for a 19x19 board, so no opt-in to more
// than 48 KB is needed.
//   1. load the board once (step_analysis applies the placement); each
//      stone is its own parent, its fields INF / -1; barrier;
//   2. each stone walks left over its row run to the run's first stone and
//      takes it as parent; the first stone of each stretch where a run of
//      this row and a run of the row above touch unites the two runs: a
//      union finds both roots (run starts) and links the larger under the
//      smaller with a shared-memory atomicMin, retrying when another thread
//      linked that root first; barrier;
//   3. each stone finds its root and does one atomicMin and one atomicMax
//      of the min / max index of its own empty neighbours into the root's
//      fields; barrier; each stone reads its root's fields, and an empty
//      point writes INF / -1.
// step_analysis labels once.  Step 3 on the placed board only marks the
// roots of chains with a liberty; barrier; the opponent stones of unmarked
// chains are captured and cleared; barrier; step 3 on the board after
// captures, with the SAME labels; barrier.  A capture removes whole
// opponent chains and never splits or joins a chain, so the chains of the
// board after captures are the chains of the placed board minus the
// captured ones.
//
// Fixed barrier count: 3 block-wide barriers in analyze_libs and 5 in
// step_analysis, whatever the chains look like.  The loops (run walks,
// root walks, union retries) are each thread's own and hold no barrier.
//
// Exact and deterministic: every link points from a larger index to a
// smaller one (parent[] is only lowered), so the trees have no cycles and
// each chain's root is its smallest point, whatever order the atomics ran
// in.  lib_min / lib_max are min / max reductions of integers, which do not
// depend on the order of the atomics either.
//
// Bound on this card: the byte bound at large B.  Per 19x19 board
// step_analysis reads 361 + 8 bytes and writes 361 * (1 + 4 + 4 + 1); at
// B = 4096 that is ~16 MB, ~4.9 us at 3.35 TB/s (analyze_libs: ~13 MB,
// ~4.0 us).  The kernels do not reach it: each point's thread runs a run
// walk, a union, a root walk, four neighbour reads and two atomics, so at
// B = 4096 the SMs' instruction issue and the CTAs' chains of dependent
// shared-memory steps set the time.  At the
// self-play batch (B = 32, 32 CTAs on 132 SMs) a launch moves ~116 KB, far
// below the fixed cost of a launch, and the time is that fixed cost plus
// one CTA's chain of dependent steps, which this design keeps short.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 20;
constexpr int kCtaThreads = 384;

struct Board {
  int b;        // board index
  int r, c, p;  // row, column and flat index of the thread's point
  bool active;  // the board is a real one
  int32_t* parent;
  int32_t* lm;
  int32_t* lx;
  int32_t* has_lib;  // step_analysis only
  int8_t* s;
};

// Shared-memory layout: `words` int32 arrays of boards * n2 entries
// (parent, lm, lx[, has_lib]), then the int8 board s[boards * n2].
__device__ __forceinline__ Board board_of(int32_t* smem, int B, int size,
                                          int words) {
  const int n2 = size * size;
  const int span = blockDim.z * n2;
  int32_t* base = smem + threadIdx.z * n2;
  Board t;
  t.c = threadIdx.x;
  t.r = threadIdx.y;
  t.p = t.r * size + t.c;
  t.b = blockIdx.x * blockDim.z + threadIdx.z;
  t.active = t.b < B;
  t.parent = base;
  t.lm = base + span;
  t.lx = base + 2 * span;
  t.has_lib = base + 3 * span;
  t.s = reinterpret_cast<int8_t*>(smem + words * span) + threadIdx.z * n2;
  return t;
}

// Root of x: follow parent links until a point is its own parent.  Other
// threads may lower parent[] meanwhile (volatile: read it anew each step).
__device__ __forceinline__ int find_root(const volatile int32_t* parent,
                                         int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// Joins the sets of a and b.  When the atomicMin finds that the larger root
// was linked by another thread first, the link it made may have replaced
// that one; uniting with the old parent again keeps all three connected.
__device__ void unite(int32_t* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&parent[b], a);
    if (old == b) return;
    b = old;
  }
}

// First stone of the row run of stone v at p (column c).
__device__ __forceinline__ int run_start(const int8_t* s, int p, int c,
                                         int8_t v) {
  while (c > 0 && s[p - 1] == v) {
    --p;
    --c;
  }
  return p;
}

// Step 2 for the stone v at p (row r, column c): parent[p] = the first
// stone of its run, and the first stone of each stretch where this run and
// a run of the row above touch unites the two runs (the stones to its
// right in the stretch join the same two runs).  Only run starts are roots
// or walked through in this step, and each thread writes the parent of a
// run's other stones only for its own point.
__device__ __forceinline__ int label_runs(const int8_t* s, int32_t* parent,
                                          int p, int r, int c, int size,
                                          int8_t v) {
  const int start = run_start(s, p, c, v);
  if (start != p) parent[p] = start;
  const int up = p - size;
  if (r > 0 && s[up] == v && !(c > 0 && s[p - 1] == v && s[up - 1] == v))
    unite(parent, start, run_start(s, up, c, v));
  return start;
}

// Min and max flat index of the empty points next to p (kInf / -1 if none).
__device__ __forceinline__ void own_libs(const int8_t* s, int p, int r, int c,
                                         int size, int& lo, int& hi) {
  lo = kInf;
  hi = -1;
  // neighbours in increasing index order: up, left, right, down
  if (r > 0 && s[p - size] == 0) { lo = min(lo, p - size); hi = p - size; }
  if (c > 0 && s[p - 1] == 0) { lo = min(lo, p - 1); hi = p - 1; }
  if (c < size - 1 && s[p + 1] == 0) { lo = min(lo, p + 1); hi = p + 1; }
  if (r < size - 1 && s[p + size] == 0) { lo = min(lo, p + size); hi = p + size; }
}

__global__ void analyze_libs_kernel(const int8_t* __restrict__ stones,
                                    int32_t* __restrict__ lm_out,
                                    int32_t* __restrict__ lx_out, int B,
                                    int size) {
  extern __shared__ int32_t smem[];
  const int n2 = size * size;
  const Board t = board_of(smem, B, size, 3);
  const int r = t.r, c = t.c;
  const int g = t.b * n2 + t.p;  // the launcher keeps B * n2 below 2^31
  int8_t v = 0;
  if (t.active) {
    v = stones[g];
    t.s[t.p] = v;
    if (v != 0) {
      t.parent[t.p] = t.p;
      t.lm[t.p] = kInf;
      t.lx[t.p] = -1;
    }
  }
  __syncthreads();  // barrier 1: board loaded, each stone its own root

  int start = t.p;
  if (t.active && v != 0)
    start = label_runs(t.s, t.parent, t.p, r, c, size, v);
  __syncthreads();  // barrier 2: chains labelled

  int root = t.p;
  if (t.active && v != 0) {
    root = find_root(t.parent, start);
    int lo, hi;
    own_libs(t.s, t.p, r, c, size, lo, hi);
    if (hi >= 0) {
      atomicMin(&t.lm[root], lo);
      atomicMax(&t.lx[root], hi);
    }
  }
  __syncthreads();  // barrier 3: liberties reduced at the roots

  if (t.active) {
    lm_out[g] = v != 0 ? t.lm[root] : kInf;
    lx_out[g] = v != 0 ? t.lx[root] : -1;
  }
}

__global__ void step_analysis_kernel(const int8_t* __restrict__ stones,
                                     const int32_t* __restrict__ action,
                                     const int32_t* __restrict__ color,
                                     int8_t* __restrict__ s2_out,
                                     int32_t* __restrict__ lm_out,
                                     int32_t* __restrict__ lx_out,
                                     uint8_t* __restrict__ cap_out, int B,
                                     int size) {
  extern __shared__ int32_t smem[];
  const int n2 = size * size;
  const Board t = board_of(smem, B, size, 4);
  const int r = t.r, c = t.c;
  const int g = t.b * n2 + t.p;  // the launcher keeps B * n2 below 2^31
  const int a = t.b < B ? action[t.b] : -1;
  const int col = t.b < B ? color[t.b] : 1;

  // placement (p < n2 here, so a pass or negative action never matches;
  // an occupied point is overwritten)
  int8_t v = 0;
  if (t.active) {
    v = stones[g];
    if (t.p == a) v = static_cast<int8_t>(col);
    t.s[t.p] = v;
    if (v != 0) {
      t.parent[t.p] = t.p;
      t.has_lib[t.p] = 0;
      t.lm[t.p] = kInf;
      t.lx[t.p] = -1;
    }
  }
  __syncthreads();  // barrier 1

  int start = t.p;
  if (t.active && v != 0)
    start = label_runs(t.s, t.parent, t.p, r, c, size, v);
  __syncthreads();  // barrier 2: chains of the placed board

  int root = t.p;
  if (t.active && v != 0) {
    root = find_root(t.parent, start);
    int lo, hi;
    own_libs(t.s, t.p, r, c, size, lo, hi);
    if (hi >= 0) t.has_lib[root] = 1;  // every writer stores the same 1
  }
  __syncthreads();  // barrier 3: chains with a liberty marked at the roots

  // remove the opponent chains without a liberty (no thread reads the
  // placed board after barrier 3)
  const bool cap = t.active && v == 3 - col && t.has_lib[root] == 0;
  if (cap) {
    v = 0;
    t.s[t.p] = 0;
  }
  __syncthreads();  // barrier 4: board after captures

  // same labels: a captured chain's stones are empty points now
  if (t.active && v != 0) {
    int lo, hi;
    own_libs(t.s, t.p, r, c, size, lo, hi);
    if (hi >= 0) {
      atomicMin(&t.lm[root], lo);
      atomicMax(&t.lx[root], hi);
    }
  }
  __syncthreads();  // barrier 5: liberties after captures at the roots

  if (t.active) {
    s2_out[g] = v;
    lm_out[g] = v != 0 ? t.lm[root] : kInf;
    lx_out[g] = v != 0 ? t.lx[root] : -1;
    cap_out[g] = cap ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Launch {
  dim3 grid;
  dim3 block;
  size_t smem;
};

// Union-find: a (size, size, boards) block; `words` int32 shared arrays per
// point, the int8 board on top.
Launch union_find_shape(int B, int size, int words) {
  const int n2 = size * size;
  int bpc = kCtaThreads / n2;
  if (bpc < 1) bpc = 1;
  if (bpc > 64) bpc = 64;  // the most a block's z dimension takes
  Launch l;
  l.grid = dim3((B + bpc - 1) / bpc);
  l.block = dim3(size, size, bpc);
  l.smem = static_cast<size_t>(bpc) * n2 * (4 * words + 1);
  return l;
}

}  // namespace

extern "C" int go_analyze_libs(const void* stones, void* lm, void* lx,
                               int B, int size, void* stream) {
  // the kernel indexes the batch with 32-bit point offsets
  if (static_cast<long long>(B) * size * size > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = union_find_shape(B, size, 3);
  analyze_libs_kernel<<<l.grid, l.block, l.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(stones), static_cast<int32_t*>(lm),
      static_cast<int32_t*>(lx), B, size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int go_step_analysis(const void* stones, const void* action,
                                const void* color, void* s2, void* lm,
                                void* lx, void* cap, int B, int size,
                                void* stream) {
  if (static_cast<long long>(B) * size * size > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = union_find_shape(B, size, 4);
  step_analysis_kernel<<<l.grid, l.block, l.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(stones), static_cast<const int32_t*>(action),
      static_cast<const int32_t*>(color), static_cast<int8_t*>(s2),
      static_cast<int32_t*>(lm), static_cast<int32_t*>(lx),
      static_cast<uint8_t*>(cap), B, size);
  return static_cast<int>(cudaGetLastError());
}
