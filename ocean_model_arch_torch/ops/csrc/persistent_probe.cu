// Mechanism probe of the persistent fused step for Hopper (sm_90a): a
// trivial stencil walked for many model steps, so that what a persistent
// launch costs and keeps (a grid-wide barrier a step, a carried state in
// L2) can be read apart from the step's arithmetic.
//
// Replaces: scripts/persistent_probe.py::build (pallas_call at :102) and
//   ::build_fori (:187), the TPU probe of the persistent-VMEM megakernel
//   (ocean_model_arch_tpu/ops/pallas/fused_step.py::
//   build_persistent_sw_step). For every interior row r of 6 f32 fields on
//   the (XS, YS) margined layout of build_fori (XS = X + 2 M, margins of M
//   rows carried unchanged; build's layout is the same with zero margins),
//   n_steps times:
//       new[r] = fma(old[r], 1.000001f, 0.000001f * old[r - M])
//   written with __fmaf_rn / __fmul_rn, the contraction JAX takes on the
//   CPU, so that nvcc does not choose it.
//   Plain PyTorch version: ops/persistent_probe.py::persistent_walk_reference
//   (the sum in float64, rounded once to f32: the same bits but for a rare
//   double-rounding tie).
//
// Three forms, the same bits:
//   (a) in place (the TPU design): one cooperative launch for n_steps, the
//       state updated in place. A tile's first M rows read the last M rows
//       of the tile before it, which that tile overwrites in the same step;
//       so each tile, after its own update, writes its new last M rows to a
//       stash slot that the next tile reads in the next step. The stash is
//       double-buffered by step parity: one grid barrier a step is enough.
//       Inside its rows a thread walks its column from the bottom chunk of M
//       rows up, so no row is written before it is read. State: 6 x XS x YS
//       f32 (42.9 MB at X = 1536, YS = 1152), which fits the H100's 50 MB
//       L2, plus the stash, 2 x 6 x (X / tx) x M x YS f32.
//   (b) ping-pong (the design of the persistent fused step): two state
//       buffers, step s reads one and writes the other, one grid barrier a
//       step; twice the state, which does not fit L2.
//   (c) one launch a step: (b)'s step as an ordinary launch per step, the
//       baseline the barrier is priced against.
// A tile is tx rows (a multiple of M that divides X) of one field by
// NTHREADS columns, one column a thread; tile t goes to block t mod
// gridDim. The cooperative forms run at most the co-resident grid
// (walk_coresident); a launch the card refuses returns its error.
//
// What bounds it: memory. A step must read the 6 fields (XS rows: the
// interior and the margin rows the first tiles read) and write their X
// interior rows: 85.4 MB at X = 1536, YS = 1152, 25.5 us at 3.35 TB/s
// from HBM; 2 flops a cell. Form (a) can beat that bound only if the state
// stays in L2 from one step to the next, which is the question it asks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NF = 6;             // fields
constexpr int M = 8;              // the stencil's reach in rows = the margin
constexpr int NTHREADS = 128;     // columns of a tile, one a thread

struct Fields {
  float* f[NF];
};

// field k of a set (k is uniform; selects on values, no indexed parameter)
__device__ __forceinline__ float* field(const Fields& s, int k) {
  float* p = s.f[0];
#pragma unroll
  for (int j = 1; j < NF; ++j)
    if (k == j) p = s.f[j];
  return p;
}

__device__ __forceinline__ float update(float old, float prev) {
  return __fmaf_rn(old, 1.000001f, __fmul_rn(0.000001f, prev));
}

// One step of one tile: rows [r0, r0 + tx) of column y, from src to dst
// (the same array in place). The M rows above the tile come from `head`
// (row stride YS): src's own rows, or a stash slot; with `tail` the tile's
// new last M rows also go there. Bottom chunk first: a chunk reads its own
// rows and the M above, which this thread has not written yet.
__device__ __forceinline__ void walk_tile(const float* src, float* dst,
                                          const float* head, float* tail,
                                          int r0, int tx, int y, int YS) {
  const size_t S = (size_t)YS;
  float cur[M], up[M];
#pragma unroll
  for (int j = 0; j < M; ++j) cur[j] = src[(size_t)(r0 + tx - M + j) * S + y];
  for (int c = tx - M; c >= 0; c -= M) {
    if (c > 0) {
#pragma unroll
      for (int j = 0; j < M; ++j) up[j] = src[(size_t)(r0 + c - M + j) * S + y];
    } else {
#pragma unroll
      for (int j = 0; j < M; ++j) up[j] = head[(size_t)j * S];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float v = update(cur[j], up[j]);
      dst[(size_t)(r0 + c + j) * S + y] = v;
      if (tail != nullptr && c == tx - M) tail[(size_t)j * S] = v;
      cur[j] = up[j];
    }
  }
}

// n_steps steps of every tile. INPLACE: form (a) on the set `a`; else form
// (b) (or, with n_steps = 1 in an ordinary launch, (c)): step s reads a and
// writes b for even s, the reverse for odd s. sync = 0 drops the barrier (a
// timing of the steps without it: the results are then not the walk's).
template <bool INPLACE>
__global__ void __launch_bounds__(NTHREADS)
walk_kernel(const Fields a, const Fields b, float* stash, int X, int YS,
            int tx, int n_steps, int sync) {
  const int NR = X / tx, NC = (YS + NTHREADS - 1) / NTHREADS;
  const int n_tiles = NF * NR * NC;
  const size_t slot = (size_t)M * YS;           // one stash slot: M rows
  const size_t half = (size_t)NF * NR * slot;   // the slots of one parity
  cg::grid_group grid = cg::this_grid();
  if (INPLACE) {
    // "step -1": parity 1 holds every tile's last M rows as they come in
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int y = (t % NC) * NTHREADS + threadIdx.x;
      const int i = (t / NC) % NR, k = t / (NC * NR);
      if (y >= YS) continue;
      const float* f = field(a, k);
      float* out = stash + half + (size_t)(k * NR + i) * slot + y;
#pragma unroll
      for (int j = 0; j < M; ++j)
        out[(size_t)j * YS] = f[(size_t)(M + (i + 1) * tx - M + j) * YS + y];
    }
    if (sync) grid.sync();
  }
  for (int s = 0; s < n_steps; ++s) {
    const int par = s & 1;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int y = (t % NC) * NTHREADS + threadIdx.x;
      const int i = (t / NC) % NR, k = t / (NC * NR);
      if (y >= YS) continue;
      const int r0 = M + i * tx;
      if (INPLACE) {
        float* f = field(a, k);
        const float* head = i > 0
            ? stash + (par ^ 1) * half + (size_t)(k * NR + i - 1) * slot + y
            : f + (size_t)(r0 - M) * YS + y;       // the fixed margin
        float* tail = stash + par * half + (size_t)(k * NR + i) * slot + y;
        walk_tile(f, f, head, tail, r0, tx, y, YS);
      } else {
        const float* src = par ? field(b, k) : field(a, k);
        float* dst = par ? field(a, k) : field(b, k);
        walk_tile(src, dst, src + (size_t)(r0 - M) * YS + y, nullptr, r0, tx,
                  y, YS);
      }
    }
    if (sync && s + 1 < n_steps) grid.sync();
  }
}

template <bool INPLACE>
int coresident(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, walk_kernel<INPLACE>, NTHREADS, 0);
  *blocks = per_sm * sms;
  return (int)e;
}

}  // namespace

extern "C" {

// The rows of the stencil's reach (the margin), the fields and the columns
// of a tile this library was built with.
int walk_margin() { return M; }

int walk_fields() { return NF; }

int walk_threads() { return NTHREADS; }

// The co-resident grid of form (a) (inplace != 0) or (b) on the current
// device: blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) x
// SMs, into *blocks; returns the CUDA error code (0 = success).
int walk_coresident(int inplace, int* blocks) {
  return inplace ? coresident<true>(blocks) : coresident<false>(blocks);
}

// One launch on `stream`; returns cudaGetLastError() (0 = launched). a, b:
// host arrays of the 6 fields' device pointers, each (X + 2 M, YS) f32
// (b unread by form 0). form 0: (a) in place on a, n_steps steps, with
// `stash` of 2 x 6 x (X / tx) x M x YS floats; 1: (b), ping-pong between a
// and b (the result in b for odd n_steps); 2: (c), one step from a into b,
// an ordinary launch of one block a tile (n_steps must be 1). Forms 0 and
// 1 are cooperative launches of `grid` blocks, which must not pass
// walk_coresident; sync = 0 drops their barrier (timing only). tx: rows of
// a tile, a multiple of M that divides X.
int walk_launch(float* const* a, float* const* b, float* stash, int X, int YS,
                int tx, int n_steps, int form, int sync, int grid,
                void* stream) {
  if (tx <= 0 || tx % M || X % tx || YS <= 0 || n_steps < 1 || form < 0
      || form > 2 || (form == 2 && n_steps != 1)
      || (form == 0 && stash == nullptr))
    return (int)cudaErrorInvalidValue;
  Fields fa, fb;
  for (int k = 0; k < NF; ++k) {
    fa.f[k] = a[k];
    fb.f[k] = form == 0 ? a[k] : b[k];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 2) {
    const int n_tiles = NF * (X / tx) * ((YS + NTHREADS - 1) / NTHREADS);
    walk_kernel<false><<<n_tiles, NTHREADS, 0, s>>>(fa, fb, nullptr, X, YS,
                                                     tx, 1, 0);
    return (int)cudaGetLastError();
  }
  int most = 0;
  int e = walk_coresident(form == 0, &most);
  if (e != 0) return e;
  if (grid < 1 || grid > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&fa, &fb, &stash, &X, &YS, &tx, &n_steps, &sync};
  const void* fn = form == 0 ? (const void*)walk_kernel<true>
                             : (const void*)walk_kernel<false>;
  e = (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(NTHREADS), args,
                                       0, s);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

const char* walk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
