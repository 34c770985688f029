// Copy step for Hopper (sm_90a): the fused shallow-water step's memory
// traffic without its arithmetic, the speed of light of its tiling.
//
// Replaces: scripts/roofline_probe.py::build_copy_step (pallas_call at
//   :71), the copy-through kernel with exactly the fused step's windows and
//   tiles: every output tile gets
//       out_i = (sum over all inputs of the tile's centre cells) + i.
//   Plain PyTorch version: ops/copy_step.py::copy_step_reference, the same
//   sum in the same order (float additions only, so the two agree exactly).
//
// What bounds it: memory, by construction. Per layout cell it reads n_win
// windowed f32 planes (the carried fields and the static planes) and n_met
// metric rows, and writes n_out planes; beside the form <tracers, guard,
// metric form> of fused_sw_step_kernel that is the same bytes: 64 + 16 T
// per cell, + 4 per metric plane. The chained form's copy step moves the
// same bytes for a launch that runs two model steps.
//
// What the design does: it is the fused kernel's skeleton. The same tile
// (fused_tile.cuh: 16 x 32 outputs, 512 threads, three blocks per SM), the
// same window halo (3, or 4 for the tracer form), the same dynamic shared
// memory (16 windows, plus the four stress planes of a viscous form, so
// the same blocks fit an SM), one block per tile. With steps = 2 it takes
// the chained form's tile, threads, window (halo 6, or 8) and shared
// memory (20 + 2 T windows, plus the wider stress planes) instead.
// Stage 0 loads the haloed window of every windowed input into shared
// memory, cells outside the array reading as 0; after the barrier each
// thread sums the centre cells of its tile from shared memory, adds the
// metric rows of its own cell from device memory (a profile by column, a
// plane by cell, as the fused kernel reads them) and stores the n_out
// outputs. With per-block wet flags an all-land block writes zeros and
// returns before it loads anything, as the guarded fused kernel does.

#include "fused_tile.cuh"

namespace {

using namespace fused_tile;

constexpr int MAX_WIN = N_SMEM_PLANES;   // windowed inputs: one window each
constexpr int MAX_OUT = 6 + 2 * MAX_TRACERS;

struct Params {
  const float* win[MAX_WIN];   // (Xs, Ys) fields, then static planes
  float* out[MAX_OUT];         // (Xs, Ys)
  const float* met;            // (n_met, Ys) or (n_met, Xs, Ys), or null
  const int* tile_wet;         // one flag per block, or null
  int n_win, n_out, n_met, met2d;
  int Xs, Ys;
};

__device__ __forceinline__ bool inside(const Params& p, int gx, int gy) {
  return gx >= 0 && gx < p.Xs && gy >= 0 && gy < p.Ys;
}

// NT selects the window: Form<0> has halo 3, Form<1> halo 4; STEPS = 2
// the chained form's tile and window (halo 6, 8).
template <int NT, int STEPS>
__global__ void
__launch_bounds__(Tile<STEPS>::NTHREADS, Tile<STEPS>::MIN_BLOCKS)
copy_step_kernel(const Params p) {
  constexpr int HALO = Form<NT, STEPS>::WH;
  constexpr int WY = Form<NT, STEPS>::WY, PLANE = Form<NT, STEPS>::PLANE;
  constexpr int TX = Tile<STEPS>::TX, TY = Tile<STEPS>::TY;
  constexpr int NTHREADS = Tile<STEPS>::NTHREADS;

  const int tid = threadIdx.x;
  const int tx0 = blockIdx.y * TX, ty0 = blockIdx.x * TY;

  if (p.tile_wet != nullptr
      && p.tile_wet[blockIdx.y * gridDim.x + blockIdx.x] == 0) {
    for (int i = tid; i < TX * TY; i += NTHREADS) {
      const int gx = tx0 + i / TY, gy = ty0 + i % TY;
      if (!inside(p, gx, gy)) continue;
      const size_t g = (size_t)gx * p.Ys + gy;
      for (int o = 0; o < p.n_out; ++o) p.out[o][g] = 0.f;
    }
    return;
  }

  extern __shared__ float sm[];
  const int x0 = tx0 - HALO, y0 = ty0 - HALO;

  // stage 0: the haloed window of every windowed input
  for (int i = tid; i < PLANE; i += NTHREADS) {
    const int gx = x0 + i / WY, gy = y0 + i % WY;
    const bool in = inside(p, gx, gy);
    const size_t g = in ? (size_t)gx * p.Ys + gy : 0;
#pragma unroll 4
    for (int j = 0; j < p.n_win; ++j)
      sm[j * PLANE + i] = in ? p.win[j][g] : 0.f;
  }
  __syncthreads();

  // stage 1: sum the centre cells, add the cell's metrics, store
  const size_t plane = (size_t)p.Xs * p.Ys;
  for (int i = tid; i < TX * TY; i += NTHREADS) {
    const int a = HALO + i / TY, b = HALO + i % TY;
    const int k = a * WY + b, gx = x0 + a, gy = y0 + b;
    if (!inside(p, gx, gy)) continue;
    const size_t g = (size_t)gx * p.Ys + gy;
    float acc = 0.f;
    for (int j = 0; j < p.n_win; ++j) acc += sm[j * PLANE + k];
    for (int r = 0; r < p.n_met; ++r)
      acc += p.met2d ? p.met[r * plane + g] : p.met[(size_t)r * p.Ys + gy];
    for (int o = 0; o < p.n_out; ++o) p.out[o][g] = acc + (float)o;
  }
}

template <int NT, int STEPS>
int launch(const Params& p, bool visc, cudaStream_t stream) {
  // a viscous form's block also holds its stress planes (unused here)
  using T = Tile<STEPS>;
  const size_t smem = smem_bytes<NT, STEPS>(visc);
  cudaError_t e = cudaFuncSetAttribute(
      copy_step_kernel<NT, STEPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<NT, STEPS>(true));
  if (e != cudaSuccess) return (int)e;
  copy_step_kernel<NT, STEPS>
      <<<dim3((p.Ys + T::TY - 1) / T::TY, (p.Xs + T::TX - 1) / T::TX),
         T::NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The output tile (rows, columns) of a block for the forms that run
// `steps` model steps a launch: the same constants the fused step is built
// with.
int copy_step_tile_x(int steps) {
  return steps == 2 ? Tile<2>::TX : Tile<1>::TX;
}

int copy_step_tile_y(int steps) {
  return steps == 2 ? Tile<2>::TY : Tile<1>::TY;
}

int copy_step_max_windows() { return MAX_WIN; }

int copy_step_max_outputs() { return MAX_OUT; }

const char* copy_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one copy step on `stream`; returns cudaGetLastError() (0 =
// launched). win / out: host arrays of n_win / n_out device pointers to
// (Xs, Ys) planes. met: n_met metric rows, (n_met, Xs, Ys) planes when
// met2d != 0, else (n_met, Ys) profiles; unread when n_met = 0. tile_wet:
// device array of one int per block, or null. tracer_form: load the
// tracer form's window (halo 4) instead of halo 3. visc_form: take the
// shared memory of a viscous form of the fused step. steps: 2 takes the
// chained form's tile, window and shared memory.
int copy_step_launch(const float* const* win, int n_win,
                     float* const* out, int n_out, const float* met,
                     int n_met, int met2d, const int* tile_wet,
                     int tracer_form, int visc_form, int steps, int Xs,
                     int Ys, void* stream) {
  if (n_win < 0 || n_win > MAX_WIN || n_out < 1 || n_out > MAX_OUT
      || n_met < 0 || (n_met > 0 && met == nullptr)
      || (steps != 1 && steps != 2))
    return (int)cudaErrorInvalidValue;
  Params p{{}, {}, met, tile_wet, n_win, n_out, n_met, met2d, Xs, Ys};
  for (int j = 0; j < n_win; ++j) p.win[j] = win[j];
  for (int o = 0; o < n_out; ++o) p.out[o] = out[o];
  cudaStream_t s = (cudaStream_t)stream;
  const bool visc = visc_form != 0;
  if (steps == 2)
    return tracer_form ? launch<1, 2>(p, visc, s) : launch<0, 2>(p, visc, s);
  return tracer_form ? launch<1, 1>(p, visc, s) : launch<0, 1>(p, visc, s);
}

}  // extern "C"
