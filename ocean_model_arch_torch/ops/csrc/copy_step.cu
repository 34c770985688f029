// Copy step for Hopper (sm_90a): the fused shallow-water step's memory
// traffic without its arithmetic, the speed of light of its tiling.
//
// Replaces: scripts/roofline_probe.py::build_copy_step (pallas_call at
//   :71), the copy-through kernel with exactly the fused step's windows and
//   tiles: every output tile gets
//       out_i = (sum over all inputs of the tile's centre cells) + i.
//   Plain PyTorch version: ops/copy_step.py::copy_step_reference, the same
//   sum in the same order (float additions only, so the two agree exactly).
//   And its stacked form: scripts/roofline_probe.py::
//   build_copy_step_stacked (pallas_call at :103), the same sum read from
//   ONE (n_in, Xs, Ys) input and written to ONE (n_out, Xs, Ys) output,
//   which on the TPU isolates the pipeline's cost per window.
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
// memory (20 + 2 T windows as far as they fit, plus the wider stress
// planes) instead. Stage 0 loads the haloed window of the windowed inputs
// into shared memory, as many as its planes hold, cells outside the array
// reading as 0; after the barrier each thread adds the centre cells of
// its tile to its running sums, in registers; more inputs than planes (a
// form with more than 2 tracers) load in turns. Then each thread adds the
// metric rows of its own cell from device memory (a profile by column, a
// plane by cell, as the fused kernel reads them) and stores the n_out
// outputs. With per-block wet flags an all-land block writes zeros and
// returns before it loads anything, as the guarded fused kernel does. The
// stacked form differs only in its addresses: input j at in + j Xs Ys,
// output o at out + o Xs Ys, instead of a pointer each.
//
// The TMA form (ASYNC = 1, the fused step's loader since it brings its
// windows in by TMA, fused_step.cu's head): one tensor map a windowed input
// (2D f32, dims (Ys, Xs), box = the window, zeros outside the array;
// tma.cuh), passed in the parameter block. Thread 0 initialises one
// mbarrier, posts the bytes of the turn's boxes and issues them all; every
// thread waits on the barrier's phase, then sums and stores as the other
// form does. A later turn reuses the planes after a barrier (every thread
// has read them; the copies only write). The threads spend no instruction
// on an address or a bounds test of a window cell, and every window of a
// turn is in flight at once instead of four loads a thread. The guard's
// all-land return comes before any copy. ASYNC = 0 is the loader of
// threads above (the stacked form K4 keeps it), kept to time against.

#include "fused_tile.cuh"
#include "tma.cuh"

#include <algorithm>
#include <type_traits>

namespace {

using namespace fused_tile;

// windowed inputs and outputs of one launch: enough for the forms of the
// fused step with up to 21 tracers (6 + 2 T fields and 6 static planes)
constexpr int MAX_WIN = 48;
constexpr int MAX_OUT = 48;

struct Params {
  const float* win[MAX_WIN];   // (Xs, Ys) fields, then static planes
  float* out[MAX_OUT];         // (Xs, Ys)
  const float* in_stack;       // stacked form: (n_win, Xs, Ys)
  float* out_stack;            // stacked form: (n_out, Xs, Ys)
  const float* met;            // (n_met, Ys) or (n_met, Xs, Ys), or null
  const int* tile_wet;         // one flag per block, or null
  int n_win, n_out, n_met, met2d;
  int n_chunk;                 // windows shared memory holds at once
  int Xs, Ys;
  size_t plane;                // Xs * Ys: the stacked form's plane stride
};

// the TMA form's tensor maps, one a windowed input, beside Params in the
// kernel's 4 KB of parameters
constexpr int MAX_ASYNC_WIN = 24;
struct Maps {
  CUtensorMap m[MAX_ASYNC_WIN];
};
struct NoMaps {};
static_assert(sizeof(Params) + sizeof(Maps) + 64 <= 4096,
              "kernel parameters are 4 KB");

__device__ __forceinline__ bool inside(const Params& p, int gx, int gy) {
  return gx >= 0 && gx < p.Xs && gy >= 0 && gy < p.Ys;
}

// output o at cell g; the stacked form walks its planes with a pointer
template <bool STACKED>
__device__ __forceinline__ void store(const Params& p, size_t g, float a) {
  if constexpr (STACKED) {
    float* dst = p.out_stack + g;
    for (int o = 0; o < p.n_out; ++o, dst += p.plane) *dst = a + (float)o;
  } else {
    for (int o = 0; o < p.n_out; ++o) p.out[o][g] = a + (float)o;
  }
}

// NT selects the window: Form<0> has halo 3, Form<1> halo 4; STEPS = 2
// the chained form's tile and window (halo 6, 8); STACKED the stacked
// form's addresses; ASYNC the TMA loader (maps: its tensor maps, first in
// the parameter block, where each keeps the 64-byte alignment TMA asks).
template <int NT, int STEPS, bool STACKED, bool ASYNC>
__global__ void
__launch_bounds__(Tile<STEPS>::NTHREADS, Tile<STEPS>::MIN_BLOCKS)
copy_step_kernel(const __grid_constant__ std::conditional_t<ASYNC, Maps,
                                                            NoMaps> maps,
                 const Params p) {
  static_assert(!(ASYNC && STACKED), "the stacked form loads by threads");
  // the window of the loader's form (the threads' the one they had)
  using Fm = Form<NT, STEPS, ASYNC>;
  constexpr int HALO = Fm::WH;
  constexpr int WY = Fm::WY, PLANE = Fm::PLANE;
  constexpr int WCELLS = Fm::CELLS;
  constexpr int SH = Fm::R;  // the TMA box begins SH columns before it
  constexpr int TX = Tile<STEPS>::TX, TY = Tile<STEPS>::TY;
  constexpr int NTHREADS = Tile<STEPS>::NTHREADS;
  constexpr int CELLS = (TX * TY + NTHREADS - 1) / NTHREADS;  // a thread's

  const int tid = threadIdx.x;
  const int tx0 = blockIdx.y * TX, ty0 = blockIdx.x * TY;

  if (p.tile_wet != nullptr
      && p.tile_wet[blockIdx.y * gridDim.x + blockIdx.x] == 0) {
    for (int i = tid; i < TX * TY; i += NTHREADS) {
      const int gx = tx0 + i / TY, gy = ty0 + i % TY;
      if (!inside(p, gx, gy)) continue;
      const size_t g = (size_t)gx * p.Ys + gy;
      if constexpr (STACKED) {
        float* dst = p.out_stack + g;
        for (int o = 0; o < p.n_out; ++o, dst += p.plane) *dst = 0.f;
      } else {
        for (int o = 0; o < p.n_out; ++o) p.out[o][g] = 0.f;
      }
    }
    return;
  }

  extern __shared__ float sm_raw[];
  float* sm = ASYNC ? tma::align128(sm_raw) : sm_raw;
  __shared__ uint64_t bar;      // the TMA form's
  const int x0 = tx0 - HALO, y0 = ty0 - HALO;

  if constexpr (ASYNC) {
    if (tid == 0) {
      tma::bar_init(&bar);
      tma::bar_fence();
    }
    __syncthreads();
  }
  float acc[CELLS];
#pragma unroll
  for (int c = 0; c < CELLS; ++c) acc[c] = 0.f;
  for (int j0 = 0, turn = 0; j0 < p.n_win; j0 += p.n_chunk, ++turn) {
    const int nj = min(p.n_chunk, p.n_win - j0);
    if (j0) __syncthreads();   // every thread has summed the last turn's

    // stage 0: the haloed window of the turn's windowed inputs
    if constexpr (ASYNC) {
      if (tid == 0) {
        tma::bar_expect(&bar, sizeof(float) * WCELLS * nj);
        for (int j = 0; j < nj; ++j)
          tma::load_2d(sm + j * PLANE, &maps.m[j0 + j], &bar, x0, y0 - SH);
      }
      tma::bar_wait(&bar, turn & 1);
    } else for (int i = tid; i < WCELLS; i += NTHREADS) {
      const int gx = x0 + i / WY, gy = y0 + i % WY;
      const bool in = inside(p, gx, gy);
      const size_t g = in ? (size_t)gx * p.Ys + gy : 0;
      if constexpr (STACKED) {
        const float* src = p.in_stack + j0 * p.plane + g;
#pragma unroll 4
        for (int j = 0; j < nj; ++j, src += p.plane)
          sm[j * PLANE + i] = in ? *src : 0.f;
      } else {
#pragma unroll 4
        for (int j = 0; j < nj; ++j)
          sm[j * PLANE + i] = in ? p.win[j0 + j][g] : 0.f;
      }
    }
    if constexpr (!ASYNC) __syncthreads();

    // stage 1: add the centre cells to the running sums
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int i = tid + c * NTHREADS;
      if (i >= TX * TY) break;
      const int k = (HALO + i / TY) * WY + HALO + i % TY;
      for (int j = 0; j < nj; ++j) acc[c] += sm[j * PLANE + SH + k];
    }
  }

  // stage 2: add the cell's metrics, store
  const size_t plane = (size_t)p.Xs * p.Ys;
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int i = tid + c * NTHREADS;
    if (i >= TX * TY) break;
    const int gx = tx0 + i / TY, gy = ty0 + i % TY;
    if (!inside(p, gx, gy)) continue;
    const size_t g = (size_t)gx * p.Ys + gy;
    float a = acc[c];
    for (int r = 0; r < p.n_met; ++r)
      a += p.met2d ? p.met[r * plane + g] : p.met[(size_t)r * p.Ys + gy];
    store<STACKED>(p, g, a);
  }
}

template <int NT, int STEPS, bool STACKED, bool ASYNC>
int launch(Params& p, int n_tr, bool visc, cudaStream_t stream) {
  // the fused form's shared memory: a viscous form's block also holds its
  // stress planes, unused here but for the turns' windows (and the TMA
  // form 128 bytes more, by which it aligns them)
  using T = Tile<STEPS>;
  using Fm = Form<NT, STEPS, ASYNC>;
  int levels = 0;
  const size_t fsmem = form_smem_bytes<STEPS, ASYNC>(n_tr, visc, &levels);
  p.n_chunk = (int)(fsmem / (sizeof(float) * Fm::PLANE));
  const size_t smem = fsmem + (ASYNC ? 128 : 0);
  std::conditional_t<ASYNC, Maps, NoMaps> maps{};
  if constexpr (ASYNC) {
    if (p.n_win > MAX_ASYNC_WIN) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < p.n_win; ++j) {
      const int e = tma::map_2d(&maps.m[j], p.win[j], p.Xs, p.Ys, Fm::WX,
                                Fm::WY);
      if (e) return e;
    }
  }
  cudaError_t e = cudaFuncSetAttribute(
      copy_step_kernel<NT, STEPS, STACKED, ASYNC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  copy_step_kernel<NT, STEPS, STACKED, ASYNC>
      <<<dim3((p.Ys + T::TY - 1) / T::TY, (p.Xs + T::TX - 1) / T::TX),
         T::NTHREADS, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

template <bool STACKED, bool ASYNC>
int launch_form(Params& p, int n_tr, bool visc, int steps, cudaStream_t s) {
  if (steps == 2)
    return n_tr ? launch<1, 2, STACKED, ASYNC>(p, n_tr, visc, s)
                : launch<0, 2, STACKED, ASYNC>(p, n_tr, visc, s);
  return n_tr ? launch<1, 1, STACKED, ASYNC>(p, n_tr, visc, s)
              : launch<0, 1, STACKED, ASYNC>(p, n_tr, visc, s);
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

int copy_step_max_async_windows() { return MAX_ASYNC_WIN; }

// The window (rows, columns, floats a shared plane) of the form with
// n_tracers tracers (its window halo) and `steps` model steps a launch.
int copy_step_window(int n_tracers, int steps, int* out) {
  const auto put = [out](int wx, int wy, int plane) {
    out[0] = wx; out[1] = wy; out[2] = plane;
    return 0;
  };
  if (steps == 2)
    return n_tracers ? put(Form<1, 2>::WX, Form<1, 2>::WY, Form<1, 2>::PLANE)
                     : put(Form<0, 2>::WX, Form<0, 2>::WY, Form<0, 2>::PLANE);
  return n_tracers ? put(Form<1, 1>::WX, Form<1, 1>::WY, Form<1, 1>::PLANE)
                   : put(Form<0, 1>::WX, Form<0, 1>::WY, Form<0, 1>::PLANE);
}

const char* copy_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one copy step on `stream`; returns cudaGetLastError() (0 =
// launched). win / out: host arrays of n_win / n_out device pointers to
// (Xs, Ys) planes. met: n_met metric rows, (n_met, Xs, Ys) planes when
// met2d != 0, else (n_met, Ys) profiles; unread when n_met = 0. tile_wet:
// device array of one int per block, or null. n_tracers: the tracer count
// of the fused form whose window (halo 4 with tracers, else 3) and shared
// memory to take; visc_form: that of its viscous form. steps: 2 takes the
// chained form's tile, window and shared memory. async: the loader, 0 the
// threads', 1 TMA a tile a block; TMA takes at most
// copy_step_max_async_windows() windowed inputs, each 16-byte aligned,
// Ys a multiple of 4.
int copy_step_launch(const float* const* win, int n_win,
                     float* const* out, int n_out, const float* met,
                     int n_met, int met2d, const int* tile_wet,
                     int n_tracers, int visc_form, int steps, int Xs,
                     int Ys, int async, void* stream) {
  if (n_win < 0 || n_win > MAX_WIN || n_out < 1 || n_out > MAX_OUT
      || n_met < 0 || (n_met > 0 && met == nullptr) || n_tracers < 0
      || (steps != 1 && steps != 2))
    return (int)cudaErrorInvalidValue;
  Params p{{}, {}, nullptr, nullptr, met, tile_wet, n_win, n_out, n_met,
           met2d, 0, Xs, Ys, (size_t)Xs * Ys};
  for (int j = 0; j < n_win; ++j) p.win[j] = win[j];
  for (int o = 0; o < n_out; ++o) p.out[o] = out[o];
  cudaStream_t s = (cudaStream_t)stream;
  switch (async) {
    case 0: return launch_form<false, false>(p, n_tracers, visc_form != 0,
                                             steps, s);
    case 1: return launch_form<false, true>(p, n_tracers, visc_form != 0,
                                            steps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The stacked form: in, (n_win, Xs, Ys); out, (n_out, Xs, Ys); the other
// arguments as copy_step_launch's.
int copy_step_stacked_launch(const float* in, int n_win, float* out,
                             int n_out, const float* met, int n_met,
                             int met2d, const int* tile_wet, int n_tracers,
                             int visc_form, int steps, int Xs, int Ys,
                             void* stream) {
  if (n_win < 0 || n_out < 1 || n_met < 0 || (n_met > 0 && met == nullptr)
      || n_tracers < 0 || (steps != 1 && steps != 2))
    return (int)cudaErrorInvalidValue;
  Params p{{}, {}, in, out, met, tile_wet, n_win, n_out, n_met, met2d, 0,
           Xs, Ys, (size_t)Xs * Ys};
  return launch_form<true, false>(p, n_tracers, visc_form != 0, steps,
                                  (cudaStream_t)stream);
}

}  // extern "C"
