// Tile and window constants shared by the fused shallow-water step
// (fused_step.cu) and its copy-step roofline kernel (copy_step.cu): the
// copy step measures the fused step's own tiling, so both take their tile,
// thread count, window halo and shared-memory footprint from here.

#pragma once

#include <cuda_runtime.h>

// The chained form's tile (two model steps a launch), defaults below; a
// build may set them (-DFUSED_CHAIN_TX=... etc.) to sweep tiles.
#ifndef FUSED_CHAIN_TX
#define FUSED_CHAIN_TX 16
#endif
#ifndef FUSED_CHAIN_TY
#define FUSED_CHAIN_TY 32
#endif
#ifndef FUSED_CHAIN_THREADS
#define FUSED_CHAIN_THREADS 512
#endif
#ifndef FUSED_CHAIN_MIN_BLOCKS
#define FUSED_CHAIN_MIN_BLOCKS 2
#endif

namespace fused_tile {

// Tile of the single-step forms: 16 x 32 outputs, 512 threads, three
// blocks per SM. Swept on an H100 SXM (700 W) at the 1533 x 1152 layout,
// device us/launch. Without tracers: 16x32 with 512 threads 75.0; 16x16,
// 12x32 and 8x32 with 256 threads 76-78; 32x32 108; 32x64 172. With 2
// tracers: 16x32/512 122; 8x64/512 123; 12x32/512 126; 32x16/512 128;
// 16x64/512 129; 16x32/384 131; 32x32/512 133; 16x16/256 134; 8x32/256
// 137. Small tiles keep more blocks, and so more loads, in flight per SM;
// their halo re-reads hit L2. Three blocks of 512 threads fit an SM only
// at 42 registers or fewer: left to itself ptxas takes 44 (47-48 with
// tracers), two blocks fit, and the launch takes 95 us instead of 73 (164
// instead of 122); with MIN_BLOCKS = 3 it takes 39 and spills nothing.
constexpr int TX = 16;                 // output rows (x) per block
constexpr int TY = 32;                 // output columns (y) per block
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MIN_BLOCKS = 3;          // blocks per SM to keep registers for

// Tile of the chained forms (two model steps a launch, window halo 6, or
// 8 with tracers): 16 x 32 outputs, 512 threads, launch bound two blocks
// per SM (64 registers; ptxas takes 40-60). The shared memory of a block
// (20 + 2 T planes of the window, plus the four stress planes of a
// viscous form) decides how many blocks an SM holds: 96 KB at T = 0 (two
// blocks), 144 KB at T = 2 (one). Swept with
// scripts/chain_tile_sweep_torch.py on an H100 SXM (700 W) at the 1533 x
// 1152 layout, device us per launch of two steps (one step a launch in
// the same run: 48.9 on the guarded Azov coastline, 78.7 with 2 tracers,
// 76.7 on the unguarded frame). Coastline T = 0: 16x32/512 91.9;
// 32x16/512 93.7; 16x16/256 112.4; 32x32/512 116.4; 8x32/256 122.2.
// Coastline T = 2: 32x32/512 193.7; 32x16/512 248.9; 16x32/512 249.9;
// 16x16/256 254.4; 8x32/256 273.9. Frame T = 0: 16x32/512 161.8;
// 32x16/512 170.2; 32x32/512 206.7; 16x16/256 212.0; 8x32/256 222.0.
// Launch bound 1 instead of 2 moves nothing (52 registers instead of 55,
// within 0.7 %). One tile for every chained form: 16 x 32 is the best at
// T = 0; at T = 2 32 x 32 would be 22 % faster, and both lose to one step
// a launch there.
constexpr int CHAIN_TX = FUSED_CHAIN_TX;
constexpr int CHAIN_TY = FUSED_CHAIN_TY;
constexpr int CHAIN_THREADS = FUSED_CHAIN_THREADS;
constexpr int CHAIN_MIN_BLOCKS = FUSED_CHAIN_MIN_BLOCKS;

// Tracers: NT = 0, 1, 2 are instantiations of their own; TLOOP stands
// for a count known at run time, from MAX_TRACERS + 1 up, whose tracer
// pass runs in groups of MAX_TRACERS through the same flux planes.
constexpr int MAX_TRACERS = 2;
constexpr int TLOOP = -1;
constexpr int N_SMEM_PLANES = 16;      // shared-memory windows of a block
constexpr int N_CHAIN_PLANES = 4;      // step A's ssh, sshp, up, vp (chain)
constexpr int N_VISC_PLANES = 4;       // stress products of the viscous forms

// The launch shape of the forms that run STEPS model steps a launch.
template <int STEPS>
struct Tile {
  static constexpr int TX = STEPS == 1 ? fused_tile::TX : CHAIN_TX;
  static constexpr int TY = STEPS == 1 ? fused_tile::TY : CHAIN_TY;
  static constexpr int NTHREADS =
      STEPS == 1 ? fused_tile::NTHREADS : CHAIN_THREADS;
  static constexpr int MIN_BLOCKS =
      STEPS == 1 ? fused_tile::MIN_BLOCKS : CHAIN_MIN_BLOCKS;
};

// The window of the form with NT tracers and STEPS chained steps, whose
// body loads it by TMA (the loader: fused_step.cu's head) or by its
// threads (the viscous fast forms on metric planes, the general forms
// GenPlan leaves there, the copy step's threads).
template <int NT, int STEPS = 1, bool TMA = true>
struct Form {
  static constexpr int EXTRA = NT ? 1 : 0;        // reach of the tracer pass
  static constexpr int HALO = 3 + EXTRA;          // stencil reach of one step
  static constexpr int WH = STEPS * HALO;         // window halo
  static constexpr int TX = Tile<STEPS>::TX;
  static constexpr int TY = Tile<STEPS>::TY;
  static constexpr int WX = TX + 2 * WH;          // window rows
  // A TMA box (tma.cuh) begins on a column that is a multiple of 4 (16
  // bytes) and its rows are multiples of 16 bytes: the loader's box
  // begins R columns before the window (a tile's first column is a
  // multiple of 4), and the window's columns are rounded up to 4 with
  // them: the one-step window of 38 columns takes 40 (R = 1), the chained
  // one of 44 takes 48 (R = 2). With tracers (halo 4, 8) nothing changes.
  // The loads of threads keep the window as it is: the larger planes of
  // the one-step window would push three blocks of the viscous forms past
  // the 196 KB shared-memory carveout, which halves L1 (PERF.md).
  static constexpr int R = TMA ? (4 - WH % 4) % 4 : 0;
  static constexpr int WY =                       // window columns
      TMA ? (TY + 2 * WH + R + 3) / 4 * 4 : TY + 2 * WH;
  static constexpr int CELLS = WX * WY;           // floats of a window
  // floats per shared array: a window (and its R columns, rounded up to
  // 128 bytes, where a TMA box lands)
  static constexpr int PLANE = TMA ? (CELLS + R + 31) / 32 * 32 : CELLS;
  // the 16 working planes; a chained form adds step A's carried outputs
  // that do not stay in place: ssh, sshp, up, vp (N_BASE planes so far)
  // and each tracer's 2, which TLOOP sizes at run time
  // (chain_levels_in_smem)
  static constexpr int N_BASE =
      N_SMEM_PLANES + (STEPS > 1 ? N_CHAIN_PLANES : 0);
  static constexpr int N_PLANES =
      N_BASE + (STEPS > 1 && NT > 0 ? 2 * NT : 0);
  // The viscous forms keep their four stress products on the region one
  // cell inside the flux stage's (halo 1 + EXTRA beyond a step's output
  // region), row-major, no wider: with full windows the 2-tracer form
  // would pass the 75 KB that let three blocks share an SM. Sized for the
  // first step's, the widest, region.
  static constexpr int VH = 1 + EXTRA;
  static constexpr int VHW = (STEPS - 1) * HALO + VH;
  static constexpr int VW = TY + 2 * VHW;         // columns of that region
  static constexpr int VPLANE = (TX + 2 * VHW) * VW;
};

// Dynamic shared memory of a block's working planes. One step: 57.3 KB
// (61.4 KB with tracers, at any count), and 67.1 KB (73.0 KB) for a
// viscous form. A chained TLOOP form adds the levels chain_levels_in_smem
// keeps; the fast form adds the planes of its Plan.
template <int NT, int STEPS = 1, bool TMA = true>
constexpr size_t smem_bytes(bool visc = false) {
  using Fm = Form<NT, STEPS, TMA>;
  return sizeof(float) * (Fm::N_PLANES * Fm::PLANE
                          + (visc ? N_VISC_PLANES * Fm::VPLANE : 0));
}

// What a block may take so that `blocks` of them share an SM of the H100
// (228 KB an SM, 1 KB of it reserved a block, 227 KB at most a block),
// less its static arrays (the block max's and the TMA barriers) and the
// 128 bytes by which the fast form aligns its planes.
constexpr size_t SM_SMEM = 233472, BLOCK_RESERVED = 1024, STATIC_SMEM = 256;
constexpr size_t smem_budget(int blocks) {
  return SM_SMEM / blocks - BLOCK_RESERVED - STATIC_SMEM;
}

// Where the fast body's TMA boxes land (fused_step.cu's head: "the
// loader"). Each windowed input of the first step of a launch is one box
// of the whole window; stage 0's fields land in their working planes,
// step A's previous levels of a chained launch in the planes step B reads
// them from (E_SSHP, E_UP, E_VP, the tracers' E_TR), and the rest in
// planes of their own, as many as the blocks the form's working planes
// leave on an SM still hold, in this order: rslu_u and rslu_v; sshp (one
// step); up and vp (one step); rslu_h; the tracer levels (one step, a
// fixed count). An input without a plane of its own lands in the working
// plane its first stage writes at the same cell (rslu_u, rslu_v -> S_HU,
// S_HV; sshp -> S_AQP; hrludxdy -> S_AQ; a viscous form's up, vp -> S_F,
// S_K; rslu_h -> S_CX), where that stage reads it; later stages read it
// from device memory. The bathymetry planes hrludxdy and hr get no plane
// of their own: with one, 16 one-step forms and the chained viscous ones
// left the threads' bits by an ulp (a contraction; PERF.md). A
// chained TLOOP form keeps its room for step A's tracer levels.
// ON = false (a body that loads by threads): no TMA, no planes.
template <int NT, int STEPS, bool VISC, bool HRP, bool FFS, bool ON = true>
struct Plan {
  using Fm = Form<NT, STEPS, ON>;
  static constexpr bool CHAIN = STEPS > 1;
  static constexpr size_t BASE = smem_bytes<NT, STEPS, ON>(VISC);
  static constexpr size_t PBYTES = sizeof(float) * Fm::PLANE;
  static constexpr int FITS = (int)(SM_SMEM
      / (BASE + BLOCK_RESERVED + STATIC_SMEM));
  static constexpr int BLOCKS =
      FITS < Tile<STEPS>::MIN_BLOCKS ? (FITS < 1 ? 1 : FITS)
                                     : Tile<STEPS>::MIN_BLOCKS;
  static constexpr int ROOM = !ON || (NT < 0 && CHAIN)
      || smem_budget(BLOCKS) < BASE
      ? 0 : (int)((smem_budget(BLOCKS) - BASE) / PBYTES);
  static constexpr bool RUV = ROOM >= 2;
  static constexpr int R1 = ROOM - 2 * RUV;
  static constexpr bool SSHP = !CHAIN && R1 >= 1;
  static constexpr int R2 = R1 - SSHP;
  static constexpr bool UVP = !CHAIN && R2 >= 2;
  static constexpr int R3 = R2 - 2 * UVP;
  static constexpr bool RH = R3 >= 1;
  static constexpr int R4 = R3 - RH;
  static constexpr bool TR = !CHAIN && NT > 0 && R4 >= 2 * NT;
  static constexpr int N_EXTRA = ROOM - R4 + (TR ? 2 * NT : 0);
  // the planes of their own, after the working planes
  static constexpr int P_RU = Fm::N_PLANES, P_RV = P_RU + 1;
  static constexpr int P_SSHP = P_RU + 2 * RUV;
  static constexpr int P_UP = P_SSHP + SSHP, P_VP = P_UP + 1;
  static constexpr int P_RH = P_UP + 2 * UVP;
  static constexpr int P_TR = P_RH + RH;
  static_assert(P_TR + (TR ? 2 * NT : 0) == Fm::N_PLANES + N_EXTRA,
                "the planes of their own");
  // dynamic shared memory of a block (a chained TLOOP form's tracer
  // levels on top), with the 128 bytes of the planes' alignment
  static constexpr size_t SMEM = BASE + N_EXTRA * PBYTES + (ON ? 128 : 0);
};

// The shared-memory carveouts an H100 SM offers (KB of its 256 KB of L1
// and shared memory; the rest is L1), and the smallest that holds `bytes`
// (-1: none). The driver takes the smallest that keeps a kernel's blocks,
// so a block's shared memory decides its L1: three blocks past 196 KB
// leave 28 KB of L1, not 60.
constexpr int N_CARVEOUTS = 10;
constexpr int CARVEOUT_KB[N_CARVEOUTS] = {0, 8, 16, 32, 64, 100, 132, 164,
                                          196, 228};
constexpr int carveout_kb(size_t bytes) {
  for (int i = 0; i < N_CARVEOUTS; ++i)
    if (bytes <= (size_t)CARVEOUT_KB[i] * 1024) return CARVEOUT_KB[i];
  return -1;
}

// The carveout as cudaFuncAttributePreferredSharedMemoryCarveout takes it,
// percent of the largest, rounded down: the driver rounds it up to the
// step.
constexpr int carveout_percent(int kb) {
  return kb * 100 / CARVEOUT_KB[N_CARVEOUTS - 1];
}

// The static shared memory the general body's kernels are budgeted for
// (the block max's warps, the TMA barriers and, in the persistent walk,
// its position and fields; fused_step.cu asserts it).
constexpr size_t GEN_STATIC = 384;

// How the general body (fused_step.cu's sw_step_gen) loads its window and
// where its boxes land. The budget is the carveout its threads' twin sits
// in, not the SM: that body reads up to a dozen metric values a cell from
// device memory (16 whole planes on metric planes), which L1 serves, so a
// form moves to TMA only if its blocks an SM keep that carveout with the
// wider window (ON). Without tracers it has no use for S_AQP (the
// tracers' post-step column), so its TMA form keeps 15 working planes,
// which is what lets the one-step form without tracers keep 164 KB. Its
// boxes: ssh, u, v, lu into their stage-0 planes, hr into a plane of its
// own where the carveout leaves one (HR; stages 0, 2, 3 and the tracers'
// read it there), else into S_AQ, which stage 0 writes at the same cell; a
// viscous form's up, vp into S_F, S_K, which stage 1 writes at the same
// cell. The rest, and every later read of an input without a plane, stay
// device loads. A chained form without tracers keeps the threads' loader:
// its 48-column window takes its two blocks past 196 KB. So does a chained
// TLOOP form, one block an SM whose tracer levels decide its shared memory
// at run time (its launcher takes that carveout; CARVE is the most it
// needs): with the carveout fixed at 228 KB it ran 2-7 % slower than its
// parent on either loader (PERF.md), and TMA with the right carveout is
// not measured yet.
template <int NT, int STEPS, bool VISC>
struct GenPlan {
  using Th = Form<NT, STEPS, false>;
  using Fm = Form<NT, STEPS, true>;
  static constexpr bool LOOP_CHAIN = NT < 0 && STEPS > 1;
  static constexpr size_t VBYTES =
      VISC ? sizeof(float) * N_VISC_PLANES * Fm::VPLANE : 0;
  // the threads' twin: its blocks an SM and their carveout
  static constexpr size_t TH_BASE = smem_bytes<NT, STEPS, false>(VISC);
  static constexpr size_t TH_BLOCK = TH_BASE + GEN_STATIC + BLOCK_RESERVED;
  static constexpr int TH_FITS = (int)(SM_SMEM / TH_BLOCK);
  static constexpr int BLOCKS = LOOP_CHAIN ? 1
      : TH_FITS < Tile<STEPS>::MIN_BLOCKS ? (TH_FITS < 1 ? 1 : TH_FITS)
                                          : Tile<STEPS>::MIN_BLOCKS;
  static constexpr int TH_CARVE = LOOP_CHAIN
      ? CARVEOUT_KB[N_CARVEOUTS - 1] : carveout_kb(BLOCKS * TH_BLOCK);
  // by TMA: the working planes, the planes' alignment
  static constexpr int N_WORK = Fm::N_PLANES - (NT == 0 ? 1 : 0);
  static constexpr size_t PBYTES = sizeof(float) * Fm::PLANE;
  static constexpr size_t BASE = N_WORK * PBYTES + VBYTES + 128;
  static constexpr size_t LIMIT = (size_t)TH_CARVE * 1024;
  static constexpr bool ON = !LOOP_CHAIN
      && BLOCKS * (BASE + GEN_STATIC + BLOCK_RESERVED) <= LIMIT;
  static constexpr bool HR = ON
      && BLOCKS * (BASE + PBYTES + GEN_STATIC + BLOCK_RESERVED) <= LIMIT;
  // hr's plane, after the working planes; the stress planes follow it
  static constexpr int P_HR = N_WORK;
  static constexpr int N_WIN = ON ? N_WORK + HR : Th::N_PLANES;
  // dynamic shared memory of a block (a chained TLOOP form's tracer levels
  // on top) and the carveout its blocks take (a chained TLOOP form's: the
  // most; its launcher takes the step of its levels)
  static constexpr size_t SMEM = ON ? BASE + HR * PBYTES : TH_BASE;
  static constexpr int CARVE = LOOP_CHAIN ? TH_CARVE
      : carveout_kb(BLOCKS * (SMEM + GEN_STATIC + BLOCK_RESERVED));
  static constexpr int BOXES = ON ? 5 + 2 * VISC : 0;
  static_assert(!ON || CARVE <= TH_CARVE, "the threads' twin's carveout");
};

// The dynamic shared memory a block may take on the current device: the
// opt-in maximum (227 KB on an H100) less the static arrays and the
// planes' alignment (STATIC_SMEM).
inline size_t smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return (size_t)bytes - STATIC_SMEM;
}

// How many of step A's 2 n_tr tracer levels a chained TLOOP block keeps
// in shared memory (whole planes of its window, after the N_BASE planes
// and a viscous form's stress planes); the levels beyond them go to a
// device-memory scratch of the block's own. A window plane is 6 KB at the
// chained tile, the N_BASE planes 120 KB and the stress planes 19.25 KB,
// so every level fits up to 8 tracers, 7 viscous, at 227 KB.
inline int chain_levels_in_smem(int n_tr, bool visc, size_t limit) {
  static_assert(Form<TLOOP, 2>::PLANE == Form<TLOOP, 2, false>::PLANE,
                "the run-time tracer family's window is the loaders' both");
  const size_t fixed = smem_bytes<TLOOP, 2>(visc);
  const size_t plane = sizeof(float) * Form<TLOOP, 2>::PLANE;
  const size_t fit = limit > fixed ? (limit - fixed) / plane : 0;
  return (int)(fit < (size_t)(2 * n_tr) ? fit : (size_t)(2 * n_tr));
}

// The dynamic shared memory of a block's working planes of the fused
// step's form with n_tr tracers (viscous or not) that runs STEPS model
// steps a launch and loads by TMA or by threads, on the current device;
// *levels: how many of step A's 2 n_tr tracer levels a chained block keeps
// there (0 for one step a launch).
template <int STEPS, bool TMA = true>
inline size_t form_smem_bytes(int n_tr, bool visc, int* levels) {
  *levels = STEPS == 1 ? 0 : 2 * n_tr;
  if (STEPS == 1)
    return n_tr ? smem_bytes<1, 1, TMA>(visc) : smem_bytes<0, 1, TMA>(visc);
  switch (n_tr) {
    case 0: return smem_bytes<0, STEPS, TMA>(visc);
    case 1: return smem_bytes<1, STEPS, TMA>(visc);
    case 2: return smem_bytes<2, STEPS, TMA>(visc);
    default:
      *levels = chain_levels_in_smem(n_tr, visc, smem_limit());
      return smem_bytes<TLOOP, STEPS>(visc)
          + sizeof(float) * Form<TLOOP, STEPS>::PLANE * *levels;
  }
}

}  // namespace fused_tile
