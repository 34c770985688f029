// Tile and window constants shared by the fused shallow-water step
// (fused_step.cu) and its copy-step roofline kernel (copy_step.cu): the
// copy step measures the fused step's own tiling, so both take their tile,
// thread count, window halo and shared-memory footprint from here.

#pragma once

#include <cuda_runtime.h>

// A build may set one tile for every chained form, fast or general
// (-DFUSED_CHAIN_TX= ... -DFUSED_CHAIN_TY, _THREADS, _MIN_BLOCKS): the tile
// sweep's libraries. -DFUSED_CHAIN_GEN_TMA=0 or 1 keeps the chained general
// forms without tracers on the threads' loader or moves them to TMA,
// whatever GenPlan's rule says: the loader sweep's libraries.

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

// The chained forms' tiles (two model steps a launch, window halo 6, or 8
// with tracers), the fast body's and the general one's alike. A chained
// block holds 20 + 2 T planes of its window (plus the four stress planes
// of a viscous form), so its shared memory decides how many blocks an SM
// holds. Swept with scripts/chain_tile_sweep_torch.py --folds 7 (--general)
// on the loader and this body (an H100 SXM at 700 W, the 1533 x 1152
// layout, device us a launch of two steps; PERF.md section 6):
// - CHAIN_SHAPE, 16 x 32 outputs, 512 threads, launch bound two blocks an
//   SM (64 registers): the forms without tracers (108 KB, two blocks).
//   The guarded coastline: 16x32/512 77.25, 32x32/512 80.29, 32x32/1024
//   82.56, 32x24/768 87.26, 24x32/768 87.76; the frame 137.20, 143.22,
//   146.38, 161.68, 157.88. Two blocks an SM hide each other's barriers; a
//   larger tile's cheaper ring does not pay for them. The general form on
//   the coastline (--general, by TMA): 102.21, 32x32/1024 111.92,
//   32x24/768 121.58.
// - CHAIN_TR_SHAPE, 32 x 32 outputs, 1024 threads, one block an SM (64
//   registers): the forms with tracers. Their planes leave one block an
//   SM whatever the tile (216 KB at T = 2), so the larger tile costs no
//   blocks; it computes step A's ring for 1024 outputs, not 512 (17 %
//   fewer cells a stage for each output at T = 2), and its 32 warps fill
//   the SM the 16 of a 16 x 32 block left idle at every barrier. T = 2:
//   32x32/1024 131.48, 32x32/512 132.92, 24x32/768 135.94, 32x24/768
//   137.10, 16x32/512 157.43; T = 4: 232.96, 282.68, 254.98, 247.29,
//   325.71. The general forms: T = 1 32x32/1024 166.84, 32x24/768 177.17,
//   16x32/512 232.96; T = 2 180.79, 193.71, 254.87; T = 4 289.12, 302.38,
//   411.22.
// - CHAIN_TRV_SHAPE, 32 x 24 outputs, 768 threads, one block an SM (85
//   registers): the viscous forms with tracers, whose stress planes a 32 x
//   32 block cannot hold in 227 KB. T = 2 over bathymetry planes at mu =
//   1000: 32x24/768 200.66, 24x32/768 206.42, 16x32/512 235.50; the
//   general form 32x24/768 227.30, 16x32/512 288.67.
struct Shape {
  int tx, ty;       // output rows (x) and columns (y) of a block
  int threads;
  int blocks;       // blocks an SM the launch bound keeps registers for
};
constexpr Shape ONE_SHAPE{TX, TY, NTHREADS, MIN_BLOCKS};
constexpr Shape CHAIN_SHAPE{16, 32, 512, 2};
constexpr Shape CHAIN_TR_SHAPE{32, 32, 1024, 1};
constexpr Shape CHAIN_TRV_SHAPE{32, 24, 768, 1};

// The tile of a form that runs STEPS model steps a launch with NT
// tracers, viscous or not, of the fast body (FAST) or the general one.
template <int STEPS, int NT, bool VISC, bool FAST>
constexpr Shape shape_of() {
#ifdef FUSED_CHAIN_TX
  if (STEPS > 1)
    return Shape{FUSED_CHAIN_TX, FUSED_CHAIN_TY, FUSED_CHAIN_THREADS,
                 FUSED_CHAIN_MIN_BLOCKS};
#endif
  return STEPS == 1 ? ONE_SHAPE
      : NT == 0 ? CHAIN_SHAPE
      : VISC ? CHAIN_TRV_SHAPE : CHAIN_TR_SHAPE;
}

// Tracers: NT = 0, 1, 2 are instantiations of their own; TLOOP stands
// for a count known at run time, from MAX_TRACERS + 1 up, whose tracer
// pass runs in groups of MAX_TRACERS through the same flux planes.
constexpr int MAX_TRACERS = 2;
constexpr int TLOOP = -1;
constexpr int N_SMEM_PLANES = 16;      // shared-memory windows of a block
constexpr int N_CHAIN_PLANES = 4;      // step A's ssh, sshp, up, vp (chain)
constexpr int N_VISC_PLANES = 4;       // stress products of the viscous forms

// The launch shape of a form (shape_of): the general forms' and the
// copy step's by default.
template <int STEPS, int NT = 0, bool VISC = false, bool FAST = false>
struct Tile {
  static constexpr Shape S = shape_of<STEPS, NT, VISC, FAST>();
  static constexpr int TX = S.tx, TY = S.ty;
  static constexpr int NTHREADS = S.threads, MIN_BLOCKS = S.blocks;
};

// The window of the form with NT tracers and STEPS chained steps, whose
// body loads it by TMA (the loader: fused_step.cu's head) or by its
// threads (the viscous fast forms on metric planes, the general forms
// GenPlan leaves there, the copy step's threads).
template <int NT, int STEPS = 1, bool TMA = true, bool VISC = false,
          bool FAST = false>
struct Form {
  static constexpr int EXTRA = NT ? 1 : 0;        // reach of the tracer pass
  static constexpr int HALO = 3 + EXTRA;          // stencil reach of one step
  static constexpr int WH = STEPS * HALO;         // window halo
  static constexpr int TX = Tile<STEPS, NT, VISC, FAST>::TX;
  static constexpr int TY = Tile<STEPS, NT, VISC, FAST>::TY;
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
template <int NT, int STEPS = 1, bool TMA = true, bool VISC = false,
          bool FAST = false>
constexpr size_t smem_bytes() {
  using Fm = Form<NT, STEPS, TMA, VISC, FAST>;
  return sizeof(float) * (Fm::N_PLANES * Fm::PLANE
                          + (VISC ? N_VISC_PLANES * Fm::VPLANE : 0));
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
  using Fm = Form<NT, STEPS, ON, VISC, true>;
  using T = Tile<STEPS, NT, VISC, true>;
  static constexpr bool CHAIN = STEPS > 1;
  static constexpr size_t BASE = smem_bytes<NT, STEPS, ON, VISC, true>();
  static constexpr size_t PBYTES = sizeof(float) * Fm::PLANE;
  static constexpr int FITS = (int)(SM_SMEM
      / (BASE + BLOCK_RESERVED + STATIC_SMEM));
  static constexpr int BLOCKS =
      FITS < T::MIN_BLOCKS ? (FITS < 1 ? 1 : FITS) : T::MIN_BLOCKS;
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
// where its boxes land. One step a launch, its budget is the carveout its
// threads' twin sits in, not the SM: that body reads up to a dozen metric
// values a cell from device memory (16 whole planes on metric planes),
// which L1 serves, so a one-step form moves to TMA only if its blocks an
// SM keep that carveout with the wider window (ON). A chained form on
// profile metrics walks each stage a column a thread and holds the
// metric rows for the column (fused_step.cu's walk), so L1 serves few of
// them: its budget is the SM (228 KB, 28 KB of L1), and it loads by TMA
// wherever its blocks fit (the viscous form without tracers does not:
// threads). On metric planes (MET2D) the 16 plane reads a cell still go
// through L1, and a chained form keeps its twin's carveout as a one-step
// form does: the form without tracers stays on threads (by TMA at 228 KB
// it ran 1.074 of its time on threads, against 0.964 on profile metrics;
// PERF.md section 6), the forms with tracers, one block an SM at 228 KB
// either way, move. The run-time tracer family takes the carveout of its
// tracer levels, which its launcher sets (CARVE is the most it needs).
// Without tracers the body has no use for S_AQP (the tracers' post-step
// column), so its TMA form keeps 15 working planes, which is what lets the
// one-step form without tracers keep 164 KB. Its boxes: ssh, u, v, lu into
// their stage-0 planes, hr into a plane of its own where the budget leaves
// one (HR; every later read of hr is there), else into S_AQ, which stage 0
// writes at the same cell (and so always for the run-time tracer family,
// whose levels follow its working planes); a viscous form's up, vp into
// S_F, S_K, which stage 1 writes at the same cell. The rest stay device
// loads. -DFUSED_CHAIN_GEN_TMA=0 (1) puts the chained forms without
// tracers on the threads' loader (on TMA, at the SM's budget, where their
// blocks fit) whatever the rule: the loader sweep's libraries.
template <int NT, int STEPS, bool VISC, bool MET2D = false>
struct GenPlan {
  using Th = Form<NT, STEPS, false, VISC>;
  using Fm = Form<NT, STEPS, true, VISC>;
  using T = Tile<STEPS, NT, VISC>;
  static constexpr bool CHAIN = STEPS > 1;
  static constexpr bool LOOP_CHAIN = NT < 0 && CHAIN;
  static constexpr size_t VBYTES =
      VISC ? sizeof(float) * N_VISC_PLANES * Fm::VPLANE : 0;
  // the threads' twin: its blocks an SM and their carveout
  static constexpr size_t TH_BASE = smem_bytes<NT, STEPS, false, VISC>();
  static constexpr size_t TH_BLOCK = TH_BASE + GEN_STATIC + BLOCK_RESERVED;
  static constexpr int TH_FITS = (int)(SM_SMEM / TH_BLOCK);
  static constexpr int BLOCKS = LOOP_CHAIN ? 1
      : TH_FITS < T::MIN_BLOCKS ? (TH_FITS < 1 ? 1 : TH_FITS)
                                : T::MIN_BLOCKS;
  static constexpr int TH_CARVE = LOOP_CHAIN
      ? CARVEOUT_KB[N_CARVEOUTS - 1] : carveout_kb(BLOCKS * TH_BLOCK);
  // by TMA: the working planes, the planes' alignment
  static constexpr int N_WORK = Fm::N_PLANES - (NT == 0 ? 1 : 0);
  static constexpr size_t PBYTES = sizeof(float) * Fm::PLANE;
  static constexpr size_t BASE = N_WORK * PBYTES + VBYTES + 128;
#ifdef FUSED_CHAIN_GEN_TMA
  static constexpr bool SM_BUDGET = CHAIN && (NT == 0 || !MET2D);
#else
  static constexpr bool SM_BUDGET = CHAIN && !MET2D;
#endif
  static constexpr size_t LIMIT =
      (size_t)(SM_BUDGET ? CARVEOUT_KB[N_CARVEOUTS - 1] : TH_CARVE) * 1024;
  static constexpr bool FITS =
      BLOCKS * (BASE + GEN_STATIC + BLOCK_RESERVED) <= LIMIT;
#ifdef FUSED_CHAIN_GEN_TMA
  static constexpr bool ON = CHAIN && NT == 0 ? FUSED_CHAIN_GEN_TMA && FITS
                                              : FITS;
#else
  static constexpr bool ON = FITS;
#endif
  static constexpr bool HR = ON && !LOOP_CHAIN
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
  static_assert(!ON || (size_t)CARVE * 1024 <= LIMIT, "the budget's carveout");
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
// device-memory scratch of the block's own. The fast and the general
// forms share the tile: 9 KB a plane at 32 x 32, N_BASE 180 KB, so 5
// levels (T = 4 keeps 5 of 8); viscous 7.5 KB at 32 x 24, N_BASE 150 KB
// and stress 24.75 KB, so 6 levels (T = 3 keeps all). `limit`: what the
// levels and the rest may take (smem_limit(); the general body's larger
// static arrays and its planes' alignment come off it: form_smem_bytes).
template <bool VISC, bool FAST>
inline int chain_levels_in_smem(int n_tr, size_t limit) {
  using Fm = Form<TLOOP, 2, true, VISC, FAST>;
  static_assert(Fm::PLANE == Form<TLOOP, 2, false, VISC, FAST>::PLANE,
                "the run-time tracer family's window is the loaders' both");
  const size_t fixed = smem_bytes<TLOOP, 2, true, VISC, FAST>();
  const size_t plane = sizeof(float) * Fm::PLANE;
  const size_t fit = limit > fixed ? (limit - fixed) / plane : 0;
  return (int)(fit < (size_t)(2 * n_tr) ? fit : (size_t)(2 * n_tr));
}

// The dynamic shared memory of a block's working planes of the fused
// step's form with n_tr tracers (viscous or not) that runs STEPS model
// steps a launch, of the fast body (FAST) or the general one, and loads
// by TMA or by threads, on the current device; *levels: how many of step
// A's 2 n_tr tracer levels a chained block keeps there (0 for one step a
// launch).
template <int STEPS, bool TMA, bool VISC, bool FAST>
inline size_t form_smem_bytes(int n_tr, int* levels) {
  *levels = STEPS == 1 ? 0 : 2 * n_tr;
  switch (n_tr) {
    case 0: return smem_bytes<0, STEPS, TMA, VISC, FAST>();
    case 1: return smem_bytes<1, STEPS, TMA, VISC, FAST>();
    case 2: return smem_bytes<2, STEPS, TMA, VISC, FAST>();
    default:
      if (STEPS == 1) return smem_bytes<1, 1, TMA, VISC, FAST>();
      *levels = chain_levels_in_smem<VISC, FAST>(
          n_tr, smem_limit() - (FAST ? 0 : GEN_STATIC + 128 - STATIC_SMEM));
      return smem_bytes<TLOOP, STEPS, TMA, VISC, FAST>()
          + sizeof(float) * Form<TLOOP, STEPS, TMA, VISC, FAST>::PLANE
          * *levels;
  }
}

template <int STEPS, bool TMA = true, bool FAST = false>
inline size_t form_smem_bytes(int n_tr, bool visc, int* levels) {
  return visc ? form_smem_bytes<STEPS, TMA, true, FAST>(n_tr, levels)
              : form_smem_bytes<STEPS, TMA, false, FAST>(n_tr, levels);
}

}  // namespace fused_tile
