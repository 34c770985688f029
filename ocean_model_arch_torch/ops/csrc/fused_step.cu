// Fused shallow-water step for Hopper (sm_90a): one launch advances the
// 6 carried fields (ssh, sshp, u, up, v, vp) and the 2 carried levels
// (ff, ffp) of each of T passive tracers by one whole model step.
//
// Replaces: ocean_model_arch_tpu/ops/pallas/fused_step.py::
//   build_fused_sw_step -> _make_kernel (pallas_call at :1642), fast
//   branch, full free surface, momentum advection, with x-uniform
//   latitude-profile metrics or, for curvilinear (bipolar) grids, its
//   fast2d form with pointwise metric planes (`metrics_2d, fast2d,
//   met_map`, MT :351-354); its lateral viscosity (:711-743: stress
//   components + uv_diff2 with a constant mu); its tracer pass (:937-1039)
//   with the diffusive fluxes of a non-zero mu (:967-998); flat bathymetry
//   folded into a scalar or varying bathymetry on the hrludxdy and hr
//   planes (aq_of :459-470, :731, :947-951, :1016); and its land-tile
//   guard (`guarded` :1106-1131, scalar-prefetch call :1630); and its raw /
//   sharded form `step_raw` (:1652-1673: `guard_y_margin`, `alias_io`), the
//   step on one shard's margined block whose margins hold the neighbouring
//   shards' wet cells. Its forms without momentum advection (`trans`
//   = 0: the Coriolis pair cpair_x / cpair_y alone, :580, :798-834) and
//   with a linear free surface (`ffs` = 0: every depth column the static
//   rest depth, :465-470, :731, :764, :945-954, :1015-1019). And its
//   chained form, `steps_per_call` = 2 (:1061-1084): two whole model steps
//   a launch, the first one's state kept in fast memory.
//   Plain PyTorch version: ops/fused_step.py::fused_sw_step_reference,
//   which evaluates the same formulas in the same order.
//
// One kernel template, fused_sw_step_kernel<NT, GUARD, MET2D, MU, HRP,
// RAW, TRANS, FFS, STEPS, GEN> (GEN: the general form, below),
// instantiated for NT = 0, 1, 2 tracers and NT = TLOOP, any count from 3
// up known at run time, with and without the guard, with
// profile or plane metrics, MU = 0 (mu = 0), 1 (the tracers' diffusive
// fluxes only: mu != 0 with the viscosity switched off) or 2 (viscosity,
// and the diffusive fluxes when there are tracers), with the rest
// bathymetry as a scalar or on planes, with or without the momentum
// advection (TRANS), with a full or a linear free surface (FFS), and one
// or two model steps a launch (STEPS).
// <0, false, false, 0, false, false, true, true, 1> is the form without
// tracers, guard or viscosity on profile metrics: 4 stages, 16
// shared-memory planes of a (TX+6) x (TY+6) window. Every addition of the
// other forms sits behind a compile-time flag, so this form's code does
// not depend on them.
//
// What bounds it: memory. Per layout cell and step the SW part must read
// 10 f32 planes (6 fields + rslu_u, rslu_v, rslu_h, ludxdy) and write 6,
// 64 bytes, against roughly 100 flops (two divisions among them); each
// tracer adds 2 planes read and 2 written, 16 bytes, and about 25 flops.
// So the tracer form moves 64 + 16 T bytes per cell (on the 1533 x 1152
// layout of the Azov 250 m basin: 141 MB at T = 1, 170 MB at T = 2; 42 us
// and 51 us at the H100's 3.35 TB/s HBM), far above the compute time.
// The guarded form moves those bytes for the cells of wet tiles only,
// plus (6 + 2 T) * 4 bytes of zero writes per cell of an all-land tile
// (24 bytes at T = 0). The plane-metric forms read 7 more f32 planes (9
// with tracers): 92 bytes per cell at T = 0, 132 at T = 2. Viscosity
// adds arithmetic (about 60 flops) and, on profile metrics, no bytes; on
// plane metrics it reads 10 more metric planes (17 in all: 132 bytes per
// cell at T = 0). Varying bathymetry reads the hrludxdy plane (4 bytes)
// and, with viscosity or tracers, the hr plane (4 more).
//
// What the design does about it: every intermediate of the step (the
// weighted depth column aq, the depths hu/hv/hh and hup/hvp, the mass
// fluxes, sshn, the vorticity, the edge fluxes F/G/K/L and the merged
// vorticity+Coriolis products, un/vn, the post-step depths and
// transports, the tracer edge fluxes) lives in shared memory or
// registers and never touches device memory, so the kernel moves only
// the bytes above plus the tile halos, which neighbouring blocks re-read
// mostly from L2. A block owns a TX x TY tile of outputs and loads a
// (TX+2H) x (TY+2H) window; each stage then runs on a region whose halo
// shrinks by one cell per stencil level, with __syncthreads() between
// stages. Without tracers the reach is H = 3 (3 -> 2 -> 1 -> 0). The
// tracer pass needs sshn two cells and un/vn one cell beyond the tile
// (post-step depths and transports at the tile's edge fluxes), which
// pushes every earlier stage one cell out: H = 4 (4 -> 3 -> 2 -> 2/1/0
// -> 1 -> 0), six stages, and the same 16 planes -- the tracer stages
// reuse planes whose contents are dead by then. y, the contiguous axis,
// runs along threadIdx so each warp reads consecutive addresses. Cells
// outside the array read as 0 (land); the layout's 4-cell land margin
// keeps every read of an interior cell inside the array.
//
// Viscosity keeps the reach. Stage 1 also forms the four products up/dyh,
// vp/dxh, up/dxt, vp/dyt at halo 2 (up, vp read from device memory there),
// in the four planes the flux stage has not written yet; one more stage,
// between stages 1 and 2, turns them into the tension at T points and the
// shear at H points and stores the four stress products dy^2 mu hq str_t,
// dx^2 mu hq str_t, dxb^2 mu hh str_s, dyb^2 mu hh str_s at halo 1, in
// four planes of their own that are only as large as that region (so
// three blocks still fit an SM); stage 3 differences them beside the
// advection tail. hh is computed twice (here and in stage 2) instead of
// being kept.
//
// Metrics: the step reads 7 metric rows (9 with tracers, 17 with
// viscosity), each at the thread's own cell only: the viscosity's shifted
// terms are shifted products, and the one shifted metric of the fast
// branch, dxt(n+1), is baked into row 17 on the host. A profile row is read by
// column, a plane by cell, coalesced along y, straight from device memory
// (halo cells re-read them, mostly from L2); no shared-memory plane holds
// a metric, so both metric forms have the same blocks. Every metric read
// sits behind the same inside-the-array test as the fields.
//
// The guard: a block whose own tile holds no wet cell (one int flag per
// block, built on the host from the land mask with this file's tile
// constants) writes exact zeros to its tile of every output and 0 to its
// max slot, loads nothing and returns before the first barrier. That is
// exact: land cells hold 0 in every carried field and every output
// select keeps land at its input value.
//
// The per-block max |ssh| over interior cells feeds the stability guard
// and propagates NaN (fmaxf would drop it). Land-only divisions are
// skipped by branching on the wet mask before dividing; the viscosity
// divides nowhere (its metric ratios are host rows, zeroed where not
// finite) and selects 0 off the wet sets, so land stays exactly 0.
//
// The raw form (RAW): the array is one shard of a mesh, (lx + 2 M) x
// (ly + 2 M) cells and pad beyond; its margin holds the neighbouring
// shards' cells (or land, at the basin's edge) and the caller refreshes it
// between launches. A block computes as in the other forms, but stores
// only inside the shard's valid box [M, M + lx) x [M, M + ly), which is
// also the box of the max: a margin cell's stencil is cut off by the
// array's edge, so what a block would compute there is wrong, and the pad
// beyond the box must stay what it was. The TPU form writes its outputs
// onto its inputs; with thousands of blocks in flight that would race (a
// block's halo is another block's output), so the caller keeps two buffers
// a field and the outputs go to the other one. An all-land tile of the
// guard writes its zeros inside the box only. RAW is a compile-time flag:
// the other forms' code does not depend on it.
//
// Without advection (TRANS = false) stage 2 forms no vorticity and no
// edge fluxes F, G, K, L and reads no vorticity rows: it stores the
// Coriolis products Px = rlh*hh*(v + v(m+1)) and -Ty = -rlh*hh*(u +
// u(n+1)) (row 21 carries the 1/4), and stage 3 sums each with its
// neighbour, Px + Px(n-1) and -Ty - Ty(m-1): what the TPU kernel adds as
// cpair_x and subtracts as cpair_y. The mass fluxes stay: continuity
// reads them. With a linear free surface (FFS = false) every depth column
// is the static rest depth hr*lu*dx*dy (the scalar hr times ludxdy on
// flat bathymetry, else the hrludxdy plane): the previous-level and
// post-step columns equal the current one, so stage 1 skips the previous
// level (hup = hu, hvp = hv), the tracers keep stage 0's column, the
// stress stage's depth is hr and the tracers' bp0 is bp. The step is
// otherwise whole: hu, hv, hh are recomputed from the static column.
//
// The chained forms (STEPS = 2, the TPU kernel's steps_per_call = 2):
// one launch runs two whole model steps on a window of halo 2 H (6, or 8
// with tracers) around the tile. Step A runs every stage of one step
// with each region H cells wider, so its outputs cover the tile and H
// cells beyond it; it leaves them in shared memory (u and v in place in
// the loaded planes, which stage 3 reads at the thread's own cell only;
// ssh, sshp, up, vp and the tracers' levels in 4 + 2 T planes of their
// own), zeros outside the array, and in the raw form it computes the
// margin too. After a barrier, step B runs the single step's stages on
// those planes where the single step reads device memory, forms aq anew
// from step A's ssh (a linear free surface keeps the static column) and
// stores as the single step does. The block max covers the tile's own
// cells of the box at both steps. A chained launch moves the bytes of one
// step for two, and recomputes step A on the H-cell ring of every tile;
// its block holds 20 + 2 T planes of the wider window (fused_tile.cuh has
// its tile and what fits an SM). The guard is unchanged: an all-land tile
// writes zeros and returns.
//
// Any number of tracers (NT = TLOOP, the TPU kernel's loop over
// n_tracers): the tracer pass (stages 4 and 5) runs in groups of
// MAX_TRACERS through the same four flux planes, a barrier between
// groups, so a block of one step a launch takes the shared memory of the
// 2-tracer form at any count (61.4 KB, 73.0 KB viscous: three blocks an
// SM). The first group keeps the transports and diffusive weights, which
// every tracer shares, in four planes dead since stage 3; the later
// groups read them. The 4 T tracer pointers are a device array the
// launcher fills in stream order (any count, no bound in the kernel's
// parameters). A chained launch keeps as many of step A's 2 T tracer
// levels as fit in shared memory (every level up to T = 8, 7 viscous, at
// the H100's 227 KB) and the others in a device scratch of window planes
// of the block's own, which it writes in step A and reads back in step B:
// no other block touches them, so no grid-wide sync. What bounds it:
// memory, as above, 16 bytes a cell for each tracer; the levels in
// scratch add their write and read, mostly from L2.
//
// The general form (GEN, the TPU kernel's non-fast branch: `fast = False`
// at :241, its `static_rslu=False` default, or metric planes without
// fast2d), sw_step_gen below: the same step on the same stages, tile,
// guard, chain, tracer groups and raw box, with what the fast forms take
// from static planes formed in the step instead, formula by formula in
// the TPU kernel's order. It reads the land mask lu and the rest
// bathymetry hr (planes, also when hr is flat) and 16 metric rows (the
// profile's rows 0-15, or 16 (Xs, Ys) planes): the staggered masks are
// products of lu > 0.5 (:381-392); the reciprocal wet counts of the depth
// interpolations are selects on the wet-neighbour sums (0.25, f32(1/3),
// 0.5, 1; :400-421), or their three static planes (the static_rslu
// variant on metric planes: the same values, so the same bits, by one run-
// time test of a pointer ahead of the same instructions); every metric
// factor is applied unfolded (u_mt = 1/dxt * 1/dyh, ...; :431-456); the
// depth column is aq = (hr + ssh * ffs) * (dx * dy) * lu (:472-476); the
// continuity divides the fluxes by the cell area and selects sshn on the
// wet set (:526-544); the vorticity takes v*dyt and u*dxt at the shifted
// cells (:650-703); the viscosity divides its metric rows (:744-786); the
// Coriolis product is rlh*dxb*dyb*hh with its own 1/4 (:807-815); the
// momentum update divides by the full bp = hhu*dxt*dyh/(2 tau) (:868-
// 887); and the tracer pass takes its column from the new ssh (:952-955)
// and its fluxes with their dyh, dxh factors (:999-1011).
//
// What bounds it: memory, as the fast forms. Per layout cell it reads the
// 6 fields, lu and hr and writes 6: 56 bytes at T = 0, against the fast
// form's 64 (the static planes were 4 reads, the general form's masks and
// depths are arithmetic on 2); with the 16 metric planes 120 (the fast2d
// form reads 7 to 17), and 12 more with the static reciprocal planes; each
// tracer adds 16. The arithmetic is about half as much again as the fast
// form's (the unfolded metric products, the selects, two divisions in the
// viscosity), still far from the card's rate.
//
// What the design does about it: the same 16 shared-memory planes as the
// fast form, so the same blocks an SM (three of one step a launch up to
// 73 KB). The general form keeps no depth plane: its masks and wet counts
// come from the lu window (in S_LD), the momentum stage re-forms hhu and
// hhv from the aq window, and the previous-level column from sshp and hr
// at the three cells it needs, so the planes the fast form spent on hu,
// hv and aqp hold the general form's eight edge terms (F, G, K, L, the
// vorticity terms H and M and the Coriolis terms, each differenced with
// its own neighbour). The tracer pass keeps aq_new in S_AQP, un and vn in
// S_U and S_V (read by their own thread only), and reads the new sshp
// back from the output it just wrote. Registers: the general form indexes
// its arrays with ints (its launcher refuses arrays of 2^31 / 3 cells and
// more), stores each field of stage 3 as soon as it is known, in three
// passes over the same cells, and runs its last tracer stage one tracer
// at a time; so its one-step forms keep 40 registers without a spill.
//
// The folds (the TPU kernel's round-5 arithmetic reductions of its fast
// form, :41-58 and :246-267 there, which its drivers turn on wherever the
// fast form runs): fused_sw_fold_kernel<..., FOLD> is the fast form with
// the bits of FOLD, each a compile-time flag of sw_step. F_ELIDE
// (elide_sel) drops the selects of the u / up / v / vp filter and of the
// tracers' pair (:886-916, :1028-1031): un and vn are 0 off the u / v wet
// sets and ffn off the T wet set, and the driver masks the carried
// velocities and tracer levels with the staggered wet masks once, when it
// packs them, so the filter of three zeros is the 0 the select kept. F_Q4
// (q4) takes the advection's 1/4 from the host, which folds it into the
// rslu_u and rslu_v planes: hu, hv, hup, hvp and the mass fluxes arrive
// quartered, the four 1/4 multiplies of F, G, K, L vanish (:608-612), and
// the constants that meet them shift by exact powers of two: -4 g, tau / 2
// and -8 tau (the launcher's scalars, :259-267), the tracers' -2 and 4 mu
// (:982-991). Both are exact: the outputs are those of the unfolded form
// but where a contraction rounds otherwise. This kernel derives its masks
// from ludxdy, not from the rslu planes, so the TPU kernel's encoded-mask
// thresholds have no counterpart here. F_SHARE (share_prev, chained forms
// with a full free surface; :498-520, :1076-1081): step B takes its
// previous-level depths from step A's through the leapfrog filter, hup =
// (ts1 hu_A + ts2 hup_A) + ts2 hu (the TPU kernel's ts1 hu_A + ts2 (hu +
// hup_A), grouped so that step A's two depths travel as one value): step A
// leaves ts1 hu_A + ts2 hup_A in S_HU / S_HV (each thread its own cell,
// after its momentum; a run-time tracer count's first group then keeps uh
// in S_SSH, dead since stage 3), and step B, in stage 1, puts hup and hvp
// in S_AQP and S_SSH, where the previous-level column is not formed. With
// a linear free surface hup = hu in both steps: nothing to share. The
// drivers reach every combination: elide_sel and q4 together or each
// alone, each with or without share_prev in the chained forms, and
// share_prev alone; -DFUSED_FOLD=1-7 builds one (one combination a
// library, beside the unfolded library of the same form): the package
// builds 3, 7 and 4 ahead (fold_targets), the others at first use. What
// bounds the folded forms: memory, as the unfolded ones (the same bytes;
// the folds remove arithmetic).
//
// With -DFUSED_NT=n only the forms with n tracers are compiled, with
// -DFUSED_RAW_NT=n only their raw forms; -DFUSED_TRANS=0 and
// -DFUSED_FFS=0 pick the forms without advection and with a linear free
// surface (both default to 1), -DFUSED_STEPS=2 the chained forms;
// -DFUSED_NT=3 (-DFUSED_RAW_NT=3) builds the TLOOP forms. The package
// builds each (tracers 0, 1, 2 or 3 and more, raw, TRANS, FFS, STEPS) as a
// library of its own, 64 side by side. -DFUSED_GEN=1 builds the general
// forms instead, every (TRANS, FFS) of them in the library of its
// (tracers, raw, STEPS): 16 more.
//
// The persistent form (K2, the TPU's build_persistent_sw_step, :1170
// there): fused_sw_persist_kernel<NT, MU, HRP, TRANS, FFS> runs n_steps
// model steps in one cooperative launch, each step the same tile body as
// the unguarded one-step form with profile metrics (GUARD, MET2D, RAW = 0,
// STEPS = 1), walked over every tile by a co-resident grid, between two
// buffer sets, with a grid barrier between steps (see the kernel).
// -DFUSED_PERSIST=1 with -DFUSED_NT=n builds only those forms, fast ones
// or, with -DFUSED_GEN=1, general ones, every (MU, HRP, TRANS, FFS) of them
// in one library: 8 more.
//
// The loader of the fast body (sw_step under BlockTile: every instantiation
// of fused_sw_step_kernel<..., GEN = 0> and fused_sw_fold_kernel, one step
// and chained, raw or not, at every tracer count, but the viscous forms on
// metric planes, MET2D && MU == 2, which keep the loads of threads: they
// read 17 metric planes through L1, and the loader's wider windows took
// three of their blocks past the 196 KB shared-memory carveout, halving
// L1, 12-19 % slower; PERF.md section 6). What held it back was
// how the tile moved its bytes: element by element, each thread computing
// a cell's index, a bounds test and a 64-bit address, four stages behind a
// barrier each exposing a load latency of its own, and only stage 0's loop
// with enough bytes in flight; the copy step of the same tiling took its
// time. Now every windowed input the first step of a launch reads comes by
// TMA (tma.cuh): after the guard's all-land return, thread 0 initialises
// five mbarriers and issues one box of the whole window (WX x WY, at the
// window's origin, zeros outside the array: what at() and inside() gave)
// for each input, all at once (the box begins R columns before the window,
// on a multiple of 16 bytes: fused_tile.cuh's Form); the cells' metric
// rows stay ordinary loads
// (one row a column, in L1). Each group of boxes is waited on by the stage
// that first reads it: stage 0 (ssh, u, v, ludxdy, hrludxdy), stage 1 and
// 1b (rslu_u, rslu_v; a viscous form's up, vp; sshp), the stress stage or
// stage 2 (rslu_h), stage 3 (up, vp), the tracer pass (the levels); hr
// stays a device load. The plane plan (fused_tile.cuh's Plan):
//   ssh, u, v, ludxdy -> S_SSH, S_U, S_V, S_LD, their working planes;
//   a chained launch: sshp, up, vp and each tracer's ff, ffp (a fixed
//     count) -> E_SSHP, E_UP, E_VP, E_TR, where step B reads step A's:
//     step A reads its inputs where step B reads its own, and stage 3 (5)
//     overwrites each cell after its thread has read it;
//   planes of their own (after the working planes) as far as the blocks
//     an SM the working planes leave allow: three one step (75 KB a
//     block), two chained T = 0 (113 KB), one chained T >= 1 and chained
//     viscous T = 0 (its 48-column window); in order rslu_u + rslu_v,
//     sshp (one step), up + vp (one step), rslu_h, a one-step form's
//     tracer levels: one step T = 0: rslu_u, rslu_v, sshp, up, vp;
//     T >= 1: rslu_u, rslu_v, sshp; viscous T = 0: rslu_u, rslu_v;
//     viscous T >= 1: none; chained T = 0: none; chained T = 1, 2 and
//     viscous T = 0: rslu_u, rslu_v, rslu_h; chained TLOOP: none (its
//     room is step A's tracer levels); the bathymetry planes none (with
//     one, 16 forms left the threads' bits by an ulp);
//   an input without a plane of its own lands in the working plane its
//     first stage writes at the same cell, read there by that stage's
//     thread before it writes: hrludxdy -> S_AQ (stage 0), rslu_u,
//     rslu_v -> S_HU, S_HV and a viscous form's up, vp -> S_F, S_K (stage
//     1), sshp -> S_AQP (1b), rslu_h -> S_CX (the stress stage and stage
//     2; stage 2 writes S_CX after it); the later own-cell reads of such an
//     input (stage 3's sshp, up, vp, rslu_u, rslu_v; the tracer pass's
//     rslu_u, rslu_v and, one step, the levels; stage 1b's and 3's
//     hrludxdy) stay device loads, as
//     do step B's reads of the static planes that have no plane of their
//     own and the run-time tracer family's levels (pointers in a device
//     table).
// A box begins and its rows end on 16 bytes, so the one-step T = 0
// window is 40 columns wide, not 38, and the chained one 48, not 44
// (every form's: fused_tile.cuh), and each plane starts at 128 bytes (the
// block's planes are aligned within 128 bytes more of shared memory). The
// loader is a compile-time choice of the Where policy. Every stage's
// arithmetic is unchanged, the same expressions in the same order, so the
// outputs and block maxima are those of the loads of threads bit for bit.
// Step A of a chained launch writes u and v in place into planes TMA
// filled: past the mbarrier's wait they are ordinary shared memory.
//
// The general body's loader (sw_step_gen under GenPlan, fused_tile.cuh):
// ssh, u, v, lu and hr, and a viscous form's up, vp, each one box of the
// window, two mbarrier groups (stage 0, stage 1). That body reads up to a
// dozen metric values a cell from device memory (16 planes on metric
// planes) through L1, so its budget is the carveout its threads' twin
// sits in, not the SM: a form moves only where its blocks keep that
// carveout with the 40-column window (164 KB one step without tracers,
// with 15 working planes: S_AQP is the tracers' column only; 196 KB with
// tracers, and hr gets a plane of its own; 196 KB / 228 KB viscous;
// chained with tracers, one block), and every general kernel is given its
// carveout (cudaFuncAttributePreferredSharedMemoryCarveout). The chained
// forms without tracers keep the threads' loader: their 48-column window
// takes two blocks past 196 KB.
//
// K2's walk (WalkTile, below) loads each tile by TMA, the fast body with
// Plan, the general one with GenPlan: the barriers are initialised once a
// launch, each tile is one phase of them (its parity flips from tile to
// tile and from step to step), and two proxy fences order the async
// proxy's boxes after the generic proxy's accesses: fence.proxy.async.
// shared::cta after a tile's planes are done with, before the next tile's
// boxes land in them, and fence.proxy.async.global around the grid
// barrier, before a step's boxes read what other blocks stored.

#include "fused_tile.cuh"
#include "tma.cuh"

#include <climits>
#include <type_traits>
#ifdef FUSED_PERSIST
#include <cooperative_groups.h>

#include <vector>

namespace cg = cooperative_groups;
#endif

#ifdef FUSED_RAW_NT
#define FUSED_NT FUSED_RAW_NT
#endif
#ifndef FUSED_TRANS
#define FUSED_TRANS 1
#endif
#ifndef FUSED_FFS
#define FUSED_FFS 1
#endif
#ifndef FUSED_STEPS
#define FUSED_STEPS 1
#endif
#ifndef FUSED_FOLD
#define FUSED_FOLD 0
#endif

namespace {

using namespace fused_tile;

// The fast form's arithmetic folds (the TPU kernel's round-5 reductions,
// a FOLD template argument): elide_sel, q4, share_prev.
enum { F_ELIDE = 1, F_Q4 = 2, F_SHARE = 4 };

// shared-memory arrays, each a WX x WY window
enum {
  S_SSH, S_U, S_V, S_LD,     // loaded fields; LD = lu*dx*dy (> 0.5: wet)
  S_AQ, S_AQP,               // weighted depth columns of ssh and sshp
  S_HU, S_HV, S_UD, S_VD,    // depth interps (carry dyh / dxh), fluxes
  S_F, S_K, S_RX, S_SY,      // edge fluxes and the merged shifted terms
  S_CX, S_CY,                // centre terms of the advection tails
  N_SMEM,
  // a chained launch: step A's outputs that step B reads (u and v stay in
  // S_U and S_V)
  E_SSH = N_SMEM, E_SSHP, E_UP, E_VP,
  E_TR                       // ff_0, ffp_0, ff_1, ffp_1, ... (chain_level)
};
// What the tracer stages keep in planes that are dead by then:
//   S_AQ <- aq_new (post-step depth column; aq is last read in stage 2)
//   S_CX, S_CY <- un, vn (each thread overwrites the centre term it read)
//   S_HU <- sshp_new of the tile's cells (hu is read by its own thread)
//   tracer t of a group: its edge fluxes fx, fy <- S_F + 2 t, S_F + 2 t + 1
//   (F, K, Rx, Sy are last read in stage 3)
//   TLOOP: uh, vh, kx, ky <- S_HV, S_UD, S_VD, S_AQP (last read in stage 3)
// What the viscous forms keep, between stage 1 and the stress stage, in
// planes the flux stage (2) has not written yet:
//   S_F <- up/dyh, S_K <- vp/dxh, S_RX <- up/dxt, S_SY <- vp/dyt
// Their stress products live past stage 2, in N_VISC_PLANES small planes
// behind these (V_A2 ...), indexed row-major over the halo 1 + EXTRA region.
static_assert(S_F + 2 * MAX_TRACERS <= S_CX, "tracer flux planes overlap");
static_assert(S_F + 4 <= S_CX, "velocity-over-metric planes overlap");
static_assert(N_SMEM == N_SMEM_PLANES, "fused_tile.cuh sizes the windows");
static_assert(E_TR - E_SSH == N_CHAIN_PLANES, "fused_tile.cuh sizes them");
enum { V_A2, V_B2, V_D2, V_E2, N_VISC };
static_assert(N_VISC == N_VISC_PLANES, "fused_tile.cuh sizes the planes");

// the metric rows the kernel reads, in the order the launcher takes their
// slots (ops/fused_layout.py row meanings 0, 1, 6, 7, 9-21)
enum {
  M_DX, M_DY,                          // tracer pass and viscosity
  M_DXB, M_DYB,                        // viscosity
  M_RDXDY, M_RDXT, M_RDYT,
  M_RDXH, M_RDYH, M_RDXB, M_RDYB,      // viscosity
  M_VORT_V, M_VORT_UY, M_VORT_U,       // advection
  M_DYDX, M_DXDY,                      // viscosity
  M_CORIO,
  N_MET
};

struct Params {
  const float* ssh; const float* sshp;
  const float* u; const float* up;
  const float* v; const float* vp;
  // each metric row: a (Ys) latitude profile (indexed by column) or an
  // (Xs, Ys) plane (indexed by cell); rows the form does not read are null
  const float* met[N_MET];
  const float* planes;   // (4, Xs, Ys): rslu_u, rslu_v, rslu_h, ludxdy;
                         // the general forms: (Xs, Ys) lu
  const float* hrld;     // (Xs, Ys) hr*lu*dx*dy, varying bathymetry only;
                         // the general forms: (3, Xs, Ys) rslu_u, rslu_v,
                         // rslu_h (static_rslu), or null (selects)
  const float* hrp;      // (Xs, Ys) hr, the same with viscosity or tracers;
                         // the general forms: always
  float* ssh_o; float* sshp_o;
  float* u_o; float* up_o;
  float* v_o; float* vp_o;
  float* blockmax;       // one max |ssh| per block
  const float* tr[2 * MAX_TRACERS];   // ff_0, ffp_0, ff_1, ffp_1
  float* tr_o[2 * MAX_TRACERS];
  // TLOOP forms: n_tr tracers, whose 4 n_tr pointers (the 2 n_tr levels
  // in, then out) are a device array; a chained launch keeps n_lev_sm of
  // step A's levels in shared memory and the others in `scratch`, (2 n_tr
  // - n_lev_sm) window planes a block
  float* const* trp;
  float* scratch;
  int n_tr, n_lev_sm;
  const int* tile_wet;   // one flag per block (guarded forms), else null
  int Xs, Ys, nx, ny, margin;
  float hr;              // flat rest bathymetry
  float mu;              // lateral viscosity / tracer diffusivity
  float neg_g;           // -FREE_FALL_ACC
  float two_tau, neg_two_tau, inv_two_tau;
  float ts1, ts2;        // 1 - time_smooth, time_smooth / 2
};

// The fast body's tensor maps (tma.cuh), one a windowed input, passed
// beside Params in the kernel's 4 KB of parameters; the general form's
// kernel takes none.
enum {
  T_SSH, T_SSHP, T_U, T_UP, T_V, T_VP,     // the carried fields
  T_RU, T_RV, T_RH, T_LD, T_HRLD,          // the static planes
  T_TR,                                    // ff_0, ffp_0, ff_1, ffp_1
  N_TMAP = T_TR + 2 * MAX_TRACERS
};
struct Maps {
  CUtensorMap m[N_TMAP];
  __device__ __forceinline__ const CUtensorMap* at(int slot) const {
    return &m[slot];
  }
};
struct NoMaps {};
static_assert(sizeof(Params) + sizeof(Maps) + 64 <= 4096,
              "kernel parameters are 4 KB");
// The general body takes its lu and hr planes through the slots of
// ludxdy and hrludxdy (T_LD, T_HRLD).
enum { T_LU = T_LD, T_HR = T_HRLD };


// The loader's groups of boxes, an mbarrier each, by the stage that waits.
enum { G_S0, G_S1, G_S2, G_S3, G_TR, N_GROUPS };

// Which boxes the loader issues for a fast form (Plan: where they land),
// by map slot (USED) and group (the boxes of each, N of them in all).
template <int NT, int MU, bool HRP, bool FFS, int STEPS>
struct Loads {
  using Pl = Plan<NT, STEPS, MU == 2, HRP, FFS>;
  static constexpr bool VISC = MU == 2, CHAIN = STEPS > 1;
  static constexpr bool SSHP = CHAIN || Pl::SSHP || FFS;   // in group 1
  static constexpr bool UV3 = !VISC && (CHAIN || Pl::UVP); // up, vp, 3
  static constexpr bool TRW = NT > 0 && (CHAIN || Pl::TR); // the levels
  enum : int {
    NG0 = 4 + HRP, NG1 = 2 + 2 * VISC + SSHP, NG2 = 1, NG3 = 2 * UV3,
    NG4 = TRW ? 2 * NT : 0, N = NG0 + NG1 + NG2 + NG3 + NG4
  };
  enum : unsigned {
    USED = 1u << T_SSH | 1u << T_U | 1u << T_V | 1u << T_LD | 1u << T_RU
        | 1u << T_RV | 1u << T_RH | (HRP ? 1u << T_HRLD : 0u)
        | (SSHP ? 1u << T_SSHP : 0u)
        | (VISC || UV3 ? 1u << T_UP | 1u << T_VP : 0u)
        | (TRW ? ((1u << 2 * (NT > 0 ? NT : 0)) - 1u) << T_TR : 0u)
  };
};

// Thread 0 of the block: the barriers (INIT: a launch of one tile a block;
// the persistent walk initialises them once a launch), then every box of
// the first step's windows (Loads, Plan), each group's bytes posted before
// its boxes.
template <int NT, int MU, bool HRP, bool FFS, int STEPS, bool INIT,
          class MapsT>
__device__ __forceinline__ void load_windows(const MapsT& m, float* sm,
                                             uint64_t* bars, int x0, int y0) {
  using Fm = Form<NT, STEPS>;
  using Ld = Loads<NT, MU, HRP, FFS, STEPS>;
  using Pl = typename Ld::Pl;
  constexpr bool CHAIN = STEPS > 1;
  // the box begins R columns before the window, on a multiple of 16 bytes
  const auto box = [&](int slot, int plane, int group) {
    tma::load_2d(sm + plane * Fm::PLANE, m.at(slot), &bars[group], x0,
                 y0 - Fm::R);
  };
  const int ng[N_GROUPS] = {Ld::NG0, Ld::NG1, Ld::NG2, Ld::NG3, Ld::NG4};
  if (INIT) {
    for (int gr = 0; gr < N_GROUPS; ++gr) tma::bar_init(&bars[gr]);
    tma::bar_fence();
  }
  for (int gr = 0; gr < N_GROUPS; ++gr)
    if (ng[gr]) tma::bar_expect(&bars[gr], sizeof(float) * Fm::CELLS * ng[gr]);
  box(T_SSH, S_SSH, G_S0);
  box(T_U, S_U, G_S0);
  box(T_V, S_V, G_S0);
  box(T_LD, S_LD, G_S0);
  if (HRP) box(T_HRLD, S_AQ, G_S0);
  box(T_RU, Pl::RUV ? Pl::P_RU : S_HU, G_S1);
  box(T_RV, Pl::RUV ? Pl::P_RV : S_HV, G_S1);
  if (Ld::VISC) {
    box(T_UP, CHAIN ? E_UP : Pl::UVP ? Pl::P_UP : S_F, G_S1);
    box(T_VP, CHAIN ? E_VP : Pl::UVP ? Pl::P_VP : S_K, G_S1);
  }
  if (Ld::SSHP) box(T_SSHP, CHAIN ? E_SSHP : Pl::SSHP ? Pl::P_SSHP : S_AQP,
                    G_S1);
  box(T_RH, Pl::RH ? Pl::P_RH : S_CX, G_S2);
  if (Ld::UV3) {
    box(T_UP, CHAIN ? E_UP : Pl::P_UP, G_S3);
    box(T_VP, CHAIN ? E_VP : Pl::P_VP, G_S3);
  }
  if (Ld::TRW)
    for (int l = 0; l < 2 * NT; ++l)
      box(T_TR + l, (CHAIN ? E_TR : Pl::P_TR) + l, G_TR);
}

// Where the general body keeps working plane s: by TMA without tracers
// S_AQP is gone (GenPlan) and the later planes move down by one.
template <int NT, bool TMA>
__host__ __device__ constexpr int gen_plane(int s) {
  return s - (TMA && NT == 0 && s > S_AQP ? 1 : 0);
}

// The general body's boxes (GenPlan): group 0 ssh, u, v, lu and hr (into
// a plane of its own, or S_AQ), waited on by stage 0; group 1 a viscous
// form's up, vp (into S_F, S_K), waited on by stage 1.
template <int NT, int STEPS, bool VISC, bool INIT, class MapsT>
__device__ __forceinline__ void load_gen_windows(const MapsT& m, float* sm,
                                                 uint64_t* bars, int x0,
                                                 int y0) {
  using Fm = Form<NT, STEPS>;
  using GP = GenPlan<NT, STEPS, VISC>;
  const auto box = [&](int slot, int plane, int group) {
    tma::load_2d(sm + plane * Fm::PLANE, m.at(slot), &bars[group], x0,
                 y0 - Fm::R);
  };
  if (INIT) {
    for (int gr = 0; gr < N_GROUPS; ++gr) tma::bar_init(&bars[gr]);
    tma::bar_fence();
  }
  const uint32_t cells = sizeof(float) * Fm::CELLS;
  tma::bar_expect(&bars[G_S0], 5 * cells);
  if (VISC) tma::bar_expect(&bars[G_S1], 2 * cells);
  box(T_SSH, gen_plane<NT, true>(S_SSH), G_S0);
  box(T_U, gen_plane<NT, true>(S_U), G_S0);
  box(T_V, gen_plane<NT, true>(S_V), G_S0);
  box(T_LU, gen_plane<NT, true>(S_LD), G_S0);
  box(T_HR, GP::HR ? GP::P_HR : gen_plane<NT, true>(S_AQ), G_S0);
  if (VISC) {
    box(T_UP, gen_plane<NT, true>(S_F), G_S1);
    box(T_VP, gen_plane<NT, true>(S_K), G_S1);
  }
}

// The carried fields' pointers of a step, in and out, by Params' names: the
// step bodies read them from an object of their own (`f`), which is the
// launch's Params itself in a launch of one step and, in the persistent
// walk, the set of the step's parity (walk_fields).
struct Fields {
  const float* ssh; const float* sshp;
  const float* u; const float* up;
  const float* v; const float* vp;
  float* ssh_o; float* sshp_o;
  float* u_o; float* up_o;
  float* v_o; float* vp_o;
  const float* tr[2 * MAX_TRACERS];
  float* tr_o[2 * MAX_TRACERS];
  float* const* trp;
};

__device__ __forceinline__ float nan_max(float m, float v) {
  return (v != v || v > m) ? v : m;
}

// Where a step body's output tile is: column tile bx(), row tile by() of
// the layout, and the window's origin (global row x0 of its row 0, column
// y0 of its column 0), and the thread's index. In a launch of one block a
// tile, the block's own indices (unsigned, as blockIdx is), the origin and
// the thread taken once at the body's top (origin(), thread(); then x0(o),
// y0(o), thread(t) return them); the persistent walk has a policy of its
// own (WalkTile). TMA: whether the step bodies bring their windows in by
// TMA (the loader, see the file's head); INIT: whether the body
// initialises the loader's barriers (one tile a block), and phase(): the
// parity of this tile's phase of them.
struct BlockTile {
  static constexpr bool TMA = true, INIT = true;
  __device__ __forceinline__ uint32_t phase() const { return 0; }
  __device__ __forceinline__ unsigned bx() const { return blockIdx.x; }
  __device__ __forceinline__ unsigned by() const { return blockIdx.y; }
  __device__ __forceinline__ int thread() const { return threadIdx.x; }
  __device__ __forceinline__ int thread(int t) const { return t; }
  template <int TX, int TY, int WH>
  __device__ __forceinline__ int2 origin() const {
    const int x0 = blockIdx.y * TX - WH;
    const int y0 = blockIdx.x * TY - WH;
    return make_int2(x0, y0);
  }
  template <int TX, int TY, int WH>
  __device__ __forceinline__ int x0(int2 o) const { return o.x; }
  template <int TX, int TY, int WH>
  __device__ __forceinline__ int y0(int2 o) const { return o.y; }
};

__device__ __forceinline__ bool inside(const Params& p, int gx, int gy) {
  return gx >= 0 && gx < p.Xs && gy >= 0 && gy < p.Ys;
}

// inside the valid box (the interior; a shard's own cells in the raw form)
__device__ __forceinline__ bool in_box(const Params& p, int gx, int gy) {
  return gx >= p.margin && gx < p.margin + p.nx
      && gy >= p.margin && gy < p.margin + p.ny;
}

// f[gx, gy], 0 outside the array
__device__ __forceinline__ float at(const Params& p, const float* f,
                                    int gx, int gy) {
  return inside(p, gx, gy) ? f[(size_t)gx * p.Ys + gy] : 0.f;
}

// tracer level l (ff_0, ffp_0, ff_1, ...) in and out, of the fields f
template <int NT, class FieldsT>
__device__ __forceinline__ const float* tr_in(const FieldsT& f, int l) {
  if constexpr (NT >= 0) return f.tr[l];
  else return f.trp[l];
}

template <int NT, class FieldsT>
__device__ __forceinline__ float* tr_out(const Params& p,
                                              const FieldsT& f, int l) {
  if constexpr (NT >= 0) return f.tr_o[l];
  else return f.trp[2 * p.n_tr + l];
}

// step A's tracer level l in a chained launch: a plane of the window in
// shared memory from E_TR on, or, for a TLOOP form's levels beyond
// n_lev_sm, the planes of the device scratch that belong to the tile
// (a chained launch runs one tile a block, so the block's own)
template <int NT, int PLANE, class Where>
__device__ __forceinline__ float* chain_level(const Params& p, float* e_tr,
                                              int l, const Where& where) {
  if (NT >= 0 || l < p.n_lev_sm) return e_tr + l * PLANE;
  const size_t block = where.by() * gridDim.x + where.bx();
  return p.scratch + (block * (2 * p.n_tr - p.n_lev_sm) + (l - p.n_lev_sm))
      * PLANE;
}

// One model step of a launch that chains STEPS of them. Step STEP
// (0-based) computes its outputs on the region OH = HALO * (STEPS - 1 -
// STEP) cells beyond the tile, and every stage's region is that many cells
// wider than in a launch of one step: the last step (OH = 0) stores to
// device memory as the single-step form does; an earlier one (step A of a
// chained launch) leaves its outputs in shared memory, where the next step
// reads them in place of the device arrays: ssh in E_SSH, u and v in
// place in S_U and S_V (stage 3 reads them at its own cell only), sshp,
// up, vp and the tracers in E_SSHP, E_UP, E_VP, E_TR. `f` holds the carried
// fields' pointers (Fields), `where` says which tile of the layout is the
// output tile (BlockTile, WalkTile). FOLD: the arithmetic folds of the
// fast form (F_ELIDE, F_Q4, F_SHARE; see the file's head), 0 for none.
// Under a Where with TMA, the first step brings its windows in by TMA
// (maps, the block's N_GROUPS mbarriers bars; the loader of the file's
// head), sm 128-byte aligned; the viscous forms on metric planes load by
// threads.
template <int NT, bool MET2D, int MU, bool HRP, bool RAW, bool TRANS,
          bool FFS, int STEPS, int STEP, int FOLD = 0, class FieldsT,
          class Where, class MapsT = Maps>
__device__ __forceinline__ void sw_step(const Params& p, const FieldsT& f,
                                        float* sm, float& mx,
                                        const Where& where,
                                        const MapsT* maps = nullptr,
                                        uint64_t* bars = nullptr) {
  // whether this body loads by TMA: under a Where with TMA, but for the
  // viscous forms on metric planes (fused_tile.cuh's Form)
  constexpr bool USE_TMA = Where::TMA && !(MET2D && MU == 2);
  using Fm = Form<NT, STEPS, USE_TMA>;
  constexpr int HALO = Fm::HALO, EXTRA = Fm::EXTRA, WH = Fm::WH;
  constexpr int TX = Fm::TX, TY = Fm::TY;
  constexpr int NTHREADS = Tile<STEPS>::NTHREADS;
  constexpr int WY = Fm::WY, PLANE = Fm::PLANE;
  constexpr bool VISC = MU == 2;            // stress stages
  constexpr bool DIFF = NT != 0 && MU != 0; // tracers' diffusive fluxes
  constexpr bool LOOP = NT < 0;             // a run-time tracer count
  constexpr bool FIRST = STEP == 0, LAST = STEP == STEPS - 1;
  constexpr int OH = HALO * (STEPS - 1 - STEP);   // this step's output halo
  // this step's stress region: its halo, columns and cells
  constexpr int VH = OH + Fm::VH, VW = TY + 2 * VH, VN = (TX + 2 * VH) * VW;
  // the folds: no filter selects; the advection 1/4 in rslu_u / rslu_v;
  // step A's depths shared with step B (a full free surface chained: step
  // A leaves them in S_HU / S_HV, step B takes its previous-level depths
  // from them into S_AQP / S_SSH)
  constexpr bool ELIDE = (FOLD & F_ELIDE) != 0, Q4 = (FOLD & F_Q4) != 0;
  constexpr bool SHARE = (FOLD & F_SHARE) != 0 && STEPS > 1 && FFS;
  constexpr bool SHARE_A = SHARE && !LAST, SHARE_B = SHARE && !FIRST;
  constexpr float ADV = Q4 ? -2.f : -0.5f;  // the tracers' advective factor
  // the loader: LD, this step's inputs came by TMA; EIN, a chained
  // launch's E planes hold the previous levels in both steps (step A's
  // inputs, then its outputs); TRE, TRX: the tracer levels came to E_TR,
  // or to planes of their own
  using Pl = Plan<NT, STEPS, VISC, HRP, FFS, USE_TMA>;
  using Ld = Loads<NT, MU, HRP, FFS, STEPS>;
  constexpr bool LD = USE_TMA && FIRST;
  constexpr bool EIN = USE_TMA && STEPS > 1;
  constexpr bool TRE = EIN && NT > 0, TRX = LD && Pl::TR;

  const int tid0 = where.thread();
  // the window planes: under the loader R columns into each plane, where
  // its box begins on a multiple of 16 bytes (fused_tile.cuh)
  float* sw = sm + Fm::R;
  const auto tid = [&] { return where.thread(tid0); };
  float* s_ssh = sw + (FIRST ? S_SSH : E_SSH) * PLANE;
  float* s_u = sw + S_U * PLANE;
  float* s_v = sw + S_V * PLANE;
  float* s_ld = sw + S_LD * PLANE;
  float* s_aq = sw + S_AQ * PLANE;
  float* s_aqp = sw + S_AQP * PLANE;
  float* s_hu = sw + S_HU * PLANE;
  float* s_hv = sw + S_HV * PLANE;
  float* s_ud = sw + S_UD * PLANE;
  float* s_vd = sw + S_VD * PLANE;
  float* s_f = sw + S_F * PLANE;
  float* s_k = sw + S_K * PLANE;
  float* s_rx = sw + S_RX * PLANE;
  float* s_sy = sw + S_SY * PLANE;
  float* s_cx = sw + S_CX * PLANE;
  float* s_cy = sw + S_CY * PLANE;
  // the viscous forms' stress planes follow the window planes, the
  // chained forms' tracer levels among them
  const int n_win = LOOP && STEPS > 1 ? Fm::N_BASE + p.n_lev_sm
                                      : Fm::N_PLANES + Pl::N_EXTRA;
  float* s_a2 = sm + n_win * PLANE + V_A2 * Fm::VPLANE;   // viscous
  float* s_b2 = sm + n_win * PLANE + V_B2 * Fm::VPLANE;   // forms only
  float* s_d2 = sm + n_win * PLANE + V_D2 * Fm::VPLANE;
  float* s_e2 = sm + n_win * PLANE + V_E2 * Fm::VPLANE;
  // step A's outputs in a chained launch
  float* e_ssh = sw + E_SSH * PLANE;
  float* e_sshp = sw + E_SSHP * PLANE;
  float* e_up = sw + E_UP * PLANE;
  float* e_vp = sw + E_VP * PLANE;
  float* e_tr = sw + E_TR * PLANE;          // see chain_level
  // the loader's planes of their own (Plan)
  const float* x_ru = sw + Pl::P_RU * PLANE;
  const float* x_rv = sw + Pl::P_RV * PLANE;
  const float* x_sshp = sw + Pl::P_SSHP * PLANE;
  const float* x_up = sw + Pl::P_UP * PLANE;
  const float* x_vp = sw + Pl::P_VP * PLANE;
  const float* x_rh = sw + Pl::P_RH * PLANE;
  float* x_tr = sw + Pl::P_TR * PLANE;

  // global row of window row 0, global column of window column 0
  const int2 org = where.template origin<TX, TY, WH>();
  const auto x0 = [&] { return where.template x0<TX, TY, WH>(org); };
  const auto y0 = [&] { return where.template y0<TX, TY, WH>(org); };
  const size_t plane = (size_t)p.Xs * p.Ys;
  const float* rslu_u = p.planes;
  const float* rslu_v = p.planes + plane;
  const float* rslu_h = p.planes + 2 * plane;
  const float* ludxdy = p.planes + 3 * plane;
  const int W = 1;                          // one window row/col offset
  const int S = WY;                         // window row stride

  // stage 0 (halo 3 + EXTRA): load the window; aq = (ssh + hr) * lu*dx*dy
  // or, on bathymetry planes, ssh * lu*dx*dy + hr*lu*dx*dy; with a linear
  // free surface the static hr * lu*dx*dy or hr*lu*dx*dy. A later step of
  // a chained launch forms aq anew from the previous step's ssh (the
  // static column of a linear free surface stays from the first)
  if (FIRST && LD) {
    // every box in flight at once; the barriers initialised for all
    if (tid() == 0)
      load_windows<NT, MU, HRP, FFS, STEPS, Where::INIT>(*maps, sm, bars,
                                                         x0(), y0());
    if (Where::INIT) __syncthreads();
    tma::bar_wait(&bars[G_S0], where.phase());
    for (int i = tid(); i < Fm::CELLS; i += NTHREADS) {
      const float ssh = s_ssh[i], ld = s_ld[i];
      const float hl = HRP ? s_aq[i] : 0.f;
      if (FFS) s_aq[i] = HRP ? ssh * ld + hl : (ssh + p.hr) * ld;
      else s_aq[i] = HRP ? hl : p.hr * ld;
    }
    __syncthreads();
  } else if (FIRST) {
    for (int i = tid(); i < Fm::CELLS; i += NTHREADS) {
      const int gx = x0() + i / WY, gy = y0() + i % WY;
      float ssh = 0.f, u = 0.f, v = 0.f, ld = 0.f, hl = 0.f;
      if (inside(p, gx, gy)) {
        const size_t g = (size_t)gx * p.Ys + gy;
        ssh = f.ssh[g]; u = f.u[g]; v = f.v[g]; ld = ludxdy[g];
        if (HRP) hl = p.hrld[g];
      }
      s_ssh[i] = ssh; s_u[i] = u; s_v[i] = v; s_ld[i] = ld;
      if (FFS) s_aq[i] = HRP ? ssh * ld + hl : (ssh + p.hr) * ld;
      else s_aq[i] = HRP ? hl : p.hr * ld;
    }
    __syncthreads();
  } else if (FFS) {
    constexpr int h = OH + HALO, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b;
      const float ssh = s_ssh[k], ld = s_ld[k];
      s_aq[k] = HRP ? ssh * ld + at(p, p.hrld, x0() + a, y0() + b)
                    : (ssh + p.hr) * ld;
    }
    __syncthreads();
  }

  // stage 1 (halo 2 + EXTRA): depth interps hu = hhu*dyh, hv = hhv*dxh and
  // the mass fluxes; the previous-level column aqp (halo 1 + EXTRA; with
  // a linear free surface it is aq, and not formed); with viscosity the
  // previous-level velocities over their metrics
  {
    if constexpr (LD) tma::bar_wait(&bars[G_S1], where.phase());
    constexpr int h = OH + 2 + EXTRA, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      // by TMA: in planes of their own, or where this stage writes hu, hv
      float ru = Pl::RUV ? x_ru[k] : LD ? s_hu[k] : 0.f;
      float rv = Pl::RUV ? x_rv[k] : LD ? s_hv[k] : 0.f;
      if (inside(p, gx, gy)) {
        const size_t g = (size_t)gx * p.Ys + gy;
        if (!Pl::RUV && !LD) { ru = rslu_u[g]; rv = rslu_v[g]; }
        if (VISC) {
          const size_t mi = MET2D ? g : (size_t)gy;
          // by TMA: E_UP, E_VP chained, else a plane of their own or S_F,
          // S_K, which this cell's products overwrite below
          const float up = EIN || !FIRST ? e_up[k] : Pl::UVP ? x_up[k]
                         : LD ? s_f[k] : f.up[g];
          const float vp = EIN || !FIRST ? e_vp[k] : Pl::UVP ? x_vp[k]
                         : LD ? s_k[k] : f.vp[g];
          s_f[k] = up * p.met[M_RDYH][mi];
          s_k[k] = vp * p.met[M_RDXH][mi];
          s_rx[k] = up * p.met[M_RDXT][mi];
          s_sy[k] = vp * p.met[M_RDYT][mi];
        }
      } else if (VISC) {
        s_f[k] = 0.f; s_k[k] = 0.f; s_rx[k] = 0.f; s_sy[k] = 0.f;
      }
      const float hu = (s_aq[k] + s_aq[k + S]) * ru;
      const float hv = (s_aq[k] + s_aq[k + W]) * rv;
      if (SHARE_B) {
        // share_prev: hup = (ts1 hu_A + ts2 hup_A) + ts2 hu, the filter
        // through the interpolation (step A left the bracket in S_HU)
        s_aqp[k] = s_hu[k] + p.ts2 * hu;
        sw[S_SSH * PLANE + k] = s_hv[k] + p.ts2 * hv;
      }
      s_hu[k] = hu; s_hv[k] = hv;
      s_ud[k] = s_u[k] * hu;
      s_vd[k] = s_v[k] * hv;
    }
  }
  if (FFS && !SHARE_B) {
    constexpr int h = OH + 1 + EXTRA, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b;
      // by TMA: E_SSHP chained, else a plane of its own or S_AQP, which
      // this cell's column overwrites
      const float sshp = EIN || !FIRST ? e_sshp[k] : Pl::SSHP ? x_sshp[k]
                       : LD ? s_aqp[k] : at(p, f.sshp, x0() + a, y0() + b);
      s_aqp[k] = HRP ? sshp * s_ld[k] + at(p, p.hrld, x0() + a, y0() + b)
                     : (sshp + p.hr) * s_ld[k];
    }
  }
  __syncthreads();

  // stress stage (halo 1 + EXTRA, viscous forms): tension at T points,
  // shear at H points, and their four products with mu, the depth and the
  // squared metrics of the cell
  if constexpr (LD) tma::bar_wait(&bars[G_S2], where.phase());
  if (VISC) {
    constexpr int h = VH, n = VN;
    const float* s_q = s_f;
    const float* s_r = s_k;
    const float* s_s1 = s_rx;
    const float* s_s2 = s_sy;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / VW, b = WH - h + i % VW;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      float a2 = 0.f, b2 = 0.f, d2 = 0.f, e2 = 0.f;
      if (inside(p, gx, gy)) {
        const size_t g = (size_t)gx * p.Ys + gy;
        const size_t mi = MET2D ? g : (size_t)gy;
        const bool wlu = s_ld[k] > 0.5f;
        const bool wluu = wlu && s_ld[k + S] > 0.5f
            && s_ld[k + W] > 0.5f && s_ld[k + S + W] > 0.5f;
        const float dx = p.met[M_DX][mi], dy = p.met[M_DY][mi];
        const float dxb = p.met[M_DXB][mi], dyb = p.met[M_DYB][mi];
        if (wlu) {
          const float str_t =
              p.met[M_DYDX][mi] * (s_q[k] - s_q[k - S])
              - p.met[M_DXDY][mi] * (s_r[k] - s_r[k - W]);
          const float hr = HRP ? p.hrp[g] : p.hr;
          const float hq = FFS ? hr + s_ssh[k] : hr;
          const float t2 = hq * str_t;
          a2 = (dy * dy * p.mu) * t2;
          b2 = (dx * dx * p.mu) * t2;
        }
        if (wluu) {
          const float su = s_aq[k] + s_aq[k + S];
          // rslu_h by TMA: a plane of its own, or S_CX (stage 2's)
          const float rh = Pl::RH ? x_rh[k] : LD ? s_cx[k] : rslu_h[g];
          const float hh = (su + (s_aq[k + W] + s_aq[k + S + W])) * rh;
          const float str_s =
              (dxb * p.met[M_RDYB][mi]) * (s_s1[k + W] - s_s1[k])
              + (dyb * p.met[M_RDXB][mi]) * (s_s2[k + S] - s_s2[k]);
          const float hs2 = hh * str_s;
          d2 = (dxb * dxb * p.mu) * hs2;
          e2 = (dyb * dyb * p.mu) * hs2;
        }
      }
      s_a2[i] = a2; s_b2[i] = b2; s_d2[i] = d2; s_e2[i] = e2;
    }
    __syncthreads();
  }

  // stage 2 (halo 1 + EXTRA): vorticity, edge fluxes, vorticity + Coriolis;
  // without advection the Coriolis products alone
  {
    constexpr int h = OH + 1 + EXTRA, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      // rslu_h by TMA: a plane of its own, or S_CX, written below
      float rh = Pl::RH ? x_rh[k] : LD ? s_cx[k] : 0.f;
      float m16 = 0.f, m17 = 0.f, m18 = 0.f, m21 = 0.f;
      if (inside(p, gx, gy)) {
        const size_t g = (size_t)gx * p.Ys + gy;
        const size_t mi = MET2D ? g : (size_t)gy;
        if (!Pl::RH && !LD) rh = rslu_h[g];
        if (TRANS) {
          m16 = p.met[M_VORT_V][mi];
          m17 = p.met[M_VORT_UY][mi];
          m18 = p.met[M_VORT_U][mi];
        }
        m21 = p.met[M_CORIO][mi];
      }
      const float su = s_aq[k] + s_aq[k + S];
      const float hh = (su + (s_aq[k + W] + s_aq[k + S + W])) * rh;
      const bool wluu = s_ld[k] > 0.5f && s_ld[k + S] > 0.5f
          && s_ld[k + W] > 0.5f && s_ld[k + S + W] > 0.5f;
      const float u = s_u[k], v = s_v[k];
      const float ux = s_u[k + S], uy = s_u[k + W];
      const float vx = s_v[k + S], vy = s_v[k + W];
      if (!TRANS) {
        const float vc = m21 * hh;
        s_rx[k] = vc * (vx + v);     // Px
        s_sy[k] = -(vc * (uy + u));  // -Ty
        continue;
      }
      // vorticity/4 (rows 16-18 carry the 1/4)
      const float vort = wluu ? (vx - v) * m16 - uy * m17 + u * m18 : 0.f;
      const float s2u = uy + u, s2v = vx + v;
      const float ud = s_ud[k], vd = s_vd[k];
      // with q4 ud, vd arrive quartered: the 1/4 multiplies vanish
      const float F = Q4 ? (ud + s_ud[k + S]) * (u + ux)
                         : (ud + s_ud[k + S]) * ((u + ux) * 0.25f);
      const float G = Q4 ? (vd + s_vd[k + S]) * (wluu ? s2u : 0.f)
                         : ((vd + s_vd[k + S]) * 0.25f) * (wluu ? s2u : 0.f);
      const float K = Q4 ? (vd + s_vd[k + W]) * (v + vy)
                         : (vd + s_vd[k + W]) * ((v + vy) * 0.25f);
      const float L = Q4 ? (ud + s_ud[k + W]) * s2v
                         : ((ud + s_ud[k + W]) * 0.25f) * s2v;
      const float vc = (vort + m21) * hh;
      const float Px = vc * s2v, Ty = vc * s2u;
      s_f[k] = F; s_k[k] = K;
      s_rx[k] = Px + G;
      s_sy[k] = L - Ty;
      s_cx[k] = (Px - F) - G;
      s_cy[k] = (-Ty - L) - K;
    }
  }
  __syncthreads();

  // stage 3: continuity, momentum, leapfrog + filter, the 6 SW outputs
  // (halo 0). With tracers the continuity runs at halo 2 and the momentum
  // at halo 1, and they leave aq_new, un, vn and sshp_new in shared memory.
  // Step A of a chained launch keeps its outputs (halo 3 + EXTRA) in
  // shared memory, zeros outside the array, and computes the raw form's
  // margin too.
  {
    if constexpr (LD && Ld::UV3)
      tma::bar_wait(&bars[G_S3], where.phase());
    constexpr int h = OH + 2 * EXTRA, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      // distance beyond this step's output region: 0 inside it
      const int ring = !NT ? 0
          : max(max(WH - OH - a, a - (WH + OH + TX - 1)),
                max(max(WH - OH - b, b - (WH + OH + TY - 1)), 0));
      if (!inside(p, gx, gy)) {
        if (NT) { s_aq[k] = 0.f; s_cx[k] = 0.f; s_cy[k] = 0.f; }
        if (!LAST && ring == 0) {
          e_ssh[k] = 0.f; e_sshp[k] = 0.f; e_up[k] = 0.f; e_vp[k] = 0.f;
        }
        continue;
      }
      const size_t g = (size_t)gx * p.Ys + gy;
      const size_t mi = MET2D ? g : (size_t)gy;
      const float ssh = s_ssh[k];
      const float sshp = EIN || !FIRST ? e_sshp[k] : Pl::SSHP ? x_sshp[k]
                       : f.sshp[g];
      const bool wlu = s_ld[k] > 0.5f;
      const bool wlcu = wlu && s_ld[k + S] > 0.5f;
      const bool wlcv = wlu && s_ld[k + W] > 0.5f;

      // continuity: sshn = sshp - 2 tau div(flux) / (dx dy)
      const float div = ((s_ud[k] - s_ud[k - S]) + s_vd[k]) - s_vd[k - W];
      const float sshn = sshp + div * (p.neg_two_tau * p.met[M_RDXDY][mi]);
      // post-step depth column; sshn, not ssh_new: ld kills land (with a
      // linear free surface it is stage 0's column, already in place)
      if (NT && FFS) s_aq[k] = HRP ? sshn * s_ld[k] + p.hrld[g]
                                   : (sshn + p.hr) * s_ld[k];
      if (ring > 1) continue;

      // momentum: (up*bp0 + grx)/bp with the bp metric factor cancelled
      const float u = s_u[k], up = EIN || !FIRST ? e_up[k]
                                  : Pl::UVP ? x_up[k] : f.up[g];
      const float v = s_v[k], vp = EIN || !FIRST ? e_vp[k]
                                  : Pl::UVP ? x_vp[k] : f.vp[g];
      float un = 0.f, vn = 0.f;
      // this cell in the small stress planes (viscous forms)
      const int j = (a - (WH - VH)) * VW + (b - (WH - VH));
      if (wlcu) {
        const float hu = s_hu[k];
        const float hup = !FFS ? hu : SHARE_B ? s_aqp[k]
            : (s_aqp[k] + s_aqp[k + S]) * (Pl::RUV ? x_ru[k] : rslu_u[g]);
        float slx = (s_ssh[k + S] - ssh) * hu * p.neg_g;
        // stress divergence: d(a2)/dx / dyh + d(D2)/dy / dxt
        if (VISC)
          slx += (s_a2[j + VW] - s_a2[j]) * p.met[M_RDYH][mi]
              + (s_d2[j] - s_d2[j - 1]) * p.met[M_RDXT][mi];
        const float acx = TRANS ? (s_cx[k] + s_rx[k - W]) + s_f[k - S]
                                : s_rx[k] + s_rx[k - W];
        const float grx = slx + acx;
        un = (up * hup + grx * (p.two_tau * p.met[M_RDXT][mi])) / hu;
        if (SHARE_A) s_hu[k] = p.ts1 * hu + p.ts2 * hup;   // for step B
      }
      if (wlcv) {
        const float hv = s_hv[k];
        const float hvp = !FFS ? hv : SHARE_B ? sw[S_SSH * PLANE + k]
            : (s_aqp[k] + s_aqp[k + W]) * (Pl::RUV ? x_rv[k] : rslu_v[g]);
        float sly = (s_ssh[k + W] - ssh) * hv * p.neg_g;
        if (VISC)
          sly += -(s_b2[j + 1] - s_b2[j]) * p.met[M_RDXH][mi]
              + (s_e2[j] - s_e2[j - VW]) * p.met[M_RDYT][mi];
        const float acy = TRANS ? (s_cy[k] + s_sy[k - S]) + s_k[k - W]
                                : s_sy[k] + s_sy[k - S];
        const float gry = sly + acy;
        vn = (vp * hvp + gry * (p.two_tau * p.met[M_RDYT][mi])) / hv;
        if (SHARE_A) s_hv[k] = p.ts1 * hv + p.ts2 * hvp;
      }
      if (NT) { s_cx[k] = un; s_cy[k] = vn; }   // 0 off the u / v wet sets
      if (ring > 0) continue;
      if (LAST && RAW && !in_box(p, gx, gy)) continue;   // not our margin

      // leapfrog rotation + Robert-Asselin filter
      const float ssh_new = wlu ? sshn : ssh;
      const float sshp_new = wlu ? p.ts1 * ssh + p.ts2 * (sshn + sshp) : sshp;
      // elide_sel: un, vn are 0 off the u / v wet sets, where the carried
      // velocities are 0 too, so the selects are the identity
      const float u_new = ELIDE || wlcu ? un : u;
      const float up_new = ELIDE || wlcu ? p.ts1 * u + p.ts2 * (un + up) : up;
      const float v_new = ELIDE || wlcv ? vn : v;
      const float vp_new = ELIDE || wlcv ? p.ts1 * v + p.ts2 * (vn + vp) : vp;
      if (LAST) {
        f.ssh_o[g] = ssh_new;
        f.sshp_o[g] = sshp_new;
        if (NT && FFS) s_hu[k] = sshp_new;
        f.u_o[g] = u_new;
        f.up_o[g] = up_new;
        f.v_o[g] = v_new;
        f.vp_o[g] = vp_new;
      } else {
        e_ssh[k] = ssh_new; e_sshp[k] = sshp_new;
        s_u[k] = u_new; e_up[k] = up_new;
        s_v[k] = v_new; e_vp[k] = vp_new;
      }

      // the block's own cells of the box, at every step
      if ((OH == 0 || (a >= WH && a < WH + TX && b >= WH && b < WH + TY))
          && gx >= p.margin && gx < p.margin + p.nx
          && gy >= p.margin && gy < p.margin + p.ny)
        mx = nan_max(mx, fabsf(ssh_new));
    }
  }

  if (NT) {
    // The tracers in groups of G (all NT of a fixed count, MAX_TRACERS of
    // a run-time one): stages 4 and 5 per group, tracer t of a group
    // keeping its edge fluxes in S_F + 2 t and S_F + 2 t + 1 (F, K, Rx, Sy
    // are last read in stage 3). The transports uh, vh and the diffusive
    // weights kx, ky are the same for every tracer: a run-time count's
    // first group keeps them in S_HV, S_UD, S_VD, S_AQP (last read in
    // stage 3) for the later groups.
    constexpr int G = LOOP ? MAX_TRACERS : NT;
    const int ntr = LOOP ? p.n_tr : NT;
    float* s_aqn = s_aq;
    float* s_un = s_cx;
    float* s_vn = s_cy;
    // (step A of share_prev keeps its depths in S_HV: uh in S_SSH, dead
    // since stage 3, instead)
    float* s_uh = SHARE_A ? sw + S_SSH * PLANE : s_hv;
    float* s_vh = s_ud;
    float* s_kx = s_vd;
    float* s_ky = s_aqp;
    const float* s_sshp_new = LAST ? s_hu : e_sshp;
    for (int t0 = 0; t0 < ntr; t0 += G) {
      const int ng = LOOP ? min(G, ntr - t0) : G;   // tracers of the group
      __syncthreads();
      if constexpr (LD && Ld::NG4 > 0)
        if (t0 == 0) tma::bar_wait(&bars[G_TR], where.phase());

      // stage 4 (halo 1): post-step depths hun, hvn from aq_new, the
      // transports uh = u_new * hun, vh = v_new * hvn on the u / v wet
      // sets, and each tracer's centred advective edge fluxes, plus the
      // diffusive ones mu / dxt * hun * dff/dx when mu != 0
      {
        constexpr int h = OH + 1, w = TY + 2 * h, n = (TX + 2 * h) * w;
        for (int i = tid(); i < n; i += NTHREADS) {
          const int a = WH - h + i / w, b = WH - h + i % w;
          const int k = a * S + b, gx = x0() + a, gy = y0() + b;
          float uh, vh, kx = 0.f, ky = 0.f;  // kx, ky: mu / dxt * hun, ...
          if (!LOOP || t0 == 0) {
            const float aqn = s_aqn[k];
            const float hun = (aqn + s_aqn[k + S])
                * (Pl::RUV ? x_ru[k] : at(p, rslu_u, gx, gy));
            const float hvn = (aqn + s_aqn[k + W])
                * (Pl::RUV ? x_rv[k] : at(p, rslu_v, gx, gy));
            const bool wlu = s_ld[k] > 0.5f;
            const bool wlcu = wlu && s_ld[k + S] > 0.5f;
            const bool wlcv = wlu && s_ld[k + W] > 0.5f;
            uh = wlcu ? s_un[k] * hun : 0.f;
            vh = wlcv ? s_vn[k] * hvn : 0.f;
            if (DIFF && inside(p, gx, gy)) {
              const size_t mi = MET2D ? (size_t)gx * p.Ys + gy : (size_t)gy;
              // with q4 hun, hvn arrive quartered: 4 mu
              const float mu = Q4 ? 4.f * p.mu : p.mu;
              kx = (mu * p.met[M_RDXT][mi]) * (wlcu ? hun : 0.f);
              ky = (mu * p.met[M_RDYT][mi]) * (wlcv ? hvn : 0.f);
            }
            if (LOOP) {
              s_uh[k] = uh; s_vh[k] = vh;
              if (DIFF) { s_kx[k] = kx; s_ky[k] = ky; }
            }
          } else {
            uh = s_uh[k]; vh = s_vh[k];
            if (DIFF) { kx = s_kx[k]; ky = s_ky[k]; }
          }
#pragma unroll
          for (int t = 0; t < G; ++t) {
            if (LOOP && t >= ng) break;
            const int l = 2 * (t0 + t);
            float ff, ffx, ffy;
            if (FIRST && !TRE && !TRX) {
              const float* ffg = tr_in<NT>(f, l);
              ff = at(p, ffg, gx, gy);
              ffx = at(p, ffg, gx + 1, gy);
              ffy = at(p, ffg, gx, gy + 1);
            } else {
              // step A's levels, or this step's by TMA
              const float* e = TRX ? x_tr + l * PLANE
                                   : chain_level<NT, PLANE>(p, e_tr, l, where);
              ff = e[k]; ffx = e[k + S]; ffy = e[k + W];
            }
            float fx = uh * ((ff + ffx) * ADV);
            float fy = vh * ((ff + ffy) * ADV);
            if (DIFF) { fx += kx * (ffx - ff); fy += ky * (ffy - ff); }
            sw[(S_F + 2 * t) * PLANE + k] = fx;
            sw[(S_F + 2 * t + 1) * PLANE + k] = fy;
          }
        }
      }
      __syncthreads();

      // stage 5 (halo 0): leapfrog update from the flux divergence,
      // rotation + Robert-Asselin filter, the group's 2 ng tracer outputs
      constexpr int h = OH, w = TY + 2 * h, n = (TX + 2 * h) * w;
      for (int i = tid(); i < n; i += NTHREADS) {
        const int a = WH - h + i / w, b = WH - h + i % w;
        const int k = a * S + b, gx = x0() + a, gy = y0() + b;
        if (!inside(p, gx, gy)) {
          if (!LAST) {
#pragma unroll
            for (int t = 0; t < 2 * G; ++t) {
              if (LOOP && t >= 2 * ng) break;
              chain_level<NT, PLANE>(p, e_tr, 2 * t0 + t, where)[k] = 0.f;
            }
          }
          continue;
        }
        if (LAST && RAW && !in_box(p, gx, gy)) continue;
        const size_t g = (size_t)gx * p.Ys + gy;
        const bool wlu = s_ld[k] > 0.5f;
        // bp = hhq_n*area, bp0 = hhq_p*area with hhq_n = hr,
        // hhq_p = hr + sshp_new (hr with a linear free surface),
        // area = dx*dy / (2 tau)
        const size_t mi = MET2D ? g : (size_t)gy;
        const float area = (p.met[M_DX][mi] * p.met[M_DY][mi])
            * p.inv_two_tau;
        const float hr = HRP ? p.hrp[g] : p.hr;
        const float bp = hr * area;
        const float bp0 = FFS ? (hr + s_sshp_new[k]) * area : bp;
#pragma unroll
        for (int t = 0; t < G; ++t) {
          if (LOOP && t >= ng) break;
          const int l = 2 * (t0 + t);
          const float* fx = sw + (S_F + 2 * t) * PLANE;
          const float* fy = sw + (S_F + 2 * t + 1) * PLANE;
          float* e0 = FIRST && LAST ? (TRX ? x_tr + l * PLANE : nullptr)
              : chain_level<NT, PLANE>(p, e_tr, l, where);
          float* e1 = FIRST && LAST ? (TRX ? x_tr + (l + 1) * PLANE : nullptr)
              : chain_level<NT, PLANE>(p, e_tr, l + 1, where);
          const float ff = FIRST && !TRE && !TRX ? tr_in<NT>(f, l)[g] : e0[k];
          const float ffp = FIRST && !TRE && !TRX ? tr_in<NT>(f, l + 1)[g]
                                                  : e1[k];
          float ffn = 0.f;
          if (wlu) {
            const float rhs = ((fx[k] - fx[k - S]) + fy[k]) - fy[k - W];
            ffn = (bp0 * ffp + rhs) / bp;
          }
          const float ff_new = ELIDE || wlu ? ffn : ff;
          const float ffp_new = ELIDE || wlu ? p.ts1 * ff + p.ts2 * (ffn + ffp)
                                             : ffp;
          if (LAST) {
            tr_out<NT>(p, f, l)[g] = ff_new;
            tr_out<NT>(p, f, l + 1)[g] = ffp_new;
          } else {
            e0[k] = ff_new;
            e1[k] = ffp_new;
          }
        }
      }
    }
  }
}

// the general form's metric rows: the profile's rows 0-15, or its 16
// planes, at their own index (ops/fused_layout.py row meanings)
enum {
  G_DX, G_DY, G_DXT, G_DYT, G_DXH, G_DYH, G_DXB, G_DYB, G_RLH,
  G_RDXDY, G_RDXT, G_RDYT, G_RDXH, G_RDYH, G_RDXB, G_RDYB,
  N_GEN_MET
};
static_assert(N_GEN_MET <= N_MET, "Params holds the general form's rows");

// The reciprocal wet counts of the general form's depth interpolations at
// window cell k (array cell g, inside the array): with static planes
// (p.hrld) their values, else the TPU kernel's selects on the wet-
// neighbour sums of the lu window s_lu (row stride S, column stride 1).
__device__ __forceinline__ float gen_rcp_u(const Params& p, const float* s_lu,
                                           int k, int g, int S) {
  return p.hrld ? p.hrld[g] : (s_lu[k] + s_lu[k + S] > 1.5f ? 0.5f : 1.f);
}

__device__ __forceinline__ float gen_rcp_v(const Params& p, const float* s_lu,
                                           int k, int g, int plane) {
  return p.hrld ? p.hrld[plane + g]
                : (s_lu[k] + s_lu[k + 1] > 1.5f ? 0.5f : 1.f);
}

__device__ __forceinline__ float gen_rcp_h(const Params& p, const float* s_lu,
                                           int k, int g, int plane,
                                           int S) {
  if (p.hrld) return p.hrld[2 * plane + g];
  const float slu = ((s_lu[k] + s_lu[k + S]) + s_lu[k + 1]) + s_lu[k + S + 1];
  return slu > 3.5f ? 0.25f
       : slu > 2.5f ? 1.f / 3.f
       : slu > 1.5f ? 0.5f : 1.f;
}

// One model step of the general form (see the file's head), with the
// stages, regions and chained-step bookkeeping of sw_step. Its use of the
// 16 window planes:
//   S_LD <- lu; S_AQ <- aq; S_UD, S_VD <- the mass fluxes u*hhu*dyh,
//   v*hhv*dxh; S_F, S_K, S_RX, S_SY <- the viscous forms' up/dyh, vp/dxh,
//   up/dxt, vp/dyt between stage 1 and the stress stage, as in sw_step;
//   stage 2's edge terms F -> S_F, G -> S_HU, K -> S_K, L -> S_HV, the
//   vorticity terms H -> S_RX, M -> S_SY, the Coriolis terms Cv -> S_CX,
//   Cu -> S_CY; the tracer pass: aq_new -> S_AQP (a linear free surface
//   keeps S_AQ), un, vn -> S_U, S_V, its flux planes and a run-time
//   count's shared uh, vh, kx, ky -> S_HU, S_HV, S_CX, S_CY.
// Under a Where with TMA, the forms GenPlan moves bring their windows in by
// TMA (load_gen_windows; maps, the block's N_GROUPS mbarriers bars; sm
// 128-byte aligned), the arithmetic unchanged: the same bits.
template <int NT, bool MET2D, int MU, bool RAW, bool TRANS, bool FFS,
          int STEPS, int STEP, class FieldsT, class Where, class MapsT = Maps>
__device__ __forceinline__ void sw_step_gen(const Params& p, const FieldsT& f,
                                            float* sm, float& mx,
                                            const Where& where,
                                            const MapsT* maps = nullptr,
                                            uint64_t* bars = nullptr) {
  using GP = GenPlan<NT, STEPS, MU == 2>;
  constexpr bool USE_TMA = Where::TMA && GP::ON;
  using Fm = Form<NT, STEPS, USE_TMA>;
  constexpr int HALO = Fm::HALO, EXTRA = Fm::EXTRA, WH = Fm::WH;
  constexpr int TX = Fm::TX, TY = Fm::TY;
  constexpr int NTHREADS = Tile<STEPS>::NTHREADS;
  constexpr int WY = Fm::WY, PLANE = Fm::PLANE;
  constexpr bool VISC = MU == 2;            // stress stages
  constexpr bool DIFF = NT != 0 && MU != 0; // tracers' diffusive fluxes
  constexpr bool LOOP = NT < 0;             // a run-time tracer count
  constexpr bool FIRST = STEP == 0, LAST = STEP == STEPS - 1;
  constexpr int OH = HALO * (STEPS - 1 - STEP);   // this step's output halo
  constexpr int VH = OH + Fm::VH, VW = TY + 2 * VH, VN = (TX + 2 * VH) * VW;
  // the loader: LD, this step's window came by TMA; HRX, hr in a plane of
  // its own
  constexpr bool LD = USE_TMA && FIRST, HRX = USE_TMA && GP::HR;

  const int tid0 = where.thread();
  const auto tid = [&] { return where.thread(tid0); };
  // the window planes: under the loader R columns into each plane, where
  // its box begins on a multiple of 16 bytes (fused_tile.cuh)
  float* sw = sm + Fm::R;
  const auto at_plane = [&](int s) {
    return sw + gen_plane<NT, USE_TMA>(s) * PLANE;
  };
  float* s_ssh = at_plane(FIRST ? S_SSH : E_SSH);
  float* s_u = at_plane(S_U);
  float* s_v = at_plane(S_V);
  float* s_lu = at_plane(S_LD);
  float* s_aq = at_plane(S_AQ);
  float* s_aqn = at_plane(FFS ? S_AQP : S_AQ);   // tracers' column
  float* s_ud = at_plane(S_UD);
  float* s_vd = at_plane(S_VD);
  float* s_ef = at_plane(S_F);              // F   (viscous: up/dyh first)
  float* s_ek = at_plane(S_K);              // K   (vp/dxh)
  float* s_eh = at_plane(S_RX);             // H   (up/dxt)
  float* s_em = at_plane(S_SY);             // M   (vp/dyt)
  float* s_eg = at_plane(S_HU);             // G
  float* s_el = at_plane(S_HV);             // L
  float* s_cv = at_plane(S_CX);             // Cv
  float* s_cu = at_plane(S_CY);             // Cu
  const float* x_hr = sw + GP::P_HR * PLANE;   // hr's own plane (HRX)
  const int n_win = LOOP && STEPS > 1 ? Fm::N_BASE + p.n_lev_sm : GP::N_WIN;
  float* s_a2 = sm + n_win * PLANE + V_A2 * Fm::VPLANE;   // viscous
  float* s_b2 = sm + n_win * PLANE + V_B2 * Fm::VPLANE;   // forms only
  float* s_d2 = sm + n_win * PLANE + V_D2 * Fm::VPLANE;
  float* s_e2 = sm + n_win * PLANE + V_E2 * Fm::VPLANE;
  float* e_ssh = at_plane(E_SSH);
  float* e_sshp = at_plane(E_SSHP);
  float* e_up = at_plane(E_UP);
  float* e_vp = at_plane(E_VP);
  float* e_tr = at_plane(E_TR);             // see chain_level

  // global row of window row 0, global column of window column 0
  const int2 org = where.template origin<TX, TY, WH>();
  const auto x0 = [&] { return where.template x0<TX, TY, WH>(org); };
  const auto y0 = [&] { return where.template y0<TX, TY, WH>(org); };
  const int plane = p.Xs * p.Ys;
  const float* lu = p.planes;
  const float* hr = p.hrp;
  const int W = 1;                          // one window row/col offset
  const int S = WY;                         // window row stride
  // a metric row's index of array cell g in column gy
  auto mix = [&](int g, int gy) { return MET2D ? g : gy; };

  // stage 0 (halo 3 + EXTRA): load the window; aq = (hr + ssh * ffs) *
  // (dx * dy) * lu. A later step of a chained launch forms aq anew from
  // the previous step's ssh (the static column of a linear free surface
  // stays from the first)
  if (FIRST && LD) {
    // every box in flight at once; hr in its plane, or in S_AQ, which this
    // cell's column overwrites. Each thread's cell areas are loaded while
    // the boxes land (metric planes are as many bytes as the fields).
    if (tid() == 0)
      load_gen_windows<NT, STEPS, MU == 2, Where::INIT>(*maps, sm, bars,
                                                        x0(), y0());
    if (Where::INIT) __syncthreads();
    constexpr int NI = (Fm::CELLS + NTHREADS - 1) / NTHREADS;
    float area[NI];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int i = tid() + j * NTHREADS;
      const int gx = x0() + i / WY, gy = y0() + i % WY;
      area[j] = 0.f;
      if (i < Fm::CELLS && inside(p, gx, gy)) {
        const int mi = mix(gx * p.Ys + gy, gy);
        area[j] = p.met[G_DX][mi] * p.met[G_DY][mi];
      }
    }
    tma::bar_wait(&bars[G_S0], where.phase());
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int i = tid() + j * NTHREADS;
      if (i >= Fm::CELLS) break;
      const int gx = x0() + i / WY, gy = y0() + i % WY;
      float aq = 0.f;
      if (inside(p, gx, gy)) {
        const float h = HRX ? x_hr[i] : s_aq[i];
        aq = ((FFS ? h + s_ssh[i] : h) * area[j]) * s_lu[i];
      }
      s_aq[i] = aq;
    }
    __syncthreads();
  } else if (FIRST) {
    for (int i = tid(); i < Fm::CELLS; i += NTHREADS) {
      const int gx = x0() + i / WY, gy = y0() + i % WY;
      float ssh = 0.f, u = 0.f, v = 0.f, l = 0.f, aq = 0.f;
      if (inside(p, gx, gy)) {
        const int g = gx * p.Ys + gy, mi = mix(g, gy);
        ssh = f.ssh[g]; u = f.u[g]; v = f.v[g]; l = lu[g];
        aq = ((FFS ? hr[g] + ssh : hr[g])
              * (p.met[G_DX][mi] * p.met[G_DY][mi])) * l;
      }
      s_ssh[i] = ssh; s_u[i] = u; s_v[i] = v; s_lu[i] = l; s_aq[i] = aq;
    }
    __syncthreads();
  } else if (FFS) {
    constexpr int h = OH + HALO, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      float aq = 0.f;
      if (inside(p, gx, gy)) {
        const int g = gx * p.Ys + gy, mi = mix(g, gy);
        aq = (((HRX ? x_hr[k] : hr[g]) + s_ssh[k])
              * (p.met[G_DX][mi] * p.met[G_DY][mi])) * s_lu[k];
      }
      s_aq[k] = aq;
    }
    __syncthreads();
  }

  // stage 1 (halo 2 + EXTRA): the depth interps hhu, hhv and the mass
  // fluxes; with viscosity the previous-level velocities over their
  // metrics (by TMA in S_F, S_K, which this cell's products overwrite)
  {
    if constexpr (LD && MU == 2) tma::bar_wait(&bars[G_S1], where.phase());
    constexpr int h = OH + 2 + EXTRA, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      float ud = 0.f, vd = 0.f;
      if (inside(p, gx, gy)) {
        const int g = gx * p.Ys + gy, mi = mix(g, gy);
        const float hu = ((s_aq[k] + s_aq[k + S])
                          * gen_rcp_u(p, s_lu, k, g, S))
            * (p.met[G_RDXT][mi] * p.met[G_RDYH][mi]);
        const float hv = ((s_aq[k] + s_aq[k + W])
                          * gen_rcp_v(p, s_lu, k, g, plane))
            * (p.met[G_RDXH][mi] * p.met[G_RDYT][mi]);
        ud = (s_u[k] * hu) * p.met[G_DYH][mi];
        vd = (s_v[k] * hv) * p.met[G_DXH][mi];
        if (VISC) {
          const float up = LD ? s_ef[k] : FIRST ? f.up[g] : e_up[k];
          const float vp = LD ? s_ek[k] : FIRST ? f.vp[g] : e_vp[k];
          s_ef[k] = up * p.met[G_RDYH][mi];
          s_ek[k] = vp * p.met[G_RDXH][mi];
          s_eh[k] = up * p.met[G_RDXT][mi];
          s_em[k] = vp * p.met[G_RDYT][mi];
        }
      } else if (VISC) {
        s_ef[k] = 0.f; s_ek[k] = 0.f; s_eh[k] = 0.f; s_em[k] = 0.f;
      }
      s_ud[k] = ud; s_vd[k] = vd;
    }
  }
  __syncthreads();

  // stress stage (halo 1 + EXTRA, viscous forms): tension at T points,
  // shear at H points, and their four products with mu, the depth and the
  // squared metrics of the cell
  if (VISC) {
    constexpr int h = VH, n = VN;
    const float* s_q = s_ef;
    const float* s_r = s_ek;
    const float* s_s1 = s_eh;
    const float* s_s2 = s_em;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / VW, b = WH - h + i % VW;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      float a2 = 0.f, b2 = 0.f, d2 = 0.f, e2 = 0.f;
      if (inside(p, gx, gy)) {
        const int g = gx * p.Ys + gy, mi = mix(g, gy);
        const float l0 = s_lu[k];
        const bool wluu = ((l0 * s_lu[k + S]) * s_lu[k + W])
            * s_lu[k + S + W] > 0.5f;
        const float dx = p.met[G_DX][mi], dy = p.met[G_DY][mi];
        const float dxb = p.met[G_DXB][mi], dyb = p.met[G_DYB][mi];
        if (l0 > 0.5f) {
          const float str_t = (dy / dx) * (s_q[k] - s_q[k - S])
              - (dx / dy) * (s_r[k] - s_r[k - W]);
          const float hq = HRX ? x_hr[k] : hr[g];
          const float t2 = (FFS ? hq + s_ssh[k] : hq) * str_t;
          a2 = (dy * dy * p.mu) * t2;
          b2 = (dx * dx * p.mu) * t2;
        }
        if (wluu) {
          const float hh = ((((s_aq[k] + s_aq[k + S]) + s_aq[k + W])
                             + s_aq[k + S + W])
                            * gen_rcp_h(p, s_lu, k, g, plane, S))
              * (p.met[G_RDXB][mi] * p.met[G_RDYB][mi]);
          const float str_s =
              (dxb * p.met[G_RDYB][mi]) * (s_s1[k + W] - s_s1[k])
              + (dyb * p.met[G_RDXB][mi]) * (s_s2[k + S] - s_s2[k]);
          const float hs2 = hh * str_s;
          d2 = (dxb * dxb * p.mu) * hs2;
          e2 = (dyb * dyb * p.mu) * hs2;
        }
      }
      s_a2[i] = a2; s_b2[i] = b2; s_d2[i] = d2; s_e2[i] = e2;
    }
    __syncthreads();
  }

  // stage 2 (halo 1 + EXTRA): hhh, the Coriolis terms, and with advection
  // the vorticity, the edge fluxes and the vorticity terms
  {
    constexpr int h = OH + 1 + EXTRA, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      float F = 0.f, G = 0.f, K = 0.f, L = 0.f, H = 0.f, Mv = 0.f;
      float cv = 0.f, cu = 0.f;
      if (inside(p, gx, gy)) {
        const int g = gx * p.Ys + gy, mi = mix(g, gy);
        const bool wluu = ((s_lu[k] * s_lu[k + S]) * s_lu[k + W])
            * s_lu[k + S + W] > 0.5f;
        const float hh = ((((s_aq[k] + s_aq[k + S]) + s_aq[k + W])
                           + s_aq[k + S + W])
                          * gen_rcp_h(p, s_lu, k, g, plane, S))
            * (p.met[G_RDXB][mi] * p.met[G_RDYB][mi]);
        const float u = s_u[k], v = s_v[k];
        const float ux = s_u[k + S], uy = s_u[k + W];
        const float vx = s_v[k + S], vy = s_v[k + W];
        const float s2u = uy + u, s2v = vx + v;
        const float corio =
            (p.met[G_RLH][mi] * p.met[G_DXB][mi] * p.met[G_DYB][mi]) * hh;
        cv = corio * s2v;
        cu = corio * s2u;
        if (TRANS) {
          float vort = 0.f;
          if (wluu) {      // every neighbour wet: inside the array
            const float vd_t = v * p.met[G_DYT][mi];
            const float vd_tx = vx * p.met[G_DYT][MET2D ? g + p.Ys : mi];
            const float ud_t = u * p.met[G_DXT][mi];
            const float ud_ty = uy * p.met[G_DXT][mi + 1];
            vort = ((vd_tx - vd_t) - (ud_ty - ud_t))
                - ((vx - v) * p.met[G_DYB][mi] - (uy - u) * p.met[G_DXB][mi]);
          }
          const float vorth = vort * hh;
          const float ud = s_ud[k], vd = s_vd[k];
          F = (ud + s_ud[k + S]) * (u + ux) * 0.25f;
          G = (vd + s_vd[k + S]) * s2u * (wluu ? 0.25f : 0.f);
          K = (vd + s_vd[k + W]) * (v + vy) * 0.25f;
          L = (ud + s_ud[k + W]) * s2v * 0.25f;
          H = vorth * s2v;
          Mv = vorth * s2u;
        }
      }
      if (TRANS) {
        s_ef[k] = F; s_eg[k] = G; s_ek[k] = K; s_el[k] = L;
        s_eh[k] = H; s_em[k] = Mv;
      }
      s_cv[k] = cv; s_cu[k] = cu;
    }
  }
  __syncthreads();

  // stage 3: continuity, momentum, leapfrog + filter, the 6 SW outputs
  // (halo 0). With tracers the continuity runs at halo 2 and the momentum
  // at halo 1, and they leave aq_new, un and vn in shared memory. Step A
  // of a chained launch keeps its outputs (halo 3 + EXTRA) in shared
  // memory, zeros outside the array, and computes the raw form's margin
  // too. Three passes, each field stored as soon as it is known: (a) the
  // continuity and ssh, (b) u, (c) v. None reads what another writes, so
  // no barrier parts them; apart, each holds few enough values that the
  // one-step forms keep their 40 registers without spilling.
  // distance of window cell (a, b) beyond this step's output region: 0
  // inside it
  auto ring_of = [&](int a, int b) {
    return !NT ? 0
        : max(max(WH - OH - a, a - (WH + OH + TX - 1)),
              max(max(WH - OH - b, b - (WH + OH + TY - 1)), 0));
  };
  {
    constexpr int h = OH + 2 * EXTRA, w = TY + 2 * h, n = (TX + 2 * h) * w;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      const int ring = ring_of(a, b);
      if (!inside(p, gx, gy)) {
        if (NT && FFS) s_aqn[k] = 0.f;
        if (!LAST && ring == 0) {
          e_ssh[k] = 0.f; e_sshp[k] = 0.f; e_up[k] = 0.f; e_vp[k] = 0.f;
        }
        continue;
      }
      const int g = gx * p.Ys + gy, mi = mix(g, gy);
      const float ssh = s_ssh[k], sshp = FIRST ? f.sshp[g] : e_sshp[k];
      const float l0 = s_lu[k];
      const bool wlu = l0 > 0.5f;

      // continuity: sshn = sshp - 2 tau div(flux) / (dx dy) on the wet set
      const float div = ((s_ud[k] - s_ud[k - S]) + s_vd[k]) - s_vd[k - W];
      const float sshn = wlu ? sshp - p.two_tau * (div * p.met[G_RDXDY][mi])
                             : 0.f;
      // post-step depth column from the new ssh
      if (NT && FFS)
        s_aqn[k] = (((HRX ? x_hr[k] : hr[g]) + (wlu ? sshn : ssh))
                    * (p.met[G_DX][mi] * p.met[G_DY][mi])) * l0;
      if (ring > 0) continue;
      if (LAST && RAW && !in_box(p, gx, gy)) continue;   // not our margin

      // leapfrog rotation + Robert-Asselin filter
      const float ssh_new = wlu ? sshn : ssh;
      const float sshp_new = wlu ? p.ts1 * ssh + p.ts2 * (sshn + sshp) : sshp;
      if (LAST) {
        f.ssh_o[g] = ssh_new;
        f.sshp_o[g] = sshp_new;
      } else {
        e_ssh[k] = ssh_new; e_sshp[k] = sshp_new;
      }
      // the block's own cells of the box, at every step
      if ((OH == 0 || (a >= WH && a < WH + TX && b >= WH && b < WH + TY))
          && gx >= p.margin && gx < p.margin + p.nx
          && gy >= p.margin && gy < p.margin + p.ny)
        mx = nan_max(mx, fabsf(ssh_new));
    }
  }
  // (b), (c): momentum, (up*bp0 + gr) / bp with bp = hhu * dxt*dyh /
  // (2 tau), then the rotation and filter of u, and of v. Y selects v.
  // The previous-level column at cell k + d (array cell g + dg, its metric
  // row index mi + dm) comes from sshp and hr, as stage 0 forms aq.
  auto momentum = [&](auto y_pass) {
    constexpr bool Y = decltype(y_pass)::value;
    constexpr int h = OH + EXTRA, w = TY + 2 * h, n = (TX + 2 * h) * w;
    const int D = Y ? W : S;                  // the cell x + 1 or y + 1
    float* s_c = Y ? s_v : s_u;               // the component
    float* e_cp = Y ? e_vp : e_up;            // its previous level
    const float* cp_g = Y ? f.vp : f.up;
    float* c_o = Y ? f.v_o : f.u_o;
    float* cp_o = Y ? f.vp_o : f.up_o;
    for (int i = tid(); i < n; i += NTHREADS) {
      const int a = WH - h + i / w, b = WH - h + i % w;
      const int k = a * S + b, gx = x0() + a, gy = y0() + b;
      if (!inside(p, gx, gy)) continue;
      const int g = gx * p.Ys + gy, mi = mix(g, gy);
      const int dg = Y ? 1 : p.Ys, dm = Y || MET2D ? dg : 0;
      const bool wet = s_lu[k] * s_lu[k + D] > 0.5f;   // wlcu / wlcv
      const float c = s_c[k], cp = FIRST ? cp_g[g] : e_cp[k];
      float cn = 0.f;
      if (wet) {          // the cell k + D is wet: inside the array
        auto aqp = [&](int d, int eg, int em) {
          const float sp = FIRST ? f.sshp[g + eg] : e_sshp[k + d];
          return (((HRX ? x_hr[k + d] : hr[g + eg]) + sp)
                  * (p.met[G_DX][mi + em] * p.met[G_DY][mi + em]))
              * s_lu[k + d];
        };
        // this cell in the small stress planes (viscous forms)
        const int j = (a - (WH - VH)) * VW + (b - (WH - VH));
        const float r = Y ? gen_rcp_v(p, s_lu, k, g, plane)
                          : gen_rcp_u(p, s_lu, k, g, S);
        const float mt = Y ? p.met[G_RDXH][mi] * p.met[G_RDYT][mi]
                           : p.met[G_RDXT][mi] * p.met[G_RDYH][mi];
        const float hc = ((s_aq[k] + s_aq[k + D]) * r) * mt;
        const float hcp = FFS ? ((aqp(0, 0, 0) + aqp(D, dg, dm)) * r) * mt
                              : hc;
        // the metric across the face: dyh for u, dxh for v
        const float mf = p.met[Y ? G_DXH : G_DYH][mi];
        const float bpm = (Y ? p.met[G_DYT][mi] * mf : p.met[G_DXT][mi] * mf)
            * p.inv_two_tau;
        float gr = (s_ssh[k + D] - s_ssh[k]) * hc * (mf * p.neg_g);
        if (Y) {
          if (VISC)
            gr = gr + (-(s_b2[j + 1] - s_b2[j]) * p.met[G_RDXH][mi]
                       + (s_e2[j] - s_e2[j - VW]) * p.met[G_RDYT][mi]);
          if (TRANS)
            gr = gr + (-(((s_el[k] - s_el[k - S]) + s_ek[k]) - s_ek[k - W])
                       - (s_em[k] + s_em[k - S]) * 0.25f);
          gr = gr - (s_cu[k] + s_cu[k - S]) * 0.25f;
        } else {
          if (VISC)
            gr = gr + ((s_a2[j + VW] - s_a2[j]) * p.met[G_RDYH][mi]
                       + (s_d2[j] - s_d2[j - 1]) * p.met[G_RDXT][mi]);
          if (TRANS)
            gr = gr + (-(((s_ef[k] - s_ef[k - S]) + s_eg[k]) - s_eg[k - W])
                       + (s_eh[k] + s_eh[k - W]) * 0.25f);
          gr = gr + (s_cv[k] + s_cv[k - W]) * 0.25f;
        }
        cn = (cp * (hcp * bpm) + gr) / (hc * bpm);
      }
      if (NT) s_c[k] = cn;      // 0 off the wet set
      if (ring_of(a, b) > 0) continue;
      if (LAST && RAW && !in_box(p, gx, gy)) continue;   // not our margin
      const float c_new = wet ? cn : c;
      const float cp_new = wet ? p.ts1 * c + p.ts2 * (cn + cp) : cp;
      if (LAST) { c_o[g] = c_new; cp_o[g] = cp_new; }
      else { s_c[k] = c_new; e_cp[k] = cp_new; }
    }
  };
  momentum(std::false_type{});
  momentum(std::true_type{});

  if (NT) {
    // The tracers in groups of G, as in sw_step. The transports uh = un *
    // hhun, vh = vn * hhvn and the diffusive weights kx, ky are the same
    // for every tracer: a run-time count's first group keeps them in
    // S_HU, S_HV, S_CX, S_CY (last read in stage 3) for the later groups.
    constexpr int G = LOOP ? MAX_TRACERS : NT;
    const int ntr = LOOP ? p.n_tr : NT;
    float* s_uh = at_plane(S_HU);
    float* s_vh = at_plane(S_HV);
    float* s_kx = at_plane(S_CX);
    float* s_ky = at_plane(S_CY);
    for (int t0 = 0; t0 < ntr; t0 += G) {
      const int ng = LOOP ? min(G, ntr - t0) : G;   // tracers of the group
      __syncthreads();

      // stage 4 (halo 1): post-step depths hhun, hhvn from aq_new, the
      // transports on the u / v wet sets, and each tracer's centred
      // advective edge fluxes with their dyh, dxh, plus the diffusive
      // ones mu * dyh/dxt * hhun * dff/dx when mu != 0
      {
        constexpr int h = OH + 1, w = TY + 2 * h, n = (TX + 2 * h) * w;
        for (int i = tid(); i < n; i += NTHREADS) {
          const int a = WH - h + i / w, b = WH - h + i % w;
          const int k = a * S + b, gx = x0() + a, gy = y0() + b;
          const float l0 = s_lu[k];
          const bool wlcu = l0 * s_lu[k + S] > 0.5f;
          const bool wlcv = l0 * s_lu[k + W] > 0.5f;
          float uh = 0.f, vh = 0.f, kx = 0.f, ky = 0.f;
          float cx = 0.f, cy = 0.f;          // dyh * -1/2, dxh * -1/2
          if (inside(p, gx, gy)) {
            const int g = gx * p.Ys + gy, mi = mix(g, gy);
            cx = p.met[G_DYH][mi] * -0.5f;
            cy = p.met[G_DXH][mi] * -0.5f;
            if (!LOOP || t0 == 0) {
              const float aqn = s_aqn[k];
              const float hun = ((aqn + s_aqn[k + S])
                                 * gen_rcp_u(p, s_lu, k, g, S))
                  * (p.met[G_RDXT][mi] * p.met[G_RDYH][mi]);
              const float hvn = ((aqn + s_aqn[k + W])
                                 * gen_rcp_v(p, s_lu, k, g, plane))
                  * (p.met[G_RDXH][mi] * p.met[G_RDYT][mi]);
              uh = s_u[k] * hun;
              vh = s_v[k] * hvn;
              if (DIFF) {
                kx = (p.mu * (p.met[G_DYH][mi] * p.met[G_RDXT][mi])) * hun;
                ky = (p.mu * (p.met[G_DXH][mi] * p.met[G_RDYT][mi])) * hvn;
              }
              if (LOOP) {
                s_uh[k] = uh; s_vh[k] = vh;
                if (DIFF) { s_kx[k] = kx; s_ky[k] = ky; }
              }
            } else {
              uh = s_uh[k]; vh = s_vh[k];
              if (DIFF) { kx = s_kx[k]; ky = s_ky[k]; }
            }
          }
#pragma unroll
          for (int t = 0; t < G; ++t) {
            if (LOOP && t >= ng) break;
            const int l = 2 * (t0 + t);
            float ff, ffx, ffy;
            if (FIRST) {
              const float* ffg = tr_in<NT>(f, l);
              ff = at(p, ffg, gx, gy);
              ffx = at(p, ffg, gx + 1, gy);
              ffy = at(p, ffg, gx, gy + 1);
            } else {
              const float* e = chain_level<NT, PLANE>(p, e_tr, l, where);
              ff = e[k]; ffx = e[k + S]; ffy = e[k + W];
            }
            float fx = 0.f, fy = 0.f;
            if (wlcu) {
              fx = uh * (ff + ffx) * cx;
              if (DIFF) fx = fx + kx * (ffx - ff);
            }
            if (wlcv) {
              fy = vh * (ff + ffy) * cy;
              if (DIFF) fy = fy + ky * (ffy - ff);
            }
            at_plane(S_F + 2 * t)[k] = fx;
            at_plane(S_F + 2 * t + 1)[k] = fy;
          }
        }
      }
      __syncthreads();

      // stage 5 (halo 0): leapfrog update from the flux divergence,
      // rotation + Robert-Asselin filter, the group's 2 ng tracer outputs
      constexpr int h = OH, w = TY + 2 * h, n = (TX + 2 * h) * w;
      for (int i = tid(); i < n; i += NTHREADS) {
        const int a = WH - h + i / w, b = WH - h + i % w;
        const int k = a * S + b, gx = x0() + a, gy = y0() + b;
        if (!inside(p, gx, gy)) {
          if (!LAST) {
#pragma unroll
            for (int t = 0; t < 2 * G; ++t) {
              if (LOOP && t >= 2 * ng) break;
              chain_level<NT, PLANE>(p, e_tr, 2 * t0 + t, where)[k] = 0.f;
            }
          }
          continue;
        }
        if (LAST && RAW && !in_box(p, gx, gy)) continue;
        const int g = gx * p.Ys + gy, mi = mix(g, gy);
        const bool wlu = s_lu[k] > 0.5f;
        // bp = hhq_n*area, bp0 = hhq_p*area with hhq_n = hr,
        // hhq_p = hr + sshp_new * ffs, area = dx*dy / (2 tau); the new
        // sshp is this step's output
        const float area = p.met[G_DX][mi] * p.met[G_DY][mi] * p.inv_two_tau;
        const float hrc = HRX ? x_hr[k] : hr[g];
        const float bp = hrc * area;
        const float bp0 = FFS ? (hrc + (LAST ? f.sshp_o[g] : e_sshp[k]))
                                    * area
                              : bp;
        // one tracer at a time: unrolled, the group's loads together
        // spill the raw two-tracer forms past their 40 registers
#pragma unroll 1
        for (int t = 0; t < G; ++t) {
          if (LOOP && t >= ng) break;
          const int l = 2 * (t0 + t);
          const float* fx = at_plane(S_F + 2 * t);
          const float* fy = at_plane(S_F + 2 * t + 1);
          float* e0 = FIRST && LAST
              ? nullptr : chain_level<NT, PLANE>(p, e_tr, l, where);
          float* e1 = FIRST && LAST
              ? nullptr : chain_level<NT, PLANE>(p, e_tr, l + 1, where);
          const float ff = FIRST ? tr_in<NT>(f, l)[g] : e0[k];
          const float ffp = FIRST ? tr_in<NT>(f, l + 1)[g] : e1[k];
          float ffn = 0.f;
          if (wlu) {
            const float rhs = ((fx[k] - fx[k - S]) + fy[k]) - fy[k - W];
            ffn = (bp0 * ffp + rhs) / bp;
          }
          const float ff_new = wlu ? ffn : ff;
          const float ffp_new = wlu ? p.ts1 * ff + p.ts2 * (ffn + ffp) : ffp;
          if (LAST) {
            tr_out<NT>(p, f, l)[g] = ff_new;
            tr_out<NT>(p, f, l + 1)[g] = ffp_new;
          } else {
            e0[k] = ff_new;
            e1[k] = ffp_new;
          }
        }
      }
    }
  }
}

// The body of a launch: the guard, one or two steps of the tile, the
// block max. FOLD: the fast form's folds (0: none); maps: the fast form's
// tensor maps (the loader).
template <int NT, bool GUARD, bool MET2D, int MU, bool HRP, bool RAW,
          bool TRANS, bool FFS, int STEPS, bool GEN, int FOLD>
__device__ __forceinline__ void step_launch(const Params& p,
                                            const Maps* maps) {
  static_assert(STEPS == 1 || STEPS == 2, "one or two steps a launch");
  static_assert(!GEN || FOLD == 0, "the folds are the fast form's");
  constexpr int TX = Tile<STEPS>::TX, TY = Tile<STEPS>::TY;
  constexpr int NTHREADS = Tile<STEPS>::NTHREADS, NWARPS = NTHREADS / 32;

  const int tid = threadIdx.x;

  if (GUARD) {
    const int bid = blockIdx.y * gridDim.x + blockIdx.x;
    // all-land tile: exact zeros, no loads; the whole block takes this
    // branch (one flag per block) before any barrier
    if (p.tile_wet[bid] == 0) {
      for (int i = tid; i < TX * TY; i += NTHREADS) {
        const int gx = blockIdx.y * TX + i / TY;
        const int gy = blockIdx.x * TY + i % TY;
        if (!inside(p, gx, gy)) continue;
        if (RAW && !in_box(p, gx, gy)) continue;
        const size_t g = (size_t)gx * p.Ys + gy;
        p.ssh_o[g] = 0.f; p.sshp_o[g] = 0.f;
        p.u_o[g] = 0.f; p.up_o[g] = 0.f;
        p.v_o[g] = 0.f; p.vp_o[g] = 0.f;
        if constexpr (NT >= 0) {
#pragma unroll
          for (int t = 0; t < 2 * NT; ++t) p.tr_o[t][g] = 0.f;
        } else {
          for (int t = 0; t < 2 * p.n_tr; ++t) tr_out<NT>(p, p, t)[g] = 0.f;
        }
      }
      if (tid == 0) p.blockmax[bid] = 0.f;
      return;
    }
  }

  extern __shared__ float sm[];
  __shared__ float s_red[NWARPS];

  float mx = 0.f;
  if constexpr (GEN && GenPlan<NT, STEPS, MU == 2>::ON) {
    // the loader's barriers; its boxes land at 128-byte boundaries
    __shared__ uint64_t s_bar[N_GROUPS];
    float* sma = tma::align128(sm);
    sw_step_gen<NT, MET2D, MU, RAW, TRANS, FFS, STEPS, 0>(
        p, p, sma, mx, BlockTile{}, maps, s_bar);
    if constexpr (STEPS > 1) {
      __syncthreads();     // step A's outputs are in shared memory
      sw_step_gen<NT, MET2D, MU, RAW, TRANS, FFS, STEPS, 1>(
          p, p, sma, mx, BlockTile{}, maps, s_bar);
    }
  } else if constexpr (GEN) {
    sw_step_gen<NT, MET2D, MU, RAW, TRANS, FFS, STEPS, 0>(p, p, sm, mx,
                                                          BlockTile{});
    if constexpr (STEPS > 1) {
      __syncthreads();     // step A's outputs are in shared memory
      sw_step_gen<NT, MET2D, MU, RAW, TRANS, FFS, STEPS, 1>(p, p, sm, mx,
                                                            BlockTile{});
    }
  } else {
    // the loader's barriers; its boxes land at 128-byte boundaries
    __shared__ uint64_t s_bar[N_GROUPS];
    float* sma = MET2D && MU == 2 ? sm : tma::align128(sm);
    sw_step<NT, MET2D, MU, HRP, RAW, TRANS, FFS, STEPS, 0, FOLD>(
        p, p, sma, mx, BlockTile{}, maps, s_bar);
    if constexpr (STEPS > 1) {
      __syncthreads();     // step A's outputs are in shared memory
      sw_step<NT, MET2D, MU, HRP, RAW, TRANS, FFS, STEPS, 1, FOLD>(
          p, p, sma, mx, BlockTile{}, maps, s_bar);
    }
  }

  // block max |ssh|, NaN-propagating, over both steps of a chained launch
  for (int off = 16; off > 0; off >>= 1)
    mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) s_red[tid >> 5] = mx;
  __syncthreads();
  if (tid < 32) {
    mx = tid < NWARPS ? s_red[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
    if (tid == 0) p.blockmax[blockIdx.y * gridDim.x + blockIdx.x] = mx;
  }
}

// Whether the form's kernel takes tensor maps: every fast form, and the
// general forms that GenPlan moves to TMA.
template <int NT, int MU, int STEPS, bool GEN>
constexpr bool TAKES_MAPS = !GEN || GenPlan<NT, STEPS, MU == 2>::ON;

// maps: the tensor maps (a general form on the threads' loader takes
// none), first in the parameter block, where each keeps the 64-byte
// alignment TMA asks
template <int NT, bool GUARD, bool MET2D, int MU, bool HRP, bool RAW,
          bool TRANS, bool FFS, int STEPS, bool GEN>
__global__ void
__launch_bounds__(Tile<STEPS>::NTHREADS, Tile<STEPS>::MIN_BLOCKS)
fused_sw_step_kernel(
    const __grid_constant__
    std::conditional_t<TAKES_MAPS<NT, MU, STEPS, GEN>, Maps, NoMaps> maps,
    const Params p) {
  if constexpr (TAKES_MAPS<NT, MU, STEPS, GEN>)
    step_launch<NT, GUARD, MET2D, MU, HRP, RAW, TRANS, FFS, STEPS, GEN, 0>(
        p, &maps);
  else
    step_launch<NT, GUARD, MET2D, MU, HRP, RAW, TRANS, FFS, STEPS, GEN, 0>(
        p, nullptr);
}

// The fast form with its arithmetic folds (FOLD != 0), a kernel of its own
// so that the unfolded forms above keep their names.
template <int NT, bool GUARD, bool MET2D, int MU, bool HRP, bool RAW,
          bool TRANS, bool FFS, int STEPS, int FOLD>
__global__ void
__launch_bounds__(Tile<STEPS>::NTHREADS, Tile<STEPS>::MIN_BLOCKS)
fused_sw_fold_kernel(const __grid_constant__ Maps maps, const Params p) {
  step_launch<NT, GUARD, MET2D, MU, HRP, RAW, TRANS, FFS, STEPS, false,
              FOLD>(p, &maps);
}

// whether this library holds the raw forms (and then no other)
#ifdef FUSED_RAW_NT
constexpr bool RAW_BUILD = true;
#else
constexpr bool RAW_BUILD = false;
#endif
// whether this library holds the general forms (and then no other)
#ifdef FUSED_GEN
constexpr bool GEN_BUILD = true;
#else
constexpr bool GEN_BUILD = false;
#endif
// whether this library holds the persistent forms (and then no other)
#ifdef FUSED_PERSIST
constexpr bool PERSIST_BUILD = true;
#else
constexpr bool PERSIST_BUILD = false;
#endif
// the advection and free-surface forms this library holds (a general or
// a persistent library: all four), and the model steps its forms chain in
// a launch
constexpr bool TRANS_BUILD = FUSED_TRANS != 0;
constexpr bool FFS_BUILD = FUSED_FFS != 0;
constexpr bool ALL_FORMS = GEN_BUILD || PERSIST_BUILD;
constexpr int STEPS_BUILD = FUSED_STEPS;
// the folds of this library's forms (a fast library's; 0: none)
constexpr int FOLD_BUILD = FUSED_FOLD;
using TILE = Tile<STEPS_BUILD>;
static_assert(!PERSIST_BUILD || (!RAW_BUILD && STEPS_BUILD == 1),
              "the persistent forms are of the single block, one step each");
static_assert(FOLD_BUILD == 0 || !(GEN_BUILD || PERSIST_BUILD),
              "the folds are the fast form's, one step or two a launch");
static_assert(FOLD_BUILD >= 0 && FOLD_BUILD <= (F_ELIDE | F_Q4 | F_SHARE)
              && (!(FOLD_BUILD & F_SHARE)
                  || (STEPS_BUILD > 1 && FUSED_FFS != 0)),
              "the fold combinations the drivers reach");

// The kernel of this library's fast forms: the unfolded one, or the one
// with this library's folds.
template <int NT, bool GUARD, bool MET2D, int MU, bool HRP>
auto fast_kernel() {
  if constexpr (FOLD_BUILD == 0)
    return fused_sw_step_kernel<NT, GUARD, MET2D, MU, HRP, RAW_BUILD,
                                TRANS_BUILD, FFS_BUILD, STEPS_BUILD, false>;
  else
    return fused_sw_fold_kernel<NT, GUARD, MET2D, MU, HRP, RAW_BUILD,
                                TRANS_BUILD, FFS_BUILD, STEPS_BUILD,
                                FOLD_BUILD>;
}

// The tensor maps of the general body's boxes (load_gen_windows): the
// carried fields ssh, u, v (and a viscous form's up, vp) of `p`, its lu
// and hr planes, each a box of the form's window; 0 or the error of one
// TMA refuses.
template <int NT, int STEPS, bool VISC>
int encode_gen_maps(Maps& m, const Params& p) {
  using Fm = Form<NT, STEPS>;
  const float* src[] = {p.ssh, p.u, p.v, p.up, p.vp, p.planes, p.hrp};
  const int slot[] = {T_SSH, T_U, T_V, T_UP, T_VP, T_LU, T_HR};
  for (int i = 0; i < 7; ++i) {
    if (!VISC && (slot[i] == T_UP || slot[i] == T_VP)) continue;
    const int e = tma::map_2d(&m.m[slot[i]], src[i], p.Xs, p.Ys, Fm::WX,
                              Fm::WY);
    if (e) return e;
  }
  return 0;
}

#ifndef FUSED_PERSIST
// The tensor maps of the windowed inputs a fast form's loader reads
// (Loads::USED), each a box of the form's window (tma.cuh); 0 or the
// error of one TMA refuses.
template <int NT, int MU, bool HRP, bool FFS, int STEPS>
int encode_maps(Maps& m, const Params& p) {
  using Fm = Form<NT, STEPS>;
  const size_t plane = (size_t)p.Xs * p.Ys;
  const float* src[N_TMAP] = {
      p.ssh, p.sshp, p.u, p.up, p.v, p.vp, p.planes, p.planes + plane,
      p.planes + 2 * plane, p.planes + 3 * plane, p.hrld};
  for (int l = 0; l < 2 * MAX_TRACERS; ++l) src[T_TR + l] = p.tr[l];
  for (int t = 0; t < N_TMAP; ++t) {
    if (!(Loads<NT, MU, HRP, FFS, STEPS>::USED >> t & 1u)) continue;
    const int e = tma::map_2d(&m.m[t], src[t], p.Xs, p.Ys, Fm::WX, Fm::WY);
    if (e) return e;
  }
  return 0;
}

template <int NT, bool GUARD, bool MET2D, int MU, bool HRP>
int launch(const Params& p, cudaStream_t stream) {
  // the loader's planes (and their alignment), or the viscous forms on
  // metric planes' loads of threads; a chained TLOOP form's tracer levels
  // in shared memory on top
  constexpr bool USE_TMA = !(MET2D && MU == 2);
  using Pl = Plan<NT, STEPS_BUILD, MU == 2, HRP, FFS_BUILD, USE_TMA>;
  const size_t smem = Pl::SMEM
      + sizeof(float) * Form<NT, STEPS_BUILD, USE_TMA>::PLANE
        * (NT < 0 ? p.n_lev_sm : 0);
  Maps maps;
  if (USE_TMA) {
    const int bad =
        encode_maps<NT, MU, HRP, FFS_BUILD, STEPS_BUILD>(maps, p);
    if (bad) return bad;
  }
  const auto kernel = fast_kernel<NT, GUARD, MET2D, MU, HRP>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel
      <<<dim3((p.Ys + TILE::TY - 1) / TILE::TY,
              (p.Xs + TILE::TX - 1) / TILE::TX),
         TILE::NTHREADS, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

template <int NT, bool GUARD, bool MET2D>
int launch_mu(const Params& p, int mu_mode, cudaStream_t s) {
  const bool hrp = p.hrld != nullptr;
  switch (mu_mode) {
    case 0:
      return hrp ? launch<NT, GUARD, MET2D, 0, true>(p, s)
                 : launch<NT, GUARD, MET2D, 0, false>(p, s);
    case 1:
      if constexpr (NT != 0)
        return hrp ? launch<NT, GUARD, MET2D, 1, true>(p, s)
                   : launch<NT, GUARD, MET2D, 1, false>(p, s);
      return (int)cudaErrorInvalidValue;
    default:
      return hrp ? launch<NT, GUARD, MET2D, 2, true>(p, s)
                 : launch<NT, GUARD, MET2D, 2, false>(p, s);
  }
}

template <int NT>
int launch_form(const Params& p, bool met2d, int mu_mode, cudaStream_t s) {
  const bool guard = p.tile_wet != nullptr;
  if (met2d)
    return guard ? launch_mu<NT, true, true>(p, mu_mode, s)
                 : launch_mu<NT, false, true>(p, mu_mode, s);
  return guard ? launch_mu<NT, true, false>(p, mu_mode, s)
               : launch_mu<NT, false, false>(p, mu_mode, s);
}

#ifdef FUSED_GEN
// the general forms: every (TRANS, FFS) in this library, each kernel at
// the carveout of its blocks (GenPlan), by TMA where GenPlan says
template <int NT, bool GUARD, bool MET2D, int MU, bool TRANS, bool FFS>
int launch_gen(const Params& p, cudaStream_t stream) {
  using GP = GenPlan<NT, STEPS_BUILD, MU == 2>;
  const size_t smem = GP::SMEM
      + sizeof(float) * Form<NT, STEPS_BUILD, GP::ON>::PLANE
        * (NT < 0 ? p.n_lev_sm : 0);
  const auto kernel = fused_sw_step_kernel<NT, GUARD, MET2D, MU, false,
                                           RAW_BUILD, TRANS, FFS,
                                           STEPS_BUILD, true>;
  std::conditional_t<GP::ON, Maps, NoMaps> maps;
  if constexpr (GP::ON) {
    const int bad = encode_gen_maps<NT, STEPS_BUILD, MU == 2>(maps, p);
    if (bad) return bad;
  }
  // a chained TLOOP block's step is that of its tracer levels (one
  // block an SM: 164 KB at 3 tracers, not 228)
  const int carve = GP::LOOP_CHAIN
      ? carveout_kb(smem + GEN_STATIC + BLOCK_RESERVED) : GP::CARVE;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             carveout_percent(carve));
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((p.Ys + TILE::TY - 1) / TILE::TY,
                (p.Xs + TILE::TX - 1) / TILE::TX),
           TILE::NTHREADS, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

template <int NT, bool GUARD, bool MET2D, bool TRANS, bool FFS>
int launch_gen_mu(const Params& p, int mu_mode, cudaStream_t s) {
  switch (mu_mode) {
    case 0: return launch_gen<NT, GUARD, MET2D, 0, TRANS, FFS>(p, s);
    case 1:
      if constexpr (NT != 0)
        return launch_gen<NT, GUARD, MET2D, 1, TRANS, FFS>(p, s);
      return (int)cudaErrorInvalidValue;
    default: return launch_gen<NT, GUARD, MET2D, 2, TRANS, FFS>(p, s);
  }
}

template <int NT, bool GUARD, bool MET2D>
int launch_gen_forms(const Params& p, int mu_mode, bool trans, bool ffs,
                     cudaStream_t s) {
  if (trans)
    return ffs ? launch_gen_mu<NT, GUARD, MET2D, true, true>(p, mu_mode, s)
               : launch_gen_mu<NT, GUARD, MET2D, true, false>(p, mu_mode, s);
  return ffs ? launch_gen_mu<NT, GUARD, MET2D, false, true>(p, mu_mode, s)
             : launch_gen_mu<NT, GUARD, MET2D, false, false>(p, mu_mode, s);
}
#endif

// the forms of this library with NT tracers
template <int NT>
int dispatch(const Params& p, bool met2d, int mu_mode, bool trans, bool ffs,
             cudaStream_t s) {
#ifdef FUSED_GEN
  const bool guard = p.tile_wet != nullptr;
  if (met2d)
    return guard ? launch_gen_forms<NT, true, true>(p, mu_mode, trans, ffs, s)
                 : launch_gen_forms<NT, false, true>(p, mu_mode, trans, ffs,
                                                     s);
  return guard ? launch_gen_forms<NT, true, false>(p, mu_mode, trans, ffs, s)
               : launch_gen_forms<NT, false, false>(p, mu_mode, trans, ffs,
                                                    s);
#else
  (void)trans; (void)ffs;
  return launch_form<NT>(p, met2d, mu_mode, s);
#endif
}
#else  // FUSED_PERSIST

// The persistent step (K2): n_steps whole model steps in one cooperative
// launch. Replaces ocean_model_arch_tpu/ops/pallas/fused_step.py::
// build_persistent_sw_step (pallas_call at :1355), which runs the inner
// kernel of the step (_make_kernel, built at :1219-1225 with profile
// metrics, one step a call and no tile guard) over every tile for each
// step, the state in VMEM scratch for the whole window, and the max |ssh|
// of all steps in one (8, 128) block.
//
// Here a co-resident grid (blocks an SM x SMs, at most one launch's worth
// of tiles) walks the tiles of the single block's layout: tile t (row tile
// t / n_ty, column tile t % n_ty) goes to block t mod gridDim, which runs
// sw_step / sw_step_gen on it -- the same tile body, the same bits, as a
// launch of the unguarded one-step form with profile metrics -- with a
// __syncthreads() before the next tile reuses the shared planes. The state
// is two buffer sets: step s reads one and writes the other (A -> B for
// even s, B -> A for odd s), and a grid barrier
// (cooperative_groups::this_grid().sync(), no relocatable device code
// needed) separates the steps. Every block calls it n_steps - 1 times,
// whatever tiles it had. Across the barrier a block reads cells another
// block wrote: by TMA boxes, which the proxy fences around the barrier
// order, and by ordinary loads (Params has no __restrict__, so nvcc emits
// no non-coherent loads of the carried fields), which the barrier's own
// fences order. The max |ssh| of every step and tile a block ran
// (NaN-keeping) is written once, per block, at the end.
//
// Its loader (design A): each tile's boxes are issued by thread 0 when the
// tile starts, after the last tile's final barrier, into the block's one
// set of planes; three blocks an SM hide each other's load latency, as in
// a launch of one tile a block. The tensor maps of both buffer sets are
// the kernel's first parameter (WalkMaps), the step's parity picks one.
//
// What bounds it: memory, as the one-step form, for every step: the carried
// fields read and written and the static planes read each step (113 MB on
// the 1533 x 1152 layout without tracers); the two buffer sets (85 MB
// without tracers) do not fit the 50 MB L2. What it saves is the launch of
// each step and the host's work between them: one launch a window.

// The walk's position, in shared memory, read at each use (volatile): the
// tile's column and row tile, the tile index, whether there is one, the
// step, and the layout's column tiles and tiles. Held in registers across
// the step body (nvcc hoists what it can out of the walk's loops), they
// would push it past the 40 registers that let three blocks share an SM,
// where a launch of one block a tile reads its tile from blockIdx
// whenever it needs it. And the carried fields' pointers of the step's
// parity, which thread 0 writes before each step and the barriers order:
// one body whose fields change with the parity, since two bodies, one a
// parity with its own parameter set, hoist twice as many constants out of
// the step loop, which spills.
enum {
  W_BX, W_BY, W_TILE, W_MORE, W_STEP, W_NTY, W_NTILES, W_PHASE, N_WALK
};
__shared__ volatile int walk_at[N_WALK];
__shared__ Fields walk_fields;

// The walk's maps: the static planes' once, the carried fields' of each
// buffer set (even steps read set A, odd steps set B: the step's parity in
// walk_at); no one-step form loads its tracer levels by TMA.
constexpr int N_WALK_STATIC = T_TR - T_RU;
struct WalkMaps {
  CUtensorMap st[N_WALK_STATIC];       // T_RU ... T_HRLD
  CUtensorMap f[2][T_RU];              // T_SSH ... T_VP of each set
  __device__ __forceinline__ const CUtensorMap* at(int slot) const {
    return slot < T_RU ? &f[walk_at[W_STEP] & 1][slot] : &st[slot - T_RU];
  }
};
// the walk's static shared memory, as GenPlan budgets it
static_assert(sizeof(int) * N_WALK + sizeof(Fields) + sizeof(uint64_t)
              * N_GROUPS + sizeof(float) * TILE::NTHREADS / 32
              <= GEN_STATIC, "the walk's static shared memory");

// The walk's tile: its position and origin read from walk_at at each use,
// and the thread's index read afresh at each use (a volatile read), so
// that nvcc neither keeps it nor hoists what derives from it out of the
// walk's loops. Its windows come by TMA: the kernel initialises the
// loader's barriers once a launch, and each tile a block runs is one
// phase of them, whose parity (W_PHASE) flips from tile to tile and from
// step to step.
struct WalkTile {
  static constexpr bool TMA = true, INIT = false;
  __device__ __forceinline__ uint32_t phase() const {
    return walk_at[W_PHASE];
  }
  __device__ __forceinline__ int bx() const { return walk_at[W_BX]; }
  __device__ __forceinline__ int by() const { return walk_at[W_BY]; }
  __device__ __forceinline__ int thread() const { return 0; }
  __device__ __forceinline__ int thread(int) const {
    int t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
  }
  template <int TX, int TY, int WH>
  __device__ __forceinline__ int2 origin() const { return make_int2(0, 0); }
  template <int TX, int TY, int WH>
  __device__ __forceinline__ int x0(int2) const {
    return walk_at[W_BY] * TX - WH;
  }
  template <int TX, int TY, int WH>
  __device__ __forceinline__ int y0(int2) const {
    return walk_at[W_BX] * TY - WH;
  }
};

// Thread 0 moves the walk to the block's first tile (first) or on by the
// grid (the next phase of the loader's barriers), and says whether there
// is one (the block's barriers order it).
__device__ __forceinline__ void walk_on(bool first) {
  if (threadIdx.x == 0) {
    if (!first) walk_at[W_PHASE] ^= 1;
    const int t = first ? (int)blockIdx.x : walk_at[W_TILE] + gridDim.x;
    walk_at[W_TILE] = t;
    walk_at[W_BX] = t % walk_at[W_NTY];
    walk_at[W_BY] = t / walk_at[W_NTY];
    walk_at[W_MORE] = t < walk_at[W_NTILES];
  }
}

// Thread 0 sets the step's fields: a -> b for even steps, b -> a for odd.
__device__ __forceinline__ void walk_fields_of(const Fields& a,
                                               const Fields& b, bool odd) {
  if (threadIdx.x != 0) return;
  walk_fields.ssh = odd ? b.ssh : a.ssh;
  walk_fields.sshp = odd ? b.sshp : a.sshp;
  walk_fields.u = odd ? b.u : a.u;
  walk_fields.up = odd ? b.up : a.up;
  walk_fields.v = odd ? b.v : a.v;
  walk_fields.vp = odd ? b.vp : a.vp;
  walk_fields.ssh_o = odd ? b.ssh_o : a.ssh_o;
  walk_fields.sshp_o = odd ? b.sshp_o : a.sshp_o;
  walk_fields.u_o = odd ? b.u_o : a.u_o;
  walk_fields.up_o = odd ? b.up_o : a.up_o;
  walk_fields.v_o = odd ? b.v_o : a.v_o;
  walk_fields.vp_o = odd ? b.vp_o : a.vp_o;
#pragma unroll
  for (int l = 0; l < 2 * MAX_TRACERS; ++l) {
    walk_fields.tr[l] = odd ? b.tr[l] : a.tr[l];
    walk_fields.tr_o[l] = odd ? b.tr_o[l] : a.tr_o[l];
  }
  walk_fields.trp = odd ? b.trp : a.trp;
}

// The two proxy fences of the walk: the boxes are the async proxy's
// writes of shared memory and reads of device memory, the step bodies'
// loads and stores the generic proxy's, and a barrier orders only the
// latter. fence_shared: before the next tile's boxes land in planes this
// tile's threads read and wrote; fence_global: around the grid barrier,
// before the next step's boxes read cells other blocks stored.
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// One model step of the walk: every tile t = blockIdx.x + k gridDim.x.
template <int NT, int MU, bool HRP, bool TRANS, bool FFS>
__device__ __forceinline__ void persist_step(const Params& p,
                                             const WalkMaps& maps,
                                             float* sm, uint64_t* bars,
                                             float& mx) {
  walk_on(true);
  __syncthreads();
  while (walk_at[W_MORE]) {
    if constexpr (GEN_BUILD)
      sw_step_gen<NT, false, MU, false, TRANS, FFS, 1, 0>(
          p, walk_fields, sm, mx, WalkTile{}, &maps, bars);
    else
      sw_step<NT, false, MU, HRP, false, TRANS, FFS, 1, 0>(
          p, walk_fields, sm, mx, WalkTile{}, &maps, bars);
    fence_shared();
    __syncthreads();      // the tile is done with the planes and the walk
    walk_on(false);
    __syncthreads();
  }
}

// maps: the boxes' maps (WalkMaps), first in the parameter block; p: the
// statics (its own fields unread); fa, fb: the fields of the even and the
// odd steps.
template <int NT, int MU, bool HRP, bool TRANS, bool FFS>
__global__ void __launch_bounds__(TILE::NTHREADS, TILE::MIN_BLOCKS)
fused_sw_persist_kernel(const __grid_constant__ WalkMaps maps,
                        const Params p, const Fields fa, const Fields fb,
                        int n_steps) {
  static_assert(GEN_BUILD || !Loads<NT, MU, HRP, FFS, 1>::TRW,
                "no one-step form loads its tracer levels by TMA");
  constexpr int NWARPS = TILE::NTHREADS / 32;
  extern __shared__ float sm[];
  __shared__ float s_red[NWARPS];
  // the loader's barriers, initialised once; its boxes land at 128-byte
  // boundaries
  __shared__ uint64_t s_bar[N_GROUPS];
  float* sma = tma::align128(sm);

  float mx = 0.f;
  if (threadIdx.x == 0) {
    walk_at[W_STEP] = 0;
    walk_at[W_PHASE] = 0;
    walk_at[W_NTY] = (p.Ys + TILE::TY - 1) / TILE::TY;
    walk_at[W_NTILES] = walk_at[W_NTY] * ((p.Xs + TILE::TX - 1) / TILE::TX);
    for (int gr = 0; gr < N_GROUPS; ++gr) tma::bar_init(&s_bar[gr]);
    tma::bar_fence();
  }
  for (;;) {
    walk_fields_of(fa, fb, walk_at[W_STEP] & 1);
    persist_step<NT, MU, HRP, TRANS, FFS>(p, maps, sma, s_bar, mx);
    if (walk_at[W_STEP] + 1 >= n_steps) break;
    // every block meets the barrier n_steps - 1 times; past it, every
    // thread has read the step and the fields, and every box of the next
    // step reads what the other blocks stored before it
    fence_global();
    cg::this_grid().sync();
    if (threadIdx.x == 0) {
      fence_global();
      walk_at[W_STEP] += 1;
    }
  }

  // block max |ssh| over every step, NaN-propagating
  const int tid = threadIdx.x;
  for (int off = 16; off > 0; off >>= 1)
    mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) s_red[tid >> 5] = mx;
  __syncthreads();
  if (tid < 32) {
    mx = tid < NWARPS ? s_red[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
    if (tid == 0) p.blockmax[blockIdx.x] = mx;
  }
}

// The carried fields' pointers of a Params.
Fields fields_of(const Params& p) {
  Fields f{p.ssh, p.sshp, p.u, p.up, p.v, p.vp, p.ssh_o, p.sshp_o, p.u_o,
           p.up_o, p.v_o, p.vp_o, {}, {}, p.trp};
  for (int l = 0; l < 2 * MAX_TRACERS; ++l) {
    f.tr[l] = p.tr[l];
    f.tr_o[l] = p.tr_o[l];
  }
  return f;
}

// The co-resident grid of one persistent instantiation into *grid (grid
// = 0), or its cooperative launch with *grid blocks, which must not pass
// that.
// The dynamic shared memory of a block of the walk: the fast body's Plan
// or the general body's GenPlan, one step a tile.
template <int NT, int MU, bool HRP, bool FFS>
constexpr size_t walk_smem() {
  if constexpr (GEN_BUILD) return GenPlan<NT, 1, MU == 2>::SMEM;
  else return Plan<NT, 1, MU == 2, HRP, FFS>::SMEM;
}

// The walk's maps of p0 (set A's carried fields and the statics) and p1
// (set B's): the fast body's boxes (Loads) or the general body's.
template <int NT, int MU, bool HRP, bool FFS>
int encode_walk_maps(WalkMaps& w, const Params& p0, const Params& p1) {
  using Fm = Form<NT, 1>;
  const size_t plane = (size_t)p0.Xs * p0.Ys;
  const Params* ps[2] = {&p0, &p1};
  unsigned used;
  const float* st[N_WALK_STATIC] = {};
  if constexpr (GEN_BUILD) {
    used = 1u << T_SSH | 1u << T_U | 1u << T_V | 1u << T_LU | 1u << T_HR
        | (MU == 2 ? 1u << T_UP | 1u << T_VP : 0u);
    st[T_LU - T_RU] = p0.planes;
    st[T_HR - T_RU] = p0.hrp;
  } else {
    used = Loads<NT, MU, HRP, FFS, 1>::USED;
    for (int t = T_RU; t <= T_LD; ++t)
      st[t - T_RU] = p0.planes + (t - T_RU) * plane;
    st[T_HRLD - T_RU] = p0.hrld;
  }
  for (int t = 0; t < T_TR; ++t) {
    if (!(used >> t & 1u)) continue;
    for (int k = 0; k < (t < T_RU ? 2 : 1); ++k) {
      const Params& p = *ps[k];
      const float* f[T_RU] = {p.ssh, p.sshp, p.u, p.up, p.v, p.vp};
      const int e = tma::map_2d(t < T_RU ? &w.f[k][t] : &w.st[t - T_RU],
                                t < T_RU ? f[t] : st[t - T_RU], p.Xs, p.Ys,
                                Fm::WX, Fm::WY);
      if (e) return e;
    }
  }
  return 0;
}

template <int NT, int MU, bool HRP, bool TRANS, bool FFS>
int persist_launch(const Params& p0, const Params& p1, int n_steps,
                   int* grid, cudaStream_t stream) {
  static_assert(sizeof(WalkMaps) + sizeof(Params) + 2 * sizeof(Fields)
                + sizeof(int) + 64 <= 4096, "the kernel's parameters");
  auto kernel = fused_sw_persist_kernel<NT, MU, HRP, TRANS, FFS>;
  const size_t smem = walk_smem<NT, MU, HRP, FFS>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // the general body at the carveout of its blocks (GenPlan)
  if (GEN_BUILD && e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             carveout_percent(GenPlan<NT, 1, MU == 2>::CARVE));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, TILE::NTHREADS, smem);
  if (e != cudaSuccess) return (int)e;
  // one block an SM at least, or the card cannot hold the grid
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (*grid == 0) {
    *grid = per_sm * sms;
    return 0;
  }
  if (*grid < 1 || *grid > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  WalkMaps maps;
  const int bad = encode_walk_maps<NT, MU, HRP, FFS>(maps, p0, p1);
  if (bad) return bad;
  Params p = p0;
  Fields a = fields_of(p0), b = fields_of(p1);
  void* args[] = {&maps, &p, &a, &b, &n_steps};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(*grid),
                                  dim3(TILE::NTHREADS), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int NT, int MU, bool HRP>
int persist_forms(const Params& p0, const Params& p1, int n_steps, int* grid,
                  bool trans, bool ffs, cudaStream_t s) {
  if (trans)
    return ffs ? persist_launch<NT, MU, HRP, true, true>(p0, p1, n_steps,
                                                         grid, s)
               : persist_launch<NT, MU, HRP, true, false>(p0, p1, n_steps,
                                                          grid, s);
  return ffs ? persist_launch<NT, MU, HRP, false, true>(p0, p1, n_steps,
                                                        grid, s)
             : persist_launch<NT, MU, HRP, false, false>(p0, p1, n_steps,
                                                         grid, s);
}

template <int NT, int MU>
int persist_hrp(const Params& p0, const Params& p1, int n_steps, int* grid,
                bool trans, bool ffs, cudaStream_t s) {
  // the general form reads the hr plane whatever the bathymetry
  if (!GEN_BUILD && p0.hrld != nullptr)
    return persist_forms<NT, MU, !GEN_BUILD>(p0, p1, n_steps, grid, trans,
                                             ffs, s);
  return persist_forms<NT, MU, false>(p0, p1, n_steps, grid, trans, ffs, s);
}

// the persistent forms of this library with NT tracers
template <int NT>
int persist_dispatch(const Params& p0, const Params& p1, int n_steps,
                     int* grid, int mu_mode, bool trans, bool ffs,
                     cudaStream_t s) {
  switch (mu_mode) {
    case 0: return persist_hrp<NT, 0>(p0, p1, n_steps, grid, trans, ffs, s);
    case 1:
      if constexpr (NT != 0)
        return persist_hrp<NT, 1>(p0, p1, n_steps, grid, trans, ffs, s);
      return (int)cudaErrorInvalidValue;
    default: return persist_hrp<NT, 2>(p0, p1, n_steps, grid, trans, ffs, s);
  }
}
#endif  // FUSED_PERSIST

// The parts of a launch's Params that do not depend on which buffers are
// its inputs and outputs (statics, metric rows, scalars), from the
// launchers' arguments; returns 0, or cudaErrorInvalidValue for arguments
// this library cannot take.
int statics(Params& p, const float* met, const float* planes,
            float* blockmax, const int* tile_wet, const int* met_slots,
            int met2d, int n_tracers, int n_planes, int mu_mode, int raw,
            int trans, int ffs, int steps, int Xs, int Ys, int nx, int ny,
            int margin, float hr, float mu, float neg_g, float two_tau,
            float neg_two_tau, float inv_two_tau, float ts1, float ts2) {
  const size_t plane = (size_t)Xs * Ys;
  const size_t row = met2d ? plane : (size_t)Ys;
  if (n_tracers < 0 || (raw != 0) != RAW_BUILD || steps != STEPS_BUILD)
    return (int)cudaErrorInvalidValue;
  p = Params{};
  p.planes = planes;
  p.blockmax = blockmax;
  p.n_tr = n_tracers;
  p.tile_wet = tile_wet;
  p.Xs = Xs; p.Ys = Ys; p.nx = nx; p.ny = ny; p.margin = margin;
  p.hr = hr; p.mu = mu; p.neg_g = neg_g;
  p.two_tau = two_tau; p.neg_two_tau = neg_two_tau;
  p.inv_two_tau = inv_two_tau; p.ts1 = ts1; p.ts2 = ts2;
  if (GEN_BUILD) {
    // the general form indexes its planes with ints
    if ((n_planes != 2 && n_planes != 5) || 3 * plane > (size_t)INT_MAX)
      return (int)cudaErrorInvalidValue;
    p.hrld = n_planes == 5 ? planes + 2 * plane : nullptr;
    p.hrp = planes + plane;
    for (int k = 0; k < N_GEN_MET; ++k) {
      if (met_slots[k] < 0) return (int)cudaErrorInvalidValue;
      p.met[k] = met + met_slots[k] * row;
    }
    return 0;
  }
  if (n_planes < 4 || n_planes > 6
      || (!ALL_FORMS && ((trans != 0) != TRANS_BUILD
                         || (ffs != 0) != FFS_BUILD)))
    return (int)cudaErrorInvalidValue;
  // varying bathymetry with viscosity or tracers reads the hr plane too
  if (n_planes == 5 && (mu_mode == 2 || n_tracers > 0))
    return (int)cudaErrorInvalidValue;
  p.hrld = n_planes > 4 ? planes + 4 * plane : nullptr;
  p.hrp = n_planes > 5 ? planes + 5 * plane : nullptr;
  for (int k = 0; k < N_MET; ++k) {
    const bool visc_row = k == M_DXB || k == M_DYB || k == M_RDXH
        || k == M_RDYH || k == M_RDXB || k == M_RDYB || k == M_DYDX
        || k == M_DXDY;
    const bool vort_row = k == M_VORT_V || k == M_VORT_UY || k == M_VORT_U;
    const bool read = visc_row ? mu_mode == 2
        : vort_row ? trans != 0
        : (k == M_DX || k == M_DY) ? (n_tracers > 0 || mu_mode == 2) : true;
    if (read && met_slots[k] < 0) return (int)cudaErrorInvalidValue;
    p.met[k] = met_slots[k] < 0 ? nullptr : met + met_slots[k] * row;
  }
  return 0;
}

// The geometry of this library's form with NT tracers
// (fused_sw_step_geometry): the fast body's (Plan) or the general body's
// (GenPlan), one step a tile in the persistent walk.
constexpr int N_GEOMETRY = 12;
template <int NT, bool VISC, bool HRP, bool FFS>
int geometry_of(long long* out) {
  if constexpr (GEN_BUILD) {
    using GP = GenPlan<NT, STEPS_BUILD, VISC>;
    using Fm = Form<NT, STEPS_BUILD, GP::ON>;
    const long long g[N_GEOMETRY] = {
        Fm::TX, Fm::TY, Fm::WH, Fm::WX, Fm::WY, Fm::PLANE, GP::HR,
        GP::BLOCKS, (long long)GP::SMEM, GP::BOXES, GP::ON, GP::CARVE};
    for (int i = 0; i < N_GEOMETRY; ++i) out[i] = g[i];
  } else {
    using Fm = Form<NT, STEPS_BUILD>;
    using Pl = Plan<NT, STEPS_BUILD, VISC, HRP, FFS>;
    const size_t stat = PERSIST_BUILD ? GEN_STATIC : STATIC_SMEM;
    const long long g[N_GEOMETRY] = {
        Fm::TX, Fm::TY, Fm::WH, Fm::WX, Fm::WY, Fm::PLANE, Pl::N_EXTRA,
        Pl::BLOCKS, (long long)Pl::SMEM,
        Loads<NT, VISC ? 2 : 0, HRP, FFS, STEPS_BUILD>::N, 1,
        carveout_kb(Pl::BLOCKS * (Pl::SMEM + stat + BLOCK_RESERVED))};
    for (int i = 0; i < N_GEOMETRY; ++i) out[i] = g[i];
  }
  return 0;
}

template <int NT>
int geometry_nt(bool visc, bool hrp, bool ffs, long long* out) {
  if (visc)
    return hrp ? (ffs ? geometry_of<NT, true, true, true>(out)
                      : geometry_of<NT, true, true, false>(out))
               : (ffs ? geometry_of<NT, true, false, true>(out)
                      : geometry_of<NT, true, false, false>(out));
  return hrp ? (ffs ? geometry_of<NT, false, true, true>(out)
                    : geometry_of<NT, false, true, false>(out))
             : (ffs ? geometry_of<NT, false, false, true>(out)
                    : geometry_of<NT, false, false, false>(out));
}

}  // namespace

extern "C" {

// The window geometry of this library's form (its steps a launch; the
// general body's in a general library, one step a tile in a persistent
// one) with n_tracers tracers, viscous or not, on bathymetry planes or not,
// with a full free surface or not (the general body: neither), into
// out[12]: the tile's rows and columns, the window halo WH, rows WX and
// columns WY, the floats of a shared plane, the loader's planes of their
// own, the blocks an SM the plan keeps, the dynamic shared memory of a
// block in bytes (a chained TLOOP form's tracer levels not counted), the
// TMA boxes of a launch (tma.cuh: each of WX x WY cells), 1 if the body
// loads by TMA (0: by threads) and the carveout of its blocks in KB.
// Returns 0.
int fused_sw_step_geometry(int n_tracers, int visc, int hrp, int ffs,
                           long long* out) {
  const bool v = visc != 0, h = hrp != 0, f = ffs != 0;
  switch (n_tracers) {
    case 0: return geometry_nt<0>(v, h, f, out);
    case 1: return geometry_nt<1>(v, h, f, out);
    case 2: return geometry_nt<2>(v, h, f, out);
    default: return geometry_nt<TLOOP>(v, h, f, out);
  }
}

// The output tile (rows, columns) of a block: the host sizes blockmax and
// builds the guard's per-block wet flags with these, both row-major over
// (x tiles, y tiles).
int fused_sw_step_tile_x() { return TILE::TX; }

int fused_sw_step_tile_y() { return TILE::TY; }

// The threads of a block and the blocks an SM keeps registers for
// (__launch_bounds__): 65536 / (threads * blocks) registers a thread.
int fused_sw_step_threads() { return TILE::NTHREADS; }

int fused_sw_step_min_blocks() { return TILE::MIN_BLOCKS; }

// How many metric rows fused_sw_step_launch takes slots for.
int fused_sw_step_n_met() { return GEN_BUILD ? N_GEN_MET : N_MET; }

// The tracer count this library was built for (-DFUSED_NT, -DFUSED_RAW_NT;
// 3 builds the TLOOP forms, which take any count from 3 up), or -1 for
// all.
int fused_sw_step_built_for() {
#ifdef FUSED_NT
  return FUSED_NT;
#else
  return -1;
#endif
}

// 1 if this library holds the raw forms (-DFUSED_RAW_NT), else 0.
int fused_sw_step_built_raw() { return RAW_BUILD ? 1 : 0; }

// 1 if this library's forms advect momentum (-DFUSED_TRANS, default 1);
// -1 for a general or a persistent library, which holds both.
int fused_sw_step_built_trans() { return ALL_FORMS ? -1 : TRANS_BUILD; }

// 1 if this library's forms have a full free surface (-DFUSED_FFS,
// default 1), 0 for a linear one; -1 for a general or a persistent
// library, both.
int fused_sw_step_built_ffs() { return ALL_FORMS ? -1 : FFS_BUILD; }

// 1 if this library holds the general forms (-DFUSED_GEN), else 0.
int fused_sw_step_built_general() { return GEN_BUILD ? 1 : 0; }

// 1 if this library holds the persistent forms (-DFUSED_PERSIST), else 0.
int fused_sw_step_built_persist() { return PERSIST_BUILD ? 1 : 0; }

// The model steps a launch of this library's forms runs (-DFUSED_STEPS,
// default 1; 2 chains two).
int fused_sw_step_built_steps() { return STEPS_BUILD; }

// The folds of this library's fast forms (-DFUSED_FOLD, default 0: none):
// 1 elide_sel, 2 q4, 4 share_prev, or'ed.
int fused_sw_step_built_folds() { return FOLD_BUILD; }

const char* fused_sw_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Of a launch of this library's forms with n_tracers tracers (viscous if
// visc != 0) on the current device: the dynamic shared memory of a block
// in bytes, and in *levels how many of step A's 2 n_tracers tracer levels
// a chained block keeps there (all of them but in a chained TLOOP form
// past the fit; 0 for one step a launch).
long long fused_sw_step_smem_bytes(int n_tracers, int visc, int* levels) {
  return (long long)form_smem_bytes<STEPS_BUILD>(n_tracers, visc != 0,
                                                 levels);
}

// The floats of device scratch a launch needs (fused_sw_step_launch's
// `scratch`): the chained TLOOP form's tracer levels that shared memory
// does not hold, a window plane each for every block; 0 for the others.
long long fused_sw_step_scratch_floats(int n_tracers, int visc, int Xs,
                                       int Ys) {
  int levels = 0;
  fused_sw_step_smem_bytes(n_tracers, visc, &levels);
  if (STEPS_BUILD == 1 || n_tracers <= MAX_TRACERS) return 0;
  const long long blocks = (long long)((Xs + TILE::TX - 1) / TILE::TX)
      * ((Ys + TILE::TY - 1) / TILE::TY);
  return blocks * (2 * n_tracers - levels) * Form<TLOOP, STEPS_BUILD>::PLANE;
}

#ifndef FUSED_PERSIST
// Launches one step on `stream`; returns cudaGetLastError() (0 = launched).
// tr_in / tr_out: host arrays of 2 * n_tracers device pointers (ff_0,
// ffp_0, ff_1, ...), unread when n_tracers = 0. Above 2 tracers (the
// TLOOP forms) they are copied, stream-ordered, into tr_table, a device
// array of 4 * n_tracers pointers, which the kernel reads; scratch:
// fused_sw_step_scratch_floats() floats of device memory (null when that
// is 0). tile_wet: device array of
// one int per block, or null for the unguarded form. met: (rows, Ys)
// profiles when met2d = 0, (rows, Xs, Ys) planes otherwise; met_slots: host
// array of fused_sw_step_n_met() ints, the row of `met` that holds each
// metric the kernel reads (in the order 0, 1, 6, 7, 9-21 of the layout's
// row meanings), negative for a row the form does not read. planes:
// (n_planes, Xs, Ys): rslu_u, rslu_v, rslu_h, ludxdy and, for varying
// bathymetry (then `hr` is unread), hrludxdy (n_planes = 5) and hr (6, which
// viscosity and tracers need). A general library (-DFUSED_GEN) instead
// takes the 16 metric rows 0-15 of the layout's row meanings (met_slots:
// fused_sw_step_n_met() = 16 slots), the planes lu, hr (n_planes = 2) and
// with static reciprocals rslu_u, rslu_v, rslu_h (5); `hr` is unread, and
// trans and ffs pick any of its forms. visc != 0 runs the lateral
// viscosity with
// the constant `mu`; tracers take their diffusive fluxes whenever mu != 0.
// raw != 0 asks for the raw form, which stores only inside the box
// [margin, margin + nx) x [margin, margin + ny) of the outputs; a library
// holds either the raw forms or the others. trans and ffs name the
// advection and free-surface form, which must be this library's; without
// advection the vorticity rows (16-18) are not read. steps: the model steps
// of one launch, which must be this library's; a chained launch (2) writes
// the second step's fields and its block max covers both steps.
int fused_sw_step_launch(
    const float* ssh, const float* sshp, const float* u, const float* up,
    const float* v, const float* vp, const float* met, const float* planes,
    float* ssh_o, float* sshp_o, float* u_o, float* up_o, float* v_o,
    float* vp_o, float* blockmax, const float* const* tr_in,
    float* const* tr_out, void* tr_table, float* scratch,
    const int* tile_wet, const int* met_slots,
    int met2d, int n_tracers, int n_planes, int visc, int raw, int trans,
    int ffs, int steps, int Xs, int Ys, int nx, int ny, int margin,
    float hr, float mu,
    float neg_g, float two_tau, float neg_two_tau, float inv_two_tau,
    float ts1, float ts2, void* stream) {
  const int mu_mode = visc ? 2 : (n_tracers > 0 && mu != 0.f ? 1 : 0);
  Params p;
  const int bad = statics(p, met, planes, blockmax, tile_wet, met_slots,
                          met2d, n_tracers, n_planes, mu_mode, raw, trans,
                          ffs, steps, Xs, Ys, nx, ny, margin, hr, mu, neg_g,
                          two_tau, neg_two_tau, inv_two_tau, ts1, ts2);
  if (bad) return bad;
  p.ssh = ssh; p.sshp = sshp; p.u = u; p.up = up; p.v = v; p.vp = vp;
  p.ssh_o = ssh_o; p.sshp_o = sshp_o; p.u_o = u_o; p.up_o = up_o;
  p.v_o = v_o; p.vp_o = vp_o;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tracers > MAX_TRACERS) {
    // the pointer table: what the kernel reads is the copy made here, in
    // stream order, so the caller's arrays may go when this returns
    const size_t half = sizeof(float*) * 2 * n_tracers;
    if (tr_table == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemcpyAsync(tr_table, tr_in, half,
                                    cudaMemcpyHostToDevice, s);
    if (e == cudaSuccess)
      e = cudaMemcpyAsync((char*)tr_table + half, tr_out, half,
                          cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return (int)e;
    p.trp = (float* const*)tr_table;
    p.scratch = scratch;
    if (STEPS_BUILD > 1) {
      fused_sw_step_smem_bytes(n_tracers, mu_mode == 2, &p.n_lev_sm);
      if (p.n_lev_sm < 2 * n_tracers && scratch == nullptr)
        return (int)cudaErrorInvalidValue;
    }
  } else {
    for (int t = 0; t < 2 * n_tracers; ++t) {
      p.tr[t] = tr_in[t];
      p.tr_o[t] = tr_out[t];
    }
  }
  const bool m2 = met2d != 0, tr = trans != 0, fs = ffs != 0;
  switch (n_tracers) {
#if !defined(FUSED_NT) || FUSED_NT == 0
    case 0: return dispatch<0>(p, m2, mu_mode, tr, fs, s);
#endif
#if !defined(FUSED_NT) || FUSED_NT == 1
    case 1: return dispatch<1>(p, m2, mu_mode, tr, fs, s);
#endif
#if !defined(FUSED_NT) || FUSED_NT == 2
    case 2: return dispatch<2>(p, m2, mu_mode, tr, fs, s);
#endif
    default:
#if !defined(FUSED_NT) || FUSED_NT == 3
      if (n_tracers > MAX_TRACERS)
        return dispatch<TLOOP>(p, m2, mu_mode, tr, fs, s);
#endif
      return (int)cudaErrorInvalidValue;   // not in this build
  }
}
#else  // FUSED_PERSIST

// Launches n_steps model steps of the persistent form (K2) on `stream` as
// one cooperative launch of *grid blocks; returns its CUDA error (0 =
// launched). With *grid = 0 it launches nothing and sets *grid to the
// co-resident grid of the form (blocks an SM x SMs), the most a launch
// takes; a card that cannot hold one block an SM refuses both. set_a,
// set_b: host arrays of the 6 + 2 n_tracers device pointers of the two
// buffer sets (ssh, sshp, u, up, v, vp, ff_0, ffp_0, ...): even steps read
// A and write B, odd steps the reverse, so step n_steps is in B for odd
// n_steps and in A for even. Every cell of the array is written each step
// (land margins keep their input). blockmax: *grid floats, each block's
// max |ssh| over every step it ran. tr_table: 8 n_tracers device pointers
// of scratch for more than 2 tracers (null otherwise), filled here in
// stream order. The statics, metric rows (profiles: met2d = 0) and
// scalars are fused_sw_step_launch's; there is no guard, no raw form and
// one step a tile a step; trans and ffs pick any of this library's forms,
// and a fast library's bathymetry planes (n_planes 5 or 6) its HRP forms.
int fused_sw_persist_launch(
    const float* const* set_a, float* const* set_b, const float* met,
    const float* planes, float* blockmax, void* tr_table,
    const int* met_slots, int n_tracers, int n_planes, int visc, int trans,
    int ffs, int n_steps, int* grid, int Xs, int Ys, int nx, int ny,
    int margin, float hr, float mu, float neg_g, float two_tau,
    float neg_two_tau, float inv_two_tau, float ts1, float ts2,
    void* stream) {
  const int mu_mode = visc ? 2 : (n_tracers > 0 && mu != 0.f ? 1 : 0);
  Params p0;
  const int bad = statics(p0, met, planes, blockmax, nullptr, met_slots, 0,
                          n_tracers, n_planes, mu_mode, 0, trans, ffs, 1, Xs,
                          Ys, nx, ny, margin, hr, mu, neg_g, two_tau,
                          neg_two_tau, inv_two_tau, ts1, ts2);
  if (bad) return bad;
  if (n_steps < 1) return (int)cudaErrorInvalidValue;
  // p0 steps A -> B, p1 B -> A (no sets for the grid's query)
  Params p1 = p0;
  const float* const* in[2] = {set_a, set_b};
  float* const* out[2] = {(float* const*)set_b, (float* const*)set_a};
  Params* ps[2] = {&p0, &p1};
  for (int k = 0; k < 2 && *grid != 0; ++k) {
    Params& p = *ps[k];
    p.ssh = in[k][0]; p.sshp = in[k][1]; p.u = in[k][2]; p.up = in[k][3];
    p.v = in[k][4]; p.vp = in[k][5];
    p.ssh_o = out[k][0]; p.sshp_o = out[k][1]; p.u_o = out[k][2];
    p.up_o = out[k][3]; p.v_o = out[k][4]; p.vp_o = out[k][5];
    if (n_tracers <= MAX_TRACERS) {
      for (int t = 0; t < 2 * n_tracers; ++t) {
        p.tr[t] = in[k][6 + t];
        p.tr_o[t] = out[k][6 + t];
      }
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tracers > MAX_TRACERS && *grid != 0) {
    // two tables of 4 n_tracers pointers, one a parity: the levels in, then
    // out; what the kernel reads is the copy made here, in stream order
    if (tr_table == nullptr) return (int)cudaErrorInvalidValue;
    std::vector<const float*> table;
    for (int k = 0; k < 2; ++k) {
      for (int t = 0; t < 2 * n_tracers; ++t) table.push_back(in[k][6 + t]);
      for (int t = 0; t < 2 * n_tracers; ++t) table.push_back(out[k][6 + t]);
    }
    cudaError_t e = cudaMemcpyAsync(tr_table, table.data(),
                                    sizeof(float*) * table.size(),
                                    cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return (int)e;
    p0.trp = (float* const*)tr_table;
    p1.trp = p0.trp + 4 * n_tracers;
  }
  const bool tr = trans != 0, fs = ffs != 0;
  switch (n_tracers) {
#if !defined(FUSED_NT) || FUSED_NT == 0
    case 0: return persist_dispatch<0>(p0, p1, n_steps, grid, mu_mode, tr, fs,
                                       s);
#endif
#if !defined(FUSED_NT) || FUSED_NT == 1
    case 1: return persist_dispatch<1>(p0, p1, n_steps, grid, mu_mode, tr, fs,
                                       s);
#endif
#if !defined(FUSED_NT) || FUSED_NT == 2
    case 2: return persist_dispatch<2>(p0, p1, n_steps, grid, mu_mode, tr, fs,
                                       s);
#endif
    default:
#if !defined(FUSED_NT) || FUSED_NT == 3
      if (n_tracers > MAX_TRACERS)
        return persist_dispatch<TLOOP>(p0, p1, n_steps, grid, mu_mode, tr,
                                       fs, s);
#endif
      return (int)cudaErrorInvalidValue;   // not in this build
  }
}
#endif  // FUSED_PERSIST

}  // extern "C"
