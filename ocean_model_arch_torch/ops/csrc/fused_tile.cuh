// Tile and window constants shared by the fused shallow-water step
// (fused_step.cu) and its copy-step roofline kernel (copy_step.cu): the
// copy step measures the fused step's own tiling, so both take their tile,
// thread count, window halo and shared-memory footprint from here.

#pragma once

#include <cuda_runtime.h>

namespace fused_tile {

// Tile, one for every form: 16 x 32 outputs, 512 threads, three blocks
// per SM. Swept on an H100 SXM (700 W) at the 1533 x 1152 layout, device
// us/launch. Without tracers: 16x32 with 512 threads 75.0; 16x16, 12x32
// and 8x32 with 256 threads 76-78; 32x32 108; 32x64 172. With 2 tracers:
// 16x32/512 122; 8x64/512 123; 12x32/512 126; 32x16/512 128; 16x64/512
// 129; 16x32/384 131; 32x32/512 133; 16x16/256 134; 8x32/256 137. Small
// tiles keep more blocks, and so more loads, in flight per SM; their halo
// re-reads hit L2. Three blocks of 512 threads fit an SM only at 42
// registers or fewer: left to itself ptxas takes 44 (47-48 with tracers),
// two blocks fit, and the launch takes 95 us instead of 73 (164 instead
// of 122); with MIN_BLOCKS = 3 it takes 39 and spills nothing.
constexpr int TX = 16;                 // output rows (x) per block
constexpr int TY = 32;                 // output columns (y) per block
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MIN_BLOCKS = 3;          // blocks per SM to keep registers for
constexpr int MAX_TRACERS = 2;
constexpr int N_SMEM_PLANES = 16;      // shared-memory windows of a block
constexpr int N_VISC_PLANES = 4;       // stress products of the viscous forms

// The window of the form with NT tracers.
template <int NT>
struct Form {
  static constexpr int EXTRA = NT ? 1 : 0;        // reach of the tracer pass
  static constexpr int HALO = 3 + EXTRA;          // stencil reach of one step
  static constexpr int WX = TX + 2 * HALO;        // window rows
  static constexpr int WY = TY + 2 * HALO;        // window columns
  static constexpr int PLANE = WX * WY;           // floats per shared array
  // The viscous forms keep their four stress products on the region one
  // cell inside the flux stage's (halo 1 + EXTRA), row-major, no wider:
  // with full windows the 2-tracer form would pass the 75 KB that let
  // three blocks share an SM.
  static constexpr int VH = 1 + EXTRA;
  static constexpr int VW = TY + 2 * VH;          // columns of that region
  static constexpr int VPLANE = (TX + 2 * VH) * VW;
};

// Dynamic shared memory of a block: 53.5 KB (61.4 KB with tracers), and
// 63.3 KB (73.0 KB) for a viscous form.
template <int NT>
constexpr size_t smem_bytes(bool visc = false) {
  return sizeof(float) * (N_SMEM_PLANES * Form<NT>::PLANE
                          + (visc ? N_VISC_PLANES * Form<NT>::VPLANE : 0));
}

}  // namespace fused_tile
