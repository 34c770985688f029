// Op-cost probes for Hopper (sm_90a): what one arithmetic operation, or
// one shifted operand, costs the card inside a dependent chain, read as
// the slope of a call's time against the chain's length K.
//
// Replaces: scripts/vpu_op_probe.py::make (pallas_call at :88; K6) and
//   scripts/vpu_shift_probe.py::make (:50; K7), the TPU's instruments for
//   the fused step's op costs. On the bench layout (XS rows: 24 tiles of
//   TX = 64 rows between margins of M = 8; YS columns: 1152 for K6, 1119
//   for K7) tile i reads the window a of rows [i TX, i TX + TX + 2 M), all
//   YS columns, runs K dependent iterations of
//       b = b * 0.999 + 1e-4 * op(b)        (b = a at first)
//   and writes the window's rows [M, M + TX) to the output's rows
//   [i TX + M, i TX + M + TX). The kinds, op(b):
//     plain  b                     (the carrier alone)
//     div    a / b                 (IEEE division, div.rn)
//     rcp    the approximate reciprocal of b (rcp.approx.ftz.f32: one
//            MUFU.RCP; the non-ftz form adds a subnormal range check)
//     rcpn   r (2 - b r), r = rcp.approx(b) (one Newton step)
//     sel    b > 0.5 ? b : a       (compare and select)
//     bmul   b * row               (row: the window's row 0, the output's
//                                   global row i TX, of the same column)
//     rollx  b of the row above, circular over the window's TX + 2 M rows
//     rolly  b of the column before, circular over the YS columns
//   and two chains without the carrier: mulf32, b = a * 0.9999, then K
//   times b = b * b; mulbf16, the same in bf16, a pair of columns (2 j,
//   2 j + 1) in a packed __nv_bfloat162 (__hmul2, the card's bf16
//   elementwise path).
//   The carrier is written __fmaf_rn(b, 0.999f, __fmul_rn(op, 1e-4f)), so
//   that nvcc neither contracts it otherwise nor folds the chain: one FMUL
//   and one FFMA an iteration. The squaring chains are dependent products,
//   which no compiler folds into a power (the TPU script's note on
//   constant-multiplier chains).
//   Plain PyTorch version: ops/vpu_probe.py::vpu_probe_reference.
//
// The output's margin rows, [0, M) and [XS - M, XS), are not written: the
// TPU kernel leaves them undefined; here they keep what the output buffer
// held, which the wrapper sets to the input's margin rows. Neighbouring
// windows overlap by 2 M rows, so a call cannot run in place: the carried
// calls step between two buffers.
//
// What bounds each kind, and what the design does about it. A cell's
// chain is K dependent iterations of 2 FP32 instructions (the carrier)
// plus the op's own, so at K = 64 the FP32 pipe bounds every kind (226 M
// instructions for plain, 6.8 us at 132 SMs x 128 lanes x 1.98 GHz), at K
// = 16 the bytes (the output rows and the input rows they depend on, once
// each: 14.2 MB, 4.2 us at 3.35 TB/s). rcp, rcpn and div also run one
// MUFU.RCP a cell and iteration, 16 a clock an SM: 0.42 us an iteration
// over K6's 1.77 M cells, which bounds them before the FP32 pipe does.
// div adds the IEEE range check and its refinement (13 SASS an
// iteration).
//   - The elementwise kinds (elem_kernel, bf16_kernel). plain, sel,
//     mulf32 and mulbf16: a thread holds the chains of four adjacent
//     interior cells, loaded and stored as one 16-byte access each (the
//     interior starts at byte 32 YS and holds a multiple of 4 cells on
//     every layout of whole tiles) and run interleaved, four independent
//     chains a thread (mulbf16: the pairs (2 j, 2 j + 1), two
//     __nv_bfloat162); the grid is at most one wave of the card's SMs and
//     its threads stride over the quads. That cuts a call's fixed part (a
//     quarter of the threads and of the load and store instructions) and
//     leaves the pipes' work, which the chains already saturate, as it
//     was. div, rcp, rcpn and bmul keep the first port's cell a thread
//     (CELLS below): in quads their slopes rose (the MUFU kinds from 97 %
//     of the MUFU pipe's rate to 87 %); they drop its division of the
//     cell's index by YS, which only bmul needs, for its row.
//   - rollx (rollx_kernel): two threads hold one column of one tile's
//     window in registers, lane l (l < 16) its rows [0, H), lane l + 16
//     its rows [H, W), H = (TX + 2 M) / 2 = 40; a warp holds 16 adjacent
//     columns, so each load and store is two coalesced 64-byte runs. An
//     iteration first takes, by one __shfl_xor_sync, the other half's
//     last row (the lower half's row 0 reads window row W - 1 across the
//     wrap, the upper half's row H reads row H - 1), then updates its
//     rows H - 1 down to 1 in place from the row above (still the last
//     iteration's value), then its first row from the value taken: the
//     circular roll with no shared memory and no barrier, 40 independent
//     carriers and one SHFL a thread and iteration. (A whole column a
//     thread, 80 rows, spilled 16 bytes at 96 registers at K = 48 and
//     64 under nvcc 12.9.) The first port wrote every cell to a
//     double-buffered shared array, passed a __syncthreads() and read the
//     neighbour back (5.1 SASS a cell an iteration: 2 LDS, STS, FFMA,
//     FMUL, a BAR each 10 cells).
//   - rolly (rolly_kernel<C, LAST>): a warp holds one interior row, lane
//     l the C = ceil(YS / 32) contiguous columns [l C, l C + C) (lane 31:
//     the LAST = YS - 31 C that are left). An iteration takes the value
//     the lane's first column needs, the last column of lane l - 1 (lane
//     0: lane 31's column LAST - 1), by one __shfl_sync before it updates
//     its columns in place from the last down, as rollx does: one SHFL a
//     lane and iteration in place of a shared-memory round trip and a
//     barrier a cell. A contiguous run of C floats a lane is not a
//     coalesced access, so the row is loaded and stored through a
//     shared-memory stage of odd stride (C | 1 floats a lane, no bank
//     conflict), once a call. C and LAST are template parameters,
//     instantiated for the two probes' widths (1152: 36, 36; 1119: 35,
//     34); another width is refused (cudaErrorInvalidValue).
//   The rolls compute all TX + 2 M rows of a window (rollx) as the TPU
//   kernel does; a thread map changes where a cell is computed, not how,
//   so every kind gives the first port's bits.
//
// K is a compile-time constant (-DVPU_K, default 16), the chain unrolled,
// so each K is a library of its own (vpu_probe@VPU_K=16, ...) and the
// SASS of two of them differs by (K1 - K0) iterations of each kind.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef VPU_K
#define VPU_K 16
#endif

namespace {

constexpr int K = VPU_K;             // dependent iterations of the chain
constexpr int TX = 64;               // rows of a tile's output
constexpr int M = 8;                 // margin rows around it
constexpr int W = TX + 2 * M;        // rows of a window
constexpr int H = W / 2;             // rollx: rows a thread holds
static_assert(W % 2 == 0, "rollx: two threads a window column");
constexpr float C1 = 0.999f, C2 = 1e-4f, SQ = 0.9999f;

enum Kind {
  PLAIN, DIV, RCP, RCPN, SEL, BMUL, ROLLX, ROLLY, MULF32, MULBF16, N_KINDS
};

constexpr int NTHREADS = 256;        // the elementwise kinds
constexpr int WARPS = 4;             // the rolls: warps a block
// The interior cells a thread of each elementwise kind holds: 4 (quads),
// or 1 (the first port's map). rollx's thread holds H window rows;
// rolly's C columns. div, rcp, rcpn and bmul keep the first
// port's map: in quads their slopes rose 3-15 %, to 1.012-1.078 x its
// time at K = 64 in turns with it (H100 80GB HBM3, 700 W).
constexpr int CELLS[N_KINDS] = {4, 1, 1, 1, 4, 1, H, 0, 4, 4};
// rolly's widths: YS = 31 C + LAST, C = ceil(YS / 32)
constexpr int ROLLY_C[2] = {36, 35}, ROLLY_LAST[2] = {36, 34};

__device__ __forceinline__ float carrier(float b, float op) {
  return __fmaf_rn(b, C1, __fmul_rn(op, C2));
}

__device__ __forceinline__ float rcp_approx(float b) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  return r;
}

// op(b) of an elementwise kind: a the cell's input, row bmul's row value
template <int KIND>
__device__ __forceinline__ float op_of(float b, float a, float row) {
  if constexpr (KIND == PLAIN) {
    return b;
  } else if constexpr (KIND == DIV) {
    return __fdiv_rn(a, b);
  } else if constexpr (KIND == RCP) {
    return rcp_approx(b);
  } else if constexpr (KIND == RCPN) {
    const float q = rcp_approx(b);
    return q * (2.f - b * q);
  } else if constexpr (KIND == SEL) {
    return b > 0.5f ? b : a;
  } else {
    static_assert(KIND == BMUL, "an elementwise kind");
    return __fmul_rn(b, row);
  }
}

// The chains of N cells, interleaved: b from a (and bmul's rows).
template <int KIND, int N>
__device__ __forceinline__ void chains(float (&b)[N], const float (&a)[N],
                                       const float (&row)[N]) {
  if constexpr (KIND == MULF32) {
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = __fmul_rn(a[j], SQ);
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j) b[j] = __fmul_rn(b[j], b[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = a[j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        b[j] = carrier(b[j], op_of<KIND>(b[j], a[j], row[j]));
    }
  }
}

// The elementwise kinds. N = 1: interior cell i a thread, a thread per
// cell (the first port's map). N = 4: the quads of interior cells [4 q,
// 4 q + 4), a float4 in and out, the grid striding (not bmul, whose row
// would be one a cell).
template <int KIND, int N>
__global__ void __launch_bounds__(NTHREADS)
elem_kernel(const float* x, float* y, int xs, int ys) {
  static_assert(N == 1 || (N == 4 && KIND != BMUL),
                "one cell a thread, or a quad of any kind but bmul");
  const long long cells = (long long)(xs - 2 * M) * ys;
  const float* xi = x + (size_t)M * ys;          // the interior
  float* yi = y + (size_t)M * ys;
  if constexpr (N == 1) {
    const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
    if (i >= cells) return;
    float a[1] = {xi[i]}, row[1] = {0.f}, b[1];
    if constexpr (KIND == BMUL) {
      // the window row 0 of the cell's tile: global row (i / ys) / TX TX
      const int r = (int)(i / ys), c = (int)(i - (long long)r * ys);
      row[0] = x[(size_t)(r / TX * TX) * ys + c];
    }
    chains<KIND>(b, a, row);
    yi[i] = b[0];
  } else {
    const float4* xq = reinterpret_cast<const float4*>(xi);
    float4* yq = reinterpret_cast<float4*>(yi);
    const long long quads = cells / 4;
    for (long long q = (long long)blockIdx.x * NTHREADS + threadIdx.x;
         q < quads; q += (long long)gridDim.x * NTHREADS) {
      const float4 v = xq[q];
      const float a[4] = {v.x, v.y, v.z, v.w}, row[4] = {};
      float b[4];
      chains<KIND>(b, a, row);
      yq[q] = make_float4(b[0], b[1], b[2], b[3]);
    }
  }
}

// mulbf16: the two pairs (2 j, 2 j + 1) of a quad of interior cells a
// thread, a float4 in and out, the grid striding.
__global__ void __launch_bounds__(NTHREADS)
bf16_kernel(const float* x, float* y, int xs, int ys) {
  const long long quads = (long long)(xs - 2 * M) * ys / 4;
  const float4* xq = reinterpret_cast<const float4*>(x + (size_t)M * ys);
  float4* yq = reinterpret_cast<float4*>(y + (size_t)M * ys);
  for (long long q = (long long)blockIdx.x * NTHREADS + threadIdx.x;
       q < quads; q += (long long)gridDim.x * NTHREADS) {
    const float4 v = xq[q];
    __nv_bfloat162 b0 = __floats2bfloat162_rn(__fmul_rn(v.x, SQ),
                                              __fmul_rn(v.y, SQ));
    __nv_bfloat162 b1 = __floats2bfloat162_rn(__fmul_rn(v.z, SQ),
                                              __fmul_rn(v.w, SQ));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      b0 = __hmul2(b0, b0);
      b1 = __hmul2(b1, b1);
    }
    yq[q] = make_float4(__low2float(b0), __high2float(b0),
                        __low2float(b1), __high2float(b1));
  }
}

// rollx: column c of tile t's window a pair of threads, lanes l and l ^ 16
// of a warp of 16 columns, the lower one the window's rows [0, H), the
// upper one [H, W), in registers; warp w of the grid holds tile w / wpr,
// columns 16 (w % wpr) + (lane & 15). A column past ys computes zeros and
// stores nothing (both of its threads, which the shuffle needs).
__global__ void __launch_bounds__(32 * WARPS)
rollx_kernel(const float* __restrict__ x, float* __restrict__ y, int tiles,
             int ys) {
  const int wpr = (ys + 15) / 16;                 // warps a tile
  const int w = blockIdx.x * WARPS + threadIdx.x / 32;
  const int t = w / wpr;
  if (t >= tiles) return;                         // the whole warp
  const int lane = threadIdx.x & 31, half = lane >> 4;
  const int c = (w - t * wpr) * 16 + (lane & 15);
  const bool on = c < ys;
  const size_t row0 = (size_t)t * TX + half * H;  // the thread's first row
  const float* src = x + row0 * ys + c;
  float b[H];
#pragma unroll
  for (int r = 0; r < H; ++r) b[r] = on ? src[(size_t)r * ys] : 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // the row before the thread's first (window row W - 1 for the lower
    // half, H - 1 for the upper), as the other half held it before this
    // iteration
    const float before = __shfl_xor_sync(0xffffffffu, b[H - 1], 16);
#pragma unroll
    for (int r = H - 1; r > 0; --r) b[r] = carrier(b[r], b[r - 1]);
    b[0] = carrier(b[0], before);
  }
  if (!on) return;
  // the output rows: window rows [M, M + TX), global row0 + r
  float* dst = y + row0 * ys + c;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const int wr = half * H + r;
    if (wr >= M && wr < M + TX) dst[(size_t)r * ys] = b[r];
  }
}

// rolly: interior row blockIdx.x WARPS + warp a warp, lane l holding its
// columns [l C, l C + C) (lane 31: LAST of them) in registers.
template <int C, int LAST>
__global__ void __launch_bounds__(32 * WARPS)
rolly_kernel(const float* __restrict__ x, float* __restrict__ y, int rows) {
  constexpr int YS = 31 * C + LAST;
  constexpr int P = C | 1;             // a lane's stride in the stage: odd
  static_assert(LAST >= 1 && LAST <= C, "lane 31 holds 1 to C columns");
  __shared__ float stage[WARPS][32 * P];
  const int lane = threadIdx.x & 31, wi = threadIdx.x / 32;
  const int row = blockIdx.x * WARPS + wi;
  if (row >= rows) return;             // the whole warp
  float* s = stage[wi];
  const float* src = x + (size_t)(M + row) * YS;
  float* dst = y + (size_t)(M + row) * YS;
  for (int i = lane; i < YS; i += 32) s[i / C * P + i % C] = src[i];
  __syncwarp();
  float b[C];
#pragma unroll
  for (int j = 0; j < C; ++j)
    b[j] = (LAST == C || lane < 31 || j < LAST) ? s[lane * P + j] : 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // the value column l C - 1 held before this iteration (lane 0: YS - 1)
    const float send =
        (LAST == C || lane < 31) ? b[C - 1] : b[LAST - 1];
    const float carried = __shfl_sync(0xffffffffu, send, (lane + 31) & 31);
#pragma unroll
    for (int j = C - 1; j > 0; --j) b[j] = carrier(b[j], b[j - 1]);
    b[0] = carrier(b[0], carried);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (LAST == C || lane < 31 || j < LAST) s[lane * P + j] = b[j];
  __syncwarp();
  for (int i = lane; i < YS; i += 32) dst[i] = s[i / C * P + i % C];
}

int sm_count() {
  static int n[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!n[dev])
    cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

// Blocks of NTHREADS for `units` thread items: at most one wave of the
// card's SMs (the threads stride over the rest), none short of it;
// per_sm, the kernel's resident blocks an SM, is asked once (a static of
// the caller, one a kernel).
template <typename Kern>
int wave_blocks(Kern kern, int& per_sm, long long units) {
  if (!per_sm)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTHREADS,
                                                  0);
  const long long need = (units + NTHREADS - 1) / NTHREADS;
  const long long wave = (long long)per_sm * sm_count();
  return (int)(wave > 0 && need > wave ? wave : need);
}

template <int KIND>
void launch_elem(const float* x, float* y, int xs, int ys, cudaStream_t s) {
  constexpr int N = CELLS[KIND];
  const long long cells = (long long)(xs - 2 * M) * ys;
  if constexpr (N == 1) {
    elem_kernel<KIND, 1><<<(int)((cells + NTHREADS - 1) / NTHREADS),
                           NTHREADS, 0, s>>>(x, y, xs, ys);
  } else {
    static int per_sm = 0;
    const int blocks = wave_blocks(elem_kernel<KIND, 4>, per_sm, cells / 4);
    elem_kernel<KIND, 4><<<blocks, NTHREADS, 0, s>>>(x, y, xs, ys);
  }
}

// rolly's instantiation for width ys: its index in ROLLY_C, or -1
int rolly_form(int ys) {
  for (int f = 0; f < 2; ++f)
    if (ys == 31 * ROLLY_C[f] + ROLLY_LAST[f]) return f;
  return -1;
}

// One call of kind `kind` from x into y.
int launch(const float* x, float* y, int kind, int xs, int ys,
           cudaStream_t s) {
  const int rows = xs - 2 * M, tiles = rows / TX;
  switch (kind) {
    case PLAIN: launch_elem<PLAIN>(x, y, xs, ys, s); break;
    case DIV: launch_elem<DIV>(x, y, xs, ys, s); break;
    case RCP: launch_elem<RCP>(x, y, xs, ys, s); break;
    case RCPN: launch_elem<RCPN>(x, y, xs, ys, s); break;
    case SEL: launch_elem<SEL>(x, y, xs, ys, s); break;
    case BMUL: launch_elem<BMUL>(x, y, xs, ys, s); break;
    case MULF32: launch_elem<MULF32>(x, y, xs, ys, s); break;
    case MULBF16: {
      static int per_sm = 0;
      bf16_kernel<<<wave_blocks(bf16_kernel, per_sm,
                                (long long)rows * ys / 4),
                    NTHREADS, 0, s>>>(x, y, xs, ys);
      break;
    }
    case ROLLX: {
      const int warps = tiles * ((ys + 15) / 16);
      rollx_kernel<<<(warps + WARPS - 1) / WARPS, 32 * WARPS, 0, s>>>(
          x, y, tiles, ys);
      break;
    }
    case ROLLY: {
      const int blocks = (rows + WARPS - 1) / WARPS;
      switch (rolly_form(ys)) {
        case 0:
          rolly_kernel<ROLLY_C[0], ROLLY_LAST[0]>
              <<<blocks, 32 * WARPS, 0, s>>>(x, y, rows);
          break;
        case 1:
          rolly_kernel<ROLLY_C[1], ROLLY_LAST[1]>
              <<<blocks, 32 * WARPS, 0, s>>>(x, y, rows);
          break;
        default:
          return (int)cudaErrorInvalidValue;
      }
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The compile-time constants the wrapper checks: K, the tile's rows, the
// margin, the number of kinds.
int vpu_k() { return K; }
int vpu_tile_rows() { return TX; }
int vpu_margin() { return M; }
int vpu_n_kinds() { return N_KINDS; }

const char* vpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// n carried calls of kind `kind` on the (xs, ys) f32 layout, on `stream`:
// call 0 reads x and writes y0, call s > 0 reads the output of call s - 1
// and writes y0 (s even) or y1 (s odd); the last call's output is
// y[(n - 1) % 2] (y1 may be null for n = 1). Only the interior rows [M,
// xs - M) are written. x may not be y0 or y1 (neighbouring windows
// overlap). Returns 0, or the first launch's error; xs - 2 M must be a
// positive multiple of the tile's rows, ys even for mulbf16, one of
// rolly's widths for rolly, and x, y0, y1 16-byte aligned (the quads).
int vpu_run(const float* x, float* y0, float* y1, int kind, int n, int xs,
            int ys, void* stream) {
  if (n < 1 || xs - 2 * M <= 0 || (xs - 2 * M) % TX || ys <= 0
      || (kind == MULBF16 && ys % 2) || y0 == nullptr || x == y0 || x == y1
      || (n > 1 && (y1 == nullptr || y0 == y1))
      || (kind == ROLLY && rolly_form(ys) < 0)
      || ((uintptr_t)x | (uintptr_t)y0 | (uintptr_t)y1) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* src = x;
  for (int c = 0; c < n; ++c) {
    float* dst = c % 2 ? y1 : y0;
    const int rc = launch(src, dst, kind, xs, ys, s);
    if (rc) return rc;
    src = dst;
  }
  return 0;
}

}  // extern "C"
