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
//   times b = b * b; mulbf16, the same in bf16, two columns a thread in
//   packed __nv_bfloat162 (__hmul2, the card's bf16 elementwise path).
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
// The window does not fit a block's shared memory (80 x 1152 f32 is 360
// KB, a block gets 227 KB), so the decomposition follows the op: the
// elementwise kinds keep the chain in registers, one output cell a thread
// (two for mulbf16) and only the output rows; rollx runs a strip of 32
// columns of all 80 window rows a block, rolly 4 whole rows of YS columns
// a block, each iteration reading the neighbour from shared memory
// (double-buffered, one barrier an iteration), as K1 reads s_ud[k + S].
//
// What bounds it: at K = 16 memory (the output rows and the input rows
// they depend on, once each: 14.2 MB, 4.2 us at 3.35 TB/s), at K = 64 the
// chain: 2 FP32 instructions an output cell an iteration, 226 M at K = 64,
// 6.8 us at 132 SMs x 128 lanes x 1.98 GHz. So at K = 16 the slope of the
// time against K can understate an op.
//
// K is a compile-time constant (-DVPU_K, default 16), the chain unrolled,
// so each K is a library of its own (vpu_probe@VPU_K=16, ...) and the
// SASS of two of them differs by (K1 - K0) iterations of each kind.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef VPU_K
#define VPU_K 16
#endif

namespace {

constexpr int K = VPU_K;             // dependent iterations of the chain
constexpr int TX = 64;               // rows of a tile's output
constexpr int M = 8;                 // margin rows around it
constexpr int W = TX + 2 * M;        // rows of a window
constexpr float C1 = 0.999f, C2 = 1e-4f, SQ = 0.9999f;

enum Kind {
  PLAIN, DIV, RCP, RCPN, SEL, BMUL, ROLLX, ROLLY, MULF32, MULBF16, N_KINDS
};

constexpr int NTHREADS = 256;        // elementwise kinds and rolly
constexpr int CW = 32, RY = 8;       // rollx: columns a block, thread rows
constexpr int RR = 4;                // rolly: rows a block
static_assert(W % RY == 0 && TX % RR == 0, "the rolls' blocks tile");

__device__ __forceinline__ float carrier(float b, float op) {
  return __fmaf_rn(b, C1, __fmul_rn(op, C2));
}

__device__ __forceinline__ float rcp_approx(float b) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  return r;
}

// The elementwise kinds: output cell i of the interior rows [M, xs - M).
template <int KIND>
__global__ void __launch_bounds__(NTHREADS)
elem_kernel(const float* x, float* y, int xs, int ys) {
  const long long n = (long long)(xs - 2 * M) * ys;
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  const int r = M + (int)(i / ys), c = (int)(i % ys);
  const size_t g = (size_t)r * ys + c;
  const float a = x[g];
  float b;
  if constexpr (KIND == MULF32) {
    b = __fmul_rn(a, SQ);
#pragma unroll
    for (int k = 0; k < K; ++k) b = __fmul_rn(b, b);
  } else {
    float row = 0.f;
    if constexpr (KIND == BMUL) row = x[(size_t)((r - M) / TX * TX) * ys + c];
    b = a;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float op;
      if constexpr (KIND == PLAIN) {
        op = b;
      } else if constexpr (KIND == DIV) {
        op = __fdiv_rn(a, b);
      } else if constexpr (KIND == RCP) {
        op = rcp_approx(b);
      } else if constexpr (KIND == RCPN) {
        const float q = rcp_approx(b);
        op = q * (2.f - b * q);
      } else if constexpr (KIND == SEL) {
        op = b > 0.5f ? b : a;
      } else {
        static_assert(KIND == BMUL, "an elementwise kind");
        op = __fmul_rn(b, row);
      }
      b = carrier(b, op);
    }
  }
  y[g] = b;
}

// mulbf16: the output cells 2 j, 2 j + 1 of a row, packed.
__global__ void __launch_bounds__(NTHREADS)
bf16_kernel(const float* x, float* y, int xs, int ys) {
  const int half = ys / 2;
  const long long n = (long long)(xs - 2 * M) * half;
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  const size_t g = (size_t)(M + i / half) * ys + 2 * (int)(i % half);
  __nv_bfloat162 b = __floats2bfloat162_rn(__fmul_rn(x[g], SQ),
                                           __fmul_rn(x[g + 1], SQ));
#pragma unroll
  for (int k = 0; k < K; ++k) b = __hmul2(b, b);
  y[g] = __low2float(b);
  y[g + 1] = __high2float(b);
}

// rollx: a strip of CW columns of tile blockIdx.y's window, all W rows.
__global__ void __launch_bounds__(CW * RY)
rollx_kernel(const float* x, float* y, int ys) {
  __shared__ float buf[2][W][CW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * CW + tx;
  const size_t row0 = (size_t)blockIdx.y * TX;
  const bool on = c < ys;
#pragma unroll
  for (int j = 0; j < W / RY; ++j) {
    const int r = ty + j * RY;
    buf[0][r][tx] = on ? x[(row0 + r) * ys + c] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k & 1;
#pragma unroll
    for (int j = 0; j < W / RY; ++j) {
      const int r = ty + j * RY;
      const int rm = r == 0 ? W - 1 : r - 1;
      buf[s ^ 1][r][tx] = carrier(buf[s][r][tx], buf[s][rm][tx]);
    }
    __syncthreads();
  }
  if (!on) return;
#pragma unroll
  for (int j = 0; j < W / RY; ++j) {
    const int r = ty + j * RY;
    if (r >= M && r < M + TX) y[(row0 + r) * ys + c] = buf[K & 1][r][tx];
  }
}

// rolly: the RR interior rows M + blockIdx.x RR ... of all ys columns.
__global__ void __launch_bounds__(NTHREADS)
rolly_kernel(const float* x, float* y, int ys) {
  extern __shared__ float sm[];        // [2][RR][ys]
  const int n = RR * ys;
  const size_t g0 = (size_t)(M + blockIdx.x * RR) * ys;
  for (int i = threadIdx.x; i < n; i += NTHREADS) sm[i] = x[g0 + i];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float* cur = sm + (k & 1) * n;
    float* nxt = sm + ((k & 1) ^ 1) * n;
    for (int c = threadIdx.x; c < ys; c += NTHREADS) {
      const int cm = c == 0 ? ys - 1 : c - 1;
#pragma unroll
      for (int rr = 0; rr < RR; ++rr)
        nxt[rr * ys + c] = carrier(cur[rr * ys + c], cur[rr * ys + cm]);
    }
    __syncthreads();
  }
  const float* fin = sm + (K & 1) * n;
  for (int i = threadIdx.x; i < n; i += NTHREADS) y[g0 + i] = fin[i];
}

// One call of kind `kind` from x into y.
int launch(const float* x, float* y, int kind, int xs, int ys,
           cudaStream_t s) {
  const long long cells = (long long)(xs - 2 * M) * ys;
  const int blocks = (int)((cells + NTHREADS - 1) / NTHREADS);
  switch (kind) {
    case PLAIN: elem_kernel<PLAIN><<<blocks, NTHREADS, 0, s>>>(x, y, xs, ys);
      break;
    case DIV: elem_kernel<DIV><<<blocks, NTHREADS, 0, s>>>(x, y, xs, ys);
      break;
    case RCP: elem_kernel<RCP><<<blocks, NTHREADS, 0, s>>>(x, y, xs, ys);
      break;
    case RCPN: elem_kernel<RCPN><<<blocks, NTHREADS, 0, s>>>(x, y, xs, ys);
      break;
    case SEL: elem_kernel<SEL><<<blocks, NTHREADS, 0, s>>>(x, y, xs, ys);
      break;
    case BMUL: elem_kernel<BMUL><<<blocks, NTHREADS, 0, s>>>(x, y, xs, ys);
      break;
    case MULF32:
      elem_kernel<MULF32><<<blocks, NTHREADS, 0, s>>>(x, y, xs, ys);
      break;
    case MULBF16:
      bf16_kernel<<<(int)((cells / 2 + NTHREADS - 1) / NTHREADS), NTHREADS,
                    0, s>>>(x, y, xs, ys);
      break;
    case ROLLX:
      rollx_kernel<<<dim3((ys + CW - 1) / CW, (xs - 2 * M) / TX),
                     dim3(CW, RY), 0, s>>>(x, y, ys);
      break;
    case ROLLY: {
      const size_t smem = sizeof(float) * 2 * RR * ys;
      cudaError_t e = cudaFuncSetAttribute(
          rolly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
      rolly_kernel<<<(xs - 2 * M) / RR, NTHREADS, smem, s>>>(x, y, ys);
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
// overlap). Returns 0, or the first
// launch's error; xs - 2 M must be a positive multiple of the tile's rows,
// and ys even for mulbf16.
int vpu_run(const float* x, float* y0, float* y1, int kind, int n, int xs,
            int ys, void* stream) {
  if (n < 1 || xs - 2 * M <= 0 || (xs - 2 * M) % TX || ys <= 0
      || (kind == MULBF16 && ys % 2) || y0 == nullptr || x == y0 || x == y1
      || (n > 1 && (y1 == nullptr || y0 == y1)))
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
