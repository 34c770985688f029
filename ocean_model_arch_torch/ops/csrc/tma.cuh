// Hopper's Tensor Memory Accelerator (TMA) for the port's kernels: one
// thread asks for a whole 2D box of an f32 array to be copied into shared
// memory; the hardware computes the addresses, fills the cells outside the
// array with zeros and reports the bytes to an mbarrier in shared memory,
// on which the block waits.
//
// Host: the tensor map of a (Xs, Ys) row-major f32 array and a box of
// rows x cols cells, encoded through the driver's cuTensorMapEncodeTiled,
// which the runtime hands out (cudaGetDriverEntryPoint), so that a library
// needs no -lcuda. Maps are cached by (pointer, Xs, Ys, box): a steady
// step loop, whose inputs cycle through a few addresses of the caching
// allocator, encodes none; the key holds the pointer, so a reused address
// gets a map that is still right. What TMA refuses (an address or a row
// not a multiple of 16 bytes, a box row not a multiple of 16 bytes, a box
// side above 256) is an error, never a fallback.
//
// Device: the mbarrier (init, expect_tx, wait on a phase's parity) and the
// 2D box load, in PTX.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace tma {

// ---- host -----------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// the driver's encoder, or null where the driver has none
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// Whether TMA takes a box of rows x cols f32 cells of a (Xs, Ys) array at
// `base`: 16-byte aligned address and rows, a box row of a multiple of 16
// bytes, at most 256 cells a side.
inline bool box_ok(const float* base, int Xs, int Ys, int rows, int cols) {
  return base != nullptr && ((uintptr_t)base & 15) == 0 && Xs > 0
      && Ys > 0 && (Ys & 3) == 0 && rows >= 1 && rows <= 256 && cols >= 4
      && cols <= 256 && (cols & 3) == 0;
}

// *out = the map of the (Xs, Ys) f32 array at `base` whose box is rows x
// cols cells (cells outside the array read as zeros); returns 0, or a CUDA
// error: cudaErrorInvalidValue for what TMA refuses, cudaErrorNotSupported
// where the driver has no encoder.
inline int map_2d(CUtensorMap* out, const float* base, int Xs, int Ys,
                  int rows, int cols) {
  struct Entry {
    const float* base;
    int Xs, Ys, rows, cols;
    CUtensorMap map;
  };
  constexpr int N = 1024;           // direct-mapped
  static Entry cache[N];
  static std::mutex lock;
  if (!box_ok(base, Xs, Ys, rows, cols)) return (int)cudaErrorInvalidValue;
  const uintptr_t h = ((uintptr_t)base >> 4) * 0x9E3779B97F4A7C15ull
      ^ (uintptr_t)(Xs * 31 + Ys) ^ (uintptr_t)(rows << 9 | cols) << 40;
  Entry& c = cache[(h >> 32) % N];
  std::lock_guard<std::mutex> g(lock);
  if (c.base == base && c.Xs == Xs && c.Ys == Ys && c.rows == rows
      && c.cols == cols) {
    *out = c.map;
    return 0;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)Ys, (cuuint64_t)Xs};
  const cuuint64_t strides[1] = {(cuuint64_t)Ys * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      &c.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)base, dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);      // zeros, never NaN
  if (r != CUDA_SUCCESS) {
    c.base = nullptr;
    return (int)cudaErrorInvalidValue;
  }
  c.base = base; c.Xs = Xs; c.Ys = Ys; c.rows = rows; c.cols = cols;
  *out = c.map;
  return 0;
}

// ---- device ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The first 128-byte boundary at or after p, a pointer into shared memory
// (a box lands there), by pointer arithmetic on p, so that the compiler
// keeps its accesses shared-memory instructions (LDS, STS) and not generic
// ones, as a pointer rebuilt from an integer would make them.
__device__ __forceinline__ float* align128(float* p) {
  return p + ((0u - smem(p)) & 127u) / sizeof(float);
}

// one thread: the barrier expects one arrival a phase; the fences make its
// state visible to the copies the thread issues next
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void bar_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the issuing thread's arrival, with the bytes the phase's boxes bring
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
}

// every thread that reads the boxes: until the phase of this parity ends
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem(bar)), "r"(parity) : "memory");
}

// The box of `map` whose first cell is (row x, column y) of the array (both
// may lie outside it; y a multiple of 4: the card faults, an illegal
// instruction, on a box whose row begins off 16 bytes) into shared memory
// at dst (128-byte aligned), its bytes counted on bar.
__device__ __forceinline__ void load_2d(float* dst, const CUtensorMap* map,
                                        uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem(dst)), "l"((uint64_t)map), "r"(smem(bar)), "r"(y), "r"(x)
      : "memory");
}

}  // namespace tma
