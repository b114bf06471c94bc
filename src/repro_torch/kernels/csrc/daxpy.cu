// DAXPY for Hopper (sm_90a): o = a*x + y, elementwise, any length.
//
// Replaces the TPU kernel `daxpy_2d` (body `_daxpy_kernel`) of
// src/repro/kernels/daxpy.py, the paper's own offloaded kernel.  The plain
// PyTorch version of the same function is `daxpy_plain` in
// src/repro_torch/kernels/daxpy.py.
//
// What bounds it on an H100: bytes.  Each element reads x and y and writes o
// (12 B in f32, 6 B in bf16) for 2 flops, so the least time is the bytes
// over 3.35 TB/s: 0.481 ms at n = 2^27 in f32.  At small n a launch costs
// a few microseconds whatever it does; that launch floor, against the
// streaming time that grows with n, is the offload overhead the paper
// models.
//
// What the design does about it: as PyTorch's vectorised elementwise loop,
// one tile per block.  A block of 256 threads takes a tile of 2 * 256
// 16-byte packs (a float4, or 8 bf16); each thread loads its 2 packs of x
// and its 2 of y, all 4 loads independent and in flight before any
// arithmetic, with neighbouring threads on neighbouring addresses, so every
// access is a full, coalesced 128-bit transaction.  The grid is the number
// of tiles; a scalar loop handles the tail and any operand that is not
// 16-byte aligned.  The TPU's (rows, 128) lane layout and its padding have
// no counterpart: the kernel reads the flat tensors.  PERF.md has the
// times of the variants this was chosen from (unroll 1-8, streaming cache
// hints, a grid of the resident capacity).
//
// Numerics follow eager PyTorch's `a * x + y`: `a` arrives already rounded
// to x's dtype; the product and the sum are rounded separately
// (__fmul_rn/__fadd_rn, never contracted into an FMA), and in bf16 each is
// rounded to bf16 on its own, so the kernel is bit-exact against
// `daxpy_plain` on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;                          // packs of x (and y) per thread
constexpr int64_t kTile = int64_t{kUnroll} * kThreads;  // packs per block

__device__ __forceinline__ float axpy(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__device__ __forceinline__ __nv_bfloat16 axpy(float a, __nv_bfloat16 x, __nv_bfloat16 y) {
  const float prod = __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, __bfloat162float(x))));
  return __float2bfloat16_rn(__fadd_rn(prod, __bfloat162float(y)));
}

// a*x + y on the 16 / sizeof(T) values packed in one 128-bit word.
template <typename T>
__device__ __forceinline__ int4 axpy16(float a, int4 xw, int4 yw) {
  constexpr int kVec = 16 / sizeof(T);
  T xv[kVec], yv[kVec], ov[kVec];
  memcpy(xv, &xw, 16);
  memcpy(yv, &yw, 16);
#pragma unroll
  for (int j = 0; j < kVec; ++j) ov[j] = axpy(a, xv[j], yv[j]);
  int4 ow;
  memcpy(&ow, ov, 16);
  return ow;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    daxpy_kernel(float a, const T* __restrict__ x, const T* __restrict__ y,
                 T* __restrict__ o, int64_t n) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  int64_t done = 0;
  if (aligned) {
    const int64_t packs = n / kVec;
    const int4* xp = reinterpret_cast<const int4*>(x);
    const int4* yp = reinterpret_cast<const int4*>(y);
    int4* op = reinterpret_cast<int4*>(o);
    const int64_t base = blockIdx.x * kTile + threadIdx.x;
    if (base + (kUnroll - 1) * kThreads < packs) {
      int4 xv[kUnroll], yv[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) xv[j] = xp[base + j * kThreads];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) yv[j] = yp[base + j * kThreads];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) op[base + j * kThreads] = axpy16<T>(a, xv[j], yv[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t i = base + j * kThreads;
        if (i < packs) op[i] = axpy16<T>(a, xp[i], yp[i]);
      }
    }
    done = packs * kVec;
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = done + tid; i < n; i += stride) o[i] = axpy(a, x[i], y[i]);
}

template <typename T>
int launch(float a, const void* x, const void* y, void* o, int64_t n, void* stream) {
  if (n <= 0) return 0;
  constexpr int64_t kVec = 16 / sizeof(T);
  const int64_t blocks = ((n + kVec - 1) / kVec + kTile - 1) / kTile;  // one tile each
  daxpy_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(o), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, one per dtype.  `a` is x's dtype's value as a float.
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int daxpy_f32(float a, const void* x, const void* y, void* o, int64_t n,
                         void* stream) {
  return launch<float>(a, x, y, o, n, stream);
}

extern "C" int daxpy_bf16(float a, const void* x, const void* y, void* o, int64_t n,
                          void* stream) {
  return launch<__nv_bfloat16>(a, x, y, o, n, stream);
}
