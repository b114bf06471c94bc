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
// What the design does about it: a 1-D grid-stride loop in which each
// thread moves 16 bytes per load and store (a float4, or 8 bf16), with
// neighbouring threads on neighbouring addresses, so every access is a
// full, coalesced 128-bit transaction; a scalar tail handles any n and any
// operand that is not 16-byte aligned.  The TPU's (rows, 128) lane layout
// and its padding have no counterpart: the kernel reads the flat tensors.
//
// Numerics follow eager PyTorch's `a * x + y`: `a` arrives already rounded
// to x's dtype; the product and the sum are rounded separately
// (__fmul_rn/__fadd_rn, never contracted into an FMA), and in bf16 each is
// rounded to bf16 on its own, so the kernel is bit-exact against
// `daxpy_plain` on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100

__device__ __forceinline__ float axpy(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__device__ __forceinline__ __nv_bfloat16 axpy(float a, __nv_bfloat16 x, __nv_bfloat16 y) {
  const float prod = __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, __bfloat162float(x))));
  return __float2bfloat16_rn(__fadd_rn(prod, __bfloat162float(y)));
}

// 16 bytes of T, loaded and stored as one 128-bit access.
template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    daxpy_kernel(float a, const T* __restrict__ x, const T* __restrict__ y,
                 T* __restrict__ o, int64_t n) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  int64_t done = 0;
  if (aligned) {
    const int64_t packs = n / kVec;
    const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(x);
    const Pack<T>* yp = reinterpret_cast<const Pack<T>*>(y);
    Pack<T>* op = reinterpret_cast<Pack<T>*>(o);
    for (int64_t i = tid; i < packs; i += stride) {
      const Pack<T> xv = xp[i];
      const Pack<T> yv = yp[i];
      Pack<T> ov;
#pragma unroll
      for (int j = 0; j < kVec; ++j) ov.v[j] = axpy(a, xv.v[j], yv.v[j]);
      op[i] = ov;
    }
    done = packs * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride) o[i] = axpy(a, x[i], y[i]);
}

template <typename T>
int launch(float a, const void* x, const void* y, void* o, int64_t n, void* stream) {
  if (n <= 0) return 0;
  constexpr int64_t kVec = 16 / sizeof(T);
  const int64_t work = (n + kVec - 1) / kVec;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
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
