// Fused AdamW update for Hopper (sm_90a): one pass over p, g, m and v.
//
// Replaces the TPU kernel `adamw_2d` (body `_adamw_kernel`) of
// src/repro/kernels/fused_adamw.py.  The plain PyTorch version of the same
// function is `adamw_plain` in src/repro_torch/kernels/fused_adamw.py,
// which this kernel follows operation for operation:
//
//     m <- b1*m + (1-b1)*g
//     v <- b2*v + ((1-b2)*g)*g
//     p <- p - lr * ( (m*c1) / (sqrt(v*c2) + eps) + wd*p )
//
// with the math in f32, p and g in f32 or bf16, m and v in f32, and the
// scalars read from the packed vector hp = [lr, b1, b2, eps, wd, c1, c2, 0]
// in device memory, so the optimizer step never waits for the host.
// p, m and v are updated in place (the reference's donated buffers).
//
// What bounds it on an H100: bytes.  Each element reads p, g, m, v and
// writes p, m, v: 28 B in f32, 22 B with bf16 p and g, for ~15 flops, far
// below the card's flop/byte balance.  One training step of chatglm3-6b cut
// to 8 layers moves ~47.6 GB here, ~14.2 ms at 3.35 TB/s.
//
// What the design does about it: every byte is touched once, in a 1-D
// grid-stride loop where each thread handles 4 consecutive elements with
// vector loads (16 B for the f32 operands, 8 B for bf16 p and g) and
// neighbouring threads take neighbouring addresses; a scalar tail takes
// any length and unaligned operands.  The TPU's (rows, 128) blocks and
// their padding have no counterpart.
//
// Numerics: every operation is one IEEE-rounded step in the reference
// order (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn, never
// contracted into an FMA), and 1-b1, 1-b2 are taken in f32 from hp as the
// TPU kernel takes them.  m and v then match `adamw_plain` bit for bit and
// p rounds once to its dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Hparams {
  float lr, b1, b2, eps, wd, c1, c2, one_m_b1, one_m_b2;
};

__device__ __forceinline__ Hparams load_hparams(const float* __restrict__ hp) {
  Hparams h;
  h.lr = hp[0];
  h.b1 = hp[1];
  h.b2 = hp[2];
  h.eps = hp[3];
  h.wd = hp[4];
  h.c1 = hp[5];
  h.c2 = hp[6];
  h.one_m_b1 = __fsub_rn(1.0f, h.b1);
  h.one_m_b2 = __fsub_rn(1.0f, h.b2);
  return h;
}

// One element: updates m and v in place and returns the new p in f32.
__device__ __forceinline__ float adamw_one(const Hparams& h, float p, float g, float& m,
                                           float& v) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_m_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.one_m_b2, g), g));
  const float m_hat = __fmul_rn(m, h.c1);
  const float v_hat = __fmul_rn(v, h.c2);
  const float denom = __fadd_rn(__fsqrt_rn(v_hat), h.eps);
  const float update = __fadd_rn(__fdiv_rn(m_hat, denom), __fmul_rn(h.wd, p));
  return __fsub_rn(p, __fmul_rn(h.lr, update));
}

// kVec consecutive elements of T, loaded and stored as one vector access.
template <typename T>
struct alignas(kVec * sizeof(T)) Pack {
  T v[kVec];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const float* __restrict__ hp, T* __restrict__ p, const T* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v, int64_t n) {
  const Hparams h = load_hparams(hp);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g)) % sizeof(Pack<T>) == 0) &&
      ((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) % sizeof(float4) == 0);
  int64_t done = 0;
  if (aligned) {
    const int64_t packs = n / kVec;
    Pack<T>* pp = reinterpret_cast<Pack<T>*>(p);
    const Pack<T>* gp = reinterpret_cast<const Pack<T>*>(g);
    float4* mp = reinterpret_cast<float4*>(m);
    float4* vp = reinterpret_cast<float4*>(v);
    for (int64_t i = tid; i < packs; i += stride) {
      Pack<T> pv = pp[i];
      const Pack<T> gv = gp[i];
      float4 mv = mp[i];
      float4 vv = vp[i];
      float* ms = reinterpret_cast<float*>(&mv);
      float* vs = reinterpret_cast<float*>(&vv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        pv.v[j] = from_f<T>(adamw_one(h, to_f(pv.v[j]), to_f(gv.v[j]), ms[j], vs[j]));
      }
      pp[i] = pv;
      mp[i] = mv;
      vp[i] = vv;
    }
    done = packs * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float mi = m[i];
    float vi = v[i];
    p[i] = from_f<T>(adamw_one(h, to_f(p[i]), to_f(g[i]), mi, vi));
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename T>
int launch(const void* hp, void* p, const void* g, void* m, void* v, int64_t n,
           void* stream) {
  if (n <= 0) return 0;
  const int64_t work = (n + kVec - 1) / kVec;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adamw_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hp), static_cast<T*>(p), static_cast<const T*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, one per dtype of p and g (m, v and hp are f32).
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_adamw_f32(const void* hp, void* p, const void* g, void* m, void* v,
                               int64_t n, void* stream) {
  return launch<float>(hp, p, g, m, v, n, stream);
}

extern "C" int fused_adamw_bf16(const void* hp, void* p, const void* g, void* m, void* v,
                                int64_t n, void* stream) {
  return launch<__nv_bfloat16>(hp, p, g, m, v, n, stream);
}
