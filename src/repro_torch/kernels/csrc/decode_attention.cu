// Fused decode-attention step for Hopper (sm_90a): rope + (int8 quantise)
// + KV scatter + masked softmax attention, one launch per attention layer.
//
// Replaces the TPU kernel `fused_decode_attention` (body `_decode_kernel`)
// of src/repro/kernels/decode_attention.py.  The plain PyTorch version of
// the same function is `decode_attention_plain` in
// src/repro_torch/kernels/decode_attention.py, which this kernel follows
// step for step.
//
// What bounds it on an H100: bytes.  One decode token does ~4*H*D flops per
// cached position against 2*K*D cache elements read, i.e. about
// 2*G flop/byte in bf16 (G = H/K q heads per kv head) -- far below the
// ~295 flop/byte at which the tensor cores, not HBM, become the limit.
// The least time is the live K/V bytes over 3.35 TB/s; at the chatglm3-6b
// decode shape (B=4, S=160, K=2, D=128, bf16) that is ~0.2 us, so a launch
// is latency-bound in practice.
//
// What the design does about it: one CTA per (batch row, kv head), so the
// G q heads of a GQA group share a single pass over their K/V rows (no
// repeat_kv copy), the K/V rows past the row's length are never read, and
// the new token is written in the same launch that reads the cache.  The
// grid is only B*K CTAs (8 at the chatglm3-6b shape on 132 SMs); splitting
// the slots across CTAs (split-K) would re-associate the p@V sum and is
// left to a later change behind its own tolerance.
//
// Numerics follow the plain version:
//   * rope products and sums are rounded separately (__fmul_rn/__fadd_rn,
//     no FMA contraction) and rounded once to the activation dtype, so the
//     k-cache write is bit-exact against PyTorch's eager ops;
//   * int8 quantisation: scale = max(amax/127, 1e-8) with true division,
//     code = rint(x/scale) (half-to-even) clipped to +-127;
//   * scores accumulate in f32 and are divided (not multiplied by a
//     reciprocal) by sqrtf(D); masked slots hold NEG_INF = -0.7*FLT_MAX;
//   * one softmax over all S slots; p is rounded to the value dtype before
//     p@V, which accumulates in f32 over the live slots only (masked p is
//     exactly 0) and is cast to the activation dtype once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDPerLane = 8;  // head_dim <= 256
// -0.7 * FLT_MAX computed in double and rounded once, as Python computes it.
constexpr float kNegInf = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to dtype T and return it as f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Max that propagates NaN, as torch.amax and jnp.max do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rope of one head vector `x` (D values) at dim d: rotate the leading 2W
// dims as halves [x1 | x2] -> [x1*c - x2*s | x2*c + x1*s], keep the rest.
template <typename TA>
__device__ __forceinline__ float rope_at(const TA* x, const float* cs, const float* sn,
                                         int d, int W) {
  if (d < W) {
    const float x1 = to_f(x[d]), x2 = to_f(x[d + W]);
    return round_to<TA>(__fsub_rn(__fmul_rn(x1, cs[d]), __fmul_rn(x2, sn[d])));
  }
  if (d < 2 * W) {
    const int i = d - W;
    const float x1 = to_f(x[i]), x2 = to_f(x[d]);
    return round_to<TA>(__fadd_rn(__fmul_rn(x2, cs[i]), __fmul_rn(x1, sn[i])));
  }
  return to_f(x[d]);
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return static_cast<int8_t>(r);
}

// TA: activation dtype of q/k_new/v_new/out (float or bf16).
// TC: cache dtype, TA itself or int8_t (then k_scale/v_scale hold f32
//     per-vector scales, shape (B, S, K, 1)).
// Layouts: q/out (B,1,H,D); k_new/v_new (B,1,K,D); caches (B,S,K,D);
// lens (B,) pre-write lengths; cos/sin (B,W); scratch (B,K,G,S) f32.
template <typename TA, typename TC>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TA* __restrict__ q, const TA* __restrict__ k_new, const TA* __restrict__ v_new,
    TC* k_cache, TC* v_cache, float* k_scale, float* v_scale,
    const int* __restrict__ lens, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, TA* __restrict__ out, float* scratch,
    int S, int H, int K, int D, int W, int window, int is_ring) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  extern __shared__ float q_s[];  // (G, D) roped queries, rounded to TA

  const int b = blockIdx.x, kv = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int len = lens[b];
  const int write = is_ring ? len % S : len;
  const float* cs = cos_b + static_cast<size_t>(b) * W;
  const float* sn = sin_b + static_cast<size_t>(b) * W;

  // 1. Rope the G q heads of this kv group into shared memory.
  const TA* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    q_s[i] = rope_at(qb + static_cast<size_t>(g) * D, cs, sn, d, W);
  }

  // 2. New token: rope k, quantise k and v for int8 caches, write slot
  //    `write`.  A write past the cache is dropped, as a JAX scatter drops it.
  if (warp == 0 && write < S) {
    const TA* kn = k_new + (static_cast<size_t>(b) * K + kv) * D;
    const TA* vn = v_new + (static_cast<size_t>(b) * K + kv) * D;
    const size_t row = (static_cast<size_t>(b) * S + write) * K + kv;
    if constexpr (kQuant) {
      float kamax = 0.f, vamax = 0.f;
      for (int d = lane; d < D; d += 32) {
        kamax = nan_max(kamax, fabsf(rope_at(kn, cs, sn, d, W)));
        vamax = nan_max(vamax, fabsf(to_f(vn[d])));
      }
      kamax = warp_max(kamax);
      vamax = warp_max(vamax);
      const float ksc = nan_max(__fdiv_rn(kamax, 127.f), 1e-8f);
      const float vsc = nan_max(__fdiv_rn(vamax, 127.f), 1e-8f);
      for (int d = lane; d < D; d += 32) {
        k_cache[row * D + d] = quantize(rope_at(kn, cs, sn, d, W), ksc);
        v_cache[row * D + d] = quantize(to_f(vn[d]), vsc);
      }
      if (lane == 0) {
        k_scale[row] = ksc;
        v_scale[row] = vsc;
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        k_cache[row * D + d] = from_f<TC>(rope_at(kn, cs, sn, d, W));
        v_cache[row * D + d] = vn[d];
      }
    }
  }
  __syncthreads();  // the attention pass below reads the slot just written

  // 3. Scores of the live slots (one warp per slot, lanes across D); every
  //    other slot holds NEG_INF.
  const int n_live = min(len + 1, S);
  const float sqrt_d = sqrtf(static_cast<float>(D));
  float* sc = scratch + (static_cast<size_t>(b) * K + kv) * G * S;
  for (int pos = warp; pos < S; pos += nwarps) {
    const bool live = pos < n_live && (window == 0 || pos > len - window);
    if (!live) {
      for (int g = lane; g < G; g += 32) sc[static_cast<size_t>(g) * S + pos] = kNegInf;
      continue;
    }
    const size_t r = (static_cast<size_t>(b) * S + pos) * K + kv;
    float kreg[kMaxDPerLane];
    float ks = 1.f;
    if constexpr (kQuant) ks = k_scale[r];
#pragma unroll
    for (int j = 0; j < kMaxDPerLane; ++j) {
      const int d = lane + 32 * j;
      float kd = 0.f;
      if (d < D) {
        if constexpr (kQuant) {
          kd = round_to<TA>(__fmul_rn(to_f(k_cache[r * D + d]), ks));
        } else {
          kd = to_f(k_cache[r * D + d]);
        }
      }
      kreg[j] = kd;
    }
    for (int g = 0; g < G; ++g) {
      const float* qg = q_s + g * D;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxDPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc = fmaf(qg[d], kreg[j], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) sc[static_cast<size_t>(g) * S + pos] = __fdiv_rn(acc, sqrt_d);
    }
  }
  __syncthreads();

  // 4. One softmax over all S slots per q head (one warp per head); p is
  //    rounded to the value dtype.
  for (int g = warp; g < G; g += nwarps) {
    float* row = sc + static_cast<size_t>(g) * S;
    float m = -INFINITY;
    for (int pos = lane; pos < S; pos += 32) m = nan_max(m, row[pos]);
    m = warp_max(m);
    float sum = 0.f;
    for (int pos = lane; pos < S; pos += 32) sum += expf(__fsub_rn(row[pos], m));
    sum = warp_sum(sum);
    for (int pos = lane; pos < S; pos += 32) {
      row[pos] = round_to<TA>(__fdiv_rn(expf(__fsub_rn(row[pos], m)), sum));
    }
  }
  __syncthreads();

  // 5. out = p @ V over the live slots, f32 accumulation, one cast.
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    const float* prow = sc + static_cast<size_t>(g) * S;
    float acc = 0.f;
    for (int pos = 0; pos < n_live; ++pos) {
      const size_t r = (static_cast<size_t>(b) * S + pos) * K + kv;
      float vd;
      if constexpr (kQuant) {
        vd = round_to<TA>(__fmul_rn(to_f(v_cache[r * D + d]), v_scale[r]));
      } else {
        vd = to_f(v_cache[r * D + d]);
      }
      acc = fmaf(prow[pos], vd, acc);
    }
    out[(static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G + g) * D + d] =
        from_f<TA>(acc);
  }
}

template <typename TA, typename TC>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
           void* v_cache, void* k_scale, void* v_scale, const void* lens,
           const void* cos_b, const void* sin_b, void* out, void* scratch, int B,
           int S, int H, int K, int D, int W, int window, int is_ring,
           void* stream) {
  const size_t smem = static_cast<size_t>(H / K) * D * sizeof(float);
  auto kernel = decode_attention_kernel<TA, TC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B, K);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TA*>(q), static_cast<const TA*>(k_new),
      static_cast<const TA*>(v_new), static_cast<TC*>(k_cache),
      static_cast<TC*>(v_cache), static_cast<float*>(k_scale),
      static_cast<float*>(v_scale), static_cast<const int*>(lens),
      static_cast<const float*>(cos_b), static_cast<const float*>(sin_b),
      static_cast<TA*>(out), static_cast<float*>(scratch), S, H, K, D, W, window,
      is_ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, one per (activation, cache) dtype pair.  Each
// launches on `stream` and returns cudaGetLastError() (0 on success).
#define DECODE_ATTENTION_ENTRY(NAME, TA, TC)                                         \
  extern "C" int NAME(const void* q, const void* k_new, const void* v_new,           \
                      void* k_cache, void* v_cache, void* k_scale, void* v_scale,    \
                      const void* lens, const void* cos_b, const void* sin_b,        \
                      void* out, void* scratch, int B, int S, int H, int K, int D,   \
                      int W, int window, int is_ring, void* stream) {                \
    return launch<TA, TC>(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, lens, \
                          cos_b, sin_b, out, scratch, B, S, H, K, D, W, window,      \
                          is_ring, stream);                                          \
  }

DECODE_ATTENTION_ENTRY(decode_attention_f32, float, float)
DECODE_ATTENTION_ENTRY(decode_attention_bf16, __nv_bfloat16, __nv_bfloat16)
DECODE_ATTENTION_ENTRY(decode_attention_q8_f32, float, int8_t)
DECODE_ATTENTION_ENTRY(decode_attention_q8_bf16, __nv_bfloat16, int8_t)
