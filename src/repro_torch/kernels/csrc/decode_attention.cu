// Fused decode-attention step for Hopper (sm_90a): rope + (int8 quantise)
// + KV scatter + masked softmax attention, two launches per attention layer.
//
// Replaces the TPU kernel `fused_decode_attention` (body `_decode_kernel`)
// of src/repro/kernels/decode_attention.py.  The plain PyTorch version of
// the same function is `decode_attention_plain` in
// src/repro_torch/kernels/decode_attention.py, which this kernel follows
// step for step.
//
// What bounds it on an H100.  One decode token does ~4*H*D flops per
// cached position against 2*K*D cache elements read, i.e. about 2*G
// flop/byte in bf16 (G = H/K q heads per kv head), far below the ~295
// flop/byte at which the tensor cores, not HBM, become the limit, so at
// long S the bound is bytes: the live K/V over 3.35 TB/s.  At the
// chatglm3-6b decode shape (B=4, S=160, K=2, D=128, bf16) that is ~0.2 us,
// under the cost of one launch: there the kernel is bound by latency and by
// how many SMs it keeps busy.  One CTA per (batch row, kv head) gave 8 CTAs
// on 132 SMs, each walking the slots through chains of dependent warp
// shuffles and global loads (0.119 ms).
//
// What the design does about it: the step runs as two ordinary launches on
// the caller's stream, and the only state passed between CTAs is the f32
// score scratch (B, K, G, S) that the wrapper allocates.
//   A. decode_attention_scores, grid (B, K, NSPLIT): the slot axis is cut
//      into NSPLIT chunks (NSPLIT from shapes only, on the host).  Each CTA
//      ropes its group's G q heads into shared memory; the one CTA whose
//      chunk holds slot `write` ropes, quantises and writes the new token,
//      and is the only CTA that reads that slot.  The chunk's live K rows
//      are staged in shared memory (16-byte loads, int8 dequantised), and
//      one thread per (q head, slot) takes the dot over D from shared
//      memory: no shuffle chain.  Dead and out-of-window slots get NEG_INF.
//   B. decode_attention_pv, grid (B, K, G): one CTA per q head takes the
//      softmax over the whole score row, as one launch did before (same
//      max, sum and division, p rounded to the activation dtype), then p@V
//      over the live slots, split across the warps with 16-byte V loads.
//      The warp partials are summed in a fixed order through shared
//      memory, so the output is the same from run to run (no atomics).
// At the serving shape that is 128 CTAs for A and 128 for B.  Only the
// summation order of the score dot and of p@V differs from one launch.
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
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 32;       // K rows staged in shared memory at a time
constexpr int kMaxHeadDim = 256;
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

// kVec consecutive cache elements as f32, dequantised (and rounded to TA)
// for int8 caches; one 16-byte load when kVec * sizeof(TC) == 16.
template <typename TA, typename TC, int kVec>
__device__ __forceinline__ void load_row(const TC* p, float scale, float* dst) {
  TC v[kVec];
  if constexpr (kVec * sizeof(TC) == 16) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    memcpy(v, &w, 16);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = p[i];
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if constexpr (std::is_same<TC, int8_t>::value) {
      dst[i] = round_to<TA>(__fmul_rn(to_f(v[i]), scale));
    } else {
      dst[i] = to_f(v[i]);
    }
  }
}

// TA: activation dtype of q/k_new/v_new/out (float or bf16).
// TC: cache dtype, TA itself or int8_t (then k_scale/v_scale hold f32
//     per-vector scales, shape (B, S, K, 1)).
// Layouts: q/out (B,1,H,D); k_new/v_new (B,1,K,D); caches (B,S,K,D);
// lens (B,) pre-write lengths; cos/sin (B,W); scratch (B,K,G,S) f32.

// A. Rope, the new token and the scores of one chunk of slots.
template <typename TA, typename TC, int kVec>
__global__ void __launch_bounds__(kThreads) decode_attention_scores(
    const TA* __restrict__ q, const TA* __restrict__ k_new, const TA* __restrict__ v_new,
    TC* k_cache, TC* v_cache, float* k_scale, float* v_scale,
    const int* __restrict__ lens, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, float* scratch, int S, int H, int K, int D, int W,
    int window, int is_ring) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  extern __shared__ float smem[];
  const int ld = D + 1;            // padded rows: a warp's rows in distinct banks
  const int G = H / K;
  float* q_s = smem;               // (G, ld) roped queries, rounded to TA
  float* k_s = smem + G * ld;      // (kStage, ld) staged K rows

  const int b = blockIdx.x, kv = blockIdx.y;
  const int chunk = (S + gridDim.z - 1) / gridDim.z;
  const int lo = blockIdx.z * chunk, hi = min(lo + chunk, S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lens[b];
  const int write = is_ring ? len % S : len;
  const float* cs = cos_b + static_cast<size_t>(b) * W;
  const float* sn = sin_b + static_cast<size_t>(b) * W;

  // 1. Rope the G q heads of this kv group into shared memory.
  const TA* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    q_s[g * ld + d] = rope_at(qb + static_cast<size_t>(g) * D, cs, sn, d, W);
  }

  // 2. New token, in the one CTA whose chunk holds slot `write`: rope k,
  //    quantise k and v for int8 caches, write the slot.  A write past the
  //    cache is dropped, as a JAX scatter drops it.
  if (warp == 0 && write >= lo && write < hi) {
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
  __syncthreads();  // the rows staged below include the slot just written

  // 3. Scores of the chunk, kStage rows at a time: stage the live K rows in
  //    shared memory, then one thread per (q head, slot) takes the dot.
  const int n_live = min(len + 1, S);
  const float sqrt_d = sqrtf(static_cast<float>(D));
  const int groups = D / kVec;     // kVec-element groups per K row
  float* sc = scratch + (static_cast<size_t>(b) * K + kv) * G * S;
  for (int base = lo; base < hi; base += kStage) {
    const int rows = min(kStage, hi - base);
    for (int i = tid; i < rows * groups; i += blockDim.x) {
      const int j = i / groups, e = i - j * groups, pos = base + j;
      if (pos >= n_live || (window != 0 && pos <= len - window)) continue;
      const size_t r = (static_cast<size_t>(b) * S + pos) * K + kv;
      float ks = 1.f;
      if constexpr (kQuant) ks = k_scale[r];
      load_row<TA, TC, kVec>(k_cache + r * D + e * kVec, ks, k_s + j * ld + e * kVec);
    }
    __syncthreads();
    for (int p = tid; p < G * rows; p += blockDim.x) {
      const int g = p / rows, j = p - g * rows, pos = base + j;
      float s = kNegInf;
      if (pos < n_live && (window == 0 || pos > len - window)) {
        const float* qg = q_s + g * ld;
        const float* kr = k_s + j * ld;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qg[d], kr[d], acc);
        s = __fdiv_rn(acc, sqrt_d);
      }
      sc[static_cast<size_t>(g) * S + pos] = s;
    }
    __syncthreads();  // before the next rows overwrite k_s
  }
}

// V rows a warp covers at once: kVec-element groups of a row spread over
// the lanes, 32 / groups rows side by side when a row needs fewer lanes.
__host__ __device__ __forceinline__ int rows_per_pass(int D, int kVec) {
  const int groups = D / kVec;
  return groups >= 32 ? 1 : 32 / groups;
}

// B. Softmax over the score row of one q head, then p@V.
template <typename TA, typename TC, int kVec>
__global__ void __launch_bounds__(kThreads) decode_attention_pv(
    const TC* __restrict__ v_cache, const float* __restrict__ v_scale,
    const int* __restrict__ lens, TA* __restrict__ out, const float* __restrict__ scratch,
    int S, int H, int K, int D) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr int kMaxGroupsPerLane = (kMaxHeadDim / kVec + 31) / 32;
  extern __shared__ float part[];  // (kWarps * R, D) warp partials
  __shared__ float stats[2];

  const int b = blockIdx.x, kv = blockIdx.y, g = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lens[b];
  const int n_live = min(len + 1, S);
  const float* row = scratch + ((static_cast<size_t>(b) * K + kv) * G + g) * S;

  // 1. Max and sum of the softmax over all S slots, one warp, as a single
  //    launch took them.
  if (warp == 0) {
    float m = -INFINITY;
    for (int pos = lane; pos < S; pos += 32) m = nan_max(m, row[pos]);
    m = warp_max(m);
    float sum = 0.f;
    for (int pos = lane; pos < S; pos += 32) sum += expf(__fsub_rn(row[pos], m));
    sum = warp_sum(sum);
    if (lane == 0) {
      stats[0] = m;
      stats[1] = sum;
    }
  }
  __syncthreads();
  const float m = stats[0], sum = stats[1];

  // 2. p@V: lane (r, e) takes group e of the rows r, r + R, ... of its
  //    warp's slots; warp w takes slots w*R + r + i*kWarps*R.
  const int groups = D / kVec;
  const int R = rows_per_pass(D, kVec);
  const int r = groups >= 32 ? 0 : lane / groups;
  const int e0 = groups >= 32 ? lane : lane - r * groups;
  const bool active = r < R;
  float acc[kMaxGroupsPerLane][kVec];
#pragma unroll
  for (int k = 0; k < kMaxGroupsPerLane; ++k) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[k][i] = 0.f;
  }
  if (active) {
    for (int pos = warp * R + r; pos < n_live; pos += kWarps * R) {
      const float p = round_to<TA>(__fdiv_rn(expf(__fsub_rn(row[pos], m)), sum));
      const size_t vr = (static_cast<size_t>(b) * S + pos) * K + kv;
      float vs = 1.f;
      if constexpr (kQuant) vs = v_scale[vr];
#pragma unroll
      for (int k = 0; k < kMaxGroupsPerLane; ++k) {
        const int e = e0 + 32 * k;
        if (e < groups) {
          float vd[kVec];
          load_row<TA, TC, kVec>(v_cache + vr * D + e * kVec, vs, vd);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[k][i] = fmaf(p, vd[i], acc[k][i]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxGroupsPerLane; ++k) {
      const int e = e0 + 32 * k;
      if (e < groups) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) part[(warp * R + r) * D + e * kVec + i] = acc[k][i];
      }
    }
  }
  __syncthreads();

  // 3. Sum the kWarps * R partials in a fixed order, one cast.
  for (int d = tid; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int i = 0; i < kWarps * R; ++i) o += part[i * D + d];
    out[(static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G + g) * D + d] = from_f<TA>(o);
  }
}

template <typename TA, typename TC, int kVec>
int launch_both(const void* q, const void* k_new, const void* v_new, void* k_cache,
                void* v_cache, void* k_scale, void* v_scale, const void* lens,
                const void* cos_b, const void* sin_b, void* out, void* scratch, int B,
                int S, int H, int K, int D, int W, int window, int is_ring, int nsplit,
                cudaStream_t stream) {
  const int G = H / K;
  const size_t smem_a = static_cast<size_t>(G + kStage) * (D + 1) * sizeof(float);
  auto ka = decode_attention_scores<TA, TC, kVec>;
  if (smem_a > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ka, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_a));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ka<<<dim3(B, K, nsplit), kThreads, smem_a, stream>>>(
      static_cast<const TA*>(q), static_cast<const TA*>(k_new),
      static_cast<const TA*>(v_new), static_cast<TC*>(k_cache),
      static_cast<TC*>(v_cache), static_cast<float*>(k_scale),
      static_cast<float*>(v_scale), static_cast<const int*>(lens),
      static_cast<const float*>(cos_b), static_cast<const float*>(sin_b),
      static_cast<float*>(scratch), S, H, K, D, W, window, is_ring);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem_b = static_cast<size_t>(kWarps) * rows_per_pass(D, kVec) * D * sizeof(float);
  decode_attention_pv<TA, TC, kVec><<<dim3(B, K, G), kThreads, smem_b, stream>>>(
      static_cast<const TC*>(v_cache), static_cast<const float*>(v_scale),
      static_cast<const int*>(lens), static_cast<TA*>(out),
      static_cast<const float*>(scratch), S, H, K, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TC>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
           void* v_cache, void* k_scale, void* v_scale, const void* lens,
           const void* cos_b, const void* sin_b, void* out, void* scratch, int B,
           int S, int H, int K, int D, int W, int window, int is_ring, int nsplit,
           void* stream) {
  // 16-byte cache loads where every row starts on a 16-byte boundary.
  constexpr int kVec = 16 / sizeof(TC);
  const bool vec = (static_cast<size_t>(D) * sizeof(TC)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k_cache) |
                     reinterpret_cast<uintptr_t>(v_cache)) & 15) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    return launch_both<TA, TC, kVec>(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                                     lens, cos_b, sin_b, out, scratch, B, S, H, K, D, W,
                                     window, is_ring, nsplit, s);
  }
  return launch_both<TA, TC, 1>(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, lens,
                                cos_b, sin_b, out, scratch, B, S, H, K, D, W, window,
                                is_ring, nsplit, s);
}

}  // namespace

// Plain C entry points, one per (activation, cache) dtype pair.  Each
// launches both kernels on `stream`, the scores over `nsplit` chunks of
// slots, and returns cudaGetLastError() (0 on success).
#define DECODE_ATTENTION_ENTRY(NAME, TA, TC)                                         \
  extern "C" int NAME(const void* q, const void* k_new, const void* v_new,           \
                      void* k_cache, void* v_cache, void* k_scale, void* v_scale,    \
                      const void* lens, const void* cos_b, const void* sin_b,        \
                      void* out, void* scratch, int B, int S, int H, int K, int D,   \
                      int W, int window, int is_ring, int nsplit, void* stream) {    \
    return launch<TA, TC>(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, lens, \
                          cos_b, sin_b, out, scratch, B, S, H, K, D, W, window,      \
                          is_ring, nsplit, stream);                                  \
  }

DECODE_ATTENTION_ENTRY(decode_attention_f32, float, float)
DECODE_ATTENTION_ENTRY(decode_attention_bf16, __nv_bfloat16, __nv_bfloat16)
DECODE_ATTENTION_ENTRY(decode_attention_q8_f32, float, int8_t)
DECODE_ATTENTION_ENTRY(decode_attention_q8_bf16, __nv_bfloat16, int8_t)
