// Fused decode-attention step for Hopper (sm_90a): rope + (int8 quantise)
// + KV scatter + masked softmax attention, two or three launches per call.
//
// Replaces the TPU kernel `fused_decode_attention` (body `_decode_kernel`)
// of src/repro/kernels/decode_attention.py.  The plain PyTorch version of
// the same function is `decode_attention_plain` in
// src/repro_torch/kernels/decode_attention.py, which this kernel follows
// step for step.
//
// What bounds it on an H100.  One decode token does ~4*H*D flops per
// cached position against 2*K*D cache elements read, about 2*G flop/byte
// in bf16 (G = H/K q heads per kv head), far below the ~295 flop/byte at
// which the tensor cores, not HBM, become the limit: the bound is the live
// K/V read once over 3.35 TB/s (0.83 us at chatglm3-6b's streaming shape,
// B=4, S=1040, K=2, G=16, D=128; 25 us at decode_32k's per-device 8 x
// 32768).  Below ~10 MB of live cache the call is bound by latency: each
// pass's launch, its first round trip to HBM, the handoff from one pass to
// the next, and the instructions each CTA runs once, fetched cold.
//
// What the design does about it:
//   * One CTA per (batch row, kv head, chunk of slots) in every pass, and
//     each CTA holds all G q heads of its group, so every K and V element is
//     read from device memory once per call (not once per q head).  The
//     chunk is a whole number of 64-slot tiles (`split_plan`, from shapes
//     only), sized for about four CTAs per SM even where B*K alone
//     nearly fills the card.
//   * K tiles of 64 slots (32 on CUDA cores) go through a ring of kStages =
//     3 shared-memory stages, V tiles through kStagesPV = 2, with 16-byte
//     cp.async, so the next tiles' loads are in flight while one is
//     multiplied.  A chunk's first tiles are requested before the row's
//     length arrives (rows past the live slots are then cleared or never
//     scored); later tiles skip and zero-fill dead slots.  Caches whose rows
//     are off a 16-byte boundary take the same rings filled by one-element
//     loads.
//   * bf16 activations with D % 16 == 0 run q.K^T and p@V on the tensor
//     cores: mma.sync.m16n8k16 bf16 -> f32, fragments by ldmatrix from
//     rows padded by 16 bytes (no bank conflicts), G padded to a multiple of
//     16 rows (G = 16 fills the m16 tile).  int8 caches are dequantised into
//     a bf16 tile first with load_row's rounding (code * scale, rounded to
//     bf16).  f32 activations (TF32 stays off) and head dims that are no
//     multiple of 16 run the same tiles on CUDA cores.
//   * The softmax is taken by whole CTAs: the scores pass writes each
//     chunk's row maxima; each chunk's sum of exp(s - M) under the row's
//     max M is taken by one warp (lanes stride the chunk, a butterfly adds
//     the lanes) and the chunk sums are added in chunk order.  That is one
//     fixed order over the row, the same in the whole call and in the
//     slot-shard form, so one block stays bit-equal to the whole call.  No
//     log-sum-exp merge of per-chunk (m, l): it would round p under a local
//     max.  Where a row group's scores fit in kFoldBytes (S = 160 at G =
//     16; zamba2's G = 1) every p@V CTA takes the sums itself, in that
//     order, and the call makes two launches; else a stats pass takes them
//     (three launches; S = 1040 at G >= 8, decode_32k).
//   * p@V is split over the same chunks: f32 partials (B, K, NSPLIT, G, D),
//     summed in chunk order and cast once by the last CTA of the group.
//     The tickets that find the last CTA live in the call's workspace and
//     are zeroed by the scores pass of the same call, so every call (and
//     every replay of a captured graph) starts them at 0.
//   * The passes after the first launch with programmatic dependent launch:
//     the scores pass lets them start at once, and p@V stages its first V
//     tiles and the new token's v row (patched into the tile that holds its
//     slot) before griddepcontrol.wait; graphs capture it as a programmatic
//     edge.
//   * Compact code.  At decode shapes each CTA runs its code once, so its
//     time follows the instructions fetched, not the flops: loops stay
//     rolled and the tile loaders, dequantiser and copies are single
//     (__noinline__) copies (chip_smoke.py prints each kernel's SASS
//     instruction count beside its HMMA count).
//   * The f32 score scratch (B, K, G, S) is kept: it is written once (live
//     slots only) and read twice (stats and p@V, or p@V alone), G*4 bytes
//     per live slot and group, a quarter of a bf16 K row at G = 16, D = 128,
//     mostly out of L2.  Recomputing q.K^T in the p@V pass would read every
//     K row again from HBM instead.
//
// Launches: A. decode_attention_scores, S. decode_attention_stats (sum, not
// folded), B. decode_attention_pv, all on grid (B, K, NSPLIT) on the
// caller's stream.  A CTA of A ropes its group's q heads; the one CTA whose
// chunk holds slot `write` ropes, quantises and writes the new token, and
// patches that row into its staged tile (the tile's load may have read the
// slot before the write); no other CTA of A reads that slot.
//
// The slot-shard form (flash-decoding over a mesh's model axis, the layout
// the reference's partitioner gives its decode step): a device holds S_local
// of the cache's S_total slots, from global slot `slot_base`, and runs the
// same function on them with the softmax's statistics reduced across
// devices by the caller's collectives, exactly as the reference's partition
// of one softmax computes it:
//   A. decode_attention_scores as above, masks and the new token's slot in
//      global positions: only the block holding `write` writes it (a write
//      past S_total is dropped, as everywhere);
//   M. decode_attention_stats, max pass: each row's local max over its chunk
//      maxima (then an all-reduce MAX);
//   S. decode_attention_stats, sum pass, under the global max: the local
//      sum in the whole call's order (then an all-reduce SUM);
//   B. decode_attention_pv under the global max and sum: the f32 partial
//      p@V of the local slots, summed over the chunks and not cast; the
//      caller's all-reduce SUM of the partials and one cast finish the step.
// With one shard (slot_base 0, S_local = S_total, the collectives the
// identity) every value is the whole call's, bit for bit.  The cache
// arguments may be views of a larger cache along the slot axis: `ldb` is
// their batch stride in slot rows (S_local for a block of its own).
//
// Numerics follow the plain version:
//   * rope products and sums are rounded separately (__fmul_rn/__fadd_rn,
//     no FMA contraction) and rounded once to the activation dtype, so the
//     k-cache write is bit-exact against PyTorch's eager ops;
//   * int8 quantisation: scale = max(amax/127, 1e-8) with true division,
//     code = rint(x/scale) (half-to-even) clipped to +-127;
//   * scores accumulate in f32 and are divided (not multiplied by a
//     reciprocal) by sqrtf(D); masked slots count as NEG_INF = -0.7*FLT_MAX
//     in the row's max (they hold p = 0 and add nothing to the sum);
//   * one softmax over all S slots, NaN carried as nan_max carries it; p is
//     rounded to the value dtype before p@V, which accumulates in f32 and is
//     cast to the activation dtype once.
//
// Workspace (one device buffer per call, laid out by `Workspace`):
// scores (B,K,G,S) f32 | chunk maxima (B,K,NSPLIT,G) | chunk sums (same) |
// the whole call's max and sum (B,H) each | tickets (2,B*K) int32 |
// p@V partials (B,K,NSPLIT,G,D) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;         // K tiles in the scores pass's shared-memory ring
constexpr int kStagesPV = 2;       // V tiles in the p@V pass's ring
constexpr int kTileTC = 64;        // slots per tile, tensor-core build
constexpr int kTileCC = 32;        // slots per tile, CUDA-core build
constexpr int kMaxG = 64;          // q heads per kv head
constexpr int kMaxSmem = 232448;   // bytes of shared memory a Hopper CTA may use
// The whole call folds the softmax's statistics into the p@V pass (two
// launches) when a row group's scores and chunk maxima fit in this many
// bytes of shared memory: every p@V CTA then takes the row's max and sum
// itself, in the stats pass's order.  Past it, the stats pass runs.
constexpr int kFoldBytes = 16 * 1024;
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

// One cache element as the activation dtype sees it: int8 codes are
// dequantised and rounded to TA (the plain version's (code * scale).to(TA)).
template <typename TA, typename TC>
__device__ __forceinline__ float cache_val(TC x, float scale) {
  if constexpr (std::is_same<TC, int8_t>::value) {
    return round_to<TA>(__fmul_rn(to_f(x), scale));
  } else {
    return to_f(x);
  }
}

// --------------------------------------------------------------------------
// Asynchronous copies, ldmatrix and the bf16 tensor-core product.
// --------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst`, or 16 zero bytes (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0));
}

// 4 bytes, or 4 zero bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(fill ? 4 : 0));
}

// `nbytes` bytes from global `src` to shared `dst`, by the whole CTA, in
// the widest cp.async pieces both addresses' alignment allows.
__device__ __noinline__ void copy_async(void* dst, const void* src, int nbytes) {
  const unsigned align = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) |
                         static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst)) |
                         static_cast<unsigned>(nbytes);
  auto* d = static_cast<unsigned char*>(dst);
  const auto* g = static_cast<const unsigned char*>(src);
  if ((align & 15) == 0) {
#pragma unroll 1
    for (int i = threadIdx.x * 16; i < nbytes; i += kThreads * 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(d + i)),
                   "l"(g + i));
  } else if ((align & 7) == 0) {
#pragma unroll 1
    for (int i = threadIdx.x * 8; i < nbytes; i += kThreads * 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(d + i)),
                   "l"(g + i));
  } else if ((align & 3) == 0) {
#pragma unroll 1
    for (int i = threadIdx.x * 4; i < nbytes; i += kThreads * 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(d + i)),
                   "l"(g + i));
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < nbytes; i += kThreads) d[i] = g[i];
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// Programmatic dependent launch: a pass lets the next one (launched with
// cudaLaunchAttributeProgrammaticStreamSerialization) start its prologue,
// and waits for the previous one's completion and memory before it reads
// what that one wrote.  Both are no-ops around an ordinary launch.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// c += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --------------------------------------------------------------------------
// Arguments, workspace and shared-memory layouts.
// --------------------------------------------------------------------------
// Layouts: q/out (B,1,H,D); k_new/v_new (B,1,K,D); caches (B,S,K,D) with
// batch stride ldb slot rows; scales (B,S,K,1) f32; lens (B,) pre-write
// lengths; cos/sin (B,W).  S is the block's slot count, slot_base the
// global slot of local slot 0 and S_total the whole cache's slot count.
struct Params {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* k_cache;
  void* v_cache;
  float* k_scale;
  float* v_scale;
  const int* lens;
  const float* cos_b;
  const float* sin_b;
  void* out;        // (B, H, D): TA for the whole call, f32 for a shard's partial
  float* scores;    // workspace: (B, K, G, S)
  float* cmax;      // workspace: (B, K, NSPLIT, G) chunk maxima
  float* psum;      // workspace: (B, K, NSPLIT, G) chunk sums
  float* m;         // (B, H): the softmax's max (whole call: workspace, written
  float* s;         //   by the stats pass; shard: the all-reduced inputs), sum
  float* m_out;     // (B, H): a shard's local max (max pass)
  float* s_out;     // (B, H): a shard's local sum (sum pass)
  int* tickets;     // workspace: (2, B*K): sum pass, p@V pass
  float* part;      // workspace: (B, K, NSPLIT, G, D) p@V partials
  int B, S, ldb, slot_base, S_total, H, K, G, D, W, window, is_ring, chunk, nsplit;
  int fold;         // the p@V pass takes the softmax's max and sum itself
};

__host__ __device__ constexpr size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Byte offsets of the workspace's parts; `bytes` is its size.
struct Workspace {
  size_t scores, cmax, psum, m, s, tickets, part, bytes;
  __host__ __device__ Workspace(int B, int K, int G, int D, int S, int nsplit) {
    const size_t rows = static_cast<size_t>(B) * K * G;
    size_t o = 0;
    scores = o; o = align_up(o + rows * S * 4, 256);
    cmax = o;   o = align_up(o + rows * nsplit * 4, 256);
    psum = o;   o = align_up(o + rows * nsplit * 4, 256);
    m = o;      o = align_up(o + rows * 4, 256);
    s = o;      o = align_up(o + rows * 4, 256);
    tickets = o; o = align_up(o + 2 * static_cast<size_t>(B) * K * 4, 256);
    part = o;   o = align_up(o + rows * nsplit * D * 4, 256);
    bytes = o;
  }
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Whether the whole call folds the statistics into the p@V pass.
__host__ __device__ inline bool fold_stats(int G, int S, int nsplit) {
  return (static_cast<long long>(G) * S + static_cast<long long>(nsplit) * G) * 4 <=
         kFoldBytes;
}

// Shared memory of one CTA of the scores pass (pv = false) or the p@V pass
// (pv = true), in bytes from the start of the dynamic buffer:
//   a:     scores: the roped q heads (rows x ald of CT); p@V: the p tile;
//   in:    scores: the group's q rows, k_new, v_new (TA), cos, sin (f32);
//          p@V: the new token's v row and scale (TC, f32);
//   ring:  cache tiles (kStages, kStagesPV for p@V), kTile rows of rs bytes
//          (16-byte pieces, rows padded by 16 bytes so ldmatrix's eight rows
//          hit distinct banks);
//   scale: the tiles' f32 scales (int8 caches);
//   conv:  one tile dequantised to bf16 (tensor cores over int8 caches);
//   x:     scores: the new token's k row; p@V: the staged scores (folded:
//          the chunk maxima, NSPLIT x G, the group's G rows of S and the
//          chunk sums, G x NSPLIT; else kStagesPV tiles of G x kTile);
//   acc:   p@V: the f32 sums of p@V, rows x D;
//   red:   scores: per-warp row maxima; p@V: the rows' max and sum.
template <typename TA, typename TC, bool kTC>
struct Layout {
  using CT = typename std::conditional<kTC, __nv_bfloat16, float>::type;
  static constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  static constexpr int kTile = kTC ? kTileTC : kTileCC;
  int rows, ald, rs, cld, o_a, o_in, o_ring, o_scale, o_conv, o_x, o_acc, o_red, bytes;
  __host__ __device__ Layout(int G, int D, bool pv, int S = 0, int nsplit = 0,
                             bool fold = false) {
    const int stages = pv ? kStagesPV : kStages;
    const int sa = static_cast<int>(sizeof(TA)), sc = static_cast<int>(sizeof(TC));
    rows = kTC ? (G + 15) / 16 * 16 : G;
    ald = pv ? (kTC ? kTile + 8 : kTile) : (kTC ? D + 8 : D + 1);
    rs = align16(D * sc) + 16;
    cld = D + 8;
    int o = 0;
    o_a = o;     o += align16(rows * ald * static_cast<int>(sizeof(CT)));
    o_in = o;    o += pv ? align16(D * sc) + 16
                         : align16(G * D * sa) + 2 * align16(D * sa) + 2 * align16(D / 2 * 4);
    o_ring = o;  o += stages * kTile * rs;
    o_scale = o; o += kQuant ? stages * kTile * 4 : 0;
    o_conv = o;  o += (kTC && kQuant) ? kTile * cld * 2 : 0;
    o_x = o;     o += pv ? align16((fold ? 2 * nsplit * G + G * S : kStagesPV * G * kTile) * 4)
                         : align16(D * sc);
    o_acc = o;   o += pv ? rows * D * 4 : 0;
    o_red = o;   o += pv ? 2 * rows * 4 : kWarps * rows * 4;
    bytes = o;
  }
};

// The block's live slots of row b inside [lo, hi): [a, e).  Local slot pos
// is live iff pos < n_live and, with a window, its global position lies
// inside it.
__device__ __forceinline__ void live_range(const Params& p, int len, int lo, int hi, int& a,
                                           int& e) {
  const int n_live = min(len + 1, p.S_total) - p.slot_base;
  a = p.window != 0 ? max(lo, len - p.window - p.slot_base + 1) : lo;
  e = min(hi, n_live);
}

// Stage kTile cache rows from local slot `base` of (b, kv) (caches of batch
// stride ldb slot rows, K heads of D) into `dst` (row stride rs bytes) and,
// for int8 caches, their scales into `sdst`; a row outside [a, e) is
// zero-filled and not read.  kAsync: 16-byte cp.async
// pieces (every row on a 16-byte boundary); else one-element loads.
template <typename TC, bool kAsync, int kTile>
__device__ __noinline__ void load_tile(const TC* cache, const float* scale,
                                       unsigned char* dst, float* sdst, int rs, int ldb,
                                       int K, int D, int b, int kv, int base, int a, int e) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  const size_t row0 = static_cast<size_t>(b) * ldb;
  if constexpr (kAsync) {
    // Thread t copies piece t % pieces of rows t / pieces, + rows_per, ...
    constexpr int kPer = 16 / sizeof(TC);
    const int pieces = D / kPer, rows_per = kThreads / pieces;
    const int j0 = threadIdx.x / pieces, u = threadIdx.x - j0 * pieces;
    if (j0 < rows_per) {
#pragma unroll 1
      for (int j = j0; j < kTile; j += rows_per) {
        const int pos = base + j;
        const bool live = pos >= a && pos < e;
        const TC* src = live ? cache + ((row0 + pos) * K + kv) * D + u * kPer : cache;
        cp_async16(dst + j * rs + u * 16, src, live);
      }
    }
    if constexpr (kQuant) {
      if (threadIdx.x < kTile) {
        const int pos = base + threadIdx.x;
        const bool live = pos >= a && pos < e;
        cp_async4(sdst + threadIdx.x, live ? scale + (row0 + pos) * K + kv : scale, live);
      }
    }
  } else {
    const int rows_per = kThreads / D;
    const int j0 = threadIdx.x / D, d = threadIdx.x - j0 * D;
    if (j0 < rows_per) {
#pragma unroll 1
      for (int j = j0; j < kTile; j += rows_per) {
        const int pos = base + j;
        TC v;
        if (pos >= a && pos < e) {
          v = cache[((row0 + pos) * K + kv) * D + d];
        } else if constexpr (kQuant) {
          v = 0;
        } else {
          v = from_f<TC>(0.f);
        }
        reinterpret_cast<TC*>(dst + j * rs)[d] = v;
      }
    }
    if constexpr (kQuant) {
      if (threadIdx.x < kTile) {
        const int pos = base + threadIdx.x;
        sdst[threadIdx.x] = pos >= a && pos < e ? scale[(row0 + pos) * K + kv] : 0.f;
      }
    }
  }
}

// An int8 tile (codes x scales) to bf16, rounded as load_row rounds it.
template <int kTile>
__device__ __noinline__ void dequant_tile(const unsigned char* raw, const float* scl,
                                             int rs, __nv_bfloat16* conv, int cld, int D) {
  const int groups = D / 8, rows_per = kThreads / groups;
  const int j0 = threadIdx.x / groups, u = threadIdx.x - j0 * groups;
  if (j0 >= rows_per) return;
#pragma unroll 1
  for (int j = j0; j < kTile; j += rows_per) {
    const uint2 codes = *reinterpret_cast<const uint2*>(raw + j * rs + u * 8);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t word = k < 2 ? codes.x : codes.y, sh = 16 * (k & 1);
      const float lo = to_f(static_cast<int8_t>((word >> sh) & 0xff));
      const float hi = to_f(static_cast<int8_t>((word >> (sh + 8)) & 0xff));
      __nv_bfloat162 h2 = __floats2bfloat162_rn(__fmul_rn(lo, scl[j]), __fmul_rn(hi, scl[j]));
      memcpy(&w[k], &h2, 4);
    }
    *reinterpret_cast<uint4*>(conv + j * cld + u * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The new token's v row as the cache stores it, by one warp: int8 codes
// under scale max(amax/127, 1e-8) (returned), or the row itself (scale 1).
template <typename TA, typename TC>
__device__ __noinline__ float v_row(const TA* vn, int D, int lane, TC* dst) {
  if constexpr (std::is_same<TC, int8_t>::value) {
    float amax = 0.f;
#pragma unroll 1
    for (int d = lane; d < D; d += 32) amax = nan_max(amax, fabsf(to_f(vn[d])));
    const float vsc = nan_max(__fdiv_rn(warp_max(amax), 127.f), 1e-8f);
#pragma unroll 1
    for (int d = lane; d < D; d += 32) dst[d] = quantize(to_f(vn[d]), vsc);
    return vsc;
  } else {
#pragma unroll 1
    for (int d = lane; d < D; d += 32) dst[d] = vn[d];
    return 1.f;
  }
}

// Zero the rows of a staged tile outside the live slots [a, e) (and their
// scales): the speculative loads read them, and 0 * NaN would poison p@V.
template <typename TC, int kTile>
__device__ __noinline__ void clear_dead_rows(unsigned char* raw, float* scl, int rs, int D,
                                                int base, int a, int e) {
  const int words = D * static_cast<int>(sizeof(TC)) / 4, rows_per = kThreads / words;
  const int j0 = threadIdx.x / words, w = threadIdx.x - j0 * words;
  if (j0 < rows_per) {
#pragma unroll 1
    for (int j = j0; j < kTile; j += rows_per) {
      const int pos = base + j;
      if (pos < a || pos >= e) reinterpret_cast<uint32_t*>(raw + j * rs)[w] = 0u;
    }
  }
  if (std::is_same<TC, int8_t>::value && threadIdx.x < kTile) {
    const int pos = base + threadIdx.x;
    if (pos < a || pos >= e) scl[threadIdx.x] = 0.f;
  }
}

// --------------------------------------------------------------------------
// A. Rope, the new token and the scores of one chunk of slots.
// --------------------------------------------------------------------------
template <typename TA, typename TC, bool kTC, bool kAsync>
__global__ void __launch_bounds__(kThreads) decode_attention_scores(const Params p) {
  using L = Layout<TA, TC, kTC>;
  using CT = typename L::CT;
  constexpr bool kQuant = L::kQuant;
  constexpr int kTile = L::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float kscale_s;
  pdl_trigger();
  const L lay(p.G, p.D, false);
  CT* q_s = reinterpret_cast<CT*>(smem + lay.o_a);
  unsigned char* ring = smem + lay.o_ring;
  float* scale_s = reinterpret_cast<float*>(smem + lay.o_scale);
  TC* knew_s = reinterpret_cast<TC*>(smem + lay.o_x);
  float* red = reinterpret_cast<float*>(smem + lay.o_red);

  const int b = blockIdx.x, kv = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, D = p.D, S = p.S, K = p.K, W = p.W;
  const int lo = c * p.chunk, hi = min(lo + p.chunk, S);
  const size_t grp = static_cast<size_t>(b) * K + kv;

  // 1. One asynchronous group for the group's q rows, the new token's k
  //    and v, cos and sin, before anything waits on memory.
  constexpr int sa = static_cast<int>(sizeof(TA));
  TA* q_in = reinterpret_cast<TA*>(smem + lay.o_in);
  TA* kn = reinterpret_cast<TA*>(smem + lay.o_in + align16(G * D * sa));
  TA* vn = reinterpret_cast<TA*>(reinterpret_cast<unsigned char*>(kn) + align16(D * sa));
  float* cs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(vn) + align16(D * sa));
  float* sn = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(cs) + align16(D / 2 * 4));
  copy_async(q_in, static_cast<const TA*>(p.q) + (static_cast<size_t>(b) * p.H + kv * G) * D,
             G * D * sa);
  copy_async(kn, static_cast<const TA*>(p.k_new) + grp * D, D * sa);
  copy_async(vn, static_cast<const TA*>(p.v_new) + grp * D, D * sa);
  copy_async(cs, p.cos_b + static_cast<size_t>(b) * W, W * 4);
  copy_async(sn, p.sin_b + static_cast<size_t>(b) * W, W * 4);
  cp_async_commit();

  // 2. The chunk's first tiles, loaded before the row's length is known on
  //    the asynchronous build (rows past the live ones are never scored),
  //    again once it is known where a window moves the live slots.
  const TC* kc = static_cast<const TC*>(p.k_cache);
  if constexpr (kAsync) {
    for (int s = 0; s < kStages - 1; ++s) {
      if (lo + s * kTile < hi) {
        load_tile<TC, true, kTile>(kc, p.k_scale, ring + s * kTile * lay.rs, scale_s + s * kTile,
                                   lay.rs, p.ldb, p.K, p.D, b, kv, lo + s * kTile, lo, hi);
      }
      cp_async_commit();
    }
  }
  if (c == 0 && tid < 2) p.tickets[tid * p.B * K + grp] = 0;  // this call's tickets
#pragma unroll 1
  for (int i = tid; i < kWarps * lay.rows; i += kThreads) red[i] = -INFINITY;
  const int len = p.lens[b];
  int a, e;
  live_range(p, len, lo, hi, a, e);
  const int write = (p.is_ring ? len % p.S_total : len) - p.slot_base;  // local slot
  const bool writer = write >= lo && write < hi;
  const int t0 = (a - lo) / kTile, t1 = a < e ? (e - lo + kTile - 1) / kTile : t0;
  if (!kAsync || t0 != 0) {
    if constexpr (kAsync) {
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int s = 0; s < kStages - 1; ++s) {
      if (t0 + s < t1) {
        load_tile<TC, kAsync, kTile>(kc, p.k_scale, ring + s * kTile * lay.rs,
                                     scale_s + s * kTile, lay.rs, p.ldb, p.K, p.D, b, kv,
                                     lo + (t0 + s) * kTile, a, e);
      }
      cp_async_commit();
    }
  }
  cp_async_wait<kStages - 1>();  // the inputs' group
  __syncthreads();

  // 3. Rope the G q heads of this kv group (padded rows zero).
  {
    const int rows_per = kThreads / D, g0 = tid / D, d = tid - g0 * D;
    if (g0 < rows_per) {
#pragma unroll 1
      for (int g = g0; g < lay.rows; g += rows_per) {
        const float v = g < G ? rope_at(q_in + g * D, cs, sn, d, W) : 0.f;
        q_s[g * lay.ald + d] = from_f<CT>(v);
      }
    }
  }

  // 4. The new token, in the one CTA whose chunk holds slot `write`: rope
  //    k, quantise k and v for int8 caches, write the slot, keep the k row
  //    for the staged tile.  A write past the cache (or outside this
  //    block's slots) is dropped, as a JAX scatter drops it.
  if (writer && warp == kWarps - 1) {
    TC* kw = static_cast<TC*>(p.k_cache);
    TC* vw = static_cast<TC*>(p.v_cache);
    const size_t row = (static_cast<size_t>(b) * p.ldb + write) * K + kv;
    const float vsc = v_row<TA, TC>(vn, D, lane, vw + row * D);
    if constexpr (kQuant) {
      float kamax = 0.f;
#pragma unroll 1
      for (int d = lane; d < D; d += 32) kamax = nan_max(kamax, fabsf(rope_at(kn, cs, sn, d, W)));
      const float ksc = nan_max(__fdiv_rn(warp_max(kamax), 127.f), 1e-8f);
#pragma unroll 1
      for (int d = lane; d < D; d += 32) {
        const int8_t code = quantize(rope_at(kn, cs, sn, d, W), ksc);
        kw[row * D + d] = code;
        knew_s[d] = code;
      }
      if (lane == 0) {
        p.k_scale[row] = ksc;
        p.v_scale[row] = vsc;
        kscale_s = ksc;
      }
    } else {
#pragma unroll 1
      for (int d = lane; d < D; d += 32) {
        const TC kr = from_f<TC>(rope_at(kn, cs, sn, d, W));
        kw[row * D + d] = kr;
        knew_s[d] = kr;
      }
    }
  }
  __syncthreads();

  // 5. The chunk's live tiles: wait for the oldest stage, start the next
  //    load into the stage freed by the last tile, score this one.
  const float sqrt_d = sqrtf(static_cast<float>(D));
  float* sc = p.scores + grp * G * S;
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int tn = t + kStages - 1;
    if (tn < t1) {
      const int sn_ = (tn - t0) % kStages;
      load_tile<TC, kAsync, kTile>(kc, p.k_scale, ring + sn_ * kTile * lay.rs,
                                   scale_s + sn_ * kTile, lay.rs, p.ldb, p.K, p.D, b, kv, lo + tn * kTile,
                                   a, e);
    }
    cp_async_commit();
    const int st = (t - t0) % kStages, base = lo + t * kTile;
    unsigned char* raw = ring + st * kTile * lay.rs;
    float* scl = scale_s + st * kTile;
    if (writer && write >= base && write < base + kTile) {  // the same in every thread
      const int j = write - base;
#pragma unroll 1
      for (int d = tid; d < D; d += kThreads) reinterpret_cast<TC*>(raw + j * lay.rs)[d] = knew_s[d];
      if (kQuant && tid == 0) scl[j] = kscale_s;
      __syncthreads();
    }
    if constexpr (kTC) {
      const unsigned char* kt_ = raw;
      int krs = lay.rs;
      if constexpr (kQuant) {
        __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem + lay.o_conv);
        dequant_tile<kTile>(raw, scl, lay.rs, conv, lay.cld, D);
        __syncthreads();
        kt_ = reinterpret_cast<const unsigned char*>(conv);
        krs = lay.cld * 2;
      }
      // Warp w takes the 8 slots w*8.. of the tile, one m16 tile of q
      // heads at a time: S (16 x 8) = Q (16 x D) K^T (D x 8).
#pragma unroll 1
      for (int nt = warp; nt < kTile / 8; nt += kWarps) {
#pragma unroll 1
        for (int mt = 0; mt < lay.rows / 16; ++mt) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
          for (int kt = 0; kt < D / 16; ++kt) {
            uint32_t af[4], bf[2];
            ldsm_x2(bf, kt_ + (nt * 8 + (lane & 7)) * krs + (kt * 16 + ((lane >> 3) & 1) * 8) * 2);
            ldsm_x4(af, q_s + (mt * 16 + (lane & 15)) * lay.ald + kt * 16 + (lane >> 4) * 8);
            mma_bf16(acc, af, bf);
          }
          float rm[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int g = mt * 16 + (lane >> 2) + (i >> 1) * 8;
            const int pos = base + nt * 8 + (lane & 3) * 2 + (i & 1);
            if (g < G && pos >= a && pos < e) {
              const float s = __fdiv_rn(acc[i], sqrt_d);
              sc[static_cast<size_t>(g) * S + pos] = s;
              rm[i >> 1] = nan_max(rm[i >> 1], s);
            }
          }
          for (int h = 0; h < 2; ++h) {  // the 4 lanes of a row, then this warp's running max
            float v = nan_max(rm[h], __shfl_xor_sync(0xffffffffu, rm[h], 1));
            v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, 2));
            const int g = mt * 16 + (lane >> 2) + h * 8;
            if ((lane & 3) == 0) red[warp * lay.rows + g] = nan_max(red[warp * lay.rows + g], v);
          }
        }
      }
    } else {
      // One thread per (q head, slot), q heads fastest: a D-long dot from
      // shared memory against the staged (dequantised) row.
      const int slots_per = kThreads / G, j0 = tid / G, g = tid - j0 * G;
#pragma unroll 1
      for (int j = j0; j0 < slots_per && j < kTile; j += slots_per) {
        const int pos = base + j;
        if (pos >= a && pos < e) {
          const CT* qg = q_s + g * lay.ald;
          const TC* kr = reinterpret_cast<const TC*>(raw + j * lay.rs);
          const float ks = kQuant ? scl[j] : 1.f;
          float acc = 0.f;
#pragma unroll 1
          for (int d = 0; d < D; ++d) acc = fmaf(qg[d], cache_val<TA>(kr[d], ks), acc);
          sc[static_cast<size_t>(g) * S + pos] = __fdiv_rn(acc, sqrt_d);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // this CTA's per-warp maxima (tensor cores) or scores (CUDA cores)

  // 6. The chunk's row maxima: NEG_INF stands for every masked slot.
  const bool dead = a > lo || e < hi || a >= e;
  float* cm = p.cmax + (grp * p.nsplit + c) * G;
  if constexpr (kTC) {
#pragma unroll 1
    for (int g = tid; g < G; g += kThreads) {
      float m = dead ? kNegInf : -INFINITY;
#pragma unroll 1
      for (int w = 0; w < kWarps; ++w) m = nan_max(m, red[w * lay.rows + g]);
      cm[g] = m;
    }
  } else {
#pragma unroll 1
    for (int g = warp; g < G; g += kWarps) {
      float m = -INFINITY;
#pragma unroll 1
      for (int pos = a + lane; pos < e; pos += 32) m = nan_max(m, sc[static_cast<size_t>(g) * S + pos]);
      m = warp_max(m);
      if (lane == 0) cm[g] = nan_max(dead ? kNegInf : -INFINITY, m);
    }
  }
}

// --------------------------------------------------------------------------
// S/M. The softmax's statistics, by whole CTAs.
// --------------------------------------------------------------------------
// The row max over the chunk maxima, reduced by one warp (lanes stride the
// chunks): the same in the whole call's sum pass, in a shard's max pass and
// in a folded p@V pass.
__device__ __forceinline__ float row_max(const float* cm, int nsplit, int G, int g, int lane) {
  float m = -INFINITY;
#pragma unroll 1
  for (int cc = lane; cc < nsplit; cc += 32) m = nan_max(m, cm[cc * G + g]);
  return warp_max(m);
}

// One chunk's sum of exp(s - m) over its live slots [a, e), by one warp:
// lanes stride the slots in order, a butterfly adds the lanes.  The same
// in the stats pass and in a folded p@V pass.
__device__ __forceinline__ float chunk_sum(const float* row, float m, int a, int e, int lane) {
  float acc = 0.f;
#pragma unroll 4
  for (int pos = a + lane; pos < e; pos += 32) acc += expf(__fsub_rn(row[pos], m));
  return warp_sum(acc);
}

// max_pass: grid (B, K, 1), each row's max over its chunk maxima into m_out.
// Else the sum pass, grid (B, K, NSPLIT): each chunk's sum of exp(s - M)
// under the row's max M (the chunk maxima's for the whole call, the reduced
// `m` for a shard); the last CTA of the group adds the chunk sums in chunk
// order (and, for the whole call, writes M beside the sum).
__global__ void __launch_bounds__(kThreads) decode_attention_stats(const Params p, int max_pass,
                                                                   int shard) {
  __shared__ float m_s[kMaxG];
  __shared__ int last_s;
  pdl_trigger();
  const int b = blockIdx.x, kv = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, K = p.K, S = p.S, NS = p.nsplit;
  const size_t grp = static_cast<size_t>(b) * K + kv;
  const size_t head0 = static_cast<size_t>(b) * p.H + kv * G;
  const int lo = c * p.chunk, hi = min(lo + p.chunk, S);
  int a, e;
  live_range(p, p.lens[b], lo, hi, a, e);
  pdl_wait();  // the scores pass's maxima and scores
  const float* cm = p.cmax + grp * NS * G;
  if (max_pass) {
#pragma unroll 1
    for (int g = warp; g < G; g += kWarps) {
      const float m = row_max(cm, NS, G, g, lane);
      if (lane == 0) p.m_out[head0 + g] = m;
    }
    return;
  }
#pragma unroll 1
  for (int g = warp; g < G; g += kWarps) {
    const float m = shard ? p.m[head0 + g] : row_max(cm, NS, G, g, lane);
    const float sum = chunk_sum(p.scores + (grp * G + g) * S, m, a, e, lane);
    if (lane == 0) {
      p.psum[(grp * NS + c) * G + g] = sum;
      m_s[g] = m;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(p.tickets + grp, 1) == NS - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
#pragma unroll 1
  for (int g = tid; g < G; g += kThreads) {
    float total = 0.f;
#pragma unroll 1
    for (int cc = 0; cc < NS; ++cc) total += __ldcg(p.psum + (grp * NS + cc) * G + g);
    if (shard) {
      p.s_out[head0 + g] = total;
    } else {
      p.m[head0 + g] = m_s[g];
      p.s[head0 + g] = total;
    }
  }
}

// --------------------------------------------------------------------------
// B. p@V of one chunk of slots, then the group's chunks summed.
// --------------------------------------------------------------------------
// The softmax's max M and sum SUM of each row come from the stats pass (or
// a shard's reductions) or, folded (p.fold), from this CTA: M over the
// chunk maxima as the max pass takes it, SUM chunk by chunk in chunk order
// as the stats pass takes it, so every CTA of the row holds the same
// values.  p = exp(s - M) / SUM rounded to TA over the chunk's live slots
// (0 elsewhere); the f32 partial p@V of the chunk goes to the workspace;
// the last CTA of the group adds the partials in chunk order and casts
// once (kShard: writes the f32 sum uncast).  Launched programmatically
// after the scores (or stats) pass, it stages its first V tiles, and the
// new token's v row (p.v_new), before waiting for that pass.
template <typename TA, typename TC, bool kTC, bool kAsync, bool kShard>
__global__ void __launch_bounds__(kThreads) decode_attention_pv(const Params p) {
  using L = Layout<TA, TC, kTC>;
  using CT = typename L::CT;
  constexpr bool kQuant = L::kQuant;
  constexpr int kTile = L::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  __shared__ float vscale_s;
  const int G = p.G, D = p.D, S = p.S, K = p.K, NS = p.nsplit;
  const bool fold = p.fold != 0;
  const L lay(G, D, true, S, NS, fold);
  CT* p_s = reinterpret_cast<CT*>(smem + lay.o_a);
  TC* vnew_s = reinterpret_cast<TC*>(smem + lay.o_in);
  unsigned char* ring = smem + lay.o_ring;
  float* scale_s = reinterpret_cast<float*>(smem + lay.o_scale);
  float* x_s = reinterpret_cast<float*>(smem + lay.o_x);     // staged scores
  float* acc_s = reinterpret_cast<float*>(smem + lay.o_acc);  // the f32 sums
  float* stat = reinterpret_cast<float*>(smem + lay.o_red);  // [rows) max, [rows, 2 rows) sum

  const int b = blockIdx.x, kv = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = c * p.chunk, hi = min(lo + p.chunk, S);
  const size_t grp = static_cast<size_t>(b) * K + kv;
  const size_t head0 = static_cast<size_t>(b) * p.H + kv * G;
  const TC* vc = static_cast<const TC*>(p.v_cache);
  const float* sc = p.scores + grp * G * S;
  float* cm_s = x_s;                 // folded: NSPLIT x G chunk maxima,
  float* rows_s = x_s + NS * G;      //   then G rows of S scores

  // 1. The first V tiles, loaded before the row's length is known on the
  //    asynchronous build, as in the scores pass (rows past the live slots
  //    are cleared below), and before the pass this one follows is done.
  //    Unfolded, each tile's scores are staged beside it.
  auto stage_v = [&](int t, int t_first, int la, int le) {
    const int st = (t - t_first) % kStagesPV;
    load_tile<TC, kAsync, kTile>(vc, p.v_scale, ring + st * kTile * lay.rs,
                                 scale_s + st * kTile, lay.rs, p.ldb, p.K, p.D, b, kv, lo + t * kTile, la, le);
  };
  auto stage_s = [&](int t, int t_first, int la, int le) {
    if (fold) return;
    const int base = lo + t * kTile;
    float* dst = x_s + (t - t_first) % kStagesPV * G * kTile;
#pragma unroll 1
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, j = i - g * kTile, pos = base + j;
      const bool live = pos >= la && pos < le;
      cp_async4(dst + i, live ? sc + static_cast<size_t>(g) * S + pos : sc, live);
    }
  };
  if constexpr (kAsync) {
    for (int s = 0; s < kStagesPV - 1; ++s) {
      if (lo + s * kTile < hi) stage_v(s, 0, lo, hi);
      cp_async_commit();
    }
  }
#pragma unroll 1
  for (int i = tid; i < lay.rows * D; i += kThreads) acc_s[i] = 0.f;
  const int len = p.lens[b];
  int a, e, ra, re;
  live_range(p, len, lo, hi, a, e);
  live_range(p, len, 0, S, ra, re);  // the row's live slots
  const int t0 = (a - lo) / kTile, t1 = a < e ? (e - lo + kTile - 1) / kTile : t0;
  // The new token's v row, for the tile that holds its slot: the scores
  // pass may not have written it when the tiles above were loaded.
  const int write = (p.is_ring ? len % p.S_total : len) - p.slot_base;
  const bool vwriter = p.v_new != nullptr && write >= lo && write < hi;
  if (vwriter && warp == kWarps - 1) {
    const float vsc = v_row<TA, TC>(static_cast<const TA*>(p.v_new) + grp * D, D, lane, vnew_s);
    if (lane == 0) vscale_s = vsc;
  }

  // 2. Wait for the pass before; its outputs, one asynchronous group:
  //    folded, the chunk maxima and the group's rows of scores (their dead
  //    slots were never written and are never read); else the rows' max
  //    and sum.
  pdl_wait();
  if (!kAsync || t0 != 0) {
    if constexpr (kAsync) {
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int s = 0; s < kStagesPV - 1; ++s) {
      if (t0 + s < t1) {
        stage_v(t0 + s, t0, a, e);
        stage_s(t0 + s, t0, a, e);
      }
    }
  } else {
    for (int s = 0; s < kStagesPV - 1; ++s) {
      if (t0 + s < t1) stage_s(t0 + s, t0, a, e);
    }
  }
  if (fold) {
    copy_async(cm_s, p.cmax + grp * NS * G, NS * G * 4);
    copy_async(rows_s, sc, G * S * 4);
  } else {
    copy_async(stat, p.m + head0, G * 4);
    copy_async(stat + lay.rows, p.s + head0, G * 4);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 3. Folded: each row's max over the chunk maxima, then every chunk's
  //    sum of each row (four (row, chunk) pairs per warp at a time, their
  //    butterflies interleaved), then each row's sum in chunk order.
  if (fold) {
    float* csum = rows_s + G * S;    // (G, NSPLIT)
#pragma unroll 1
    for (int g = warp; g < G; g += kWarps) {
      const float m = row_max(cm_s, NS, G, g, lane);
      if (lane == 0) stat[g] = m;
    }
    __syncthreads();
    constexpr int kU = 4;
#pragma unroll 1
    for (int q0 = warp * kU; q0 < G * NS; q0 += kWarps * kU) {
      float acc[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int q = q0 + u, g = q / NS, cc = q - g * NS;
        const int ca = max(cc * p.chunk, ra), ce = min(min(cc * p.chunk + p.chunk, S), re);
        acc[u] = 0.f;
        if (q < G * NS) {
          const float* row = rows_s + g * S;
          const float m = stat[g];
#pragma unroll 1
          for (int pos = ca + lane; pos < ce; pos += 32) acc[u] += expf(__fsub_rn(row[pos], m));
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kU; ++u) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
      }
      if (lane < kU && q0 + lane < G * NS) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (u == lane) csum[q0 + u] = acc[u];
        }
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int g = tid; g < G; g += kThreads) {
      float total = 0.f;
#pragma unroll 1
      for (int cc = 0; cc < NS; ++cc) total += csum[g * NS + cc];
      stat[lay.rows + g] = total;
    }
  }

  // 4. The chunk's live tiles: p, then the f32 sums of p@V in shared
  //    memory, tile by tile in slot order.
  const int n_nt = D / 8, pairs = lay.rows / 16 * n_nt;
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<kStagesPV - 2>();
    __syncthreads();
    if (t + kStagesPV - 1 < t1) {
      stage_v(t + kStagesPV - 1, t0, a, e);
      stage_s(t + kStagesPV - 1, t0, a, e);
    }
    cp_async_commit();
    const int st = (t - t0) % kStagesPV, base = lo + t * kTile;
    unsigned char* raw = ring + st * kTile * lay.rs;
    float* scl = scale_s + st * kTile;
    const bool patch = vwriter && write >= base && write < base + kTile;
    if (kAsync && (base < a || base + kTile > e)) {
      clear_dead_rows<TC, kTile>(raw, scl, lay.rs, D, base, a, e);
    }
    if (patch) {
      const int j = write - base;
#pragma unroll 1
      for (int d = tid; d < D; d += kThreads) reinterpret_cast<TC*>(raw + j * lay.rs)[d] = vnew_s[d];
      if (kQuant && tid == 0) scl[j] = vscale_s;
    }
#pragma unroll 2
    for (int i = tid; i < lay.rows * kTile; i += kThreads) {
      const int g = i / kTile, j = i - g * kTile, pos = base + j;
      float pv = 0.f;
      if (g < G && pos >= a && pos < e) {
        const float sv = fold ? rows_s[g * S + pos] : x_s[st * G * kTile + g * kTile + j];
        pv = round_to<TA>(__fdiv_rn(expf(__fsub_rn(sv, stat[g])), stat[lay.rows + g]));
      }
      p_s[g * lay.ald + j] = from_f<CT>(pv);
    }
    __syncthreads();
    if constexpr (kTC) {
      const unsigned char* vt = raw;
      int vrs = lay.rs;
      if constexpr (kQuant) {
        __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem + lay.o_conv);
        dequant_tile<kTile>(raw, scl, lay.rs, conv, lay.cld, D);
        __syncthreads();
        vt = reinterpret_cast<const unsigned char*>(conv);
        vrs = lay.cld * 2;
      }
      // Warp w owns the (m16, n8) output tiles w, w + 8, ...: O (16 x 8)
      // += P (16 x 16 slots) V (16 slots x 8), k-steps in slot order; each
      // lane's four sums live in shared memory between tiles.
#pragma unroll 1
      for (int pi = warp; pi < pairs; pi += kWarps) {
        const int mt = pi / n_nt, nt = pi - mt * n_nt;
        float4* a4 = reinterpret_cast<float4*>(acc_s) + pi * 32 + lane;
        const float4 c4 = *a4;
        float cacc[4] = {c4.x, c4.y, c4.z, c4.w};
        for (int kt = 0; kt < kTile / 16; ++kt) {
          uint32_t af[4], bf[2];
          ldsm_x4(af, p_s + (mt * 16 + (lane & 15)) * lay.ald + kt * 16 + (lane >> 4) * 8);
          ldsm_x2_trans(bf, vt + (kt * 16 + (lane & 15)) * vrs + nt * 16);
          mma_bf16(cacc, af, bf);
        }
        *a4 = make_float4(cacc[0], cacc[1], cacc[2], cacc[3]);
      }
    } else {
      // One thread per (q head, d) output, slots in order.
#pragma unroll 1
      for (int o = tid; o < G * D; o += kThreads) {
        const int g = o / D, d = o - g * D;
        const CT* pg = p_s + g * lay.ald;
        float s = acc_s[o];
#pragma unroll 1
        for (int j = 0; j < kTile; ++j) {
          const TC* vr = reinterpret_cast<const TC*>(raw + j * lay.rs);
          s = fmaf(pg[j], cache_val<TA>(vr[d], kQuant ? scl[j] : 1.f), s);
        }
        acc_s[o] = s;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 5. The chunk's partial, then the group's sum in chunk order by its last
  //    CTA, every load of a thread's outputs in flight at once.
  float* part = p.part + (grp * NS + c) * G * D;
  if constexpr (kTC) {
#pragma unroll 1
    for (int i = tid; i < pairs * 32; i += kThreads) {
      const int pi = i >> 5, ln = i & 31, mt = pi / n_nt, nt = pi - mt * n_nt;
      const float4 c4 = reinterpret_cast<const float4*>(acc_s)[i];
      const float r[4] = {c4.x, c4.y, c4.z, c4.w};
      for (int k = 0; k < 4; ++k) {
        const int g = mt * 16 + (ln >> 2) + (k >> 1) * 8;
        const int d = nt * 8 + (ln & 3) * 2 + (k & 1);
        if (g < G) part[g * D + d] = r[k];
      }
    }
  } else {
#pragma unroll 1
    for (int o = tid; o < G * D; o += kThreads) part[o] = acc_s[o];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(p.tickets + p.B * K + grp, 1) == NS - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* part0 = p.part + grp * NS * G * D;
  const size_t out0 = head0 * D;
  const int n = G * D, stride = G * D;
  // Thread t adds columns t and t + kThreads (float4 where G * D allows),
  // four chunks' loads in flight for both before any add.
  const bool vec4 = (n & 3) == 0;
  const int cols = vec4 ? n / 4 : n;
#pragma unroll 1
  for (int o = tid; o < cols; o += 2 * kThreads) {
    const int o2 = o + kThreads;
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
#pragma unroll 1
    for (int c0 = 0; c0 < NS; c0 += 4) {
      float4 v0[4], v1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v0[u] = v1[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + u < NS) {
          const float* src = part0 + (c0 + u) * stride;
          if (vec4) {
            v0[u] = __ldcg(reinterpret_cast<const float4*>(src) + o);
            if (o2 < cols) v1[u] = __ldcg(reinterpret_cast<const float4*>(src) + o2);
          } else {
            v0[u].x = __ldcg(src + o);
            if (o2 < cols) v1[u].x = __ldcg(src + o2);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + u < NS) {
          s0.x += v0[u].x; s0.y += v0[u].y; s0.z += v0[u].z; s0.w += v0[u].w;
          s1.x += v1[u].x; s1.y += v1[u].y; s1.z += v1[u].z; s1.w += v1[u].w;
        }
      }
    }
    const float r[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll 1
    for (int k = 0; k < (vec4 ? 8 : 2); ++k) {
      const int col = k < (vec4 ? 4 : 1) ? o : o2;
      if (col >= cols) continue;
      const int at = vec4 ? 4 * col + (k & 3) : col;
      const float v = vec4 ? r[k] : r[k * 4];
      if constexpr (kShard) {
        static_cast<float*>(p.out)[out0 + at] = v;
      } else {
        static_cast<TA*>(p.out)[out0 + at] = from_f<TA>(v);
      }
    }
  }
}

// An empty kernel: the launch floor of a grid, for timing only.
__global__ void decode_attention_empty() {}

// --------------------------------------------------------------------------
// Launchers.
// --------------------------------------------------------------------------
enum Phase { kWhole, kShardScores, kShardPv };

// Launch one pass: its dynamic shared memory allowed past 48 KB, the
// largest shared-memory carveout asked for (the passes of a call run on
// one SM configuration), and, with `pdl`, programmatically after the pass
// before it on the stream.
// The dynamic shared memory each (kernel, device) was last allowed, so a
// launch sets a function attribute only when it needs more (the first
// launch on a device also asks for the largest carveout).
int set_attributes(const void* kernel, int smem) {
  struct Entry {
    const void* kernel;
    int device, smem;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> lock(mu);
  Entry* hit = nullptr;
  for (Entry& x : seen) {
    if (x.kernel == kernel && x.device == device) hit = &x;
  }
  if (hit == nullptr) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    seen.push_back({kernel, device, 48 * 1024});
    hit = &seen.back();
  }
  if (smem > hit->smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    hit->smem = smem;
  }
  return 0;
}

template <typename... Args>
int launch_pass(void (*kernel)(Args...), dim3 grid, int smem, cudaStream_t stream, bool pdl,
                Args... args) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = set_attributes(reinterpret_cast<const void*>(kernel), smem);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int launch_stats(const Params& p, int max_pass, int shard, bool pdl, cudaStream_t stream) {
  return launch_pass(decode_attention_stats, dim3(p.B, p.K, max_pass ? 1 : p.nsplit), 0, stream,
                     pdl, p, max_pass, shard);
}

// The whole call: scores, (stats,) p@V, each later pass launched
// programmatically.  A shard's passes: scores and max, or p@V alone.
template <typename TA, typename TC, bool kTC, bool kAsync>
int run_phase(Phase phase, Params p, cudaStream_t stream) {
  using L = Layout<TA, TC, kTC>;
  const dim3 grid(p.B, p.K, p.nsplit);
  p.fold = phase == kWhole && fold_stats(p.G, p.S, p.nsplit);
  int rc = 0;
  if (phase != kShardPv) {
    rc = launch_pass(decode_attention_scores<TA, TC, kTC, kAsync>, grid,
                     L(p.G, p.D, false).bytes, stream, false, p);
    if (rc != 0) return rc;
  }
  if (phase == kShardScores) return launch_stats(p, 1, 1, false, stream);
  const int smem = L(p.G, p.D, true, p.S, p.nsplit, p.fold != 0).bytes;
  if (phase == kShardPv) {
    return launch_pass(decode_attention_pv<TA, TC, kTC, kAsync, true>, grid, smem, stream, false,
                       p);
  }
  if (!p.fold) {
    rc = launch_stats(p, 0, 0, true, stream);
    if (rc != 0) return rc;
  }
  return launch_pass(decode_attention_pv<TA, TC, kTC, kAsync, false>, grid, smem, stream, true,
                     p);
}

// The build: tensor cores for bf16 activations whose head dim is a whole
// number of k16 steps (unless `cuda_cores` asks for the other build), CUDA
// cores otherwise; 16-byte cp.async where every cache row starts on a
// 16-byte boundary, one-element loads otherwise.  From dtypes, shapes and
// addresses only.
template <typename TA, typename TC>
int launch(Phase phase, const Params& p, int cuda_cores, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = (static_cast<size_t>(p.D) * sizeof(TC)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(p.k_cache) |
                     reinterpret_cast<uintptr_t>(p.v_cache)) & 15) == 0;
  if constexpr (std::is_same<TA, __nv_bfloat16>::value) {
    if (!cuda_cores && p.D % 16 == 0) {
      return vec ? run_phase<TA, TC, true, true>(phase, p, s)
                 : run_phase<TA, TC, true, false>(phase, p, s);
    }
  }
  return vec ? run_phase<TA, TC, false, true>(phase, p, s)
             : run_phase<TA, TC, false, false>(phase, p, s);
}

// Fill the workspace pointers of `p` from `work` (`work_bytes` long).
bool carve(Params& p, void* work, long long work_bytes) {
  const Workspace w(p.B, p.K, p.G, p.D, p.S, p.nsplit);
  if (work == nullptr || static_cast<long long>(w.bytes) > work_bytes) return false;
  auto* base = static_cast<unsigned char*>(work);
  p.scores = reinterpret_cast<float*>(base + w.scores);
  p.cmax = reinterpret_cast<float*>(base + w.cmax);
  p.psum = reinterpret_cast<float*>(base + w.psum);
  p.tickets = reinterpret_cast<int*>(base + w.tickets);
  p.part = reinterpret_cast<float*>(base + w.part);
  if (p.m == nullptr) p.m = reinterpret_cast<float*>(base + w.m);
  if (p.s == nullptr) p.s = reinterpret_cast<float*>(base + w.s);
  return true;
}

Params make_params(int B, int S, int ldb, int slot_base, int S_total, int H, int K, int D,
                   int W, int window, int is_ring, int chunk) {
  Params p{};
  p.B = B;
  p.S = S;
  p.ldb = ldb;
  p.slot_base = slot_base;
  p.S_total = S_total;
  p.H = H;
  p.K = K;
  p.G = H / K;
  p.D = D;
  p.W = W;
  p.window = window;
  p.is_ring = is_ring;
  p.chunk = chunk;
  p.nsplit = (S + chunk - 1) / chunk;
  return p;
}

}  // namespace

// Plain C entry points, one set per (activation, cache) dtype pair; each
// launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when `work` is shorter than the shapes need
// (`Workspace`).  `chunk` is split_plan's chunk,
// `cuda_cores` 1 runs a bf16 call on the CUDA-core build.
//   NAME: the whole call, two or three launches;
//   NAME_shard_scores: the scores pass on a slot shard and the local max of
//     each score row into m_out (B, H);
//   NAME_shard_pv: p@V on a slot shard under the global max m and sum s,
//     the f32 partial into out (B, H, D).
// decode_attention_shard_sum (dtype-free) takes the local softmax sums.
#define DECODE_ATTENTION_ENTRY(NAME, TA, TC)                                                \
  extern "C" int NAME(const void* q, const void* k_new, const void* v_new, void* k_cache,   \
                      void* v_cache, void* k_scale, void* v_scale, const void* lens,        \
                      const void* cos_b, const void* sin_b, void* out, void* work,          \
                      long long work_bytes, int B, int S, int H, int K, int D, int W,       \
                      int window, int is_ring, int chunk, int cuda_cores, void* stream) {   \
    Params p = make_params(B, S, S, 0, S, H, K, D, W, window, is_ring, chunk);              \
    p.q = q; p.k_new = k_new; p.v_new = v_new; p.k_cache = k_cache; p.v_cache = v_cache;    \
    p.k_scale = static_cast<float*>(k_scale); p.v_scale = static_cast<float*>(v_scale);     \
    p.lens = static_cast<const int*>(lens);                                                 \
    p.cos_b = static_cast<const float*>(cos_b); p.sin_b = static_cast<const float*>(sin_b); \
    p.out = out;                                                                            \
    if (!carve(p, work, work_bytes)) return static_cast<int>(cudaErrorInvalidValue);        \
    return launch<TA, TC>(kWhole, p, cuda_cores, stream);                                   \
  }                                                                                         \
  extern "C" int NAME##_shard_scores(                                                       \
      const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,    \
      void* k_scale, void* v_scale, const void* lens, const void* cos_b, const void* sin_b, \
      void* m_out, void* work, long long work_bytes, int B, int S, int ldb, int slot_base,  \
      int S_total, int H, int K, int D, int W, int window, int is_ring, int chunk,          \
      int cuda_cores, void* stream) {                                                       \
    Params p = make_params(B, S, ldb, slot_base, S_total, H, K, D, W, window, is_ring,      \
                           chunk);                                                          \
    p.q = q; p.k_new = k_new; p.v_new = v_new; p.k_cache = k_cache; p.v_cache = v_cache;    \
    p.k_scale = static_cast<float*>(k_scale); p.v_scale = static_cast<float*>(v_scale);     \
    p.lens = static_cast<const int*>(lens);                                                 \
    p.cos_b = static_cast<const float*>(cos_b); p.sin_b = static_cast<const float*>(sin_b); \
    p.m_out = static_cast<float*>(m_out);                                                   \
    if (!carve(p, work, work_bytes)) return static_cast<int>(cudaErrorInvalidValue);        \
    return launch<TA, TC>(kShardScores, p, cuda_cores, stream);                             \
  }                                                                                         \
  extern "C" int NAME##_shard_pv(void* k_cache, void* v_cache, void* v_scale,               \
                                 const void* lens, void* out, void* work,                   \
                                 long long work_bytes, void* m, void* s, int B, int S,      \
                                 int ldb, int slot_base, int S_total, int H, int K, int D,  \
                                 int window, int chunk, int cuda_cores, void* stream) {     \
    Params p = make_params(B, S, ldb, slot_base, S_total, H, K, D, 0, window, 0, chunk);    \
    p.k_cache = k_cache; p.v_cache = v_cache; p.v_scale = static_cast<float*>(v_scale);     \
    p.lens = static_cast<const int*>(lens); p.out = out;                                    \
    p.m = static_cast<float*>(m); p.s = static_cast<float*>(s);                             \
    if (!carve(p, work, work_bytes)) return static_cast<int>(cudaErrorInvalidValue);        \
    return launch<TA, TC>(kShardPv, p, cuda_cores, stream);                                 \
  }

DECODE_ATTENTION_ENTRY(decode_attention_f32, float, float)
DECODE_ATTENTION_ENTRY(decode_attention_bf16, __nv_bfloat16, __nv_bfloat16)
DECODE_ATTENTION_ENTRY(decode_attention_q8_f32, float, int8_t)
DECODE_ATTENTION_ENTRY(decode_attention_q8_bf16, __nv_bfloat16, int8_t)

extern "C" int decode_attention_shard_sum(void* work, long long work_bytes, void* m,
                                          void* s_out, const void* lens, int B, int S,
                                          int slot_base, int S_total, int H, int K, int D,
                                          int window, int chunk, void* stream) {
  Params p = make_params(B, S, S, slot_base, S_total, H, K, D, 0, window, 0, chunk);
  p.lens = static_cast<const int*>(lens);
  p.m = static_cast<float*>(m);
  p.s_out = static_cast<float*>(s_out);
  if (!carve(p, work, work_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_stats(p, 0, 1, false, static_cast<cudaStream_t>(stream));
}

// `launches` launches of an empty kernel on the grid (B, K, nsplit) of
// kThreads threads: the launch floor of the passes, for timing.
extern "C" int decode_attention_empty_grid(int B, int K, int nsplit, int launches,
                                           void* stream) {
  for (int i = 0; i < launches; ++i) {
    decode_attention_empty<<<dim3(B, K, nsplit), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// Absorbed multi-head latent attention (DeepSeek-V2/V3) over a latent cache.
// --------------------------------------------------------------------------
// The decode step of `mla_block` (src/repro_torch/models/layers.py), whose
// plain version is `latent_decode_attention_plain` in
// src/repro_torch/kernels/decode_attention.py.  Each of H heads has a query
// of DK = R + Dr values over the latent (its no-rope dims already folded
// through kv_b_proj's key block, then its roped dims); every position
// caches one DK-wide row (the normed R-wide latent, then the roped shared
// key), and a position's value is the leading DV = R values of its row.
// Every head reads the same rows: the fused decode attention's one-kv-head
// case, with a 576-wide key and a 512-wide value taken from one row.
//
// What bounds it on an H100.  A cached position costs 2*H*(DK + DV) flops
// (139k at H = 32) against DK*2 bytes (1152) read, about 60 flop/byte, far
// below the tensor cores' ~295: the bound is the live latent read once over
// 3.35 TB/s (11 us a layer at kanana-2-30b-a3b's 4 rows of 8256 slots).
//
// What the design does about it:
//   * A. decode_attention_scores_pv_latent, grid (NSPLIT, B, H / HG): one
//     CTA per (chunk of slots, batch row, group of HG = 16 or 32 heads);
//     the chunk from shapes only (`latent_split_plan`), about one CTA per
//     SM.  The group's q rows stay in shared memory; the chunk's live
//     64-row tiles go through a ring of two shared-memory stages by 16-byte
//     cp.async (rows past the live ones zero-filled), so the next tile's
//     load is in flight while one is multiplied.  Per tile: S = q.K^T on
//     the tensor cores (mma.sync m16n8k16 bf16 -> f32, each warp one m16
//     row tile by 8*MT columns), divided by the caller's scale; an online
//     softmax per row (f32 max and sum, p rounded to bf16); O = O*alpha +
//     p@V with V the tile's leading DV columns, already in shared memory, so
//     each latent row is read from device memory once for both products
//     (each warp owns DV/8 columns of every row in registers).  The chunk
//     writes its unnormalised f32 O and its (max, sum).
//   * S. decode_attention_stats_latent, grid (B, H): the row's live chunks
//     merged under their common max in chunk order, divided by the merged
//     sum and cast once.  Dead chunks (past the row's length) never run.
// Rows padded in shared memory by 16 bytes (1168 B a latent row, an odd
// number of 16-byte pieces) so ldmatrix's eight rows hit distinct banks.
// Numerics: products in f32 from bf16 operands; scores divided (not
// multiplied by a reciprocal) by `scale_div`; expf; p rounded to bf16
// before p@V, as the plain version rounds its probabilities.  The online
// softmax takes p under a running max, so results agree with the plain
// version to bf16 rounding, not bit for bit.
//
// Workspace (one device buffer per call): partials (B, NSPLIT, H, DV) f32
// | chunk max and sum (B, NSPLIT, H, 2) f32.
namespace {

constexpr int kLatTile = 64;    // latent rows per tile
constexpr int kLatStages = 2;   // tiles in the shared-memory ring

struct LatentParams {
  const __nv_bfloat16* q;       // (B, H, DK)
  const __nv_bfloat16* latent;  // (B, S, DK)
  const int* lens;              // (B,) live rows, the new one included
  __nv_bfloat16* out;           // (B, H, DV)
  float* part;                  // workspace: (B, NSPLIT, H, DV)
  float* stat;                  // workspace: (B, NSPLIT, H, 2)
  float scale_div;              // the scores are divided by it
  int B, S, H, chunk, nsplit;
};

// Byte offsets of one CTA's shared memory: q rows, the ring, the tile's f32
// scores, its bf16 p, and per row the rescale of O, the running max and sum.
template <int kDK, int kMT>
struct LatentLayout {
  static constexpr int kRows = 16 * kMT;
  static constexpr int kLd = kDK + 8;          // bf16 per q or latent row
  static constexpr int kSld = kLatTile + 4;    // f32 per score row
  static constexpr int kPld = kLatTile + 8;    // bf16 per p row
  static constexpr int q = 0;
  static constexpr int ring = q + kRows * kLd * 2;
  static constexpr int s = ring + kLatStages * kLatTile * kLd * 2;
  static constexpr int pr = s + kRows * kSld * 4;
  static constexpr int alpha = pr + kRows * kPld * 2;
  static constexpr int ml = alpha + kRows * 4;
  static constexpr int bytes = ml + 2 * kRows * 4;
};

// Rows [base, base + kLatTile) of one batch row's latent into `dst`; rows
// at or past `hi` are zero-filled (p@V would carry their stale bits).
template <int kDK, int kLd>
__device__ __forceinline__ void load_latent_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                 int base, int hi) {
  constexpr int kPieces = kDK * 2 / 16;
#pragma unroll 1
  for (int i = threadIdx.x; i < kLatTile * kPieces; i += kThreads) {
    const int r = i / kPieces, c = i % kPieces;
    const bool fill = base + r < hi;
    cp_async16(dst + r * kLd + c * 8,
               src + static_cast<size_t>(fill ? base + r : base) * kDK + c * 8, fill);
  }
}

template <int kDK, int kDV, int kMT>
__global__ void __launch_bounds__(kThreads) decode_attention_scores_pv_latent(
    const LatentParams p) {
  using L = LatentLayout<kDK, kMT>;
  constexpr int kRows = L::kRows;
  constexpr int kWarpsPerM = kWarps / kMT;   // warps per m16 row tile (scores)
  constexpr int kNO = kDV / kWarps / 8;      // n8 tiles of O per warp
  static_assert(kDK % 16 == 0 && kDV % (kWarps * 8) == 0 && kDV <= kDK, "widths");
  extern __shared__ __align__(16) unsigned char smem[];
  auto* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  auto* ring = reinterpret_cast<__nv_bfloat16*>(smem + L::ring);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  auto* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::pr);
  float* alpha_s = reinterpret_cast<float*>(smem + L::alpha);
  float* m_s = reinterpret_cast<float*>(smem + L::ml);
  float* l_s = m_s + kRows;

  const int split = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int live = min(p.lens[b], p.S);
  const int lo = split * p.chunk, hi = min(lo + p.chunk, live);
  if (lo >= hi) return;
  const int ntiles = (hi - lo + kLatTile - 1) / kLatTile;
  const __nv_bfloat16* src = p.latent + static_cast<size_t>(b) * p.S * kDK;

  // The group's q rows and the first tile.
  constexpr int kPieces = kDK * 2 / 16;
  const __nv_bfloat16* qg = p.q + (static_cast<size_t>(b) * p.H + h0) * kDK;
#pragma unroll 1
  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int r = i / kPieces, c = i % kPieces;
    cp_async16(q_s + r * L::kLd + c * 8, qg + r * kDK + c * 8, true);
  }
  load_latent_tile<kDK, L::kLd>(ring, src, lo, hi);
  cp_async_commit();
  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int wm = warp / kWarpsPerM, wn = (warp % kWarpsPerM) * 8 * kMT;
  const int on = warp * (kDV / kWarps);
  float acc[kMT][kNO][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int base = lo + t * kLatTile;
    if (t + 1 < ntiles) {
      load_latent_tile<kDK, L::kLd>(ring + ((t + 1) % kLatStages) * kLatTile * L::kLd, src,
                                    base + kLatTile, hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ring + (t % kLatStages) * kLatTile * L::kLd;

    // 1. The tile's scores, slots past `hi` at -inf.
    {
      float sacc[kMT][4];
#pragma unroll
      for (int j = 0; j < kMT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll 4
      for (int k = 0; k < kDK / 16; ++k) {
        uint32_t af[4];
        ldsm_x4(af, q_s + (wm * 16 + (lane & 15)) * L::kLd + k * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kMT; ++j) {
          uint32_t bf[2];
          ldsm_x2(bf, kt + (wn + j * 8 + (lane & 7)) * L::kLd + k * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sacc[j], af, bf);
        }
      }
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm * 16 + (lane >> 2) + (e >> 1) * 8;
          const int c = wn + j * 8 + (lane & 3) * 2 + (e & 1);
          s_s[r * L::kSld + c] =
              base + c < hi ? __fdiv_rn(sacc[j][e], p.scale_div) : -INFINITY;
        }
      }
    }
    __syncthreads();

    // 2. Online softmax, one warp a row: running max and sum, p in bf16.
#pragma unroll 1
    for (int r = warp; r < kRows; r += kWarps) {
      const float s0 = s_s[r * L::kSld + lane], s1 = s_s[r * L::kSld + lane + 32];
      const float m_old = m_s[r];
      const float m_new = nan_max(m_old, warp_max(nan_max(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float alpha = expf(m_old - m_new);
      const float sum = warp_sum(p0 + p1);
      p_s[r * L::kPld + lane] = __float2bfloat16_rn(p0);
      p_s[r * L::kPld + lane + 32] = __float2bfloat16_rn(p1);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // 3. O = O * alpha + p@V, V the tile's leading kDV columns.
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const float a0 = alpha_s[i * 16 + (lane >> 2)], a1 = alpha_s[i * 16 + (lane >> 2) + 8];
#pragma unroll
      for (int j = 0; j < kNO; ++j) {
        acc[i][j][0] *= a0;
        acc[i][j][1] *= a0;
        acc[i][j][2] *= a1;
        acc[i][j][3] *= a1;
      }
    }
#pragma unroll
    for (int k = 0; k < kLatTile / 16; ++k) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldsm_x4(af[i], p_s + (i * 16 + (lane & 15)) * L::kPld + k * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNO; ++j) {
        uint32_t bf[2];
        ldsm_x2_trans(bf, kt + (k * 16 + (lane & 15)) * L::kLd + on + j * 8);
#pragma unroll
        for (int i = 0; i < kMT; ++i) mma_bf16(acc[i][j], af[i], bf);
      }
    }
    __syncthreads();
  }

  // 4. The chunk's unnormalised O and its max and sum.
  const size_t row0 = (static_cast<size_t>(b) * p.nsplit + split) * p.H + h0;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      const int r = i * 16 + (lane >> 2), c = on + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(p.part + (row0 + r) * kDV + c) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(p.part + (row0 + r + 8) * kDV + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  if (tid < kRows) {
    p.stat[(row0 + tid) * 2] = m_s[tid];
    p.stat[(row0 + tid) * 2 + 1] = l_s[tid];
  }
}

template <int kDV>
__global__ void __launch_bounds__(kThreads) decode_attention_stats_latent(const LatentParams p) {
  static_assert(kDV % kThreads == 0, "widths");
  constexpr int kPer = kDV / kThreads;
  const int b = blockIdx.x, h = blockIdx.y;
  const int live = min(p.lens[b], p.S);
  const int n = live > 0 ? (live + p.chunk - 1) / p.chunk : 0;
  const size_t row0 = static_cast<size_t>(b) * p.nsplit * p.H + h;
  float mx = -INFINITY;
#pragma unroll 1
  for (int c = 0; c < n; ++c) mx = nan_max(mx, p.stat[(row0 + static_cast<size_t>(c) * p.H) * 2]);
  float sum = 0.f, o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < n; ++c) {
    const size_t row = row0 + static_cast<size_t>(c) * p.H;
    const float w = expf(p.stat[row * 2] - mx);
    sum += w * p.stat[row * 2 + 1];
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[i] += w * p.part[row * kDV + threadIdx.x + i * kThreads];
  }
  __nv_bfloat16* out = p.out + (static_cast<size_t>(b) * p.H + h) * kDV;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    out[threadIdx.x + i * kThreads] = __float2bfloat16_rn(n ? __fdiv_rn(o[i], sum) : 0.f);
}

template <int kDK, int kDV, int kMT>
int launch_latent(const LatentParams& p, cudaStream_t stream) {
  using L = LatentLayout<kDK, kMT>;
  const int rc = launch_pass(decode_attention_scores_pv_latent<kDK, kDV, kMT>,
                             dim3(p.nsplit, p.B, p.H / L::kRows), L::bytes, stream, false, p);
  if (rc != 0) return rc;
  return launch_pass(decode_attention_stats_latent<kDV>, dim3(p.B, p.H), 0, stream, false, p);
}

}  // namespace

// The absorbed MLA step: q (B, H, DK) and the latent cache (B, S, DK) bf16,
// lens (B,) int32 live rows, out (B, H, DV) bf16; two launches on `stream`.
// Built for (DK, DV) = (576, 512) and H a multiple of 16; other shapes, or
// a `work` shorter than (B, NSPLIT, H, DV + 2) f32, return
// cudaErrorInvalidValue.  `chunk` is latent_split_plan's, a multiple of 64.
extern "C" int decode_attention_latent_bf16(const void* q, const void* latent, const void* lens,
                                            void* out, void* work, long long work_bytes, int B,
                                            int S, int H, int DK, int DV, float scale_div,
                                            int chunk, void* stream) {
  if (DK != 576 || DV != 512 || H % 16 != 0 || chunk <= 0 || chunk % kLatTile != 0 || B <= 0 ||
      S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LatentParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.latent = static_cast<const __nv_bfloat16*>(latent);
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.scale_div = scale_div;
  p.B = B;
  p.S = S;
  p.H = H;
  p.chunk = chunk;
  p.nsplit = (S + chunk - 1) / chunk;
  const size_t rows = static_cast<size_t>(B) * p.nsplit * H;
  const size_t part = align_up(rows * DV * 4, 256);
  if (work == nullptr || static_cast<long long>(part + rows * 2 * 4) > work_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.part = static_cast<float*>(work);
  p.stat = reinterpret_cast<float*>(static_cast<unsigned char*>(work) + part);
  auto s = static_cast<cudaStream_t>(stream);
  return H % 32 == 0 ? launch_latent<576, 512, 2>(p, s) : launch_latent<576, 512, 1>(p, s);
}
