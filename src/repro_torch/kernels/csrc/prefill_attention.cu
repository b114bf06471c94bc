// Causal GQA attention over a prompt for Hopper (sm_90a): the prefill's
// attention, one launch per call, the softmax kept on chip.
//
// Replaces no Pallas kernel: the JAX package's prefill attention is plain
// jnp (`chunked_attention`, src/repro/models/layers.py), which XLA fuses.
// The port ran the same arithmetic as plain tensor code: both operands
// upcast to f32 (the reference's preferred_element_type=float32), every
// product on CUDA cores, every 1024-key chunk of scores written to device
// memory and read back by a dozen elementwise passes.  This kernel computes
// the same function; its plain PyTorch version is `prefill_attention_plain`
// in src/repro_torch/kernels/prefill_attention.py, which is also
// `models.layers.chunked_attention`.
//
// What bounds it on an H100.  q (B, L, H, D) attends causally over k, v
// (B, L, K, D): 4*B*H*D*L*(L+1)/2 flops against B*L*(2H + 2K)*D*2 bytes of
// q, k, v and output, about L/2 flop per byte at D = 128, so from a few
// hundred positions on the bound is the bf16 tensor-core rate (989 TFLOP/s):
// 139 us a layer at chatglm3-6b's B = 4, L = 2048 (H = 32, K = 2), against
// 43 us for its 0.14 GB over 3.35 TB/s.  Everything else has to stay off the
// device memory and out of the tensor cores' way: the scores, the softmax,
// and the shared-memory reads that feed the products.
//
// What the design does about it (FlashAttention's schedule, on Hopper's
// warpgroup products and tensor memory copies):
//   * One CTA per (batch row, q head, tile of kBM = 128 query positions):
//     two warpgroups of 64 rows each (D = 256: one, of 64).  The CTA walks
//     the key tiles of kBN = 64 keys its rows can see: tiles wholly above
//     the causal diagonal, wholly outside `window` (0: none) or past L are
//     never loaded.  Their weights are exactly 0 in the plain version, so
//     nothing changes.  Both warpgroups take every tile of the CTA: a branch
//     around the products makes ptxas serialise them.  The grid's fastest
//     axis runs over (batch row, head) and the q tiles run from the last
//     (the longest rows) to the first, so the longest CTAs start first and
//     the short ones fill the tail.
//   * GQA relies on L2: q head h reads kv head h / (H/K) (K-major), and the
//     CTAs in flight at once hold the same q tile of every head, so one kv
//     head's tiles serve its G q heads out of the 50 MB L2 (one kv head's
//     K and V at L = 2048, D = 128 take 1 MB; the whole of chatglm3-6b's
//     at B = 4 takes 8 MB).  A CTA holding all G heads of a group would
//     need G x 128 rows of accumulators: G = 16 does not fit a CTA.
//   * q.K^T and p@V on the tensor cores by wgmma (bf16 operands, f32
//     accumulators): q.K^T reads q and the K tile from shared memory
//     through descriptors, p@V takes p from registers and the V tile from
//     shared memory (transposed).  The tensor cores read each tile once per
//     warpgroup of 64 rows; mma.sync's fragment loads would read it once per
//     warp of 16, and that shared-memory traffic, not the products, would
//     bound the kernel.
//   * Tiles reach shared memory by TMA, issued by one thread, in the
//     128-byte swizzle that wgmma reads without bank conflicts (rows past L
//     arrive as zeros); three stages, each group of copies issued two tiles
//     ahead and counted on an mbarrier.  Copies issued by every thread
//     (cp.async) stall behind the products' shared-memory reads.
//   * The scores of a warpgroup's 64 rows and 64 keys stay in registers,
//     are scaled, masked and turned into p there, and p goes from the score
//     registers into the A operand of p@V: no score reaches shared or device
//     memory.  Each warpgroup issues the scores of tile j and the p@V of tile
//     j - 1 together, and takes tile j's softmax while p@V runs.
//   * The online softmax's running max and sum live in registers (the sum
//     as each thread's partial over its keys, added over the row's four
//     threads at the end); the f32 output accumulators too, rescaled only
//     where some row's max moved.  The output is cast once, staged through
//     the warp's own rows of the q tile and written in 16-byte pieces.
//
// Widths: q and k share one head width DK, v and the output have DV.  The
// instantiations are (64, 64), (128, 128), (256, 256) and (192, 128), the
// last for multi-head latent attention's decompressed prefill (DeepSeek-V3's
// layout: 128 + 64 rotary dims of q and k, 128 of v), whose 32 heads each
// have their own k and v (K = H).  DK sets the q tile, the K ring and the
// q.K^T k-steps, DV the V ring, the accumulators and the output; the output
// is staged in the q tile, which DV <= DK lets it fit.  At (192, 128) the
// CTA takes (128 x 192 + 3 x 64 x 320) x 2 = 168 KiB of shared memory.
//
// Numerics: the rounding points of `chunked_attention`.  Scores are f32
// sums of exact bf16 products; the 1/sqrt(D) scale is one f32 multiply
// (the double 1/sqrt(D) rounded to f32, as PyTorch rounds a Python scalar);
// masked keys score NEG_INF = -0.7 * FLT_MAX; the running max, exp(s - m),
// the correction exp(m_old - m_new), the sum and the rescaled accumulators
// are f32, rounded one operation at a time (no FMA contraction); p is
// rounded to bf16 before p@V, which accumulates in f32; the output is
// acc / max(sum, 1e-30), cast to bf16 once.  Only the order of the sums
// and the running max's tile width (64 keys here, 1024 in the plain
// version) differ.  A row whose first tiles hold none of its keys (a
// window) takes exp(0) = 1 for them, as the plain version does for such a
// chunk, and the first tile with a key multiplies that by exp(NEG_INF - m)
// = 0, so both come to the same result.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBN = 64;                  // keys per tile
constexpr int kStages = 3;               // K tiles (and V tiles) in the rings

// The CTA: kBM query positions, a warpgroup (128 threads) per 64 of them;
// DK = 256 takes one warpgroup, so that three stages fit in shared memory.
template <int DK, int DV> struct Cta {
  static_assert(DV <= DK, "the output is staged in the q tile");
  static constexpr int kBM = DK == 256 ? 64 : 128;
  static constexpr int kThreads = kBM * 2;
  static constexpr int kSmem = (kBM * DK + kStages * kBN * (DK + DV)) * 2 + kStages * 8;
};
// -0.7 * FLT_MAX computed in double and rounded once, as Python computes it.
constexpr float kNegInf = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

// The running max.  fmaxf drops a NaN score where torch.amax would keep
// it, but a NaN score makes its p, and so its row's sum and output, NaN all
// the same, as in the plain version.
__device__ __forceinline__ float row_max(float a, float b) { return fmaxf(a, b); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers: a TMA group's copies complete a phase of their barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA box (64 columns of a head's rows, see `make_map`) at coordinates
// (column, head, row, batch) into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int head,
                                        int row, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(head), "r"(row), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an asynchronous
// product's registers (accumulators, A fragments) across its issue or wait.
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N> __device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Tiles in shared memory: a [ROWS][D] bf16 tile is cut into D / 64 column
// blocks of ROWS rows of 128 bytes, each block 1024-byte aligned, and the
// 16-byte chunk c of row r lies at chunk c ^ (r % 8) of its row: the
// 128-byte swizzle that wgmma reads without bank conflicts (and TMA would
// write).  Byte offset of (row r, column x) in a tile of ROWS rows:
__device__ __forceinline__ int swz(int rows, int r, int x) {
  return (x / 64) * rows * 128 + r * 128 + ((((x / 8) % 8) ^ (r % 8)) << 4) + (x % 8) * 2;
}

// A shared-memory matrix descriptor for the 128-byte swizzle: `lbo` the
// bytes between 64-wide column blocks of an MN-major operand (unused for
// K-major ones), `sbo` the bytes between 8-row groups (1024).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// s (64 x 64 per warpgroup, f32) = a (64 x 16) * b (16 x 64), plus s where
// `accumulate` is not 0: a and b K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(s[0]), "+f"(s[1]), "+f"(s[2]), "+f"(s[3]), "+f"(s[4]), "+f"(s[5]), "+f"(s[6]), "+f"(s[7]),
        "+f"(s[8]), "+f"(s[9]), "+f"(s[10]), "+f"(s[11]), "+f"(s[12]), "+f"(s[13]), "+f"(s[14]), "+f"(s[15]),
        "+f"(s[16]), "+f"(s[17]), "+f"(s[18]), "+f"(s[19]), "+f"(s[20]), "+f"(s[21]), "+f"(s[22]), "+f"(s[23]),
        "+f"(s[24]), "+f"(s[25]), "+f"(s[26]), "+f"(s[27]), "+f"(s[28]), "+f"(s[29]), "+f"(s[30]), "+f"(s[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// o (64 x 64 per warpgroup, f32) += p (64 x 16, bf16 fragments in registers) *
// v (16 x 64), v MN-major in shared memory (transposed descriptor).
__device__ __forceinline__ void wgmma_pv(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]), "+f"(o[6]), "+f"(o[7]),
        "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]), "+f"(o[12]), "+f"(o[13]), "+f"(o[14]), "+f"(o[15]),
        "+f"(o[16]), "+f"(o[17]), "+f"(o[18]), "+f"(o[19]), "+f"(o[20]), "+f"(o[21]), "+f"(o[22]), "+f"(o[23]),
        "+f"(o[24]), "+f"(o[25]), "+f"(o[26]), "+f"(o[27]), "+f"(o[28]), "+f"(o[29]), "+f"(o[30]), "+f"(o[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// o (64 x 128 per warpgroup, f32) += p (64 x 16, bf16 fragments in registers) *
// v (16 x 128), v MN-major in shared memory (transposed descriptor).
__device__ __forceinline__ void wgmma_pv(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]), "+f"(o[6]), "+f"(o[7]),
        "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]), "+f"(o[12]), "+f"(o[13]), "+f"(o[14]), "+f"(o[15]),
        "+f"(o[16]), "+f"(o[17]), "+f"(o[18]), "+f"(o[19]), "+f"(o[20]), "+f"(o[21]), "+f"(o[22]), "+f"(o[23]),
        "+f"(o[24]), "+f"(o[25]), "+f"(o[26]), "+f"(o[27]), "+f"(o[28]), "+f"(o[29]), "+f"(o[30]), "+f"(o[31]),
        "+f"(o[32]), "+f"(o[33]), "+f"(o[34]), "+f"(o[35]), "+f"(o[36]), "+f"(o[37]), "+f"(o[38]), "+f"(o[39]),
        "+f"(o[40]), "+f"(o[41]), "+f"(o[42]), "+f"(o[43]), "+f"(o[44]), "+f"(o[45]), "+f"(o[46]), "+f"(o[47]),
        "+f"(o[48]), "+f"(o[49]), "+f"(o[50]), "+f"(o[51]), "+f"(o[52]), "+f"(o[53]), "+f"(o[54]), "+f"(o[55]),
        "+f"(o[56]), "+f"(o[57]), "+f"(o[58]), "+f"(o[59]), "+f"(o[60]), "+f"(o[61]), "+f"(o[62]), "+f"(o[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// o (64 x 256 per warpgroup, f32) += p (64 x 16, bf16 fragments in registers) *
// v (16 x 256), v MN-major in shared memory (transposed descriptor).
__device__ __forceinline__ void wgmma_pv(float (&o)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]), "+f"(o[6]), "+f"(o[7]),
        "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]), "+f"(o[12]), "+f"(o[13]), "+f"(o[14]), "+f"(o[15]),
        "+f"(o[16]), "+f"(o[17]), "+f"(o[18]), "+f"(o[19]), "+f"(o[20]), "+f"(o[21]), "+f"(o[22]), "+f"(o[23]),
        "+f"(o[24]), "+f"(o[25]), "+f"(o[26]), "+f"(o[27]), "+f"(o[28]), "+f"(o[29]), "+f"(o[30]), "+f"(o[31]),
        "+f"(o[32]), "+f"(o[33]), "+f"(o[34]), "+f"(o[35]), "+f"(o[36]), "+f"(o[37]), "+f"(o[38]), "+f"(o[39]),
        "+f"(o[40]), "+f"(o[41]), "+f"(o[42]), "+f"(o[43]), "+f"(o[44]), "+f"(o[45]), "+f"(o[46]), "+f"(o[47]),
        "+f"(o[48]), "+f"(o[49]), "+f"(o[50]), "+f"(o[51]), "+f"(o[52]), "+f"(o[53]), "+f"(o[54]), "+f"(o[55]),
        "+f"(o[56]), "+f"(o[57]), "+f"(o[58]), "+f"(o[59]), "+f"(o[60]), "+f"(o[61]), "+f"(o[62]), "+f"(o[63]),
        "+f"(o[64]), "+f"(o[65]), "+f"(o[66]), "+f"(o[67]), "+f"(o[68]), "+f"(o[69]), "+f"(o[70]), "+f"(o[71]),
        "+f"(o[72]), "+f"(o[73]), "+f"(o[74]), "+f"(o[75]), "+f"(o[76]), "+f"(o[77]), "+f"(o[78]), "+f"(o[79]),
        "+f"(o[80]), "+f"(o[81]), "+f"(o[82]), "+f"(o[83]), "+f"(o[84]), "+f"(o[85]), "+f"(o[86]), "+f"(o[87]),
        "+f"(o[88]), "+f"(o[89]), "+f"(o[90]), "+f"(o[91]), "+f"(o[92]), "+f"(o[93]), "+f"(o[94]), "+f"(o[95]),
        "+f"(o[96]), "+f"(o[97]), "+f"(o[98]), "+f"(o[99]), "+f"(o[100]), "+f"(o[101]), "+f"(o[102]), "+f"(o[103]),
        "+f"(o[104]), "+f"(o[105]), "+f"(o[106]), "+f"(o[107]), "+f"(o[108]), "+f"(o[109]), "+f"(o[110]), "+f"(o[111]),
        "+f"(o[112]), "+f"(o[113]), "+f"(o[114]), "+f"(o[115]), "+f"(o[116]), "+f"(o[117]), "+f"(o[118]), "+f"(o[119]),
        "+f"(o[120]), "+f"(o[121]), "+f"(o[122]), "+f"(o[123]), "+f"(o[124]), "+f"(o[125]), "+f"(o[126]), "+f"(o[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Two f32 values rounded to bf16 (round to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A tile of ROWS rows of D values of one head, from row `row0` of batch
// row b, as D / 64 TMA boxes into the swizzled layout (`swz`); rows past L
// arrive as zeros.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, int head, int row0,
                                         int b, uint64_t* bar) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    tma_box(reinterpret_cast<unsigned char*>(dst) + cb * ROWS * 128, map, cb * 64, head, row0, b,
            bar);
}

// q, k, v through their TMA maps (`make_map`); out (B, L, H, DV) contiguous
// bf16.  Grid (B * H, ceil(L / kBM)), Cta<DK, DV>::kThreads threads,
// Cta<DK, DV>::kSmem bytes of shared memory.
template <int DK, int DV>
__global__ void __launch_bounds__(Cta<DK, DV>::kThreads, 1)
    prefill_attention_fwd(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int L,
                          int H, int K, int window, float scale) {
  constexpr int kBM = Cta<DK, DV>::kBM;
  constexpr int kTileK = kBN * DK;          // elements of a K tile
  constexpr int kTileV = kBN * DV;          // elements of a V tile
  constexpr uint32_t kBlock = kBN * 128;    // bytes between column blocks of a K or V tile
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBM * DK;                 // [kStages][kBN x DK]
  bf16* sV = sK + kStages * kTileK;         // [kStages][kBN x DV]
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kTileV);   // [kStages]

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kvh = h / (H / K);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBM;    // longest rows first
  const int r_last = min(r0 + kBM, L) - 1;
  const int j_lo = window > 0 ? max(0, r0 - window + 1) / kBN : 0;
  const int j_hi = r_last / kBN;
  const size_t os = static_cast<size_t>(H) * DV;     // the output's row stride
  const size_t o_at = static_cast<size_t>(b) * L * os + static_cast<size_t>(h) * DV;

  // Tile t lies in stage (t - j_lo) % kStages of its ring.  Group g of
  // copies holds V tile j_lo + g - 1 and K tile j_lo + g (group 0: q and
  // K tile j_lo; a tile past j_hi is not loaded); one thread issues it, and
  // it completes phase g / kStages of barrier full[g % kStages].
  auto stage = [&](int tile) { return (tile - j_lo) % kStages; };
  auto load_group = [&](int g) {
    if (threadIdx.x != 0) return;
    const int t_v = j_lo + g - 1, t_k = j_lo + g;
    const bool has_v = t_v >= j_lo && t_v <= j_hi, has_k = t_k <= j_hi;
    uint64_t* bar = full + g % kStages;
    mbar_expect(bar, (has_v * kTileV + has_k * kTileK) * 2 + (g == 0 ? kBM * DK * 2 : 0));
    if (g == 0) tma_tile<DK, kBM>(sQ, &tq, h, r0, b, bar);
    if (has_v) tma_tile<DV, kBN>(sV + stage(t_v) * kTileV, &tv, kvh, t_v * kBN, b, bar);
    if (has_k) tma_tile<DK, kBN>(sK + stage(t_k) * kTileK, &tk, kvh, t_k * kBN, b, bar);
  };
  auto group_landed = [&](int g) { mbar_wait(full + g % kStages, (g / kStages) & 1); };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int g = 0; g < kStages; ++g) load_group(g);

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = r0 + warp * 16;            // the warp's first query position
  const int row[2] = {w0 + g, w0 + g + 8};  // the rows of s[.][0..1] and s[.][2..3]
  const bf16* sq = sQ + wg * 64 * 64;       // the warpgroup's 64 rows of q

  float o[DV / 2];                          // o[4n + e]: row row[e / 2], column 8n + 2t + e % 2
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float s[32];                              // s[4n + e]: row row[e / 2], key 8n + 2t + e % 2
  uint32_t p[16];                           // p in bf16, as p@V's A fragments
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float corr[2];

  // Tile j's scores (K stage `sk`) into s, and the p@V of the p held in p
  // (V stage `sv`) into o, each as one batch of warpgroup products.
  // A k-step's operand is a fixed byte offset from its tile's descriptor,
  // which is added to the start address field (in 16-byte units).
  const uint64_t dq = desc(sq, 1);
  auto issue_qk = [&](const bf16* sk) {
    const uint64_t dk = desc(sk, 1);
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_qk(s, dq + ((kk / 4) * kBM * 128 + (kk % 4) * 32) / 16,
               dk + ((kk / 4) * kBN * 128 + (kk % 4) * 32) / 16, kk);
    wgmma_commit();
  };
  auto issue_pv = [&](const bf16* sv) {
    const uint64_t dv = desc(sv, kBlock);
    pin(o);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3]};
      wgmma_pv(o, a, dv + ks * 16 * 128 / 16);
    }
    wgmma_commit();
  };
  // The scores of the tile from key `key0` in s: scale, mask where some
  // (row, key) of the warp's 16 rows is hidden, then the online softmax:
  // the rows' max over the tile (four threads hold a row), the correction
  // of what came before into corr, p (f32) into s, and the sums.
  auto softmax = [&](int key0) {
    const bool edge = key0 + kBN - 1 > w0 || key0 + kBN > L ||
                      (window > 0 && key0 <= w0 + 15 - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = __fmul_rn(s[i], scale);
      if (edge) {
        const int key = key0 + (i / 4) * 8 + 2 * t + (i & 1);
        const int r = row[(i / 2) & 1];
        const bool seen = key <= r && key < L && (window == 0 || key > r - window);
        x = seen ? x : kNegInf;
      }
      s[i] = x;
    }
    float mx[2] = {s[0], s[2]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) & 1] = row_max(mx[(i / 2) & 1], s[i]);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = row_max(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = row_max(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float mn = row_max(m[e], mx[e]);
      corr[e] = expf(__fsub_rn(m[e], mn));
      m[e] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pi = expf(__fsub_rn(s[i], m[(i / 2) & 1]));
      s[i] = pi;
      rs[(i / 2) & 1] = __fadd_rn(rs[(i / 2) & 1], pi);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = __fadd_rn(__fmul_rn(l[e], corr[e]), rs[e]);
  };
  // p to bf16 as p@V's A fragments: k-step ks of 16 keys takes the key
  // blocks 2ks and 2ks + 1.
  auto to_p = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };

  // Every warpgroup takes every tile of the CTA: a branch around the
  // products would serialise them, and a tile that none of a warpgroup's
  // rows sees gives each row p = 0 (or, before a window's first key, a
  // share that the first seen key multiplies by 0, as in the plain version).
  // Iteration j multiplies K tile j and V tile j - 1, whose copies (group
  // j - j_lo) the barrier before it saw land, while group j - j_lo + 2
  // lands: the stages it refills were last read by products that every
  // warpgroup waited for before that barrier.
  group_landed(0);                          // q and K tile j_lo
  issue_qk(sK);
  wgmma_wait<0>();
  pin(s);
  softmax(j_lo * kBN);
  to_p();
#pragma unroll 1
  for (int j = j_lo + 1; j <= j_hi; ++j) {
    __syncthreads();                        // every product of iteration j - 1 is done
    // V tile j + kStages - 2 and K tile j + kStages - 1, into the stages of
    // tiles j - 2 and j - 1.
    load_group(j - j_lo + kStages - 1);
    group_landed(j - j_lo);                 // K tile j and V tile j - 1
    issue_qk(sK + stage(j) * kTileK);
    issue_pv(sV + stage(j - 1) * kTileV);   // tile j - 1's p@V runs under tile j's softmax
    wgmma_wait<1>();
    pin(s);
    softmax(j * kBN);
    wgmma_wait<0>();
    pin(o);
    pin(p);
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = __fmul_rn(o[i], corr[(i / 2) & 1]);
    }
    to_p();
  }
  group_landed(j_hi - j_lo + 1);            // V tile j_hi
  issue_pv(sV + stage(j_hi) * kTileV);
  wgmma_wait<0>();
  pin(o);

  // The row sums over the row's four threads, then acc / max(sum, 1e-30),
  // cast once, staged in the warp's own 16 rows of the q tile (no other
  // warp reads them; every product that read q is done) and written as
  // 16-byte pieces.
  float den[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] = __fadd_rn(l[e], __shfl_xor_sync(0xffffffffu, l[e], 1));
    l[e] = __fadd_rn(l[e], __shfl_xor_sync(0xffffffffu, l[e], 2));
    den[e] = (l[e] != l[e] || l[e] > 1e-30f) ? l[e] : 1e-30f;   // clamp_min keeps NaN
  }
  unsigned char* so = reinterpret_cast<unsigned char*>(sQ);
  const int wr = warp * 16;                 // the warp's first row in the q tile
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    *reinterpret_cast<uint32_t*>(so + swz(kBM, wr + g, 8 * n + 2 * t)) =
        pack_bf16(__fdiv_rn(o[4 * n], den[0]), __fdiv_rn(o[4 * n + 1], den[0]));
    *reinterpret_cast<uint32_t*>(so + swz(kBM, wr + g + 8, 8 * n + 2 * t)) =
        pack_bf16(__fdiv_rn(o[4 * n + 2], den[1]), __fdiv_rn(o[4 * n + 3], den[1]));
  }
  __syncwarp();
  bf16* og = out + o_at;
#pragma unroll
  for (int i = lane; i < 16 * DV / 8; i += 32) {
    const int r = (i / 8) % 16, x = (i / 128) * 64 + (i % 8) * 8;
    if (w0 + r < L) {
      *reinterpret_cast<uint4*>(og + static_cast<size_t>(w0 + r) * os + x) =
          *reinterpret_cast<const uint4*>(so + swz(kBM, wr + r, x));
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query, so the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The TMA map of a contiguous (B, L, heads, D) bf16 tensor: boxes of 64
// columns of one head's `rows` rows, 128-byte swizzled (the layout `swz`
// reads), rows past L filled with zeros.
bool make_map(CUtensorMap* map, const void* t, int B, int L, int heads, int D, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(L) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H, int K,
           int window, cudaStream_t stream) {
  using C = Cta<DK, DV>;
  // Set once per process, before the first launch (a captured call is
  // always preceded by an eager one of the same shape).
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_attention_fwd<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, L, H, DK, C::kBM) || !make_map(&tk, k, B, L, K, DK, kBN) ||
      !make_map(&tv, v, B, L, K, DV, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(DK)));
  const dim3 grid(B * H, (L + C::kBM - 1) / C::kBM);
  prefill_attention_fwd<DK, DV><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), L, H, K, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point: q (B, L, H, DK), k (B, L, K, DK), v (B, L, K, DV)
// and out (B, L, H, DV), contiguous bf16 on the device, 16-byte aligned;
// (DK, DV) one of (64, 64), (128, 128), (256, 256), (192, 128); window 0 (no
// window) or the sliding window.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int prefill_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                      int B, int L, int H, int K, int DK, int DV, int window,
                                      void* stream) {
  if (B < 1 || L < 1 || K < 1 || H < K || H % K || window < 0 ||
      static_cast<long long>(B) * H > 0x7fffffffLL || (L + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (DK == 192 && DV == 128) return launch<192, 128>(q, k, v, out, B, L, H, K, window, s);
  if (DK != DV) return static_cast<int>(cudaErrorInvalidValue);
  switch (DK) {
    case 64: return launch<64, 64>(q, k, v, out, B, L, H, K, window, s);
    case 128: return launch<128, 128>(q, k, v, out, B, L, H, K, window, s);
    case 256: return launch<256, 256>(q, k, v, out, B, L, H, K, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

