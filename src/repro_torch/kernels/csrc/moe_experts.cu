// The MoE's expert FFN for few rows a call on Hopper (sm_90a): a grouped
// gated FFN that reads only the weights of the experts some kept copy was
// routed to.
//
// Replaces no Pallas kernel: the JAX package runs the expert FFN as plain
// `jnp.einsum`s over every expert's capacity slots (`moe_block` in
// src/repro/models/layers.py, `gecd,edf->gecf` and `gecf,efd->gecd`), and
// the port ran the same einsums, which cuBLAS runs as batched GEMMs over all
// E experts.  At a decode call's capacity (C = 8 rows an expert on
// qwen3-moe-30b-a3b, 10 on granite-4.0-h-small) an expert block is all zeros
// unless a kept copy chose it, and the GEMMs read every expert's weights all
// the same: qwen3-moe's 8 tokens x top-8 reach ~52 of 128 experts, granite's
// 4 x top-10 ~32 of 72.  This kernel computes the same function; its plain
// PyTorch version is `expert_ffn_plain` in
// src/repro_torch/kernels/moe_experts.py.
//
// The function.  buf (G, E, C, D) bf16, the dispatch buffer; w_gate, w_in
// (E, D, F) and w_out (E, F, D) bf16; dst, keep (G, N) from the router.
// h = bf16(silu(bf16(buf_e @ Wg_e)) * bf16(buf_e @ Wi_e)), with silu's value
// rounded to bf16 before the product, and y_e = bf16(h @ Wo_e): the
// rounding points of the plain chain (each einsum's output, the SiLU, the
// product).  Accumulators are f32, so only the order of the sums differs
// from cuBLAS.  An expert that no kept copy of its group chose gives rows of
// exact zeros, which is what the dense chain gives for its all-zero block.
//
// What bounds it on an H100.  At C <= 16 rows an expert does about one
// operation per weight byte, against the card's ~295 at which the tensor
// cores become the limit: the bound is the live experts' weights over
// 3.35 TB/s (qwen3-moe: ~52 x 9.4 MB a layer, ~0.15 ms; granite: ~32 x
// 18.9 MB, ~0.18 ms), plus buf and y_e.  So the design streams bytes:
//   * Two passes, each one CTA per (group, expert, 64 weight columns) over
//     the whole depth: the gate/in pass (w_gate and w_in's same columns,
//     the SwiGLU in its epilogue, h (G, E, C, F) bf16 out) and the out pass
//     (w_out's columns, y_e out).  qwen3-moe's ~52 live experts give ~620
//     and ~1,660 streaming CTAs, granite's ~32 give ~380 and ~2,050: enough
//     on 132 SMs, three CTAs each, to keep ~10 MB of copies in flight.
//   * Every CTA reads its group's dst and keep first and finds whether its
//     expert holds a kept copy; a dead CTA issues no load (the out pass
//     writes its rows' zeros), so a captured graph skips other experts on
//     every replay with the same grid.
//   * Weights reach shared memory by TMA in 64 x 64 boxes (128-byte
//     swizzle), with the matching 64-deep slice of the C activation rows,
//     through a ring of stages that one producer warp keeps full (mbarriers
//     for full and empty stages); four consumer warps multiply as they land.
//   * mma.sync m16n8k16 with the weights on the M side (each warp 16
//     columns, A fragments by ldmatrix.trans from the swizzled tile, no bank
//     conflicts) and the <= 16 token rows on the N side (one or two n8
//     tiles): no zero padding of a 64-row tile.  Rows past C in a box are
//     the next expert's or zeros past the tensor; they only feed output
//     columns that are never stored.
//   * The out pass launches as a programmatic dependent of the gate/in
//     pass (griddepcontrol): its CTAs stream their first stages of w_out
//     while the gate/in pass drains, and wait only before they load h.
// No host sync, no allocation, the caller's stream: both passes capture in
// a CUDA graph.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;                        // weight columns per CTA
constexpr int kBK = 64;                        // depth per stage
constexpr int kWarps = 4;                      // consumer warps, 16 columns each
constexpr int kThreads = (kWarps + 1) * 32;    // and one producer warp
constexpr int kMaxRows = 16;                   // C: two n8 tiles
constexpr int kWeightTile = kBK * 128;         // bytes of a 64 x 64 weight box

// A stage: kMats weight tiles, then the activations' kNT x 8 rows of 64.
template <int kMats, int kNT, int kStages> struct Ring {
  static constexpr int kStage = kMats * kWeightTile + kNT * 8 * 128;
  // The stages, a full and an empty barrier each, and room to align the
  // ring to the 1024 bytes the swizzle repeats over.
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

// One TMA box of a 3-d map (`make_map`) at (x, y, z), counted on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y, int z,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// Swizzled byte offset of the 16-byte chunk `chunk` of row `row` in a box of
// 128-byte rows (TMA's 128-byte swizzle over a 1024-byte-aligned box).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16) * b (16 x 8), bf16 operands.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// PyTorch's bf16 chain: silu(g) = g / (1 + exp(-g)) in f32, rounded; the
// product of the two bf16 values in f32, rounded by the caller.
__device__ __forceinline__ float swiglu(float gate, float in) {
  const float g = round_bf16(gate);
  const float s = round_bf16(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))));
  return __fmul_rn(s, round_bf16(in));
}

// One pass.  Grid (cols / kBM, E, G), kThreads threads, Ring::kSmem bytes.
// Weights tw0 (and tw1 where kMats = 2) are maps over (E, depth, cols);
// tx over the activations (G, E * rows, depth).  kUp: the gate/in pass, out
// = h (G, E, rows, F = cols); else the out pass, out = y_e (G, E, rows,
// D = cols), launched as a programmatic dependent of the gate/in pass.
template <int kMats, int kNT, int kStages, bool kUp>
__global__ void __launch_bounds__(kThreads)
    expert_pass(const __grid_constant__ CUtensorMap tw0, const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap tx, const int64_t* __restrict__ dst,
                const bool* __restrict__ keep, bf16* __restrict__ out, int n, int rows, int depth,
                int cols) {
  using R = Ring<kMats, kNT, kStages>;
  extern __shared__ unsigned char smem_raw[];
  if constexpr (kUp) pdl_trigger();
  const int m0 = blockIdx.x * kBM, e = blockIdx.y, g = blockIdx.z;
  bf16* o = out + (static_cast<int64_t>(g) * gridDim.y + e) * rows * cols + m0;

  // Is the expert live: does a kept copy of this group hold one of its
  // slots (dst = expert * rows + rank)?
  bool mine = false;
  const int64_t* gd = dst + static_cast<int64_t>(g) * n;
  const bool* gk = keep + static_cast<int64_t>(g) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) mine |= gk[i] && gd[i] / rows == e;
  if (!__syncthreads_or(mine)) {
    if constexpr (!kUp) {
      for (int i = threadIdx.x; i < rows * (kBM / 8); i += kThreads)
        *reinterpret_cast<uint4*>(o + static_cast<int64_t>(i / (kBM / 8)) * cols +
                                  (i % (kBM / 8)) * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * R::kStage);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = depth / kBK;

  if (warp == kWarps) {
    // The producer: stage kt % kStages holds depth slice kt.  The out pass
    // loads its first stages' weights before it waits for h.
    if (lane != 0) return;
    auto load_w = [&](int kt) {
      unsigned char* st = ring + (kt % kStages) * R::kStage;
      tma_box(st, &tw0, m0, kt * kBK, e, full + kt % kStages);
      if constexpr (kMats == 2) tma_box(st + kWeightTile, &tw1, m0, kt * kBK, e, full + kt % kStages);
    };
    auto load_x = [&](int kt) {
      tma_box(ring + (kt % kStages) * R::kStage + kMats * kWeightTile, &tx, kt * kBK, e * rows, g,
              full + kt % kStages);
    };
    const int pre = nk < kStages ? nk : kStages;
    for (int kt = 0; kt < pre; ++kt) {
      mbar_expect(full + kt, R::kStage);
      load_w(kt);
    }
    if constexpr (!kUp) pdl_wait();
    for (int kt = 0; kt < pre; ++kt) load_x(kt);
#pragma unroll 1
    for (int kt = pre; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(empty + s, ((kt / kStages) - 1) & 1);
      mbar_expect(full + s, R::kStage);
      load_w(kt);
      load_x(kt);
    }
    return;
  }

  // The consumers: warp w multiplies weight columns m0 + 16w .. + 15.
  float acc[kMats][kNT][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][t][i] = 0.f;
  // ldmatrix rows: A (weights, transposed) lanes 8j..8j+7 give matrix j's
  // rows, k = (lane & 7) + 8 (lane >> 4), columns 8 ((lane >> 3) & 1) on;
  // B (activations) lanes 0..15 give rows n = lane & 7, depth chunk
  // (lane >> 3) & 1.
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_chunk = warp * 2 + ((lane >> 3) & 1);
  const int b_row = lane & 7, b_chunk = (lane >> 3) & 1;
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + s, (kt / kStages) & 1);
    const uint32_t st = smem_u32(ring + s * R::kStage);
    const uint32_t sx = st + kMats * kWeightTile;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int t = 0; t < kNT; ++t) ldmatrix_x2(b[t], sx + swz(t * 8 + b_row, 2 * ks + b_chunk));
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, st + m * kWeightTile + swz(ks * 16 + a_row, a_chunk));
#pragma unroll
        for (int t = 0; t < kNT; ++t) mma(acc[m][t], a, b[t]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

  // acc[.][t][2h + j]: weight column m0 + 16 warp + lane / 4 + 8h, token
  // row 8t + 2 (lane % 4) + j.  Rows past C are not stored.
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t * 8 + 2 * (lane % 4) + (i & 1);
      const int col = warp * 16 + lane / 4 + 8 * (i >> 1);
      if (row < rows) {
        float v;
        if constexpr (kUp) v = swiglu(acc[0][t][i], acc[1][t][i]);
        else v = acc[0][t][i];
        o[static_cast<int64_t>(row) * cols + col] = __float2bfloat16_rn(v);
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

// The TMA map of a bf16 tensor (z, y, x) with x contiguous and the given
// byte strides of y and z: boxes of 64 x values by `rows` y values,
// 128-byte swizzled (the layout `swz` reads), zeros past the tensor.
bool make_map(CUtensorMap* map, const void* t, int64_t x, int64_t y, int64_t z, int64_t y_stride,
              int64_t z_stride, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(x), static_cast<cuuint64_t>(y),
                              static_cast<cuuint64_t>(z)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(y_stride),
                                 static_cast<cuuint64_t>(z_stride)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(t), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMats, int kNT, int kStages, bool kUp>
cudaError_t launch_pass(const CUtensorMap& w0, const CUtensorMap& w1, const CUtensorMap& x,
                        const int64_t* dst, const bool* keep, bf16* out, int n, int rows,
                        int depth, int cols, int experts, int groups, cudaStream_t stream) {
  constexpr int kSmem = Ring<kMats, kNT, kStages>::kSmem;
  // Set once per process, before the first launch (a captured call is
  // always preceded by an eager one of the same shape).
  static const cudaError_t attr = cudaFuncSetAttribute(
      expert_pass<kMats, kNT, kStages, kUp>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cols / kBM, experts, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = kUp ? 0 : 1;
  return cudaLaunchKernelEx(&cfg, expert_pass<kMats, kNT, kStages, kUp>, w0, w1, x, dst, keep,
                            out, n, rows, depth, cols);
}

template <int kNT>
cudaError_t launch(const CUtensorMap (&maps)[5], const int64_t* dst, const bool* keep, bf16* h,
                   bf16* y, int n, int rows, int d, int f, int experts, int groups,
                   cudaStream_t s) {
  const cudaError_t err = launch_pass<2, kNT, 4, true>(maps[0], maps[1], maps[2], dst, keep, h, n,
                                                       rows, d, f, experts, groups, s);
  if (err != cudaSuccess) return err;
  return launch_pass<1, kNT, 6, false>(maps[3], maps[3], maps[4], dst, keep, y, n, rows, f, d,
                                       experts, groups, s);
}

}  // namespace

// The most rows an expert (C) the kernels take.
extern "C" int moe_experts_max_rows() { return kMaxRows; }

// y (G, E, C, D) from buf (G, E, C, D), whose groups lie `buf_group_stride`
// elements apart and whose rows are contiguous within a group; w_gate, w_in
// (E, D, F) and w_out (E, F, D) contiguous; dst (G, N) int64 and keep
// (G, N) bool contiguous; h (G, E, C, F) the hidden values' scratch.  All
// bf16 but dst and keep, 16-byte aligned; D and F multiples of 64, C in
// 1..16.  Launches both passes on `stream` and returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for what it does not take).
extern "C" int moe_experts_ffn(const void* buf, int64_t buf_group_stride, const void* w_gate,
                               const void* w_in, const void* w_out, const void* dst,
                               const void* keep, void* h, void* y, int groups, int experts,
                               int rows, int d, int f, int n, void* stream) {
  if (groups < 1 || groups > 65535 || experts < 1 || experts > 65535 || rows < 1 ||
      rows > kMaxRows || d < kBM || d % kBM || f < kBM || f % kBM || n < 1 ||
      buf_group_stride < static_cast<int64_t>(experts) * rows * d || buf_group_stride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int box = rows <= 8 ? 8 : 16;
  const int64_t er = static_cast<int64_t>(experts) * rows;
  CUtensorMap maps[5];    // w_gate, w_in, buf; w_out, h
  if (!make_map(&maps[0], w_gate, f, d, experts, 2LL * f, 2LL * d * f, kBK) ||
      !make_map(&maps[1], w_in, f, d, experts, 2LL * f, 2LL * d * f, kBK) ||
      !make_map(&maps[2], buf, d, er, groups, 2LL * d, 2 * buf_group_stride, box) ||
      !make_map(&maps[3], w_out, d, f, experts, 2LL * d, 2LL * f * d, kBK) ||
      !make_map(&maps[4], h, f, er, groups, 2LL * f, 2 * er * f, box))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* di = static_cast<const int64_t*>(dst);
  const auto* ki = static_cast<const bool*>(keep);
  auto* hp = static_cast<bf16*>(h);
  auto* yp = static_cast<bf16*>(y);
  const cudaError_t err =
      box == 8 ? launch<1>(maps, di, ki, hp, yp, n, rows, d, f, experts, groups, s)
               : launch<2>(maps, di, ki, hp, yp, n, rows, d, f, experts, groups, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
