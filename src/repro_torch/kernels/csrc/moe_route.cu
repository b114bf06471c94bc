// The MoE router's expert slots for Hopper (sm_90a): each routed copy's
// rank among the earlier copies of its group that chose the same expert,
// and from it the copy's row in the dispatch buffer.
//
// Replaces no Pallas kernel: the JAX package ranks the copies with plain
// jnp (`route_group` in src/repro/models/layers.py: an int32 one-hot over
// (copies, experts), `jnp.cumsum` along the copies, a gather).  The port ran
// the same ops, and PyTorch runs a cumsum along an outer axis as
// `tensor_kernel_scan_outer_dim`: one thread per (group, expert) column,
// walking every copy in turn, so E threads on one SM do the whole scan, one
// dependent load and store per copy.  At granite-4.0-h-small's 4096-token
// refill (4 x 4096 tokens x 10 experts = 163,840 copies, E = 72) that took
// ~45 ms a layer.  This kernel computes the same function without the
// one-hot; its plain PyTorch version is `expert_slots_plain` in
// src/repro_torch/kernels/moe_route.py.
//
// The function.  ids (G, N) int64, N = tokens x K in token-major (token, k)
// order.  rank = the number of copies before this one in its group with the
// same id; keep = rank < cap; dst = keep ? id * cap + rank : E * cap (the
// overflow row).  Every output is an integer, so the kernel is bit-exact
// against the plain version.  An id outside [0, E) takes the overflow row
// and counts for no expert (the plain version raises there; the router
// never makes one).
//
// What bounds it on an H100.  Each copy reads 8 bytes and writes 9: 2.8 MB
// at 163,840 copies, 0.8 us at 3.35 TB/s.  So the bound is latency: the
// launches, and the hand-off of counts from one tile of copies to the next,
// which a scan along the copies cannot avoid.
//
// What the design does about it:
//   * Tiles of kTile = 2048 copies, one CTA of 16 warps per (group, tile),
//     each warp a segment of 128 copies, 4 per lane held in registers from
//     one set of independent loads.  163,840 copies are 80 CTAs on 80 SMs.
//   * Inside a warp, `__match_any_sync` finds the lanes with the same id;
//     a lane's rank among them is `__popc(peers & lanemask_lt)`, and the
//     lowest such lane adds `__popc(peers)` to its warp's per-expert row in
//     shared memory.  A CTA counts its warps' segments so, takes the
//     exclusive prefix of the rows over its warps in order (per expert, one
//     thread each), then ranks each segment again from its warp's prefix.
//   * Across tiles, two passes: `moe_route_count` writes each tile's
//     per-expert totals (G, tiles - 1, E) int32 to a scratch the wrapper
//     allocates (the last tile's are never read); `moe_route_rank` starts
//     every tile from the sum of the earlier tiles' totals.  The rank pass
//     launches as a programmatic dependent of the count pass
//     (griddepcontrol): it loads and counts its own tile while the count
//     pass runs, and waits only before it reads the totals.  CUDA graphs
//     capture the pair as a programmatic edge.
//   * When N fits one tile (every decode call: 40 copies on granite, 64 on
//     qwen3-moe), the rank pass alone runs, as one CTA.
// No host sync, no allocation, the caller's stream: the pair captures in a
// CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 4;                      // copies per lane in a tile
constexpr int kSegment = 32 * kPerLane;          // copies per warp
constexpr int kTile = kWarps * kSegment;         // copies per CTA: 2048
constexpr int kMaxExperts = 512;                 // (kWarps + 1) x E ints fit 48 KB

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The ids of this lane's copies in its warp's segment of tile `tile`, all
// loads in flight before any is used; -1 past the end of the row or outside
// [0, E).
__device__ __forceinline__ void load_segment(const int64_t* __restrict__ ids, int64_t n,
                                             int tile, int e, int (&id)[kPerLane]) {
  const int64_t first = static_cast<int64_t>(tile) * kTile + (threadIdx.x >> 5) * kSegment +
                        (threadIdx.x & 31);
  int64_t v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int64_t i = first + 32 * j;
    v[j] = i < n ? ids[i] : -1;
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) id[j] = (v[j] >= 0 && v[j] < e) ? static_cast<int>(v[j]) : -1;
}

// Adds each expert's copies in this lane's warp segment to `row` (the warp's
// E counters in shared memory).  One leader lane per distinct id writes.
__device__ __forceinline__ void count_segment(const int (&id)[kPerLane], int* row) {
  const unsigned lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const unsigned peers = __match_any_sync(0xffffffffu, id[j]);
    if (id[j] >= 0 && lane == static_cast<unsigned>(__ffs(peers) - 1)) row[id[j]] += __popc(peers);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
    moe_route_count(const int64_t* __restrict__ ids, int* __restrict__ totals, int64_t n, int e) {
  extern __shared__ int rows[];                  // kWarps x E
  pdl_trigger();
  const int g = blockIdx.y, tile = blockIdx.x;
  int id[kPerLane];
  load_segment(ids + static_cast<int64_t>(g) * n, n, tile, e, id);
  for (int i = threadIdx.x; i < kWarps * e; i += kThreads) rows[i] = 0;
  __syncthreads();
  count_segment(id, rows + (threadIdx.x >> 5) * e);
  __syncthreads();
  int* out = totals + (static_cast<int64_t>(g) * gridDim.x + tile) * e;
  for (int x = threadIdx.x; x < e; x += kThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += rows[w * e + x];
    out[x] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
    moe_route_rank(const int64_t* __restrict__ ids, const int* __restrict__ totals,
                   int64_t* __restrict__ dst, bool* __restrict__ keep, int64_t n, int e,
                   int64_t cap, int tiles) {
  extern __shared__ int smem[];                  // kWarps x E rows, then E tile bases
  int* rows = smem;
  int* base = smem + kWarps * e;
  const int g = blockIdx.y, tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const unsigned lane = threadIdx.x & 31;
  int id[kPerLane];
  load_segment(ids + static_cast<int64_t>(g) * n, n, tile, e, id);
  for (int i = threadIdx.x; i < (kWarps + 1) * e; i += kThreads) smem[i] = 0;
  __syncthreads();
  count_segment(id, rows + warp * e);
  if (tile > 0) {
    // The earlier tiles' totals: written by the count pass this one may
    // have started beside.
    pdl_wait();
    const int* t = totals + static_cast<int64_t>(g) * (tiles - 1) * e;
    for (int i = threadIdx.x; i < tile * e; i += kThreads) atomicAdd(&base[i % e], t[i]);
  }
  __syncthreads();
  // Each warp's counters become the rank of its segment's first copy of
  // each expert: the tile's base plus the earlier warps' counts.
  for (int x = threadIdx.x; x < e; x += kThreads) {
    int run = base[x];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = rows[w * e + x];
      rows[w * e + x] = run;
      run += c;
    }
  }
  __syncthreads();
  int* row = rows + warp * e;
  const int64_t first = static_cast<int64_t>(tile) * kTile + warp * kSegment + lane;
  const int64_t overflow = static_cast<int64_t>(e) * cap;
  int64_t* gdst = dst + static_cast<int64_t>(g) * n;
  bool* gkeep = keep + static_cast<int64_t>(g) * n;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const unsigned peers = __match_any_sync(0xffffffffu, id[j]);
    const int64_t i = first + 32 * j;
    if (i < n) {
      bool k = false;
      int64_t d = overflow;
      if (id[j] >= 0) {
        const int rank = row[id[j]] + __popc(peers & ((1u << lane) - 1u));
        k = rank < cap;
        if (k) d = id[j] * cap + rank;
      }
      gdst[i] = d;
      gkeep[i] = k;
    }
    __syncwarp();
    if (id[j] >= 0 && lane == static_cast<unsigned>(__ffs(peers) - 1)) row[id[j]] += __popc(peers);
    __syncwarp();
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, bool pdl,
                   Args... args) {
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
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// Copies per tile: the wrapper sizes the totals' scratch from it.
extern "C" int moe_route_tile() { return kTile; }

// The largest E the kernels take.
extern "C" int moe_route_max_experts() { return kMaxExperts; }

// dst (G, N) int64 and keep (G, N) bool from ids (G, N) int64, all
// contiguous.  `totals` holds G x (ceil(N / kTile) - 1) x E ints (unused,
// and may be null, when N fits one tile).  Launches on `stream` and returns
// a cudaError_t (0 on success).
extern "C" int moe_route_slots(const void* ids, void* dst, void* keep, void* totals, int groups,
                               int64_t n, int e, int64_t cap, void* stream) {
  if (groups < 1 || groups > 65535 || n < 1 || e < 1 || e > kMaxExperts || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7fffffff / e) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* in = static_cast<const int64_t*>(ids);
  int* t = static_cast<int*>(totals);
  cudaError_t err = cudaSuccess;
  if (tiles > 1) {
    err = launch(moe_route_count, dim3(static_cast<unsigned>(tiles - 1), groups),
                 kWarps * e * static_cast<int>(sizeof(int)), s, false, in, t, n, e);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch(moe_route_rank, dim3(static_cast<unsigned>(tiles), groups),
               (kWarps + 1) * e * static_cast<int>(sizeof(int)), s, tiles > 1, in,
               static_cast<const int*>(t), static_cast<int64_t*>(dst), static_cast<bool*>(keep), n,
               e, cap, static_cast<int>(tiles));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
