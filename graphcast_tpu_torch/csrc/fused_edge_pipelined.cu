// K1p: the pipelined fused InteractionNetwork edge step, forward, for
// Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_edge.py::_fused_edge_pipelined_kernel
// (FusedEdgeStep(pipelined=True), or GC_PIPELINED_EDGE=1). It computes K1's
// function (fused_edge.cu) in K1's modes (processor, encoder, embed, and the
// two other We / e' combinations) at K1's widths (every multiple of 128 up
// to 512), and its e' and receiver sums are bit-equal to K1's, as the JAX
// pair is (pallas_edge.py:211-213): it runs K1's consumer code (edge.cuh
// edge_fwd_consumer, kPipe) with K1's box order, rounding points and
// fixed-order run sums.
//
// The TPU kernel exists to run one chunk's vector tail (swish, the second
// layer's LayerNorm, the residual, the aggregation) beside the next chunk's
// matrix head. What K1 serialises on this card (PERF.md §5): a tile's two
// consumer warpgroups run a product, then its epilogue, then the run sums,
// then the next tile's load and product; and the gathered node rows are
// read in the accumulator's layout, 4 bytes a thread (on an H100, without
// its gathers K1's encoder keeps 11.1 of its 18.1 ms). Design, on K1's
// cluster, ring and wgmma, two ways by mode:
//   * with We or e' (processor, embed, and the two other combinations):
//     epilogue warps. The producer warpgroup's three idle warps take the
//     receiver-run sums (edge.cuh edge_run_sums over bf16(y) in A, two
//     columns a thread) off the consumers. The consumers hand A and the
//     tile's receivers over at a named barrier and go on to the next
//     tile's edge rows (TMA) and first product (e @ We, or the embed's
//     hh @ Ew1, LN0 and en @ We), which read the tile E, not A; the
//     epilogue warps hand A back at a second barrier, waited for just
//     before the next tile's first write to A. The receivers alternate
//     between two buffers. Shared memory: A, E and a ring of 10 boxes,
//     K1's plan in the modes that write e';
//   * without (encoder mode, where the sender rows come from the 1 GB grid
//     table): the next tile's gathered sender rows staged ahead. While the
//     consumers run tile g's products and epilogues, one epilogue warp
//     copies tile g + 1's sproj[snd] rows into the tile S by per-row bulk
//     copies (cp.async.bulk, 1 KB rows, 16-byte aligned, one mbarrier for
//     the tile), once the consumers have read tile g's; the first epilogue
//     reads them from S (rows 16 bytes apart beyond their width, so that a
//     warp's 8 rows fall in different banks) instead of gathering them
//     from device memory. e stays in A as in K1, S takes E's place, the
//     ring keeps 10 boxes (K1's encoder mode: 18); the consumers keep the
//     run sums (the next tile's first step, e's load into A, leaves
//     nothing to overlap them with). The receiver rows repeat along the
//     sorted receivers and stay direct loads;
//   * registers: a consumer warpgroup holds 128 f32 accumulators a thread
//     (64 x 256 of a tile), so no warpgroup can hold a second tile's
//     products while it runs an epilogue; only the accumulator-free parts
//     of the epilogue (the run sums, the gathers) move to other warps. A
//     ping-pong of two warpgroups each owning a whole tile (its 512 columns
//     in two passes, the first parked in an L2 scratch) was built and
//     measured first: bit-equal, but 7.2 ms against K1's 4.0 on an H100 in
//     processor mode (PERF.md §6), its epilogues on 128 threads a tile the
//     limit. Prefetching the next tile's gathered rows into L2
//     (cp.async.bulk.prefetch) made K1p slower in both modes measured
//     (encoder 18.7 against 17.6 ms without it): the gathers cost
//     transactions, not latency.
// What bounds it on an H100: as K1, the weight stream from L2 and the
// epilogues; the two products per row (three in embed mode) at 989
// TFLOP/s are the operations bound.
//
// Each mode is its own kernel: this file builds the modes with We
// (processor, and We without e'), fused_edge_pipelined_encoder.cu the two
// without We (GC_K1P_UNIT 1), fused_edge_pipelined_embed.cu embed mode
// (GC_K1P_UNIT 2), so that nvcc builds them in parallel.

#include "edge.cuh"

namespace gc {

// K1p's shared-memory layout: K1's (edge.cuh edge_layout) with a second
// tile, E or (`staged`) the staged sender rows S (64 rows of
// kEdgeStageStride bytes), two receiver buffers and S's mbarrier.
// ops/fused_edge.py pipelined_smem_layout mirrors it.
__host__ __device__ constexpr EdgeLayout pipe_layout(bool staged) {
  EdgeLayout L{};
  L.a = 0;
  L.e = (kDecWidth / 64) * kDecBox;
  L.ring = L.e + (staged ? kEdgeRows * kEdgeStageStride : L.e);
  const int bars = (2 * kEdgeMaxStages + 1) * 8;
  const int tail = kDecExchange + 2 * kEdgeIdx + 16 + bars;
  const int st = (kDecSmemLimit - kDecAlign - L.ring - tail) / kDecBox;
  L.stages = (st < kEdgeMaxStages ? st : kEdgeMaxStages) & ~1;  // even
  L.exchange = L.ring + L.stages * kDecBox;
  L.idx = L.exchange + kDecExchange;
  L.sums = L.idx + 2 * kEdgeIdx;  // S's mbarrier
  L.colred = L.bars = L.sums + 16;
  L.total = L.bars + bars + kDecAlign;
  return L;
}

// The epilogue warps (kEdgeWalkers threads, w their index) in the modes
// with We or e': per tile of the walk, once the consumers have written
// bf16(y), the receiver-run sums over it, then A back to the consumers.
__device__ __forceinline__ void pipe_walker(const EdgeFwdArgs& a,
                                            const EdgeSmem& sh, int w,
                                            uint32_t rank, int groups,
                                            int cluster, int clusters) {
  const int C = a.C;
  int it = 0;
  for (int grp = cluster; grp < groups; grp += clusters, ++it) {
    const int row0 = (grp * kEdgeCluster + (int)rank) * kEdgeRows;
    const int rows = max(0, min(kEdgeRows, a.num_edges - row0));
    float* const bnd = a.bnd + (size_t)(row0 / kEdgeRows) * 2 * C;
    const int* const idx = sh.idx + (it & 1) * kEdgeRows;
    named_sync(kEdgeBarReady, kEdgePipeSync);
    for (int c = 2 * w; c < C; c += 2 * kEdgeWalkers) {
      edge_run_sums(sh.a, idx, rows, C, a.agg, bnd, c);
    }
    named_arrive(kEdgeBarFree, kEdgePipeSync);
  }
}

// The staging warp in encoder mode: the sender rows of this block's tile
// at `grp` into S, one bulk copy of 2 C bytes a row, completing on S's
// mbarrier (armed with the tile's bytes by lane 0).
__device__ __forceinline__ void pipe_stage(const EdgeFwdArgs& a,
                                           const EdgeSmem& sh, int grp,
                                           uint32_t rank, int lane) {
  const int row0 = (grp * kEdgeCluster + (int)rank) * kEdgeRows;
  const int rows = max(0, min(kEdgeRows, a.num_edges - row0));
  const uint32_t bytes = 2u * a.C;
  uint64_t* const full = reinterpret_cast<uint64_t*>(sh.sums);
  if (lane == 0) mbar_arrive_expect_tx(full, bytes * rows);
  for (int r = lane; r < rows; r += 32) {
    const int snd = __ldg(a.senders + row0 + r);
    bulk_load(sh.e + r * kEdgeStageStride, a.sproj + (size_t)snd * a.C,
              bytes, full);
  }
}

// Per tile of the walk: the next tile's sender rows, once the consumers
// have read this tile's (the first tile's before the walk).
__device__ __forceinline__ void pipe_stager(const EdgeFwdArgs& a,
                                            const EdgeSmem& sh, int lane,
                                            uint32_t rank, int groups,
                                            int cluster, int clusters) {
  pipe_stage(a, sh, cluster, rank, lane);
  for (int grp = cluster; grp < groups; grp += clusters) {
    __syncwarp();
    named_sync(kEdgeBarStaged, kEdgeStageSync);
    if (grp + clusters < groups) pipe_stage(a, sh, grp + clusters, rank, lane);
  }
}

template <bool kHasWe, bool kWriteE, bool kEmbed>
__global__ void __launch_bounds__(kDecThreads, 1) fused_edge_pipelined_kernel(
    const __grid_constant__ EdgeFwdMaps maps, const EdgeFwdArgs a) {
  constexpr int W = kDecWidth;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kWalk = kWriteE || kHasWe;  // else the staged encoder
  const EdgeSmem sh(smem_raw, pipe_layout(!kWalk));
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const uint32_t rank = cluster_ctarank();
  const int tiles = (a.num_edges + kEdgeRows - 1) / kEdgeRows;
  const int groups = (tiles + kEdgeCluster - 1) / kEdgeCluster;
  const int cluster = blockIdx.x / kEdgeCluster;
  const int clusters = gridDim.x / kEdgeCluster;
  if (threadIdx.x == 0) {
    mbar_init(reinterpret_cast<uint64_t*>(sh.sums), 1);  // S (encoder mode)
    sh.init();
  }
  __syncthreads();
  cluster_sync();  // the partners' barriers are initialised

  if (warp >= kDecConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<kDecProducerRegs>();
    if (threadIdx.x == kDecConsumers) {
      EdgeProducer pr(sh, rank);
      for (int grp = cluster; grp < groups; grp += clusters) {
        if (kEmbed) pr.fwd(&maps.ew1, W, W);
        if (kHasWe) pr.fwd(&maps.we, W, W);
        pr.fwd(&maps.w1, W, W);
      }
    } else if (warp > kDecConsumers / 32) {  // the epilogue warps
      const int w = threadIdx.x - kDecConsumers - 32;
      if (kWalk) {
        pipe_walker(a, sh, w, rank, groups, cluster, clusters);
      } else if (w < 32) {
        pipe_stager(a, sh, w, rank, groups, cluster, clusters);
      }
    }
  } else {
    setmaxnreg_inc<kDecConsumerRegs>();
    edge_fwd_consumer<kHasWe, kWriteE, kEmbed, true>(maps, a, sh, rank,
                                                     groups, cluster,
                                                     clusters);
  }
  if (kWriteE && threadIdx.x == 0) tma_store_wait_all();
  __syncwarp();
  cluster_sync();  // no block exits while a partner may still arrive
}

template <bool kHasWe, bool kWriteE, bool kEmbed>
int fused_edge_pipelined(const void* we, const void* w1, const void* ew1,
                         const EdgeFwdArgs& a, cudaStream_t stream) {
  if (a.num_edges <= 0) return 0;
  const int C = a.C;
  if (C % 128 || C < 128 || C > kDecWidth) return cudaErrorInvalidValue;
  // Tensor maps of the true width C: boxes past it arrive as zeros.
  EdgeFwdMaps maps;
  cudaError_t err = bf16_tile_map(&maps.w1, w1, C, C, C, 64);
  maps.e = maps.eout = maps.we = maps.ew1 = maps.w1;
  if (!kEmbed && err == cudaSuccess) {
    err = bf16_tile_map(&maps.e, a.e, a.num_edges, C, C, 64);
  }
  if (kWriteE && err == cudaSuccess) {
    err = bf16_tile_map(&maps.eout, a.eout, a.num_edges, C, C, 64);
  }
  if (kHasWe && err == cudaSuccess) {
    err = bf16_tile_map(&maps.we, we, C, C, C, 64);
  }
  if (kEmbed && err == cudaSuccess) {
    err = bf16_tile_map(&maps.ew1, ew1, C, C, C, 64);
  }
  if (err != cudaSuccess) return err;
  const int tiles = (a.num_edges + kEdgeRows - 1) / kEdgeRows;
  err = edge_launch(fused_edge_pipelined_kernel<kHasWe, kWriteE, kEmbed>,
                    pipe_layout(!(kWriteE || kHasWe)).total, tiles, 1 << 30,
                    stream, maps, a);
  if (err != cudaSuccess) return err;
  return edge_bounds(a.receivers, a.num_edges, C, a.bnd, a.agg, stream);
}

}  // namespace gc

#ifndef GC_K1P_UNIT
#define GC_K1P_UNIT 0
#endif

#if GC_K1P_UNIT == 1
// The two modes without We (encoder mode: e is the hoisted first-layer
// part), with and without e'; gc_fused_edge_pipelined dispatches here.
extern "C" int gc_fused_edge_pipelined_nowe(
    const void* e, const void* sproj, const int* senders, const void* rproj,
    const int* receivers, const void* w1, const float* b1,
    const float* scale, const float* offset, void* eout, float* agg,
    float* bnd, int num_edges, int C, int write_e, void* stream) {
  const gc::EdgeFwdArgs a =
      gc::edge_fwd_args(e, sproj, senders, rproj, receivers, nullptr, b1,
                        scale, offset, eout, agg, bnd, num_edges, C);
  auto s = static_cast<cudaStream_t>(stream);
  return write_e ? gc::fused_edge_pipelined<false, true, false>(
                       nullptr, w1, nullptr, a, s)
                 : gc::fused_edge_pipelined<false, false, false>(
                       nullptr, w1, nullptr, a, s);
}

#elif GC_K1P_UNIT == 2
// Embed mode: features [E, F] raw edge features (bf16), ew0 [F, kDecWidth]
// bf16 zero-padded, ew1 [C, C]; aggregation only.
extern "C" int gc_fused_edge_embed_pipelined(
    const void* features, const void* ew0, const float* eb0, const void* ew1,
    const float* eb1, const void* sproj, const int* senders,
    const void* rproj, const int* receivers, const void* we, const float* b0,
    const void* w1, const float* b1, const float* scale, const float* offset,
    float* agg, float* bnd, int num_edges, int F, int C, void* stream) {
  gc::EdgeFwdArgs a =
      gc::edge_fwd_args(features, sproj, senders, rproj, receivers, b0, b1,
                        scale, offset, nullptr, agg, bnd, num_edges, C);
  a.ew0 = static_cast<const gc::bf16*>(ew0);
  a.eb0 = eb0;
  a.eb1 = eb1;
  a.F = F;
  return gc::fused_edge_pipelined<true, false, true>(
      we, w1, ew1, a, static_cast<cudaStream_t>(stream));
}

#else
extern "C" int gc_fused_edge_pipelined_nowe(
    const void* e, const void* sproj, const int* senders, const void* rproj,
    const int* receivers, const void* w1, const float* b1,
    const float* scale, const float* offset, void* eout, float* agg,
    float* bnd, int num_edges, int C, int write_e, void* stream);

// K1p: K1's arguments (gc_fused_edge).
extern "C" int gc_fused_edge_pipelined(
    const void* e, const void* sproj, const int* senders, const void* rproj,
    const int* receivers, const void* we, const float* b0, const void* w1,
    const float* b1, const float* scale, const float* offset, void* eout,
    float* agg, float* bnd, int num_edges, int C, int has_we, int write_e,
    void* stream) {
  if (!has_we) {
    return gc_fused_edge_pipelined_nowe(e, sproj, senders, rproj, receivers,
                                        w1, b1, scale, offset, eout, agg, bnd,
                                        num_edges, C, write_e, stream);
  }
  const gc::EdgeFwdArgs a =
      gc::edge_fwd_args(e, sproj, senders, rproj, receivers, b0, b1, scale,
                        offset, eout, agg, bnd, num_edges, C);
  auto s = static_cast<cudaStream_t>(stream);
  return write_e ? gc::fused_edge_pipelined<true, true, false>(we, w1,
                                                               nullptr, a, s)
                 : gc::fused_edge_pipelined<true, false, false>(we, w1,
                                                                nullptr, a, s);
}

// K1p's shared-memory layout (pipe_layout) with E or with the staged
// sender rows: out[10] as gc_edge_layout's.
extern "C" void gc_pipelined_layout(int staged, int* out) {
  const gc::EdgeLayout L = gc::pipe_layout(staged != 0);
  const int v[10] = {L.a,    L.e,      L.ring, L.exchange, L.idx,
                     L.sums, L.colred, L.bars, L.stages,   L.total};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}
#endif  // GC_K1P_UNIT
