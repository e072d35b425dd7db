// K1: one fused InteractionNetwork edge step, forward, for Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_edge.py::_fused_edge_kernel (driven by
// FusedEdgeStep._forward). Over receiver-sorted edges, per edge row:
//
//   x0  = e @ We + Gs[snd] + Gr[rcv] + b0     (encoder mode: x0 = e + Gs + Gr)
//         (embed mode, GenCast's grid2mesh: e is the embedding en =
//          bf16(LN0(bf16(swish(bf16(f @ ew0 + eb0))) @ ew1 + eb1)) of the
//          raw [E, F] edge features f, computed in the tile; We, b0 and the
//          LN affine carry the folded norm conditioning; aggregation only)
//   h   = bf16(swish(bf16(x0)))
//   y   = LN(h @ W1 + b1) * scale + offset     (LN statistics in f32)
//   e'  = bf16(e + y)                          (processor mode only)
//   agg[n] = sum over edges into n of bf16(y), in f32
//
// What bounds it on an H100: streaming the weights. Per 64-row tile the
// products read 512 KB of W1 (and of We, and in embed mode of ew1) for
// 64 x 512 x 512 x 2 = 33.6 MFLOP a matrix: 64 FLOP per weight byte against
// the card's 989 TFLOP/s over the ~2.8 TB/s L2 serves here (PERF.md), so
// each weight byte from L2 must serve far more than 64 rows before the
// tensor cores are the limit. Design (edge.cuh):
//   * a cluster of kEdgeCluster blocks of 64 consecutive edge rows shares
//     every 64 x 64 weight box by TMA multicast, so each weight byte from L2
//     serves 64 kEdgeCluster rows; one producer thread per block keeps a
//     ring of 18 boxes of 8 KB full; two consumer warpgroups split each
//     product by columns and issue wgmma m64n64k16 per box, the f32 product
//     in registers (128 a thread);
//   * the edge rows e arrive by TMA tile load, in the operand tile A or,
//     in the modes that write e', in a second tile E (the ring then holds
//     10 boxes); the first epilogue writes h into A, the LayerNorm epilogue
//     writes bf16(y) over h and e' = bf16(e + y) over e in E, which leaves
//     by TMA store: e and e' are read and written a whole tile at a time,
//     not element by element in the accumulator's layout;
//   * the sender and receiver projections are gathered by index in the
//     first epilogue, in the accumulator's layout; the TPU version reads a
//     pre-gathered [E, C] array;
//   * aggregation: the rows are receiver-sorted, so the tile walks its
//     receiver runs over bf16(y) in A, one f32 sum per run and column: a
//     plain store for runs inside the tile, a per-tile boundary partial for
//     the (at most two) runs that may continue into a neighbouring tile,
//     added in tile order by a second pass (edge.cuh edge_bounds). The
//     output starts zeroed; every sum has a fixed order, so a rerun is
//     bit-equal;
//   * embed mode adds a third product per row (ew1) and reads 8 bytes of
//     raw features per row (F = 4) instead of a 1 KB edge latent: the
//     [E, C] embedded edges never exist in device memory.
//
// Each mode is its own kernel: this file builds processor mode (We, e')
// and We without e', fused_edge_encoder.cu the two modes without We
// (GC_K1_UNIT 1), fused_edge_embed.cu embed mode (GC_K1_UNIT 2), so that
// nvcc builds them in parallel.

#include "edge.cuh"

namespace gc {

template <bool kHasWe, bool kWriteE, bool kEmbed>
__global__ void __launch_bounds__(kDecThreads, 1) fused_edge_kernel(
    const __grid_constant__ EdgeFwdMaps maps, const EdgeFwdArgs a) {
  constexpr int W = kDecWidth;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const EdgeSmem sh(smem_raw, edge_layout(0, kWriteE));
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const uint32_t rank = cluster_ctarank();
  const int tiles = (a.num_edges + kEdgeRows - 1) / kEdgeRows;
  const int groups = (tiles + kEdgeCluster - 1) / kEdgeCluster;
  const int cluster = blockIdx.x / kEdgeCluster;
  const int clusters = gridDim.x / kEdgeCluster;
  if (threadIdx.x == 0) sh.init();
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
    }
  } else {
    setmaxnreg_inc<kDecConsumerRegs>();
    edge_fwd_consumer<kHasWe, kWriteE, kEmbed, false>(maps, a, sh, rank,
                                                      groups, cluster,
                                                      clusters);
  }
  if (kWriteE && threadIdx.x == 0) tma_store_wait_all();
  __syncwarp();
  cluster_sync();  // no block exits while a partner may still arrive
}

template <bool kHasWe, bool kWriteE, bool kEmbed>
int fused_edge(const void* we, const void* w1, const void* ew1,
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
  err = edge_launch(fused_edge_kernel<kHasWe, kWriteE, kEmbed>,
                    edge_layout(0, kWriteE).total, tiles, 1 << 30, stream,
                    maps, a);
  if (err != cudaSuccess) return err;
  return edge_bounds(a.receivers, a.num_edges, C, a.bnd, a.agg, stream);
}

}  // namespace gc

#ifndef GC_K1_UNIT
#define GC_K1_UNIT 0
#endif

#if GC_K1_UNIT == 1
// The two modes without We (encoder mode: e is the hoisted first-layer
// part), with and without e'; gc_fused_edge dispatches here.
extern "C" int gc_fused_edge_nowe(const void* e, const void* sproj,
                                  const int* senders, const void* rproj,
                                  const int* receivers, const void* w1,
                                  const float* b1, const float* scale,
                                  const float* offset, void* eout,
                                  float* agg, float* bnd, int num_edges,
                                  int C, int write_e, void* stream) {
  const gc::EdgeFwdArgs a =
      gc::edge_fwd_args(e, sproj, senders, rproj, receivers, nullptr, b1,
                        scale, offset, eout, agg, bnd, num_edges, C);
  auto s = static_cast<cudaStream_t>(stream);
  return write_e ? gc::fused_edge<false, true, false>(nullptr, w1, nullptr,
                                                      a, s)
                 : gc::fused_edge<false, false, false>(nullptr, w1, nullptr,
                                                       a, s);
}

#elif GC_K1_UNIT == 2
// Embed mode: features [E, F] raw edge features (bf16), ew0 [F, kDecWidth]
// bf16 zero-padded, ew1 [C, C]; aggregation only.
extern "C" int gc_fused_edge_embed(
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
  return gc::fused_edge<true, false, true>(we, w1, ew1, a,
                                           static_cast<cudaStream_t>(stream));
}

#else
extern "C" int gc_fused_edge_nowe(const void* e, const void* sproj,
                                  const int* senders, const void* rproj,
                                  const int* receivers, const void* w1,
                                  const float* b1, const float* scale,
                                  const float* offset, void* eout,
                                  float* agg, float* bnd, int num_edges,
                                  int C, int write_e, void* stream);

// e [E, C] bf16 (encoder mode: the hoisted first-layer part), sproj/rproj
// bf16 by node, weights [C, C] bf16, vectors f32 zero-padded to kDecWidth,
// eout [E, C] bf16 (with write_e), agg [num_receivers, C] f32 zeroed, bnd
// [ceil(E / 64), 2, C] f32 scratch.
extern "C" int gc_fused_edge(const void* e, const void* sproj,
                             const int* senders, const void* rproj,
                             const int* receivers, const void* we,
                             const float* b0, const void* w1, const float* b1,
                             const float* scale, const float* offset,
                             void* eout, float* agg, float* bnd,
                             int num_edges, int C, int has_we, int write_e,
                             void* stream) {
  if (!has_we) {
    return gc_fused_edge_nowe(e, sproj, senders, rproj, receivers, w1, b1,
                              scale, offset, eout, agg, bnd, num_edges, C,
                              write_e, stream);
  }
  const gc::EdgeFwdArgs a =
      gc::edge_fwd_args(e, sproj, senders, rproj, receivers, b0, b1, scale,
                        offset, eout, agg, bnd, num_edges, C);
  auto s = static_cast<cudaStream_t>(stream);
  return write_e ? gc::fused_edge<true, true, false>(we, w1, nullptr, a, s)
                 : gc::fused_edge<true, false, false>(we, w1, nullptr, a, s);
}

// The edge kernels' shared-memory layout (edge.cuh edge_layout) with `sums`
// column-sum floats and an E tile if e_tile: out[10] = a, e, ring,
// exchange, idx, sums, colred, bars, stages, total.
extern "C" void gc_edge_layout(int sums, int e_tile, int* out) {
  const gc::EdgeLayout L = gc::edge_layout(sums, e_tile != 0);
  const int v[10] = {L.a,    L.e,      L.ring, L.exchange, L.idx,
                     L.sums, L.colred, L.bars, L.stages,   L.total};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

extern "C" const char* gc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // GC_K1_UNIT
