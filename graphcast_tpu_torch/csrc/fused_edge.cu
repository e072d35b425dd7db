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
//     ring of 19 boxes of 8 KB full; two consumer warpgroups split each
//     product by columns and issue wgmma m64n64k16 per box, the f32 product
//     in registers (128 a thread);
//   * the edge rows e arrive by TMA tile load, in the operand tile A or,
//     in the modes that write e', in a second tile E (the ring then holds
//     11 boxes); the first epilogue writes h into A, the LayerNorm epilogue
//     writes bf16(y) over h and e' = bf16(e + y) over e in E, which leaves
//     by TMA store: e and e' are read and written a whole tile at a time,
//     not element by element in the accumulator's layout;
//   * the sender and receiver projections are gathered by index in the
//     first epilogue, in the accumulator's layout; the TPU version reads a
//     pre-gathered [E, C] array;
//   * aggregation: the rows are receiver-sorted, so the tile walks its
//     receiver runs over bf16(y) in A, one f32 sum per run and column: a
//     plain store for runs inside the tile, atomicAdd for the (at most two)
//     runs that may continue into a neighbouring tile. The output starts
//     zeroed. Only those boundary runs are order-dependent in f32;
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

struct EdgeFwdMaps {
  CUtensorMap e, eout, we, w1, ew1;
};

struct EdgeFwdArgs {
  const bf16* e;          // [E, C]; embed mode: raw features [E, F]
  const bf16* sproj;      // [num_senders, C]
  const int* senders;     // [E]
  const bf16* rproj;      // [num_receivers, C]
  const int* receivers;   // [E], sorted
  const float *b0, *b1, *scale, *offset;  // [kDecWidth], zero-padded
  bf16* eout;             // [E, C] (e' written)
  float* agg;             // [num_receivers, C], zeroed
  const bf16* ew0;        // embed mode: [F, kDecWidth], zero-padded
  const float *eb0, *eb1;  // embed mode: [kDecWidth]
  int num_edges, C, F;
};

// The consumer warpgroups' walk over the cluster's tiles (the head note).
template <bool kHasWe, bool kWriteE, bool kEmbed>
__device__ __forceinline__ void edge_fwd_consumer(const EdgeFwdMaps& maps,
                                                  const EdgeFwdArgs& a,
                                                  const EdgeSmem& sh,
                                                  uint32_t rank, int groups,
                                                  int cluster, int clusters) {
  constexpr int NQ = kDecNQ;
  constexpr int kK = 2 * NQ;  // 64-deep slabs of a product
  const int C = a.C;
  const DecThread th(threadIdx.x);
  EdgeRing ring(sh, th);
  DecRows rsum{sh.exchange};
  // e's tile: E where e' is written, else A.
  unsigned char* const e_tile = kWriteE ? sh.e : sh.a;
  const uint32_t a_addr = smem_u32(sh.a), e_addr = smem_u32(e_tile);
  float acc[NQ][32];
  int it = 0;
  for (int grp = cluster; grp < groups; grp += clusters, ++it) {
    const EdgeTile t(grp, rank, a.num_edges, th, a.senders, a.receivers);
    if (kWriteE && th.ctid == 0) tma_store_wait_read();  // the last e'
    dec_sync();  // the previous tile is done with A, E and idx
    edge_load_idx(sh.idx, t, a.receivers, th.ctid);
    if (kEmbed) {
      // A <- hh; acc = hh @ Ew1; A <- en = bf16(LN0(acc + eb1)).
      edge_embed_hh<NQ>(sh.a, th.ctid, t, C, a.F, a.e, a.ew0, a.eb0, nullptr,
                        nullptr);
      dec_publish();
      dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);
      const float4 st = dec_ln_stats<NQ>(acc, a.eb1, th, rsum, C);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = dec_col<NQ>(th, q, j);
          const float2 b = ldg2(a.eb1 + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool in = c < C;
            st_pair(sh.a, th.r0 + 8 * h, c,
                    in ? dec_ln(st, acc[q][4 * j + 2 * h] + b.x, h) : 0.f,
                    in ? dec_ln(st, acc[q][4 * j + 2 * h + 1] + b.y, h) : 0.f);
          }
        }
      }
      dec_publish();
      dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // en @ We
      dec_sync();  // both warpgroups are done reading A
    } else {
      if (th.ctid == 0) {
        dec_load_tile(e_tile, &maps.e, sh.a_bar, kDecWidth, t.row0);
      }
      mbar_wait(sh.a_bar, it & 1);  // e (zeros past the rows and C)
      if (kHasWe) {
        dec_mma<NQ, 1>(acc, e_addr, kK, false, ring);  // e @ We
        dec_sync();
      }
    }

    // A <- h = bf16(swish(bf16(x0))), x0 = ((e @ We or e) + Gs) + Gr (+ b0).
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      uint32_t sv[8][2], gv[8][2];
      edge_gather<NQ>(sv, gv, th, q, C, t, a.sproj, a.rproj);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = dec_col<NQ>(th, q, j);
        const float2 b = kHasWe ? ldg2(a.b0 + c) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = th.r0 + 8 * h;
          float2 x = kHasWe ? make_float2(acc[q][4 * j + 2 * h],
                                          acc[q][4 * j + 2 * h + 1])
                            : ld_pair(e_tile, r, c);
          const float2 s = bf2(sv[j][h]), g = bf2(gv[j][h]);
          x.x += s.x;
          x.y += s.y;
          x.x += g.x;
          x.y += g.y;
          if (kHasWe) {
            x.x += b.x;
            x.y += b.y;
          }
          const bool in = t.ok[h] && c < C;
          st_pair(sh.a, r, c, in ? swish_of_bf16(x.x) : 0.f,
                  in ? swish_of_bf16(x.y) : 0.f);
        }
      }
    }
    dec_publish();
    dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // h @ W1
    const float4 st = dec_ln_stats<NQ>(acc, a.b1, th, rsum, C);
    // y = LN(.) * scale + offset; E <- e' = bf16(e + y); A <- bf16(y).
    // Both warpgroups are past the product (dec_ln_stats' barrier).
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = dec_col<NQ>(th, q, j);
        const float2 b = ldg2(a.b1 + c), sc = ldg2(a.scale + c),
                     of = ldg2(a.offset + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = dec_ln(st, acc[q][4 * j + 2 * h] + b.x, h) * sc.x +
                           of.x;
          const float y1 =
              dec_ln(st, acc[q][4 * j + 2 * h + 1] + b.y, h) * sc.y + of.y;
          if (kWriteE) {
            const float2 e = ld_pair(sh.e, th.r0 + 8 * h, c);
            st_pair(sh.e, th.r0 + 8 * h, c, e.x + y0, e.y + y1);
          }
          st_pair(sh.a, th.r0 + 8 * h, c, y0, y1);
        }
      }
    }
    if (kWriteE) {
      dec_publish();
      if (th.ctid == 0) edge_store_tile(&maps.eout, sh.e, t.row0, C);
    } else {
      dec_sync();
    }
    edge_run_sums(sh.a, sh.idx, t.rows, C, a.agg, th.ctid);
  }
}

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
    edge_fwd_consumer<kHasWe, kWriteE, kEmbed>(maps, a, sh, rank, groups,
                                               cluster, clusters);
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
  return edge_launch(fused_edge_kernel<kHasWe, kWriteE, kEmbed>,
                     edge_layout(0, kWriteE).total, tiles, 1 << 30, stream,
                     maps, a);
}

inline EdgeFwdArgs edge_fwd_args(const void* e, const void* sproj,
                                 const int* senders, const void* rproj,
                                 const int* receivers, const float* b0,
                                 const float* b1, const float* scale,
                                 const float* offset, void* eout, float* agg,
                                 int num_edges, int C) {
  EdgeFwdArgs a{};
  a.e = static_cast<const bf16*>(e);
  a.sproj = static_cast<const bf16*>(sproj);
  a.senders = senders;
  a.rproj = static_cast<const bf16*>(rproj);
  a.receivers = receivers;
  a.b0 = b0; a.b1 = b1; a.scale = scale; a.offset = offset;
  a.eout = static_cast<bf16*>(eout);
  a.agg = agg;
  a.num_edges = num_edges; a.C = C;
  return a;
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
                                  float* agg, int num_edges, int C,
                                  int write_e, void* stream) {
  const gc::EdgeFwdArgs a =
      gc::edge_fwd_args(e, sproj, senders, rproj, receivers, nullptr, b1,
                        scale, offset, eout, agg, num_edges, C);
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
    float* agg, int num_edges, int F, int C, void* stream) {
  gc::EdgeFwdArgs a =
      gc::edge_fwd_args(features, sproj, senders, rproj, receivers, b0, b1,
                        scale, offset, nullptr, agg, num_edges, C);
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
                                  float* agg, int num_edges, int C,
                                  int write_e, void* stream);

// e [E, C] bf16 (encoder mode: the hoisted first-layer part), sproj/rproj
// bf16 by node, weights [C, C] bf16, vectors f32 zero-padded to kDecWidth,
// eout [E, C] bf16 (with write_e), agg [num_receivers, C] f32 zeroed.
extern "C" int gc_fused_edge(const void* e, const void* sproj,
                             const int* senders, const void* rproj,
                             const int* receivers, const void* we,
                             const float* b0, const void* w1, const float* b1,
                             const float* scale, const float* offset,
                             void* eout, float* agg, int num_edges, int C,
                             int has_we, int write_e, void* stream) {
  if (!has_we) {
    return gc_fused_edge_nowe(e, sproj, senders, rproj, receivers, w1, b1,
                              scale, offset, eout, agg, num_edges, C,
                              write_e, stream);
  }
  const gc::EdgeFwdArgs a =
      gc::edge_fwd_args(e, sproj, senders, rproj, receivers, b0, b1, scale,
                        offset, eout, agg, num_edges, C);
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
