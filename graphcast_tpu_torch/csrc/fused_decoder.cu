// K2: the whole mesh2grid decoder, forward, for Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_decoder.py::_decoder_kernel (driven by
// FusedMesh2GridDecoder._forward). Every grid node v has exactly 3 incoming
// edges, rows 3v..3v+2 of the receiver-sorted edge list. Per grid node:
//
//   gproj = g @ Wr
//   for j in 0..2:
//     y_j = LN(bf16(swish(bf16(const[3v+j] + mesh_proj[snd[3v+j]] + gproj)))
//              @ W1 + b1) * es + eo                       (f32)
//   agg  = y_0 + y_1 + y_2                                (f32)
//   upd  = LN(bf16(swish(bf16(g @ Wng + bf16(agg) @ Wna + bn0))) @ Wn1 + bn1)
//          * ns + no
//   res  = bf16(g + upd)
//   out  = bf16(bf16(swish(bf16(res @ Wd0 + bd0))) @ Wd1 + bd1)
//
// Embed mode (GenCast's mesh2grid): const holds the raw [3G, F] edge
// features; each slot first embeds its row, en_j = bf16(LN0(bf16(swish(
// bf16(f @ ew0 + eb0))) @ ew1 + eb1)), and takes const_j = en_j @ We' + b0',
// the norm conditioning folded into We', b0' and the LN affines by the
// caller. Two more C x C products per edge slot (ew1, We'); the [3G, C]
// embedded edges never reach device memory.
//
// What bounds it on an H100: streaming the weights from L2. At C = 512 a
// 64-node tile runs 10 products of [64, 512] x [512, 512] (g @ Wr once per
// edge slot, as below) and one [64, 512] x [512, NO]: 5.5 MB of weights
// for 21 KB of useful output (plain; embed mode 8.6 MB). Against the card's
// 989 TFLOP/s the products need 2 x 64 x 512 = 64 KFLOP per weight byte
// read for 64 rows; L2 serves ~2.8 TB/s on this repo's kernels (PERF.md),
// so each weight byte must serve far more than 64 rows before the tensor
// cores can be the limit. Design (decoder.cuh):
//   * a cluster of two blocks of 64 grid nodes shares every weight box by
//     TMA multicast: each weight byte fetched from L2 serves 128 nodes (4x
//     the 32 of the wmma kernel this replaces); one producer thread per
//     block keeps a ring of 10 boxes of 8 KB full;
//   * two consumer warpgroups split each product by columns and issue wgmma
//     m64n64k16 per box (A from shared memory, B MN-major from the ring),
//     the f32 product in registers (128 a thread at C = 512);
//   * epilogues run on the accumulators: bias, swish to the next product's
//     bf16 operand in shared memory (K-major, 128-byte swizzle); LayerNorm
//     with its row statistics summed across both warpgroups;
//   * where each f32 value lives: the product in registers; gproj is not
//     kept but recomputed per edge slot (a fourth f32 [64, C] tile has no
//     room: registers hold one, shared memory holds the operand A, the grid
//     latents G and the ring); the 3-slot sum agg goes to a per-block
//     128 KB scratch in device memory (L2-resident), written after slot 0,
//     read and rewritten after slot 1, read after slot 2 straight into
//     bf16(agg), the A operand of Wna. Shared memory: A 64 KB, G 64 KB,
//     ring 80 KB, row exchange and barriers 2.3 KB;
//   * the sender rows mesh_proj[snd] and the const rows (embed mode: the
//     raw features) are gathered by index in the epilogue that needs them;
//     the [3, G, C] gathered rows never reach device memory;
//   * persistent: as many clusters as fit walk the pairs of tiles.
// Deterministic: no atomics, a fixed summation order.

#include "decoder.cuh"

namespace gc {

struct DecoderMaps {
  CUtensorMap grid, wr, w1, wng, wna, wn1, wd0, wd1, ew1, we;
};

struct DecoderArgs {
  const bf16* mesh_proj;  // [M, C]
  const bf16* cnst;       // [3G, C]; embed mode: raw features [3G, F]
  const int* senders;     // [3G]
  const float *b1, *es, *eo, *bn0, *bn1, *ns, *no, *bd0, *bd1;  // bd1 [NO]
  const bf16* ew0;        // embed mode: [F, C]
  const float *eb0, *eb1, *b0;
  bf16* out;              // [G, num_out]
  float* scratch;         // [blocks, 64 kDecWidth] f32: agg
  int num_grid, C, NO, num_out, F;  // C: the latent width, <= kDecWidth
};

// A <- bf16(swish(bf16(acc + bias))) (the node and output MLPs).
template <int NQ>
__device__ __forceinline__ void swish_to_a(const float (&acc)[NQ][32],
                                           const float* __restrict__ bias,
                                           unsigned char* A,
                                           const DecThread& th) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = dec_col<NQ>(th, q, j);
      const float2 b = ldg2(bias + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        st_pair(A, th.r0 + 8 * h, c, swish_of_bf16(acc[q][4 * j + 2 * h] + b.x),
                swish_of_bf16(acc[q][4 * j + 2 * h + 1] + b.y));
      }
    }
  }
}

// The consumer warpgroups' walk over the cluster's tiles (the head note).
template <int NQ, bool kEmbed>
__device__ __forceinline__ void decoder_consumer(const DecoderMaps& maps,
                                                 const DecoderArgs& a,
                                                 const DecSmem& sh,
                                                 uint32_t rank, int pairs,
                                                 int cluster, int clusters) {
  constexpr int kK = NQ * 2;  // 64-deep slabs of a product over the layout
  const int C = a.C;
  const DecThread th(threadIdx.x);
  DecRing ring(sh, th);
  DecRows rsum{sh.exchange};
  const uint32_t a_addr = smem_u32(sh.a), g_addr = smem_u32(sh.g);
  const DecScratch<NQ> agg{a.scratch +
                           (size_t)blockIdx.x * kDecRows * NQ * 128};
  float acc[NQ][32];
  int it = 0;
  for (int pair = cluster; pair < pairs; pair += clusters, ++it) {
    const int v0 = (2 * pair + (int)rank) * kDecRows;
    const int rows = max(0, min(kDecRows, a.num_grid - v0));
    const bool ok0 = th.r0 < rows, ok1 = th.r0 + 8 < rows;
    dec_sync();  // the previous tile is done with G and A
    if (th.ctid == 0) dec_load_tile(sh.g, &maps.grid, sh.g_bar, NQ * 128, v0);
    mbar_wait(sh.g_bar, it & 1);

#pragma unroll 1
    for (int j = 0; j < 3; ++j) {
      const int e0 = 3 * (v0 + th.r0) + j, e1 = e0 + 24;  // rows r0, r0 + 8
      const int s0 = ok0 ? __ldg(a.senders + e0) : 0;
      const int s1 = ok1 ? __ldg(a.senders + e1) : 0;
      if (kEmbed) {
        // A <- hh_j = bf16(swish(bf16(f_j @ ew0 + eb0))), on the CUDA cores.
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = dec_col<NQ>(th, q, jj);
            const float2 b = ldg2(a.eb0 + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float hx = 0.f, hy = 0.f;
              if (h == 0 ? ok0 : ok1) {
                const bf16* f = a.cnst + (size_t)(h == 0 ? e0 : e1) * a.F;
                float x0 = 0.f, x1 = 0.f;
                for (int k = 0; k < a.F; ++k) {
                  const float fk = __bfloat162float(__ldg(f + k));
                  const float2 w = ldg_bf16x2(a.ew0 + (size_t)k * NQ * 128 + c);
                  x0 = fmaf(fk, w.x, x0);
                  x1 = fmaf(fk, w.y, x1);
                }
                hx = swish_of_bf16(x0 + b.x);
                hy = swish_of_bf16(x1 + b.y);
              }
              st_pair(sh.a, th.r0 + 8 * h, c, hx, hy);
            }
          }
        }
        dec_publish();
        dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // hh_j @ Ew1
        const float4 st = dec_ln_stats<NQ>(acc, a.eb1, th, rsum, C);
        // A <- en_j = bf16(LN0(.)); both warpgroups are past the product.
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = dec_col<NQ>(th, q, jj);
            const float2 b = ldg2(a.eb1 + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              st_pair(sh.a, th.r0 + 8 * h, c,
                      dec_ln(st, acc[q][4 * jj + 2 * h] + b.x, h),
                      dec_ln(st, acc[q][4 * jj + 2 * h + 1] + b.y, h));
            }
          }
        }
        dec_publish();
        dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // en_j @ We'
        dec_mma<NQ, 1>(acc, g_addr, kK, true, ring);   // + g @ Wr
      } else {
        dec_mma<NQ, 1>(acc, g_addr, kK, false, ring);  // gproj
      }
      dec_sync();  // both warpgroups are done reading A
      // A <- h_j = bf16(swish(bf16(const_j + mesh_proj[snd_j] + gproj))).
      const int edge[2] = {e0, e1}, snd[2] = {s0, s1};
      const bool ok[2] = {ok0, ok1};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float2 xin[8][2];
        dec_slot_inputs<NQ, kEmbed>(xin, th, q, C, a.cnst, a.b0, a.mesh_proj,
                                    edge, snd, ok);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float hx = 0.f, hy = 0.f;
            if (ok[h] && c < C) {
              hx = swish_of_bf16(xin[jj][h].x + acc[q][4 * jj + 2 * h]);
              hy = swish_of_bf16(xin[jj][h].y + acc[q][4 * jj + 2 * h + 1]);
            }
            st_pair(sh.a, th.r0 + 8 * h, c, hx, hy);
          }
        }
      }
      dec_publish();
      dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // h_j @ W1
      const float4 st = dec_ln_stats<NQ>(acc, a.b1, th, rsum, C);
      // agg (+)= y_j; after the last slot A <- bf16(agg).
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 prev[8];
        if (j > 0) dec_load_chunk<NQ>(prev, agg, q, th.ctid);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
          const float2 b = ldg2(a.b1 + c), sc = ldg2(a.es + c),
                       of = ldg2(a.eo + c);
          float4 y = make_float4(
              dec_ln(st, acc[q][4 * jj] + b.x, 0) * sc.x + of.x,
              dec_ln(st, acc[q][4 * jj + 1] + b.y, 0) * sc.y + of.y,
              dec_ln(st, acc[q][4 * jj + 2] + b.x, 1) * sc.x + of.x,
              dec_ln(st, acc[q][4 * jj + 3] + b.y, 1) * sc.y + of.y);
          if (j > 0) {
            const float4 g = prev[jj];
            y = make_float4(g.x + y.x, g.y + y.y, g.z + y.z, g.w + y.w);
          }
          if (j < 2) {
            *agg.at(q, jj, th.ctid) = y;
          } else {
            st_pair(sh.a, th.r0, c, y.x, y.y);
            st_pair(sh.a, th.r0 + 8, c, y.z, y.w);
          }
        }
      }
    }
    dec_publish();

    // Node MLP on [g, bf16(agg)] + LayerNorm + residual.
    dec_mma<NQ, 1>(acc, g_addr, kK, false, ring);  // g @ Wng
    dec_mma<NQ, 1>(acc, a_addr, kK, true, ring);   // + bf16(agg) @ Wna
    dec_sync();
    swish_to_a<NQ>(acc, a.bn0, sh.a, th);
    dec_publish();
    dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // @ Wn1
    {
      const float4 st = dec_ln_stats<NQ>(acc, a.bn1, th, rsum, C);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
          const float2 b = ldg2(a.bn1 + c), sc = ldg2(a.ns + c),
                       of = ldg2(a.no + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = th.r0 + 8 * h;
            const float2 g = ld_pair(sh.g, r, c);
            st_pair(sh.a, r, c,
                    g.x + (dec_ln(st, acc[q][4 * jj + 2 * h] + b.x, h) * sc.x + of.x),
                    g.y + (dec_ln(st, acc[q][4 * jj + 2 * h + 1] + b.y, h) * sc.y + of.y));
          }
        }
      }
    }
    dec_publish();

    // Output MLP.
    dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // res @ Wd0
    dec_sync();
    swish_to_a<NQ>(acc, a.bd0, sh.a, th);
    dec_publish();
    for (int q = 0; q < a.NO / 128; ++q) {  // 64 output columns a pass
      dec_mma_pass(acc[0], a_addr, kK, ring);
      const int c0 = (2 * q + th.w) * 64 + 2 * th.t;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + 8 * jj + e;
            if ((h == 0 ? ok0 : ok1) && c < a.num_out) {
              a.out[(size_t)(v0 + th.r0 + 8 * h) * a.num_out + c] =
                  __float2bfloat16(acc[0][4 * jj + 2 * h + e] + __ldg(a.bd1 + c));
            }
          }
        }
      }
    }
  }
}

template <bool kEmbed>
__global__ void __launch_bounds__(kDecThreads, 1) fused_decoder_kernel(
    const __grid_constant__ DecoderMaps maps, const DecoderArgs a) {
  constexpr int W = kDecWidth;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DecSmem sh(smem_raw, dec_layout(W, W, 0));
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const uint32_t rank = cluster_ctarank();
  const int tiles = (a.num_grid + kDecRows - 1) / kDecRows;
  const int pairs = (tiles + 1) / 2;
  const int cluster = blockIdx.x / kDecCluster;
  const int clusters = gridDim.x / kDecCluster;
  if (threadIdx.x == 0) sh.init();
  __syncthreads();
  cluster_sync();  // the partner's barriers are initialised

  if (warp >= kDecConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<kDecProducerRegs>();
    if (threadIdx.x == kDecConsumers) {
      DecProducer pr(sh, rank);
      for (int pair = cluster; pair < pairs; pair += clusters) {
        for (int j = 0; j < 3; ++j) {
          if (kEmbed) {
            pr.fwd(&maps.ew1, W, W);
            pr.fwd(&maps.we, W, W);
          }
          pr.fwd(&maps.wr, W, W);
          pr.fwd(&maps.w1, W, W);
        }
        pr.fwd(&maps.wng, W, W);
        pr.fwd(&maps.wna, W, W);
        pr.fwd(&maps.wn1, W, W);
        pr.fwd(&maps.wd0, W, W);
        pr.fwd_passes(&maps.wd1, W, a.NO);
      }
    }
  } else {
    setmaxnreg_inc<kDecConsumerRegs>();
    decoder_consumer<kDecNQ, kEmbed>(maps, a, sh, rank, pairs, cluster,
                                     clusters);
  }
  __syncwarp();
  cluster_sync();  // no block exits while its partner may still arrive
}

template <bool kEmbed>
int fused_decoder(const void* grid, const void* wr, const void* w1,
                  const void* wng, const void* wna, const void* wn1,
                  const void* wd0, const void* wd1, const void* ew1,
                  const void* we, const DecoderArgs& a, int max_blocks,
                  void* stream) {
  if (a.num_grid <= 0) return 0;
  const int C = a.C;
  if (C % 128 || C < 128 || C > kDecWidth || a.NO % 128 || a.NO < 128 ||
      a.NO > 512 || max_blocks < kDecCluster) {
    return cudaErrorInvalidValue;
  }
  // Tensor maps of the true width C: boxes past it arrive as zeros.
  DecoderMaps maps;
  cudaError_t err = bf16_tile_map(&maps.grid, grid, a.num_grid, C, C, 64);
  const void* cc[6] = {wr, w1, wng, wna, wn1, wd0};
  CUtensorMap* cm[6] = {&maps.wr, &maps.w1, &maps.wng, &maps.wna, &maps.wn1,
                        &maps.wd0};
  for (int i = 0; i < 6 && err == cudaSuccess; ++i) {
    err = bf16_tile_map(cm[i], cc[i], C, C, C, 64);
  }
  if (err == cudaSuccess) {
    err = bf16_tile_map(&maps.wd1, wd1, C, a.NO, a.NO, 64);
  }
  if (kEmbed && err == cudaSuccess) {
    err = bf16_tile_map(&maps.ew1, ew1, C, C, C, 64);
  }
  if (kEmbed && err == cudaSuccess) {
    err = bf16_tile_map(&maps.we, we, C, C, C, 64);
  }
  if (!kEmbed) {
    maps.ew1 = maps.wr;
    maps.we = maps.wr;
  }
  if (err != cudaSuccess) return err;
  const DecLayout L = dec_layout(kDecWidth, kDecWidth, 0);
  const int tiles = (a.num_grid + kDecRows - 1) / kDecRows;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  auto kernel = fused_decoder_kernel<kEmbed>;
  err = dec_launch_config(kernel, L.total, (tiles + 1) / 2, max_blocks,
                          static_cast<cudaStream_t>(stream), cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gc

// Each translation unit builds one kernel: this file the plain mode,
// fused_decoder_embed.cu (which includes it) the embed mode, so that
// the two build in parallel.
#ifndef GC_K2_EMBED_UNIT

// grid [G, C], mesh_proj [M, C], cnst [3G, C] bf16; senders [3G] int32;
// weights bf16 row-major ([C, C], wd1 [C, NO] with NO the outputs padded
// to a multiple of 128); vectors f32, zero-padded to kDecWidth (bd1 [NO]);
// out [G, num_out] bf16; scratch: max_blocks * 64 * kDecWidth f32 (the
// launch uses at most max_blocks blocks).
extern "C" int gc_fused_decoder(
    const void* grid, const void* mesh_proj, const void* cnst,
    const int* senders, const void* wr, const void* w1, const float* b1,
    const float* es, const float* eo, const void* wng, const void* wna,
    const float* bn0, const void* wn1, const float* bn1, const float* ns,
    const float* no, const void* wd0, const float* bd0, const void* wd1,
    const float* bd1, void* out, float* scratch, int num_grid, int C, int NO,
    int num_out, int max_blocks, void* stream) {
  using gc::bf16;
  gc::DecoderArgs a{};
  a.mesh_proj = static_cast<const bf16*>(mesh_proj);
  a.cnst = static_cast<const bf16*>(cnst);
  a.senders = senders;
  a.b1 = b1; a.es = es; a.eo = eo; a.bn0 = bn0; a.bn1 = bn1; a.ns = ns;
  a.no = no; a.bd0 = bd0; a.bd1 = bd1;
  a.out = static_cast<bf16*>(out);
  a.scratch = scratch;
  a.num_grid = num_grid; a.C = C; a.NO = NO; a.num_out = num_out;
  return gc::fused_decoder<false>(grid, wr, w1, wng, wna, wn1, wd0, wd1,
                                  nullptr, nullptr, a, max_blocks, stream);
}

// The decoder kernels' shared-memory layout (decoder.cuh dec_layout) for
// latent width C, an A operand a_cols wide and `sums` column-sum floats:
// out[9] = a, g, ring, exchange, sums, colred, bars, stages, total.
extern "C" void gc_decoder_layout(int C, int a_cols, int sums, int* out) {
  const gc::DecLayout L = gc::dec_layout(C, a_cols, sums);
  const int v[9] = {L.a,      L.g,    L.ring,   L.exchange, L.sums,
                    L.colred, L.bars, L.stages, L.total};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

#else  // GC_K2_EMBED_UNIT

// Embed mode: features [3G, F] raw edge features in edge order (bf16), ew0
// [F, kDecWidth] bf16 (zero-padded), ew1 and we [C, C] bf16, eb0, eb1, b0
// [kDecWidth] f32.
extern "C" int gc_fused_decoder_embed(
    const void* grid, const void* mesh_proj, const void* features,
    const int* senders, const void* ew0, const float* eb0, const void* ew1,
    const float* eb1, const void* we, const float* b0, const void* wr,
    const void* w1, const float* b1, const float* es, const float* eo,
    const void* wng, const void* wna, const float* bn0, const void* wn1,
    const float* bn1, const float* ns, const float* no, const void* wd0,
    const float* bd0, const void* wd1, const float* bd1, void* out,
    float* scratch, int num_grid, int C, int NO, int num_out, int F,
    int max_blocks, void* stream) {
  using gc::bf16;
  gc::DecoderArgs a{};
  a.mesh_proj = static_cast<const bf16*>(mesh_proj);
  a.cnst = static_cast<const bf16*>(features);
  a.senders = senders;
  a.b1 = b1; a.es = es; a.eo = eo; a.bn0 = bn0; a.bn1 = bn1; a.ns = ns;
  a.no = no; a.bd0 = bd0; a.bd1 = bd1;
  a.ew0 = static_cast<const bf16*>(ew0);
  a.eb0 = eb0; a.eb1 = eb1; a.b0 = b0;
  a.out = static_cast<bf16*>(out);
  a.scratch = scratch;
  a.num_grid = num_grid; a.C = C; a.NO = NO; a.num_out = num_out; a.F = F;
  return gc::fused_decoder<true>(grid, wr, w1, wng, wna, wn1, wd0, wd1, ew1,
                                 we, a, max_blocks, stream);
}

#endif  // GC_K2_EMBED_UNIT
