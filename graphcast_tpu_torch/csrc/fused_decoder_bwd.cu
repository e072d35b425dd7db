// K5: the backward of the fused mesh2grid decoder (K2), per-node pass, for
// Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_decoder.py::_decoder_bwd_kernel (driven
// by FusedMesh2GridDecoder._backward), plain and embed modes. Per grid node v
// (edge slots j = 0, 1, 2, rows 3v + j of the edge list) it recomputes K2's
// forward, then back-propagates the output cotangent through the output
// MLP, the node MLP + LayerNorm + residual, and each edge slot's MLP +
// LayerNorm:
//
//   dxo  = (bf16(dout) @ Wd1^T) * swish'(xo)
//   dres = bf16(dxo) @ Wd0^T                       (also the residual's dg)
//   dyn  = LN0'(dres * ns)      dxn = (bf16(dyn) @ Wn1^T) * swish'(xn)
//   dg  += bf16(dxn) @ Wng^T    dagg = bf16(dxn) @ Wna^T
//   per slot: dy_j = LN0'(dagg * es)
//             dx0_j = (bf16(dy_j) @ W1^T) * swish'(x0_j)
//             dgs_j = dconst_j = bf16(dx0_j),  dgproj += dx0_j
//   dgrid = bf16(dg + bf16(dgproj) @ Wr^T)
// and the column sums dbd1 = sum dout, dbd0 = sum dxo, dnoffset = sum dres,
// dnscale = sum dres * ynh, dbn1 = sum dyn, dbn0 = sum dxn,
// deoffset = 3 sum dagg, descale = sum_j dagg * yh_j, db1 = sum_j dy_j.
//
// Embed mode (GenCast's mesh2grid, pallas_decoder.py:268-280 and 381-400):
// const holds the raw [3G, F] edge features and each slot starts from
// x0_j = en_j @ We' + b0' + mesh_proj[snd_j] + gproj, en_j = bf16(yh0_j),
// yh0_j = LN0(hh_j @ Ew1 + eb1), hh_j = bf16(swish(bf16(f_j @ Ew0 + eb0))).
// Per slot the backward adds
//
//   den_j = bf16(dx0_j) @ We'^T (f32)    dy0_j = LN0'(den_j)
//   dxe_j = (bf16(dy0_j) @ Ew1^T) * swish'(bf16(f_j @ Ew0 + eb0))
//
// and the column sums db0' = sum_j dx0_j, deb1 = sum_j dy0_j, deb0 = sum_j
// dxe_j. The forward pass embeds each slot and keeps en_j, hh_j (bf16 rows
// in the slabs) and yh0_j (f32, by edge; each row's rstd in shared memory);
// the backward pass reads en_j back instead of embedding again. dWe' =
// en^T bf16(dx0) (dx0 is dgs), dEw1 = hh^T bf16(dy0), and dEw0 with the
// raw-feature gradient from bf16(dxe) are reduced outside (weight_grad.cu).
//
// What bounds it on an H100: streaming the weights from L2, as in K2. Per
// 64-node tile at C = 512: 25 products of [64, 512] x [512, 512] (10 to
// recompute the forward, 15 for the cotangents; embed mode 40), 12.8 MB of
// weight boxes (embed 20.5 MB). Design (decoder.cuh, as K2):
//   * two kernels a chunk, each one cluster launch over its tile pairs: the
//     node pass (the forward recompute, then the output MLP's and the node
//     MLP's backward: 15 products, embed 21) and the edge pass (the edge
//     slots' recompute and backward, then dgrid: 10, embed 19). One kernel
//     of 25 to 40 product sites took ptxas 8 to 13+ minutes; a pass builds
//     in its own translation unit, in parallel with the others;
//   * a cluster of two 64-node blocks shares each weight box by TMA
//     multicast, so each weight byte from L2 serves 128 nodes (8x the 16 of
//     the wmma kernel this replaces); a producer thread per block streams
//     the boxes of the pass's sequence of products through a ring (8 boxes
//     at C = 512, 7 in embed mode), two consumer warpgroups split each
//     product by columns and issue wgmma m64n64k16 per box;
//   * the transposed products (Wd1^T, Wd0^T, Wn1^T, Wng^T, Wna^T, W1^T, Wr^T,
//     We'^T, Ew1^T) read the same boxes of the same weights K-major; the
//     wrapper makes no transposed copy;
//   * where each f32 value lives: the product in registers (128 a thread);
//     shared memory holds the operand A, the grid latents G, the ring and
//     the column sums; the f32 tiles that outlive a product go to device
//     memory in the accumulator's layout: per tile, agg, then ynh, then
//     dres + the Wng^T term (dg), and dagg, which the edge pass reads; per
//     block, dgproj (summed over the slots) and two bf16 tiles of swish'
//     (of xn, and of xo or x0_j; exact in bf16); LN0's rstd by edge (embed
//     mode). gproj is recomputed per slot in both passes, as in K2;
//   * the column sums stay in shared memory per block, added per tile in a
//     fixed order (rows in pairs, a shuffle tree over each warp, the 4
//     warps in order), and reach device memory as per-block partials that a
//     second kernel sums over the blocks in order: a rerun at the same
//     chunking is bit-equal;
//   * the bf16 operands of the matrix gradients (agg_d, hn, res, ho, dxo_d,
//     dyn_d, dxn_d, dgproj_d per node; h_j, dy_j per edge) go to the slab
//     scratch in device memory, and weight_grad.cu reduces them (split-K);
//     the wrapper runs both over chunks of grid nodes, which bounds the
//     scratch at 14 bf16 rows per node of the chunk;
//   * dgs stays per edge: the wrapper scatters it to the mesh nodes (as the
//     JAX package does outside its kernel).
// Rounding points follow the TPU kernel: every product's operand is bf16
// (dout, dxo, dyn, dxn, dy_j, dgproj), the cotangents and sums in f32.

#include "decoder.cuh"

namespace gc {

// Column sums, [kDecSums (embed: kDecSumsEmbed), C] then dbd1 [NO].
enum { kSBd0, kSNoff, kSNscale, kSBn1, kSBn0, kSEoff, kSEscale, kSB1,
       kDecSums, kSB0 = kDecSums, kSEb1, kSEb0, kDecSumsEmbed };
// Scratch slabs of [slab_rows, C] bf16; hs, dys and the embed mode's hh,
// en, dy0 and dxe (per edge, in edge order) take 3 slabs each.
enum { kAggD, kHn, kRes, kHo, kDxo, kDyn, kDxn, kDgp, kHs = 8, kDys = 11,
       kDecSlabs = 14, kHh = 14, kEn = 17, kDy0 = 20, kDxe = 23,
       kDecSlabsEmbed = 26 };
// Per-block work scratch, in floats per column of kDecWidth: an f32 tile
// (agg, then ynh, in the node pass; dgproj in the edge pass) and two bf16
// tiles.
constexpr int kDecWork = 64 + 2 * 32;

struct DecoderBwdMaps {
  CUtensorMap grid, dout, wr, w1, wng, wna, wn1, wd0, wd1, ew1, we;
};

struct DecoderBwdArgs {
  const bf16* mesh_proj;   // [M, C]
  const bf16* cnst;        // [3 rows, C], chunk; embed: features [3 rows, F]
  const int* senders;      // [3 rows], chunk
  const float *b1, *es, *eo, *bn0, *bn1, *ns, *no, *bd0;  // [C]
  bf16* dgrid;             // [rows, C], chunk
  bf16* dgs;               // [3 rows, C], chunk
  bf16* scratch;           // [slabs, slab_rows, C]
  float* work;             // [max_blocks, kDecWork kDecWidth]
  float* dg;               // [tiles, 64 kDecWidth]: dres + the Wng^T term
  float* dagg;             // [tiles, 64 kDecWidth]
  float* partials;         // [blocks, sums]
  int slab_rows, num_rows, C, NO;  // C: the latent width, <= kDecWidth
  const bf16* ew0;         // embed mode: [F, C]
  const float *eb0, *eb1, *b0;
  float* en32;             // [3 slab_rows, C] f32, edge order
  float* rstd0;            // [3 slab_rows] f32: LN0's rstd by edge
  int F;
};

// bf16(f @ ew0 + eb0)[c] for one raw feature row f (ew0 rows ldw apart):
// the embed's first-layer output before its swish (f32 fmas over the F
// features, then the bias, rounded to bf16), the swish' point of the
// embed's backward; its loads through the non-coherent path so that they
// need not wait for the epilogue's stores.
__device__ __forceinline__ float embed_pre_ldg(const bf16* __restrict__ f,
                                               int F,
                                               const bf16* __restrict__ ew0,
                                               const float* __restrict__ eb0,
                                               int ldw, int c) {
  float x = 0.f;
  for (int k = 0; k < F; ++k) {
    x = fmaf(__bfloat162float(__ldg(f + k)),
             __bfloat162float(__ldg(ew0 + (size_t)k * ldw + c)), x);
  }
  return round_bf16(x + __ldg(eb0 + c));
}

// The consumer warpgroups of pass kPass: 0, the node pass (the forward
// recompute, the output and node MLPs' backward: dg and dagg to the
// per-tile arrays), 1, the edge pass (the edge slots' backward and dgrid).
template <int NQ, bool kEmbed, int kPass>
__device__ __forceinline__ void decoder_bwd_consumer(
    const DecoderBwdMaps& maps, const DecoderBwdArgs& a, const DecSmem& sh,
    uint32_t rank, int pairs, int cluster, int clusters) {
  constexpr int W = NQ * 128;  // the layout's width
  constexpr int kK = W / 64;
  constexpr int kSums = kEmbed ? kDecSumsEmbed : kDecSums;
  const int C = a.C;
  const DecThread th(threadIdx.x);
  DecRing ring(sh, th);
  DecRows rsum{sh.exchange};
  const DecColSums cs{sh.colred, sh.sums, C};
  const uint32_t a_addr = smem_u32(sh.a), g_addr = smem_u32(sh.g);
  float* work = a.work + (size_t)blockIdx.x * kDecWork * W;
  const DecScratch<NQ> tw{work};  // agg, ynh (node pass); dgproj (edges)
  const DecScratch16<NQ> sxn{reinterpret_cast<bf16*>(work + 64 * W)};
  const DecScratch16<NQ> sx{reinterpret_cast<bf16*>(work + 96 * W)};
  const int NO = a.NO;
  const size_t slab_elems = (size_t)a.slab_rows * C;
  bf16* const slabs = a.scratch;
  for (int i = th.ctid; i < kSums * C + NO; i += kDecConsumers) {
    sh.sums[i] = 0.f;
  }
  float acc[NQ][32];

  int it = 0;
  for (int pair = cluster; pair < pairs; pair += clusters, ++it) {
    const int v0 = (2 * pair + (int)rank) * kDecRows;
    const int rows = max(0, min(kDecRows, a.num_rows - v0));
    const bool ok0 = th.r0 < rows, ok1 = th.r0 + 8 < rows;
    const int n0 = v0 + th.r0, n1 = n0 + 8;  // this thread's node rows
    const size_t tile_off = (size_t)(2 * pair + (int)rank) * kDecRows * W;
    const DecScratch<NQ> t0{a.dg + tile_off}, t1{a.dagg + tile_off};
    dec_sync();  // the previous tile is done with G and A
    if (th.ctid == 0) dec_load_tile(sh.g, &maps.grid, sh.g_bar, W, v0);
    mbar_wait(sh.g_bar, it & 1);
    if (kPass == 0) {

      // ---- forward recompute ----
#pragma unroll 1
      for (int j = 0; j < 3; ++j) {
        const int e0 = 3 * n0 + j, e1 = e0 + 24;
        const int s0 = ok0 ? __ldg(a.senders + e0) : 0;
        const int s1 = ok1 ? __ldg(a.senders + e1) : 0;
        const int edge[2] = {e0, e1}, snd[2] = {s0, s1};
        const bool ok[2] = {ok0, ok1};
        if (kEmbed) {
          // A <- hh_j (kept in the hh slab); then en_j = bf16(yh0_j) (kept in
          // the en slab, yh0_j in en32, its rstd in shared memory).
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
                  const int e = h == 0 ? e0 : e1;
                  const bf16* f = a.cnst + (size_t)e * a.F;
                  float x0 = 0.f, x1 = 0.f;
                  for (int k = 0; k < a.F; ++k) {
                    const float fk = __bfloat162float(__ldg(f + k));
                    const float2 w = ldg_bf16x2(a.ew0 + (size_t)k * W + c);
                    x0 = fmaf(fk, w.x, x0);
                    x1 = fmaf(fk, w.y, x1);
                  }
                  hx = swish_of_bf16(x0 + b.x);
                  hy = swish_of_bf16(x1 + b.y);
                  put_pair(slabs + kHh * slab_elems, e, C, c, true, hx, hy);
                }
                st_pair(sh.a, th.r0 + 8 * h, c, hx, hy);
              }
            }
          }
          dec_publish();
          dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // hh_j @ Ew1
          const float4 st = dec_ln_stats<NQ>(acc, a.eb1, th, rsum, C);
          if (th.w == 0 && th.t == 0) {
            if (ok0) a.rstd0[e0] = st.y;
            if (ok1) a.rstd0[e1] = st.w;
          }
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int c = dec_col<NQ>(th, q, jj);
              const float2 b = ldg2(a.eb1 + c);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float y0 = dec_ln(st, acc[q][4 * jj + 2 * h] + b.x, h);
                const float y1 = dec_ln(st, acc[q][4 * jj + 2 * h + 1] + b.y, h);
                st_pair(sh.a, th.r0 + 8 * h, c, y0, y1);
                if ((h == 0 ? ok0 : ok1) && c < C) {
                  const size_t o = (size_t)(h == 0 ? e0 : e1) * C + c;
                  *reinterpret_cast<float2*>(a.en32 + o) = make_float2(y0, y1);
                  store_bf16x2(slabs + kEn * slab_elems + o, y0, y1);
                }
              }
            }
          }
          dec_publish();
          dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // en_j @ We'
          dec_mma<NQ, 1>(acc, g_addr, kK, true, ring);   // + g @ Wr
        } else {
          dec_mma<NQ, 1>(acc, g_addr, kK, false, ring);  // gproj
        }
        dec_sync();
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float2 xin[8][2];
          dec_slot_inputs<NQ, kEmbed>(xin, th, q, C, a.cnst, a.b0,
                                      a.mesh_proj, edge, snd, ok);
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
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float4 prev[8];
          if (j > 0) dec_load_chunk<NQ>(prev, t0, q, th.ctid);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = dec_col<NQ>(th, q, jj);
            const float2 b = ldg2(a.b1 + c), sc = ldg2(a.es + c);
            const float2 of = ldg2(a.eo + c);
            float4 y = f4(dec_ln(st, acc[q][4 * jj] + b.x, 0) * sc.x + of.x,
                          dec_ln(st, acc[q][4 * jj + 1] + b.y, 0) * sc.y + of.y,
                          dec_ln(st, acc[q][4 * jj + 2] + b.x, 1) * sc.x + of.x,
                          dec_ln(st, acc[q][4 * jj + 3] + b.y, 1) * sc.y + of.y);
            if (j > 0) {
              const float4 g = prev[jj];
              y = f4(g.x + y.x, g.y + y.y, g.z + y.z, g.w + y.w);
            }
            if (j < 2) {
              *t0.at(q, jj, th.ctid) = y;
            } else {  // A <- bf16(agg), kept in the agg slab
              st_pair(sh.a, th.r0, c, y.x, y.y);
              st_pair(sh.a, th.r0 + 8, c, y.z, y.w);
              put_pair(slabs + kAggD * slab_elems, n0, C, c, ok0, y.x, y.y);
              put_pair(slabs + kAggD * slab_elems, n1, C, c, ok1, y.z, y.w);
            }
          }
        }
      }
      dec_publish();

      // Node MLP: xn = g @ Wng + bf16(agg) @ Wna + bn0, hn = bf16(swish(xn)).
      dec_mma<NQ, 1>(acc, g_addr, kK, false, ring);
      dec_mma<NQ, 1>(acc, a_addr, kK, true, ring);
      dec_sync();
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
          const float2 b = ldg2(a.bn0 + c);
          float x[4], hv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            x[k] = acc[q][4 * jj + k] + (k % 2 ? b.y : b.x);
            hv[k] = swish_of_bf16(x[k]);
          }
          *sxn.at(q, jj, th.ctid) = pack4_bf16(
              swish_grad_bf16(round_bf16(x[0])), swish_grad_bf16(round_bf16(x[1])),
              swish_grad_bf16(round_bf16(x[2])), swish_grad_bf16(round_bf16(x[3])));
          st_pair(sh.a, th.r0, c, hv[0], hv[1]);
          st_pair(sh.a, th.r0 + 8, c, hv[2], hv[3]);
          put_pair(slabs + kHn * slab_elems, n0, C, c, ok0, hv[0], hv[1]);
          put_pair(slabs + kHn * slab_elems, n1, C, c, ok1, hv[2], hv[3]);
        }
      }
      dec_publish();
      // ynh = LN0(hn @ Wn1 + bn1) to T0; res = bf16(g + ynh * ns + no).
      dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);
      float4 nst = dec_ln_stats<NQ>(acc, a.bn1, th, rsum, C);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
          const float2 b = ldg2(a.bn1 + c), sc = ldg2(a.ns + c), of = ldg2(a.no + c);
          const float4 y = f4(dec_ln(nst, acc[q][4 * jj] + b.x, 0),
                              dec_ln(nst, acc[q][4 * jj + 1] + b.y, 0),
                              dec_ln(nst, acc[q][4 * jj + 2] + b.x, 1),
                              dec_ln(nst, acc[q][4 * jj + 3] + b.y, 1));
          *t0.at(q, jj, th.ctid) = y;
          const float2 g0 = ld_pair(sh.g, th.r0, c), g1 = ld_pair(sh.g, th.r0 + 8, c);
          const float r0x = g0.x + (y.x * sc.x + of.x), r0y = g0.y + (y.y * sc.y + of.y);
          const float r1x = g1.x + (y.z * sc.x + of.x), r1y = g1.y + (y.w * sc.y + of.y);
          st_pair(sh.a, th.r0, c, r0x, r0y);
          st_pair(sh.a, th.r0 + 8, c, r1x, r1y);
          put_pair(slabs + kRes * slab_elems, n0, C, c, ok0, r0x, r0y);
          put_pair(slabs + kRes * slab_elems, n1, C, c, ok1, r1x, r1y);
        }
      }
      dec_publish();
      // xo = res @ Wd0 + bd0: ho to its slab, swish'(xo) to sx.
      dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);
      dec_sync();  // both warpgroups are done reading A
      if (th.ctid == 0) dec_load_tile(sh.a, &maps.dout, sh.a_bar, NO, v0);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
          const float2 b = ldg2(a.bd0 + c);
          float x[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) x[k] = acc[q][4 * jj + k] + (k % 2 ? b.y : b.x);
          *sx.at(q, jj, th.ctid) = pack4_bf16(
              swish_grad_bf16(round_bf16(x[0])), swish_grad_bf16(round_bf16(x[1])),
              swish_grad_bf16(round_bf16(x[2])), swish_grad_bf16(round_bf16(x[3])));
          put_pair(slabs + kHo * slab_elems, n0, C, c, ok0,
                   swish_of_bf16(x[0]), swish_of_bf16(x[1]));
          put_pair(slabs + kHo * slab_elems, n1, C, c, ok1,
                   swish_of_bf16(x[2]), swish_of_bf16(x[3]));
        }
      }

      // ---- output MLP backward ----
      mbar_wait(sh.a_bar, it & 1);  // A <- dout (rows past the chunk: zeros)
      for (int c = th.ctid; c < NO; c += kDecConsumers) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) {
          s += __bfloat162float(*reinterpret_cast<const bf16*>(sh.a + swz(r, c)));
        }
        sh.sums[kSums * C + c] += s;
      }
      dec_mma<NQ, 0>(acc, a_addr, NO / 64, false, ring);  // dho = dout @ Wd1^T
      dec_sync();
      // dxo = dho * swish'(xo) -> A.
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 sxv[8];
        dec_load_chunk<NQ>(sxv, sx, q, th.ctid);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
          const float4 d = sxv[jj];
          const float v0x = acc[q][4 * jj] * d.x, v0y = acc[q][4 * jj + 1] * d.y;
          const float v1x = acc[q][4 * jj + 2] * d.z, v1y = acc[q][4 * jj + 3] * d.w;
          st_pair(sh.a, th.r0, c, v0x, v0y);
          st_pair(sh.a, th.r0 + 8, c, v1x, v1y);
          put_pair(slabs + kDxo * slab_elems, n0, C, c, ok0, v0x, v0y);
          put_pair(slabs + kDxo * slab_elems, n1, C, c, ok1, v1x, v1y);
          cs.put(th, c, (ok0 ? v0x : 0.f) + (ok1 ? v1x : 0.f),
                 (ok0 ? v0y : 0.f) + (ok1 ? v1y : 0.f));
        }
      }
      cs.fold(th, kSBd0);
      dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // dres = dxo @ Wd0^T

      // ---- node MLP + LayerNorm backward ----
      // Row moments of dres * ns against ynh (T0), and dnoffset.
      {
        float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float4 t0v[8];
          dec_load_chunk<NQ>(t0v, t0, q, th.ctid);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = dec_col<NQ>(th, q, jj);
            const float2 sc = ldg2(a.ns + c);
            const float4 y = t0v[jj];
            const float d[4] = {acc[q][4 * jj], acc[q][4 * jj + 1],
                              acc[q][4 * jj + 2], acc[q][4 * jj + 3]};
            m[0] += d[0] * sc.x + d[1] * sc.y;
            m[1] += d[2] * sc.x + d[3] * sc.y;
            m[2] += d[0] * sc.x * y.x + d[1] * sc.y * y.y;
            m[3] += d[2] * sc.x * y.z + d[3] * sc.y * y.w;
            cs.put(th, c, (ok0 ? d[0] : 0.f) + (ok1 ? d[2] : 0.f),
                   (ok0 ? d[1] : 0.f) + (ok1 ? d[3] : 0.f));
          }
        }
        const float4 mm = rsum.sum(f4(m[0], m[1], m[2], m[3]), th);
        cs.fold(th, kSNoff);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float4 t0v[8];
          dec_load_chunk<NQ>(t0v, t0, q, th.ctid);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = dec_col<NQ>(th, q, jj);
            const float4 y = t0v[jj];
            const float d[4] = {acc[q][4 * jj], acc[q][4 * jj + 1],
                              acc[q][4 * jj + 2], acc[q][4 * jj + 3]};
            cs.put(th, c, (ok0 ? d[0] * y.x : 0.f) + (ok1 ? d[2] * y.z : 0.f),
                   (ok0 ? d[1] * y.y : 0.f) + (ok1 ? d[3] * y.w : 0.f));
          }
        }
        cs.fold(th, kSNscale);
        const float m10 = mm.x / C, m11 = mm.y / C;
        const float m20 = mm.z / C, m21 = mm.w / C;
        // dyn = rstd (dres ns - m1 - ynh m2) -> A; T0 <- dres.
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float4 t0v[8];
          dec_load_chunk<NQ>(t0v, t0, q, th.ctid);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = dec_col<NQ>(th, q, jj);
            const float2 sc = ldg2(a.ns + c);
            const float4 y = t0v[jj];
            const float d[4] = {acc[q][4 * jj], acc[q][4 * jj + 1],
                              acc[q][4 * jj + 2], acc[q][4 * jj + 3]};
            const float a0 = nst.y * (d[0] * sc.x - m10 - y.x * m20);
            const float a1 = nst.y * (d[1] * sc.y - m10 - y.y * m20);
            const float b0 = nst.w * (d[2] * sc.x - m11 - y.z * m21);
            const float b1 = nst.w * (d[3] * sc.y - m11 - y.w * m21);
            *t0.at(q, jj, th.ctid) = f4(d[0], d[1], d[2], d[3]);
            st_pair(sh.a, th.r0, c, a0, a1);
            st_pair(sh.a, th.r0 + 8, c, b0, b1);
            put_pair(slabs + kDyn * slab_elems, n0, C, c, ok0, a0, a1);
            put_pair(slabs + kDyn * slab_elems, n1, C, c, ok1, b0, b1);
            cs.put(th, c, (ok0 ? a0 : 0.f) + (ok1 ? b0 : 0.f),
                   (ok0 ? a1 : 0.f) + (ok1 ? b1 : 0.f));
          }
        }
        cs.fold(th, kSBn1);
      }
      dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // dhn = dyn @ Wn1^T
      dec_sync();
      // dxn = dhn * swish'(xn) -> A.
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 sxnv[8];
        dec_load_chunk<NQ>(sxnv, sxn, q, th.ctid);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
          const float4 d = sxnv[jj];
          const float v0x = acc[q][4 * jj] * d.x, v0y = acc[q][4 * jj + 1] * d.y;
          const float v1x = acc[q][4 * jj + 2] * d.z, v1y = acc[q][4 * jj + 3] * d.w;
          st_pair(sh.a, th.r0, c, v0x, v0y);
          st_pair(sh.a, th.r0 + 8, c, v1x, v1y);
          put_pair(slabs + kDxn * slab_elems, n0, C, c, ok0, v0x, v0y);
          put_pair(slabs + kDxn * slab_elems, n1, C, c, ok1, v1x, v1y);
          cs.put(th, c, (ok0 ? v0x : 0.f) + (ok1 ? v1x : 0.f),
                 (ok0 ? v0y : 0.f) + (ok1 ? v1y : 0.f));
        }
      }
      cs.fold(th, kSBn0);
      dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // dxn @ Wng^T
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 t0v[8];
        dec_load_chunk<NQ>(t0v, t0, q, th.ctid);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 g = t0v[jj];
          *t0.at(q, jj, th.ctid) =
              f4(g.x + acc[q][4 * jj], g.y + acc[q][4 * jj + 1],
                 g.z + acc[q][4 * jj + 2], g.w + acc[q][4 * jj + 3]);
        }
      }
      dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // dagg = dxn @ Wna^T
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float d[4] = {acc[q][4 * jj], acc[q][4 * jj + 1],
                              acc[q][4 * jj + 2], acc[q][4 * jj + 3]};
          *t1.at(q, jj, th.ctid) = f4(d[0], d[1], d[2], d[3]);
          cs.put(th, dec_col<NQ>(th, q, jj), (ok0 ? d[0] : 0.f) + (ok1 ? d[2] : 0.f),
                 (ok0 ? d[1] : 0.f) + (ok1 ? d[3] : 0.f));
        }
      }
      cs.fold(th, kSEoff, 3.f);
    } else {
      // ---- edge slots: recompute, then backward ----
#pragma unroll 1
      for (int j = 0; j < 3; ++j) {
        const int e0 = 3 * n0 + j, e1 = e0 + 24;
        const int s0 = ok0 ? __ldg(a.senders + e0) : 0;
        const int s1 = ok1 ? __ldg(a.senders + e1) : 0;
        const int edge[2] = {e0, e1}, snd[2] = {s0, s1};
        const bool ok[2] = {ok0, ok1};
        dec_sync();  // both warpgroups are done reading A
        if (kEmbed) {
          // A <- en_j, read back from its slab.
          const bf16* en = slabs + kEn * slab_elems;
          for (int i = th.ctid; i < kDecRows * W / 8; i += kDecConsumers) {
            const int r = i / (W / 8), c = (i % (W / 8)) * 8;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (r < rows && c < C) {
              v = __ldg(reinterpret_cast<const uint4*>(
                  en + ((size_t)3 * (v0 + r) + j) * C + c));
            }
            *reinterpret_cast<uint4*>(sh.a + swz(r, c)) = v;
          }
          dec_publish();
          dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // en_j @ We'
          dec_mma<NQ, 1>(acc, g_addr, kK, true, ring);   // + g @ Wr
          dec_sync();
        } else {
          dec_mma<NQ, 1>(acc, g_addr, kK, false, ring);  // gproj
        }
        // h_j -> A and its slab; swish'(x0_j) -> sx.
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = dec_col<NQ>(th, q, jj);
            float g4[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float hx = 0.f, hy = 0.f;
              g4[2 * h] = g4[2 * h + 1] = 0.f;
              if ((h == 0 ? ok0 : ok1) && c < C) {
                const int e = h == 0 ? e0 : e1;
                float2 x = kEmbed ? ldg2(a.b0 + c) : load_bf16x2(a.cnst + (size_t)e * C + c);
                const float2 s = load_bf16x2(
                    a.mesh_proj + (size_t)(h == 0 ? s0 : s1) * C + c);
                x.x += s.x;
                x.y += s.y;
                x.x += acc[q][4 * jj + 2 * h];
                x.y += acc[q][4 * jj + 2 * h + 1];
                hx = swish_of_bf16(x.x);
                hy = swish_of_bf16(x.y);
                g4[2 * h] = swish_grad_bf16(round_bf16(x.x));
                g4[2 * h + 1] = swish_grad_bf16(round_bf16(x.y));
                put_pair(slabs + kHs * slab_elems, e, C, c, true, hx, hy);
              }
              st_pair(sh.a, th.r0 + 8 * h, c, hx, hy);
            }
            *sx.at(q, jj, th.ctid) = pack4_bf16(g4[0], g4[1], g4[2], g4[3]);
          }
        }
        dec_publish();
        dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // h_j @ W1
        {
          const float4 st = dec_ln_stats<NQ>(acc, a.b1, th, rsum, C);
          // yh = LN0(.); moments of dagg * es against yh, and descale.
          float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            float4 t1v[8];
            dec_load_chunk<NQ>(t1v, t1, q, th.ctid);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int c = dec_col<NQ>(th, q, jj);
              const float2 b = ldg2(a.b1 + c), sc = ldg2(a.es + c);
              const float4 g = t1v[jj];
              const float y0 = dec_ln(st, acc[q][4 * jj] + b.x, 0);
              const float y1 = dec_ln(st, acc[q][4 * jj + 1] + b.y, 0);
              const float y2 = dec_ln(st, acc[q][4 * jj + 2] + b.x, 1);
              const float y3 = dec_ln(st, acc[q][4 * jj + 3] + b.y, 1);
              m[0] += g.x * sc.x + g.y * sc.y;
              m[1] += g.z * sc.x + g.w * sc.y;
              m[2] += g.x * sc.x * y0 + g.y * sc.y * y1;
              m[3] += g.z * sc.x * y2 + g.w * sc.y * y3;
              cs.put(th, c, (ok0 ? g.x * y0 : 0.f) + (ok1 ? g.z * y2 : 0.f),
                     (ok0 ? g.y * y1 : 0.f) + (ok1 ? g.w * y3 : 0.f));
            }
          }
          const float4 mm = rsum.sum(f4(m[0], m[1], m[2], m[3]), th);
          cs.fold(th, kSEscale);
          const float m10 = mm.x / C, m11 = mm.y / C;
          const float m20 = mm.z / C, m21 = mm.w / C;
          // dy_j = rstd (dagg es - m1 - yh m2) -> A and its slab.
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            float4 t1v[8];
            dec_load_chunk<NQ>(t1v, t1, q, th.ctid);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int c = dec_col<NQ>(th, q, jj);
              const float2 b = ldg2(a.b1 + c), sc = ldg2(a.es + c);
              const float4 g = t1v[jj];
              const float y0 = dec_ln(st, acc[q][4 * jj] + b.x, 0);
              const float y1 = dec_ln(st, acc[q][4 * jj + 1] + b.y, 0);
              const float y2 = dec_ln(st, acc[q][4 * jj + 2] + b.x, 1);
              const float y3 = dec_ln(st, acc[q][4 * jj + 3] + b.y, 1);
              const float a0 = st.y * (g.x * sc.x - m10 - y0 * m20);
              const float a1 = st.y * (g.y * sc.y - m10 - y1 * m20);
              const float b0 = st.w * (g.z * sc.x - m11 - y2 * m21);
              const float b1 = st.w * (g.w * sc.y - m11 - y3 * m21);
              st_pair(sh.a, th.r0, c, a0, a1);
              st_pair(sh.a, th.r0 + 8, c, b0, b1);
              put_pair(slabs + kDys * slab_elems, e0, C, c, ok0, a0, a1);
              put_pair(slabs + kDys * slab_elems, e1, C, c, ok1, b0, b1);
              cs.put(th, c, (ok0 ? a0 : 0.f) + (ok1 ? b0 : 0.f),
                     (ok0 ? a1 : 0.f) + (ok1 ? b1 : 0.f));
            }
          }
          cs.fold(th, kSB1);
        }
        dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // dh_j = dy_j @ W1^T
        dec_sync();
        // dx0_j = dh_j * swish'(x0_j): dgs_j, dgproj; embed mode: -> A, db0'.
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float4 twv[8];
          if (j > 0) dec_load_chunk<NQ>(twv, tw, q, th.ctid);
          float4 sxv[8];
          dec_load_chunk<NQ>(sxv, sx, q, th.ctid);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = dec_col<NQ>(th, q, jj);
            const float4 d = sxv[jj];
            const float4 v = f4(acc[q][4 * jj] * d.x, acc[q][4 * jj + 1] * d.y,
                                acc[q][4 * jj + 2] * d.z,
                                acc[q][4 * jj + 3] * d.w);
            put_pair(a.dgs, e0, C, c, ok0, v.x, v.y);
            put_pair(a.dgs, e1, C, c, ok1, v.z, v.w);
            float4 sum = v;  // dgproj += dx0_j
            if (j > 0) {
              const float4 g = twv[jj];
              sum = f4(g.x + v.x, g.y + v.y, g.z + v.z, g.w + v.w);
            }
            *tw.at(q, jj, th.ctid) = sum;
            if (kEmbed) {
              st_pair(sh.a, th.r0, c, v.x, v.y);
              st_pair(sh.a, th.r0 + 8, c, v.z, v.w);
              cs.put(th, c, (ok0 ? v.x : 0.f) + (ok1 ? v.z : 0.f),
                     (ok0 ? v.y : 0.f) + (ok1 ? v.w : 0.f));
            }
          }
        }
        if (kEmbed) {
          cs.fold(th, kSB0);
          dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // den_j = dx0_j @ We'^T
          // LN0 backward with slot j's kept yh0 and rstd.
          const float rs0 = ok0 ? a.rstd0[e0] : 0.f;
          const float rs1 = ok1 ? a.rstd0[e1] : 0.f;
          float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int c = dec_col<NQ>(th, q, jj);
              const float2 y0 = ok0 && c < C
                  ? ldg2(a.en32 + (size_t)e0 * C + c)
                  : make_float2(0.f, 0.f);
              const float2 y1 = ok1 && c < C
                  ? ldg2(a.en32 + (size_t)e1 * C + c)
                  : make_float2(0.f, 0.f);
              const float d[4] = {acc[q][4 * jj], acc[q][4 * jj + 1],
                              acc[q][4 * jj + 2], acc[q][4 * jj + 3]};
              m[0] += d[0] + d[1];
              m[1] += d[2] + d[3];
              m[2] += d[0] * y0.x + d[1] * y0.y;
              m[3] += d[2] * y1.x + d[3] * y1.y;
            }
          }
          const float4 mm = rsum.sum(f4(m[0], m[1], m[2], m[3]), th);
          const float m10 = mm.x / C, m11 = mm.y / C;
          const float m20 = mm.z / C, m21 = mm.w / C;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int c = dec_col<NQ>(th, q, jj);
              const float2 y0 = ok0 && c < C
                  ? ldg2(a.en32 + (size_t)e0 * C + c)
                  : make_float2(0.f, 0.f);
              const float2 y1 = ok1 && c < C
                  ? ldg2(a.en32 + (size_t)e1 * C + c)
                  : make_float2(0.f, 0.f);
              const float d[4] = {acc[q][4 * jj], acc[q][4 * jj + 1],
                              acc[q][4 * jj + 2], acc[q][4 * jj + 3]};
              const float a0 = rs0 * (d[0] - m10 - y0.x * m20);
              const float a1 = rs0 * (d[1] - m10 - y0.y * m20);
              const float b0 = rs1 * (d[2] - m11 - y1.x * m21);
              const float b1 = rs1 * (d[3] - m11 - y1.y * m21);
              st_pair(sh.a, th.r0, c, a0, a1);
              st_pair(sh.a, th.r0 + 8, c, b0, b1);
              put_pair(slabs + kDy0 * slab_elems, e0, C, c, ok0, a0, a1);
              put_pair(slabs + kDy0 * slab_elems, e1, C, c, ok1, b0, b1);
              cs.put(th, c, (ok0 ? a0 : 0.f) + (ok1 ? b0 : 0.f),
                     (ok0 ? a1 : 0.f) + (ok1 ? b1 : 0.f));
            }
          }
          cs.fold(th, kSEb1);
          dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // dhh_j = dy0_j @ Ew1^T
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int c = dec_col<NQ>(th, q, jj);
              float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if ((h == 0 ? ok0 : ok1) && c < C) {
                  const int e = h == 0 ? e0 : e1;
                  const bf16* f = a.cnst + (size_t)e * a.F;
#pragma unroll
                  for (int x = 0; x < 2; ++x) {
                    v[2 * h + x] = acc[q][4 * jj + 2 * h + x] *
                        swish_grad_bf16(embed_pre_ldg(f, a.F, a.ew0, a.eb0, W, c + x));
                  }
                  store_bf16x2(slabs + kDxe * slab_elems + (size_t)e * C + c, v[2 * h],
                               v[2 * h + 1]);
                }
              }
              cs.put(th, c, v[0] + v[2], v[1] + v[3]);
            }
          }
          cs.fold(th, kSEb0);
        }
      }

      // ---- dgrid = bf16(dg + bf16(dgproj) @ Wr^T) ----
      dec_sync();
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 twv[8];
        dec_load_chunk<NQ>(twv, tw, q, th.ctid);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
          const float4 g = twv[jj];
          st_pair(sh.a, th.r0, c, g.x, g.y);
          st_pair(sh.a, th.r0 + 8, c, g.z, g.w);
          put_pair(slabs + kDgp * slab_elems, n0, C, c, ok0, g.x, g.y);
          put_pair(slabs + kDgp * slab_elems, n1, C, c, ok1, g.z, g.w);
        }
      }
      dec_publish();
      dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 t0v[8];
        dec_load_chunk<NQ>(t0v, t0, q, th.ctid);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = dec_col<NQ>(th, q, jj);
          const float4 g = t0v[jj];
          put_pair(a.dgrid, n0, C, c, ok0, g.x + acc[q][4 * jj],
                   g.y + acc[q][4 * jj + 1]);
          put_pair(a.dgrid, n1, C, c, ok1, g.z + acc[q][4 * jj + 2],
                   g.w + acc[q][4 * jj + 3]);
        }
      }
    }
  }
  dec_sync();
  float* part = a.partials + (size_t)blockIdx.x * (kSums * C + NO);
  for (int i = th.ctid; i < kSums * C + NO; i += kDecConsumers) {
    part[i] = sh.sums[i];
  }
}

template <bool kEmbed, int kPass>
__global__ void __launch_bounds__(kDecThreads, 1) fused_decoder_bwd_kernel(
    const __grid_constant__ DecoderBwdMaps maps, const DecoderBwdArgs a) {
  constexpr int W = kDecWidth;
  constexpr int kSums = kEmbed ? kDecSumsEmbed : kDecSums;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DecSmem sh(smem_raw, dec_layout(W, W, kSums * W + a.NO));
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const uint32_t rank = cluster_ctarank();
  const int tiles = (a.num_rows + kDecRows - 1) / kDecRows;
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
        if (kPass == 0) {
          for (int j = 0; j < 3; ++j) {  // forward recompute
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
          pr.bwd(&maps.wd1, a.NO, W);  // cotangents
          pr.bwd(&maps.wd0, W, W);
          pr.bwd(&maps.wn1, W, W);
          pr.bwd(&maps.wng, W, W);
          pr.bwd(&maps.wna, W, W);
        } else {
          for (int j = 0; j < 3; ++j) {
            if (kEmbed) pr.fwd(&maps.we, W, W);
            pr.fwd(&maps.wr, W, W);
            pr.fwd(&maps.w1, W, W);
            pr.bwd(&maps.w1, W, W);
            if (kEmbed) {
              pr.bwd(&maps.we, W, W);
              pr.bwd(&maps.ew1, W, W);
            }
          }
          pr.bwd(&maps.wr, W, W);
        }
      }
    }
  } else {
    setmaxnreg_inc<kDecConsumerRegs>();
    decoder_bwd_consumer<kDecNQ, kEmbed, kPass>(maps, a, sh, rank, pairs,
                                                cluster, clusters);
  }
  __syncwarp();
  cluster_sync();  // no block exits while its partner may still arrive
}

// One pass of K5 over a chunk, then its column sums into `sums`.
template <bool kEmbed, int kPass>
int fused_decoder_bwd(const void* grid, const void* dout, const void* wr,
                      const void* w1, const void* wng, const void* wna,
                      const void* wn1, const void* wd0, const void* wd1,
                      const void* ew1, const void* we,
                      const DecoderBwdArgs& a, float* sums, int max_blocks,
                      void* stream) {
  if (a.num_rows <= 0) return 0;
  const int C = a.C;
  if (C % 128 || C < 128 || C > kDecWidth || a.NO % 128 || a.NO < 128 ||
      a.NO > 512 || max_blocks < kDecCluster || a.slab_rows < a.num_rows) {
    return cudaErrorInvalidValue;
  }
  // Tensor maps of the true width C: boxes past it arrive as zeros.
  DecoderBwdMaps maps;
  cudaError_t err = bf16_tile_map(&maps.grid, grid, a.num_rows, C, C, 64);
  if (err == cudaSuccess) {
    err = bf16_tile_map(&maps.dout, dout, a.num_rows, a.NO, a.NO, 64);
  }
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
  constexpr int kSums = kEmbed ? kDecSumsEmbed : kDecSums;
  const DecLayout L = dec_layout(kDecWidth, kDecWidth,
                                 kSums * kDecWidth + a.NO);
  const int tiles = (a.num_rows + kDecRows - 1) / kDecRows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  auto kernel = fused_decoder_bwd_kernel<kEmbed, kPass>;
  err = dec_launch_config(kernel, L.total, (tiles + 1) / 2, max_blocks, st,
                          cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, a);
  if (err != cudaSuccess) return err;
  const int n = kSums * C + a.NO;
  decoder_sums_reduce<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, (int)cfg.gridDim.x, n, sums);
  return cudaGetLastError();
}

}  // namespace gc

// Each translation unit builds one kernel, so that nvcc compiles the four
// in parallel: GC_K5_UNIT 0 (this file) the plain node pass, 1
// (fused_decoder_bwd_edges.cu) the plain edge pass, 2
// (fused_decoder_bwd_embed.cu) the embed node pass, 3
// (fused_decoder_bwd_embed_edges.cu) the embed edge pass. The wrapper runs
// a chunk's node pass, then its edge pass, with the same arguments.
#ifndef GC_K5_UNIT
#define GC_K5_UNIT 0
#endif
#define GC_K5_PASS (GC_K5_UNIT % 2)
#if GC_K5_UNIT == 0
#define GC_K5_ENTRY gc_fused_decoder_bwd_nodes
#elif GC_K5_UNIT == 1
#define GC_K5_ENTRY gc_fused_decoder_bwd_edges
#elif GC_K5_UNIT == 2
#define GC_K5_ENTRY gc_fused_decoder_bwd_embed_nodes
#else
#define GC_K5_ENTRY gc_fused_decoder_bwd_embed_edges
#endif

#if GC_K5_UNIT < 2
// One chunk of grid nodes of K5. grid, cnst, senders, dout, dgrid and dgs
// start at the chunk's first node (edge rows 3 v); mesh_proj is indexed by
// mesh node. Weights bf16 row-major ([C, C], wd1 [C, NO]); dout [rows, NO]
// bf16 (NO: the outputs padded to a multiple of 128); vectors f32
// zero-padded to kDecWidth. scratch: [14, slab_rows, C] bf16 with
// slab_rows >= num_rows; work: max_blocks * kDecWork * kDecWidth f32;
// partials: max_blocks * (8 C + NO) f32; sums: [8 C + NO] f32, added to
// (see the enum above for the order).
extern "C" int GC_K5_ENTRY(
    const void* grid, const void* mesh_proj, const void* cnst,
    const int* senders, const void* wr, const void* w1, const float* b1,
    const float* es, const float* eo, const void* wng, const void* wna,
    const float* bn0, const void* wn1, const float* bn1, const float* ns,
    const float* no, const void* wd0, const float* bd0, const void* wd1,
    const void* dout, void* dgrid, void* dgs, void* scratch, float* work,
    float* dg, float* dagg, float* partials, float* sums, int slab_rows,
    int num_rows, int C, int NO, int max_blocks, void* stream) {
  using gc::bf16;
  gc::DecoderBwdArgs a{};
  a.mesh_proj = static_cast<const bf16*>(mesh_proj);
  a.cnst = static_cast<const bf16*>(cnst);
  a.senders = senders;
  a.b1 = b1; a.es = es; a.eo = eo; a.bn0 = bn0; a.bn1 = bn1; a.ns = ns;
  a.no = no; a.bd0 = bd0;
  a.dgrid = static_cast<bf16*>(dgrid);
  a.dgs = static_cast<bf16*>(dgs);
  a.scratch = static_cast<bf16*>(scratch);
  a.work = work;
  a.dg = dg;
  a.dagg = dagg;
  a.partials = partials;
  a.slab_rows = slab_rows; a.num_rows = num_rows; a.C = C; a.NO = NO;
  return gc::fused_decoder_bwd<false, GC_K5_PASS>(
      grid, dout, wr, w1, wng, wna, wn1, wd0, wd1, nullptr, nullptr, a, sums,
      max_blocks, stream);
}

#else  // embed mode

// Embed mode: feat [3 rows, F] raw edge features of the chunk (in place of
// cnst), ew0 [F, kDecWidth] bf16 zero-padded; scratch: [26, slab_rows, C]
// bf16; en32: [3 slab_rows, C] f32; rstd0: [3 slab_rows] f32;
// partials: max_blocks * (11 C + NO) f32; sums: [11 C + NO] f32 (the 8
// above, then db0', deb1, deb0).
extern "C" int GC_K5_ENTRY(
    const void* grid, const void* mesh_proj, const void* feat,
    const int* senders, const void* ew0, const float* eb0, const void* ew1,
    const float* eb1, const void* we, const float* b0, const void* wr,
    const void* w1, const float* b1, const float* es, const float* eo,
    const void* wng, const void* wna, const float* bn0, const void* wn1,
    const float* bn1, const float* ns, const float* no, const void* wd0,
    const float* bd0, const void* wd1, const void* dout, void* dgrid,
    void* dgs, void* scratch, float* en32, float* rstd0, float* work,
    float* dg, float* dagg, float* partials, float* sums, int slab_rows,
    int num_rows, int C, int NO, int F, int max_blocks, void* stream) {
  using gc::bf16;
  gc::DecoderBwdArgs a{};
  a.mesh_proj = static_cast<const bf16*>(mesh_proj);
  a.cnst = static_cast<const bf16*>(feat);
  a.senders = senders;
  a.b1 = b1; a.es = es; a.eo = eo; a.bn0 = bn0; a.bn1 = bn1; a.ns = ns;
  a.no = no; a.bd0 = bd0;
  a.dgrid = static_cast<bf16*>(dgrid);
  a.dgs = static_cast<bf16*>(dgs);
  a.scratch = static_cast<bf16*>(scratch);
  a.work = work;
  a.dg = dg;
  a.dagg = dagg;
  a.partials = partials;
  a.slab_rows = slab_rows; a.num_rows = num_rows; a.C = C; a.NO = NO;
  a.ew0 = static_cast<const bf16*>(ew0);
  a.eb0 = eb0; a.eb1 = eb1; a.b0 = b0;
  a.en32 = en32;
  a.rstd0 = rstd0;
  a.F = F;
  return gc::fused_decoder_bwd<true, GC_K5_PASS>(
      grid, dout, wr, w1, wng, wna, wn1, wd0, wd1, ew1, we, a, sums,
      max_blocks, stream);
}

#endif  // GC_K5_UNIT
