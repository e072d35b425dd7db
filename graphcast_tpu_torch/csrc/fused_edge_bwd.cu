// K4: the backward of the fused InteractionNetwork edge step (K1), per-row
// pass, for Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_edge.py::_fused_edge_bwd_kernel (driven
// by FusedEdgeStep._backward), in K1's three modes: processor (We, b0, e'
// written), encoder (hoisted const, aggregation only) and embed (GenCast's
// grid2mesh: raw features, aggregation only). Per edge row it recomputes
// K1's forward and forms the row cotangents:
//
//   x0 = e @ We + Gs[snd] + Gr[rcv] + b0,  xd = bf16(x0),  h = bf16(swish(xd))
//   yh = LN0(h @ W1 + b1)                          (f32 statistics)
//   dyn = dagg[rcv] + d_e'                         (f32)
//   dy  = LN0'(dyn * scale)                        dyd = bf16(dy)
//   dx0 = (dyd @ W1^T) * swish'(xd)                dxd = bf16(dx0)
//   dGs = dxd      dGr[n] = sum over edges into n of dxd (f32)
//   de  = dxd @ We^T + d_e'   (encoder: de = dxd)
// and the column sums dscale = sum dyn * yh, doff = sum dyn, db1 = sum dy,
// db0 = sum dx0 (f32).
//
// Embed mode (pallas_edge.py:433-470) recomputes the in-tile embed, e = en =
// bf16(yh0), yh0 = LN0(hh @ Ew1 + eb1), hh = bf16(swish(xe)), xe =
// bf16(f @ Ew0 + eb0), and carries de = dxd @ We'^T (f32) back through it:
//
//   dy0 = LN0'(de)   dy0d = bf16(dy0)   dxe = (dy0d @ Ew1^T) * swish'(xe)
//
// with deb1 = sum dy0 and deb0 = sum dxe (f32). The rows en, hh, dy0d and
// bf16(dxe) go to device memory for the reductions dWe' = en^T dxd, dEw1 =
// hh^T dy0d, dEw0 = f^T bf16(dxe) and the raw-feature de = bf16(dxe) Ew0^T
// (weight_grad.cu).
//
// What bounds it on an H100: streaming the weights, as in K1: per 64-row
// tile four (encoder two, embed six) products, each reading a whole 512 KB
// weight matrix. The TPU kernel accumulates the weight gradients in f32
// output blocks across a grid that runs in order; Hopper's blocks run in
// parallel. Design (edge.cuh, as K1):
//   * a cluster of kEdgeCluster blocks of 64 rows shares every weight box
//     by TMA multicast (64 kEdgeCluster rows per weight byte from L2; the
//     wmma kernel this replaces: 32); a producer thread per block streams
//     the boxes of the tile's products through a ring of 16 boxes, two
//     consumer warpgroups split each product by columns on wgmma m64n64k16;
//   * the products by W1^T and We^T (and Ew1^T) read the same boxes of the
//     same weights K-major: the wrapper makes no transposed copy;
//   * A holds e (processor, encoder: by TMA tile load), then h, dyd, dxd
//     (embed: hh, en before, dy0d after); swish'(xd) outlives two products
//     and goes to a per-block bf16 scratch tile in device memory in the
//     accumulator's layout (embed mode also LN0's output yh0, f32); dagg
//     and d_e' are read in that layout once, dyn = dagg[rcv] + d_e' kept in
//     the same scratch (f32) between the two LayerNorm passes;
//   * this kernel writes the bf16 operands of the weight gradients (h, dyd;
//     dxd is dGs; embed mode hh, en and dy0d) to device memory, each by TMA
//     store from A while A holds it, and weight_grad.cu reduces them in a
//     split-K pass; the wrapper runs both over row chunks to bound that
//     memory;
//   * the column sums are summed over each warp's rows by a reduce-scatter
//     (edge_put8), then over the 4 warps and the tiles through decoder.cuh
//     DecColSums, in a fixed order; they leave as per-block partials that a
//     second kernel sums over the blocks in order: a rerun at the same
//     chunking is bit-equal;
//   * dGr reuses K1's receiver-run sum over dxd in A: one f32 sum per run,
//     a plain store inside the tile and boundary partials for the runs at
//     its two ends, added in tile order by edge.cuh edge_bounds;
//   * dGs stays per edge: the wrapper sums it into the sender nodes with
//     K3's sender mode (segment_sum.cu), in a fixed order, as the JAX
//     package scatters it outside its kernel, in the gather's VJP.
// No sum of K4 uses atomics: a rerun at the same chunking is bit-equal in
// every output.
// Rounding points follow the TPU kernel: dyd before dW1 and dh, dxd before
// dGs, dGr, dWe and de; dyn, dx0 and the column sums in f32.
//
// Each mode is its own kernel and translation unit: this file processor
// mode, fused_edge_bwd_encoder.cu (GC_K4_UNIT 1) encoder mode,
// fused_edge_bwd_embed.cu (GC_K4_UNIT 2) embed mode.

#include "edge.cuh"

namespace gc {

// Column sums, [kinds, C]: processor mode the first 4, encoder mode the
// first 3, embed mode all 6.
enum { kSScale, kSOff, kSB1, kSB0, kSEb1, kSEb0, kEdgeSumsEmbed };
constexpr int kEdgeSums = kSEb1;

struct EdgeBwdMaps {
  CUtensorMap e, we, w1, ew1;
  CUtensorMap hbuf, dybuf, dgs, en, hh, dy0;  // rows stored from A
};

struct EdgeBwdArgs {
  const bf16* e;           // [rows, C] (encoder: the const part); embed
                           // mode: raw features [rows, F]
  const bf16* sproj;       // [num_senders, C]
  const int* senders;      // [rows]
  const bf16* rproj;       // [num_receivers, C]
  const int* receivers;    // [rows], sorted
  const float *b0, *b1, *scale;  // [kDecWidth], zero-padded
  const bf16* deout;       // [rows, C], processor mode
  const float* dagg;       // [num_receivers, C]
  bf16 *hbuf, *dybuf, *dgs, *de;  // [rows, C]
  float* dgr;              // [num_receivers, C], zeroed
  float* bnd;              // [tiles, 2, C]: the tile-end run partials
  float* work;             // [max_blocks, kEdgeWork kDecWidth]
  float* partials;         // [blocks, kinds C]
  const bf16* ew0;         // embed mode: [F, kDecWidth], zero-padded
  const float *eb0, *eb1;  // embed mode: [kDecWidth]
  bf16 *en, *hh, *dy0, *dxe;  // embed mode: [rows, C]
  int num_rows, C, F;
};

// dyn = dagg[rcv] (+ d_e') at half `half` of chunk q of this thread: v[i][h]
// the pair of columns j = 4 half + i of row r0 + 8 h, zeros past the tile's
// rows and past C (half a chunk at a time, beside the 128 accumulators;
// the loads unconditional, as edge_gather's, the zeros applied at use).
template <int NQ, bool kProcessor>
__device__ __forceinline__ void edge_dyn(float2 (&v)[4][2],
                                         const DecThread& th, int q, int half,
                                         int C, const EdgeTile& t,
                                         const EdgeBwdArgs& a) {
  uint32_t dv[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = dec_col<NQ>(th, q, 4 * half + i);
    const int cc = c < C ? c : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[i][h] = ldg2(a.dagg + (size_t)t.rcv[h] * C + cc);
      if (kProcessor) {
        dv[i][h] = ldg_raw2(a.deout + (size_t)(t.ok[h] ? t.er[h] : 0) * C +
                            cc);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool inc = dec_col<NQ>(th, q, 4 * half + i) < C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = t.ok[h] && inc;
      if (kProcessor) {
        const float2 d = bf2(dv[i][h]);
        v[i][h].x += d.x;
        v[i][h].y += d.y;
      }
      v[i][h] = in ? v[i][h] : make_float2(0.f, 0.f);
    }
  }
}

// The consumer warpgroups' walk over the cluster's tiles (the head note).
template <bool kProcessor, bool kEmbed>
__device__ __forceinline__ void edge_bwd_consumer(const EdgeBwdMaps& maps,
                                                  const EdgeBwdArgs& a,
                                                  const EdgeSmem& sh,
                                                  uint32_t rank, int groups,
                                                  int cluster, int clusters) {
  constexpr bool kHasWe = kProcessor || kEmbed;
  constexpr int kSums = kEmbed ? kEdgeSumsEmbed : kHasWe ? kEdgeSums : kSB0;
  constexpr int NQ = kDecNQ;
  constexpr int W = NQ * 128;
  constexpr int kK = W / 64;
  const int C = a.C;
  const DecThread th(threadIdx.x);
  EdgeRing ring(sh, th);
  DecRows rsum{sh.exchange};
  const DecColSums cs{sh.colred, sh.sums, C};
  const uint32_t a_addr = smem_u32(sh.a);
  float* work = a.work + (size_t)blockIdx.x * kEdgeWork * W;
  const DecScratch<NQ> yh0s{work};  // LN0's output (embed mode)
  const DecScratch<NQ> dyns{work + 64 * W};  // dyn, between two passes
  const DecScratch16<NQ> sxs{reinterpret_cast<bf16*>(work + 128 * W)};
  bf16* const sxe = reinterpret_cast<bf16*>(work + 160 * W);  // embed mode
  for (int i = th.ctid; i < kSums * C; i += kDecConsumers) sh.sums[i] = 0.f;
  float acc[NQ][32];
  int it = 0;
  for (int grp = cluster; grp < groups; grp += clusters, ++it) {
    const EdgeTile t(grp, rank, a.num_rows, th, a.senders, a.receivers);
    if (th.ctid == 0) tma_store_wait_read();  // the last tile's dGs
    dec_sync();  // the previous tile is done with A, idx and the sums
    edge_load_idx(sh.idx, t, a.receivers, th.ctid);
    float rs0[2] = {0.f, 0.f};  // LN0's rstd of this thread's rows (embed)
    if (kEmbed) {
      // A <- hh (also to its rows); acc = hh @ Ew1; yh0 = LN0(acc + eb1)
      // to the scratch, A <- en = bf16(yh0) (also to its rows).
      edge_embed_hh<NQ>(sh.a, th.ctid, t, C, a.F, a.e, a.ew0, a.eb0, nullptr,
                        sxe);
      dec_publish();
      if (th.ctid == 0) edge_store_tile(&maps.hh, sh.a, t.row0, C);
      dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);
      if (th.ctid == 0) tma_store_wait_read();
      const float4 st = dec_ln_stats<NQ>(acc, a.eb1, th, rsum, C);
      rs0[0] = st.y;
      rs0[1] = st.w;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = dec_col<NQ>(th, q, j);
          const float2 b = ldg2(a.eb1 + c);
          float y[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            y[k] = c < C ? dec_ln(st, acc[q][4 * j + k] + (k % 2 ? b.y : b.x),
                                  k / 2)
                         : 0.f;
          }
          *yh0s.at(q, j, th.ctid) = f4(y[0], y[1], y[2], y[3]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            st_pair(sh.a, th.r0 + 8 * h, c, y[2 * h], y[2 * h + 1]);
          }
        }
      }
      dec_publish();
      if (th.ctid == 0) edge_store_tile(&maps.en, sh.a, t.row0, C);
      dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // en @ We
      if (th.ctid == 0) tma_store_wait_read();
      dec_sync();
    } else {
      if (th.ctid == 0) {
        dec_load_tile(sh.a, &maps.e, sh.a_bar, kDecWidth, t.row0);
      }
      mbar_wait(sh.a_bar, it & 1);  // A <- e (zeros past the rows and C)
      if (kProcessor) {
        dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // e @ We
        dec_sync();
      }
    }

    // Forward recompute: A <- h (also to hbuf), swish'(xd) to the scratch.
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      uint32_t sv[8][2], gv[8][2];
      edge_gather<NQ>(sv, gv, th, q, C, t, a.sproj, a.rproj);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = dec_col<NQ>(th, q, j);
        const float2 b = kHasWe ? ldg2(a.b0 + c) : make_float2(0.f, 0.f);
        float hv[4], gd[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = th.r0 + 8 * h;
          float2 x = kHasWe ? make_float2(acc[q][4 * j + 2 * h],
                                          acc[q][4 * j + 2 * h + 1])
                            : ld_pair(sh.a, r, c);
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
          hv[2 * h] = in ? swish_of_bf16(x.x) : 0.f;
          hv[2 * h + 1] = in ? swish_of_bf16(x.y) : 0.f;
          gd[2 * h] = in ? swish_grad_bf16(round_bf16(x.x)) : 0.f;
          gd[2 * h + 1] = in ? swish_grad_bf16(round_bf16(x.y)) : 0.f;
          st_pair(sh.a, r, c, hv[2 * h], hv[2 * h + 1]);
        }
        *sxs.at(q, j, th.ctid) = pack4_bf16(gd[0], gd[1], gd[2], gd[3]);
      }
    }
    dec_publish();
    if (th.ctid == 0) edge_store_tile(&maps.hbuf, sh.a, t.row0, C);
    dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // h @ W1
    if (th.ctid == 0) tma_store_wait_read();
    const float4 st = dec_ln_stats<NQ>(acc, a.b1, th, rsum, C);

    // LayerNorm backward. Row moments of dyn * scale against yh; dscale and
    // doff; dyn to the scratch for the second pass.
    float mm1[2], mm2[2];
    {
      float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2 dyn[4][2];
          edge_dyn<NQ, kProcessor>(dyn, th, q, half, C, t, a);
          float vs[8], vo[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * half + i;
            const int c = dec_col<NQ>(th, q, j);
            const float2 b = ldg2(a.b1 + c), sc = ldg2(a.scale + c);
            *dyns.at(q, j, th.ctid) = f4(dyn[i][0].x, dyn[i][0].y,
                                         dyn[i][1].x, dyn[i][1].y);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float yx = dec_ln(st, acc[q][4 * j + 2 * h] + b.x, h);
              const float yy =
                  dec_ln(st, acc[q][4 * j + 2 * h + 1] + b.y, h);
              const float dx = dyn[i][h].x * sc.x, dy = dyn[i][h].y * sc.y;
              m[h] += dx + dy;
              m[2 + h] += dx * yx + dy * yy;
            }
            vs[2 * i] = dyn[i][0].x * dec_ln(st, acc[q][4 * j] + b.x, 0) +
                        dyn[i][1].x * dec_ln(st, acc[q][4 * j + 2] + b.x, 1);
            vs[2 * i + 1] =
                dyn[i][0].y * dec_ln(st, acc[q][4 * j + 1] + b.y, 0) +
                dyn[i][1].y * dec_ln(st, acc[q][4 * j + 3] + b.y, 1);
            vo[2 * i] = dyn[i][0].x + dyn[i][1].x;
            vo[2 * i + 1] = dyn[i][0].y + dyn[i][1].y;
          }
          edge_put8<NQ>(cs, th, q, half, vs, 0);
          edge_put8<NQ>(cs, th, q, half, vo, 1);
        }
      }
      const float4 s = rsum.sum(f4(m[0], m[1], m[2], m[3]), th);
      mm1[0] = s.x / C;
      mm1[1] = s.y / C;
      mm2[0] = s.z / C;
      mm2[1] = s.w / C;
      cs.fold(th, kSScale, 1.f, 2);
    }
    // dy = rstd (dyn scale - m1 - yh m2): A <- dyd (also to dybuf); db1.
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float4 dv[8];
      dec_load_chunk<NQ>(dv, dyns, q, th.ctid);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float vb[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * half + i;
          const int c = dec_col<NQ>(th, q, j);
          const float2 b = ldg2(a.b1 + c), sc = ldg2(a.scale + c);
          const float2 dyn[2] = {make_float2(dv[j].x, dv[j].y),
                                 make_float2(dv[j].z, dv[j].w)};
          float d[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float rstd = h == 0 ? st.y : st.w;
            const bool in = t.ok[h] && c < C;
            const float yx = dec_ln(st, acc[q][4 * j + 2 * h] + b.x, h);
            const float yy = dec_ln(st, acc[q][4 * j + 2 * h + 1] + b.y, h);
            d[2 * h] =
                in ? rstd * (dyn[h].x * sc.x - mm1[h] - yx * mm2[h]) : 0.f;
            d[2 * h + 1] =
                in ? rstd * (dyn[h].y * sc.y - mm1[h] - yy * mm2[h]) : 0.f;
            st_pair(sh.a, th.r0 + 8 * h, c, d[2 * h], d[2 * h + 1]);
          }
          vb[2 * i] = d[0] + d[2];
          vb[2 * i + 1] = d[1] + d[3];
        }
        edge_put8<NQ>(cs, th, q, half, vb, 0);
      }
    }
    cs.fold(th, kSB1);  // also publishes A
    if (th.ctid == 0) edge_store_tile(&maps.dybuf, sh.a, t.row0, C);
    dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // dh = dyd @ W1^T
    if (th.ctid == 0) tma_store_wait_read();
    dec_sync();  // both warpgroups are done reading A

    // dx0 = dh swish'(xd): A <- dxd (also dGs); db0.
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float4 gd[8];
      dec_load_chunk<NQ>(gd, sxs, q, th.ctid);
      float cv[2][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = dec_col<NQ>(th, q, j);
        const float4 v = f4(acc[q][4 * j] * gd[j].x, acc[q][4 * j + 1] * gd[j].y,
                            acc[q][4 * j + 2] * gd[j].z,
                            acc[q][4 * j + 3] * gd[j].w);
        st_pair(sh.a, th.r0, c, v.x, v.y);
        st_pair(sh.a, th.r0 + 8, c, v.z, v.w);
        cv[j / 4][2 * (j % 4)] = v.x + v.z;
        cv[j / 4][2 * (j % 4) + 1] = v.y + v.w;
      }
      if (kHasWe) {
        edge_put8<NQ>(cs, th, q, 0, cv[0], 0);
        edge_put8<NQ>(cs, th, q, 1, cv[1], 0);
      }
    }
    if (kHasWe) {
      cs.fold(th, kSB0);
    } else {
      dec_publish();
    }
    if (th.ctid == 0) edge_store_tile(&maps.dgs, sh.a, t.row0, C);
    // dGr: sums of dxd over the receiver runs.
    edge_run_sums(sh.a, sh.idx, t.rows, C, a.dgr,
                  a.bnd + (size_t)(t.row0 / kEdgeRows) * 2 * C, 2 * th.ctid);

    if (kProcessor) {
      dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // dxd @ We^T
      // de = bf16(. + d_e').
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        uint32_t dv[8][2];
        edge_rows<NQ>(dv, th, q, C, t, a.deout);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = dec_col<NQ>(th, q, j);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 d = bf2(dv[j][h]);
            put_pair(a.de, t.er[h], C, c, t.ok[h],
                     acc[q][4 * j + 2 * h] + d.x,
                     acc[q][4 * j + 2 * h + 1] + d.y);
          }
        }
      }
    }
    if (kEmbed) {
      dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // de = dxd @ We'^T
      if (th.ctid == 0) tma_store_wait_read();  // dGs, before A <- dy0d
      // LN0 backward: dy0 = rstd0 (de - mean(de) - yh0 mean(de yh0)).
      float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 yv[8];
        dec_load_chunk<NQ>(yv, yh0s, q, th.ctid);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d0 = acc[q][4 * j], d1 = acc[q][4 * j + 1];
          const float d2 = acc[q][4 * j + 2], d3 = acc[q][4 * j + 3];
          m[0] += d0 + d1;
          m[1] += d2 + d3;
          m[2] += d0 * yv[j].x + d1 * yv[j].y;
          m[3] += d2 * yv[j].z + d3 * yv[j].w;
        }
      }
      // Past rsum's barrier both warpgroups are done with the product.
      const float4 s = rsum.sum(f4(m[0], m[1], m[2], m[3]), th);
      const float m10 = s.x / C, m11 = s.y / C, m20 = s.z / C,
                  m21 = s.w / C;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 yv[8];
        dec_load_chunk<NQ>(yv, yh0s, q, th.ctid);
        float cv[2][8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = dec_col<NQ>(th, q, j);
          const bool in0 = t.ok[0] && c < C, in1 = t.ok[1] && c < C;
          const float4 v = f4(
              in0 ? rs0[0] * (acc[q][4 * j] - m10 - yv[j].x * m20) : 0.f,
              in0 ? rs0[0] * (acc[q][4 * j + 1] - m10 - yv[j].y * m20) : 0.f,
              in1 ? rs0[1] * (acc[q][4 * j + 2] - m11 - yv[j].z * m21) : 0.f,
              in1 ? rs0[1] * (acc[q][4 * j + 3] - m11 - yv[j].w * m21) : 0.f);
          st_pair(sh.a, th.r0, c, v.x, v.y);
          st_pair(sh.a, th.r0 + 8, c, v.z, v.w);
          cv[j / 4][2 * (j % 4)] = v.x + v.z;
          cv[j / 4][2 * (j % 4) + 1] = v.y + v.w;
        }
        edge_put8<NQ>(cs, th, q, 0, cv[0], 0);
        edge_put8<NQ>(cs, th, q, 1, cv[1], 0);
      }
      cs.fold(th, kSEb1);
      if (th.ctid == 0) edge_store_tile(&maps.dy0, sh.a, t.row0, C);
      dec_mma<NQ, 0>(acc, a_addr, kK, false, ring);  // dhh = dy0d @ Ew1^T
      // dxe = dhh swish'(xe), swish'(xe) from the scratch.
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float4 gv[8];
        dec_load_chunk<NQ>(gv, DecScratch16<NQ>{sxe}, q, th.ctid);
        float cv[2][8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = dec_col<NQ>(th, q, j);
          const float4 v = f4(acc[q][4 * j] * gv[j].x,
                              acc[q][4 * j + 1] * gv[j].y,
                              acc[q][4 * j + 2] * gv[j].z,
                              acc[q][4 * j + 3] * gv[j].w);
          put_pair(a.dxe, t.er[0], C, c, t.ok[0], v.x, v.y);
          put_pair(a.dxe, t.er[1], C, c, t.ok[1], v.z, v.w);
          cv[j / 4][2 * (j % 4)] = v.x + v.z;
          cv[j / 4][2 * (j % 4) + 1] = v.y + v.w;
        }
        edge_put8<NQ>(cs, th, q, 0, cv[0], 0);
        edge_put8<NQ>(cs, th, q, 1, cv[1], 0);
      }
      cs.fold(th, kSEb0);
    }
  }
  if (th.ctid == 0) tma_store_wait_all();
  dec_sync();
  float* part = a.partials + (size_t)blockIdx.x * (kSums * C);
  for (int i = th.ctid; i < kSums * C; i += kDecConsumers) {
    part[i] = sh.sums[i];
  }
}

template <bool kProcessor, bool kEmbed>
__global__ void __launch_bounds__(kDecThreads, 1) fused_edge_bwd_kernel(
    const __grid_constant__ EdgeBwdMaps maps, const EdgeBwdArgs a) {
  constexpr int W = kDecWidth;
  constexpr int kSums = kEmbed ? kEdgeSumsEmbed : kEdgeSums;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const EdgeSmem sh(smem_raw, edge_layout(kSums * W, false));
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const uint32_t rank = cluster_ctarank();
  const int tiles = (a.num_rows + kEdgeRows - 1) / kEdgeRows;
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
        if (kProcessor || kEmbed) pr.fwd(&maps.we, W, W);
        pr.fwd(&maps.w1, W, W);
        pr.bwd(&maps.w1, W, W);
        if (kProcessor || kEmbed) pr.bwd(&maps.we, W, W);
        if (kEmbed) pr.bwd(&maps.ew1, W, W);
      }
    }
  } else {
    setmaxnreg_inc<kDecConsumerRegs>();
    edge_bwd_consumer<kProcessor, kEmbed>(maps, a, sh, rank, groups, cluster,
                                          clusters);
  }
  __syncwarp();
  cluster_sync();  // no block exits while a partner may still arrive
}

// One chunk of K4, then its column sums into `sums` (kinds x C, added to).
template <bool kProcessor, bool kEmbed>
int fused_edge_bwd(const void* we, const void* w1, const void* ew1,
                   const EdgeBwdArgs& a, float* sums, int max_blocks,
                   cudaStream_t stream) {
  if (a.num_rows <= 0) return 0;
  const int C = a.C;
  if (C % 128 || C < 128 || C > kDecWidth || max_blocks < kEdgeCluster) {
    return cudaErrorInvalidValue;
  }
  // Tensor maps of the true width C: boxes past it arrive as zeros.
  EdgeBwdMaps maps;
  cudaError_t err = bf16_tile_map(&maps.w1, w1, C, C, C, 64);
  maps.e = maps.we = maps.ew1 = maps.w1;
  if (!kEmbed && err == cudaSuccess) {
    err = bf16_tile_map(&maps.e, a.e, a.num_rows, C, C, 64);
  }
  if ((kProcessor || kEmbed) && err == cudaSuccess) {
    err = bf16_tile_map(&maps.we, we, C, C, C, 64);
  }
  if (kEmbed && err == cudaSuccess) {
    err = bf16_tile_map(&maps.ew1, ew1, C, C, C, 64);
  }
  // The bf16 rows the kernel stores from A, [num_rows, C] each.
  const void* rows[6] = {a.hbuf, a.dybuf, a.dgs, a.en, a.hh, a.dy0};
  CUtensorMap* rmaps[6] = {&maps.hbuf, &maps.dybuf, &maps.dgs, &maps.en,
                           &maps.hh, &maps.dy0};
  for (int i = 0; i < 6 && err == cudaSuccess; ++i) {
    *rmaps[i] = maps.w1;
    if (rows[i] != nullptr) {
      err = bf16_tile_map(rmaps[i], rows[i], a.num_rows, C, C, 64);
    }
  }
  if (err != cudaSuccess) return err;
  constexpr int kSums =
      kEmbed ? kEdgeSumsEmbed : kProcessor ? kEdgeSums : kSB0;
  const int tiles = (a.num_rows + kEdgeRows - 1) / kEdgeRows;
  int blocks = 0;
  err = edge_launch(fused_edge_bwd_kernel<kProcessor, kEmbed>,
                    edge_layout((kEmbed ? kEdgeSumsEmbed : kEdgeSums) *
                                    kDecWidth,
                                false).total,
                    tiles, max_blocks, stream, maps, a, &blocks);
  if (err != cudaSuccess) return err;
  err = edge_bounds(a.receivers, a.num_rows, C, a.bnd, a.dgr, stream);
  if (err != cudaSuccess) return err;
  const int n = kSums * C;
  decoder_sums_reduce<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a.partials, blocks, n, sums);
  return cudaGetLastError();
}

inline EdgeBwdArgs edge_bwd_args(const void* e, const void* sproj,
                                 const int* senders, const void* rproj,
                                 const int* receivers, const float* b0,
                                 const float* b1, const float* scale,
                                 const float* dagg, void* hbuf, void* dybuf,
                                 void* dgs, float* dgr, float* bnd,
                                 float* work, float* partials, int num_rows,
                                 int C) {
  EdgeBwdArgs a{};
  a.e = static_cast<const bf16*>(e);
  a.sproj = static_cast<const bf16*>(sproj);
  a.senders = senders;
  a.rproj = static_cast<const bf16*>(rproj);
  a.receivers = receivers;
  a.b0 = b0; a.b1 = b1; a.scale = scale;
  a.dagg = dagg;
  a.hbuf = static_cast<bf16*>(hbuf);
  a.dybuf = static_cast<bf16*>(dybuf);
  a.dgs = static_cast<bf16*>(dgs);
  a.dgr = dgr;
  a.bnd = bnd;
  a.work = work;
  a.partials = partials;
  a.num_rows = num_rows; a.C = C;
  return a;
}

}  // namespace gc

#ifndef GC_K4_UNIT
#define GC_K4_UNIT 0
#endif

#if GC_K4_UNIT == 1
// K4 in encoder mode (no We, aggregation only); gc_fused_edge_bwd
// dispatches here.
extern "C" int gc_fused_edge_bwd_encoder(
    const void* e, const void* sproj, const int* senders, const void* rproj,
    const int* receivers, const void* w1, const float* b1,
    const float* scale, const float* dagg, void* hbuf, void* dybuf,
    void* dgs, float* dgr, float* bnd, float* work, float* partials,
    float* sums, int num_rows, int C, int max_blocks, void* stream) {
  const gc::EdgeBwdArgs a = gc::edge_bwd_args(
      e, sproj, senders, rproj, receivers, nullptr, b1, scale, dagg, hbuf,
      dybuf, dgs, dgr, bnd, work, partials, num_rows, C);
  return gc::fused_edge_bwd<false, false>(nullptr, w1, nullptr, a, sums,
                                          max_blocks,
                                          static_cast<cudaStream_t>(stream));
}

#elif GC_K4_UNIT == 2
// One row chunk of K4 in embed mode (aggregation only). feat [rows, F] and
// the row outputs (hbuf, dybuf, dgs, en, hh, dy0, dxe) start at the chunk's
// first row; ew0 [F, kDecWidth] bf16 zero-padded, vectors f32 zero-padded
// to kDecWidth; work: max_blocks * kEdgeWork * kDecWidth f32; partials:
// max_blocks * 6 C f32; sums: [6, C] f32 (dscale, doff, db1, db0, deb1,
// deb0), added to.
extern "C" int gc_fused_edge_bwd_embed(
    const void* feat, const void* ew0, const float* eb0, const void* ew1,
    const float* eb1, const void* sproj, const int* senders,
    const void* rproj, const int* receivers, const void* we, const float* b0,
    const void* w1, const float* b1, const float* scale, const float* dagg,
    void* hbuf, void* dybuf, void* dgs, float* dgr, float* bnd, void* en,
    void* hh, void* dy0, void* dxe, float* work, float* partials,
    float* sums, int num_rows, int F, int C, int max_blocks, void* stream) {
  using gc::bf16;
  gc::EdgeBwdArgs a = gc::edge_bwd_args(
      feat, sproj, senders, rproj, receivers, b0, b1, scale, dagg, hbuf,
      dybuf, dgs, dgr, bnd, work, partials, num_rows, C);
  a.ew0 = static_cast<const bf16*>(ew0);
  a.eb0 = eb0;
  a.eb1 = eb1;
  a.en = static_cast<bf16*>(en);
  a.hh = static_cast<bf16*>(hh);
  a.dy0 = static_cast<bf16*>(dy0);
  a.dxe = static_cast<bf16*>(dxe);
  a.F = F;
  return gc::fused_edge_bwd<false, true>(we, w1, ew1, a, sums, max_blocks,
                                         static_cast<cudaStream_t>(stream));
}

#else
extern "C" int gc_fused_edge_bwd_encoder(
    const void* e, const void* sproj, const int* senders, const void* rproj,
    const int* receivers, const void* w1, const float* b1,
    const float* scale, const float* dagg, void* hbuf, void* dybuf,
    void* dgs, float* dgr, float* bnd, float* work, float* partials,
    float* sums, int num_rows, int C, int max_blocks, void* stream);

// One row chunk of K4. Row arrays (e, senders, receivers, deout, hbuf,
// dybuf, dgs, de) start at the chunk's first row; sproj, rproj, dagg and
// dgr are indexed by node; bnd: [ceil(num_rows / 64), 2, C] f32 scratch. Weights [C, C] bf16, vectors f32 zero-padded to
// kDecWidth; work: max_blocks * kEdgeWork * kDecWidth f32; partials:
// max_blocks * 4 C f32; sums: [4, C] f32 (dscale, doff, db1, db0), added
// to. processor = 0 is the encoder mode (we, b0, deout and de unused;
// three sums).
extern "C" int gc_fused_edge_bwd(
    const void* e, const void* sproj, const int* senders, const void* rproj,
    const int* receivers, const void* we, const float* b0, const void* w1,
    const float* b1, const float* scale, const void* deout,
    const float* dagg, void* hbuf, void* dybuf, void* dgs, void* de,
    float* dgr, float* bnd, float* work, float* partials, float* sums,
    int num_rows, int C, int processor, int max_blocks, void* stream) {
  if (!processor) {
    return gc_fused_edge_bwd_encoder(e, sproj, senders, rproj, receivers, w1,
                                     b1, scale, dagg, hbuf, dybuf, dgs, dgr,
                                     bnd, work, partials, sums, num_rows, C,
                                     max_blocks, stream);
  }
  gc::EdgeBwdArgs a = gc::edge_bwd_args(
      e, sproj, senders, rproj, receivers, b0, b1, scale, dagg, hbuf, dybuf,
      dgs, dgr, bnd, work, partials, num_rows, C);
  a.deout = static_cast<const gc::bf16*>(deout);
  a.de = static_cast<gc::bf16*>(de);
  return gc::fused_edge_bwd<true, false>(we, w1, nullptr, a, sums,
                                         max_blocks,
                                         static_cast<cudaStream_t>(stream));
}
#endif  // GC_K4_UNIT
