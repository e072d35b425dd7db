// K5: the backward of the fused mesh2grid decoder (K2), per-node pass, for
// Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_decoder.py::_decoder_bwd_kernel (driven
// by FusedMesh2GridDecoder._backward), plain and embed modes. Per grid node v (edge
// slots j = 0, 1, 2, rows 3v + j of the edge list) it recomputes K2's
// forward, then back-propagates the output cotangent through the output
// MLP, the node MLP + LayerNorm + residual, and each edge slot's MLP +
// LayerNorm:
//
//   dxo  = (bf16(dout) @ Wd1^T) * swish'(xo)
//   dres = bf16(dxo) @ Wd0^T                       (also the residual's dg)
//   dyn  = LN0'(dres * ns)      dxn = (bf16(dyn) @ Wn1^T) * swish'(xn)
//   dg  += bf16(dxn) @ Wng^T    dagg = bf16(dxn) @ Wna^T
//   per slot: dy_j = LN0'(dagg * es),  dx0_j = (bf16(dy_j) @ W1^T) * swish'(x0_j)
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
// dxe_j. The first forward pass embeds each slot and keeps en_j, hh_j (bf16
// rows in the scratch) and yh0_j (f32, in its own scratch; each row's rstd
// in shared memory); the second pass reads en_j back instead of embedding
// again. dWe' = en^T bf16(dx0) (dx0 is dgs), dEw1 = hh^T bf16(dy0), and dEw0
// with the raw-feature gradient from bf16(dxe) are reduced outside
// (weight_grad.cu).
//
// What bounds it on an H100: ~24 products of [nodes, 512] x [512, 512] per
// grid node (10 to recompute the forward, 14 for the cotangents), and the 7
// matrix gradients over 1M nodes (3M edge rows for dW1). Design:
//   * a tile of 16 grid nodes keeps the node latents, one bf16 operand,
//     bf16(x0 / xn) and four f32 tiles (product, ynh then dagg, dg, dgproj)
//     in shared memory: 218 KB at C = 512. 16 rows, not K2's 32, because
//     the backward needs four f32 tiles live where the forward needs two;
//   * one resident block per SM walks the tiles (grid-stride), so the nine
//     column sums stay in shared memory and reach device memory once per
//     block (atomicAdd);
//   * the bf16 operands of the matrix gradients (agg_d, hn, res, ho, dxo_d,
//     dyn_d, dxn_d, dgproj_d per node; h_j, dy_j per edge) go to a scratch
//     area in device memory, and weight_grad.cu reduces them (split-K); the
//     wrapper runs both over chunks of grid nodes, which bounds the scratch
//     at 14 bf16 rows per node of the chunk;
//   * gproj = g @ Wr is recomputed per edge slot, as in K2;
//   * dgs stays per edge: the wrapper scatters it to the mesh nodes (as the
//     JAX package does outside its kernel).
// Rounding points follow the TPU kernel: every product's operand is bf16
// (dout, dxo, dyn, dxn, dy_j, dgproj), the cotangents and sums in f32.

#include "common.cuh"

namespace gc {

constexpr int kDecBwdTM = 16;
// Column sums, [kDecSums (embed: kDecSumsEmbed), C] then dbd1 [NO].
enum { kSBd0, kSNoff, kSNscale, kSBn1, kSBn0, kSEoff, kSEscale, kSB1,
       kDecSums, kSB0 = kDecSums, kSEb1, kSEb0, kDecSumsEmbed };
// Scratch slabs of [slab_rows, C] bf16; hs, dys and the embed mode's hh,
// en, dy0 and dxe (per edge, in edge order) take 3 slabs each.
enum { kAggD, kHn, kRes, kHo, kDxo, kDyn, kDxn, kDgp, kHs = 8, kDys = 11,
       kDecSlabs = 14, kHh = 14, kEn = 17, kDy0 = 20, kDxe = 23,
       kDecSlabsEmbed = 26 };

struct DecoderBwdArgs {
  const bf16* grid;        // [rows, C], chunk
  const bf16* mesh_proj;   // [M, C]
  const bf16* cnst;        // [3 rows, C], chunk
  const int* senders;      // [3 rows], chunk
  const bf16 *wr, *wrt, *w1, *w1t, *wng, *wngt, *wna, *wnat, *wn1, *wn1t,
      *wd0, *wd0t, *wd1t;  // [C, C] and transposes; wd1t [NO, C]
  const float *b1, *es, *eo, *bn0, *bn1, *ns, *no, *bd0;  // [C]
  const bf16* dout;        // [rows, NO], chunk
  bf16* dgrid;             // [rows, C], chunk
  bf16* dgs;               // [3 rows, C], chunk
  bf16* scratch;           // [kDecSlabs, slab_rows, C]
  float* sums;             // [kDecSums (embed: kDecSumsEmbed) * C + NO]
  int slab_rows, num_rows, C, NO;
  // Embed mode (null and F = 0 otherwise); cnst holds the raw features.
  const bf16 *ew0, *ew1, *ew1t, *we, *wet;  // [F, C], [C, C] and transposes
  const float *eb0, *eb1, *b0;              // [C]
  float* en32;             // [3 slab_rows, C] f32 scratch, edge order
  int F;
};

template <bool kEmbed>
__global__ void __launch_bounds__(kThreads, 1)
    fused_decoder_bwd_kernel(const DecoderBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TM = kDecBwdTM;
  constexpr int kSums = kEmbed ? kDecSumsEmbed : kDecSums;
  const int C = a.C, NO = a.NO;
  const int ldh = max(C, NO) + 8, ldx = C + 4;
  bf16* G = reinterpret_cast<bf16*>(smem);                // [TM, ldh]
  bf16* H = G + TM * ldh;                                 // [TM, ldh]
  bf16* B = H + TM * ldh;                                 // [TM, ldh]
  float* X = reinterpret_cast<float*>(B + TM * ldh);      // [TM, ldx]
  float* P = X + TM * ldx;                                // [TM, ldx]
  float* Q = P + TM * ldx;                                // [TM, ldx]
  float* Rg = Q + TM * ldx;                               // [TM, ldx]
  float* S = Rg + TM * ldx;                               // sums
  float* RS = S + kSums * C + NO;                         // [TM]
  float* M1 = RS + TM;                                    // [TM]
  float* M2 = M1 + TM;                                    // [TM]
  float* NRS = M2 + TM;                                   // [TM]
  float* ERS = NRS + TM;                          // [3, TM] (embed) LN0 rstd
  int* snd = reinterpret_cast<int*>(ERS + (kEmbed ? 3 * TM : 0));  // [3, TM]
  bf16* Wt = reinterpret_cast<bf16*>(snd + 3 * TM);       // [kKT, kLdW]
  auto slab = [&](int k) { return a.scratch + (size_t)k * a.slab_rows * C; };

  for (int i = threadIdx.x; i < kSums * C + NO; i += kThreads) S[i] = 0.f;
  const int tiles = (a.num_rows + TM - 1) / TM;
  const int c2n = C / 2;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int v0 = tile * TM;
    const int rows = min(TM, a.num_rows - v0);
    __syncthreads();  // the previous tile is done with every buffer
    for (int i = threadIdx.x; i < 3 * TM; i += kThreads) {
      const int j = i / TM, r = i % TM;
      snd[i] = r < rows ? a.senders[(size_t)3 * (v0 + r) + j] : 0;
    }
    load_tile<TM>(G, ldh, a.grid, v0, rows, C);
    for (int i = threadIdx.x; i < TM * C; i += kThreads) {
      P[(i / C) * ldx + i % C] = 0.f;
    }

    // X <- gproj (embed: en_j @ We' + gproj; the first pass, keep = false,
    // embeds slot j and keeps en_j, hh_j, yh0_j and rstd0_j, the second
    // reads en_j back).
    auto edge_slot_x = [&](int j, bool keep) {
      if (!kEmbed) {
        block_mm<TM>(G, ldh, a.wr, C, C, X, ldx, Wt, false);
        return;
      }
      if (!keep) {
        embed_rows_keep<TM>(
            H, ldh, X, ldx, Wt, a.cnst, a.F,
            [&](int r) { return 3 * (v0 + r) + j; }, rows, C, a.ew0, a.eb0,
            a.ew1, a.eb1, ERS + j * TM,
            [&](int r, int c, float hx, float hy) {
              store_bf16x2(slab(kHh) + ((size_t)3 * (v0 + r) + j) * C + c, hx,
                           hy);
            },
            [&](int r, int c, float y) {
              const size_t o = ((size_t)3 * (v0 + r) + j) * C + c;
              a.en32[o] = y;
              slab(kEn)[o] = __float2bfloat16(y);
            });
      } else {
        const int c8n = C / 8;
        for (int i = threadIdx.x; i < TM * c8n; i += kThreads) {
          const int r = i / c8n, c = (i % c8n) * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (r < rows) {
            v = *reinterpret_cast<const uint4*>(
                slab(kEn) + ((size_t)3 * (v0 + r) + j) * C + c);
          }
          *reinterpret_cast<uint4*>(H + r * ldh + c) = v;
        }
      }
      block_mm<TM>(H, ldh, a.we, C, C, X, ldx, Wt, false);
      block_mm<TM>(G, ldh, a.wr, C, C, X, ldx, Wt, true);
    };

    // H <- h_j = bf16(swish(bf16(const_j + mesh_proj[snd_j] + gproj))),
    // (embed: b0' in place of const_j), gproj = X; also B <- bf16(x0_j) and
    // h_j to `hs` when `keep`.
    auto edge_slot_in = [&](int j, bool keep) {
      edge_slot_x(j, keep);
      for (int i = threadIdx.x; i < TM * c2n; i += kThreads) {
        const int r = i / c2n, c = (i % c2n) * 2;
        float2 x = make_float2(0.f, 0.f);
        if (r < rows) {
          x = kEmbed ? make_float2(a.b0[c], a.b0[c + 1])
                     : load_bf16x2(a.cnst + ((size_t)3 * (v0 + r) + j) * C + c);
          const float2 s =
              load_bf16x2(a.mesh_proj + (size_t)snd[j * TM + r] * C + c);
          const float2 g = *reinterpret_cast<const float2*>(X + r * ldx + c);
          x.x += s.x;
          x.y += s.y;
          x.x += g.x;
          x.y += g.y;
        }
        const float hx = r < rows ? swish_of_bf16(x.x) : 0.f;
        const float hy = r < rows ? swish_of_bf16(x.y) : 0.f;
        store_bf16x2(H + r * ldh + c, hx, hy);
        if (keep) {
          store_bf16x2(B + r * ldh + c, x.x, x.y);
          if (r < rows) {
            store_bf16x2(slab(kHs) + ((size_t)3 * (v0 + r) + j) * C + c, hx,
                         hy);
          }
        }
      }
    };

    // ---- forward recompute ----
    for (int j = 0; j < 3; ++j) {
      edge_slot_in(j, false);
      block_mm<TM>(H, ldh, a.w1, C, C, X, ldx, Wt, false);
      layer_norm_rows(X, ldx, rows, C, a.b1, a.es, a.eo,
                      [&](int r, int c, float y) { P[r * ldx + c] += y; });
    }
    for (int i = threadIdx.x; i < TM * C; i += kThreads) {
      const int r = i / C, c = i % C;
      const bf16 v = __float2bfloat16(P[r * ldx + c]);
      H[r * ldh + c] = v;
      if (r < rows) slab(kAggD)[(size_t)(v0 + r) * C + c] = v;
    }
    block_mm<TM>(G, ldh, a.wng, C, C, X, ldx, Wt, false);
    block_mm<TM>(H, ldh, a.wna, C, C, X, ldx, Wt, true);
    for (int i = threadIdx.x; i < TM * c2n; i += kThreads) {
      const int r = i / c2n, c = (i % c2n) * 2;
      const float xa = X[r * ldx + c] + a.bn0[c];
      const float xb = X[r * ldx + c + 1] + a.bn0[c + 1];
      store_bf16x2(B + r * ldh + c, xa, xb);
      const float ha = r < rows ? swish_of_bf16(xa) : 0.f;
      const float hb = r < rows ? swish_of_bf16(xb) : 0.f;
      store_bf16x2(H + r * ldh + c, ha, hb);
      if (r < rows) store_bf16x2(slab(kHn) + (size_t)(v0 + r) * C + c, ha, hb);
    }
    block_mm<TM>(H, ldh, a.wn1, C, C, X, ldx, Wt, false);
    ln_rows_normalize(X, ldx, rows, C, a.bn1, NRS);
    for (int i = threadIdx.x; i < TM * C; i += kThreads) {
      const int r = i / C, c = i % C;
      const float ynh = r < rows ? X[r * ldx + c] : 0.f;
      P[r * ldx + c] = ynh;
      const bf16 res = r < rows
          ? __float2bfloat16(__bfloat162float(G[r * ldh + c]) +
                             (ynh * a.ns[c] + a.no[c]))
          : __float2bfloat16(0.f);
      H[r * ldh + c] = res;
      if (r < rows) slab(kRes)[(size_t)(v0 + r) * C + c] = res;
    }
    block_mm<TM>(H, ldh, a.wd0, C, C, X, ldx, Wt, false);  // X = xo - bd0
    for (int i = threadIdx.x; i < rows * c2n; i += kThreads) {
      const int r = i / c2n, c = (i % c2n) * 2;
      store_bf16x2(slab(kHo) + (size_t)(v0 + r) * C + c,
                   swish_of_bf16(X[r * ldx + c] + a.bd0[c]),
                   swish_of_bf16(X[r * ldx + c + 1] + a.bd0[c + 1]));
    }

    // ---- output MLP backward ----
    const int no8 = NO / 8;
    for (int i = threadIdx.x; i < TM * no8; i += kThreads) {
      const int r = i / no8, c = (i % no8) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) {
        v = *reinterpret_cast<const uint4*>(a.dout + (size_t)(v0 + r) * NO + c);
      }
      *reinterpret_cast<uint4*>(H + r * ldh + c) = v;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < NO; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += __bfloat162float(H[r * ldh + c]);
      S[kSums * C + c] += s;
    }
    block_mm<TM>(H, ldh, a.wd1t, NO, C, Rg, ldx, Wt, false);  // dho
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float dxo = Rg[r * ldx + c] *
                          swish_grad_bf16(round_bf16(X[r * ldx + c] + a.bd0[c]));
        s += dxo;
        const bf16 d = __float2bfloat16(dxo);
        H[r * ldh + c] = d;
        slab(kDxo)[(size_t)(v0 + r) * C + c] = d;
      }
      S[kSBd0 * C + c] += s;
    }
    block_mm<TM>(H, ldh, a.wd0t, C, C, X, ldx, Wt, false);  // dres

    // ---- node MLP + LayerNorm backward ----
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s_off = 0.f, s_scale = 0.f;
      for (int r = 0; r < TM; ++r) {
        const float d = X[r * ldx + c];
        Q[r * ldx + c] = d;
        s_off += d;
        s_scale += d * P[r * ldx + c];
      }
      S[kSNoff * C + c] += s_off;
      S[kSNscale * C + c] += s_scale;
    }
    ln_bwd_moments(P, ldx, rows, C,
                   [&](int r, int c) { return X[r * ldx + c] * a.ns[c]; }, M1,
                   M2);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float dyn = NRS[r] * (X[r * ldx + c] * a.ns[c] - M1[r] -
                                    P[r * ldx + c] * M2[r]);
        s += dyn;
        const bf16 d = __float2bfloat16(dyn);
        H[r * ldh + c] = d;
        slab(kDyn)[(size_t)(v0 + r) * C + c] = d;
      }
      S[kSBn1 * C + c] += s;
    }
    block_mm<TM>(H, ldh, a.wn1t, C, C, X, ldx, Wt, false);  // dhn
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float dxn = X[r * ldx + c] *
                          swish_grad_bf16(__bfloat162float(B[r * ldh + c]));
        s += dxn;
        const bf16 d = __float2bfloat16(dxn);
        H[r * ldh + c] = d;
        slab(kDxn)[(size_t)(v0 + r) * C + c] = d;
      }
      S[kSBn0 * C + c] += s;
    }
    block_mm<TM>(H, ldh, a.wngt, C, C, X, ldx, Wt, false);
    for (int i = threadIdx.x; i < TM * C; i += kThreads) {
      const int r = i / C, c = i % C;
      Q[r * ldx + c] += X[r * ldx + c];
    }
    block_mm<TM>(H, ldh, a.wnat, C, C, P, ldx, Wt, false);  // P = dagg
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < TM; ++r) {
        s += P[r * ldx + c];
        Rg[r * ldx + c] = 0.f;
      }
      S[kSEoff * C + c] += 3.f * s;
    }

    // ---- edge slots: recompute, then backward ----
    for (int j = 0; j < 3; ++j) {
      edge_slot_in(j, true);
      block_mm<TM>(H, ldh, a.w1, C, C, X, ldx, Wt, false);
      ln_rows_normalize(X, ldx, rows, C, a.b1, RS);
      ln_bwd_moments(X, ldx, rows, C,
                     [&](int r, int c) { return P[r * ldx + c] * a.es[c]; },
                     M1, M2);
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float s_scale = 0.f, s_b1 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float yh = X[r * ldx + c], dagg = P[r * ldx + c];
          s_scale += dagg * yh;
          const float dy = RS[r] * (dagg * a.es[c] - M1[r] - yh * M2[r]);
          s_b1 += dy;
          const bf16 d = __float2bfloat16(dy);
          H[r * ldh + c] = d;
          slab(kDys)[((size_t)3 * (v0 + r) + j) * C + c] = d;
        }
        S[kSEscale * C + c] += s_scale;
        S[kSB1 * C + c] += s_b1;
      }
      block_mm<TM>(H, ldh, a.w1t, C, C, X, ldx, Wt, false);  // dh_j
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float s_b0 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float dx0 = X[r * ldx + c] *
                            swish_grad_bf16(__bfloat162float(B[r * ldh + c]));
          Rg[r * ldx + c] += dx0;
          const bf16 d = __float2bfloat16(dx0);
          a.dgs[((size_t)3 * (v0 + r) + j) * C + c] = d;
          if (kEmbed) {
            s_b0 += dx0;
            H[r * ldh + c] = d;
          }
        }
        if (kEmbed) S[kSB0 * C + c] += s_b0;
      }
      if (kEmbed) {
        block_mm<TM>(H, ldh, a.wet, C, C, X, ldx, Wt, false);  // den_j
        // LN0 backward with slot j's kept yh0 (edge rows 3 (v0 + r) + j).
        const float* yh0 = a.en32 + ((size_t)3 * v0 + j) * C;
        const float* rs0 = ERS + j * TM;
        ln_bwd_moments(yh0, 3 * C, rows, C,
                       [&](int r, int c) { return X[r * ldx + c]; }, M1, M2);
        for (int c = threadIdx.x; c < C; c += kThreads) {
          float s_eb1 = 0.f;
          for (int r = 0; r < rows; ++r) {
            const float dy0 = rs0[r] * (X[r * ldx + c] - M1[r] -
                                        yh0[(size_t)r * 3 * C + c] * M2[r]);
            s_eb1 += dy0;
            const bf16 d = __float2bfloat16(dy0);
            H[r * ldh + c] = d;
            slab(kDy0)[((size_t)3 * (v0 + r) + j) * C + c] = d;
          }
          S[kSEb1 * C + c] += s_eb1;
        }
        block_mm<TM>(H, ldh, a.ew1t, C, C, X, ldx, Wt, false);  // dhh_j
        for (int c = threadIdx.x; c < C; c += kThreads) {
          float s_eb0 = 0.f;
          for (int r = 0; r < rows; ++r) {
            const size_t e = (size_t)3 * (v0 + r) + j;
            const float xe = embed_pre_bf16(a.cnst + e * a.F, a.F, a.ew0,
                                            a.eb0, C, c);
            const float dxe = X[r * ldx + c] * swish_grad_bf16(xe);
            s_eb0 += dxe;
            slab(kDxe)[e * C + c] = __float2bfloat16(dxe);
          }
          S[kSEb0 * C + c] += s_eb0;
        }
      }
    }

    // ---- dgrid = dg + bf16(dgproj) @ Wr^T ----
    __syncthreads();
    for (int i = threadIdx.x; i < TM * C; i += kThreads) {
      const int r = i / C, c = i % C;
      const bf16 d = __float2bfloat16(Rg[r * ldx + c]);
      H[r * ldh + c] = d;
      if (r < rows) slab(kDgp)[(size_t)(v0 + r) * C + c] = d;
    }
    block_mm<TM>(H, ldh, a.wrt, C, C, X, ldx, Wt, false);
    for (int i = threadIdx.x; i < rows * C; i += kThreads) {
      const int r = i / C, c = i % C;
      a.dgrid[(size_t)(v0 + r) * C + c] =
          __float2bfloat16(Q[r * ldx + c] + X[r * ldx + c]);
    }
  }
  flush_sums(a.sums, S, kSums * C + NO);
}

template <bool kEmbed>
int launch_fused_decoder_bwd(const DecoderBwdArgs& a, void* stream) {
  if (a.num_rows <= 0) return 0;
  constexpr int TM = kDecBwdTM;
  constexpr int kSums = kEmbed ? kDecSumsEmbed : kDecSums;
  const int C = a.C, NO = a.NO;
  const int ldh = (C > NO ? C : NO) + 8;
  const size_t smem = sizeof(bf16) * 3 * TM * ldh +
                      sizeof(float) * 4 * TM * (C + 4) +
                      sizeof(float) * (kSums * C + NO + 4 * TM) +
                      sizeof(float) * (kEmbed ? 3 * TM : 0) +
                      sizeof(int) * 3 * TM + sizeof(bf16) * kKT * kLdW;
  auto kernel = fused_decoder_bwd_kernel<kEmbed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = persistent_blocks((a.num_rows + TM - 1) / TM);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace gc

// One chunk of grid nodes of K5. grid, cnst, senders, dout, dgrid and dgs
// start at the chunk's first node (edge rows 3 v); mesh_proj is indexed by
// mesh node. scratch: [14, slab_rows, C] bf16 with slab_rows >= num_rows;
// sums: [8 C + NO] f32, accumulated (see the enum above for the order).
extern "C" int gc_fused_decoder_bwd(
    const void* grid, const void* mesh_proj, const void* cnst,
    const int* senders, const void* wr, const void* wrt, const void* w1,
    const void* w1t, const float* b1, const float* es, const float* eo,
    const void* wng, const void* wngt, const void* wna, const void* wnat,
    const float* bn0, const void* wn1, const void* wn1t, const float* bn1,
    const float* ns, const float* no, const void* wd0, const void* wd0t,
    const float* bd0, const void* wd1t, const void* dout, void* dgrid,
    void* dgs, void* scratch, float* sums, int slab_rows, int num_rows, int C,
    int NO, void* stream) {
  using gc::bf16;
  auto m = [](const void* p) { return static_cast<const bf16*>(p); };
  const gc::DecoderBwdArgs a{
      m(grid), m(mesh_proj), m(cnst), senders, m(wr), m(wrt), m(w1), m(w1t),
      m(wng), m(wngt), m(wna), m(wnat), m(wn1), m(wn1t), m(wd0), m(wd0t),
      m(wd1t), b1, es, eo, bn0, bn1, ns, no, bd0, m(dout),
      static_cast<bf16*>(dgrid), static_cast<bf16*>(dgs),
      static_cast<bf16*>(scratch), sums, slab_rows, num_rows, C, NO};
  return gc::launch_fused_decoder_bwd<false>(a, stream);
}

// Embed mode: feat [3 rows, F] raw edge features of the chunk (in place of
// cnst); scratch: [26, slab_rows, C] bf16; en32: [3 slab_rows, C] f32;
// sums: [11 C + NO] f32 (the 8 above, then db0', deb1, deb0).
extern "C" int gc_fused_decoder_bwd_embed(
    const void* grid, const void* mesh_proj, const void* feat,
    const int* senders, const void* ew0, const float* eb0, const void* ew1,
    const void* ew1t, const float* eb1, const void* we, const void* wet,
    const float* b0, const void* wr, const void* wrt, const void* w1,
    const void* w1t, const float* b1, const float* es, const float* eo,
    const void* wng, const void* wngt, const void* wna, const void* wnat,
    const float* bn0, const void* wn1, const void* wn1t, const float* bn1,
    const float* ns, const float* no, const void* wd0, const void* wd0t,
    const float* bd0, const void* wd1t, const void* dout, void* dgrid,
    void* dgs, void* scratch, float* en32, float* sums, int slab_rows,
    int num_rows, int C, int NO, int F, void* stream) {
  using gc::bf16;
  auto m = [](const void* p) { return static_cast<const bf16*>(p); };
  const gc::DecoderBwdArgs a{
      m(grid), m(mesh_proj), m(feat), senders, m(wr), m(wrt), m(w1), m(w1t),
      m(wng), m(wngt), m(wna), m(wnat), m(wn1), m(wn1t), m(wd0), m(wd0t),
      m(wd1t), b1, es, eo, bn0, bn1, ns, no, bd0, m(dout),
      static_cast<bf16*>(dgrid), static_cast<bf16*>(dgs),
      static_cast<bf16*>(scratch), sums, slab_rows, num_rows, C, NO,
      m(ew0), m(ew1), m(ew1t), m(we), m(wet), eb0, eb1, b0, en32, F};
  return gc::launch_fused_decoder_bwd<true>(a, stream);
}
