// K5: the backward of the fused mesh2grid decoder (K2), per-node pass, for
// Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_decoder.py::_decoder_bwd_kernel (driven
// by FusedMesh2GridDecoder._backward), plain mode. Per grid node v (edge
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
// Column sums, [kDecSums, C] then dbd1 [NO].
enum { kSBd0, kSNoff, kSNscale, kSBn1, kSBn0, kSEoff, kSEscale, kSB1,
       kDecSums };
// Scratch slabs of [slab_rows, C] bf16; hs and dys take 3 slabs each.
enum { kAggD, kHn, kRes, kHo, kDxo, kDyn, kDxn, kDgp, kHs = 8, kDys = 11,
       kDecSlabs = 14 };

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
  float* sums;             // [kDecSums * C + NO]
  int slab_rows, num_rows, C, NO;
};

__global__ void __launch_bounds__(kThreads, 1)
    fused_decoder_bwd_kernel(const DecoderBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TM = kDecBwdTM;
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
  float* RS = S + kDecSums * C + NO;                      // [TM]
  float* M1 = RS + TM;                                    // [TM]
  float* M2 = M1 + TM;                                    // [TM]
  float* NRS = M2 + TM;                                   // [TM]
  int* snd = reinterpret_cast<int*>(NRS + TM);            // [3, TM]
  bf16* Wt = reinterpret_cast<bf16*>(snd + 3 * TM);       // [kKT, kLdW]
  auto slab = [&](int k) { return a.scratch + (size_t)k * a.slab_rows * C; };

  for (int i = threadIdx.x; i < kDecSums * C + NO; i += kThreads) S[i] = 0.f;
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

    // H <- h_j = bf16(swish(bf16(const_j + mesh_proj[snd_j] + gproj))),
    // gproj = X; also B <- bf16(x0_j) and h_j to `hs` when `keep`.
    auto edge_slot_in = [&](int j, bool keep) {
      for (int i = threadIdx.x; i < TM * c2n; i += kThreads) {
        const int r = i / c2n, c = (i % c2n) * 2;
        float2 x = make_float2(0.f, 0.f);
        if (r < rows) {
          x = load_bf16x2(a.cnst + ((size_t)3 * (v0 + r) + j) * C + c);
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
      block_mm<TM>(G, ldh, a.wr, C, C, X, ldx, Wt, false);
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
      S[kDecSums * C + c] += s;
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
      block_mm<TM>(G, ldh, a.wr, C, C, X, ldx, Wt, false);
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
        for (int r = 0; r < rows; ++r) {
          const float dx0 = X[r * ldx + c] *
                            swish_grad_bf16(__bfloat162float(B[r * ldh + c]));
          Rg[r * ldx + c] += dx0;
          a.dgs[((size_t)3 * (v0 + r) + j) * C + c] = __float2bfloat16(dx0);
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
  flush_sums(a.sums, S, kDecSums * C + NO);
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
  if (num_rows <= 0) return 0;
  auto m = [](const void* p) { return static_cast<const bf16*>(p); };
  const gc::DecoderBwdArgs a{
      m(grid), m(mesh_proj), m(cnst), senders, m(wr), m(wrt), m(w1), m(w1t),
      m(wng), m(wngt), m(wna), m(wnat), m(wn1), m(wn1t), m(wd0), m(wd0t),
      m(wd1t), b1, es, eo, bn0, bn1, ns, no, bd0, m(dout),
      static_cast<bf16*>(dgrid), static_cast<bf16*>(dgs),
      static_cast<bf16*>(scratch), sums, slab_rows, num_rows, C, NO};
  constexpr int TM = gc::kDecBwdTM;
  const int ldh = (C > NO ? C : NO) + 8;
  const size_t smem = sizeof(bf16) * 3 * TM * ldh +
                      sizeof(float) * 4 * TM * (C + 4) +
                      sizeof(float) * (gc::kDecSums * C + NO + 4 * TM) +
                      sizeof(int) * 3 * TM + sizeof(bf16) * gc::kKT * gc::kLdW;
  cudaError_t err = cudaFuncSetAttribute(
      gc::fused_decoder_bwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = gc::persistent_blocks((num_rows + TM - 1) / TM);
  gc::fused_decoder_bwd_kernel<<<blocks, gc::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
