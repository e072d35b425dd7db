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
// (weight_grad.cu); yh0 goes there in f32 for the LN0 backward, since a
// second f32 tile does not fit beside the others.
//
// What bounds it on an H100: three (encoder: two) 512x512 products per edge
// row, as in K1, and the weight gradients dW1 = h^T dyd and dWe = e^T dxd,
// each a [512, 512] product over hundreds of thousands of rows. The TPU
// kernel accumulates those in f32 output blocks across a grid that runs in
// order; Hopper's blocks run in parallel and a 1 MB f32 accumulator does not
// fit in shared memory. Design:
//   * this kernel writes the bf16 operands of the weight gradients (h, dyd;
//     dxd is dGs) to device memory, and weight_grad.cu reduces them in a
//     split-K pass; the wrapper runs both over row chunks to bound that
//     memory;
//   * a tile of 32 rows keeps h (then dyd, dxd), bf16(x0) and one f32
//     product in shared memory (159 KB at C = 512); one resident block per
//     SM walks the tiles (grid-stride), so the four column sums stay in
//     shared memory and reach device memory once per block (atomicAdd);
//   * the products by W1^T and We^T take transposed copies made by the
//     wrapper, so block_mm streams every weight the same way;
//   * dGr reuses K1's receiver-run sum: one f32 sum per run, a plain store
//     inside the tile and atomicAdd for the runs at its two ends;
//   * dGs stays per edge: the wrapper scatters it to the sender nodes (as
//     the JAX package scatters it outside its kernel, in the gather's VJP).
// Rounding points follow the TPU kernel: dyd before dW1 and dh, dxd before
// dGs, dGr, dWe and de; dyn, dx0 and the column sums in f32.

#include "common.cuh"

namespace gc {

constexpr int kEdgeBwdTM = 32;
// Column sums: dscale, doff, db1, db0 (processor, embed), deb1, deb0 (embed).
constexpr int kEdgeSums = 4;
constexpr int kEdgeSumsEmbed = 6;

// The embed mode's operands and extra row outputs (null pointers and F = 0
// otherwise). Row arrays start at the chunk's first row, [rows, C] unless
// noted.
struct EdgeBwdEmbed {
  const bf16* feat;   // [rows, F] raw edge features
  const bf16* ew0;    // [F, C]
  const float* eb0;   // [C]
  const bf16* ew1;    // [C, C]
  const bf16* ew1t;   // [C, C], Ew1^T
  const float* eb1;   // [C]
  bf16* en;           // bf16(yh0), dWe' operand
  float* en32;        // yh0 in f32, read back by the LN0 backward
  bf16* hh;           // dEw1 operand
  bf16* dy0;          // dEw1 operand
  bf16* dxe;          // dEw0 and raw-feature de operand
  int F;
};

template <bool kProcessor, bool kEmbed>
__global__ void __launch_bounds__(kThreads, 1) fused_edge_bwd_kernel(
    const bf16* __restrict__ e, const bf16* __restrict__ sproj,
    const int* __restrict__ senders, const bf16* __restrict__ rproj,
    const int* __restrict__ receivers, const bf16* __restrict__ we,
    const bf16* __restrict__ wet, const float* __restrict__ b0,
    const bf16* __restrict__ w1, const bf16* __restrict__ w1t,
    const float* __restrict__ b1, const float* __restrict__ scale,
    const bf16* __restrict__ deout, const float* __restrict__ dagg,
    bf16* __restrict__ hbuf, bf16* __restrict__ dybuf,
    bf16* __restrict__ dgs, bf16* __restrict__ de, float* __restrict__ dgr,
    float* __restrict__ sums, int num_rows, int C, EdgeBwdEmbed emb) {
  static_assert(!(kProcessor && kEmbed), "embed mode writes no e'");
  constexpr bool kHasWe = kProcessor || kEmbed;
  constexpr int kSums = kEmbed ? kEdgeSumsEmbed : kEdgeSums;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TM = kEdgeBwdTM;
  const int ldh = C + 8, ldx = C + 4;
  bf16* H = reinterpret_cast<bf16*>(smem);                // [TM, ldh]
  bf16* XD = H + TM * ldh;                                // [TM, ldh]
  float* X = reinterpret_cast<float*>(XD + TM * ldh);     // [TM, ldx]
  float* S = X + TM * ldx;                                // [kSums, C]
  float* RS = S + kSums * C;                              // [TM]
  float* M1 = RS + TM;                                    // [TM]
  float* M2 = M1 + TM;                                    // [TM]
  float* ERS = M2 + TM;                                   // [TM] LN0 rstd
  int* snd = reinterpret_cast<int*>(ERS + TM);            // [TM]
  int* rcv = snd + TM;                                    // [TM]
  bf16* Wt = reinterpret_cast<bf16*>(rcv + TM);           // [kKT, kLdW]

  for (int i = threadIdx.x; i < kSums * C; i += kThreads) S[i] = 0.f;
  const int tiles = (num_rows + TM - 1) / TM;
  const int c2n = C / 2;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * TM;
    const int rows = min(TM, num_rows - row0);
    __syncthreads();  // the previous tile is done with snd/rcv/H
    for (int r = threadIdx.x; r < TM; r += kThreads) {
      snd[r] = r < rows ? senders[row0 + r] : 0;
      rcv[r] = r < rows ? receivers[row0 + r] : -1;
    }
    if (kEmbed) {
      embed_rows_keep<TM>(
          H, ldh, X, ldx, Wt, emb.feat, emb.F, [&](int r) { return row0 + r; },
          rows, C, emb.ew0, emb.eb0, emb.ew1, emb.eb1, ERS,
          [&](int r, int c, float hx, float hy) {
            store_bf16x2(emb.hh + (size_t)(row0 + r) * C + c, hx, hy);
          },
          [&](int r, int c, float y) {
            const size_t o = (size_t)(row0 + r) * C + c;
            emb.en32[o] = y;
            emb.en[o] = __float2bfloat16(y);
          });
      block_mm<TM>(H, ldh, we, C, C, X, ldx, Wt, false);
    } else if (kProcessor) {
      load_tile<TM>(H, ldh, e, row0, rows, C);
      block_mm<TM>(H, ldh, we, C, C, X, ldx, Wt, false);
    } else {
      __syncthreads();
    }

    // Forward recompute: XD <- bf16(x0), H <- h (also to hbuf).
    for (int i = threadIdx.x; i < TM * c2n; i += kThreads) {
      const int r = i / c2n, c = (i % c2n) * 2;
      float2 x = make_float2(0.f, 0.f);
      if (r < rows) {
        x = kHasWe ? *reinterpret_cast<const float2*>(X + r * ldx + c)
                   : load_bf16x2(e + (size_t)(row0 + r) * C + c);
        const float2 s = load_bf16x2(sproj + (size_t)snd[r] * C + c);
        const float2 g = load_bf16x2(rproj + (size_t)rcv[r] * C + c);
        x.x += s.x;
        x.y += s.y;
        x.x += g.x;
        x.y += g.y;
        if (kHasWe) {
          x.x += b0[c];
          x.y += b0[c + 1];
        }
      }
      store_bf16x2(XD + r * ldh + c, x.x, x.y);
      const float hx = r < rows ? swish_of_bf16(x.x) : 0.f;
      const float hy = r < rows ? swish_of_bf16(x.y) : 0.f;
      store_bf16x2(H + r * ldh + c, hx, hy);
      if (r < rows) store_bf16x2(hbuf + (size_t)(row0 + r) * C + c, hx, hy);
    }
    block_mm<TM>(H, ldh, w1, C, C, X, ldx, Wt, false);

    // LayerNorm backward: X <- yh, then dy per row; dyd to H and dybuf.
    auto dyn_of = [&](int r, int c) {
      float d = dagg[(size_t)rcv[r] * C + c];
      if (kProcessor) d += __bfloat162float(deout[(size_t)(row0 + r) * C + c]);
      return d;
    };
    ln_rows_normalize(X, ldx, rows, C, b1, RS);
    ln_bwd_moments(X, ldx, rows, C,
                   [&](int r, int c) { return dyn_of(r, c) * scale[c]; }, M1,
                   M2);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s_scale = 0.f, s_off = 0.f, s_b1 = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float yh = X[r * ldx + c];
        const float dyn = dyn_of(r, c);
        s_scale += dyn * yh;
        s_off += dyn;
        const float dy = RS[r] * (dyn * scale[c] - M1[r] - yh * M2[r]);
        s_b1 += dy;
        const bf16 dyd = __float2bfloat16(dy);
        H[r * ldh + c] = dyd;
        dybuf[(size_t)(row0 + r) * C + c] = dyd;
      }
      S[0 * C + c] += s_scale;
      S[1 * C + c] += s_off;
      S[2 * C + c] += s_b1;
    }
    block_mm<TM>(H, ldh, w1t, C, C, X, ldx, Wt, false);  // dh

    // dx0 = dh * swish'(xd); H <- dxd (also dGs); db0; dGr over receiver runs.
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s_b0 = 0.f;
      int r = 0;
      while (r < rows) {
        const int node = rcv[r];
        float run = 0.f;
        int r1 = r;
        do {
          const float dx0 = X[r1 * ldx + c] *
                            swish_grad_bf16(__bfloat162float(XD[r1 * ldh + c]));
          s_b0 += dx0;
          const bf16 dxd = __float2bfloat16(dx0);
          H[r1 * ldh + c] = dxd;
          dgs[(size_t)(row0 + r1) * C + c] = dxd;
          run += __bfloat162float(dxd);
          ++r1;
        } while (r1 < rows && rcv[r1] == node);
        float* dst = dgr + (size_t)node * C + c;
        if (r == 0 || r1 == rows) {
          atomicAdd(dst, run);
        } else {
          *dst = run;
        }
        r = r1;
      }
      if (kHasWe) S[3 * C + c] += s_b0;
    }
    if (kProcessor) {
      block_mm<TM>(H, ldh, wet, C, C, X, ldx, Wt, false);  // dxd @ We^T
      for (int i = threadIdx.x; i < rows * c2n; i += kThreads) {
        const int r = i / c2n, c = (i % c2n) * 2;
        const size_t o = (size_t)(row0 + r) * C + c;
        const float2 d = load_bf16x2(deout + o);
        store_bf16x2(de + o, X[r * ldx + c] + d.x, X[r * ldx + c + 1] + d.y);
      }
    }
    if (kEmbed) {
      block_mm<TM>(H, ldh, wet, C, C, X, ldx, Wt, false);  // de, f32
      // LN0 backward: dy0 = rstd0 * (de - mean(de) - yh0 * mean(de * yh0)).
      const float* yh0 = emb.en32 + (size_t)row0 * C;
      ln_bwd_moments(yh0, C, rows, C,
                     [&](int r, int c) { return X[r * ldx + c]; }, M1, M2);
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float s_eb1 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float dy0 = ERS[r] * (X[r * ldx + c] - M1[r] -
                                      yh0[(size_t)r * C + c] * M2[r]);
          s_eb1 += dy0;
          const bf16 d = __float2bfloat16(dy0);
          H[r * ldh + c] = d;
          emb.dy0[(size_t)(row0 + r) * C + c] = d;
        }
        S[4 * C + c] += s_eb1;
      }
      block_mm<TM>(H, ldh, emb.ew1t, C, C, X, ldx, Wt, false);  // dhh
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float s_eb0 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float xe = embed_pre_bf16(
              emb.feat + (size_t)(row0 + r) * emb.F, emb.F, emb.ew0, emb.eb0,
              C, c);
          const float dxe = X[r * ldx + c] * swish_grad_bf16(xe);
          s_eb0 += dxe;
          emb.dxe[(size_t)(row0 + r) * C + c] = __float2bfloat16(dxe);
        }
        S[5 * C + c] += s_eb0;
      }
    }
  }
  flush_sums(sums, S, (kHasWe ? kSums : 3) * C);
}

template <bool kProcessor, bool kEmbed = false>
cudaError_t launch_fused_edge_bwd(
    const void* e, const void* sproj, const int* senders, const void* rproj,
    const int* receivers, const void* we, const void* wet, const float* b0,
    const void* w1, const void* w1t, const float* b1, const float* scale,
    const void* deout, const float* dagg, void* hbuf, void* dybuf, void* dgs,
    void* de, float* dgr, float* sums, int num_rows, int C,
    cudaStream_t stream, EdgeBwdEmbed emb = EdgeBwdEmbed{}) {
  constexpr int TM = kEdgeBwdTM;
  constexpr int kSums = kEmbed ? kEdgeSumsEmbed : kEdgeSums;
  const size_t smem = sizeof(bf16) * 2 * TM * (C + 8) +
                      sizeof(float) * TM * (C + 4) +
                      sizeof(float) * (kSums * C + 4 * TM) +
                      sizeof(int) * 2 * TM + sizeof(bf16) * kKT * kLdW;
  auto kernel = fused_edge_bwd_kernel<kProcessor, kEmbed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = persistent_blocks((num_rows + TM - 1) / TM);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(e), static_cast<const bf16*>(sproj), senders,
      static_cast<const bf16*>(rproj), receivers,
      static_cast<const bf16*>(we), static_cast<const bf16*>(wet), b0,
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w1t), b1, scale,
      static_cast<const bf16*>(deout), dagg, static_cast<bf16*>(hbuf),
      static_cast<bf16*>(dybuf), static_cast<bf16*>(dgs),
      static_cast<bf16*>(de), dgr, sums, num_rows, C, emb);
  return cudaGetLastError();
}

}  // namespace gc

// One row chunk of K4. Row arrays (e, senders, receivers, deout, hbuf, dybuf,
// dgs, de) start at the chunk's first row; sproj, rproj, dagg and dgr are
// indexed by node. sums: [4, C] f32 (dscale, doff, db1, db0), accumulated.
// processor = 0 is the encoder mode (we, wet, b0, deout and de unused).
extern "C" int gc_fused_edge_bwd(
    const void* e, const void* sproj, const int* senders, const void* rproj,
    const int* receivers, const void* we, const void* wet, const float* b0,
    const void* w1, const void* w1t, const float* b1, const float* scale,
    const void* deout, const float* dagg, void* hbuf, void* dybuf, void* dgs,
    void* de, float* dgr, float* sums, int num_rows, int C, int processor,
    void* stream) {
  if (num_rows <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (processor) {
    return gc::launch_fused_edge_bwd<true>(
        e, sproj, senders, rproj, receivers, we, wet, b0, w1, w1t, b1, scale,
        deout, dagg, hbuf, dybuf, dgs, de, dgr, sums, num_rows, C, s);
  }
  return gc::launch_fused_edge_bwd<false>(
      e, sproj, senders, rproj, receivers, we, wet, b0, w1, w1t, b1, scale,
      deout, dagg, hbuf, dybuf, dgs, de, dgr, sums, num_rows, C, s);
}

// One row chunk of K4 in embed mode (aggregation only). feat [rows, F] and
// the row outputs (hbuf, dybuf, dgs, en, en32, hh, dy0, dxe) start at the
// chunk's first row; sums: [6, C] f32 (dscale, doff, db1, db0, deb1, deb0),
// accumulated.
extern "C" int gc_fused_edge_bwd_embed(
    const void* feat, const void* ew0, const float* eb0, const void* ew1,
    const void* ew1t, const float* eb1, const void* sproj, const int* senders,
    const void* rproj, const int* receivers, const void* we, const void* wet,
    const float* b0, const void* w1, const void* w1t, const float* b1,
    const float* scale, const float* dagg, void* hbuf, void* dybuf,
    void* dgs, float* dgr, float* sums, void* en, float* en32, void* hh,
    void* dy0, void* dxe, int num_rows, int F, int C, void* stream) {
  using gc::bf16;
  if (num_rows <= 0) return 0;
  const gc::EdgeBwdEmbed emb{
      static_cast<const bf16*>(feat), static_cast<const bf16*>(ew0), eb0,
      static_cast<const bf16*>(ew1), static_cast<const bf16*>(ew1t), eb1,
      static_cast<bf16*>(en), en32, static_cast<bf16*>(hh),
      static_cast<bf16*>(dy0), static_cast<bf16*>(dxe), F};
  return gc::launch_fused_edge_bwd<false, true>(
      nullptr, sproj, senders, rproj, receivers, we, wet, b0, w1, w1t, b1,
      scale, nullptr, dagg, hbuf, dybuf, dgs, nullptr, dgr, sums, num_rows, C,
      static_cast<cudaStream_t>(stream), emb);
}
