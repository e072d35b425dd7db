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
// features; each slot first embeds its row (embed_rows in common.cuh) and
// takes const_j = en_j @ We' + b0', the norm conditioning folded into We',
// b0' and the LN affines by the caller. Two more 512x512 products per edge
// slot (ew1, We'); the [3G, C] embedded edges never reach device memory.
//
// What bounds it on an H100: ~10 512x512 products per grid node (FLOPs);
// the useful output is only [G, num_outputs]. Design:
//   * one block of 256 threads per tile of 32 grid nodes; the node's latent,
//     the operand of each product, the f32 product and the f32 3-edge sum
//     stay in shared memory, so nothing but the output reaches device
//     memory;
//   * the sender rows mesh_proj[snd] are gathered by index inside the kernel
//     (the TPU version materialises [3, G, C] gathered rows, 3.2 GB at
//     0.25°);
//   * gproj is recomputed for each of the 3 edge slots instead of being
//     kept: a third f32 [32, C] buffer would not fit beside the others in
//     227 KB, and a 32-node tile halves the weight traffic per node of a
//     16-node tile;
//   * products use wmma bf16 fragments with f32 accumulation (block_mm).
// Deterministic: no atomics, a fixed summation order.

#include "common.cuh"

namespace gc {

constexpr int kDecTM = 32;

// H <- bf16(swish(bf16(X + bias))) over the whole tile.
__device__ __forceinline__ void swish_rows(const float* X, int ldx, bf16* H,
                                           int ldh, int C,
                                           const float* __restrict__ bias) {
  const int c2n = C / 2;
  for (int i = threadIdx.x; i < kDecTM * c2n; i += kThreads) {
    const int r = i / c2n, c = (i % c2n) * 2;
    const float2 x = *reinterpret_cast<const float2*>(X + r * ldx + c);
    store_bf16x2(H + r * ldh + c, swish_of_bf16(x.x + bias[c]),
                 swish_of_bf16(x.y + bias[c + 1]));
  }
}

// The embed mode's extra operands (null pointers and F = 0 otherwise).
struct DecoderEmbed {
  const bf16* ew0;   // [F, C]
  const float* eb0;  // [C]
  const bf16* ew1;   // [C, C]
  const float* eb1;  // [C]
  const bf16* we;    // [C, C]
  const float* b0;   // [C]
  int F;
};

template <bool kEmbed>
__global__ void __launch_bounds__(kThreads, 1) fused_decoder_kernel(
    DecoderEmbed emb,
    const bf16* __restrict__ grid, const bf16* __restrict__ mesh_proj,
    const bf16* __restrict__ cnst, const int* __restrict__ senders,
    const bf16* __restrict__ wr, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ es,
    const float* __restrict__ eo, const bf16* __restrict__ wng,
    const bf16* __restrict__ wna, const float* __restrict__ bn0,
    const bf16* __restrict__ wn1, const float* __restrict__ bn1,
    const float* __restrict__ ns, const float* __restrict__ no,
    const bf16* __restrict__ wd0, const float* __restrict__ bd0,
    const bf16* __restrict__ wd1, const float* __restrict__ bd1,
    bf16* __restrict__ out, int num_grid, int C, int NO, int num_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = C + 8, ldx = max(C, NO) + 4, lda = C + 4;
  bf16* Gs = reinterpret_cast<bf16*>(smem);                  // [TM, ldh]
  bf16* H = Gs + kDecTM * ldh;                               // [TM, ldh]
  float* AGG = reinterpret_cast<float*>(H + kDecTM * ldh);   // [TM, lda]
  float* X = AGG + kDecTM * lda;                             // [TM, ldx]
  bf16* Wt = reinterpret_cast<bf16*>(X + kDecTM * ldx);      // [kKT, kLdW]
  int* snd = reinterpret_cast<int*>(Wt + kKT * kLdW);        // [3, TM]

  const int v0 = blockIdx.x * kDecTM;
  const int rows = min(kDecTM, num_grid - v0);
  for (int i = threadIdx.x; i < 3 * kDecTM; i += kThreads) {
    const int j = i / kDecTM, r = i % kDecTM;
    snd[i] = r < rows ? senders[(size_t)3 * (v0 + r) + j] : 0;
  }
  load_tile<kDecTM>(Gs, ldh, grid, v0, rows, C);
  for (int i = threadIdx.x; i < kDecTM * C; i += kThreads) {
    AGG[(i / C) * lda + i % C] = 0.f;
  }

  // Edge MLP + LayerNorm for each of the 3 edge slots, summed in f32.
  const int c2n = C / 2;
  for (int j = 0; j < 3; ++j) {
    if (kEmbed) {
      // X <- en_j @ We' + g @ Wr; b0' is added below.
      embed_rows<kDecTM>(H, ldh, X, ldx, Wt, cnst, emb.F,
                         [&](int r) { return 3 * (v0 + r) + j; }, rows, C,
                         emb.ew0, emb.eb0, emb.ew1, emb.eb1);
      block_mm<kDecTM>(H, ldh, emb.we, C, C, X, ldx, Wt, false);
      block_mm<kDecTM>(Gs, ldh, wr, C, C, X, ldx, Wt, true);
    } else {
      block_mm<kDecTM>(Gs, ldh, wr, C, C, X, ldx, Wt, false);
    }
    for (int i = threadIdx.x; i < kDecTM * c2n; i += kThreads) {
      const int r = i / c2n, c = (i % c2n) * 2;
      float hx = 0.f, hy = 0.f;
      if (r < rows) {
        float2 x = kEmbed ? make_float2(emb.b0[c], emb.b0[c + 1])
                          : load_bf16x2(cnst + ((size_t)3 * (v0 + r) + j) * C + c);
        const float2 s = load_bf16x2(mesh_proj + (size_t)snd[j * kDecTM + r] * C + c);
        const float2 g = *reinterpret_cast<const float2*>(X + r * ldx + c);
        x.x += s.x;
        x.y += s.y;
        x.x += g.x;
        x.y += g.y;
        hx = swish_of_bf16(x.x);
        hy = swish_of_bf16(x.y);
      }
      store_bf16x2(H + r * ldh + c, hx, hy);
    }
    block_mm<kDecTM>(H, ldh, w1, C, C, X, ldx, Wt, false);
    layer_norm_rows(X, ldx, rows, C, b1, es, eo,
                    [&](int r, int c, float y) { AGG[r * lda + c] += y; });
  }

  // Node MLP on [g, bf16(agg)] + LayerNorm + residual.
  for (int i = threadIdx.x; i < kDecTM * C; i += kThreads) {
    const int r = i / C, c = i % C;
    H[r * ldh + c] = __float2bfloat16(AGG[r * lda + c]);
  }
  block_mm<kDecTM>(Gs, ldh, wng, C, C, X, ldx, Wt, false);
  block_mm<kDecTM>(H, ldh, wna, C, C, X, ldx, Wt, true);
  swish_rows(X, ldx, H, ldh, C, bn0);
  block_mm<kDecTM>(H, ldh, wn1, C, C, X, ldx, Wt, false);
  layer_norm_rows(X, ldx, rows, C, bn1, ns, no, [&](int r, int c, float u) {
    H[r * ldh + c] =
        __float2bfloat16(__bfloat162float(Gs[r * ldh + c]) + u);
  });

  // Output MLP.
  block_mm<kDecTM>(H, ldh, wd0, C, C, X, ldx, Wt, false);
  swish_rows(X, ldx, H, ldh, C, bd0);
  block_mm<kDecTM>(H, ldh, wd1, C, NO, X, ldx, Wt, false);
  for (int i = threadIdx.x; i < rows * num_out; i += kThreads) {
    const int r = i / num_out, c = i % num_out;
    out[(size_t)(v0 + r) * num_out + c] =
        __float2bfloat16(X[r * ldx + c] + bd1[c]);
  }
}

}  // namespace gc

namespace {

template <bool kEmbed>
int launch_fused_decoder(
    gc::DecoderEmbed emb, const void* grid, const void* mesh_proj,
    const void* cnst, const int* senders, const void* wr, const void* w1,
    const float* b1, const float* es, const float* eo, const void* wng,
    const void* wna, const float* bn0, const void* wn1, const float* bn1,
    const float* ns, const float* no, const void* wd0, const float* bd0,
    const void* wd1, const float* bd1, void* out, int num_grid, int C, int NO,
    int num_out, void* stream) {
  using gc::bf16;
  if (num_grid <= 0) return 0;
  const int ldx = (C > NO ? C : NO) + 4;
  const size_t smem = sizeof(bf16) * 2 * gc::kDecTM * (C + 8) +
                      sizeof(float) * gc::kDecTM * (C + 4) +
                      sizeof(float) * gc::kDecTM * ldx +
                      sizeof(bf16) * gc::kKT * gc::kLdW +
                      sizeof(int) * 3 * gc::kDecTM;
  auto kernel = gc::fused_decoder_kernel<kEmbed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (num_grid + gc::kDecTM - 1) / gc::kDecTM;
  kernel<<<blocks, gc::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      emb, static_cast<const bf16*>(grid), static_cast<const bf16*>(mesh_proj),
      static_cast<const bf16*>(cnst), senders, static_cast<const bf16*>(wr),
      static_cast<const bf16*>(w1), b1, es, eo, static_cast<const bf16*>(wng),
      static_cast<const bf16*>(wna), bn0, static_cast<const bf16*>(wn1), bn1,
      ns, no, static_cast<const bf16*>(wd0), bd0,
      static_cast<const bf16*>(wd1), bd1, static_cast<bf16*>(out), num_grid, C,
      NO, num_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gc_fused_decoder(
    const void* grid, const void* mesh_proj, const void* cnst,
    const int* senders, const void* wr, const void* w1, const float* b1,
    const float* es, const float* eo, const void* wng, const void* wna,
    const float* bn0, const void* wn1, const float* bn1, const float* ns,
    const float* no, const void* wd0, const float* bd0, const void* wd1,
    const float* bd1, void* out, int num_grid, int C, int NO, int num_out,
    void* stream) {
  return launch_fused_decoder<false>(
      gc::DecoderEmbed{}, grid, mesh_proj, cnst, senders, wr, w1, b1, es, eo,
      wng, wna, bn0, wn1, bn1, ns, no, wd0, bd0, wd1, bd1, out, num_grid, C,
      NO, num_out, stream);
}

// Embed mode: features [3G, F] raw edge features in edge order.
extern "C" int gc_fused_decoder_embed(
    const void* grid, const void* mesh_proj, const void* features,
    const int* senders, const void* ew0, const float* eb0, const void* ew1,
    const float* eb1, const void* we, const float* b0, const void* wr,
    const void* w1, const float* b1, const float* es, const float* eo,
    const void* wng, const void* wna, const float* bn0, const void* wn1,
    const float* bn1, const float* ns, const float* no, const void* wd0,
    const float* bd0, const void* wd1, const float* bd1, void* out,
    int num_grid, int C, int NO, int num_out, int F, void* stream) {
  using gc::bf16;
  const gc::DecoderEmbed emb{static_cast<const bf16*>(ew0), eb0,
                             static_cast<const bf16*>(ew1), eb1,
                             static_cast<const bf16*>(we), b0, F};
  return launch_fused_decoder<true>(
      emb, grid, mesh_proj, features, senders, wr, w1, b1, es, eo, wng, wna,
      bn0, wn1, bn1, ns, no, wd0, bd0, wd1, bd1, out, num_grid, C, NO,
      num_out, stream);
}
