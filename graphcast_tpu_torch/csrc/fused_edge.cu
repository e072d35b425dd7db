// K1: one fused InteractionNetwork edge step, forward, for Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_edge.py::_fused_edge_kernel (driven by
// FusedEdgeStep._forward). Over receiver-sorted edges, per edge row:
//
//   x0  = e @ We + Gs[snd] + Gr[rcv] + b0     (encoder mode: x0 = e + Gs + Gr)
//         (embed mode, GenCast's grid2mesh: e is the embedding en of the
//          raw [E, F] edge features, computed in the tile: embed_rows in
//          common.cuh; We, b0 and the LN affine carry the folded norm
//          conditioning; aggregation only)
//   h   = bf16(swish(bf16(x0)))
//   y   = LN(h @ W1 + b1) * scale + offset     (LN statistics in f32)
//   e'  = bf16(e + y)                          (processor mode only)
//   agg[n] = sum over edges into n of bf16(y), in f32
//
// What bounds it on an H100: the two 512x512 products per edge row (K1 is
// FLOP-heavy: ~1 MFLOP per row against ~4 KB of edge bytes per row), then
// the gathered projection rows. Design:
//   * one block of 256 threads per tile of 64 edge rows; the tile's operand
//     (e, then h) and its f32 product live in shared memory, so the
//     first-layer output, h and y never reach device memory;
//   * the sender and receiver projections are gathered by index inside the
//     kernel (the TPU version reads a pre-gathered [E, C] array);
//   * aggregation: the rows are receiver-sorted, so each tile walks its
//     receiver runs column by column and writes each run's f32 sum once:
//     a plain store for runs inside the tile, atomicAdd for the (at most
//     two) runs that may continue into a neighbouring tile. The output
//     starts zeroed. Only those boundary runs are order-dependent in f32.
//   * products use wmma bf16 fragments with f32 accumulation (block_mm);
//     wgmma/TMA are a later step.
//   * embed mode adds a third 512x512 product per row (ew1) and reads 8
//     bytes of raw features per row instead of a 1 KB edge latent: the
//     [E, C] embedded edges never exist in device memory.

#include "common.cuh"

namespace gc {

constexpr int kEdgeTM = 64;

// The embed mode's extra operands (null pointers and F = 0 otherwise).
struct EdgeEmbed {
  const bf16* ew0;   // [F, C]
  const float* eb0;  // [C]
  const bf16* ew1;   // [C, C]
  const float* eb1;  // [C]
  int F;
};

template <bool kHasWe, bool kWriteE, bool kEmbed>
__global__ void __launch_bounds__(kThreads, 1) fused_edge_kernel(
    const bf16* __restrict__ e, const bf16* __restrict__ sproj,
    const int* __restrict__ senders, const bf16* __restrict__ rproj,
    const int* __restrict__ receivers, const bf16* __restrict__ we,
    const float* __restrict__ b0, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ scale,
    const float* __restrict__ offset, bf16* __restrict__ eout,
    float* __restrict__ agg, int num_edges, int C, EdgeEmbed emb) {
  static_assert(!kEmbed || (kHasWe && !kWriteE),
                "embed mode runs the edge matmul, aggregation only");
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + 8, ldx = C + 4;
  bf16* A = reinterpret_cast<bf16*>(smem);                 // [TM, lda]
  float* X = reinterpret_cast<float*>(A + kEdgeTM * lda);  // [TM, ldx]
  bf16* Wt = reinterpret_cast<bf16*>(X + kEdgeTM * ldx);   // [kKT, kLdW]
  int* snd = reinterpret_cast<int*>(Wt + kKT * kLdW);      // [TM]
  int* rcv = snd + kEdgeTM;                                // [TM]

  const int row0 = blockIdx.x * kEdgeTM;
  const int rows = min(kEdgeTM, num_edges - row0);
  for (int r = threadIdx.x; r < kEdgeTM; r += kThreads) {
    snd[r] = r < rows ? senders[row0 + r] : 0;
    rcv[r] = r < rows ? receivers[row0 + r] : -1;
  }
  if (kEmbed) {
    embed_rows<kEdgeTM>(A, lda, X, ldx, Wt, e, emb.F,
                        [&](int r) { return row0 + r; }, rows, C, emb.ew0,
                        emb.eb0, emb.ew1, emb.eb1);
    block_mm<kEdgeTM>(A, lda, we, C, C, X, ldx, Wt, false);
  } else if (kHasWe) {
    load_tile<kEdgeTM>(A, lda, e, row0, rows, C);
    block_mm<kEdgeTM>(A, lda, we, C, C, X, ldx, Wt, false);
  } else {
    __syncthreads();
  }

  // First-layer sum and activation: A <- bf16(swish(bf16(x0))).
  const int c2n = C / 2;
  for (int i = threadIdx.x; i < kEdgeTM * c2n; i += kThreads) {
    const int r = i / c2n, c = (i % c2n) * 2;
    float hx = 0.f, hy = 0.f;
    if (r < rows) {
      float2 x = kHasWe
          ? *reinterpret_cast<const float2*>(X + r * ldx + c)
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
      hx = swish_of_bf16(x.x);
      hy = swish_of_bf16(x.y);
    }
    store_bf16x2(A + r * lda + c, hx, hy);
  }
  block_mm<kEdgeTM>(A, lda, w1, C, C, X, ldx, Wt, false);

  // LayerNorm: e' written, X <- bf16-rounded y.
  layer_norm_rows(X, ldx, rows, C, b1, scale, offset,
                  [&](int r, int c, float yn) {
                    if (kWriteE) {
                      const size_t o = (size_t)(row0 + r) * C + c;
                      eout[o] = __float2bfloat16(__bfloat162float(e[o]) + yn);
                    }
                    X[r * ldx + c] = round_bf16(yn);
                  });

  // Segmented sum over the tile's receiver runs, one column per thread.
  for (int c = threadIdx.x; c < C; c += kThreads) {
    int r = 0;
    while (r < rows) {
      const int node = rcv[r];
      float s = 0.f;
      int r1 = r;
      do {
        s += X[r1 * ldx + c];
        ++r1;
      } while (r1 < rows && rcv[r1] == node);
      float* dst = agg + (size_t)node * C + c;
      if (r == 0 || r1 == rows) {
        atomicAdd(dst, s);
      } else {
        *dst = s;
      }
      r = r1;
    }
  }
}

template <bool kHasWe, bool kWriteE, bool kEmbed = false>
cudaError_t launch_fused_edge(const void* e, const void* sproj,
                              const int* senders, const void* rproj,
                              const int* receivers, const void* we,
                              const float* b0, const void* w1, const float* b1,
                              const float* scale, const float* offset,
                              void* eout, float* agg, int num_edges, int C,
                              cudaStream_t stream,
                              EdgeEmbed emb = EdgeEmbed{}) {
  const size_t smem = sizeof(bf16) * kEdgeTM * (C + 8) +
                      sizeof(float) * kEdgeTM * (C + 4) +
                      sizeof(bf16) * kKT * kLdW + sizeof(int) * 2 * kEdgeTM;
  auto kernel = fused_edge_kernel<kHasWe, kWriteE, kEmbed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (num_edges + kEdgeTM - 1) / kEdgeTM;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(e), static_cast<const bf16*>(sproj), senders,
      static_cast<const bf16*>(rproj), receivers,
      static_cast<const bf16*>(we), b0, static_cast<const bf16*>(w1), b1,
      scale, offset, static_cast<bf16*>(eout), agg, num_edges, C, emb);
  return cudaGetLastError();
}

}  // namespace gc

extern "C" int gc_fused_edge(const void* e, const void* sproj,
                             const int* senders, const void* rproj,
                             const int* receivers, const void* we,
                             const float* b0, const void* w1, const float* b1,
                             const float* scale, const float* offset,
                             void* eout, float* agg, int num_edges, int C,
                             int has_we, int write_e, void* stream) {
  if (num_edges <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (has_we && write_e) {
    return gc::launch_fused_edge<true, true>(e, sproj, senders, rproj,
                                             receivers, we, b0, w1, b1, scale,
                                             offset, eout, agg, num_edges, C, s);
  }
  if (has_we) {
    return gc::launch_fused_edge<true, false>(e, sproj, senders, rproj,
                                              receivers, we, b0, w1, b1, scale,
                                              offset, eout, agg, num_edges, C,
                                              s);
  }
  if (write_e) {
    return gc::launch_fused_edge<false, true>(e, sproj, senders, rproj,
                                              receivers, we, b0, w1, b1, scale,
                                              offset, eout, agg, num_edges, C,
                                              s);
  }
  return gc::launch_fused_edge<false, false>(e, sproj, senders, rproj,
                                             receivers, we, b0, w1, b1, scale,
                                             offset, eout, agg, num_edges, C, s);
}

// Embed mode: features [E, F] raw edge features; aggregation only.
extern "C" int gc_fused_edge_embed(
    const void* features, const void* ew0, const float* eb0, const void* ew1,
    const float* eb1, const void* sproj, const int* senders,
    const void* rproj, const int* receivers, const void* we, const float* b0,
    const void* w1, const float* b1, const float* scale, const float* offset,
    float* agg, int num_edges, int F, int C, void* stream) {
  if (num_edges <= 0) return 0;
  const gc::EdgeEmbed emb{static_cast<const gc::bf16*>(ew0), eb0,
                          static_cast<const gc::bf16*>(ew1), eb1, F};
  return gc::launch_fused_edge<true, false, true>(
      features, sproj, senders, rproj, receivers, we, b0, w1, b1, scale,
      offset, nullptr, agg, num_edges, C, static_cast<cudaStream_t>(stream),
      emb);
}

extern "C" const char* gc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
