// K1p: the pipelined fused InteractionNetwork edge step, forward, for
// Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_edge.py::_fused_edge_pipelined_kernel
// (FusedEdgeStep(pipelined=True), or GC_PIPELINED_EDGE=1). It computes K1's
// function (fused_edge.cu) in K1's three modes, with K1's rounding points:
// x0 rounded to bf16 before swish, f32 LayerNorm statistics, y rounded to
// bf16 before the receiver sum, f32 run sums.
//
// The TPU kernel's grid step g runs chunk g-1's tail (swish, w1, LayerNorm,
// residual, aggregation) and chunk g's head (the first factored linear),
// which share no data, so that one's matrix work overlaps the other's
// vector work. What K1 serialises on this card is memory behind compute:
// it loads a tile's edge rows, gathers its sender and receiver projection
// rows by index with plain loads, and stages each weight tile
// synchronously, and the tensor cores wait on each of them. Design:
//   * a persistent kernel: one 256-thread block per SM walks a contiguous
//     range of 32-row tiles in order;
//   * while the block runs tile g's tail (the W1 product, LayerNorm, e' and
//     the run sums), warps 4-7 have cp.async copies of tile g+1's e rows
//     and of its gathered sproj/rproj rows in flight into a staging area;
//     tile g+1's head (the We product, x0 = . + s + r + b0 and its swish,
//     carried to the tail in bf16 as the TPU kernel carries x0 in the
//     activation dtype) starts as soon as those rows have landed;
//   * both products stream their weights through a 2-deep ring of
//     [32, 256] tiles by cp.async, started and waited on by warps 0-3 only
//     (so their commit groups never wait on the prefetch of warps 4-7): the
//     tensor cores work on one weight tile while the next is in flight.
//     256 columns a pass give each warp 8 products between two barriers:
//     on the card the number of barriers per row, more than the depth of
//     the ring, set the products' time (PERF.md);
//   * the vector work runs 8 columns a thread (16-byte shared loads), the
//     LayerNorms hold each lane's columns, bias, scale and offset in
//     registers, and e' = e + y is written in a pass of 16-byte loads, all
//     of a thread's started before the first is used: K1 reads its operands
//     one or two elements at a time, each load waiting on the one before;
//   * the products use wmma bf16 fragments with f32 accumulation, K in
//     order; K1 (wgmma over 64-deep weight boxes) sums its products in
//     another order, so x0, y and e' agree with K1's up to f32 rounding;
//     the run sums are K1's (atomicAdd only for a tile's first and last
//     run) on 32-row tiles;
//   * embed mode (GenCast's grid2mesh) embeds the tile's raw features in
//     its head (the F-deep layer on the CUDA cores, then the ew1 product and
//     the parameter-free LayerNorm) before the We product; its 8 bytes of
//     raw features a row are read with plain loads.
// Shared memory at C = 512: X f32 [32, 516] 66 KB, the carry A [32, 520]
// 33 KB, the staged e, s and r rows 99 KB (no e in embed mode), the
// weight ring 33 KB: 232,320 of the 232,448 bytes a block may have. Widths
// are multiples of 256 (256, 512); the wrapper refuses others.
// What bounds it on an H100: the two (embed mode: three) 512 x 512 products
// per edge row, as K1; the 32-row tile reads each weight matrix from L2
// twice as often per row as K1's 64-row tile does.

#include <mma.h>

#include "common.cuh"

namespace gc {
namespace {

constexpr int kPipeTM = 32;      // edge rows per tile
constexpr int kPipeNC = 256;     // output columns per product pass
constexpr int kPipeKT = 32;      // K rows per weight-ring tile
constexpr int kPipeStages = 2;   // weight-ring depth
constexpr int kPipeLdW = kPipeNC + 8;        // padded weight-tile row
constexpr int kHalfThreads = kThreads / 2;   // warps 0-3 | warps 4-7
// e' loads a thread keeps in flight: 8 columns each, all of a tile at C 512.
constexpr int kEdgeLoads = kPipeTM * 512 / 8 / kThreads;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// X[0:TM, 0:N] = A[0:TM, 0:K] @ W[0:K, 0:N] (A shared bf16, leading dim
// lda; X shared f32, leading dim ldx) in wmma bf16 16x16x16 fragments with
// f32 accumulation, W streamed through `ring` (kPipeStages tiles of
// [kPipeKT, kPipeNC], leading dim kPipeLdW): the (column pass, K tile)
// pairs run as one sequence, and tile t + kPipeStages - 1 is copied while
// tile t is multiplied. Only warps 0-3 start and wait on these copies. Each
// output is summed in K order. Every thread of the block calls it; it
// begins and ends with a barrier.
template <int TM>
__device__ void block_mm_pipe(const bf16* A, int lda,
                              const bf16* __restrict__ W, int K, int N,
                              float* X, int ldx, bf16* ring) {
  using namespace nvcuda;
  constexpr int kWR = TM / 16;            // warps along rows
  constexpr int kWC = kWarps / kWR;       // warps along columns
  constexpr int kFN = kPipeNC / 16 / kWC;  // fragments per warp per pass
  static_assert(kWR * kWC == kWarps && kFN >= 1, "tile shape");
  const int warp = threadIdx.x / 32;
  const int wr = warp / kWC, wc = warp % kWC;
  const bool copier = threadIdx.x < kHalfThreads;
  const int nk = K / kPipeKT;
  const int total = (N / kPipeNC) * nk;
  auto fetch = [&](int t) {
    if (!copier) return;
    if (t < total) {
      const int n0 = (t / nk) * kPipeNC, k0 = (t % nk) * kPipeKT;
      bf16* dst = ring + (t % kPipeStages) * (kPipeKT * kPipeLdW);
      for (int i = threadIdx.x; i < kPipeKT * kPipeNC / 8;
           i += kHalfThreads) {
        const int r = i / (kPipeNC / 8), c = (i % (kPipeNC / 8)) * 8;
        cp_async16(dst + r * kPipeLdW + c,
                   W + (size_t)(k0 + r) * N + n0 + c);
      }
    }
    cp_async_commit();  // empty past the end: keeps the group count even
  };
  __syncthreads();
  for (int t = 0; t < kPipeStages - 1; ++t) fetch(t);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFN];
  for (int t = 0; t < total; ++t) {
    if (copier) cp_async_wait<kPipeStages - 2>();  // tile t has landed
    __syncthreads();  // ... for every thread; slot (t - 1) is free
    fetch(t + kPipeStages - 1);
    const int n0 = (t / nk) * kPipeNC, k0 = (t % nk) * kPipeKT;
    if (k0 == 0) {
#pragma unroll
      for (int f = 0; f < kFN; ++f) wmma::fill_fragment(acc[f], 0.0f);
    }
    const bf16* wt = ring + (t % kPipeStages) * (kPipeKT * kPipeLdW);
#pragma unroll
    for (int kk = 0; kk < kPipeKT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + wr * 16 * lda + k0 + kk, lda);
#pragma unroll
      for (int f = 0; f < kFN; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wt + kk * kPipeLdW + (wc * kFN + f) * 16,
                               kPipeLdW);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    if (k0 + kPipeKT == K) {
      float* xblk = X + wr * 16 * ldx + n0 + wc * kFN * 16;
#pragma unroll
      for (int f = 0; f < kFN; ++f) {
        wmma::store_matrix_sync(xblk + f * 16, acc[f], ldx,
                                wmma::mem_row_major);
      }
    }
  }
  if (copier) cp_async_wait<0>();
  __syncthreads();
}

// LayerNorm of the first `rows` rows of X (+bias) over C <= 512 columns (a
// multiple of 32), one warp per row, statistics in f32 (a warp_sum of each
// lane's columns, for the mean, then for the mean square deviation), with
// each lane's columns c = lane + 32 k held in registers: its bias, scale
// and offset loaded once
// a call and its row values once a row, every load of a row started before
// the first is used. Hands each normalised value to fn(r, c, value); ends
// with a barrier.
template <bool kAffine, typename Fn>
__device__ __forceinline__ void ln_rows_pipe(const float* X, int ldx,
                                             int rows, int C,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ offset,
                                             Fn fn) {
  constexpr int kK = 512 / 32;  // columns a lane holds at most
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = C / 32;
  float bv[kK], sv[kK], ov[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (k < nk) {
      bv[k] = bias[lane + 32 * k];
      if (kAffine) {
        sv[k] = scale[lane + 32 * k];
        ov[k] = offset[lane + 32 * k];
      }
    }
  }
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = X + r * ldx;
    float v[kK];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (k < nk) {
        v[k] = xr[lane + 32 * k] + bv[k];
        s += v[k];
      }
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (k < nk) {
        const float d = v[k] - mean;
        q += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / C + kLnEps);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (k < nk) {
        float y = (v[k] - mean) * rstd;
        if (kAffine) y = y * sv[k] + ov[k];
        fn(r, lane + 32 * k, y);
      }
    }
  }
  __syncthreads();
}

// Eight bf16 values packed in a uint4, as f32 (exact: a bf16 is the high
// half of its f32).
__device__ __forceinline__ void unpack8(const uint4& w, float* out) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(words[k] << 16);
    out[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
  }
}

template <bool kHasWe, bool kWriteE, bool kEmbed>
__global__ void __launch_bounds__(kThreads, 1) fused_edge_pipelined_kernel(
    const bf16* __restrict__ e, const bf16* __restrict__ sproj,
    const int* __restrict__ senders, const bf16* __restrict__ rproj,
    const int* __restrict__ receivers, const bf16* __restrict__ we,
    const float* __restrict__ b0, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ scale,
    const float* __restrict__ offset, bf16* __restrict__ eout,
    float* __restrict__ agg, int num_edges, int C,
    const bf16* __restrict__ ew0, const float* __restrict__ eb0,
    const bf16* __restrict__ ew1, const float* __restrict__ eb1, int F) {
  static_assert(!kEmbed || (kHasWe && !kWriteE),
                "embed mode runs the edge matmul, aggregation only");
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + 8, ldx = C + 4;
  float* X = reinterpret_cast<float*>(smem);              // [TM, ldx]
  bf16* A = reinterpret_cast<bf16*>(X + kPipeTM * ldx);   // [TM, lda]
  bf16* Es = A + kPipeTM * lda;                           // [TM, lda]
  bf16* Ss = Es + (kEmbed ? 0 : kPipeTM * lda);           // [TM, C]
  bf16* Rs = Ss + kPipeTM * C;                            // [TM, C]
  bf16* ring = Rs + kPipeTM * C;        // [stages, kPipeKT, kPipeLdW]
  int* snd_next =
      reinterpret_cast<int*>(ring + kPipeStages * kPipeKT * kPipeLdW);
  int* rcv_next = snd_next + kPipeTM;
  int* rcv_cur = rcv_next + kPipeTM;

  const int tiles = (num_edges + kPipeTM - 1) / kPipeTM;
  const int t_begin = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  if (t_begin >= t_end) return;
  const bool prefetcher = threadIdx.x >= kHalfThreads;
  const int c2n = C / 2, c8n = C / 8;

  // Warps 4-7: tile `tile`'s e rows and gathered projection rows into the
  // staging area (its indices already in snd_next / rcv_next), one group.
  auto prefetch = [&](int tile) {
    const int row0 = tile * kPipeTM;
    const int rows = min(kPipeTM, num_edges - row0);
    const int t = threadIdx.x - kHalfThreads;
    if (!kEmbed) {
      for (int i = t; i < kPipeTM * c8n; i += kHalfThreads) {
        const int r = i / c8n, c = (i % c8n) * 8;
        if (r < rows) {
          cp_async16(Es + r * lda + c, e + (size_t)(row0 + r) * C + c);
        } else {
          *reinterpret_cast<uint4*>(Es + r * lda + c) =
              make_uint4(0, 0, 0, 0);
        }
      }
    }
    for (int i = t; i < rows * c8n; i += kHalfThreads) {
      const int r = i / c8n, c = (i % c8n) * 8;
      cp_async16(Ss + r * C + c, sproj + (size_t)snd_next[r] * C + c);
      cp_async16(Rs + r * C + c, rproj + (size_t)rcv_next[r] * C + c);
    }
    cp_async_commit();
  };

  for (int r = threadIdx.x; r < kPipeTM; r += kThreads) {
    const int row = t_begin * kPipeTM + r;
    snd_next[r] = row < num_edges ? senders[row] : 0;
    rcv_next[r] = row < num_edges ? receivers[row] : 0;
  }
  __syncthreads();
  if (prefetcher) prefetch(t_begin);

  for (int g = t_begin; g < t_end; ++g) {
    const int row0 = g * kPipeTM;
    const int rows = min(kPipeTM, num_edges - row0);
    if (prefetcher) cp_async_wait<0>();
    __syncthreads();  // tile g's staged rows are visible to every thread
    // Tile g's receivers for its run sums; tile g+1's indices for its
    // prefetch (the same thread reads and rewrites each slot).
    for (int r = threadIdx.x; r < kPipeTM; r += kThreads) {
      rcv_cur[r] = r < rows ? rcv_next[r] : -1;
      const int row = row0 + kPipeTM + r;
      if (g + 1 < t_end && row < num_edges) {
        snd_next[r] = senders[row];
        rcv_next[r] = receivers[row];
      }
    }

    // ---- head of tile g: the first layer, A <- bf16(swish(bf16(x0))) ----
    if (kEmbed) {
      for (int i = threadIdx.x; i < kPipeTM * c2n; i += kThreads) {
        const int r = i / c2n, c = (i % c2n) * 2;
        float hx = 0.f, hy = 0.f;
        if (r < rows) {
          const bf16* f = e + (size_t)(row0 + r) * F;
          float x0 = 0.f, x1 = 0.f;
          for (int k = 0; k < F; ++k) {
            const float fk = __bfloat162float(f[k]);
            const float2 w = load_bf16x2(ew0 + (size_t)k * C + c);
            x0 = fmaf(fk, w.x, x0);
            x1 = fmaf(fk, w.y, x1);
          }
          hx = swish_of_bf16(x0 + eb0[c]);
          hy = swish_of_bf16(x1 + eb0[c + 1]);
        }
        store_bf16x2(A + r * lda + c, hx, hy);
      }
      block_mm_pipe<kPipeTM>(A, lda, ew1, C, C, X, ldx, ring);
      ln_rows_pipe<false>(X, ldx, rows, C, eb1, nullptr, nullptr,
                          [&](int r, int c, float yn) {
                            A[r * lda + c] = __float2bfloat16(yn);
                          });
      block_mm_pipe<kPipeTM>(A, lda, we, C, C, X, ldx, ring);
    } else if (kHasWe) {
      block_mm_pipe<kPipeTM>(Es, lda, we, C, C, X, ldx, ring);
    }
    // x0 = . + s + r (+ b0), then A <- bf16(swish(bf16(x0))), 8 columns a
    // thread; its columns are the same in every row (c8n divides kThreads).
    {
      const int c = (threadIdx.x % c8n) * 8;
      float bias[8] = {};
      if (kHasWe) {
        const float4 lo = *reinterpret_cast<const float4*>(b0 + c);
        const float4 hi = *reinterpret_cast<const float4*>(b0 + c + 4);
        bias[0] = lo.x, bias[1] = lo.y, bias[2] = lo.z, bias[3] = lo.w;
        bias[4] = hi.x, bias[5] = hi.y, bias[6] = hi.z, bias[7] = hi.w;
      }
      for (int r = threadIdx.x / c8n; r < kPipeTM; r += kThreads / c8n) {
        unsigned h[4] = {0u, 0u, 0u, 0u};
        if (r < rows) {
          float x[8], sv[8], rv[8];
          if (kHasWe) {
            const float4 lo = *reinterpret_cast<const float4*>(X + r * ldx + c);
            const float4 hi =
                *reinterpret_cast<const float4*>(X + r * ldx + c + 4);
            x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
            x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
          } else {
            unpack8(*reinterpret_cast<const uint4*>(Es + r * lda + c), x);
          }
          unpack8(*reinterpret_cast<const uint4*>(Ss + r * C + c), sv);
          unpack8(*reinterpret_cast<const uint4*>(Rs + r * C + c), rv);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            x[k] += sv[k];
            x[k] += rv[k];
            if (kHasWe) x[k] += bias[k];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            h[k] = pack_bf16x2(swish_of_bf16(x[2 * k]),
                               swish_of_bf16(x[2 * k + 1]));
          }
        }
        *reinterpret_cast<uint4*>(A + r * lda + c) =
            make_uint4(h[0], h[1], h[2], h[3]);
      }
    }
    __syncthreads();  // A holds h; the staging area is free
    if (prefetcher && g + 1 < t_end) prefetch(g + 1);

    // ---- tail of tile g, while tile g+1's rows are in flight ----
    block_mm_pipe<kPipeTM>(A, lda, w1, C, C, X, ldx, ring);
    ln_rows_pipe<true>(X, ldx, rows, C, b1, scale, offset,
                       [&](int r, int c, float yn) {
                         X[r * ldx + c] = kWriteE ? yn : round_bf16(yn);
                       });
    if (kWriteE) {
      // e' = bf16(e + yn), K1's arithmetic, 8 columns a load with all of a
      // thread's loads started before the first is used; then X <- bf16(yn).
      uint4 ev[kEdgeLoads];
#pragma unroll
      for (int j = 0; j < kEdgeLoads; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < rows * c8n) {
          ev[j] = *reinterpret_cast<const uint4*>(
              e + (size_t)(row0 + i / c8n) * C + (i % c8n) * 8);
        }
      }
#pragma unroll
      for (int j = 0; j < kEdgeLoads; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < rows * c8n) {
          const int r = i / c8n, c = (i % c8n) * 8;
          float ef[8];
          unpack8(ev[j], ef);
          unsigned out[4];
          float* xr = X + r * ldx + c;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            out[k] = pack_bf16x2(ef[2 * k] + xr[2 * k],
                                 ef[2 * k + 1] + xr[2 * k + 1]);
            xr[2 * k] = round_bf16(xr[2 * k]);
            xr[2 * k + 1] = round_bf16(xr[2 * k + 1]);
          }
          *reinterpret_cast<uint4*>(eout + (size_t)(row0 + r) * C + c) =
              make_uint4(out[0], out[1], out[2], out[3]);
        }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < C; c += kThreads) {
      int r = 0;
      while (r < rows) {
        const int node = rcv_cur[r];
        float s = 0.f;
        int r1 = r;
        do {
          s += X[r1 * ldx + c];
          ++r1;
        } while (r1 < rows && rcv_cur[r1] == node);
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
}

template <bool kHasWe, bool kWriteE, bool kEmbed = false>
cudaError_t launch_pipelined(const void* e, const void* sproj,
                             const int* senders, const void* rproj,
                             const int* receivers, const void* we,
                             const float* b0, const void* w1, const float* b1,
                             const float* scale, const float* offset,
                             void* eout, float* agg, int num_edges, int C,
                             cudaStream_t stream, const void* ew0 = nullptr,
                             const float* eb0 = nullptr,
                             const void* ew1 = nullptr,
                             const float* eb1 = nullptr, int F = 0) {
  if (C % kPipeNC) return cudaErrorInvalidValue;  // the wrapper refuses it
  const size_t smem = sizeof(float) * kPipeTM * (C + 4) +
                      sizeof(bf16) * kPipeTM * (C + 8) * (kEmbed ? 1 : 2) +
                      sizeof(bf16) * 2 * kPipeTM * C +
                      sizeof(bf16) * kPipeStages * kPipeKT * kPipeLdW +
                      sizeof(int) * 3 * kPipeTM;
  auto kernel = fused_edge_pipelined_kernel<kHasWe, kWriteE, kEmbed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (num_edges + kPipeTM - 1) / kPipeTM;
  kernel<<<persistent_blocks(tiles), kThreads, smem, stream>>>(
      static_cast<const bf16*>(e), static_cast<const bf16*>(sproj), senders,
      static_cast<const bf16*>(rproj), receivers,
      static_cast<const bf16*>(we), b0, static_cast<const bf16*>(w1), b1,
      scale, offset, static_cast<bf16*>(eout), agg, num_edges, C,
      static_cast<const bf16*>(ew0), eb0, static_cast<const bf16*>(ew1), eb1,
      F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gc

extern "C" int gc_fused_edge_pipelined(
    const void* e, const void* sproj, const int* senders, const void* rproj,
    const int* receivers, const void* we, const float* b0, const void* w1,
    const float* b1, const float* scale, const float* offset, void* eout,
    float* agg, int num_edges, int C, int has_we, int write_e, void* stream) {
  if (num_edges <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (has_we && write_e) {
    return gc::launch_pipelined<true, true>(e, sproj, senders, rproj,
                                            receivers, we, b0, w1, b1, scale,
                                            offset, eout, agg, num_edges, C,
                                            s);
  }
  if (has_we) {
    return gc::launch_pipelined<true, false>(e, sproj, senders, rproj,
                                             receivers, we, b0, w1, b1, scale,
                                             offset, eout, agg, num_edges, C,
                                             s);
  }
  if (write_e) {
    return gc::launch_pipelined<false, true>(e, sproj, senders, rproj,
                                             receivers, we, b0, w1, b1, scale,
                                             offset, eout, agg, num_edges, C,
                                             s);
  }
  return gc::launch_pipelined<false, false>(e, sproj, senders, rproj,
                                            receivers, we, b0, w1, b1, scale,
                                            offset, eout, agg, num_edges, C,
                                            s);
}

// Embed mode: features [E, F] raw edge features; aggregation only.
extern "C" int gc_fused_edge_embed_pipelined(
    const void* features, const void* ew0, const float* eb0, const void* ew1,
    const float* eb1, const void* sproj, const int* senders,
    const void* rproj, const int* receivers, const void* we, const float* b0,
    const void* w1, const float* b1, const float* scale, const float* offset,
    float* agg, int num_edges, int F, int C, void* stream) {
  if (num_edges <= 0) return 0;
  return gc::launch_pipelined<true, false, true>(
      features, sproj, senders, rproj, receivers, we, b0, w1, b1, scale,
      offset, nullptr, agg, num_edges, C, static_cast<cudaStream_t>(stream),
      ew0, eb0, ew1, eb1, F);
}
