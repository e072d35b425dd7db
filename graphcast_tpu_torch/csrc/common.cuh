// Shared pieces of the port's Hopper kernels (fused_edge.cu, fused_decoder.cu,
// their backward passes fused_edge_bwd.cu, fused_decoder_bwd.cu, and the
// attention kernels splash_fwd.cu, splash_bwd.cu).
//
// The kernels are chains of [rows, C] x [C, N] products on a tile of rows
// held in shared memory, with elementwise and LayerNorm epilogues between
// them. block_mm is that product: nvcuda::wmma bf16 16x16x16 fragments with
// f32 accumulation, the weight matrix streamed from global memory (where it
// stays L2-resident: every block reads the same few 512x512 matrices)
// through a [64, 128] shared-memory tile. A later PR replaces it with
// wgmma + TMA; the epilogues stay.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace gc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNC = 128;        // output columns per block_mm pass
constexpr int kKT = 64;         // K rows per staged weight tile
constexpr int kLdW = kNC + 8;   // padded leading dim of the weight tile
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// swish of x rounded to bf16 first: the TPU kernels apply the activation to
// the bf16-rounded first-layer output.
__device__ __forceinline__ float swish_of_bf16(float x) {
  const float xb = round_bf16(x);
  return xb / (1.0f + expf(-xb));
}

// swish'(xb) = s + xb * s * (1 - s), s = sigmoid(xb), at a bf16-rounded xb;
// rounded to bf16, as the TPU backward kernels evaluate it in bf16.
__device__ __forceinline__ float swish_grad_bf16(float xb) {
  const float s = 1.0f / (1.0f + expf(-xb));
  return round_bf16(s + xb * s * (1.0f - s));
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dst[0:TM, 0:C] <- src rows row0.. (row-major [*, C]); rows >= `rows` zero.
template <int TM>
__device__ __forceinline__ void load_tile(bf16* dst, int ldd,
                                          const bf16* __restrict__ src,
                                          int row0, int rows, int C) {
  const int c8n = C / 8;
  for (int i = threadIdx.x; i < TM * c8n; i += kThreads) {
    const int r = i / c8n, c = (i % c8n) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * C + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
  }
}

// LayerNorm of the first `rows` rows of X (+bias) over C columns, one warp
// per row, statistics in f32; hands each normalised value to
// fn(r, c, value), which may overwrite X[r, c]. scale and offset may be
// null (the parameter-free LayerNorm). Ends with a barrier.
template <typename Fn>
__device__ __forceinline__ void layer_norm_rows(float* X, int ldx, int rows,
                                                int C,
                                                const float* __restrict__ bias,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ offset,
                                                Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float* xr = X + r * ldx;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = xr[c] + bias[c];
      xr[c] = v;
      s += v;
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / C + kLnEps);
    for (int c = lane; c < C; c += 32) {
      float y = (xr[c] - mean) * rstd;
      if (scale != nullptr) y = y * scale[c] + offset[c];
      fn(r, c, y);
    }
  }
  __syncthreads();
}

// The LayerNorm backward, in two warp-per-row passes for the first `rows`
// rows. ln_rows_normalize: X[r] <- yh = (X[r] + bias - mean) * rstd, f32
// statistics, rstd to rstd_out[r]. ln_bwd_moments: m1 = mean_c dyh(r, c) and
// m2 = mean_c dyh(r, c) * Y[r, c] to m1_out[r], m2_out[r], so that
// dy = rstd * (dyh - m1 - yh * m2). Both end with a barrier.
__device__ __forceinline__ void ln_rows_normalize(float* X, int ldx, int rows,
                                                  int C,
                                                  const float* __restrict__ bias,
                                                  float* rstd_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float* xr = X + r * ldx;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = xr[c] + bias[c];
      xr[c] = v;
      s += v;
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / C + kLnEps);
    for (int c = lane; c < C; c += 32) xr[c] = (xr[c] - mean) * rstd;
    if (lane == 0) rstd_out[r] = rstd;
  }
  __syncthreads();
}

template <typename DyhFn>
__device__ __forceinline__ void ln_bwd_moments(const float* Y, int ldy,
                                               int rows, int C, DyhFn dyh,
                                               float* m1_out, float* m2_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = dyh(r, c);
      s1 += d;
      s2 += d * Y[r * ldy + c];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      m1_out[r] = s1 / C;
      m2_out[r] = s2 / C;
    }
  }
  __syncthreads();
}

// Adds the block's column sums (shared, n floats) into `dst` (global f32).
__device__ __forceinline__ void flush_sums(float* __restrict__ dst,
                                           const float* S, int n) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) atomicAdd(dst + i, S[i]);
}

// Number of blocks for a persistent grid-stride launch over `tiles` tiles,
// one resident block per SM.
inline int persistent_blocks(int tiles) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms < 1) sms = 1;
  return tiles < sms ? tiles : sms;
}

// The attention kernels (splash_fwd.cu, splash_bwd.cu): tiles of 64 q rows
// by 64 kv columns at head dim 128, fragment packing and sums over the 4
// threads of a quad (the threads that share a fragment row), and the
// backward kernels' register-level bf16 product: one warp-wide mma.sync
// m16n8k16 with f32 accumulation and its fragment loads.
constexpr int kSpT = 64;            // q rows and kv columns per tile
constexpr int kSpD = 128;           // head dim
constexpr int kSpThreads = 128;     // 4 warps x 16 q rows
constexpr int kLdK = kSpD + 8;      // Q/K row stride (bf16): 272 B
constexpr int kLdVt = kSpT + 8;     // transposed-V row stride (bf16): 144 B
constexpr float kSpNegInf = -1e30f;

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// X[0:TM, 0:N] (+)= A[0:TM, 0:K] @ W[0:K, 0:N].
//   A: shared bf16, leading dim lda (a multiple of 8, rows 32-byte aligned).
//   W: global bf16, row-major [K, N], 16-byte aligned.
//   X: shared f32, leading dim ldx (a multiple of 4).
//   Wt: shared scratch of kKT * kLdW bf16.
// K % kKT == 0 and N % kNC == 0. Every thread of the block calls it; it
// begins and ends with a barrier.
template <int TM>
__device__ void block_mm(const bf16* A, int lda, const bf16* __restrict__ W,
                         int K, int N, float* X, int ldx, bf16* Wt,
                         bool accumulate) {
  using namespace nvcuda;
  constexpr int kWR = TM / 16;            // warps along rows
  constexpr int kWC = kWarps / kWR;       // warps along columns
  constexpr int kFN = kNC / 16 / kWC;     // fragments per warp per pass
  static_assert(kWR * kWC == kWarps && kFN >= 1, "tile shape");
  const int warp = threadIdx.x / 32;
  const int wr = warp / kWC, wc = warp % kWC;
  __syncthreads();
  for (int n0 = 0; n0 < N; n0 += kNC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFN];
    float* xblk = X + wr * 16 * ldx + n0 + wc * kFN * 16;
#pragma unroll
    for (int f = 0; f < kFN; ++f) {
      if (accumulate) {
        wmma::load_matrix_sync(acc[f], xblk + f * 16, ldx,
                               wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc[f], 0.0f);
      }
    }
    for (int k0 = 0; k0 < K; k0 += kKT) {
      __syncthreads();
      for (int i = threadIdx.x; i < kKT * kNC / 8; i += kThreads) {
        const int r = i / (kNC / 8), c = (i % (kNC / 8)) * 8;
        *reinterpret_cast<uint4*>(Wt + r * kLdW + c) =
            *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + wr * 16 * lda + k0 + kk, lda);
#pragma unroll
        for (int f = 0; f < kFN; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Wt + kk * kLdW + (wc * kFN + f) * 16,
                                 kLdW);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kFN; ++f) {
      wmma::store_matrix_sync(xblk + f * 16, acc[f], ldx, wmma::mem_row_major);
    }
  }
  __syncthreads();
}

// The embed mode's edge embedding (GenCast; pallas_edge.py:124-157 and
// pallas_decoder.py:116-124) for a tile of TM rows whose raw features are
// rows feat_row(r) of feat [*, F]:
//   A[r] <- en = bf16(LN0(bf16(swish(bf16(f @ ew0 + eb0))) @ ew1 + eb1)),
// LN0 parameter-free with f32 statistics. The F-deep first product runs on
// the CUDA cores (F is 4 in GenCast), the C x C second one through
// block_mm into X. Rows >= `rows` of A are left zero. Every thread of the
// block calls it; it ends with a barrier.
template <int TM, typename RowFn>
__device__ void embed_rows(bf16* A, int lda, float* X, int ldx, bf16* Wt,
                           const bf16* __restrict__ feat, int F,
                           RowFn feat_row, int rows, int C,
                           const bf16* __restrict__ ew0,
                           const float* __restrict__ eb0,
                           const bf16* __restrict__ ew1,
                           const float* __restrict__ eb1) {
  const int c2n = C / 2;
  for (int i = threadIdx.x; i < TM * c2n; i += kThreads) {
    const int r = i / c2n, c = (i % c2n) * 2;
    float hx = 0.f, hy = 0.f;
    if (r < rows) {
      const bf16* f = feat + (size_t)feat_row(r) * F;
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
  block_mm<TM>(A, lda, ew1, C, C, X, ldx, Wt, false);
  layer_norm_rows(X, ldx, rows, C, eb1, nullptr, nullptr,
                  [&](int r, int c, float yn) {
                    A[r * lda + c] = __float2bfloat16(yn);
                  });
}

// bf16(f @ ew0 + eb0)[c] for one raw feature row f: the embed's first-layer
// output before its swish, with embed_rows' arithmetic (the backward
// kernels' swish' point).
__device__ __forceinline__ float embed_pre_bf16(const bf16* __restrict__ f,
                                                int F,
                                                const bf16* __restrict__ ew0,
                                                const float* __restrict__ eb0,
                                                int C, int c) {
  float x = 0.f;
  for (int k = 0; k < F; ++k) {
    x = fmaf(__bfloat162float(f[k]), __bfloat162float(ew0[(size_t)k * C + c]),
             x);
  }
  return round_bf16(x + eb0[c]);
}

// embed_rows for the backward kernels, which also keep what the embed's
// backward needs: hh = bf16(swish(...)) goes to hh_out(r, c, hx, hy) (pairs
// of columns), the f32 LN0 output yh0 to keep(r, c, yh0) and each row's
// rstd to rstd_out[r]; A ends holding en = bf16(yh0), as in embed_rows (the
// same arithmetic). Rows >= `rows` of A are left zero. Ends with a barrier.
template <int TM, typename RowFn, typename HhFn, typename KeepFn>
__device__ void embed_rows_keep(bf16* A, int lda, float* X, int ldx, bf16* Wt,
                                const bf16* __restrict__ feat, int F,
                                RowFn feat_row, int rows, int C,
                                const bf16* __restrict__ ew0,
                                const float* __restrict__ eb0,
                                const bf16* __restrict__ ew1,
                                const float* __restrict__ eb1,
                                float* rstd_out, HhFn hh_out, KeepFn keep) {
  const int c2n = C / 2;
  for (int i = threadIdx.x; i < TM * c2n; i += kThreads) {
    const int r = i / c2n, c = (i % c2n) * 2;
    float hx = 0.f, hy = 0.f;
    if (r < rows) {
      const bf16* f = feat + (size_t)feat_row(r) * F;
      float x0 = 0.f, x1 = 0.f;
      for (int k = 0; k < F; ++k) {
        const float fk = __bfloat162float(f[k]);
        const float2 w = load_bf16x2(ew0 + (size_t)k * C + c);
        x0 = fmaf(fk, w.x, x0);
        x1 = fmaf(fk, w.y, x1);
      }
      hx = swish_of_bf16(x0 + eb0[c]);
      hy = swish_of_bf16(x1 + eb0[c + 1]);
      hh_out(r, c, hx, hy);
    }
    store_bf16x2(A + r * lda + c, hx, hy);
  }
  block_mm<TM>(A, lda, ew1, C, C, X, ldx, Wt, false);
  ln_rows_normalize(X, ldx, rows, C, eb1, rstd_out);
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const float y = X[r * ldx + c];
    A[r * lda + c] = __float2bfloat16(y);
    keep(r, c, y);
  }
  __syncthreads();
}

}  // namespace gc
