// The weight-gradient reduction of the backward kernels K4 and K5, for
// Hopper (sm_90a): dW[K, N] += A[R, K]^T B[R, N], bf16 operands, f32 sums.
//
// Replaces the constant-index f32 accumulator blocks of
// graphcast_tpu/ops/pallas_edge.py::_fused_edge_bwd_kernel (dW1, dWe) and
// graphcast_tpu/ops/pallas_decoder.py::_decoder_bwd_kernel (its 7 matrix
// gradients), which sum over a grid that runs in order on the TPU. Here the
// per-row passes (fused_edge_bwd.cu, fused_decoder_bwd.cu) write the bf16
// row operands to device memory and this kernel reduces them.
//
// What bounds it: R is hundreds of thousands of rows and K, N are 512, so
// the product is tensor-core work (2 R K N FLOPs) over 2 R (K + N) bytes.
// Design: split-K over rows. A block owns one 128 x 128 tile of dW and one
// slice of the rows; it stages 32-row slabs of A and B in shared memory and
// accumulates with wmma bf16 16x16x16 fragments in f32 (A^T is read as a
// column-major fragment, so no transpose is made). At the end the block adds
// its tile into dW with atomicAdd through a shared staging tile. The row
// slices are sized to give ~1000 blocks; only the order of those few dozen
// f32 partial sums per element varies between runs.
//
// feature_grad_kernel is the same reduction for the embed modes' first
// layer, whose depth is the F raw edge features (4 in GenCast, too narrow
// for a 128-wide tile): dEw0[F, C] += X[R, F]^T D[R, C], and the raw-feature
// gradient dX[R, F] = D Ew0^T (pallas_edge.py:463-470, pallas_decoder.py:
// 394-400). A block owns a slice of rows: one thread per column sums its F
// products over the slice in registers and adds them into dEw0 (atomicAdd),
// then one warp per row reduces the row's F dot products. Bytes bound it
// (2 R C bytes of D read once against 4 R F C FLOPs).

#include "common.cuh"

namespace gc {

constexpr int kWgT = 128;        // dW tile edge
constexpr int kWgR = 32;         // rows per staged slab
constexpr int kWgLd = kWgT + 8;  // padded leading dim of a slab
constexpr int kWgLdC = kWgT + 4; // padded leading dim of the staging tile

__global__ void __launch_bounds__(kThreads) weight_grad_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    float* __restrict__ dW, int R, int N, int rows_per_split) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                // [kWgR, kWgLd]
  bf16* Bs = As + kWgR * kWgLd;                            // [kWgR, kWgLd]
  float* Cs = reinterpret_cast<float*>(Bs + kWgR * kWgLd); // [kWgT, kWgLdC]
  const int n0 = blockIdx.x * kWgT, k0 = blockIdx.y * kWgT;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = warp % 2;  // 32 x 64 of the tile per warp

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int g = 0; g < 4; ++g) wmma::fill_fragment(acc[f][g], 0.0f);
  }
  for (int r0 = r_begin; r0 < r_end; r0 += kWgR) {
    __syncthreads();
    for (int i = threadIdx.x; i < kWgR * kWgT / 8; i += kThreads) {
      const int r = i / (kWgT / 8), c = (i % (kWgT / 8)) * 8;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
      if (r0 + r < r_end) {
        a = *reinterpret_cast<const uint4*>(A + (size_t)(r0 + r) * lda + k0 + c);
        b = *reinterpret_cast<const uint4*>(B + (size_t)(r0 + r) * ldb + n0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * kWgLd + c) = a;
      *reinterpret_cast<uint4*>(Bs + r * kWgLd + c) = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWgR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::load_matrix_sync(a[f], As + kk * kWgLd + wr * 32 + f * 16,
                               kWgLd);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * kWgLd + wc * 64 + g * 16, kWgLd);
#pragma unroll
        for (int f = 0; f < 2; ++f) wmma::mma_sync(acc[f][g], a[f], b, acc[f][g]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      wmma::store_matrix_sync(
          Cs + (wr * 32 + f * 16) * kWgLdC + wc * 64 + g * 16, acc[f][g],
          kWgLdC, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kWgT * kWgT; i += kThreads) {
    const int r = i / kWgT, c = i % kWgT;
    atomicAdd(dW + (size_t)(k0 + r) * N + n0 + c, Cs[r * kWgLdC + c]);
  }
}

constexpr int kFgRows = 256;  // rows per block
constexpr int kFgMaxF = 16;   // raw features the kernel takes

__global__ void __launch_bounds__(kThreads) feature_grad_kernel(
    const bf16* __restrict__ X, int F, const bf16* __restrict__ D, int ldd,
    const bf16* __restrict__ W0, float* __restrict__ dW0,
    float* __restrict__ dX, int R, int C) {
  const int r_begin = blockIdx.x * kFgRows;
  const int r_end = min(R, r_begin + kFgRows);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float acc[kFgMaxF];
#pragma unroll
    for (int k = 0; k < kFgMaxF; ++k) acc[k] = 0.f;
    for (int r = r_begin; r < r_end; ++r) {
      const float d = __bfloat162float(D[(size_t)r * ldd + c]);
      const bf16* x = X + (size_t)r * F;
#pragma unroll
      for (int k = 0; k < kFgMaxF; ++k) {
        if (k < F) acc[k] = fmaf(__bfloat162float(x[k]), d, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kFgMaxF; ++k) {
      if (k < F) atomicAdd(dW0 + (size_t)k * C + c, acc[k]);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = r_begin + warp; r < r_end; r += kWarps) {
    for (int k = 0; k < F; ++k) {
      float s = 0.f;
      for (int c = lane; c < C; c += 32) {
        s = fmaf(__bfloat162float(D[(size_t)r * ldd + c]),
                 __bfloat162float(W0[(size_t)k * C + c]), s);
      }
      s = warp_sum(s);
      if (lane == 0) dX[(size_t)r * F + k] = s;
    }
  }
}

}  // namespace gc

// dEw0[F, C] (f32) += X[R, F]^T D[R, C] and dX[R, F] (f32) = D Ew0^T; X, Ew0
// bf16 row-major, D bf16 with leading dim ldd; F <= 16.
extern "C" int gc_feature_grad(const void* X, int F, const void* D, int ldd,
                               const void* W0, float* dW0, float* dX, int R,
                               int C, void* stream) {
  using gc::bf16;
  if (R <= 0) return 0;
  if (F < 1 || F > gc::kFgMaxF) return cudaErrorInvalidValue;
  const int blocks = (R + gc::kFgRows - 1) / gc::kFgRows;
  gc::feature_grad_kernel<<<blocks, gc::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(X), F, static_cast<const bf16*>(D), ldd,
      static_cast<const bf16*>(W0), dW0, dX, R, C);
  return cudaGetLastError();
}

// dW[K, N] (f32, row-major) += A[R, K]^T B[R, N] (bf16, leading dims lda,
// ldb, 16-byte aligned rows). K and N multiples of 128.
extern "C" int gc_weight_grad(const void* A, int lda, const void* B, int ldb,
                              float* dW, int R, int K, int N, void* stream) {
  using gc::bf16;
  if (R <= 0) return 0;
  const size_t smem = sizeof(bf16) * 2 * gc::kWgR * gc::kWgLd +
                      sizeof(float) * gc::kWgT * gc::kWgLdC;
  cudaError_t err = cudaFuncSetAttribute(
      gc::weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (K / gc::kWgT) * (N / gc::kWgT);
  // ~1024 blocks in all, at least 1024 rows each, whole 32-row slabs.
  const int splits = 1024 / tiles > 1 ? 1024 / tiles : 1;
  int per = (R + splits - 1) / splits;
  per = per < 1024 ? 1024 : per;
  per = (per + gc::kWgR - 1) / gc::kWgR * gc::kWgR;
  const dim3 grid(N / gc::kWgT, K / gc::kWgT, (R + per - 1) / per);
  gc::weight_grad_kernel<<<grid, gc::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb, dW,
      R, N, per);
  return cudaGetLastError();
}
