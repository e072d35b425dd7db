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
// What bounds it on an H100: R is hundreds of thousands of rows and K, N
// are 512, so 2 R K N FLOPs over 2 R (K + N) bytes read once: 256 FLOPs a
// byte, just under the card's ~295, so bytes bound it by a little. Each
// 128 x 256 tile of dW reads its 384 columns of every row, so the SMs pull
// 3x the operands' bytes from L2 (12 bytes per KFLOP), while HBM sees them
// about once when the blocks that read the same rows run together.
// Design (hopper.cuh's TMA and wgmma pieces):
//   * split-K over rows: the host (ops/weight_grad.py plan) cuts the rows
//     into ranges of whole 64-row slabs and makes one work item per
//     (row range, dW tile), ordered range-major so that the blocks running
//     at once read the same rows (L2 hits); persistent blocks, one per SM,
//     walk the items with a grid stride;
//   * per block one producer warp keeps a 4-stage ring of (A slab 64 x 128,
//     B slab 64 x BN) in flight with TMA (128-byte swizzle; rows past R
//     arrive as zeros, so the ragged last slab needs no mask), two consumer
//     warpgroups each own 64 rows of the 128 x BN tile (BN = 256, or 128
//     when N is an odd multiple of 128) and accumulate in f32 registers with
//     wgmma m64nBNk16; the contraction runs over the slab's rows, so both
//     operands are read MN-major (the instruction's transpose bits) and
//     nothing is transposed anywhere; a stage is released once the next
//     stage's products are issued (one wgmma group in flight);
//   * reduction in a fixed order: each item stores its f32 partial tile to
//     a workspace [items, 128, BN] and a second pass adds the partials to dW
//     in row-range order, so dW is bit-reproducible from run to run (no
//     atomics); the workspace costs ~32 MB of traffic at 512 x 512.
//
// feature_grad_kernel is the same reduction for the embed modes' first
// layer, whose depth is the F raw edge features (4 in GenCast, too narrow
// for a 128-wide tile): dEw0[F, C] += X[R, F]^T D[R, C], and the raw-feature
// gradient dX[R, F] = D Ew0^T (pallas_edge.py:463-470, pallas_decoder.py:
// 394-400). Bytes bound it: 2 R C bytes of D read once against 4 R F C
// FLOPs (8 FLOPs a byte at F = 4). Design: one pass over D, 16-byte loads:
//   * a block owns a range of rows (the host's plan: one block per SM, as
//     many as its ~200 registers a thread let run at once), a warp every
//     8th row of it, 4 rows in flight; a lane holds
//     columns 8 v .. 8 v + 7 of D for v = lane, lane + 32 (C <= 512), with
//     Ew0's F values of those columns in registers;
//   * per row the lane's F dot products with Ew0 are summed over the warp
//     by shuffles (dX), and x[r, k] d[r, c] is added into the lane's f32
//     dEw0 partial, in row order;
//   * the 8 warps' partials are added in warp order in shared memory and
//     leave as the block's partial; a second kernel adds the blocks'
//     partials into dEw0 in a fixed tree over the blocks, as weight_grad's
//     second pass does: no atomics, so a rerun is bit-equal.

#include "common.cuh"
#include "hopper.cuh"

namespace gc {

constexpr int kWgBM = 128;                     // dW rows (of K) per tile
constexpr int kWgSlab = 64;                    // contraction rows a stage
constexpr int kWgStages = 4;                   // ring depth
constexpr int kWgBox = 64 * 64 * 2;            // bytes of a 64 x 64 box
constexpr int kWgConsumers = 256;              // two warpgroups
constexpr int kWgThreads = kWgConsumers + 32;  // and the producer warp

template <int BN>
__host__ __device__ constexpr int wg_stage_bytes() {
  return (kWgBM / 64 + BN / 64) * kWgBox;
}

template <int BN>
__host__ __device__ constexpr int wg_smem_bytes() {
  return kWgStages * wg_stage_bytes<BN>() + 2 * kWgStages * 8 + 1024;
}

template <int BN>
__device__ __forceinline__ void wg_mma(float (&acc)[BN / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (BN == 256) {
    wgmma_m64n256k16_ss<1, 1>(acc, da, db);
  } else {
    wgmma_m64n128k16_ss<1, 1>(acc, da, db);
  }
}

// items[i] = (k0, n0, r0, r1): the dW tile at (k0, n0) over rows [r0, r1),
// r0 a multiple of kWgSlab; ws[i] its f32 partial tile [kWgBM, BN].
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1) weight_grad_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const int4* __restrict__ items,
    int n_items, float* __restrict__ ws) {
  constexpr int kStage = wg_stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgStages * kStage);
  uint64_t* empty = full + kWgStages;
  // The warp index, warp-uniform as ptxas sees it (a broadcast).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWgConsumers / 32) {  // the producer warp
    if (lane == 0) {
      prefetch_tensor_map(&ta);
      prefetch_tensor_map(&tb);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
        const int4 w = items[it];
        for (int r = w.z; r < w.w; r += kWgSlab) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * kStage;
          mbar_arrive_expect_tx(&full[stage], kStage);
          tma_load_2d(st, &ta, &full[stage], w.x, r);
          tma_load_2d(st + kWgBox, &ta, &full[stage], w.x + 64, r);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            tma_load_2d(st + (2 + j) * kWgBox, &tb, &full[stage],
                        w.y + 64 * j, r);
          }
          if (++stage == kWgStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows wg * 64 .. wg * 64 + 63 of the tile.
  const int wg = threadIdx.x / 128;
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int4 w = items[it];
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int r = w.z; r < w.w; r += kWgSlab) {
      mbar_wait(&full[stage], phase);
      const uint32_t st = smem_u32(smem + stage * kStage);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgSlab / 16; ++ks) {
        wg_mma<BN>(acc, mnmajor_desc(st + wg * kWgBox, ks, kWgBox),
                   mnmajor_desc(st + 2 * kWgBox, ks, kWgBox));
      }
      wgmma_commit();
      fence_operands(acc);
      wgmma_wait<1>();  // the previous stage's products are done
      fence_operands(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kWgStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    float* dst = ws + (size_t)it * kWgBM * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(dst + row * BN + 8 * j + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(dst + (row + 8) * BN + 8 * j + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// dW[k, n] += sum over s in order of ws[s * tiles + tile(k, n)][k % kWgBM,
// n % BN]: the fixed-order second pass, 4 columns a thread. The partials
// are loaded kWgBatch at a time (independent loads in flight) and added in
// split order.
constexpr int kWgBatch = 8;

__global__ void __launch_bounds__(kThreads) weight_grad_reduce_kernel(
    const float* __restrict__ ws, float* __restrict__ dW, int K, int N,
    int bn, int splits) {
  const int tiles_n = N / bn, tiles = (K / kWgBM) * tiles_n;
  const size_t tile_elems = (size_t)kWgBM * bn;
  const size_t split_stride = (size_t)tiles * tile_elems;
  const int quads = K * N / 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += gridDim.x * blockDim.x) {
    const int k = (4 * i) / N, n = (4 * i) % N;
    const int tile = (k / kWgBM) * tiles_n + n / bn;
    const float* src = ws + (size_t)tile * tile_elems + (k % kWgBM) * bn +
                       n % bn;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += kWgBatch) {
      float4 p[kWgBatch];
#pragma unroll
      for (int j = 0; j < kWgBatch; ++j) {
        p[j] = s0 + j < splits ? *reinterpret_cast<const float4*>(
                                     src + (s0 + j) * split_stride)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kWgBatch; ++j) {
        sum.x += p[j].x;
        sum.y += p[j].y;
        sum.z += p[j].z;
        sum.w += p[j].w;
      }
    }
    float4* d = reinterpret_cast<float4*>(dW) + i;
    const float4 o = *d;
    *d = make_float4(o.x + sum.x, o.y + sum.y, o.z + sum.z, o.w + sum.w);
  }
}

constexpr int kFgMaxF = 16;   // raw features the kernel takes
constexpr int kFgWarps = 8;    // warps a block
constexpr int kFgUnroll = 4;   // rows a warp keeps in flight
constexpr int kFgNV = 2;       // 16-byte column vectors a lane (C <= 512)

// Rows [blockIdx.x rpb, + rpb) of X and D: dX of each row, and the block's
// dEw0 partial [F, C] into ws[blockIdx.x]. FM >= F bounds the registers.
template <int FM>
__global__ void __launch_bounds__(kThreads) feature_grad_kernel(
    const bf16* __restrict__ X, int F, const bf16* __restrict__ D, int ldd,
    const bf16* __restrict__ W0, float* __restrict__ dX,
    float* __restrict__ ws, int R, int C, int rpb) {
  __shared__ float part[FM * 512];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_begin = blockIdx.x * rpb;
  const int r_end = min(R, r_begin + rpb);
  const int nvec = C / 8;
  float w[kFgNV][8][FM], acc[kFgNV][8][FM];
#pragma unroll
  for (int i = 0; i < kFgNV; ++i) {
    const int v = lane + 32 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int k = 0; k < FM; ++k) {
        w[i][j][k] = v < nvec && k < F
                         ? __bfloat162float(W0[(size_t)k * C + 8 * v + j])
                         : 0.f;
        acc[i][j][k] = 0.f;
      }
    }
  }
  for (int r0 = r_begin + warp; r0 < r_end; r0 += kFgWarps * kFgUnroll) {
    // Every load of the rows in flight issued before any is used, from
    // clamped addresses (a row past the range reads row r_begin, a vector
    // past C vector 0; both are discarded).
    uint4 raw[kFgUnroll][kFgNV];
    float x[kFgUnroll][FM];
#pragma unroll
    for (int u = 0; u < kFgUnroll; ++u) {
      const int r = r0 + u * kFgWarps;
      const int rr = r < r_end ? r : r_begin;
#pragma unroll
      for (int i = 0; i < kFgNV; ++i) {
        const int v = lane + 32 * i;
        raw[u][i] = __ldg(reinterpret_cast<const uint4*>(
            D + (size_t)rr * ldd + 8 * (v < nvec ? v : 0)));
      }
#pragma unroll
      for (int k = 0; k < FM; ++k) {
        x[u][k] = k < F ? __bfloat162float(__ldg(X + (size_t)rr * F + k))
                        : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kFgUnroll; ++u) {
      const int r = r0 + u * kFgWarps;
      if (r >= r_end) break;
      float d[kFgNV][8];
#pragma unroll
      for (int i = 0; i < kFgNV; ++i) {
        const unsigned words[4] = {raw[u][i].x, raw[u][i].y, raw[u][i].z,
                                   raw[u][i].w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          d[i][2 * h] = __uint_as_float(words[h] << 16);
          d[i][2 * h + 1] = __uint_as_float(words[h] & 0xffff0000u);
        }
      }
      float s[FM];
#pragma unroll
      for (int k = 0; k < FM; ++k) s[k] = 0.f;
#pragma unroll
      for (int i = 0; i < kFgNV; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int k = 0; k < FM; ++k) {
            s[k] = fmaf(d[i][j], w[i][j][k], s[k]);
            acc[i][j][k] = fmaf(x[u][k], d[i][j], acc[i][j][k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < FM; ++k) {
        if (k < F) s[k] = warp_sum(s[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < FM; ++k) {
          if (k < F) dX[(size_t)r * F + k] = s[k];
        }
      }
    }
  }
  // The warps' partials in warp order, then the block's to ws.
  for (int wp = 0; wp < kFgWarps; ++wp) {
    __syncthreads();
    if (warp == wp) {
#pragma unroll
      for (int i = 0; i < kFgNV; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * (lane + 32 * i) + j;
#pragma unroll
          for (int k = 0; k < FM; ++k) {
            if (k < F && c < C) {
              float* p = part + k * C + c;
              *p = wp == 0 ? acc[i][j][k] : *p + acc[i][j][k];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  float* dst = ws + (size_t)blockIdx.x * F * C;
  for (int i = threadIdx.x; i < F * C; i += kThreads) dst[i] = part[i];
}

// dW0[i] += the blocks' partials ws[b][i] (n = F C values each): per value,
// 8 strided runs over the blocks, then those 8 in order; a fixed order.
__global__ void __launch_bounds__(kThreads) feature_grad_reduce_kernel(
    const float* __restrict__ ws, int blocks, int n, float* __restrict__ dW0) {
  __shared__ float red[8][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int b = threadIdx.y; b < blocks; b += 8) s += ws[(size_t)b * n + i];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = red[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < 8; ++y) t += red[y][threadIdx.x];
    dW0[i] += t;
  }
}

template <int BN>
static cudaError_t launch_weight_grad(const CUtensorMap& ta,
                                      const CUtensorMap& tb, const int4* items,
                                      int n_items, float* ws,
                                      cudaStream_t stream) {
  const int smem = wg_smem_bytes<BN>();
  const cudaError_t err = cudaFuncSetAttribute(
      weight_grad_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  weight_grad_kernel<BN><<<persistent_blocks(n_items), kWgThreads, smem,
                           stream>>>(ta, tb, items, n_items, ws);
  return cudaGetLastError();
}

}  // namespace gc

// dW[K, N] (f32, row-major) += A[R, K]^T B[R, N] (bf16, leading dims lda,
// ldb, 16-byte aligned rows). K a multiple of 128, N of bn (256 or 128).
// items: the host's work plan, n_items int4 (k0, n0, r0, r1), `splits` row
// ranges in order, each with every tile in order; ws: n_items * 128 * bn
// f32 of scratch.
extern "C" int gc_weight_grad(const void* A, int lda, const void* B, int ldb,
                              float* dW, int R, int K, int N,
                              const void* items, int n_items, int splits,
                              int bn, float* ws, void* stream) {
  if (R <= 0 || n_items <= 0) return 0;
  if ((bn != 128 && bn != 256) || K % gc::kWgBM || N % bn ||
      n_items != splits * (K / gc::kWgBM) * (N / bn)) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap ta, tb;
  cudaError_t err = gc::bf16_tile_map(&ta, A, R, K, lda, gc::kWgSlab);
  if (err != cudaSuccess) return err;
  err = gc::bf16_tile_map(&tb, B, R, N, ldb, gc::kWgSlab);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* it = static_cast<const int4*>(items);
  err = bn == 256 ? gc::launch_weight_grad<256>(ta, tb, it, n_items, ws, st)
                  : gc::launch_weight_grad<128>(ta, tb, it, n_items, ws, st);
  if (err != cudaSuccess) return err;
  const int quads = K * N / 4;
  const int blocks = (quads + gc::kThreads - 1) / gc::kThreads;
  gc::weight_grad_reduce_kernel<<<blocks < 1024 ? blocks : 1024, gc::kThreads,
                                  0, st>>>(ws, dW, K, N, bn, splits);
  return cudaGetLastError();
}

// Dynamic shared memory of weight_grad_kernel at tile width bn, in bytes.
extern "C" int gc_weight_grad_smem(int bn) {
  return bn == 256 ? gc::wg_smem_bytes<256>() : gc::wg_smem_bytes<128>();
}

// dEw0[F, C] (f32) += X[R, F]^T D[R, C] and dX[R, F] (f32) = D Ew0^T; X, Ew0
// bf16 row-major, D bf16 with leading dim ldd (a multiple of 8, 16-byte
// aligned rows); F <= 16, C a multiple of 8 up to 512. The host's plan:
// `blocks` blocks of rpb rows (a multiple of 32); ws: blocks F C f32.
extern "C" int gc_feature_grad(const void* X, int F, const void* D, int ldd,
                               const void* W0, float* dW0, float* dX,
                               float* ws, int R, int C, int rpb, int blocks,
                               void* stream) {
  using gc::bf16;
  if (R <= 0) return 0;
  if (F < 1 || F > gc::kFgMaxF || C % 8 || C > 512 || ldd % 8 ||
      rpb % (gc::kFgWarps * gc::kFgUnroll) || (long long)rpb * blocks < R) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const bf16 *x = static_cast<const bf16*>(X), *d = static_cast<const bf16*>(D),
             *w0 = static_cast<const bf16*>(W0);
  if (F <= 4) {
    gc::feature_grad_kernel<4><<<blocks, gc::kThreads, 0, st>>>(
        x, F, d, ldd, w0, dX, ws, R, C, rpb);
  } else if (F <= 8) {
    gc::feature_grad_kernel<8><<<blocks, gc::kThreads, 0, st>>>(
        x, F, d, ldd, w0, dX, ws, R, C, rpb);
  } else {
    gc::feature_grad_kernel<16><<<blocks, gc::kThreads, 0, st>>>(
        x, F, d, ldd, w0, dX, ws, R, C, rpb);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = F * C;
  gc::feature_grad_reduce_kernel<<<(n + 31) / 32, dim3(32, 8), 0, st>>>(
      ws, blocks, n, dW0);
  return cudaGetLastError();
}
