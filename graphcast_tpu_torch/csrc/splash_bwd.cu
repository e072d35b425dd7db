// K7 and K8: the backward of the block-sparse flash attention (K6), for
// Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/splash.py::_dq_kernel (K7) and ::_dkv_kernel
// (K8), driven by _bwd. For one batch·head slice, over the entries (i, j) of
// the static mask, from K6's inputs, its lse and the output cotangent dO:
//
//   s_ij  = q_i . k_j * scale          p_ij = exp(s_ij - lse_i)
//   dp_ij = dO_i . v_j                 ds_ij = p_ij (dp_ij - delta_i) scale
//   dq_i  = sum_j bf16(ds_ij) k_j                                   (K7)
//   dv_j  = sum_i bf16(p_ij) dO_i      dk_j = sum_i bf16(ds_ij) q_i   (K8)
//
// with delta_i = sum_d o_i dO_i (f32, a reduction the wrapper runs before
// the launch, as the JAX package computes it outside its kernels), every
// product in f32, and the bf16 casts of the TPU kernels. Entries outside the
// mask have p = 0. Rows past n are zero in q, dO and delta, their lse is 0
// and their mask words are 0, so they contribute nothing and get 0.
//
// The TPU carries dq (and dk, dv) across an in-order grid dimension in
// scratch; Hopper's blocks run in no order. The split into two kernels does
// that job here: each block owns its output rows and loops over its pairs,
// so neither kernel needs atomics.
//
// What bounds them on an H100: per active (q tile, kv tile) pair, four
// 64x64x128 products (K7: S, dP, dQ and the recomputed mask; K8: S^T, dP^T,
// dV, dK), 4.2 MFLOP against 32-64 KB of tiles that all blocks of a head
// read from L2. Design, as K6 (mma.sync m16n8k16 bf16, f32 accumulation,
// 4 warps of 16 rows):
//   * K7: one block per (q tile, batch·head). Q and dO stay in registers as
//     A fragments, and so does the 16 x 128 f32 dq accumulator of each warp.
//     Per active kv tile, K is staged twice (row-major for S = Q K^T,
//     transposed for dS K) and V row-major for dP = dO V^T; S and dP are
//     computed 16 kv columns at a time, dS repacked to bf16 as an A
//     fragment and multiplied straight away (53 KB of shared memory).
//   * K8: one block per (kv tile, batch·head), walking the transposed
//     map's q tiles. Each warp owns 16 kv rows and computes S^T = K Q^T and
//     dP^T = V dO^T directly, so P^T and dS^T are A fragments in registers;
//     K and V stay in shared memory, Q and dO are staged row-major and
//     transposed with lse and delta per q column (105 KB). dK and dV
//     accumulate in f32 registers (2 x 16 x 128 per warp).
// Simple first: no cp.async/TMA pipelining and no wgmma.

#include "common.cuh"

namespace gc {

// Copies a [kSpT, kSpD] tile to shared memory, row-major (stride kLdK) and,
// where `dst_t` is given, transposed (stride kLdVt).
__device__ __forceinline__ void stage_tile(bf16* dst, bf16* dst_t,
                                           const bf16* __restrict__ src) {
  for (int i = threadIdx.x; i < kSpT * kSpD / 8; i += kSpThreads) {
    const int r = i / (kSpD / 8), c = (i % (kSpD / 8)) * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(src + (size_t)r * kSpD + c);
    *reinterpret_cast<uint4*>(dst + r * kLdK + c) = x;
    if (dst_t != nullptr) {
      const bf16* xe = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst_t[(c + e) * kLdVt + r] = xe[e];
    }
  }
}

__device__ __forceinline__ bool mask_bit(unsigned long long w, int col) {
  return (w >> col) & 1ull;
}

__global__ void __launch_bounds__(kSpThreads) splash_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ kv_offsets, const int* __restrict__ kv_index,
    const unsigned long long* __restrict__ words,
    const int* __restrict__ full, bf16* __restrict__ dq, float scale,
    int n_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);   // [kSpT, kLdK]
  bf16* Vs = Ks + kSpT * kLdK;                // [kSpT, kLdK]
  bf16* Kt = Vs + kSpT * kLdK;                // [kSpD, kLdVt]

  const int qt = blockIdx.x;
  const size_t head = (size_t)blockIdx.y * n_pad * kSpD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  // Q and dO fragments, staged through Ks and Vs.
  const size_t qtile = head + (size_t)qt * kSpT * kSpD;
  stage_tile(Ks, nullptr, q + qtile);
  stage_tile(Vs, nullptr, dout + qtile);
  __syncthreads();
  uint32_t qa[kSpD / 16][4], da[kSpD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kSpD / 16; ++ks) {
    const bf16* p = Ks + r0 * kLdK + ks * 16 + t * 2;
    const bf16* d = Vs + r0 * kLdK + ks * 16 + t * 2;
    qa[ks][0] = lds32(p);
    qa[ks][1] = lds32(p + 8 * kLdK);
    qa[ks][2] = lds32(p + 8);
    qa[ks][3] = lds32(p + 8 * kLdK + 8);
    da[ks][0] = lds32(d);
    da[ks][1] = lds32(d + 8 * kLdK);
    da[ks][2] = lds32(d + 8);
    da[ks][3] = lds32(d + 8 * kLdK + 8);
  }
  const size_t row = (size_t)blockIdx.y * n_pad + (size_t)qt * kSpT + r0;
  const float lse0 = lse[row], lse1 = lse[row + 8];
  const float dl0 = delta[row], dl1 = delta[row + 8];

  float acc[kSpD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kSpD / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  const int a_end = kv_offsets[qt + 1];
  for (int a = kv_offsets[qt]; a < a_end; ++a) {
    const size_t tile = head + (size_t)kv_index[a] * kSpT * kSpD;
    __syncthreads();  // the previous pair (or the Q/dO staging) is done
    stage_tile(Ks, Kt, k + tile);
    stage_tile(Vs, nullptr, v + tile);
    __syncthreads();
    unsigned long long w0 = ~0ull, w1 = ~0ull;
    if (!full[a]) {
      w0 = words[(size_t)a * kSpT + r0];
      w1 = words[(size_t)a * kSpT + r0 + 8];
    }
    // 16 kv columns at a time: S and dP tiles 2 ks2 and 2 ks2 + 1, dS as
    // the A fragment of k step ks2 of dS K.
#pragma unroll
    for (int ks2 = 0; ks2 < kSpT / 16; ++ks2) {
      uint32_t dsa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * ks2 + half;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* kr = Ks + (nt * 8 + g) * kLdK + t * 2;
        const bf16* vr = Vs + (nt * 8 + g) * kLdK + t * 2;
#pragma unroll
        for (int ks = 0; ks < kSpD / 16; ++ks) {
          const uint32_t bk[2] = {lds32(kr + ks * 16), lds32(kr + ks * 16 + 8)};
          const uint32_t bv[2] = {lds32(vr + ks * 16), lds32(vr + ks * 16 + 8)};
          mma_16816(s, qa[ks], bk);
          mma_16816(dp, da[ks], bv);
        }
        float ds0[2], ds1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + t * 2 + e;
          const float p0 =
              mask_bit(w0, col) ? __expf(s[e] * scale - lse0) : 0.f;
          const float p1 =
              mask_bit(w1, col) ? __expf(s[2 + e] * scale - lse1) : 0.f;
          ds0[e] = p0 * (dp[e] - dl0) * scale;
          ds1[e] = p1 * (dp[2 + e] - dl1) * scale;
        }
        dsa[half * 2] = pack_bf16x2(ds0[0], ds0[1]);
        dsa[half * 2 + 1] = pack_bf16x2(ds1[0], ds1[1]);
      }
#pragma unroll
      for (int dt = 0; dt < kSpD / 8; ++dt) {
        const bf16* kc = Kt + (dt * 8 + g) * kLdVt + ks2 * 16 + t * 2;
        const uint32_t b[2] = {lds32(kc), lds32(kc + 8)};
        mma_16816(acc[dt], dsa, b);
      }
    }
  }

  const size_t out0 = qtile + (size_t)r0 * kSpD;
#pragma unroll
  for (int dt = 0; dt < kSpD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    store_bf16x2(dq + out0 + c, acc[dt][0], acc[dt][1]);
    store_bf16x2(dq + out0 + 8 * kSpD + c, acc[dt][2], acc[dt][3]);
  }
}

__global__ void __launch_bounds__(kSpThreads) splash_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_offsets, const int* __restrict__ q_index,
    const unsigned long long* __restrict__ words_t,
    const int* __restrict__ full_t, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float scale, int n_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);   // [kSpT, kLdK]
  bf16* Vs = Ks + kSpT * kLdK;                // [kSpT, kLdK]
  bf16* Qs = Vs + kSpT * kLdK;                // [kSpT, kLdK]
  bf16* Ds = Qs + kSpT * kLdK;                // [kSpT, kLdK] dO
  bf16* Qt = Ds + kSpT * kLdK;                // [kSpD, kLdVt]
  bf16* Dt = Qt + kSpD * kLdVt;               // [kSpD, kLdVt] dO^T
  float* Ls = reinterpret_cast<float*>(Dt + kSpD * kLdVt);  // [kSpT] lse
  float* Dl = Ls + kSpT;                                     // [kSpT] delta

  const int jt = blockIdx.x;
  const size_t head = (size_t)blockIdx.y * n_pad * kSpD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's kv rows: r0 and r0 + 8

  const size_t kvtile = head + (size_t)jt * kSpT * kSpD;
  stage_tile(Ks, nullptr, k + kvtile);
  stage_tile(Vs, nullptr, v + kvtile);

  float dka[kSpD / 8][4], dva[kSpD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kSpD / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
  }

  const int a_end = q_offsets[jt + 1];
  for (int a = q_offsets[jt]; a < a_end; ++a) {
    const int it = q_index[a];
    const size_t qtile = head + (size_t)it * kSpT * kSpD;
    __syncthreads();  // the previous pair is done with Qs, Ds, Qt, Dt
    stage_tile(Qs, Qt, q + qtile);
    stage_tile(Ds, Dt, dout + qtile);
    if (threadIdx.x < kSpT) {
      const size_t r = (size_t)blockIdx.y * n_pad + (size_t)it * kSpT +
                       threadIdx.x;
      Ls[threadIdx.x] = lse[r];
      Dl[threadIdx.x] = delta[r];
    }
    __syncthreads();
    unsigned long long w0 = ~0ull, w1 = ~0ull;
    if (!full_t[a]) {
      w0 = words_t[(size_t)a * kSpT + r0];
      w1 = words_t[(size_t)a * kSpT + r0 + 8];
    }
    // 16 q columns at a time: S^T and dP^T tiles 2 ks2 and 2 ks2 + 1, P^T
    // and dS^T as the A fragments of k step ks2 of P^T dO and dS^T Q.
#pragma unroll
    for (int ks2 = 0; ks2 < kSpT / 16; ++ks2) {
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * ks2 + half;
        float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* qr = Qs + (nt * 8 + g) * kLdK + t * 2;
        const bf16* dr = Ds + (nt * 8 + g) * kLdK + t * 2;
#pragma unroll
        for (int ks = 0; ks < kSpD / 16; ++ks) {
          const bf16* kp = Ks + r0 * kLdK + ks * 16 + t * 2;
          const bf16* vp = Vs + r0 * kLdK + ks * 16 + t * 2;
          const uint32_t ka[4] = {lds32(kp), lds32(kp + 8 * kLdK),
                                  lds32(kp + 8), lds32(kp + 8 * kLdK + 8)};
          const uint32_t va[4] = {lds32(vp), lds32(vp + 8 * kLdK),
                                  lds32(vp + 8), lds32(vp + 8 * kLdK + 8)};
          const uint32_t bq[2] = {lds32(qr + ks * 16), lds32(qr + ks * 16 + 8)};
          const uint32_t bd[2] = {lds32(dr + ks * 16), lds32(dr + ks * 16 + 8)};
          mma_16816(st, ka, bq);
          mma_16816(dpt, va, bd);
        }
        float p0[2], p1[2], ds0[2], ds1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + t * 2 + e;  // q row of the q tile
          const float lq = Ls[col], dlq = Dl[col];
          p0[e] = mask_bit(w0, col) ? __expf(st[e] * scale - lq) : 0.f;
          p1[e] = mask_bit(w1, col) ? __expf(st[2 + e] * scale - lq) : 0.f;
          ds0[e] = p0[e] * (dpt[e] - dlq) * scale;
          ds1[e] = p1[e] * (dpt[2 + e] - dlq) * scale;
        }
        pa[half * 2] = pack_bf16x2(p0[0], p0[1]);
        pa[half * 2 + 1] = pack_bf16x2(p1[0], p1[1]);
        dsa[half * 2] = pack_bf16x2(ds0[0], ds0[1]);
        dsa[half * 2 + 1] = pack_bf16x2(ds1[0], ds1[1]);
      }
#pragma unroll
      for (int dt = 0; dt < kSpD / 8; ++dt) {
        const bf16* dc = Dt + (dt * 8 + g) * kLdVt + ks2 * 16 + t * 2;
        const bf16* qc = Qt + (dt * 8 + g) * kLdVt + ks2 * 16 + t * 2;
        const uint32_t bd[2] = {lds32(dc), lds32(dc + 8)};
        const uint32_t bq[2] = {lds32(qc), lds32(qc + 8)};
        mma_16816(dva[dt], pa, bd);
        mma_16816(dka[dt], dsa, bq);
      }
    }
  }

  const size_t out0 = kvtile + (size_t)r0 * kSpD;
#pragma unroll
  for (int dt = 0; dt < kSpD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    store_bf16x2(dk + out0 + c, dka[dt][0], dka[dt][1]);
    store_bf16x2(dk + out0 + 8 * kSpD + c, dka[dt][2], dka[dt][3]);
    store_bf16x2(dv + out0 + c, dva[dt][0], dva[dt][1]);
    store_bf16x2(dv + out0 + 8 * kSpD + c, dva[dt][2], dva[dt][3]);
  }
}

}  // namespace gc

// q, k, v, dout, dq: [bh, n_pad, 128] bf16; lse, delta: [bh, n_pad] f32
// (lse 0 past n); the forward map (kv_offsets [nq + 1], kv_index, words
// [n_active, 64], full [n_active]).
extern "C" int gc_splash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* kv_offsets,
                            const int* kv_index, const void* words,
                            const int* full, void* dq, float scale, int bh,
                            int nq, int n_pad, void* stream) {
  using gc::bf16;
  if (bh <= 0 || nq <= 0) return 0;
  const size_t smem = sizeof(bf16) * (2 * gc::kSpT * gc::kLdK +
                                       gc::kSpD * gc::kLdVt);
  cudaError_t err = cudaFuncSetAttribute(
      gc::splash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gc::splash_dq_kernel<<<dim3(nq, bh), gc::kSpThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, kv_offsets, kv_index,
      static_cast<const unsigned long long*>(words), full,
      static_cast<bf16*>(dq), scale, n_pad);
  return cudaGetLastError();
}

// As gc_splash_dq, over the transposed map (q_offsets [nkv + 1], q_index,
// words_t [n_active, 64] one word per kv row, full_t); dk, dv: [bh, n_pad,
// 128] bf16.
extern "C" int gc_splash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* q_offsets,
                             const int* q_index, const void* words_t,
                             const int* full_t, void* dk, void* dv,
                             float scale, int bh, int nkv, int n_pad,
                             void* stream) {
  using gc::bf16;
  if (bh <= 0 || nkv <= 0) return 0;
  const size_t smem = sizeof(bf16) * (4 * gc::kSpT * gc::kLdK +
                                       2 * gc::kSpD * gc::kLdVt) +
                      sizeof(float) * 2 * gc::kSpT;
  cudaError_t err = cudaFuncSetAttribute(
      gc::splash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gc::splash_dkv_kernel<<<dim3(nkv, bh), gc::kSpThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, q_offsets, q_index,
      static_cast<const unsigned long long*>(words_t), full_t,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), scale, n_pad);
  return cudaGetLastError();
}
