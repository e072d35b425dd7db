// K6: block-sparse flash attention, forward, for Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/splash.py::_fwd_kernel (driven by _fwd). For
// one batch·head slice and every query row i, over the entries j of a
// static mask (GenCast's k-hop mesh mask):
//
//   s_ij = q_i . k_j * scale   (f32; entries outside the mask at -1e30)
//   o_i  = sum_j exp(s_ij - m_i) v_j / l_i,   l_i = sum_j exp(s_ij - m_i)
//   lse_i = m_i + log l_i      (l == 0 guarded as 1, as the TPU kernel does)
//
// The mask arrives compiled on the host (ops/splash.py BlockMap) at 64 x 64
// tiles: per q tile, a CSR list of the kv tiles that hold any entry, and for
// each pair one 64-bit word per q row (bit c: kv column c of the tile is in
// the mask), plus a flag for pairs whose words are all ones.
//
// What bounds it on an H100: the two 64x64x128 products per active pair
// (QK^T and PV, 2.1 MFLOP) against 32 KB of K and V per pair, which all
// blocks of a head read from L2 (the k-hop mask keeps a q tile's kv tiles
// few and near); at mesh-5 the mask needs 8,161 active pairs a head. Design:
//   * one block of 4 warps per (q tile, batch·head); each warp owns 16 q
//     rows and keeps its Q fragments, its S tile (16 x 64) and its O
//     accumulator (16 x 128, f32) in registers through mma.sync
//     m16n8k16 bf16 with f32 accumulation (flash-attention 2 layout: the
//     S accumulator becomes P's A fragment without going through shared
//     memory);
//   * per active pair, K is staged row-major and V transposed in shared
//     memory (52 KB in all), so every fragment load is one 32-bit word;
//   * the online softmax keeps (m, l) per row in f32; P is rounded to bf16
//     before the PV product, as the TPU kernel rounds it (splash.py:253);
//   * a full pair skips the mask words.
// Simple first: no cp.async/TMA pipelining of the K/V loads and no wgmma;
// those are a later step.

#include "common.cuh"

namespace gc {

__global__ void __launch_bounds__(kSpThreads) splash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ kv_offsets,
    const int* __restrict__ kv_index,
    const unsigned long long* __restrict__ words,
    const int* __restrict__ full, bf16* __restrict__ o,
    float* __restrict__ lse, float scale, int n_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // [kSpT, kLdK]
  bf16* Ks = Qs + kSpT * kLdK;                // [kSpT, kLdK]
  bf16* Vt = Ks + kSpT * kLdK;                // [kSpD, kLdVt]

  const int qt = blockIdx.x;
  const size_t head = (size_t)blockIdx.y * n_pad * kSpD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const bf16* qg = q + head + (size_t)qt * kSpT * kSpD;
  for (int i = threadIdx.x; i < kSpT * kSpD / 8; i += kSpThreads) {
    const int r = i / (kSpD / 8), c = (i % (kSpD / 8)) * 8;
    *reinterpret_cast<uint4*>(Qs + r * kLdK + c) =
        *reinterpret_cast<const uint4*>(qg + (size_t)r * kSpD + c);
  }
  __syncthreads();
  uint32_t qa[kSpD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kSpD / 16; ++ks) {
    const bf16* p = Qs + r0 * kLdK + ks * 16 + t * 2;
    qa[ks][0] = lds32(p);
    qa[ks][1] = lds32(p + 8 * kLdK);
    qa[ks][2] = lds32(p + 8);
    qa[ks][3] = lds32(p + 8 * kLdK + 8);
  }

  float acc[kSpD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kSpD / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m0 = kSpNegInf, m1 = kSpNegInf, l0 = 0.f, l1 = 0.f;

  const int a_end = kv_offsets[qt + 1];
  for (int a = kv_offsets[qt]; a < a_end; ++a) {
    const size_t tile = head + (size_t)kv_index[a] * kSpT * kSpD;
    __syncthreads();  // the previous pair is done with Ks and Vt
    for (int i = threadIdx.x; i < kSpT * kSpD / 8; i += kSpThreads) {
      const int r = i / (kSpD / 8), c = (i % (kSpD / 8)) * 8;
      *reinterpret_cast<uint4*>(Ks + r * kLdK + c) =
          *reinterpret_cast<const uint4*>(k + tile + (size_t)r * kSpD + c);
      const uint4 vv =
          *reinterpret_cast<const uint4*>(v + tile + (size_t)r * kSpD + c);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * kLdVt + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows: 8 tiles of 8 kv columns.
    float s[kSpT / 8][4];
#pragma unroll
    for (int nt = 0; nt < kSpT / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = Ks + (nt * 8 + g) * kLdK + t * 2;
#pragma unroll
      for (int ks = 0; ks < kSpD / 16; ++ks) {
        const uint32_t b[2] = {lds32(kr + ks * 16), lds32(kr + ks * 16 + 8)};
        mma_16816(s[nt], qa[ks], b);
      }
    }

    // Scale, mask, online softmax (rows r0: s[.][0..1], r0+8: s[.][2..3]).
    unsigned long long w0 = ~0ull, w1 = ~0ull;
    if (!full[a]) {
      w0 = words[(size_t)a * kSpT + r0];
      w1 = words[(size_t)a * kSpT + r0 + 8];
    }
    float mx0 = kSpNegInf, mx1 = kSpNegInf;
#pragma unroll
    for (int nt = 0; nt < kSpT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + t * 2 + e;
        const float x0 = ((w0 >> col) & 1ull) ? s[nt][e] * scale : kSpNegInf;
        const float x1 =
            ((w1 >> col) & 1ull) ? s[nt][2 + e] * scale : kSpNegInf;
        s[nt][e] = x0;
        s[nt][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P in bf16 as the A fragments of P.V: k step ks covers kv columns
    // 16ks..16ks+15, i.e. S tiles 2ks (a0, a1) and 2ks+1 (a2, a3).
    uint32_t pa[kSpT / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kSpT / 8; ++nt) {
      const float p00 = __expf(s[nt][0] - mn0), p01 = __expf(s[nt][1] - mn0);
      const float p10 = __expf(s[nt][2] - mn1), p11 = __expf(s[nt][3] - mn1);
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      pa[nt / 2][(nt % 2) * 2] = pack_bf16x2(p00, p01);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16x2(p10, p11);
    }
    l0 = l0 * alpha0 + quad_sum(ps0);
    l1 = l1 * alpha1 + quad_sum(ps1);

    // O = O * alpha + P V: 16 tiles of 8 head-dim columns.
#pragma unroll
    for (int dt = 0; dt < kSpD / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
      const bf16* vr = Vt + (dt * 8 + g) * kLdVt + t * 2;
#pragma unroll
      for (int ks = 0; ks < kSpT / 16; ++ks) {
        const uint32_t b[2] = {lds32(vr + ks * 16), lds32(vr + ks * 16 + 8)};
        mma_16816(acc[dt], pa[ks], b);
      }
    }
  }

  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  const size_t row0 = head + ((size_t)qt * kSpT + r0) * kSpD;
#pragma unroll
  for (int dt = 0; dt < kSpD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    store_bf16x2(o + row0 + c, acc[dt][0] * inv0, acc[dt][1] * inv0);
    store_bf16x2(o + row0 + 8 * kSpD + c, acc[dt][2] * inv1,
                 acc[dt][3] * inv1);
  }
  if (t == 0) {
    float* lrow = lse + (size_t)blockIdx.y * n_pad + (size_t)qt * kSpT + r0;
    lrow[0] = m0 + logf(ls0);
    lrow[8] = m1 + logf(ls1);
  }
}

}  // namespace gc

// q, k, v, o: [bh, n_pad, 128] bf16; lse: [bh, n_pad] f32; n_pad = nq * 64.
extern "C" int gc_splash_fwd(const void* q, const void* k, const void* v,
                             const int* kv_offsets, const int* kv_index,
                             const void* words, const int* full, void* o,
                             float* lse, float scale, int bh, int nq,
                             int n_pad, void* stream) {
  using gc::bf16;
  if (bh <= 0 || nq <= 0) return 0;
  const size_t smem = sizeof(bf16) * (2 * gc::kSpT * gc::kLdK +
                                       gc::kSpD * gc::kLdVt);
  cudaError_t err = cudaFuncSetAttribute(
      gc::splash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gc::splash_fwd_kernel<<<dim3(nq, bh), gc::kSpThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv_offsets, kv_index,
      static_cast<const unsigned long long*>(words), full,
      static_cast<bf16*>(o), lse, scale, n_pad);
  return cudaGetLastError();
}
