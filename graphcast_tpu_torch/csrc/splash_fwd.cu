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
// (QK^T and PV, 2.1 MFLOP) and the softmax between them. At mesh-5 the
// mask needs 8,161 active pairs a head, 130,576 at the ensemble's 16 heads
// (274 GFLOP, 0.28 ms at the tensor cores' peak), but only a quarter of
// each pair's 64 x 64 entries are in the mask, and every entry of a pair
// costs the same products and ~9 instructions of softmax a thread. Read a
// pair at a time, K and V would cost 4.3 GB of L2 traffic there; pairing q
// tiles (below) halves that. What remains is the chain per entry: the
// products, and the softmax that the next products wait for. Design
// (hopper.cuh; the ring and mask words it shares with K7 and K8 are in
// splash.cuh):
//   * one block per (pair of neighbouring q tiles 2g, 2g + 1, batch·head):
//     one producer warp and two consumer warpgroups, one per q tile. The
//     block walks the union of the two tiles' kv lists (ops/splash.py
//     paired_lists), so each K and V tile it loads serves both q tiles
//     where both attend it: the k-hop mask's neighbouring q tiles share
//     about half their kv tiles (4,230 union entries for 8,161 pairs at
//     mesh-5);
//   * the producer loads the pair's Q tiles once (64-column TMA boxes,
//     128-byte swizzle) and streams each union entry's K and V tiles, and
//     each of its two pairs' 512 bytes of mask words unless the pair is
//     full or absent, into a 4-stage ring with full/empty mbarriers;
//   * each consumer warpgroup, for each entry, runs S = Q K^T as 8 wgmma
//     m64n64k16 with both operands K-major in shared memory, then scale,
//     mask and the online softmax on the accumulator in registers (m, l
//     per row in f32), rounds P to bf16 as the TPU kernel rounds it
//     (splash.py:253), and runs O += P V as 4 wgmma m64n128k16 with P as
//     the register A operand (the m64n64 accumulator's layout is the A
//     fragment's) and V read MN-major straight from its TMA tile, so no
//     transpose is made. The products of consecutive entries overlap the
//     softmax: S of the next entry and P V of this one are issued together
//     and the next entry's softmax runs while P V does. An entry where the
//     warpgroup's q tile has no pair runs with all-zero mask words;
//     the softmax is taken in base 2 (the scale folded with log2 e, one
//     ex2 per weight) and tests this thread's mask bits at constant shifts;
//     every wgmma sits outside any branch and P alternates between two
//     register sets, which keeps ptxas from serialising the products;
//   * the grid walks the q tile pairs heaviest first (union lists of 31-68
//     kv tiles at mesh-5), each pair's heads together, so the long lists
//     start first; one block fills an SM (~169 KB of shared memory);
//   * q and kv rows are counted apart (n_pad, n_pad_kv): a sequence-parallel
//     shard runs its own q tiles against every kv tile (ops/splash.py
//     shard_block_maps) with no other change; a q row sees the same kv
//     tiles in the same order as in the whole map.

#include "splash.cuh"

namespace gc {

constexpr int kFwdSmem = splash_smem(1, false);

// The online softmax of this thread's two rows (r0: s[4 j + c], r0 + 8:
// s[4 j + 2 + c], column 8 j + 2 t + c) in base 2: the scores are scaled
// by scale * log2(e) once, so each weight is one ex2 of a difference, and
// m is kept in those units. It masks the scores (the rows' bits b0, b1),
// updates (m, l) in f32 and packs P = 2^(x - m) in bf16 as the A operand
// of P V (k step ks covers kv columns 16 ks .. 16 ks + 15, accumulator
// column blocks 2 ks and 2 ks + 1).
// alpha = 2^(m_old - m_new) rescales O. It reads s and never writes it: the
// scores are a wgmma's accumulator, and a non-wgmma definition of one
// would serialise the products.
struct SoftmaxRows {
  float m0 = kSpNegInf, m1 = kSpNegInf, l0 = 0.f, l1 = 0.f;

  __device__ __forceinline__ void step(const float (&s)[kSpT / 2],
                                       const RowBits& b0, const RowBits& b1,
                                       float scale2,
                                       uint32_t (&pa)[kSpT / 16][4],
                                       float* alpha0 = nullptr,
                                       float* alpha1 = nullptr) {
    float x[kSpT / 2];
    float mx0 = kSpNegInf, mx1 = kSpNegInf;
#pragma unroll
    for (int j = 0; j < kSpT / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        x[4 * j + c] = b0.has(j, c) ? s[4 * j + c] * scale2 : kSpNegInf;
        x[4 * j + 2 + c] =
            b1.has(j, c) ? s[4 * j + 2 + c] * scale2 : kSpNegInf;
        mx0 = fmaxf(mx0, x[4 * j + c]);
        mx1 = fmaxf(mx1, x[4 * j + 2 + c]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kSpT / 8; ++j) {
      const float p00 = fast_exp2(x[4 * j] - mn0);
      const float p01 = fast_exp2(x[4 * j + 1] - mn0);
      const float p10 = fast_exp2(x[4 * j + 2] - mn1);
      const float p11 = fast_exp2(x[4 * j + 3] - mn1);
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      pa[j / 2][(j % 2) * 2] = pack_bf16x2(p00, p01);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(p10, p11);
    }
    l0 = l0 * a0 + quad_sum(ps0);
    l1 = l1 * a1 + quad_sum(ps1);
    if (alpha0 != nullptr) {
      *alpha0 = a0;
      *alpha1 = a1;
    }
  }

  // The row's logsumexp in natural units (-1e30 + log l for a row that met
  // no entry of its mask, as before the change of base).
  __device__ __forceinline__ float lse(float m, float ls) const {
    return (m == kSpNegInf ? kSpNegInf : m * kLn2) + logf(ls);
  }
};

__global__ void __launch_bounds__(kSpBlockThreads, 1) splash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const int* __restrict__ group_offsets, const int* __restrict__ group_kv,
    const int2* __restrict__ group_pairs, const int* __restrict__ group_order,
    const unsigned long long* __restrict__ words,
    const int* __restrict__ full, bf16* __restrict__ o,
    float* __restrict__ lse, float scale, int nq, int n_pad, int n_pad_kv,
    int bh) {
  extern __shared__ unsigned char smem_raw[];
  const SplashSmem sh(smem_raw, 1, false);  // own: q tiles 2g, 2g + 1
  const int grp = group_order[blockIdx.x / bh];
  const int row0 = (blockIdx.x % bh) * n_pad;        // the head's first q row
  const int kv_row0 = (blockIdx.x % bh) * n_pad_kv;  // and first kv row
  const int e_begin = group_offsets[grp], e_end = group_offsets[grp + 1];
  // The warp index, warp-uniform as ptxas sees it (a broadcast).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) sh.init();
  __syncthreads();

  if (warp == 8) {  // the producer warp
    if (lane == 0) {
      sh.load_own(&tq, nullptr, row0, grp, min(2, nq - 2 * grp));
      for (int e = e_begin; e < e_end; ++e) {
        sh.stream(e - e_begin, e, &tk, &tv, kv_row0 + group_kv[e] * kSpT,
                  group_pairs, full, words, 0);
      }
    }
    return;
  }

  // Consumer warpgroup wg, q tile 2 grp + wg (Lane). Entries where the
  // tile has no pair run with all-zero mask words (3.7 % of the entries at
  // mesh-5), so every entry keeps the same pipeline: their weights are
  // exactly 0 once a row has met an entry of its mask, and whatever they
  // add before that is scaled by exactly 0 when it does, so a row with any
  // mask entry gets the result of its tile's own pairs. (A row with none,
  // such as the padding past n, averages v over every entry's columns
  // instead of its own pairs'.)
  // The pipeline, per entry i: S(i + 1) = Q K(i + 1)^T and O += P(i) V(i)
  // are issued together, the softmax of S(i + 1) runs under P(i) V(i), and
  // O is rescaled once P(i) V(i) is done.
  const Lane ln(warp, lane);
  const int qt = 2 * grp + ln.wg;
  float acc[kSpD / 2];
#pragma unroll
  for (int i = 0; i < kSpD / 2; ++i) acc[i] = 0.f;
  SoftmaxRows sm;
  const float scale2 = scale * kLog2e;
  mbar_wait(sh.own_bar, 0);
  const uint32_t q_addr = smem_u32(sh.own[0] + ln.wg * kSpTile);
  // Entry e sits at stream position e - e_begin: waiting for its stage,
  // its tiles, this tile's mask bits of it, and handing its stage back.
  auto wait_full = [&](int e) {
    mbar_wait(&sh.full_bar[ring_stage(e - e_begin)], ring_phase(e - e_begin));
  };
  auto kv_addr = [&](int e) { return sh.streamed(e - e_begin); };
  auto bits = [&](int e, RowBits& b0, RowBits& b1) {
    entry_bits(sh, group_pairs, full, e - e_begin, e, ln, b0, b1);
  };
  auto release = [&](int e) {
    if (lane == 0) mbar_arrive(&sh.empty_bar[ring_stage(e - e_begin)]);
  };

  // Every wgmma below sits in a loop with a block-uniform trip count and
  // in no branch (the first entry, the entries with a next one, two at a
  // time, the last entry), so that ptxas keeps the products asynchronous.
  // P alternates between two register sets, pa and pb: a copy from one to
  // the other would be a non-wgmma definition of P V's input registers,
  // which serialises the products too.
  float s[kSpT / 2];
  uint32_t pa[kSpT / 16][4], pb[kSpT / 16][4];
  const int e_first_end = min(e_begin + 1, e_end);
  for (int e = e_begin; e < e_first_end; ++e) {  // the first entry's S
    wait_full(e);
    issue_scores(s, q_addr, kv_addr(e));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    RowBits b0, b1;
    bits(e, b0, b1);
    sm.step(s, b0, b1, scale2, pa);  // O is zero: no rescale needed
  }
  // Entry e, which has a next one: P(e) in cur, P(e + 1) into nxt.
  auto body = [&](int e, uint32_t(&cur)[kSpT / 16][4],
                  uint32_t(&nxt)[kSpT / 16][4]) {
    wait_full(e + 1);
    // O's rescale and P's registers are settled before the wgmma.fence.
    fence_operands(acc);
    fence_operands(cur);
    issue_scores(s, q_addr, kv_addr(e + 1));
    wgmma_commit();
    const uint32_t v_addr = kv_addr(e) + kSpTile;
#pragma unroll
    for (int ks = 0; ks < kSpT / 16; ++ks) {
      wgmma_m64n128k16_rs<1>(acc, cur[ks], mnmajor_desc(v_addr, ks, kSpBox));
    }
    wgmma_commit();
    wgmma_wait<1>();  // S(e + 1) is done; P(e) V(e) may still run
    fence_operands(s);
    RowBits b0, b1;
    bits(e + 1, b0, b1);
    float alpha0, alpha1;
    sm.step(s, b0, b1, scale2, nxt, &alpha0, &alpha1);
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(cur);
    release(e);
#pragma unroll
    for (int j = 0; j < kSpD / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }
  };
  // The last entry's P V, P in cur.
  auto last = [&](int e, uint32_t(&cur)[kSpT / 16][4]) {
    fence_operands(acc);
    fence_operands(cur);
    wgmma_fence();
    const uint32_t v_addr = kv_addr(e) + kSpTile;
#pragma unroll
    for (int ks = 0; ks < kSpT / 16; ++ks) {
      wgmma_m64n128k16_rs<1>(acc, cur[ks], mnmajor_desc(v_addr, ks, kSpBox));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(cur);
    release(e);
  };
  const int with_next = max(e_end - e_begin - 1, 0);  // entries with a next
  const int pairs_end = e_begin + (with_next & ~1);
  for (int e = e_begin; e < pairs_end; e += 2) {
    body(e, pa, pb);
    body(e + 1, pb, pa);
  }
  // An odd count leaves one more entry with a next one (P in pa), and the
  // last entry's P in pb; an even count leaves the last entry's P in pa.
  const int odd = with_next & 1;
  for (int e = pairs_end; e < pairs_end + odd; ++e) {
    body(e, pa, pb);
    last(e + 1, pb);
  }
  const int even_last = e_end > e_begin && !odd;
  for (int e = e_end - 1; e < e_end - 1 + even_last; ++e) last(e, pa);
  const float m0 = sm.m0, m1 = sm.m1, l0 = sm.l0, l1 = sm.l1;
  if (qt >= nq) return;  // the odd last tile's missing partner

  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  const size_t orow = ((size_t)row0 + (size_t)qt * kSpT + ln.r0) * kSpD;
#pragma unroll
  for (int j = 0; j < kSpD / 8; ++j) {
    const int c = j * 8 + ln.t * 2;
    store_bf16x2(o + orow + c, acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    store_bf16x2(o + orow + 8 * kSpD + c, acc[4 * j + 2] * inv1,
                 acc[4 * j + 3] * inv1);
  }
  if (ln.t == 0) {
    float* lrow = lse + (size_t)row0 + (size_t)qt * kSpT + ln.r0;
    lrow[0] = sm.lse(m0, ls0);
    lrow[8] = sm.lse(m1, ls1);
  }
}

}  // namespace gc

// q, o: [bh, n_pad, 128] bf16; k, v: [bh, n_pad_kv, 128] bf16; lse:
// [bh, n_pad] f32; n_pad = nq * 64.
// The work lists of ops/splash.py paired_lists: group_offsets [groups + 1],
// group_kv [entries], group_pairs [entries, 2], group_order [groups].
extern "C" int gc_splash_fwd(const void* q, const void* k, const void* v,
                             const int* group_offsets, const int* group_kv,
                             const void* group_pairs, const int* group_order,
                             const void* words, const int* full, void* o,
                             float* lse, float scale, int bh, int nq,
                             int groups, int n_pad, int n_pad_kv,
                             void* stream) {
  using gc::bf16;
  if (bh <= 0 || nq <= 0) return 0;
  if (groups != (nq + 1) / 2) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const uint64_t rows = (uint64_t)bh * n_pad;
  const uint64_t kv_rows = (uint64_t)bh * n_pad_kv;
  cudaError_t err = gc::bf16_tile_map(&tq, q, rows, gc::kSpD, gc::kSpD,
                                      gc::kSpT);
  if (err == cudaSuccess) {
    err = gc::bf16_tile_map(&tk, k, kv_rows, gc::kSpD, gc::kSpD, gc::kSpT);
  }
  if (err == cudaSuccess) {
    err = gc::bf16_tile_map(&tv, v, kv_rows, gc::kSpD, gc::kSpD, gc::kSpT);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gc::splash_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gc::kFwdSmem);
  if (err != cudaSuccess) return err;
  gc::splash_fwd_kernel<<<groups * bh, gc::kSpBlockThreads, gc::kFwdSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, group_offsets, group_kv,
      static_cast<const int2*>(group_pairs), group_order,
      static_cast<const unsigned long long*>(words), full,
      static_cast<bf16*>(o), lse, scale, nq, n_pad, n_pad_kv, bh);
  return cudaGetLastError();
}

// Dynamic shared memory of splash_fwd_kernel, in bytes.
extern "C" int gc_splash_fwd_smem() { return gc::kFwdSmem; }
