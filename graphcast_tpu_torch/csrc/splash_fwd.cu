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
// (hopper.cuh):
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
//     start first; one block fills an SM (~169 KB of shared memory).

#include "common.cuh"
#include "hopper.cuh"

namespace gc {

constexpr int kFwdStages = 4;                       // ring depth
constexpr int kFwdBox = kSpT * 64 * 2;              // a 64 x 64 bf16 box
constexpr int kFwdTile = 2 * kFwdBox;               // a 64 x 128 tile
constexpr int kFwdWords = kSpT * 8;                 // a pair's mask words
constexpr int kFwdThreads = 2 * 128 + 32;           // consumers + producer
constexpr int kFwdSmem = 2 * kFwdTile +
                         kFwdStages * (2 * kFwdTile + 2 * kFwdWords) +
                         (2 * kFwdStages + 1) * 8 + 1024;

// S = Q K^T for one entry into s: 8 k16 steps over the head dim, both
// operands K-major, the first overwriting s. Issues the wgmma.fence; the
// caller commits.
__device__ __forceinline__ void issue_scores(float (&s)[kSpT / 2],
                                             uint32_t q_addr,
                                             uint32_t k_addr) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSpD / 16; ++ks) {
    wgmma_m64n64k16_ss<0, 0>(s, kmajor_desc(q_addr, ks, kFwdBox),
                             kmajor_desc(k_addr, ks, kFwdBox), ks > 0);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The online softmax of this thread's two rows (r0: s[4 j + c], r0 + 8:
// s[4 j + 2 + c], column 8 j + 2 t + c) in base 2: the scores are scaled
// by scale * log2(e) once, so each weight is one ex2 of a difference, and
// m is kept in those units. It masks the scores (this thread's 16 columns
// of words w0, w1, tested at constant shifts), updates (m, l) in f32 and
// packs P = 2^(x - m) in bf16 as the A operand of P V (k step ks covers kv
// columns 16 ks .. 16 ks + 15, accumulator column blocks 2 ks and 2 ks + 1).
// alpha = 2^(m_old - m_new) rescales O. It reads s and never writes it: the
// scores are a wgmma's accumulator, and a non-wgmma definition of one
// would serialise the products.
struct SoftmaxRows {
  float m0 = kSpNegInf, m1 = kSpNegInf, l0 = 0.f, l1 = 0.f;

  __device__ __forceinline__ void step(const float (&s)[kSpT / 2],
                                       unsigned long long w0,
                                       unsigned long long w1, float scale2,
                                       int t, uint32_t (&pa)[kSpT / 16][4],
                                       float* alpha0 = nullptr,
                                       float* alpha1 = nullptr) {
    // Bit 8 j + c of (w >> 2 t): column 8 j + 2 t + c; j < 4 in the low
    // word, j >= 4 in the high one.
    const unsigned long long v0 = w0 >> (2 * t), v1 = w1 >> (2 * t);
    const uint32_t lo0 = (uint32_t)v0, hi0 = (uint32_t)(v0 >> 32);
    const uint32_t lo1 = (uint32_t)v1, hi1 = (uint32_t)(v1 >> 32);
    float x[kSpT / 2];
    float mx0 = kSpNegInf, mx1 = kSpNegInf;
#pragma unroll
    for (int j = 0; j < kSpT / 8; ++j) {
      const uint32_t b0 = j < 4 ? lo0 : hi0, b1 = j < 4 ? lo1 : hi1;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t bit = 1u << (8 * (j % 4) + c);
        x[4 * j + c] = (b0 & bit) ? s[4 * j + c] * scale2 : kSpNegInf;
        x[4 * j + 2 + c] = (b1 & bit) ? s[4 * j + 2 + c] * scale2 : kSpNegInf;
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

__global__ void __launch_bounds__(kFwdThreads, 1) splash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const int* __restrict__ group_offsets, const int* __restrict__ group_kv,
    const int2* __restrict__ group_pairs, const int* __restrict__ group_order,
    const unsigned long long* __restrict__ words,
    const int* __restrict__ full, bf16* __restrict__ o,
    float* __restrict__ lse, float scale, int nq, int n_pad, int bh) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Qs = smem;                 // q tiles 2g, 2g + 1
  unsigned char* KV = smem + 2 * kFwdTile;  // stage s: K, then V
  unsigned long long* Ws = reinterpret_cast<unsigned long long*>(
      KV + kFwdStages * 2 * kFwdTile);  // [stages][2 tiles][kSpT]
  uint64_t* full_bar =
      reinterpret_cast<uint64_t*>(Ws + kFwdStages * 2 * kSpT);
  uint64_t* empty_bar = full_bar + kFwdStages;
  uint64_t* q_bar = empty_bar + kFwdStages;

  const int grp = group_order[blockIdx.x / bh];
  const int h = blockIdx.x % bh;
  const int row0 = h * n_pad;  // the head's first row in [bh * n_pad, 128]
  const int tiles = min(2, nq - 2 * grp);  // q tiles in the pair
  const int e_begin = group_offsets[grp], e_end = group_offsets[grp + 1];
  // The warp index, warp-uniform as ptxas sees it (a broadcast).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 8);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, tiles * kFwdTile);
      for (int w = 0; w < tiles; ++w) {
        const int qr = row0 + (2 * grp + w) * kSpT;
        tma_load_2d(Qs + w * kFwdTile, &tq, q_bar, 0, qr);
        tma_load_2d(Qs + w * kFwdTile + kFwdBox, &tq, q_bar, 64, qr);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int e = e_begin; e < e_end; ++e) {
        const int2 pr = group_pairs[e];
        const bool w0 = pr.x >= 0 && !full[pr.x];
        const bool w1 = pr.y >= 0 && !full[pr.y];
        mbar_wait(&empty_bar[stage], phase ^ 1);
        uint64_t* bar = &full_bar[stage];
        mbar_arrive_expect_tx(bar, 2 * kFwdTile + (w0 + w1) * kFwdWords);
        unsigned char* kd = KV + stage * 2 * kFwdTile;
        const int kr = row0 + group_kv[e] * kSpT;
        tma_load_2d(kd, &tk, bar, 0, kr);
        tma_load_2d(kd + kFwdBox, &tk, bar, 64, kr);
        tma_load_2d(kd + kFwdTile, &tv, bar, 0, kr);
        tma_load_2d(kd + kFwdTile + kFwdBox, &tv, bar, 64, kr);
        unsigned long long* ws = Ws + stage * 2 * kSpT;
        if (w0) bulk_load(ws, words + (size_t)pr.x * kSpT, kFwdWords, bar);
        if (w1) {
          bulk_load(ws + kSpT, words + (size_t)pr.y * kSpT, kFwdWords, bar);
        }
        if (++stage == kFwdStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg, q tile 2 grp + wg: warp w of it owns q rows
  // 16 w .. 16 w + 15; this thread rows r0 and r0 + 8, columns 8 j + 2 t
  // (+1) of each accumulator. Entries where the tile has no pair run with
  // all-zero mask words (3.7 % of the entries at mesh-5), so every entry
  // keeps the same pipeline: their weights are exactly 0 once a row has
  // met an entry of its mask, and whatever they add before that is scaled
  // by exactly 0 when it does, so a row with any mask entry gets the result
  // of its tile's own pairs. (A row with none, such as the padding past n,
  // averages v over every entry's columns instead of its own pairs'.)
  // The pipeline, per entry i: S(i + 1) = Q K(i + 1)^T and O += P(i) V(i)
  // are issued together, the softmax of S(i + 1) runs under P(i) V(i), and
  // O is rescaled once P(i) V(i) is done.
  const int wg = warp / 4;
  const int qt = 2 * grp + wg;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % 4) * 16 + g;
  float acc[kSpD / 2];
#pragma unroll
  for (int i = 0; i < kSpD / 2; ++i) acc[i] = 0.f;
  SoftmaxRows sm;
  const float scale2 = scale * kLog2e;
  mbar_wait(q_bar, 0);
  const uint32_t q_addr = smem_u32(Qs + wg * kFwdTile);

  // The stage of entry e and its words for this tile (all zero where the
  // tile has no pair, all ones where the pair is full).
  auto stage_of = [&](int e) { return (e - e_begin) % kFwdStages; };
  auto row_words = [&](int e, unsigned long long& w0,
                       unsigned long long& w1) {
    const int2 pr = group_pairs[e];
    const int a = wg == 0 ? pr.x : pr.y;
    w0 = w1 = a < 0 ? 0ull : ~0ull;
    if (a >= 0 && !full[a]) {
      const unsigned long long* ws = Ws + (stage_of(e) * 2 + wg) * kSpT;
      w0 = ws[r0];
      w1 = ws[r0 + 8];
    }
  };
  auto kv_addr = [&](int e) {
    return smem_u32(KV + stage_of(e) * 2 * kFwdTile);
  };
  auto phase_of = [&](int e) {
    return (uint32_t)(((e - e_begin) / kFwdStages) & 1);
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
    mbar_wait(&full_bar[stage_of(e)], phase_of(e));
    issue_scores(s, q_addr, kv_addr(e));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    unsigned long long w0, w1;
    row_words(e, w0, w1);
    sm.step(s, w0, w1, scale2, t, pa);  // O is zero: no rescale needed
  }
  // Entry e, which has a next one: P(e) in cur, P(e + 1) into nxt.
  auto body = [&](int e, uint32_t(&cur)[kSpT / 16][4],
                  uint32_t(&nxt)[kSpT / 16][4]) {
    mbar_wait(&full_bar[stage_of(e + 1)], phase_of(e + 1));
    // O's rescale and P's registers are settled before the wgmma.fence.
    fence_operands(acc);
    fence_operands(cur);
    issue_scores(s, q_addr, kv_addr(e + 1));
    wgmma_commit();
    const uint32_t v_addr = kv_addr(e) + kFwdTile;
#pragma unroll
    for (int ks = 0; ks < kSpT / 16; ++ks) {
      wgmma_m64n128k16_rs<1>(acc, cur[ks], mnmajor_desc(v_addr, ks, kFwdBox));
    }
    wgmma_commit();
    wgmma_wait<1>();  // S(e + 1) is done; P(e) V(e) may still run
    fence_operands(s);
    unsigned long long w0, w1;
    row_words(e + 1, w0, w1);
    float alpha0, alpha1;
    sm.step(s, w0, w1, scale2, t, nxt, &alpha0, &alpha1);
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(cur);
    if (lane == 0) mbar_arrive(&empty_bar[stage_of(e)]);
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
    const uint32_t v_addr = kv_addr(e) + kFwdTile;
#pragma unroll
    for (int ks = 0; ks < kSpT / 16; ++ks) {
      wgmma_m64n128k16_rs<1>(acc, cur[ks], mnmajor_desc(v_addr, ks, kFwdBox));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(cur);
    if (lane == 0) mbar_arrive(&empty_bar[stage_of(e)]);
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
  const size_t orow = ((size_t)row0 + (size_t)qt * kSpT + r0) * kSpD;
#pragma unroll
  for (int j = 0; j < kSpD / 8; ++j) {
    const int c = j * 8 + t * 2;
    store_bf16x2(o + orow + c, acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    store_bf16x2(o + orow + 8 * kSpD + c, acc[4 * j + 2] * inv1,
                 acc[4 * j + 3] * inv1);
  }
  if (t == 0) {
    float* lrow = lse + (size_t)row0 + (size_t)qt * kSpT + r0;
    lrow[0] = sm.lse(m0, ls0);
    lrow[8] = sm.lse(m1, ls1);
  }
}

}  // namespace gc

// q, k, v, o: [bh, n_pad, 128] bf16; lse: [bh, n_pad] f32; n_pad = nq * 64.
// The work lists of ops/splash.py paired_lists: group_offsets [groups + 1],
// group_kv [entries], group_pairs [entries, 2], group_order [groups].
extern "C" int gc_splash_fwd(const void* q, const void* k, const void* v,
                             const int* group_offsets, const int* group_kv,
                             const void* group_pairs, const int* group_order,
                             const void* words, const int* full, void* o,
                             float* lse, float scale, int bh, int nq,
                             int groups, int n_pad, void* stream) {
  using gc::bf16;
  if (bh <= 0 || nq <= 0) return 0;
  if (groups != (nq + 1) / 2) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const uint64_t rows = (uint64_t)bh * n_pad;
  cudaError_t err = gc::bf16_tile_map(&tq, q, rows, gc::kSpD, gc::kSpD,
                                      gc::kSpT);
  if (err == cudaSuccess) {
    err = gc::bf16_tile_map(&tk, k, rows, gc::kSpD, gc::kSpD, gc::kSpT);
  }
  if (err == cudaSuccess) {
    err = gc::bf16_tile_map(&tv, v, rows, gc::kSpD, gc::kSpD, gc::kSpT);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gc::splash_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gc::kFwdSmem);
  if (err != cudaSuccess) return err;
  gc::splash_fwd_kernel<<<groups * bh, gc::kFwdThreads, gc::kFwdSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, group_offsets, group_kv,
      static_cast<const int2*>(group_pairs), group_order,
      static_cast<const unsigned long long*>(words), full,
      static_cast<bf16*>(o), lse, scale, nq, n_pad, bh);
  return cudaGetLastError();
}

// Dynamic shared memory of splash_fwd_kernel, in bytes.
extern "C" int gc_splash_fwd_smem() { return gc::kFwdSmem; }
