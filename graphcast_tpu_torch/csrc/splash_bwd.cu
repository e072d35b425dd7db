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
// that job here: each block owns its output rows and walks its list in a
// fixed order, so neither kernel needs atomics and a rerun is bit-equal.
//
// What bounds them on an H100: per active (q tile, kv tile) pair, the
// 64x64x128 products (K7: S, dP, dQ; K8: S^T, dP^T, dV, dK) and the
// exponentials between them. Only ~25 % of a pair's entries are in the
// k-hop mask, but every entry of an active tile costs the same, so the
// products over the active tiles, ~4x the entries' own, are the floor.
// Design, on K6's (hopper.cuh, and the ring and mask words of splash.cuh):
//   * one block per (pair of neighbouring tiles 2g, 2g + 1, batch·head),
//     walking the union of the two tiles' lists (ops/splash.py
//     paired_lists), heaviest first: K7 over the forward map's q tiles,
//     K8 over the transposed map's kv tiles. Each streamed tile then serves
//     both of the block's tiles where both have a pair with it;
//   * a producer warp loads the block's own tiles once (K7: Q and dO; K8: K
//     and V) and streams each union entry's other two tiles (K7: K and V;
//     K8: Q and dO, with the q tile's 64 lse and 64 delta values) and each
//     present, not full pair's 512 bytes of mask words by TMA (64-column
//     boxes, 128-byte swizzle) into a 4-stage ring with full/empty
//     mbarriers. An entry where a tile has no pair runs with all-zero
//     words, a full pair with all-one words, so every entry keeps the same
//     pipeline; an all-zero word gives p = 0 exactly, so such entries add
//     exactly 0;
//   * two consumer warpgroups, one per tile of the pair. Per entry: the
//     score products as wgmma m64n64k16 with both operands K-major; p and
//     ds in registers, the exponential in base 2 (one ex2 each) with the
//     mask bits tested at constant shifts; bf16(p), bf16(ds) packed
//     straight into the register A operand; and the gradient product as
//     wgmma m64n128k16 with the streamed tile (K7: K; K8: dO, then Q) read
//     MN-major from its TMA tile, so no tile is ever transposed. A
//     warpgroup's products wait for its own exponentials and its
//     exponentials for its products; the other warpgroup's products run in
//     between;
//   * registers decide the rest: ptxas keeps a warpgroup's products
//     asynchronous only while its live accumulators and A operands fit.
//     K7 holds dQ (64 f32 a thread), S and dP (32 each) and bf16(dS) (16).
//     Holding dK and dV (128) besides S^T and dP^T, K8 had ptxas spill dK
//     and dV around every product and serialise all of them, at 168
//     registers a thread and at 240 under setmaxnreg alike (as did issuing
//     the next entry's scores beside this entry's gradient product, in
//     both kernels). So K8 walks its list twice: dV += bf16(P^T) dO (S^T,
//     then dV: 2 products an entry), then dK += bf16(dS^T) Q (S^T and
//     dP^T, then dK: 3), each pass with K7's live set: one more product an
//     entry, the stream and the exponentials twice, for products that run
//     asynchronously. One block fills an SM (~200 KB of shared memory, 288
//     threads);
//   * q and kv rows are counted apart (n_pad, n_pad_kv), so both kernels
//     run a sequence-parallel shard's maps (ops/splash.py
//     shard_block_maps): K7 the shard's q tiles against every kv tile, K8
//     every kv tile against the shard's q tiles, writing the shard's dK
//     and dV partials (0 where no q row of the shard attends a kv tile),
//     which the shards' process group sums.

#include "splash.cuh"

namespace gc {

constexpr int kDqSmem = splash_smem(2, false);
constexpr int kDkvSmem = splash_smem(2, true);

// acc += A B over the 64 columns of A's fragments (4 k16 steps), B the
// 64 x 128 tile at b read MN-major (its rows are the contraction), then
// waits for it. The caller has written A's registers since the last wait.
__device__ __forceinline__ void run_grad(float (&acc)[kSpD / 2],
                                         uint32_t (&a)[kSpT / 16][4],
                                         uint32_t b) {
  fence_operands(acc);
  fence_operands(a);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSpT / 16; ++ks) {
    wgmma_m64n128k16_rs<1>(acc, a[ks], mnmajor_desc(b, ks, kSpBox));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
  fence_operands(a);
}

// Stores this thread's two rows of a 64 x 128 f32 accumulator as bf16.
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[kSpD / 2],
                                           int t) {
#pragma unroll
  for (int j = 0; j < kSpD / 8; ++j) {
    const int c = j * 8 + t * 2;
    store_bf16x2(out + c, acc[4 * j], acc[4 * j + 1]);
    store_bf16x2(out + 8 * kSpD + c, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int kN>
__device__ __forceinline__ void zero(float (&acc)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.f;
}

// ---- K7: dq ---------------------------------------------------------------

__device__ __forceinline__ void dq_consumer(
    const SplashSmem& sm, int e_begin, int n, const Lane& ln,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int2* __restrict__ group_pairs, const int* __restrict__ full,
    bf16* __restrict__ dq, float scale, int nq, int row0, int grp) {
  const int qt = 2 * grp + ln.wg;
  float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;  // lse in base 2
  if (qt < nq) {
    const size_t r = (size_t)row0 + (size_t)qt * kSpT + ln.r0;
    lse0 = lse[r] * kLog2e;
    lse1 = lse[r + 8] * kLog2e;
    dl0 = delta[r];
    dl1 = delta[r + 8];
  }
  const float scale2 = scale * kLog2e;
  float acc[kSpD / 2], s[kSpT / 2], dp[kSpT / 2];
  uint32_t da[kSpT / 16][4];  // bf16(dS), the A operand of dS K
  zero(acc);
  mbar_wait(sm.own_bar, 0);
  const uint32_t q_addr = smem_u32(sm.own[0] + ln.wg * kSpTile);
  const uint32_t do_addr = smem_u32(sm.own[1] + ln.wg * kSpTile);
  // One loop with a block-uniform trip count and no wgmma in a branch.
  for (int r = 0; r < n; ++r) {
    mbar_wait(&sm.full_bar[ring_stage(r)], ring_phase(r));
    const uint32_t kv = sm.streamed(r);
    fence_operands(acc);
    issue_scores(s, q_addr, kv);
    issue_scores(dp, do_addr, kv + kSpTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    RowBits b0, b1;
    entry_bits(sm, group_pairs, full, r, e_begin + r, ln, b0, b1);
#pragma unroll
    for (int j = 0; j < kSpT / 8; ++j) {
      float ds0[2], ds1[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e0 = fast_exp2(fmaf(s[4 * j + c], scale2, -lse0));
        const float e1 = fast_exp2(fmaf(s[4 * j + 2 + c], scale2, -lse1));
        const float p0 = b0.has(j, c) ? e0 : 0.f;
        const float p1 = b1.has(j, c) ? e1 : 0.f;
        ds0[c] = p0 * (dp[4 * j + c] - dl0) * scale;
        ds1[c] = p1 * (dp[4 * j + 2 + c] - dl1) * scale;
      }
      da[j / 2][(j % 2) * 2] = pack_bf16x2(ds0[0], ds0[1]);
      da[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(ds1[0], ds1[1]);
    }
    run_grad(acc, da, kv);
    if (ln.lane == 0) mbar_arrive(&sm.empty_bar[ring_stage(r)]);
  }
  if (qt >= nq) return;  // the odd last tile's missing partner
  store_rows(dq + ((size_t)row0 + (size_t)qt * kSpT + ln.r0) * kSpD, acc,
             ln.t);
}

__global__ void __launch_bounds__(kSpBlockThreads, 1) splash_dq_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ group_offsets, const int* __restrict__ group_kv,
    const int2* __restrict__ group_pairs, const int* __restrict__ group_order,
    const unsigned long long* __restrict__ words,
    const int* __restrict__ full, bf16* __restrict__ dq, float scale, int nq,
    int n_pad, int n_pad_kv, int bh) {
  extern __shared__ unsigned char smem_raw[];
  const SplashSmem sm(smem_raw, 2, false);
  const int grp = group_order[blockIdx.x / bh];
  const int row0 = (blockIdx.x % bh) * n_pad;        // the head's first q row
  const int kv_row0 = (blockIdx.x % bh) * n_pad_kv;  // and first kv row
  const int e_begin = group_offsets[grp];
  const int n = group_offsets[grp + 1] - e_begin;
  // The warp index, warp-uniform as ptxas sees it (a broadcast).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (warp == 8) {  // the producer warp
    if (lane == 0) {
      sm.load_own(&tq, &tdo, row0, grp, min(2, nq - 2 * grp));
      for (int r = 0; r < n; ++r) {
        const int e = e_begin + r;
        sm.stream(r, e, &tk, &tv, kv_row0 + group_kv[e] * kSpT, group_pairs,
                  full, words, 0);
      }
    }
    return;
  }
  dq_consumer(sm, e_begin, n, Lane(warp, lane), lse, delta, group_pairs,
              full, dq, scale, nq, row0, grp);
}

// ---- K8: dk, dv -----------------------------------------------------------

// K8's consumer warpgroup (kv tile 2 grp + wg: its rows are kv rows, its
// columns the streamed q tile's rows), over its list twice: stream
// positions 0 .. n - 1 for dV, n .. 2n - 1 for dK.
__device__ __forceinline__ void dkv_consumer(
    const SplashSmem& sm, int e_begin, int n, const Lane& ln,
    const int2* __restrict__ group_pairs, const int* __restrict__ full_t,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float scale, int nkv,
    int row0, int grp) {
  const int kt = 2 * grp + ln.wg;
  const float scale2 = scale * kLog2e;
  float acc[kSpD / 2], st[kSpT / 2], dpt[kSpT / 2];
  uint32_t fa[kSpT / 16][4];  // bf16(P^T), then bf16(dS^T): the A operand
  mbar_wait(sm.own_bar, 0);
  const uint32_t k_addr = smem_u32(sm.own[0] + ln.wg * kSpTile);
  const uint32_t v_addr = smem_u32(sm.own[1] + ln.wg * kSpTile);
  const size_t orow = ((size_t)row0 + (size_t)kt * kSpT + ln.r0) * kSpD;

  // Each pass writes its exponentials out in full: a helper that handed
  // its per-column arrays to a callback by reference put them in local
  // memory, and ptxas serialised the products again.
  // dV += bf16(P^T) dO.
  zero(acc);
  for (int r = 0; r < n; ++r) {
    mbar_wait(&sm.full_bar[ring_stage(r)], ring_phase(r));
    const uint32_t qd = sm.streamed(r);
    fence_operands(acc);
    issue_scores(st, k_addr, qd);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    RowBits b0, b1;
    entry_bits(sm, group_pairs, full_t, r, e_begin + r, ln, b0, b1);
    const float* ls = sm.lse + ring_stage(r) * kSpT + 2 * ln.t;
#pragma unroll
    for (int j = 0; j < kSpT / 8; ++j) {
      // lse (base 2) of q columns 8 j + 2 t and 8 j + 2 t + 1.
      const float2 lc = *reinterpret_cast<const float2*>(ls + 8 * j);
      const float l2[2] = {lc.x * kLog2e, lc.y * kLog2e};
      float p0[2], p1[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e0 = fast_exp2(fmaf(st[4 * j + c], scale2, -l2[c]));
        const float e1 = fast_exp2(fmaf(st[4 * j + 2 + c], scale2, -l2[c]));
        p0[c] = b0.has(j, c) ? e0 : 0.f;
        p1[c] = b1.has(j, c) ? e1 : 0.f;
      }
      fa[j / 2][(j % 2) * 2] = pack_bf16x2(p0[0], p0[1]);
      fa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(p1[0], p1[1]);
    }
    run_grad(acc, fa, qd + kSpTile);
    if (ln.lane == 0) mbar_arrive(&sm.empty_bar[ring_stage(r)]);
  }
  if (kt < nkv) store_rows(dv + orow, acc, ln.t);

  // dK += bf16(dS^T) Q.
  zero(acc);
  for (int r = n; r < 2 * n; ++r) {
    mbar_wait(&sm.full_bar[ring_stage(r)], ring_phase(r));
    const uint32_t qd = sm.streamed(r);
    fence_operands(acc);
    issue_scores(st, k_addr, qd);
    issue_scores(dpt, v_addr, qd + kSpTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);
    RowBits b0, b1;
    entry_bits(sm, group_pairs, full_t, r, e_begin + r % n, ln, b0, b1);
    const float* ls = sm.lse + ring_stage(r) * kSpT + 2 * ln.t;
    const float* dl = sm.delta + ring_stage(r) * kSpT + 2 * ln.t;
#pragma unroll
    for (int j = 0; j < kSpT / 8; ++j) {
      // lse and delta of q columns 8 j + 2 t and 8 j + 2 t + 1.
      const float2 lc = *reinterpret_cast<const float2*>(ls + 8 * j);
      const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j);
      const float l2[2] = {lc.x * kLog2e, lc.y * kLog2e};
      const float d2[2] = {d.x, d.y};
      float ds0[2], ds1[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e0 = fast_exp2(fmaf(st[4 * j + c], scale2, -l2[c]));
        const float e1 = fast_exp2(fmaf(st[4 * j + 2 + c], scale2, -l2[c]));
        const float p0 = b0.has(j, c) ? e0 : 0.f;
        const float p1 = b1.has(j, c) ? e1 : 0.f;
        ds0[c] = p0 * (dpt[4 * j + c] - d2[c]) * scale;
        ds1[c] = p1 * (dpt[4 * j + 2 + c] - d2[c]) * scale;
      }
      fa[j / 2][(j % 2) * 2] = pack_bf16x2(ds0[0], ds0[1]);
      fa[j / 2][(j % 2) * 2 + 1] = pack_bf16x2(ds1[0], ds1[1]);
    }
    run_grad(acc, fa, qd);
    if (ln.lane == 0) mbar_arrive(&sm.empty_bar[ring_stage(r)]);
  }
  if (kt < nkv) store_rows(dk + orow, acc, ln.t);
}

__global__ void __launch_bounds__(kSpBlockThreads, 1) splash_dkv_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ group_offsets, const int* __restrict__ group_q,
    const int2* __restrict__ group_pairs, const int* __restrict__ group_order,
    const unsigned long long* __restrict__ words_t,
    const int* __restrict__ full_t, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float scale, int nkv, int n_pad, int n_pad_kv,
    int bh) {
  extern __shared__ unsigned char smem_raw[];
  const SplashSmem sm(smem_raw, 2, true);
  const int grp = group_order[blockIdx.x / bh];
  const int q_row0 = (blockIdx.x % bh) * n_pad;   // the head's first q row
  const int row0 = (blockIdx.x % bh) * n_pad_kv;  // and first kv row
  const int e_begin = group_offsets[grp];
  const int n = group_offsets[grp + 1] - e_begin;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (warp == 8) {  // the producer warp: the list twice, as the consumers
    if (lane == 0) {
      sm.load_own(&tk, &tv, row0, grp, min(2, nkv - 2 * grp));
      for (int r = 0; r < 2 * n; ++r) {
        const int e = e_begin + r % n;
        const int qr = q_row0 + group_q[e] * kSpT;
        uint64_t* bar = sm.stream(r, e, &tq, &tdo, qr, group_pairs, full_t,
                                  words_t, 2 * kSpRowVals);
        bulk_load(sm.lse + ring_stage(r) * kSpT, lse + qr, kSpRowVals, bar);
        bulk_load(sm.delta + ring_stage(r) * kSpT, delta + qr, kSpRowVals,
                  bar);
      }
    }
    return;
  }
  dkv_consumer(sm, e_begin, n, Lane(warp, lane), group_pairs, full_t, dk, dv,
               scale, nkv, row0, grp);
}

// The four bf16 operands' tensor maps (q, dout [bh * n_pad, 128], k, v
// [bh * n_pad_kv, 128], 64 x 64 boxes).
inline cudaError_t operand_maps(CUtensorMap (&maps)[4], const void* q,
                                const void* k, const void* v,
                                const void* dout, int bh, int n_pad,
                                int n_pad_kv) {
  const uint64_t rows = (uint64_t)bh * n_pad;
  const uint64_t kv_rows = (uint64_t)bh * n_pad_kv;
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = bf16_tile_map(
        &maps[i], ptrs[i], i == 1 || i == 2 ? kv_rows : rows, kSpD, kSpD,
        kSpT);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace gc

// q, dout, dq: [bh, n_pad, 128] bf16; k, v: [bh, n_pad_kv, 128] bf16; lse,
// delta: [bh, n_pad] f32 (lse 0 past n), 16-byte aligned; n_pad = nq * 64. The forward map's
// words [n_active, 64] and full [n_active] and its work lists from
// ops/splash.py paired_lists: group_offsets [groups + 1], group_kv
// [entries], group_pairs [entries, 2], group_order [groups].
extern "C" int gc_splash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* group_offsets,
                            const int* group_kv, const void* group_pairs,
                            const int* group_order, const void* words,
                            const int* full, void* dq, float scale, int bh,
                            int nq, int groups, int n_pad, int n_pad_kv,
                            void* stream) {
  using gc::bf16;
  if (bh <= 0 || nq <= 0) return 0;
  if (groups != (nq + 1) / 2) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  cudaError_t err =
      gc::operand_maps(maps, q, k, v, dout, bh, n_pad, n_pad_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gc::splash_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gc::kDqSmem);
  if (err != cudaSuccess) return err;
  gc::splash_dq_kernel<<<groups * bh, gc::kSpBlockThreads, gc::kDqSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, group_offsets,
      group_kv, static_cast<const int2*>(group_pairs), group_order,
      static_cast<const unsigned long long*>(words), full,
      static_cast<bf16*>(dq), scale, nq, n_pad, n_pad_kv, bh);
  return cudaGetLastError();
}

// As gc_splash_dq, over the transposed map: its words_t (one word per kv
// row), full_t and paired lists (group_q: the q tile of each entry); dk,
// dv: [bh, n_pad_kv, 128] bf16.
extern "C" int gc_splash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* group_offsets,
                             const int* group_q, const void* group_pairs,
                             const int* group_order, const void* words_t,
                             const int* full_t, void* dk, void* dv,
                             float scale, int bh, int nkv, int groups,
                             int n_pad, int n_pad_kv, void* stream) {
  using gc::bf16;
  if (bh <= 0 || nkv <= 0) return 0;
  if (groups != (nkv + 1) / 2) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  cudaError_t err =
      gc::operand_maps(maps, q, k, v, dout, bh, n_pad, n_pad_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gc::splash_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gc::kDkvSmem);
  if (err != cudaSuccess) return err;
  gc::splash_dkv_kernel<<<groups * bh, gc::kSpBlockThreads, gc::kDkvSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, group_offsets, group_q,
      static_cast<const int2*>(group_pairs), group_order,
      static_cast<const unsigned long long*>(words_t), full_t,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), scale, nkv, n_pad,
      n_pad_kv, bh);
  return cudaGetLastError();
}

// Dynamic shared memory of splash_dq_kernel and splash_dkv_kernel, bytes.
extern "C" int gc_splash_dq_smem() { return gc::kDqSmem; }
extern "C" int gc_splash_dkv_smem() { return gc::kDkvSmem; }
