// The pieces the fused decoder kernels share (fused_decoder.cu: K2;
// fused_decoder_bwd.cu: K5), for Hopper (sm_90a). The fused edge kernels
// (edge.cuh: K1, K4) take the width-independent ones: the cluster's
// producer and ring (of any cluster size), the warpgroup products
// dec_mma, the row exchange, the column sums and the launch.
//
// Both run chains of [64 grid nodes, K] x [K, N] products (K, N <= 512)
// with elementwise and LayerNorm epilogues between them, and both are
// bound by streaming the weights from L2: every product reads a whole
// weight matrix for 64 rows. The layout they share:
//   * a cluster of kDecCluster = 2 blocks, each owning a tile of kDecRows =
//     64 grid nodes; both blocks run the same sequence of products, so each
//     64 x 64 weight box is fetched from L2 once by TMA multicast and lands
//     in both blocks' rings: each weight byte from L2 serves 128 nodes;
//   * per block one producer thread (warpgroup 2, which gives its registers
//     to the consumers: setmaxnreg 40 / 232) walks that sequence and keeps a
//     ring of `stages` 8 KB boxes full (full / empty mbarriers); the two
//     blocks' producers take turns issuing the multicast (position p by
//     cluster rank p % 2), and each arms its own block's full barrier;
//   * two consumer warpgroups split every product by columns: warpgroup w
//     owns output columns [w N / 2, (w + 1) N / 2) of all 64 rows, as NQ =
//     N / 128 chunks of 64 columns, one wgmma m64n64k16 accumulator (32 f32
//     registers a thread) each. Stream position p goes to warpgroup p % 2;
//     a warpgroup's release arrives on the empty barrier of both blocks;
//   * the kernels are built for a latent width of kDecWidth = 512 only
//     (one instantiation per mode: the build stays within minutes); a
//     narrower width C runs in the same layout, its weights and grid rows
//     read through tensor maps of the true width whose boxes arrive
//     zero-filled past it, its vectors zero-padded by the wrapper, every
//     row access of width C guarded, and the LayerNorm statistics taken
//     over the C true columns;
//   * the activation operand A of each product sits in shared memory as
//     K-major 64 x 64 boxes with the 128-byte swizzle (hopper.cuh), written
//     by the previous epilogue or by TMA; the block's grid latents G stay
//     there too, loaded once per tile, as the A operand of g @ Wr and
//     g @ Wng and the residual's summand;
//   * a product x @ W reads W's boxes MN-major (row k, column n: the
//     instruction's transpose bit), a product x @ W^T reads the same boxes
//     of the same tensor map K-major, so no transposed copy exists;
//   * f32 values that outlive a product and do not fit (the 3-slot sum agg
//     and K5's cotangent tiles) go to a per-block scratch in device memory
//     in the accumulator's own layout (each thread reads back its own
//     values, 16 bytes at a time, the warp's loads contiguous): 128 KB a
//     tile at C = 512, L2-resident for the ~132 blocks of a launch;
//   * LayerNorm row statistics are summed over both warpgroups through a
//     small shared exchange (each row's columns are split between them).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace gc {

constexpr int kDecRows = 64;                     // grid nodes per block
constexpr int kDecCluster = 2;                   // blocks sharing each box
constexpr int kDecBox = 64 * 64 * 2;             // one 64 x 64 bf16 box
constexpr int kDecConsumers = 256;                // two warpgroups
constexpr int kDecThreads = kDecConsumers + 128;  // and the producer's
constexpr int kDecWidth = 512;                    // the built latent width
constexpr int kDecNQ = kDecWidth / 128;           // chunks a warpgroup
constexpr int kDecProducerRegs = 40;              // setmaxnreg budgets
constexpr int kDecConsumerRegs = 232;
constexpr int kDecSmemLimit = 232448;            // a block's dynamic maximum
constexpr int kDecMaxStages = 16;                // ring depth cap
constexpr int kDecAlign = 1008;                  // 16-byte base to 1024
constexpr int kDecExchange = 2 * 2 * kDecRows * 8;  // row exchange, 2 KB
constexpr int kDecBarSync = 1;                   // consumers' named barrier

// The shared-memory layout of a block, in bytes from the 1024-aligned
// base: A (a_cols / 64 boxes), G (C / 64 boxes), the ring, the row
// exchange, K5's column sums (`sums` floats) and their per-warp parts (4
// warps x C floats), the barriers (full and empty per stage, the G load's,
// the A load's). The ring takes what is left, up to kDecMaxStages boxes,
// rounded down to an even count (ClusterRing). ops/fused_decoder.py
// smem_layout mirrors it.
struct DecLayout {
  int a, g, ring, exchange, sums, colred, bars, stages, total;
};

__host__ __device__ constexpr DecLayout dec_layout(int C, int a_cols,
                                                   int sums) {
  DecLayout L{};
  L.a = 0;
  L.g = (a_cols / 64) * kDecBox;
  L.ring = L.g + (C / 64) * kDecBox;
  const int colred = sums > 0 ? 4 * C * 4 : 0;
  const int bars = (2 * kDecMaxStages + 2) * 8;
  const int tail = kDecExchange + sums * 4 + colred + bars;
  const int st = (kDecSmemLimit - kDecAlign - L.ring - tail) / kDecBox;
  L.stages = (st < kDecMaxStages ? st : kDecMaxStages) & ~1;
  L.exchange = L.ring + L.stages * kDecBox;
  L.sums = L.exchange + kDecExchange;
  L.colred = L.sums + sums * 4;
  L.bars = L.colred + colred;
  L.total = L.bars + bars + kDecAlign;
  return L;
}

struct DecSmem {
  unsigned char* a;
  unsigned char* g;
  unsigned char* ring;
  float2* exchange;   // [2 buffers][2 warpgroups][64 rows]
  float* sums;        // K5's running column sums
  float* colred;      // [4 warps][C]
  uint64_t* full;     // [stages]
  uint64_t* empty;    // [stages]
  uint64_t* g_bar;
  uint64_t* a_bar;
  int stages;

  __device__ __forceinline__ DecSmem(unsigned char* raw, const DecLayout& L)
      : stages(L.stages) {
    unsigned char* p = align_1024(raw);
    a = p + L.a;
    g = p + L.g;
    ring = p + L.ring;
    exchange = reinterpret_cast<float2*>(p + L.exchange);
    sums = reinterpret_cast<float*>(p + L.sums);
    colred = reinterpret_cast<float*>(p + L.colred);
    full = reinterpret_cast<uint64_t*>(p + L.bars);
    empty = full + kDecMaxStages;
    g_bar = empty + kDecMaxStages;
    a_bar = g_bar + 1;
  }

  // Thread 0 initialises the barriers; the block, then the cluster,
  // synchronise after.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      // One arrival per consumer warp of the warpgroup that reads the
      // stage, in each block of the cluster.
      mbar_init(&empty[s], 4 * kDecCluster);
    }
    mbar_init(g_bar, 1);
    mbar_init(a_bar, 1);
    mbar_fence_init();
  }
};

// ---- the producer ---------------------------------------------------------

// Lane 0 of the producer warp: stream position p goes to stage p % stages;
// the block of cluster rank p % kCl issues its multicast to all kCl
// blocks. Smem: any block plan with ring, full, empty and stages.
template <int kCl>
struct ClusterProducer {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  uint32_t rank;
  int p = 0;

  template <typename Smem>
  __device__ __forceinline__ ClusterProducer(const Smem& sh, uint32_t rank_)
      : ring(sh.ring), full(sh.full), empty(sh.empty), stages(sh.stages),
        rank(rank_) {}

  // Box (column c0, row c1) of `map` at the next stream position.
  __device__ __forceinline__ void box(const CUtensorMap* map, int c0,
                                      int c1) {
    const int s = p % stages;
    mbar_wait(&empty[s], ((p / stages) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[s], kDecBox);
    if (p % kCl == (int)rank) {
      tma_load_2d_multicast(ring + s * kDecBox, map, &full[s], c0, c1,
                            (1 << kCl) - 1);
    }
    ++p;
  }

  // The boxes of x @ W (W [K, N] row-major, read MN-major) in the order
  // dec_mma consumes them: per 64-row slab of K, warpgroup 0's and 1's
  // q-th chunks in turn.
  __device__ __forceinline__ void fwd(const CUtensorMap* map, int K, int N) {
    const int nq = N / 128;
    for (int k0 = 0; k0 < K; k0 += 64) {
      for (int q = 0; q < nq; ++q) {
        for (int w = 0; w < 2; ++w) box(map, (w * nq + q) * 64, k0);
      }
    }
  }

  // x @ W^T (W [N, K] row-major, read K-major): the same order.
  __device__ __forceinline__ void bwd(const CUtensorMap* map, int K, int N) {
    const int nq = N / 128;
    for (int k0 = 0; k0 < K; k0 += 64) {
      for (int q = 0; q < nq; ++q) {
        for (int w = 0; w < 2; ++w) box(map, k0, (w * nq + q) * 64);
      }
    }
  }

  // x @ W by pairs of 64-column chunks (dec_mma_pass): pass q gives
  // warpgroup w chunk 2 q + w over all of K.
  __device__ __forceinline__ void fwd_passes(const CUtensorMap* map, int K,
                                             int N) {
    for (int q = 0; q < N / 128; ++q) {
      for (int k0 = 0; k0 < K; k0 += 64) {
        for (int w = 0; w < 2; ++w) box(map, (2 * q + w) * 64, k0);
      }
    }
  }
};

using DecProducer = ClusterProducer<kDecCluster>;

// ---- the consumers --------------------------------------------------------

// A consumer thread: warpgroup w (0, 1), warp wl of it, lane; this thread
// holds rows r0 and r0 + 8 of the tile and, of each 64-column chunk,
// columns 8 j + 2 t (+ 1), j < 8. Element 4 j + 2 h + e of a chunk's
// accumulator is row r0 + 8 h, column 8 j + 2 t + e.
struct DecThread {
  int ctid, w, wl, lane, t, r0;
  __device__ __forceinline__ DecThread(int tid)
      : ctid(tid), w(tid / 128), wl((tid / 32) % 4), lane(tid % 32),
        t(tid % 4), r0(16 * ((tid / 32) % 4) + (tid % 32) / 4) {}
};

// A warpgroup's view of the ring: its i-th box sits at stream position
// 2 i + w. The ring's depth is even (the layouts round it down), so
// warpgroup w owns the stages of its parity and every phase of their full
// barriers is waited for by w alone, in order: a parity wait cannot tell
// phase k from phase k + 2, and is right only for a waiter that saw phase
// k - 1 complete. At an odd depth a stage alternates between the
// warpgroups, and a warpgroup could wait for round k + 1 of a stage whose
// round k (the other warpgroup's, multicast by a partner running behind)
// had not landed: the wait passed at once, the stale box was read and
// released early, and the ring's counts went out of step. A partner falls
// that far behind when the card time-slices two contexts (PERF.md §6).
template <int kCl>
struct ClusterRing {
  uint32_t ring;
  uint64_t* full;
  uint64_t* empty;
  int stages, w, lane;
  int i = 0;

  template <typename Smem>
  __device__ __forceinline__ ClusterRing(const Smem& sh, const DecThread& th)
      : ring(smem_u32(sh.ring)), full(sh.full), empty(sh.empty),
        stages(sh.stages), w(th.w), lane(th.lane) {}

  __device__ __forceinline__ uint32_t acquire(int& stage) {
    const int p = 2 * i + w;
    stage = p % stages;
    mbar_wait(&full[stage], (p / stages) & 1);
    ++i;
    return ring + stage * kDecBox;
  }

  // Each warp's lane 0 arrives on the stage's empty barrier in every block
  // of the cluster (the partner's producer refills its copy too).
  __device__ __forceinline__ void release(int stage) const {
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCl; ++c) mbar_arrive_cluster(&empty[stage], c);
    }
  }
};

using DecRing = ClusterRing<kDecCluster>;

// acc (+)= A[64, 64 nk] @ B over nk slabs of 64, this warpgroup's NQ
// chunks of B's columns from the ring (kTB = 1: boxes of W read MN-major,
// a product x @ W; kTB = 0: read K-major, x @ W^T). A: nk K-major boxes at
// shared address `a`. With `accumulate` false the first k step overwrites
// acc. One wgmma group per box; a box's stage is released once the next
// box's products are issued and its own are done. Returns with every
// product done.
template <int NQ, int kTB, typename Ring>
__device__ __forceinline__ void dec_mma(float (&acc)[NQ][32], uint32_t a,
                                        int nk, bool accumulate, Ring& ring) {
  int prev = -1;
  for (int kk = 0; kk < nk; ++kk) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      int stage;
      const uint32_t b = ring.acquire(stage);
      fence_operands(acc[q]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t db = kTB ? mnmajor_desc(b, ks, kDecBox)
                                : kmajor_desc(b, ks, kDecBox);
        const int scale_d = (accumulate || kk > 0 || ks > 0) ? 1 : 0;
        wgmma_m64n64k16_ss<0, kTB>(
            acc[q], kmajor_desc(a, 4 * kk + ks, kDecBox), db, scale_d);
      }
      wgmma_commit();
      fence_operands(acc[q]);
      wgmma_wait<1>();
      if (prev >= 0) ring.release(prev);
      prev = stage;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < NQ; ++q) fence_operands(acc[q]);
  if (prev >= 0) ring.release(prev);
}

// One pass of DecProducer::fwd_passes: acc = A @ W[:, this warpgroup's
// chunk], nk slabs.
template <typename Ring>
__device__ __forceinline__ void dec_mma_pass(float (&acc)[32], uint32_t a,
                                             int nk, Ring& ring) {
  int prev = -1;
  for (int kk = 0; kk < nk; ++kk) {
    int stage;
    const uint32_t b = ring.acquire(stage);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_m64n64k16_ss<0, 1>(acc, kmajor_desc(a, 4 * kk + ks, kDecBox),
                               mnmajor_desc(b, ks, kDecBox),
                               (kk > 0 || ks > 0) ? 1 : 0);
    }
    wgmma_commit();
    fence_operands(acc);
    wgmma_wait<1>();
    if (prev >= 0) ring.release(prev);
    prev = stage;
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (prev >= 0) ring.release(prev);
}

// Byte offset of element (row, col) in a K-major stack of 64 x 64 boxes
// with the 128-byte swizzle: box col / 64, row r at 128 r, the 16-byte
// chunk (col % 64) / 8 permuted by r % 8.
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * kDecBox + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void st_pair(unsigned char* tile, int row, int col,
                                        float x, float y) {
  store_bf16x2(reinterpret_cast<bf16*>(tile + swz(row, col)), x, y);
}

__device__ __forceinline__ float2 ld_pair(const unsigned char* tile, int row,
                                          int col) {
  return load_bf16x2(reinterpret_cast<const bf16*>(tile + swz(row, col)));
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Sums over each of this thread's two rows across all C columns: v.x, v.y
// the row r0 and r0 + 8 parts of one quantity, v.z, v.w of another. Quad
// sums, then the two warpgroups' parts through the exchange (alternating
// buffers, so one barrier a call), added in warpgroup order.
struct DecRows {
  float2* exchange;
  int flip = 0;

  __device__ __forceinline__ float4 sum(float4 v, const DecThread& th) {
    v.x = quad_sum(v.x);
    v.y = quad_sum(v.y);
    v.z = quad_sum(v.z);
    v.w = quad_sum(v.w);
    float2* buf = exchange + flip * 2 * kDecRows;
    if (th.t == 0) {
      buf[th.w * kDecRows + th.r0] = make_float2(v.x, v.z);
      buf[th.w * kDecRows + th.r0 + 8] = make_float2(v.y, v.w);
    }
    named_sync(kDecBarSync, kDecConsumers);
    const float2 a0 = buf[th.r0], b0 = buf[kDecRows + th.r0];
    const float2 a1 = buf[th.r0 + 8], b1 = buf[kDecRows + th.r0 + 8];
    flip ^= 1;
    return make_float4(a0.x + b0.x, a1.x + b1.x, a0.y + b0.y, a1.y + b1.y);
  }
};

__device__ __forceinline__ void dec_sync() {
  named_sync(kDecBarSync, kDecConsumers);
}

// Makes this thread's writes to the operand tiles visible to the next
// wgmma, then synchronises the consumers.
__device__ __forceinline__ void dec_publish() {
  fence_proxy_async();
  dec_sync();
}

// Column of element pair (q, j) of this thread (chunk q of its warpgroup).
template <int NQ>
__device__ __forceinline__ int dec_col(const DecThread& th, int q, int j) {
  return (th.w * NQ + q) * 64 + 8 * j + 2 * th.t;
}

// LayerNorm statistics of this thread's rows of acc + bias over the first
// C columns, f32 (mean, then the mean square deviation; columns past C hold
// zeros and count in neither): (mean, rstd) of row r0 in .x, .y and of row
// r0 + 8 in .z, .w. Ends past a consumer barrier, so both warpgroups are
// done with the product behind acc.
template <int NQ>
__device__ __forceinline__ float4 dec_ln_stats(const float (&acc)[NQ][32],
                                               const float* __restrict__ bias,
                                               const DecThread& th,
                                               DecRows& rs, int C) {
  const float kInvC = 1.f / C;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = ldg2(bias + dec_col<NQ>(th, q, j));
      s0 += (acc[q][4 * j] + b.x) + (acc[q][4 * j + 1] + b.y);
      s1 += (acc[q][4 * j + 2] + b.x) + (acc[q][4 * j + 3] + b.y);
    }
  }
  float4 tot = rs.sum(make_float4(s0, s1, 0.f, 0.f), th);
  const float m0 = tot.x * kInvC, m1 = tot.y * kInvC;
  s0 = s1 = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = dec_col<NQ>(th, q, j);
      const float2 b = ldg2(bias + c);
      const float in = c < C ? 1.f : 0.f;
      const float d0 = (acc[q][4 * j] + b.x - m0) * in;
      const float d1 = (acc[q][4 * j + 1] + b.y - m0) * in;
      const float d2 = (acc[q][4 * j + 2] + b.x - m1) * in;
      const float d3 = (acc[q][4 * j + 3] + b.y - m1) * in;
      s0 += d0 * d0 + d1 * d1;
      s1 += d2 * d2 + d3 * d3;
    }
  }
  tot = rs.sum(make_float4(s0, s1, 0.f, 0.f), th);
  return make_float4(m0, rsqrtf(tot.x * kInvC + kLnEps), m1,
                     rsqrtf(tot.y * kInvC + kLnEps));
}

// The normalised value of x (acc + bias) in row r0 + 8 h.
__device__ __forceinline__ float dec_ln(const float4& st, float x, int h) {
  return h == 0 ? (x - st.x) * st.y : (x - st.z) * st.w;
}

// A read-only bf16 pair through the non-coherent path: the compiler may
// issue it ahead of the epilogue's stores (a plain load through a generic
// pointer waits for each store before it, so the loads of an epilogue would
// go out one at a time).
__device__ __forceinline__ float2 ldg_bf16x2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// Columns c, c + 1 of row n of a [*, C] bf16 array, if the row is valid
// and c < C (the layout's columns past the true width are not stored).
__device__ __forceinline__ void put_pair(bf16* base, int n, int C, int c,
                                         bool ok, float x, float y) {
  if (ok && c < C) store_bf16x2(base + (size_t)n * C + c, x, y);
}

__device__ __forceinline__ float4 f4(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}

// A per-block f32 tile in device memory in the accumulator's layout:
// chunk q, j of thread ctid is one float4 (elements 4 j .. 4 j + 3).
template <int NQ>
struct DecScratch {
  float* base;
  __device__ __forceinline__ float4* at(int q, int j, int ctid) const {
    return reinterpret_cast<float4*>(base) + (q * 8 + j) * kDecConsumers +
           ctid;
  }
};

// The same for a bf16 tile (4 bf16 per (q, j)).
template <int NQ>
struct DecScratch16 {
  bf16* base;
  __device__ __forceinline__ uint2* at(int q, int j, int ctid) const {
    return reinterpret_cast<uint2*>(base) + (q * 8 + j) * kDecConsumers + ctid;
  }
};

// A chunk's 8 values of a scratch tile, all loads issued before any use
// (written by this kernel, so not through the non-coherent path).
template <int NQ>
__device__ __forceinline__ void dec_load_chunk(float4 (&v)[8],
                                               const DecScratch<NQ>& t, int q,
                                               int ctid) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = *t.at(q, j, ctid);
}

__device__ __forceinline__ uint2 pack4_bf16(float a, float b, float c,
                                            float d) {
  return make_uint2(pack_bf16x2(a, b), pack_bf16x2(c, d));
}

__device__ __forceinline__ float4 unpack4_bf16(uint2 v) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The same for a bf16 tile, unpacked.
template <int NQ>
__device__ __forceinline__ void dec_load_chunk(float4 (&v)[8],
                                               const DecScratch16<NQ>& t,
                                               int q, int ctid) {
  uint2 raw[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) raw[j] = *t.at(q, j, ctid);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = unpack4_bf16(raw[j]);
}

// The edge slot's input rows for chunk q of this thread: xin[j][h] = const
// (embed mode: b0') + mesh_proj[snd] at row r0 + 8 h, columns of pair j,
// zeros for rows past the tile's nodes and columns past C; every load
// issued before any is used.
template <int NQ, bool kEmbed>
__device__ __forceinline__ void dec_slot_inputs(
    float2 (&xin)[8][2], const DecThread& th, int q, int C,
    const bf16* __restrict__ cnst, const float* __restrict__ b0,
    const bf16* __restrict__ mesh_proj, const int (&edge)[2],
    const int (&snd)[2], const bool (&ok)[2]) {
  float2 cv[8][2], sv[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = dec_col<NQ>(th, q, j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cv[j][h] = sv[j][h] = make_float2(0.f, 0.f);
      if (ok[h] && c < C) {
        cv[j][h] = kEmbed ? ldg2(b0 + c)
                          : ldg_bf16x2(cnst + (size_t)edge[h] * C + c);
        sv[j][h] = ldg_bf16x2(mesh_proj + (size_t)snd[h] * C + c);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xin[j][h] = make_float2(cv[j][h].x + sv[j][h].x,
                              cv[j][h].y + sv[j][h].y);
    }
  }
}

// The G tile's TMA load (C / 64 boxes of rows v0.., zeros past the grid),
// issued by consumer thread 0.
__device__ __forceinline__ void dec_load_tile(unsigned char* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int cols,
                                              int row0) {
  mbar_arrive_expect_tx(bar, (cols / 64) * kDecBox);
  for (int c = 0; c < cols; c += 64) {
    tma_load_2d(dst + (c / 64) * kDecBox, map, bar, c, row0);
  }
}

// The per-tile column sums of the backward kernels (K5, K4): each
// thread's pair of rows, a shuffle tree over the warp's 8 row groups (K4:
// edge.cuh edge_put8), the 4 warps of the warpgroup in order through
// colred, added into the block's sums; a fixed order, so a rerun is
// bit-equal. colred may hold several kinds ("slots", [slots][4 warps]
// [kDecWidth]), so that one epilogue puts several before one fold.
struct DecColSums {
  float* colred;  // [slots][4 warps][kDecWidth]
  float* sums;    // [kinds][C] (K5: then dbd1)
  int C;

  // (sx, sy): this thread's sums of columns col, col + 1 over its rows.
  __device__ __forceinline__ void put(const DecThread& th, int col, float sx,
                                      float sy) const {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      sx += __shfl_xor_sync(0xffffffffu, sx, o);
      sy += __shfl_xor_sync(0xffffffffu, sy, o);
    }
    if (th.lane < 4) {
      colred[th.wl * kDecWidth + col] = sx;
      colred[th.wl * kDecWidth + col + 1] = sy;
    }
  }

  // After an epilogue's puts: sums[kind + s] += scale * (the 4 warps' parts
  // of slot s), s < slots. Also publishes the epilogue's writes to A.
  __device__ __forceinline__ void fold(const DecThread& th, int kind,
                                       float scale = 1.f,
                                       int slots = 1) const {
    dec_publish();
    for (int s = 0; s < slots; ++s) {
      const float* cr = colred + s * 4 * kDecWidth;
      for (int c = th.ctid; c < C; c += kDecConsumers) {
        constexpr int W = kDecWidth;
        sums[(kind + s) * C + c] +=
            scale * (((cr[c] + cr[W + c]) + cr[2 * W + c]) + cr[3 * W + c]);
      }
    }
    dec_sync();
  }
};

namespace {

// sums[i] += the blocks' partials[b][i], b in order (the second pass of
// the backward kernels' fixed-order column sums).
__global__ void decoder_sums_reduce(const float* __restrict__ partials,
                                    int blocks, int n, float* sums) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partials[(size_t)b * n + i];
    sums[i] += s;
  }
}

}  // namespace

// The persistent grid of a launch in clusters of kCl blocks: as many
// clusters as fit at once (cudaOccupancyMaxActiveClusters), at most
// `pairs` (the clusters' tile groups), at most max_blocks blocks.
template <int kCl = kDecCluster, typename Kernel>
cudaError_t dec_launch_config(Kernel kernel, int smem, int pairs,
                              int max_blocks, cudaStream_t stream,
                              cudaLaunchConfig_t& cfg,
                              cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kCl * pairs);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  if (clusters > pairs) clusters = pairs;
  if (clusters * kCl > max_blocks) clusters = max_blocks / kCl;
  cfg.gridDim = dim3(kCl * clusters);
  return cudaSuccess;
}

}  // namespace gc
