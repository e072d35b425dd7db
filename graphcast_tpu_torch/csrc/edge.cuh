// The pieces the fused edge kernels share (fused_edge.cu: K1;
// fused_edge_bwd.cu: K4), for Hopper (sm_90a), on decoder.cuh's ring.
//
// Both run, per tile of 64 receiver-sorted edge rows, a chain of
// [64, 512] x [512, 512] products (K1 two, encoder one, embed three; K4
// four, encoder two, embed six) with elementwise and LayerNorm epilogues
// between them, and both are bound by streaming the weights from L2: a
// product reads a whole 512 KB weight matrix for its rows. The layout:
//   * a cluster of kEdgeCluster blocks, each owning one 64-row tile of
//     consecutive edges (cluster c's group g of tiles is kEdgeCluster g ..
//     kEdgeCluster g + kEdgeCluster - 1, block rank r taking the r-th);
//     every block runs the same sequence of products, so each 64 x 64
//     weight box is fetched from L2 once by TMA multicast and lands in all
//     the cluster's rings: each weight byte from L2 serves 64 kEdgeCluster
//     edge rows (the wmma kernels this replaces: 64 in K1, 32 in K4);
//   * per block one producer thread (decoder.cuh ClusterProducer,
//     setmaxnreg 40) streams the boxes through a ring as deep as shared
//     memory allows beside the one 64 KB operand tile A, rounded down to an
//     even count (18 boxes in K1, 16 in K4); two consumer warpgroups (232 registers) split every
//     product by columns and issue wgmma m64n64k16 per box (dec_mma);
//   * the operand A holds, in turn, each product's bf16 input as K-major
//     64 x 64 boxes with the 128-byte swizzle: the edge rows e by TMA tile
//     load (rows are contiguous in CSR order), then each epilogue's output;
//     x @ W reads W's boxes MN-major, x @ W^T the same boxes K-major, so no
//     transposed copy exists; the bf16 rows a kernel writes out (K1's e',
//     K4's h, dy, dx and embed rows) leave from a tile in shared memory by
//     TMA store (K1's modes that write e' keep e in a second tile E, where
//     e' replaces it);
//   * the gathered rows sproj[snd], rproj[rcv] (K4 also the f32 cotangent
//     dagg[rcv]) are loaded by each consumer thread in the accumulator's
//     layout in the epilogue that needs them (TMA has no row gather);
//   * the receiver-run sums (K1's agg, K4's dGr) are taken from a bf16 tile
//     in A, two columns a thread, one f32 sum per run: a plain store for a
//     run inside the tile; the runs at its two ends, which may continue into
//     a neighbouring tile, leave as f32 partials in a per-tile boundary
//     buffer that a second pass (edge_bounds) adds in tile order: no
//     atomics, so a rerun is bit-equal;
//   * built for a latent width of kDecWidth = 512 only (one instantiation
//     per mode); a narrower width C runs in the same layout through tensor
//     maps of the true width whose boxes arrive zero-filled past it, its
//     vectors zero-padded by the wrapper, every row access guarded;
//   * K4's column sums go through decoder.cuh DecColSums in a fixed order
//     and leave as per-block partials that a second kernel sums over the
//     blocks in order; the f32 values that outlive a product (K4: swish'
//     of the first layer, embed mode LN0's output) go to a per-block
//     scratch in device memory in the accumulator's layout.

#pragma once

#include "decoder.cuh"

namespace gc {

constexpr int kEdgeRows = 64;        // edge rows per block (one wgmma M)
constexpr int kEdgeCluster = 2;      // blocks sharing each weight box
constexpr int kEdgeMaxStages = 24;   // ring depth cap
constexpr int kEdgeIdx = kEdgeRows * 4;  // the tile's receivers, 256 B
constexpr int kEdgeSlots = 2;        // column-sum kinds put before a fold
// K1p: its epilogue warps (the producer warpgroup's last three), and the
// named barriers between them and the consumers: bf16(y) and idx ready, A
// free again (each counting the consumers and the epilogue warps); the
// staged sender rows read (the consumers and the staging warp). A staged
// row's stride in shared memory (16 bytes past kDecWidth bf16, so that the
// 8 rows a warp reads at once fall in different banks).
constexpr int kEdgeWalkers = 96;
constexpr int kEdgePipeSync = kDecConsumers + kEdgeWalkers;
constexpr int kEdgeBarReady = 2;
constexpr int kEdgeBarFree = 3;
constexpr int kEdgeStageSync = kDecConsumers + 32;
constexpr int kEdgeBarStaged = 4;
constexpr int kEdgeStageStride = 2 * kDecWidth + 16;
// K4's per-block scratch in floats per column of kDecWidth: two f32 tiles
// (LN0's output, embed mode; the cotangent dyn) and two bf16 tiles (swish'
// of the first layer; of the embed's first layer, embed mode).
constexpr int kEdgeWork = 64 + 64 + 32 + 32;

// The shared-memory layout of a block, in bytes from the 1024-aligned
// base: A (kDecWidth / 64 boxes), with `e_tile` a second such tile E, the
// ring, the row exchange, the tile's receivers, K4's column sums (`sums`
// floats) and their per-warp parts (kEdgeSlots x 4 warps x kDecWidth
// floats), the barriers (full and empty per stage, the tile load's). The
// ring takes what is left, up to kEdgeMaxStages boxes, rounded down to an
// even count (decoder.cuh ClusterRing). ops/fused_edge.py smem_layout
// mirrors it.
struct EdgeLayout {
  int a, e, ring, exchange, idx, sums, colred, bars, stages, total;
};

__host__ __device__ constexpr EdgeLayout edge_layout(int sums, bool e_tile) {
  EdgeLayout L{};
  L.a = 0;
  L.e = (kDecWidth / 64) * kDecBox;
  L.ring = L.e + (e_tile ? L.e : 0);
  const int colred = sums > 0 ? kEdgeSlots * 4 * kDecWidth * 4 : 0;
  const int bars = (2 * kEdgeMaxStages + 1) * 8;
  const int tail = kDecExchange + kEdgeIdx + sums * 4 + colred + bars;
  const int st = (kDecSmemLimit - kDecAlign - L.ring - tail) / kDecBox;
  L.stages = (st < kEdgeMaxStages ? st : kEdgeMaxStages) & ~1;  // even
  L.exchange = L.ring + L.stages * kDecBox;
  L.idx = L.exchange + kDecExchange;
  L.sums = L.idx + kEdgeIdx;
  L.colred = L.sums + sums * 4;
  L.bars = L.colred + colred;
  L.total = L.bars + bars + kDecAlign;
  return L;
}

struct EdgeSmem {
  unsigned char* a;
  unsigned char* e;  // the E tile (modes with e_tile)
  unsigned char* ring;
  float2* exchange;  // [2 buffers][2 warpgroups][64 rows]
  int* idx;          // [64]: the tile's receivers, -1 past its rows
  float* sums;       // K4's running column sums
  float* colred;     // [kEdgeSlots][4 warps][kDecWidth]
  uint64_t* full;    // [stages]
  uint64_t* empty;   // [stages]
  uint64_t* a_bar;
  int stages;

  __device__ __forceinline__ EdgeSmem(unsigned char* raw, const EdgeLayout& L)
      : stages(L.stages) {
    unsigned char* p = align_1024(raw);
    a = p + L.a;
    e = p + L.e;
    ring = p + L.ring;
    exchange = reinterpret_cast<float2*>(p + L.exchange);
    idx = reinterpret_cast<int*>(p + L.idx);
    sums = reinterpret_cast<float*>(p + L.sums);
    colred = reinterpret_cast<float*>(p + L.colred);
    full = reinterpret_cast<uint64_t*>(p + L.bars);
    empty = full + kEdgeMaxStages;
    a_bar = empty + kEdgeMaxStages;
  }

  // Thread 0 initialises the barriers; the block, then the cluster,
  // synchronise after.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      // One arrival per consumer warp of the warpgroup that reads the
      // stage, in each block of the cluster.
      mbar_init(&empty[s], 4 * kEdgeCluster);
    }
    mbar_init(a_bar, 1);
    mbar_fence_init();
  }
};

using EdgeProducer = ClusterProducer<kEdgeCluster>;
using EdgeRing = ClusterRing<kEdgeCluster>;

// This block's tile in the cluster walk, and this thread's two rows of it.
struct EdgeTile {
  int row0, rows;
  bool ok[2];     // rows r0, r0 + 8 hold an edge
  int er[2];      // their edge (row) indices
  int snd[2], rcv[2];

  __device__ __forceinline__ EdgeTile(int group, uint32_t rank, int num,
                                      const DecThread& th,
                                      const int* __restrict__ senders,
                                      const int* __restrict__ receivers) {
    row0 = (group * kEdgeCluster + (int)rank) * kEdgeRows;
    rows = max(0, min(kEdgeRows, num - row0));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      er[h] = row0 + th.r0 + 8 * h;
      ok[h] = th.r0 + 8 * h < rows;
      snd[h] = ok[h] ? __ldg(senders + er[h]) : 0;
      rcv[h] = ok[h] ? __ldg(receivers + er[h]) : 0;
    }
  }
};

// Signals named barrier `id` over `threads` threads without waiting (the
// other side waits in named_sync); this thread's prior shared-memory writes
// are visible to the threads that pass the barrier.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The tile's receivers into idx (-1 past its rows), by the first 64
// consumer threads; read after a later consumer barrier.
__device__ __forceinline__ void edge_load_idx(int* idx, const EdgeTile& t,
                                              const int* __restrict__ rcv,
                                              int ctid) {
  if (ctid < kEdgeRows) {
    idx[ctid] = ctid < t.rows ? __ldg(rcv + t.row0 + ctid) : -1;
  }
}

// A bf16 pair of a read-only array as its raw 32 bits (one register until
// it is used; bf2 unpacks it), through the non-coherent path. The load is
// unconditional: callers pass an address inside the array (row 0, column 0
// where the element is not wanted) and discard or mask the value at its
// use. Loaded under a predicate, with a zero written in its place, each
// load held up the ones after it (PERF.md §5).
__device__ __forceinline__ uint32_t ldg_raw2(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// sproj[snd] and rproj[rcv] at chunk q of this thread: sv[j][h], gv[j][h]
// are the raw bf16 pair of columns j of row r0 + 8 h; past the tile's rows
// and past C they hold row 0's values, which the caller discards. Every
// load is issued before any is used.
template <int NQ>
__device__ __forceinline__ void edge_gather(uint32_t (&sv)[8][2],
                                            uint32_t (&gv)[8][2],
                                            const DecThread& th, int q, int C,
                                            const EdgeTile& t,
                                            const bf16* __restrict__ sproj,
                                            const bf16* __restrict__ rproj) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = dec_col<NQ>(th, q, j);
    const int cc = c < C ? c : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sv[j][h] = ldg_raw2(sproj + (size_t)t.snd[h] * C + cc);
      gv[j][h] = ldg_raw2(rproj + (size_t)t.rcv[h] * C + cc);
    }
  }
}

// edge_gather with the sender rows staged in shared memory (K1p's encoder
// mode): sv from S (row r at r kEdgeStageStride; its values past the
// tile's rows and past C are stale and discarded by the caller), gv from
// rproj as edge_gather loads it.
template <int NQ>
__device__ __forceinline__ void edge_gather_staged(
    uint32_t (&sv)[8][2], uint32_t (&gv)[8][2], const DecThread& th, int q,
    int C, const EdgeTile& t, const unsigned char* S,
    const bf16* __restrict__ rproj) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = dec_col<NQ>(th, q, j);
    const int cc = c < C ? c : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sv[j][h] = *reinterpret_cast<const uint32_t*>(
          S + (th.r0 + 8 * h) * kEdgeStageStride + 2 * c);
      gv[j][h] = ldg_raw2(rproj + cc + (size_t)t.rcv[h] * C);
    }
  }
}

// The tile's own rows of a [*, C] bf16 array (d_e') at chunk q of this
// thread, raw, as edge_gather (row 0's values past the tile's rows and C).
template <int NQ>
__device__ __forceinline__ void edge_rows(uint32_t (&v)[8][2],
                                          const DecThread& th, int q, int C,
                                          const EdgeTile& t,
                                          const bf16* __restrict__ x) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = dec_col<NQ>(th, q, j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[j][h] = ldg_raw2(x + (size_t)(t.ok[h] ? t.er[h] : 0) * C +
                         (c < C ? c : 0));
    }
  }
}

// A <- hh = bf16(swish(bf16(f @ ew0 + eb0))) of the tile's rows (zeros past
// its rows and past C), the F-deep first layer on the CUDA cores in a plain
// loop over column pairs (consecutive threads, consecutive pairs of one
// row); with `hh` non-null also to that [*, C] array (K4's dEw1 operand),
// with `sxe` non-null swish' of the bf16 pre-activation to that per-block
// scratch tile in the accumulator's layout (K4's dxe epilogue reads it
// there, past a consumer barrier). kThr threads take part, ctid < kThr.
template <int NQ, int kThr = kDecConsumers>
__device__ __forceinline__ void edge_embed_hh(unsigned char* A, int ctid,
                                             const EdgeTile& t, int C, int F,
                                             const bf16* __restrict__ feat,
                                             const bf16* __restrict__ ew0,
                                             const float* __restrict__ eb0,
                                             bf16* hh, bf16* sxe) {
  constexpr int W = NQ * 128;
  for (int i = ctid; i < kEdgeRows * W / 2; i += kThr) {
    const int r = i / (W / 2), c = (i % (W / 2)) * 2;
    float hx = 0.f, hy = 0.f, gx = 0.f, gy = 0.f;
    if (r < t.rows && c < C) {
      const bf16* f = feat + (size_t)(t.row0 + r) * F;
      float x0 = 0.f, x1 = 0.f;
      for (int k = 0; k < F; ++k) {
        const float fk = __bfloat162float(__ldg(f + k));
        const float2 w = ldg_bf16x2(ew0 + (size_t)k * W + c);
        x0 = fmaf(fk, w.x, x0);
        x1 = fmaf(fk, w.y, x1);
      }
      const float2 b = ldg2(eb0 + c);
      x0 += b.x;
      x1 += b.y;
      hx = swish_of_bf16(x0);
      hy = swish_of_bf16(x1);
      if (hh != nullptr) {
        store_bf16x2(hh + (size_t)(t.row0 + r) * C + c, hx, hy);
      }
      gx = swish_grad_bf16(round_bf16(x0));
      gy = swish_grad_bf16(round_bf16(x1));
    }
    st_pair(A, r, c, hx, hy);
    if (sxe != nullptr) {
      // Element (r, c) belongs to consumer thread w 128 + 32 (r / 16) +
      // 4 (r % 8) + (c % 8) / 2, chunk q, pair j, row half (r / 8) % 2.
      const int cth = (c / (W / 2)) * 128 + (r / 16) * 32 + (r % 8) * 4 +
                      (c % 8) / 2;
      uint2* slot =
          DecScratch16<NQ>{sxe}.at((c / 64) % NQ, (c % 64) / 8, cth);
      reinterpret_cast<uint32_t*>(slot)[(r / 8) % 2] = pack_bf16x2(gx, gy);
    }
  }
}

// K4's column sums of 8 values, columns dec_col(q, 4 half + k / 2) + k % 2
// of this thread (v[k] its part over its two rows), summed over the warp's
// 8 row groups by a reduce-scatter (7 shuffles, where DecColSums::put
// takes 24): lane group k = lane / 4 ends with value k's total, which it
// writes to colred slot `slot` for DecColSums::fold. A fixed order.
template <int NQ>
__device__ __forceinline__ void edge_put8(const DecColSums& cs,
                                          const DecThread& th, int q,
                                          int half, const float (&v)[8],
                                          int slot) {
  const bool b1 = th.lane & 16, b2 = th.lane & 8, b3 = th.lane & 4;
  float w[4], x[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b1 ? v[i] : v[4 + i];
    w[i] = (b1 ? v[4 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b2 ? w[i] : w[2 + i];
    x[i] = (b2 ? w[2 + i] : w[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float y =
      (b3 ? x[1] : x[0]) + __shfl_xor_sync(0xffffffffu, b3 ? x[0] : x[1], 4);
  const int k = th.lane >> 2;
  const int col = dec_col<NQ>(th, q, 4 * half + k / 2) + (k & 1);
  cs.colred[(slot * 4 + th.wl) * kDecWidth + col] = y;
}

// Thread ctid 0 of the consumers: the tile's rows of `tile` (bf16, kDecWidth
// / 64 boxes) to rows row0.. of the [*, C] array of `map` by TMA store, the
// boxes of the C true columns only (rows past the array's end are not
// written); committed, not waited for. Issue past dec_publish; before the
// tile is written again, tma_store_wait_read in the same thread and a
// consumer barrier.
__device__ __forceinline__ void edge_store_tile(const CUtensorMap* map,
                                                const unsigned char* tile,
                                                int row0, int C) {
  for (int c = 0; c < C; c += 64) {
    tma_store_2d(map, tile + (c / 64) * kDecBox, c, row0);
  }
  tma_store_commit();
}

// Sums of the bf16 tile in A over the tile's receiver runs (idx), columns
// c, c + 1 (c even) of this thread, one f32 sum per run in row order: a
// plain store into dst [N, C] for a run inside the tile; the runs that touch
// the tile's first or last row, which may continue into a neighbouring
// tile, go to this tile's boundary partials bnd [2][C] (slot 0: the run at
// the first row, slot 1: the one at the last row when it is another run),
// which edge_bounds adds into dst in tile order. Call past a consumer
// barrier that follows the tile's writes.
__device__ __forceinline__ void edge_run_sums(const unsigned char* A,
                                              const int* idx, int rows,
                                              int C, float* __restrict__ dst,
                                              float* __restrict__ bnd,
                                              int c) {
  if (c >= C) return;
  int r = 0;
  while (r < rows) {
    const int node = idx[r];
    float sx = 0.f, sy = 0.f;
    int r1 = r;
    do {
      const float2 v = ld_pair(A, r1, c);
      sx += v.x;
      sy += v.y;
      ++r1;
    } while (r1 < rows && idx[r1] == node);
    float* p = r == 0 ? bnd + c
                      : (r1 == rows ? bnd + C + c : dst + (size_t)node * C + c);
    *reinterpret_cast<float2*>(p) = make_float2(sx, sy);
    r = r1;
  }
}

namespace {

// The second pass of the receiver-run sums: per boundary partial that
// starts a node's span of tile ends (entry 2 t + s of tile t, slot s), the
// partials of that node in tile order, added into dst[node] (f32, 4
// columns a thread). A node's span: its run at tile t's last row (or first,
// when the tile is one run), then the first-row runs of the tiles after
// while they hold it; a node whose edges cross no tile end has no partial
// or one. rcv: the launch's receivers [num_edges], sorted.
__global__ void __launch_bounds__(256) edge_bounds_kernel(
    const int* __restrict__ rcv, int num_edges, int C,
    const float* __restrict__ bnd, float* __restrict__ dst) {
  const int tiles = (num_edges + kEdgeRows - 1) / kEdgeRows;
  const int entry = blockIdx.x * blockDim.y + threadIdx.y;
  if (entry >= 2 * tiles) return;
  const int t = entry / 2;
  const int row0 = t * kEdgeRows;
  const int first = __ldg(rcv + row0);
  const int last = __ldg(rcv + min(num_edges, row0 + kEdgeRows) - 1);
  int node;
  if (entry % 2 == 0) {
    node = first;
    if (t > 0 && __ldg(rcv + row0 - 1) == node) return;  // not its start
  } else {
    if (last == first) return;  // one run: slot 0 holds it
    node = last;
  }
  for (int c = 4 * threadIdx.x; c < C; c += 4 * blockDim.x) {
    float4 s = *reinterpret_cast<const float4*>(bnd + (size_t)entry * C + c);
    for (int u = t + 1; u < tiles; ++u) {
      const int u0 = u * kEdgeRows;
      if (__ldg(rcv + u0) != node) break;
      const float4 p =
          *reinterpret_cast<const float4*>(bnd + (size_t)2 * u * C + c);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
      if (__ldg(rcv + min(num_edges, u0 + kEdgeRows) - 1) != node) break;
    }
    float4* d = reinterpret_cast<float4*>(dst + (size_t)node * C + c);
    const float4 o = *d;
    *d = make_float4(o.x + s.x, o.y + s.y, o.z + s.z, o.w + s.w);
  }
}

}  // namespace

// edge_bounds_kernel over a launch's ceil(num_edges / 64) tiles, bnd [tiles,
// 2, C] as the edge kernel left it, dst [N, C] (C a multiple of 4).
inline cudaError_t edge_bounds(const int* rcv, int num_edges, int C,
                               const float* bnd, float* dst,
                               cudaStream_t stream) {
  if (num_edges <= 0) return cudaSuccess;
  const int tiles = (num_edges + kEdgeRows - 1) / kEdgeRows;
  const dim3 block(128, 2);
  edge_bounds_kernel<<<tiles, block, 0, stream>>>(rcv, num_edges, C, bnd,
                                                  dst);
  return cudaGetLastError();
}

// K1's and K1p's operands (fused_edge.cu, fused_edge_pipelined.cu).
struct EdgeFwdMaps {
  CUtensorMap e, eout, we, w1, ew1;
};

struct EdgeFwdArgs {
  const bf16* e;          // [E, C]; embed mode: raw features [E, F]
  const bf16* sproj;      // [num_senders, C]
  const int* senders;     // [E]
  const bf16* rproj;      // [num_receivers, C]
  const int* receivers;   // [E], sorted
  const float *b0, *b1, *scale, *offset;  // [kDecWidth], zero-padded
  bf16* eout;             // [E, C] (e' written)
  float* agg;             // [num_receivers, C], zeroed
  float* bnd;             // [tiles, 2, C]: the tile-end run partials
  const bf16* ew0;        // embed mode: [F, kDecWidth], zero-padded
  const float *eb0, *eb1;  // embed mode: [kDecWidth]
  int num_edges, C, F;
};

inline EdgeFwdArgs edge_fwd_args(const void* e, const void* sproj,
                                 const int* senders, const void* rproj,
                                 const int* receivers, const float* b0,
                                 const float* b1, const float* scale,
                                 const float* offset, void* eout, float* agg,
                                 float* bnd, int num_edges, int C) {
  EdgeFwdArgs a{};
  a.e = static_cast<const bf16*>(e);
  a.sproj = static_cast<const bf16*>(sproj);
  a.senders = senders;
  a.rproj = static_cast<const bf16*>(rproj);
  a.receivers = receivers;
  a.b0 = b0; a.b1 = b1; a.scale = scale; a.offset = offset;
  a.eout = static_cast<bf16*>(eout);
  a.agg = agg;
  a.bnd = bnd;
  a.num_edges = num_edges; a.C = C;
  return a;
}

// K1's consumer warpgroups' walk over the cluster's tiles (fused_edge.cu's
// head note). With kPipe, K1p's (fused_edge_pipelined.cu). In the modes
// with We or e' and in embed mode (kWalk): e, hh and en sit in the tile E,
// so that A holds only h and bf16(y); the tile's receivers alternate
// between two idx buffers; the receiver-run sums are left to K1p's
// epilogue warps, which take A and idx after the barrier kEdgeBarReady and
// hand A back at kEdgeBarFree, waited for just before the next tile's
// first write to A. Without We and e' (encoder mode, kStage): the tile's
// sender rows arrive staged in the tile S (sh.e) by bulk copies completing
// on the mbarrier at sh.sums, the first epilogue reads them there, and
// hands S back at kEdgeBarStaged; e stays in A and the consumers keep the
// run sums. Every value is computed as in K1, in the same order.
template <bool kHasWe, bool kWriteE, bool kEmbed, bool kPipe>
__device__ __forceinline__ void edge_fwd_consumer(const EdgeFwdMaps& maps,
                                                  const EdgeFwdArgs& a,
                                                  const EdgeSmem& sh,
                                                  uint32_t rank, int groups,
                                                  int cluster, int clusters) {
  constexpr int NQ = kDecNQ;
  constexpr int kK = 2 * NQ;  // 64-deep slabs of a product
  const int C = a.C;
  const DecThread th(threadIdx.x);
  EdgeRing ring(sh, th);
  DecRows rsum{sh.exchange};
  // e's tile: E where e' is written (and in K1p with We), else A; the
  // embed's operand tile for hh and en: E in K1p, else A.
  constexpr bool kEInE = kWriteE || (kPipe && kHasWe);
  constexpr bool kWalk = kPipe && (kWriteE || kHasWe);
  constexpr bool kStage = kPipe && !kWalk;
  unsigned char* const e_tile = kEInE ? sh.e : sh.a;
  unsigned char* const x_tile = kPipe ? sh.e : sh.a;
  const uint32_t a_addr = smem_u32(sh.a), e_addr = smem_u32(e_tile);
  const uint32_t x_addr = smem_u32(x_tile);
  float acc[NQ][32];
  int it = 0;
  for (int grp = cluster; grp < groups; grp += clusters, ++it) {
    const EdgeTile t(grp, rank, a.num_edges, th, a.senders, a.receivers);
    int* const idx = sh.idx + (kWalk ? (it & 1) * kEdgeRows : 0);
    if (kWriteE && th.ctid == 0) tma_store_wait_read();  // the last e'
    dec_sync();  // the previous tile is done with A, E and idx
    edge_load_idx(idx, t, a.receivers, th.ctid);
    if (kEmbed) {
      // X <- hh; acc = hh @ Ew1; X <- en = bf16(LN0(acc + eb1)).
      edge_embed_hh<NQ>(x_tile, th.ctid, t, C, a.F, a.e, a.ew0, a.eb0,
                        nullptr, nullptr);
      dec_publish();
      dec_mma<NQ, 1>(acc, x_addr, kK, false, ring);
      const float4 st = dec_ln_stats<NQ>(acc, a.eb1, th, rsum, C);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = dec_col<NQ>(th, q, j);
          const float2 b = ldg2(a.eb1 + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool in = c < C;
            st_pair(x_tile, th.r0 + 8 * h, c,
                    in ? dec_ln(st, acc[q][4 * j + 2 * h] + b.x, h) : 0.f,
                    in ? dec_ln(st, acc[q][4 * j + 2 * h + 1] + b.y, h) : 0.f);
          }
        }
      }
      dec_publish();
      dec_mma<NQ, 1>(acc, x_addr, kK, false, ring);  // en @ We
      dec_sync();  // both warpgroups are done reading X
    } else {
      if (th.ctid == 0) {
        dec_load_tile(e_tile, &maps.e, sh.a_bar, kDecWidth, t.row0);
      }
      mbar_wait(sh.a_bar, it & 1);  // e (zeros past the rows and C)
      if (kHasWe) {
        dec_mma<NQ, 1>(acc, e_addr, kK, false, ring);  // e @ We
        dec_sync();
      }
    }

    if (kWalk && it > 0) {
      named_sync(kEdgeBarFree, kEdgePipeSync);  // A is the consumers' again
    }
    // A <- h = bf16(swish(bf16(x0))), x0 = ((e @ We or e) + Gs) + Gr (+ b0).
    if (kStage) mbar_wait(reinterpret_cast<uint64_t*>(sh.sums), it & 1);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      uint32_t sv[8][2], gv[8][2];
      if (kStage) {
        edge_gather_staged<NQ>(sv, gv, th, q, C, t, sh.e, a.rproj);
      } else {
        edge_gather<NQ>(sv, gv, th, q, C, t, a.sproj, a.rproj);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = dec_col<NQ>(th, q, j);
        const float2 b = kHasWe ? ldg2(a.b0 + c) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = th.r0 + 8 * h;
          float2 x = kHasWe ? make_float2(acc[q][4 * j + 2 * h],
                                          acc[q][4 * j + 2 * h + 1])
                            : ld_pair(e_tile, r, c);
          const float2 s = bf2(sv[j][h]), g = bf2(gv[j][h]);
          x.x += s.x;
          x.y += s.y;
          x.x += g.x;
          x.y += g.y;
          if (kHasWe) {
            x.x += b.x;
            x.y += b.y;
          }
          const bool in = t.ok[h] && c < C;
          st_pair(sh.a, r, c, in ? swish_of_bf16(x.x) : 0.f,
                  in ? swish_of_bf16(x.y) : 0.f);
        }
      }
    }
    if (kStage) named_arrive(kEdgeBarStaged, kEdgeStageSync);  // S read
    dec_publish();
    dec_mma<NQ, 1>(acc, a_addr, kK, false, ring);  // h @ W1
    const float4 st = dec_ln_stats<NQ>(acc, a.b1, th, rsum, C);
    // y = LN(.) * scale + offset; E <- e' = bf16(e + y); A <- bf16(y).
    // Both warpgroups are past the product (dec_ln_stats' barrier).
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = dec_col<NQ>(th, q, j);
        const float2 b = ldg2(a.b1 + c), sc = ldg2(a.scale + c),
                     of = ldg2(a.offset + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = dec_ln(st, acc[q][4 * j + 2 * h] + b.x, h) * sc.x +
                           of.x;
          const float y1 =
              dec_ln(st, acc[q][4 * j + 2 * h + 1] + b.y, h) * sc.y + of.y;
          if (kWriteE) {
            const float2 e = ld_pair(sh.e, th.r0 + 8 * h, c);
            st_pair(sh.e, th.r0 + 8 * h, c, e.x + y0, e.y + y1);
          }
          st_pair(sh.a, th.r0 + 8 * h, c, y0, y1);
        }
      }
    }
    if (kWriteE) {
      dec_publish();
      if (th.ctid == 0) edge_store_tile(&maps.eout, sh.e, t.row0, C);
    } else if (!kWalk) {
      dec_sync();
    }
    if (kWalk) {
      named_arrive(kEdgeBarReady, kEdgePipeSync);  // A and idx to the walk
    } else {
      edge_run_sums(sh.a, idx, t.rows, C, a.agg,
                    a.bnd + (size_t)(t.row0 / kEdgeRows) * 2 * C,
                    2 * th.ctid);
    }
  }
  if (kWalk && it > 0) named_sync(kEdgeBarFree, kEdgePipeSync);
}

// A cluster launch of an edge kernel over `tiles` 64-row tiles: as many
// clusters as fit at once, at most one per group of kEdgeCluster tiles and
// at most max_blocks blocks.
template <typename Kernel, typename Maps, typename Args>
cudaError_t edge_launch(Kernel kernel, int smem, int tiles, int max_blocks,
                        cudaStream_t stream, const Maps& maps,
                        const Args& args, int* blocks = nullptr) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int groups = (tiles + kEdgeCluster - 1) / kEdgeCluster;
  cudaError_t err = dec_launch_config<kEdgeCluster>(
      kernel, smem, groups, max_blocks, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  if (blocks != nullptr) *blocks = (int)cfg.gridDim.x;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gc
