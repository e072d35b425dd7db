// The pieces the block-sparse attention kernels share (splash_fwd.cu: K6;
// splash_bwd.cu: K7, K8). Each runs one block per (pair of neighbouring
// tiles 2g, 2g + 1, batch·head) over the union of the two tiles' lists
// (ops/splash.py paired_lists): a producer warp loads the block's own tiles
// once and streams each union entry's two 64 x 128 tiles and the present
// pairs' mask words into a ring of full/empty mbarriers, and two consumer
// warpgroups, one per tile of the pair, read them. The mask words: one
// 64-bit word per row of a pair (bit c: column c of the other tile).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace gc {

constexpr int kSpStages = 4;                  // ring depth
constexpr int kSpBox = kSpT * 64 * 2;         // a 64 x 64 bf16 box
constexpr int kSpTile = 2 * kSpBox;           // a 64 x 128 tile
constexpr int kSpWords = kSpT * 8;            // a pair's mask words
constexpr int kSpRowVals = kSpT * 4;          // 64 f32 values, one per row
constexpr int kSpBlockThreads = 2 * 128 + 32;  // consumers + producer warp

// Dynamic shared memory of a kernel with `kinds` own tiles per tile of the
// pair and, with `row_vals`, two f32 row values per streamed row (K8's lse
// and delta); 1024 bytes for the alignment of the swizzled tiles.
constexpr int splash_smem(int kinds, bool row_vals) {
  return kinds * 2 * kSpTile +
         kSpStages *
             (2 * kSpTile + 2 * kSpWords + (row_vals ? 2 * kSpRowVals : 0)) +
         (2 * kSpStages + 1) * 8 + 1024;
}

// Position r of a block's stream sits in stage r % kSpStages, filled in
// phase (r / kSpStages) & 1.
__device__ __forceinline__ int ring_stage(int r) { return r % kSpStages; }
__device__ __forceinline__ uint32_t ring_phase(int r) {
  return (uint32_t)((r / kSpStages) & 1);
}

// S = A B^T for one entry into s: 8 k16 steps over the head dim, both
// operands K-major 64 x 128 tiles, the first step overwriting s. Issues the
// wgmma.fence; the caller commits.
__device__ __forceinline__ void issue_scores(float (&s)[kSpT / 2],
                                             uint32_t a_addr,
                                             uint32_t b_addr) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSpD / 16; ++ks) {
    wgmma_m64n64k16_ss<0, 0>(s, kmajor_desc(a_addr, ks, kSpBox),
                             kmajor_desc(b_addr, ks, kSpBox), ks > 0);
  }
}

// The shared memory and barriers of a block: its own tiles, `kinds` of
// them per tile of the pair (K6: Q; K7: Q, dO; K8: K, V), then the ring's
// stages of two streamed tiles (K6, K7: K, V; K8: Q, dO), their mask words,
// with `row_vals` the lse and delta of the stage's q tile (K8), and the
// barriers.
struct SplashSmem {
  unsigned char* own[2];      // [2 tiles] of each kind
  unsigned char* ring;        // stage s: the first streamed tile, the other
  unsigned long long* words;  // [stages][2 tiles][kSpT]
  float* lse;                 // [stages][kSpT] (K8)
  float* delta;               // [stages][kSpT] (K8)
  uint64_t* full_bar;         // [stages]
  uint64_t* empty_bar;        // [stages]
  uint64_t* own_bar;          // the block's own tiles

  __device__ __forceinline__ SplashSmem(unsigned char* raw, int kinds,
                                        bool row_vals) {
    unsigned char* p = align_1024(raw);
    own[0] = p;
    own[1] = p + 2 * kSpTile;
    ring = p + kinds * 2 * kSpTile;
    words = reinterpret_cast<unsigned long long*>(
        ring + kSpStages * 2 * kSpTile);
    lse = reinterpret_cast<float*>(words + kSpStages * 2 * kSpT);
    delta = lse + kSpStages * kSpT;
    full_bar = reinterpret_cast<uint64_t*>(
        row_vals ? delta + kSpStages * kSpT : lse);
    empty_bar = full_bar + kSpStages;
    own_bar = empty_bar + kSpStages;
  }

  // Thread 0 initialises the barriers; the block synchronises after.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kSpStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 8);  // one arrival per consumer warp
    }
    mbar_init(own_bar, 1);
    mbar_fence_init();
  }

  // The producer's first loads: the block's `tiles` tiles (rows row0 +
  // (2 grp + w) * kSpT) of map ta and, unless it is null, of map tb.
  __device__ __forceinline__ void load_own(const CUtensorMap* ta,
                                           const CUtensorMap* tb, int row0,
                                           int grp, int tiles) const {
    const int kinds = tb == nullptr ? 1 : 2;
    mbar_arrive_expect_tx(own_bar, tiles * kinds * kSpTile);
    for (int w = 0; w < tiles; ++w) {
      const int r = row0 + (2 * grp + w) * kSpT;
      tma_load_2d(own[0] + w * kSpTile, ta, own_bar, 0, r);
      tma_load_2d(own[0] + w * kSpTile + kSpBox, ta, own_bar, 64, r);
      if (tb != nullptr) {
        tma_load_2d(own[1] + w * kSpTile, tb, own_bar, 0, r);
        tma_load_2d(own[1] + w * kSpTile + kSpBox, tb, own_bar, 64, r);
      }
    }
  }

  // The producer's stream at position r, list entry e: waits for the
  // stage's slot, announces its bytes (the two tiles, `extra` more, the
  // present pairs' words), loads both tiles (rows `row` of maps ta and tb)
  // and the words, and returns the stage's full barrier for the caller's
  // extra bulk loads. A pair that is absent or full loads no words.
  __device__ __forceinline__ uint64_t* stream(
      int r, int e, const CUtensorMap* ta, const CUtensorMap* tb, int row,
      const int2* __restrict__ pairs, const int* __restrict__ full,
      const unsigned long long* __restrict__ pair_words,
      uint32_t extra) const {
    const int st = ring_stage(r);
    const int2 pr = pairs[e];
    const bool w0 = pr.x >= 0 && !full[pr.x];
    const bool w1 = pr.y >= 0 && !full[pr.y];
    mbar_wait(&empty_bar[st], ring_phase(r) ^ 1);
    uint64_t* bar = &full_bar[st];
    mbar_arrive_expect_tx(bar, 2 * kSpTile + extra + (w0 + w1) * kSpWords);
    unsigned char* d = ring + st * 2 * kSpTile;
    tma_load_2d(d, ta, bar, 0, row);
    tma_load_2d(d + kSpBox, ta, bar, 64, row);
    tma_load_2d(d + kSpTile, tb, bar, 0, row);
    tma_load_2d(d + kSpTile + kSpBox, tb, bar, 64, row);
    unsigned long long* w = words + st * 2 * kSpT;
    if (w0) bulk_load(w, pair_words + (size_t)pr.x * kSpT, kSpWords, bar);
    if (w1) {
      bulk_load(w + kSpT, pair_words + (size_t)pr.y * kSpT, kSpWords, bar);
    }
    return bar;
  }

  // The shared address of stream position r's first tile (the other one
  // follows at + kSpTile).
  __device__ __forceinline__ uint32_t streamed(int r) const {
    return smem_u32(ring + ring_stage(r) * 2 * kSpTile);
  }
};

// A consumer thread: warpgroup wg (the pair's tile 2 grp + wg); warp w of
// it owns rows 16 w .. 16 w + 15 of the tile, this thread rows r0 and
// r0 + 8, columns 8 j + 2 t (+1) of each accumulator.
struct Lane {
  int wg, lane, t, r0;
  __device__ __forceinline__ Lane(int warp, int lane_)
      : wg(warp / 4), lane(lane_), t(lane_ & 3),
        r0((warp % 4) * 16 + (lane_ >> 2)) {}
};

// The mask bits of one of this thread's rows for columns 8 j + 2 t + c
// (j < 8, c < 2), tested at constant shifts: bit 8 (j % 4) + c of word
// j / 4 of (w >> 2 t).
struct RowBits {
  uint32_t w[2];
  RowBits() = default;
  __device__ __forceinline__ RowBits(unsigned long long word, int t) {
    const unsigned long long v = word >> (2 * t);
    w[0] = (uint32_t)v;
    w[1] = (uint32_t)(v >> 32);
  }
  __device__ __forceinline__ bool has(int j, int c) const {
    return (w[j / 4] >> (8 * (j % 4) + c)) & 1u;
  }
};

// This warpgroup's mask bits of list entry e (at stream position r) for
// rows r0 and r0 + 8: the pair's own words, all ones for a full pair, all
// zeros where the tile has no pair with the entry's tile.
__device__ __forceinline__ void entry_bits(const SplashSmem& sm,
                                           const int2* __restrict__ pairs,
                                           const int* __restrict__ full,
                                           int r, int e, const Lane& ln,
                                           RowBits& b0, RowBits& b1) {
  const int2 pr = pairs[e];
  const int a = ln.wg == 0 ? pr.x : pr.y;
  unsigned long long w0 = a < 0 ? 0ull : ~0ull, w1 = w0;
  if (a >= 0 && !full[a]) {
    const unsigned long long* ws =
        sm.words + (ring_stage(r) * 2 + ln.wg) * kSpT;
    w0 = ws[ln.r0];
    w1 = ws[ln.r0 + 8];
  }
  b0 = RowBits(w0, ln.t);
  b1 = RowBits(w1, ln.t);
}

}  // namespace gc
