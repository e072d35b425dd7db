// K3: the sorted segment sum of edge messages into their receivers, for
// Hopper (sm_90a).
//
// Replaces graphcast_tpu/ops/pallas_mp.py::_agg_kernel (driven by
// BlockedSegmentSum._forward): over receiver-sorted edges,
//
//   out[n] = sum over the edges e into n of messages[e]
//
// summed in f32 and rounded once to the messages' dtype (bf16 or f32); a
// receiver with no edges gets zeros. A batch is folded into the channels by
// the caller ([E, B, C] -> [E, B*C]), as the JAX package does. The TPU
// kernel turns the scatter into one-hot matmuls on the MXU over bitpacked
// membership masks; that technique is not carried over. Here the edges into
// one receiver are one contiguous row range (CSR order), and a block simply
// reads that range and adds it up.
//
// What bounds it on an H100: bytes. Every message element is read once and
// added once in f32 (E*C adds against 2 or 4 bytes each, far below the
// FP32 rate), and every output row is written once. Design:
//   * work items (ops/segment_sum.py plans them on the host, once per edge
//     set): each receiver's edge range is cut into chunks of at most
//     kChunkEdges rows (64), one item per chunk; a receiver with no edges
//     has one empty item;
//   * pass 1: one row of threads per item and channel slice; each thread
//     owns the 16 bytes of channels (8 bf16 or 4 f32) it loads from every
//     edge row of the chunk with one vector load and adds into f32
//     registers. A receiver of one chunk (every mesh receiver, most
//     grid2mesh ones) is rounded once and written straight to ``out``; a
//     receiver of several chunks writes each chunk's f32 sum to a scratch
//     row instead;
//   * pass 2: per receiver of several chunks, the scratch rows are added in
//     chunk order, rounded once and written.
// So a skewed in-degree (594 at 1.0 deg grid2mesh, 3,753 at 0.25 deg) costs
// no thread more than 64 serial loads, no atomics are used, and the order of
// every sum is fixed by the plan: the result is the same in every run.
//
// The sender mode (``perm`` non-null) is the backward kernels' scatter of
// per-edge sender gradients to their sender nodes (K4's dGs, K5's
// dmesh_proj; pallas_edge.py and pallas_decoder.py sum them over the TPU
// grid in order). The edges stay in their receiver-sorted rows: the plan
// runs over the senders' CSR offsets of a stable sender-sorted permutation,
// and each work item reads its rows through ``perm`` (one 4-byte index a
// row, the same for every thread of the row), so no [E, C] copy in sender
// order is made. The sums leave in f32, as the f32 scatter they replace.

#include "common.cuh"

namespace gc {

constexpr int kSegThreads = 256;

template <typename T>
struct SegVec;  // channels per 16-byte vector
template <>
struct SegVec<float> {
  static constexpr int n = 4;
};
template <>
struct SegVec<bf16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void add_vec(float* acc, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

__device__ __forceinline__ void add_vec(float* acc, const bf16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* acc) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__device__ __forceinline__ void store_vec(bf16* p, const float* acc) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// V f32 values from / to scratch (V / 4 float4s).
template <int V>
__device__ __forceinline__ void add_f32(float* acc, const float* p) {
#pragma unroll
  for (int i = 0; i < V; i += 4) add_vec(acc + i, p + i);
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* acc) {
#pragma unroll
  for (int i = 0; i < V; i += 4) store_vec(p + i, acc + i);
}

// V sums to the output: in the messages' dtype, or in f32.
template <int V>
__device__ __forceinline__ void store_out(bf16* p, const float* acc) {
  store_vec(p, acc);
}

template <int V>
__device__ __forceinline__ void store_out(float* p, const float* acc) {
  store_f32<V>(p, acc);
}

// items[i] = (receiver, first edge, end edge, scratch row or -1); with
// kPerm the item's rows are perm[first edge .. end edge).
template <typename T, typename TO, bool kPerm>
__global__ void __launch_bounds__(kSegThreads) segment_sum_kernel(
    const T* __restrict__ msgs, const int* __restrict__ perm,
    const int4* __restrict__ items, int num_items,
    float* __restrict__ scratch, TO* __restrict__ out, int C) {
  constexpr int V = SegVec<T>::n;
  const int item = blockIdx.x * blockDim.y + threadIdx.y;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (item >= num_items || c >= C) return;
  const int4 it = items[item];
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (kPerm) {
#pragma unroll 4
    for (int e = it.y; e < it.z; ++e) {
      add_vec(acc, msgs + (size_t)__ldg(perm + e) * C + c);
    }
  } else {
    const T* p = msgs + (size_t)it.y * C + c;
#pragma unroll 4
    for (int e = it.y; e < it.z; ++e, p += C) add_vec(acc, p);
  }
  if (it.w < 0) {
    store_out<V>(out + (size_t)it.x * C + c, acc);
  } else {
    store_f32<V>(scratch + (size_t)it.w * C + c, acc);
  }
}

// splits[s] = (receiver, first scratch row, end scratch row, unused).
template <int V, typename TO>
__global__ void __launch_bounds__(kSegThreads) segment_sum_combine_kernel(
    const int4* __restrict__ splits, int num_splits,
    const float* __restrict__ scratch, TO* __restrict__ out, int C) {
  const int s = blockIdx.x * blockDim.y + threadIdx.y;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (s >= num_splits || c >= C) return;
  const int4 sp = splits[s];
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  for (int r = sp.y; r < sp.z; ++r) add_f32<V>(acc, scratch + (size_t)r * C + c);
  store_out<V>(out + (size_t)sp.x * C + c, acc);
}

// Blocks of kSegThreads threads: x across a row's 16-byte lanes (whole
// warps), y across rows when a row has fewer lanes than the block.
inline void segment_grid(int rows, int C, int V, dim3* grid, dim3* block) {
  const int lanes = C / V;
  int bx = (lanes + 31) / 32 * 32;
  bx = bx < kSegThreads ? bx : kSegThreads;
  const int by = kSegThreads / bx;
  *block = dim3(bx, by);
  *grid = dim3((rows + by - 1) / by, (lanes + bx - 1) / bx);
}

template <typename T, typename TO, bool kPerm>
int launch_segment_sum(const void* msgs, const int* perm, const int* items,
                       int num_items, const int* splits, int num_splits,
                       float* scratch, void* out, int C, cudaStream_t stream) {
  constexpr int V = SegVec<T>::n;
  if (C <= 0 || C % V) return cudaErrorInvalidValue;
  dim3 grid, block;
  segment_grid(num_items, C, V, &grid, &block);
  segment_sum_kernel<T, TO, kPerm><<<grid, block, 0, stream>>>(
      static_cast<const T*>(msgs), perm,
      reinterpret_cast<const int4*>(items), num_items, scratch,
      static_cast<TO*>(out), C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_splits == 0) return err;
  segment_grid(num_splits, C, V, &grid, &block);
  segment_sum_combine_kernel<V, TO><<<grid, block, 0, stream>>>(
      reinterpret_cast<const int4*>(splits), num_splits, scratch,
      static_cast<TO*>(out), C);
  return cudaGetLastError();
}

}  // namespace gc

// out[N, C] = segment sums of msgs[E, C] (bf16 if is_bf16, else f32; 16-byte
// aligned, C a multiple of 8) over the work items [num_items, 4] and splits
// [num_splits, 4] (int32) that ops/segment_sum.py plans; scratch holds one
// f32 row of C per split chunk (null when num_splits is 0); out in the
// messages' dtype. With perm ([E] int32, non-null) the sender mode: the
// items' edge ranges index perm, whose entries are the message rows, the
// messages are bf16 and out is f32.
extern "C" int gc_segment_sum(const void* msgs, const int* perm,
                              const int* items, int num_items,
                              const int* splits, int num_splits,
                              float* scratch, void* out, int C, int is_bf16,
                              void* stream) {
  using gc::bf16;
  using gc::launch_segment_sum;
  if (num_items <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (perm != nullptr) {
    if (!is_bf16) return cudaErrorInvalidValue;
    return launch_segment_sum<bf16, float, true>(
        msgs, perm, items, num_items, splits, num_splits, scratch, out, C, s);
  }
  if (is_bf16) {
    return launch_segment_sum<bf16, bf16, false>(
        msgs, perm, items, num_items, splits, num_splits, scratch, out, C, s);
  }
  return launch_segment_sum<float, float, false>(
      msgs, perm, items, num_items, splits, num_splits, scratch, out, C, s);
}
