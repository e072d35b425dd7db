// Shared pieces of the port's Hopper kernels: scalar helpers (bf16
// rounding, swish and its derivative, bf16 pair loads and stores, warp
// sums), the persistent grid size, and the attention kernels' constants
// and fragment helpers (splash_fwd.cu, splash_bwd.cu). The fused edge and
// decoder kernels build on decoder.cuh and edge.cuh; the TMA and wgmma
// building blocks are in hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// swish of x rounded to bf16 first: the TPU kernels apply the activation to
// the bf16-rounded first-layer output.
__device__ __forceinline__ float swish_of_bf16(float x) {
  const float xb = round_bf16(x);
  return xb / (1.0f + expf(-xb));
}

// swish'(xb) = s + xb * s * (1 - s), s = sigmoid(xb), at a bf16-rounded xb;
// rounded to bf16, as the TPU backward kernels evaluate it in bf16.
__device__ __forceinline__ float swish_grad_bf16(float xb) {
  const float s = 1.0f / (1.0f + expf(-xb));
  return round_bf16(s + xb * s * (1.0f - s));
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Number of blocks for a persistent grid-stride launch over `tiles` tiles,
// one resident block per SM.
inline int persistent_blocks(int tiles) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms < 1) sms = 1;
  return tiles < sms ? tiles : sms;
}

// The attention kernels (splash_fwd.cu, splash_bwd.cu): tiles of 64 q rows
// by 64 kv columns at head dim 128, base-2 exponentials, fragment packing
// and sums over the 4 threads of a quad (the threads that share a fragment
// row).
constexpr int kSpT = 64;            // q rows and kv columns per tile
constexpr int kSpD = 128;           // head dim
constexpr float kSpNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x, one MUFU instruction (the attention kernels' exponentials, taken in
// base 2 with log2(e) folded into the scale).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace gc
