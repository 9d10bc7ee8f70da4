// Block-level building blocks of the decode kernels
// (packed_decode_attention.cu, fused_decode_layers.cu,
// fused_paged_decode_layers.cu): element conversion, warp and block
// reductions, the ordered sums of split-K partials, and the activation.
//
// Every block function here is called by all kThreads threads of a block
// with block-uniform arguments (they contain __syncthreads).

#pragma once

#include "kv_quant.cuh"

namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;   // partials a reader loads at once
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back: the kernels round where the TPU kernel casts
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (is_max false) or max over the block; every thread gets the
// result. red: kWarps + 1 floats, free again on return.
__device__ __forceinline__ float block_reduce(float v, float* red,
                                              bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? red[lane] : (is_max ? kNegInf : 0.f);
    w = is_max ? warp_max(w) : warp_sum(w);
    if (lane == 0) red[kWarps] = w;
  }
  __syncthreads();
  const float out = red[kWarps];
  __syncthreads();
  return out;
}

// (m, l) pairs merged over the block: m the largest of the m's, l the
// sum of l * exp(m_i - m); every thread gets both. A thread with nothing
// holds (-1e30, 0). red: 2 * kWarps + 2 floats, free again on return.
__device__ __forceinline__ float2 block_max_sumexp(float m, float l,
                                                   float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto merge = [&](float mo, float lo) {
    const float mn = fmaxf(m, mo);
    l = l * expf(m - mn) + lo * expf(mo - mn);
    m = mn;
  };
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge(__shfl_xor_sync(0xffffffffu, m, o),
          __shfl_xor_sync(0xffffffffu, l, o));
  if (lane == 0) {
    red[2 * warp] = m;
    red[2 * warp + 1] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? red[2 * lane] : kNegInf;
    l = lane < kWarps ? red[2 * lane + 1] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1)
      merge(__shfl_xor_sync(0xffffffffu, m, o),
            __shfl_xor_sync(0xffffffffu, l, o));
    if (lane == 0) {
      red[2 * kWarps] = m;
      red[2 * kWarps + 1] = l;
    }
  }
  __syncthreads();
  const float2 r = make_float2(red[2 * kWarps], red[2 * kWarps + 1]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// p[0] + p[stride] + ... + p[(n - 1) * stride], added in index order,
// the loads issued kMaxSplits at a time (L2: written by other blocks)
__device__ __forceinline__ float sum_parts(const float* p, long stride,
                                           int n) {
  float s = 0.f;
  for (int i0 = 0; i0 < n; i0 += kMaxSplits) {
    float v[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      v[j] = i0 + j < n ? __ldcg(p + (i0 + j) * stride) : 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (i0 + j < n) s += v[j];
  }
  return s;
}

// the same for four consecutive columns (p 16-byte aligned)
__device__ __forceinline__ float4 sum_parts4(const float* p, long stride,
                                             int n) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < n; i0 += kMaxSplits) {
    float4 v[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (i0 + j < n)
        v[j] = __ldcg(reinterpret_cast<const float4*>(p + (i0 + j) * stride));
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (i0 + j < n) {
        s.x += v[j].x;
        s.y += v[j].y;
        s.z += v[j].z;
        s.w += v[j].w;
      }
    }
  }
  return s;
}

}  // namespace decode
