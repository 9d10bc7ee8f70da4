// Block-level building blocks of the two decode kernels
// (packed_decode_attention.cu, fused_decode_layers.cu): element
// conversion, warp and block reductions, and the decode attention of
// ONE head over a stale cache plus the fresh column.
//
// Every function here is called by all kThreads threads of a block with
// block-uniform arguments (they contain __syncthreads).

#pragma once

#include "kv_quant.cuh"

namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;   // threads per score dot product
constexpr int kRowsPerPass = kThreads / kGroup;
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

// 16 bytes of T at src (16-byte aligned) as floats
using kvq::load_vec;

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

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum (is_max false) or max over the block; every thread gets the
// result. red: kWarps + 1 floats of shared memory.
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
  __syncthreads();   // red may be reused right after
  return out;
}

// Shared-memory floats attend_head needs at cache length S, head dim D.
__host__ __device__ inline int attend_smem_floats(int S, int D) {
  return D + S + kThreads + kWarps + 1;
}

// Decode attention of one head, mirroring _packed_attn_kernel and the
// attention of _decode_kernel (replicatinggpt_tpu/ops/decode_pallas.py):
// the query attends cache rows r < pos (row r of the head at kc + r *
// row_stride, D contiguous elements) and then the fresh column
// (k_new, v_new). Scores and softmax in f32; the probabilities are
// rounded to T before the value product, and the fresh value's weight
// p_new / denom likewise. Rows >= pos are never read. q, k_new, v_new
// and out hold D elements; D is a multiple of 16 / sizeof(T) that
// divides kThreads. smem: attend_smem_floats(S, D) floats.
template <typename T>
__device__ void attend_head(const T* q, const T* k_new, const T* v_new,
                            const T* kc, const T* vc, long row_stride,
                            int pos, int D, float scale, float* smem,
                            T* out) {
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* q_s = smem;              // D
  float* p_s = q_s + D;           // pos (<= S): scores, then weights
  float* part = p_s + (pos > 0 ? pos : 0);   // kThreads partial sums
  float* red = part + kThreads;   // kWarps + 1

  for (int d = tid; d < D; d += kThreads) q_s[d] = to_f(q[d]);
  __syncthreads();

  // scores of the stale rows, kGroup threads per row
  const int gl = tid & (kGroup - 1);
  for (int base = 0; base < pos; base += kRowsPerPass) {
    const int r = base + tid / kGroup;
    float s = 0.f;
    if (r < pos) {
      const T* krow = kc + (long)r * row_stride;
      for (int d0 = gl * VEC; d0 < D; d0 += kGroup * VEC) {
        float kv[VEC];
        load_vec(krow + d0, kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += q_s[d0 + i] * kv[i];
      }
    }
    s = group_sum(s);
    if (r < pos && gl == 0) p_s[r] = s * scale;
  }
  // the fresh column's score, by warp 0
  float s_new = 0.f;
  if (warp == 0) {
    for (int d = lane; d < D; d += 32) s_new += q_s[d] * to_f(k_new[d]);
    s_new = warp_sum(s_new) * scale;
    if (lane == 0) red[0] = s_new;
  }
  __syncthreads();
  s_new = red[0];
  __syncthreads();

  float mx = kNegInf;
  for (int r = tid; r < pos; r += kThreads) mx = fmaxf(mx, p_s[r]);
  const float m = fmaxf(block_reduce(mx, red, true), s_new);
  float sum = 0.f;
  for (int r = tid; r < pos; r += kThreads) {
    const float e = expf(p_s[r] - m);
    p_s[r] = e;
    sum += e;
  }
  const float p_new = expf(s_new - m);
  const float denom = block_reduce(sum, red, false) + p_new;
  for (int r = tid; r < pos; r += kThreads)
    p_s[r] = round_to<T>(p_s[r] / denom);
  __syncthreads();

  // weighted values: kThreads / D row groups, thread (g, d)
  const int G = kThreads / D;
  const int d = tid % D, g = tid / D;
  float acc = 0.f;
  for (int r = g; r < pos; r += G) acc += p_s[r] * to_f(vc[(long)r * row_stride + d]);
  part[g * D + d] = acc;
  __syncthreads();
  if (tid < D) {
    float pv = 0.f;
    for (int j = 0; j < G; ++j) pv += part[j * D + tid];
    const float w_new = round_to<T>(p_new / denom);
    out[tid] = from_f<T>(pv + w_new * to_f(v_new[tid]));
  }
  __syncthreads();
}

}  // namespace decode
