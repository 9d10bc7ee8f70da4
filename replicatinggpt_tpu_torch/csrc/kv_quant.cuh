// Element loads and KV quantization helpers shared by the paged kernels
// (paged_window_attention.cu, fused_paged_decode_layers.cu).
//
// A paged pool holds K/V rows in the compute dtype (float or bf16) or,
// quantized, in int8 or fp8 e4m3 with f32 scales beside them
// (replicatinggpt_tpu_torch/quant/kv.py). The kernels read every pool
// element as a float and multiply a quantized one by its row's scale in
// f32, as replicatinggpt_tpu/ops/paged_pallas.py and decode_pallas.py
// dequantize inside their loops.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kvq {

// elements of P in one 16-byte vector
template <typename P>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(P);
}

// 16 bytes of P at src (16-byte aligned) as floats
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const int8_t* src, float* dst) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = (float)b[i];
}

__device__ __forceinline__ float fp8_to_float(__nv_fp8_storage_t v) {
  // every e4m3 value is exact in f16, and every f16 in f32
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v, __NV_E4M3)));
}

__device__ __forceinline__ void load_vec(const __nv_fp8_e4m3* src,
                                         float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_fp8_storage_t* b =
      reinterpret_cast<const __nv_fp8_storage_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = fp8_to_float(b[i]);
}

// x / s quantized and dequantized, as quant/kv.py's span math: int8
// rounds half to even (rintf) and clips to +-127; fp8 clips to +-448
// and casts once from f32 to e4m3 (round to nearest even, saturating).
// True IEEE division: the kernels are built without fast math.
__device__ __forceinline__ float fake_quant(float x, float s, bool fp8) {
  if (fp8) {
    const float q = fminf(fmaxf(x / s, -448.f), 448.f);
    return fp8_to_float(__nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3))
           * s;
  }
  return fminf(fmaxf(rintf(x / s), -127.f), 127.f) * s;
}

// the scale of a span whose largest magnitude is amax (quant/kv.py:
// max(amax / qmax, SCALE_EPS))
__device__ __forceinline__ float span_scale(float amax, bool fp8) {
  return fmaxf(amax / (fp8 ? 448.f : 127.f), 1e-8f);
}

}  // namespace kvq
