// Element loads, KV quantization helpers and asynchronous copies (cp.async;
// TMA bulk copies on mbarriers) shared by the decode kernels (paged_window_attention.cu,
// fused_paged_decode_layers.cu, fused_decode_layers.cu).
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

// Asynchronous global -> shared copies (cp.async, sm_80 and later), used
// by the decode kernels to keep loads in flight across their barriers. A thread's copies complete in the
// order of its commit groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the same for a count known only at run time; a count past 15 waits
// for more groups than it must, which is safe
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    default: cp_async_wait<15>(); break;
  }
}

// Bulk copies (the TMA's cp.async.bulk, sm_90) that complete on an
// mbarrier in shared memory: one thread arms a phase with the bytes it
// expects (arrive + expect_tx, the phase's one arrival), any threads
// issue copies of 16-byte multiples, and the phase completes when every
// byte has landed; waiters poll the phase's parity. The tx-count may run
// below zero before the arming arrival, so the copies may precede it.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(n)
               : "memory");
}

// the inits visible to the async proxy (call before the block's barrier)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arm(unsigned long long* bar,
                                         unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// shared memory that generic-proxy threads read before the async proxy
// writes it again
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace kvq
