// Decode attention over a packed (B, S, C) KV cache at one shared pos.
//
// Replaces replicatinggpt_tpu/ops/decode_pallas.py:_packed_attn_kernel
// (entry packed_decode_attention). For every batch row b and head h the
// fresh query row q[b, h*D:(h+1)*D] attends the STALE cache rows at
// positions < pos (head h is the D-wide column strip h*D of each packed
// row, as in flash_packed.cu) and then the fresh column (k_new, v_new);
// the caller writes k_new/v_new at pos afterwards (attend-stale-then-
// write == write-then-attend). Scores and softmax in f32, probabilities
// rounded to the cache dtype before the value product (decode::
// attend_head in decode_attention.cuh, shared with the fused kernel).
//
// Bound on this card: bytes. One call reads 2 * B * pos * C * itemsize
// bytes of K and V and does 4 flops per element read, far below the
// H100's ~295 flops/byte ridge.
//
// Design (first version, correct before fast): one block per (row,
// head), the W=1 case of paged_window_attention.cu over a contiguous
// cache; scores for all rows < pos are kept in shared memory (the two
// passes the TPU kernel's numerics need: the denominator before the
// rounded weights), 8 threads per row with 16-byte loads. B * H blocks
// (96 at GPT-2 124M, B=8) under-fill the 132 SMs, and nothing overlaps
// the loads with the math yet.
//
// Plain C interface (ctypes); the launch returns cudaGetLastError().

#include "decode_attention.cuh"

namespace {

using decode::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
packed_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                     const T* __restrict__ v_new,
                     const T* __restrict__ k_cache,
                     const T* __restrict__ v_cache, T* __restrict__ out,
                     long ld, int S, int C, int D, int pos, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const long row = (long)b * ld + (long)h * D;
  const long cache = (long)b * S * C + (long)h * D;
  decode::attend_head<T>(q + row, k_new + row, v_new + row, k_cache + cache,
                         v_cache + cache, C, pos, D, scale, smem,
                         out + (long)b * C + (long)h * D);
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_cache, const void* v_cache, void* out, int B,
           long ld, int S, int H, int D, int pos, cudaStream_t stream) {
  const size_t smem =
      (size_t)decode::attend_smem_floats(S, D) * sizeof(float);
  if (D % (16 / sizeof(T)) != 0 || D > kThreads || kThreads % D != 0 ||
      pos < 0 || pos >= S || H > 65535 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  auto kernel = packed_decode_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<T*>(out), ld, S, H * D, D,
      pos, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k_new/v_new rows are ld elements
// apart (the (B, 3C) fused projection's slices share one ld); caches
// and out are contiguous.
extern "C" int packed_decode_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, void* out, int B, long ld, int S, int H, int D,
    int pos, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_new, v_new, k_cache, v_cache, out, B, ld, S, H,
                         D, pos, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, out, B,
                                 ld, S, H, D, pos, s);
  return (int)cudaErrorInvalidValue;
}
