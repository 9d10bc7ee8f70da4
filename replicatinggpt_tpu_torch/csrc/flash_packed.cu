// Packed causal flash attention, forward and backward, on the fused
// (B, T, 3C) QKV projection output.
//
// Replaces replicatinggpt_tpu/ops/flash_pallas.py:_fwd_kernel_packed
// (forward, via _packed_fwd) and :_bwd_kernel_packed (backward, via
// _packed_bwd), and the head-group families that compute the same
// function on (T, 128)-column strips: _group_fwd / _group_bwd, their
// streamed (_group_fwd_stream / _group_bwd_stream) and triangular
// (_group_fwd_tri / _group_bwd_tri) variants. Head h reads q, k and v
// as the column strips [h*D, (h+1)*D), C + ... and 2C + ... of each
// packed row (row stride 3C elements), so no head transpose happens on
// either pass. The forward writes the merged (B, T, C) output and the
// f32 log-sum-exp (B, T, H); the backward takes dO (B, T, C), lse and
// delta = rowsum(dO * O) per head (B, T, H, f32, from the caller) and
// writes the packed d(qkv) (B, T, 3C). Scores, softmax statistics and
// every accumulator are f32; loads of bf16 inputs convert to f32 in
// shared memory.
//
// Attention dropout is the JAX kernels' counter hash (_dropout_mult):
// h = fmix32(seed ^ bh * 0x9E3779B9), y = fmix32(fmix32(h ^ qpos) ^
// kpos) at absolute positions, kept iff y > threshold, kept weights
// scaled by `keep`. The forward's normalizer l sees no dropout; only the
// V accumulation does. The backward regenerates the same mask.
//
// Bound on this card: at the char-GPT shapes (B=64, T=256, C=384, H=6,
// bf16) the forward moves ~51 MB (15 us at 3.35 TB/s) against 3.2 GFLOP
// (3.3 us at 989 TFLOP/s), the backward ~89 MB (27 us) against 8.1 GFLOP
// (8 us): bytes bound both. These kernels are far from either: they
// multiply in f32 on the CUDA cores (no tensor cores), so operations
// bound them in practice. wgmma/TMA tiles are later work.
//
// Design (first version, correct before fast): 64-row tiles, 256
// threads, each thread owning a 4 x 4 (score tile) or 4 x D/16 (output
// tile) micro-tile at rows ty + 16i, columns tx + 16j, so shared-memory
// reads are conflict-free with a row stride of D + 1 floats.
// - forward: one block per (q tile, head, batch); K/V tiles walked up to
//   the diagonal, masked inside it; online softmax with m, l and the
//   accumulator in f32.
// - backward: two kernels, no atomics, so the result is deterministic.
//   dkv_kernel: one block per (kv tile, head, batch), q tiles from the
//   diagonal down, dK and dV accumulated in registers. dq_kernel: one
//   block per (q tile, head, batch), kv tiles up to the diagonal. Both
//   recompute p = exp(s - lse) and dP; the pair is the port of the one
//   fused TPU backward.
//
// Plain C interface (ctypes); each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // rows of a q or kv tile
constexpr int kSS = kTile + 1;  // row stride (floats) of a score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  int on;
  uint32_t seed;
  uint32_t threshold;  // int(q * 256) * 2^24 for the quantized rate q
  float keep;          // (float)(1 / (1 - q))

  __device__ __forceinline__ uint32_t head(int bh) const {
    return fmix32(seed ^ ((uint32_t)bh * 0x9E3779B9u));
  }
  __device__ __forceinline__ uint32_t row(uint32_t hh, int qpos) const {
    return fmix32(hh ^ (uint32_t)qpos);
  }
  __device__ __forceinline__ float mult(uint32_t rr, int kpos) const {
    return fmix32(rr ^ (uint32_t)kpos) > threshold ? keep : 0.f;
  }
};

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

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kTile rows of D elements, row r at src + r * stride, into dst (f32,
// row stride D + 1), 16 bytes per thread per load.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* src, size_t stride,
                                          float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int e = threadIdx.x; e < kTile * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * VEC;
    float f[VEC];
    load_vec(src + r * stride + c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * (D + 1) + c + i] = f[i];
  }
}

// s[i][j] += A[ty + 16i] . B[tx + 16j] over D (A, B: tiles of row
// stride D + 1).
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bt,
                                         float s[4][4], int tx, int ty) {
  constexpr int SD = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * SD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bt[(tx + 16 * j) * SD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
  }
}

// Scores s = Q K^T (rows of q_s) and dP = dO V^T for one tile pair, then
// p_s = p * z and ds_s = p (z dP - delta) scale, with p = exp(s scale -
// lse) and columns past the diagonal zeroed when `diag`.
template <int D>
__device__ __forceinline__ void bwd_scores(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dl_s, float* p_s, float* ds_s, int q0,
    int k0, bool diag, float scale, const Dropout& dp, uint32_t hh, int tx,
    int ty) {
  float s[4][4] = {}, g[4][4] = {};
  dot_tile<D>(q_s, k_s, s, tx, ty);
  dot_tile<D>(do_s, v_s, g, tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const uint32_t rr = dp.on ? dp.row(hh, q0 + r) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p =
          (diag && c > r) ? 0.f : expf(s[i][j] * scale - lse_s[r]);
      const float z = dp.on ? dp.mult(rr, k0 + c) : 1.f;
      p_s[r * kSS + c] = p * z;
      ds_s[r * kSS + c] = p * (g[i][j] * z - dl_s[r]) * scale;
    }
  }
}

template <int D>
constexpr size_t fwd_smem_floats() {
  return 3 * (size_t)kTile * (D + 1) + (size_t)kTile * kSS + 3 * kTile;
}
template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)kTile * (D + 1) + 2 * (size_t)kTile * kSS + 2 * kTile;
}
template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)kTile * (D + 1) + (size_t)kTile * kSS + 2 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
           float* __restrict__ lse, int Tlen, int H, float scale,
           Dropout dp) {
  constexpr int SD = D + 1;
  constexpr int NJ = D / 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t rs = 3 * (size_t)C;
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;               // kTile x SD
  float* k_s = q_s + kTile * SD;   // kTile x SD
  float* v_s = k_s + kTile * SD;   // kTile x SD
  float* s_s = v_s + kTile * SD;   // kTile x kSS: scores, then p
  float* m_s = s_s + kTile * kSS;  // running max
  float* l_s = m_s + kTile;        // running normalizer (no dropout)
  float* a_s = l_s + kTile;        // this tile's rescale factor

  const T* base = qkv + (size_t)b * Tlen * rs + (size_t)h * D;
  load_tile<T, D>(base + (size_t)q0 * rs, rs, q_s);
  for (int r = tid; r < kTile; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const uint32_t hh = dp.head(b * H + h);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers of k_s, v_s, s_s are done
    load_tile<T, D>(base + (size_t)k0 * rs + C, rs, k_s);
    load_tile<T, D>(base + (size_t)k0 * rs + 2 * C, rs, v_s);
    __syncthreads();
    float s[4][4] = {};
    dot_tile<D>(q_s, k_s, s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        s_s[r * kSS + c] = (kt == qt && c > r) ? kNegInf : s[i][j] * scale;
      }
    __syncthreads();
    // online softmax: one warp per row, two columns per lane
    for (int r = warp; r < kTile; r += kWarps) {
      float* sr = s_s + r * kSS;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      if (dp.on) {
        const uint32_t rr = dp.row(hh, q0 + r);
        p0 *= dp.mult(rr, k0 + lane);
        p1 *= dp.mult(rr, k0 + lane + 32);
      }
      sr[lane] = p0;
      sr[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kTile; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * kSS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float v = v_s[c * SD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * v;
      }
    }
  }
  // the diagonal tile leaves every row a positive normalizer
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = l_s[r];
    T* dst = out + ((size_t)b * Tlen + q0 + r) * C + (size_t)h * D + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(dst + 16 * j, acc[i][j] / l);
  }
  for (int r = tid; r < kTile; r += kThreads)
    lse[((size_t)b * Tlen + q0 + r) * H + h] = m_s[r] + logf(l_s[r]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dqkv, int Tlen, int H, float scale, Dropout dp) {
  constexpr int SD = D + 1;
  constexpr int NJ = D / 16;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t rs = 3 * (size_t)C;
  const int k0 = kt * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  extern __shared__ float smem[];
  float* k_s = smem;                // kTile x SD
  float* v_s = k_s + kTile * SD;    // kTile x SD
  float* q_s = v_s + kTile * SD;    // kTile x SD
  float* do_s = q_s + kTile * SD;   // kTile x SD
  float* p_s = do_s + kTile * SD;   // kTile x kSS: p * z
  float* ds_s = p_s + kTile * kSS;  // kTile x kSS: ds
  float* lse_s = ds_s + kTile * kSS;
  float* dl_s = lse_s + kTile;

  const T* base = qkv + (size_t)b * Tlen * rs + (size_t)h * D;
  load_tile<T, D>(base + (size_t)k0 * rs + C, rs, k_s);
  load_tile<T, D>(base + (size_t)k0 * rs + 2 * C, rs, v_s);
  const uint32_t hh = dp.head(b * H + h);
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_q = Tlen / kTile;
  for (int qt = kt; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(base + (size_t)q0 * rs, rs, q_s);
    load_tile<T, D>(dout + ((size_t)b * Tlen + q0) * C + (size_t)h * D, C,
                    do_s);
    for (int r = tid; r < kTile; r += kThreads) {
      const size_t at = ((size_t)b * Tlen + q0 + r) * H + h;
      lse_s[r] = lse[at];
      dl_s[r] = delta[at];
    }
    __syncthreads();
    bwd_scores<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, q0, k0,
                  qt == kt, scale, dp, hh, tx, ty);
    __syncthreads();
    // dV += (p z)^T dO, dK += ds^T Q: rows of the kv tile
    for (int q = 0; q < kTile; ++q) {
      float pk[4], sk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = p_s[q * kSS + ty + 16 * i];
        sk[i] = ds_s[q * kSS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float g = do_s[q * SD + tx + 16 * j];
        const float x = q_s[q * SD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] += pk[i] * g;
          dk[i][j] += sk[i] * x;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    T* dst = dqkv + ((size_t)b * Tlen + k0 + r) * rs + (size_t)h * D + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store(dst + C + 16 * j, dk[i][j]);
      store(dst + 2 * C + 16 * j, dv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dqkv, int Tlen, int H, float scale, Dropout dp) {
  constexpr int SD = D + 1;
  constexpr int NJ = D / 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const size_t rs = 3 * (size_t)C;
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  extern __shared__ float smem[];
  float* q_s = smem;                // kTile x SD
  float* do_s = q_s + kTile * SD;   // kTile x SD
  float* k_s = do_s + kTile * SD;   // kTile x SD
  float* v_s = k_s + kTile * SD;    // kTile x SD
  float* ds_s = v_s + kTile * SD;   // kTile x kSS
  float* lse_s = ds_s + kTile * kSS;
  float* dl_s = lse_s + kTile;

  const T* base = qkv + (size_t)b * Tlen * rs + (size_t)h * D;
  load_tile<T, D>(base + (size_t)q0 * rs, rs, q_s);
  load_tile<T, D>(dout + ((size_t)b * Tlen + q0) * C + (size_t)h * D, C,
                  do_s);
  for (int r = tid; r < kTile; r += kThreads) {
    const size_t at = ((size_t)b * Tlen + q0 + r) * H + h;
    lse_s[r] = lse[at];
    dl_s[r] = delta[at];
  }
  const uint32_t hh = dp.head(b * H + h);
  float dq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers of k_s, ds_s are done
    load_tile<T, D>(base + (size_t)k0 * rs + C, rs, k_s);
    load_tile<T, D>(base + (size_t)k0 * rs + 2 * C, rs, v_s);
    __syncthreads();
    // p * z is not needed here: ds_s doubles as the p_s scratch, and is
    // then overwritten by ds in the same call
    bwd_scores<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, ds_s, ds_s, q0, k0,
                  kt == qt, scale, dp, hh, tx, ty);
    __syncthreads();
    // dQ += ds K
    for (int c = 0; c < kTile; ++c) {
      float sq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sq[i] = ds_s[(ty + 16 * i) * kSS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = k_s[c * SD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] += sq[i] * x;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    T* dst = dqkv + ((size_t)b * Tlen + q0 + r) * rs + (size_t)h * D + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(dst + 16 * j, dq[i][j]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int fwd_launch(const void* qkv, void* out, float* lse, int B, int Tlen,
               int H, float scale, Dropout dp, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  auto kernel = fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Tlen / kTile, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, Tlen, H, scale,
      dp);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_launch(const void* qkv, const void* dout, const float* lse,
               const float* delta, void* dqkv, int B, int Tlen, int H,
               float scale, Dropout dp, cudaStream_t stream) {
  const dim3 grid(Tlen / kTile, H, B);
  const size_t smem_kv = dkv_smem_floats<D>() * sizeof(float);
  auto kv = dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kv, smem_kv);
  if (err != cudaSuccess) return (int)err;
  kv<<<grid, kThreads, smem_kv, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqkv), Tlen, H, scale, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_q = dq_smem_floats<D>() * sizeof(float);
  auto q = dq_kernel<T, D>;
  err = allow_smem(q, smem_q);
  if (err != cudaSuccess) return (int)err;
  q<<<grid, kThreads, smem_q, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqkv), Tlen, H, scale, dp);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int Tlen, int H) {
  return B > 0 && Tlen > 0 && Tlen % kTile == 0 && H > 0 && H <= 65535 &&
         B <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128}; T a multiple of
// 64. `dropout` 0 turns the mask off (seed, threshold, keep unused).
extern "C" int flash_packed_fwd_launch(const void* qkv, void* out,
                                       void* lse, int B, int Tlen, int H,
                                       int D, float scale, unsigned seed,
                                       unsigned threshold, float keep,
                                       int dropout, int dtype,
                                       void* stream) {
  if (!shape_ok(B, Tlen, H)) return (int)cudaErrorInvalidValue;
  const Dropout dp{dropout, seed, threshold, keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FWD(T, DD) \
  return fwd_launch<T, DD>(qkv, out, l, B, Tlen, H, scale, dp, s)
  if (dtype == 0) {
    if (D == 32) FWD(float, 32);
    if (D == 64) FWD(float, 64);
    if (D == 128) FWD(float, 128);
  } else if (dtype == 1) {
    if (D == 32) FWD(__nv_bfloat16, 32);
    if (D == 64) FWD(__nv_bfloat16, 64);
    if (D == 128) FWD(__nv_bfloat16, 128);
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_packed_bwd_launch(const void* qkv, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dqkv, int B, int Tlen, int H,
                                       int D, float scale, unsigned seed,
                                       unsigned threshold, float keep,
                                       int dropout, int dtype,
                                       void* stream) {
  if (!shape_ok(B, Tlen, H)) return (int)cudaErrorInvalidValue;
  const Dropout dp{dropout, seed, threshold, keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define BWD(T, DD) \
  return bwd_launch<T, DD>(qkv, dout, l, dl, dqkv, B, Tlen, H, scale, dp, s)
  if (dtype == 0) {
    if (D == 32) BWD(float, 32);
    if (D == 64) BWD(float, 64);
    if (D == 128) BWD(float, 128);
  } else if (dtype == 1) {
    if (D == 32) BWD(__nv_bfloat16, 32);
    if (D == 64) BWD(__nv_bfloat16, 64);
    if (D == 128) BWD(__nv_bfloat16, 128);
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}
