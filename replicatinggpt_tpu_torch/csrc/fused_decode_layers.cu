// All L transformer layers of one B=1 decode token in ONE launch.
//
// Replaces replicatinggpt_tpu/ops/decode_pallas.py:_decode_kernel (entry
// fused_decode_layers). Per layer: LN1 -> QKV -> attention of each head
// over the STALE cache rows < pos plus the fresh column -> output
// projection -> residual -> LN2 -> MLP up -> ReLU or tanh-GELU -> MLP
// down -> residual. It emits the final residual row and every layer's
// fresh K/V row; the caller writes those into the cache at pos. Every
// tensor is in one compute dtype T (bf16 or f32; the TPU kernel casts
// the layernorm parameters too), with the TPU kernel's rounding points:
// layernorm statistics in f32, each row product accumulated in f32 with
// the bias added before its single rounding to T, attention as in
// decode_attention.cuh, residual sums rounded to T.
//
// Bound on this card: bytes. A token reads every layer's weights once
// (L * (12 C^2 + 13 C) elements) plus 2 * L * pos * C cache elements and
// does ~2 flops per weight element, far below the ~295 flops/byte ridge.
// At char-GPT (L=6, C=384, bf16) that is ~21 MB, ~6.4 us at 3.35 TB/s.
//
// Design (first version, correct before fast): a persistent cooperative
// kernel (cudaLaunchCooperativeKernel; the grid is the smaller of what
// the widest product can use and what the card can hold resident, and
// a launch that cannot be placed returns its error, with no fallback).
// Five phases per layer, separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()):
//   A. every block recomputes LN1 of the row into shared memory; the QKV
//      product is split over 64-column tiles of the output;
//   B. one block per head attends and copies the fresh K/V row out;
//   C. output projection + residual, over column tiles;
//   D. every block recomputes LN2; MLP up + activation, over tiles;
//   E. MLP down + residual, over tiles.
// Inside a tile block, 8 threads cover 8 consecutive 16-byte column
// vectors of one weight row (128 contiguous bytes) and 32 row groups
// split the input dimension; partial sums meet in shared memory. The
// weights are (in, out) row-major, as the JAX package keeps them.
// Narrow products (projection and MLP down: C / 64 tiles) leave most
// blocks idle; splitting the input dimension over blocks is a later
// change, as is overlapping a phase's loads with the previous barrier.
//
// Plain C interface (ctypes); the launch returns its CUDA error code.

#include <cooperative_groups.h>

#include "decode_attention.cuh"

namespace cg = cooperative_groups;

namespace {

using decode::from_f;
using decode::kThreads;
using decode::kWarps;
using decode::round_to;
using decode::to_f;

constexpr int kTileVecs = 8;                      // 16-byte vectors / tile row
constexpr int kRowGroups = kThreads / kTileVecs;  // split of the input dim
constexpr size_t kMaxSmem = 232448;

template <typename T>
struct FusedArgs {
  const T* x0;                   // C
  const T* ln1s;                 // L x C
  const T* ln1b;
  const T* wqkv;                 // L x C x 3C
  const T* bqkv;                 // L x 3C
  const T* wproj;                // L x C x C
  const T* bproj;                // L x C
  const T* ln2s;
  const T* ln2b;
  const T* wup;                  // L x C x 4C
  const T* bup;                  // L x 4C
  const T* wdown;                // L x 4C x C
  const T* bdown;                // L x C
  const T* kc;                   // L layers of S * C elements
  const T* vc;
  T* xout;                       // C: the residual row across layers
  T* newk;                       // L x C
  T* newv;
  T* qkv;                        // scratch: 3C
  T* attn;                       // C
  T* xmid;                       // C
  T* up;                         // 4C
  long head_stride;              // heads layout: S * D; packed: D
  long row_stride;               // heads layout: D; packed: C
  int L, C, H, D, S, pos, gelu;
  float eps, scale;
};

template <typename T>
__host__ __device__ constexpr int tile_cols() {
  return kTileVecs * (16 / (int)sizeof(T));
}

// Shared-memory floats of one block; keep in step with
// fused_smem_bytes() in ops/decode.py.
template <typename T>
__host__ __device__ inline int smem_floats(int C, int S, int D) {
  return 4 * C + kRowGroups * tile_cols<T>() + kWarps + 1 +
         decode::attend_smem_floats(S, D);
}

// LN of one row into out_s (f32 values already rounded to T).
template <typename T>
__device__ void layer_norm_row(const T* x, const T* s, const T* b, int C,
                               float eps, float* out_s, float* red) {
  float sum = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float v = to_f(x[c]);
    out_s[c] = v;
    sum += v;
  }
  const float mu = decode::block_reduce(sum, red, false) / C;
  float sq = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float d = out_s[c] - mu;
    sq += d * d;
  }
  const float inv = rsqrtf(decode::block_reduce(sq, red, false) / C + eps);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float y = (out_s[c] - mu) * inv;
    out_s[c] = round_to<T>(y * to_f(s[c]) + to_f(b[c]));
  }
  __syncthreads();
}

template <typename T>
__device__ void load_row(const T* src, int n, float* dst) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = to_f(src[i]);
  __syncthreads();
}

// out[col] = epi(col, in_s[0:K] @ W[:, col] + bias[col]) for every column
// of the (K, N) row-major W, over the grid's blocks by column tiles.
template <typename T, typename Epi>
__device__ void row_product(const float* in_s, int K, const T* W,
                            const T* bias, int N, float* tile_red, Epi epi) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TC = tile_cols<T>();
  const int cv = threadIdx.x % kTileVecs, rg = threadIdx.x / kTileVecs;
  const int tiles = (N + TC - 1) / TC;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int col0 = t * TC + cv * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    if (col0 < N) {
      const T* w = W + col0;
#pragma unroll 4
      for (int i = rg; i < K; i += kRowGroups) {
        float wv[VEC];
        decode::load_vec(w + (long)i * N, wv);
        const float h = in_s[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += h * wv[j];
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) tile_red[rg * TC + cv * VEC + j] = acc[j];
    __syncthreads();
    if (threadIdx.x < TC) {
      const int col = t * TC + threadIdx.x;
      if (col < N) {
        float s = 0.f;
        for (int g = 0; g < kRowGroups; ++g) s += tile_red[g * TC + threadIdx.x];
        epi(col, s + to_f(bias[col]));
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const FusedArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int C = a.C, D = a.D;
  float* in_s = smem;                                  // 4C
  float* tile_red = in_s + 4 * C;                      // kRowGroups x TC
  float* red = tile_red + kRowGroups * tile_cols<T>();  // kWarps + 1
  float* att = red + kWarps + 1;
  const long layer_cache = (long)a.S * C;

  for (int l = 0; l < a.L; ++l) {
    const T* x = l == 0 ? a.x0 : a.xout;
    // A. LN1 + QKV
    layer_norm_row<T>(x, a.ln1s + (long)l * C, a.ln1b + (long)l * C, C,
                      a.eps, in_s, red);
    row_product<T>(in_s, C, a.wqkv + (long)l * C * 3 * C,
                   a.bqkv + (long)l * 3 * C, 3 * C, tile_red,
                   [&](int col, float v) { a.qkv[col] = from_f<T>(v); });
    grid.sync();
    // B. attention, one block per head; the fresh K/V rows go out
    for (int h = blockIdx.x; h < a.H; h += gridDim.x) {
      const long kv_off = l * layer_cache + h * a.head_stride;
      decode::attend_head<T>(a.qkv + h * D, a.qkv + C + h * D,
                             a.qkv + 2 * C + h * D, a.kc + kv_off,
                             a.vc + kv_off, a.row_stride, a.pos, D, a.scale,
                             att, a.attn + h * D);
      for (int d = threadIdx.x; d < D; d += kThreads) {
        a.newk[(long)l * C + h * D + d] = a.qkv[C + h * D + d];
        a.newv[(long)l * C + h * D + d] = a.qkv[2 * C + h * D + d];
      }
    }
    grid.sync();
    // C. output projection + residual
    load_row<T>(a.attn, C, in_s);
    row_product<T>(in_s, C, a.wproj + (long)l * C * C, a.bproj + (long)l * C,
                   C, tile_red, [&](int col, float v) {
                     a.xmid[col] = from_f<T>(to_f(x[col]) + round_to<T>(v));
                   });
    grid.sync();
    // D. LN2 + MLP up + activation
    layer_norm_row<T>(a.xmid, a.ln2s + (long)l * C, a.ln2b + (long)l * C, C,
                      a.eps, in_s, red);
    row_product<T>(in_s, C, a.wup + (long)l * C * 4 * C,
                   a.bup + (long)l * 4 * C, 4 * C, tile_red,
                   [&](int col, float v) {
                     const float r = round_to<T>(v);
                     a.up[col] = from_f<T>(a.gelu ? gelu_tanh(r)
                                                  : fmaxf(r, 0.f));
                   });
    grid.sync();
    // E. MLP down + residual
    load_row<T>(a.up, 4 * C, in_s);
    row_product<T>(in_s, 4 * C, a.wdown + (long)l * 4 * C * C,
                   a.bdown + (long)l * C, C, tile_red,
                   [&](int col, float v) {
                     a.xout[col] =
                         from_f<T>(to_f(a.xmid[col]) + round_to<T>(v));
                   });
    grid.sync();
  }
}

template <typename T>
int launch(FusedArgs<T> a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t smem = (size_t)smem_floats<T>(a.C, a.S, a.D) * sizeof(float);
  if (a.D % VEC != 0 || a.D > kThreads || kThreads % a.D != 0 ||
      a.C != a.H * a.D || a.pos < 0 || a.pos >= a.S || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = fused_decode_kernel<T>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int widest = (4 * a.C + tile_cols<T>() - 1) / tile_cols<T>();
  int grid = widest > a.H ? widest : a.H;
  if (grid > per_sm * sms) grid = per_sm * sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* const* p, long head_stride, long row_stride, int L,
        int C, int H, int S, int pos, int gelu, float eps,
        cudaStream_t stream) {
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(const_cast<void*>(p[i])); };
  FusedArgs<T> a;
  a.x0 = in(0);
  a.ln1s = in(1);
  a.ln1b = in(2);
  a.wqkv = in(3);
  a.bqkv = in(4);
  a.wproj = in(5);
  a.bproj = in(6);
  a.ln2s = in(7);
  a.ln2b = in(8);
  a.wup = in(9);
  a.bup = in(10);
  a.wdown = in(11);
  a.bdown = in(12);
  a.kc = in(13);
  a.vc = in(14);
  a.xout = out(15);
  a.newk = out(16);
  a.newv = out(17);
  T* scratch = out(18);          // 9C: qkv | attn | xmid | up
  a.qkv = scratch;
  a.attn = scratch + 3 * C;
  a.xmid = scratch + 4 * C;
  a.up = scratch + 5 * C;
  a.head_stride = head_stride;
  a.row_stride = row_stride;
  a.L = L;
  a.C = C;
  a.H = H;
  a.D = C / H;
  a.S = S;
  a.pos = pos;
  a.gelu = gelu;
  a.eps = eps;
  a.scale = 1.0f / sqrtf((float)a.D);
  return launch<T>(a, stream);
}

}  // namespace

// ptrs: the 19 device pointers x0, ln1_scale, ln1_bias, qkv_kernel,
// qkv_bias, attn_out_kernel, attn_out_bias, ln2_scale, ln2_bias,
// mlp_up_kernel, mlp_up_bias, mlp_down_kernel, mlp_down_bias, k_cache,
// v_cache, xout, newk, newv, scratch (9C elements), all contiguous in
// one dtype (0 = float32, 1 = bfloat16). packed: 1 for the (L, 1, S, C)
// cache layout, 0 for (L, 1, H, S, D). gelu: 1 for tanh-GELU, 0 ReLU.
extern "C" int fused_decode_layers_launch(const void* const* ptrs, int L,
                                          int C, int H, int S, int pos,
                                          int packed, int gelu, float eps,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  const int D = C / H;
  const long head_stride = packed ? D : (long)S * D;
  const long row_stride = packed ? C : D;
  if (dtype == 0)
    return run<float>(ptrs, head_stride, row_stride, L, C, H, S, pos, gelu,
                      eps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(ptrs, head_stride, row_stride, L, C, H, S, pos,
                              gelu, eps, s);
  return (int)cudaErrorInvalidValue;
}

