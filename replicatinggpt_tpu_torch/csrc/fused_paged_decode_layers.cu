// All L transformer layers of one multi-slot PAGED decode step in ONE
// launch.
//
// Replaces replicatinggpt_tpu/ops/decode_pallas.py:_paged_fused_kernel
// (entry fused_paged_decode_layers). For each of B slots, per layer:
// LN1 -> QKV -> attention of each head over the slot's STALE pool rows
// at positions < pos[b], read through its page table, plus the fresh
// column -> output projection -> residual -> LN2 -> MLP up -> ReLU or
// tanh-GELU -> MLP down -> residual. It emits the final residual rows
// and every layer's raw fresh K/V rows; the caller writes those into
// the pool (quantizing them for a quantized pool). An inactive slot runs
// at pos 0: it attends only its fresh column and the caller drops its
// rows.
//
// Rounding, as the TPU kernel: every block tensor in the compute dtype T
// (bf16 or f32; the layernorm parameters cast too), layernorm
// statistics in f32, each row product accumulated in f32 with the bias
// added before its one rounding to T, q / k_new / v_new rounded to T.
// Unlike the B=1 kernel (decode_attention.cuh, which rounds the
// probabilities to T as _packed_attn_kernel does) the attention keeps
// the probabilities and the accumulator in f32, with an online softmax
// over the pages and the fresh column folded in f32 at the end. A
// quantized pool (int8 or fp8 e4m3 pages with f32 scales per row, or
// per row and head) is dequantized as f32(q) * scale inside the loop,
// and the fresh K/V column is fake-quantized in f32 (quant/kv.py's
// span math) and rounded to T before it attends, so that it scores
// exactly what the caller's write will store.
//
// Bound on this card: bytes. A step reads every layer's weights once
// for all B slots (L * (12 C^2 + 13 C) elements) plus each slot's live
// K/V rows (2 * L * sum(pos) * C pool elements, and their scales) and
// does ~2 * B flops per weight element, far below the ~295 flops/byte
// ridge. At char-GPT (L=6, C=384, bf16, B=8, sum(pos) = 1024): ~21 MB of
// weights and ~9 MB of pages, ~9 us at 3.35 TB/s.
//
// Design (first version, correct before fast): a persistent cooperative
// kernel (cudaLaunchCooperativeKernel; the grid is the smaller of what
// the widest phase can use and what the card holds resident; a launch
// that cannot be placed returns its error, with no fallback), five
// phases per layer separated by grid-wide barriers:
//   A. every block recomputes LN1 of the B rows into shared memory; the
//      QKV product is split over column tiles;
//   B. one block per (slot, head) walks the slot's live pages in tiles
//      of kTile rows (paged_window_attention.cu's addressing) and copies
//      the raw fresh K/V rows out;
//   C. output projection + residual, over column tiles;
//   D. every block recomputes LN2; MLP up + activation, over tiles;
//   E. MLP down + residual, over tiles.
// A tile block keeps kRB = 8 partial sums per output column, one per
// slot, so a layer's weights are read once for up to 8 slots (a larger
// B reads them once per group of 8): 8 threads cover 8 consecutive
// 16-byte column vectors of one weight row and 32 row groups split the
// input dimension; the row groups meet through warp shuffles and shared
// memory. Narrow products (C / 64 tiles) leave most blocks idle, and B *
// H attention blocks under-fill the card; both are later changes.
//
// Plain C interface (ctypes); the launch returns its CUDA error code.

#include <cooperative_groups.h>

#include <type_traits>

#include "decode_attention.cuh"
#include "kv_quant.cuh"

namespace cg = cooperative_groups;

namespace {

using decode::from_f;
using decode::group_sum;
using decode::kGroup;
using decode::kThreads;
using decode::kWarps;
using decode::round_to;
using decode::to_f;
using kvq::load_vec;

constexpr int kTileVecs = 8;                      // 16-byte vectors / tile row
constexpr int kRowGroups = kThreads / kTileVecs;  // split of the input dim
constexpr int kRB = 8;                            // slots per weight pass
constexpr int kTile = 64;                         // history rows per tile
constexpr int kPad = 8;                           // K row padding (floats)
constexpr size_t kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Args {
  const T* x0;                   // B x C
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
  const void* kp;                // L x N x psz x C pool elements
  const void* vp;
  const float* ks;               // L x N x psz (x H) scales, or null
  const float* vs;
  const int* tables;             // B x mp
  const int* pos;                // B
  T* xout;                       // B x C: the residual rows across layers
  T* newk;                       // L x B x C
  T* newv;
  T* qkv;                        // scratch: B x 3C
  T* attn;                       // B x C
  T* xmid;                       // B x C
  T* up;                         // B x 4C
  int L, B, C, H, D, N, psz, mp, gelu, head_gran;
  float eps, scale;
};

template <typename T>
__host__ __device__ constexpr int tile_cols() {
  return kTileVecs * (16 / (int)sizeof(T));
}

// Shared-memory floats of one block; keep in step with
// fused_paged_smem_bytes() in ops/decode.py. The row products' region
// (kRB input rows of up to 4C, the row groups' partial sums) and the
// attention's region share one union after the reduction scratch.
template <typename T>
__host__ __device__ inline int smem_floats(int C, int D, int mp) {
  const int rows = kRB * 4 * C + kWarps * kRB * tile_cols<T>();
  const int att = 3 * D + kTile * (D + kPad) + kTile * D + kTile + kThreads +
                  4 + mp;
  return kWarps + 1 + (rows > att ? rows : att);
}

// LN of rows b0 .. b0+nb-1 of x (B x C) into out_s (kRB x C, f32 values
// already rounded to T), one warp per row; rows >= nb are zeroed.
template <typename T>
__device__ void layer_norm_rows(const T* x, int b0, int nb, const T* s,
                                const T* b, int C, float eps, float* out_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kRB; r += kWarps) {
    float* o = out_s + r * C;
    if (r >= nb) {
      for (int c = lane; c < C; c += 32) o[c] = 0.f;
      continue;
    }
    const T* xr = x + (size_t)(b0 + r) * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f(xr[c]);
      o[c] = v;
      sum += v;
    }
    const float mu = decode::warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = o[c] - mu;
      sq += d * d;
    }
    const float inv = rsqrtf(decode::warp_sum(sq) / C + eps);
    for (int c = lane; c < C; c += 32)
      o[c] = round_to<T>((o[c] - mu) * inv * to_f(s[c]) + to_f(b[c]));
  }
  __syncthreads();
}

// rows b0 .. b0+nb-1 of src (B x K) into out_s (kRB x K); rows >= nb zero
template <typename T>
__device__ void load_rows(const T* src, int b0, int nb, int K,
                          float* out_s) {
  for (int e = threadIdx.x; e < kRB * K; e += kThreads) {
    const int r = e / K;
    out_s[e] = r < nb ? to_f(src[(size_t)(b0 + r) * K + e % K]) : 0.f;
  }
  __syncthreads();
}

// epi(r, col, in_s[r, 0:K] @ W[:, col] + bias[col]) for r < nb and every
// column of the (K, N) row-major W, over the grid's blocks by column
// tiles. Each weight element is read once for the kRB rows.
template <typename T, typename Epi>
__device__ void rows_product(const float* in_s, int K, const T* W,
                             const T* bias, int N, int nb, float* tile_red,
                             Epi epi) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TC = tile_cols<T>();
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cv = tid % kTileVecs, rg = tid / kTileVecs;
  const int tiles = (N + TC - 1) / TC;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int col0 = t * TC + cv * VEC;
    float acc[kRB][VEC];
#pragma unroll
    for (int r = 0; r < kRB; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;
    if (col0 < N) {
      const T* w = W + col0;
#pragma unroll 2
      for (int i = rg; i < K; i += kRowGroups) {
        float wv[VEC];
        load_vec(w + (size_t)i * N, wv);
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          const float h = in_s[r * K + i];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[r][j] += h * wv[j];
        }
      }
    }
    // the warp's 4 row groups (lane bits 3 and 4) meet by shuffles; its
    // lanes 0..7 then hold the warp's sums for column vector cv = lane
#pragma unroll
    for (int r = 0; r < kRB; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float v = acc[r][j];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[r][j] = v;
      }
    if (lane < kTileVecs)
#pragma unroll
      for (int r = 0; r < kRB; ++r)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          tile_red[(warp * kRB + r) * TC + cv * VEC + j] = acc[r][j];
    __syncthreads();
    for (int e = tid; e < nb * TC; e += kThreads) {
      const int r = e / TC, c = e % TC, col = t * TC + c;
      if (col < N) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += tile_red[(w * kRB + r) * TC + c];
        epi(r, col, s + to_f(bias[col]));
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// The fresh column of one head in place (D floats of T values): fake-
// quantized with the scale of its span (the whole row at page
// granularity, the head's D lanes at head granularity) and rounded to T.
// `row` is the full fresh row (C elements of T); every thread calls.
template <typename T, bool kFp8>
__device__ void fake_quant_head(const T* row, float* col_s, int C, int D,
                                int h, int head_gran, float* red) {
  float amax = 0.f;
  if (head_gran) {
    for (int d = threadIdx.x; d < D; d += kThreads)
      amax = fmaxf(amax, fabsf(to_f(row[h * D + d])));
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads)
      amax = fmaxf(amax, fabsf(to_f(row[c])));
  }
  const float s = kvq::span_scale(decode::block_reduce(amax, red, true),
                                  kFp8);
  for (int d = threadIdx.x; d < D; d += kThreads)
    col_s[d] = round_to<T>(kvq::fake_quant(col_s[d], s, kFp8));
  __syncthreads();
}

// Decode attention of slot b, head h, at layer l: the stale pool rows <
// pos[b] through the slot's table, then the fresh column. Writes the
// head's D outputs into a.attn and the raw fresh rows into newk/newv.
template <typename T, typename P>
__device__ void attend_paged(const Args<T>& a, int l, int b, int h,
                             float* red, float* sm) {
  constexpr bool kQuant = !std::is_same<P, T>::value;
  constexpr bool kFp8 = std::is_same<P, __nv_fp8_e4m3>::value;
  constexpr int PVEC = kvq::vec_elems<P>();
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int C = a.C, D = a.D, H = a.H, psz = a.psz;
  const int ks = D + kPad;
  float* q_s = sm;                        // D
  float* kn_s = q_s + D;                  // D
  float* vn_s = kn_s + D;                 // D
  float* k_s = vn_s + D;                  // kTile x ks
  float* v_s = k_s + kTile * ks;          // kTile x D
  float* p_s = v_s + kTile * D;           // kTile
  float* part = p_s + kTile;              // kThreads
  float* st = part + kThreads;            // m, l, alpha, s_new
  int* tab_s = reinterpret_cast<int*>(st + 4);   // live table prefix

  const T* row = a.qkv + (size_t)b * 3 * C;
  const int pos = a.pos[b];
  const int live = min((pos + psz - 1) / psz, a.mp);
  const int n_hist = min(pos, live * psz);
  const size_t out_row = ((size_t)l * a.B + b) * C + (size_t)h * D;
  for (int d = tid; d < D; d += kThreads) {
    q_s[d] = to_f(row[h * D + d]);
    kn_s[d] = to_f(row[C + h * D + d]);
    vn_s[d] = to_f(row[2 * C + h * D + d]);
    a.newk[out_row + d] = row[C + h * D + d];
    a.newv[out_row + d] = row[2 * C + h * D + d];
  }
  for (int p = tid; p < live; p += kThreads)
    tab_s[p] = a.tables[(size_t)b * a.mp + p];
  if (tid == 0) {
    st[0] = kNegInf;
    st[1] = 0.f;
  }
  __syncthreads();
  if constexpr (kQuant) {
    fake_quant_head<T, kFp8>(row + C, kn_s, C, D, h, a.head_gran, red);
    fake_quant_head<T, kFp8>(row + 2 * C, vn_s, C, D, h, a.head_gran, red);
  }

  const size_t layer = (size_t)l * a.N * psz;     // pool rows before l
  const P* kp = static_cast<const P*>(a.kp) + layer * C;
  const P* vp = static_cast<const P*>(a.vp) + layer * C;
  const int sw = a.head_gran ? H : 1;             // scales per pool row
  const float* ksl = kQuant ? a.ks + layer * sw : nullptr;
  const float* vsl = kQuant ? a.vs + layer * sw : nullptr;
  const int pvpr = D / PVEC;
  const int G = kThreads / D;                     // value row groups
  const int dd = tid % D, g = tid / D;
  const int gl = tid & (kGroup - 1);
  float acc = 0.f;                                // thread (g, dd)'s share
  for (int t0 = 0; t0 < n_hist; t0 += kTile) {
    const int rows = min(kTile, n_hist - t0);
    for (int e = tid; e < rows * pvpr; e += kThreads) {
      const int r = e / pvpr, c = (e % pvpr) * PVEC;
      const int gpos = t0 + r;
      const size_t prow = (size_t)tab_s[gpos / psz] * psz + gpos % psz;
      const size_t src = prow * C + (size_t)h * D + c;
      float* kd = k_s + r * ks + c;
      float* vd = v_s + r * D + c;
      load_vec(kp + src, kd);
      load_vec(vp + src, vd);
      if constexpr (kQuant) {
        const size_t si = prow * sw + (a.head_gran ? h : 0);
        const float sk = ksl[si], sv = vsl[si];
#pragma unroll
        for (int j = 0; j < PVEC; ++j) {
          kd[j] *= sk;
          vd[j] *= sv;
        }
      }
    }
    __syncthreads();
    for (int base = 0; base < rows; base += kThreads / kGroup) {
      const int r = base + tid / kGroup;
      float s = 0.f;
      if (r < rows)
        for (int d = gl; d < D; d += kGroup) s += q_s[d] * k_s[r * ks + d];
      s = group_sum(s);
      if (r < rows && gl == 0) p_s[r] = s * a.scale;
    }
    __syncthreads();
    if (warp == 0) {             // online softmax over the tile
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[r]);
      const float m_prev = st[0];
      const float m_new = fmaxf(m_prev, decode::warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float e = expf(p_s[r] - m_new);
        p_s[r] = e;
        sum += e;
      }
      sum = decode::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        st[1] = st[1] * alpha + sum;
        st[0] = m_new;
        st[2] = alpha;
      }
    }
    __syncthreads();
    float pv = 0.f;
    for (int r = g; r < rows; r += G) pv += p_s[r] * v_s[r * D + dd];
    acc = acc * st[2] + pv;
    __syncthreads();             // k_s, v_s, p_s are refilled next tile
  }
  // the fresh column's score, by warp 0
  if (warp == 0) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += q_s[d] * kn_s[d];
    s = decode::warp_sum(s);
    if (lane == 0) st[3] = s * a.scale;
  }
  part[g * D + dd] = acc;
  __syncthreads();
  if (tid < D) {
    float accd = 0.f;
    for (int j = 0; j < G; ++j) accd += part[j * D + tid];
    const float s_new = st[3];
    const float m2 = fmaxf(st[0], s_new);
    const float alpha = expf(st[0] - m2);
    const float p_new = expf(s_new - m2);
    const float denom = st[1] * alpha + p_new;   // >= p_new > 0
    a.attn[(size_t)b * C + (size_t)h * D + tid] =
        from_f<T>((accd * alpha + p_new * vn_s[tid]) / denom);
  }
  __syncthreads();
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
fused_paged_kernel(const Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int C = a.C, B = a.B;
  float* red = smem;                                    // kWarps + 1
  float* in_s = red + kWarps + 1;                       // kRB x 4C
  float* tile_red = in_s + kRB * 4 * C;                 // kWarps x kRB x TC
  float* att = in_s;                                    // union with both

  for (int l = 0; l < a.L; ++l) {
    const T* x = l == 0 ? a.x0 : a.xout;
    // A. LN1 + QKV
    for (int b0 = 0; b0 < B; b0 += kRB) {
      const int nb = min(kRB, B - b0);
      layer_norm_rows<T>(x, b0, nb, a.ln1s + (size_t)l * C,
                         a.ln1b + (size_t)l * C, C, a.eps, in_s);
      rows_product<T>(in_s, C, a.wqkv + (size_t)l * C * 3 * C,
                      a.bqkv + (size_t)l * 3 * C, 3 * C, nb, tile_red,
                      [&](int r, int col, float v) {
                        a.qkv[(size_t)(b0 + r) * 3 * C + col] = from_f<T>(v);
                      });
    }
    grid.sync();
    // B. attention, one block per (slot, head)
    for (int item = blockIdx.x; item < B * a.H; item += gridDim.x)
      attend_paged<T, P>(a, l, item / a.H, item % a.H, red, att);
    grid.sync();
    // C. output projection + residual
    for (int b0 = 0; b0 < B; b0 += kRB) {
      const int nb = min(kRB, B - b0);
      load_rows<T>(a.attn, b0, nb, C, in_s);
      rows_product<T>(in_s, C, a.wproj + (size_t)l * C * C,
                      a.bproj + (size_t)l * C, C, nb, tile_red,
                      [&](int r, int col, float v) {
                        const size_t i = (size_t)(b0 + r) * C + col;
                        a.xmid[i] = from_f<T>(to_f(x[i]) + round_to<T>(v));
                      });
    }
    grid.sync();
    // D. LN2 + MLP up + activation
    for (int b0 = 0; b0 < B; b0 += kRB) {
      const int nb = min(kRB, B - b0);
      layer_norm_rows<T>(a.xmid, b0, nb, a.ln2s + (size_t)l * C,
                         a.ln2b + (size_t)l * C, C, a.eps, in_s);
      rows_product<T>(in_s, C, a.wup + (size_t)l * C * 4 * C,
                      a.bup + (size_t)l * 4 * C, 4 * C, nb, tile_red,
                      [&](int r, int col, float v) {
                        const float u = round_to<T>(v);
                        a.up[(size_t)(b0 + r) * 4 * C + col] =
                            from_f<T>(a.gelu ? gelu_tanh(u) : fmaxf(u, 0.f));
                      });
    }
    grid.sync();
    // E. MLP down + residual
    for (int b0 = 0; b0 < B; b0 += kRB) {
      const int nb = min(kRB, B - b0);
      load_rows<T>(a.up, b0, nb, 4 * C, in_s);
      rows_product<T>(in_s, 4 * C, a.wdown + (size_t)l * 4 * C * C,
                      a.bdown + (size_t)l * C, C, nb, tile_red,
                      [&](int r, int col, float v) {
                        const size_t i = (size_t)(b0 + r) * C + col;
                        a.xout[i] =
                            from_f<T>(to_f(a.xmid[i]) + round_to<T>(v));
                      });
    }
    grid.sync();
  }
}

template <typename T, typename P>
int launch(Args<T> a, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats<T>(a.C, a.D, a.mp) * sizeof(float);
  if (a.D % kvq::vec_elems<T>() != 0 || a.D % kvq::vec_elems<P>() != 0 ||
      a.D > kThreads || kThreads % a.D != 0 || a.C != a.H * a.D ||
      a.B < 1 || smem > kMaxSmem ||
      (std::is_same<P, T>::value != (a.ks == nullptr)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = fused_paged_kernel<T, P>;
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
  int grid = widest > a.B * a.H ? widest : a.B * a.H;
  if (grid > per_sm * sms) grid = per_sm * sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* const* p, int pool, int L, int B, int C, int H, int N,
        int psz, int mp, int gelu, int head_gran, float eps,
        cudaStream_t stream) {
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(const_cast<void*>(p[i])); };
  Args<T> a;
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
  a.kp = p[13];
  a.vp = p[14];
  a.ks = static_cast<const float*>(p[15]);
  a.vs = static_cast<const float*>(p[16]);
  a.tables = static_cast<const int*>(p[17]);
  a.pos = static_cast<const int*>(p[18]);
  a.xout = out(19);
  a.newk = out(20);
  a.newv = out(21);
  T* scratch = out(22);          // 9 B C: qkv | attn | xmid | up
  a.qkv = scratch;
  a.attn = scratch + (size_t)3 * B * C;
  a.xmid = scratch + (size_t)4 * B * C;
  a.up = scratch + (size_t)5 * B * C;
  a.L = L;
  a.B = B;
  a.C = C;
  a.H = H;
  a.D = C / H;
  a.N = N;
  a.psz = psz;
  a.mp = mp;
  a.gelu = gelu;
  a.head_gran = head_gran;
  a.eps = eps;
  a.scale = 1.0f / sqrtf((float)a.D);
  if ((a.ks == nullptr) != (a.vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (pool == 0) return launch<T, T>(a, stream);
  if (pool == 1) return launch<T, int8_t>(a, stream);
  if (pool == 2) return launch<T, __nv_fp8_e4m3>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ptrs: the 23 device pointers x0, ln1_scale, ln1_bias, qkv_kernel,
// qkv_bias, attn_out_kernel, attn_out_bias, ln2_scale, ln2_bias,
// mlp_up_kernel, mlp_up_bias, mlp_down_kernel, mlp_down_bias (all
// contiguous, dtype 0 = float32, 1 = bfloat16), k_pages, v_pages (L x N x
// psz x C; pool 0 = that dtype, 1 = int8, 2 = fp8 e4m3), k_scales,
// v_scales (f32 L x N x psz, or L x N x psz x H with head_gran 1; null
// when pool is 0), tables (B x mp int32), pos (B int32), xout (B x C),
// newk, newv (L x B x C), scratch (9 B C elements). gelu: 1 for
// tanh-GELU, 0 ReLU. The kernel trusts the live prefix of each table row
// to hold page ids inside the pool; entries past it are never read.
extern "C" int fused_paged_decode_layers_launch(
    const void* const* ptrs, int L, int B, int C, int H, int N, int psz,
    int mp, int gelu, int head_gran, float eps, int dtype, int pool,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(ptrs, pool, L, B, C, H, N, psz, mp, gelu, head_gran,
                      eps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(ptrs, pool, L, B, C, H, N, psz, mp, gelu,
                              head_gran, eps, s);
  return (int)cudaErrorInvalidValue;
}
