// Windowed paged attention for one layer of a packed KV page pool.
//
// Replaces replicatinggpt_tpu/ops/paged_pallas.py:_paged_window_kernel
// (fold=True, quantized or not). For every slot b a window of W
// fresh query rows (row j at logical position pos[b] + j) attends the
// STALE pool rows at positions < pos[b], addressed through the slot's
// page table, and then the fresh (W, W) K/V block causally. Scores,
// running max, denominator and accumulator are f32; the output is
// written in the input dtype (bf16 or f32). A quantized pool (int8 or
// fp8 e4m3 pages with f32 scales per row, or per row and head) is
// dequantized in f32 as its rows are loaded, f32(q) * scale, never
// rounded to the compute dtype; the caller hands the fresh window
// already fake-quantized (quant/kv.py).
//
// Bound on this card: bytes. One call reads sum_b live_b * psz * C * 2 *
// itemsize bytes of K+V pages (live_b = ceil(pos[b] / psz); plus 8 or
// 8 * H scale bytes per row when quantized) and does
// about 4 flops per page element read, far below the H100's ~295
// flops/byte ridge, so its floor is those bytes at 3.35 TB/s.
//
// Design (first version, correct before fast): one thread block per
// (slot, head). The block reads its own pos[b] and live page-table
// prefix, and walks its history in tiles of kTile rows. A tile's rows
// may come from several pages (row g lives in page tables[b, g / psz]),
// so small pages still give every thread several independent 16-byte
// loads per tile. Each tile: K/V rows -> shared memory (f32), scores by
// groups of kGroup threads with shuffle reductions, one online-softmax
// update per query row by a warp, then the accumulator update. Rows at
// positions >= pos and table entries past the live frontier are never
// read. Nothing yet overlaps the next tile's loads with this tile's
// math, and B * H blocks under-fill the 132 SMs at small batch (split
// over pages is a later change).
//
// Plain C interface (ctypes); the launch returns cudaGetLastError().

#include "kv_quant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // history rows per tile
constexpr int kGroup = 8;     // threads per dot product
constexpr int kPad = 8;       // K row padding (floats): conflict-free reads
constexpr size_t kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// Shared memory floats of one block; keep in step with smem_bytes() in
// ops/paged_attention.py.
__host__ __device__ inline size_t smem_floats(int W, int D, int mp) {
  const int ks = D + kPad;
  const int ps = W > kTile ? W : kTile;
  return (size_t)W * D + (size_t)W * ks + 2 * (size_t)W * D +
         (size_t)kTile * ks + (size_t)kTile * D + (size_t)W * ps + 3 * W +
         mp;  // the table prefix is int32, one float slot each
}

// Scores of rows [0, n_rows) of `keys` (row stride ks) against every
// query row, times `scale`, into p_s[w * ps + r]. Groups of kGroup
// threads share one dot product; the loop bound is uniform across the
// block, so every lane reaches the shuffles.
__device__ __forceinline__ void scores(const float* q_s, const float* keys,
                                       int ks, float* p_s, int ps, int W,
                                       int n_rows, int D, float scale) {
  const int gl = threadIdx.x & (kGroup - 1);
  const int n_pairs = W * n_rows;
  for (int base = 0; base < n_pairs; base += kThreads / kGroup) {
    const int pair = base + threadIdx.x / kGroup;
    const bool ok = pair < n_pairs;
    const int w = ok ? pair / n_rows : 0;
    const int r = ok ? pair % n_rows : 0;
    float s = 0.f;
    if (ok)
      for (int d = gl; d < D; d += kGroup)
        s += q_s[w * D + d] * keys[r * ks + d];
    s = group_sum(s);
    if (ok && gl == 0) p_s[w * ps + r] = s * scale;
  }
}

// T: the window rows' and output's dtype; P: the pool's (T, int8 or fp8).
// k_scales/v_scales: null for an unquantized pool, else (N, psz) f32 per
// row (head_gran 0) or (N, psz, H) per row and head (head_gran 1).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
paged_window_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new,
                    const P* __restrict__ k_pages,
                    const P* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, int head_gran,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos_arr, T* __restrict__ out,
                    int W, int psz, int mp, int H, int D, float scale) {
  using kvq::load_vec;
  constexpr int VEC = kvq::vec_elems<T>();
  constexpr int PVEC = kvq::vec_elems<P>();
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C = H * D;
  const int ks = D + kPad;
  const int ps = W > kTile ? W : kTile;
  const int vpr = D / VEC;     // 16-byte vectors per window head row
  const int pvpr = D / PVEC;   // 16-byte vectors per page head row

  extern __shared__ float smem[];
  float* q_s = smem;                 // W x D
  float* kn_s = q_s + W * D;         // W x ks
  float* vn_s = kn_s + W * ks;       // W x D
  float* acc_s = vn_s + W * D;       // W x D
  float* k_s = acc_s + W * D;        // kTile x ks
  float* v_s = k_s + kTile * ks;     // kTile x D
  float* p_s = v_s + kTile * D;      // W x ps
  float* m_s = p_s + W * ps;         // W
  float* l_s = m_s + W;              // W
  float* a_s = l_s + W;              // W
  int* tab_s = reinterpret_cast<int*>(a_s + W);   // live table prefix

  const int pos = pos_arr[b];
  const int live = min((pos + psz - 1) / psz, mp);
  const int n_hist = min(pos, live * psz);
  const size_t row0 = (size_t)b * W * C + (size_t)h * D;

  for (int e = tid; e < W * vpr; e += kThreads) {
    const int w = e / vpr, c = (e % vpr) * VEC;
    const size_t off = row0 + (size_t)w * C + c;
    load_vec(q + off, q_s + w * D + c);
    load_vec(k_new + off, kn_s + w * ks + c);
    load_vec(v_new + off, vn_s + w * D + c);
  }
  for (int e = tid; e < W * D; e += kThreads) acc_s[e] = 0.f;
  for (int w = tid; w < W; w += kThreads) {
    m_s[w] = kNegInf;
    l_s[w] = 0.f;
  }
  for (int p = tid; p < live; p += kThreads)
    tab_s[p] = tables[(size_t)b * mp + p];
  __syncthreads();

  for (int t0 = 0; t0 < n_hist; t0 += kTile) {
    const int rows = min(kTile, n_hist - t0);
    for (int e = tid; e < rows * pvpr; e += kThreads) {
      const int r = e / pvpr, c = (e % pvpr) * PVEC;
      const int g = t0 + r;
      const size_t prow = (size_t)tab_s[g / psz] * psz + g % psz;
      const size_t src = prow * C + (size_t)h * D + c;
      float* kd = k_s + r * ks + c;
      float* vd = v_s + r * D + c;
      load_vec(k_pages + src, kd);
      load_vec(v_pages + src, vd);
      if (k_scales != nullptr) {
        const size_t si = head_gran ? prow * H + h : prow;
        const float sk = k_scales[si], sv = v_scales[si];
#pragma unroll
        for (int j = 0; j < PVEC; ++j) {
          kd[j] *= sk;
          vd[j] *= sv;
        }
      }
    }
    __syncthreads();
    scores(q_s, k_s, ks, p_s, ps, W, rows, D, scale);
    __syncthreads();
    // online softmax: one warp per query row
    for (int w = warp; w < W; w += kWarps) {
      float* pw = p_s + w * ps;
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, pw[r]);
      const float m_prev = m_s[w];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float e = expf(pw[r] - m_new);
        pw[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[w] = alpha;
        l_s[w] = l_s[w] * alpha + sum;
        m_s[w] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < W * D; e += kThreads) {
      const int w = e / D, d = e % D;
      const float* pw = p_s + w * ps;
      float a = acc_s[e] * a_s[w];
      for (int r = 0; r < rows; ++r) a += pw[r] * v_s[r * D + d];
      acc_s[e] = a;
    }
    __syncthreads();
  }

  // fold the fresh window: row w attends fresh rows 0..w
  scores(q_s, kn_s, ks, p_s, ps, W, W, D, scale);
  __syncthreads();
  for (int w = warp; w < W; w += kWarps) {
    float* pw = p_s + w * ps;
    float mx = kNegInf;
    for (int j = lane; j <= w; j += 32) mx = fmaxf(mx, pw[j]);
    const float m_prev = m_s[w];
    const float m2 = fmaxf(m_prev, warp_max(mx));
    float sum = 0.f;
    for (int j = lane; j < W; j += 32) {
      const float e = j <= w ? expf(pw[j] - m2) : 0.f;
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      // denominator >= the diagonal term > 0
      const float alpha = expf(m_prev - m2);
      a_s[w] = alpha;
      l_s[w] = l_s[w] * alpha + sum;
    }
  }
  __syncthreads();
  for (int e = tid; e < W * D; e += kThreads) {
    const int w = e / D, d = e % D;
    const float* pw = p_s + w * ps;
    float a = acc_s[e] * a_s[w];
    for (int j = 0; j < W; ++j) a += pw[j] * vn_s[j * D + d];
    store(out + row0 + (size_t)w * C + d, a / l_s[w]);
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_pages, const void* v_pages, const float* k_scales,
           const float* v_scales, int head_gran, const int* tables,
           const int* pos, void* out, int B, int W, int psz, int mp, int H,
           int D, cudaStream_t stream) {
  const size_t smem = smem_floats(W, D, mp) * sizeof(float);
  if (smem > kMaxSmem || D % kvq::vec_elems<T>() != 0 ||
      D % kvq::vec_elems<P>() != 0 || H > 65535 ||
      (k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = paged_window_kernel<T, P>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), k_scales, v_scales, head_gran, tables,
      pos, static_cast<T*>(out), W, psz, mp, H, D, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pool(int pool, const void* q, const void* k_new, const void* v_new,
                const void* k_pages, const void* v_pages, const float* ks,
                const float* vs, int head_gran, const int* tab, const int* p,
                void* out, int B, int W, int psz, int mp, int H, int D,
                cudaStream_t s) {
  if (pool == 0 && ks == nullptr)
    return launch<T, T>(q, k_new, v_new, k_pages, v_pages, ks, vs, head_gran,
                        tab, p, out, B, W, psz, mp, H, D, s);
  if (pool == 1 && ks != nullptr)
    return launch<T, int8_t>(q, k_new, v_new, k_pages, v_pages, ks, vs,
                             head_gran, tab, p, out, B, W, psz, mp, H, D, s);
  if (pool == 2 && ks != nullptr)
    return launch<T, __nv_fp8_e4m3>(q, k_new, v_new, k_pages, v_pages, ks,
                                    vs, head_gran, tab, p, out, B, W, psz,
                                    mp, H, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (window rows and output): 0 = float32, 1 = bfloat16. pool: 0 =
// the pages in that dtype (k_scales and v_scales null), 1 = int8, 2 = fp8
// e4m3, with f32 scales (N, psz) (head_gran 0) or (N, psz, H) (head_gran
// 1). The kernel trusts the live prefix of each table row to hold page
// ids inside the pool (the allocator's invariant); entries past it are
// never read.
extern "C" int paged_window_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scales, const void* v_scales,
    int head_gran, const void* tables, const void* pos, void* out, int B,
    int W, int psz, int mp, int H, int D, int dtype, int pool, void* stream) {
  const int* tab = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pool<float>(pool, q, k_new, v_new, k_pages, v_pages, ks,
                              vs, head_gran, tab, p, out, B, W, psz, mp, H,
                              D, s);
  if (dtype == 1)
    return launch_pool<__nv_bfloat16>(pool, q, k_new, v_new, k_pages,
                                      v_pages, ks, vs, head_gran, tab, p,
                                      out, B, W, psz, mp, H, D, s);
  return (int)cudaErrorInvalidValue;
}
