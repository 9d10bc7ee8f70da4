// Decode attention over a packed (B, S, C) KV cache at one shared pos.
//
// Replaces replicatinggpt_tpu/ops/decode_pallas.py:_packed_attn_kernel
// (entry packed_decode_attention). For every batch row b and head h the
// fresh query row q[b, h*D:(h+1)*D] attends the STALE cache rows at
// positions < pos (head h is the D-wide column strip h*D of each packed
// row, as in flash_packed.cu) and then the fresh column (k_new, v_new);
// the caller writes k_new/v_new at pos afterwards (attend-stale-then-
// write == write-then-attend). Scores and softmax in f32; the weights
// p / denom are rounded to the cache dtype before the value product, and
// so is the fresh column's weight, as the TPU kernel rounds them.
//
// Bound on this card: bytes. One call reads 2 * B * pos * C * itemsize
// bytes of K and V and does 4 flops per element read, far below the
// H100's ~295 flops/byte ridge. At GPT-2 124M, B=8, pos 318, bf16 that
// is 7.8 MB: 2.35 us at 3.35 TB/s (H100 80GB HBM3, 700 W).
//
// The rounding point decides the design: round(p / denom) is not
// round(p) / denom, so an online softmax that rescales a P V accumulator
// is another function. The global max and denominator must exist before
// any weight is formed. Design:
// - A thread-block cluster of R CTAs (R <= 8, cudaLaunchKernelEx with a
//   cluster dimension) serves one (b, h); the grid is (R * B, H). The
//   history is cut into R contiguous row ranges. R is sized from pos
//   alone (a host int): one rank per kRankRows rows, so a short history
//   runs one CTA on a plain grid with no cluster barrier (split(),
//   mirrored by packed_decode_split in ops/decode.py).
// - Each rank issues every copy of its K and V rows at entry (cp.async,
//   16 bytes a thread, K one commit group and V another) into shared
//   memory in the cache's own dtype, converted at use; V does not depend
//   on the scores, so its copy overlaps the score pass. Rows past what
//   the card's shared memory holds (only for pos > 8 * kRankRows at wide
//   rows) are read in place.
// - Scores: lane groups of G lanes (G 16-byte vectors of a row) own whole
//   rows, q held in registers; each group keeps the (m, l) of its rows
//   online, and one block reduction gives the rank's (m, l).
// - The merge: one cluster barrier publishes every rank's (m, l); each
//   rank reads them through distributed shared memory and forms the
//   global m = max(m_all, s_new) and denom in rank order, so all ranks
//   hold the same bits. Each rank rounds its weights, runs P V from
//   shared memory (a thread one 16-byte vector of a row) and writes its
//   D-wide f32 partial into rank 0's shared memory; after a second
//   barrier rank 0 sums the partials in rank order and adds
//   round(p_new / denom) * v_new. An empty history (pos 0) is warp 0's
//   alone, with the same arithmetic.
// What is left: the rank count follows pos only, so at a large batch the
// split adds CTAs to a grid that is already full (PERF.md has the sweep).
//
// Plain C interface (ctypes); the launch returns cudaGetLastError().

#include <cooperative_groups.h>

#include "decode_attention.cuh"

namespace cg = cooperative_groups;

namespace {

using decode::block_max_sumexp;
using decode::from_f;
using decode::kNegInf;
using decode::kThreads;
using decode::kWarps;
using decode::round_to;
using decode::to_f;
using kvq::load_vec;

constexpr int kRankRows = 128;   // history rows that earn a rank
constexpr int kMaxRanks = 8;     // CTAs of a cluster (portable size)
constexpr long kMaxSmem = 232448;

// The launch's split at this pos, and the CTA's shared memory: scores
// (rows floats), the block reductions and the rank's (m, l) (2 kWarps +
// 6), the P V partial sums (kWarps x D) and the ranks' partials (kMaxRanks
// x D), after the K and V rows held (held x D elements of T each). Keep in
// step with packed_decode_split() in ops/decode.py.
struct Split {
  int ranks, rows, held;
  long fixed, smem;   // bytes
};

__host__ __device__ inline long fixed_bytes(int rows, int D) {
  return 4L * (rows + 2 * kWarps + 6 + (long)kWarps * D +
               (long)kMaxRanks * D);
}

__host__ __device__ inline Split split(int D, int isz, int pos) {
  Split s;
  s.ranks = (pos + kRankRows - 1) / kRankRows;
  s.ranks = s.ranks < 1 ? 1 : s.ranks > kMaxRanks ? kMaxRanks : s.ranks;
  s.rows = (pos + s.ranks - 1) / s.ranks;
  s.fixed = fixed_bytes(s.rows, D);
  const long row = 2L * D * isz;
  long cap = (kMaxSmem - s.fixed) / row;
  cap = cap < 0 ? 0 : cap;
  s.held = s.rows < cap ? s.rows : (int)cap;
  s.smem = s.held * row + s.fixed;
  return s;
}

template <typename T>
struct Args {
  const T* q;
  const T* k_new;
  const T* v_new;
  const T* kc;
  const T* vc;
  T* out;
  long ld;            // row stride of q / k_new / v_new
  int S, C, D, pos;
  float scale;
  Split sp;
};

// NVL: 16-byte vectors of a row one lane holds in the score pass (1, or
// 2 where a row has more than 32). kSplit: ranks > 1 (a cluster); one
// rank runs an instantiation with no cluster instruction at all.
template <typename T, int NVL, bool kSplit>
__global__ void __launch_bounds__(kThreads)
packed_decode_kernel(const Args<T> a) {
  constexpr int VEC = 16 / sizeof(T);
  const int R = a.sp.ranks;
  const int rank = blockIdx.x % R, b = blockIdx.x / R, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, C = a.C, nvec = D / VEC;
  const int r0 = rank * a.sp.rows;
  const int r1 = min(r0 + a.sp.rows, a.pos);
  const int n = r1 > r0 ? r1 - r0 : 0;
  const int nh = min(n, a.sp.held);

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (long)a.sp.held * D;
  float* p_s = reinterpret_cast<float*>(v_s + (long)a.sp.held * D);
  float* red = p_s + a.sp.rows;          // 2 kWarps + 2
  float* ml_s = red + 2 * kWarps + 2;    // this rank's (m, l), then s_new
  float* pv_red = ml_s + 4;              // kWarps x D
  float* part = pv_red + kWarps * D;     // kMaxRanks x D (rank 0's)

  const long row = (long)b * a.ld + (long)h * D;
  if (!kSplit && a.pos == 0) {
    // no history: the fresh column alone, by warp 0, with the general
    // path's arithmetic at (m, l) = (-1e30, 0) (the same bits)
    if (warp != 0) return;
    float sn = 0.f;
    for (int d = lane; d < D; d += 32)
      sn += to_f(a.q[row + d]) * to_f(a.k_new[row + d]);
    const float s_new = decode::warp_sum(sn) * a.scale;
    const float M = fmaxf(kNegInf, s_new);
    const float p_new = expf(s_new - M);
    const float denom = 0.f * expf(kNegInf - M) + p_new;
    const float w_new = round_to<T>(p_new / denom);
    for (int d = lane; d < D; d += 32)
      a.out[(long)b * C + (long)h * D + d] =
          from_f<T>(0.f + w_new * to_f(a.v_new[row + d]));
    return;
  }
  const T* kc = a.kc + (long)b * a.S * C + (long)h * D + (long)r0 * C;
  const T* vc = a.vc + (long)b * a.S * C + (long)h * D + (long)r0 * C;

  // every copy at once: K rows one commit group, V rows the next
  for (int e = tid; e < nh * nvec; e += kThreads) {
    const int r = e / nvec, c = (e - r * nvec) * VEC;
    kvq::cp_async16(k_s + (long)r * D + c, kc + (long)r * C + c);
  }
  kvq::cp_async_commit();
  for (int e = tid; e < nh * nvec; e += kThreads) {
    const int r = e / nvec, c = (e - r * nvec) * VEC;
    kvq::cp_async16(v_s + (long)r * D + c, vc + (long)r * C + c);
  }
  kvq::cp_async_commit();

  // the lane group's share of q, in registers; the fresh score by warp 0
  int G = 1;
  while (2 * G <= nvec && 2 * G <= 32) G *= 2;
  const int gl = lane & (G - 1), gidx = tid / G, groups = kThreads / G;
  float qv[NVL][VEC];
#pragma unroll
  for (int j = 0; j < NVL; ++j) {
    const int vi = gl + j * G;
    if (vi < nvec) {
      load_vec(a.q + row + vi * VEC, qv[j]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qv[j][i] = 0.f;
    }
  }
  if (warp == 0) {
    float sn = 0.f;
    for (int d = lane; d < D; d += 32)
      sn += to_f(a.q[row + d]) * to_f(a.k_new[row + d]);
    sn = decode::warp_sum(sn);
    if (lane == 0) ml_s[2] = sn * a.scale;
  }
  kvq::cp_async_wait<1>();
  __syncthreads();   // K is in; s_new is published

  // scores of the rank's rows, (m, l) online per lane group
  float m = kNegInf, l = 0.f;
  for (int base = 0; base < n; base += groups) {   // block-uniform bound
    const int r = base + gidx;
    const bool ok = r < n;
    const T* kr = r < nh ? k_s + (long)r * D : kc + (long)(ok ? r : 0) * C;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NVL; ++j) {
      const int vi = gl + j * G;
      if (ok && vi < nvec) {
        float kv[VEC];
        load_vec(kr + vi * VEC, kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += qv[j][i] * kv[i];
      }
    }
    for (int o = G / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (ok) {
      s *= a.scale;
      if (gl == 0) p_s[r] = s;
      const float mn = fmaxf(m, s);
      l = l * expf(m - mn) + expf(s - mn);
      m = mn;
    }
  }
  // one lane a group speaks for it
  const float2 ml = block_max_sumexp(gl == 0 ? m : kNegInf,
                                     gl == 0 ? l : 0.f, red);
  const float s_new = ml_s[2];
  float M, denom;
  if constexpr (kSplit) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) {
      ml_s[0] = ml.x;
      ml_s[1] = ml.y;
    }
    cluster.sync();   // every rank's (m, l) is published
    float mr[kMaxRanks], lr[kMaxRanks];
#pragma unroll
    for (int i = 0; i < kMaxRanks; ++i) {
      if (i < R) {
        const float* o = cluster.map_shared_rank(ml_s, i);
        mr[i] = o[0];
        lr[i] = o[1];
      }
    }
    M = s_new;
#pragma unroll
    for (int i = 0; i < kMaxRanks; ++i)
      if (i < R) M = fmaxf(M, mr[i]);
    denom = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRanks; ++i)
      if (i < R) denom += lr[i] * expf(mr[i] - M);
  } else {
    M = fmaxf(ml.x, s_new);
    denom = ml.y * expf(ml.x - M);
  }
  const float p_new = expf(s_new - M);
  denom += p_new;
  for (int r = tid; r < n; r += kThreads)
    p_s[r] = round_to<T>(expf(p_s[r] - M) / denom);
  kvq::cp_async_wait<0>();
  __syncthreads();   // the weights and V are in

  // P V: a thread one 16-byte vector of a row, kThreads / nvec row
  // groups; the groups of a warp by shuffles, then the warps (or, a row
  // wider than a warp, the groups) in order
  const int RG = kThreads / nvec, cvv = tid % nvec, rg = tid / nvec;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int r = rg; r < n; r += RG) {
    float vv[VEC];
    load_vec((r < nh ? v_s + (long)r * D : vc + (long)r * C) + cvv * VEC, vv);
    const float p = p_s[r];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += p * vv[i];
  }
  int ngroups = RG;
  if (nvec < 32) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      for (int o = nvec; o < 32; o <<= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    ngroups = kWarps;
  }
  if (nvec >= 32 || lane < nvec) {
    const int g = nvec < 32 ? warp : rg;
#pragma unroll
    for (int i = 0; i < VEC; ++i) pv_red[g * D + cvv * VEC + i] = acc[i];
  }
  __syncthreads();
  float pv = 0.f;
  if (tid < D)
    for (int g = 0; g < ngroups; ++g) pv += pv_red[g * D + tid];
  if constexpr (kSplit) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid < D) cluster.map_shared_rank(part, 0)[rank * D + tid] = pv;
    cluster.sync();   // rank 0 holds every partial; the others may leave
    if (rank != 0) return;
    if (tid < D) {
      pv = 0.f;
      for (int i = 0; i < R; ++i) pv += part[i * D + tid];
    }
  }
  if (tid < D) {
    const float w_new = round_to<T>(p_new / denom);
    a.out[(long)b * C + (long)h * D + tid] =
        from_f<T>(pv + w_new * to_f(a.v_new[row + tid]));
  }
}

template <typename T, int NVL>
int launch_kernel(const Args<T>& a, int B, int H, cudaStream_t stream) {
  auto kernel = a.sp.ranks > 1 ? packed_decode_kernel<T, NVL, true>
                               : packed_decode_kernel<T, NVL, false>;
  // past the default 48 KB only where a launch needs it, and only as far
  // as that launch needs
  cudaError_t err = cudaSuccess;
  if (a.sp.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)a.sp.smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.sp.ranks * B, H);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.sp.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.sp.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.sp.ranks > 1 ? 1 : 0;   // one rank: a plain grid
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_cache, const void* v_cache, void* out, int B,
           long ld, int S, int H, int D, int pos, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC != 0 || D > kThreads || kThreads % D != 0 || pos < 0 ||
      pos >= S || H > 65535 || (long)B * kMaxRanks > 2147483647L)
    return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k_new = static_cast<const T*>(k_new);
  a.v_new = static_cast<const T*>(v_new);
  a.kc = static_cast<const T*>(k_cache);
  a.vc = static_cast<const T*>(v_cache);
  a.out = static_cast<T*>(out);
  a.ld = ld;
  a.S = S;
  a.C = H * D;
  a.D = D;
  a.pos = pos;
  a.scale = 1.0f / sqrtf((float)D);
  a.sp = split(D, (int)sizeof(T), pos);
  if (a.sp.fixed > kMaxSmem) return (int)cudaErrorInvalidValue;
  return D / VEC > 32 ? launch_kernel<T, 2>(a, B, H, stream)
                      : launch_kernel<T, 1>(a, B, H, stream);
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

// The launch's split at these shapes, for the tests of the Python
// mirror: out = ranks, rows a rank, rows held in shared memory, dynamic
// shared memory (bytes).
extern "C" int packed_decode_attention_split(int D, int isz, int pos,
                                             long* out) {
  const Split s = split(D, isz, pos);
  out[0] = s.ranks;
  out[1] = s.rows;
  out[2] = s.held;
  out[3] = s.smem;
  return 0;
}
