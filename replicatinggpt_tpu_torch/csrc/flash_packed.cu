// Flash attention, forward and backward, on two layouts with one body:
// the fused (B, T, 3C) QKV projection output (packed) and separate
// (B, H, T, D) q, k, v (heads), the latter also as a q-chunk against a
// kv-chunk at global offsets (chunk: one ring-attention hop).
//
// Replaces, in replicatinggpt_tpu/ops/flash_pallas.py:
// - packed: _fwd_kernel_packed (forward, via _packed_fwd) and
//   _bwd_kernel_packed (backward, via _packed_bwd), and the head-group
//   families that compute the same function on (T, 128)-column strips:
//   _group_fwd / _group_bwd, their streamed (_group_fwd_stream /
//   _group_bwd_stream) and triangular (_group_fwd_tri / _group_bwd_tri)
//   variants;
// - heads: the (B, H, T, D) family of pallas_flash_attention: _fwd_kernel
//   (via _flash_fwd), the backward kernels of _flash_bwd (_bwd_dq_kernel,
//   _bwd_dkv_kernel), _flash_bwd_fused's single-tile kernel, the kv-major
//   fused backward (_fused_kv_major_bwd), the streamed (_flash_fwd_stream,
//   _flash_bwd_stream) and the triangular (_flash_fwd_tri, _flash_bwd_tri)
//   variants;
// - chunk: pallas_flash_chunk's kernels, _chunk_fwd_kernel (via
//   _chunk_fwd), _chunk_bwd_dq_kernel and _chunk_bwd_dkv_kernel (via
//   _flash_chunk_bwd_rule), the kv-major _chunk_bwd_fused_kernel (via
//   _fused_kv_major_bwd) and the streamed _chunk_fwd_stream /
//   _chunk_bwd_stream kernels.
// All of them compute one function and differ only in what the TPU keeps
// resident in VMEM; here a block keeps one q or kv tile and walks the
// other side's tiles through shared memory, so T is bounded by memory
// only.
//
// Addressing: every tensor is a View, a base pointer and the element
// strides of (batch, head, row); a row's D elements are contiguous. The
// packed entry points read head h's q, k and v as the column strips
// [h*D, (h+1)*D), C + ... and 2C + ... of each packed row (row stride 3C)
// and write the merged (B, T, C) output, the f32 lse (B, T, H) and the
// packed d(qkv); the heads entry points take q, k, v, o, dO, dq, dk, dv
// as (B, H, T, D) and lse, delta as (B, H, T) f32. The backward takes
// delta = rowsum(dO * O) per row and head from the caller. Scores,
// softmax statistics and every accumulator are f32; loads of bf16 inputs
// convert to f32 in shared memory. `scale` multiplies the scores.
//
// Positions: q row r sits at global position q_off + r, k row c at k_off
// + c (all offsets 0 for the packed and heads entry points, where the
// rules below reduce to the diagonal ones). `causal` hides key c from row r iff
// k_off + c > q_off + r. A q tile walks the kv tiles whose first key is
// at or before its last row; a kv tile walks the q tiles from the first
// whose last row sees its first key; a tile is masked elementwise
// wherever some pair fails the inequality, which at tile-aligned zero
// offsets is the diagonal tile alone. A row with no visible key (a chunk
// placed past it, or a row before the first key of a processed tile's
// chunk) counts no probability mass: o = 0, lse = NEG_INF = -1e30, and
// its gradients are 0 (the backward gets lse clamped to NEG_INF / 2, so
// p = exp(s - lse) of its masked scores is 0, and zeroes them anyway).
//
// Attention dropout is the JAX kernels' counter hash (_dropout_mult):
// h = fmix32(seed ^ bh * 0x9E3779B9), y = fmix32(fmix32(h ^ qpos) ^
// kpos) at global positions, kept iff y > threshold, kept weights
// scaled by `keep`; bh = bh_off + b * H + h in every layout (the (B*H)
// grid index of the JAX heads and chunk kernels). The forward's normalizer l sees no dropout;
// only the V accumulation does. The backward regenerates the same mask.
//
// Bound on this card: at GPT-2 XL's shapes (B=16, H=25, T=1024, D=64,
// bf16, causal) the forward moves ~210 MB (63 us at 3.35 TB/s) against
// 5.4e10 FLOP (54 us at 989 TFLOP/s): bytes bound it; the backward is
// bound by its operations. A ring hop of GPT-2 XL split 4 ways (B=16,
// H=25, Tq=Tk=256, D=64, bf16) moves ~53 MB forward and ~93 MB backward
// (~16 and ~28 us) against 6.7 and 16.8 GFLOP on a fully visible hop (7
// and 17 us): bytes bound both. These kernels are far from either: they
// multiply in f32 on the CUDA cores (no tensor cores), so operations
// bound them in practice. wgmma/TMA tiles are later work; a hop's grid is
// a quarter of the full sequence's (Tq / 64 q tiles), still 1600 blocks
// at the XL hop.
//
// Design (first version, correct before fast): BM-row tiles (64; 32 for
// the D=256 backward, whose 64-row f32 tiles would need ~297 KB of
// shared memory where a block may have 227 KB), 256 threads as a 16 x 16
// grid, each thread owning a BM/16 x BM/16 (score tile) or BM/16 x D/16
// (output tile) micro-tile at rows ty + 16i, columns tx + 16j, so
// shared-memory reads are conflict-free with a row stride of D + 1
// floats.
// - forward: one block per (q tile, head, batch); K/V tiles walked up to
//   the last one its rows see (causal) or to the end, masked where a key
//   is past a row; online softmax with m, l and the accumulator in f32.
// - backward: two kernels, no atomics, so the result is deterministic.
//   dkv_kernel: one block per (kv tile, head, batch), q tiles from the
//   first that sees it (causal) or the start down, dK and dV accumulated
//   in registers. dq_kernel: one block per (q tile, head, batch), kv
//   tiles as the forward walks them. Both recompute p = exp(s - lse) and
//   dP; the pair is the port of every TPU backward above.
//
// Plain C interface (ctypes); each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // rows of a forward tile; T is a multiple
constexpr float kNegInf = -1e30f;

// rows of a backward tile: 32 at D=256 (shared memory), else 64
template <int D>
constexpr int bwd_rows() {
  return D == 256 ? 32 : kTile;
}

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

// A tensor as a base pointer and the element strides of (batch, head,
// row); the D elements of a row are contiguous.
template <typename P>
struct View {
  P* p;
  long long sb, sh, sr;

  __device__ __forceinline__ P* at(int b, int h, int r) const {
    return p + b * sb + h * sh + r * sr;
  }
};

// Where a chunk sits in the whole sequence: q row r is at global
// position q_off + r, k row c at k_off + c; (batch b, head h) hashes as
// bh_off + b * H + h. All 0 for full-sequence attention.
struct Offsets {
  int q, k, bh;
};

template <typename T>
struct FwdArgs {
  View<const T> q, k, v;
  View<T> o;
  View<float> lse;
  int Tq, Tk, H, causal;
  Offsets off;
  float scale;
  Dropout dp;
};

template <typename T>
struct BwdArgs {
  View<const T> q, k, v, dout;
  View<const float> lse, delta;
  View<T> dq, dk, dv;
  int Tq, Tk, H, causal;
  Offsets off;
  float scale;
  Dropout dp;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Causal tile walks on global positions (the JAX chunk kernels' rules,
// flash_pallas.py _chunk_fwd_kernel / _chunk_bwd_dkv_kernel). kv tiles a
// q tile whose first row is at qpos0 reaches: those whose first key is
// at or before its last row. With zero offsets and equal lengths this is
// q tile index + 1, the diagonal rule.
template <int BM>
__device__ __forceinline__ int kv_tiles(int causal, int qpos0, int k_off,
                                        int n_kv) {
  if (!causal) return n_kv;
  return clamp_int(floor_div(qpos0 + BM - 1 - k_off, BM) + 1, 0, n_kv);
}
// The first q tile whose last row can see the key at kpos0 (the mirror
// rule; the kv tile's index with zero offsets).
template <int BM>
__device__ __forceinline__ int first_q_tile(int causal, int kpos0, int q_off,
                                            int n_q) {
  if (!causal) return 0;
  return clamp_int(floor_div(kpos0 - q_off, BM), 0, n_q);
}

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

// BM rows of D elements, row r at src + r * stride, into dst (f32, row
// stride D + 1), 16 bytes per thread per load.
template <typename T, int D, int BM>
__device__ __forceinline__ void load_tile(const T* src, long long stride,
                                          float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int e = threadIdx.x; e < BM * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * VEC;
    float f[VEC];
    load_vec(src + r * stride + c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * (D + 1) + c + i] = f[i];
  }
}

// s[i][j] += A[ty + 16i] . B[tx + 16j] over D (A, B: tiles of row
// stride D + 1), i, j < BM / 16.
template <int D, int BM>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bt,
                                         float s[BM / 16][BM / 16], int tx,
                                         int ty) {
  constexpr int SD = D + 1, R = BM / 16;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * SD + d];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = Bt[(tx + 16 * j) * SD + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] += a[i] * b[j];
  }
}

// Scores s = Q K^T (rows of q_s) and dP = dO V^T for one tile pair, then
// p_s = p * z and ds_s = p (z dP - delta) scale, with p = exp(s scale -
// lse); the tile's first q row and key are at global positions qpos0 and
// kpos0, and when `mask`, key c is past row r (p = 0) iff c - r > qpos0 -
// kpos0.
template <int D, int BM>
__device__ __forceinline__ void bwd_scores(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dl_s, float* p_s, float* ds_s,
    int qpos0, int kpos0, bool mask, float scale, const Dropout& dp,
    uint32_t hh, int tx, int ty) {
  constexpr int R = BM / 16, SS = BM + 1;
  const int d = qpos0 - kpos0;
  float s[R][R] = {}, g[R][R] = {};
  dot_tile<D, BM>(q_s, k_s, s, tx, ty);
  dot_tile<D, BM>(do_s, v_s, g, tx, ty);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const uint32_t rr = dp.on ? dp.row(hh, qpos0 + r) : 0u;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      const float p =
          (mask && c - r > d) ? 0.f : expf(s[i][j] * scale - lse_s[r]);
      const float z = dp.on ? dp.mult(rr, kpos0 + c) : 1.f;
      p_s[r * SS + c] = p * z;
      ds_s[r * SS + c] = p * (g[i][j] * z - dl_s[r]) * scale;
    }
  }
}

template <int D, int BM>
constexpr size_t fwd_smem_floats() {
  return 3 * (size_t)BM * (D + 1) + (size_t)BM * (BM + 1) + 3 * BM;
}
template <int D, int BM>
constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)BM * (D + 1) + 2 * (size_t)BM * (BM + 1) + 2 * BM;
}
template <int D, int BM>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)BM * (D + 1) + (size_t)BM * (BM + 1) + 2 * BM;
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FwdArgs<T> a) {
  constexpr int SD = D + 1, SS = BM + 1, R = BM / 16, NJ = D / 16;
  constexpr int CPL = BM / 32;  // softmax columns per lane
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM, qpos0 = a.off.q + q0;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;            // BM x SD
  float* k_s = q_s + BM * SD;   // BM x SD
  float* v_s = k_s + BM * SD;   // BM x SD
  float* s_s = v_s + BM * SD;   // BM x SS: scores, then p
  float* m_s = s_s + BM * SS;   // running max
  float* l_s = m_s + BM;        // running normalizer (no dropout)
  float* a_s = l_s + BM;        // this tile's rescale factor

  load_tile<T, D, BM>(a.q.at(b, h, q0), a.q.sr, q_s);
  for (int r = tid; r < BM; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const Dropout& dp = a.dp;
  const uint32_t hh = dp.head(a.off.bh + b * a.H + h);
  float acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_kv = kv_tiles<BM>(a.causal, qpos0, a.off.k, a.Tk / BM);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BM, kpos0 = a.off.k + k0;
    // key c is past query row r iff c - r > d; only a tile with d < BM - 1
    // has such a pair (with zero offsets: the diagonal tile, d = 0)
    const int d = qpos0 - kpos0;
    const bool mask = a.causal && d < BM - 1;
    __syncthreads();  // the last tile's readers of k_s, v_s, s_s are done
    load_tile<T, D, BM>(a.k.at(b, h, k0), a.k.sr, k_s);
    load_tile<T, D, BM>(a.v.at(b, h, k0), a.v.sr, v_s);
    __syncthreads();
    float s[R][R] = {};
    dot_tile<D, BM>(q_s, k_s, s, tx, ty);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        s_s[r * SS + c] = (mask && c - r > d) ? kNegInf : s[i][j] * a.scale;
      }
    __syncthreads();
    // online softmax: one warp per row, CPL columns per lane
    for (int r = warp; r < BM; r += kWarps) {
      float* sr = s_s + r * SS;
      float x[CPL], mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        x[c] = sr[lane + 32 * c];
        mx = fmaxf(mx, x[c]);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      // no visible key in this row yet: every score so far is the mask
      // value, and exp(s - m_new) would count each masked key as 1
      const bool unseen = m_new == kNegInf;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        x[c] = unseen ? 0.f : expf(x[c] - m_new);
        sum += x[c];
      }
      sum = warp_sum(sum);
      if (dp.on) {
        const uint32_t rr = dp.row(hh, qpos0 + r);
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          x[c] *= dp.mult(rr, kpos0 + lane + 32 * c);
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) sr[lane + 32 * c] = x[c];
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < BM; ++c) {
      float p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = s_s[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float v = v_s[c * SD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] += p[i] * v;
      }
    }
  }
  // a row that saw a visible key has l >= 1 (its largest score counts
  // exp(0)); a row that saw none (a chunk placed past it) has l = 0 and
  // gets o = 0, lse = NEG_INF, as the JAX chunk kernel writes
  __syncthreads();  // m_s, l_s as initialized when no kv tile was walked
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const float l = l_s[r];
    T* dst = a.o.at(b, h, q0 + r) + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store(dst + 16 * j, l > 0.f ? acc[i][j] / l : 0.f);
  }
  for (int r = tid; r < BM; r += kThreads) {
    const float l = l_s[r];
    *a.lse.at(b, h, q0 + r) = l > 0.f ? m_s[r] + logf(l) : kNegInf;
  }
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(kThreads) dkv_kernel(BwdArgs<T> a) {
  constexpr int SD = D + 1, SS = BM + 1, R = BM / 16, NJ = D / 16;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BM, kpos0 = a.off.k + k0;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  extern __shared__ float smem[];
  float* k_s = smem;             // BM x SD
  float* v_s = k_s + BM * SD;    // BM x SD
  float* q_s = v_s + BM * SD;    // BM x SD
  float* do_s = q_s + BM * SD;   // BM x SD
  float* p_s = do_s + BM * SD;   // BM x SS: p * z
  float* ds_s = p_s + BM * SS;   // BM x SS: ds
  float* lse_s = ds_s + BM * SS;
  float* dl_s = lse_s + BM;

  load_tile<T, D, BM>(a.k.at(b, h, k0), a.k.sr, k_s);
  load_tile<T, D, BM>(a.v.at(b, h, k0), a.v.sr, v_s);
  const uint32_t hh = a.dp.head(a.off.bh + b * a.H + h);
  float dk[R][NJ], dv[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_q = a.Tq / BM;
  for (int qt = first_q_tile<BM>(a.causal, kpos0, a.off.q, n_q); qt < n_q;
       ++qt) {
    const int q0 = qt * BM, qpos0 = a.off.q + q0;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D, BM>(a.q.at(b, h, q0), a.q.sr, q_s);
    load_tile<T, D, BM>(a.dout.at(b, h, q0), a.dout.sr, do_s);
    for (int r = tid; r < BM; r += kThreads) {
      lse_s[r] = *a.lse.at(b, h, q0 + r);
      dl_s[r] = *a.delta.at(b, h, q0 + r);
    }
    __syncthreads();
    bwd_scores<D, BM>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, qpos0,
                      kpos0, a.causal && qpos0 - kpos0 < BM - 1, a.scale,
                      a.dp, hh, tx, ty);
    __syncthreads();
    // dV += (p z)^T dO, dK += ds^T Q: rows of the kv tile
    for (int q = 0; q < BM; ++q) {
      float pk[R], sk[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pk[i] = p_s[q * SS + ty + 16 * i];
        sk[i] = ds_s[q * SS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float g = do_s[q * SD + tx + 16 * j];
        const float x = q_s[q * SD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv[i][j] += pk[i] * g;
          dk[i][j] += sk[i] * x;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    T* dkr = a.dk.at(b, h, k0 + r) + tx;
    T* dvr = a.dv.at(b, h, k0 + r) + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store(dkr + 16 * j, dk[i][j]);
      store(dvr + 16 * j, dv[i][j]);
    }
  }
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs<T> a) {
  constexpr int SD = D + 1, SS = BM + 1, R = BM / 16, NJ = D / 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM, qpos0 = a.off.q + q0;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  extern __shared__ float smem[];
  float* q_s = smem;             // BM x SD
  float* do_s = q_s + BM * SD;   // BM x SD
  float* k_s = do_s + BM * SD;   // BM x SD
  float* v_s = k_s + BM * SD;    // BM x SD
  float* ds_s = v_s + BM * SD;   // BM x SS
  float* lse_s = ds_s + BM * SS;
  float* dl_s = lse_s + BM;

  load_tile<T, D, BM>(a.q.at(b, h, q0), a.q.sr, q_s);
  load_tile<T, D, BM>(a.dout.at(b, h, q0), a.dout.sr, do_s);
  for (int r = tid; r < BM; r += kThreads) {
    lse_s[r] = *a.lse.at(b, h, q0 + r);
    dl_s[r] = *a.delta.at(b, h, q0 + r);
  }
  const uint32_t hh = a.dp.head(a.off.bh + b * a.H + h);
  float dq[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  const int n_kv = kv_tiles<BM>(a.causal, qpos0, a.off.k, a.Tk / BM);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int kpos0 = a.off.k + kt * BM;
    __syncthreads();  // the last tile's readers of k_s, ds_s are done
    load_tile<T, D, BM>(a.k.at(b, h, kt * BM), a.k.sr, k_s);
    load_tile<T, D, BM>(a.v.at(b, h, kt * BM), a.v.sr, v_s);
    __syncthreads();
    // p * z is not needed here: ds_s doubles as the p_s scratch, and is
    // then overwritten by ds in the same call
    bwd_scores<D, BM>(q_s, do_s, k_s, v_s, lse_s, dl_s, ds_s, ds_s, qpos0,
                      kpos0, a.causal && qpos0 - kpos0 < BM - 1, a.scale,
                      a.dp, hh, tx, ty);
    __syncthreads();
    // dQ += ds K
    for (int c = 0; c < BM; ++c) {
      float sq[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sq[i] = ds_s[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = k_s[c * SD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) dq[i][j] += sq[i] * x;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    T* dst = a.dq.at(b, h, q0 + r) + tx;
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
int fwd_launch(const FwdArgs<T>& a, int B, cudaStream_t stream) {
  constexpr int BM = kTile;
  const size_t smem = fwd_smem_floats<D, BM>() * sizeof(float);
  auto kernel = fwd_kernel<T, D, BM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.Tq / BM, a.H, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_launch(const BwdArgs<T>& a, int B, cudaStream_t stream) {
  constexpr int BM = bwd_rows<D>();
  const size_t smem_kv = dkv_smem_floats<D, BM>() * sizeof(float);
  auto kv = dkv_kernel<T, D, BM>;
  cudaError_t err = allow_smem(kv, smem_kv);
  if (err != cudaSuccess) return (int)err;
  kv<<<dim3(a.Tk / BM, a.H, B), kThreads, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_q = dq_smem_floats<D, BM>() * sizeof(float);
  auto q = dq_kernel<T, D, BM>;
  err = allow_smem(q, smem_q);
  if (err != cudaSuccess) return (int)err;
  q<<<dim3(a.Tq / BM, a.H, B), kThreads, smem_q, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_dispatch(const FwdArgs<T>& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return fwd_launch<T, 32>(a, B, s);
    case 64: return fwd_launch<T, 64>(a, B, s);
    case 128: return fwd_launch<T, 128>(a, B, s);
    case 256: return fwd_launch<T, 256>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_dispatch(const BwdArgs<T>& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return bwd_launch<T, 32>(a, B, s);
    case 64: return bwd_launch<T, 64>(a, B, s);
    case 128: return bwd_launch<T, 128>(a, B, s);
    case 256: return bwd_launch<T, 256>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename P>
View<P> view(P* p, long long sb, long long sh, long long sr) {
  return View<P>{p, sb, sh, sr};
}

// (B, T, 3C) packed q/k/v and d(qkv) strips at column `col`, merged
// (B, T, C) o/dO, (B, T, H) lse/delta
template <typename P>
View<P> packed(P* base, long long col, int Tlen, int H, int D) {
  const long long C = (long long)H * D;
  return view(base + col, Tlen * 3 * C, (long long)D, 3 * C);
}
template <typename P>
View<P> merged(P* base, int Tlen, int H, int D) {
  const long long C = (long long)H * D;
  return view(base, Tlen * C, (long long)D, C);
}
template <typename P>
View<P> packed_stats(P* base, int Tlen, int H) {
  return view(base, (long long)Tlen * H, 1LL, (long long)H);
}
// (B, H, T, D) tensors, (B, H, T) lse/delta
template <typename P>
View<P> heads(P* base, int Tlen, int H, int D) {
  return view(base, (long long)H * Tlen * D, (long long)Tlen * D,
              (long long)D);
}
template <typename P>
View<P> heads_stats(P* base, int Tlen, int H) {
  return view(base, (long long)H * Tlen, (long long)Tlen, 1LL);
}

template <typename T>
int packed_fwd(const void* qkv, void* out, void* lse, int B, int Tlen,
               int H, int D, float scale, Dropout dp, cudaStream_t s) {
  const T* x = static_cast<const T*>(qkv);
  const long long C = (long long)H * D;
  FwdArgs<T> a{packed(x, 0, Tlen, H, D), packed(x, C, Tlen, H, D),
               packed(x, 2 * C, Tlen, H, D),
               merged(static_cast<T*>(out), Tlen, H, D),
               packed_stats(static_cast<float*>(lse), Tlen, H),
               Tlen, Tlen, H, 1, Offsets{0, 0, 0}, scale, dp};
  return fwd_dispatch(a, B, D, s);
}

template <typename T>
int packed_bwd(const void* qkv, const void* dout, const void* lse,
               const void* delta, void* dqkv, int B, int Tlen, int H, int D,
               float scale, Dropout dp, cudaStream_t s) {
  const T* x = static_cast<const T*>(qkv);
  T* dx = static_cast<T*>(dqkv);
  const long long C = (long long)H * D;
  BwdArgs<T> a{packed(x, 0, Tlen, H, D), packed(x, C, Tlen, H, D),
               packed(x, 2 * C, Tlen, H, D),
               merged(static_cast<const T*>(dout), Tlen, H, D),
               packed_stats(static_cast<const float*>(lse), Tlen, H),
               packed_stats(static_cast<const float*>(delta), Tlen, H),
               packed(dx, 0, Tlen, H, D), packed(dx, C, Tlen, H, D),
               packed(dx, 2 * C, Tlen, H, D), Tlen, Tlen, H, 1,
               Offsets{0, 0, 0}, scale, dp};
  return bwd_dispatch(a, B, D, s);
}

// (B, H, Tq, D) q, o, dO, dq; (B, H, Tk, D) k, v, dk, dv; (B, H, Tq) lse,
// delta: the heads entry points (Tq = Tk, zero offsets) and the chunk ones
template <typename T>
int chunk_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Tq, int Tk, int H, int D, float scale,
              int causal, Offsets off, Dropout dp, cudaStream_t s) {
  FwdArgs<T> a{heads(static_cast<const T*>(q), Tq, H, D),
               heads(static_cast<const T*>(k), Tk, H, D),
               heads(static_cast<const T*>(v), Tk, H, D),
               heads(static_cast<T*>(out), Tq, H, D),
               heads_stats(static_cast<float*>(lse), Tq, H),
               Tq, Tk, H, causal, off, scale, dp};
  return fwd_dispatch(a, B, D, s);
}

template <typename T>
int chunk_bwd(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int B, int Tq, int Tk, int H, int D, float scale,
              int causal, Offsets off, Dropout dp, cudaStream_t s) {
  BwdArgs<T> a{heads(static_cast<const T*>(q), Tq, H, D),
               heads(static_cast<const T*>(k), Tk, H, D),
               heads(static_cast<const T*>(v), Tk, H, D),
               heads(static_cast<const T*>(dout), Tq, H, D),
               heads_stats(static_cast<const float*>(lse), Tq, H),
               heads_stats(static_cast<const float*>(delta), Tq, H),
               heads(static_cast<T*>(dq), Tq, H, D),
               heads(static_cast<T*>(dk), Tk, H, D),
               heads(static_cast<T*>(dv), Tk, H, D), Tq, Tk, H, causal,
               off, scale, dp};
  return bwd_dispatch(a, B, D, s);
}

int chunk_fwd_typed(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int Tq, int Tk, int H, int D,
                    float scale, int causal, Offsets off, Dropout dp,
                    int dtype, cudaStream_t s) {
  if (dtype == 0)
    return chunk_fwd<float>(q, k, v, out, lse, B, Tq, Tk, H, D, scale,
                            causal, off, dp, s);
  if (dtype == 1)
    return chunk_fwd<__nv_bfloat16>(q, k, v, out, lse, B, Tq, Tk, H, D,
                                    scale, causal, off, dp, s);
  return (int)cudaErrorInvalidValue;
}

int chunk_bwd_typed(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                    int H, int D, float scale, int causal, Offsets off,
                    Dropout dp, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return chunk_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, Tq,
                            Tk, H, D, scale, causal, off, dp, s);
  if (dtype == 1)
    return chunk_bwd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv,
                                    B, Tq, Tk, H, D, scale, causal, off, dp,
                                    s);
  return (int)cudaErrorInvalidValue;
}

bool shape_ok(int B, int Tlen, int H) {
  return B > 0 && Tlen > 0 && Tlen % kTile == 0 && H > 0 && H <= 65535 &&
         B <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128, 256}; T a
// multiple of 64. `dropout` 0 turns the mask off (seed, threshold, keep
// unused). The packed entry points are causal.
extern "C" int flash_packed_fwd_launch(const void* qkv, void* out,
                                       void* lse, int B, int Tlen, int H,
                                       int D, float scale, unsigned seed,
                                       unsigned threshold, float keep,
                                       int dropout, int dtype,
                                       void* stream) {
  if (!shape_ok(B, Tlen, H)) return (int)cudaErrorInvalidValue;
  const Dropout dp{dropout, seed, threshold, keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return packed_fwd<float>(qkv, out, lse, B, Tlen, H, D, scale, dp, s);
  if (dtype == 1)
    return packed_fwd<__nv_bfloat16>(qkv, out, lse, B, Tlen, H, D, scale,
                                     dp, s);
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
  if (dtype == 0)
    return packed_bwd<float>(qkv, dout, lse, delta, dqkv, B, Tlen, H, D,
                             scale, dp, s);
  if (dtype == 1)
    return packed_bwd<__nv_bfloat16>(qkv, dout, lse, delta, dqkv, B, Tlen,
                                     H, D, scale, dp, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_heads_fwd_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Tlen, int H, int D,
                                      float scale, int causal,
                                      unsigned seed, unsigned threshold,
                                      float keep, int dropout, int dtype,
                                      void* stream) {
  if (!shape_ok(B, Tlen, H)) return (int)cudaErrorInvalidValue;
  return chunk_fwd_typed(q, k, v, out, lse, B, Tlen, Tlen, H, D, scale,
                         causal, Offsets{0, 0, 0},
                         Dropout{dropout, seed, threshold, keep}, dtype,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int flash_heads_bwd_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int B,
                                      int Tlen, int H, int D, float scale,
                                      int causal, unsigned seed,
                                      unsigned threshold, float keep,
                                      int dropout, int dtype,
                                      void* stream) {
  if (!shape_ok(B, Tlen, H)) return (int)cudaErrorInvalidValue;
  return chunk_bwd_typed(q, k, v, dout, lse, delta, dq, dk, dv, B, Tlen,
                         Tlen, H, D, scale, causal, Offsets{0, 0, 0},
                         Dropout{dropout, seed, threshold, keep}, dtype,
                         static_cast<cudaStream_t>(stream));
}

// The chunk entry points (ops/flash_chunk.py): a (B, H, Tq, D) q-chunk
// against a (B, H, Tk, D) kv-chunk, q row r at global position q_off + r
// and k row c at k_off + c (causal: visible iff q_off + r >= k_off + c),
// the dropout hash keyed on bh_off + b * H + h at global positions. The
// backward takes the lse clamped to >= NEG_INF / 2 and delta' =
// rowsum(dO * O) - dlse. Tq and Tk multiples of 64.
extern "C" int flash_chunk_fwd_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Tq, int Tk, int H, int D,
                                      float scale, int causal, int q_off,
                                      int k_off, int bh_off, unsigned seed,
                                      unsigned threshold, float keep,
                                      int dropout, int dtype, void* stream) {
  if (!shape_ok(B, Tq, H) || !shape_ok(B, Tk, H))
    return (int)cudaErrorInvalidValue;
  return chunk_fwd_typed(q, k, v, out, lse, B, Tq, Tk, H, D, scale, causal,
                         Offsets{q_off, k_off, bh_off},
                         Dropout{dropout, seed, threshold, keep}, dtype,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int flash_chunk_bwd_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int B,
                                      int Tq, int Tk, int H, int D,
                                      float scale, int causal, int q_off,
                                      int k_off, int bh_off, unsigned seed,
                                      unsigned threshold, float keep,
                                      int dropout, int dtype, void* stream) {
  if (!shape_ok(B, Tq, H) || !shape_ok(B, Tk, H))
    return (int)cudaErrorInvalidValue;
  return chunk_bwd_typed(q, k, v, dout, lse, delta, dq, dk, dv, B, Tq, Tk,
                         H, D, scale, causal, Offsets{q_off, k_off, bh_off},
                         Dropout{dropout, seed, threshold, keep}, dtype,
                         static_cast<cudaStream_t>(stream));
}
