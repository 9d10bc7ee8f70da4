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
// softmax statistics and every accumulator are f32. `scale` multiplies
// the scores.
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
// Two bodies, chosen at compile time by the element type in the
// dispatch (fwd_launch / bwd_launch); neither falls back to the other.
//
// bf16: the tensor-core body. Every product is mma.sync.m16n8k16 (bf16
// operands, f32 accumulators), fed by ldmatrix from shared-memory tiles
// that cp.async fills 16 bytes a copy, double-buffered: the next tile
// loads while this one multiplies. It rounds where the JAX kernels round
// (flash_pallas._fwd_tile, _dq_tile, _dkv_tile) and the plain versions
// with them (ops/flash_packed.attention_ref, attention_bwd_ref): the
// forward's probabilities p z, taken from the running max of each
// 64-key tile (kTile, the plain forward's TILE), go to bf16 straight
// from the score accumulators into the A fragments of P V; the backward
// rounds p z before dV and ds before dK and dQ. The elementwise steps
// that feed a rounding are __fmul_rn / __fsub_rn and exp(x) = 2^(x log2
// e) (exp_; torch.exp2 in the plain versions) in the plain versions'
// order, so that equal scores round equally.
// - forward: one block of 4 warps per (q tile of 64 rows, head, batch),
//   16 rows a warp; S = Q K^T, the row max and sum over the quad
//   (__shfl_xor_sync 1, 2), P V into 16 x D f32 accumulators a warp;
//   causal q tiles walk heaviest first (reverse order) so the grid's
//   tail is short.
// - every kernel decides per warp, for a tile pair, whether its 16 rows
//   (keys) meet no visible pair (it adds nothing and skips the tile) or
//   some masked pair (the masked loop), and runs the elementwise loops
//   specialized on that and on dropout (Flag, with_flags): the diagonal
//   and the dropout hash cost only where they apply.
// - backward: two kernels, no atomics, so the result is deterministic.
//   dkv_tc_kernel: one block per (kv tile, head, batch), 16 keys a warp,
//   computes S^T = K Q^T and dP^T = V dO^T with keys as rows, so p z and
//   ds go from accumulators to A fragments of dV += (p z)^T dO and dK +=
//   ds^T Q without shared memory. dq_tc_kernel: one block per q tile,
//   S, dP, then dQ += ds K. Both recompute p = exp(s scale - lse).
//   Accumulators that would not fit the registers are split over column
//   chunks of D, one block each, which recompute S (and dP): dkv keeps 64
//   columns of dK and dV (D = 128, 256: 2 and 4 chunks), dq 128 of dQ
//   and the forward 128 of O (D = 256: 2 chunks). At D = 256 every tile
//   stays 64 rows: the largest block takes ~200 KB of the 227 KB of
//   shared memory.
// Shared-memory rows are padded to D + 8 elements, which keeps ldmatrix
// free of bank conflicts.
//
// f32: the CUDA-core body (the first version, kept for f32: tensor cores
// multiply f32 only as TF32, and the f32 parity phases lean on its
// exactness). BM-row tiles (64; 32 for the D=256 backward, whose 64-row
// f32 tiles would need ~297 KB of shared memory), 256 threads as a 16 x
// 16 grid, each thread owning a BM/16 x BM/16 (score tile) or BM/16 x
// D/16 (output tile) micro-tile at rows ty + 16i, columns tx + 16j, row
// stride D + 1 floats; the same walks and the same two-kernel backward.
//
// Bound on this card: at GPT-2 XL's shapes (B=16, H=25, T=1024, D=64,
// bf16, causal) the forward moves ~210 MB (63 us at 3.35 TB/s) against
// 5.4e10 FLOP (54 us at 989 TFLOP/s): bytes bound it; the backward
// (5 products, 1.4e11 FLOP, 136 us) is bound by its operations. A ring
// hop of GPT-2 XL split 4 ways (B=16, H=25, Tq=Tk=256, D=64, bf16) moves
// ~53 MB forward and ~93 MB backward (~16 and ~28 us) against 6.7 and
// 16.8 GFLOP on a fully visible hop (7 and 17 us): bytes bound both.
// mma.sync reaches a fraction of the card's dense rate (that takes
// wgmma); the backward's two kernels also recompute S and dP, 7 products
// for the 5 the bound counts, the price of no atomics.
//
// ptxas (CUDA 12.8, sm_90a, -Xptxas -v) and the dynamic shared memory a
// block takes, at D = 32 / 64 / 128 / 256:
// - fwd_tc_kernel: 128 / 128 / 228 / 254 registers; 25.0 / 45.0 / 85.0 /
//   165.0 KB;
// - dkv_tc_kernel: 168 / 168 / 242 / 255 registers; dq_tc_kernel: 128 /
//   168 / 250 / 255; both 31.5 / 55.5 / 103.5 / 199.5 KB.
// Spills: 8 bytes (fwd_tc_kernel<64>) and 20 bytes (dkv_tc_kernel<64>)
// go to local memory under the register caps that let an SM hold 4 and
// 3 of those blocks (fwd_min_blocks, dkv_min_blocks), which the card
// measured faster than the same kernels without a cap and without
// spills; nothing else spills. The f32 body: 48-128 registers, none
// spilled.
//
// Plain C interface (ctypes); each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the CUDA-core body's blocks
constexpr int kWarps = kThreads / 32;
// rows of a tile and keys of a forward step (the plain versions' TILE);
// T is a multiple
constexpr int kTile = 64;
constexpr float kNegInf = -1e30f;

// rows of a CUDA-core backward tile: 32 at D=256 (shared memory), else 64
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

// ---------------------------------------------------------------------
// The CUDA-core body (f32)
// ---------------------------------------------------------------------

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

// BM rows of D floats, row r at src + r * stride, into dst (row stride
// D + 1), 16 bytes per thread per load.
template <int D, int BM>
__device__ __forceinline__ void load_tile(const float* src, long long stride,
                                          float* dst) {
  constexpr int VPR = D / 4;
  for (int e = threadIdx.x; e < BM * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + r * stride + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
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

template <int D, int BM>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FwdArgs<float> a) {
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

  load_tile<D, BM>(a.q.at(b, h, q0), a.q.sr, q_s);
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
    load_tile<D, BM>(a.k.at(b, h, k0), a.k.sr, k_s);
    load_tile<D, BM>(a.v.at(b, h, k0), a.v.sr, v_s);
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
    float* dst = a.o.at(b, h, q0 + r) + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dst[16 * j] = l > 0.f ? acc[i][j] / l : 0.f;
  }
  for (int r = tid; r < BM; r += kThreads) {
    const float l = l_s[r];
    *a.lse.at(b, h, q0 + r) = l > 0.f ? m_s[r] + logf(l) : kNegInf;
  }
}

template <int D, int BM>
__global__ void __launch_bounds__(kThreads) dkv_kernel(BwdArgs<float> a) {
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

  load_tile<D, BM>(a.k.at(b, h, k0), a.k.sr, k_s);
  load_tile<D, BM>(a.v.at(b, h, k0), a.v.sr, v_s);
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
    load_tile<D, BM>(a.q.at(b, h, q0), a.q.sr, q_s);
    load_tile<D, BM>(a.dout.at(b, h, q0), a.dout.sr, do_s);
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
    float* dkr = a.dk.at(b, h, k0 + r) + tx;
    float* dvr = a.dv.at(b, h, k0 + r) + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkr[16 * j] = dk[i][j];
      dvr[16 * j] = dv[i][j];
    }
  }
}

template <int D, int BM>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs<float> a) {
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

  load_tile<D, BM>(a.q.at(b, h, q0), a.q.sr, q_s);
  load_tile<D, BM>(a.dout.at(b, h, q0), a.dout.sr, do_s);
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
    load_tile<D, BM>(a.k.at(b, h, kt * BM), a.k.sr, k_s);
    load_tile<D, BM>(a.v.at(b, h, kt * BM), a.v.sr, v_s);
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
    float* dst = a.dq.at(b, h, q0 + r) + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[16 * j] = dq[i][j];
  }
}

// ---------------------------------------------------------------------
// The tensor-core body (bf16)
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps of 16 rows (or keys) each

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b on one m16n8k16 tile: bf16 operands, f32 accumulators. Lane
// l = 4 g + t holds c[0], c[1] at row g, columns 2t, 2t + 1 and c[2],
// c[3] at row g + 8; a[0..3] at (row g, k 2t..), (g + 8, 2t..), (g,
// 2t + 8..), (g + 8, 2t + 8..); b0, b1 at (k 2t.., column g), (k 2t +
// 8.., g).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 to a bf16x2 register (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of a 16 x 64 product operand from the accumulators of
// the 16 x 64 tile that produced it (8 n8 tiles): k step kk takes n
// tiles 2 kk and 2 kk + 1, rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&c)[8][4],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// A shared-memory tile: kTile rows of D bf16, row stride D + 8 elements
// (16 bytes of padding: 8 consecutive rows start in 8 different 16-byte
// bank groups, so ldmatrix is conflict-free).
template <int D>
struct Tile {
  static constexpr int SD = D + 8;
  static constexpr int kElems = kTile * SD;

  // rows of src (row stride `stride` elements) into dst, 16 bytes a copy
  static __device__ __forceinline__ void load(bf16* dst, const bf16* src,
                                              long long stride) {
    constexpr int CPR = D / 8, N = kTile * CPR / kTcThreads;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * kTcThreads;
      const int r = e / CPR, c = (e % CPR) * 8;
      cp_async16(dst + r * SD + c, src + r * stride + c);
    }
  }
  // A fragment of rows row0.., columns col0.. (16 x 16)
  static __device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                                const bf16* t, int row0,
                                                int col0, int lane) {
    ldsm_x4(a, t + (row0 + (lane & 15)) * SD + col0 + (lane >> 4) * 8);
  }
  // B fragments of two n8 tiles (b[0], b[1]: n0..; b[2], b[3]: n0 + 8..)
  // at k0.. from a tile whose rows are n (the score products Q K^T)
  static __device__ __forceinline__ void b_rows_n(uint32_t (&b)[4],
                                                  const bf16* t, int n0,
                                                  int k0, int lane) {
    const int m = lane >> 3;
    ldsm_x4(b, t + (n0 + (m >> 1) * 8 + (lane & 7)) * SD + k0 + (m & 1) * 8);
  }
  // the same from a tile whose rows are k (P V, dS K and the like)
  static __device__ __forceinline__ void b_rows_k(uint32_t (&b)[4],
                                                  const bf16* t, int k0,
                                                  int n0, int lane) {
    const int m = lane >> 3;
    ldsm_x4_trans(b,
                  t + (k0 + (m & 1) * 8 + (lane & 7)) * SD + n0 + (m >> 1) * 8);
  }
};

// c[0..NS) += rows row0.. of A (16 x D) times the kTile rows of Bn (as
// n), over D: S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T
template <int D>
__device__ __forceinline__ void score_tile(float (&c)[8][4], const bf16* A,
                                           int row0, const bf16* Bn,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    Tile<D>::a_frag(a, A, row0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      Tile<D>::b_rows_n(b, Bn, np * 16, kk * 16, lane);
      mma_bf16(c[2 * np], a, b[0], b[1]);
      mma_bf16(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// c[0..NO) += P (16 x kTile, as A fragments) times the kTile rows of Bk
// (as k), columns d0 .. d0 + 8 NO: O += P V, dQ += dS K, dV += (p z)^T
// dO, dK += ds^T Q
template <int D, int NO>
__device__ __forceinline__ void value_tile(float (&c)[NO][4],
                                           const uint32_t (&p)[4][4],
                                           const bf16* Bk, int d0,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t b[4];
      Tile<D>::b_rows_k(b, Bk, kk * 16, d0 + np * 16, lane);
      mma_bf16(c[2 * np], p[kk], b[0], b[1]);
      mma_bf16(c[2 * np + 1], p[kk], b[2], b[3]);
    }
}

// exp(x) as the tensor-core body and the plain versions take it:
// exp2(x log2 e) in f32, the product rounded, then one MUFU.EX2 (expf
// takes a dozen instructions). It equals torch.exp2 of the same product
// except below 2^-126, which it flushes to 0: such a p adds under 1e-38
// to any sum.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, kLog2e)));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// columns of the O / dQ / dK / dV accumulators one block keeps: the rest
// of D goes to other blocks (see the note at the top)
template <int D>
__host__ __device__ constexpr int fwd_cols() {
  return D < 128 ? D : 128;
}
template <int D>
__host__ __device__ constexpr int dkv_cols() {
  return D < 64 ? D : 64;
}
template <int D>
__host__ __device__ constexpr int dq_cols() {
  return D < 128 ? D : 128;
}

// blocks an SM should hold at D <= 64 (the main paths' heads), which caps
// the registers a thread at 65536 / (128 x blocks): 4 forward blocks (128
// registers), 3 dkv blocks (170); larger D keeps what it needs
template <int D>
__host__ __device__ constexpr int fwd_min_blocks() {
  return D <= 64 ? 4 : 1;
}
template <int D>
__host__ __device__ constexpr int dkv_min_blocks() {
  return D <= 64 ? 3 : 1;
}

template <int D>
constexpr size_t fwd_tc_smem() {  // Q, 2 K and 2 V buffers
  return 5 * (size_t)Tile<D>::kElems * sizeof(bf16);
}
template <int D>
constexpr size_t bwd_tc_smem() {  // 2 fixed tiles, 2 x 2 streamed ones
  return 6 * (size_t)Tile<D>::kElems * sizeof(bf16) +
         2 * 3 * kTile * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, fwd_min_blocks<D>())
    fwd_tc_kernel(FwdArgs<bf16> a) {
  using TL = Tile<D>;
  constexpr int DC = fwd_cols<D>(), NC = D / DC, NO = DC / 8;
  const int n_q = a.Tq / kTile;
  const int tile = blockIdx.x / NC, d0 = (blockIdx.x % NC) * DC;
  const int qt = a.causal ? n_q - 1 - tile : tile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile, qpos0 = a.off.q + q0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, g = lane >> 2;
  const int r0 = warp * 16 + g;  // this thread's rows r0, r0 + 8

  extern __shared__ uint4 tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* k_s = q_s + TL::kElems;      // 2 buffers
  bf16* v_s = k_s + 2 * TL::kElems;  // 2 buffers

  const Dropout& dp = a.dp;
  const uint32_t hh = dp.head(a.off.bh + b * a.H + h);
  const uint32_t rh[2] = {dp.row(hh, qpos0 + r0), dp.row(hh, qpos0 + r0 + 8)};
  float o[NO][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_kv = kv_tiles<kTile>(a.causal, qpos0, a.off.k, a.Tk / kTile);
  TL::load(q_s, a.q.at(b, h, q0), a.q.sr);
  if (n_kv > 0) {
    TL::load(k_s, a.k.at(b, h, 0), a.k.sr);
    TL::load(v_s, a.v.at(b, h, 0), a.v.sr);
  }
  cp_async_commit();
  for (int kt = 0; kt < n_kv; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kv) {
      const int k1 = (kt + 1) * kTile;
      TL::load(k_s + (buf ^ 1) * TL::kElems, a.k.at(b, h, k1), a.k.sr);
      TL::load(v_s + (buf ^ 1) * TL::kElems, a.v.at(b, h, k1), a.v.sr);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kpos0 = a.off.k + kt * kTile;
    // key c is past this warp's row w iff c - w > d; none of its 16 rows
    // sees a key of the tile when d < -15 (a tile that adds nothing: p = 0,
    // m and l unchanged), and only a tile with d < kTile - 1 has such a
    // pair (with zero offsets: the diagonal)
    const int d = qpos0 + warp * 16 - kpos0;
    if (!(a.causal && d < -15)) {
      const bf16* ks = k_s + buf * TL::kElems;
      const bf16* vs = v_s + buf * TL::kElems;
      float s[8][4] = {};
      score_tile<D>(s, q_s, warp * 16, ks, lane);
      float mx[2] = {kNegInf, kNegInf};
      if (a.causal && d < kTile - 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int w = g + (e >> 1) * 8, c = j * 8 + 2 * t + (e & 1);
            s[j][e] = c - w > d ? kNegInf : __fmul_rn(s[j][e], a.scale);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = __fmul_rn(s[j][e], a.scale);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      }
      // p = exp(x - m), summed into l before dropout, then p z for the
      // product. While a row has seen no visible key, m and all its
      // scores are the mask value, and exp(x - m) would count each masked
      // key as 1: it subtracts 0 instead, which gives exp(NEG_INF) = 0
      float alpha[2], msub[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = exp_(__fsub_rn(m[i], m_new));
        m[i] = m_new;
        msub[i] = m_new == kNegInf ? 0.f : m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          s[j][e] = exp_(__fsub_rn(s[j][e], msub[i]));
          l[i] += s[j][e];
        }
      if (dp.on) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = __fmul_rn(
                s[j][e], dp.mult(rh[e >> 1], kpos0 + j * 8 + 2 * t + (e & 1)));
      }
      uint32_t pa[4][4];
      acc_to_a(s, pa);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      value_tile<D, NO>(o, pa, vs, d0, lane);
    }
    __syncthreads();  // this tile's readers are done before its reload
  }
  cp_async_wait<0>();  // Q's copy is still in flight where no tile was walked
  // a row that saw a visible key has l >= 1 (its largest score counts
  // exp(0)); a row that saw none (a chunk placed past it) has l = 0 and
  // gets o = 0, lse = NEG_INF, as the JAX chunk kernel writes
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    const int row = q0 + r0 + 8 * i;
    bf16* dst = a.o.at(b, h, row) + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          li > 0.f ? pack_bf16(o[n][2 * i] / li, o[n][2 * i + 1] / li) : 0u;
    if (t == 0 && d0 == 0)
      *a.lse.at(b, h, row) = li > 0.f ? m[i] + logf(li) : kNegInf;
  }
}

// a flag known at compile time
template <bool B>
struct Flag {
  __host__ __device__ constexpr operator bool() const { return B; }
};

// f(x, y) with x and y as Flag<true> / Flag<false>, so that each
// combination of two flags uniform over a loop compiles to its own loop
template <typename F>
__device__ __forceinline__ void with_flags(bool x, bool y, F&& f) {
  if (x) {
    if (y) f(Flag<true>{}, Flag<true>{});
    else f(Flag<true>{}, Flag<false>{});
  } else {
    if (y) f(Flag<false>{}, Flag<true>{});
    else f(Flag<false>{}, Flag<false>{});
  }
}

// ds = p (dp z - delta) scale and p z for one score element, in the
// plain version's order (attention_bwd_ref)
__device__ __forceinline__ void bwd_elem(float& s, float& g, bool masked,
                                         float scale, float lse,
                                         float delta, float z, bool drop) {
  const float p = masked ? 0.f : exp_(__fsub_rn(__fmul_rn(s, scale), lse));
  const float gz = drop ? __fmul_rn(g, z) : g;
  s = drop ? __fmul_rn(p, z) : p;
  g = __fmul_rn(__fmul_rn(p, __fsub_rn(gz, delta)), scale);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, dkv_min_blocks<D>())
    dkv_tc_kernel(BwdArgs<bf16> a) {
  using TL = Tile<D>;
  constexpr int DC = dkv_cols<D>(), NC = D / DC, NO = DC / 8;
  const int kt = blockIdx.x / NC, d0 = (blockIdx.x % NC) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile, kpos0 = a.off.k + k0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, kr0 = warp * 16 + (lane >> 2);  // keys kr0, +8

  extern __shared__ uint4 tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* v_s = k_s + TL::kElems;
  bf16* q_s = v_s + TL::kElems;       // 2 buffers
  bf16* do_s = q_s + 2 * TL::kElems;  // 2 buffers
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * TL::kElems);  // 2 x 64
  float* dl_s = lse_s + 2 * kTile;                                 // 2 x 64
  uint32_t* rh_s = reinterpret_cast<uint32_t*>(dl_s + 2 * kTile);  // 2 x 64

  const Dropout& dp = a.dp;
  const uint32_t hh = dp.head(a.off.bh + b * a.H + h);
  // a q tile's rows, their lse, delta and dropout row hashes into buffer
  auto load_q = [&](int qt, int buf) {
    const int q0 = qt * kTile;
    TL::load(q_s + buf * TL::kElems, a.q.at(b, h, q0), a.q.sr);
    TL::load(do_s + buf * TL::kElems, a.dout.at(b, h, q0), a.dout.sr);
    const int r = threadIdx.x;
    if (r < kTile) {
      lse_s[buf * kTile + r] = *a.lse.at(b, h, q0 + r);
      dl_s[buf * kTile + r] = *a.delta.at(b, h, q0 + r);
      rh_s[buf * kTile + r] = dp.row(hh, a.off.q + q0 + r);
    }
  };
  float dk[NO][4] = {}, dv[NO][4] = {};
  const int n_q = a.Tq / kTile;
  const int qt0 = first_q_tile<kTile>(a.causal, kpos0, a.off.q, n_q);
  TL::load(k_s, a.k.at(b, h, k0), a.k.sr);
  TL::load(v_s, a.v.at(b, h, k0), a.v.sr);
  if (qt0 < n_q) load_q(qt0, 0);
  cp_async_commit();
  for (int qt = qt0; qt < n_q; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < n_q) {
      load_q(qt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = q_s + buf * TL::kElems;
    const bf16* dos = do_s + buf * TL::kElems;
    const float* lse = lse_s + buf * kTile;
    const float* dl = dl_s + buf * kTile;
    const uint32_t* rh = rh_s + buf * kTile;
    // this warp's key w is past q row c of the tile iff w - c > dw: no row
    // sees any of its 16 keys when dw < -(kTile - 1) (nothing to add), and
    // only dw < 15 has such a pair
    const int dw = a.off.q + qt * kTile - kpos0 - warp * 16;
    if (!(a.causal && dw < 1 - kTile)) {
      // S^T and dP^T: the warp's 16 keys against the tile's 64 q rows
      float s[8][4] = {}, g[8][4] = {};
      score_tile<D>(s, k_s, warp * 16, qs, lane);
      score_tile<D>(g, v_s, warp * 16, dos, lane);
      with_flags(a.causal && dw < 15, dp.on, [&](auto masked, auto drop) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int w = (lane >> 2) + (e >> 1) * 8;
            const int qc = j * 8 + 2 * t + (e & 1);
            const float z =
                drop ? dp.mult(rh[qc], kpos0 + warp * 16 + w) : 1.f;
            bwd_elem(s[j][e], g[j][e], masked && w - qc > dw, a.scale,
                     lse[qc], dl[qc], z, drop);
          }
      });
      uint32_t pa[4][4], sa[4][4];
      acc_to_a(s, pa);  // (p z)^T, bf16
      acc_to_a(g, sa);  // ds^T, bf16
      value_tile<D, NO>(dv, pa, dos, d0, lane);
      value_tile<D, NO>(dk, sa, qs, d0, lane);
    }
    __syncthreads();  // this tile's readers are done before its reload
  }
  cp_async_wait<0>();  // K's and V's copies, where no q tile was walked
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + kr0 + 8 * i;
    bf16* dkr = a.dk.at(b, h, row) + d0 + 2 * t;
    bf16* dvr = a.dv.at(b, h, row) + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * n) =
          pack_bf16(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvr + 8 * n) =
          pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) dq_tc_kernel(BwdArgs<bf16> a) {
  using TL = Tile<D>;
  constexpr int DC = dq_cols<D>(), NC = D / DC, NO = DC / 8;
  const int n_q = a.Tq / kTile;
  const int tile = blockIdx.x / NC, d0 = (blockIdx.x % NC) * DC;
  const int qt = a.causal ? n_q - 1 - tile : tile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile, qpos0 = a.off.q + q0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, r0 = warp * 16 + (lane >> 2);  // rows r0, r0 + 8

  extern __shared__ uint4 tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* do_s = q_s + TL::kElems;
  bf16* k_s = do_s + TL::kElems;     // 2 buffers
  bf16* v_s = k_s + 2 * TL::kElems;  // 2 buffers

  const Dropout& dp = a.dp;
  const uint32_t hh = dp.head(a.off.bh + b * a.H + h);
  float lse[2], dl[2];
  uint32_t rh[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = *a.lse.at(b, h, q0 + r0 + 8 * i);
    dl[i] = *a.delta.at(b, h, q0 + r0 + 8 * i);
    rh[i] = dp.row(hh, qpos0 + r0 + 8 * i);
  }
  float dq[NO][4] = {};
  const int n_kv = kv_tiles<kTile>(a.causal, qpos0, a.off.k, a.Tk / kTile);
  TL::load(q_s, a.q.at(b, h, q0), a.q.sr);
  TL::load(do_s, a.dout.at(b, h, q0), a.dout.sr);
  if (n_kv > 0) {
    TL::load(k_s, a.k.at(b, h, 0), a.k.sr);
    TL::load(v_s, a.v.at(b, h, 0), a.v.sr);
  }
  cp_async_commit();
  for (int kt = 0; kt < n_kv; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kv) {
      const int k1 = (kt + 1) * kTile;
      TL::load(k_s + (buf ^ 1) * TL::kElems, a.k.at(b, h, k1), a.k.sr);
      TL::load(v_s + (buf ^ 1) * TL::kElems, a.v.at(b, h, k1), a.v.sr);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kpos0 = a.off.k + kt * kTile;
    // key c is past this warp's row w iff c - w > dw: the warp's 16 rows
    // see no key of the tile when dw < -15 (nothing to add), and only
    // dw < kTile - 1 has such a pair
    const int dw = qpos0 + warp * 16 - kpos0;
    if (!(a.causal && dw < -15)) {
      const bf16* ks = k_s + buf * TL::kElems;
      const bf16* vs = v_s + buf * TL::kElems;
      float s[8][4] = {}, g[8][4] = {};
      score_tile<D>(s, q_s, warp * 16, ks, lane);
      score_tile<D>(g, do_s, warp * 16, vs, lane);
      with_flags(a.causal && dw < kTile - 1, dp.on,
                 [&](auto masked, auto drop) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int w = (lane >> 2) + i * 8, c = j * 8 + 2 * t + (e & 1);
            const float z = drop ? dp.mult(rh[i], kpos0 + c) : 1.f;
            bwd_elem(s[j][e], g[j][e], masked && c - w > dw, a.scale,
                     lse[i], dl[i], z, drop);
          }
      });
      uint32_t sa[4][4];
      acc_to_a(g, sa);  // ds, bf16
      value_tile<D, NO>(dq, sa, ks, d0, lane);
    }
    __syncthreads();  // this tile's readers are done before its reload
  }
  cp_async_wait<0>();  // Q's and dO's copies, where no kv tile was walked
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* dst = a.dq.at(b, h, q0 + r0 + 8 * i) + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------
// Launches: the element type picks the body
// ---------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename K, typename A>
int launch(K kernel, dim3 grid, int threads, size_t smem, const A& a,
           cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_launch(const FwdArgs<float>& a, int B, cudaStream_t s) {
  constexpr int BM = kTile;
  return launch(fwd_kernel<D, BM>, dim3(a.Tq / BM, a.H, B), kThreads,
                fwd_smem_floats<D, BM>() * sizeof(float), a, s);
}

template <int D>
int fwd_launch(const FwdArgs<bf16>& a, int B, cudaStream_t s) {
  constexpr int NC = D / fwd_cols<D>();
  return launch(fwd_tc_kernel<D>, dim3(a.Tq / kTile * NC, a.H, B),
                kTcThreads, fwd_tc_smem<D>(), a, s);
}

template <int D>
int bwd_launch(const BwdArgs<float>& a, int B, cudaStream_t s) {
  constexpr int BM = bwd_rows<D>();
  const int err =
      launch(dkv_kernel<D, BM>, dim3(a.Tk / BM, a.H, B), kThreads,
             dkv_smem_floats<D, BM>() * sizeof(float), a, s);
  if (err != 0) return err;
  return launch(dq_kernel<D, BM>, dim3(a.Tq / BM, a.H, B), kThreads,
                dq_smem_floats<D, BM>() * sizeof(float), a, s);
}

template <int D>
int bwd_launch(const BwdArgs<bf16>& a, int B, cudaStream_t s) {
  constexpr int NKV = D / dkv_cols<D>(), NQ = D / dq_cols<D>();
  const int err = launch(dkv_tc_kernel<D>, dim3(a.Tk / kTile * NKV, a.H, B),
                         kTcThreads, bwd_tc_smem<D>(), a, s);
  if (err != 0) return err;
  return launch(dq_tc_kernel<D>, dim3(a.Tq / kTile * NQ, a.H, B), kTcThreads,
                bwd_tc_smem<D>(), a, s);
}

template <typename T>
int fwd_dispatch(const FwdArgs<T>& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return fwd_launch<32>(a, B, s);
    case 64: return fwd_launch<64>(a, B, s);
    case 128: return fwd_launch<128>(a, B, s);
    case 256: return fwd_launch<256>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_dispatch(const BwdArgs<T>& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return bwd_launch<32>(a, B, s);
    case 64: return bwd_launch<64>(a, B, s);
    case 128: return bwd_launch<128>(a, B, s);
    case 256: return bwd_launch<256>(a, B, s);
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
