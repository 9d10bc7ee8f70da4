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
// the bias added before its single rounding to T, the attention of
// _packed_attn_kernel (scores and softmax in f32, p / denom rounded to T
// before P V, the fresh column's weight too), residual sums rounded to T.
//
// Bound on this card: bytes. A token reads every layer's weights once
// (L * (12 C^2 + 13 C) elements) plus 2 * L * pos * C cache elements and
// does ~2 flops per weight element, far below the ~295 flops/byte ridge.
// At char-GPT (L=6, C=384, bf16) that is ~21 MB, ~6.4 us at 3.35 TB/s.
// What stands between a kernel and that floor is the chain of grid-wide
// barriers a token needs and the load latency in front of each phase.
//
// Design. A persistent cooperative kernel (cudaLaunchCooperativeKernel,
// grid.sync(); a launch that cannot be placed returns its error, no
// fallback) with every block the card holds resident: one 256-thread
// block on each SM, which claims the SM's shared memory.
// - Each of the four products is split over output-column tiles (64 bf16
//   or 32 f32 columns: 128-byte rows) AND over the input dimension into
//   at most 8 slices, so that most blocks own a slab of each product
//   (7-25 KB at char-GPT). Partials go to an f32 scratch that the wrapper
//   allocates; after the barrier the block that needs a column issues
//   the loads of all its partials at once, sums them in split order (the
//   same bits on every run, no atomics) and applies the epilogue: bias,
//   the one rounding to T, the residual or the activation.
// - Four barriers a layer (the TPU kernel's order had five): (1) QKV
//   partials; (2) attention and the output projection in one phase: the
//   projection's input dimension is split inside single heads, so a
//   block attends the one head its slab reads (recomputed by the few
//   blocks that share a head) and projects its slice; (3) every block
//   sums the projection into the residual, LN2, MLP-up partials; (4) a
//   block sums and activates only the up columns its MLP-down slab
//   reads. Every block then sums MLP-down into the next residual.
// - Nothing waits for a load it could have issued earlier: weights and
//   the stale cache rows (< pos) do not depend on the token. A ring of
//   up to 8 weight slots in shared memory keeps each block's next slabs
//   in flight across the barriers (cp.async, one commit group a slab);
//   after consuming a slab the block issues the one a ring ahead before
//   it arrives at the barrier. An attention block copies its head's K
//   rows and the V columns of its slice into shared memory a layer ahead
//   (TMA bulk copies, cp.async.bulk, one a row, on an mbarrier), in phase
//   4, where the attention blocks (the top of the grid) have no MLP-down
//   slab. After a barrier a block reads only activations and partials.
// - Attention: one block per (head, slice); lane groups over D give the
//   scores of independent rows, block reductions the max and the
//   denominator (p / denom needs the whole row's sum before it rounds,
//   which one block has without another barrier).
// Shared memory (bytes): the ring takes what the card leaves after the
// rows (2 + 3C + 32 x 128 B / itemsize + 20 + 2D + S floats); the K/V
// rows take at most half of it, the weight slots the rest. What is left
// for later: the attention phase, a chain of block reductions that the
// other blocks wait for at the next barrier (split one head over a
// cluster), and the 24 barriers of a char-GPT token themselves (their
// cost is this design's floor; PERF.md has it).
//
// Plain C interface (ctypes); the launch returns its CUDA error code.

#include <cooperative_groups.h>

#include "decode_attention.cuh"

namespace cg = cooperative_groups;

namespace {

using decode::block_max_sumexp;
using decode::from_f;
using decode::gelu_tanh;
using decode::kMaxSplits;
using decode::kNegInf;
using decode::kThreads;
using decode::kWarps;
using decode::round_to;
using decode::sum_parts;
using decode::sum_parts4;
using decode::to_f;
using kvq::load_vec;

constexpr int kTileVecs = 8;                      // 16-byte vectors / tile row
constexpr int kRowGroups = kThreads / kTileVecs;  // rows a pass over a slab
constexpr int kMaxSlabs = 8;                      // weight slots of the ring
constexpr long kMaxSmem = 232448;
enum { kQkv = 0, kProj = 1, kUp = 2, kDown = 3 };

__host__ __device__ constexpr int tile_cols(int isz) {
  return kTileVecs * 16 / isz;
}

// One product's split: ntile column tiles x nsplit input slices of ks
// rows (the last one shorter); item i is tile i % ntile, slice i / ntile.
struct Split {
  int ntile, nsplit, ks;
};

struct Plan {
  int grid;
  Split sp[4];
  long part[4];       // float offset of each product's partials
  long part_floats;   // the scratch the wrapper allocates
  int smem, ring;     // dynamic shared memory; the ring's bytes
  int kv_rows, kv_v;  // K/V rows the ring holds; byte offset of V
  int slab_off, slot, nslot;
};

// Shared-memory floats after the ring; keep in step with
// fused_smem_bytes() in ops/decode.py: the K/V rows' mbarrier (8 bytes),
// in_s, x_s, xm_s (C each), the partial sums of a slab pass or of P V
// (kRowGroups x tile columns = kThreads x one 16-byte vector), the block
// reductions and the fresh score (2 x kWarps + 4), q and the fresh k
// (D each), the scores (S).
__host__ __device__ inline long fixed_floats(int C, int S, int D, int isz) {
  return 2L + 3L * C + (long)kRowGroups * tile_cols(isz) + 2 * kWarps + 4 +
         2L * D + S;
}

__host__ __device__ inline long smem_total(int C, int S, int D, int isz) {
  const long fixed = 4 * fixed_floats(C, S, D, isz);
  if (fixed > kMaxSmem) return fixed;
  return fixed + ((kMaxSmem - fixed) & ~15L);
}

// at most kMaxSplits slices (the reader of a column's partials issues
// their loads at once), at least min_splits, and no more items than the
// grid where that allows
inline Split split_k(int K, int N, int tc, int grid, int min_splits) {
  Split s;
  s.ntile = (N + tc - 1) / tc;
  int ns = grid / s.ntile;
  if (ns > kMaxSplits) ns = kMaxSplits;
  if (ns < min_splits) ns = min_splits;
  if (ns > K) ns = K;
  if (ns < 1) ns = 1;
  s.ks = (K + ns - 1) / ns;
  s.nsplit = (K + s.ks - 1) / s.ks;
  return s;
}

// the output projection's slices lie inside one head: ks = D / 2^j,
// halved while the items still fit the grid and the slices kMaxSplits
inline Split split_proj(int C, int D, int tc, int grid) {
  Split s;
  s.ntile = (C + tc - 1) / tc;
  int ks = D;
  while (ks % 16 == 0 && C / (ks / 2) <= kMaxSplits &&
         (long)s.ntile * (C / (ks / 2)) <= grid)
    ks /= 2;
  s.ks = ks;
  s.nsplit = C / ks;
  return s;
}

inline Plan make_plan(int C, int H, int S, int isz, int grid) {
  Plan p;
  const int D = C / H, tc = tile_cols(isz);
  p.grid = grid;
  p.sp[kQkv] = split_k(C, 3 * C, tc, grid, 1);
  p.sp[kProj] = split_proj(C, D, tc, grid);
  p.sp[kUp] = split_k(C, 4 * C, tc, grid, 1);
  p.sp[kDown] = split_k(4 * C, C, tc, grid, 4);   // ks <= C: fits in_s
  const int N[4] = {3 * C, C, 4 * C, C};
  long off = 0;
  for (int i = 0; i < 4; ++i) {
    p.part[i] = off;
    off += (long)p.sp[i].nsplit * N[i];
  }
  p.part_floats = off;
  p.smem = (int)smem_total(C, S, D, isz);
  p.ring = p.smem - (int)(4 * fixed_floats(C, S, D, isz));
  // a K row padded by 16 bytes: threads reading different rows at one
  // column hit different banks
  const long row = (long)(D + p.sp[kProj].ks) * isz + 16;
  long kv = p.ring / 2;
  if (kv > row * S) kv = row * S;
  p.kv_rows = (int)(kv / row);
  p.kv_v = p.kv_rows * (D * isz + 16);
  p.slab_off = (int)(p.kv_rows * row);
  p.slot = 0;
  for (int i = 0; i < 4; ++i)
    if (p.sp[i].ks * tc * isz > p.slot) p.slot = p.sp[i].ks * tc * isz;
  p.nslot = (p.ring - p.slab_off) / p.slot;
  if (p.nslot > kMaxSlabs) p.nslot = kMaxSlabs;
  return p;
}

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
  T* xout;                       // C
  T* newk;                       // L x C
  T* newv;
  float* part;                   // Plan::part_floats
  long head_stride;              // heads layout: S * D; packed: D
  long row_stride;               // heads layout: D; packed: C
  int L, C, H, D, S, pos, gelu;
  float eps, scale;
  Plan plan;
};

// The sums of two values over the block; every thread gets both. red:
// 2 * kWarps + 2 floats, free again on return.
__device__ __forceinline__ float2 block_sum2(float x, float y, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
    y += __shfl_xor_sync(0xffffffffu, y, o);
  }
  if (lane == 0) {
    red[2 * warp] = x;
    red[2 * warp + 1] = y;
  }
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? red[2 * lane] : 0.f;
    y = lane < kWarps ? red[2 * lane + 1] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, o);
      y += __shfl_xor_sync(0xffffffffu, y, o);
    }
    if (lane == 0) {
      red[2 * kWarps] = x;
      red[2 * kWarps + 1] = y;
    }
  }
  __syncthreads();
  const float2 r = make_float2(red[2 * kWarps], red[2 * kWarps + 1]);
  __syncthreads();
  return r;
}

// Phase stamps for tools/torch_port_fused_stamps.py: built with
// -DFUSED_DECODE_STAMPS, thread 0 of each of the first kStampBlocks blocks
// records clock64() at STAMP(layer, point); otherwise STAMP is nothing.
#ifdef FUSED_DECODE_STAMPS
constexpr int kStampBlocks = 160, kStampLayers = 6, kStampPoints = 24;
__device__ long long g_stamp[kStampBlocks][kStampLayers][kStampPoints];
#define STAMP(l, k)                                                     \
  do {                                                                  \
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks &&                \
        (l) < kStampLayers)                                             \
      g_stamp[blockIdx.x][l][k] = clock64();                            \
  } while (0)
#else
#define STAMP(l, k) \
  do {              \
  } while (0)
#endif

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const FusedArgs<T> a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TC = tile_cols(sizeof(T));
  cg::grid_group grid = cg::this_grid();
  const Plan& pl = a.plan;
  const int C = a.C, D = a.D, L = a.L, S = a.S, pos = a.pos;
  const int tid = threadIdx.x, b0 = blockIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  const T* kv_k = reinterpret_cast<const T*>(ring);
  const T* kv_v = reinterpret_cast<const T*>(ring + pl.kv_v);
  unsigned char* slabs = ring + pl.slab_off;
  unsigned long long* kv_bar =
      reinterpret_cast<unsigned long long*>(smem + pl.ring);
  float* in_s = reinterpret_cast<float*>(kv_bar + 1);
  float* x_s = in_s + C;
  float* xm_s = x_s + C;
  float* tile_red = xm_s + C;
  float* red = tile_red + kRowGroups * TC;   // 2 x kWarps + 4
  float* q_s = red + 2 * kWarps + 4;
  float* kn_s = q_s + D;
  float* p_s = kn_s + D;
  const long layer_cache = (long)S * C;

  auto k_of = [&](int p) { return p == kDown ? 4 * C : C; };
  auto n_of = [&](int p) { return p == kQkv ? 3 * C : p == kUp ? 4 * C : C; };
  auto weight = [&](int p, int l) -> const T* {
    if (p == kQkv) return a.wqkv + (long)l * C * 3 * C;
    if (p == kProj) return a.wproj + (long)l * C * C;
    if (p == kUp) return a.wup + (long)l * C * 4 * C;
    return a.wdown + (long)l * 4 * C * C;
  };
  auto bias = [&](int p, int l) -> const T* {
    if (p == kQkv) return a.bqkv + (long)l * 3 * C;
    if (p == kProj) return a.bproj + (long)l * C;
    if (p == kUp) return a.bup + (long)l * 4 * C;
    return a.bdown + (long)l * C;
  };
  auto items = [&](int p) { return pl.sp[p].ntile * pl.sp[p].nsplit; };
  // the block's first item of product p: the projection's (and so the
  // attention's) run from the top of the grid down, so that its blocks
  // are not the MLP-down's and can fetch the next layer's K/V in phase 4
  const int G0 = gridDim.x;
  auto first = [&](int p) { return p == kProj ? G0 - 1 - b0 : b0; };

  // The weight slabs: cp.async, one commit group a slab, every thread
  // committing the same groups in the same order; gid[] holds each
  // slot's group. The K/V rows: TMA bulk copies, one a row, on kv_bar,
  // layer l's phase with parity l & 1, armed by thread 0 (empty too).
  int committed = 0;
  int gid[kMaxSlabs];

  // slab j (layer j / 4, product j % 4) of the block's first item into
  // slot j % nslot
  auto slab_issue = [&](int j) {
    const int p = j % 4, l = j / 4, item = first(p);
    if (l < L && item >= 0 && item < items(p)) {
      const Split sp = pl.sp[p];
      const int K = k_of(p), N = n_of(p);
      const int k0 = (item / sp.ntile) * sp.ks, c0 = (item % sp.ntile) * TC;
      const int rows = min(sp.ks, K - k0);
      const T* w = weight(p, l) + (long)k0 * N + c0;
      unsigned char* dst = slabs + (long)(j % pl.nslot) * pl.slot;
      const int cv = tid % kTileVecs;
      if (c0 + cv * VEC < N)
        for (int r = tid / kTileVecs; r < rows; r += kRowGroups)
          kvq::cp_async16(dst + ((long)r * TC + cv * VEC) * sizeof(T),
                          w + (long)r * N + cv * VEC);
    }
    kvq::cp_async_commit();
    gid[j % pl.nslot] = committed++;
  };
  auto slab_wait = [&](int j) {
    kvq::cp_async_wait_dyn(committed - gid[j % pl.nslot] - 1);
    __syncthreads();
  };

  // layer l's K rows of the head of the block's first projection item,
  // and the V columns of its slice: rows < min(pos, kv_rows)
  auto kv_issue = [&](int l) {
    unsigned bytes = 0;
    const int item = first(kProj);
    if (item >= 0 && item < items(kProj) && pl.kv_rows > 0) {
      const Split sp = pl.sp[kProj];
      const int k0 = (item / sp.ntile) * sp.ks, h = k0 / D, kk = k0 - h * D;
      const int rows = min(pos, pl.kv_rows);
      const T* kg = a.kc + l * layer_cache + h * a.head_stride;
      const T* vg = a.vc + l * layer_cache + h * a.head_stride + kk;
      unsigned char* vd = ring + pl.kv_v;
      kvq::fence_proxy_async();
      for (int e = tid; e < 2 * rows; e += kThreads) {
        const int v = e >= rows, r = e - v * rows;
        if (v)
          kvq::bulk_copy(vd + (long)r * sp.ks * sizeof(T),
                         vg + r * a.row_stride, sp.ks * sizeof(T), kv_bar);
        else
          kvq::bulk_copy(ring + (long)r * (D * sizeof(T) + 16),
                         kg + r * a.row_stride, D * sizeof(T), kv_bar);
      }
      bytes = rows * (D + sp.ks) * sizeof(T);
    }
    if (tid == 0) kvq::mbar_arm(kv_bar, bytes);
  };

  // dst[c] = T(base[c] + T(sum of product p's partials + bias)), every c
  auto residual = [&](int p, int l, const float* base, float* dst) {
    const float* P = a.part + pl.part[p];
    const int ns = pl.sp[p].nsplit;
    const T* bb = bias(p, l);
    for (int c4 = tid; c4 < C / 4; c4 += kThreads) {
      const float4 v = sum_parts4(P + 4 * c4, C, ns);
      const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * c4 + j;
        dst[c] = round_to<T>(base[c] + round_to<T>(s[j] + to_f(bb[c])));
      }
    }
    __syncthreads();
  };

  // Layernorm of the row src into out (f32 values rounded to T): mean and
  // variance in f32 from one block reduction of the sum and the sum of
  // squares. The scale and bias of a thread's first columns load first,
  // so their latency hides behind the reduction.
  auto layer_norm = [&](const float* src, const T* s, const T* b,
                        float* out) {
    constexpr int kHeld = 4;
    float sh[kHeld], bh[kHeld];
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int c = tid + i * kThreads;
      sh[i] = c < C ? to_f(s[c]) : 0.f;
      bh[i] = c < C ? to_f(b[c]) : 0.f;
    }
    float sum = 0.f, sq = 0.f;
    for (int c = tid; c < C; c += kThreads) {
      sum += src[c];
      sq += src[c] * src[c];
    }
    const float2 tot = block_sum2(sum, sq, red);
    const float mu = tot.x / C;
    const float inv = rsqrtf(fmaxf(tot.y / C - mu * mu, 0.f) + a.eps);
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int c = tid + i * kThreads;
      if (c < C) out[c] = round_to<T>((src[c] - mu) * inv * sh[i] + bh[i]);
    }
    for (int c = tid + kHeld * kThreads; c < C; c += kThreads) {
      const float y = (src[c] - mu) * inv;
      out[c] = round_to<T>(y * to_f(s[c]) + to_f(b[c]));
    }
    __syncthreads();
  };

  // The block's items of product p at layer l: for each, prep(item, k0,
  // rows) readies the inputs (block-uniform), then the partial sums of
  // the slice over the tile go to the scratch. in_s holds the inputs at
  // their index (rel false) or from the slice's first row (rel true).
  // The first item reads its slab from the ring; then the slot takes the
  // slab nslot ahead.
  auto product = [&](int p, int l, bool rel, auto&& prep) {
    const Split sp = pl.sp[p];
    const int K = k_of(p), N = n_of(p), j = 4 * l + p;
    const int cv = tid % kTileVecs, rg = tid / kTileVecs;
    float* P = a.part + pl.part[p];
    for (int item = first(p); item >= 0 && item < items(p);
         item += gridDim.x) {
      const int k0 = (item / sp.ntile) * sp.ks, c0 = (item % sp.ntile) * TC;
      const int rows = min(sp.ks, K - k0);
      prep(item, k0, rows);
      const T* w;
      long stride;
      if (item == first(p) && pl.nslot > 0) {
        slab_wait(j);
        w = reinterpret_cast<const T*>(slabs + (long)(j % pl.nslot) *
                                                   pl.slot);
        stride = TC;
      } else {
        w = weight(p, l) + (long)k0 * N + c0;
        stride = N;
      }
      const float* in = rel ? in_s : in_s + k0;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      if (c0 + cv * VEC < N) {
#pragma unroll 4
        for (int i = rg; i < rows; i += kRowGroups) {
          float wv[VEC];
          load_vec(w + (long)i * stride + cv * VEC, wv);
          const float hv = in[i];
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[q] += hv * wv[q];
        }
      }
      // the warp's 4 row groups by shuffles, then the 8 warps in order
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], kTileVecs);
        acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], 2 * kTileVecs);
      }
      if ((tid & 31) < kTileVecs) {
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          tile_red[(tid >> 5) * TC + cv * VEC + q] = acc[q];
      }
      __syncthreads();
      if (tid < TC && c0 + tid < N) {
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < kWarps; ++g) s += tile_red[g * TC + tid];
        P[(long)(item / sp.ntile) * N + c0 + tid] = s;
      }
      __syncthreads();
    }
    if (pl.nslot > 0) slab_issue(j + pl.nslot);
  };

  // Attention of the head of projection item `item` at layer l, into
  // in_s[0, ks): the item's columns; tile 0's items also write the fresh
  // K/V row's columns out.
  auto attend = [&](int item, int l) {
    STAMP(l, 4);
    const Split sp = pl.sp[kProj];
    const int ks = sp.ks, k0 = (item / sp.ntile) * ks;
    const int h = k0 / D, kk = k0 - h * D;
    const bool first_tile = item % sp.ntile == 0;
    const float* Pq = a.part + pl.part[kQkv];
    const int nq = pl.sp[kQkv].nsplit;
    const T* bq = bias(kQkv, l);
    float vn = 0.f;
    if (tid < D) {   // ks <= D: the v column's thread is the same
      const int cq = h * D + tid, ck = C + cq, cv = 2 * C + k0 + tid;
      // q, k and v partials in one batch of loads, each summed in order
      float sq = 0.f, sk = 0.f, sv = 0.f;
      for (int i0 = 0; i0 < nq; i0 += kMaxSplits) {
        float pq[kMaxSplits], pk[kMaxSplits], pv[kMaxSplits];
#pragma unroll
        for (int i = 0; i < kMaxSplits; ++i) {
          const long o = (long)(i0 + i) * 3 * C;
          const bool in = i0 + i < nq;
          pq[i] = in ? __ldcg(Pq + o + cq) : 0.f;
          pk[i] = in ? __ldcg(Pq + o + ck) : 0.f;
          pv[i] = in && tid < ks ? __ldcg(Pq + o + cv) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kMaxSplits; ++i) {
          if (i0 + i < nq) {
            sq += pq[i];
            sk += pk[i];
            sv += pv[i];
          }
        }
      }
      const float qv = round_to<T>(sq + to_f(bq[cq]));
      const float kv = round_to<T>(sk + to_f(bq[ck]));
      q_s[tid] = qv;
      kn_s[tid] = kv;
      if (first_tile && tid >= kk && tid < kk + ks)
        a.newk[(long)l * C + cq] = from_f<T>(kv);
      if (tid < ks) {
        vn = round_to<T>(sv + to_f(bq[cv]));
        if (first_tile) a.newv[(long)l * C + k0 + tid] = from_f<T>(vn);
      }
    }
    __syncthreads();   // q and the fresh k are in shared memory
    STAMP(l, 16);
    const bool pre = item == first(kProj) && pl.kv_rows > 0;
    const int n_pre = pre ? min(pos, pl.kv_rows) : 0;
    if (pre) kvq::mbar_wait(kv_bar, (unsigned)l & 1u);
    STAMP(l, 17);
    const T* kg = a.kc + l * layer_cache + h * a.head_stride;
    const T* vg = a.vc + l * layer_cache + h * a.head_stride + kk;
    // scores: a thread a row, the rows in shared memory (K rows padded
    // to D + 16 bytes / sizeof(T) elements), then any past them in place;
    // q is read as broadcast 16-byte vectors, four partial sums a row
    const int nv = D / VEC;
    const long k_pad = D + 16 / sizeof(T);
    for (int part = 0; part < 2; ++part) {
      const T* base = part ? kg : kv_k;
      const long stride = part ? a.row_stride : k_pad;
      const int r_hi = part ? pos : n_pre;
      for (int r = (part ? n_pre : 0) + tid; r < r_hi; r += kThreads) {
        const T* krow = base + r * stride;
        float acc4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int v = 0; v < nv; ++v) {
          float kf[VEC];
          load_vec(krow + v * VEC, kf);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc4[i % 4] += q_s[v * VEC + i] * kf[i];
        }
        p_s[r] = ((acc4[0] + acc4[1]) + (acc4[2] + acc4[3])) * a.scale;
      }
    }
    if (tid < 32) {   // the fresh column's score, by warp 0
      float sn = 0.f;
      for (int d = tid; d < D; d += 32) sn += q_s[d] * kn_s[d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sn += __shfl_xor_sync(0xffffffffu, sn, o);
      if (tid == 0) red[2 * kWarps + 2] = sn * a.scale;
    }
    __syncthreads();
    const float s_new = red[2 * kWarps + 2];
    STAMP(l, 18);
    // the max and the denominator in one reduction of (m, l) pairs; the
    // fresh column is thread 0's
    float mt = tid == 0 ? s_new : kNegInf;
    for (int r = tid; r < pos; r += kThreads) mt = fmaxf(mt, p_s[r]);
    float lt = tid == 0 ? expf(s_new - mt) : 0.f;
    for (int r = tid; r < pos; r += kThreads) lt += expf(p_s[r] - mt);
    const float2 ml = block_max_sumexp(mt, lt, red);
    const float m = ml.x, denom = ml.y;
    const float p_new = expf(s_new - m);
    for (int r = tid; r < pos; r += kThreads)
      p_s[r] = round_to<T>(expf(p_s[r] - m) / denom);
    __syncthreads();
    STAMP(l, 19);
    // P V over the slice's columns: a thread one 16-byte vector of a
    // row, kThreads / nvv row groups; the groups of a warp by shuffles,
    // then the warps (or, a row wider than a warp, the groups) in order
    const int nvv = ks / VEC, RG = kThreads / nvv;
    const int cvv = tid % nvv, rg = tid / nvv;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    for (int part = 0; part < 2; ++part) {   // shared memory, then in place
      const T* base = part ? vg : kv_v;
      const long stride = part ? a.row_stride : ks;
      const int r1 = part ? pos : n_pre;
      const int r0 = part ? n_pre + (rg - n_pre % RG + RG) % RG : rg;
#pragma unroll 2
      for (int r = r0; r < r1; r += RG) {
        float vv[VEC];
        load_vec(base + r * stride + cvv * VEC, vv);
        const float p = p_s[r];
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] += p * vv[q];
      }
    }
    STAMP(l, 20);
    int groups = RG;
    if (nvv < 32) {
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        for (int o = nvv; o < 32; o <<= 1)
          acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
      groups = kWarps;
    }
    if (nvv >= 32 || (tid & 31) < nvv) {
      const int g = nvv < 32 ? tid >> 5 : rg;
#pragma unroll
      for (int q = 0; q < VEC; ++q) tile_red[g * ks + cvv * VEC + q] = acc[q];
    }
    __syncthreads();
    if (tid < ks) {
      float pv = 0.f;
      for (int i = 0; i < groups; ++i) pv += tile_red[i * ks + tid];
      const float w_new = round_to<T>(p_new / denom);
      in_s[tid] = round_to<T>(pv + w_new * vn);
    }
    __syncthreads();
    STAMP(l, 5);
  };

  // the MLP-down slice's inputs: the up columns [k0, k0 + rows), summed,
  // biased, rounded, activated and rounded again
  auto down_inputs = [&](int l, int k0, int rows) {
    STAMP(l, 11);
    const float* Pu = a.part + pl.part[kUp];
    const int nu = pl.sp[kUp].nsplit;
    const T* bu = bias(kUp, l);
    for (int i = tid; i < rows; i += kThreads) {
      const int c = k0 + i;
      const float r =
          round_to<T>(sum_parts(Pu + c, 4L * C, nu) + to_f(bu[c]));
      in_s[i] = round_to<T>(a.gelu ? gelu_tanh(r) : fmaxf(r, 0.f));
    }
    __syncthreads();
    STAMP(l, 12);
  };

  if (tid == 0) {
    kvq::mbar_init(kv_bar, 1);
    kvq::mbar_fence_init();
  }
  __syncthreads();
  for (int j = 0; j < pl.nslot; ++j) slab_issue(j);
  kv_issue(0);
  for (int c = tid; c < C; c += kThreads) x_s[c] = to_f(a.x0[c]);
  __syncthreads();
  auto none = [](int, int, int) {};
  for (int l = 0; l < L; ++l) {
    // 1. the residual after the last MLP-down; LN1; QKV partials
    STAMP(l, 0);
    if (l > 0) residual(kDown, l - 1, xm_s, x_s);
    STAMP(l, 1);
    layer_norm(x_s, a.ln1s + (long)l * C, a.ln1b + (long)l * C, in_s);
    STAMP(l, 2);
    product(kQkv, l, false, none);
    STAMP(l, 3);
    grid.sync();
    // 2. attention and the output projection's partials
    product(kProj, l, true,
            [&](int item, int, int) { attend(item, l); });
    STAMP(l, 6);
    grid.sync();
    // 3. the residual after the projection; LN2; MLP-up partials
    STAMP(l, 7);
    residual(kProj, l, x_s, xm_s);
    STAMP(l, 8);
    layer_norm(xm_s, a.ln2s + (long)l * C, a.ln2b + (long)l * C, in_s);
    STAMP(l, 9);
    product(kUp, l, false, none);
    STAMP(l, 10);
    grid.sync();
    // 4. MLP-down partials over the activated up slice; the attention
    // blocks fetch the next layer's K/V rows
    if (l + 1 < L) kv_issue(l + 1);
    product(kDown, l, true,
            [&](int, int k0, int rows) { down_inputs(l, k0, rows); });
    STAMP(l, 13);
    grid.sync();
    STAMP(l, 14);
  }
  if (b0 == 0) {
    residual(kDown, L - 1, xm_s, x_s);
    for (int c = tid; c < C; c += kThreads) a.xout[c] = from_f<T>(x_s[c]);
  }
  kvq::cp_async_wait<0>();
}

// A cooperative kernel that only crosses n grid barriers, launched on the
// fused kernel's grid: the cost of one barrier.
__global__ void __launch_bounds__(kThreads) barrier_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// The split at these shapes on a grid of `grid` blocks; no CUDA call.
int plan_on(int C, int H, int S, int isz, int grid, Plan* out) {
  if (H <= 0 || C % H != 0 || grid < 1 ||
      smem_total(C, S, C / H, isz) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  *out = make_plan(C, H, S, isz, grid);
  if (out->nslot < 0 || out->kv_rows < 0) return (int)cudaErrorInvalidValue;
  return 0;
}

// The plan at these shapes on the current device: every block the card
// holds resident at the kernel's shared memory. It also lets the kernel
// take the card's largest carve-up, so that a launch needs no further
// CUDA call before it: the wrapper asks once per shape and device and
// hands the grid to every launch.
template <typename T>
int plan_for(int C, int H, int S, Plan* out) {
  if (H <= 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  const int D = C / H;
  const long smem = smem_total(C, S, D, (int)sizeof(T));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = fused_decode_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return plan_on(C, H, S, (int)sizeof(T), per_sm * sms, out);
}

// a grid the card cannot hold resident is refused by the cooperative
// launch itself (no fallback)
template <typename T>
int launch(FusedArgs<T> a, int grid, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (a.D % VEC != 0 || a.D > kThreads || kThreads % a.D != 0 ||
      a.C != a.H * a.D || a.pos < 0 || a.pos >= a.S)
    return (int)cudaErrorInvalidValue;
  const int err = plan_on(a.C, a.H, a.S, (int)sizeof(T), grid, &a.plan);
  if (err != 0) return err;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_decode_kernel<T>), dim3(a.plan.grid),
      dim3(kThreads), args, a.plan.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* const* p, long head_stride, long row_stride, int L,
        int C, int H, int S, int pos, int gelu, float eps, int grid,
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
  a.part = static_cast<float*>(const_cast<void*>(p[18]));
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
  return launch<T>(a, grid, stream);
}

}  // namespace

// ptrs: the 19 device pointers x0, ln1_scale, ln1_bias, qkv_kernel,
// qkv_bias, attn_out_kernel, attn_out_bias, ln2_scale, ln2_bias,
// mlp_up_kernel, mlp_up_bias, mlp_down_kernel, mlp_down_bias, k_cache,
// v_cache, xout, newk, newv (all contiguous in one dtype: 0 = float32,
// 1 = bfloat16), and the f32 partials (fused_decode_layers_plan's
// part_floats). packed: 1 for the (L, 1, S, C) cache layout, 0 for (L,
// 1, H, S, D). gelu: 1 for tanh-GELU, 0 ReLU. grid: the plan's
// (fused_decode_layers_plan, on this device).
extern "C" int fused_decode_layers_launch(const void* const* ptrs, int L,
                                          int C, int H, int S, int pos,
                                          int packed, int gelu, float eps,
                                          int dtype, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  const int D = C / H;
  const long head_stride = packed ? D : (long)S * D;
  const long row_stride = packed ? C : D;
  if (dtype == 0)
    return run<float>(ptrs, head_stride, row_stride, L, C, H, S, pos, gelu,
                      eps, grid, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(ptrs, head_stride, row_stride, L, C, H, S, pos,
                              gelu, eps, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The launch's plan on the current device, into out[0..17]: grid; ntile,
// nsplit, ks of QKV, projection, MLP up, MLP down; the partials' floats;
// weight slots; K/V rows held; dynamic shared memory; slot bytes.
extern "C" int fused_decode_layers_plan(int C, int H, int S, int dtype,
                                        long* out) {
  Plan p;
  const int err = dtype == 0   ? plan_for<float>(C, H, S, &p)
                  : dtype == 1 ? plan_for<__nv_bfloat16>(C, H, S, &p)
                               : (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  out[0] = p.grid;
  for (int i = 0; i < 4; ++i) {
    out[1 + 3 * i] = p.sp[i].ntile;
    out[2 + 3 * i] = p.sp[i].nsplit;
    out[3 + 3 * i] = p.sp[i].ks;
  }
  out[13] = p.part_floats;
  out[14] = p.nslot;
  out[15] = p.kv_rows;
  out[16] = p.smem;
  out[17] = p.slot;
  return 0;
}

// n grid barriers and nothing else, on the fused kernel's grid and
// shared memory at these shapes (dtype as above)
extern "C" int fused_decode_barrier_probe(int n, int C, int H, int S,
                                          int dtype, void* stream) {
  Plan p;
  const int err = dtype == 0   ? plan_for<float>(C, H, S, &p)
                  : dtype == 1 ? plan_for<__nv_bfloat16>(C, H, S, &p)
                               : (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&n};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(barrier_probe_kernel),
                                  dim3(p.grid), dim3(kThreads), args, p.smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef FUSED_DECODE_STAMPS
// the stamps of the last launch, (kStampBlocks, kStampLayers,
// kStampPoints) cycles
extern "C" int fused_decode_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}
#endif
