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
// Unlike the B=1 kernels (which round the probabilities to T as
// _packed_attn_kernel does) the attention keeps the probabilities and
// the accumulator in f32, as an online softmax; the fresh column is
// folded in f32 at the end. A quantized pool (int8 or fp8 e4m3 pages
// with f32 scales per row, or per row and head) is dequantized as f32(q)
// * scale at use, and the fresh K/V column is fake-quantized in f32
// (quant/kv.py's span math) and rounded to T before it attends, so that
// it scores exactly what the caller's write will store.
//
// Bound on this card: bytes. A step reads every layer's weights once
// for all B slots (L * (12 C^2 + 13 C) elements) plus each slot's live
// K/V rows (2 * L * sum(pos) * C pool elements, and their scales) and
// does ~2 * B flops per weight element, far below the ~295 flops/byte
// ridge. At char-GPT (L=6, C=384, bf16, B=8, sum(pos) = 949): ~21 MB of
// weights and ~9 MB of pages, ~9 us at 3.35 TB/s (H100 80GB HBM3, 700 W).
//
// Design: fused_decode_layers.cu's (TPU row #3) carried over to B slots
// and pages. A persistent cooperative kernel (cudaLaunchCooperativeKernel,
// grid.sync(); a launch that cannot be placed returns its error, no
// fallback) with one 256-thread block on each SM, which claims the SM's
// shared memory. The grid, the splits and the ring are planned once per
// shape, dtype, pool type and device (fused_paged_decode_layers_plan), so
// a launch makes no CUDA call but the launch itself.
// - Each of the four products is split over output-column tiles (128-byte
//   rows of the weight) and over at most 8 input slices, for a group of
//   kRB = 8 slots at once: each weight element is read once for up to 8
//   slots (a larger B walks its groups with the slab still in shared
//   memory). bf16 multiplies on the tensor cores (mma.sync m16n8k16, the
//   slots rows 0..7 of the tile, the slab's B fragments by ldmatrix), f32
//   on the CUDA cores (a thread 4 slots of one 16-byte column vector).
//   Slices go to an f32 scratch and are summed in split order, so every
//   run gives the same bits: q / k / v and the up rows by the blocks that
//   read them; the two residual products (which every block reads whole,
//   for its layernorm) by the last block to finish each column tile (an
//   acquire-release ticket a tile), which writes the residual rows.
// - Four grid barriers a layer (the TPU kernel's order had five):
//   (1) LN1, QKV slices; (2) the attention items, then the output
//   projection's slices and residual; (3) LN2, MLP-up slices; (4) the
//   activated up slice, MLP-down slices and residual. In phase 2 the
//   projection waits for its head, not for the grid: each (slot, head)'s
//   live rows are split into contiguous ranges over up to kMaxAttn items,
//   sized from the caller's bound on pos (the engine's longest position;
//   the whole table without it), which run on the top of the grid. An
//   item keeps an online softmax (m, l, acc) in lane groups that own whole
//   rows, writes its f32 state to the scratch (the last split also the
//   fresh column's, fake-quantized for a quantized pool) and counts itself
//   done on its head. A projection block spins on its head's count (all
//   blocks are resident), merges the records of its input slice by
//   logsumexp in split order and projects.
// - Nothing waits for a load it could have issued earlier: weights, pages,
//   biases and layernorm parameters do not depend on the token. A ring of
//   up to 8 weight slots in shared memory keeps each block's next slabs in
//   flight across the barriers (cp.async, one commit group a slab); an
//   attention block copies its first item's K and V rows of the next layer
//   into shared memory in phase 4, where the attention blocks (the top of
//   the grid) have no MLP-down slab (TMA bulk copies, one a row, on an
//   mbarrier); the small tensors go to L2 at the launch, and a layernorm's
//   parameters into registers before the barrier ahead of their use.
// What is left: the 24 grid barriers and each phase's chain of L2 round
// trips (PERF.md has the phase cycles), and a batch whose slots'
// histories differ widely sizes every split for the longest one.
//
// Plain C interface (ctypes); the launch returns its CUDA error code.

#include <cooperative_groups.h>

#include <type_traits>

#include "decode_attention.cuh"

namespace cg = cooperative_groups;

namespace {

using decode::block_reduce;
using decode::from_f;
using decode::gelu_tanh;
using decode::kMaxSplits;
using decode::kNegInf;
using decode::kThreads;
using decode::kWarps;
using decode::round_to;
using decode::sum_parts4;
using decode::to_f;
using kvq::load_vec;

constexpr int kTileVecs = 8;                      // 16-byte vectors / tile row
constexpr int kRowGroups = kThreads / kTileVecs;  // rows a pass over a slab
constexpr int kRB = 8;                            // slots per weight pass
constexpr int kMaxSlabs = 8;                      // weight slots of the ring
constexpr int kMaxAttn = 8;     // history splits of one (slot, head)
constexpr int kAttnRows = 64;   // history rows that earn a split
// floats per input row of a product in shared memory (in_s, k-major: the
// kRB slots, then 4 of padding, so that the tensor cores' A fragments and
// the CUDA cores' row groups read distinct banks)
constexpr int kInStride = kRB + 4;
constexpr long kMaxSmem = 232448;
enum { kQkv = 0, kProj = 1, kUp = 2, kDown = 3 };

__host__ __device__ constexpr int tile_cols(int isz) {
  return kTileVecs * 16 / isz;
}

// floats of one attention record: acc (D), m, l, two pads (16 bytes)
__host__ __device__ constexpr int rec_floats(int D) { return D + 4; }

// One product's split: ntile column tiles x nsplit input slices of ks
// rows (the last one shorter); item i is tile i % ntile, slice i / ntile.
struct Split {
  int ntile, nsplit, ks;
};

struct Plan {
  int grid;
  Split sp[4];
  long part[4];       // float offset of each product's partials, per slot
  long part_row;      // partial floats per slot
  int smem, ring;     // dynamic shared memory; the ring's bytes
  int kv_rows, kv_v;  // history rows the ring holds; byte offset of V
  int slab_off, slot, nslot;
};

// Shared-memory floats after the ring; keep in step with
// fused_paged_smem_bytes() in ops/decode.py: the K/V rows' mbarrier (8
// bytes), the block reductions and a ticket (2 kWarps + 4), the
// layernorm statistics of a slot group (2 kRB) and its scale and bias
// (2 C), the merge factors of the attention records (kRB x 2 (kMaxAttn +
// 2)), the row quarters' sums of a product (4 x kRB x tile columns), then
// x_s (kRB x C) and in_s (C x kInStride), which the attention's scratch
// shares.
__host__ __device__ inline long fixed_floats(int C, int isz) {
  return 2L + 2 * kWarps + 4 + 2 * kRB + 2L * C + 2L * kRB * (kMaxAttn + 2) +
         4L * kRB * tile_cols(isz) + (long)(kRB + kInStride) * C;
}

__host__ __device__ inline long smem_total(int C, int isz) {
  const long fixed = 4 * fixed_floats(C, isz);
  if (fixed > kMaxSmem) return fixed;
  return fixed + ((kMaxSmem - fixed) & ~15L);
}

// at most kMaxSplits slices (the reader of a column's partials issues
// their loads at once), at least min_splits, and no more items than the
// grid where that allows
inline Split split_k(int K, int N, int tc, int grid, int min_splits,
                     int align = 1) {
  Split s;
  s.ntile = (N + tc - 1) / tc;
  int ns = grid / s.ntile;
  if (ns > kMaxSplits) ns = kMaxSplits;
  if (ns < min_splits) ns = min_splits;
  if (ns > K) ns = K;
  if (ns < 1) ns = 1;
  s.ks = (K + ns - 1) / ns;
  s.ks = (s.ks + align - 1) / align * align;
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

// S: the table's rows (max_pages * page), which bounds a split's
inline Plan make_plan(int C, int H, int S, int isz, int pisz, int grid) {
  Plan p;
  const int D = C / H, tc = tile_cols(isz);
  p.grid = grid;
  p.sp[kQkv] = split_k(C, 3 * C, tc, grid, 1);
  p.sp[kProj] = split_proj(C, D, tc, grid);
  p.sp[kUp] = split_k(C, 4 * C, tc, grid, 1);
  // ks <= C fits in_s; slices of whole float4s (C is one): the up sums
  // that feed a slice load as float4
  p.sp[kDown] = split_k(4 * C, C, tc, grid, 4, 4);
  const int N[4] = {3 * C, C, 4 * C, C};
  long off = 0;
  for (int i = 0; i < 4; ++i) {
    p.part[i] = off;
    off += (long)p.sp[i].nsplit * N[i];
  }
  p.part_row = off;
  p.smem = (int)smem_total(C, isz);
  p.ring = p.smem - (int)(4 * fixed_floats(C, isz));
  const long row = (long)D * pisz;   // one head's K (or V) row
  long kv = p.ring / 2;
  if (kv > 2 * row * S) kv = 2 * row * S;
  p.kv_rows = (int)(kv / (2 * row));
  p.kv_v = (int)(p.kv_rows * row);
  p.slab_off = 2 * p.kv_v;
  p.slot = 0;   // a slab row is padded by 16 bytes (ldmatrix, below)
  for (int i = 0; i < 4; ++i)
    if (p.sp[i].ks * (tc * isz + 16) > p.slot)
      p.slot = p.sp[i].ks * (tc * isz + 16);
  p.nslot = (p.ring - p.slab_off) / p.slot;
  if (p.nslot > kMaxSlabs) p.nslot = kMaxSlabs;
  return p;
}

// History splits of one (slot, head) for a bound of `span` rows on every
// slot's history: one per kAttnRows rows, at most kMaxAttn, and no more
// items than the grid where that allows. Keep in step with
// fused_paged_attn_splits() in ops/decode.py.
__host__ __device__ inline int attn_splits(int span, int BH, int grid) {
  int ns = (span + kAttnRows - 1) / kAttnRows;
  if (ns > kMaxAttn) ns = kMaxAttn;
  if (ns > grid / BH) ns = grid / BH;
  return ns < 1 ? 1 : ns;
}

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
  float* part;                   // B x part_row partials
  float* rec;                    // B x H x (kMaxAttn + 1) attention records
  float* xmid;                   // B x C: the residual after attention
  int* done;                     // L x H: attention items finished a head
  int* tiles;                    // 4 x tile_slots: slices summed a tile
                                 // (the residual products')
  int L, B, C, H, D, N, psz, mp, gelu, head_gran;
  int nattn, attn_rows;          // history splits a (slot, head); rows each
  float eps, scale;
  Plan plan;
};

// Phase stamps for tools/torch_port_fused_stamps.py --kernel paged:
// built with -DFUSED_PAGED_STAMPS, thread 0 of each of the first
// kStampBlocks blocks records clock64() at STAMP(layer, point); otherwise
// STAMP is nothing.
#ifdef FUSED_PAGED_STAMPS
constexpr int kStampBlocks = 160, kStampLayers = 6, kStampPoints = 32;
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

// Counters between blocks, as CUTLASS's semaphore: the writers' stores,
// then __syncthreads() and one thread's release; the reader's acquire,
// then __syncthreads() and loads from L2. No full fence.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// the raw 16 bytes at src, to be converted later (unpack): a load issued
// before a barrier that its use follows
__device__ __forceinline__ uint4 load_raw(const void* src) {
  return *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void unpack(uint4 raw, float* dst, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = f[i];
}
__device__ __forceinline__ void unpack(uint4 raw, float* dst,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// 16 bytes of T at src as floats, from L2 (data other blocks wrote during
// the launch: the SM's L1 is not coherent)
__device__ __forceinline__ void load_vec_cg(const float* src, float* dst) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load_vec_cg(const __nv_bfloat16* src,
                                            float* dst) {
  const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// bf16 products on the tensor cores: c += a b on one m16n8k16 tile (bf16
// operands, f32 accumulators). Lane l = 4 g + t holds c[0], c[1] at row
// g, columns 2t, 2t + 1 (c[2], c[3] at row g + 8); a[0..3] at (row g, k
// 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); b0, b1 at (k
// 2t.., column g), (k 2t + 8.., g).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragments (b0, b1) of rows k.. k + 15, columns n.. n + 7 of a
// row-major [k][n] bf16 tile in shared memory: lane i < 16 gives the
// address of row k + i
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(kvq::smem_u32(row)));
}

// two f32 to a bf16x2 register (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// T: the compute dtype; P: the pool's (T, int8 or fp8). NVL: 16-byte
// pool vectors of a row one lane holds in the attention (1 or 2).
template <typename T, typename P, int NVL>
__global__ void __launch_bounds__(kThreads)
fused_paged_kernel(const Args<T> a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TC = tile_cols(sizeof(T));
  constexpr int SR = TC + VEC;   // a slab row's stride: 16 bytes of padding
  constexpr int PVEC = kvq::vec_elems<P>();
  constexpr bool kQuant = !std::is_same<P, T>::value;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool kFp8 = std::is_same<P, __nv_fp8_e4m3>::value;
  cg::grid_group grid = cg::this_grid();
  const Plan& pl = a.plan;
  const int C = a.C, D = a.D, H = a.H, L = a.L, B = a.B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x, G0 = gridDim.x;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  const P* kv_k = reinterpret_cast<const P*>(ring);
  const P* kv_v = reinterpret_cast<const P*>(ring + pl.kv_v);
  unsigned char* slabs = ring + pl.slab_off;
  unsigned long long* kv_bar =
      reinterpret_cast<unsigned long long*>(smem + pl.ring);
  float* red = reinterpret_cast<float*>(kv_bar + 1);   // 2 kWarps + 4
  float* st = red + 2 * kWarps + 4;                     // 2 kRB: mu, inv
  float* lnp_s = st + 2 * kRB;                          // 2 C: scale, bias
  float* fac = lnp_s + 2 * C;          // kRB x 2 (kMaxAttn + 2): m / f, l
  float* red4 = fac + 2 * kRB * (kMaxAttn + 2);         // 4 x kRB x TC
  float* x_s = red4 + 4 * kRB * TC;                     // kRB x C
  float* in_s = x_s + kRB * C;                          // C x kInStride
  // the attention's scratch, over the rows' (phase 2 only)
  float* q_s = x_s;                                     // D
  float* wst = q_s + D;                                 // kWarps x (D + 2)
  int* ticket = reinterpret_cast<int*>(red + 2 * kWarps + 2);

  const int ns_attn = a.nattn, n_items = B * H * ns_attn;
  const int rf = rec_floats(D);
  const int sw = a.head_gran ? H : 1;                   // scales a pool row
  const long layer_rows = (long)a.N * a.psz;
  const int tile_slots = (4 * C + TC - 1) / TC;

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
  auto parts = [&](int p) { return a.part + (long)B * pl.part[p]; };
  auto items = [&](int p) { return pl.sp[p].ntile * pl.sp[p].nsplit; };
  // attention items from the top of the grid down, so that their blocks
  // are not the MLP-down's and can fetch the next layer's pages in phase 4
  const int first_attn = G0 - 1 - b0;

  // the rows [r0, r0 + n) of item i's slot history, and its (b, h, s)
  struct Item {
    int b, h, s, r0, n;
  };
  auto item_of = [&](int i) {
    Item it;
    it.s = i % ns_attn;
    const int bh = i / ns_attn;
    it.b = bh % B;
    it.h = bh / B;
    const int pos = a.pos[it.b];
    const int live = min((pos + a.psz - 1) / a.psz, a.mp);
    const int n_hist = min(pos, live * a.psz);
    it.r0 = it.s * a.attn_rows;
    const int r1 = it.s == ns_attn - 1 ? n_hist
                                       : min(it.r0 + a.attn_rows, n_hist);
    it.n = r1 > it.r0 ? r1 - it.r0 : 0;
    return it;
  };
  // the pool row of history row g of slot b (g inside its live pages)
  auto pool_row = [&](int b, int g) -> long {
    const int pi = g / a.psz;
    return (long)a.tables[(long)b * a.mp + pi] * a.psz + (g - pi * a.psz);
  };

  // The weight slabs: cp.async, one commit group a slab, every thread
  // committing the same groups in the same order; gid[] holds each
  // slot's group. The K/V rows: TMA bulk copies, one a row, on kv_bar,
  // layer l's phase with parity l & 1, armed by thread 0 (empty too).
  int committed = 0;
  int gid[kMaxSlabs];

  // slab j (layer j / 4, product j % 4) of the block's first item into
  // slot j % nslot
  auto slab_issue = [&](int j) {
    const int p = j % 4, l = j / 4, item = b0;
    if (l < L && item < items(p)) {
      const Split sp = pl.sp[p];
      const int K = k_of(p), N = n_of(p);
      const int k0 = (item / sp.ntile) * sp.ks, c0 = (item % sp.ntile) * TC;
      const int rows = min(sp.ks, K - k0);
      const T* w = weight(p, l) + (long)k0 * N + c0;
      unsigned char* dst = slabs + (long)(j % pl.nslot) * pl.slot;
      const int cv = tid % kTileVecs;
      if (c0 + cv * VEC < N)
        for (int r = tid / kTileVecs; r < rows; r += kRowGroups)
          kvq::cp_async16(dst + ((long)r * SR + cv * VEC) * sizeof(T),
                          w + (long)r * N + cv * VEC);
    }
    kvq::cp_async_commit();
    gid[j % pl.nslot] = committed++;
  };
  auto slab_wait = [&](int j) {
    kvq::cp_async_wait_dyn(committed - gid[j % pl.nslot] - 1);
    __syncthreads();
  };

  // The block's first attention item and the pool rows of its first
  // min(n, kv_rows) history rows do not depend on the layer: found once
  // (a thread keeps the rows of its kPreCopies copies)
  constexpr int kPreCopies = 4;
  const Item first_item = first_attn < n_items ? item_of(first_attn)
                                               : Item{0, 0, 0, 0, 0};
  const int n_pre_rows =
      first_attn < n_items ? min(first_item.n, pl.kv_rows) : 0;
  long pre_row[kPreCopies];
#pragma unroll
  for (int j = 0; j < kPreCopies; ++j) {
    const int e = tid + j * kThreads, r = e % max(n_pre_rows, 1);
    pre_row[j] = e < 2 * n_pre_rows ? pool_row(first_item.b,
                                               first_item.r0 + r)
                                    : 0;
  }

  // layer l's K and V rows of the block's first attention item
  auto kv_issue = [&](int l) {
    const int rows = n_pre_rows;
    const unsigned rb = D * sizeof(P);
    const long base = (long)l * layer_rows;
    auto copy = [&](int e, long prow) {
      const int v = e >= rows, r = e - v * rows;
      const long src = ((base + prow) * C + (long)first_item.h * D) *
                       sizeof(P);
      kvq::bulk_copy(ring + (v ? pl.kv_v : 0) + (long)r * rb,
                     static_cast<const unsigned char*>(v ? a.vp : a.kp) +
                         src,
                     rb, kv_bar);
    };
    if (rows > 0) kvq::fence_proxy_async();
#pragma unroll
    for (int j = 0; j < kPreCopies; ++j)
      if (tid + j * kThreads < 2 * rows) copy(tid + j * kThreads, pre_row[j]);
    for (int e = tid + kPreCopies * kThreads; e < 2 * rows; e += kThreads)
      copy(e, pool_row(first_item.b, first_item.r0 + e % rows));
    if (tid == 0) kvq::mbar_arm(kv_bar, 2u * rows * rb);
  };

  // The last block to finish a column tile of a residual product (the
  // output projection, MLP-down) at layer l sums the tile's slices in
  // split order, adds the bias, rounds, and writes the residual: after
  // attention (xmid), after the MLP (the next layer's input, the output
  // after the last). Every slot, four columns a thread.
  auto reduce_tile = [&](int p, int l, int tile) {
    const int N = n_of(p), c0 = tile * TC, ns = pl.sp[p].nsplit;
    const T* bb = bias(p, l);
    const float* Pp = parts(p);
    constexpr int nq = TC / 4;
    for (int e = tid; e < B * nq; e += kThreads) {
      const int b = e / nq, c = c0 + 4 * (e - b * nq);
      if (c >= N) continue;
      float bv[4], base[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bv[q] = to_f(bb[c + q]);
        const long i = (long)b * C + c + q;
        base[q] = p == kDown ? __ldcg(a.xmid + i)
                  : l == 0   ? to_f(a.x0[i])
                             : ld_cg(a.xout + i);
      }
      const float4 v = sum_parts4(Pp + (long)b * N + c, (long)B * N, ns);
      const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float y = round_to<T>(base[q] + round_to<T>(s[q] + bv[q]));
        const long i = (long)b * C + c + q;
        if (p == kProj)
          __stcg(a.xmid + i, y);
        else
          a.xout[i] = from_f<T>(y);
      }
    }
  };

  // The block's items of product p at layer l, slot group by slot group:
  // group(g0, nb) readies what the group's rows share (block-uniform),
  // prep(item, k0, rows, g0, nb) fills in_s[i * kInStride + r] with input
  // row k0 + i of slot g0 + r (zero for r >= nb). bf16 on the tensor
  // cores: a warp one 8-column strip of the tile over every input row, the
  // slots rows 0..7 of the m16 tile. f32 on the CUDA cores: a thread keeps
  // 4 slots' sums of one 16-byte column vector (lanes 8 column vectors x 4
  // row groups, warps 2 slot quads x 4 row quarters), so a weight vector
  // read from shared memory feeds 4 slots; the row groups meet by
  // shuffles, the quarters in red4 in order. The slice's partial sums go
  // to the scratch. The first item reads its slab from the ring; then the
  // slot takes the slab nslot ahead. For a residual product the last
  // block of each tile then sums the tile (reduce_tile); q / k / v and
  // the up rows are summed by the blocks that read them.
  auto product = [&](int p, int l, auto&& group, auto&& prep) {
    const Split sp = pl.sp[p];
    const int K = k_of(p), N = n_of(p), j = 4 * l + p;
    const int cv = lane & 7, rg = lane >> 3;
    const int sq = warp & 1, rgi = rg + 4 * (warp >> 1);   // 16 row groups
    float* Pp = parts(p);
    if (b0 < items(p)) {
      for (int g0 = 0; g0 < B; g0 += kRB) {
        const int nb = min(kRB, B - g0);
        group(g0, nb);
        for (int item = b0; item < items(p); item += G0) {
          const int k0 = (item / sp.ntile) * sp.ks;
          const int c0 = (item % sp.ntile) * TC;
          const int rows = min(sp.ks, K - k0);
          prep(item, k0, rows, g0, nb);
          const T* w;
          long stride;
          const bool ring_slab = item == b0 && pl.nslot > 0;
          if (ring_slab) {
            if (g0 == 0) slab_wait(j);
            STAMP(l, 24);
            w = reinterpret_cast<const T*>(slabs + (long)(j % pl.nslot) *
                                                       pl.slot);
            stride = SR;
          } else {
            w = weight(p, l) + (long)k0 * N + c0;
            stride = N;
          }
          const long pbase = (long)(item / sp.ntile) * B * N;
          if constexpr (kMma) {
            if (ring_slab) {
              // a warp one n8 column strip over every input row: 8 slots
              // are rows 0..7 of the m16 tile (rows 8..15 zero)
              const int g = lane >> 2, t = lane & 3, n0 = warp * 8;
              const float* in = in_s + g;
              auto at = [&](int k) {
                return k < rows ? in[k * kInStride] : 0.f;
              };
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              for (int k = 0; k < rows; k += 16) {
                const int ka = k + 2 * t, kb = ka + 8;
                uint32_t af[4];
                af[0] = pack_bf16(at(ka), at(ka + 1));
                af[1] = 0u;
                af[2] = pack_bf16(at(kb), at(kb + 1));
                af[3] = 0u;
                uint32_t b0f, b1f;
                ldsm_x2_trans(b0f, b1f,
                              w + (long)(k + (lane & 15)) * SR + n0);
                if (k + 16 > rows) {   // the slice's tail: stale slab rows
                  b0f &= (ka < rows ? 0xffffu : 0u) |
                         (ka + 1 < rows ? 0xffff0000u : 0u);
                  b1f &= (kb < rows ? 0xffffu : 0u) |
                         (kb + 1 < rows ? 0xffff0000u : 0u);
                }
                mma_bf16(c, af, b0f, b1f);
              }
              const int col = c0 + n0 + 2 * t;
              if (g < nb && col < N)
                __stcg(reinterpret_cast<float2*>(Pp + pbase +
                                                  (long)(g0 + g) * N + col),
                       make_float2(c[0], c[1]));
              __syncthreads();   // in_s is read: the next prep may refill it
              STAMP(l, 25);
              continue;
            }
          }
          const bool live = 4 * sq < nb && c0 + cv * VEC < N;
          float acc[4][VEC];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[r][q] = 0.f;
          if (live) {
            const float* in = in_s + 4 * sq;
#pragma unroll 2
            for (int i = rgi; i < rows; i += 16) {
              float wv[VEC];
              load_vec(w + (long)i * stride + cv * VEC, wv);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float hv = in[i * kInStride + r];
#pragma unroll
                for (int q = 0; q < VEC; ++q) acc[r][q] += hv * wv[q];
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
              float v = acc[r][q];
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              acc[r][q] = v;
            }
          if (rg == 0)
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < VEC; ++q)
                red4[((warp >> 1) * kRB + 4 * sq + r) * TC + cv * VEC + q] =
                    acc[r][q];
          __syncthreads();
          for (int e = tid; e < nb * TC; e += kThreads) {
            const int r = e / TC, c = e - r * TC;
            if (c0 + c < N)
              __stcg(Pp + pbase + (long)(g0 + r) * N + c0 + c,
                     ((red4[r * TC + c] + red4[(kRB + r) * TC + c]) +
                      red4[(2 * kRB + r) * TC + c]) +
                         red4[(3 * kRB + r) * TC + c]);
          }
          __syncthreads();   // in_s and red4 are free for the next
          STAMP(l, 25);
        }
      }
      for (int item = b0; (p == kProj || p == kDown) && item < items(p);
           item += G0) {
        const int tile = item % sp.ntile;
        int* cnt = a.tiles + p * tile_slots + tile;
        __syncthreads();   // the slices are stored (and *ticket is free)
        if (tid == 0) *ticket = add_acq_rel(cnt, 1);
        __syncthreads();
        STAMP(l, 26);
        if (*ticket == sp.nsplit - 1) {   // the tile's last slice
          reduce_tile(p, l, tile);
          if (tid == 0) *cnt = 0;         // its next use is a layer on
          STAMP(l, 27);
        }
      }
    }
    if (pl.nslot > 0) slab_issue(j + pl.nslot);
  };

  // A layernorm's scale and bias do not depend on the token: a thread's
  // 16 bytes of them load into registers before the barrier that precedes
  // their use (ln_issue) and land in lnp_s after it (ln_land; a row wider
  // than the block's 16-byte vectors loads its rest then)
  uint4 ln_raw = make_uint4(0u, 0u, 0u, 0u);
  auto ln_issue = [&](const T* lns, const T* lnb) {
    const int cv = C / VEC;
    if (tid < 2 * cv) {
      const int v = tid >= cv;
      ln_raw = load_raw((v ? lnb : lns) + (long)(tid - v * cv) * VEC);
    }
  };
  auto ln_land = [&](const T* lns, const T* lnb) {
    const int cv = C / VEC;
    if (tid < 2 * cv) unpack(ln_raw, lnp_s + (long)tid * VEC, T());
    for (int e = tid + kThreads; e < 2 * cv; e += kThreads) {
      const int v = e >= cv;
      load_vec((v ? lnb : lns) + (long)(e - v * cv) * VEC,
               lnp_s + (long)e * VEC);
    }
  };

  // The slot group's rows (T rows xt, or f32 rows xf) into x_s with their
  // layernorm statistics (mean, 1 / std) into st, and the layernorm's
  // scale and bias (every column) into lnp_s
  auto rows_in = [&](const T* xt, const float* xf, const T* lns,
                     const T* lnb, int g0, int nb) {
    const int cv = C / VEC;
    ln_land(lns, lnb);
    if (xt) {
#pragma unroll 4
      for (int e = tid; e < nb * cv; e += kThreads)
        load_vec_cg(xt + (long)g0 * C + (long)e * VEC, x_s + (long)e * VEC);
    } else {
#pragma unroll 4
      for (int e = tid; e < nb * C / 4; e += kThreads)
        load_vec_cg(xf + (long)g0 * C + 4L * e, x_s + 4L * e);
    }
    __syncthreads();
    // one warp a row: the mean, then the mean square deviation
    for (int r = warp; r < nb; r += kWarps) {
      const float* xr = x_s + r * C;
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) sum += xr[c];
      const float mu = decode::warp_sum(sum) / C;
      float sq = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = xr[c] - mu;
        sq += d * d;
      }
      const float inv = rsqrtf(decode::warp_sum(sq) / C + a.eps);
      if (lane == 0) {
        st[2 * r] = mu;
        st[2 * r + 1] = inv;
      }
    }
    __syncthreads();
  };
  // in_s = the layernormed slice [k0, k0 + rows) of the group's x_s rows
  auto ln_slice = [&](int k0, int rows, int nb) {
    for (int e = tid; e < kRB * rows; e += kThreads) {
      const int i = e / kRB, r = e - i * kRB, c = k0 + i;
      in_s[i * kInStride + r] =
          r < nb ? round_to<T>((x_s[r * C + c] - st[2 * r]) * st[2 * r + 1] *
                                   lnp_s[c] +
                               lnp_s[C + c])
                 : 0.f;
    }
    __syncthreads();
  };

  // q / k / v column c (in [0, 3C)) of slot b at layer l: the QKV
  // partials summed in split order, the bias, one rounding to T
  auto qkv_col = [&](int l, int b, int c) {
    const float bv = to_f(a.bqkv[(long)l * 3 * C + c]);   // issued first
    const float* Pq = parts(kQkv) + (long)b * 3 * C + c;
    return round_to<T>(
        decode::sum_parts(Pq, (long)B * 3 * C, pl.sp[kQkv].nsplit) + bv);
  };

  // The fresh column's scale for slot b, head h: the span of the whole
  // row (page granularity) or of the head's D lanes, over the rounded
  // raw row (`off` 0 for k, C for v)
  auto fresh_scale = [&](int l, int b, int h, int off) {
    float amax = 0.f;
    if (a.head_gran) {
      for (int d = tid; d < D; d += kThreads)
        amax = fmaxf(amax, fabsf(qkv_col(l, b, C + off + h * D + d)));
    } else {
#pragma unroll 2
      for (int c = tid; c < C; c += kThreads)
        amax = fmaxf(amax, fabsf(qkv_col(l, b, C + off + c)));
    }
    return kvq::span_scale(block_reduce(amax, red, true), kFp8);
  };

  // Attention item i at layer l: the online softmax of its rows into its
  // record; the last split (the shortest, if one is) also writes the raw
  // fresh K/V columns and the fresh column's record (m = s_new, l = 1, acc
  // = v_new); then the item counts itself done on its head.
  auto attend = [&](int i, int l) {
    const Item it = i == first_attn ? first_item : item_of(i);
    const int b = it.b, h = it.h;
    float* rb = a.rec + ((long)(b * H + h) * (kMaxAttn + 1)) * rf;
    if (it.s == ns_attn - 1) {
      // q and the fresh k / v columns, their loads in one batch; the raw
      // rows out; a quantized pool's fresh column at its span's scale
      float qd = 0.f, kn = 0.f, vn = 0.f;
      const bool mine = tid < D;   // D <= kThreads
      if (mine) {
        qd = qkv_col(l, b, h * D + tid);
        kn = qkv_col(l, b, C + h * D + tid);
        vn = qkv_col(l, b, 2 * C + h * D + tid);
        const long o = ((long)l * B + b) * C + (long)h * D + tid;
        q_s[tid] = qd;
        a.newk[o] = from_f<T>(kn);
        a.newv[o] = from_f<T>(vn);
      }
      if constexpr (kQuant) {
        const float sk = fresh_scale(l, b, h, 0);
        const float sv = fresh_scale(l, b, h, C);
        kn = round_to<T>(kvq::fake_quant(kn, sk, kFp8));
        vn = round_to<T>(kvq::fake_quant(vn, sv, kFp8));
      }
      float sn = 0.f;
      if (mine) {
        sn = qd * kn;
        __stcg(rb + (long)ns_attn * rf + tid, vn);
      }
      sn = block_reduce(sn, red, false);
      if (tid == 0) {
        __stcg(rb + (long)ns_attn * rf + D, sn * a.scale);
        __stcg(rb + (long)ns_attn * rf + D + 1, 1.f);
      }
    } else {
      for (int d = tid; d < D; d += kThreads)
        q_s[d] = qkv_col(l, b, h * D + d);
      __syncthreads();   // q_s is in
    }
    STAMP(l, 5);
    // lane groups of G lanes own whole rows: G 16-byte pool vectors, at
    // most 32, NVL a lane
    const int nvec = D / PVEC;
    int G = 1;
    while (2 * G <= nvec && 2 * G <= 32) G *= 2;
    const int gl = lane & (G - 1), gidx = tid / G, groups = kThreads / G;
    float qv[NVL][PVEC];
#pragma unroll
    for (int j = 0; j < NVL; ++j)
#pragma unroll
      for (int e = 0; e < PVEC; ++e) {
        const int d = (gl + j * G) * PVEC + e;
        qv[j][e] = d < D ? q_s[d] : 0.f;
      }
    const bool pre = i == first_attn && pl.kv_rows > 0;
    const int n_pre = pre ? min(it.n, pl.kv_rows) : 0;
    if (pre) kvq::mbar_wait(kv_bar, (unsigned)l & 1u);
    STAMP(l, 6);
    const P* kp = static_cast<const P*>(a.kp) + (long)l * layer_rows * C +
                  (long)h * D;
    const P* vp = static_cast<const P*>(a.vp) + (long)l * layer_rows * C +
                  (long)h * D;
    const float* ksl = kQuant ? a.ks + (long)l * layer_rows * sw : nullptr;
    const float* vsl = kQuant ? a.vs + (long)l * layer_rows * sw : nullptr;
    float m = kNegInf, ls = 0.f, acc[NVL * PVEC];
#pragma unroll
    for (int e = 0; e < NVL * PVEC; ++e) acc[e] = 0.f;
    for (int base = 0; base < it.n; base += groups) {   // block-uniform
      const int r = base + gidx;
      const bool ok = r < it.n;
      const P* kr;
      const P* vr;
      float sk = 1.f, sv = 1.f;
      long prow = 0;
      if (ok && (r >= n_pre || kQuant)) prow = pool_row(b, it.r0 + r);
      if (r < n_pre) {
        kr = kv_k + (long)r * D;
        vr = kv_v + (long)r * D;
      } else {
        kr = kp + prow * C;
        vr = vp + prow * C;
      }
      if constexpr (kQuant) {
        if (ok) {
          const long si = prow * sw + (a.head_gran ? h : 0);
          sk = __ldg(ksl + si);
          sv = __ldg(vsl + si);
        }
      }
      float s = 0.f, vv[NVL][PVEC];
#pragma unroll
      for (int j = 0; j < NVL; ++j) {
        const int vi = gl + j * G;
        if (ok && vi < nvec) {
          float kv[PVEC];
          load_vec(kr + vi * PVEC, kv);
          load_vec(vr + vi * PVEC, vv[j]);
#pragma unroll
          for (int e = 0; e < PVEC; ++e) {
            s += qv[j][e] * (kv[e] * sk);
            vv[j][e] *= sv;
          }
        } else {
#pragma unroll
          for (int e = 0; e < PVEC; ++e) vv[j][e] = 0.f;
        }
      }
      for (int o = G / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (ok) {
        s *= a.scale;
        const float mn = fmaxf(m, s);
        const float al = expf(m - mn), p = expf(s - mn);
        ls = ls * al + p;
#pragma unroll
        for (int j = 0; j < NVL; ++j)
#pragma unroll
          for (int e = 0; e < PVEC; ++e)
            acc[j * PVEC + e] = acc[j * PVEC + e] * al + p * vv[j][e];
        m = mn;
      }
    }
    STAMP(l, 7);
    // merge the lane groups of a warp (butterfly over lanes >= G apart)
    for (int o = G; o < 32; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o);
      const float lo = __shfl_xor_sync(0xffffffffu, ls, o);
      const float mn = fmaxf(m, mo);
      const float x = expf(m - mn), y = expf(mo - mn);
      ls = ls * x + lo * y;
#pragma unroll
      for (int e = 0; e < NVL * PVEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[e], o);
        acc[e] = acc[e] * x + ao * y;
      }
      m = mn;
    }
    if (lane < G) {
      float* wp = wst + warp * (D + 2);
#pragma unroll
      for (int j = 0; j < NVL; ++j) {
        const int vi = lane + j * G;
        if (vi < nvec)
#pragma unroll
          for (int e = 0; e < PVEC; ++e) wp[vi * PVEC + e] = acc[j * PVEC + e];
      }
      if (lane == 0) {
        wp[D] = m;
        wp[D + 1] = ls;
      }
    }
    __syncthreads();
    // the warps in warp order into the item's record
    float* rr = rb + (long)it.s * rf;
    for (int d = tid; d < D + 2; d += kThreads) {
      float M = kNegInf;
      for (int w8 = 0; w8 < kWarps; ++w8) M = fmaxf(M, wst[w8 * (D + 2) + D]);
      float A = 0.f;
      for (int w8 = 0; w8 < kWarps; ++w8) {
        const float* wp = wst + w8 * (D + 2);
        A += (d == D ? 0.f : wp[d]) * expf(wp[D] - M);
      }
      __stcg(rr + d, d == D ? M : A);
    }
    __syncthreads();   // the records are stored
    if (tid == 0) add_release(a.done + l * H + h, 1);
    STAMP(l, 8);
  };

  // The projection's inputs: the records of head h's slice [k0, k0 +
  // rows) merged by logsumexp in split order, the fresh column last,
  // divided and rounded to T, after every item of the head is done
  auto attn_inputs = [&](int l, int k0, int rows, int g0, int nb) {
    const int h = k0 / D, kk = k0 - h * D;
    const int nr = ns_attn + 1, fw = 2 * (kMaxAttn + 2);
    if (tid == 0) {
      const int* cnt = a.done + l * H + h;
      while (load_acquire(cnt) < B * ns_attn) __nanosleep(32);
    }
    __syncthreads();
    STAMP(l, 9);
    auto record = [&](int r, int s) {
      return a.rec + ((long)((g0 + r) * H + h) * (kMaxAttn + 1) + s) * rf;
    };
    // every load at once: a thread's first two elements' record values,
    // then every (m, l)
    const int n_el = kRB * rows;
    float acc0[kMaxAttn + 1], acc1[kMaxAttn + 1];
    auto load_el = [&](int e, float* acc) {
      const int r = e / rows, i = e - r * rows;
#pragma unroll
      for (int s = 0; s <= kMaxAttn; ++s)
        acc[s] = e < n_el && r < nb && s < nr ? __ldcg(record(r, s) + kk + i)
                                              : 0.f;
    };
    auto put_el = [&](int e, const float* acc) {
      if (e >= n_el) return;
      const int r = e / rows, i = e - r * rows;
      float v = 0.f;
      if (r < nb) {
        const float* f = fac + r * fw;
        float A = 0.f;
#pragma unroll
        for (int s = 0; s <= kMaxAttn; ++s)
          if (s < nr) A += acc[s] * f[s];
        v = round_to<T>(A / f[kMaxAttn + 1]);
      }
      in_s[i * kInStride + r] = v;
    };
    load_el(tid, acc0);
    load_el(tid + kThreads, acc1);
    for (int e = tid; e < nb * nr; e += kThreads) {
      const int r = e / nr, s = e - r * nr;
      fac[r * fw + s] = __ldcg(record(r, s) + D);
      fac[r * fw + kMaxAttn + 2 + s] = __ldcg(record(r, s) + D + 1);
    }
    __syncthreads();
    STAMP(l, 21);
    if (tid < nb) {   // a slot's factors exp(m_s - M) and its denominator
      float* f = fac + tid * fw;
      float M = kNegInf;
      for (int s = 0; s < nr; ++s) M = fmaxf(M, f[s]);
      float Ls = 0.f;
      for (int s = 0; s < nr; ++s) {
        f[s] = expf(f[s] - M);
        Ls += f[kMaxAttn + 2 + s] * f[s];
      }
      f[kMaxAttn + 1] = Ls;
    }
    __syncthreads();
    STAMP(l, 22);
    put_el(tid, acc0);
    put_el(tid + kThreads, acc1);
    for (int e = tid + 2 * kThreads; e < n_el; e += kThreads) {
      load_el(e, acc0);
      put_el(e, acc0);
    }
    STAMP(l, 23);
    __syncthreads();
    STAMP(l, 10);
  };

  // the MLP-down slice's inputs: the up columns [k0, k0 + rows) of each
  // slot, summed in split order, biased, rounded, activated and rounded
  // again; four columns a thread, two such groups' loads at once
  auto down_inputs = [&](int l, int k0, int rows, int g0, int nb) {
    const float* Pu = parts(kUp);
    const int nu = pl.sp[kUp].nsplit, rq = rows / 4;
    const T* bu = bias(kUp, l);
    // the bias of a group's four columns, its loads issued before the
    // partials'
    auto bias4 = [&](int e, float* bv) {
      const int r = e / rq, i = 4 * (e - r * rq);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bv[q] = e < kRB * rq ? to_f(bu[k0 + i + q]) : 0.f;
    };
    auto put = [&](int e, float4 v, const float* bv) {
      const int r = e / rq, i = 4 * (e - r * rq);
      const float sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float x = 0.f;
        if (r < nb) {
          const float u = round_to<T>(sv[q] + bv[q]);
          x = round_to<T>(a.gelu ? gelu_tanh(u) : fmaxf(u, 0.f));
        }
        in_s[(i + q) * kInStride + r] = x;
      }
    };
    auto sum4 = [&](int e) {
      const int r = e / rq, i = 4 * (e - r * rq);
      return r < nb ? sum_parts4(Pu + (long)(g0 + r) * 4 * C + k0 + i,
                                 (long)B * 4 * C, nu)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    for (int e = tid; e < kRB * rq; e += 2 * kThreads) {
      const int e1 = e + kThreads;
      float b0v[4], b1v[4];
      bias4(e, b0v);
      bias4(e1, b1v);
      const float4 v0 = sum4(e);
      const float4 v1 = e1 < kRB * rq ? sum4(e1) : make_float4(0, 0, 0, 0);
      put(e, v0, b0v);
      if (e1 < kRB * rq) put(e1, v1, b1v);
    }
    __syncthreads();
  };

  // The small tensors every phase reads once (the layernorms' scales and
  // biases, the products' biases, the rows, positions and tables) into L2
  // at once, spread over every thread of the grid: a phase then finds
  // them there rather than in device memory
  {
    const long step = (long)G0 * kThreads * 128;
    auto to_l2 = [&](const void* p, long bytes) {
      const char* c = static_cast<const char*>(p);
      for (long o = ((long)b0 * kThreads + tid) * 128; o < bytes; o += step)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + o));
    };
    const long lc = (long)L * C * sizeof(T);
    to_l2(a.ln1s, lc);
    to_l2(a.ln1b, lc);
    to_l2(a.ln2s, lc);
    to_l2(a.ln2b, lc);
    to_l2(a.bqkv, 3 * lc);
    to_l2(a.bproj, lc);
    to_l2(a.bup, 4 * lc);
    to_l2(a.bdown, lc);
    to_l2(a.x0, (long)B * C * sizeof(T));
    to_l2(a.tables, (long)B * a.mp * sizeof(int));
    to_l2(a.pos, (long)B * sizeof(int));
  }
  if (tid == 0) {
    kvq::mbar_init(kv_bar, 1);
    kvq::mbar_fence_init();
  }
  __syncthreads();   // the mbarrier is initialised before any copy to it
  for (int j = 0; j < pl.nslot; ++j) slab_issue(j);
  kv_issue(0);
  // the counters start at 0: no block counts before the first layer's
  // first barrier, which block 0 reaches after this
  if (b0 == 0) {
    for (int e = tid; e < L * H; e += kThreads) a.done[e] = 0;
    for (int e = tid; e < 4 * tile_slots; e += kThreads) a.tiles[e] = 0;
  }
  ln_issue(a.ln1s, a.ln1b);
  auto nothing = [](int, int) {};
  for (int l = 0; l < L; ++l) {
    const long lc = (long)l * C;
    // 1. LN1 of the residual rows; QKV partials
    STAMP(l, 0);
    product(kQkv, l,
            [&](int g0, int nb) {
              rows_in(l == 0 ? a.x0 : a.xout, nullptr, a.ln1s + lc,
                      a.ln1b + lc, g0, nb);
              STAMP(l, 1);
            },
            [&](int, int k0, int rows, int, int nb) {
              ln_slice(k0, rows, nb);
              STAMP(l, 2);
            });
    STAMP(l, 3);
    grid.sync();
    STAMP(l, 4);
    // 2. the attention items, then the projection's partials per head;
    // the residual after attention by tile
    for (int i = first_attn; i >= 0 && i < n_items; i += G0) attend(i, l);
    product(kProj, l, nothing,
            [&](int, int k0, int rows, int g0, int nb) {
              attn_inputs(l, k0, rows, g0, nb);
            });
    STAMP(l, 11);
    ln_issue(a.ln2s + lc, a.ln2b + lc);
    grid.sync();
    STAMP(l, 12);
    // 3. LN2 of the residual after attention; MLP-up partials
    product(kUp, l,
            [&](int g0, int nb) {
              rows_in(nullptr, a.xmid, a.ln2s + lc, a.ln2b + lc, g0, nb);
              STAMP(l, 13);
            },
            [&](int, int k0, int rows, int, int nb) {
              ln_slice(k0, rows, nb);
              STAMP(l, 14);
            });
    STAMP(l, 15);
    grid.sync();
    STAMP(l, 16);
    // 4. MLP-down partials over the activated up slice, the residual by
    // tile; the attention blocks fetch the next layer's K/V rows
    if (l + 1 < L) kv_issue(l + 1);
    STAMP(l, 17);
    product(kDown, l, nothing,
            [&](int, int k0, int rows, int g0, int nb) {
              down_inputs(l, k0, rows, g0, nb);
              STAMP(l, 18);
            });
    STAMP(l, 19);
    if (l + 1 < L) {
      ln_issue(a.ln1s + lc + C, a.ln1b + lc + C);
      grid.sync();
    }
    STAMP(l, 20);
  }
  kvq::cp_async_wait<0>();
}

// The plan at these shapes on a grid of `grid` blocks; no CUDA call.
int plan_on(int C, int H, int S, int isz, int pisz, int grid, Plan* out) {
  if (H <= 0 || C % H != 0 || grid < 1 || S < 1 ||
      smem_total(C, isz) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  *out = make_plan(C, H, S, isz, pisz, grid);
  if (out->nslot < 0 || out->kv_rows < 0) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, typename P>
auto kernel_for(int C, int H) {
  const int nvec = C / H / kvq::vec_elems<P>();
  return nvec > 32 ? fused_paged_kernel<T, P, 2> : fused_paged_kernel<T, P, 1>;
}

// The plan on the current device: every block the card holds resident at
// the kernel's shared memory. It also lets the kernel take the card's
// largest carve-up, so that a launch needs no further CUDA call: the
// wrapper asks once per shape and device and hands the grid to every
// launch.
template <typename T, typename P>
int plan_for(int C, int H, int S, Plan* out) {
  if (H <= 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  const long smem = smem_total(C, (int)sizeof(T));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = kernel_for<T, P>(C, H);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return plan_on(C, H, S, (int)sizeof(T), (int)sizeof(P), per_sm * sms, out);
}

// a grid the card cannot hold resident is refused by the cooperative
// launch itself (no fallback)
template <typename T, typename P>
int launch(Args<T> a, int span, int grid, cudaStream_t stream) {
  if (a.D % kvq::vec_elems<T>() != 0 || a.D % kvq::vec_elems<P>() != 0 ||
      a.D > kThreads || kThreads % a.D != 0 || a.C != a.H * a.D ||
      a.B < 1 || (std::is_same<P, T>::value != (a.ks == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int S = a.mp * a.psz;
  int err = plan_on(a.C, a.H, S, (int)sizeof(T), (int)sizeof(P), grid,
                    &a.plan);
  if (err != 0) return err;
  span = span < 1 ? 1 : span > S ? S : span;
  a.nattn = attn_splits(span, a.B * a.H, grid);
  a.attn_rows = (span + a.nattn - 1) / a.nattn;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel_for<T, P>(a.C, a.H)), dim3(grid),
      dim3(kThreads), args, a.plan.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* const* p, int pool, int L, int B, int C, int H, int N,
        int psz, int mp, int span, int gelu, int head_gran, float eps,
        int grid, cudaStream_t stream) {
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
  // the f32 scratch (fused_paged_scratch_floats in ops/decode.py):
  // partials | attention records | xmid | the heads' and the tiles'
  // counters
  Plan pl = make_plan(C, H, mp * psz, (int)sizeof(T), 1, grid);
  float* scratch = static_cast<float*>(const_cast<void*>(p[22]));
  a.part = scratch;
  a.rec = a.part + (long)B * pl.part_row;
  a.xmid = a.rec + (long)B * H * (kMaxAttn + 1) * rec_floats(a.D);
  a.done = reinterpret_cast<int*>(a.xmid + (long)B * C);
  a.tiles = a.done + L * H;
  if (pool == 0) return launch<T, T>(a, span, grid, stream);
  if (pool == 1) return launch<T, int8_t>(a, span, grid, stream);
  if (pool == 2) return launch<T, __nv_fp8_e4m3>(a, span, grid, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int plan_pool(int pool, int C, int H, int S, Plan* p) {
  if (pool == 0) return plan_for<T, T>(C, H, S, p);
  if (pool == 1) return plan_for<T, int8_t>(C, H, S, p);
  if (pool == 2) return plan_for<T, __nv_fp8_e4m3>(C, H, S, p);
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
// newk, newv (L x B x C), and the f32 scratch (fused_paged_scratch_floats
// in ops/decode.py). span: the caller's bound on every slot's pos, which
// sizes the attention's split (any value gives the right result). gelu:
// 1 for tanh-GELU, 0 ReLU. grid: the plan's (fused_paged_decode_layers_plan,
// on this device). The kernel trusts the live prefix of each table row
// to hold page ids inside the pool; entries past it are never read.
extern "C" int fused_paged_decode_layers_launch(
    const void* const* ptrs, int L, int B, int C, int H, int N, int psz,
    int mp, int span, int gelu, int head_gran, float eps, int dtype,
    int pool, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || C % H != 0 || mp < 1 || psz < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(ptrs, pool, L, B, C, H, N, psz, mp, span, gelu,
                      head_gran, eps, grid, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(ptrs, pool, L, B, C, H, N, psz, mp, span, gelu,
                              head_gran, eps, grid, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef FUSED_PAGED_STAMPS
// the stamps of the last launch, (kStampBlocks, kStampLayers,
// kStampPoints) cycles
extern "C" int fused_paged_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}
#endif

// The launch's plan on the current device, into out[0..19]: grid; ntile,
// nsplit, ks of QKV, projection, MLP up, MLP down; the partial floats a
// slot; weight slots; history rows held; dynamic shared memory; slot
// bytes; the ring's bytes; the split rule's kAttnRows and kMaxAttn.
// S: the table's rows (max_pages * page).
extern "C" int fused_paged_decode_layers_plan(int C, int H, int S, int dtype,
                                              int pool, long* out) {
  Plan p;
  const int err = dtype == 0   ? plan_pool<float>(pool, C, H, S, &p)
                  : dtype == 1 ? plan_pool<__nv_bfloat16>(pool, C, H, S, &p)
                               : (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  out[0] = p.grid;
  for (int i = 0; i < 4; ++i) {
    out[1 + 3 * i] = p.sp[i].ntile;
    out[2 + 3 * i] = p.sp[i].nsplit;
    out[3 + 3 * i] = p.sp[i].ks;
  }
  out[13] = p.part_row;
  out[14] = p.nslot;
  out[15] = p.kv_rows;
  out[16] = p.smem;
  out[17] = p.slot;
  out[18] = kAttnRows;
  out[19] = kMaxAttn;
  return 0;
}
