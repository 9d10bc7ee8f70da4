// Windowed paged attention for one layer of a packed KV page pool.
//
// Replaces replicatinggpt_tpu/ops/paged_pallas.py:_paged_window_kernel,
// both of its modes, quantized or not. For every slot b a window of W
// fresh query rows (row j at logical position pos[b] + j) attends the
// STALE pool rows at positions < pos[b], addressed through the slot's
// page table, and then (fold mode) the fresh (W, W) K/V block causally.
// Scores, running max, denominator and accumulator are f32; the output
// is written in the input dtype (bf16 or f32). The partials mode (the
// JAX kernel's fold=False, which its shard_map wrapper runs on each
// data shard of a serving mesh) reads only the live pages that an owned
// mask marks (one shard's block, the table then holding ids local to
// it) and writes the raw f32 state per (slot, row, head): acc (B, W, C),
// m and l (B, W, H), m = -1e30 and l = acc = 0 where the slot owns no
// page; the caller merges the shards and folds the fresh window once.
// A quantized pool (int8 or
// fp8 e4m3 pages with f32 scales per row, or per row and head) is
// dequantized in f32 as its rows are used, f32(q) * scale, never
// rounded to the compute dtype; the caller hands the fresh window
// already fake-quantized (quant/kv.py).
//
// Bound on this card: bytes. One call reads sum_b live_b * psz * C * 2 *
// itemsize bytes of K+V pages (live_b = ceil(pos[b] / psz); plus 8 or
// 8 * H scale bytes per row when quantized) and does about 4 flops per
// page element read, far below the H100's ~295 flops/byte ridge, so its
// floor is those bytes at 3.35 TB/s. At the serving step's small batch
// those bytes are few (~7 MB at GPT-2 124M, B=8), so what sets the time
// is how many loads are in flight on how many SMs, and the longest
// slot's history.
//
// Design. A thread-block cluster of R CTAs (R <= 8, cudaLaunchKernelEx
// with a cluster dimension; R = 1 is a plain grid with no cluster
// barrier) serves one (slot, head); the grid is (R, H, B). R is sized
// from W and a span of history rows that the caller already holds on
// the host, never from pos read back: the engine's step passes the
// longest slot's position, other callers get the table's whole
// max_pages * page_size (plan below, mirrored by cluster_ranks in
// ops/paged_attention.py). A short history thus launches one CTA per
// (slot, head), and no idle rank holds an SM while its cluster waits.
// - Every CTA lists the slot's pages to read in shared memory: the live
//   prefix, or with an owned mask (the partials mode) the live pages it
//   marks, an arbitrary subset under allocation churn, compacted by warp
//   0 (ballots over 32 table entries at a time). Their rows, in logical
//   order (only the last live page can be partial, and it comes last),
//   are cut into tiles of `tile` rows (64, fewer where a row is wide)
//   and dealt round-robin: tile t to rank t % R. A rank that owns no
//   tile contributes m = -1e30, l = 0, loads nothing but the table row
//   and the query rows, and no rank reads a table entry past the live
//   frontier, a page that is not its own or a row >= pos. The span that
//   sizes R is then the caller's bound on the rows a slot owns.
// - Each CTA copies its tiles into a ring of 2-4 stages in shared memory
//   with 16-byte cp.async copies, every stage at once, in the pool's own
//   type (bf16, f32, int8 or fp8, with the rows' scales), converted at
//   use; a rank with more tiles than stages streams them, one barrier a
//   tile handing a stage over. The live table prefix is loaded once.
// - Inside a CTA every lane group of G lanes (G = 16-byte vectors of a
//   row, at most 32) owns whole rows: scores by shuffles over the group,
//   then its own online softmax (m, l, acc) in registers for up to 4
//   query rows at a time (W > 4 walks the tiles again). Groups merge by
//   shuffles, warps through shared memory, once a pass.
// - The ranks merge by logsumexp through distributed shared memory
//   (cg::this_cluster().map_shared_rank), in rank order, on rank 0: one
//   thread an element, every rank's loads in flight at once. Rank 0 then
//   folds the fresh (W, W) block in causally from shared memory (it
//   loaded the fresh rows with the queries) and writes the rows, or, in
//   partials mode, writes the merged (acc, m, l) as they are.
// What is left for later: tensor cores (mma) for wide windows; a batch
// whose slots' histories differ widely still sizes every cluster for the
// longest one (a persistent grid over (slot, head, tile) work would
// not).
//
// Plain C interface (ctypes); the launch returns cudaGetLastError().

#include <cooperative_groups.h>

#include "kv_quant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;          // ring stages of one CTA, at most
constexpr int kMaxTile = 64;        // history rows per tile
constexpr int kMinTile = 8;
constexpr int kStageBytes = 16384;  // K+V bytes of one stage, at most
constexpr int kMaxRanks = 8;        // CTAs of a cluster (portable size)
constexpr int kMaxLaneCols = 8;     // D / 32 columns a lane, D <= 256
constexpr size_t kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

// query rows one pass over the history holds in registers
__host__ __device__ constexpr int pass_rows(int W) { return W == 1 ? 1 : 4; }

// Byte offsets of one CTA's dynamic shared memory; keep in step with
// smem_bytes() in ops/paged_attention.py. The K/V ring (stages x {K, V}
// x tile x D elements of the pool type, then stages x {K, V} x tile f32
// scales when quantized) shares its bytes with the warps' partial states
// of a pass ("uni"); then the window's query rows and its fresh K and V
// rows (3 x W x D f32), the CTA's merged state (W x D acc, W m, W l) and
// the live table prefix (mp int32).
struct Carve {
  int tile, stages, ranks;
  size_t kv, uni, q, kn, vn, part, tab, total;
};

__host__ __device__ inline Carve carve(int W, int D, int mp, int isz,
                                       bool quant, int tile, int stages) {
  Carve c;
  c.tile = tile;
  c.stages = stages;
  c.ranks = 1;
  c.kv = (size_t)stages * 2 * tile * D * isz;
  const size_t ring = c.kv + (quant ? (size_t)stages * 2 * tile * 4 : 0);
  const size_t warps = (size_t)kWarps * pass_rows(W) * (D + 2) * 4;
  c.uni = ring > warps ? ring : warps;
  c.q = c.uni;
  c.kn = c.q + (size_t)W * D * 4;
  c.vn = c.kn + (size_t)W * D * 4;
  c.part = c.vn + (size_t)W * D * 4;
  c.tab = c.part + (size_t)W * (D + 2) * 4;
  c.total = c.tab + (size_t)mp * 4;
  return c;
}

// 64-row tiles, halved while a stage passes kStageBytes or the CTA (at
// kStages) the card's shared memory
__host__ __device__ inline int tile_rows(int W, int D, int mp, int isz,
                                         bool quant) {
  int tile = kMaxTile;
  while (tile > kMinTile &&
         ((size_t)2 * tile * D * isz > (size_t)kStageBytes ||
          carve(W, D, mp, isz, quant, tile, kStages).total > kMaxSmem))
    tile /= 2;
  return tile;
}

// The launch's split for a history of `span` rows (the caller's bound on
// every slot's pos, the table's mp * psz when it has none; clamped to 1
// .. mp * psz): the fewest ranks (at most kMaxRanks) that hold all of
// their tiles in flight at once, times the passes over them a wide
// window makes, and a ring of a rank's tiles of one pass, 2 to kStages
// stages, fewer while the CTA passes the card's shared memory. Any span
// gives the right result: a rank with more tiles than stages streams
// them. Keep in step with cluster_ranks() / ring_stages() in
// ops/paged_attention.py.
__host__ __device__ inline Carve plan(int W, int D, int mp, int psz,
                                      int isz, bool quant, int span) {
  const int tile = tile_rows(W, D, mp, isz, quant);
  span = span < 1 ? 1 : span > mp * psz ? mp * psz : span;
  const int tiles = (span + tile - 1) / tile;
  const int work = tiles * ((W + pass_rows(W) - 1) / pass_rows(W));
  int ranks = (work + kStages - 1) / kStages;
  ranks = ranks > kMaxRanks ? kMaxRanks : ranks;
  int stages = (tiles + ranks - 1) / ranks;
  stages = stages < 2 ? 2 : stages > kStages ? kStages : stages;
  while (stages > 2 &&
         carve(W, D, mp, isz, quant, tile, stages).total > kMaxSmem)
    --stages;
  Carve c = carve(W, D, mp, isz, quant, tile, stages);
  c.ranks = ranks;
  return c;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, typename P>
struct Args {
  const T* q;
  const T* k_new;
  const T* v_new;
  const P* k_pages;
  const P* v_pages;
  const float* k_scales;   // null for an unquantized pool
  const float* v_scales;
  const int* tables;
  const int* pos;
  const int* owned;        // partials mode's (B, mp) mask; null: every
                           // live page
  T* out;                  // fold mode's output, else null
  float* acc_out;          // partials mode's (B, W, H * D) f32
  float* m_out;            // and (B, W, H) f32
  float* l_out;
  int W, psz, mp, H, D, head_gran;
  float scale;
  Carve cv;
};

// T: the window rows' and output's dtype; P: the pool's (T, int8 or fp8).
// NVL: 16-byte vectors of a row one lane holds (1 or 2); WQ: query rows
// a pass holds in registers (1 at W = 1, else 4); OWN: an owned mask is
// given (its own instantiation, so the plain table's code is untouched).
template <typename T, typename P, int NVL, int WQ, bool OWN>
__global__ void __launch_bounds__(kThreads)
paged_window_kernel(const Args<T, P> a) {
  constexpr int PVEC = kvq::vec_elems<P>();
  constexpr int VEC = kvq::vec_elems<T>();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;   // the cluster spans gridDim.x
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int W = a.W, D = a.D, C = a.H * a.D, TR = a.cv.tile;
  const int nvec = D / PVEC;
  int G = 1;                     // lanes a row: 2^k <= min(32, nvec)
  while (2 * G <= nvec && 2 * G <= 32) G *= 2;
  const int gl = lane & (G - 1);
  const int groups = kThreads / G;
  const int gidx = tid / G;
  const bool quant = a.k_scales != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* sc_ring = reinterpret_cast<float*>(smem + a.cv.kv);
  float* wpart = reinterpret_cast<float*>(smem);   // aliases the ring
  float* q_s = reinterpret_cast<float*>(smem + a.cv.q);
  float* kn_s = reinterpret_cast<float*>(smem + a.cv.kn);
  float* vn_s = reinterpret_cast<float*>(smem + a.cv.vn);
  float* acc_s = reinterpret_cast<float*>(smem + a.cv.part);
  float* m_s = acc_s + W * D;
  float* l_s = m_s + W;
  int* tab_s = reinterpret_cast<int*>(smem + a.cv.tab);

  const bool fold = a.out != nullptr;
  const int pos = a.pos[b];
  const int live = min((pos + a.psz - 1) / a.psz, a.mp);
  const size_t row0 = (size_t)b * W * C + (size_t)h * D;
  // the pages to read into tab_s, in logical order, and their row count:
  // the live prefix, copied by the CTAs that own tiles of it (its rows
  // are known from pos alone); or, with an owned mask (OWN), the live
  // pages it marks, compacted by warp 0 of every CTA, which leaves their
  // row count in the first word of acc_s (nothing else touches it before
  // the pass loop's merges). Meanwhile the other threads load the query
  // rows (a rank with tiles, and rank 0 of the fold) and the fresh rows
  // (rank 0 of the fold).
  auto tiles_of = [&](int n_rows) {
    const int n_tiles = (n_rows + TR - 1) / TR;
    return rank < n_tiles ? (n_tiles - rank + a.cv.ranks - 1) / a.cv.ranks
                          : 0;
  };
  const int prefix_rows = min(pos, live * a.psz);
  const int prefix_mine = tiles_of(prefix_rows);
  if (OWN && warp == 0) {
    int n = 0, last = -1;
    for (int p0 = 0; p0 < live; p0 += 32) {
      const int p = p0 + lane;
      const bool own = p < live && a.owned[(size_t)b * a.mp + p] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, own);
      if (own)
        tab_s[n + __popc(bal & ((1u << lane) - 1u))] =
            a.tables[(size_t)b * a.mp + p];
      if (bal) last = p0 + 31 - __clz(bal);
      n += __popc(bal);
    }
    // only the last live page can be partial, and it is last if owned
    if (lane == 0)
      reinterpret_cast<int*>(acc_s)[0] =
          n * a.psz - (last == live - 1 ? max(live * a.psz - pos, 0) : 0);
  } else if (OWN || prefix_mine > 0 || (rank == 0 && fold)) {
    const int first = OWN ? 32 : 0;
    for (int e = tid - first; e < W * (D / VEC); e += kThreads - first) {
      const int w = e / (D / VEC), c = (e % (D / VEC)) * VEC;
      const size_t off = row0 + (size_t)w * C + c;
      kvq::load_vec(a.q + off, q_s + w * D + c);
      if (rank == 0 && fold) {
        kvq::load_vec(a.k_new + off, kn_s + w * D + c);
        kvq::load_vec(a.v_new + off, vn_s + w * D + c);
      }
    }
    if (!OWN && prefix_mine > 0)
      for (int p = tid; p < live; p += kThreads)
        tab_s[p] = a.tables[(size_t)b * a.mp + p];
  }
  __syncthreads();
  const int n_hist =
      OWN ? reinterpret_cast<const int*>(acc_s)[0] : prefix_rows;
  const int mine = OWN ? tiles_of(n_hist) : prefix_mine;
  const int NS = a.cv.stages;
  const size_t stage_bytes = (size_t)2 * TR * D * sizeof(P);
  const int cp_step = kThreads / (2 * nvec);   // rows a copy pass, >= 2
  const int cp_col = tid % (2 * nvec);

  // the CTA's k-th tile (history tile rank + k * R) into stage k % NS,
  // one commit group
  auto issue = [&](int k) {
    {
      const int t0 = (rank + k * a.cv.ranks) * TR;
      const int rows = min(TR, n_hist - t0);
      unsigned char* st = ring + (size_t)(k % NS) * stage_bytes;
      // a thread keeps one 16-byte column of K or V and steps over rows
      if (tid < cp_step * 2 * nvec) {
        const int v = cp_col >= nvec, c = cp_col - v * nvec;
        const P* pages = v ? a.v_pages : a.k_pages;
        for (int r = tid / (2 * nvec); r < rows; r += cp_step) {
          const int g = t0 + r, pi = g / a.psz;
          const size_t prow = (size_t)tab_s[pi] * a.psz + (g - pi * a.psz);
          kvq::cp_async16(
              st + ((size_t)v * TR + r) * D * sizeof(P) + c * 16,
              pages + prow * C + (size_t)h * D + (size_t)c * PVEC);
        }
      }
      if (quant) {
        float* ss = sc_ring + (k % NS) * 2 * TR;
        for (int e = tid; e < 2 * rows; e += kThreads) {
          const int v = e >= rows, r = e - v * rows;
          const int g = t0 + r, pi = g / a.psz;
          const size_t prow = (size_t)tab_s[pi] * a.psz + (g - pi * a.psz);
          const size_t si = a.head_gran ? prow * a.H + h : prow;
          kvq::cp_async4(ss + v * TR + r, (v ? a.v_scales : a.k_scales) + si);
        }
      }
    }
    kvq::cp_async_commit();
  };

  for (int w0 = 0; w0 < W; w0 += WQ) {
    float m[WQ], l[WQ], acc[WQ][NVL * PVEC];
#pragma unroll
    for (int i = 0; i < WQ; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NVL * PVEC; ++j) acc[i][j] = 0.f;
    }
    // every stage filled at once; a stage freed by tile k - 1 takes tile
    // k + NS - 1 (a rank with more tiles than stages streams them)
    int issued = 0;
    for (; issued < NS && issued < mine; ++issued) issue(issued);
    for (int k = 0; k < mine; ++k) {
      kvq::cp_async_wait_dyn(issued - k - 1);
      __syncthreads();   // tile k is in; every warp is done with tile k-1
      if (k > 0 && issued < mine) issue(issued++);
      const int t0 = (rank + k * a.cv.ranks) * TR;
      const int rows = min(TR, n_hist - t0);
      const P* ks = reinterpret_cast<const P*>(
          ring + (size_t)(k % NS) * stage_bytes);
      const P* vs = ks + (size_t)TR * D;
      const float* ss = sc_ring + (k % NS) * 2 * TR;
      for (int r0 = 0; r0 < rows; r0 += groups) {   // block-uniform bound
        const int r = r0 + gidx;
        const bool ok = r < rows;
        const int rr = ok ? r : 0;
        const float sk = quant ? ss[rr] : 1.f;
        const float sv = quant ? ss[TR + rr] : 1.f;
        float s[WQ], vv[NVL][PVEC];
#pragma unroll
        for (int i = 0; i < WQ; ++i) s[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NVL; ++j) {
          const int vi = gl + j * G;
          if (vi < nvec) {
            float kv[PVEC];
            kvq::load_vec(ks + (size_t)rr * D + vi * PVEC, kv);
            kvq::load_vec(vs + (size_t)rr * D + vi * PVEC, vv[j]);
            if (quant) {
#pragma unroll
              for (int i = 0; i < PVEC; ++i) {
                kv[i] *= sk;
                vv[j][i] *= sv;
              }
            }
#pragma unroll
            for (int wq = 0; wq < WQ; ++wq) {
              const float* qq = q_s + min(w0 + wq, W - 1) * D + vi * PVEC;
#pragma unroll
              for (int i = 0; i < PVEC; ++i) s[wq] += qq[i] * kv[i];
            }
          } else {
#pragma unroll
            for (int i = 0; i < PVEC; ++i) vv[j][i] = 0.f;
          }
        }
#pragma unroll
        for (int wq = 0; wq < WQ; ++wq)
          for (int o = G / 2; o > 0; o >>= 1)
            s[wq] += __shfl_xor_sync(0xffffffffu, s[wq], o);
        if (ok) {
#pragma unroll
          for (int wq = 0; wq < WQ; ++wq) {
            if (w0 + wq < W) {
              const float sc = s[wq] * a.scale;
              const float mn = fmaxf(m[wq], sc);
              const float al = expf(m[wq] - mn), p = expf(sc - mn);
              l[wq] = l[wq] * al + p;
#pragma unroll
              for (int j = 0; j < NVL; ++j)
#pragma unroll
                for (int i = 0; i < PVEC; ++i)
                  acc[wq][j * PVEC + i] =
                      acc[wq][j * PVEC + i] * al + p * vv[j][i];
              m[wq] = mn;
            }
          }
        }
      }
    }
    // merge the lane groups of a warp (butterfly over lanes >= G apart)
    for (int o = G; o < 32; o <<= 1) {
#pragma unroll
      for (int wq = 0; wq < WQ; ++wq) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[wq], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[wq], o);
        const float mn = fmaxf(m[wq], mo);
        const float x = expf(m[wq] - mn), y = expf(mo - mn);
        l[wq] = l[wq] * x + lo * y;
#pragma unroll
        for (int j = 0; j < NVL * PVEC; ++j) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[wq][j], o);
          acc[wq][j] = acc[wq][j] * x + ao * y;
        }
        m[wq] = mn;
      }
    }
    kvq::cp_async_wait<0>();
    __syncthreads();   // the ring is read: the warps' states may take it
    if (lane < G) {
#pragma unroll
      for (int wq = 0; wq < WQ; ++wq) {
        float* wp = wpart + (warp * WQ + wq) * (D + 2);
#pragma unroll
        for (int j = 0; j < NVL; ++j) {
          const int vi = lane + j * G;
          if (vi < nvec)
#pragma unroll
            for (int i = 0; i < PVEC; ++i)
              wp[vi * PVEC + i] = acc[wq][j * PVEC + i];
        }
        if (lane == 0) {
          wp[D] = m[wq];
          wp[D + 1] = l[wq];
        }
      }
    }
    __syncthreads();
    // merge the warps, in warp order, into the CTA's state
    for (int e = tid; e < WQ * D; e += kThreads) {
      const int wq = e / D, d = e % D;
      if (w0 + wq >= W) continue;
      float M = kNegInf;
      for (int i = 0; i < kWarps; ++i)
        M = fmaxf(M, wpart[(i * WQ + wq) * (D + 2) + D]);
      float L = 0.f, A = 0.f;
      for (int i = 0; i < kWarps; ++i) {
        const float* wp = wpart + (i * WQ + wq) * (D + 2);
        const float f = expf(wp[D] - M);
        L += wp[D + 1] * f;
        A += wp[d] * f;
      }
      acc_s[(w0 + wq) * D + d] = A;
      if (d == 0) {
        m_s[w0 + wq] = M;
        l_s[w0 + wq] = L;
      }
    }
    __syncthreads();   // the ring is free for the next pass
  }

  // one rank: its state is the slot's (the pass loop's last barrier
  // published it); else every rank's state is in its shared memory
  const bool split = a.cv.ranks > 1;
  if (split) cluster.sync();
  if (rank == 0 && split) {
    // the ranks by logsumexp, in rank order: one thread an element, the
    // ranks' loads all in flight
    float Ms[(kMaxLaneCols * 32 + kThreads - 1) / kThreads];
    float Ls[(kMaxLaneCols * 32 + kThreads - 1) / kThreads];
    float As[(kMaxLaneCols * 32 + kThreads - 1) / kThreads];
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int i = 0; i * kThreads < kMaxLaneCols * 32; ++i) {
        const int d = tid + i * kThreads;
        if (d >= D) continue;
        float mr[kMaxRanks], lr[kMaxRanks], ar[kMaxRanks];
#pragma unroll
        for (int r = 0; r < kMaxRanks; ++r) {
          if (r < a.cv.ranks) {
            mr[r] = cluster.map_shared_rank(m_s, r)[w];
            lr[r] = cluster.map_shared_rank(l_s, r)[w];
            ar[r] = cluster.map_shared_rank(acc_s, r)[w * D + d];
          }
        }
        float M = kNegInf;
#pragma unroll
        for (int r = 0; r < kMaxRanks; ++r)
          if (r < a.cv.ranks) M = fmaxf(M, mr[r]);
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxRanks; ++r) {
          if (r < a.cv.ranks) {
            const float f = expf(mr[r] - M);
            L += lr[r] * f;
            A += ar[r] * f;
          }
        }
        Ms[i] = M;
        Ls[i] = L;
        As[i] = A;
      }
      __syncthreads();   // every read of this row's state is done
#pragma unroll
      for (int i = 0; i * kThreads < kMaxLaneCols * 32; ++i) {
        const int d = tid + i * kThreads;
        if (d >= D) continue;
        acc_s[w * D + d] = As[i];
        if (d == 0) {
          m_s[w] = Ms[i];
          l_s[w] = Ls[i];
        }
      }
    }
    __syncthreads();
  }
  if (rank == 0 && !fold) {
    // partials mode: the merged state as it is
    for (int e = tid; e < W * D; e += kThreads) {
      const int w = e / D, d = e % D;
      a.acc_out[row0 + (size_t)w * C + d] = acc_s[w * D + d];
    }
    for (int w = tid; w < W; w += kThreads) {
      const size_t o = ((size_t)b * W + w) * a.H + h;
      a.m_out[o] = m_s[w];
      a.l_out[o] = l_s[w];
    }
  }
  if (rank == 0 && fold) {
    // the fresh rows j <= w, in order, a warp a query row
    for (int w = warp; w < W; w += kWarps) {
      float M = m_s[w], L = l_s[w], A[kMaxLaneCols];
#pragma unroll
      for (int i = 0; i < kMaxLaneCols; ++i) {
        const int d = lane + 32 * i;
        A[i] = d < D ? acc_s[w * D + d] : 0.f;
      }
      for (int j = 0; j <= w; ++j) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxLaneCols; ++i) {
          const int d = lane + 32 * i;
          if (d < D) s += q_s[w * D + d] * kn_s[j * D + d];
        }
        s = warp_sum(s) * a.scale;
        const float mn = fmaxf(M, s);
        const float al = expf(M - mn), p = expf(s - mn);
        L = L * al + p;   // >= the diagonal term, > 0
#pragma unroll
        for (int i = 0; i < kMaxLaneCols; ++i) {
          const int d = lane + 32 * i;
          if (d < D) A[i] = A[i] * al + p * vn_s[j * D + d];
        }
        M = mn;
      }
#pragma unroll
      for (int i = 0; i < kMaxLaneCols; ++i) {
        const int d = lane + 32 * i;
        if (d < D) store(a.out + row0 + (size_t)w * C + d, A[i] / L);
      }
    }
  }
  if (split) cluster.sync();   // no rank leaves while rank 0 reads it
}

template <typename T, typename P, int NVL, int WQ, bool OWN>
int launch_kernel(const Args<T, P>& a, int B, cudaStream_t stream) {
  auto kernel = paged_window_kernel<T, P, NVL, WQ, OWN>;
  const size_t smem = a.cv.total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cv.ranks, a.H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cv.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cv.ranks > 1 ? 1 : 0;   // one rank: a plain grid
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename P, int NVL, int WQ>
int launch_own(const Args<T, P>& a, int B, cudaStream_t stream) {
  if (a.owned != nullptr)
    return launch_kernel<T, P, NVL, WQ, true>(a, B, stream);
  return launch_kernel<T, P, NVL, WQ, false>(a, B, stream);
}

template <typename T, typename P>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_pages, const void* v_pages, const float* k_scales,
           const float* v_scales, int head_gran, const int* tables,
           const int* pos, const int* owned, void* out, float* acc_out,
           float* m_out, float* l_out, int B, int W, int psz, int mp, int H,
           int D, int span, cudaStream_t stream) {
  const bool quant = k_scales != nullptr;
  if (W < 1 || D % kvq::vec_elems<T>() != 0 ||
      D % kvq::vec_elems<P>() != 0 || D > 32 * kMaxLaneCols || H > 65535 ||
      B > 65535 || quant != (v_scales != nullptr) ||
      (out == nullptr) == (acc_out == nullptr || m_out == nullptr ||
                           l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Args<T, P> a;
  a.q = static_cast<const T*>(q);
  a.k_new = static_cast<const T*>(k_new);
  a.v_new = static_cast<const T*>(v_new);
  a.k_pages = static_cast<const P*>(k_pages);
  a.v_pages = static_cast<const P*>(v_pages);
  a.k_scales = k_scales;
  a.v_scales = v_scales;
  a.tables = tables;
  a.pos = pos;
  a.owned = owned;
  a.out = static_cast<T*>(out);
  a.acc_out = acc_out;
  a.m_out = m_out;
  a.l_out = l_out;
  a.W = W;
  a.psz = psz;
  a.mp = mp;
  a.H = H;
  a.D = D;
  a.head_gran = head_gran;
  a.scale = 1.0f / sqrtf((float)D);
  a.cv = plan(W, D, mp, psz, (int)sizeof(P), quant, span);
  if (a.cv.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int nvec = D / kvq::vec_elems<P>();
  int G = 1;
  while (2 * G <= nvec && 2 * G <= 32) G *= 2;
  const bool two = nvec > G;
  if (W == 1)
    return two ? launch_own<T, P, 2, 1>(a, B, stream)
               : launch_own<T, P, 1, 1>(a, B, stream);
  return two ? launch_own<T, P, 2, 4>(a, B, stream)
             : launch_own<T, P, 1, 4>(a, B, stream);
}

template <typename T>
int launch_pool(int pool, const void* q, const void* k_new, const void* v_new,
                const void* k_pages, const void* v_pages, const float* ks,
                const float* vs, int head_gran, const int* tab, const int* p,
                const int* own, void* out, float* acc, float* m, float* l,
                int B, int W, int psz, int mp, int H, int D, int span,
                cudaStream_t s) {
  if (pool == 0 && ks == nullptr)
    return launch<T, T>(q, k_new, v_new, k_pages, v_pages, ks, vs, head_gran,
                        tab, p, own, out, acc, m, l, B, W, psz, mp, H, D,
                        span, s);
  if (pool == 1 && ks != nullptr)
    return launch<T, int8_t>(q, k_new, v_new, k_pages, v_pages, ks, vs,
                             head_gran, tab, p, own, out, acc, m, l, B, W,
                             psz, mp, H, D, span, s);
  if (pool == 2 && ks != nullptr)
    return launch<T, __nv_fp8_e4m3>(q, k_new, v_new, k_pages, v_pages, ks,
                                    vs, head_gran, tab, p, own, out, acc, m,
                                    l, B, W, psz, mp, H, D, span, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (window rows and output): 0 = float32, 1 = bfloat16. pool: 0 =
// the pages in that dtype (k_scales and v_scales null), 1 = int8, 2 = fp8
// e4m3, with f32 scales (N, psz) (head_gran 0) or (N, psz, H) (head_gran
// 1). Fold mode: `out` (B, W, C) in the dtype, acc/m/l null. Partials
// mode: `out` null, acc (B, W, C), m and l (B, W, H) f32. owned: a (B,
// mp) int32 mask of the pages to read among the live ones, or null for
// all of them. span: the caller's bound on the rows any slot reads (its
// pos, or the rows it owns), which sizes the split (any value gives the
// right result). The kernel trusts the entries it reads (live, and
// owned when a mask is given) to hold page ids inside the pool (the
// allocator's invariant); other entries are never dereferenced.
extern "C" int paged_window_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const void* k_scales, const void* v_scales,
    int head_gran, const void* tables, const void* pos, const void* owned,
    void* out, void* acc_out, void* m_out, void* l_out, int B, int W,
    int psz, int mp, int H, int D, int span, int dtype, int pool,
    void* stream) {
  const int* tab = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  const int* own = static_cast<const int*>(owned);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  float* acc = static_cast<float*>(acc_out);
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pool<float>(pool, q, k_new, v_new, k_pages, v_pages, ks,
                              vs, head_gran, tab, p, own, out, acc, m, l, B,
                              W, psz, mp, H, D, span, s);
  if (dtype == 1)
    return launch_pool<__nv_bfloat16>(pool, q, k_new, v_new, k_pages,
                                      v_pages, ks, vs, head_gran, tab, p,
                                      own, out, acc, m, l, B, W, psz, mp, H,
                                      D, span, s);
  return (int)cudaErrorInvalidValue;
}

// The CTA's dynamic shared memory (bytes), tile rows, ring stages and
// cluster ranks at these shapes and span (isz: the pool's element size),
// for the tests of the Python mirror.
extern "C" int paged_window_attention_carve(int W, int D, int mp, int psz,
                                            int isz, int quant, int span,
                                            int* out) {
  const Carve c = plan(W, D, mp, psz, isz, quant != 0, span);
  out[0] = (int)c.total;
  out[1] = c.tile;
  out[2] = c.stages;
  out[3] = c.ranks;
  return 0;
}
