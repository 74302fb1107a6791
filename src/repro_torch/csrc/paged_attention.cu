// Fused paged-attention decode for Hopper (sm_90a), plain-C interface.
//
// Flash-decoding over the page table: for row b and kv head h, the G
// query heads of h and the Sq query tokens of b fold into R = Sq*G rows
// (row r = s*G + g, query position lens[b] + s).  The row reads its page
// chain from pages[b, 0] up to the page holding position lens[b] + Sq - 1:
// nb = (lens[b] + Sq - 1) / ps + 1 pages; a page index past the table
// reads scratch page 0.
// Replaces the TPU kernel repro/kernels/paged_attention.py:_decode_kernel.
//
// Numerics follow the reference op order: q is scaled in its storage
// dtype, logits / softcap / mask / softmax run in f32 with the finite
// sentinel NEG_INF = -2e38, and the output divides by max(l, 1e-30), so
// idle rows (lens = 0) stay finite.  As in the reference's recurrence over
// K blocks of 128 tokens, each block of the cluster takes one max over its
// pages (at least one reference block), every p is exp(s - max), the
// block's partial sums add up without rescaling, and the blocks' sums are
// rescaled to the row's max when they meet.  Masked
// keys add 0 (in the reference they add exp(NEG_INF - m) = 0, or, before
// the first visible key, sums that the first visible key multiplies by
// exp(NEG_INF - m) = 0).  Every row sees its own position, so every row
// has a visible key.
//
// Bound: the bytes of the K/V pages read, 2 * nb * ps * (Dp * sizeof(pool)
// + 4 for a quantized pool's scale) per (b, kv head).  At decode sizes that
// is a microsecond or less, so the design is about latency: one launch,
// few dependent loads, and no block that starts only to exit.
//
// Design.  One launch, grid (B, Hkv, CL), one thread-block cluster of CL
// <= 8 blocks per (b, kv head); CL is fixed by the shape and the card
// (kernels/paged_attention.py:cluster_size), never by lens, so the grid
// does not grow with the page table and a captured graph stays valid.
//  * Block z of the cluster reads lens[b] and the row's page ids itself
//    (one load each, at once, with the q rows) and takes pages [z * per,
//    min(nb, (z + 1) * per)), per = max(bp, ceil(nb / CL)), bp = 128 / ps
//    pages (the reference's K block); a rank with no page adds nothing but
//    still takes part in both cluster barriers.
//  * Each of the block's 4 warps takes every 4th page of the block's run
//    and streams it through its own 2-stage ring by cp.async: first the K
//    rows of its pages (ps rows of Dp * sizeof(pool) bytes, strided by Hkv
//    rows in the pool), then the V rows, with their f32 scales for
//    quantized pools; K and V have a ring each, and the first two pages of
//    both load at once, at the start.  Quantized
//    rows stay raw in shared memory and widen to f32 as level * scale on
//    the way out (the reference's _dequant_block), so the kernel's K/V
//    equal the plain version's bit for bit.
//  * A token's dot product is spread over lpt lanes, one 16-byte piece of
//    the stored row each (lpt = 16 for f32 rows of D = 64), so tpi =
//    32 / lpt tokens are scored at once by the whole warp, and a shuffle
//    tree over the lpt lanes completes each score.  Pass 1 keeps the
//    scores of the warp's pages in shared memory and their max; the
//    block's max per row goes through the warps in shared memory.  Pass 2
//    adds up p and p * v per lane group in registers; the groups add up
//    by shuffles.  Rows run in passes of RP (1, 2, 4 or 8, fixed at
//    launch: 1 on the main path).
//  * The warps' sums add up in warp order in shared memory, then the
//    cluster's blocks in rank order through distributed shared memory,
//    each rescaled from its max to the row's: block z writes its slice of
//    the (R, D) output, divided by max(l, 1e-30).  No workspace, no
//    second launch, fixed sum order.
//  * The q rows and the block's sums of RC rows at a time sit in shared
//    memory: RC = R when they fit in 227 KB, else the rows run in chunks
//    of RC (a multiple of the rows per pass), each merged and written
//    before the next (f32 pools at D = 128 and G = 16 with Sq 5 or 9: two
//    chunks).  A row's arithmetic does not depend on its chunk.
// Pools: dense (the q dtype), int8, or uint8 holding packed int4 (byte i
// of a row holds dim i in its low nibble and dim i + D/2 in its high
// nibble, each offset by 8), with f32 scale rows (n_pages, ps, Hkv).
// Stored rows must be a multiple of 16 bytes, at most 512.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;                     // ring stages per warp, for K and for V
constexpr int kMaxCluster = 8;                 // portable cluster size
constexpr int kMaxPieces = 32;                 // 16-byte pieces of a stored row

// Pool storage: the q dtype, int8 levels, or packed int4 levels.
enum KvMode { kDense = 0, kInt8 = 1, kInt4 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Dims one 16-byte piece of a stored row widens to, and the most rows a
// pass takes (so a lane holds at most 32 floats of q and 32 of output
// sums).  The launch picks rows per pass RP <= kMaxRows, a power of 2.
template <typename T, int MODE>
struct Piece {
  static constexpr int kDims = MODE == kDense ? 16 / (int)sizeof(T) : (MODE == kInt8 ? 16 : 32);
  static constexpr int kMaxRows = 32 / kDims;
};

// Dim of element j of piece c: dense and int8 pieces hold kDims
// consecutive dims; an int4 piece holds dims 16c .. 16c+15 (low nibbles)
// and D/2 + 16c .. (high nibbles).
template <int MODE, int ND>
__device__ __forceinline__ int dim_of(int c, int j, int D) {
  if constexpr (MODE == kInt4) return j < 16 ? c * 16 + j : D / 2 + c * 16 + (j - 16);
  return c * ND + j;
}

template <typename T, int MODE>
__device__ __forceinline__ void widen(const uint4& r, float sc, float (&o)[Piece<T, MODE>::kDims]) {
  const uint32_t p[4] = {r.x, r.y, r.z, r.w};
  if constexpr (MODE == kDense && sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __uint_as_float(p[i]);
  } else if constexpr (MODE == kDense) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(p[i] << 16);
      o[2 * i + 1] = __uint_as_float(p[i] & 0xffff0000u);
    }
  } else if constexpr (MODE == kInt8) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[4 * i + j] = (float)(int8_t)((p[i] >> (8 * j)) & 0xffu) * sc;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (p[i] >> (8 * j)) & 0xffu;
        o[4 * i + j] = ((float)(byte & 0xfu) - 8.0f) * sc;
        o[16 + 4 * i + j] = ((float)(byte >> 4) - 8.0f) * sc;
      }
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// RC: rows per chunk.  A block holds the q rows and the block's sums of
// RC rows at a time; when all R rows do not fit in shared memory the
// block takes them in chunks of RC (a multiple of the rows per pass),
// each merged across the cluster and written before the next.
struct Shape {
  int Sq, Hq, Hkv, D, ps, P, G, R, np, lpt, bp, spw, RC, window, has_cap;
  float scale, cap;
};

constexpr size_t kMaxSmem = 227 * 1024;        // dynamic shared memory of a block

// Shared memory of a block, in bytes: the warps' K and V rings, the q
// rows of a chunk, the row's page ids, the warps' scores, the warps' row
// maxima, the warps' sums of one pass and the block's sums and maxima of
// a chunk.
struct Layout {
  int stage, q, pages, scores, wmax, warp_state, block_state, total;
};
__host__ __device__ inline int align16(int b) { return (b + 15) / 16 * 16; }
__host__ __device__ inline Layout layout(const Shape& s, int rows_per_pass) {
  Layout L;
  const int rp = s.R < rows_per_pass ? s.R : rows_per_pass;
  L.stage = align16(s.ps * s.np * 16 + s.ps * 4);  // K or V rows, then their scales
  L.q = kWarps * 2 * kStages * L.stage;
  L.pages = L.q + align16(s.RC * s.D * 4);
  L.scores = L.pages + align16(s.P * 4);
  L.wmax = L.scores + align16(kWarps * rp * s.spw * 4);
  L.warp_state = L.wmax + align16(kWarps * rp * 4);
  L.block_state = L.warp_state + kWarps * rp * (s.D + 1) * 4;
  L.total = L.block_state + s.RC * (s.D + 2) * 4;
  return L;
}

// Copy the K or V rows of page `pid`, kv head h (ps rows of rb bytes,
// strided by Hkv rows in the pool), into a ring stage, then for quantized
// pools their f32 scales.  Lane (ts, c) copies piece c of rows ts, ts +
// tpi, ..., the pieces it reads back.
template <int MODE>
__device__ __forceinline__ void issue_page(const unsigned char* __restrict__ pool,
                                           const float* __restrict__ scale, int pid, int h,
                                           const Shape& s, uint32_t stage, int lane, int ts,
                                           int tpi, int c) {
  const int rb = s.np * 16;
  const size_t tok0 = (size_t)pid * s.ps * s.Hkv + h;  // token t: tok0 + t * Hkv
  if (c < s.np)
    for (int t = ts; t < s.ps; t += tpi)
      cp_async16(stage + t * rb + c * 16, pool + (tok0 + (size_t)t * s.Hkv) * rb + c * 16);
  if constexpr (MODE != kDense) {
    for (int t = lane; t < s.ps; t += 32)
      cp_async4(stage + s.ps * rb + t * 4, scale + tok0 + (size_t)t * s.Hkv);
  }
}

template <typename T, int MODE, int RP>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const unsigned char* __restrict__ pool_k,
                  const unsigned char* __restrict__ pool_v, const float* __restrict__ scale_k,
                  const float* __restrict__ scale_v, const int* __restrict__ pages,
                  const int* __restrict__ lens, T* __restrict__ out, Shape s) {
  constexpr int ND = Piece<T, MODE>::kDims;
  static_assert(RP >= 1 && RP <= Piece<T, MODE>::kMaxRows, "rows per pass");
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(s, RP);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  int* pg_s = reinterpret_cast<int*>(smem + L.pages);
  float* wmax = reinterpret_cast<float*>(smem + L.wmax);
  float* ws = reinterpret_cast<float*>(smem + L.warp_state);
  float* bs = reinterpret_cast<float*>(smem + L.block_state);
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks(), z = (int)cluster.block_rank();
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int D = s.D, G = s.G, R = s.R, DW = s.D + 1, DB = s.D + 2;
  const int rp = min(R, RP);
  float* sb = reinterpret_cast<float*>(smem + L.scores) + warp * rp * s.spw;

  // lens and the page ids (the q rows load with each chunk's)
  const int ln = lens[b];
  for (int i = tid; i < s.P; i += kThreads) pg_s[i] = pages[(size_t)b * s.P + i];
  const float scale_t = to_f(from_f<T>(s.scale));

  // this rank's run of pages, at least one reference K block (bp pages),
  // and this warp's share: every kWarps-th page
  const int nb = (ln + s.Sq - 1) / s.ps + 1;
  const int per = max(s.bp, (nb + CL - 1) / CL);
  const int p_begin = min(nb, z * per), p_end = min(nb, p_begin + per);
  // (capped by the score buffer, sized for the longest run of a row that
  // stays inside its table, as callers keep it)
  const int cnt = min(s.spw / s.ps, p_begin + warp < p_end
                                        ? (p_end - p_begin - warp + kWarps - 1) / kWarps : 0);
  auto page_id = [&](int i) {                   // page i of this warp; past the table: 0
    const int p = p_begin + warp + i * kWarps;
    return p < s.P ? pg_s[p] : 0;
  };

  const int lpt = s.lpt, tpi = 32 / lpt;        // lanes per token, tokens per step
  const int ts = lane / lpt, c = lane - ts * lpt;
#define LOAD_PAGE(pool, scale, i, stage) \
  issue_page<MODE>(pool, scale, page_id(i), h, s, stage, lane, ts, tpi, c)
  const bool act = c < s.np;
  const int steps = (s.ps + tpi - 1) / tpi;
  const int rb = s.np * 16;
  const unsigned char* kring_p = smem + warp * 2 * kStages * L.stage;
  const unsigned char* vring_p = kring_p + kStages * L.stage;
  const uint32_t kring = (uint32_t)__cvta_generic_to_shared(kring_p);
  const uint32_t vring = (uint32_t)__cvta_generic_to_shared(vring_p);

  for (int c0 = 0; c0 < R; c0 += s.RC) {
    // the scaled q rows of this chunk of rows [c0, c0 + rc)
    const int rc = min(s.RC, R - c0);
    for (int i = tid; i < rc * D; i += kThreads) {
      const int r = c0 + i / D, d = i % D, sq = r / G, g = r - sq * G;
      const float qv = to_f(q[(((size_t)b * s.Sq + sq) * s.Hq + h * G + g) * D + d]);
      q_s[i] = to_f(from_f<T>(qv * scale_t));  // scaled in storage dtype
    }
    __syncthreads();
    for (int r0 = c0; r0 < c0 + rc; r0 += RP) {
      // rows of this pass; rows past the chunk (in its last pass) run on
      // q = 0 and are never written
      const int rows = min(RP, c0 + rc - r0);
      float qr[RP][ND], mx[RP];
      int q_pos[RP];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        mx[r] = kNegInf;
        q_pos[r] = ln + (r0 + r) / G;
#pragma unroll
        for (int j = 0; j < ND; ++j)
          qr[r][j] = act && r < rows ? q_s[(r0 - c0 + r) * D + dim_of<MODE, ND>(c, j, D)] : 0.f;
      }
      // the first two K pages and the first two V pages load at once, one
      // cp.async group each
      for (int i = 0; i < kStages; ++i) {
        if (i < cnt) LOAD_PAGE(pool_k, scale_k, i, kring + i * L.stage);
        cp_async_commit();
      }
      for (int i = 0; i < kStages; ++i) {
        if (i < cnt) LOAD_PAGE(pool_v, scale_v, i, vring + i * L.stage);
        cp_async_commit();
      }
      // pass 1: the scores of this warp's K pages, kept in shared memory
      for (int i = 0; i < cnt; ++i) {
        if (i < kStages)                           // page i has landed (this lane's part)
          cp_async_wait<2 * kStages - 1>();
        else
          cp_async_wait<kStages - 1>();
        __syncwarp();                              // ... and every lane's
        const unsigned char* st = kring_p + (i % kStages) * L.stage;
        const float* sc = reinterpret_cast<const float*>(st + s.ps * rb);
        const int k0 = (p_begin + warp + i * kWarps) * s.ps;
#pragma unroll 2
        for (int it = 0; it < steps; ++it) {
          const int t = it * tpi + ts;
          const bool tok = t < s.ps;
          float kv[ND];
          if (act && tok) {
            widen<T, MODE>(*reinterpret_cast<const uint4*>(st + t * rb + c * 16),
                           MODE == kDense ? 1.f : sc[t], kv);
          } else {
#pragma unroll
            for (int j = 0; j < ND; ++j) kv[j] = 0.f;
          }
          float part[RP];
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            float a = 0.f;
#pragma unroll
            for (int j = 0; j < ND; ++j) a = fmaf(qr[r][j], kv[j], a);
            part[r] = a;
          }
          for (int o = lpt / 2; o > 0; o >>= 1)    // the score, in each lane of the token
#pragma unroll
            for (int r = 0; r < RP; ++r) part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            float x = part[r];
            if (s.has_cap) x = s.cap * tanhf(x / s.cap);
            const int dist = q_pos[r] - (k0 + t);
            x = tok && dist >= 0 && dist < s.window ? x : kNegInf;
            mx[r] = fmaxf(mx[r], x);
            if (c == 0 && tok && r < rows) sb[r * s.spw + i * s.ps + t] = x;
          }
        }
        __syncwarp();                              // every lane is done with the stage
        if (i + kStages < cnt)
          LOAD_PAGE(pool_k, scale_k, i + kStages, kring + (i % kStages) * L.stage);
        cp_async_commit();
      }
      // one max per row over the block: token groups, then warps
      for (int o = lpt; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < RP; ++r) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
      if (lane == 0)
#pragma unroll
        for (int r = 0; r < RP; ++r)
          if (r < rows) wmax[warp * rp + r] = mx[r];
      __syncthreads();
      float m_r[RP], l[RP], acc[RP][ND];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        m_r[r] = kNegInf;
        if (r < rows)
#pragma unroll
          for (int w = 0; w < kWarps; ++w) m_r[r] = fmaxf(m_r[r], wmax[w * rp + r]);
        l[r] = 0.f;
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[r][j] = 0.f;
      }
      // pass 2: p = exp(s - m) against the block's max, and the sums of p
      // and p * v over this warp's V pages
      cp_async_wait<0>();                          // V pages 0 and 1 (and every K page)
      __syncwarp();
      for (int i = 0; i < cnt; ++i) {
        if (i >= kStages) {
          cp_async_wait<kStages - 1>();            // page i has landed (this lane's part)
          __syncwarp();                            // ... and every lane's
        }
        const unsigned char* st = vring_p + (i % kStages) * L.stage;
        const float* sc = reinterpret_cast<const float*>(st + s.ps * rb);
#pragma unroll 2
        for (int it = 0; it < steps; ++it) {
          const int t = it * tpi + ts;
          const bool tok = t < s.ps;
          float vv[ND];
          if (act && tok) {
            widen<T, MODE>(*reinterpret_cast<const uint4*>(st + t * rb + c * 16),
                           MODE == kDense ? 1.f : sc[t], vv);
          } else {
#pragma unroll
            for (int j = 0; j < ND; ++j) vv[j] = 0.f;
          }
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const float x = tok && r < rows ? sb[r * s.spw + i * s.ps + t] : kNegInf;
            const float pe = x == kNegInf ? 0.f : expf(x - m_r[r]);   // masked keys add 0
            l[r] += pe;
#pragma unroll
            for (int j = 0; j < ND; ++j) acc[r][j] = fmaf(pe, vv[j], acc[r][j]);
          }
        }
        __syncwarp();                              // every lane is done with the stage
        if (i + kStages < cnt)
          LOAD_PAGE(pool_v, scale_v, i + kStages, vring + (i % kStages) * L.stage);
        cp_async_commit();
      }
      cp_async_wait<0>();
      // the token groups of the warp add up: lanes lpt, 2 lpt, ... apart
      for (int o = lpt; o < 32; o <<= 1) {
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
          for (int j = 0; j < ND; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
        }
      }
      if (ts == 0 && act) {
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          if (r >= rows) break;
          float* w = ws + (warp * rp + r) * DW;
#pragma unroll
          for (int j = 0; j < ND; ++j) w[dim_of<MODE, ND>(c, j, D)] = acc[r][j];
          if (c == 0) w[D] = l[r];
        }
      }
      __syncthreads();
      // the warps' sums add up in warp order: the block's sums of these
      // rows, then the block's max beside them
      for (int e = tid; e < rows * DB; e += kThreads) {
        const int r = e / DB, d = e - r * DB;
        float v = kNegInf;
        if (d <= D) {
          v = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) v += ws[(w * rp + r) * DW + d];
        } else {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) v = fmaxf(v, wmax[w * rp + r]);
        }
        bs[(r0 - c0 + r) * DB + d] = v;
      }
      __syncthreads();                             // the buffers are free for the next pass
    }

    // the cluster's blocks meet in rank order, each rescaled from its max to
    // the row's; block z writes its slice of the chunk
    cluster.sync();
    const int n_el = rc * D, per_el = (n_el + CL - 1) / CL;
    const int e_end = min(n_el, (z + 1) * per_el);
    for (int e = z * per_el + tid; e < e_end; e += kThreads) {
      const int rl = e / D, r = c0 + rl, d = e - rl * D, sq = r / G, g = r - sq * G;
      float mk[kMaxCluster], lk[kMaxCluster], ak[kMaxCluster];
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {     // every remote read in flight at once
        if (k < CL) {
          const float* rs = cluster.map_shared_rank(bs, k) + rl * DB;
          mk[k] = rs[D + 1];
          lk[k] = rs[D];
          ak[k] = rs[d];
        }
      }
      float mx = kNegInf;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < CL) mx = fmaxf(mx, mk[k]);
      float lsum = 0.f, asum = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < CL) {
          const float w = expf(mk[k] - mx);
          lsum = fmaf(lk[k], w, lsum);
          asum = fmaf(ak[k], w, asum);
        }
      }
      out[(((size_t)b * s.Sq + sq) * s.Hq + h * G + g) * D + d] =
          from_f<T>(asum / fmaxf(lsum, 1e-30f));
    }
    cluster.sync();  // the sums are read: the next chunk may overwrite them, blocks may exit
  }
#undef LOAD_PAGE
}

// The same grid and cluster doing nothing: the launch floor.
__global__ void __launch_bounds__(kThreads) paged_attn_floor_kernel() {}

cudaError_t launch_cluster(const void* fn, void** args, int B, int Hkv, int cl, size_t smem,
                           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, Hkv, cl);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cl;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, fn, args);
}

template <typename T, int MODE, int RP>
cudaError_t launch(const void* q, const void* pk, const void* pv, const float* sk,
                   const float* sv, const int* pages, const int* lens, void* out, int B, int cl,
                   const Shape& s, cudaStream_t stream) {
  // rows per chunk: all R rows when they fit, else the fewest chunks of
  // a multiple of RP rows that fit
  Shape sh = s;
  for (int n = 1;; ++n) {
    const int rc = ((s.R + n - 1) / n + RP - 1) / RP * RP;
    sh.RC = rc < s.R ? rc : s.R;
    if ((size_t)layout(sh, RP).total <= kMaxSmem || sh.RC <= RP) break;
  }
  const size_t bytes = layout(sh, RP).total;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured = 48 * 1024;  // raised once per size, before any capture
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(paged_attn_kernel<T, MODE, RP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  const T* qp = static_cast<const T*>(q);
  const unsigned char* pkp = static_cast<const unsigned char*>(pk);
  const unsigned char* pvp = static_cast<const unsigned char*>(pv);
  T* op = static_cast<T*>(out);
  void* args[] = {&qp, &pkp, &pvp, &sk, &sv, &pages, &lens, &op, &sh};
  return launch_cluster(reinterpret_cast<const void*>(paged_attn_kernel<T, MODE, RP>), args, B,
                        s.Hkv, cl, bytes, stream);
}

// Rows per pass: the smallest power of 2 that holds R, at most kMaxRows.
template <typename T, int MODE>
cudaError_t launch_rows(const void* q, const void* pk, const void* pv, const float* sk,
                        const float* sv, const int* pages, const int* lens, void* out, int B,
                        int cl, const Shape& s, cudaStream_t st) {
  constexpr int MR = Piece<T, MODE>::kMaxRows;
  if (s.R == 1 || MR == 1)
    return launch<T, MODE, 1>(q, pk, pv, sk, sv, pages, lens, out, B, cl, s, st);
  if constexpr (MR >= 2)
    if (s.R == 2 || MR == 2)
      return launch<T, MODE, (MR >= 2 ? 2 : 1)>(q, pk, pv, sk, sv, pages, lens, out, B, cl, s, st);
  if constexpr (MR >= 4)
    if (s.R <= 4 || MR == 4)
      return launch<T, MODE, (MR >= 4 ? 4 : 1)>(q, pk, pv, sk, sv, pages, lens, out, B, cl, s, st);
  return launch<T, MODE, MR>(q, pk, pv, sk, sv, pages, lens, out, B, cl, s, st);
}

template <typename T>
cudaError_t launch_mode(int kv_mode, const void* q, const void* pk, const void* pv,
                        const float* sk, const float* sv, const int* pages, const int* lens,
                        void* out, int B, int cl, const Shape& s, cudaStream_t stream) {
  if (kv_mode == kInt8)
    return launch_rows<T, kInt8>(q, pk, pv, sk, sv, pages, lens, out, B, cl, s, stream);
  if (kv_mode == kInt4)
    return launch_rows<T, kInt4>(q, pk, pv, sk, sv, pages, lens, out, B, cl, s, stream);
  return launch_rows<T, kDense>(q, pk, pv, sk, sv, pages, lens, out, B, cl, s, stream);
}

}  // namespace

// Returns a cudaError_t (0 = launched).  dtype: 0 = float32, 1 = bfloat16
// (q and out share it).  kv_mode: 0 = dense pools of the q dtype
// (scale_k / scale_v unused), 1 = int8 pools, 2 = uint8 pools of packed
// int4 with D/2 bytes a row; 1 and 2 need scale_k / scale_v, f32
// (n_pages, ps, Hkv).  A stored row (Dp elements) must be a multiple of 16
// bytes and at most 512, and the pools 16-byte aligned.  cluster: blocks
// per (b, kv head), 1..8.  window: positions with q_pos - k_pos >= window
// are masked (a huge value = global).  has_cap: apply cap*tanh(s/cap).
extern "C" int paged_attn_launch(int dtype, int kv_mode, const void* q,
                                 const void* pool_k, const void* pool_v,
                                 const void* scale_k, const void* scale_v,
                                 const void* pages, const void* lens, void* out, int B,
                                 int Sq, int Hq, int Hkv, int D, int ps, int P, int G,
                                 int cluster, float scale, int window, int has_cap,
                                 float cap, void* stream) {
  const bool quant = kv_mode == kInt8 || kv_mode == kInt4;
  if (B < 1 || Sq < 1 || G < 1 || Hkv < 1 || Hq != Hkv * G || P < 1 || ps < 1 || D < 1 ||
      cluster < 1 || cluster > kMaxCluster || (dtype != 0 && dtype != 1) ||
      (kv_mode != kDense && !quant) || (quant && (scale_k == nullptr || scale_v == nullptr)) ||
      (kv_mode == kInt4 && D % 2))
    return (int)cudaErrorInvalidValue;
  const int item = kv_mode == kDense ? (dtype == 0 ? 4 : 2) : 1;
  const int row_bytes = (kv_mode == kInt4 ? D / 2 : D) * item;
  if (row_bytes % 16 || row_bytes / 16 > kMaxPieces || (uintptr_t)pool_k % 16 ||
      (uintptr_t)pool_v % 16)
    return (int)cudaErrorInvalidValue;
  const int np = row_bytes / 16;
  int lpt = 1;
  while (lpt < np) lpt *= 2;
  // a rank takes at least one of the reference's K blocks of 128 tokens;
  // the scores a warp keeps per row: its share of the longest run
  const int bp = ps < 128 ? 128 / ps : 1;
  const int run = bp > (P + cluster - 1) / cluster ? bp : (P + cluster - 1) / cluster;
  const int spw = (run + kWarps - 1) / kWarps * ps;
  Shape s{Sq, Hq, Hkv, D, ps, P, G, Sq * G, np, lpt, bp, spw, Sq * G, window, has_cap, scale, cap};
  const auto* pg = static_cast<const int*>(pages);
  const auto* ln = static_cast<const int*>(lens);
  const auto* sk = static_cast<const float*>(scale_k);
  const auto* sv = static_cast<const float*>(scale_v);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_mode<float>(kv_mode, q, pool_k, pool_v, sk, sv, pg, ln, out, B, cluster,
                                   s, st);
  return (int)launch_mode<__nv_bfloat16>(kv_mode, q, pool_k, pool_v, sk, sv, pg, ln, out, B,
                                         cluster, s, st);
}

// The launch floor: an empty kernel on paged_attn_launch's grid (B, Hkv,
// cluster) and cluster size, for timing beside the kernel.
extern "C" int paged_attn_floor_launch(int B, int Hkv, int cluster, void* stream) {
  if (B < 1 || Hkv < 1 || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(reinterpret_cast<const void*>(paged_attn_floor_kernel), nullptr, B,
                             Hkv, cluster, 0, static_cast<cudaStream_t>(stream));
}
