// Fused paged-attention decode for Hopper (sm_90a), plain-C interface.
//
// Flash-decoding over the page table: for row b and kv head h, the G
// query heads of h and the Sq query tokens of b fold into R = Sq*G rows
// (row r = s*G + g, query position lens[b] + s).  The row's page chain,
// from pages[b, 0] up to the page holding position lens[b] + Sq - 1, is
// cut into chunks of whole pages (about 64 tokens).
// Replaces the TPU kernel repro/kernels/paged_attention.py:_decode_kernel.
//
// Numerics follow the reference op order: q is scaled in its storage
// dtype, logits / softcap / mask / softmax run in f32 with the finite
// sentinel NEG_INF = -2e38, and the output divides by max(l, 1e-30), so
// idle rows (lens = 0) stay finite.
//
// Design (simple first).  The TPU kernel walks the page blocks of a row in
// grid order, carrying (m, l, acc) from block to block.  Here the chunks
// of a row run in parallel, one block of 128 threads per (b, kv head,
// chunk), so a decode step with few slots still fills the card:
//  * pass 1: the block reads pages[b, :] and lens[b] itself (in place of
//    scalar prefetch), loads its chunk's K/V rows through the page table
//    into shared memory as f32 (16-byte loads), then computes scores (one
//    thread per (row, token)), the chunk's softmax statistics (one warp
//    per row) and its P.V sums (one thread per (row, dim)); it writes
//    (m, l) and the unnormalised acc of its R rows to a workspace.  Chunks
//    past the row's last page exit at once;
//  * pass 2: one block per (b, kv head) rescales the chunks' sums to their
//    common max, in chunk order, and divides.
// Pools: dense (the q dtype), int8, or uint8 holding packed int4 (byte i
// of a row holds dim i in its low nibble and dim i + D/2 in its high
// nibble, each offset by 8).  Quantized pools come with f32 scale rows
// (n_pages, ps, Hkv), one per token and kv head; the K/V tile is widened
// to f32 on its way into shared memory as level * scale, the reference's
// _dequant_block, so no dense K/V view exists anywhere.
// Bound: the bytes of the K/V pages read, 2 * ceil((lens+Sq)/ps) * ps *
// (Dp * sizeof(pool) + 4 for a quantized pool's scale) per (b, kv head).
// Left on the table: loads and math of a chunk do not overlap (no async
// copies), and the scores run on the FMA pipes, not the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T (4 f32 or 8 bf16) widened to f32.
__device__ __forceinline__ void unpack16(const uint4& r, float* o, float) {
  o[0] = __uint_as_float(r.x); o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z); o[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float* o, __nv_bfloat16) {
  const uint32_t p[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(p[i] << 16);
    o[2 * i + 1] = __uint_as_float(p[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pool storage: the q dtype, int8 levels, or packed int4 levels.
enum KvMode { kDense = 0, kInt8 = 1, kInt4 = 2 };

// 16 bytes of int8 levels widened to f32 and scaled.
__device__ __forceinline__ void dequant16_int8(const uint4& r, float sc, float* o) {
  const uint32_t p[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[4 * i + j] = (float)(int8_t)((p[i] >> (8 * j)) & 0xffu) * sc;
}
// 16 bytes of packed int4: lo[j] = dim j0 + j, hi[j] = dim j0 + D/2 + j.
__device__ __forceinline__ void dequant16_int4(const uint4& r, float sc, float* lo,
                                               float* hi) {
  const uint32_t p[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t byte = (p[i] >> (8 * j)) & 0xffu;
      lo[4 * i + j] = ((float)(byte & 0xfu) - 8.0f) * sc;
      hi[4 * i + j] = ((float)(byte >> 4) - 8.0f) * sc;
    }
}
// One pool element of dim d (D = head dim) at row base `row` (the row's
// first element for dense and int8 pools, its first byte for int4).
template <typename T, int MODE>
__device__ __forceinline__ float load_elem(const void* pool, size_t row, int d, int D,
                                           float sc) {
  if constexpr (MODE == kDense) {
    return to_f(static_cast<const T*>(pool)[row + d]);
  } else if constexpr (MODE == kInt8) {
    return (float)static_cast<const int8_t*>(pool)[row + d] * sc;
  } else {
    const int half = D / 2;
    const uint8_t byte = static_cast<const uint8_t*>(pool)[row + (d < half ? d : d - half)];
    return ((float)(d < half ? (byte & 0xfu) : (byte >> 4)) - 8.0f) * sc;
  }
}

struct Shape {
  int Sq, Hq, Hkv, D, ps, P, G, tile_pages, n_chunks, window, has_cap, vec;
  float scale, cap;
};

size_t smem_floats(const Shape& s) {
  const size_t R = (size_t)s.Sq * s.G, T = (size_t)s.tile_pages * s.ps;
  return R * s.D                // q rows
       + T * (s.D + 1)          // K tile (padded stride)
       + T * s.D                // V tile
       + R * T;                 // scores / probabilities
}

// Workspace: acc (B, Hkv, n_chunks, R, D) then (m, l) (B, Hkv, n_chunks, R, 2).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_attn_chunk_kernel(const T* __restrict__ q, const void* __restrict__ pool_k,
                        const void* __restrict__ pool_v,
                        const float* __restrict__ scale_k,
                        const float* __restrict__ scale_v,
                        const int* __restrict__ pages,
                        const int* __restrict__ lens, float* __restrict__ ws_acc,
                        float* __restrict__ ws_ml, Shape s) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, c = blockIdx.z, tid = threadIdx.x;
  const int D = s.D, G = s.G, R = s.Sq * s.G;
  const int Dp = MODE == kInt4 ? D / 2 : D;  // stored elements per row
  const int TT = s.tile_pages * s.ps;
  const int DP = D + 1;
  const int ln = lens[b];
  const int nb = (ln + s.Sq - 1) / s.ps + 1;  // pages holding positions <= ln+Sq-1
  const int p0 = c * s.tile_pages;
  if (p0 >= nb) return;                       // past the row's last page

  float* qs = smem;
  float* ks = qs + R * D;
  float* vs = ks + TT * DP;
  float* sc = vs + TT * D;
  const float scale_t = to_f(from_f<T>(s.scale));

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D, sq = r / G, g = r % G;
    const float qv = to_f(q[(((size_t)b * s.Sq + sq) * s.Hq + h * G + g) * D + d]);
    qs[i] = to_f(from_f<T>(qv * scale_t));  // scaled in storage dtype
  }
  if (s.vec) {                                 // 16-byte loads of K/V rows
    // elements of a row per 16 bytes: dense 16/sizeof(T), int8 16, int4
    // 16 bytes = 32 dims (16 low nibbles, 16 high)
    constexpr int VE = MODE == kDense ? 16 / (int)sizeof(T) : 16;
    const int dv = Dp / VE;
    for (int i = tid; i < TT * dv; i += kThreads) {
      const int t = i / dv, d0 = (i % dv) * VE, p = p0 + t / s.ps, off = t % s.ps;
      constexpr int NV = MODE == kInt4 ? 2 * VE : VE;  // dims per load
      float kv[NV], vv[NV];
      if (p < nb && p < s.P) {
        const int pid = pages[(size_t)b * s.P + p];
        const size_t tok = ((size_t)pid * s.ps + off) * s.Hkv + h;
        const size_t idx = tok * Dp + d0;
        if constexpr (MODE == kDense) {
          unpack16(__ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(pool_k) + idx)),
                   kv, T());
          unpack16(__ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(pool_v) + idx)),
                   vv, T());
        } else {
          const uint4 rk = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const uint8_t*>(pool_k) + idx));
          const uint4 rv = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const uint8_t*>(pool_v) + idx));
          const float sk = __ldg(scale_k + tok), sv = __ldg(scale_v + tok);
          if constexpr (MODE == kInt8) {
            dequant16_int8(rk, sk, kv);
            dequant16_int8(rv, sv, vv);
          } else {
            dequant16_int4(rk, sk, kv, kv + VE);
            dequant16_int4(rv, sv, vv, vv + VE);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NV; ++j) { kv[j] = 0.f; vv[j] = 0.f; }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        // int4: the second half of kv/vv holds dims d0 + D/2 + (j - VE)
        const int d = (MODE == kInt4 && j >= VE) ? d0 + Dp + (j - VE) : d0 + j;
        ks[t * DP + d] = kv[j];
        vs[t * D + d] = vv[j];
      }
    }
  } else {
    for (int i = tid; i < TT * D; i += kThreads) {
      const int t = i / D, d = i % D, p = p0 + t / s.ps, off = t % s.ps;
      float kv = 0.f, vv = 0.f;
      if (p < nb && p < s.P) {
        const int pid = pages[(size_t)b * s.P + p];
        const size_t tok = ((size_t)pid * s.ps + off) * s.Hkv + h;
        const float sk = MODE == kDense ? 1.f : scale_k[tok];
        const float sv = MODE == kDense ? 1.f : scale_v[tok];
        kv = load_elem<T, MODE>(pool_k, tok * Dp, d, D, sk);
        vv = load_elem<T, MODE>(pool_v, tok * Dp, d, D, sv);
      }
      ks[t * DP + d] = kv;
      vs[t * D + d] = vv;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * TT; i += kThreads) {
    const int r = i / TT, t = i % TT;
    float acc_s = 0.f;
    for (int d = 0; d < D; ++d) acc_s = fmaf(qs[r * D + d], ks[t * DP + d], acc_s);
    if (s.has_cap) acc_s = s.cap * tanhf(acc_s / s.cap);
    const int dist = ln + r / G - (p0 * s.ps + t);  // q_pos - k_pos
    sc[i] = (dist >= 0 && dist < s.window) ? acc_s : kNegInf;
  }
  __syncthreads();
  const size_t row0 = (((size_t)b * s.Hkv + h) * s.n_chunks + c) * R;
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < R; r += kThreads / 32) {
    float mx = kNegInf;
    for (int t = lane; t < TT; t += 32) mx = fmaxf(mx, sc[r * TT + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < TT; t += 32) {
      const float e = expf(sc[r * TT + t] - mx);
      sc[r * TT + t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ws_ml[(row0 + r) * 2] = mx;
      ws_ml[(row0 + r) * 2 + 1] = sum;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float pv = 0.f;
    for (int t = 0; t < TT; ++t) pv = fmaf(sc[r * TT + t], vs[t * D + d], pv);
    ws_acc[(row0 + r) * D + d] = pv;
  }
}

// Rescale the chunks' sums of each row to their common max, in chunk
// order, and divide by max(l, 1e-30).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_combine_kernel(const int* __restrict__ lens,
                          const float* __restrict__ ws_acc,
                          const float* __restrict__ ws_ml, T* __restrict__ out,
                          Shape s) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int D = s.D, G = s.G, R = s.Sq * s.G;
  const int nb = (lens[b] + s.Sq - 1) / s.ps + 1;
  const int nc = min((nb + s.tile_pages - 1) / s.tile_pages, s.n_chunks);
  const size_t row0 = ((size_t)b * s.Hkv + h) * s.n_chunks * R;
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D, sq = r / G, g = r % G;
    float mx = kNegInf;
    for (int c = 0; c < nc; ++c) mx = fmaxf(mx, ws_ml[(row0 + (size_t)c * R + r) * 2]);
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < nc; ++c) {
      const size_t rc = row0 + (size_t)c * R + r;
      const float w = expf(ws_ml[rc * 2] - mx);
      l = fmaf(ws_ml[rc * 2 + 1], w, l);
      acc = fmaf(ws_acc[rc * D + d], w, acc);
    }
    out[(((size_t)b * s.Sq + sq) * s.Hq + h * G + g) * D + d] =
        from_f<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int MODE>
cudaError_t launch(const void* q, const void* pk, const void* pv, const float* sk,
                   const float* sv, const int* pages, const int* lens, void* out,
                   float* ws, int B, const Shape& s, cudaStream_t stream) {
  const size_t bytes = smem_floats(s) * sizeof(float);
  static size_t configured = 48 * 1024;  // raised once per size, before any capture
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(paged_attn_chunk_kernel<T, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  const size_t rows = (size_t)B * s.Hkv * s.n_chunks * s.Sq * s.G;
  float* ws_acc = ws;
  float* ws_ml = ws + rows * s.D;
  paged_attn_chunk_kernel<T, MODE><<<dim3(B, s.Hkv, s.n_chunks), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), pk, pv, sk, sv, pages, lens, ws_acc, ws_ml, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_attn_combine_kernel<T><<<dim3(B, s.Hkv), kThreads, 0, stream>>>(
      lens, ws_acc, ws_ml, static_cast<T*>(out), s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int kv_mode, const void* q, const void* pk, const void* pv,
                        const float* sk, const float* sv, const int* pages,
                        const int* lens, void* out, float* ws, int B, const Shape& s,
                        cudaStream_t stream) {
  if (kv_mode == kInt8)
    return launch<T, kInt8>(q, pk, pv, sk, sv, pages, lens, out, ws, B, s, stream);
  if (kv_mode == kInt4)
    return launch<T, kInt4>(q, pk, pv, sk, sv, pages, lens, out, ws, B, s, stream);
  return launch<T, kDense>(q, pk, pv, sk, sv, pages, lens, out, ws, B, s, stream);
}

}  // namespace

// Returns a cudaError_t (0 = launched).  dtype: 0 = float32, 1 = bfloat16
// (q and out share it).  kv_mode: 0 = dense pools of the q dtype
// (scale_k / scale_v unused), 1 = int8 pools, 2 = uint8 pools of packed
// int4 with D/2 bytes a row; 1 and 2 need scale_k / scale_v, f32
// (n_pages, ps, Hkv).  workspace: B * Hkv * n_chunks * Sq * G * (D + 2)
// f32 on the device, n_chunks = ceil(P / tile_pages).  window: positions
// with q_pos - k_pos >= window are masked (a huge value = global).
// has_cap: apply cap*tanh(s/cap).
extern "C" int paged_attn_launch(int dtype, int kv_mode, const void* q,
                                 const void* pool_k, const void* pool_v,
                                 const void* scale_k, const void* scale_v,
                                 const void* pages, const void* lens, void* out,
                                 void* workspace, int B, int Sq, int Hq, int Hkv,
                                 int D, int ps, int P, int G, int tile_pages,
                                 float scale, int window, int has_cap, float cap,
                                 void* stream) {
  const bool quant = kv_mode == kInt8 || kv_mode == kInt4;
  if (B < 1 || Sq < 1 || G < 1 || Hq != Hkv * G || tile_pages < 1 || P < 1 ||
      workspace == nullptr || (dtype != 0 && dtype != 1) ||
      (kv_mode != kDense && !quant) || (quant && (scale_k == nullptr || scale_v == nullptr)) ||
      (kv_mode == kInt4 && D % 2))
    return (int)cudaErrorInvalidValue;
  // elements per 16-byte load, and the stored row width
  const int ve = kv_mode == kDense ? (dtype == 0 ? 4 : 8) : 16;
  const int dp = kv_mode == kInt4 ? D / 2 : D;
  const int vec = dp % ve == 0 && (uintptr_t)pool_k % 16 == 0 && (uintptr_t)pool_v % 16 == 0;
  const int n_chunks = (P + tile_pages - 1) / tile_pages;
  Shape s{Sq, Hq, Hkv, D, ps, P, G, tile_pages, n_chunks, window, has_cap, vec, scale, cap};
  if (smem_floats(s) * sizeof(float) > 227 * 1024) return (int)cudaErrorInvalidValue;
  const auto* pg = static_cast<const int*>(pages);
  const auto* ln = static_cast<const int*>(lens);
  const auto* sk = static_cast<const float*>(scale_k);
  const auto* sv = static_cast<const float*>(scale_v);
  auto* ws = static_cast<float*>(workspace);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_mode<float>(kv_mode, q, pool_k, pool_v, sk, sv, pg, ln, out, ws, B, s, st);
  return (int)launch_mode<__nv_bfloat16>(kv_mode, q, pool_k, pool_v, sk, sv, pg, ln, out, ws,
                                         B, s, st);
}
