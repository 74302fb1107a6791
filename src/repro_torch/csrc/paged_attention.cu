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
// Bound: the bytes of the K/V pages read, 2 * ceil((lens+Sq)/ps) * ps *
// D * sizeof(pool) per (b, kv head).
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_chunk_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                        const T* __restrict__ pool_v, const int* __restrict__ pages,
                        const int* __restrict__ lens, float* __restrict__ ws_acc,
                        float* __restrict__ ws_ml, Shape s) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, c = blockIdx.z, tid = threadIdx.x;
  const int D = s.D, G = s.G, R = s.Sq * s.G;
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
    constexpr int VE = 16 / sizeof(T);
    const int dv = D / VE;
    for (int i = tid; i < TT * dv; i += kThreads) {
      const int t = i / dv, d0 = (i % dv) * VE, p = p0 + t / s.ps, off = t % s.ps;
      float kv[VE], vv[VE];
      if (p < nb && p < s.P) {
        const int pid = pages[(size_t)b * s.P + p];
        const size_t idx = (((size_t)pid * s.ps + off) * s.Hkv + h) * D + d0;
        unpack16(__ldg(reinterpret_cast<const uint4*>(pool_k + idx)), kv, T());
        unpack16(__ldg(reinterpret_cast<const uint4*>(pool_v + idx)), vv, T());
      } else {
#pragma unroll
        for (int j = 0; j < VE; ++j) { kv[j] = 0.f; vv[j] = 0.f; }
      }
#pragma unroll
      for (int j = 0; j < VE; ++j) {
        ks[t * DP + d0 + j] = kv[j];
        vs[t * D + d0 + j] = vv[j];
      }
    }
  } else {
    for (int i = tid; i < TT * D; i += kThreads) {
      const int t = i / D, d = i % D, p = p0 + t / s.ps, off = t % s.ps;
      float kv = 0.f, vv = 0.f;
      if (p < nb && p < s.P) {
        const int pid = pages[(size_t)b * s.P + p];
        const size_t idx = (((size_t)pid * s.ps + off) * s.Hkv + h) * D + d;
        kv = to_f(pool_k[idx]);
        vv = to_f(pool_v[idx]);
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

template <typename T>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* pages, const int* lens, void* out, float* ws,
                   int B, const Shape& s, cudaStream_t stream) {
  const size_t bytes = smem_floats(s) * sizeof(float);
  static size_t configured = 48 * 1024;  // raised once per size, before any capture
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attn_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  const size_t rows = (size_t)B * s.Hkv * s.n_chunks * s.Sq * s.G;
  float* ws_acc = ws;
  float* ws_ml = ws + rows * s.D;
  paged_attn_chunk_kernel<T><<<dim3(B, s.Hkv, s.n_chunks), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      pages, lens, ws_acc, ws_ml, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_attn_combine_kernel<T><<<dim3(B, s.Hkv), kThreads, 0, stream>>>(
      lens, ws_acc, ws_ml, static_cast<T*>(out), s);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).  dtype: 0 = float32, 1 = bfloat16
// (q, pools and out share it).  workspace: B * Hkv * n_chunks * Sq * G *
// (D + 2) f32 on the device, n_chunks = ceil(P / tile_pages).  window:
// positions with q_pos - k_pos >= window are masked (a huge value =
// global).  has_cap: apply cap*tanh(s/cap).
extern "C" int paged_attn_launch(int dtype, const void* q, const void* pool_k,
                                 const void* pool_v, const void* pages,
                                 const void* lens, void* out, void* workspace,
                                 int B, int Sq, int Hq, int Hkv, int D, int ps,
                                 int P, int G, int tile_pages, float scale,
                                 int window, int has_cap, float cap,
                                 void* stream) {
  if (B < 1 || Sq < 1 || G < 1 || Hq != Hkv * G || tile_pages < 1 || P < 1 ||
      workspace == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int ve = dtype == 0 ? 4 : 8;  // elements per 16 bytes
  const int vec = D % ve == 0 && (uintptr_t)pool_k % 16 == 0 && (uintptr_t)pool_v % 16 == 0;
  const int n_chunks = (P + tile_pages - 1) / tile_pages;
  Shape s{Sq, Hq, Hkv, D, ps, P, G, tile_pages, n_chunks, window, has_cap, vec, scale, cap};
  if (smem_floats(s) * sizeof(float) > 227 * 1024) return (int)cudaErrorInvalidValue;
  const auto* pg = static_cast<const int*>(pages);
  const auto* ln = static_cast<const int*>(lens);
  auto* ws = static_cast<float*>(workspace);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, pool_k, pool_v, pg, ln, out, ws, B, s, st);
  return (int)launch<__nv_bfloat16>(q, pool_k, pool_v, pg, ln, out, ws, B, s, st);
}
