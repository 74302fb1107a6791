// Causal flash-attention forward for Hopper (sm_90a), plain-C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel.  q is
// (BH, Sq, D) and k, v are (BH / G, Sk, D), query head i reading kv head
// i / G (the reference repeats K/V to q heads instead; both compute the
// same).  f32 or bf16, D <= 128.
//
// Numerics follow the reference op order: s = (q . k) * scale summed in
// f32, softcap cap * tanh(s / cap), causal and window masks to the finite
// sentinel NEG_INF = -2e38, online softmax statistics (m, l) and the
// output sums in f32, p rounded to v's dtype before P.V (l sums the f32
// p), and out = acc / max(l, 1e-30) in q's dtype.
//
// Design (simple first).  The TPU grid (B*H, Sq/bq, Sk/bk) walks the K
// axis in order, carrying (m, l, acc) in VMEM.  Here one block of 128
// threads per (b*h, tile of 64 query rows) holds the q tile, (m, l) and
// the f32 output sums in shared memory and loops over 64-key tiles: each
// tile of K and V is staged in shared memory as f32 (16-byte loads; a
// tile of one head is contiguous), each thread computes a 4 x 8 block of
// scores in registers, one warp per row updates the softmax statistics,
// and each thread adds its 4 rows x D/8 dims of P.V.  The loop starts at
// the first key tile inside the window and, when causal, ends at the last
// tile the block's last row can see.  The reference runs the masked tiles
// as well; that changes nothing: a tile masked for every row of the block
// either comes after the row's diagonal (s = NEG_INF, so p = 0 and alpha
// = 1) or before the first key the row sees, where it only adds to l and
// acc what the first visible tile multiplies by exp(NEG_INF - m) = 0.
// Every row sees its own position, so that tile exists.
// Bound: the operations, 4 * D per (query, visible key) pair, which this
// version runs on the FMA pipes in f32 (no wgmma), with shared-memory
// reads behind every FMA block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 128;
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kSP = kBK + 1;       // score row stride (no bank conflicts)
constexpr int kMaxD = 128;

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
  int BH, Sq, Sk, D, G, causal, window, has_cap, vec;
  float scale, cap;
};

size_t smem_floats(int D) {
  return (size_t)kBQ * (D + 1)     // q tile (padded stride)
       + (size_t)kBK * (D + 1)     // K tile (padded stride)
       + (size_t)kBK * D           // V tile
       + (size_t)kBQ * kSP         // scores / probabilities
       + (size_t)kBQ * D           // output sums
       + 3 * kBQ;                  // m, l, alpha
}

// rows [t0, t0 + n) of a (S, D) head into dst (row stride ld) as f32;
// rows at or past `rows` read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int t0, int rows,
                                          int D, int vec, float* dst, int ld, int n) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int VE = 16 / (int)sizeof(T);
    const int per_row = D / VE;
    for (int i = tid; i < n * per_row; i += kThreads) {
      const int t = i / per_row, d0 = (i % per_row) * VE;
      float v[VE];
      if (t0 + t < rows) {
        unpack16(__ldg(reinterpret_cast<const uint4*>(src + (size_t)(t0 + t) * D + d0)), v,
                 T());
      } else {
#pragma unroll
        for (int j = 0; j < VE; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VE; ++j) dst[t * ld + d0 + j] = v[j];
    }
  } else {
    for (int i = tid; i < n * D; i += kThreads) {
      const int t = i / D, d = i % D;
      dst[t * ld + d] = t0 + t < rows ? to_f(src[(size_t)(t0 + t) * D + d]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Shape s) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, q0 = blockIdx.y * kBQ, tid = threadIdx.x;
  const int D = s.D, DP = D + 1;
  float* qs = smem;
  float* ks = qs + kBQ * DP;
  float* vs = ks + kBK * DP;
  float* sc = vs + kBK * D;
  float* acc = sc + kBQ * kSP;
  float* m_s = acc + kBQ * D;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  const T* qb = q + (size_t)bh * s.Sq * D;
  const T* kb = k + (size_t)(bh / s.G) * s.Sk * D;
  const T* vb = v + (size_t)(bh / s.G) * s.Sk * D;

  load_tile<T>(qb, q0, s.Sq, D, s.vec, qs, DP, kBQ);
  for (int i = tid; i < kBQ * D; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  // key tiles the block's rows can see
  const int q_last = min(q0 + kBQ, s.Sq) - 1;
  int kt_end = (s.Sk + kBK - 1) / kBK;
  if (s.causal) kt_end = min(kt_end, q_last / kBK + 1);
  const int first_key = q0 - s.window + 1;
  const int kt_begin = first_key > 0 ? first_key / kBK : 0;

  const int rg = tid / 8, cg = tid % 8;     // 4 rows x 8 columns per thread
  const int warp = tid / 32, lane = tid % 32;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                          // last tile's ks / vs / sc used
    load_tile<T>(kb, k0, s.Sk, D, s.vec, ks, DP, kBK);
    load_tile<T>(vb, k0, s.Sk, D, s.vec, vs, D, kBK);
    __syncthreads();
    // scores: rows rg*4 + i, keys cg + 8*j
    float sacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[(cg + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j, kp = k0 + c;
        float x = sacc[i][j] * s.scale;
        if (s.has_cap) x = s.cap * tanhf(x / s.cap);
        bool ok = kp < s.Sk && (qp - kp) < s.window;
        if (s.causal) ok = ok && qp >= kp;
        sc[r * kSP + c] = ok ? x : kNegInf;
      }
    }
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float m_prev = m_s[r];
      float mx = fmaxf(sc[r * kSP + lane], sc[r * kSP + lane + 32]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      const float p0 = expf(sc[r * kSP + lane] - m_new);
      const float p1 = expf(sc[r * kSP + lane + 32] - m_new);
      sc[r * kSP + lane] = to_f(from_f<T>(p0));       // p in v's dtype
      sc[r * kSP + lane + 32] = to_f(from_f<T>(p1));
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // P.V: rows rg*4 + i, dims cg + 8*j
    float pacc[4][kMaxD / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMaxD / 8; ++j) pacc[i][j] = 0.f;
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sc[(rg * 4 + i) * kSP + c];
#pragma unroll
      for (int j = 0; j < kMaxD / 8; ++j) {
        const int d = cg + 8 * j;
        if (d < D) {
          const float vv = vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) pacc[i][j] = fmaf(pv[i], vv, pacc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const float alpha = a_s[r];
#pragma unroll
      for (int j = 0; j < kMaxD / 8; ++j) {
        const int d = cg + 8 * j;
        if (d < D) acc[r * D + d] = acc[r * D + d] * alpha + pacc[i][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < s.Sq)
      out[((size_t)bh * s.Sq + q0 + r) * D + d] = from_f<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const Shape& s,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats(s.D) * sizeof(float);
  static size_t configured = 48 * 1024;  // raised once per size, before any capture
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  const dim3 grid(s.BH, (s.Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).  dtype: 0 = float32, 1 = bfloat16
// (q, k, v and out share it).  q, out: (BH, Sq, D); k, v: (BH / G, Sk, D),
// all contiguous.  causal: mask k_pos > q_pos.  window: mask q_pos - k_pos
// >= window (a huge value = none).  has_cap: apply cap*tanh(s/cap).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int BH, int Sq,
                                      int Sk, int D, int G, float scale, int causal,
                                      int window, int has_cap, float cap, void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD || G < 1 || BH % G ||
      window < 1 || (dtype != 0 && dtype != 1) || Sq > 65535 * kBQ)
    return (int)cudaErrorInvalidValue;
  const int ve = dtype == 0 ? 4 : 8;  // elements per 16 bytes
  const int vec = D % ve == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  Shape s{BH, Sq, Sk, D, G, causal, window, has_cap, vec, scale, cap};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, out, s, st);
  return (int)launch<__nv_bfloat16>(q, k, v, out, s, st);
}
