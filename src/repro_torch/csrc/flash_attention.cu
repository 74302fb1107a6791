// Causal flash-attention forward for Hopper (sm_90a), plain-C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel.  q is
// (BH, Sq, D) and k, v are (BH / G, Sk, D), query head i reading kv head
// i / G (the reference repeats K/V to q heads instead; both compute the
// same).  f32 or bf16, D <= 128.  Three kernels, chosen by the caller's
// `route` before the launch (kernels/flash_attention.py:flash_route):
// bf16 with D a multiple of 16 runs on the tensor cores in bf16 (route 1),
// f32 with D a multiple of 8 on the tensor cores in 3xTF32 (route 2),
// everything else on the FMA pipes (route 0).
//
// Numerics follow the reference op order: s = (q . k) * scale summed in
// f32, softcap cap * tanh(s / cap), causal and window masks to the finite
// sentinel NEG_INF = -2e38, online softmax statistics (m, l) and the
// output sums in f32, p rounded to v's dtype before P.V (l sums the f32
// p), and out = acc / max(l, 1e-30) in q's dtype.
//
// All kernels: the TPU grid (B*H, Sq/bq, Sk/bk) walks the K axis in
// order, carrying (m, l, acc) in VMEM.  Here one block of 128 threads per
// (b*h, tile of 64 query rows) loops over 64-key tiles.  The loop starts
// at the first key tile inside the window and, when causal, ends at the
// last tile the block's last row can see.  The reference runs the masked
// tiles as well; that changes nothing: a tile masked for every row of the
// block either comes after the row's diagonal (s = NEG_INF, so p = 0 and
// alpha = 1) or before the first key the row sees, where it only adds to
// l and acc what the first visible tile multiplies by exp(NEG_INF - m) =
// 0.  Every row sees its own position, so that tile exists.
//
// FMA kernel (f32 and bf16 with a D the tensor-core kernels do not take).
// The block holds the q tile, (m, l) and the f32 output sums in shared
// memory: each tile of K and V is staged in shared memory as f32 (16-byte
// loads; a tile of one head is contiguous), each thread computes a 4 x 8
// block of scores in registers, one warp per row updates the softmax
// statistics, and each thread adds its 4 rows x D/8 dims of P.V.  Bound:
// the operations, 4 * D per (query, visible key) pair, on the FMA pipes.
//
// Tensor-core kernels, FlashAttention-2 style.  Each of the 4 warps owns
// 16 query rows: the S tile (16 x 64), (m, l) and the f32 output sums stay
// in registers.  K and V tiles stream through a 2-stage shared-memory
// ring by cp.async (the next tile loads while this one is used; rows past
// Sk are zero-filled and masked).  The S accumulator becomes P's A operand
// in registers.  exp runs on the MUFU unit (__expf: ex2.approx of x·log2
// e, relative error about 1e-6 for the arguments softmax takes).  Blocks of
// later query tiles (more keys when causal) are launched first.
//  * bf16 (D = 16, 32, ..., 128): S = Q.K^T and P.V are mma.sync.m16n8k16
//    bf16 products with f32 sums; q fragments stay in registers; rows are
//    padded by 16 bytes so ldmatrix's 8 rows fall in 8 bank groups; p is
//    rounded to bf16 in registers while l sums the f32 p.  Bound at the
//    prefill shape: bytes and bf16 tensor-core operations about equally
//    (0.010 and 0.009 ms on the H100).
//  * f32 (D = 8, 16, ..., 128), 3xTF32: every f32 operand x is split into
//    tf32 parts hi = rna(x), lo = rna(x - hi) (x = hi + lo to about 2^-22
//    relative), and each product runs as three mma.sync.m16n8k8 tf32
//    products into the same f32 sums, lo·hi + hi·lo + hi·hi, small terms
//    first (lo·lo, below f32 rounding, is dropped): about f32 accuracy on
//    the tensor cores.  Q is split once per block (hi and lo tiles in
//    shared memory), K and V per tile as each warp reads them, P in
//    registers; p stays f32 (v is f32).  (Splitting each K and V tile once
//    for the whole block, with Q's fragments split in registers, measured
//    slower on the H100: the extra barrier and shared-memory traffic cost
//    more than the repeated split.)  The k8 A operand wants keys t and
//    t + 4 of an 8-key step where the S accumulator holds keys 2t and
//    2t + 1, so P.V takes the step's keys in the order 0, 2, 4, 6, 1, 3,
//    5, 7 (k-slot t is key 2t, slot t + 4 is key 2t + 1) and reads V's B
//    fragment rows 2t and 2t + 1 to match.  32-bit fragments are read by
//    plain shared-memory loads from rows padded to D + 4 floats, which
//    puts the 32 lanes of each load in 32 different banks.  Bound: 3 x 4 *
//    D tf32 operations per (query, visible key) pair at 495 TFLOP/s.

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

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16).

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr size_t mma_smem_bytes(int D) { return (size_t)5 * kBQ * (D + 8) * 2; }

// rows [t0, t0 + 64) of a (rows, D) bf16 head into a tile of row stride
// D + 8 by cp.async; rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(const __nv_bfloat16* __restrict__ src, int t0,
                                                int rows, uint32_t dst) {
  constexpr int CPR = D / 8;                   // 16-byte pieces per row
  for (int p = threadIdx.x; p < kBK * CPR; p += kThreads) {
    const int r = p / CPR, c = p % CPR;
    const bool ok = t0 + r < rows;
    cp_async16(dst + (r * (D + 8) + c * 8) * 2,
               ok ? (const void*)(src + (size_t)(t0 + r) * D + c * 8) : (const void*)src,
               ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     Shape s) {
  static_assert(kBQ == 64 && kBK == 64 && kThreads == 128, "4 warps x 16 rows, 64 keys");
  constexpr int RS = D + 8;                    // tile row stride (bf16)
  constexpr int TILE = kBQ * RS * 2;           // bytes of one 64-row tile
  constexpr int KD = D / 16;                   // k16 steps over D
  constexpr int ND = D / 8;                    // n8 tiles over D
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sq = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sk = sq + TILE, sv = sk + 2 * TILE;  // 2 stages each

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* qb = q + (size_t)bh * s.Sq * D;
  const __nv_bfloat16* kb = k + (size_t)(bh / s.G) * s.Sk * D;
  const __nv_bfloat16* vb = v + (size_t)(bh / s.G) * s.Sk * D;

  const int q_last = min(q0 + kBQ, s.Sq) - 1;
  int kt_end = (s.Sk + kBK - 1) / kBK;
  if (s.causal) kt_end = min(kt_end, q_last / kBK + 1);
  const int first_key = q0 - s.window + 1;
  const int kt_begin = first_key > 0 ? first_key / kBK : 0;

  load_tile_async<D>(qb, q0, s.Sq, sq);
  cp_async_commit();
  if (kt_begin < kt_end) {
    load_tile_async<D>(kb, kt_begin * kBK, s.Sk, sk);
    load_tile_async<D>(vb, kt_begin * kBK, s.Sk, sv);
  }
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  uint32_t qf[KD][4];
  const int row0 = q0 + warp * 16 + g;         // this thread's rows: row0, row0 + 8

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {                     // the next tile loads during this one
      load_tile_async<D>(kb, (kt + 1) * kBK, s.Sk, sk + (st ^ 1) * TILE);
      load_tile_async<D>(vb, (kt + 1) * kBK, s.Sk, sv + (st ^ 1) * TILE);
    }
    cp_async_commit();
    cp_async_wait<1>();                        // q and tile kt have landed
    __syncthreads();
    if (kt == kt_begin) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(qf[kd], sq + (r * RS + kd * 16 + ((lane >> 4) << 3)) * 2);
      }
    }
    const uint32_t kt_s = sk + st * TILE, vt_s = sv + st * TILE;

    // S = Q K^T: 16 rows x 64 keys per warp, keys nt * 8 + 2 * tig + {0, 1}
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        const int r = kp * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t b[4];
        ldsm_x4(b, kt_s + (r * RS + kd * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(sc[2 * kp], qf[kd], b[0], b[1]);
        mma_bf16(sc[2 * kp + 1], qf[kd], b[2], b[3]);
      }
    }
    // scale, softcap, masks; a tile every key of which the warp's 16 rows
    // see (most tiles below the causal diagonal) skips the mask arithmetic
    const int k0 = kt * kBK, r_lo = q0 + warp * 16;
    const bool seen = k0 + kBK <= s.Sk && (!s.causal || k0 + kBK - 1 <= r_lo) &&
                      r_lo + 15 - k0 < s.window;
    if (seen && !s.has_cap) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] *= s.scale;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = row0 + (e >> 1) * 8, kp = k0 + i * 8 + 2 * tig + (e & 1);
          float x = sc[i][e] * s.scale;
          if (s.has_cap) x = s.cap * tanhf(x / s.cap);
          bool ok = kp < s.Sk && (qp - kp) < s.window;
          if (s.causal) ok = ok && qp >= kp;
          sc[i][e] = ok ? x : kNegInf;
        }
    }
    // online softmax; a row's 64 scores sit in the 4 threads of a quad
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(sc[i][2 * h], sc[i][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      alpha[h] = __expf(m_r[h] - m_new);
      m_r[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          sc[i][e] = __expf(sc[i][e] - m_new);
          sum += sc[i][e];                     // l sums the f32 p
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[h] = l_r[h] * alpha[h] + sum;
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
    // O += P V, p rounded to bf16: the S tiles 2j, 2j+1 are P's A fragment
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                             pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                             pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                             pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
      const int r = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vt_s + (r * RS + dp * 16 + ((lane >> 4) << 3)) * 2);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                           // the stage is free for tile kt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= s.Sq) continue;
    const float den = fmaxf(l_r[h], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)bh * s.Sq + row) * D + 2 * tig;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
          __floats2bfloat162_rn(o[i][2 * h] / den, o[i][2 * h + 1] / den);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, const Shape& s,
                       cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes(D);
  static bool configured = false;              // once, before any capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(s.BH, (s.Sq + kBQ - 1) / kBQ);
  flash_fwd_mma_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core kernel (f32).

// x rounded to tf32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32, written out so that its low 13 bits are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a.b in 3xTF32: lo·hi + hi·lo + hi·hi, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

constexpr size_t tf32_smem_bytes(int D) { return (size_t)6 * kBQ * (D + 4) * 4; }

// rows [t0, t0 + 64) of a (rows, D) f32 head into a tile of row stride
// D + 4 by cp.async; rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_f32(const float* __restrict__ src, int t0, int rows,
                                              uint32_t dst) {
  constexpr int CPR = D / 4;                   // 16-byte pieces per row
  for (int p = threadIdx.x; p < kBK * CPR; p += kThreads) {
    const int r = p / CPR, c = p % CPR;
    const bool ok = t0 + r < rows;
    cp_async16(dst + (r * (D + 4) + c * 4) * 4,
               ok ? (const void*)(src + (size_t)(t0 + r) * D + c * 4) : (const void*)src,
               ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, Shape s) {
  static_assert(kBQ == 64 && kBK == 64 && kThreads == 128, "4 warps x 16 rows, 64 keys");
  constexpr int RS = D + 4;                    // tile row stride (floats)
  constexpr int TILE = kBQ * RS;               // floats of one 64-row tile
  constexpr int KD = D / 8;                    // k8 steps over D
  constexpr int ND = D / 8;                    // n8 tiles over D
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qh = reinterpret_cast<float*>(smem_raw);   // Q hi, then Q lo
  float* ql = qh + TILE;
  const float* kf = ql + TILE;                 // K: 2 stages, then V: 2 stages
  const float* vf = kf + 2 * TILE;
  const uint32_t sq = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sk = sq + 2 * TILE * 4, sv = sk + 2 * TILE * 4;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const float* qb = q + (size_t)bh * s.Sq * D;
  const float* kb = k + (size_t)(bh / s.G) * s.Sk * D;
  const float* vb = v + (size_t)(bh / s.G) * s.Sk * D;

  const int q_last = min(q0 + kBQ, s.Sq) - 1;
  int kt_end = (s.Sk + kBK - 1) / kBK;
  if (s.causal) kt_end = min(kt_end, q_last / kBK + 1);
  const int first_key = q0 - s.window + 1;
  const int kt_begin = first_key > 0 ? first_key / kBK : 0;

  load_tile_f32<D>(qb, q0, s.Sq, sq);
  cp_async_commit();
  if (kt_begin < kt_end) {
    load_tile_f32<D>(kb, kt_begin * kBK, s.Sk, sk);
    load_tile_f32<D>(vb, kt_begin * kBK, s.Sk, sv);
  }
  cp_async_commit();
  cp_async_wait<1>();                          // q has landed
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {   // split Q once
    const int r = i / D, d = i % D;
    uint32_t hi, lo;
    split_tf32(qh[r * RS + d], hi, lo);
    qh[r * RS + d] = __uint_as_float(hi);
    ql[r * RS + d] = __uint_as_float(lo);
  }

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int rw = warp * 16 + g;                // this thread's tile rows: rw, rw + 8
  const int row0 = q0 + rw;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {                     // the next tile loads during this one
      load_tile_f32<D>(kb, (kt + 1) * kBK, s.Sk, sk + (st ^ 1) * TILE * 4);
      load_tile_f32<D>(vb, (kt + 1) * kBK, s.Sk, sv + (st ^ 1) * TILE * 4);
    }
    cp_async_commit();
    cp_async_wait<1>();                        // tile kt has landed
    __syncthreads();                           // ... for every thread (and Q is split)
    const float* kt_f = kf + st * TILE;
    const float* vt_f = vf + st * TILE;

    // S = Q K^T: 16 rows x 64 keys per warp, keys nt * 8 + 2 * tig + {0, 1}
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c0 = kd * 8 + tig;
      const uint32_t ah[4] = {__float_as_uint(qh[rw * RS + c0]),
                              __float_as_uint(qh[(rw + 8) * RS + c0]),
                              __float_as_uint(qh[rw * RS + c0 + 4]),
                              __float_as_uint(qh[(rw + 8) * RS + c0 + 4])};
      const uint32_t al[4] = {__float_as_uint(ql[rw * RS + c0]),
                              __float_as_uint(ql[(rw + 8) * RS + c0]),
                              __float_as_uint(ql[rw * RS + c0 + 4]),
                              __float_as_uint(ql[(rw + 8) * RS + c0 + 4])};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* kr = kt_f + (nt * 8 + g) * RS + c0;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kr[0], bh0, bl0);
        split_tf32(kr[4], bh1, bl1);
        mma_3xtf32(sc[nt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    // scale, softcap, masks; a tile every key of which the warp's 16 rows
    // see (most tiles below the causal diagonal) skips the mask arithmetic
    const int k0 = kt * kBK, r_lo = q0 + warp * 16;
    const bool seen = k0 + kBK <= s.Sk && (!s.causal || k0 + kBK - 1 <= r_lo) &&
                      r_lo + 15 - k0 < s.window;
    if (seen && !s.has_cap) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] *= s.scale;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = row0 + (e >> 1) * 8, kp = k0 + i * 8 + 2 * tig + (e & 1);
          float x = sc[i][e] * s.scale;
          if (s.has_cap) x = s.cap * tanhf(x / s.cap);
          bool ok = kp < s.Sk && (qp - kp) < s.window;
          if (s.causal) ok = ok && qp >= kp;
          sc[i][e] = ok ? x : kNegInf;
        }
    }
    // online softmax; a row's 64 scores sit in the 4 threads of a quad
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(sc[i][2 * h], sc[i][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      alpha[h] = __expf(m_r[h] - m_new);
      m_r[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          sc[i][e] = __expf(sc[i][e] - m_new);
          sum += sc[i][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[h] = l_r[h] * alpha[h] + sum;
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
    // O += P V over 8-key steps j: k-slot t is key 2t (c0, c2 of S tile j),
    // k-slot t + 4 is key 2t + 1 (c1, c3), and V's B rows follow
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(sc[j][0], ph[0], pl[0]);
      split_tf32(sc[j][2], ph[1], pl[1]);
      split_tf32(sc[j][1], ph[2], pl[2]);
      split_tf32(sc[j][3], ph[3], pl[3]);
      const float* v0 = vt_f + (j * 8 + 2 * tig) * RS + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[nd * 8], bh0, bl0);
        split_tf32(v0[RS + nd * 8], bh1, bl1);
        mma_3xtf32(o[nd], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();                           // the stage is free for tile kt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= s.Sq) continue;
    const float den = fmaxf(l_r[h], 1e-30f);
    float* orow = out + ((size_t)bh * s.Sq + row) * D + 2 * tig;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<float2*>(orow + i * 8) = make_float2(o[i][2 * h] / den,
                                                             o[i][2 * h + 1] / den);
  }
}

template <int D>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* out,
                          const Shape& s, cudaStream_t stream) {
  constexpr size_t bytes = tf32_smem_bytes(D);
  static bool configured = false;              // once, before any capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(s.BH, (s.Sq + kBQ - 1) / kBQ);
  flash_fwd_tf32x3_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), s);
  return cudaGetLastError();
}

cudaError_t launch_tf32x3_d(const void* q, const void* k, const void* v, void* out,
                            const Shape& s, cudaStream_t st) {
  switch (s.D) {
    case 8: return launch_tf32x3<8>(q, k, v, out, s, st);
    case 16: return launch_tf32x3<16>(q, k, v, out, s, st);
    case 24: return launch_tf32x3<24>(q, k, v, out, s, st);
    case 32: return launch_tf32x3<32>(q, k, v, out, s, st);
    case 40: return launch_tf32x3<40>(q, k, v, out, s, st);
    case 48: return launch_tf32x3<48>(q, k, v, out, s, st);
    case 56: return launch_tf32x3<56>(q, k, v, out, s, st);
    case 64: return launch_tf32x3<64>(q, k, v, out, s, st);
    case 72: return launch_tf32x3<72>(q, k, v, out, s, st);
    case 80: return launch_tf32x3<80>(q, k, v, out, s, st);
    case 88: return launch_tf32x3<88>(q, k, v, out, s, st);
    case 96: return launch_tf32x3<96>(q, k, v, out, s, st);
    case 104: return launch_tf32x3<104>(q, k, v, out, s, st);
    case 112: return launch_tf32x3<112>(q, k, v, out, s, st);
    case 120: return launch_tf32x3<120>(q, k, v, out, s, st);
    case 128: return launch_tf32x3<128>(q, k, v, out, s, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_mma_d(const void* q, const void* k, const void* v, void* out,
                         const Shape& s, cudaStream_t st) {
  switch (s.D) {
    case 16: return launch_mma<16>(q, k, v, out, s, st);
    case 32: return launch_mma<32>(q, k, v, out, s, st);
    case 48: return launch_mma<48>(q, k, v, out, s, st);
    case 64: return launch_mma<64>(q, k, v, out, s, st);
    case 80: return launch_mma<80>(q, k, v, out, s, st);
    case 96: return launch_mma<96>(q, k, v, out, s, st);
    case 112: return launch_mma<112>(q, k, v, out, s, st);
    case 128: return launch_mma<128>(q, k, v, out, s, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).  dtype: 0 = float32, 1 = bfloat16
// (q, k, v and out share it).  route: 0 = the FMA kernel, 1 = the bf16
// tensor-core kernel (bf16, D a multiple of 16, 16-byte aligned tensors),
// 2 = the 3xTF32 tensor-core kernel (f32, D a multiple of 8, 16-byte
// aligned tensors).
// q, out: (BH, Sq, D); k, v: (BH / G, Sk, D), all contiguous.  causal:
// mask k_pos > q_pos.  window: mask q_pos - k_pos >= window (a huge value
// = none).  has_cap: apply cap*tanh(s/cap).
extern "C" int flash_attention_launch(int dtype, int route, const void* q, const void* k,
                                      const void* v, void* out, int BH, int Sq,
                                      int Sk, int D, int G, float scale, int causal,
                                      int window, int has_cap, float cap, void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD || G < 1 || BH % G ||
      window < 1 || (dtype != 0 && dtype != 1) || Sq > 65535 * kBQ || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  const int ve = dtype == 0 ? 4 : 8;  // elements per 16 bytes
  const int vec = D % ve == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  Shape s{BH, Sq, Sk, D, G, causal, window, has_cap, vec, scale, cap};
  auto st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || D % 16 != 0 || !vec || (uintptr_t)out % 4 != 0)
      return (int)cudaErrorInvalidValue;
    return (int)launch_mma_d(q, k, v, out, s, st);
  }
  if (route == 2) {
    if (dtype != 0 || D % 8 != 0 || !vec || (uintptr_t)out % 8 != 0)
      return (int)cudaErrorInvalidValue;
    return (int)launch_tf32x3_d(q, k, v, out, s, st);
  }
  if (dtype == 0) return (int)launch<float>(q, k, v, out, s, st);
  return (int)launch<__nv_bfloat16>(q, k, v, out, s, st);
}
