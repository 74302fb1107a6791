// Encoded-MAC bitplane matmul for Hopper (sm_90a), plain-C interface.
//
//   out[m, n] = sum_u sum_k plane_u(x[m, k]) * Wt[u, k, n] + bias[n]
//
// x holds int8 activation codes; plane_u is the AND of the 1-3 bits of
// x named by monomial u (shift/AND on the sign-extended code, so the
// two's-complement sign bit is bit 7).  Wt is bf16, sums are f32.
// Replaces the TPU kernel repro/kernels/encoded_matmul.py:_kernel.
//
// Design (simple first; no wgmma/TMA yet).  At decode m is the slot count
// (a few rows), so the work is a stream over Wt and the bytes of Wt bound
// it; the kernel is built to keep many 16-byte loads of Wt in flight:
//  * one block of 8 warps per (256-column, BM-row, k-split) tile.  Lane l
//    owns output columns n0 + 8l .. n0 + 8l + 7 for BM rows and reads them
//    from each Wt row with one 16-byte load (8 bf16), so a warp reads 512
//    contiguous bytes per (u, k);
//  * the 8 warps take interleaved k of the split (warp w: k = w, w+8, ...)
//    and issue the loads of all monomials of one k before using them;
//    their sums meet in shared memory at the end, in warp order;
//  * the block stages a 64-wide k chunk of the int8 x tile in shared
//    memory once and turns it into one BM-bit row mask per (u, k).  The
//    main loop adds w into the rows whose mask bit is set (an FMA by 0 or
//    1): plane in {0, 1}, so every product is exact and only the f32
//    summation order differs from the plain version;
//  * the TPU grid's sequential K axis becomes a loop inside the block, and
//    K is also split across blocks so that decode shapes fill the card:
//    each split writes an f32 partial tile and a second pass sums the
//    splits in a fixed order and adds the bias once, so results are
//    deterministic.  With one split the bias is added in the epilogue.
// Bound: reading Wt, U*k*n*2 bytes, once per call.
// Left on the table: the FMA pipes do BM*8 FMAs per 16 bytes loaded, which
// caps prefill-sized m; wgmma on 0/1 bf16 plane tiles, TMA loads of Wt and
// a pipelined ring of stages are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kMaxMonos = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 8;            // output columns per lane (16 bytes of bf16)
constexpr int kBN = 32 * kCols;     // output columns per block
constexpr int kKC = 64;             // k values staged per chunk

struct MonoTable {
  int u;
  signed char shift[kMaxMonos][3];
};

// 8 bf16 of a Wt row from column n (n_left columns remain in the row);
// columns past the row read as 0.  vec: rows are 16-byte aligned.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int n_left,
                                       bool vec) {
  if (vec && n_left >= kCols) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c < n_left) w[c / 2] |= (uint32_t)__ldg(s + c) << (16 * (c & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BM>
__device__ __forceinline__ void add_masked(float (&acc)[BM][kCols],
                                           const uint4& raw, uint32_t mask) {
  const uint32_t p[4] = {raw.x, raw.y, raw.z, raw.w};
  float w[kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
    w[2 * i] = __uint_as_float(p[i] << 16);
    w[2 * i + 1] = __uint_as_float(p[i] & 0xffff0000u);
  }
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    const float bit = (float)((mask >> m) & 1u);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = fmaf(bit, w[c], acc[m][c]);
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
encoded_matmul_kernel(const int8_t* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wt,
                      const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ partial,
                      int M, int K, int N, int k_per_split, int vec,
                      MonoTable monos) {
  extern __shared__ float red[];  // kWarps x BM x kBN partial sums
  __shared__ int8_t xs[BM][kKC];
  __shared__ uint8_t masks[kMaxMonos][kKC];
  __shared__ int sh[kMaxMonos][3];

  const int U = monos.u;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kBN + lane * kCols;
  const int n_left = N - n0;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const size_t plane = (size_t)K * N;

  for (int i = tid; i < U * 3; i += kThreads) sh[i / 3][i % 3] = monos.shift[i / 3][i % 3];

  float acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kKC) {
    const int kn = min(kKC, k_end - kc);
    __syncthreads();  // masks of the previous chunk are consumed
    for (int i = tid; i < BM * kKC; i += kThreads) {
      const int m = i / kKC, kk = i % kKC;
      xs[m][kk] = (m0 + m < M && kk < kn) ? x[(size_t)(m0 + m) * K + kc + kk] : int8_t(0);
    }
    __syncthreads();
    for (int i = tid; i < U * kKC; i += kThreads) {
      const int u = i / kKC, kk = i % kKC;
      const int s0 = sh[u][0], s1 = sh[u][1], s2 = sh[u][2];
      uint32_t mask = 0;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int v = xs[m][kk];  // rows past M hold 0: every plane bit is 0
        mask |= (uint32_t)((v >> s0) & (v >> s1) & (v >> s2) & 1) << m;
      }
      masks[u][kk] = (uint8_t)mask;
    }
    __syncthreads();
    if (n_left > 0) {
      for (int kk = warp; kk < kn; kk += kWarps) {
        const __nv_bfloat16* wrow = wt + (size_t)(kc + kk) * N + n0;
        for (int u0 = 0; u0 < U; u0 += 8) {
          uint4 raw[8];
          uint32_t mk[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {  // all loads first, then the adds
            const int u = u0 + j;
            raw[j] = make_uint4(0u, 0u, 0u, 0u);
            mk[j] = 0u;
            if (u < U) {
              raw[j] = load8(wrow + u * plane, n_left, vec);
              mk[j] = masks[u][kk];
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) add_masked<BM>(acc, raw[j], mk[j]);
        }
      }
    }
  }

  // the warps' sums meet in shared memory and are added in warp order
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    float4* dst = reinterpret_cast<float4*>(red + (warp * BM + m) * kBN + lane * kCols);
    dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  for (int e = tid; e < BM * kBN; e += kThreads) {
    const int m = e / kBN, c = e % kBN;
    const int row = m0 + m, n = blockIdx.x * kBN + c;
    if (row >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * BM + m) * kBN + c];
    if (partial == nullptr) {
      out[(size_t)row * N + n] = s + bias[n];
    } else {
      partial[((size_t)blockIdx.z * M + row) * N + n] = s;
    }
  }
}

// Sum the k-split partials in split order, then add the bias once.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
#pragma unroll 8
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + i];
  out[i] = s + bias[i % N];
}

template <int BM>
cudaError_t launch(const int8_t* x, const __nv_bfloat16* wt, const float* bias,
                   float* out, float* partial, int M, int K, int N,
                   int splits, int k_per_split, int vec, const MonoTable& monos,
                   cudaStream_t stream) {
  const int smem = kWarps * BM * kBN * (int)sizeof(float);
  static bool configured = false;  // once, before any stream capture
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(encoded_matmul_kernel<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  encoded_matmul_kernel<BM><<<grid, kThreads, smem, stream>>>(
      x, wt, bias, out, splits > 1 ? partial : nullptr, M, K, N, k_per_split,
      vec, monos);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      partial, bias, out, M, N, splits);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).  shifts: U x 3 int32 on the host.
// workspace: splits x M x N f32 on the device when splits > 1.  bm: rows
// per block, 4 or 8.  vec: Wt rows are 16-byte aligned (N % 8 == 0 and an
// aligned base), so the kernel may read them 8 bf16 at a time.
extern "C" int encoded_matmul_launch(const void* x, const void* wt,
                                     const void* bias, void* out,
                                     void* workspace, int M, int K, int N,
                                     int U, const int* shifts, int bm,
                                     int splits, int k_per_split, int vec,
                                     void* stream) {
  if (U < 1 || U > kMaxMonos || splits < 1 || k_per_split < 1) return (int)cudaErrorInvalidValue;
  if (splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  MonoTable monos;
  monos.u = U;
  for (int u = 0; u < U; ++u)
    for (int j = 0; j < 3; ++j) monos.shift[u][j] = (signed char)shifts[u * 3 + j];
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(wt);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  auto* ws = static_cast<float*>(workspace);
  auto st = static_cast<cudaStream_t>(stream);
  if (bm == 4) return (int)launch<4>(xp, wp, bp, op, ws, M, K, N, splits, k_per_split, vec, monos, st);
  if (bm == 8) return (int)launch<8>(xp, wp, bp, op, ws, M, K, N, splits, k_per_split, vec, monos, st);
  return (int)cudaErrorInvalidValue;
}
