// Encoded-MAC bitplane matmul for Hopper (sm_90a), plain-C interface.
//
//   out[m, n] = sum_u sum_k plane_u(x[m, k]) * Wt[u, k, n] + bias[n]
//
// x holds int8 activation codes; plane_u is the AND of the 1-3 bits of
// x named by monomial u (shift/AND on the sign-extended code, so the
// two's-complement sign bit is bit 7).  Wt is bf16, sums are f32.
// Replaces the TPU kernel repro/kernels/encoded_matmul.py:_kernel, an MXU
// product of bf16 0/1 planes by bf16 Wt with f32 sums.
//
// Bound: reading Wt, U*k*n*2 bytes, once per call.  On the main path m is
// 4 (decode) or 32 (a prefill chunk), far below the ~295 operations per
// byte where the tensor cores would bind, so the design is about keeping
// enough bytes of Wt in flight on every SM and touching each byte once.
//
// Design.  The product runs transposed, out^T (n x m) = Wt^T . planes^T
// over the flattened (u, k) axis, on the tensor cores:
//  * mma.sync.m16n8k16 (bf16 in, f32 sums).  n is the MMA's M side (16
//    columns of Wt per instruction), m, padded to TN = 8, 16 or 32 rows,
//    its N side.  mma.sync and not wgmma: at m <= 32 bytes bind, not the
//    tensor-core rate, and a warp-level MMA lets each warp run its own
//    ring with no block-wide barrier per stage;
//  * A (Wt) comes from shared memory by ldmatrix.trans: a Wt row is k-major
//    with n contiguous, which is the MMA's A in column-major form;
//  * B (the planes) is built in registers straight from the int8 codes:
//    a thread's B fragment is 4 codes (k = 2t, 2t+1, 2t+8, 2t+9 of one
//    row), packed in one 32-bit word; (w >> s0) & (w >> s1) & (w >> s2) &
//    0x01010101 is the plane bit of all four at once, and a byte permute
//    times 0x3F80 spreads it into two bf16x2 registers of 0.0 / 1.0.  The
//    planes never reach device or shared memory;
//  * each warp streams its own run of (u, k) chunks (32 k x 64 n of one
//    plane, 4 KB) through a ring of 3 stages by cp.async (16-byte copies,
//    the zero-fill form past the ragged k and n edges): 48 KB of Wt in
//    flight per block, three blocks per SM.  The first chunk of each k
//    column in a warp's run also brings that column's codes (32 bytes of
//    each of the pass's rows), so they arrive as far ahead as Wt and serve
//    all U planes of the column; loading them from device memory when
//    needed stalled the warp for several microseconds a call at m = 32.
//    (Measured on the H100: 2 to 4 stages stream equally fast; 8, at 128
//    KB a block, leave one block per SM, and 8-block clusters of those do
//    not all fit at once.)
//  * the (u, k) axis is split across the blocks of a thread-block cluster
//    (grid.y = cluster.y = splits <= 8) so that n/64 x splits fills the
//    card at decode; the 4 warps of a block take consecutive runs of the
//    block's chunks and meet in shared memory in warp order, then each
//    block of the cluster sums its slice of the output tile over the
//    cluster's blocks in rank order through distributed shared memory and
//    adds the bias once.  One launch, no workspace in device memory, and a
//    fixed order, so results are deterministic;
//  * m > 32 loops over 32-row passes inside the block, each re-streaming
//    the block's chunks (from L2 when they were just read).
// Planes are 0/1, so every product is exact and only the order of the f32
// sums differs from the plain version.  Rows of Wt that are not 16-byte
// aligned (n % 8 != 0) are copied element by element into the same ring.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxMonos = 92;                  // C(8,1) + C(8,2) + C(8,3): every 8-bit program
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 64;                        // Wt columns per block
constexpr int kKC = 32;                        // k per chunk (one ring stage)
constexpr int kStages = 3;                     // ring stages per warp
constexpr int kMaxSplits = 8;                  // blocks of a cluster (portable)
constexpr int kRowBytes = kBN * 2;             // one Wt row of a stage
constexpr int kWtBytes = kKC * kRowBytes;      // 4 KB of Wt per stage
constexpr int kRedStride = kBN + 4;            // f32 row stride, reduction tile
// a stage: the chunk's Wt, then room for TN rows of 32 codes
__host__ __device__ constexpr int stage_bytes(int tn) { return kWtBytes + tn * kKC; }
__host__ __device__ constexpr int ring_bytes(int tn) { return kWarps * kStages * stage_bytes(tn); }
__host__ __device__ constexpr int red_bytes(int tn) { return kWarps * tn * kRedStride * 4; }  // warps' sums

struct MonoTable {
  signed char shift[kMaxMonos][3];
};

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

// Copy chunk (u, kc) -- rows k0 .. k0+31 of plane u, columns n0 .. n0+63 --
// into a ring stage.  Stage row r holds 8 pieces of 16 bytes; piece c lands
// at c ^ (r & 7) so that ldmatrix's 8 rows hit 8 different bank groups.
// With `codes`, the chunk is the first of its k column in the warp's run,
// and the stage also takes that column's codes: rows m0 .. m0+TN-1 of x,
// 32 bytes each, behind the Wt rows.  Rows, k and n past the edges read
// as 0 (code 0 has no plane bits).  vec / xvec: Wt / x rows are 16-byte
// aligned, so the stage fills by cp.async; otherwise element by element.
template <int TN>
__device__ __forceinline__ void issue_chunk(const __nv_bfloat16* __restrict__ wt,
                                            const int8_t* __restrict__ x, int u, int kc,
                                            bool codes, int M, int K, int N, int n0, int m0,
                                            int vec, bool xvec, uint32_t stage,
                                            unsigned char* stage_ptr, int lane) {
  const int k0 = kc * kKC;
  const __nv_bfloat16* src0 = wt + ((size_t)u * K + k0) * N + n0;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kKC * 8 / 32; ++i) {
      const int p = lane + 32 * i, r = p >> 3, c = p & 7;
      const int n_left = N - (n0 + c * 8);
      const bool ok = k0 + r < K && n_left > 0;
      const void* src = ok ? (const void*)(src0 + (size_t)r * N + c * 8) : (const void*)wt;
      cp_async16(stage + r * kRowBytes + ((c ^ (r & 7)) << 4), src,
                 ok ? min(16, 2 * n_left) : 0);
    }
  } else {
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src0);
    for (int p = lane; p < kKC * kBN; p += 32) {
      const int r = p / kBN, c = p % kBN;
      const bool ok = k0 + r < K && n0 + c < N;
      *reinterpret_cast<unsigned short*>(stage_ptr + r * kRowBytes +
                                         (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) =
          ok ? __ldg(s16 + (size_t)r * N + c) : (unsigned short)0;
    }
  }
  if (!codes) return;
  if (xvec) {
    for (int p = lane; p < TN * 2; p += 32) {
      const int r = p >> 1, kk = k0 + (p & 1) * 16;
      const int bytes = m0 + r < M ? max(0, min(16, K - kk)) : 0;
      const void* src = bytes ? (const void*)(x + (size_t)(m0 + r) * K + kk) : (const void*)x;
      cp_async16(stage + kWtBytes + p * 16, src, bytes);
    }
  } else {
    for (int p = lane; p < TN * kKC; p += 32) {
      const int r = p / kKC, kk = k0 + p % kKC;
      stage_ptr[kWtBytes + p] =
          m0 + r < M && kk < K ? (unsigned char)__ldg(x + (size_t)(m0 + r) * K + kk) : 0;
    }
  }
}

// The codes a thread's B fragments take from a stage's code rows, one word
// per (m8 tile, k16 step): row 8 mt + g, k = 16 ks + {2t, 2t+1, 2t+8,
// 2t+9} of the column.
template <int MT>
__device__ __forceinline__ void read_codes(uint32_t (&xw)[MT][2], const unsigned char* xs, int g,
                                           int tig) {
  const uint32_t sel = (tig & 1) ? 0x7632u : 0x5410u;   // bytes 2t, 2t+1 of two words
  const bool hi = tig >> 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const uint4 a = *reinterpret_cast<const uint4*>(xs + (mt * 8 + g) * kKC);
    const uint4 b = *reinterpret_cast<const uint4*>(xs + (mt * 8 + g) * kKC + 16);
    xw[mt][0] = __byte_perm(hi ? a.y : a.x, hi ? a.w : a.z, sel);
    xw[mt][1] = __byte_perm(hi ? b.y : b.x, hi ? b.w : b.z, sel);
  }
}

template <int TN>
__global__ void __launch_bounds__(kThreads, 3)
encoded_matmul_kernel(const int8_t* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                      const float* __restrict__ bias, float* __restrict__ out, int M, int K,
                      int N, int U, int chunks_per_split, int vec, MonoTable monos) {
  constexpr int MT = TN / 8;                   // m8 tiles per pass
  constexpr int kStageBytes = stage_bytes(TN);
  static_assert(red_bytes(TN) + TN * kBN * 4 <= ring_bytes(TN), "fits the rings");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint32_t shifts[kMaxMonos];       // s0 | s1 << 8 | s2 << 16, each <= 7

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int chunks = U * ((K + kKC - 1) / kKC);
  const int s_begin = blockIdx.y * chunks_per_split;
  const int s_end = min(chunks, s_begin + chunks_per_split);
  const int per_warp = (chunks_per_split + kWarps - 1) / kWarps;
  const int j_begin = min(s_end, s_begin + warp * per_warp);
  const int count = min(s_end, j_begin + per_warp) - j_begin;
  unsigned char* ring = smem + warp * kStages * kStageBytes;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  const bool xvec = (K & 15) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  for (int u = threadIdx.x; u < U; u += kThreads) {
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) packed |= (uint32_t)min((int)monos.shift[u][j], 7) << (8 * j);
    shifts[u] = packed;
  }
  __syncthreads();

  for (int m0 = 0; m0 < M; m0 += TN) {
    float acc[4][MT][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][mt][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s < count) {
        const int j = j_begin + s, kc = j / U;
        issue_chunk<TN>(wt, x, j - kc * U, kc, s == 0 || j == kc * U, M, K, N, n0, m0, vec,
                        xvec, ring_s + s * kStageBytes, ring + s * kStageBytes, lane);
      }
      cp_async_commit();
    }

    uint32_t xw[MT][2];                        // codes of the current k column
    for (int i = 0; i < count; ++i) {
      const int j = j_begin + i, kc = j / U, u = j - kc * U;
      cp_async_wait<kStages - 1>();            // chunk i has landed (this lane's part)
      __syncwarp();                            // ... and every lane's
      const uint32_t stage = ring_s + (i % kStages) * kStageBytes;
      if (i == 0 || u == 0) read_codes<MT>(xw, ring + (i % kStages) * kStageBytes + kWtBytes, g, tig);
      const uint32_t sh = shifts[u];
      const int s0 = sh & 0xff, s1 = (sh >> 8) & 0xff, s2 = sh >> 16;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t b[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t w = xw[mt][ks];
          const uint32_t t = (w >> s0) & (w >> s1) & (w >> s2) & 0x01010101u;
          b[mt][0] = __byte_perm(t, 0u, 0x4140) * 0x3F80u;   // k = 2t, 2t+1
          b[mt][1] = __byte_perm(t, 0u, 0x4342) * 0x3F80u;   // k = 2t+8, 2t+9
        }
        const int r = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = nt * 2 + ((lane >> 3) & 1);
          uint32_t a[4];
          ldsm_x4_trans(a, stage + r * kRowBytes + ((c ^ (r & 7)) << 4));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[nt][mt], a, b[mt][0], b[mt][1]);
        }
      }
      __syncwarp();                            // every lane is done with the stage
      if (i + kStages < count) {
        const int jn = j + kStages, kcn = jn / U;
        issue_chunk<TN>(wt, x, jn - kcn * U, kcn, jn == kcn * U, M, K, N, n0, m0, vec, xvec,
                        stage, ring + (i % kStages) * kStageBytes, lane);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();                           // every warp is done with its ring

    // the warps' sums meet in shared memory (over the rings) in warp order
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mm = mt * 8 + 2 * tig + (e & 1), nn = nt * 16 + g + (e >> 1) * 8;
          red[(warp * TN + mm) * kRedStride + nn] = acc[nt][mt][e];
        }
    __syncthreads();
    // the block's tile, then the cluster's: block r sums its slice of the
    // tile over the cluster's blocks in rank order and adds the bias once
    float* tile = reinterpret_cast<float*>(smem + red_bytes(TN));
    for (int e = threadIdx.x; e < TN * kBN; e += kThreads) {
      const int mm = e / kBN, c = e % kBN;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[(w * TN + mm) * kRedStride + c];
      tile[e] = s;
    }
    cg::cluster_group cluster = cg::this_cluster();
    const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    cluster.sync();                            // every tile of the cluster is summed
    const int per = (TN * kBN + splits - 1) / splits;
    const int e_end = min(TN * kBN, (rank + 1) * per);
    for (int e = rank * per + threadIdx.x; e < e_end; e += kThreads) {
      const int row = m0 + e / kBN, n = n0 + e % kBN;
      if (row >= M || n >= N) continue;
      float s = 0.f;
      for (int z = 0; z < splits; ++z) s += cluster.map_shared_rank(tile, z)[e];
      out[(size_t)row * N + n] = s + bias[n];
    }
    cluster.sync();                            // the tiles are read; rings are free
  }
}

template <int TN>
cudaError_t launch(const int8_t* x, const __nv_bfloat16* wt, const float* bias, float* out,
                   int M, int K, int N, int U, int splits, int chunks_per_split, int vec,
                   const MonoTable& monos, cudaStream_t stream) {
  static bool configured = false;  // once, before any stream capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(encoded_matmul_kernel<TN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           ring_bytes(TN));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = ring_bytes(TN);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, encoded_matmul_kernel<TN>, x, wt, bias, out, M, K, N, U,
                            chunks_per_split, vec, monos);
}

}  // namespace

// Returns a cudaError_t (0 = launched).  shifts: U x 3 int32 on the host.
// tn: rows per pass, 8, 16 or 32.  The (u, k) axis is cut into chunks of
// 32 k of one plane, chunk j = kc * U + u; split z (grid.y, the block's
// rank in its cluster) takes chunks [z * chunks_per_split, (z + 1) *
// chunks_per_split), 1 <= splits <= 8.  vec: Wt rows are 16-byte aligned
// (N % 8 == 0 and an aligned base), so the ring fills by cp.async.
extern "C" int encoded_matmul_launch(const void* x, const void* wt, const void* bias,
                                     void* out, int M, int K, int N, int U, const int* shifts,
                                     int tn, int splits, int chunks_per_split, int vec,
                                     void* stream) {
  const int chunks = U * ((K + kKC - 1) / kKC);
  if (U < 1 || U > kMaxMonos || M < 1 || K < 1 || N < 1 || splits < 1 ||
      splits > kMaxSplits || chunks_per_split < 1 ||
      (long long)splits * chunks_per_split < chunks || (splits - 1) * chunks_per_split >= chunks)
    return (int)cudaErrorInvalidValue;
  MonoTable monos;
  for (int u = 0; u < U; ++u)
    for (int j = 0; j < 3; ++j) monos.shift[u][j] = (signed char)shifts[u * 3 + j];
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(wt);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (tn) {
    case 8: return (int)launch<8>(xp, wp, bp, op, M, K, N, U, splits, chunks_per_split, vec, monos, st);
    case 16: return (int)launch<16>(xp, wp, bp, op, M, K, N, U, splits, chunks_per_split, vec, monos, st);
    case 32: return (int)launch<32>(xp, wp, bp, op, M, K, N, U, splits, chunks_per_split, vec, monos, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
