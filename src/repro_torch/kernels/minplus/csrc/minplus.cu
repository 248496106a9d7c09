// Tropical (min, +) matrix product for Hopper (sm_90a), bound through
// ctypes.
//
// Replaces the Pallas kernel minplus in
// src/repro/kernels/minplus/kernel.py:42 (pallas_call at :54):
//
//   C[i, j] = min(INF, min_k __fadd_rn(A[i, k], B[k, j]))
//
// with A [M, K], B [K, N] and C [M, N] float32, row-major.  Powering the
// hop-weighted adjacency matrix under this product gives all-pairs hop
// distances (repro_torch.kernels.minplus.ops.all_pairs_distances), which
// the routing tables take on the card instead of a host BFS.
//
// Exactness: each sum is one float32 add rounded to nearest (__fadd_rn,
// never contracted), and fminf is exact, so the result is the same for
// any order of the k loop: bit for bit the plain version in ../ref.py and
// the TPU kernel, whose accumulator also starts at INF.  NaN inputs are
// outside the contract: fminf drops a NaN where jnp.min keeps it.
//
// Bound: operations.  Every (i, k, j) costs one add and one min, 2 M N K
// float32 operations, against 4 (MK + KN + MN) bytes of traffic; at the
// 100k-endpoint fabrics' N = 8,748 and 23,328 that is far above the
// card's operations-per-byte balance.  Tensor cores do not apply: (min, +)
// has no MMA form.
//
// Design: a simple tiled kernel.  One block of 256 threads computes one
// 64 x 64 tile of C, each thread a 4 x 4 sub-tile held in registers and
// started at INF.  K is walked in slabs of 16 staged through shared
// memory: the A slab is stored transposed (k-major), so the inner loop
// reads one float4 of A and one float4 of B per k and neither read has a
// bank conflict.  Loads past the edge of A or B read INF, so any M, N and
// K work without a padding copy: a padded k adds INF + INF, which never
// beats the INF the accumulator starts from, and padded rows and columns
// are never stored.
//
// The table build runs the integer form below (minplus_hops_kernel), which
// fuses the add and the min into one DPX instruction on packed int16 hop
// counts; this float32 kernel stays the counterpart of the TPU kernel.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kInf = 1e9f;
constexpr int kBM = 64;                // C tile rows
constexpr int kBN = 64;                // C tile columns
constexpr int kBK = 16;                // K slab depth
constexpr int kTM = 4;                 // rows per thread
constexpr int kTN = 4;                 // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
// row stride of the transposed A slab: keeps float4 alignment and turns
// the 16-way bank conflict of the transposing store into a 2-way one
constexpr int kAStride = kBM + 4;

__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[kBK][kAStride];
  __shared__ __align__(16) float bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = kInf;
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A slab [64 rows, 16 k]: 16 consecutive threads read one row's 64
    // contiguous bytes; stored k-major
#pragma unroll
    for (int p = 0; p < kBM * kBK / kThreads; ++p) {
      const int r = tid / kBK + p * (kThreads / kBK);
      const int kk = tid % kBK;
      const int gr = m0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k)
                      ? a[static_cast<size_t>(gr) * k + gk] : kInf;
    }
    // B slab [16 k, 64 columns]: 64 consecutive threads read one row
#pragma unroll
    for (int p = 0; p < kBK * kBN / kThreads; ++p) {
      const int kk = tid / kBN + p * (kThreads / kBN);
      const int cc = tid % kBN;
      const int gk = k0 + kk, gc = n0 + cc;
      bs[kk][cc] = (gk < k && gc < n)
                       ? b[static_cast<size_t>(gk) * n + gc] : kInf;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * kTM]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * kTN]);
      const float ar[kTM] = {av.x, av.y, av.z, av.w};
      const float br[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = fminf(acc[i][j], __fadd_rn(ar[i], br[j]));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty * kTM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < n) c[static_cast<size_t>(row) * n + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// C = A (min, +) B on `stream`; returns cudaGetLastError() of the launch.
int minplus_launch(const float* a, const float* b, float* c, int m, int n,
                   int k, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  minplus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Integer (min, +) product on packed int16 hop counts, with Hopper's DPX.
//
// Replaces the same Pallas kernel (src/repro/kernels/minplus/kernel.py:42)
// on the routing-table build's path (repro_torch.core.routing
// .hop_distances):
//
//   C[i, j] = min(S, min_k At[k, i] + B[k, j]),   S = 0x3FFF ("no path")
//
// with At [K, M] (A given k-major), B [K, N] and C [M, N] int16, row-major
// with leading dimensions lda, ldb, ldc that are multiples of 8, and every
// pointer 16-byte aligned.  Entries lie in [0, S]; S + S = 32,766 fits an
// int16 lane, so no sum wraps.  On finite entries below S / 2 (8,192) every
// finite sum stays below S, and the result equals the float32 kernel's,
// bit for bit under v <-> float(v) and S <-> INF: both take exact sums and
// an exact min, and both cap "no path" at their sentinel.
//
// Bound: operations.  M N K (min, +) triples, two per VIADDMNMX (one int16
// lane each), against 2 (MK + KN + MN) bytes: far above the card's
// operations-per-byte balance at the fabrics' N = 8,748 and 23,328.  The
// DPX instruction's issue rate, measured by ../bench.py, sets the bound.
//
// Design: one block of 256 threads computes a 128 x 128 tile of C, each
// thread 8 rows x 8 columns held as 8 x 4 packed words started at S.  K
// goes in slabs of 32 through a 4-stage ring of 16-byte cp.async copies
// (64 KB of dynamic shared memory): At being k-major, both operand slabs
// are runs of contiguous row segments and land without a transposing
// store.  Per k a thread reads 16 bytes of A and 16 of B.  Rows are paired
// on the diagonal: the word (A[2i], A[2i+1]) meets (B[2j], B[2j+1]) for
// C[2i][2j] and C[2i+1][2j+1], and the half-swapped (B[2j+1], B[2j]) for
// C[2i][2j+1] and C[2i+1][2j], so 32 VIADDMNMX cost 4 PRMT, and the
// epilogue puts the lanes back in rows.  Blocks walk the tiles in groups
// of 8 row tiles, so the blocks in flight share their slabs in L2.
//
// Edges: slab rows past K and chunks that start past the edge of M or N
// hold S, which never beats the accumulator; a chunk that crosses the
// edge reads up to the next multiple of 8 (inside the leading dimension)
// and feeds only rows and columns that are never stored.  C is written
// only inside [M, N]: its padding columns keep what they held.

#include <cstdint>

namespace {

constexpr unsigned kHopsInf2 = 0x3FFF3FFFu;   // S in both int16 lanes
constexpr int kHM = 128;                      // C tile rows
constexpr int kHN = 128;                      // C tile columns
constexpr int kHK = 32;                       // K slab depth
constexpr int kHStages = 4;                   // cp.async ring depth
constexpr int kHThreads = 256;
constexpr int kHGroup = 8;                    // row tiles per tile group
constexpr int kHSlab = kHK * kHM;             // int16 entries per slab
constexpr int kHSmemBytes = kHStages * 2 * kHSlab * 2;   // 64 KB
static_assert(kHM == kHN, "load_slab copies 128-wide slabs of both operands");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// One K slab [kHK rows, 128 columns] of an operand into shared memory:
// 512 chunks of 16 bytes, two per thread; 16 consecutive threads copy one
// row's 256 contiguous bytes.
__device__ __forceinline__ void load_slab(int16_t* dst,
                                          const int16_t* __restrict__ x,
                                          int ld, int cols, int k, int k0,
                                          int c0, int tid) {
#pragma unroll
  for (int p = 0; p < kHSlab / 8 / kHThreads; ++p) {
    const int q = tid + p * kHThreads;
    const int r = q / (kHM / 8);
    const int cc = (q % (kHM / 8)) * 8;
    int16_t* d = dst + r * kHM + cc;
    if (k0 + r < k && c0 + cc < cols) {
      cp_async16(d, x + static_cast<size_t>(k0 + r) * ld + c0 + cc);
    } else {
      *reinterpret_cast<uint4*>(d) =
          make_uint4(kHopsInf2, kHopsInf2, kHopsInf2, kHopsInf2);
    }
  }
}

__global__ void __launch_bounds__(kHThreads, 2)
minplus_hops_kernel(const int16_t* __restrict__ at,
                    const int16_t* __restrict__ b, int16_t* __restrict__ c,
                    int m, int n, int k, int lda, int ldb, int ldc) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* as = reinterpret_cast<int16_t*>(smem);
  int16_t* bs = as + kHStages * kHSlab;

  const int tid = threadIdx.x;
  const int tx = tid % (kHN / 8);
  const int ty = tid / (kHN / 8);

  // grouped tile order: kHGroup row tiles share the blocks in flight
  const int tiles_m = (m + kHM - 1) / kHM;
  const int tiles_n = (n + kHN - 1) / kHN;
  const int per_group = kHGroup * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kHGroup;
  const int group_m = min(tiles_m - first_m, kHGroup);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * kHM;
  const int n0 = (in_group / group_m) * kHN;

  // d0[i][j]: lanes C[2i][2j], C[2i+1][2j+1]; d1[i][j]: C[2i][2j+1],
  // C[2i+1][2j] (rows and columns of this thread's 8 x 8)
  unsigned d0[4][4], d1[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) d0[i][j] = d1[i][j] = kHopsInf2;
  }

  const int n_slabs = (k + kHK - 1) / kHK;
#pragma unroll
  for (int s = 0; s < kHStages - 1; ++s) {
    if (s < n_slabs) {
      load_slab(as + s * kHSlab, at, lda, m, k, s * kHK, m0, tid);
      load_slab(bs + s * kHSlab, b, ldb, n, k, s * kHK, n0, tid);
    }
    cp_async_commit();
  }

  for (int t = 0; t < n_slabs; ++t) {
    cp_async_wait<kHStages - 2>();
    __syncthreads();
    // the stage refilled here was read in step t - 1, which every thread
    // has finished at the barrier above
    const int nxt = t + kHStages - 1;
    if (nxt < n_slabs) {
      const int s = nxt % kHStages;
      load_slab(as + s * kHSlab, at, lda, m, k, nxt * kHK, m0, tid);
      load_slab(bs + s * kHSlab, b, ldb, n, k, nxt * kHK, n0, tid);
    }
    cp_async_commit();

    const int16_t* sa = as + (t % kHStages) * kHSlab + ty * 8;
    const int16_t* sb = bs + (t % kHStages) * kHSlab + tx * 8;
#pragma unroll
    for (int kk = 0; kk < kHK; ++kk) {
      const uint4 av = *reinterpret_cast<const uint4*>(sa + kk * kHM);
      const uint4 bv = *reinterpret_cast<const uint4*>(sb + kk * kHN);
      const unsigned a[4] = {av.x, av.y, av.z, av.w};
      const unsigned bw[4] = {bv.x, bv.y, bv.z, bv.w};
      unsigned bsw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bsw[j] = __byte_perm(bw[j], 0, 0x1032);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d0[i][j] = __viaddmin_s16x2(a[i], bw[j], d0[i][j]);
          d1[i][j] = __viaddmin_s16x2(a[i], bsw[j], d1[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int col = n0 + tx * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned w[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[0][j] = __byte_perm(d0[i][j], d1[i][j], 0x5410);   // row 2i
      w[1][j] = __byte_perm(d1[i][j], d0[i][j], 0x7632);   // row 2i + 1
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + ty * 8 + 2 * i + h;
      if (row >= m) continue;
      int16_t* dst = c + static_cast<size_t>(row) * ldc + col;
      if (col + 8 <= n) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(w[h][0], w[h][1], w[h][2], w[h][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (col + e < n)
            dst[e] = static_cast<int16_t>(w[h][e / 2] >> (16 * (e % 2)));
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// C = At^T (min, +) B on `stream`, capped at S; returns cudaGetLastError()
// of the launch (or of the shared-memory opt-in).
int minplus_hops_launch(const int16_t* at, const int16_t* b, int16_t* c,
                        int m, int n, int k, int lda, int ldb, int ldc,
                        void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        minplus_hops_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kHSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int tiles = ((m + kHM - 1) / kHM) * ((n + kHN - 1) / kHN);
  minplus_hops_kernel<<<tiles, kHThreads, kHSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      at, b, c, m, n, k, lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The DPX issue-rate probe that sets minplus_hops_kernel's bound.
#include "dpx_probe.cuh"
