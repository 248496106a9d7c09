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
// Later work: Hopper's DPX instructions fuse the add and the min into one
// instruction (__viaddmin_s32, or __viaddmin_s16x2 on packed int16
// distances), which halves the instruction count of the inner loop.

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
