// Mamba-1 selective scan for Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas kernel selective_scan in
// src/repro/kernels/selective_scan/kernel.py:39 (pallas_call at :53):
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = sum_n h_t[n] * C_t[n]
//
// with u, dt, y [B, T, Di], A [Di, N], B, C [B, T, N], h0, h_T [B, Di, N],
// all float32, row-major, and N = 16.
//
// Exactness: every product and sum is one float32 rounding (__fmul_rn,
// __fadd_rn, never contracted into an FMA), exp is the accurate expf that
// PyTorch's exp also runs on the card, and the sum over the state is a
// shuffle tree with offsets 8, 4, 2, 1, which is the halving order of the
// plain version in ../ref.py.  So the kernel can equal the plain version
// bit for bit.
//
// Bound: bytes.  Each (b, t, channel) reads u and dt and writes y, 12
// bytes, against about 7 operations per state element (16 per channel),
// far below the card's float32 operations-per-byte balance.  But time is
// sequential: T dependent steps per channel.
//
// Design: channels and states are independent, time is not.  One thread
// owns one (b, channel, state n) and walks all T steps with h in a
// register; a block of 256 threads is 16 channels x 16 states of one batch
// row, so a channel's 16 states are one half-warp and y_t is four
// shuffles.  The 16 lanes of a channel read the same u and dt (one
// broadcast) and lane n reads B_t[n] and C_t[n] (64 contiguous bytes);
// the loads do not depend on h, so the unrolled loop starts them ahead of
// the recurrence.  At the serving slice (B 4, Di 3,200) that is 204,800
// threads in 800 blocks, about 48 warps per SM.  Channels past Di run with
// zeros and store nothing.
//
// Later work: stage u, dt, B and C for a run of steps in shared memory
// with cp.async, and split T into chunks scanned in parallel with a
// second pass that carries the state across chunks.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kN = 16;                  // state size
constexpr int kChannels = 16;           // channels per block
constexpr int kThreads = kChannels * kN;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ bc,
                      const float* __restrict__ cc,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_t, int steps, int di) {
  const int n = threadIdx.x % kN;
  const int ch = blockIdx.x * kChannels + threadIdx.x / kN;
  const int b = blockIdx.y;
  const bool ok = ch < di;
  const int c = ok ? ch : 0;

  const float an = ok ? a[static_cast<size_t>(c) * kN + n] : 0.f;
  const size_t hi = (static_cast<size_t>(b) * di + c) * kN + n;
  float h = ok ? h0[hi] : 0.f;
  const size_t seq = static_cast<size_t>(b) * steps;
  const float* up = u + seq * di + c;
  const float* dp = dt + seq * di + c;
  const float* bp = bc + seq * kN + n;
  const float* cp = cc + seq * kN + n;
  float* yp = y + seq * di + c;

#pragma unroll 4
  for (int t = 0; t < steps; ++t) {
    const size_t tc = static_cast<size_t>(t) * di;
    const float dtv = ok ? dp[tc] : 0.f;
    const float uv = ok ? up[tc] : 0.f;
    const float bv = bp[static_cast<size_t>(t) * kN];
    const float cv = cp[static_cast<size_t>(t) * kN];
    const float da = expf(__fmul_rn(dtv, an));
    const float dbu = __fmul_rn(dtv, uv);
    h = __fadd_rn(__fmul_rn(da, h), __fmul_rn(dbu, bv));
    float yv = __fmul_rn(h, cv);
    yv = __fadd_rn(yv, __shfl_xor_sync(kFull, yv, 8));
    yv = __fadd_rn(yv, __shfl_xor_sync(kFull, yv, 4));
    yv = __fadd_rn(yv, __shfl_xor_sync(kFull, yv, 2));
    yv = __fadd_rn(yv, __shfl_xor_sync(kFull, yv, 1));
    if (ok && n == 0) yp[tc] = yv;
  }
  if (ok) h_t[hi] = h;
}

}  // namespace

extern "C" {

// (y, h_T) = scan(u, dt, A, B, C, h0) on `stream`; returns
// cudaGetLastError() of the launch.
int selective_scan_launch(const float* u, const float* dt, const float* a,
                          const float* bc, const float* cc, const float* h0,
                          float* y, float* h_t, int b, int steps, int di,
                          void* stream) {
  const dim3 grid((di + kChannels - 1) / kChannels, b);
  selective_scan_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      u, dt, a, bc, cc, h0, y, h_t, steps, di);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
