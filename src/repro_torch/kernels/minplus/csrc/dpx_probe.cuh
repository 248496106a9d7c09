// Issue-rate probe of Hopper's DPX add-min instructions (sm_90a), built
// into minplus.cu's library and bound through ctypes; run by ../bench.py,
// which sets the integer min-plus kernel's bound (minplus_hops_kernel)
// from its result.
//
// Each thread runs kProbeChains independent chains x = min(x + y, z) in
// registers, unrolled, with y and z read from memory so that nothing
// folds; enough blocks fill every SM.  Thread 0 of each block records the
// SM clocks its loop took (clock64), so the rate per SM per clock does not
// depend on the clock the card ran at.  Op 0 is __viaddmin_s16x2 (two
// int16 lanes), op 1 __viaddmin_s32, op 2 the float32 kernel's pair
// fminf(__fadd_rn(x, y), z) for comparison.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kProbeChains = 8;
constexpr int kProbeUnroll = 8;
constexpr int kProbeThreads = 256;

template <int Op>
__device__ __forceinline__ unsigned probe_step(unsigned x, unsigned y,
                                               unsigned z) {
  if (Op == 0) return __viaddmin_s16x2(x, y, z);
  if (Op == 1) {
    return static_cast<unsigned>(__viaddmin_s32(
        static_cast<int>(x), static_cast<int>(y), static_cast<int>(z)));
  }
  return __float_as_uint(fminf(
      __fadd_rn(__uint_as_float(x), __uint_as_float(y)), __uint_as_float(z)));
}

template <int Op>
__global__ void __launch_bounds__(kProbeThreads)
dpx_probe_kernel(const unsigned* __restrict__ in, unsigned* __restrict__ out,
                 long long* __restrict__ cycles, int iters) {
  const unsigned y = in[0], z = in[1];
  unsigned x[kProbeChains];
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c) x[c] = in[2] + c + threadIdx.x;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kProbeChains; ++c)
        x[c] = probe_step<Op>(x[c], y, z);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  unsigned acc = 0;
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c) acc ^= x[c];
  out[blockIdx.x * kProbeThreads + threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int Op>
int probe_launch(const unsigned* in, unsigned* out, long long* cycles,
                 int blocks, int iters, cudaStream_t stream) {
  dpx_probe_kernel<Op><<<blocks, kProbeThreads, 0, stream>>>(in, out, cycles,
                                                             iters);
  return static_cast<int>(cudaGetLastError());
}

template <int Op>
int probe_occupancy() {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, dpx_probe_kernel<Op>, kProbeThreads, 0) == cudaSuccess
             ? n : -1;
}

}  // namespace

extern "C" {

// Steps each thread runs per loop iteration; threads per block.
int dpx_probe_steps() { return kProbeChains * kProbeUnroll; }
int dpx_probe_threads() { return kProbeThreads; }

// Blocks of op `op` resident on one SM at once (-1 on an error).
int dpx_probe_occupancy(int op) {
  if (op == 0) return probe_occupancy<0>();
  if (op == 1) return probe_occupancy<1>();
  return probe_occupancy<2>();
}

// One probe launch of op `op` on `stream`: `blocks` blocks of
// dpx_probe_threads() threads, `iters` iterations of dpx_probe_steps()
// steps each; `in` holds y, z and a start value; out[blocks * threads],
// cycles[blocks].  Returns cudaGetLastError() of the launch.
int dpx_probe_launch(int op, const unsigned* in, unsigned* out,
                     long long* cycles, int blocks, int iters,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == 0) return probe_launch<0>(in, out, cycles, blocks, iters, s);
  if (op == 1) return probe_launch<1>(in, out, cycles, blocks, iters, s);
  return probe_launch<2>(in, out, cycles, blocks, iters, s);
}

}  // extern "C"
