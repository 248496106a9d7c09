// Crossbar arbitration kernels for Hopper (sm_90a), bound through ctypes.
//
// Plain C entry points take device pointers, sizes and the CUDA stream,
// launch on that stream without synchronising, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// The plain PyTorch versions of both functions are in ../ref.py; the two
// agree bit for bit (integer arithmetic, and float adds rounded
// to nearest with no contraction into FMA).

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;

// ---------------------------------------------------------------------- //
// vc_prearb
//
// Replaces the Pallas kernel vc_prearb in
// src/repro/kernels/switch_arb/kernel.py (stage 1 of a crossbar
// sub-round): per (switch, port) row, the first VC of highest priority
// among those with qlen > 0, and whether there was one.  The engine also
// runs it for the link phase's choice of output VC.
//
// Bound: bytes.  Each row reads V int32 + V float32 and writes two int32;
// at the paper's 11k-endpoint fabric that is 1.3 MB, well under a
// microsecond of HBM time, so the launch itself dominates.  Design: one
// thread per row, V looped in registers, no shared memory; consecutive
// threads read consecutive rows, so the loads coalesce.
// ---------------------------------------------------------------------- //
__global__ void vc_prearb_kernel(const int* __restrict__ qlen,
                                 const float* __restrict__ rand,
                                 int* __restrict__ sel,
                                 int* __restrict__ has,
                                 int rows, int v) {
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < rows;
       row += gridDim.x * blockDim.x) {
    const int* q = qlen + static_cast<size_t>(row) * v;
    const float* r = rand + static_cast<size_t>(row) * v;
    float best = q[0] > 0 ? r[0] : -1.0f;
    int arg = 0;
    for (int k = 1; k < v; ++k) {
      const float x = q[k] > 0 ? r[k] : -1.0f;
      if (x > best) {  // strict: ties keep the lowest VC, as jnp.argmax
        best = x;
        arg = k;
      }
    }
    sel[row] = arg;
    has[row] = best >= 0.0f ? 1 : 0;
  }
}

// ---------------------------------------------------------------------- //
// switch_arbitrate
//
// Replaces the Pallas kernel switch_arbitrate in
// src/repro/kernels/switch_arb/kernel.py (stages 2+3 fused): per
// requester row, score = (occ + penalty * deroute) + tie over the ports,
// masked to kBig, first argmin; then per (switch, output port) the
// largest priority word (rnd << 23 | lo) among the requesters that can
// move, and the grant to its owner.
//
// Bound: bytes.  The [N, R, P] inputs (occ, deroute, mask as int32, tie
// as float32) are 16 bytes per element, read once: 29.8 MB at the
// paper's 11k-endpoint fabric, about 9 us of HBM time.  Design: one
// block per switch, which keeps the segmented max inside the block:
// the per-port maximum lives in shared memory and is built with
// atomicMax on int32 (order-independent, so the result is exact).  No
// (8, 128) padding: threads loop over rows and every row loops over its
// P ports, so any R and P work.  The row-major [R, P] layout means a
// thread walks its own row; a later version can stage the switch's
// block through shared memory so that a warp's loads coalesce.
// ---------------------------------------------------------------------- //
__global__ void switch_arbitrate_kernel(const int* __restrict__ occ,
                                        const int* __restrict__ der,
                                        const int* __restrict__ mask,
                                        const float* __restrict__ tie,
                                        const int* __restrict__ route,
                                        const int* __restrict__ rnd,
                                        const int* __restrict__ lo,
                                        int* __restrict__ port,
                                        int* __restrict__ win,
                                        int* __restrict__ seg,
                                        int r, int p, float penalty) {
  extern __shared__ int smem[];
  int* s_seg = smem;          // [p] winning priority per output port
  int* s_prio = smem + p;     // [r] each row's priority word
  int* s_port = s_prio + r;   // [r] chosen port, -1 if the row cannot move
  const size_t n = blockIdx.x;

  for (int j = threadIdx.x; j < p; j += blockDim.x) s_seg[j] = -1;
  __syncthreads();

  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const size_t row = n * r + i;
    const size_t base = row * p;
    float best = 0.0f;
    int arg = 0;
    for (int j = 0; j < p; ++j) {
      float s = kBig;
      if (mask[base + j] > 0) {
        s = __fadd_rn(__fadd_rn(static_cast<float>(occ[base + j]),
                                __fmul_rn(penalty,
                                          static_cast<float>(der[base + j]))),
                      tie[base + j]);
      }
      if (j == 0 || s < best) {  // strict: first argmin, as jnp.argmin
        best = s;
        arg = j;
      }
    }
    const bool can = route[row] > 0 && best < kBig;
    const int prio = static_cast<int>(
        (static_cast<unsigned>(rnd[row]) << 23) |
        static_cast<unsigned>(lo[row]));
    port[row] = arg;
    s_prio[i] = prio;
    s_port[i] = can ? arg : -1;
    if (can) atomicMax(&s_seg[arg], prio);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const int pt = s_port[i];
    win[n * r + i] = (pt >= 0 && s_seg[pt] == s_prio[i]) ? 1 : 0;
  }
  for (int j = threadIdx.x; j < p; j += blockDim.x) seg[n * p + j] = s_seg[j];
}

}  // namespace

extern "C" int vc_prearb_launch(const int* qlen, const float* rand, int* sel,
                                int* has, int rows, int v, void* stream) {
  const int threads = 256;
  const int blocks = (rows + threads - 1) / threads;
  vc_prearb_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      qlen, rand, sel, has, rows, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int switch_arbitrate_launch(const int* occ, const int* der,
                                       const int* mask, const float* tie,
                                       const int* route, const int* rnd,
                                       const int* lo, int* port, int* win,
                                       int* seg, int n, int r, int p,
                                       float penalty, void* stream) {
  const int widest = r > p ? r : p;
  int threads = ((widest + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t shared = static_cast<size_t>(p + 2 * r) * sizeof(int);
  switch_arbitrate_kernel<<<n, threads, shared,
                            static_cast<cudaStream_t>(stream)>>>(
      occ, der, mask, tie, route, rnd, lo, port, win, seg, r, p, penalty);
  return static_cast<int>(cudaGetLastError());
}
