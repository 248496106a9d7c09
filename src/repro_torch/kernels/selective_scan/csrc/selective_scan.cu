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
// PyTorch's exp also runs on the card, every state's recurrence runs in t
// order, and y_t is the halving tree of the plain version in ../ref.py
// (s1[n] = v[n] + v[n+8], then offsets 4, 2, 1).  So the kernel equals the
// plain version bit for bit.
//
// Bound: operations.  Each (b, t, channel, state) takes one expf, one MUFU
// ex2, and the card issues 16 of those per SM per clock: 0.2006 ms at the
// serving slice [4, 4096, 3200, 16], above the 0.189 ms that its bytes
// take (bench.py's scan_bound_ms).  What holds the kernel back in practice
// is instruction issue and its stalls: an accurate expf is 8 instructions,
// and the recurrence and the product with C add 5 more per state, so a
// state-step costs at least 13 issue slots (0.33 ms at the serving slice).
//
// Design: channels and states are independent, time is not.
// - Several states a thread.  A channel's 16 states are spread over
//   L = 16 / K lanes; lane j holds states j, j + L, ..., j + (K-1) L.  The
//   tree's levels with offsets 8, 4, ... down to L pair two registers of
//   one lane; the levels below L are __shfl_xor_sync at L/2, ..., 1 (a lane
//   whose partner is the lower state adds in the other order, which IEEE
//   addition's commutativity makes the same bits).  K = 4 (the main path):
//   two shuffles a thread-step where one state a thread took four, and
//   four independent recurrences in each thread.  K = 2 and 8 are built
//   too; bench.py holds and times all three.
// - Inputs staged through shared memory by cp.async.  A block is one batch
//   row and C channels.  Runs of kSteps = 64 steps of u and dt ([64, C]
//   tiles in rows of kCols floats, 16-byte copies where Di % 4 == 0,
//   4-byte ones otherwise) and of B and C ([64, 16], loaded once per block
//   and permuted so that a lane's K values are contiguous) go through a
//   ring of two slots: run c + 1 loads while run c computes.  The step
//   loop reads shared memory only: u and dt as a broadcast to the
//   channel's lanes, B and C as one vector load each.  The fixed row
//   stride makes every address in the unrolled run an immediate offset,
//   and each step's inputs are read one step ahead, so the loads do not
//   queue behind the previous y store.
// - y leaves in full sectors.  Lane 0 of each channel writes y_t into a
//   [kSteps, C] tile (two of them, alternating); after the next barrier the
//   block stores the tile with 16-byte writes (4-byte where Di % 4 != 0).
// - Balance.  The launcher picks C (a multiple of 4, at most kCols) so
//   that the busiest SM holds the fewest warps, by the occupancy API: at
//   the serving slice with K = 4, 31 blocks a batch row of 104 channels,
//   124 blocks of 13 warps, one an SM, against the 12.12 warps an SM of a
//   perfect split.
// Channels past Di, and a block's lanes past its C channels, run on zeros
// and store nothing; the last run of steps stops at T.
//
// What is left: K = 2, 4 and 8 take about the same time, so more warps do
// not help, and neither a cheaper exp nor removing the global traffic
// alone closes the gap to the issue bound (PERF.md): the time is spread
// over issue, the MUFU and shared-memory pipes and their stalls at 12 to
// 13 warps an SM.  A warp-specialised form (one warp staging u and
// dt with bulk copies, the others computing) or fewer shared-memory reads
// a step are next.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kN = 16;          // state size
constexpr int kSteps = 64;      // steps a staged run holds (T_c)
constexpr int kStages = 2;      // slots of the cp.async ring
constexpr int kCols = 128;      // channel columns of a tile row (its stride)
constexpr int kDefaultK = 4;    // states a thread on the main path
constexpr unsigned kFull = 0xffffffffu;

// floats of one ring slot (u, dt, B, C) and of one y tile; the block's
// dynamic shared memory: the ring and two y tiles, 212,992 bytes
constexpr int kSlot = kSteps * (2 * kCols + 2 * kN);
constexpr int kYTile = kSteps * kCols;
constexpr int kSmemBytes = sizeof(float) * (kStages * kSlot + 2 * kYTile);

template <int K>
struct Shape {
  static constexpr int kLanes = kN / K;  // lanes a channel
  // a block's channels fill at most the kCols columns of a tile
  static constexpr int kMaxThreads = kCols * kLanes;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte copy; zero fill when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16-byte copy of `bytes` (0 to 16) from src, the rest zero filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

template <int K>
__device__ __forceinline__ void load_vec(float (&out)[K], const float* p) {
  if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      out[q] = v.x;
      out[q + 1] = v.y;
      out[q + 2] = v.z;
      out[q + 3] = v.w;
    }
  }
}

// one step's inputs for one thread
template <int K>
struct Inputs {
  float dt, u, b[K], c[K];
};

// Grid: one block per (batch row, run of `channels` channels), batch row
// major.  blockDim.x: the block's channel columns times L, a multiple of
// 32.  vec: u, dt and y rows are 16-byte aligned (Di % 4 == 0, channels
// % 4 == 0 and aligned bases), so they move in 16-byte pieces.
template <int K>
__global__ void __launch_bounds__(Shape<K>::kMaxThreads)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ bc,
                      const float* __restrict__ cc,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_t, int steps, int di,
                      int channels, int blocks_per_row, bool vec) {
  constexpr int L = Shape<K>::kLanes;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int cols = nthreads / L;               // tile columns the block fills
  const int b = blockIdx.x / blocks_per_row;
  const int c0 = (blockIdx.x % blocks_per_row) * channels;
  const int nvalid = min(channels, di - c0);   // channels this block stores
  const int cl = tid / L;                      // the thread's channel column
  const int j = tid % L;                       // its lane in the channel
  const bool ok = cl < nvalid;
  const int c = c0 + (ok ? cl : 0);
  const size_t seq = static_cast<size_t>(b) * steps;

  float an[K], h[K];
  const size_t hi = (static_cast<size_t>(b) * di + c) * kN + j;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    an[i] = ok ? a[static_cast<size_t>(c) * kN + j + i * L] : 0.f;
    h[i] = ok ? h0[hi + i * L] : 0.f;
  }

  float* const ytile = smem + kStages * kSlot;
  const int nchunks = (steps + kSteps - 1) / kSteps;

  // run `chunk` of kSteps steps into ring slot `slot`
  auto load = [&](int slot, int chunk) {
    float* su = smem + slot * kSlot;
    float* sdt = su + kSteps * kCols;
    float* sb = sdt + kSteps * kCols;
    float* sc = sb + kSteps * kN;
    const int t0 = chunk * kSteps;
    const int len = min(kSteps, steps - t0);
    if (vec) {
      // 16-byte pieces, kCols / 4 a row (a shift, not a division), those
      // past the block's columns skipped
      for (int i = tid; i < len * (kCols / 4); i += nthreads) {
        const int tt = i / (kCols / 4);
        const int q = (i % (kCols / 4)) * 4;
        if (q >= cols) continue;
        const int bytes = 4 * max(0, min(4, nvalid - q));
        const size_t g = (seq + t0 + tt) * di + c0 + q;
        cp_async16(su + tt * kCols + q, bytes ? u + g : u, bytes);
        cp_async16(sdt + tt * kCols + q, bytes ? dt + g : dt, bytes);
      }
    } else {
      for (int i = tid; i < len * cols; i += nthreads) {
        const int tt = i / cols;
        const int q = i - tt * cols;
        const bool in = q < nvalid;
        const size_t g = (seq + t0 + tt) * di + c0 + q;
        cp_async4(su + tt * kCols + q, in ? u + g : u, in);
        cp_async4(sdt + tt * kCols + q, in ? dt + g : dt, in);
      }
    }
    // B and C: state n = jj + m L goes to jj K + m, so lane jj's K values
    // are contiguous
    for (int i = tid; i < len * kN; i += nthreads) {
      const int tt = i / kN;
      const int n = i - tt * kN;
      const int d = tt * kN + (n % L) * K + n / L;
      const size_t g = (seq + t0) * kN + i;
      cp_async4(sb + d, bc + g, true);
      cp_async4(sc + d, cc + g, true);
    }
  };

  // the y tile of `chunk` to global memory
  auto store = [&](int chunk) {
    const float* sy = ytile + (chunk & 1) * kYTile;
    const int t0 = chunk * kSteps;
    const int len = min(kSteps, steps - t0);
    if (vec) {
      for (int i = tid; i < len * (kCols / 4); i += nthreads) {
        const int tt = i / (kCols / 4);
        const int q = (i % (kCols / 4)) * 4;
        if (q < nvalid)
          *reinterpret_cast<float4*>(y + (seq + t0 + tt) * di + c0 + q) =
              *reinterpret_cast<const float4*>(sy + tt * kCols + q);
      }
    } else {
      for (int i = tid; i < len * cols; i += nthreads) {
        const int tt = i / cols;
        const int q = i - tt * cols;
        if (q < nvalid) y[(seq + t0 + tt) * di + c0 + q] = sy[tt * kCols + q];
      }
    }
  };

  // the steps of `chunk` from ring slot `slot`
  auto compute = [&](int slot, int chunk) {
    const float* su = smem + slot * kSlot + cl;
    const float* sdt = su + kSteps * kCols;
    const float* sb = smem + slot * kSlot + 2 * kSteps * kCols + j * K;
    const float* sc = sb + kSteps * kN;
    float* sy = ytile + (chunk & 1) * kYTile + cl;
    // row tt of the slot; row kSteps lies inside the shared memory (the
    // next slot or a y tile) and is read but not used
    auto fetch = [&](int tt, Inputs<K>& x) {
      x.dt = sdt[tt * kCols];
      x.u = su[tt * kCols];
      load_vec<K>(x.b, sb + tt * kN);
      load_vec<K>(x.c, sc + tt * kN);
    };
    auto step = [&](int tt, const Inputs<K>& x) {
      float v[K];
      const float dbu = __fmul_rn(x.dt, x.u);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float da = expf(__fmul_rn(x.dt, an[i]));
        h[i] = __fadd_rn(__fmul_rn(da, h[i]), __fmul_rn(dbu, x.b[i]));
        v[i] = __fmul_rn(h[i], x.c[i]);
      }
      // tree levels with offsets 8 .. L: registers w apart
#pragma unroll
      for (int w = K / 2; w >= 1; w /= 2) {
#pragma unroll
        for (int i = 0; i < w; ++i) v[i] = __fadd_rn(v[i], v[i + w]);
      }
      // offsets L/2 .. 1: lanes
      float yv = v[0];
#pragma unroll
      for (int s = L / 2; s >= 1; s /= 2)
        yv = __fadd_rn(yv, __shfl_xor_sync(kFull, yv, s));
      if (j == 0) sy[tt * kCols] = yv;
    };
    // each step's inputs are read one step ahead, before the previous
    // step's y store, which the compiler keeps them behind otherwise
    Inputs<K> cur, next;
    fetch(0, cur);
    const int len = min(kSteps, steps - chunk * kSteps);
    if (len == kSteps) {
#pragma unroll
      for (int tt = 0; tt < kSteps; ++tt) {
        fetch(tt + 1, next);
        step(tt, cur);
        cur = next;
      }
    } else {
#pragma unroll 1
      for (int tt = 0; tt < len; ++tt) {
        fetch(tt + 1, next);
        step(tt, cur);
        cur = next;
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    cp_async_wait<kStages - 2>();
    // run `chunk` is in shared memory; every thread is done with run
    // chunk - 1, so its slot and the other y tile are free
    __syncthreads();
    const int next = chunk + kStages - 1;
    if (next < nchunks) load(next % kStages, next);
    cp_async_commit();
    if (chunk > 0) store(chunk - 1);
    compute(chunk % kStages, chunk);
  }
  __syncthreads();
  if (nchunks > 0) store(nchunks - 1);

  if (ok) {
#pragma unroll
    for (int i = 0; i < K; ++i) h_t[hi + i * L] = h[i];
  }
}

// ---------------------------------------------------------------------- //
// Launch plans: the channels a block takes, by the occupancy API.

struct Plan {
  int k, channels, threads, smem, blocks_per_sm, grid, sms, steps_per_run;
};

std::mutex plan_mutex;
std::map<std::tuple<int, int, int, int, int>, Plan> plans;

template <int K>
int plan_for(int b, int di, int channels, Plan* out) {
  constexpr int L = Shape<K>::kLanes;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto key = std::make_tuple(dev, K, b, di, channels);
  std::lock_guard<std::mutex> lock(plan_mutex);
  const auto found = plans.find(key);
  if (found != plans.end()) {
    *out = found->second;
    return 0;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(selective_scan_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the warps the busiest SM holds over the whole launch, C channels a
  // block (ties: the larger C, which loads B and C fewer times)
  Plan best{};
  long best_cost = -1;
  const int lo = channels > 0 ? channels : 4;
  const int hi = channels > 0 ? channels : kCols;
  for (int ch = lo; ch <= hi; ch += 4) {
    const int threads = (ch * L + 31) / 32 * 32;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, selective_scan_kernel<K>, threads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm <= 0) continue;
    const long grid = static_cast<long>(b) * ((di + ch - 1) / ch);
    const long slots = static_cast<long>(sms) * per_sm;
    const long blocks = grid <= slots ? (grid + sms - 1) / sms
                                      : (grid + slots - 1) / slots * per_sm;
    const long cost = blocks * (threads / 32);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = Plan{K,   ch,  threads, kSmemBytes, per_sm, static_cast<int>(grid),
                  sms, kSteps};
    }
  }
  if (best_cost < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  plans[key] = best;
  *out = best;
  return 0;
}

int plan_any(int k, int b, int di, int channels, Plan* out) {
  switch (k == 0 ? kDefaultK : k) {
    case 2:
      return plan_for<2>(b, di, channels, out);
    case 4:
      return plan_for<4>(b, di, channels, out);
    case 8:
      return plan_for<8>(b, di, channels, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int K>
int launch(const float* u, const float* dt, const float* a, const float* bc,
           const float* cc, const float* h0, float* y, float* h_t, int b,
           int steps, int di, int channels, cudaStream_t stream) {
  Plan p;
  const int err = plan_for<K>(b, di, channels, &p);
  if (err) return err;
  const bool vec = di % 4 == 0 && p.channels % 4 == 0 && aligned16(u) &&
                   aligned16(dt) && aligned16(y);
  selective_scan_kernel<K><<<p.grid, p.threads, p.smem, stream>>>(
      u, dt, a, bc, cc, h0, y, h_t, steps, di, p.channels,
      (di + p.channels - 1) / p.channels, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_any(const float* u, const float* dt, const float* a,
               const float* bc, const float* cc, const float* h0, float* y,
               float* h_t, int b, int steps, int di, int k, int channels,
               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (k == 0 ? kDefaultK : k) {
    case 2:
      return launch<2>(u, dt, a, bc, cc, h0, y, h_t, b, steps, di, channels,
                       s);
    case 4:
      return launch<4>(u, dt, a, bc, cc, h0, y, h_t, b, steps, di, channels,
                       s);
    case 8:
      return launch<8>(u, dt, a, bc, cc, h0, y, h_t, b, steps, di, channels,
                       s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// (y, h_T) = scan(u, dt, A, B, C, h0) on `stream` with the main path's
// states a thread and the planned block; returns cudaGetLastError() of the
// launch.
int selective_scan_launch(const float* u, const float* dt, const float* a,
                          const float* bc, const float* cc, const float* h0,
                          float* y, float* h_t, int b, int steps, int di,
                          void* stream) {
  return launch_any(u, dt, a, bc, cc, h0, y, h_t, b, steps, di, 0, 0,
                    stream);
}

// The same with k states a thread (2, 4 or 8; 0: the main path's) and
// `channels` channels a block (a multiple of 4; 0: planned).
int selective_scan_launch_variant(const float* u, const float* dt,
                                  const float* a, const float* bc,
                                  const float* cc, const float* h0, float* y,
                                  float* h_t, int b, int steps, int di, int k,
                                  int channels, void* stream) {
  return launch_any(u, dt, a, bc, cc, h0, y, h_t, b, steps, di, k, channels,
                    stream);
}

// The launch plan of (k, b, di, channels) as 8 ints: k, channels a block,
// threads a block, dynamic shared bytes, resident blocks an SM (occupancy
// API), grid, SMs, steps a staged run.  Returns a CUDA error code.
int selective_scan_plan(int k, int b, int di, int channels, int* out) {
  Plan p;
  const int err = plan_any(k, b, di, channels, &p);
  if (err) return err;
  const int v[8] = {p.k,   p.channels, p.threads, p.smem, p.blocks_per_sm,
                    p.grid, p.sms,      p.steps_per_run};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
