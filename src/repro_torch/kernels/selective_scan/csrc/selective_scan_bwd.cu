// The gradient of the Mamba-1 selective scan for Hopper (sm_90a), bound
// through ctypes.
//
// Replaces the reference's XLA-differentiated chunk scan
// (src/repro/models/ssm.py:93-115; no Pallas kernel computes it).  The
// forward, selective_scan.cu, computes
//
//   a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} + (dt_t u_t) B_t,
//   y_t = sum_n h_t[n] C_t[n]
//
// with u, dt, y [B, T, Di], A [Di, 16], B, C [B, T, 16], h0, h_T
// [B, Di, 16], all float32.  Given dy [B, T, Di] and dh_T [B, Di, 16]
// (or none), with g_t = dL/dh_t:
//
//   g_t  = dy_t C_t + a_{t+1} g_{t+1}          (g_T takes dh_T)
//   s    = sum_n g_t B_t,   q_t = (a_t g_t) h_{t-1}
//   du_t = dt_t s,   ddt_t = u_t s + sum_n A q_t
//   dA   = sum_{b,t} dt_t q_t,   dB_t = sum_d g_t (dt_t u_t),
//   dC_t = sum_d dy_t h_t,   dh0 = a_1 g_1.
//
// Exactness: the plain version is selective_scan_bwd_ref in ../ref.py,
// which runs the same operations in the same order; every product and
// sum is one float32 rounding (__fmul_rn, __fadd_rn, never an FMA) and
// exp is the accurate expf, so the rebuilt states are the forward's bit
// for bit and every output equals the plain version's.
//
// Bound: operations.  Each (b, t, channel, state) takes at least two
// expf, two MUFU ex2 (one to find the states at sub-chunk starts, one to
// rebuild them), at 16 an SM a clock: 0.2006 ms at Hymba's training
// shape [2, 4096, 3200], above its bytes' 0.158 ms (bench.py's
// scan_bwd_bound_ms).  In practice it is instruction issue: two walks of
// about 13 issue slots a state-step (the expf is 8) and the walk back's
// products and its sums over the states and the channels, about 52 in
// all, at 8 warps an SM.
//
// Design.  A block is one batch row and kChannels = 64 channels, four
// lanes a channel with K = 4 states a lane (the forward's Shape<4>: lane j
// holds states j, j + 4, j + 8, j + 12), 256 threads; a warp holds 8
// channels.
// - Inputs staged through shared memory by cp.async, as the forward does.
//   Runs of kRun = 64 steps of u, dt and dy (rows of u | dt | dy, 192
//   floats a step; 16-byte copies where Di % 4 == 0, 4-byte ones
//   otherwise) and of B and C ([64, 16], permuted so that a lane's four
//   values are contiguous) go through a ring of two slots.  The block
//   walks 2 ceil(T / 64) runs: forward for pass 1 (u, dt and B only),
//   then backward for pass 2, last run first; the ring loads run i + 1 of
//   that order while run i computes.  The step loops read shared memory
//   only.
// - Two expf walks.  Pass 1 runs the recurrence forward and writes the
//   state before every kSub = 8-th step to a float32 workspace [B,
//   ceil(T/8), Di, 16] (a lane's four states contiguous: one 16-byte
//   store).  Pass 2 takes the sub-chunks last first: it rebuilds the
//   sub-chunk's 8 states and decay factors in registers from its stored
//   start state (fetched one sub-chunk ahead) and walks back through
//   them.  A whole sub-chunk runs without a branch; the last one of T,
//   when shorter, rebuilds its 8 steps on rows past the run's end and
//   walks back its own steps only.  g and dA stay in registers; s and
//   sum_n A q go through the lanes' halving tree, as the forward's y does
//   (registers 8 and 4 states apart, then xor shuffles at 2 and 1).
// - dB and dC with two barriers a run.  At each step a warp sums its 8
//   channels' terms of dB and dC by a reduce-scatter of shuffles: at
//   channel offsets 1, 2 and 4 each lane keeps half of its values and
//   adds its partner's half, so the 8 channels are summed as a balanced
//   tree, ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7)), and each of
//   the 32 lanes ends with one of the 32 (dB or dC, state) sums, which it
//   writes to a warp tile [64][warps][32].  du and ddt overwrite the dy
//   and dt of their step in the run's slot (lane 0 of the channel, once
//   the sub-chunk is walked: every lane has read them).  Once a run has
//   been walked, the block stores du and ddt from the slot with 16-byte
//   stores (4-byte where Di % 4 != 0) and sums the warp tile over its
//   warps, left to right, into per-block partials [B, T, n_blocks, 16].
// - A second launch sums the partials over the blocks, left to right,
//   into dB and dC, and the per-row dA [B, Di, 16] over the batch rows.
// - Balance.  The ring and the warp tile take 176 KB, so an SM holds one
//   block of 8 warps, two for each of its four schedulers.  Hymba's
//   training shape [2, 4096, 3200] is 100 blocks, one wave; falcon-mamba's
//   [2, 4096, 8192] 256, two.  (At Hymba's shape 32-channel blocks, two an
//   SM, and blocks of 6 or 7 warps over all 132 SMs measured slower:
//   PERF.md.)  The width is a constant, BWD_CHANNELS in ../ref.py, since
//   it sets the order of the sums over channels.
// No float atomicAdd: a gradient has the same bits on every run.
// Channels past Di read zeros and store nothing; their terms of dB and
// dC are zeros.
//
// What is left (PERF.md): the walks issue about 50 instructions a
// state-step, 16 of them the two accurate expf's and 3.5 the
// reduce-scatter's selects, at 8 warps an SM; shared memory keeps a
// second block off it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kN = 16;                      // state size
constexpr int kK = 4;                       // states a lane
constexpr int kL = kN / kK;                 // lanes a channel
constexpr int kWarpChannels = 32 / kL;      // channels a warp
constexpr int kRun = 64;                    // steps a staged run
constexpr int kSub = 8;                     // steps between stored states
constexpr int kSubs = kRun / kSub;          // sub-chunks a run
constexpr int kChannels = 64;               // channels a block
constexpr int kThreads = kChannels * kL;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 3 * kChannels;         // floats of a step's staged row
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRun % kSub == 0, "a run is whole sub-chunks");

// floats of one ring slot: kRun rows of u | dt | dy, then B and C,
// [kRun][16] each
constexpr int kSlot = kRun * (kRow + 2 * kN);
// dynamic shared bytes of a block: two ring slots and the warp tile
// [kRun][kThreads], 180,224 (one block an SM)
constexpr int kSmemBytes = static_cast<int>(sizeof(float)) *
                           (2 * kSlot + kRun * kThreads);
static_assert(kSmemBytes <= 232448, "fits an SM's shared memory");
static_assert(kChannels % kWarpChannels == 0, "whole warps a block");

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

// 16-byte copy of `bytes` (0 or 16) from src, the rest zero filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void load4(float (&out)[kK], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// the sum over a channel's 16 states of v (this lane's K of them): the
// plain version's halving tree
__device__ __forceinline__ float state_sum(float (&v)[kK]) {
#pragma unroll
  for (int w = kK / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] = __fadd_rn(v[i], v[i + w]);
  }
  float s = v[0];
#pragma unroll
  for (int o = kL / 2; o >= 1; o /= 2)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// The warp's 8 channels' terms of dB (vb) and dC (vc), this lane's four
// states of each, summed over the channels by a reduce-scatter: at each
// level (channel offsets 1, 2, 4: lane offsets 4, 8, 16) a lane keeps
// half of its values, sends the other half to its partner and adds what
// it receives, the lower channel's lane keeping the lower half.  So the
// channels are summed as a balanced tree in their order, ((c0 + c1) +
// (c2 + c3)) + ((c4 + c5) + (c6 + c7)).  The lane whose channel bits are
// (b0, b1, b2) ends with the dB (b0 = 0) or dC (b0 = 1) sum of its state
// j + 4 (2 b1 + b2).
__device__ __forceinline__ float warp_sum(const float (&vb)[kK],
                                          const float (&vc)[kK], int lane) {
  float x[kK];
  const bool b0 = lane & kL;
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    const float keep = b0 ? vc[m] : vb[m];
    const float send = b0 ? vb[m] : vc[m];
    x[m] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, kL));
  }
#pragma unroll
  for (int n = kK / 2, off = 2 * kL; n >= 1; n /= 2, off *= 2) {
    const bool bit = lane & off;
#pragma unroll
    for (int m = 0; m < n; ++m) {
      const float keep = bit ? x[m + n] : x[m];
      const float send = bit ? x[m] : x[m + n];
      x[m] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, off));
    }
  }
  return x[0];
}

// the lane (of a warp) that warp_sum leaves holding output (kind, n),
// kind 0 for dB and 1 for dC
__device__ __forceinline__ int sum_lane(int kind, int n) {
  const int i = n / kL;
  return (kind | (i >> 1) << 1 | (i & 1) << 2) * kL + n % kL;
}

// Grid: one block per (batch row, run of kChannels channels), batch row
// major; kThreads threads.  vec: u, dt, dy, du and ddt rows are 16-byte
// aligned (Di % 4 == 0 and aligned bases), so they move in 16-byte pieces.
__global__ void __launch_bounds__(kThreads, 1)
selective_scan_bwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ bc,
                          const float* __restrict__ cc,
                          const float* __restrict__ h0,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_t, float* ws,
                          float* __restrict__ du, float* __restrict__ ddt,
                          float* __restrict__ dh0, float* __restrict__ pda,
                          float* __restrict__ pdb, float* __restrict__ pdc,
                          int steps, int di, int blocks_per_row, bool vec) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / blocks_per_row;
  const int blk = blockIdx.x % blocks_per_row;
  const int c0 = blk * kChannels;
  const int nvalid = min(kChannels, di - c0);  // channels this block stores
  const int cl = tid / kL;                     // the thread's channel column
  const int j = tid % kL;                      // its lane in the channel
  const int lane = tid % 32;
  const bool ok = cl < nvalid;
  const int c = c0 + (ok ? cl : 0);
  const size_t seq = static_cast<size_t>(b) * steps;
  const int nruns = (steps + kRun - 1) / kRun;
  const int nsc = (steps + kSub - 1) / kSub;   // sub-chunks in T
  float* const wtile = smem + 2 * kSlot;

  // this lane's first state of channel c in [B, Di, 16]
  const size_t hi = (static_cast<size_t>(b) * di + c) * kN + j;
  float an[kK], h[kK], carry[kK], acc[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    an[i] = ok ? a[static_cast<size_t>(c) * kN + j + i * kL] : 0.f;
    h[i] = ok ? h0[hi + i * kL] : 0.f;
    carry[i] = ok && dh_t != nullptr ? dh_t[hi + i * kL] : 0.f;
    acc[i] = 0.f;
  }
  // this lane's four states before sub-chunk 0 in the workspace; those of
  // sub-chunk sc lie sc * ws_step floats on
  float* const ws0 =
      ws + (static_cast<size_t>(b) * nsc * di + c) * kN + j * kK;
  const size_t ws_step = static_cast<size_t>(di) * kN;

  // run `run` into ring slot `slot`: u, dt and B, and dy and C when
  // `back`
  auto load = [&](int slot, int run, bool back) {
    float* rows = smem + slot * kSlot;
    float* sb = rows + kRun * kRow;
    float* sc = sb + kRun * kN;
    const int t0 = run * kRun;
    const int len = min(kRun, steps - t0);
    if (vec) {
      constexpr int kPieces = kChannels / 4;          // 16-byte pieces an array
      for (int i = tid; i < len * kPieces; i += kThreads) {
        const int tt = i / kPieces;
        const int q = (i % kPieces) * 4;
        const int bytes = q < nvalid ? 16 : 0;
        const size_t g = (seq + t0 + tt) * di + c0 + q;
        float* d = rows + tt * kRow + q;
        cp_async16(d, bytes ? u + g : u, bytes);
        cp_async16(d + kChannels, bytes ? dt + g : dt, bytes);
        if (back) cp_async16(d + 2 * kChannels, bytes ? dy + g : dy, bytes);
      }
    } else {
      for (int i = tid; i < len * kChannels; i += kThreads) {
        const int tt = i / kChannels;
        const int q = i % kChannels;
        const bool in = q < nvalid;
        const size_t g = (seq + t0 + tt) * di + c0 + q;
        float* d = rows + tt * kRow + q;
        cp_async4(d, in ? u + g : u, in);
        cp_async4(d + kChannels, in ? dt + g : dt, in);
        if (back) cp_async4(d + 2 * kChannels, in ? dy + g : dy, in);
      }
    }
    // B and C: state n = jj + m L goes to jj K + m, so lane jj's K values
    // are contiguous
    for (int i = tid; i < len * kN; i += kThreads) {
      const int tt = i / kN;
      const int n = i % kN;
      const int d = tt * kN + (n % kL) * kK + n / kL;
      const size_t g = (seq + t0) * kN + i;
      cp_async4(sb + d, bc + g, true);
      if (back) cp_async4(sc + d, cc + g, true);
    }
  };

  // run `run`'s du and ddt (in the dy and dt columns of its slot) and its
  // dB and dC partials (the warp tile summed over the warps, left to
  // right) to device memory
  auto flush = [&](int slot, int run) {
    const float* rows = smem + slot * kSlot;
    const int t0 = run * kRun;
    const int len = min(kRun, steps - t0);
    if (vec) {
      constexpr int kPieces = kChannels / 4;
      for (int i = tid; i < len * kPieces; i += kThreads) {
        const int tt = i / kPieces;
        const int q = (i % kPieces) * 4;
        if (q >= nvalid) continue;
        const size_t g = (seq + t0 + tt) * di + c0 + q;
        const float* s = rows + tt * kRow + q;
        *reinterpret_cast<float4*>(du + g) =
            *reinterpret_cast<const float4*>(s + 2 * kChannels);
        *reinterpret_cast<float4*>(ddt + g) =
            *reinterpret_cast<const float4*>(s + kChannels);
      }
    } else {
      for (int i = tid; i < len * kChannels; i += kThreads) {
        const int tt = i / kChannels;
        const int q = i % kChannels;
        if (q >= nvalid) continue;
        const size_t g = (seq + t0 + tt) * di + c0 + q;
        du[g] = rows[tt * kRow + 2 * kChannels + q];
        ddt[g] = rows[tt * kRow + kChannels + q];
      }
    }
    // output (tt, kind, n), kind 0 for dB and 1 for dC
    for (int o = tid; o < len * 2 * kN; o += kThreads) {
      const int tt = o / (2 * kN);
      const int kind = (o / kN) % 2;
      const int n = o % kN;
      const float* x = wtile + tt * kWarps * 32 + sum_lane(kind, n);
      float v = x[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v = __fadd_rn(v, x[w * 32]);
      (kind ? pdc : pdb)[((seq + t0 + tt) * blocks_per_row + blk) * kN + n] =
          v;
    }
  };

  // pass 2: the state before the sub-chunk to walk next
  float hn[kK];

  // pass 1 over run `run` in slot `slot`: the state before each sub-chunk
  // to the workspace, then its steps.  A sub-chunk that ends past T runs
  // its 8 steps all the same, on rows past the run's end: the state after
  // T is never used.
  auto forward_run = [&](int slot, int run) {
    const float* rows = smem + slot * kSlot + cl;
    const float* sb = smem + slot * kSlot + kRun * kRow + j * kK;
    const int len = min(kRun, steps - run * kRun);
    const int nsub = (len + kSub - 1) / kSub;
    float* w = ws0 + static_cast<size_t>(run) * kSubs * ws_step;
#pragma unroll 1
    for (int s = 0; s < nsub; ++s, w += ws_step) {
      if (ok)
        __stcg(reinterpret_cast<float4*>(w),
               make_float4(h[0], h[1], h[2], h[3]));
#pragma unroll
      for (int i = 0; i < kK; ++i) hn[i] = h[i];
      const float* r = rows + s * kSub * kRow;
      const float* bb = sb + s * kSub * kN;
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        const float dtv = r[q * kRow + kChannels];
        const float uv = r[q * kRow];
        float bv[kK];
        load4(bv, bb + q * kN);
        const float dbu = __fmul_rn(dtv, uv);
#pragma unroll
        for (int i = 0; i < kK; ++i) {
          const float da = expf(__fmul_rn(dtv, an[i]));
          h[i] = __fadd_rn(__fmul_rn(da, h[i]), __fmul_rn(dbu, bv[i]));
        }
      }
    }
  };

  // pass 2 over run `run` in slot `slot`: its sub-chunks last first
  auto backward_run = [&](int slot, int run) {
    float* rows = smem + slot * kSlot;
    const float* sb = rows + kRun * kRow + j * kK;
    const float* sc = sb + kRun * kN;
    float* wt = wtile + (tid / 32) * 32 + lane;
    const int len = min(kRun, steps - run * kRun);
    const int nsub = (len + kSub - 1) / kSub;
#pragma unroll 1
    for (int s = nsub - 1; s >= 0; --s) {
      const int g = run * kSubs + s;
      // hr[q]: the state before step ts + q; da[q]: that step's decay.  A
      // sub-chunk that ends past T rebuilds its 8 steps all the same (on
      // rows past the run's end), and walks back its own steps only.
      float hr[kSub + 1][kK], da[kSub][kK];
#pragma unroll
      for (int i = 0; i < kK; ++i) hr[0][i] = hn[i];
      if (g > 0) {
        const float4 v =
            ok ? __ldcg(reinterpret_cast<const float4*>(
                     ws0 + static_cast<size_t>(g - 1) * ws_step))
               : make_float4(0.f, 0.f, 0.f, 0.f);
        hn[0] = v.x;
        hn[1] = v.y;
        hn[2] = v.z;
        hn[3] = v.w;
      }
      const int ts = s * kSub;
      float* r = rows + ts * kRow + cl;
      const float* bb = sb + ts * kN;
      const float* cb = sc + ts * kN;
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        const float dtv = r[q * kRow + kChannels];
        const float uv = r[q * kRow];
        float bv[kK];
        load4(bv, bb + q * kN);
        const float dbu = __fmul_rn(dtv, uv);
#pragma unroll
        for (int i = 0; i < kK; ++i) {
          da[q][i] = expf(__fmul_rn(dtv, an[i]));
          hr[q + 1][i] = __fadd_rn(__fmul_rn(da[q][i], hr[q][i]),
                                   __fmul_rn(dbu, bv[i]));
        }
      }
      // step ts + q back from the carry of step ts + q + 1.  Its outputs
      // wait in registers until the sub-chunk is done, so that no store
      // to the slot comes between the steps' reads of it (the compiler
      // keeps them in order, as it cannot tell them apart).
      float vs[kSub], dus[kSub], ddts[kSub];
      auto step = [&](int q) {
        const float uv = r[q * kRow];
        const float dtv = r[q * kRow + kChannels];
        const float dyv = r[q * kRow + 2 * kChannels];
        float bv[kK], cv[kK];
        load4(bv, bb + q * kN);
        load4(cv, cb + q * kN);
        const float dbu = __fmul_rn(dtv, uv);
        float p[kK], w[kK], vb[kK], vc[kK];
#pragma unroll
        for (int i = 0; i < kK; ++i) {
          const float gv = __fadd_rn(__fmul_rn(dyv, cv[i]), carry[i]);
          p[i] = __fmul_rn(gv, bv[i]);
          carry[i] = __fmul_rn(da[q][i], gv);
          const float qv = __fmul_rn(carry[i], hr[q][i]);
          acc[i] = __fadd_rn(acc[i], __fmul_rn(dtv, qv));
          w[i] = __fmul_rn(an[i], qv);
          vb[i] = __fmul_rn(gv, dbu);
          vc[i] = __fmul_rn(dyv, hr[q + 1][i]);
        }
        const float sv = state_sum(p);
        const float rv = state_sum(w);
        vs[q] = warp_sum(vb, vc, lane);
        dus[q] = __fmul_rn(dtv, sv);
        ddts[q] = __fadd_rn(__fmul_rn(uv, sv), rv);
      };
      // lane 0 of a channel writes du and ddt over the step's dy and dt,
      // which every lane of the channel has read before the step's
      // shuffles
      auto store = [&](int q) {
        wt[(ts + q) * kThreads] = vs[q];
        if (j == 0) {
          r[q * kRow + 2 * kChannels] = dus[q];
          r[q * kRow + kChannels] = ddts[q];
        }
      };
      const int slen = min(kSub, len - ts);
      if (slen == kSub) {
#pragma unroll
        for (int q = kSub - 1; q >= 0; --q) step(q);
#pragma unroll
        for (int q = 0; q < kSub; ++q) store(q);
      } else {
        // the last sub-chunk of T, shorter than kSub
#pragma unroll
        for (int q = kSub - 1; q >= 0; --q) {
          if (q < slen) step(q);
        }
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          if (q < slen) store(q);
        }
      }
    }
  };

  // the ring walks pass 1's runs forward, then pass 2's backward
  const int items = 2 * nruns;
  load(0, 0, false);
  cp_async_commit();
  for (int it = 0; it < items; ++it) {
    const bool back = it >= nruns;
    const int run = back ? items - 1 - it : it;
    const int slot = it & 1;
    cp_async_wait_all();
    // item it is in its slot; every thread is done with item it - 1
    __syncthreads();
    if (it > nruns) {
      // item it - 1 walked run + 1 back: store its outputs, then free its
      // slot and the warp tile
      flush(slot ^ 1, run + 1);
      __syncthreads();
    }
    if (it + 1 < items) {
      const bool nback = it + 1 >= nruns;
      load(slot ^ 1, nback ? items - 2 - it : it + 1, nback);
    }
    cp_async_commit();
    if (back)
      backward_run(slot, run);
    else
      forward_run(slot, run);
  }
  __syncthreads();
  flush((items - 1) & 1, 0);
  if (ok) {
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      pda[hi + i * kL] = acc[i];
      dh0[hi + i * kL] = carry[i];    // a_1 g_1: the carry past step 0
    }
  }
}

// dB, dC [B, T, 16]: the partials [B, T, n_blocks, 16] summed over the
// blocks left to right; dA [Di, 16]: the rows of [B, Di, 16] summed over
// the batch rows in order.  One thread an output, the dB/dC outputs
// first.
__global__ void selective_scan_bwd_sum_kernel(
    const float* __restrict__ pda, const float* __restrict__ pdb,
    const float* __restrict__ pdc, float* __restrict__ da,
    float* __restrict__ db, float* __restrict__ dc, int batch, int steps,
    int di, int blocks_per_row) {
  const size_t n_bt = static_cast<size_t>(batch) * steps * kN;
  const size_t n_a = static_cast<size_t>(di) * kN;
  const size_t i =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_bt) {
    const size_t row = i / kN, n = i % kN;
    const size_t base = row * blocks_per_row * kN + n;
    float vb = pdb[base], vc = pdc[base];
    for (int k = 1; k < blocks_per_row; ++k) {
      vb = __fadd_rn(vb, pdb[base + static_cast<size_t>(k) * kN]);
      vc = __fadd_rn(vc, pdc[base + static_cast<size_t>(k) * kN]);
    }
    db[i] = vb;
    dc[i] = vc;
  } else if (i < n_bt + n_a) {
    const size_t e = i - n_bt;
    float v = pda[e];
    for (int r = 1; r < batch; ++r)
      v = __fadd_rn(v, pda[static_cast<size_t>(r) * n_a + e]);
    da[e] = v;
  }
}

unsigned blocks_for(size_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// (du, ddt, dA, dB, dC, dh0) of the scan at (u, dt, A, B, C, h0) for the
// cotangents dy and dh_t (null: zeros), on `stream`, with float32
// scratch: ws [b, ceil(steps/8), di, 16], pdb and pdc [b, steps,
// ceil(di/64), 16], pda [b, di, 16].  Two launches: the scan
// backward, then the sums over blocks and batch rows.  Returns
// cudaGetLastError() after them.  steps must be at least 1.
int selective_scan_bwd_launch(const float* u, const float* dt,
                              const float* a, const float* bc,
                              const float* cc, const float* h0,
                              const float* dy, const float* dh_t, float* du,
                              float* ddt, float* da, float* db, float* dc,
                              float* dh0, float* ws, float* pdb, float* pdc,
                              float* pda, int b, int steps, int di,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || di <= 0 || steps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (di + kChannels - 1) / kChannels;
  const bool vec = di % 4 == 0 && aligned16(u) && aligned16(dt) &&
                   aligned16(dy) && aligned16(du) && aligned16(ddt);
  selective_scan_bwd_kernel<<<b * nblk, kThreads, kSmemBytes, s>>>(
      u, dt, a, bc, cc, h0, dy, dh_t, ws, du, ddt, dh0, pda, pdb, pdc, steps,
      di, nblk, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(b) * steps * kN +
                   static_cast<size_t>(di) * kN;
  selective_scan_bwd_sum_kernel<<<blocks_for(n, 256), 256, 0, s>>>(
      pda, pdb, pdc, da, db, dc, b, steps, di, nblk);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan of the scan backward at (b, di), as 8 ints: channels
// and threads a block, dynamic shared bytes, resident blocks an SM
// (occupancy API), grid, SMs, registers a thread, local (spilled) bytes a
// thread.  Returns a CUDA error code.
int selective_scan_bwd_plan(int b, int di, int* out) {
  if (b <= 0 || di <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(selective_scan_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, selective_scan_bwd_kernel, kThreads, kSmemBytes);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, selective_scan_bwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[8] = {kChannels,
                    kThreads,
                    kSmemBytes,
                    per_sm,
                    b * ((di + kChannels - 1) / kChannels),
                    sms,
                    attr.numRegs,
                    static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
