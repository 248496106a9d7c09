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
// expf, two MUFU ex2 (one to find the states at chunk starts, one to
// rebuild them), at 16 an SM a clock: 0.2006 ms at Hymba's training shape
// [2, 4096, 3200], above its bytes' 0.158 ms (bench.py's
// scan_bwd_bound_ms).  This first form does not come near it: it is held
// back by latency, with 200 blocks of 4 warps at that shape (2 blocks an
// SM by its registers) walking T three times, each step waiting on its
// loads and on the recurrence (PERF.md).
//
// Design (a simple kernel; the forward's staging and planning are not
// carried over).  A block is one batch row and kChannels = 32 channels,
// four lanes a channel with K = 4 states a lane (the forward's Shape<4>:
// lane j holds states j, j + 4, j + 8, j + 12), 128 threads.  (Two
// states a lane, eight lanes a channel, measured slower.)
// - Pass 1 runs the recurrence forward and writes the state before every
//   kChunk = 64-th step to a float32 workspace [B, ceil(T/64), Di, 16].
// - Pass 2 takes the chunks last first.  It runs the chunk forward again
//   from its stored state, keeping the state before every kSub = 8-th
//   step in shared memory, then takes those sub-chunks last first: it
//   rebuilds the sub-chunk's 8 states and decay factors in registers
//   (the loops are unrolled, so they index registers) and walks back
//   through them.  g and dA stay in registers; s and sum_n A q go through
//   the lanes' halving tree, as the forward's y does (registers 8 and 4
//   states apart, then xor shuffles at 2 and 1); du and ddt leave from
//   lane 0.  Each lane writes its terms of dB and dC to shared memory;
//   after the sub-chunk the block sums them over its 32 channels, left
//   to right, into per-block partials [B, T, n_blocks, 16].
// - A second launch sums the partials over the blocks, left to right,
//   into dB and dC, and the per-row dA [B, Di, 16] over the batch rows.
// No float atomicAdd: a gradient has the same bits on every run.
// Channels past Di read zeros and store nothing; their terms of dB and
// dC are zeros.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kN = 16;                     // state size
constexpr int kK = 4;                      // states a lane
constexpr int kL = kN / kK;                // lanes a channel
constexpr int kChunk = 64;                 // steps between stored states
constexpr int kSub = 8;                    // steps rebuilt in registers
constexpr int kSubs = kChunk / kSub;       // sub-chunks a chunk
constexpr int kChannels = 32;              // channels a block
constexpr int kThreads = kChannels * kL;   // 128
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunk % kSub == 0, "a chunk is whole sub-chunks");
static_assert(kSub * kN == kThreads, "one thread a (step, state) to sum");

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

// Grid: one block per (batch row, run of kChannels channels), batch row
// major; kThreads threads.
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ bc,
                          const float* __restrict__ cc,
                          const float* __restrict__ h0,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_t,
                          float* __restrict__ ws, float* __restrict__ du,
                          float* __restrict__ ddt, float* __restrict__ dh0,
                          float* __restrict__ pda, float* __restrict__ pdb,
                          float* __restrict__ pdc, int steps, int di,
                          int blocks_per_row) {
  // the state before each sub-chunk of the chunk at hand, [kSubs][kK]
  // [kThreads]; each lane's terms of dB and dC, [kSub][kChannels][kN]
  __shared__ float ssub[kSubs * kK * kThreads];
  __shared__ float sdb[kSub * kChannels * kN];
  __shared__ float sdc[kSub * kChannels * kN];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / blocks_per_row;
  const int blk = blockIdx.x % blocks_per_row;
  const int cl = tid / kL;                  // the thread's channel column
  const int j = tid % kL;                   // its lane in the channel
  const int c = blk * kChannels + cl;
  const bool ok = c < di;
  const size_t seq = static_cast<size_t>(b) * steps;
  const int nchunks = (steps + kChunk - 1) / kChunk;
  // this lane's first state of channel c in [B, Di, 16]
  const size_t hi = (static_cast<size_t>(b) * di + c) * kN + j;

  float an[kK], h[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    an[i] = ok ? a[static_cast<size_t>(c) * kN + j + i * kL] : 0.f;
    h[i] = ok ? h0[hi + i * kL] : 0.f;
  }
  auto ws_at = [&](int chunk) {
    return ws + ((static_cast<size_t>(b) * nchunks + chunk) * di + c) * kN +
           j;
  };
  // step t's dt, u (zeros past Di) and this lane's B values
  auto load = [&](int t, float& dtv, float& uv, float (&bv)[kK]) {
    const size_t g = (seq + t) * di + c;
    dtv = ok ? __ldg(dt + g) : 0.f;
    uv = ok ? __ldg(u + g) : 0.f;
#pragma unroll
    for (int i = 0; i < kK; ++i)
      bv[i] = __ldg(bc + (seq + t) * kN + j + i * kL);
  };
  // one step of the forward's recurrence
  auto advance = [&](int t, float (&hv)[kK]) {
    float dtv, uv, bv[kK];
    load(t, dtv, uv, bv);
    const float dbu = __fmul_rn(dtv, uv);
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const float da = expf(__fmul_rn(dtv, an[i]));
      hv[i] = __fadd_rn(__fmul_rn(da, hv[i]), __fmul_rn(dbu, bv[i]));
    }
  };

  // pass 1: the state before every chunk (the last chunk's steps are not
  // needed)
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (ok) {
      float* w = ws_at(chunk);
#pragma unroll
      for (int i = 0; i < kK; ++i) w[i * kL] = h[i];
    }
    if (chunk + 1 == nchunks) break;
#pragma unroll 8
    for (int q = 0; q < kChunk; ++q) advance(chunk * kChunk + q, h);
  }

  // pass 2
  float carry[kK], acc[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    carry[i] = ok && dh_t != nullptr ? dh_t[hi + i * kL] : 0.f;
    acc[i] = 0.f;
  }
  for (int chunk = nchunks - 1; chunk >= 0; --chunk) {
    const int t0 = chunk * kChunk;
    const int len = min(kChunk, steps - t0);
    const int nsub = (len + kSub - 1) / kSub;
    {
      const float* w = ws_at(chunk);
#pragma unroll
      for (int i = 0; i < kK; ++i) h[i] = ok ? w[i * kL] : 0.f;
    }
    for (int s = 0; s < nsub; ++s) {
#pragma unroll
      for (int i = 0; i < kK; ++i)
        ssub[(s * kK + i) * kThreads + tid] = h[i];
      if (s + 1 == nsub) break;
#pragma unroll
      for (int q = 0; q < kSub; ++q) advance(t0 + s * kSub + q, h);
    }
    for (int s = nsub - 1; s >= 0; --s) {
      const int ts = t0 + s * kSub;
      const int slen = min(kSub, steps - ts);
      // hr[q]: the state before step ts + q; da[q]: that step's decay
      float hr[kSub + 1][kK], da[kSub][kK];
#pragma unroll
      for (int i = 0; i < kK; ++i)
        hr[0][i] = ssub[(s * kK + i) * kThreads + tid];
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        if (q < slen) {
          float dtv, uv, bv[kK];
          load(ts + q, dtv, uv, bv);
          const float dbu = __fmul_rn(dtv, uv);
#pragma unroll
          for (int i = 0; i < kK; ++i) {
            da[q][i] = expf(__fmul_rn(dtv, an[i]));
            hr[q + 1][i] = __fadd_rn(__fmul_rn(da[q][i], hr[q][i]),
                                     __fmul_rn(dbu, bv[i]));
          }
        }
      }
#pragma unroll
      for (int q = kSub - 1; q >= 0; --q) {
        if (q < slen) {
          const int t = ts + q;
          const size_t gi = (seq + t) * di + c;
          float dtv, uv, bv[kK], cv[kK];
          load(t, dtv, uv, bv);
          const float dyv = ok ? __ldg(dy + gi) : 0.f;
#pragma unroll
          for (int i = 0; i < kK; ++i)
            cv[i] = __ldg(cc + (seq + t) * kN + j + i * kL);
          const float dbu = __fmul_rn(dtv, uv);
          float p[kK], w[kK];
          float* sb = sdb + (q * kChannels + cl) * kN + j;
          float* sc = sdc + (q * kChannels + cl) * kN + j;
#pragma unroll
          for (int i = 0; i < kK; ++i) {
            const float g = __fadd_rn(__fmul_rn(dyv, cv[i]), carry[i]);
            p[i] = __fmul_rn(g, bv[i]);
            carry[i] = __fmul_rn(da[q][i], g);
            const float qv = __fmul_rn(carry[i], hr[q][i]);
            acc[i] = __fadd_rn(acc[i], __fmul_rn(dtv, qv));
            w[i] = __fmul_rn(an[i], qv);
            sb[i * kL] = __fmul_rn(g, dbu);
            sc[i * kL] = __fmul_rn(dyv, hr[q + 1][i]);
          }
          const float sv = state_sum(p);
          const float rv = state_sum(w);
          if (ok && j == 0) {
            du[gi] = __fmul_rn(dtv, sv);
            ddt[gi] = __fadd_rn(__fmul_rn(uv, sv), rv);
          }
        }
      }
      __syncthreads();
      // thread (q, n) sums step ts + q's terms of state n over the
      // block's channels, left to right
      {
        const int q = tid / kN;
        const int n = tid % kN;
        if (q < slen) {
          const float* xb = sdb + q * kChannels * kN + n;
          const float* xc = sdc + q * kChannels * kN + n;
          float vb = xb[0], vc = xc[0];
#pragma unroll
          for (int k = 1; k < kChannels; ++k) {
            vb = __fadd_rn(vb, xb[k * kN]);
            vc = __fadd_rn(vc, xc[k * kN]);
          }
          const size_t o =
              ((seq + ts + q) * blocks_per_row + blk) * kN + n;
          pdb[o] = vb;
          pdc[o] = vc;
        }
      }
      __syncthreads();
    }
  }
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

}  // namespace

extern "C" {

// (du, ddt, dA, dB, dC, dh0) of the scan at (u, dt, A, B, C, h0) for the
// cotangents dy and dh_t (null: zeros), on `stream`, with float32
// scratch: ws [b, ceil(steps/64), di, 16], pdb and pdc [b, steps,
// ceil(di/32), 16], pda [b, di, 16].  Two launches: the
// scan backward, then the sums over blocks and batch rows.  Returns
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
  const int nblk = (di + kChannels - 1) / kChannels;
  selective_scan_bwd_kernel<<<b * nblk, kThreads, 0, s>>>(
      u, dt, a, bc, cc, h0, dy, dh_t, ws, du, ddt, dh0, pda, pdb, pdc, steps,
      di, nblk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(b) * steps * kN +
                   static_cast<size_t>(di) * kN;
  selective_scan_bwd_sum_kernel<<<blocks_for(n, 256), 256, 0, s>>>(
      pda, pdb, pdc, da, db, dc, b, steps, di, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
