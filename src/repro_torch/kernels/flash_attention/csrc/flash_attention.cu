// Causal flash attention forward (GQA, sliding window) for Hopper
// (sm_90a), bound through ctypes.
//
// Replaces the Pallas kernel flash_attention in
// src/repro/kernels/flash_attention/kernel.py:73 (pallas_call at :89), and
// adds the sliding window that the reference's attention_core and
// attention_ref take; causal only, as the model calls it:
//
//   q [B, Sq, H, D], k, v [B, Skv, Hkv, D] bf16 -> o [B, Sq, H, D] bf16,
//   query head h reads key head h / (H / Hkv), query i sits at position
//   i + Skv - Sq (Sq <= Skv), and key j is live when j <= qpos and, with
//   a window, j > qpos - (window + 1).
//
// Arithmetic, as in the Pallas kernel and the plain version in ../ref.py:
// s = (q . k) * scale in float32 (bf16 products are exact), masked entries
// set to NEG = -1e30, a running max m and sum l per row in float32,
// p = exp(s - m_new) rounded to bf16 before p . v, acc rescaled by
// alpha = exp(m - m_new), and o = acc / max(l, 1e-30).  Sums run in
// another order than in the plain version, so a few outputs differ from
// it by one bf16 rounding.
//
// Bound: operations.  A live (query, key) pair costs 4 D operations (q.k
// and p.v); at the serving slice's shapes (B 4, S 4,096, H 25, Hkv 5,
// D 64) that is 2.1e11 operations per causal layer against 126 MB of
// q, k, v and o, far above the card's bf16 operations-per-byte balance.
// The bound is the tensor cores' bf16 rate.
//
// Design: a simple kernel that is right first; this one uses no tensor
// cores.  One block of 256 threads owns a tile of 64 queries of one
// (batch, head) and walks the key tiles of 64 that its queries can see:
// tiles wholly above the diagonal or wholly left of the window are
// skipped, and tiles are taken from the right end of the sequence first
// (the heaviest query tiles start first).  Q (once) and each K tile are
// staged in shared memory transposed, [d][row], so that a thread reads
// four rows with one float4; each thread computes a 4 x 4 block of S
// (rows 4 ty.., columns 4 tx..) with scalar FMAs.  The 16 threads that
// share a row are one half-warp, so row max and row sum are shuffles and
// the bf16-rounded P tile goes through shared memory with only a warp
// barrier before p . v, where each thread accumulates 4 rows x D/16
// columns in registers.  Loads past the ragged edges read zero and are
// masked.  Row ownership is fixed for the whole loop, so a row whose
// first tile is wholly masked (possible with a window) takes
// exp(NEG - NEG) = 1 there, as the Pallas kernel does, and the next
// tile's alpha = exp(NEG - m) = 0 clears it.
//
// Later work: wgmma on bf16 tiles from shared memory, TMA loads of K and
// V, and a K/V ring that overlaps the loads with the math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;                 // queries per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kThreads = 256;
constexpr int kRow = 68;                // row stride of the [d][row] tiles
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBQ == kBK, "load_transposed stages 64-row tiles of Q and K");

template <int D>
struct Smem {
  static constexpr int kQ = D * kRow;   // q^T [D][kRow]
  static constexpr int kK = D * kRow;   // k^T [D][kRow]
  static constexpr int kV = kBK * D;    // v   [kBK][D]
  static constexpr int kP = kBK * kRow; // p^T [kBK][kRow]
  static constexpr size_t kBytes =
      sizeof(float) * static_cast<size_t>(kQ + kK + kV + kP);
};

__device__ __forceinline__ float bf(const __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows [r0, r0 + 64) of one head's rows x (D bf16 each, `row_stride`
// apart), transposed into dst[d * kRow + r]; rows past `n` read zero.  Thread t loads 8
// consecutive d of one row: consecutive threads take consecutive rows.
template <int D>
__device__ __forceinline__ void load_transposed(
    float* dst, const __nv_bfloat16* __restrict__ x, int r0, int n,
    size_t row_stride, int tid) {
  constexpr int kChunks = D / 8;
  for (int c = tid; c < kBQ * kChunks; c += kThreads) {
    const int r = c % kBQ;
    const int d0 = (c / kBQ) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      raw = *reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(r0 + r) * row_stride + d0);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(d0 + i) * kRow + r] = bf(e[i]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int sq, int skv,
                       int n_heads, int n_kv_heads, int window,
                       float scale) {
  constexpr int kDC = D / 16;           // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + Smem<D>::kQ;
  float* vs = ks + Smem<D>::kK;
  float* ps = vs + Smem<D>::kV;

  const int tid = threadIdx.x;
  const int tx = tid % 16;              // S columns 4 tx.., O columns tx + 16 j
  const int ty = tid / 16;              // rows 4 ty..
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int q0 = qt * kBQ;
  const int off = skv - sq;             // query i sits at position i + off

  const size_t q_stride = static_cast<size_t>(n_heads) * D;
  const size_t kv_stride = static_cast<size_t>(n_kv_heads) * D;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * sq * q_stride +
                            static_cast<size_t>(h) * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * skv * kv_stride +
                            static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * skv * kv_stride +
                            static_cast<size_t>(hk) * D;

  // key tiles this query tile can see
  const int qp_lo = q0 + off;
  const int qp_hi = min(q0 + kBQ, sq) - 1 + off;
  const int key_hi = min(qp_hi, skv - 1);
  const int key_lo = window >= 0 ? max(qp_lo - window, 0) : 0;
  const int t_lo = key_lo / kBK;
  const int t_hi = key_hi / kBK;

  load_transposed<D>(qs, qb, q0, sq, q_stride, tid);

  float m[4], l[4], acc[4][kDC];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
    qpos[i] = q0 + 4 * ty + i + off;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                    // the previous tile is consumed
    load_transposed<D>(ks, kb, k0, skv, kv_stride, tid);
    for (int c = tid; c < kBK * (D / 8); c += kThreads) {
      const int r = c / (D / 8);
      const int d0 = (c % (D / 8)) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (k0 + r < skv)
        raw = *reinterpret_cast<const uint4*>(
            vb + static_cast<size_t>(k0 + r) * kv_stride + d0);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) vs[r * D + d0 + i] = bf(e[i]);
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 block
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[d * kRow + 4 * ty]);
      const float4 kv = *reinterpret_cast<const float4*>(&ks[d * kRow + 4 * tx]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
      }
    }

    // mask, online softmax, P^T to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * tx + j;
        bool live = kp < skv && kp <= qpos[i];
        if (window >= 0) live = live && kp > qpos[i] - (window + 1);
        s[i][j] = live ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        rs += p[j];
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) rs += __shfl_xor_sync(kFull, rs, w);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(4 * tx + j) * kRow + 4 * ty + i] =
            __bfloat162float(__float2bfloat16_rn(p[j]));
    }
    // a row's P is written and read by the 16 threads of one half-warp
    __syncwarp();

    // O += P V for this thread's 4 rows x kDC columns
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&ps[c * kRow + 4 * ty]);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = o + static_cast<size_t>(b) * sq * q_stride +
                          static_cast<size_t>(row) * q_stride +
                          static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < kDC; ++j)
      orow[tx + 16 * j] = __float2bfloat16_rn(acc[i][j] / denom);
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* o, int b, int sq, int skv,
           int h, int hkv, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, sq, skv, h, hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o = causal attention(q, k, v) on `stream`; window < 0 means none.
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// head dim without an instantiation (64 for Hymba, 16 for its reduced
// test config).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int sq, int skv, int h, int hkv,
                           int d, int window, float scale, void* stream) {
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(qq, kk, vv, oo, b, sq, skv, h, hkv, window, scale, s);
    case 64:
      return launch<64>(qq, kk, vv, oo, b, sq, skv, h, hkv, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
