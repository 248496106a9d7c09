// Flash attention forward (GQA; causal with an optional sliding window,
// or not causal) for Hopper (sm_90a) on the tensor cores, bound through
// ctypes.
//
// Replaces the Pallas kernel flash_attention in
// src/repro/kernels/flash_attention/kernel.py:73 (pallas_call at :89),
// both of its forms (causal: bool), and adds the sliding window that the
// reference's attention_core and attention_ref take:
//
//   q [B, Sq, H, DQK], k [B, Skv, Hkv, DQK], v [B, Skv, Hkv, DV] bf16
//   -> o [B, Sq, H, DV] bf16 (DV = DQK but for MLA's 192 / 128, as the
//   reference's attention_core takes them), query head h reads key head
//   h / (H / Hkv).  Causal (kCausal): query i sits at position
//   i + Skv - Sq (Sq <= Skv), and key j is live when j <= qpos and, with a
//   window, j > qpos - (window + 1).  Not causal (an encoder's
//   self-attention, a cross-attention over a context: instantiated at
//   (64, 64) and (128, 128)): every key j < Skv is live, Sq and Skv are
//   free, and there is no window.
//
// Arithmetic, as in the Pallas kernel and the plain version in ../ref.py:
// s = (q . k) * scale in float32 (bf16 products are exact; the scale,
// 1 / sqrt(DQK), is applied after the sum), masked entries set to
// NEG = -1e30, a running max m and sum l per row in float32,
// p = expf(s - m_new) (the accurate expf), l summed from the unrounded p,
// p rounded to bf16 only as the A operand of p . v, acc rescaled by
// alpha = expf(m - m_new), and
// o = acc / max(l, 1e-30) rounded to bf16.  Sums run in another order than
// in the plain version, so a few outputs differ from it by one bf16
// rounding.
//
// The plain version's s is a float32 matrix product, which sums each
// q . k as one fmaf chain in d order.  The tensor cores' sum of the same
// bf16 products differs from it in the last bits (they align the terms of
// each k16 step and truncate).  That moves no output by itself, but where
// it moves p's bf16 rounding, or the row max from which every p of the
// row is taken, outputs move by one bf16 ulp, in far more places than the
// check against the plain version allows (PERF.md; bench.py
// --tc-sums-only builds the kernel without what follows).  So the kernel
// takes the row max, and every p whose rounding is in doubt, from the
// chain: where a tile may raise a row's max, the s within two bands of the
// largest; and every p within its band of a bf16 rounding midpoint.  The
// band bounds the difference of the two sums by
// kBand * 2^-24 * scale * |q| |k|.  The chains are summed from the
// swizzled tiles in shared memory, one per lane in each round, the whole
// warp in step.
//
// Ceilings at the serving slice's shapes (B 4, S 4,096, H 25, Hkv 5, D 64,
// one full causal layer; a 2,048-window layer is about 3/4 of it):
// - tensor cores: 4 D operations per live (query, key) pair, 2.15e11, at
//   989 TFLOP/s bf16: 0.217 ms.  This is the bound chip_smoke.py reports;
//   q, k, v and o are 126 MB, 0.04 ms at 3.35 TB/s.
// - MUFU ex2: one exponential per pair the kernel visits, the live pairs
//   plus the masked halves of the diagonal tiles, about 8.5e8, at 16 per
//   clock per SM: about 0.23 ms.
// - the float32 pipe: scale, mask, max, subtract, the expf's range
//   reduction, sum and rescale, about 8 operations per pair: about 0.2 ms.
// At D = 128 the tensor-core bound of a full causal layer is 2.75e11
// operations, 0.278 ms, for qwen3-1.7b (B 4, H 16, Hkv 8) and 5.50e11,
// 0.556 ms, for qwen3-moe-235b-a22b (B 2, H 64, Hkv 4); the exponentials
// per pair stay the same, so the tensor cores' share of a tile doubles.
// At DeepSeek-V3's MLA (B 2, S 4,096, H = Hkv = 128, DQK 192, DV 128) it
// is 2 (DQK + DV) = 640 operations a pair, 1.375e12, 1.390 ms.
//
// Not causal, every pair is live, at the same 4 D operations a pair: the
// llama-3.2-vision cross layer (B 2, Sq 4,096 over Skv 1,600, H 64, Hkv 8,
// D 128) is 4.29e11 operations, 0.434 ms, seamless-m4t's encoder (B 4,
// 1,024 over 1,024, H = Hkv = 16, D 64) 1.72e10, 0.017 ms, and its cross
// layer (4,096 over 1,024) 6.87e10, 0.069 ms.
//
// Design.  One block is one warpgroup (128 threads) and owns a tile of 64
// queries of one (batch, head), wgmma's M; blocks take the query tiles
// from the last (causal: the heaviest) to the first.  Causal, it walks the
// key tiles of 64 that its queries can see (tiles wholly above the
// diagonal or wholly left of the window are skipped); not causal, every
// key tile, and only the last, where it holds rows past Skv, is masked
// (kernel.py's key_tiles mirrors the range for the CPU tests).
// One thread loads Q once, and K and V tile by tile, with TMA into a ring
// of kStages shared-memory stages, each completed on its own mbarrier;
// TMA fills the rows past Skv (or Sq) with zeros.  Tiles are swizzled
// (128-byte rows at D = 64, 32-byte rows at D = 16) as wgmma reads them;
// a row wider than 64 columns is wider than a 128-byte swizzled box, so a
// tile is D / 64 sub-tiles of 64 columns (two at D = 128, three for MLA's
// 192-wide Q and K), each loaded as its own box on the tile's mbarrier
// and swizzled as a D = 64 tile, the descriptors stepping from one to the
// next.  At (192, 128) the shared memory is Q 24 KB and 2 stages of K 24
// KB and V 16 KB, 104 KB, so two blocks still fit on an SM.
// S = Q K^T is DQK/16 wgmma m64n64k16 with both operands in shared
// memory; it leaves each thread two rows (r and r + 8) of 16 columns
// each, so the row max and row sum are four-lane shuffles.  The mask is
// applied only on tiles that hold a masked pair.  P is computed in place
// in S's registers and, rounded pairwise to bf16x2, is already the
// register A fragment of O += P V (4 wgmma m64nDVk16, V read N-major
// through the descriptor's transpose bit; 4 m64n64k16 a sub-tile at
// DV = 128), so P never goes through shared memory.  O stays in float32
// registers.  A stage is refilled after the block's barrier at the end of
// the tile that used it, so the next tile's loads overlap this tile's
// math, and the blocks that fit on an SM overlap one block's softmax with
// another's MMAs.
//
// The exact chains cost more than the rest of the softmax (PERF.md): a
// warp needs a round in most tiles, and a round is a DQK-step dependent
// chain (192 steps for MLA).  Rounds shared by the block, or chains that
// overlap the next tile's tensor-core work, are left to later work, as
// are warp specialisation (a producer warp, setmaxnreg), ping-pong of one
// warpgroup's softmax against another's MMAs, a persistent grid, and
// sharing each K/V tile across the g = 5 query heads of a KV head.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;                 // queries per block (wgmma M)
constexpr int kBK = 64;                 // keys per tile
constexpr int kThreads = 128;           // one warpgroup
constexpr int kStages = 2;              // K/V ring depth
constexpr int kAlign = 1024;            // the 128-byte swizzle's repeat
constexpr unsigned kFull = 0xffffffffu;
// |s from the tensor cores - s from the d-order float32 chain| is taken to
// be at most kBand * 2^-24 * scale * |q| |k| (Euclidean norms of the query
// and key rows): each sum is within a few of these units of the exact one
// (the tensor cores truncate the aligned terms of a k16 step, the chain
// rounds 64 times), and a difference past the band only leaves a p
// rounded as the tensor cores have it
constexpr float kBand = 2.f;
// the ablation that shows what the chains are for: s, the row max and
// every p from the tensor cores alone (bench.py --tc-sums-only)
#ifdef FLASH_ATTENTION_TC_SUMS_ONLY
constexpr bool kExactSums = false;
#else
constexpr bool kExactSums = true;
#endif
// expf's own rounding, as a share of p, added to the band of a p
constexpr float kExpSlack = 0x1p-21f;

// a tile of 64 rows of D bf16 columns in shared memory
template <int D>
struct Tile {
  static_assert(D == 16 || D == 64 || D == 128 || D == 192,
                "tile widths 16, 64, 128 and 192");
  // kSubs sub-tiles of kSubD columns each, side by side: with the
  // 128-byte swizzle a TMA box spans at most 128 bytes a row, so a row
  // wider than 64 bf16 columns is loaded as 64-column sub-tiles
  static constexpr int kSubD = D >= 64 ? 64 : D;
  static constexpr int kSubs = D / kSubD;
  static constexpr int kChunks = kSubD / 8;            // 16-byte chunks a row
  static constexpr int kRowBytes = 2 * kSubD;          // one sub-tile row
  static constexpr int kSubBytes = kBK * kRowBytes;    // one sub-tile
  static constexpr int kTileBytes = kSubs * kSubBytes; // the tile
  static constexpr uint64_t kLayout =
      D >= 64 ? sm90::kSwizzle128 : sm90::kSwizzle32;
  static constexpr CUtensorMapSwizzle kMapSwizzle =
      D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  // eight rows of one swizzle atom: the stride between core-matrix groups
  // along M or N (Q, K) and along K (V)
  static constexpr uint32_t kSbo = 8 * kRowBytes;
};

template <int DQK, int DV>
struct Cfg {
  static_assert((DQK == DV && DV != 192) || (DQK == 192 && DV == 128),
                "head dims (16, 16), (64, 64), (128, 128) and (192, 128)");
  using QK = Tile<DQK>;                                // Q and K tiles
  using V = Tile<DV>;
  static constexpr int kOregs = DV / 2;                // O fragment floats
  static constexpr int kSubOregs = V::kSubD / 2;       // of one sub-tile
  // Q, K[kStages], V[kStages], 1 + 2 kStages mbarriers, then each
  // stage's largest key norm of each warp's 16 keys
  static constexpr int kKOffset = QK::kTileBytes;
  static constexpr int kVOffset = (1 + kStages) * QK::kTileBytes;
  static constexpr int kBarOffset = kVOffset + kStages * V::kTileBytes;
  static constexpr int kNormOffset = kBarOffset + 8 * (1 + 2 * kStages);
  static constexpr size_t kBytes = kNormOffset + 4 * kStages * 4 +
                                   kAlign;             // + alignment slack
};

// byte offset of the 16-byte chunk c (d = 8 c .. 8 c + 7) of row `row` in
// a tile of width D that TMA swizzled: chunk c lies in sub-tile
// c / kChunks, and its index there is XORed with row bits 0-2 (128-byte
// rows) or row bit 2 (32-byte rows)
template <int D>
__device__ __forceinline__ int chunk_offset(int row, int c) {
  using T = Tile<D>;
  const int swz = D >= 64 ? (row & 7) : ((row >> 2) & 1);
  return (c / T::kChunks) * T::kSubBytes + row * T::kRowBytes +
         (((c % T::kChunks) ^ swz) << 4);
}

// sum over d of q[row][d] k[key][d] as one float32 fmaf chain in d order
// from 0: the sum the plain version's float32 matrix product gives (cuBLAS
// sums a dot product of 192, 128, 64 or 16 terms this way), from two
// swizzled tiles
template <int D>
__device__ __forceinline__ float dot_chain(const uint8_t* q, int row,
                                           const uint8_t* k, int key) {
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 qv =
        *reinterpret_cast<const uint4*>(q + chunk_offset<D>(row, c));
    const uint4 kv =
        *reinterpret_cast<const uint4*>(k + chunk_offset<D>(key, c));
    const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qv);
    const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a = fmaf(__bfloat162float(qe[i]), __bfloat162float(ke[i]), a);
  }
  return a;
}

// sum of x[row][d]^2 over the 16-byte chunks c0 .. c0 + n - 1 (a bound: in
// any order)
template <int D>
__device__ __forceinline__ float sum_squares(const uint8_t* x, int row,
                                             int c0, int n) {
  float a[2] = {0.f, 0.f};
  for (int c = c0; c < c0 + n; ++c) {
    const uint4 v =
        *reinterpret_cast<const uint4*>(x + chunk_offset<D>(row, c));
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      a[0] = fmaf(f.x, f.x, a[0]);
      a[1] = fmaf(f.y, f.y, a[1]);
    }
  }
  return a[0] + a[1];
}

// this thread's S register c holds row r + 8 ((c >> 1) & 1), key
// 8 (c >> 2) + col + (c & 1) of the tile
template <int D>
__device__ __forceinline__ float chain_at(const uint8_t* q, const uint8_t* k,
                                          int r, int col, int c) {
  return dot_chain<D>(q, r + 8 * ((c >> 1) & 1), k,
                      8 * (c >> 2) + col + (c & 1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DQK, int DV, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ o, int sq, int skv,
                       int n_heads, int n_kv_heads, int window,
                       float scale) {
  using C = Cfg<DQK, DV>;
  using QK = typename C::QK;
  using V = typename C::V;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (sm90::smem_addr(smem_raw) + (kAlign - 1)) & ~uint32_t(kAlign - 1);
  const uint32_t q_tile = base;
  const uint32_t k_tile0 = base + C::kKOffset;
  const uint32_t v_tile0 = base + C::kVOffset;
  const uint32_t q_bar = base + C::kBarOffset;
  const uint32_t k_bar0 = q_bar + 8;
  const uint32_t v_bar0 = k_bar0 + 8 * kStages;
  // the same shared memory through generic pointers, for the exact sums
  uint8_t* const smem = smem_raw + (base - sm90::smem_addr(smem_raw));
  const uint8_t* q_gen = smem;
  const uint8_t* k_gen0 = smem + C::kKOffset;
  float* k_norm0 = reinterpret_cast<float*>(smem + C::kNormOffset);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int q0 = qt * kBQ;
  // causal: query i sits at i + off (off < 0 only where not causal, and
  // then it is read nowhere)
  const int off = skv - sq;

  // key tiles this query tile can see (kernel.py: key_tiles): causal, from
  // the window's first to the diagonal's last; not causal, all of them
  const int qp_lo = q0 + off;
  const int qp_hi = min(q0 + kBQ, sq) - 1 + off;
  int t_lo = 0;
  int n_tiles = (skv + kBK - 1) / kBK;
  if constexpr (kCausal) {
    const int key_hi = min(qp_hi, skv - 1);
    const int key_lo = window >= 0 ? max(qp_lo - window, 0) : 0;
    t_lo = key_lo / kBK;
    n_tiles = key_hi / kBK - t_lo + 1;
  }

  // one thread: a tile of 64 rows from `row` of head `head`, sub-tile by
  // sub-tile, all completing on `bar`
  auto load_tile = [&](auto tile, uint32_t dst, const CUtensorMap* map,
                       uint32_t bar, int head, int row) {
    using T = decltype(tile);
    sm90::mbar_arrive_expect_tx(bar, T::kTileBytes);
#pragma unroll
    for (int sub = 0; sub < T::kSubs; ++sub)
      sm90::tma_load_4d(dst + sub * T::kSubBytes, map, bar, sub * T::kSubD,
                        head, row, b);
  };
  auto issue_kv = [&](int i) {              // one thread: tile i's K and V
    const int s = i % kStages;
    const int k0 = (t_lo + i) * kBK;
    load_tile(QK{}, k_tile0 + s * QK::kTileBytes, &k_map, k_bar0 + 8 * s,
              hk, k0);
    load_tile(V{}, v_tile0 + s * V::kTileBytes, &v_map, v_bar0 + 8 * s, hk,
              k0);
  };

  if (tid == 0) {
    sm90::tma_prefetch_map(&q_map);
    sm90::tma_prefetch_map(&k_map);
    sm90::tma_prefetch_map(&v_map);
    for (int i = 0; i < 1 + 2 * kStages; ++i) sm90::mbar_init(q_bar + 8 * i);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_tile(QK{}, q_tile, &q_map, q_bar, h, q0);
    for (int i = 0; i < kStages && i < n_tiles; ++i) issue_kv(i);
  }

  // this thread's rows of the tile: r and r + 8 of its warp's 16
  const int r = 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);           // + 8 j + e for register 4 j + e
  const int qpos[2] = {q0 + r + off, q0 + r + 8 + off};
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float acc[C::kOregs];                     // O, float32
  float pv[V::kSubs][C::kSubOregs];         // one tile's P V, by sub-tile
  float s[32];
#pragma unroll
  for (int i = 0; i < C::kOregs; ++i)
    acc[i] = pv[i / C::kSubOregs][i % C::kSubOregs] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  const uint64_t q_desc = sm90::make_desc(q_tile, 0, QK::kSbo, QK::kLayout);
  sm90::mbar_wait(q_bar, 0);
  // the band of s for this thread's rows, short of the key norm
  float qband[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    qband[half] = kBand * 0x1p-24f * scale *
                  sqrtf(sum_squares<DQK>(q_gen, r + 8 * half, 0, DQK / 8));

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = (t_lo + i) * kBK;

    // S = Q K^T: DQK/16 steps of k16, 32 bytes along each K-major row of
    // a sub-tile, kSubD/16 steps a sub-tile
    const uint64_t k_desc = sm90::make_desc(
        k_tile0 + st * QK::kTileBytes, 0, QK::kSbo, QK::kLayout);
    const uint8_t* k_gen = k_gen0 + st * QK::kTileBytes;
    float* k_norm = k_norm0 + 4 * st;
    sm90::mbar_wait(k_bar0 + 8 * st, parity);
    sm90::fence_operands(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint64_t step = (kk / (QK::kSubD / 16)) * (QK::kSubBytes >> 4) +
                            2 * (kk % (QK::kSubD / 16));
      sm90::wgmma_m64n64k16_ss(s, q_desc + step, k_desc + step, kk);
    }
    sm90::wgmma_commit();
    // the tile's largest key norm, while the tensor cores work: two
    // threads a key, then each warp's largest of its 16 keys
    {
      float kk2 = sum_squares<DQK>(k_gen, tid / 2, (tid % 2) * (DQK / 16),
                                   DQK / 16);
      kk2 += __shfl_xor_sync(kFull, kk2, 1);
#pragma unroll
      for (int w = 2; w < 32; w *= 2)
        kk2 = fmaxf(kk2, __shfl_xor_sync(kFull, kk2, w));
      if (lane == 0) k_norm[warp] = kk2;
    }
    sm90::wgmma_wait_all();
    sm90::fence_operands(s);
    __syncthreads();                        // the key norms are written
    const float kn_max = sqrtf(fmaxf(fmaxf(k_norm[0], k_norm[1]),
                                     fmaxf(k_norm[2], k_norm[3])));

    // register 4 j + 2 half + e holds row r + 8 half, column 8 j + col + e;
    // the mask is needed only where a key of the tile is masked for a row.
    // Rows past Skv are TMA's zeros, which score s = 0, not NEG: causal,
    // j <= qpos < Skv hides them; not causal, only the test j < Skv does,
    // in the last tile
    const bool unmasked =
        kCausal ? k0 + kBK - 1 <= qp_lo && (window < 0 || k0 >= qp_hi - window)
                : k0 + kBK <= skv;
    if (unmasked) {
#pragma unroll
      for (int c = 0; c < 32; ++c) s[c] *= scale;
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int kp = k0 + 8 * (c / 4) + col + c % 2;
        bool live = kp < skv;
        if constexpr (kCausal) {
          const int qp = qpos[(c / 2) % 2];
          live = live && kp <= qp;
          if (window >= 0) live = live && kp > qp - (window + 1);
        }
        s[c] = live ? s[c] * scale : kNeg;
      }
    }
    // The row max and p's bf16 rounding must be the plain version's: they
    // are taken from the d-order chain wherever the tensor cores' s could
    // decide them otherwise.  Chains are summed in rounds of one per lane,
    // the whole warp in step, while a lane has one to do.
    float band[2], mx[2], m_new[2];
    uint32_t exact = 0;                     // bit c: s[c] is the chain's
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      band[half] = qband[half] * kn_max;
      mx[half] = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx[half] = fmaxf(mx[half], fmaxf(s[4 * j + 2 * half],
                                         s[4 * j + 2 * half + 1]));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFull, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFull, mx[half], 2));
      // the tile may raise the row max: every s within two bands of the
      // largest is summed again
      if (kExactSums && mx[half] + band[half] >= m[half]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 4 * j + 2 * half + e;
            if (s[c] != kNeg && s[c] >= mx[half] - 2.f * band[half])
              exact |= 1u << c;
          }
        }
      }
    }
    if (__any_sync(kFull, exact)) {
      for (uint32_t todo = exact; __any_sync(kFull, todo);
           todo &= todo - 1) {
        const int c = todo ? __ffs(todo) - 1 : 0;
        const float v = chain_at<DQK>(q_gen, k_gen, r, col, c) * scale;
#pragma unroll
        for (int cc = 0; cc < 32; ++cc)
          if (todo && cc == c) s[cc] = v;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = kNeg;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx[half] = fmaxf(mx[half], fmaxf(s[4 * j + 2 * half],
                                           s[4 * j + 2 * half + 1]));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFull, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFull, mx[half], 2));
      }
    }
    // p, and the p within their band of a bf16 rounding midpoint: a p in
    // [2^e, 2^(e+1)) moves by at most 2^24 (band + kExpSlack) of its ulps
    // 2^(e-23), so its rounding is in doubt when its low 16 bits are
    // within that many of 0x8000 (a masked p is 0 and an exact one needs
    // no second sum, but testing them costs nothing)
    uint32_t lo[2], width[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      m_new[half] = fmaxf(m[half], mx[half]);
      const uint32_t t =
          static_cast<uint32_t>((band[half] + kExpSlack) * 0x1p24f) + 1;
      lo[half] = 0x8000u - t;
      width[half] = 2 * t;
    }
    uint32_t doubt = 0;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int half = (c >> 1) & 1;
      const float x = expf(s[c] - m_new[half]);
      if (kExactSums &&
          ((__float_as_uint(x) - lo[half]) & 0xffffu) <= width[half])
        doubt |= 1u << c;
      s[c] = x;
    }
    for (uint32_t todo = doubt; __any_sync(kFull, todo); todo &= todo - 1) {
      const int c = todo ? __ffs(todo) - 1 : 0;
      const float x = expf(chain_at<DQK>(q_gen, k_gen, r, col, c) * scale -
                           ((c >> 1) & 1 ? m_new[1] : m_new[0]));
#pragma unroll
      for (int cc = 0; cc < 32; ++cc)
        if (todo && cc == c) s[cc] = x;
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rs += s[4 * j + 2 * half];
        rs += s[4 * j + 2 * half + 1];
      }
      rs += __shfl_xor_sync(kFull, rs, 1);
      rs += __shfl_xor_sync(kFull, rs, 2);
      alpha[half] = expf(m[half] - m_new[half]);
      l[half] = __fadd_rn(__fmul_rn(l[half], alpha[half]), rs);
      m[half] = m_new[half];
    }

    // P as bf16x2: S's registers 8 kk .. 8 kk + 7 are the A fragment of
    // the k16 step over keys 16 kk .. 16 kk + 15
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        p[kk][a] = pack_bf16x2(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1]);
    }

    // pv = P V: for each sub-tile of V's columns, 4 steps of k16, 16 rows
    // of V each
    const uint64_t v_desc = sm90::make_desc(
        v_tile0 + st * V::kTileBytes, 0, V::kSbo, V::kLayout);
    sm90::mbar_wait(v_bar0 + 8 * st, parity);
#pragma unroll
    for (int sub = 0; sub < V::kSubs; ++sub) sm90::fence_operands(pv[sub]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(p[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int sub = 0; sub < V::kSubs; ++sub) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vk = v_desc + sub * (V::kSubBytes >> 4) +
                            ((16 * kk * V::kRowBytes) >> 4);
        if constexpr (DV >= 64)
          sm90::wgmma_m64n64k16_rs_tb(pv[sub], p[kk], vk, kk);
        else
          sm90::wgmma_m64n16k16_rs_tb(pv[sub], p[kk], vk, kk);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int sub = 0; sub < V::kSubs; ++sub) sm90::fence_operands(pv[sub]);

    // acc = acc * alpha + pv, rounded as the plain version rounds it: the
    // tensor cores' sums truncate, which over a whole row of tiles would
    // pull acc off by more than one rounding per tile
#pragma unroll
    for (int c = 0; c < C::kOregs; ++c)
      acc[c] = __fadd_rn(__fmul_rn(acc[c], alpha[(c / 2) % 2]),
                         pv[c / C::kSubOregs][c % C::kSubOregs]);

    // every thread is done with stage st: refill it
    __syncthreads();
    if (tid == 0 && i + kStages < n_tiles) issue_kv(i + kStages);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r + 8 * half;
    if (row >= sq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * sq + row) *
                                  n_heads * DV +
                          static_cast<size_t>(h) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const float x0 = acc[4 * j + 2 * half] / denom;
      const float x1 = acc[4 * j + 2 * half + 1] / denom;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// so that the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over x [batch, seq, heads, D] (D innermost) whose box is one
// head's sub-tile of 64 rows, [64][kSubD], swizzled as wgmma reads it
template <int D>
CUresult make_map(CUtensorMap* map, EncodeTiled encode, const void* x,
                  int batch, int seq, int heads) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {Tile<D>::kSubD, 1, kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<D>::kMapSwizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// tensor-map failures are returned as kMapError + the CUresult, apart
// from the CUDA runtime's own error codes
constexpr int kMapError = 100000;

template <int DQK, int DV, bool kCausal>
int launch(const void* q, const void* k, const void* v, __nv_bfloat16* o,
           int b, int sq, int skv, int h, int hkv, int window, float scale,
           cudaStream_t stream) {
  static_assert(kBQ == kBK, "one box shape serves Q, K and V");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError;
  CUtensorMap q_map, k_map, v_map;
  CUresult res = make_map<DQK>(&q_map, encode, q, b, sq, h);
  if (res == CUDA_SUCCESS)
    res = make_map<DQK>(&k_map, encode, k, b, skv, hkv);
  if (res == CUDA_SUCCESS) res = make_map<DV>(&v_map, encode, v, b, skv, hkv);
  if (res != CUDA_SUCCESS) return kMapError + static_cast<int>(res);
  constexpr size_t bytes = Cfg<DQK, DV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DQK, DV, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_attention_kernel<DQK, DV, kCausal><<<grid, kThreads, bytes, stream>>>(
      q_map, k_map, v_map, o, sq, skv, h, hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream`: causal when `causal` != 0 (window
// < 0 means none), else every key for every query (window must be < 0).
// q, k, v and o are contiguous and 16-byte aligned (TMA's condition; the
// wrapper checks it); q and k are d wide, v and o dv wide.  Returns
// cudaGetLastError() of the launch, cudaErrorInvalidValue for head dims
// without an instantiation (causal: (64, 64) for Hymba, (16, 16) for its
// reduced test config, (128, 128) for the dense and MoE models, (192, 128)
// for DeepSeek-V3's MLA; not causal: (64, 64) for seamless-m4t, (128, 128)
// for llama-3.2-vision) or for a window that is not causal, or
// 100000 + the CUresult when a tensor map cannot be made (100000 alone:
// CUDA offers no cuTensorMapEncodeTiled).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int sq, int skv, int h, int hkv,
                           int d, int dv, int window, int causal, float scale,
                           void* stream) {
  auto* oo = static_cast<__nv_bfloat16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  if (!causal) {
    if (window >= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (d == 64 && dv == 64)
      return launch<64, 64, false>(q, k, v, oo, b, sq, skv, h, hkv, -1,
                                   scale, s);
    if (d == 128 && dv == 128)
      return launch<128, 128, false>(q, k, v, oo, b, sq, skv, h, hkv, -1,
                                     scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 16 && dv == 16)
    return launch<16, 16, true>(q, k, v, oo, b, sq, skv, h, hkv, window,
                                scale, s);
  if (d == 64 && dv == 64)
    return launch<64, 64, true>(q, k, v, oo, b, sq, skv, h, hkv, window,
                                scale, s);
  if (d == 128 && dv == 128)
    return launch<128, 128, true>(q, k, v, oo, b, sq, skv, h, hkv, window,
                                  scale, s);
  if (d == 192 && dv == 128)
    return launch<192, 128, true>(q, k, v, oo, b, sq, skv, h, hkv, window,
                                  scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
