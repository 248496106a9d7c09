// Crossbar arbitration kernels for Hopper (sm_90a), bound through ctypes.
//
// Plain C entry points take device pointers, sizes and the CUDA stream,
// launch on that stream without synchronising, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// The plain PyTorch versions of these functions are in ../ref.py; each
// pair agrees bit for bit (integer arithmetic, and float adds rounded to
// nearest with no contraction into FMA).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------- //
// vc_prearb
//
// Replaces the Pallas kernel vc_prearb in
// src/repro/kernels/switch_arb/kernel.py (stage 1 of a crossbar
// sub-round): per (switch, port) row, the first VC of highest priority
// among those with qlen > 0, and whether there was one.  The engine also
// runs it for the link phase's choice of output VC.  With a queue buffer
// `buf` [rows * V, depth] and its `head` [rows * V] it also returns the
// chosen queue's head packet (-1 where no VC was a candidate): the gather
// that followed every call on the engine's two call sites.
//
// Bound: bytes.  A row reads V int32 + V float32 and writes two int32;
// the gather adds the head and the buffer word of a row that has a
// candidate and one int32 out: 52 bytes a row at V = 4, 1.7 MB at the
// paper's 11k-endpoint fabric, half a microsecond of HBM time, so the
// launch itself dominates.  Design: one thread per row; at V = 4 a row's
// qlen and rand are one 16-byte load each (int4 / float4), so a warp's
// loads are 512 contiguous bytes, and with the gather its four queues'
// heads come in a third 16-byte load issued beside them, so only the
// buffer word waits for the choice (two dependent loads, not three);
// other V loop in registers.
// ---------------------------------------------------------------------- //
template <bool kVec4, bool kGather>
__global__ void vc_prearb_kernel(const int* __restrict__ qlen,
                                 const float* __restrict__ rand,
                                 int* __restrict__ sel, int* __restrict__ has,
                                 const int* __restrict__ buf,
                                 const int* __restrict__ head,
                                 int* __restrict__ pkt, int rows, int v,
                                 int depth) {
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < rows;
       row += gridDim.x * blockDim.x) {
    float best;
    int arg = 0;
    int hd = 0;   // the chosen queue's head, read beside qlen at V = 4
    if constexpr (kVec4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(qlen) + row);
      const float4 r = __ldg(reinterpret_cast<const float4*>(rand) + row);
      int4 h4 = make_int4(0, 0, 0, 0);
      if constexpr (kGather) {
        h4 = __ldg(reinterpret_cast<const int4*>(head) + row);
      }
      best = q.x > 0 ? r.x : -1.0f;
      // strict: ties keep the lowest VC, as jnp.argmax
      const float x1 = q.y > 0 ? r.y : -1.0f;
      if (x1 > best) { best = x1; arg = 1; }
      const float x2 = q.z > 0 ? r.z : -1.0f;
      if (x2 > best) { best = x2; arg = 2; }
      const float x3 = q.w > 0 ? r.w : -1.0f;
      if (x3 > best) { best = x3; arg = 3; }
      hd = arg == 0 ? h4.x : arg == 1 ? h4.y : arg == 2 ? h4.z : h4.w;
    } else {
      const int* q = qlen + static_cast<size_t>(row) * v;
      const float* r = rand + static_cast<size_t>(row) * v;
      best = q[0] > 0 ? r[0] : -1.0f;
      for (int k = 1; k < v; ++k) {
        const float x = q[k] > 0 ? r[k] : -1.0f;
        if (x > best) {
          best = x;
          arg = k;
        }
      }
      if constexpr (kGather) hd = head[static_cast<size_t>(row) * v + arg];
    }
    const int h = best >= 0.0f ? 1 : 0;
    sel[row] = arg;
    has[row] = h;
    if constexpr (kGather) {
      int p = -1;
      if (h) p = buf[(static_cast<size_t>(row) * v + arg) * depth + hd];
      pkt[row] = p;
    }
  }
}

// An empty kernel: the floor of a launch timed with CUDA events.
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------- //
// switch_arbitrate (dense layout)
//
// Replaces the Pallas kernel switch_arbitrate in
// src/repro/kernels/switch_arb/kernel.py (stages 2+3 fused): per
// requester row, score = (occ + penalty * deroute) + tie over the ports,
// masked to kBig, first argmin; then per (switch, output port) the
// largest priority word (rnd << 23 | lo) among the requesters that can
// move, and the grant to its owner.  The literal counterpart of the TPU
// kernel on its [N, R, P] layout; the engine runs switch_arbitrate_rows
// below instead.
//
// Bound: bytes.  The [N, R, P] inputs (occ, deroute, mask as int32, tie
// as float32) are 16 bytes per element, read once: 29.8 MB at the
// paper's 11k-endpoint fabric, about 9 us of HBM time.  Design: one
// block per switch, which keeps the segmented max inside the block:
// the per-port maximum lives in shared memory and is built with
// atomicMax on int32 (order-independent, so the result is exact).  No
// (8, 128) padding: threads loop over rows and every row loops over its
// P ports, so any R and P work.  A thread walks its own row.
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

// ---------------------------------------------------------------------- //
// switch_arbitrate_rows
//
// The same stages 2+3 (the Pallas kernel switch_arbitrate in
// src/repro/kernels/switch_arb/kernel.py), redesigned for Hopper on the
// engine's own flat requester rows: [N*P network inputs] ++ [S NICs], so
// no dense [N, R_max, P] block is built and undone around it.  It also
// reads the occupancies itself: for row i at switch cur with flight VC
// vc = next_vc[i], port j scores
//   oq  = oq_len[(cur*P + j)*V + vc]          (local output queue)
//   qd  = qlen[dq_base[cur*P + j] + vc]       (downstream input queue)
//   occ = zero_occ ? 0 : oq + qd
//   s   = allowed && oq < out_queue ? (occ + penalty*deroute) + tie : kBig
// (zero_occ, the ksp random walk, also drops the deroute term), then the
// first argmin, priority (rnd << 23) | i, the segmented max per
// (switch, output port) and the grant, as the dense kernel.
//
// Bound: bytes.  tie (float32) and the allowed / deroute bytes, 6 bytes
// per (row, port); route, rnd, next_vc; the occupancy words once per
// (switch, port, VC); port, win and seg out: 11.6 MB at the paper's
// 11k-endpoint fabric, about 3.5 us of HBM time, against the dense
// layout's 29.8 MB.  Design: one block per switch.  A switch's rows are
// two contiguous runs (net rows cur*P .. cur*P + P, and for a leaf its d
// NIC rows from nic_first[cur]), so their tie, allowed and deroute bytes
// are contiguous too: the block stages them into shared memory with
// 16-byte cp.async copies (the ragged ends byte by byte), and meanwhile
// reads the switch's P*V occupancy words into a VC-major table of
// floats (-1 where the output queue has no credit) and its rows'
// next_vc, priority word and route flag.  The argmin then reads shared
// memory only: kLanes lanes a row (1, a thread a row, up to 32, a warp a
// row), lane l taking ports l, l + kLanes, ..., then the lanes' (score,
// port) pairs reduced by __shfl_xor_sync.  A thread a row starts at port
// k % P and wraps (a rotation that spreads a warp's reads over the banks
// without a padded layout); with 4 lanes and P = 36 the rows of a warp
// already fall on distinct banks.  Every comparison takes the lower port
// on a tie, so the result is the first argmin whatever the order.  The
// deroute term is penalty * 1 or penalty * 0, so it is selected, not
// multiplied, with the same bits.
// The segmented max lives in shared memory, built with atomicMax on
// int32 (order-independent, so exact).  Any P, d and R = P + d work.
//
// Replicas: kBatched adds the grid's y dimension, one replica a block
// row.  A block moves every per-replica pointer (tie, allowed, deroute
// [R, NR, P]; route, rnd, next_vc, port, win [R, NR]; oq_len, qlen
// [R, N*P*V]; seg [R, N*P]) to its replica's slice and shares the
// geometry (nic_first, dq_base); the row index i in a priority word
// stays the row within the fabric, so replica r is bitwise the
// unbatched launch on its slices.  A launch of one replica takes the
// unbatched instantiation, whose code has no replica arithmetic at all.
// ---------------------------------------------------------------------- //
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// byte offsets of the shared-memory regions, each 16-byte aligned; a
// staged region has 15 bytes of slack for its source's alignment phase
struct RowsLayout {
  int tie_net, tie_nic, al_net, al_nic, de_net, de_nic;
  int occ, seg, vc, prio, port, route, total;
};

__host__ __device__ inline RowsLayout rows_layout(int p, int v, int d) {
  RowsLayout l;
  const int r = p + d;
  int off = 0;
  l.tie_net = off; off += round16(p * p * 4 + 15);
  l.tie_nic = off; off += round16(d * p * 4 + 15);
  l.al_net = off;  off += round16(p * p + 15);
  l.al_nic = off;  off += round16(d * p + 15);
  l.de_net = off;  off += round16(p * p + 15);
  l.de_nic = off;  off += round16(d * p + 15);
  l.occ = off;     off += round16(v * p * 4);
  l.seg = off;     off += round16(p * 4);
  l.vc = off;      off += round16(r * 4);
  l.prio = off;    off += round16(r * 4);
  l.port = off;    off += round16(r * 4);
  l.route = off;   off += round16(r);
  l.total = off;
  return l;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy the n bytes at src to dst + (src & 15), which keeps the source's
// 16-byte phase: its aligned middle goes by 16-byte cp.async, its ragged
// ends byte by byte.  dst is 16-byte aligned with n + 15 bytes of room.
// Returns where the bytes land.
__device__ __forceinline__ unsigned char* stage(unsigned char* dst,
                                                const void* src_v, int n) {
  const unsigned char* src = static_cast<const unsigned char*>(src_v);
  const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* out = dst + phase;
  const int head = min((16 - phase) & 15, n);
  const int chunks = (n - head) >> 4;
  const int tail = head + (chunks << 4);
  for (int k = threadIdx.x; k < chunks; k += blockDim.x)
    cp_async16(out + head + (k << 4), src + head + (k << 4));
  for (int k = threadIdx.x; k < head; k += blockDim.x) out[k] = src[k];
  for (int k = tail + threadIdx.x; k < n; k += blockDim.x) out[k] = src[k];
  return out;
}

template <int kLanes, bool kBatched>
__global__ void __launch_bounds__(256) switch_arbitrate_rows_kernel(
    const float* __restrict__ tie, const unsigned char* __restrict__ allowed,
    const unsigned char* __restrict__ der,
    const unsigned char* __restrict__ route, const int* __restrict__ rnd,
    const int* __restrict__ next_vc, const int* __restrict__ oq_len,
    const int* __restrict__ qlen, const int* __restrict__ nic_first,
    const int* __restrict__ dq_base, int* __restrict__ port,
    int* __restrict__ win, int* __restrict__ seg, int p, int v, int d,
    float penalty, int out_queue, int zero_occ, int nr) {
  if constexpr (kBatched) {   // this block's replica
    const size_t rep = blockIdx.y;
    const size_t rows = rep * nr;
    const size_t words = rep * gridDim.x * p * v;
    tie += rows * p;
    allowed += rows * p;
    der += rows * p;
    route += rows;
    rnd += rows;
    next_vc += rows;
    port += rows;
    win += rows;
    oq_len += words;
    qlen += words;
    seg += rep * gridDim.x * p;
  }
  extern __shared__ __align__(16) unsigned char smem_rows[];
  unsigned char* smem = smem_rows;
  const RowsLayout l = rows_layout(p, v, d);
  const int cur = blockIdx.x;
  const int nic = nic_first[cur];
  const int r = nic >= 0 ? p + d : p;
  const size_t net0 = static_cast<size_t>(cur) * p;
  if (zero_occ) penalty = 0.0f;   // the score is the tiebreak alone
  const float pen0 = __fmul_rn(penalty, 0.0f);   // penalty * deroute 0

  // ---- stage: the rows' [., P] blocks by cp.async ----
  const float* t_net = reinterpret_cast<const float*>(
      stage(smem + l.tie_net, tie + net0 * p, p * p * 4));
  const unsigned char* a_net = stage(smem + l.al_net, allowed + net0 * p,
                                     p * p);
  const unsigned char* d_net = stage(smem + l.de_net, der + net0 * p, p * p);
  const float* t_nic = t_net;
  const unsigned char* a_nic = a_net;
  const unsigned char* d_nic = d_net;
  if (nic >= 0) {
    const size_t nic0 = static_cast<size_t>(nic) * p;
    t_nic = reinterpret_cast<const float*>(
        stage(smem + l.tie_nic, tie + nic0, d * p * 4));
    a_nic = stage(smem + l.al_nic, allowed + nic0, d * p);
    d_nic = stage(smem + l.de_nic, der + nic0, d * p);
  }

  // ---- meanwhile: occupancy table, row vectors, segment maxima ----
  float* s_occ = reinterpret_cast<float*>(smem + l.occ); // [V][P]
  int* s_seg = reinterpret_cast<int*>(smem + l.seg);     // [P]
  int* s_vc = reinterpret_cast<int*>(smem + l.vc);       // [R]
  int* s_prio = reinterpret_cast<int*>(smem + l.prio);   // [R]
  int* s_port = reinterpret_cast<int*>(smem + l.port);   // [R]
  unsigned char* s_route = smem + l.route;               // [R]
  const int* oq_sw = oq_len + net0 * v;
  for (int t = threadIdx.x; t < p * v; t += blockDim.x) {
    const int j = t / v;
    const int c = t - j * v;
    const int oq = oq_sw[t];
    float val = -1.0f;                  // no credit: the port is masked
    if (oq < out_queue) {
      val = static_cast<float>(zero_occ ? 0 : oq + qlen[dq_base[net0 + j] + c]);
    }
    s_occ[c * p + j] = val;
  }
  for (int j = threadIdx.x; j < p; j += blockDim.x) s_seg[j] = -1;
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    const size_t i = k < p ? net0 + k : static_cast<size_t>(nic) + (k - p);
    s_vc[k] = next_vc[i];
    s_prio[k] = static_cast<int>((static_cast<unsigned>(rnd[i]) << 23) |
                                 static_cast<unsigned>(i));
    s_route[k] = route[i];
  }
  cp_async_wait_all();
  __syncthreads();

  auto finish = [&](int k, float best, int arg) {
    const size_t i = k < p ? net0 + k : static_cast<size_t>(nic) + (k - p);
    const bool can = s_route[k] && best < kBig;
    port[i] = arg;
    s_port[k] = can ? arg : -1;
    if (can) atomicMax(&s_seg[arg], s_prio[k]);
  };

  // a pass takes blockDim.x / kLanes rows; the passes are uniform over
  // the block, so every lane of a warp reaches the shuffles
  const int lane = threadIdx.x % kLanes;
  const int ports = (p - lane + kLanes - 1) / kLanes;   // this lane's
  for (int k0 = 0; k0 < r; k0 += blockDim.x / kLanes) {
    const int k = k0 + threadIdx.x / kLanes;
    float best = __int_as_float(0x7f800000);   // +inf: no port
    int arg = 0x7fffffff;
    if (k < r && ports > 0) {
      const bool net = k < p;
      const int e = (net ? k : k - p) * p;
      const float* tr = (net ? t_net : t_nic) + e;
      const unsigned char* ar = (net ? a_net : a_nic) + e;
      const unsigned char* dr = (net ? d_net : d_nic) + e;
      const float* oc = s_occ + s_vc[k] * p;
      int m = kLanes == 1 ? k % ports : 0;
      for (int t = 0; t < ports; ++t) {
        const int j = lane + m * kLanes;
        const float o = oc[j];
        float s = kBig;
        if (ar[j] && o >= 0.0f) {
          s = __fadd_rn(__fadd_rn(o, dr[j] ? penalty : pen0), tr[j]);
        }
        if (s < best || (s == best && j < arg)) {
          best = s;
          arg = j;
        }
        if (++m == ports) m = 0;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oa = __shfl_xor_sync(kFull, arg, off);
      if (ob < best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    if (k < r && lane == 0) finish(k, best, arg);
  }
  __syncthreads();

  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    const size_t i = k < p ? net0 + k : static_cast<size_t>(nic) + (k - p);
    const int pt = s_port[k];
    win[i] = (pt >= 0 && s_seg[pt] == s_prio[k]) ? 1 : 0;
  }
  for (int j = threadIdx.x; j < p; j += blockDim.x) seg[net0 + j] = s_seg[j];
}

}  // namespace

extern "C" int vc_prearb_launch(const int* qlen, const float* rand, int* sel,
                                int* has, const int* buf, const int* head,
                                int* pkt, int rows, int v, int depth,
                                void* stream) {
  const int threads = 256;
  const int blocks = (rows + threads - 1) / threads;
  const bool gather = buf != nullptr;
  const bool vec4 = v == 4 &&
                    (reinterpret_cast<uintptr_t>(qlen) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(rand) & 15) == 0 &&
                    (!gather || (reinterpret_cast<uintptr_t>(head) & 15) == 0);
  decltype(&vc_prearb_kernel<true, true>) kernel =
      vec4 ? (gather ? &vc_prearb_kernel<true, true>
                     : &vc_prearb_kernel<true, false>)
           : (gather ? &vc_prearb_kernel<false, true>
                     : &vc_prearb_kernel<false, false>);
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      qlen, rand, sel, has, buf, head, pkt, rows, v, depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
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

// dynamic shared bytes a block of switch_arbitrate_rows takes
extern "C" int switch_arbitrate_rows_smem(int p, int v, int d) {
  return rows_layout(p, v, d).total;
}

// lanes: 1, 2, 4, 8, 16 or 32 lanes a row; a block has the threads for
// all P + d rows of a leaf in one pass, a multiple of 32, at most 256.
// replicas: the grid's y extent (1: the unbatched kernel); nr: the
// requester rows of one replica.
template <int kLanes>
static int rows_launch(const float* tie, const unsigned char* allowed,
                       const unsigned char* der, const unsigned char* route,
                       const int* rnd, const int* next_vc, const int* oq_len,
                       const int* qlen, const int* nic_first,
                       const int* dq_base, int* port, int* win, int* seg,
                       int n, int p, int v, int d, float penalty,
                       int out_queue, int zero_occ, int replicas, int nr,
                       cudaStream_t stream) {
  auto kernel = replicas > 1 ? &switch_arbitrate_rows_kernel<kLanes, true>
                             : &switch_arbitrate_rows_kernel<kLanes, false>;
  int threads = ((p + d) * kLanes + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  const int shared = rows_layout(p, v, d).total;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(n, replicas), threads, shared, stream>>>(
      tie, allowed, der, route, rnd, next_vc, oq_len, qlen, nic_first,
      dq_base, port, win, seg, p, v, d, penalty, out_queue, zero_occ, nr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int switch_arbitrate_rows_launch(
    const float* tie, const unsigned char* allowed, const unsigned char* der,
    const unsigned char* route, const int* rnd, const int* next_vc,
    const int* oq_len, const int* qlen, const int* nic_first,
    const int* dq_base, int* port, int* win, int* seg, int n, int p, int v,
    int d, float penalty, int out_queue, int zero_occ, int lanes,
    int replicas, int nr, void* stream) {
  if (replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  decltype(&rows_launch<1>) launch;
  switch (lanes) {
    case 1: launch = &rows_launch<1>; break;
    case 2: launch = &rows_launch<2>; break;
    case 4: launch = &rows_launch<4>; break;
    case 8: launch = &rows_launch<8>; break;
    case 16: launch = &rows_launch<16>; break;
    case 32: launch = &rows_launch<32>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(tie, allowed, der, route, rnd, next_vc, oq_len, qlen,
                nic_first, dq_base, port, win, seg, n, p, v, d, penalty,
                out_queue, zero_occ, replicas, nr,
                static_cast<cudaStream_t>(stream));
}
