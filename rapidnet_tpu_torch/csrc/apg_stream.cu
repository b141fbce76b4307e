// Streaming APG iteration for Hopper (sm_90a): K1 (backward) and K2
// (forward) over a scenario tree too large for the whole-solve kernel.
//
// Replaces the TPU kernels of rapidnet_tpu/ops/pallas_stream.py::
// make_apg_stream (K1 body :311, pallas_call :497; K2 body :417,
// pallas_call :527) and the run that composes them (run_impl :577, with
// its XLA scalar combine and final tail).  One iteration computes what
// they compute:
//   K1, stages N-1 .. 0: the previous iteration's residual
//        r = (1 - shrink)(pre - clip(pre, lo, hi)) - c w_prev, the dual
//        update y' = y + upd (lam_prev z + step r), z' = y' - y, the
//        signed champion of r, the extrapolation w = y' + lam_i z', and
//        the backward recursion t = d1 w1 + d2 w2 + t_carry,
//        inner = beta + a_carry + Bb t + L'(g wp), v = nhp iW inner,
//        with the child -> parent handoff after each prefix stage;
//   K2, stages 0 .. N-1: du += L v, u = uhat + du, x = x_prev + e + B u,
//        the pre-images d1 x + c w1, d2 x + c w2, g u + c wp and the two
//        rep-weighted squared distances of the x pre-images to their box;
// then the shrink factors from those distances, which the next K1 reads.
// d1, d2, g and every bound are sqrt(prob) x a per-stage row (the rank-1
// form the TPU kernels read): the kernels read the rows and the sqrt(prob)
// line instead of five (N, ns, d) slabs.
//
// What bounds it on the card.  At BASELINE config 5 (N = 24 stages,
// ns = 1024 scenario slots, nx = 63, nu = 114, nv = 97) the state (y, z,
// the pre-images, v, x, u) is ~100 MB, twice the 50 MB L2, so every
// iteration streams it from device memory: K1 moves ~137 MB and K2 ~115
// MB, 75 us per iteration at 3.35 TB/s, against 2.4 GFLOP of products,
// 36 us at 67 TFLOP/s: bytes set the bound.  Within a block the stage
// recursion is serial, so a stage costs its latency.  The first design
// read the matrices through L1/L2 at every k-step and the operands in
// rounds of dependent loads: a K1 stage took ~21.5 us, 74 % of it in its
// products, a K2 stage ~23.7 us.  With the matrices and the operands in
// shared memory a K1 stage takes ~6.7 us and a K2 stage ~6.2 us, two
// thirds of it in the products, which are now bound by the bytes shared
// memory hands their threads (tile_product); K1's five launches add a
// handoff gather each (~5 us, dependent loads) (PERF.md sections 5 and
// 6, profile_solve.py --stream --spans).
//
// What the design does.  The recursion is serial over the stages and
// independent across the scenario slots except at the branching prefix.
// Each block owns TILE consecutive slots (128 blocks at ns = 1024) and
// walks the stages, carrying t and a (K1) or du and x (K2) in shared
// memory; the tile's rows of every (N, ns, d) array are contiguous, so
// its loads are coalesced without a transpose.  K1 is cut after each
// prefix stage: a launch ends by writing its tile's carries, and the next
// launch starts each slot's carries as the sum over the child slots of
// its parent (at most 8 rows at config 5), read from index lists; two
// carry buffers alternate between the launches.  K2 needs no handoff
// (the fan layout duplicates a node's values over its subtree's slots).
// Staged, each launch copies its matrices into shared memory once (K1:
// Bb', L and iW', 106 KB at config 5; K2: L' and B', 73 KB) with the
// copy engine (TMA bulk copies on an mbarrier: no thread spends a load
// slot on them), together with the first stage's operands, while K1's
// handoff gather runs; and each stage's streaming operands (the tile's
// rows of y, z and the pre-images, beta, sqrt(prob) and nhp, and the
// stage's rank-1 rows, for K1; of v, uhat, e, y and z or w, sqrt(prob)
// and rep for K2) are copied into shared memory a stage ahead, so the
// elementwise passes read shared memory: K1 into its one buffer once its
// elementwise pass has read it (it adds beta to the carry a and keeps
// nhp's tile there), under its three products; K2 into the other of two
// buffers, under its second product.  The last warp, idle in those
// products at config 5, issues the copies.  K1's handoff gather lists
// each slot's first KIDS child slots in shared memory and issues the
// loads of GATHER items at once.  The C entry picks the staged variant
// where its shared memory fits the device's opt-in limit (and, fused,
// every block stays resident); else the same stage bodies read the
// matrices and the operands from device memory (a template flag).
// Every output keeps its sum in one order in both variants (one fmaf
// chain over k from 0, the emits' expressions as they were), so both
// give the bits of the first design.  Stores stay plain coalesced
// stores.
//
// The iteration counter, lam_i, upd and the shrink factors stay on the
// device (a one-block scalar phase reads the counter), so one iteration's
// launches are captured as a CUDA graph and replayed: the host enqueues
// each iteration with one call.  The squared distances and the champions
// are reduced in two passes (per-block partials, then a fixed-order
// pass), with no atomics, so a run repeats itself bit for bit.
//
// The fused iteration (fused_kernel, C entry apg_stream_fused) replaces
// the TPU kernel of pallas_stream.py::make_apg_stream_fused (:686; kernel
// body :726, pallas_call :905, run :975-1070): the same iteration in one
// call, w and v kept on chip between the backward and the forward
// phase.  Here it is one cooperative launch of the same blocks, each
// walking its tile through every stage: each block first derives the
// scalars itself (the scalar phase's fixed-order reduction, so every
// block gets the same bits; no atomics), then runs K1's stage bodies
// over every range of stages with a grid barrier before each prefix
// handoff's gather, then K2's, reading v from shared memory (24 * 8 *
// 97 floats, 74.5 KB at config 5) and w from a device scratch of (N,
// ns, 2nx + nu) that the same block wrote (23.6 MB, inside the L2): K2
// no longer re-reads y and z (~47 MB an iteration).  One launch an
// iteration in place of 1 scalar + 5 K1 + 1 K2, replayed from a
// captured graph; the stage bodies, and so the bits, are K1's and K2's.
// The Pallas grid's dense CpT/BpT handoff products are not carried over:
// the handoff stays the index-list gather.  It needs every block
// resident at once (128 blocks of 256 threads at config 5, on 132 SMs):
// the launch checks the occupancy and refuses a grid that is not.
//
// Products are this file's own FP32 FMA loops (no cuBLAS, no tensor
// cores, no TF32): the JAX package computes them at Precision.HIGHEST.
// Its stream_precision="default" (one bf16 MXU pass a product) is the
// BF16 instantiation of every kernel, reached through the C entries
// apg_stream_bf16 and apg_stream_fused_bf16: each product's vector operand
// is rounded to bfloat16 (to nearest, ties to even) once per element, and
// the caller passes the matrices rounded the same way, so the same FP32
// FMA chain sums exact bf16 x bf16 products.  The rounded copies of t, of
// inner and of u (which stay float32 as the carries and the pre-images
// read them) take (nx + nv) x TILE more floats of K1's work area and
// nu x TILE more of K2's; v and g wp are rounded where they are stored.
// The handoff gather rounds each child's carry before its sum and the sum
// after it, as the TPU kernel's one-hot CpT and BpT products at that
// precision do (pallas_stream.py:401-404).  The "highest" instantiation is
// the code as it was, with its shared memory and bits.
//
// Layout: every per-row array is row-major (N, ns, d) with row
// r = s * ns + i (stage s, slot i), the unpadded layout of the JAX
// package's XLA path; the dual pair is xi (N, ns, 2 nx) = [y1 | y2] and
// psi (N, ns, nu), as the whole-solve kernel keeps it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 8;            // scenario slots per block
constexpr int GROUP = 4;           // slots per thread in a product (float4)
constexpr int THREADS = 256;       // block size of K1, K2 and the tail
constexpr int SCALAR_THREADS = 256;
constexpr int KIDS = 8;            // child rows a handoff gather loads at once
constexpr int GATHER = 4;          // (slot, feature) items it loads at once

struct Args {
  int N, ns, nx, nu, nv, nblocks, max_it;
  float c, step, t1c, t2c, xs_upper;
  // rank-1 constants: per-stage rows (N, d) and per-slot lines (N, ns)
  const float *cx1, *cx2, *cu, *bx_min, *bx_max, *bx_s, *bu_min, *bu_max;
  const float *sq, *nhp, *rep;
  // shared matrices, row-major (K, C): out[c] = sum_k M[k * C + c] in[k]
  const float *L, *BbT, *iWT, *LT, *BT;
  const float* lams;   // lam_i, i = 0 .. max_it
  // prefix handoffs: each slot's parent (n_agg, ns), parents' child slots
  const int *agg_parent, *agg_ptr, *agg_idx;
  // the step
  const float *beta, *uhat, *e, *x0, *pdu;
  // state (N, ns, d), carries, partials and scalars
  float *y_xi, *y_psi, *z_xi, *z_psi, *pre_xi, *pre_psi, *v, *x, *u;
  float* carry;        // 2 buffers of (ns, nx + nv): [t | a] per slot
  float* norm_part;    // (nblocks, 2)
  float* champ_part;   // (launches x blocks, 4): hi_x, lo_x, hi_u, lo_u
  float* sc;           // lam_prev, lam_i, upd, k1f, k2f
  float* trace;
  int* ctr;            // the iteration the next scalar phase starts
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  // jnp.clip semantics: max with lo, then min with hi
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// The prox residual (1 - shrink)(pre - clip(pre, lo, hi)) - c w; keep is
// 1 - shrink, cw is c w.
__device__ __forceinline__ float residual(float pre, float lo, float hi,
                                          float keep, float cw) {
  return keep * (pre - clip(pre, lo, hi)) - cw;
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// x rounded to bfloat16 (to nearest, ties to even) and widened back: a
// product's operand under BF16.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// x as a product under BF16 reads it (rounded), else x.
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  return BF16 ? bf16r(x) : x;
}

// The parts of a block's stage that the instrumented build times
// (nvcc -DAPG_STREAM_CLOCK): SM cycles on thread 0 between barriers,
// summed over the blocks and launches into g_spans, which
// apg_stream_spans reads.  The marks add barriers and nothing else, so
// the outputs stay those of the plain build; without the define they
// are empty.
enum Part {
  P_K1_START, P_X, P_U, P_BBT, P_L, P_IWT, P_K1_END,
  P_K2_LOAD, P_LT, P_BT, P_PRE_X, P_PRE_U, P_K2_END, P_K1_WAIT, P_K2_WAIT,
  N_PARTS
};
#ifdef APG_STREAM_CLOCK
__device__ unsigned long long g_spans[N_PARTS];
#endif

// part < 0 starts the clock.
__device__ __forceinline__ void clock_mark(int part) {
#ifdef APG_STREAM_CLOCK
  __shared__ long long last;
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long now = clock64();
    if (part >= 0)
      atomicAdd(&g_spans[part], (unsigned long long)(now - last));
    last = now;
  }
#else
  (void)part;
#endif
}

// Deterministic tree reduction over a block of BLOCK threads.
template <int BLOCK, class Op>
__device__ __forceinline__ float block_reduce(float v, float* buf, Op op) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int stride = BLOCK / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride)
      buf[threadIdx.x] = op(buf[threadIdx.x], buf[threadIdx.x + stride]);
    __syncthreads();
  }
  const float out = buf[0];
  __syncthreads();
  return out;
}

struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// ---- bulk copies into shared memory (the Tensor Memory Accelerator) ----
//
// One thread asks for a segment of device memory to be copied into shared
// memory (cp.async.bulk); the copy engine runs it and counts its bytes
// down on an mbarrier in shared memory, on which every thread waits.  The
// threads spend no instructions and no load slots on the copy.  A bulk
// copy moves 16-byte aligned runs of 16-byte multiples, so a segment of n
// floats at src is copied as the aligned run around it (at most 12 bytes
// more on either side, inside the tensor's allocation: PyTorch's blocks
// are 512-byte aligned and sized); its floats land at src's offset within
// 16 bytes of the 16-byte aligned segment (`landing`).

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}
// The barriers' initialisation, visible to the copy engine.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// This thread's generic accesses to shared memory ordered before the
// copy engine's next writes.
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (not 0, which __syncthreads uses) of the first `count`
// threads of the block (a multiple of 32).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// This thread's stores to device memory visible to the copy engine.
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// The one arrival of the barrier's phase, which completes once `bytes`
// more have landed.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(float* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }
// The floats a segment of n floats takes in shared memory: its aligned
// run, at most n + 3 floats rounded up to 4.
__host__ __device__ constexpr int room(int n) { return n ? up4(n) + 4 : 0; }

__device__ __forceinline__ int misalign(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}
// Where a segment copied from src into seg (16-byte aligned) lands.
__device__ __forceinline__ const float* landing(const float* seg,
                                                const float* src) {
  return seg + misalign(src);
}
// The 16-byte aligned run around n floats at src, and its bytes.
__device__ __forceinline__ const char* run_start(const float* src) {
  return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(src) &
                                       ~(uintptr_t)15);
}
__device__ __forceinline__ unsigned run_bytes(const float* src, int n) {
  if (!n) return 0;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src) & ~(uintptr_t)15;
  const uintptr_t hi =
      (reinterpret_cast<uintptr_t>(src + n) + 15) & ~(uintptr_t)15;
  return (unsigned)(hi - lo);
}

// One warp: one phase of `bar` that completes once every segment visit(f)
// names (f(seg, src, n), at most 32 of them) has landed in shared
// memory; lane i issues the copy of segment i, lane 0 the expected bytes
// first.
template <class Visit>
__device__ __forceinline__ void bulk_fill(uint64_t* bar, Visit visit) {
  const int lane = threadIdx.x & 31;
  unsigned bytes = 0;
  int at = 0, n = 0;
  float* seg = nullptr;
  const float* src = nullptr;
  visit([&](float* sg, const float* sr, int nn) {
    bytes += run_bytes(sr, nn);
    if (at++ == lane) {
      seg = sg;
      src = sr;
      n = nn;
    }
  });
  fence_proxy_shared();
  if (lane == 0) mbar_expect(bar, bytes);
  __syncwarp();
  if (n) bulk_copy(seg, run_start(src), run_bytes(src, n), bar);
}

// ---- a stage's streaming operands ----
//
// K1's operands of stage s for a tile: the tile's rows of y, z and the
// pre-images of xi and psi, of beta, sqrt(prob) and nhp (row j of the
// tile at j * d), and the stage's rank-1 rows.  K2's: the tile's rows of
// v, uhat and e, of y and z (two-kernel K2) or of w (the fused kernel's
// scratch), of sqrt(prob) and rep, and the rank-1 rows its pre-images
// read.  A staged launch copies them into a buffer of shared memory, in
// this order, one stage ahead; an unstaged one reads them where they lie.
enum K1Op {
  O1_YX, O1_ZX, O1_PX, O1_YP, O1_ZP, O1_PP, O1_BETA, O1_SQ, O1_NHP,
  O1_CX1, O1_CX2, O1_BXMIN, O1_BXMAX, O1_BXS, O1_CU, O1_BUMIN, O1_BUMAX,
  K1_OPS
};
enum K2Op {
  O2_V, O2_UHAT, O2_E, O2_YX, O2_ZX, O2_YP, O2_ZP, O2_W, O2_SQ, O2_REP,
  O2_CX1, O2_CX2, O2_BXMIN, O2_BXMAX, O2_BXS, O2_CU, K2_OPS
};
template <int N>
struct Ops {
  const float* f[N];
};

// Floats of operand o for nt slots.
__host__ __device__ inline int k1_len(int o, int nx, int nu, int nv,
                                      int nt) {
  if (o <= O1_PX) return 2 * nx * nt;
  if (o <= O1_PP) return nu * nt;
  if (o == O1_BETA) return nv * nt;
  if (o <= O1_NHP) return nt;
  return o <= O1_BXS ? nx : nu;
}
__host__ __device__ inline int k2_len(int o, int nx, int nu, int nv, int nt,
                                      bool fused) {
  switch (o) {
    case O2_V: return fused ? 0 : nv * nt;
    case O2_UHAT: return nu * nt;
    case O2_E: return nx * nt;
    case O2_YX: case O2_ZX: return fused ? 0 : 2 * nx * nt;
    case O2_YP: case O2_ZP: return fused ? 0 : nu * nt;
    case O2_W: return fused ? (2 * nx + nu) * nt : 0;
    case O2_SQ: case O2_REP: return nt;
    case O2_CU: return nu;
    default: return nx;
  }
}
// Floats of one buffer.
__host__ __device__ inline int k1_buf_floats(int nx, int nu, int nv) {
  int n = 0;
  for (int o = 0; o < K1_OPS; ++o) n += room(k1_len(o, nx, nu, nv, TILE));
  return n;
}
__host__ __device__ inline int k2_buf_floats(int nx, int nu, int nv,
                                             bool fused) {
  int n = 0;
  for (int o = 0; o < K2_OPS; ++o)
    n += room(k2_len(o, nx, nu, nv, TILE, fused));
  return n;
}

__device__ __forceinline__ Ops<K1_OPS> k1_sources(const Args& p, int s,
                                                  int i0) {
  const size_t row0 = (size_t)s * p.ns + i0;
  const size_t sx = (size_t)s * p.nx, su = (size_t)s * p.nu;
  const size_t rx = row0 * 2 * p.nx, ru = row0 * p.nu;
  return {{p.y_xi + rx, p.z_xi + rx, p.pre_xi + rx, p.y_psi + ru,
           p.z_psi + ru, p.pre_psi + ru, p.beta + row0 * p.nv, p.sq + row0,
           p.nhp + row0, p.cx1 + sx, p.cx2 + sx, p.bx_min + sx,
           p.bx_max + sx, p.bx_s + sx, p.cu + su, p.bu_min + su,
           p.bu_max + su}};
}
__device__ __forceinline__ Ops<K2_OPS> k2_sources(const Args& p, int s,
                                                  int i0, const float* win) {
  const size_t row0 = (size_t)s * p.ns + i0;
  const size_t sx = (size_t)s * p.nx;
  const size_t rx = row0 * 2 * p.nx, ru = row0 * p.nu;
  return {{p.v + row0 * p.nv, p.uhat + ru, p.e + row0 * p.nx, p.y_xi + rx,
           p.z_xi + rx, p.y_psi + ru, p.z_psi + ru,
           win ? win + row0 * (2 * p.nx + p.nu) : nullptr, p.sq + row0,
           p.rep + row0, p.cx1 + sx, p.cx2 + sx, p.bx_min + sx,
           p.bx_max + sx, p.bx_s + sx, p.cu + (size_t)s * p.nu}};
}

// Names K1's operands of stage s and their segments of `buf` to f.
template <class F>
__device__ __forceinline__ void k1_visit(const Args& p, int s, int i0,
                                         int nt, float* buf, F f) {
  const Ops<K1_OPS> src = k1_sources(p, s, i0);
#pragma unroll
  for (int o = 0; o < K1_OPS; ++o) {
    f(buf, src.f[o], k1_len(o, p.nx, p.nu, p.nv, nt));
    buf += room(k1_len(o, p.nx, p.nu, p.nv, TILE));
  }
}
template <bool FUSED, class F>
__device__ __forceinline__ void k2_visit(const Args& p, int s, int i0,
                                         int nt, float* buf,
                                         const float* win, F f) {
  const Ops<K2_OPS> src = k2_sources(p, s, i0, win);
#pragma unroll
  for (int o = 0; o < K2_OPS; ++o) {
    f(buf, src.f[o], k2_len(o, p.nx, p.nu, p.nv, nt, FUSED));
    buf += room(k2_len(o, p.nx, p.nu, p.nv, TILE, FUSED));
  }
}

// Where K1's operands of stage s are read: in `buf` (NBUF > 0) or in
// device memory.
template <int NBUF>
__device__ __forceinline__ Ops<K1_OPS> k1_ops(const Args& p, int s, int i0,
                                              const float* buf) {
  Ops<K1_OPS> o = k1_sources(p, s, i0);
  if (NBUF) {
#pragma unroll
    for (int k = 0; k < K1_OPS; ++k) {
      o.f[k] = landing(buf, o.f[k]);
      buf += room(k1_len(k, p.nx, p.nu, p.nv, TILE));
    }
  }
  return o;
}
template <int NBUF, bool FUSED>
__device__ __forceinline__ Ops<K2_OPS> k2_ops(const Args& p, int s, int i0,
                                              const float* buf,
                                              const float* win) {
  Ops<K2_OPS> o = k2_sources(p, s, i0, win);
  if (NBUF) {
#pragma unroll
    for (int k = 0; k < K2_OPS; ++k) {
      if (k2_len(k, p.nx, p.nu, p.nv, TILE, FUSED))
        o.f[k] = landing(buf, o.f[k]);
      buf += room(k2_len(k, p.nx, p.nu, p.nv, TILE, FUSED));
    }
  }
  return o;
}

// The shared matrices of a launch, named to f with their segments of
// `mats` (the copies keep the row-major (K, C) layout), and where a
// product reads each: in shared memory (STAGED) or in device memory.
template <class F>
__device__ __forceinline__ void mats_visit(float* mats, const float* const* M,
                                           const int* n, int count, F f) {
  for (int k = 0; k < count; ++k) {
    f(mats, M[k], n[k]);
    mats += room(n[k]);
  }
}
template <bool STAGED>
__device__ __forceinline__ void mats_at(const float* mats,
                                        const float* const* M, const int* n,
                                        int count, const float** at) {
  for (int k = 0; k < count; ++k) {
    at[k] = STAGED ? landing(mats, M[k]) : M[k];
    mats += room(n[k]);
  }
}

// out[c][j0 .. j0+3] = sum_k M[k * C + c] * X[k * TILE + j0 .. j0+3] for
// the tile: X feature-major in shared memory, M row-major (K, C) in
// shared memory (STAGED) or in device memory, read through L1
// (consecutive threads read consecutive c).  Each thread owns one output
// row c and GROUP slots, each one fmaf chain over k from 0; emit(c, j,
// acc) runs for every slot j of the tile.  Step k + 1's operands are
// loaded before step k's FMAs.  Staged, a product is bound by the bytes
// shared memory hands its threads, 128 a cycle: a k-step gives each
// thread a word of M and X's float4 (20 bytes for 4 FMAs), ~0.31 cycles
// a (row, k) at config 5.  Two or four rows a thread read less but leave
// too few warps to hide the loads' latency, and measured slower (PERF.md
// section 6).
template <bool STAGED, class Emit>
__device__ __forceinline__ void tile_product(const float* X,
                                             const float* __restrict__ M,
                                             int K, int C, Emit emit) {
  constexpr int NG = TILE / GROUP;
  for (int item = threadIdx.x; item < C * NG; item += blockDim.x) {
    const int c = item % C;
    const int j0 = (item / C) * GROUP;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    float m = STAGED ? M[c] : __ldg(M + c);
    float4 xv = *reinterpret_cast<const float4*>(X + j0);
#pragma unroll 4
    for (int k = 0; k + 1 < K; ++k) {
      const float* Mn = M + (k + 1) * C + c;
      const float mn = STAGED ? *Mn : __ldg(Mn);
      const float4 xn =
          *reinterpret_cast<const float4*>(X + (k + 1) * TILE + j0);
      a0 = fmaf(xv.x, m, a0);
      a1 = fmaf(xv.y, m, a1);
      a2 = fmaf(xv.z, m, a2);
      a3 = fmaf(xv.w, m, a3);
      m = mn;
      xv = xn;
    }
    a0 = fmaf(xv.x, m, a0);
    a1 = fmaf(xv.y, m, a1);
    a2 = fmaf(xv.z, m, a2);
    a3 = fmaf(xv.w, m, a3);
    emit(c, j0, a0);
    emit(c, j0 + 1, a1);
    emit(c, j0 + 2, a2);
    emit(c, j0 + 3, a3);
  }
}

__device__ __forceinline__ float shrink(float sumsq, float thresh) {
  const float dist = sqrtf(sumsq);
  return dist > thresh ? 1.f - thresh / fmaxf(dist, 1e-30f) : 0.f;
}

// The signed champion of pallas_stream.py:362-378: hi if hi > -lo else
// lo, per block (x, u), then the larger.
__device__ __forceinline__ float champion(float hx, float lx, float hp,
                                          float lp) {
  return fmaxf(hx > -lx ? hx : lx, hp > -lp ? hp : lp);
}

// The five scalars an iteration's K1 and K2 read (the layout of sc):
// lam_prev, lam_i, upd and the shrink factors k1f, k2f.
struct Scalars {
  float lam_prev, lam_i, upd, k1f, k2f;
};

__device__ __forceinline__ Scalars given_scalars(const Args& p) {
  return {p.sc[0], p.sc[1], p.sc[2], p.sc[3], p.sc[4]};
}

// K1's dual update under BF16, each operation rounded on its own in
// PyTorch's order (k1_plain), never contracted to an FMA: t, inner and g wp
// are rounded to bfloat16 from these values, and a contraction moves some
// of them across a bf16 tie.  y + lam z (also K2's w under BF16):
__device__ __forceinline__ float extrapolate_rn(float y, float lam, float z) {
  return __fadd_rn(y, __fmul_rn(lam, z));
}
// keep (pre - clip(pre, lo, hi)) - c w
__device__ __forceinline__ float residual_rn(float pre, float lo, float hi,
                                             float keep, float c, float w) {
  return __fsub_rn(__fmul_rn(keep, __fsub_rn(pre, clip(pre, lo, hi))),
                   __fmul_rn(c, w));
}
// y + upd (lam_prev z + step r)
__device__ __forceinline__ float update_rn(float y, float z, float r,
                                           const Scalars& q, float step) {
  return __fadd_rn(y, __fmul_rn(q.upd, __fadd_rn(__fmul_rn(q.lam_prev, z),
                                                 __fmul_rn(step, r))));
}

// The scalars of iteration `it` from the squared distances s1, s2 that
// K2 of iteration it - 1 left.
__device__ __forceinline__ Scalars scalars_of(const Args& p, int it,
                                              float s1, float s2) {
  return {p.lams[it > 0 ? it - 1 : 0], p.lams[it], it > 0 ? 1.f : 0.f,
          it > 0 ? shrink(s1, p.t1c) : 0.f,
          it > 0 ? shrink(s2, p.t2c) : 0.f};
}

// Per-thread running max and min of the x-block and u-block residuals.
struct Champ {
  float hx, lx, hp, lp;
};

// The block's maxima (hx, hp) and minima (lx, lp) of h, for every
// thread: each warp's by shuffles, then the warps' through red (4 a
// warp).  A max or a min is exact in any order, so this gives the bits
// of a tree reduction, with two barriers in place of forty.
template <int BLOCK>
__device__ __forceinline__ Champ champ_reduce(Champ h, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    h.hx = fmaxf(h.hx, __shfl_xor_sync(0xffffffffu, h.hx, off));
    h.lx = fminf(h.lx, __shfl_xor_sync(0xffffffffu, h.lx, off));
    h.hp = fmaxf(h.hp, __shfl_xor_sync(0xffffffffu, h.hp, off));
    h.lp = fminf(h.lp, __shfl_xor_sync(0xffffffffu, h.lp, off));
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();               // red's last readers are done
  if ((threadIdx.x & 31) == 0) {
    red[4 * warp] = h.hx;
    red[4 * warp + 1] = h.lx;
    red[4 * warp + 2] = h.hp;
    red[4 * warp + 3] = h.lp;
  }
  __syncthreads();
  Champ out = {-inf(), inf(), -inf(), inf()};
  for (int w = 0; w < BLOCK / 32; ++w) {
    out.hx = fmaxf(out.hx, red[4 * w]);
    out.lx = fminf(out.lx, red[4 * w + 1]);
    out.hp = fmaxf(out.hp, red[4 * w + 2]);
    out.lp = fminf(out.lp, red[4 * w + 3]);
  }
  __syncthreads();               // before red is written again
  return out;
}

// What a scalar phase reads, reduced by one block of BLOCK threads in a
// fixed order, so every block that runs it gets the same bits: the two
// squared distances from the K2 partials (when `sums`) and the signed
// champion of n_champ K1 partials (when `champ`).  Every thread gets
// them.
template <int BLOCK>
__device__ __forceinline__ void reduce_partials(const Args& p, bool sums,
                                                bool champ, int n_champ,
                                                float* red, float* s1,
                                                float* s2, float* ch) {
  float a = 0.f, b2 = 0.f;
  if (sums)
    for (int b = threadIdx.x; b < p.nblocks; b += BLOCK) {
      a += p.norm_part[2 * b];
      b2 += p.norm_part[2 * b + 1];
    }
  *s1 = block_reduce<BLOCK>(a, red, Add());
  *s2 = block_reduce<BLOCK>(b2, red, Add());
  Champ h = {-inf(), inf(), -inf(), inf()};
  if (champ)
    for (int b = threadIdx.x; b < n_champ; b += BLOCK) {
      const float* cp = p.champ_part + 4 * b;
      h.hx = fmaxf(h.hx, cp[0]);
      h.lx = fminf(h.lx, cp[1]);
      h.hp = fmaxf(h.hp, cp[2]);
      h.lp = fminf(h.lp, cp[3]);
    }
  h = champ_reduce<BLOCK>(h, red);
  *ch = champion(h.hx, h.lx, h.hp, h.lp);
}

// One block.  With the counter at `it` on entry: the trace entry of
// iteration it - 2 from the n_champ champion partials that the last K1
// (or the tail) wrote, when it >= 2; with `advance`, the scalars of
// iteration it (lam_prev, lam_i, upd, and the shrink factors from the K2
// partials of iteration it - 1) and the counter moved on.  Before the
// tail the counter is max_it: the scalars then hold the last lam and
// shrinks, which is what the tail reads.
__global__ void __launch_bounds__(SCALAR_THREADS)
scalars_kernel(Args p, int n_champ, int advance) {
  __shared__ float red[SCALAR_THREADS];
  const int it = *p.ctr;
  float s1, s2, ch;
  reduce_partials<SCALAR_THREADS>(p, advance && it > 0, it >= 2, n_champ,
                                  red, &s1, &s2, &ch);
  if (threadIdx.x == 0) {
    if (it >= 2) p.trace[it - 2] = ch;
    if (advance) {
      const Scalars q = scalars_of(p, it, s1, s2);
      p.sc[0] = q.lam_prev;
      p.sc[1] = q.lam_i;
      p.sc[2] = q.upd;
      p.sc[3] = q.k1f;
      p.sc[4] = q.k2f;
      *p.ctr = it + 1;
    }
  }
}

// The block's champion partials (hi_x, lo_x, hi_u, lo_u) into cp.
__device__ __forceinline__ void store_champion(Champ h, float* red,
                                               float* cp) {
  h = champ_reduce<THREADS>(h, red);
  if (threadIdx.x == 0) {
    cp[0] = h.hx; cp[1] = h.lx; cp[2] = h.hp; cp[3] = h.lp;
  }
}

// A launch's shared memory, in floats: the carries and product operands
// (`work`; with bf16, K1's rounded t and inner and K2's rounded u too),
// the staged matrices (`mats`) and NBUF operand buffers.
__host__ __device__ inline int k1_work_floats(int nx, int nu, int nv,
                                              bool bf16) {
  return (nx + nv + nu + (bf16 ? nx + nv : 0)) * TILE;
}
__host__ __device__ inline int k2_work_floats(int nx, int nu, int nv,
                                              bool bf16) {
  return (2 * nu + nx + nv + (bf16 ? nu : 0)) * TILE;
}
__host__ __device__ inline int k1_mats_floats(int nx, int nu, int nv) {
  return room(nx * nv) + room(nu * nv) + room(nv * nv);
}
__host__ __device__ inline int k2_mats_floats(int nx, int nu, int nv) {
  return room(nv * nu) + room(nu * nx);
}

// The shared memory a staged launch copies into: the matrices, NBUF
// operand buffers of buf_floats each, and one barrier per buffer, whose
// phases every thread counts in `parity` (bit b: the parity of buffer
// b's next phase).
struct Staging {
  float* mats;
  float* bufs;
  int buf_floats;
  uint64_t* bars;
  unsigned parity;
};

template <int NBUF>
__device__ __forceinline__ float* buffer(const Staging& sg, int s) {
  return sg.bufs + (NBUF == 2 ? (s & 1) : 0) * sg.buf_floats;
}
template <int NBUF>
__device__ __forceinline__ uint64_t* barrier_of(const Staging& sg, int s) {
  return sg.bars + (NBUF == 2 ? (s & 1) : 0);
}
// Every thread: waits until stage s's buffer has landed.
template <int NBUF>
__device__ __forceinline__ void wait_buffer(Staging& sg, int s) {
  const unsigned b = NBUF == 2 ? (s & 1) : 0;
  mbar_wait(sg.bars + b, (sg.parity >> b) & 1u);
  sg.parity ^= 1u << b;
}

// K1's matrices (Bb', L, iW') and their floats.
__device__ __forceinline__ void k1_matrices(const Args& p, const float** M,
                                            int* n) {
  M[0] = p.BbT; M[1] = p.L; M[2] = p.iWT;
  n[0] = p.nx * p.nv; n[1] = p.nu * p.nv; n[2] = p.nv * p.nv;
}
__device__ __forceinline__ void k2_matrices(const Args& p, const float** M,
                                            int* n) {
  M[0] = p.LT; M[1] = p.BT;
  n[0] = p.nv * p.nu; n[1] = p.nu * p.nx;
}

// K1's stage s for the block's tile (slots i0 .. i0 + nt - 1), the
// carries t and a in tS (nx, TILE) and aS (nv, TILE), gS (nu, TILE)
// scratch, nhpS the stage's nhp; the operands in the buffer (NBUF 1),
// the next stage's (s_next >= 0) copied into it once this stage's
// elementwise pass has read it, while its products run.  Writes y', z'
// and v; with
// `wout` also w = y' + lam_i z' (rows of 2nx + nu, [w1 | w2 | wp]), and
// with `vkeep` also v as the (nv, TILE) tile that K2 multiplies (zero
// past nt).  BF16: the dual update, the extrapolation and t are rounded
// one operation at a time (the *_rn helpers), the products read t and
// inner rounded, from tR (nx, TILE) and aR (nv, TILE), and g wp and v's
// tile are rounded where they are stored.
template <bool STAGED, int NBUF, bool BF16>
__device__ __forceinline__ void k1_stage(
    const Args& p, const Scalars& q, int s, int s_next, int i0, int nt,
    float* tS, float* aS, float* gS, float* tR, float* aR, float* nhpS,
    const float* BbT, const float* L, const float* iWT, Staging& sg,
    Champ& h, float* wout, float* vkeep) {
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns, D = 2 * nx + nu;
  const float c = p.c, step = p.step;
  const size_t row0 = (size_t)s * ns + i0;
  if (NBUF) wait_buffer<NBUF>(sg, s);
  // every thread's operands have landed, and the last stage's product
  // that reads aS is done
  __syncthreads();
  clock_mark(P_K1_WAIT);
  const Ops<K1_OPS> o = k1_ops<NBUF>(p, s, i0, buffer<NBUF>(sg, s));
  // the dual update of the x blocks, the extrapolation and t (BF16: and t
  // rounded, zero past nt)
  for (int idx = threadIdx.x; idx < (BF16 ? TILE : nt) * nx;
       idx += blockDim.x) {
    const int j = idx / nx, k = idx - j * nx;
    if (BF16 && j >= nt) {
      tR[k * TILE + j] = 0.f;
      continue;
    }
    const size_t r = row0 + j;
    const size_t o1 = r * 2 * nx + k, o2 = o1 + nx;
    const int l1 = j * 2 * nx + k, l2 = l1 + nx;
    const float sqv = o.f[O1_SQ][j];
    const float y1 = o.f[O1_YX][l1], y2 = o.f[O1_YX][l2];
    const float z1 = o.f[O1_ZX][l1], z2 = o.f[O1_ZX][l2];
    const float pr1 = o.f[O1_PX][l1], pr2 = o.f[O1_PX][l2];
    float r1, r2, y1n, y2n;
    if constexpr (BF16) {
      r1 = residual_rn(pr1, o.f[O1_BXMIN][k] * sqv, o.f[O1_BXMAX][k] * sqv,
                       1.f - q.k1f, c, extrapolate_rn(y1, q.lam_prev, z1));
      r2 = residual_rn(pr2, o.f[O1_BXS][k] * sqv, p.xs_upper, 1.f - q.k2f,
                       c, extrapolate_rn(y2, q.lam_prev, z2));
      y1n = update_rn(y1, z1, r1, q, step);
      y2n = update_rn(y2, z2, r2, q, step);
    } else {
      const float w1p = y1 + q.lam_prev * z1, w2p = y2 + q.lam_prev * z2;
      r1 = residual(pr1, o.f[O1_BXMIN][k] * sqv, o.f[O1_BXMAX][k] * sqv,
                    1.f - q.k1f, c * w1p);
      r2 = residual(pr2, o.f[O1_BXS][k] * sqv, p.xs_upper, 1.f - q.k2f,
                    c * w2p);
      y1n = y1 + q.upd * (q.lam_prev * z1 + step * r1);
      y2n = y2 + q.upd * (q.lam_prev * z2 + step * r2);
    }
    const float z1n = y1n - y1, z2n = y2n - y2;
    p.y_xi[o1] = y1n;
    p.y_xi[o2] = y2n;
    p.z_xi[o1] = z1n;
    p.z_xi[o2] = z2n;
    h.hx = fmaxf(h.hx, fmaxf(r1, r2));
    h.lx = fminf(h.lx, fminf(r1, r2));
    const float d1 = o.f[O1_CX1][k] * sqv, d2 = o.f[O1_CX2][k] * sqv;
    float w1, w2;
    if constexpr (BF16) {
      w1 = extrapolate_rn(y1n, q.lam_i, z1n);
      w2 = extrapolate_rn(y2n, q.lam_i, z2n);
      tS[k * TILE + j] = __fadd_rn(
          __fadd_rn(__fmul_rn(d1, w1), __fmul_rn(d2, w2)), tS[k * TILE + j]);
      tR[k * TILE + j] = bf16r(tS[k * TILE + j]);
    } else {
      w1 = y1n + q.lam_i * z1n;
      w2 = y2n + q.lam_i * z2n;
      tS[k * TILE + j] = d1 * w1 + d2 * w2 + tS[k * TILE + j];
    }
    if (wout) {
      wout[r * D + k] = w1;
      wout[r * D + nx + k] = w2;
    }
  }
  clock_mark(P_X);
  // the dual update of the u block, the extrapolation and g wp
  for (int idx = threadIdx.x; idx < TILE * nu; idx += blockDim.x) {
    const int j = idx / nu, k = idx - j * nu;
    float gw = 0.f;
    if (j < nt) {
      const size_t r = row0 + j;
      const size_t og = r * nu + k;
      const int l = j * nu + k;
      const float sqv = o.f[O1_SQ][j];
      const float yv = o.f[O1_YP][l], zv = o.f[O1_ZP][l];
      const float pr = o.f[O1_PP][l];
      float rp, ypn;
      if constexpr (BF16) {
        rp = residual_rn(pr, o.f[O1_BUMIN][k] * sqv, o.f[O1_BUMAX][k] * sqv,
                         1.f, c, extrapolate_rn(yv, q.lam_prev, zv));
        ypn = update_rn(yv, zv, rp, q, step);
      } else {
        const float wpp = yv + q.lam_prev * zv;
        rp = residual(pr, o.f[O1_BUMIN][k] * sqv, o.f[O1_BUMAX][k] * sqv,
                      1.f, c * wpp);
        ypn = yv + q.upd * (q.lam_prev * zv + step * rp);
      }
      const float zpn = ypn - yv;
      p.y_psi[og] = ypn;
      p.z_psi[og] = zpn;
      h.hp = fmaxf(h.hp, rp);
      h.lp = fminf(h.lp, rp);
      const float wp = BF16 ? extrapolate_rn(ypn, q.lam_i, zpn)
                            : ypn + q.lam_i * zpn;
      if (wout) wout[r * D + 2 * nx + k] = wp;
      gw = operand<BF16>((o.f[O1_CU][k] * sqv) * wp);
    }
    gS[k * TILE + j] = gw;
  }
  // inner = beta + a + Bb t + L'(g wp), summed in that order (beta + a
  // here, so that the buffer is free once this pass has read it); it is
  // the next stage's a.  Slots vary fastest: no bank conflicts on aS.
  for (int idx = threadIdx.x; idx < nt * nv; idx += blockDim.x) {
    const int cc = idx / nt, j = idx - cc * nt;
    aS[cc * TILE + j] = o.f[O1_BETA][j * nv + cc] + aS[cc * TILE + j];
  }
  if (threadIdx.x < nt) nhpS[threadIdx.x] = o.f[O1_NHP][threadIdx.x];
  __syncthreads();
  clock_mark(P_U);
  // the next stage's operands, into the buffer this stage no longer
  // reads, by the last warp, which the products at config 5 leave idle
  if (NBUF && s_next >= 0 && threadIdx.x >= blockDim.x - 32)
    bulk_fill(barrier_of<NBUF>(sg, s_next), [&](auto f) {
      k1_visit(p, s_next, i0, nt, buffer<NBUF>(sg, s_next), f);
    });
  // Both products give a thread the same (c, slots), so the second reads
  // what the first wrote without a barrier.
  tile_product<STAGED>(BF16 ? tR : tS, BbT, nx, nv,
                       [&](int cc, int j, float acc) {
    aS[cc * TILE + j] = j < nt ? aS[cc * TILE + j] + acc : 0.f;
  });
  clock_mark(P_BBT);
  tile_product<STAGED>(gS, L, nu, nv, [&](int cc, int j, float acc) {
    aS[cc * TILE + j] += acc;
    if (BF16) aR[cc * TILE + j] = bf16r(aS[cc * TILE + j]);
  });
  __syncthreads();
  clock_mark(P_L);
  // v = nhp * iW inner
  tile_product<STAGED>(BF16 ? aR : aS, iWT, nv, nv,
                       [&](int cc, int j, float acc) {
    const float v = j < nt ? nhpS[j] * acc : 0.f;
    if (j < nt) p.v[(row0 + j) * nv + cc] = v;
    if (vkeep) vkeep[cc * TILE + j] = operand<BF16>(v);
  });
  clock_mark(P_IWT);
  // the next stage writes tS, gS and, after its first barrier, aS
}

// A K1 range's starting carries for the block's tile, into tS (t) and
// aS (a), by the first `team` threads: each slot's is the sum over its
// parent's child slots (aggregation `gather`) of the exit carries qin,
// in the order of the index list; -1: zero.  The first KIDS child slots
// of each slot's parent (and their count) go to kidS first, so that each
// (slot, feature) issues its loads at once, GATHER of them a thread.
// BF16: each child's carry is rounded before it is added and the sum
// after (the TPU kernel's one-hot products at one bf16 pass).
template <bool BF16>
__device__ __forceinline__ void gather_carries(const Args& p, int gather,
                                               int i0, int nt, int W,
                                               const float* __restrict__ qin,
                                               float* tS, float* aS,
                                               int* kidS, int team) {
  const int nx = p.nx, ns = p.ns;
  for (int idx = threadIdx.x; gather >= 0 && idx < nt * KIDS; idx += team) {
    const int j = idx / KIDS, t = idx - j * KIDS;
    const int par = p.agg_parent[(size_t)gather * ns + i0 + j];
    const int m0 = p.agg_ptr[par], m1 = p.agg_ptr[par + 1];
    if (t == 0) kidS[j * (KIDS + 2)] = m0;
    if (t == 0) kidS[j * (KIDS + 2) + 1] = m1;
    if (t < m1 - m0) kidS[j * (KIDS + 2) + 2 + t] = p.agg_idx[m0 + t];
  }
  named_barrier(1, team);
  for (int base = threadIdx.x; base < TILE * W; base += GATHER * team) {
    float val[GATHER][KIDS];
#pragma unroll
    for (int b = 0; b < GATHER; ++b) {
      const int idx = base + b * team;
      const int j = idx / W, k = idx - j * W;
      if (gather < 0 || idx >= TILE * W || j >= nt) continue;
      const int* kid = kidS + j * (KIDS + 2);
      const int n0 = min(KIDS, kid[1] - kid[0]);
#pragma unroll
      for (int t = 0; t < KIDS; ++t)
        if (t < n0) val[b][t] = qin[(size_t)kid[2 + t] * W + k];
    }
#pragma unroll
    for (int b = 0; b < GATHER; ++b) {
      const int idx = base + b * team;
      const int j = idx / W, k = idx - j * W;
      if (idx >= TILE * W) continue;
      float acc = 0.f;
      if (gather >= 0 && j < nt) {
        const int* kid = kidS + j * (KIDS + 2);
        const int m0 = kid[0], m1 = kid[1];
        const int n0 = min(KIDS, m1 - m0);
#pragma unroll
        for (int t = 0; t < KIDS; ++t)
          if (t < n0) acc += operand<BF16>(val[b][t]);
        for (int m = m0 + KIDS; m < m1; ++m)
          acc += operand<BF16>(qin[(size_t)p.agg_idx[m] * W + k]);
        acc = operand<BF16>(acc);
      }
      if (k < nx)
        tS[k * TILE + j] = acc;
      else
        aS[(k - nx) * TILE + j] = acc;
    }
  }
}

// K1 over stages s_hi .. s_lo (descending) for the block's tile, its
// carries and product operands in `work`, the matrices, buffers and
// barriers in `sg` (staged: the matrices copied there first when
// `copy_mats`, with the first stage's operands, while the handoff gather
// runs).  gather >= 0: the carries start as the child -> parent sums of
// prefix aggregation `gather`, over the exit carries of the previous
// range; -1: they start at zero.  Writes y', z', v (and w, v's tile, as
// k1_stage), its exit carries (buffer launch & 1) and its champion
// partials (row launch * nblocks + block).
template <bool STAGED, int NBUF, bool BF16>
__device__ __forceinline__ void k1_range(const Args& p, const Scalars& q,
                                         int s_hi, int s_lo, int gather,
                                         int launch, float* work,
                                         Staging& sg, bool copy_mats,
                                         float* red, float* nhpS,
                                         int* kidS, float* wout,
                                         float* vkeep) {
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns;
  float* tS = work;              // (nx, TILE) t
  float* aS = tS + nx * TILE;    // (nv, TILE) a, inner
  float* gS = aS + nv * TILE;    // (nu, TILE) g * wp
  float* tR = gS + nu * TILE;    // BF16: (nx, TILE) t rounded
  float* aR = tR + nx * TILE;    // BF16: (nv, TILE) inner rounded
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);
  const int W = nx + nv;
  clock_mark(-1);
  const float* M[3];
  const float* at[3];
  int n[3];
  k1_matrices(p, M, n);
  mats_at<STAGED>(sg.mats, M, n, 3, at);
  const float* __restrict__ qin =
      p.carry + (size_t)((launch + 1) & 1) * ns * W;
  float* qout = p.carry + (size_t)(launch & 1) * ns * W;
  // The last warp issues the copies (its issue waits on the copy engine
  // for about as long as they take) while the others gather the carries,
  // synchronised among themselves by a named barrier; the first stage's
  // barrier joins them.
  const int team = blockDim.x - 32;
  if (threadIdx.x >= team) {
    if (NBUF)
      bulk_fill(barrier_of<NBUF>(sg, s_hi), [&](auto f) {
        if (copy_mats) mats_visit(sg.mats, M, n, 3, f);
        k1_visit(p, s_hi, i0, nt, buffer<NBUF>(sg, s_hi), f);
      });
  } else {
    gather_carries<BF16>(p, gather, i0, nt, W, qin, tS, aS, kidS, team);
  }
  clock_mark(P_K1_START);

  Champ h = {-inf(), inf(), -inf(), inf()};
  for (int s = s_hi; s >= s_lo; --s)
    k1_stage<STAGED, NBUF, BF16>(
        p, q, s, s > s_lo ? s - 1 : -1, i0, nt, tS, aS, gS, tR, aR, nhpS,
        at[0], at[1], at[2], sg, h, wout,
        vkeep ? vkeep + (size_t)s * nv * TILE : nullptr);
  __syncthreads();

  for (int idx = threadIdx.x; idx < nt * W; idx += blockDim.x) {
    const int j = idx / W, k = idx - j * W;
    qout[(size_t)(i0 + j) * W + k] =
        k < nx ? tS[k * TILE + j] : aS[(k - nx) * TILE + j];
  }
  store_champion(h, red,
                 p.champ_part + 4 * ((size_t)launch * p.nblocks + blockIdx.x));
  clock_mark(P_K1_END);
}

// A launch's staging in its dynamic shared memory: after `first` floats
// (the fused kernel's v tiles and work area, or one kernel's work area),
// the matrices and the buffers; the barriers initialised (STAGED).
template <bool STAGED>
__device__ __forceinline__ Staging staging(float* smem, int first,
                                           int mats, int buf_floats,
                                           uint64_t* bars) {
  if (!STAGED) return {nullptr, nullptr, 0, nullptr, 0u};
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    fence_barrier_init();
  }
  __syncthreads();
  return {smem + first, smem + first + mats, buf_floats, bars, 0u};
}

template <bool STAGED, bool BF16>
__global__ void __launch_bounds__(THREADS)
k1_kernel(Args p, int s_hi, int s_lo, int gather, int launch) {
  extern __shared__ float4 smem4[];
  __shared__ float red[THREADS];
  __shared__ float nhpS[TILE];
  __shared__ int kidS[TILE * (KIDS + 2)];
  __shared__ uint64_t bars[2];
  float* smem = reinterpret_cast<float*>(smem4);
  Staging sg = staging<STAGED>(
      smem, k1_work_floats(p.nx, p.nu, p.nv, BF16),
      k1_mats_floats(p.nx, p.nu, p.nv), k1_buf_floats(p.nx, p.nu, p.nv),
      bars);
  k1_range<STAGED, STAGED ? 1 : 0, BF16>(p, given_scalars(p), s_hi, s_lo,
                                         gather, launch, smem, sg, true, red,
                                         nhpS, kidS, nullptr, nullptr);
}

// K2's stage s for the block's tile from vX, the stage's (nv, TILE) tile
// of v, and its operands `o`: u, x, the pre-images and the slots' squared
// distances into s1, s2.  du, u and x are carried in duS, uS (nu, TILE)
// and xS (nx, TILE).  w comes from the fused kernel's scratch (FUSED) or
// is rebuilt from y and z.  The caller's barrier precedes it; mid() runs
// between the two products.  BF16: vX holds v rounded, B u reads u
// rounded from uR (nu, TILE), and w is rebuilt as K1 stores it for the
// fused kernel (extrapolate_rn), so that both routes read the same w.
template <bool STAGED, bool FUSED, bool BF16, class Mid>
__device__ __forceinline__ void k2_stage(const Args& p, float lam_i, int s,
                                         int i0, int nt, float* duS,
                                         float* uS, float* uR, float* xS,
                                         const float* vX,
                                         const Ops<K2_OPS>& o,
                                         const float* LT, const float* BT,
                                         float* s1, float* s2, Mid mid) {
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns, D = 2 * nx + nu;
  const float c = p.c;
  const size_t row0 = (size_t)s * ns + i0;
  // du += L v, u = uhat + du
  tile_product<STAGED>(vX, LT, nv, nu, [&](int cc, int j, float acc) {
    const float du = duS[cc * TILE + j] + acc;
    duS[cc * TILE + j] = du;
    float uv = 0.f;
    if (j < nt) {
      uv = o.f[O2_UHAT][j * nu + cc] + du;
      p.u[(row0 + j) * nu + cc] = uv;
    }
    uS[cc * TILE + j] = uv;
    if (BF16) uR[cc * TILE + j] = bf16r(uv);
  });
  __syncthreads();
  clock_mark(P_LT);
  mid();
  // x = x_prev + e + B u
  tile_product<STAGED>(BF16 ? uR : uS, BT, nu, nx,
                       [&](int cc, int j, float acc) {
    if (j < nt) {
      const float xv = xS[cc * TILE + j] + o.f[O2_E][j * nx + cc] + acc;
      xS[cc * TILE + j] = xv;
      p.x[(row0 + j) * nx + cc] = xv;
    }
  });
  __syncthreads();
  clock_mark(P_BT);
  // the pre-images and the squared distances of the x blocks
  for (int idx = threadIdx.x; idx < nt * nx; idx += blockDim.x) {
    const int j = idx / nx, k = idx - j * nx;
    const size_t r = row0 + j;
    const size_t o1 = r * 2 * nx + k, o2 = o1 + nx;
    const int l1 = j * 2 * nx + k, l2 = l1 + nx;
    const float sqv = o.f[O2_SQ][j], xv = xS[k * TILE + j];
    const float w1 =
        FUSED  ? o.f[O2_W][j * D + k]
        : BF16 ? extrapolate_rn(o.f[O2_YX][l1], lam_i, o.f[O2_ZX][l1])
               : o.f[O2_YX][l1] + lam_i * o.f[O2_ZX][l1];
    const float w2 =
        FUSED  ? o.f[O2_W][j * D + nx + k]
        : BF16 ? extrapolate_rn(o.f[O2_YX][l2], lam_i, o.f[O2_ZX][l2])
               : o.f[O2_YX][l2] + lam_i * o.f[O2_ZX][l2];
    const float pre1 = (o.f[O2_CX1][k] * sqv) * xv + c * w1;
    const float pre2 = (o.f[O2_CX2][k] * sqv) * xv + c * w2;
    p.pre_xi[o1] = pre1;
    p.pre_xi[o2] = pre2;
    const float df1 = pre1 - clip(pre1, o.f[O2_BXMIN][k] * sqv,
                                  o.f[O2_BXMAX][k] * sqv);
    const float df2 = pre2 - clip(pre2, o.f[O2_BXS][k] * sqv, p.xs_upper);
    const float rv = o.f[O2_REP][j];
    *s1 += rv * df1 * df1;
    *s2 += rv * df2 * df2;
  }
  clock_mark(P_PRE_X);
  for (int idx = threadIdx.x; idx < nt * nu; idx += blockDim.x) {
    const int j = idx / nu, k = idx - j * nu;
    const int l = j * nu + k;
    const float wp =
        FUSED  ? o.f[O2_W][j * D + 2 * nx + k]
        : BF16 ? extrapolate_rn(o.f[O2_YP][l], lam_i, o.f[O2_ZP][l])
               : o.f[O2_YP][l] + lam_i * o.f[O2_ZP][l];
    p.pre_psi[(row0 + j) * nu + k] =
        (o.f[O2_CU][k] * o.f[O2_SQ][j]) * uS[k * TILE + j] + c * wp;
  }
  clock_mark(P_PRE_U);
}

// K2 over stages 0 .. N-1 for the block's tile, its carries and operands
// in `work`; v from vkeep (the (N, nv, TILE) tiles k1_stage kept; FUSED,
// with w from `win`) or from device memory; the matrices, NBUF buffers
// and barriers in `sg` (each stage's operands copied one stage ahead, the
// matrices with the first).  Its partial sums of the two squared
// distances into norm_part.  BF16: the products read v and u rounded.
template <bool STAGED, int NBUF, bool FUSED, bool BF16>
__device__ __forceinline__ void k2_all(const Args& p, float lam_i,
                                       float* work, Staging& sg, float* red,
                                       const float* vkeep,
                                       const float* win) {
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns;
  float* duS = work;             // (nu, TILE) du
  float* uS = duS + nu * TILE;   // (nu, TILE) u
  float* xS = uS + nu * TILE;    // (nx, TILE) x
  float* uR = xS + nx * TILE;    // BF16: (nu, TILE) u rounded
  // (nv, TILE) v, unless kept
  float* vS = uR + (BF16 ? nu * TILE : 0);
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);
  const float* M[2];
  const float* at[2];
  int n[2];
  k2_matrices(p, M, n);
  mats_at<STAGED>(sg.mats, M, n, 2, at);
  if (NBUF && threadIdx.x >= blockDim.x - 32)
    bulk_fill(barrier_of<NBUF>(sg, 0), [&](auto f) {
      mats_visit(sg.mats, M, n, 2, f);
      k2_visit<FUSED>(p, 0, i0, nt, buffer<NBUF>(sg, 0), win, f);
    });
  for (int idx = threadIdx.x; idx < nu * TILE; idx += blockDim.x)
    duS[idx] = p.pdu[idx / TILE];
  for (int idx = threadIdx.x; idx < nx * TILE; idx += blockDim.x)
    xS[idx] = p.x0[idx / TILE];
  float s1 = 0.f, s2 = 0.f;
  clock_mark(-1);
  for (int s = 0; s < p.N; ++s) {
    if (NBUF) {
      wait_buffer<NBUF>(sg, s);
      // every thread's operands have landed, and the last stage has read
      // the buffer the next copy overwrites
      __syncthreads();
    }
    clock_mark(P_K2_WAIT);
    const Ops<K2_OPS> o =
        k2_ops<NBUF, FUSED>(p, s, i0, buffer<NBUF>(sg, s), win);
    const float* vX = vS;
    if (FUSED) {
      vX = vkeep + (size_t)s * nv * TILE;
    } else {
      // the stage's v tile, feature-major (slots vary fastest: no bank
      // conflicts): the last stage's first product read vS before the
      // barriers that followed it
      for (int idx = threadIdx.x; idx < TILE * nv; idx += blockDim.x) {
        const int k = idx / TILE, j = idx - k * TILE;
        vS[k * TILE + j] =
            j < nt ? operand<BF16>(o.f[O2_V][j * nv + k]) : 0.f;
      }
    }
    // the last stage's pre-image pass reads uS and xS, which this stage's
    // products write
    __syncthreads();
    clock_mark(P_K2_LOAD);
    // the next stage's operands, into the buffer of the stage before
    // this one, while B u runs, by the last warp (idle there at config 5)
    k2_stage<STAGED, FUSED, BF16>(
        p, lam_i, s, i0, nt, duS, uS, uR, xS, vX, o, at[0], at[1], &s1, &s2,
        [&] {
          if (NBUF && s + 1 < p.N && threadIdx.x >= blockDim.x - 32)
            bulk_fill(barrier_of<NBUF>(sg, s + 1), [&](auto f) {
              k2_visit<FUSED>(p, s + 1, i0, nt, buffer<NBUF>(sg, s + 1),
                              win, f);
            });
        });
  }
  s1 = block_reduce<THREADS>(s1, red, Add());
  s2 = block_reduce<THREADS>(s2, red, Add());
  if (threadIdx.x == 0) {
    p.norm_part[2 * blockIdx.x] = s1;
    p.norm_part[2 * blockIdx.x + 1] = s2;
  }
  clock_mark(P_K2_END);
}

// K2 over stages 0 .. N-1 for the block's TILE slots: u, x, the
// pre-images and the block's partial sums of the two squared distances.
template <bool STAGED, bool BF16>
__global__ void __launch_bounds__(THREADS) k2_kernel(Args p) {
  extern __shared__ float4 smem4[];
  __shared__ float red[THREADS];
  __shared__ uint64_t bars[2];
  float* smem = reinterpret_cast<float*>(smem4);
  Staging sg = staging<STAGED>(
      smem, k2_work_floats(p.nx, p.nu, p.nv, BF16),
      k2_mats_floats(p.nx, p.nu, p.nv),
      k2_buf_floats(p.nx, p.nu, p.nv, false), bars);
  k2_all<STAGED, STAGED ? 2 : 0, false, BF16>(p, p.sc[1], smem, sg, red,
                                              nullptr, nullptr);
}

// The K1 ranges of one iteration, passed by value to the fused kernel:
// (first stage, last stage, aggregation read at the start or -1).
constexpr int MAX_RANGES = 32;
struct Ranges {
  int n;
  int r[3 * MAX_RANGES];
};

// The fused kernel's work area: the larger of K1's and of K2's without
// its v tile (v is kept).
__host__ __device__ inline int fused_work_floats(int nx, int nu, int nv,
                                                 bool bf16) {
  const int k1 = k1_work_floats(nx, nu, nv, bf16);
  const int k2 = k2_work_floats(nx, nu, nv, bf16) - nv * TILE;
  return k1 > k2 ? k1 : k2;
}
__host__ __device__ inline int fused_mats_floats(int nx, int nu, int nv) {
  const int k1 = k1_mats_floats(nx, nu, nv);
  const int k2 = k2_mats_floats(nx, nu, nv);
  return k1 > k2 ? k1 : k2;
}
// K1's one buffer or K2's two.
__host__ __device__ inline int fused_bufs_floats(int nx, int nu, int nv) {
  const int k1 = k1_buf_floats(nx, nu, nv);
  const int k2 = 2 * k2_buf_floats(nx, nu, nv, true);
  return k1 > k2 ? k1 : k2;
}

// One whole iteration in one cooperative launch of nblocks blocks, each
// on its tile for every stage: the scalars, K1 over every range with a
// grid barrier at each prefix handoff, then K2, which reads w from the
// device scratch `w` and v from the (N, nv, TILE) tiles K1 kept in
// shared memory.  derive: the scalars come from the counter and the last
// iteration's partials, reduced by every block in the scalar phase's
// order (so every block gets the same bits), and block 0 writes the
// trace entry and moves the counter on once every block has read them;
// else they are sc's, and the counter and the trace stay as they are.
// Two carry buffers alternate between ranges, so one barrier a handoff
// suffices: a block writes a buffer only after every block has passed
// the barrier behind the gather that last read it.  Staged, K1's
// matrices stay in shared memory over its ranges (one operand buffer),
// then K2's take their place (two buffers).  BF16: the tiles of v are
// kept rounded, as K2's product reads them.
template <bool STAGED, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_kernel(Args p, Ranges rg, float* w, int derive) {
  extern __shared__ float4 smem4[];
  __shared__ float red[THREADS];
  __shared__ float nhpS[TILE];
  __shared__ int kidS[TILE * (KIDS + 2)];
  __shared__ uint64_t bars[2];
  cg::grid_group grid = cg::this_grid();
  float* vkeep = reinterpret_cast<float*>(smem4);
  float* work = vkeep + (size_t)p.N * p.nv * TILE;
  const int nx = p.nx, nu = p.nu, nv = p.nv;
  Staging sg = staging<STAGED>(work, fused_work_floats(nx, nu, nv, BF16),
                               fused_mats_floats(nx, nu, nv),
                               k1_buf_floats(nx, nu, nv), bars);
  Scalars q;
  if (derive) {
    const int it = *p.ctr;
    float s1, s2, ch;
    reduce_partials<THREADS>(p, it > 0, blockIdx.x == 0 && it >= 2,
                             rg.n * p.nblocks, red, &s1, &s2, &ch);
    q = scalars_of(p, it, s1, s2);
    // every block has read the counter and the partials this launch
    // overwrites
    grid.sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      if (it >= 2) p.trace[it - 2] = ch;
      *p.ctr = it + 1;
    }
  } else {
    q = given_scalars(p);
  }
  for (int k = 0; k < rg.n; ++k) {
    // the previous range's exit carries, which this range's gather
    // reads, are written by every block
    if (k > 0) grid.sync();
    const int* r = rg.r + 3 * k;
    k1_range<STAGED, STAGED ? 1 : 0, BF16>(p, q, r[0], r[1], r[2], k, work,
                                           sg, k == 0, red, nhpS, kidS, w,
                                           vkeep);
  }
  // no grid barrier: each block's forward pass reads only its own slots.
  // The w rows this block stored are read by the copy engine, and K2's
  // copies overwrite what K1's products read.
  if (STAGED) fence_proxy_global();
  __syncthreads();
  sg.buf_floats = STAGED ? k2_buf_floats(nx, nu, nv, true) : 0;
  k2_all<STAGED, STAGED ? 2 : 0, true, BF16>(p, q.lam_i, work, sg, red,
                                             vkeep, w);
}

// The final dual update (the tail of pallas_stream.py:629-660, XLA there):
// y = w + step r with w = y + lam z, lam = lams[max_it - 1], and the
// champion partials of that last residual, one block per (tile, stage).
__global__ void __launch_bounds__(THREADS) tail_kernel(Args p) {
  __shared__ float red[THREADS];
  const int nx = p.nx, nu = p.nu, ns = p.ns, s = blockIdx.y;
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);
  const float lam = p.sc[0], k1f = p.sc[3], k2f = p.sc[4], c = p.c;
  const size_t row0 = (size_t)s * ns + i0;
  float hx = -inf(), lx = inf(), hp = -inf(), lp = inf();
  for (int idx = threadIdx.x; idx < nt * 2 * nx; idx += blockDim.x) {
    const int j = idx / (2 * nx), k = idx - j * 2 * nx;
    const size_t r = row0 + j, o = r * 2 * nx + k;
    const bool first = k < nx;
    const size_t sk = (size_t)s * nx + (first ? k : k - nx);
    const float sqv = p.sq[r], pr = p.pre_xi[o];
    const float w = p.y_xi[o] + lam * p.z_xi[o];
    const float res =
        first ? residual(pr, p.bx_min[sk] * sqv, p.bx_max[sk] * sqv,
                         1.f - k1f, c * w)
              : residual(pr, p.bx_s[sk] * sqv, p.xs_upper, 1.f - k2f, c * w);
    p.y_xi[o] = w + p.step * res;
    hx = fmaxf(hx, res);
    lx = fminf(lx, res);
  }
  for (int idx = threadIdx.x; idx < nt * nu; idx += blockDim.x) {
    const int j = idx / nu, k = idx - j * nu;
    const size_t r = row0 + j, o = r * nu + k, sk = (size_t)s * nu + k;
    const float sqv = p.sq[r], pr = p.pre_psi[o];
    const float w = p.y_psi[o] + lam * p.z_psi[o];
    const float res =
        residual(pr, p.bu_min[sk] * sqv, p.bu_max[sk] * sqv, 1.f, c * w);
    p.y_psi[o] = w + p.step * res;
    hp = fmaxf(hp, res);
    lp = fminf(lp, res);
  }
  store_champion({hx, lx, hp, lp}, red,
                 p.champ_part + 4 * ((size_t)s * gridDim.x + blockIdx.x));
}

#define SK_TRY(expr)                                 \
  do {                                               \
    const cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return err_;            \
  } while (0)

// Which variant each kernel launches (staged: its matrices and operand
// buffers in shared memory) and the dynamic shared memory it asks for.
struct Plan {
  bool k1_staged, k2_staged;
  size_t smem_k1, smem_k2;
  const int* ranges;   // (first stage, last stage, gather) per K1 launch
  int n_ranges;
};

// K1: one launch per range of stages.
template <bool BF16>
cudaError_t enqueue_k1(const Args& p, const Plan& pl, cudaStream_t st) {
  for (int k = 0; k < pl.n_ranges; ++k) {
    const int* r = pl.ranges + 3 * k;
    if (pl.k1_staged)
      k1_kernel<true, BF16><<<p.nblocks, THREADS, pl.smem_k1, st>>>(
          p, r[0], r[1], r[2], k);
    else
      k1_kernel<false, BF16><<<p.nblocks, THREADS, pl.smem_k1, st>>>(
          p, r[0], r[1], r[2], k);
    SK_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

template <bool BF16>
cudaError_t enqueue_k2(const Args& p, const Plan& pl, cudaStream_t st) {
  if (pl.k2_staged)
    k2_kernel<true, BF16><<<p.nblocks, THREADS, pl.smem_k2, st>>>(p);
  else
    k2_kernel<false, BF16><<<p.nblocks, THREADS, pl.smem_k2, st>>>(p);
  return cudaGetLastError();
}

// One iteration: the scalars, K1's launches and K2.
template <bool BF16>
cudaError_t enqueue_iteration(const Args& p, const Plan& pl,
                              cudaStream_t st) {
  scalars_kernel<<<1, SCALAR_THREADS, 0, st>>>(p, pl.n_ranges * p.nblocks,
                                               1);
  SK_TRY(cudaGetLastError());
  SK_TRY(enqueue_k1<BF16>(p, pl, st));
  return enqueue_k2<BF16>(p, pl, st);
}

// After the last iteration: the scalars, the tail, and the trace entry of
// the tail's champion.
cudaError_t enqueue_tail(const Args& p, const Plan& pl, cudaStream_t st) {
  scalars_kernel<<<1, SCALAR_THREADS, 0, st>>>(p, pl.n_ranges * p.nblocks,
                                               1);
  SK_TRY(cudaGetLastError());
  tail_kernel<<<dim3(p.nblocks, p.N), THREADS, 0, st>>>(p);
  SK_TRY(cudaGetLastError());
  scalars_kernel<<<1, SCALAR_THREADS, 0, st>>>(p, p.N * p.nblocks, 0);
  return cudaGetLastError();
}

// Replays `enqueue` (one iteration's launches) max_it times on `st`: one
// captured graph launched max_it times (a cooperative launch captures
// too, CUDA 12).
template <class Enqueue>
cudaError_t replay(const Args& p, cudaStream_t st, Enqueue enqueue) {
  cudaStream_t cs;
  SK_TRY(cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking));
  cudaGraph_t g = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaError_t err =
      cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    const cudaError_t enq = enqueue(cs);
    err = cudaStreamEndCapture(cs, &g);
    if (enq != cudaSuccess) err = enq;
    if (err == cudaSuccess) err = cudaGraphInstantiateWithFlags(&exec, g, 0);
  }
  const cudaError_t err2 = cudaStreamDestroy(cs);
  for (int it = 0; it < p.max_it && err == cudaSuccess; ++it)
    err = cudaGraphLaunch(exec, st);
  // in-flight launches complete before the executable is freed
  if (exec) cudaGraphExecDestroy(exec);
  if (g) cudaGraphDestroy(g);
  SK_TRY(err);
  return err2;
}

// The whole solve: the counter reset, max_it replays of one captured
// iteration, then the tail.
template <bool BF16>
cudaError_t run_solve(const Args& p, const Plan& pl, cudaStream_t st) {
  SK_TRY(cudaMemsetAsync(p.ctr, 0, sizeof(int), st));
  SK_TRY(replay(p, st, [&](cudaStream_t s) {
    return enqueue_iteration<BF16>(p, pl, s);
  }));
  return enqueue_tail(p, pl, st);
}

// Dynamic shared memory of the unstaged K1 and K2 (bytes): the launch's
// and, through apg_stream_smem (apg_stream_bf16_smem), the routing gate's
// one formula.
size_t smem_k1(int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * (size_t)k1_work_floats(nx, nu, nv, bf16);
}
size_t smem_k2(int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * (size_t)k2_work_floats(nx, nu, nv, bf16);
}
// The unstaged fused kernel's: the (N, nv, TILE) tiles of v beside the
// larger of K1's work and K2's without its v tile.
size_t smem_fused(int N, int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * ((size_t)N * nv * TILE +
                          fused_work_floats(nx, nu, nv, bf16));
}
// The staged variants' (bytes): the work areas, the matrices and the
// operand buffers (one for K1, two for K2; the fused kernel K1's one,
// then K2's two, in one place).
size_t staged_k1(int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * ((size_t)k1_work_floats(nx, nu, nv, bf16) +
                          k1_mats_floats(nx, nu, nv) +
                          k1_buf_floats(nx, nu, nv));
}
size_t staged_k2(int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * ((size_t)k2_work_floats(nx, nu, nv, bf16) +
                          k2_mats_floats(nx, nu, nv) +
                          2 * (size_t)k2_buf_floats(nx, nu, nv, false));
}
size_t staged_fused(int N, int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * ((size_t)N * nv * TILE +
                          fused_work_floats(nx, nu, nv, bf16) +
                          fused_mats_floats(nx, nu, nv) +
                          fused_bufs_floats(nx, nu, nv));
}

cudaError_t set_smem(const void* kernel, size_t bytes, int max_optin) {
  if (bytes > (size_t)max_optin) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

// Whether `kernel` with `bytes` of dynamic shared memory beside its
// static shared memory stays within the device's opt-in limit.
cudaError_t smem_fits(const void* kernel, size_t bytes, int max_optin,
                      bool* fits) {
  cudaFuncAttributes a;
  SK_TRY(cudaFuncGetAttributes(&a, kernel));
  *fits = a.sharedSizeBytes + bytes <= (size_t)max_optin;
  return cudaSuccess;
}

// K1's and K2's variants at these sizes: staged where it fits, else the
// same stage bodies with the matrices and operands read from device
// memory; their shared memory set.
template <bool BF16>
cudaError_t plan_stream(int nx, int nu, int nv, int max_optin, Plan* pl) {
  SK_TRY(smem_fits((const void*)k1_kernel<true, BF16>,
                   staged_k1(nx, nu, nv, BF16), max_optin, &pl->k1_staged));
  SK_TRY(smem_fits((const void*)k2_kernel<true, BF16>,
                   staged_k2(nx, nu, nv, BF16), max_optin, &pl->k2_staged));
  pl->smem_k1 = pl->k1_staged ? staged_k1(nx, nu, nv, BF16)
                              : smem_k1(nx, nu, nv, BF16);
  pl->smem_k2 = pl->k2_staged ? staged_k2(nx, nu, nv, BF16)
                              : smem_k2(nx, nu, nv, BF16);
  SK_TRY(set_smem(pl->k1_staged ? (const void*)k1_kernel<true, BF16>
                                : (const void*)k1_kernel<false, BF16>,
                  pl->smem_k1, max_optin));
  return set_smem(pl->k2_staged ? (const void*)k2_kernel<true, BF16>
                                : (const void*)k2_kernel<false, BF16>,
                  pl->smem_k2, max_optin);
}

// Whether the fused kernel's variant (staged, with `smem` bytes) runs
// every block of the grid at once.
template <bool BF16>
cudaError_t fused_resident(bool staged, size_t smem, int nblocks, int sms,
                           bool* resident) {
  int per_sm = 0;
  SK_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, staged ? fused_kernel<true, BF16> : fused_kernel<false, BF16>,
      THREADS, smem));
  *resident = (long long)per_sm * sms >= nblocks;
  return cudaSuccess;
}

// The fused kernel's variant: staged where its shared memory fits and
// every block stays resident, else unstaged; its shared memory set.
// Refuses a tree whose v tiles pass the shared memory
// (cudaErrorInvalidValue) and a grid whose blocks cannot all be resident
// (cudaErrorCooperativeLaunchTooLarge).
template <bool BF16>
cudaError_t plan_fused(int N, int nx, int nu, int nv, int nblocks,
                       int max_optin, int sms, bool* staged, size_t* smem) {
  *smem = staged_fused(N, nx, nu, nv, BF16);
  SK_TRY(smem_fits((const void*)fused_kernel<true, BF16>, *smem, max_optin,
                   staged));
  bool resident = false;
  if (*staged) {
    SK_TRY(set_smem((const void*)fused_kernel<true, BF16>, *smem,
                    max_optin));
    SK_TRY(fused_resident<BF16>(true, *smem, nblocks, sms, &resident));
    *staged = resident;
  }
  if (!*staged) {
    *smem = smem_fused(N, nx, nu, nv, BF16);
    SK_TRY(set_smem((const void*)fused_kernel<false, BF16>, *smem,
                    max_optin));
    SK_TRY(fused_resident<BF16>(false, *smem, nblocks, sms, &resident));
  }
  return resident ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

// One cooperative launch of the fused kernel.
template <bool BF16>
cudaError_t launch_fused(const Args& p, const Ranges& rg, float* w,
                         int derive, bool staged, size_t smem,
                         cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nblocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (staged)
    return cudaLaunchKernelEx(&cfg, fused_kernel<true, BF16>, p, rg, w,
                              derive);
  return cudaLaunchKernelEx(&cfg, fused_kernel<false, BF16>, p, rg, w,
                            derive);
}

Args make_args(
    const float* cx1, const float* cx2, const float* cu, const float* bx_min,
    const float* bx_max, const float* bx_s, const float* bu_min,
    const float* bu_max, const float* sq, const float* nhp, const float* rep,
    const float* L, const float* BbT, const float* iWT, const float* LT,
    const float* BT, const float* lams, const int* agg_parent,
    const int* agg_ptr, const int* agg_idx, const float* beta,
    const float* uhat, const float* e, const float* x0, const float* pdu,
    float* y_xi, float* y_psi, float* z_xi, float* z_psi, float* pre_xi,
    float* pre_psi, float* v, float* x, float* u, float* carry,
    float* norm_part, float* champ_part, float* sc, float* trace, int* ctr,
    int N, int ns, int nx, int nu, int nv, int max_it, float c, float step,
    float t1c, float t2c, float xs_upper) {
  Args p;
  p.N = N; p.ns = ns; p.nx = nx; p.nu = nu; p.nv = nv;
  p.nblocks = (ns + TILE - 1) / TILE;
  p.max_it = max_it;
  p.c = c; p.step = step; p.t1c = t1c; p.t2c = t2c; p.xs_upper = xs_upper;
  p.cx1 = cx1; p.cx2 = cx2; p.cu = cu; p.bx_min = bx_min; p.bx_max = bx_max;
  p.bx_s = bx_s; p.bu_min = bu_min; p.bu_max = bu_max;
  p.sq = sq; p.nhp = nhp; p.rep = rep;
  p.L = L; p.BbT = BbT; p.iWT = iWT; p.LT = LT; p.BT = BT; p.lams = lams;
  p.agg_parent = agg_parent; p.agg_ptr = agg_ptr; p.agg_idx = agg_idx;
  p.beta = beta; p.uhat = uhat; p.e = e; p.x0 = x0; p.pdu = pdu;
  p.y_xi = y_xi; p.y_psi = y_psi; p.z_xi = z_xi; p.z_psi = z_psi;
  p.pre_xi = pre_xi; p.pre_psi = pre_psi; p.v = v; p.x = x; p.u = u;
  p.carry = carry; p.norm_part = norm_part; p.champ_part = champ_part;
  p.sc = sc; p.trace = trace; p.ctr = ctr;
  return p;
}

cudaError_t device_limits(int* max_optin, int* sms) {
  int dev = 0;
  SK_TRY(cudaGetDevice(&dev));
  SK_TRY(cudaDeviceGetAttribute(max_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (sms) SK_TRY(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                         dev));
  return cudaSuccess;
}

}  // namespace

// The argument list of both C entries, up to the mode.
#define APG_STREAM_ARGS                                                    \
  const float *cx1, const float *cx2, const float *cu,                     \
      const float *bx_min, const float *bx_max, const float *bx_s,         \
      const float *bu_min, const float *bu_max, const float *sq,           \
      const float *nhp, const float *rep, const float *L, const float *BbT, \
      const float *iWT, const float *LT, const float *BT,                  \
      const float *lams, const int *agg_parent, const int *agg_ptr,        \
      const int *agg_idx, const float *beta, const float *uhat,            \
      const float *e, const float *x0, const float *pdu, float *y_xi,      \
      float *y_psi, float *z_xi, float *z_psi, float *pre_xi,              \
      float *pre_psi, float *v, float *x, float *u, float *carry,          \
      float *norm_part, float *champ_part, float *sc, float *trace,        \
      int *ctr
#define APG_STREAM_ARG_NAMES                                               \
  cx1, cx2, cu, bx_min, bx_max, bx_s, bu_min, bu_max, sq, nhp, rep, L,     \
      BbT, iWT, LT, BT, lams, agg_parent, agg_ptr, agg_idx, beta, uhat, e, \
      x0, pdu, y_xi, y_psi, z_xi, z_psi, pre_xi, pre_psi, v, x, u, carry,  \
      norm_part, champ_part, sc, trace, ctr

namespace {

// The two-kernel iteration's entry (apg_stream, apg_stream_bf16), BF16
// the products' precision.
template <bool BF16>
int stream_entry(APG_STREAM_ARGS, int N, int ns, int nx, int nu, int nv,
                 int max_it, const int* ranges, int n_ranges, float c,
                 float step, float t1c, float t2c, float xs_upper, int mode,
                 void* stream) {
  if (N < 1 || N > 65535 || ns < 1 || max_it < 1 || n_ranges < 1)
    return cudaErrorInvalidValue;
  const Args p = make_args(APG_STREAM_ARG_NAMES, N, ns, nx, nu, nv, max_it,
                           c, step, t1c, t2c, xs_upper);
  Plan pl;
  pl.ranges = ranges;
  pl.n_ranges = n_ranges;
  int max_optin = 0;
  SK_TRY(device_limits(&max_optin, nullptr));
  SK_TRY(plan_stream<BF16>(nx, nu, nv, max_optin, &pl));

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1) return enqueue_k1<BF16>(p, pl, st);
  if (mode == 2) return enqueue_k2<BF16>(p, pl, st);
  if (mode != 0) return cudaErrorInvalidValue;
  return run_solve<BF16>(p, pl, st);
}

// The fused iteration's entry (apg_stream_fused, apg_stream_fused_bf16).
template <bool BF16>
int fused_entry(APG_STREAM_ARGS, float* w, int N, int ns, int nx, int nu,
                int nv, int max_it, const int* ranges, int n_ranges, float c,
                float step, float t1c, float t2c, float xs_upper, int mode,
                void* stream) {
  if (N < 1 || N > 65535 || ns < 1 || max_it < 1 || n_ranges < 1 ||
      n_ranges > MAX_RANGES)
    return cudaErrorInvalidValue;
  const Args p = make_args(APG_STREAM_ARG_NAMES, N, ns, nx, nu, nv, max_it,
                           c, step, t1c, t2c, xs_upper);
  Plan pl;
  pl.ranges = ranges;
  pl.n_ranges = n_ranges;
  Ranges rg;
  rg.n = n_ranges;
  for (int k = 0; k < 3 * n_ranges; ++k) rg.r[k] = ranges[k];
  int max_optin = 0, sms = 0, dev = 0, coop = 0;
  SK_TRY(device_limits(&max_optin, &sms));
  SK_TRY(cudaGetDevice(&dev));
  SK_TRY(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;
  bool staged = false;
  size_t smem = 0;
  SK_TRY(plan_fused<BF16>(N, nx, nu, nv, p.nblocks, max_optin, sms, &staged,
                          &smem));
  SK_TRY(plan_stream<BF16>(nx, nu, nv, max_optin, &pl));   // the tail's

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1) return launch_fused<BF16>(p, rg, w, 0, staged, smem, st);
  if (mode != 0) return cudaErrorInvalidValue;
  SK_TRY(cudaMemsetAsync(p.ctr, 0, sizeof(int), st));
  SK_TRY(replay(p, st, [&](cudaStream_t s) {
    return launch_fused<BF16>(p, rg, w, 1, staged, smem, s);
  }));
  return enqueue_tail(p, pl, st);
}

// Which variants a launch at these sizes takes (apg_stream_staged).
template <bool BF16>
int staged_mask(int N, int ns, int nx, int nu, int nv) {
  int max_optin = 0, sms = 0;
  cudaError_t err = device_limits(&max_optin, &sms);
  Plan pl;
  if (err == cudaSuccess) err = plan_stream<BF16>(nx, nu, nv, max_optin, &pl);
  if (err != cudaSuccess) return -(int)err;
  bool fused = false;
  size_t smem = 0;
  err = plan_fused<BF16>(N, nx, nu, nv, (ns + TILE - 1) / TILE, max_optin,
                         sms, &fused, &smem);
  if (err != cudaSuccess) fused = false;
  return (int)pl.k1_staged | (int)pl.k2_staged << 1 | (int)fused << 2;
}

long long stream_smem(int nx, int nu, int nv, bool bf16) {
  const size_t k1 = smem_k1(nx, nu, nv, bf16), k2 = smem_k2(nx, nu, nv, bf16);
  return (long long)(k1 > k2 ? k1 : k2);
}

long long staged_smem(int N, int nx, int nu, int nv, int kernel, bool bf16) {
  return (long long)(kernel == 0   ? staged_k1(nx, nu, nv, bf16)
                     : kernel == 1 ? staged_k2(nx, nu, nv, bf16)
                                   : staged_fused(N, nx, nu, nv, bf16));
}

}  // namespace

// mode 0: the whole solve of max_it iterations and the tail; the caller
// fills y_xi/y_psi with the warm start, zeroes z, the pre-images and the
// trace, and reads x, u, v, y and the trace after the stream has run.
// mode 1: one K1 pass (every range of stages), mode 2: one K2 pass, from
// the state and the scalars (sc[0..4]) the caller put in place; K1 leaves
// its champion partials in champ_part (row launch * nblocks + block), K2
// its squared-distance partials in norm_part.  Enqueued on `stream`
// without synchronising.  Returns a cudaError_t (0 on success).  The
// products in full float32 (stream_precision "highest").
extern "C" int apg_stream(APG_STREAM_ARGS, int N, int ns, int nx, int nu,
                          int nv, int max_it, const int* ranges,
                          int n_ranges, float c, float step, float t1c,
                          float t2c, float xs_upper, int mode,
                          void* stream) {
  return stream_entry<false>(APG_STREAM_ARG_NAMES, N, ns, nx, nu, nv, max_it,
                             ranges, n_ranges, c, step, t1c, t2c, xs_upper,
                             mode, stream);
}

// apg_stream with one bf16 pass a product (stream_precision "default"):
// the caller passes L, BbT, iWT, LT and BT rounded to bfloat16.
extern "C" int apg_stream_bf16(APG_STREAM_ARGS, int N, int ns, int nx,
                               int nu, int nv, int max_it,
                               const int* ranges, int n_ranges, float c,
                               float step, float t1c, float t2c,
                               float xs_upper, int mode, void* stream) {
  return stream_entry<true>(APG_STREAM_ARG_NAMES, N, ns, nx, nu, nv, max_it,
                            ranges, n_ranges, c, step, t1c, t2c, xs_upper,
                            mode, stream);
}

// The fused iteration (fused_kernel), with the state and outputs of
// apg_stream and the scratch w (N, ns, 2nx + nu).  mode 0: the whole
// solve (the counter reset, max_it replays of one captured cooperative
// launch, the tail of apg_stream's mode 0); mode 1: one iteration from
// the state and the scalars sc[0..4] the caller put in place, leaving
// K1's champion partials (row range * nblocks + block) and K2's
// squared-distance partials.  Refuses a tree whose v tiles pass the
// shared memory (cudaErrorInvalidValue) and a grid whose blocks cannot
// all be resident at once (cudaErrorCooperativeLaunchTooLarge).
extern "C" int apg_stream_fused(APG_STREAM_ARGS, float* w, int N, int ns,
                                int nx, int nu, int nv, int max_it,
                                const int* ranges, int n_ranges, float c,
                                float step, float t1c, float t2c,
                                float xs_upper, int mode, void* stream) {
  return fused_entry<false>(APG_STREAM_ARG_NAMES, w, N, ns, nx, nu, nv,
                            max_it, ranges, n_ranges, c, step, t1c, t2c,
                            xs_upper, mode, stream);
}

// apg_stream_fused with one bf16 pass a product, the matrices rounded by
// the caller (as apg_stream_bf16).
extern "C" int apg_stream_fused_bf16(APG_STREAM_ARGS, float* w, int N,
                                     int ns, int nx, int nu, int nv,
                                     int max_it, const int* ranges,
                                     int n_ranges, float c, float step,
                                     float t1c, float t2c, float xs_upper,
                                     int mode, void* stream) {
  return fused_entry<true>(APG_STREAM_ARG_NAMES, w, N, ns, nx, nu, nv,
                           max_it, ranges, n_ranges, c, step, t1c, t2c,
                           xs_upper, mode, stream);
}

// The slots per block, which the wrapper sizes its partials by.
extern "C" int apg_stream_tile() { return TILE; }

// The most dynamic shared memory (bytes) a launch at these sizes asks
// for; ops/apg_stream.py holds its routing formula to this (and to
// apg_stream_bf16_smem for the bf16 entry).
extern "C" long long apg_stream_smem(int N, int ns, int nx, int nu, int nv) {
  (void)N; (void)ns;
  return stream_smem(nx, nu, nv, false);
}
extern "C" long long apg_stream_bf16_smem(int N, int ns, int nx, int nu,
                                          int nv) {
  (void)N; (void)ns;
  return stream_smem(nx, nu, nv, true);
}

// The fused kernel's shared memory (bytes); ops/apg_stream.py holds
// fused_smem to it.
extern "C" long long apg_stream_fused_smem(int N, int ns, int nx, int nu,
                                           int nv) {
  (void)ns;
  return (long long)smem_fused(N, nx, nu, nv, false);
}
extern "C" long long apg_stream_fused_bf16_smem(int N, int ns, int nx,
                                                int nu, int nv) {
  (void)ns;
  return (long long)smem_fused(N, nx, nu, nv, true);
}

// The dynamic shared memory (bytes) of the staged variant of K1 (kernel
// 0), K2 (1) or the fused kernel (2); ops/apg_stream.py's staged_smem
// mirrors it.
extern "C" long long apg_stream_staged_smem(int N, int ns, int nx, int nu,
                                            int nv, int kernel) {
  (void)ns;
  return staged_smem(N, nx, nu, nv, kernel, false);
}
extern "C" long long apg_stream_bf16_staged_smem(int N, int ns, int nx,
                                                 int nu, int nv,
                                                 int kernel) {
  (void)ns;
  return staged_smem(N, nx, nu, nv, kernel, true);
}

// Which variants a launch at these sizes takes on the current device:
// bit 0 K1 staged, bit 1 K2 staged, bit 2 the fused kernel staged (its
// blocks all resident); a negative cudaError_t on failure.  Sets the
// kernels' shared memory as a launch would.
extern "C" int apg_stream_staged(int N, int ns, int nx, int nu, int nv) {
  return staged_mask<false>(N, ns, nx, nu, nv);
}
extern "C" int apg_stream_bf16_staged(int N, int ns, int nx, int nu, int nv) {
  return staged_mask<true>(N, ns, nx, nu, nv);
}

#ifdef APG_STREAM_CLOCK
// The instrumented build's spans (N_PARTS sums of SM cycles, in Part's
// order) into the host array `out`, then zeroed.  Synchronises.
extern "C" int apg_stream_spans(unsigned long long* out) {
  SK_TRY(cudaDeviceSynchronize());
  SK_TRY(cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans)));
  const unsigned long long zero[N_PARTS] = {};
  return cudaMemcpyToSymbol(g_spans, zero, sizeof(g_spans));
}
#endif

extern "C" const char* apg_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
