// Streaming oracle sweeps of the FBE/NAMA solve for Hopper (sm_90a): S1
// (backward) and S2 (forward) over a scenario tree too large for the
// whole-solve kernel.
//
// Replaces the TPU kernels of rapidnet_tpu/ops/pallas_stream_qn.py::
// make_stream_sweeps (S1 body :79, pallas_call :200; S2 body :129,
// pallas_call :216).  They are the tree recursion of the streaming APG
// pair (csrc/apg_stream.cu) stripped to the bare oracle that the
// quasi-Newton solve (solver/qn_stream.py) calls three times an
// iteration:
//   S1, stages N-1 .. 0: t = d1 w1 + d2 w2 + t_carry,
//        inner = a_carry + Bb t + L'(g wp) [+ beta], v = nhp iW inner,
//        with the child -> parent handoff after each prefix stage;
//   S2, stages 0 .. N-1: du = du_carry + L v, u = du [+ uhat],
//        x = x_carry + B u [+ e], and the primal images p1 = d1 x,
//        p2 = d2 x, pp = g u.
// The bracketed affine terms, and S2's start (du = pdu, x = x0 instead of
// zero), are the solve step's; the Hessian oracle (AFFINE = false) reads
// none of them, as the JAX package's affine=False variant does not.
// d1, d2 and g are sqrt(prob) x a per-stage row, as in csrc/apg_stream.cu.
// On a scenario mesh each rank runs S1 over its block's high stages and S2
// over its block (ops/stream_qn.py, s1a_call).
//
// What bounds it on the card.  At BASELINE config 5 (N = 24, ns = 1024,
// nx = 63, nu = 114, nv = 97) one S1 pass reads the duals (23.6 MB) and
// beta and writes v (9.5 MB); one S2 pass reads v, uhat and e and writes
// x, u and the images (~40 MB): ~10-25 us at 3.35 TB/s, against ~1 GFLOP
// of products per pair, ~15 us at 67 TFLOP/s.  Within a block the stage
// recursion is serial, so a stage costs its latency.  The first design
// (csrc/apg_stream.cu's before it was staged) read each product's matrix
// through L1/L2 at every k-step and the operands straight from device
// memory: an S1 stage took ~22 us a block, 87 % of it in its three
// products, an S2 stage ~15 us.  Staged (below), an S1 stage takes
// ~6.1 us and an S2 stage ~5.8 us, most of it in the products' k-chains
// (S2's B' product runs on four warps, bound by a step's latency), and
// each S1 launch spends ~5 us staging its matrices (PERF.md section 6,
// profile_solve.py --stream --spans --algorithm fbe).
//
// What the design does.  Each block owns TILE consecutive scenario slots
// and walks the stages, carrying t and a (S1) or du and x (S2) in shared
// memory; a tile's rows of every (N, ns, d) array are contiguous, so its
// loads coalesce without a transpose.  S1 is one launch per range of
// stages between prefix aggregations: a launch ends by writing its tile's
// carries, and the next starts each slot's carries as the sum over the
// child slots of its parent (index lists; two carry buffers alternate).
// S2 needs no handoff (the fan layout copies a node's values over its
// subtree's slots).  Staged, as csrc/apg_stream.cu's K1 and K2 are, each
// launch copies its matrices into shared memory once (S1: Bb', L and iW',
// 106 KB at config 5; S2: L' and B', 73 KB) with the copy engine (TMA
// bulk copies on an mbarrier), together with the first stage's operands,
// while S1's handoff gather runs; and each stage's operands (the tile's
// rows of w, beta, sqrt(prob) and nhp and the stage's rank-1 rows for S1;
// of v, uhat, e and sqrt(prob) and the rank-1 rows for S2) are copied a
// stage ahead into the other of two buffers, so the elementwise passes
// and the emits read shared memory: S1's under its three products, S2's
// under its second (the first reaches into the last warp).  The last
// warp, idle there at config 5, issues the copies.  S1's staged handoff
// gather lists each slot's first KIDS child slots in shared memory and
// issues the loads of GATHER items at once.  The C entry picks the
// staged variant where its shared memory fits the device's opt-in limit
// (and caches the pick per device and sizes); else the same stage
// bodies read the matrices and the operands from device memory (a
// template flag), and the gather walks the child lists there, so that
// an unstaged launch asks for its tile alone: the kernels declare no
// static shared memory.  Every output keeps its sum in one order in
// both variants (one fmaf chain over k from 0, the emits' expressions as
// they were), so both give the bits of the first design.  Nothing is
// reduced, so a run repeats itself bit for bit.  Products are this
// file's FP32 FMA loops (no tensor cores, no TF32): the JAX package
// computes them at Precision.HIGHEST.  Its stream_precision="default"
// (one bf16 MXU pass a product, pallas_stream_qn.py:73-76) is the BF16
// instantiation, reached through the C entry stream_qn_bf16 with the
// matrices rounded to bfloat16 by the caller: each product's vector
// operand is rounded (to nearest, ties to even) once per element, t and
// inner into copies beside the float32 carries (S1's work area grows by
// (nx + nv) x TILE floats) and u into one beside the u the images read
// (S2's by nu x TILE); g wp and v are rounded where they are stored, and
// the handoff gather rounds each child's carry and the sum
// (csrc/apg_stream.cu's rules).  The float32 instantiation is the code as
// it was, with its shared memory and bits.
//
// Layout: every per-row array is row-major (N, ns, d), row r = s * ns + i
// (stage s, slot i).  The dual triple is one array (N, ns, 2 nx + nu),
// [w1 | w2 | wp] per row, and so are the images [p1 | p2 | pp].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

constexpr int TILE = 8;            // scenario slots per block
constexpr int GROUP = 4;           // slots per thread in a product (float4)
constexpr int THREADS = 256;
constexpr int KIDS = 8;            // child rows a handoff gather loads at once
constexpr int GATHER = 4;          // (slot, feature) items it loads at once
constexpr int BAR_FLOATS = 4;      // a staged launch's two mbarriers
constexpr int KID_INTS = TILE * (KIDS + 2);   // a staged S1's child lists

// The parts of a block's stage that the instrumented build times
// (nvcc -DSTREAM_QN_CLOCK): SM cycles on thread 0 between barriers,
// summed over the blocks and launches into g_spans, which
// stream_qn_spans reads; thread 0 keeps the last mark in a register
// (`last`), so the build asks for no more shared memory than the plain
// one.  The marks add barriers and nothing else, so the outputs stay
// those of the plain build; without the define they are empty.
enum Part {
  P_S1_START, P_S1_WAIT, P_S1_PASS, P_S1_BBT, P_S1_L, P_S1_IWT, P_S1_END,
  P_S2_START, P_S2_WAIT, P_S2_LOAD, P_S2_LT, P_S2_BT, P_S2_IMAGES, N_PARTS
};
#ifdef STREAM_QN_CLOCK
__device__ unsigned long long g_spans[N_PARTS];
#endif

// part < 0 starts the clock.
__device__ __forceinline__ void clock_mark(int part, long long& last) {
#ifdef STREAM_QN_CLOCK
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long now = clock64();
    if (part >= 0)
      atomicAdd(&g_spans[part], (unsigned long long)(now - last));
    last = now;
  }
#else
  (void)part;
  (void)last;
#endif
}

struct Args {
  int N, ns, nx, nu, nv, D, nblocks;
  // rank-1 constants: per-stage rows (N, d) and per-slot lines (N, ns)
  const float *cx1, *cx2, *cu, *sq, *nhp;
  // shared matrices, row-major (K, C): out[c] = sum_k M[k * C + c] in[k]
  const float *L, *BbT, *iWT, *LT, *BT;
  // prefix handoffs: each slot's parent (n_agg, ns), parents' child slots
  const int *agg_parent, *agg_ptr, *agg_idx;
  // the solve step's affine operands (read only with AFFINE)
  const float *beta, *uhat, *e, *x0, *pdu;
  const float* w;      // S1's duals (N, ns, D)
  float* v;            // S1's output, S2's input (N, ns, nv)
  float *x, *u, *pr;   // S2's outputs; pr (N, ns, D) the images
  float* carry;        // 2 buffers of (ns, nx + nv): [t | a] per slot
};

// ---- bulk copies into shared memory (the Tensor Memory Accelerator) ----
//
// (csrc/apg_stream.cu's helpers.)  One thread asks for a segment of
// device memory to be copied into shared memory (cp.async.bulk); the copy
// engine runs it and counts its bytes down on an mbarrier in shared
// memory, on which every thread waits.  A bulk copy moves 16-byte aligned
// runs of 16-byte multiples, so a segment of n floats at src is copied as
// the aligned run around it (at most 12 bytes more on either side, inside
// the tensor's allocation: PyTorch's blocks are 512-byte aligned and
// sized); its floats land at src's offset within 16 bytes of the 16-byte
// aligned segment (`landing`).

// x rounded to bfloat16 (to nearest, ties to even) and widened back: a
// product's operand under BF16.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  return BF16 ? bf16r(x) : x;
}

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

// ---- a stage's operands ----
//
// S1's operands of stage s for a tile: the tile's rows of w, beta (the
// solve step's), sqrt(prob) and nhp (row j of the tile at j * d), and the
// stage's rank-1 rows.  S2's: the tile's rows of v, uhat and e (the solve
// step's) and sqrt(prob), and the rank-1 rows of its images.  A staged
// launch copies them into a buffer of shared memory, in this order, one
// stage ahead; an unstaged one reads them where they lie.
enum S1Op { O1_W, O1_BETA, O1_SQ, O1_NHP, O1_CX1, O1_CX2, O1_CU, S1_OPS };
enum S2Op { O2_V, O2_UHAT, O2_E, O2_SQ, O2_CX1, O2_CX2, O2_CU, S2_OPS };
template <int N>
struct Ops {
  const float* f[N];
};

// Floats of operand o for nt slots.
__host__ __device__ inline int s1_len(int o, int nx, int nu, int nv, int nt,
                                      bool affine) {
  switch (o) {
    case O1_W: return (2 * nx + nu) * nt;
    case O1_BETA: return affine ? nv * nt : 0;
    case O1_SQ: case O1_NHP: return nt;
    case O1_CU: return nu;
    default: return nx;
  }
}
__host__ __device__ inline int s2_len(int o, int nx, int nu, int nv, int nt,
                                      bool affine) {
  switch (o) {
    case O2_V: return nv * nt;
    case O2_UHAT: return affine ? nu * nt : 0;
    case O2_E: return affine ? nx * nt : 0;
    case O2_SQ: return nt;
    case O2_CU: return nu;
    default: return nx;
  }
}
// Floats of one buffer (the solve step's, the larger).
__host__ __device__ inline int s1_buf_floats(int nx, int nu, int nv) {
  int n = 0;
  for (int o = 0; o < S1_OPS; ++o)
    n += room(s1_len(o, nx, nu, nv, TILE, true));
  return n;
}
__host__ __device__ inline int s2_buf_floats(int nx, int nu, int nv) {
  int n = 0;
  for (int o = 0; o < S2_OPS; ++o)
    n += room(s2_len(o, nx, nu, nv, TILE, true));
  return n;
}

template <bool AFFINE>
__device__ __forceinline__ Ops<S1_OPS> s1_sources(const Args& p, int s,
                                                  int i0) {
  const size_t row0 = (size_t)s * p.ns + i0;
  const size_t sx = (size_t)s * p.nx;
  return {{p.w + row0 * p.D, AFFINE ? p.beta + row0 * p.nv : nullptr,
           p.sq + row0, p.nhp + row0, p.cx1 + sx, p.cx2 + sx,
           p.cu + (size_t)s * p.nu}};
}
template <bool AFFINE>
__device__ __forceinline__ Ops<S2_OPS> s2_sources(const Args& p, int s,
                                                  int i0) {
  const size_t row0 = (size_t)s * p.ns + i0;
  const size_t sx = (size_t)s * p.nx;
  return {{p.v + row0 * p.nv, AFFINE ? p.uhat + row0 * p.nu : nullptr,
           AFFINE ? p.e + row0 * p.nx : nullptr, p.sq + row0, p.cx1 + sx,
           p.cx2 + sx, p.cu + (size_t)s * p.nu}};
}

// Names S1's (S2's) operands of stage s and their segments of `buf` to f.
template <bool AFFINE, class F>
__device__ __forceinline__ void s1_visit(const Args& p, int s, int i0,
                                         int nt, float* buf, F f) {
  const Ops<S1_OPS> src = s1_sources<AFFINE>(p, s, i0);
#pragma unroll
  for (int o = 0; o < S1_OPS; ++o) {
    f(buf, src.f[o], s1_len(o, p.nx, p.nu, p.nv, nt, AFFINE));
    buf += room(s1_len(o, p.nx, p.nu, p.nv, TILE, true));
  }
}
template <bool AFFINE, class F>
__device__ __forceinline__ void s2_visit(const Args& p, int s, int i0,
                                         int nt, float* buf, F f) {
  const Ops<S2_OPS> src = s2_sources<AFFINE>(p, s, i0);
#pragma unroll
  for (int o = 0; o < S2_OPS; ++o) {
    f(buf, src.f[o], s2_len(o, p.nx, p.nu, p.nv, nt, AFFINE));
    buf += room(s2_len(o, p.nx, p.nu, p.nv, TILE, true));
  }
}

// Where S1's (S2's) operands of stage s are read: in `buf` (STAGED) or in
// device memory.
template <bool AFFINE, bool STAGED>
__device__ __forceinline__ Ops<S1_OPS> s1_ops(const Args& p, int s, int i0,
                                              const float* buf) {
  Ops<S1_OPS> o = s1_sources<AFFINE>(p, s, i0);
  if (STAGED) {
#pragma unroll
    for (int k = 0; k < S1_OPS; ++k) {
      if (s1_len(k, p.nx, p.nu, p.nv, TILE, AFFINE))
        o.f[k] = landing(buf, o.f[k]);
      buf += room(s1_len(k, p.nx, p.nu, p.nv, TILE, true));
    }
  }
  return o;
}
template <bool AFFINE, bool STAGED>
__device__ __forceinline__ Ops<S2_OPS> s2_ops(const Args& p, int s, int i0,
                                              const float* buf) {
  Ops<S2_OPS> o = s2_sources<AFFINE>(p, s, i0);
  if (STAGED) {
#pragma unroll
    for (int k = 0; k < S2_OPS; ++k) {
      if (s2_len(k, p.nx, p.nu, p.nv, TILE, AFFINE))
        o.f[k] = landing(buf, o.f[k]);
      buf += room(s2_len(k, p.nx, p.nu, p.nv, TILE, true));
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

// S1's matrices (Bb', L, iW') and S2's (L', B'), and their floats.
__device__ __forceinline__ void s1_matrices(const Args& p, const float** M,
                                            int* n) {
  M[0] = p.BbT; M[1] = p.L; M[2] = p.iWT;
  n[0] = p.nx * p.nv; n[1] = p.nu * p.nv; n[2] = p.nv * p.nv;
}
__device__ __forceinline__ void s2_matrices(const Args& p, const float** M,
                                            int* n) {
  M[0] = p.LT; M[1] = p.BT;
  n[0] = p.nv * p.nu; n[1] = p.nu * p.nx;
}

// A launch's shared memory, in floats: the carries and product operands
// (`work`; with bf16, S1's rounded t and inner and S2's rounded u too),
// the staged matrices (`mats`) and two operand buffers.
__host__ __device__ inline int s1_work_floats(int nx, int nu, int nv,
                                              bool bf16) {
  return (nx + nv + nu + (bf16 ? nx + nv : 0)) * TILE;
}
__host__ __device__ inline int s2_work_floats(int nx, int nu, int nv,
                                              bool bf16) {
  return (2 * nu + nx + nv + (bf16 ? nu : 0)) * TILE;
}
__host__ __device__ inline int s1_mats_floats(int nx, int nu, int nv) {
  return room(nx * nv) + room(nu * nv) + room(nv * nv);
}
__host__ __device__ inline int s2_mats_floats(int nx, int nu, int nv) {
  return room(nv * nu) + room(nu * nx);
}

// The shared memory a staged launch copies into: the matrices, two
// operand buffers of buf_floats each (stage s in buffer s & 1), and one
// barrier per buffer (BAR_FLOATS after the buffers, S1's child lists
// after them), whose phases every thread counts in `parity` (bit b: the
// parity of buffer b's next phase).  Every part of it is dynamic shared
// memory: the kernels declare none of their own, so an unstaged launch
// asks for its tile alone, the routing gate's formula.
struct Staging {
  float* mats;
  float* bufs;
  int buf_floats;
  uint64_t* bars;
  unsigned parity;
};

__device__ __forceinline__ float* buffer(const Staging& sg, int s) {
  return sg.bufs + (s & 1) * sg.buf_floats;
}
__device__ __forceinline__ uint64_t* barrier_of(const Staging& sg, int s) {
  return sg.bars + (s & 1);
}
// Every thread: waits until stage s's buffer has landed.
__device__ __forceinline__ void wait_buffer(Staging& sg, int s) {
  const unsigned b = s & 1;
  mbar_wait(sg.bars + b, (sg.parity >> b) & 1u);
  sg.parity ^= 1u << b;
}

// A launch's staging in its dynamic shared memory: after `work` floats,
// the matrices, the buffers and the barriers, initialised (STAGED).
template <bool STAGED>
__device__ __forceinline__ Staging staging(float* smem, int work, int mats,
                                           int buf_floats) {
  if (!STAGED) return {nullptr, nullptr, 0, nullptr, 0u};
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + work + mats + 2 * buf_floats);
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    fence_barrier_init();
  }
  __syncthreads();
  return {smem + work, smem + work + mats, buf_floats, bars, 0u};
}

// out[c][j0 .. j0+3] = sum_k M[k * C + c] * X[k * TILE + j0 .. j0+3] for
// the tile: X feature-major in shared memory, M row-major (K, C) in
// shared memory (STAGED) or in device memory, read through L1
// (consecutive threads read consecutive c).  Each thread owns one output
// row c and GROUP slots, each one fmaf chain over k from 0; emit(c, j,
// acc) runs for every slot j of the tile.  Step k + 1's operands are
// loaded before step k's FMAs.  (csrc/apg_stream.cu's loop.)
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

// An S1 launch's starting carries for the block's tile, into tS (t) and
// aS (a), by the first `team` threads: each slot's is the sum over its
// parent's child slots (aggregation `gather`) of the exit carries qin,
// in the order of the index list; -1: zero.  LISTED (staged), the first
// KIDS child slots of each slot's parent (and their count) go to kidS
// (KID_INTS) first, so that each (slot, feature) issues its loads at
// once, GATHER of them a thread (csrc/apg_stream.cu's gather); else each
// (slot, feature) walks its parent's list in device memory.  BF16: each
// child's carry is rounded before it is added and the sum after.
template <bool LISTED, bool BF16>
__device__ __forceinline__ void gather_carries(const Args& p, int gather,
                                               int i0, int nt, int W,
                                               const float* __restrict__ qin,
                                               float* tS, float* aS,
                                               int* kidS, int team) {
  const int nx = p.nx, ns = p.ns;
  if (!LISTED) {
    for (int idx = threadIdx.x; idx < TILE * W; idx += team) {
      const int j = idx / W, k = idx - j * W;
      float acc = 0.f;
      if (gather >= 0 && j < nt) {
        const int par = p.agg_parent[(size_t)gather * ns + i0 + j];
        for (int m = p.agg_ptr[par]; m < p.agg_ptr[par + 1]; ++m)
          acc += operand<BF16>(qin[(size_t)p.agg_idx[m] * W + k]);
        acc = operand<BF16>(acc);
      }
      if (k < nx)
        tS[k * TILE + j] = acc;
      else
        aS[(k - nx) * TILE + j] = acc;
    }
    return;
  }
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

// S1's stage s for the block's tile (slots i0 .. i0 + nt - 1), the
// carries t and a in tS (nx, TILE) and aS (nv, TILE), gS (nu, TILE)
// scratch; the operands in stage s's buffer (STAGED), the next stage's
// (s_next >= 0) copied into the other buffer while the products run.
// Writes v.  BF16: t is summed one rounded operation at a time, the
// products read t and inner rounded, from tR (nx, TILE) and aR (nv, TILE),
// and g wp is rounded where it is stored.
template <bool AFFINE, bool STAGED, bool BF16>
__device__ __forceinline__ void s1_stage(const Args& p, int s, int s_next,
                                         int i0, int nt, float* tS,
                                         float* aS, float* gS, float* tR,
                                         float* aR, const float* BbT,
                                         const float* L, const float* iWT,
                                         Staging& sg, long long& clk) {
  const int nx = p.nx, nu = p.nu, nv = p.nv, D = p.D;
  const size_t row0 = (size_t)s * p.ns + i0;
  // No barrier first: this stage's passes write tS and gS, which the last
  // stage's products read before the barrier behind its L' product.
  if (STAGED) wait_buffer(sg, s);
  clock_mark(P_S1_WAIT, clk);
  const Ops<S1_OPS> o = s1_ops<AFFINE, STAGED>(p, s, i0, buffer(sg, s));
  // t = d1 w1 + d2 w2 + t (BF16: and t rounded, zero past nt)
  for (int idx = threadIdx.x; idx < (BF16 ? TILE : nt) * nx;
       idx += blockDim.x) {
    const int j = idx / nx, k = idx - j * nx;
    if (BF16 && j >= nt) {
      tR[k * TILE + j] = 0.f;
      continue;
    }
    const float sqv = o.f[O1_SQ][j];
    const float d1 = o.f[O1_CX1][k] * sqv, d2 = o.f[O1_CX2][k] * sqv;
    const float w1 = o.f[O1_W][j * D + k], w2 = o.f[O1_W][j * D + nx + k];
    if constexpr (BF16) {
      // each operation rounded on its own, in s1_plain's order: t is
      // rounded to bfloat16 from this value, and an FMA can move it across
      // a bf16 tie
      tS[k * TILE + j] = __fadd_rn(
          __fadd_rn(__fmul_rn(d1, w1), __fmul_rn(d2, w2)), tS[k * TILE + j]);
      tR[k * TILE + j] = bf16r(tS[k * TILE + j]);
    } else {
      tS[k * TILE + j] = d1 * w1 + d2 * w2 + tS[k * TILE + j];
    }
  }
  // g wp
  for (int idx = threadIdx.x; idx < TILE * nu; idx += blockDim.x) {
    const int j = idx / nu, k = idx - j * nu;
    float gw = 0.f;
    if (j < nt)
      gw = operand<BF16>((o.f[O1_CU][k] * o.f[O1_SQ][j]) *
                         o.f[O1_W][j * D + 2 * nx + k]);
    gS[k * TILE + j] = gw;
  }
  __syncthreads();
  clock_mark(P_S1_PASS, clk);
  // the next stage's operands, into the buffer the stage before this one
  // read (its emits are done: every thread has passed the barrier
  // above), by the last warp, which the products at config 5 leave idle
  if (STAGED && s_next >= 0 && threadIdx.x >= blockDim.x - 32)
    bulk_fill(barrier_of(sg, s_next), [&](auto f) {
      s1_visit<AFFINE>(p, s_next, i0, nt, buffer(sg, s_next), f);
    });
  // inner = a + Bb t + L'(g wp) [+ beta], summed in that order; it is
  // the next stage's a.  Both products give a thread the same (c, slots),
  // so the second reads what the first wrote without a barrier.
  tile_product<STAGED>(BF16 ? tR : tS, BbT, nx, nv,
                       [&](int cc, int j, float acc) {
    aS[cc * TILE + j] = j < nt ? aS[cc * TILE + j] + acc : 0.f;
  });
  clock_mark(P_S1_BBT, clk);
  tile_product<STAGED>(gS, L, nu, nv, [&](int cc, int j, float acc) {
    float a = aS[cc * TILE + j] + acc;
    if (AFFINE && j < nt) a += o.f[O1_BETA][j * nv + cc];
    aS[cc * TILE + j] = a;
    if (BF16) aR[cc * TILE + j] = bf16r(a);
  });
  __syncthreads();
  clock_mark(P_S1_L, clk);
  // v = nhp * iW inner
  tile_product<STAGED>(BF16 ? aR : aS, iWT, nv, nv,
                       [&](int cc, int j, float acc) {
    if (j < nt) p.v[(row0 + j) * nv + cc] = o.f[O1_NHP][j] * acc;
  });
  clock_mark(P_S1_IWT, clk);
  // the next stage writes tS and gS, which this product does not read;
  // its first product waits at the barrier behind its passes
}

// S1 over stages s_hi .. s_lo (descending) for the block's TILE slots.
// gather >= 0: the carries start as the child -> parent sums of prefix
// aggregation `gather`, over the exit carries of the previous launch;
// -1: they start at zero.  Staged, the matrices and the first stage's
// operands are copied by the last warp while the others gather.  Writes
// v and its exit carries (buffer launch & 1).
template <bool AFFINE, bool STAGED, bool BF16>
__global__ void __launch_bounds__(THREADS)
s1_kernel(Args p, int s_hi, int s_lo, int gather, int launch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns;
  float* tS = smem;              // (nx, TILE) t
  float* aS = tS + nx * TILE;    // (nv, TILE) a, inner
  float* gS = aS + nv * TILE;    // (nu, TILE) g * wp
  float* tR = gS + nu * TILE;    // BF16: (nx, TILE) t rounded
  float* aR = tR + nx * TILE;    // BF16: (nv, TILE) inner rounded
  Staging sg = staging<STAGED>(smem, s1_work_floats(nx, nu, nv, BF16),
                               s1_mats_floats(nx, nu, nv),
                               s1_buf_floats(nx, nu, nv));
  int* kidS = STAGED ? reinterpret_cast<int*>(sg.bars + 2) : nullptr;
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);
  const int W = nx + nv;
  const float* M[3];
  const float* at[3];
  int n[3];
  s1_matrices(p, M, n);
  mats_at<STAGED>(sg.mats, M, n, 3, at);
  const float* __restrict__ qin =
      p.carry + (size_t)((launch + 1) & 1) * ns * W;
  float* qout = p.carry + (size_t)(launch & 1) * ns * W;
  long long clk = 0;
  clock_mark(-1, clk);
  const int team = STAGED ? blockDim.x - 32 : blockDim.x;
  if (STAGED && threadIdx.x >= team) {
    bulk_fill(barrier_of(sg, s_hi), [&](auto f) {
      mats_visit(sg.mats, M, n, 3, f);
      s1_visit<AFFINE>(p, s_hi, i0, nt, buffer(sg, s_hi), f);
    });
  } else {
    gather_carries<STAGED, BF16>(p, gather, i0, nt, W, qin, tS, aS, kidS,
                                 team);
  }
  // the carries in place for every thread
  __syncthreads();
  clock_mark(P_S1_START, clk);

  for (int s = s_hi; s >= s_lo; --s)
    s1_stage<AFFINE, STAGED, BF16>(p, s, s > s_lo ? s - 1 : -1, i0, nt, tS,
                                   aS, gS, tR, aR, at[0], at[1], at[2], sg,
                                   clk);
  __syncthreads();

  for (int idx = threadIdx.x; idx < nt * W; idx += blockDim.x) {
    const int j = idx / W, k = idx - j * W;
    qout[(size_t)(i0 + j) * W + k] =
        k < nx ? tS[k * TILE + j] : aS[(k - nx) * TILE + j];
  }
  clock_mark(P_S1_END, clk);
}

// S2 over stages 0 .. N-1 for the block's TILE slots: u, x and the primal
// images.  Staged, the matrices are copied with stage 0's operands, and
// each later stage's into the other buffer while its predecessor's second
// product runs.  BF16: the products read v and u rounded (v where the
// tile is stored, u from uR).
template <bool AFFINE, bool STAGED, bool BF16>
__global__ void __launch_bounds__(THREADS) s2_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns, D = p.D;
  float* duS = smem;                             // (nu, TILE) du
  float* uS = duS + nu * TILE;                   // (nu, TILE) u
  float* xS = uS + nu * TILE;                    // (nx, TILE) x
  float* vS = xS + nx * TILE;                    // (nv, TILE) v
  float* uR = vS + nv * TILE;                    // BF16: (nu, TILE) u rounded
  Staging sg = staging<STAGED>(smem, s2_work_floats(nx, nu, nv, BF16),
                               s2_mats_floats(nx, nu, nv),
                               s2_buf_floats(nx, nu, nv));
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);
  const float* M[2];
  const float* at[2];
  int n[2];
  s2_matrices(p, M, n);
  mats_at<STAGED>(sg.mats, M, n, 2, at);

  long long clk = 0;
  clock_mark(-1, clk);
  if (STAGED && threadIdx.x >= blockDim.x - 32)
    bulk_fill(barrier_of(sg, 0), [&](auto f) {
      mats_visit(sg.mats, M, n, 2, f);
      s2_visit<AFFINE>(p, 0, i0, nt, buffer(sg, 0), f);
    });
  for (int idx = threadIdx.x; idx < nu * TILE; idx += blockDim.x)
    duS[idx] = AFFINE ? p.pdu[idx / TILE] : 0.f;
  for (int idx = threadIdx.x; idx < nx * TILE; idx += blockDim.x)
    xS[idx] = AFFINE ? p.x0[idx / TILE] : 0.f;
  clock_mark(P_S2_START, clk);
  for (int s = 0; s < p.N; ++s) {
    const size_t row0 = (size_t)s * ns + i0;
    if (STAGED) wait_buffer(sg, s);
    clock_mark(P_S2_WAIT, clk);
    const Ops<S2_OPS> o = s2_ops<AFFINE, STAGED>(p, s, i0, buffer(sg, s));
    // the stage's v tile, feature-major (slots vary fastest: no bank
    // conflicts); the last stage's first product read vS before the
    // barriers that followed it
    for (int idx = threadIdx.x; idx < TILE * nv; idx += blockDim.x) {
      const int k = idx / TILE, j = idx - k * TILE;
      vS[k * TILE + j] = j < nt ? operand<BF16>(o.f[O2_V][j * nv + k]) : 0.f;
    }
    // and the last stage's image pass, which reads uS and xS, is done
    __syncthreads();
    clock_mark(P_S2_LOAD, clk);
    // du += L v, u = du [+ uhat]
    tile_product<STAGED>(vS, at[0], nv, nu, [&](int cc, int j, float acc) {
      const float du = duS[cc * TILE + j] + acc;
      duS[cc * TILE + j] = du;
      float uv = 0.f;
      if (j < nt) {
        uv = AFFINE ? o.f[O2_UHAT][j * nu + cc] + du : du;
        p.u[(row0 + j) * nu + cc] = uv;
      }
      uS[cc * TILE + j] = uv;
      if (BF16) uR[cc * TILE + j] = bf16r(uv);
    });
    __syncthreads();
    clock_mark(P_S2_LT, clk);
    // the next stage's operands, into the buffer of the stage before this
    // one (its image pass is behind this stage's first barrier), while
    // B u runs, by the last warp (idle there at config 5)
    if (STAGED && s + 1 < p.N && threadIdx.x >= blockDim.x - 32)
      bulk_fill(barrier_of(sg, s + 1), [&](auto f) {
        s2_visit<AFFINE>(p, s + 1, i0, nt, buffer(sg, s + 1), f);
      });
    // x = x_prev + B u [+ e]
    tile_product<STAGED>(BF16 ? uR : uS, at[1], nu, nx,
                         [&](int cc, int j, float acc) {
      if (j < nt) {
        float xv = xS[cc * TILE + j] + acc;
        if (AFFINE) xv += o.f[O2_E][j * nx + cc];
        xS[cc * TILE + j] = xv;
        p.x[(row0 + j) * nx + cc] = xv;
      }
    });
    __syncthreads();
    clock_mark(P_S2_BT, clk);
    // the images d1 x, d2 x, g u
    for (int idx = threadIdx.x; idx < nt * nx; idx += blockDim.x) {
      const int j = idx / nx, k = idx - j * nx;
      const size_t ob = (row0 + j) * D + k;
      const float sqv = o.f[O2_SQ][j], xv = xS[k * TILE + j];
      p.pr[ob] = (o.f[O2_CX1][k] * sqv) * xv;
      p.pr[ob + nx] = (o.f[O2_CX2][k] * sqv) * xv;
    }
    for (int idx = threadIdx.x; idx < nt * nu; idx += blockDim.x) {
      const int j = idx / nu, k = idx - j * nu;
      p.pr[(row0 + j) * D + 2 * nx + k] =
          (o.f[O2_CU][k] * o.f[O2_SQ][j]) * uS[k * TILE + j];
    }
    clock_mark(P_S2_IMAGES, clk);
    // the next stage writes vS (read before the barrier above) and then
    // waits before it writes duS, uS and xS, which this pass reads
  }
}

#define SQ_TRY(expr)                                 \
  do {                                               \
    const cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return err_;            \
  } while (0)

// Dynamic shared memory of the unstaged S1 and S2 (bytes): the launch's
// and, through stream_qn_smem, the routing gate's one formula.
size_t smem_s1(int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * (size_t)s1_work_floats(nx, nu, nv, bf16);
}
size_t smem_s2(int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * (size_t)s2_work_floats(nx, nu, nv, bf16);
}
// The staged variants' (bytes): the work areas, the matrices, two
// operand buffers, the barriers and (S1) the child lists.
size_t staged_s1(int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * ((size_t)s1_work_floats(nx, nu, nv, bf16) +
                          s1_mats_floats(nx, nu, nv) +
                          2 * (size_t)s1_buf_floats(nx, nu, nv) +
                          BAR_FLOATS + KID_INTS);
}
size_t staged_s2(int nx, int nu, int nv, bool bf16) {
  return sizeof(float) * ((size_t)s2_work_floats(nx, nu, nv, bf16) +
                          s2_mats_floats(nx, nu, nv) +
                          2 * (size_t)s2_buf_floats(nx, nu, nv) +
                          BAR_FLOATS);
}

// A kernel's variant at these sizes: staged where its static and dynamic
// shared memory fit the device's opt-in limit, else the same stage bodies
// reading the matrices and operands from device memory; `smem` its
// dynamic bytes.
struct Plan {
  bool staged;
  size_t smem;
};

// The plans made, by (device, staged kernel, nx, nu, nv), and the dynamic
// bytes each kernel is allowed on each device (it only grows, so a plan
// made once stays valid): a launch at sizes seen before makes no runtime
// call to plan.
std::mutex plan_mutex;
std::map<std::tuple<int, const void*, int, int, int>, Plan> plans;
std::map<std::pair<int, const void*>, size_t> allowed;

cudaError_t plan(const void* staged_kernel, const void* unstaged_kernel,
                 size_t staged_bytes, size_t unstaged_bytes, int nx, int nu,
                 int nv, Plan* pl) {
  int dev = 0;
  SQ_TRY(cudaGetDevice(&dev));
  std::lock_guard<std::mutex> lock(plan_mutex);
  const auto key = std::make_tuple(dev, staged_kernel, nx, nu, nv);
  const auto hit = plans.find(key);
  if (hit != plans.end()) {
    *pl = hit->second;
    return cudaSuccess;
  }
  int max_optin = 0;
  SQ_TRY(cudaDeviceGetAttribute(&max_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  cudaFuncAttributes a;
  SQ_TRY(cudaFuncGetAttributes(&a, staged_kernel));
  Plan got;
  got.staged = a.sharedSizeBytes + staged_bytes <= (size_t)max_optin;
  got.smem = got.staged ? staged_bytes : unstaged_bytes;
  if (got.smem > (size_t)max_optin) return cudaErrorInvalidValue;
  const void* kernel = got.staged ? staged_kernel : unstaged_kernel;
  size_t& now = allowed[std::make_pair(dev, kernel)];
  if (got.smem > 48 * 1024 && got.smem > now) {
    SQ_TRY(cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)got.smem));
    now = got.smem;
  }
  plans[key] = got;
  *pl = got;
  return cudaSuccess;
}
template <bool AFFINE, bool BF16>
cudaError_t plan_s1(int nx, int nu, int nv, Plan* pl) {
  return plan((const void*)s1_kernel<AFFINE, true, BF16>,
              (const void*)s1_kernel<AFFINE, false, BF16>,
              staged_s1(nx, nu, nv, BF16), smem_s1(nx, nu, nv, BF16), nx, nu,
              nv, pl);
}
template <bool AFFINE, bool BF16>
cudaError_t plan_s2(int nx, int nu, int nv, Plan* pl) {
  return plan((const void*)s2_kernel<AFFINE, true, BF16>,
              (const void*)s2_kernel<AFFINE, false, BF16>,
              staged_s2(nx, nu, nv, BF16), smem_s2(nx, nu, nv, BF16), nx, nu,
              nv, pl);
}

template <bool AFFINE, bool BF16>
cudaError_t run(const Args& p, int mode, const int* ranges, int n_ranges,
                cudaStream_t st) {
  Plan pl;
  if (mode == 1) {
    SQ_TRY((plan_s1<AFFINE, BF16>(p.nx, p.nu, p.nv, &pl)));
    for (int k = 0; k < n_ranges; ++k) {
      const int* r = ranges + 3 * k;
      if (pl.staged)
        s1_kernel<AFFINE, true, BF16><<<p.nblocks, THREADS, pl.smem, st>>>(
            p, r[0], r[1], r[2], k);
      else
        s1_kernel<AFFINE, false, BF16><<<p.nblocks, THREADS, pl.smem, st>>>(
            p, r[0], r[1], r[2], k);
      SQ_TRY(cudaGetLastError());
    }
    return cudaSuccess;
  }
  if (mode != 2) return cudaErrorInvalidValue;
  SQ_TRY((plan_s2<AFFINE, BF16>(p.nx, p.nu, p.nv, &pl)));
  if (pl.staged)
    s2_kernel<AFFINE, true, BF16><<<p.nblocks, THREADS, pl.smem, st>>>(p);
  else
    s2_kernel<AFFINE, false, BF16><<<p.nblocks, THREADS, pl.smem, st>>>(p);
  return cudaGetLastError();
}

// The entries' body (stream_qn, stream_qn_bf16), BF16 the products'
// precision.
template <bool BF16>
int sweep_entry(const float* cx1, const float* cx2, const float* cu,
                const float* sq, const float* nhp, const float* L,
                const float* BbT, const float* iWT, const float* LT,
                const float* BT, const int* agg_parent, const int* agg_ptr,
                const int* agg_idx, const float* beta, const float* uhat,
                const float* e, const float* x0, const float* pdu,
                const float* w, float* v, float* x, float* u, float* pr,
                float* carry, int N, int ns, int nx, int nu, int nv,
                const int* ranges, int n_ranges, int affine, int mode,
                void* stream) {
  if (N < 1 || ns < 1 || n_ranges < 1) return cudaErrorInvalidValue;
  Args p;
  p.N = N; p.ns = ns; p.nx = nx; p.nu = nu; p.nv = nv; p.D = 2 * nx + nu;
  p.nblocks = (ns + TILE - 1) / TILE;
  p.cx1 = cx1; p.cx2 = cx2; p.cu = cu; p.sq = sq; p.nhp = nhp;
  p.L = L; p.BbT = BbT; p.iWT = iWT; p.LT = LT; p.BT = BT;
  p.agg_parent = agg_parent; p.agg_ptr = agg_ptr; p.agg_idx = agg_idx;
  p.beta = beta; p.uhat = uhat; p.e = e; p.x0 = x0; p.pdu = pdu;
  p.w = w; p.v = v; p.x = x; p.u = u; p.pr = pr; p.carry = carry;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return affine ? run<true, BF16>(p, mode, ranges, n_ranges, st)
                : run<false, BF16>(p, mode, ranges, n_ranges, st);
}

// Which variants a launch at these sizes takes (stream_qn_staged).
template <bool BF16>
int staged_mask(int nx, int nu, int nv) {
  Plan s1, s2;
  cudaError_t err = plan_s1<true, BF16>(nx, nu, nv, &s1);
  if (err == cudaSuccess) err = plan_s2<true, BF16>(nx, nu, nv, &s2);
  if (err != cudaSuccess) return -(int)err;
  return (int)s1.staged | (int)s2.staged << 1;
}

long long unstaged_smem(int nx, int nu, int nv, bool bf16) {
  const size_t s1 = smem_s1(nx, nu, nv, bf16), s2 = smem_s2(nx, nu, nv, bf16);
  return (long long)(s1 > s2 ? s1 : s2);
}

}  // namespace

#define STREAM_QN_ARGS                                                      \
  const float *cx1, const float *cx2, const float *cu, const float *sq,     \
      const float *nhp, const float *L, const float *BbT, const float *iWT, \
      const float *LT, const float *BT, const int *agg_parent,              \
      const int *agg_ptr, const int *agg_idx, const float *beta,            \
      const float *uhat, const float *e, const float *x0, const float *pdu, \
      const float *w, float *v, float *x, float *u, float *pr, float *carry, \
      int N, int ns, int nx, int nu, int nv, const int *ranges,             \
      int n_ranges, int affine, int mode, void *stream
#define STREAM_QN_ARG_NAMES                                                 \
  cx1, cx2, cu, sq, nhp, L, BbT, iWT, LT, BT, agg_parent, agg_ptr, agg_idx, \
      beta, uhat, e, x0, pdu, w, v, x, u, pr, carry, N, ns, nx, nu, nv,     \
      ranges, n_ranges, affine, mode, stream

// mode 1: one S1 pass (every range of stages: (first stage, last stage,
// aggregation read at the start or -1) per launch) from w to v; mode 2:
// one S2 pass from v to x, u and the images pr.  affine != 0: the solve
// step (S1 adds beta; S2 starts from pdu and x0 and adds uhat and e);
// 0: the Hessian oracle, which reads none of those pointers.  Each kernel
// runs staged where that fits the device (stream_qn_staged).  Enqueued on
// `stream` without synchronising.  Returns a cudaError_t (0 on success).
// The products in full float32 (stream_precision "highest").
extern "C" int stream_qn(STREAM_QN_ARGS) {
  return sweep_entry<false>(STREAM_QN_ARG_NAMES);
}

// stream_qn with one bf16 pass a product (stream_precision "default"):
// the caller passes L, BbT, iWT, LT and BT rounded to bfloat16.
extern "C" int stream_qn_bf16(STREAM_QN_ARGS) {
  return sweep_entry<true>(STREAM_QN_ARG_NAMES);
}

// The slots per block.
extern "C" int stream_qn_tile() { return TILE; }

// The most dynamic shared memory (bytes) an unstaged launch at these
// sizes asks for; ops/stream_qn.py holds its routing formula to this.
extern "C" long long stream_qn_smem(int N, int ns, int nx, int nu, int nv) {
  (void)N; (void)ns;
  return unstaged_smem(nx, nu, nv, false);
}
extern "C" long long stream_qn_bf16_smem(int N, int ns, int nx, int nu,
                                         int nv) {
  (void)N; (void)ns;
  return unstaged_smem(nx, nu, nv, true);
}

// The dynamic shared memory (bytes) of the staged variant of S1 (kernel
// 0) or S2 (1).
extern "C" long long stream_qn_staged_smem(int N, int ns, int nx, int nu,
                                           int nv, int kernel) {
  (void)N; (void)ns;
  return (long long)(kernel == 0 ? staged_s1(nx, nu, nv, false)
                                 : staged_s2(nx, nu, nv, false));
}
extern "C" long long stream_qn_bf16_staged_smem(int N, int ns, int nx,
                                                int nu, int nv, int kernel) {
  (void)N; (void)ns;
  return (long long)(kernel == 0 ? staged_s1(nx, nu, nv, true)
                                 : staged_s2(nx, nu, nv, true));
}

// Which variants a launch at these sizes takes on the current device:
// bit 0 S1 staged, bit 1 S2 staged; a negative cudaError_t on failure.
// Sets the kernels' shared memory as a launch would.
extern "C" int stream_qn_staged(int N, int ns, int nx, int nu, int nv) {
  (void)N; (void)ns;
  return staged_mask<false>(nx, nu, nv);
}
extern "C" int stream_qn_bf16_staged(int N, int ns, int nx, int nu, int nv) {
  (void)N; (void)ns;
  return staged_mask<true>(nx, nu, nv);
}

#ifdef STREAM_QN_CLOCK
// The instrumented build's spans (N_PARTS sums of SM cycles, in Part's
// order) into the host array `out`, then zeroed.  Synchronises.
extern "C" int stream_qn_spans(unsigned long long* out) {
  SQ_TRY(cudaDeviceSynchronize());
  SQ_TRY(cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans)));
  const unsigned long long zero[N_PARTS] = {};
  return cudaMemcpyToSymbol(g_spans, zero, sizeof(g_spans));
}
#endif

extern "C" const char* stream_qn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
