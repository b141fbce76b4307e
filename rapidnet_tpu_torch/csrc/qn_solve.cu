// Whole-solve global-FBE and NAMA for Hopper (sm_90a): the entire
// fixed-budget (or tolerance) quasi-Newton dual solve from one call out of
// Python.
//
// Replaces the TPU kernel rapidnet_tpu/ops/pallas_qn.py::make_pallas_qn_solve
// (kernel body :133-545, pallas_call :600).  Each iteration computes what
// that kernel computes (:300-512), on the unpadded fan layout:
//   solve step     the affine tree sweep at the dual y, the prox of g
//                  (projection differences, two rep-masked global norms)
//                  and the residual r = (1 - k) diff - c y;
//   yvec           FBE: -(r + step H(r)), with H the Hessian oracle (the
//                  sweep with its affine terms zero); NAMA: -r;
//   FBE value      <y, r> + step/2 <r, r> + the g-values + the smoothing
//                  and economic costs of u, before the line search;
//   L-BFGS         the accept test and the write of the curvature pair
//                  (size + 1 columns, column 0 zero, col = 1 + col % size),
//                  the Hessian scale and the two-loop recursion;
//   line search    FBE: H(dir); NAMA: H(r), the unconditional residual
//                  step, then H(dir - step r); then up to LS_MAX_STEPS + 1
//                  cumulative tau trials, each an apply, a prox, a residual
//                  and an FBE value, the last worsening trial left applied;
//   dual update    y_prev <- y, y <- w + step r;
//   traces         the signed infeasibility champion, the FBE value and
//                  tau; with a tolerance, the true residual magnitude for
//                  the exit.
//
// What bounds it on the card.  At the Barcelona-scale problem (N = 24
// stages, ns = 25 scenario slots, nx = 63, nu = 114, nv = 97, a curvature
// buffer of 5) an instance's state is ~14 dual-sized buffers of 144k
// floats (~8 MB) plus the 2 x 6 history columns (~6.9 MB in float32,
// ~3.5 MB in bf16).  Three tree sweeps an iteration hold most of the
// operations (~54 MFLOP each); everything else is elementwise work and
// reductions over the dual space, whose every dot and norm couples the
// whole tree, and the FBE value's smoothing term sum p du' W du (2 nu^2
// flops a row of u, ~15.6 MFLOP an instance), once in the solve step and
// once in each line-search trial.  A single solve's state sits in the 50
// MB L2 and its iteration is bound by the latency of ~73 dependent
// launches; a batch of 32 streams ~0.43 GB of state from device memory,
// so its elementwise passes are bound by bytes (a two-loop step moves ~74
// MB, a trial's prox and residual ~170 MB) and the smoothing products by
// FP32 operations (0.5 GFLOP a call, 7.4 us at 67 TFLOP/s).
//
// What the design does.  Every piece of the iteration is a phase kernel
// launched in order on one stream; the iterations after the first, whose
// launch sequence is fixed, run as one captured CUDA graph launched once
// per iteration, and every decision the Pallas kernel takes with pl.when
// is a device-side flag (the search's done flag turns the remaining
// trials into early returns; the tolerance exit's, every later phase).
// The host never reads the device.
//   * The sweeps (copies of apg_solve.cu's tail, prefix and forward
//     phases, :195, :270, :354, with the affine terms behind a template
//     flag) run one block per scenario slot and instance and one block
//     per instance for the branching prefix.
//   * The dual-space passes (prox, residual, the L-BFGS dots and store,
//     the ten two-loop steps, NAMA's residual step, the dual update) are
//     flat: each instance's buffer is cut into P chunks of FLAT_THREADS
//     4-float vectors, P a function of the buffer's size alone, never of
//     B.  A thread loads its vector of each operand with one 16-byte
//     access, recovers each element's row, part and primal index by a
//     multiply-shift, and the block reduces its sums by warp shuffles
//     and then its warps in order into one partial per chunk; every
//     consumer adds an instance's P partials in one fixed order (lanes
//     over the chunks, then a shuffle tree).  A grid of a few blocks per
//     SM walks the (instance, chunk) items in contiguous runs, so a
//     finished instance's items cost a flag read, not a block launch.
//     The two-loop stages both history columns it reads with cp.async,
//     marked evict-first in L2, and walks the chunks in the other order
//     at every step, so the last-written part of the direction dd is
//     read first from L2.
//   * The prox of a trial applies its cumulative step to w and u in
//     place and to x only in registers (x pairs with two dual entries,
//     read by two threads); the residual pass, which reads no x, writes
//     it.  So a trial stays four launches: prox, residual, smoothing
//     product, the scalar test.
//   * The smoothing product is a tiled FP32 product: each block stages
//     W' (nu x nu, in slabs when it exceeds SMOOTH_SMEM_CAP) in shared
//     memory by cp.async once, builds du = u - u of the parent for TM
//     rows of the instance in shared memory from one read of u, gives
//     each thread a TILE_ROWS x TILE_COLS register tile, and folds the
//     quadratic form and the economic cost into the epilogue.
//   * A trial's residual is kept only in its sums; the dual update forms
//     the last one again from df and w.  Every grid holds as many blocks
//     as the card runs at once (by occupancy), the items spread over
//     them; the chunks, and so every sum, do not depend on the grid.
//
// Measured on an H100 80GB HBM3 (700 W; chip_smoke.py --reference-kernel,
// PERF.md section 6): a B = 32 call of 500 Barcelona-scale iterations
// takes ~0.57-0.59 of the time of the per-slot design it replaced (FBE
// ~1.05 s against ~1.83 s, NAMA ~1.1 s against ~1.91 s, in turns on one
// card), a single solve ~0.8 of it (~275-283 ms against ~341-353 ms).
// At B = 32 the three sweeps now take ~41 % of an iteration, the
// smoothing products ~14 % (~250 us an iteration over ~7.5 calls,
// against 7.4 us of FP32 operations a call), the trials' prox and
// residual ~22 % and the ten two-loop steps ~13 % (~23 us a step for
// ~74 MB).
//
// The batch axis.  B independent solves over one factor step run in one
// call: what the TPU kernel's batch wrappers compute by a lax.map of the
// whole-solve pallas_call (rapidnet_tpu/ops/pallas_qn.py:686-739,
// make_qn_pallas_batch and make_qn_pallas_batch_shared).  The sweeps take
// their instance from blockIdx.y (slot phases) or blockIdx.x (prefix),
// the flat passes and the product from their work item, the scalar
// phases one warp per instance, and `instance()` moves each per-instance
// pointer to its slice; the row constants, the matrices, Cs and W' are
// read by every instance from one buffer, and uhat, e and alpha_price
// may be too (batch stride 0, the shared-forecast batch).  The single
// solve is B = 1 of the same source, compiled without the per-instance
// offsets (BATCHED = false); the batched entry keeps them at every B,
// B = 1 included, so a batch of one is held to the single solve.  Flags
// live in each instance's st: a search or a solve that has ended turns
// only its own instance's later work into early returns, so a finished
// instance keeps its state and zero traces past its exit.  The chunks
// and tiles and every reduction's order are the same whatever B, so an
// instance of a batch equals its single solve bit for bit.
//
// Reductions.  Every dot, norm and champion is reduced in two passes:
// per-chunk (per-slot in the sweeps) partials, then a fixed-order pass by
// the consumer.  No atomics, so a run repeats itself bit for bit.
//
// Products are this file's own FP32 FMA loops (no cuBLAS, no tensor
// cores, no TF32): the JAX package computes them at Precision.HIGHEST.
//
// The history's storage (History<H>): float32 (qn_solve, qn_solve_batch)
// or bf16 (qn_solve_bf16, qn_solve_batch_bf16), the TPU kernel's
// lbfgs_dtype (pallas_qn.py:99, :128).  A bf16 pair is rounded before its
// dots and rho, stored rounded, and widened on read (:335-359, :383);
// all arithmetic stays float32, column 0 stays zero, and the launches per
// iteration are the same.
//
// Layout: every per-row array is row-major (R, d) with row r = s*ns + i
// (stage s, slot i).  A dual-space buffer is flat, [xi (R, 2nx) | pad |
// psi (R, nu) | pad], each part padded to a multiple of 4 floats (no pad
// at the Barcelona-scale sizes); the history holds bs + 1 such columns.
// The partial buffers hold per instance 2P norm, 2P + 2G value
// (residual chunks, then smoothing tiles), 4P dot, 2P two-loop and 6P
// champion floats (qn_solve_partials).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROW_GROUP = 8;        // stage rows per thread in a sweep product
// the sweeps' slot blocks: enough threads that each product of a slot's
// 24 stage rows (3 row groups x up to 114 columns) runs in one round
constexpr int SLOT_THREADS = 384;
constexpr int PREFIX_THREADS = 512;
// the flat dual-space passes: a chunk is one 4-float vector per thread
constexpr int FLAT_THREADS = 256;
constexpr int FLAT_BLOCKS_PER_SM = 4;
// the smoothing product: a block, a thread's register tile (TILE_COLS
// columns in two runs of 4, half a padded row apart), blocks per SM and
// the most shared memory a block takes (W' beyond it goes in slabs)
constexpr int SMOOTH_THREADS = 128;
constexpr int TILE_ROWS = 4, TILE_COLS = 8;
constexpr int SMOOTH_BLOCKS_PER_SM = 3;
constexpr int STAGE_BATCH = 8;      // du' elements a thread loads at once
constexpr long long SMOOTH_SMEM_CAP = 96 * 1024;
constexpr int LS_MAX_STEPS = 10;    // solver/quasi_newton.py:42-43
constexpr float LS_TOLERANCE = 1e-4f;

// float scalars: sc[S_RHO ..] rho (bs + 1), then alpha (bs + 1)
enum { S_HESS, S_VALUE_REF, S_TAU, S_APPLIED, S_RHO };
// int scalars; I_TRIALS counts the line-search trials that ran
enum { I_DONE, I_ITERS, I_COL, I_MEM, I_SKIPS, I_ACCEPT, I_LS_DONE, I_SKIP,
       I_POSITIVE, I_TRIALS, I_COUNT };

// The sizes of an instance's dual buffer, its flat chunks and its
// smoothing tiles: functions of the problem's sizes alone (never of B).
struct Layout {
  long long XI, XP, PS, D;   // xi, psi's offset, psi, the whole buffer
  long long DV, XV, P;       // 4-float vectors, of them xi, chunks
  int NCP, TM, KS;           // W' columns padded, tile rows, slab rows
  long long G, smooth_smem;  // tiles; the product's shared memory (bytes)
};

long long round4(long long n) { return (n + 3) / 4 * 4; }

Layout layout(int N, int ns, int nx, int nu) {
  Layout l;
  const long long R = (long long)N * ns;
  l.XI = R * 2 * nx;
  l.XP = round4(l.XI);
  l.PS = R * nu;
  l.D = l.XP + round4(l.PS);
  l.DV = l.D / 4;
  l.XV = l.XP / 4;
  l.P = (l.DV + FLAT_THREADS - 1) / FLAT_THREADS;
  l.NCP = (nu + TILE_COLS - 1) / TILE_COLS * TILE_COLS;
  const int col_groups = l.NCP / TILE_COLS;
  const int row_groups = SMOOTH_THREADS / col_groups;
  l.TM = TILE_ROWS * (row_groups > 0 ? row_groups : 1);
  const long long per_k = 4LL * (l.NCP + l.TM);   // a row of W' and of du'
  const long long ks = SMOOTH_SMEM_CAP / per_k;
  l.KS = (int)(ks < 1 ? 1 : ks < nu ? ks : nu);
  l.smooth_smem = per_k * l.KS;
  l.G = (R + l.TM - 1) / l.TM;
  return l;
}

struct Args {
  int B, N, ns, nx, nu, nv, fp, RS, bs, tol_mode, max_it;
  // the dual buffer (Layout): xi elements from 0, psi from XP, D in all
  int XI, XP, PS, D;
  // the flat passes: DV vectors (the first XV xi), P chunks; mx and mu
  // the multiply-shift constants of 2nx and nu (0 for a divisor of 1)
  int DV, XV, P;
  unsigned long long mx, mu;
  // the smoothing product (Layout)
  int G, TM, KS, NCP;
  float c, step, t1c, t2c, pstate, psafety, xs_upper, tol;
  // batch strides (elements) of uhat, e and alpha_price: one instance's
  // size, or 0 where every instance reads the same array
  long long uhat_bs, e_bs, alpha_bs;
  // constants, per row r = s*ns + i
  const float *d1, *d2, *g, *nhp, *rep, *prob, *xmin, *xmax, *xs, *umin,
      *umax;
  // shared matrices (row-major), the prefix aggregation (fp, ns, ns), W'
  const float *L, *BbT, *iWT, *LT, *BT, *Cs, *WT;
  // per-step inputs: beta, uhat, e, alpha_price per row; x0, pdu, prev_u
  const float *beta, *uhat, *e, *alpha, *x0, *pdu, *pu;
  // dual-space state
  float *y, *yp, *yvp, *w, *rs, *yv, *dd, *wd, *df;
  // primal state and sweep scratch
  float *x, *u, *hx, *hu, *t, *a;
  // the curvature history, bs + 1 columns of D each: float or bf16
  // (History<H>), hsize bytes an element
  void *ms, *my;
  int hsize;
  // per-chunk partials (Layout above)
  float *norm_part, *val_part, *dot_part, *pp, *champ_part;
  float *sc, *tr_inf, *tr_val, *tr_tau;
  int* st;
};

// The arguments as instance b sees them: every per-instance pointer
// moved to its slice (a leading batch axis on each array), the shared
// constants untouched.  BATCHED = false (B = 1, the single solve) moves
// nothing.
template <bool BATCHED>
__device__ __forceinline__ Args instance(Args p, int b) {
  if constexpr (BATCHED) {
    const size_t R = (size_t)p.N * p.ns, D = p.D, P = p.P;
    p.beta += b * R * p.nv;
    p.uhat += b * p.uhat_bs;
    p.e += b * p.e_bs;
    p.alpha += b * p.alpha_bs;
    p.x0 += (size_t)b * p.nx;
    p.pdu += (size_t)b * p.nu;
    p.pu += (size_t)b * p.nu;
    p.y += b * D; p.yp += b * D; p.yvp += b * D; p.w += b * D;
    p.rs += b * D; p.yv += b * D; p.dd += b * D; p.wd += b * D;
    p.df += b * D;
    p.x += b * R * p.nx; p.hx += b * R * p.nx; p.t += b * R * p.nx;
    p.u += b * R * p.nu; p.hu += b * R * p.nu;
    p.a += b * R * p.nv;
    const size_t hist = (size_t)b * (p.bs + 1) * D * p.hsize;
    p.ms = static_cast<char*>(p.ms) + hist;
    p.my = static_cast<char*>(p.my) + hist;
    p.norm_part += b * P * 2;
    p.val_part += b * (P * 2 + (size_t)p.G * 2);
    p.dot_part += b * P * 4;
    p.pp += b * P * 2;
    p.champ_part += b * P * 6;
    p.sc += (size_t)b * (S_RHO + 2 * (p.bs + 1));
    p.tr_inf += (size_t)b * p.max_it;
    p.tr_val += (size_t)b * p.max_it;
    p.tr_tau += (size_t)b * p.max_it;
    p.st += (size_t)b * I_COUNT;
  }
  return p;
}

// A per-instance buffer passed to a phase beside its arguments (the
// sweep's direction and outputs, the dual a residual is taken at), moved
// to instance b's slice of `per` elements.
template <bool BATCHED, class T>
__device__ __forceinline__ T* slice(T* ptr, int b, size_t per) {
  if constexpr (BATCHED)
    if (ptr != nullptr) return ptr + (size_t)b * per;
  return ptr;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  // jnp.clip semantics: max with lo, then min with hi; NaN propagates
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

__device__ __forceinline__ float shrink(float sumsq, float thresh) {
  const float dist = sqrtf(sumsq);
  return dist > thresh ? 1.f - thresh / fmaxf(dist, 1e-30f) : 0.f;
}

// ---- shared-memory staging and history vectors ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One float from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Two floats (8-byte aligned) likewise.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// An L2 policy that evicts first: for data read once an iteration.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// 16 or 8 bytes from device memory into shared memory, asynchronously,
// under the L2 policy `pol`.
__device__ __forceinline__ void cp_async_hint(void* dst, const void* src,
                                              uint64_t pol, float4*) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "l"(pol));
}
__device__ __forceinline__ void cp_async_hint(void* dst, const void* src,
                                              uint64_t pol, uint2*) {
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "l"(pol));
}

// Waits for this thread's asynchronous copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Four consecutive floats of a buffer: a 16-byte access (e % 4 == 0).
struct V4 {
  float x[4];
};
__device__ __forceinline__ V4 ld4(const float* a, int e) {
  const float4 t = *reinterpret_cast<const float4*>(a + e);
  return {{t.x, t.y, t.z, t.w}};
}
__device__ __forceinline__ void st4(float* a, int e, const V4& v) {
  *reinterpret_cast<float4*>(a + e) =
      make_float4(v.x[0], v.x[1], v.x[2], v.x[3]);
}

// The history's storage type H: float, or bf16 (the TPU kernel's
// lbfgs_dtype, pallas_qn.py:128).  A curvature pair is rounded to H
// before its dots, rho and the accept test (pallas_qn.py:335-340), so the
// stored column and its rho agree; every sum and product stays float,
// and a column is widened as it is read (:383).  Vec: four stored values.
template <class H>
struct History;
template <>
struct History<float> {
  using Vec = float4;
  __device__ static float round(float v) { return v; }
  __device__ static V4 widen(Vec v) { return {{v.x, v.y, v.z, v.w}}; }
  __device__ static Vec narrow(const V4& v) {
    return make_float4(v.x[0], v.x[1], v.x[2], v.x[3]);
  }
};
template <>
struct History<__nv_bfloat16> {
  using Vec = uint2;   // two bf16 pairs, the lower element in the low half
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ static unsigned bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
  __device__ static V4 widen(Vec v) {
    return {{__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
             __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u)}};
  }
  __device__ static Vec narrow(const V4& v) {
    return make_uint2(bits(v.x[0]) | bits(v.x[1]) << 16,
                      bits(v.x[2]) | bits(v.x[3]) << 16);
  }
};

// Column col of a history buffer.
template <class H>
__device__ __forceinline__ H* column(void* base, int col, size_t D) {
  return static_cast<H*>(base) + (size_t)col * D;
}
template <class H>
__device__ __forceinline__ V4 ld_hist(const H* col, int e) {
  return History<H>::widen(
      *reinterpret_cast<const typename History<H>::Vec*>(col + e));
}
template <class H>
__device__ __forceinline__ void st_hist(H* col, int e, const V4& v) {
  *reinterpret_cast<typename History<H>::Vec*>(col + e) =
      History<H>::narrow(v);
}

// ---- the flat passes: chunks, lanes, reductions ----

__device__ __forceinline__ unsigned fast_div(unsigned e,
                                             unsigned long long m) {
  return m ? static_cast<unsigned>(__umul64hi(e, m)) : e;
}

// The four elements of vector v of an instance's dual buffer: e the
// offset of the first, n how many lie in the buffer's part (the rest are
// pad), and per element its row r, part (0 xi1, 1 xi2, 2 psi) and the
// index q of the primal entry it pairs with (x for xi, u for psi).  A pad
// element takes the first element's r, part and q, so every lane's loads
// are in bounds and can all be issued before any is used; only its sums
// and primal writes are masked.
struct Lanes {
  int e, n;
  bool psi;
  int r[4], part[4], q[4];
};
__device__ __forceinline__ Lanes lanes(const Args& p, int v) {
  Lanes L;
  const bool xi = v < p.XV;
  const int rel = 4 * (xi ? v : v - p.XV);
  const int W = xi ? 2 * p.nx : p.nu;
  L.e = xi ? rel : p.XP + rel;
  L.n = min(4, (xi ? p.XI : p.PS) - rel);
  L.psi = !xi;
  int r = static_cast<int>(fast_div(rel, xi ? p.mx : p.mu));
  int k = rel - r * W;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int part = xi ? (k >= p.nx ? 1 : 0) : 2;
    const bool pad = j >= L.n;
    L.part[j] = pad ? L.part[0] : part;
    L.r[j] = pad ? L.r[0] : r;
    L.q[j] = pad ? L.q[0] : xi ? r * p.nx + k - (part ? p.nx : 0) : rel + j;
    if (++k == W) {
      k = 0;
      ++r;
    }
  }
  return L;
}

// Runs body(b, c) for this block's run of the (instance b, chunk c)
// items, in order or (reverse) in the other order, skipping the items
// of an instance for which skip(b) holds (asked once an instance: the
// flags it reads do not change within a launch).  Each item is one
// block's work, so body may synchronise the block.
template <class Skip, class Body>
__device__ __forceinline__ void flat_items(int B, int P, bool reverse,
                                           Skip skip, Body body) {
  const int total = B * P;
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * per;
  const int hi = min(total, lo + per);
  int seen = -1;
  bool skipped = false;
  for (int j = lo; j < hi; ++j) {
    const int w = reverse ? total - 1 - j : j;
    const int b = w / P;
    if (b != seen) {
      seen = b;
      skipped = skip(b);
    }
    if (!skipped) body(b, w - b * P);
  }
}

// skip(b) of the flat passes: the solve (or, in a line search, ls, the
// search) of instance b has ended.
template <bool BATCHED>
struct Ended {
  const Args& pb;
  int ls;
  __device__ bool operator()(int b) const {
    const int* st = instance<BATCHED>(pb, b).st;
    return st[I_DONE] || (ls && st[I_LS_DONE]);
  }
};

// Reduces NV values over the block (THREADS threads) in a fixed order,
// warp shuffles then the warps in order, into out[i * ostride].
template <int NV, class Op, int THREADS = FLAT_THREADS>
__device__ __forceinline__ void block_reduce(const float (&v)[NV],
                                             float* out, int ostride,
                                             Op op) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float red[WARPS][NV];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float x = v[i];
    for (int off = 16; off > 0; off >>= 1)
      x = op(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) red[warp][i] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = red[0][threadIdx.x];
    for (int k = 1; k < WARPS; ++k) s = op(s, red[k][threadIdx.x]);
    out[threadIdx.x * ostride] = s;
  }
  __syncthreads();
}

// op over part[j * stride], j < n, in a fixed order (lanes over j, then a
// shuffle tree), returned in every lane of a full warp.
template <class Op>
__device__ __forceinline__ float warp_reduce(const float* part, int n,
                                             int stride, float init, Op op) {
  float v = init;
  for (int j = threadIdx.x & 31; j < n; j += 32)
    v = op(v, part[(size_t)j * stride]);
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  return __shfl_sync(0xffffffffu, v, 0);
}
__device__ __forceinline__ float warp_sum(const float* part, int n,
                                          int stride) {
  return warp_reduce(part, n, stride, 0.f, Add());
}

// out[s][c] = sum_k X[k*RS + s] * M[k*C + c] for one slot's stage rows
// (apg_solve.cu:158).  X is in shared memory, feature-major with row
// stride RS (a multiple of ROW_GROUP, pad rows zero); M is a row-major
// (K, C) matrix in device memory.  emit(s, c, acc) runs for s < N.
template <class Emit>
__device__ __forceinline__ void slot_product(const float* X, int RS, int N,
                                             const float* __restrict__ M,
                                             int K, int C, Emit emit) {
  const int items = (RS / ROW_GROUP) * C;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int grp = item / C;
    const int c = item - grp * C;
    const int s0 = grp * ROW_GROUP;
    float acc[ROW_GROUP];
#pragma unroll
    for (int j = 0; j < ROW_GROUP; ++j) acc[j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float m = __ldg(M + k * C + c);
      const float4 lo = *reinterpret_cast<const float4*>(X + k * RS + s0);
      const float4 hi =
          *reinterpret_cast<const float4*>(X + k * RS + s0 + 4);
      acc[0] = fmaf(lo.x, m, acc[0]);
      acc[1] = fmaf(lo.y, m, acc[1]);
      acc[2] = fmaf(lo.z, m, acc[2]);
      acc[3] = fmaf(lo.w, m, acc[3]);
      acc[4] = fmaf(hi.x, m, acc[4]);
      acc[5] = fmaf(hi.y, m, acc[5]);
      acc[6] = fmaf(hi.z, m, acc[6]);
      acc[7] = fmaf(hi.w, m, acc[7]);
    }
#pragma unroll
    for (int j = 0; j < ROW_GROUP; ++j)
      if (s0 + j < N) emit(s0 + j, c, acc[j]);
  }
}

// ---- the sweep: solve step (AFFINE) or Hessian oracle ----

// Sweep phase 1, one block per slot i (blockIdx.x) of instance blockIdx.y:
// the dual-only terms of the dual direction `in` and the tail recursions
// (apg_solve.cu:195 without the extrapolation).  The tail stages
// (s >= fp) of t and a hold the finished t and inner; the prefix stages
// hold tb and a0 for phase 2.
template <bool AFFINE, bool BATCHED>
__global__ void __launch_bounds__(SLOT_THREADS)
sweep_tail_kernel(Args pb, const float* __restrict__ in_b) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE]) return;
  const float* in = slice<BATCHED>(in_b, blockIdx.y, p.D);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, nv = p.nv;
  const int RS = p.RS, fp = p.fp, i = blockIdx.x;
  float* gwT = smem;               // (nu, RS)  g * in_psi
  float* tT = gwT + nu * RS;       // (nx, RS)  t
  float* aT = tT + nx * RS;        // (nv, RS)  a, then inner
  const float* in_psi = in + p.XP;

  for (int idx = threadIdx.x; idx < RS * nx; idx += blockDim.x) {
    const int s = idx / nx, k = idx - s * nx;
    float tb = 0.f;
    if (s < N) {
      const size_t r = (size_t)s * ns + i;
      const size_t o1 = r * 2 * nx + k;
      tb = p.d1[r * nx + k] * in[o1] + p.d2[r * nx + k] * in[o1 + nx];
    }
    tT[k * RS + s] = tb;
  }
  for (int idx = threadIdx.x; idx < RS * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    float gw = 0.f;
    if (s < N) {
      const size_t o = ((size_t)s * ns + i) * nu + k;
      gw = p.g[o] * in_psi[o];
    }
    gwT[k * RS + s] = gw;
  }
  __syncthreads();

  // a = [beta +] (g in_psi) L; meanwhile the suffix cumsum of t over the
  // tail stages fp..N-1 (disjoint buffers)
  slot_product(gwT, RS, N, p.L, nu, nv, [&](int s, int c, float acc) {
    if constexpr (AFFINE)
      aT[c * RS + s] = p.beta[((size_t)s * ns + i) * nv + c] + acc;
    else
      aT[c * RS + s] = acc;
  });
  for (int k = threadIdx.x; k < nx; k += blockDim.x)
    for (int s = N - 2; s >= fp; --s) tT[k * RS + s] += tT[k * RS + s + 1];
  __syncthreads();

  // tail stages: a += t Bb'
  slot_product(tT, RS, N, p.BbT, nx, nv, [&](int s, int c, float acc) {
    if (s >= fp) aT[c * RS + s] += acc;
  });
  __syncthreads();

  // inner = suffix cumsum of a over the tail
  for (int c = threadIdx.x; c < nv; c += blockDim.x)
    for (int s = N - 2; s >= fp; --s) aT[c * RS + s] += aT[c * RS + s + 1];
  __syncthreads();

  for (int idx = threadIdx.x; idx < N * nx; idx += blockDim.x) {
    const int s = idx / nx, k = idx - s * nx;
    p.t[((size_t)s * ns + i) * nx + k] = tT[k * RS + s];
  }
  for (int idx = threadIdx.x; idx < N * nv; idx += blockDim.x) {
    const int s = idx / nv, c = idx - s * nv;
    p.a[((size_t)s * ns + i) * nv + c] = aT[c * RS + s];
  }
}

// Sweep phase 2, one block per instance (blockIdx.x): the branching
// prefix, stages fp-1..0, which couples the slots through the
// child->parent sums Cs[s] (identity where the tree does not branch).
// Overwrites a at the prefix stages with inner (apg_solve.cu:270).
template <bool BATCHED>
__global__ void __launch_bounds__(PREFIX_THREADS)
sweep_prefix_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.x);
  if (p.st[I_DONE]) return;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, ns = p.ns, nx = p.nx, nv = p.nv, fp = p.fp;
  float* q = smem;              // (ns, nx)  carried t
  float* r = q + ns * nx;       // (ns, nv)  carried inner
  float* tS = r + ns * nv;      // (ns, nx)  t of the current stage
  float* inS = tS + ns * nx;    // (ns, nv)  inner of the current stage

  for (int idx = threadIdx.x; idx < ns * nx; idx += blockDim.x)
    q[idx] = fp < N ? p.t[(size_t)fp * ns * nx + idx] : 0.f;
  for (int idx = threadIdx.x; idx < ns * nv; idx += blockDim.x)
    r[idx] = fp < N ? p.a[(size_t)fp * ns * nv + idx] : 0.f;
  __syncthreads();

  for (int s = fp - 1; s >= 0; --s) {
    const float* tb = p.t + (size_t)s * ns * nx;
    float* as = p.a + (size_t)s * ns * nv;
    for (int idx = threadIdx.x; idx < ns * nx; idx += blockDim.x)
      tS[idx] = tb[idx] + q[idx];
    __syncthreads();
    for (int idx = threadIdx.x; idx < ns * nv; idx += blockDim.x) {
      const int si = idx / nv, c = idx - si * nv;
      float acc = 0.f;
      for (int k = 0; k < nx; ++k)
        acc = fmaf(tS[si * nx + k], __ldg(p.BbT + k * nv + c), acc);
      const float in = as[idx] + r[idx] + acc;
      inS[idx] = in;
      as[idx] = in;
    }
    __syncthreads();
    if (s > 0) {
      const float* C = p.Cs + (size_t)s * ns * ns;
      for (int idx = threadIdx.x; idx < ns * nx; idx += blockDim.x) {
        const int si = idx / nx, k = idx - si * nx;
        float acc = 0.f;
        for (int j = 0; j < ns; ++j)
          acc = fmaf(__ldg(C + si * ns + j), tS[j * nx + k], acc);
        q[idx] = acc;
      }
      for (int idx = threadIdx.x; idx < ns * nv; idx += blockDim.x) {
        const int si = idx / nv, c = idx - si * nv;
        float acc = 0.f;
        for (int j = 0; j < ns; ++j)
          acc = fmaf(__ldg(C + si * ns + j), inS[j * nv + c], acc);
        r[idx] = acc;
      }
    }
    __syncthreads();
  }
}

// Sweep phase 3, one block per slot and instance: v, the forward
// cumsums, and x and u into out_x / out_u (apg_solve.cu:354).
template <bool AFFINE, bool BATCHED>
__global__ void __launch_bounds__(SLOT_THREADS)
sweep_forward_kernel(Args pb, float* __restrict__ out_x_b,
                     float* __restrict__ out_u_b) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE]) return;
  const size_t R = (size_t)p.N * p.ns;
  float* out_x = slice<BATCHED>(out_x_b, blockIdx.y, R * p.nx);
  float* out_u = slice<BATCHED>(out_u_b, blockIdx.y, R * p.nu);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, nv = p.nv;
  const int RS = p.RS, i = blockIdx.x;
  float* aT = smem;             // (nv, RS)  inner
  float* vT = aT + nv * RS;     // (nv, RS)  v
  float* uT = vT + nv * RS;     // (nu, RS)  v L', then u
  float* xT = uT + nu * RS;     // (nx, RS)  [e +] u B', then x

  for (int idx = threadIdx.x; idx < RS * nv; idx += blockDim.x) {
    const int s = idx / nv, c = idx - s * nv;
    aT[c * RS + s] = s < N ? p.a[((size_t)s * ns + i) * nv + c] : 0.f;
    vT[c * RS + s] = 0.f;
  }
  for (int idx = threadIdx.x; idx < RS * nu; idx += blockDim.x)
    uT[idx] = 0.f;
  __syncthreads();

  slot_product(aT, RS, N, p.iWT, nv, nv, [&](int s, int c, float acc) {
    vT[c * RS + s] = p.nhp[(size_t)s * ns + i] * acc;
  });
  __syncthreads();
  slot_product(vT, RS, N, p.LT, nv, nu, [&](int s, int c, float acc) {
    uT[c * RS + s] = acc;
  });
  __syncthreads();
  for (int k = threadIdx.x; k < nu; k += blockDim.x) {
    float du = 0.f;
    for (int s = 0; s < N; ++s) {
      du += uT[k * RS + s];
      if constexpr (AFFINE)
        uT[k * RS + s] =
            p.uhat[((size_t)s * ns + i) * nu + k] + (du + p.pdu[k]);
      else
        uT[k * RS + s] = du;
    }
  }
  __syncthreads();
  slot_product(uT, RS, N, p.BT, nu, nx, [&](int s, int c, float acc) {
    if constexpr (AFFINE)
      xT[c * RS + s] = p.e[((size_t)s * ns + i) * nx + c] + acc;
    else
      xT[c * RS + s] = acc;
  });
  __syncthreads();
  for (int k = threadIdx.x; k < nx; k += blockDim.x) {
    float xa = 0.f;
    for (int s = 0; s < N; ++s) {
      xa += xT[k * RS + s];
      if constexpr (AFFINE)
        xT[k * RS + s] = xa + p.x0[k];
      else
        xT[k * RS + s] = xa;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * nx; idx += blockDim.x) {
    const int s = idx / nx, k = idx - s * nx;
    out_x[((size_t)s * ns + i) * nx + k] = xT[k * RS + s];
  }
  for (int idx = threadIdx.x; idx < N * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    out_u[((size_t)s * ns + i) * nu + k] = uT[k * RS + s];
  }
}

// ---- prox, residual, FBE value ----

// Flat: the prox of g at (x, u) and the dual w (apg_solve.cu:406-436):
// the projection differences into df and this chunk's partials of the
// two penalty norms.  The solve step (ls = 0) takes w from w_b (y); a
// line-search trial (ls = 1, w_b = w) first applies its cumulative step
// tau: w += tau wd and u += tau hu in place, and x + tau hx in registers
// (the residual pass writes it), and returns once the search is done.
template <bool BATCHED>
__global__ void __launch_bounds__(FLAT_THREADS, FLAT_BLOCKS_PER_SM)
prox_kernel(Args pb, const float* __restrict__ w_b, int ls) {
  flat_items(pb.B, pb.P, false, Ended<BATCHED>{pb, ls}, [&](int b, int c) {
    const Args p = instance<BATCHED>(pb, b);
    const float* w = slice<BATCHED>(w_b, b, p.D);
    const int v = c * FLAT_THREADS + threadIdx.x;
    float sums[2] = {0.f, 0.f};
    if (v < p.DV) {
      const Lanes L = lanes(p, v);
      const float tau = ls ? p.sc[S_TAU] : 0.f;
      // every operand first: the primal entry, its step, the map of the
      // part (d1, d2 or g) and its box, the row weight
      V4 wv = ld4(w, L.e);
      const V4 dv = ls ? ld4(p.wd, L.e) : V4{};
      const float* prim = L.psi ? p.u : p.x;
      const float* dprim = L.psi ? p.hu : p.hx;
      float pv[4], hv[4], mv[4], lo[4], hi[4], rp[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = L.q[j], part = L.part[j];
        pv[j] = prim[q];
        hv[j] = ls ? dprim[q] : 0.f;
        mv[j] = (part == 2 ? p.g : part ? p.d2 : p.d1)[q];
        lo[j] = (part == 2 ? p.umin : part ? p.xs : p.xmin)[q];
        hi[j] = part == 1 ? p.xs_upper : (part == 2 ? p.umax : p.xmax)[q];
        rp[j] = p.rep[L.r[j]];
      }
      V4 df;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ls) {
          wv.x[j] = fmaf(tau, dv.x[j], wv.x[j]);
          pv[j] = fmaf(tau, hv[j], pv[j]);
        }
        const float pre = mv[j] * pv[j] + p.c * wv.x[j];
        const float d = pre - clip(pre, lo[j], hi[j]);
        df.x[j] = j < L.n ? d : 0.f;
        if (j < L.n && !L.psi) {
          const float sq = rp[j] * d * d;
          if (L.part[j])
            sums[1] += sq;
          else
            sums[0] += sq;
        }
      }
      if (ls) {
        st4(p.w, L.e, wv);
        // u pairs with one dual entry, written here; x with two, written
        // by the residual pass
        if (L.psi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < L.n) p.u[L.q[j]] = pv[j];
      }
      st4(p.df, L.e, df);
    }
    block_reduce(sums, p.norm_part + 2 * c, 1, Add());
  });
}

// Flat: the shrink factors (from the instance's norm partials in their
// fixed order), the residual r = (1 - k) df - c w into rs and this
// chunk's partials of <w, r> and <r, r>.  copy_w: also w -> p.w (the
// solve step, at w = y).  ls: a line-search trial, which writes the
// trial's x = x + tau hx (as the prox computed it) and returns once the
// search is done.
template <bool BATCHED>
__global__ void __launch_bounds__(FLAT_THREADS, FLAT_BLOCKS_PER_SM - 1)
residual_kernel(Args pb, const float* __restrict__ w_b, int copy_w,
                int ls) {
  __shared__ float k12[2];
  int held = -1;                 // the instance whose shrinks k12 holds
  flat_items(pb.B, pb.P, false, Ended<BATCHED>{pb, ls}, [&](int b, int c) {
    const Args p = instance<BATCHED>(pb, b);
    const float* w = slice<BATCHED>(w_b, b, p.D);
    const int v = c * FLAT_THREADS + threadIdx.x;
    const bool act = v < p.DV;
    const Lanes L = lanes(p, act ? v : 0);
    // every operand first, then the shrinks (once an instance a block)
    V4 wv{}, dfv{};
    float rp[4], xv[4], hv[4];
    if (act) {
      wv = ld4(w, L.e);
      dfv = ld4(p.df, L.e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rp[j] = p.rep[L.r[j]];
        const bool own = ls && L.part[j] == 0;
        xv[j] = own ? p.x[L.q[j]] : 0.f;
        hv[j] = own ? p.hx[L.q[j]] : 0.f;
      }
    }
    if (held != b) {
      if (threadIdx.x < 32) {
        const float n1 = warp_sum(p.norm_part, p.P, 2);
        const float n2 = warp_sum(p.norm_part + 1, p.P, 2);
        if (threadIdx.x == 0) {
          k12[0] = shrink(n1, p.t1c);
          k12[1] = shrink(n2, p.t2c);
        }
      }
      __syncthreads();
      held = b;
    }
    float sums[2] = {0.f, 0.f};
    if (act) {
      const float k1 = k12[0], k2 = k12[1], cc = p.c;
      const float tau = ls ? p.sc[S_TAU] : 0.f;
      V4 res;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int part = L.part[j];
        const float kk = part == 0 ? k1 : part == 1 ? k2 : 0.f;
        res.x[j] = (1.f - kk) * dfv.x[j] - cc * wv.x[j];
        if (j >= L.n) continue;
        sums[0] += rp[j] * wv.x[j] * res.x[j];
        sums[1] += rp[j] * res.x[j] * res.x[j];
        // the trial's x, as the prox computed it
        if (ls && part == 0) p.x[L.q[j]] = fmaf(tau, hv[j], xv[j]);
      }
      // a trial's residual is needed only for its sums: the dual update
      // forms the last one again from df and w
      if (!ls) st4(p.rs, L.e, res);
      if (copy_w) st4(p.w, L.e, wv);
    }
    block_reduce(sums, p.val_part + 2 * c, 1, Add());
  });
}

// The smoothing and economic costs sum p du' W du + sum p u' alpha
// (du = u - u of the parent, the root's from prev_u), as a tiled FP32
// product over G tiles of TM rows an instance, the blocks striding over
// the (instance, tile) items: W' in shared memory (one slab of KS rows
// when KS = nu, loaded once a block by cp.async), du' of the tile's rows
// beside it (STAGE_BATCH loads of u in flight a thread), a TILE_ROWS x
// TILE_COLS register tile a thread whose two column runs sit half a row
// apart (consecutive threads read consecutive 16-byte words of W'), the
// quadratic form and the economic cost in the epilogue, one partial pair
// per tile after the instance's residual partials.  ls: a line-search
// trial, which returns once the search is done.
template <bool BATCHED>
__global__ void __launch_bounds__(SMOOTH_THREADS, SMOOTH_BLOCKS_PER_SM)
smooth_kernel(Args pb, int ls) {
  extern __shared__ float4 smem4[];
  const int nu = pb.nu, ns = pb.ns, NCP = pb.NCP, TM = pb.TM, KS = pb.KS;
  float* Ws = reinterpret_cast<float*>(smem4);   // (KS, NCP)  W' slab
  float* duT = Ws + (size_t)KS * NCP;            // (KS, TM)   du' slab
  const int col_groups = NCP / TILE_COLS, half = NCP / 2;
  const int units = col_groups * (TM / TILE_ROWS);
  // du' is stored swizzled: the 4-row group g of slab row kk sits at
  // group g ^ (kk & sw), so the staging's stores (consecutive kk) spread
  // over the banks while every 4-row group stays one 16-byte word
  const int groups = TM / 4;
  const int sw = min(8, groups & -groups) - 1;
  const int R = pb.N * ns;
  bool held = false;                             // W' whole in Ws
  for (int it = blockIdx.x; it < pb.B * pb.G; it += gridDim.x) {
    const int b = it / pb.G, tile = it - b * pb.G;
    const Args p = instance<BATCHED>(pb, b);
    if (p.st[I_DONE] || (ls && p.st[I_LS_DONE])) continue;
    const int r0 = tile * TM, rows = min(TM, R - r0);
    float sums[2] = {0.f, 0.f};
    for (int u0 = 0; u0 < units; u0 += SMOOTH_THREADS) {
      const int unit = u0 + threadIdx.x;
      const bool act = unit < units;
      const int rg = act ? unit / col_groups : 0;
      const int cg = unit - rg * col_groups;
      float acc[TILE_ROWS][TILE_COLS];
#pragma unroll
      for (int i = 0; i < TILE_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < TILE_COLS; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < nu; k0 += KS) {
        const int kn = min(KS, nu - k0);
        if (u0 > 0) __syncthreads();   // the last round's epilogue read duT
        if (!held) {
          // W'[k0 .. k0+kn) by cp.async, two floats a copy where its rows
          // are 8-byte aligned (nu even), its pad columns zero
          const int width = nu % 2 == 0 ? 2 : 1, per_row = NCP / width;
          int kk = threadIdx.x / per_row, cw = threadIdx.x - kk * per_row;
          const int dk = SMOOTH_THREADS / per_row;
          const int dc = SMOOTH_THREADS % per_row;
          for (int idx = threadIdx.x; idx < kn * per_row;
               idx += SMOOTH_THREADS) {
            const int col = cw * width;
            float* dst = Ws + kk * NCP + col;
            const float* src = p.WT + (size_t)(k0 + kk) * nu + col;
            if (col >= nu) {
              dst[0] = 0.f;
              if (width == 2) dst[1] = 0.f;
            } else if (width == 2) {
              cp_async8(dst, src);
            } else {
              cp_async4(dst, src);
            }
            kk += dk;
            cw += dc;
            if (cw >= per_row) {
              cw -= per_row;
              ++kk;
            }
          }
          held = KS >= nu;
        }
        // du' of the tile's rows (pad rows zero) from one read of u:
        // STAGE_BATCH elements and their parents a thread, every load
        // issued (a lane past the slab reads the first element) before
        // any is stored
        {
          int row = threadIdx.x / kn, kk = threadIdx.x - row * kn;
          const int dr = SMOOTH_THREADS / kn, dk = SMOOTH_THREADS % kn;
          for (int base = threadIdx.x; base < TM * kn;
               base += STAGE_BATCH * SMOOTH_THREADS) {
            float cur[STAGE_BATCH], par[STAGE_BATCH];
            int at[STAGE_BATCH];
            bool pad[STAGE_BATCH];
#pragma unroll
            for (int j = 0; j < STAGE_BATCH; ++j) {
              const bool in = base + j * SMOOTH_THREADS < TM * kn;
              const int rw = in ? row : 0, kc = in ? kk : 0;
              const int r = r0 + min(rw, rows - 1), k = k0 + kc;
              const float* up = r >= ns ? p.u + (size_t)(r - ns) * nu : p.pu;
              cur[j] = p.u[(size_t)r * nu + k];
              par[j] = up[k];
              pad[j] = rw >= rows;
              at[j] = in ? kc * TM + (((rw >> 2) ^ (kc & sw)) << 2) + (rw & 3)
                         : -1;
              row += dr;
              kk += dk;
              if (kk >= kn) {
                kk -= kn;
                ++row;
              }
            }
#pragma unroll
            for (int j = 0; j < STAGE_BATCH; ++j)
              if (at[j] >= 0) duT[at[j]] = pad[j] ? 0.f : cur[j] - par[j];
          }
        }
        cp_async_wait_all();
        __syncthreads();
        if (act) {
          const float* wlo = Ws + cg * 4;
          const float* whi = wlo + half;
#pragma unroll 2
          for (int kk = 0; kk < kn; ++kk) {
            float av[TILE_ROWS];
#pragma unroll
            for (int i = 0; i < TILE_ROWS; i += 4) {
              const int g = (rg * TILE_ROWS + i) >> 2;
              const float4 a = *reinterpret_cast<const float4*>(
                  duT + kk * TM + ((g ^ (kk & sw)) << 2));
              av[i] = a.x;
              av[i + 1] = a.y;
              av[i + 2] = a.z;
              av[i + 3] = a.w;
            }
            const float4 w0 = *reinterpret_cast<const float4*>(wlo + kk * NCP);
            const float4 w1 = *reinterpret_cast<const float4*>(whi + kk * NCP);
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < TILE_ROWS; ++i)
#pragma unroll
              for (int j = 0; j < TILE_COLS; ++j)
                acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
      if (!act) continue;
      // the epilogue: each row's operands first (a pad row or column
      // reads the last real one, masked), du' from duT when it holds
      // every column
      const bool whole = KS >= nu;
#pragma unroll
      for (int i = 0; i < TILE_ROWS; ++i) {
        const int row = rg * TILE_ROWS + i;
        const int r = r0 + min(row, rows - 1);
        const float* ur = p.u + (size_t)r * nu;
        const float* up = r >= ns ? p.u + (size_t)(r - ns) * nu : p.pu;
        const float* al = p.alpha + (size_t)r * nu;
        const float rp = p.rep[r] * p.prob[r];
        float uc[TILE_COLS], av[TILE_COLS], du[TILE_COLS];
#pragma unroll
        for (int j = 0; j < TILE_COLS; ++j) {
          const int col = min((j < 4 ? 0 : half - 4) + cg * 4 + j, nu - 1);
          uc[j] = ur[col];
          av[j] = al[col];
          du[j] = whole ? duT[col * TM + (((row >> 2) ^ (col & sw)) << 2) +
                              (row & 3)]
                        : uc[j] - up[col];
        }
        if (row >= rows) continue;
#pragma unroll
        for (int j = 0; j < TILE_COLS; ++j) {
          if ((j < 4 ? 0 : half - 4) + cg * 4 + j >= nu) continue;
          sums[0] += rp * du[j] * acc[i][j];
          sums[1] += rp * uc[j] * av[j];
        }
      }
    }
    block_reduce<2, Add, SMOOTH_THREADS>(sums,
                                         p.val_part + 2 * p.P + 2 * tile, 1,
                                         Add());
  }
}

// The FBE value (computeValueFbe, src/SmpcController.cu:1417-1476) from
// the partials, in a fixed order; every lane of a full warp.
__device__ float fbe_value(const Args& p) {
  const float n1 = warp_sum(p.norm_part, p.P, 2);
  const float n2 = warp_sum(p.norm_part + 1, p.P, 2);
  const float wr = warp_sum(p.val_part, p.P, 2);
  const float rr = warp_sum(p.val_part + 1, p.P, 2);
  const float* sp = p.val_part + 2 * p.P;
  const float sm = warp_sum(sp, p.G, 2);
  const float ec = warp_sum(sp + 1, p.G, 2);
  // the g-values: penalty * distance of the post-prox point from its set,
  // k * dist (pallas_qn.py:247-248)
  const float dist1 = sqrtf(n1), dist2 = sqrtf(n2);
  const float k1 = shrink(n1, p.t1c), k2 = shrink(n2, p.t2c);
  const float vg = (k1 > 0.f ? p.pstate * k1 * dist1 : 0.f) +
                   (k2 > 0.f ? p.psafety * k2 * dist2 : 0.f);
  return wr + 0.5f * p.step * rr + vg + sm + ec;
}

// ---- L-BFGS, line search, dual update ----

// Flat: yvec (FBE: -(r + step H(r)), from H(r) in hx, hu; NAMA: -r), the
// two-loop's start dd = -yvec, and this chunk's partials of <yvec, yvec>,
// <s, yd>, <yd, yd> and <s, s> for the curvature pair s = y - y_prev,
// yd = yvec - yvec_prev, each rounded to the history's storage.
template <class H, bool BATCHED>
__global__ void __launch_bounds__(FLAT_THREADS, FLAT_BLOCKS_PER_SM)
lbfgs_dots_kernel(Args pb, int is_fbe) {
  flat_items(pb.B, pb.P, false, Ended<BATCHED>{pb, 0}, [&](int b, int c) {
    const Args p = instance<BATCHED>(pb, b);
    const int v = c * FLAT_THREADS + threadIdx.x;
    float sums[4] = {0.f, 0.f, 0.f, 0.f};
    if (v < p.DV) {
      const Lanes L = lanes(p, v);
      const V4 rsv = ld4(p.rs, L.e), yv = ld4(p.y, L.e),
               ypv = ld4(p.yp, L.e), yvpv = ld4(p.yvp, L.e);
      const float* hprim = L.psi ? p.hu : p.hx;
      float mv[4], hv[4], rp[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = L.q[j], part = L.part[j];
        mv[j] = is_fbe ? (part == 2 ? p.g : part ? p.d2 : p.d1)[q] : 0.f;
        hv[j] = is_fbe ? hprim[q] : 0.f;
        rp[j] = p.rep[L.r[j]];
      }
      const float step = p.step;
      V4 out, neg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float vv =
            is_fbe ? -(rsv.x[j] + step * (mv[j] * hv[j])) : -rsv.x[j];
        out.x[j] = vv;
        neg.x[j] = -vv;
        if (j >= L.n) continue;
        const float s = History<H>::round(yv.x[j] - ypv.x[j]);
        const float yd = History<H>::round(vv - yvpv.x[j]);
        sums[0] += rp[j] * vv * vv;
        sums[1] += rp[j] * s * yd;
        sums[2] += rp[j] * yd * yd;
        sums[3] += rp[j] * s * s;
      }
      st4(p.yv, L.e, out);
      st4(p.dd, L.e, neg);
    }
    block_reduce(sums, p.dot_part + 4 * c, 1, Add());
  });
}

// One warp per instance: the FBE value before the search, the L-BFGS
// accept test and buffer bookkeeping (updateLbfgsBuffer,
// src/SmpcController.cu:1103-1177) and the Hessian scale.
template <bool BATCHED>
__global__ void lbfgs_update_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.x);
  if (p.st[I_DONE]) return;
  const float gg = warp_sum(p.dot_part, p.P, 4);
  const float sy = warp_sum(p.dot_part + 1, p.P, 4);
  const float yy = warp_sum(p.dot_part + 2, p.P, 4);
  const float ss = warp_sum(p.dot_part + 3, p.P, 4);
  const float value = fbe_value(p);
  if (threadIdx.x != 0) return;
  p.sc[S_VALUE_REF] = value;
  float norm_grad = sqrtf(gg);
  if (norm_grad < 1.f) norm_grad = norm_grad * norm_grad * norm_grad;
  const bool accept = sy / fmaxf(ss, 1e-30f) > 1e-6f * norm_grad;
  int col = p.st[I_COL], mem = p.st[I_MEM];
  if (accept) {
    col = 1 + col % p.bs;
    mem = mem + 1 < p.bs ? mem + 1 : p.bs;
    p.sc[S_RHO + col] = 1.f / sy;
  } else {
    p.st[I_SKIPS] += 1;
  }
  p.st[I_ACCEPT] = accept;
  p.st[I_COL] = col;
  p.st[I_MEM] = mem;
  const float gamma = sy / fmaxf(yy, 1e-30f);
  const float hess = p.sc[S_HESS];
  p.sc[S_HESS] = (gamma < 0.f || fabsf(gamma - hess) == 0.f) ? 1.f : gamma;
}

// Column of the two-loop's step q (q < bs: the first loop's i = q, else
// the second's j = q - bs; twoLoopRecursionLbfgs,
// src/SmpcController.cu:1182-1232) and whether it is active (< mem); an
// inactive step reads the zero column 0, as pallas_qn.py:379-382 does.
__device__ __forceinline__ int loop_column(int q, int bs, int col, int mem,
                                           bool* active) {
  int icol;
  if (q < bs) {
    *active = q < mem;
    icol = col - q;
  } else {
    *active = q - bs < mem;
    icol = col - (mem - (q - bs)) + 1;
  }
  if (!*active) return 0;
  return icol < 0 ? mem + icol : icol;
}

// Flat: the accepted pair into its column, and this chunk's partial of
// the first two-loop step's dot <s_col, dd>.
template <class H, bool BATCHED>
__global__ void __launch_bounds__(FLAT_THREADS, FLAT_BLOCKS_PER_SM)
lbfgs_store_kernel(Args pb) {
  flat_items(pb.B, pb.P, false, Ended<BATCHED>{pb, 0}, [&](int b, int c) {
    const Args p = instance<BATCHED>(pb, b);
    const int col = p.st[I_COL], mem = p.st[I_MEM];
    const bool accept = p.st[I_ACCEPT];
    H* ms = column<H>(p.ms, col, p.D);
    H* my = column<H>(p.my, col, p.D);
    const int v = c * FLAT_THREADS + threadIdx.x;
    float sums[1] = {0.f};
    if (v < p.DV) {
      const Lanes L = lanes(p, v);
      V4 sv;
      if (accept) {
        const V4 yv = ld4(p.y, L.e), ypv = ld4(p.yp, L.e),
                 vv = ld4(p.yv, L.e), vpv = ld4(p.yvp, L.e);
        V4 ydv;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sv.x[j] = yv.x[j] - ypv.x[j];
          ydv.x[j] = vv.x[j] - vpv.x[j];
        }
        st_hist<H>(ms, L.e, sv);
        st_hist<H>(my, L.e, ydv);
#pragma unroll
        for (int j = 0; j < 4; ++j) sv.x[j] = History<H>::round(sv.x[j]);
      } else {
        sv = ld_hist<H>(ms, L.e);
      }
      if (mem > 0) {
        const V4 dv = ld4(p.dd, L.e);
        float rp[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) rp[j] = p.rep[L.r[j]];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < L.n) sums[0] += rp[j] * sv.x[j] * dv.x[j];
      }
    }
    block_reduce(sums, p.pp + c, 1, Add());
  });
}

// Flat: step q of the two-loop recursion.  The coefficient comes from the
// step's dot partials (pp[q & 1]) in their fixed order while the step's
// history columns arrive by cp.async: the first loop does dd -= a y_col
// with a = rho dot (chunk 0 keeps a as alpha[col]), the second dd +=
// (alpha[col] - rho dot) s_col; after the first loop's last step dd *=
// the Hessian scale.  Then this chunk's partial of the next step's dot
// into pp[(q + 1) & 1] or, after the last step, of the line search's
// direction value (FBE: <yvec, dd>; NAMA: <r, dd>, whose search
// direction wd = dd - step r is formed here).  Odd steps walk the chunks
// in the other order.
template <class H, bool BATCHED>
__global__ void __launch_bounds__(FLAT_THREADS, FLAT_BLOCKS_PER_SM)
two_loop_kernel(Args pb, int q, int is_fbe) {
  using Vec = typename History<H>::Vec;
  __shared__ Vec mbuf[FLAT_THREADS], vbuf[FLAT_THREADS];
  __shared__ float coef_s;
  const uint64_t pol = evict_first();
  int held = -1;                 // the instance whose coefficient coef_s is
  flat_items(pb.B, pb.P, q & 1, Ended<BATCHED>{pb, 0}, [&](int b, int c) {
    const Args p = instance<BATCHED>(pb, b);
    const int bs = p.bs, col = p.st[I_COL], mem = p.st[I_MEM];
    bool act, nact = false;
    const int icol = loop_column(q, bs, col, mem, &act);
    const H* M = column<H>(q < bs ? p.my : p.ms, icol, p.D);
    const H* V = nullptr;         // the next step's other factor
    if (q + 1 < 2 * bs) {
      const int ncol = loop_column(q + 1, bs, col, mem, &nact);
      V = column<H>(q + 1 < bs ? p.ms : p.my, ncol, p.D);
    }
    const int v = c * FLAT_THREADS + threadIdx.x;
    const bool on = v < p.DV;
    const Lanes L = lanes(p, on ? v : 0);
    if (on) {
      if (act) cp_async_hint(mbuf + threadIdx.x, M + L.e, pol, (Vec*)nullptr);
      if (nact)
        cp_async_hint(vbuf + threadIdx.x, V + L.e, pol, (Vec*)nullptr);
    }
    const bool last = q == 2 * bs - 1, nama = !is_fbe;
    V4 dv{}, ov{};
    float rp[4];
    if (on) {
      dv = ld4(p.dd, L.e);
      if (last) ov = ld4(nama ? p.rs : p.yv, L.e);
#pragma unroll
      for (int j = 0; j < 4; ++j) rp[j] = p.rep[L.r[j]];
    }
    // the coefficient, once an instance a block (chunk 0's block keeps
    // alpha); every block sums the partials in the same order
    if (held != b || (c == 0 && q < bs)) {
      if (threadIdx.x < 32) {
        float coef = 0.f;
        if (act) {
          const float dot = warp_sum(p.pp + (q & 1) * p.P, p.P, 1);
          const float* rho = p.sc + S_RHO;
          float* alpha = p.sc + S_RHO + bs + 1;
          const float a = rho[icol] * dot;
          if (q < bs) {
            coef = -a;
            if (c == 0 && threadIdx.x == 0) alpha[icol] = a;
          } else {
            coef = alpha[icol] - a;
          }
        }
        if (threadIdx.x == 0) coef_s = coef;
      }
      held = b;
    }
    cp_async_wait_all();
    __syncthreads();
    float sums[1] = {0.f};
    if (on) {
      const float coef = coef_s, hess = p.sc[S_HESS], step = p.step;
      const V4 mv = act ? History<H>::widen(mbuf[threadIdx.x]) : V4{};
      const V4 nv = nact ? History<H>::widen(vbuf[threadIdx.x]) : V4{};
      V4 wdv;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float d = dv.x[j];
        if (act) d = d + coef * mv.x[j];
        if (q == bs - 1) d = hess * d;
        dv.x[j] = d;
        if (last && nama) wdv.x[j] = d - step * ov.x[j];
        if (j >= L.n) continue;
        if (nact) sums[0] += rp[j] * nv.x[j] * d;
        if (last) sums[0] += rp[j] * ov.x[j] * d;
      }
      st4(p.dd, L.e, dv);
      if (last && nama) st4(p.wd, L.e, wdv);
    }
    block_reduce(sums, p.pp + ((q + 1) & 1) * p.P + c, 1, Add());
  });
}

// Flat, NAMA only: the unconditional residual step w += step r,
// x += step H(r), u += step H(r) (pallas_qn.py:436-441).
template <bool BATCHED>
__global__ void __launch_bounds__(FLAT_THREADS, FLAT_BLOCKS_PER_SM)
nama_step_kernel(Args pb) {
  flat_items(pb.B, pb.P, false, Ended<BATCHED>{pb, 0}, [&](int b, int c) {
    const Args p = instance<BATCHED>(pb, b);
    const int v = c * FLAT_THREADS + threadIdx.x;
    if (v >= p.DV) return;
    const Lanes L = lanes(p, v);
    const float step = p.step;
    V4 wv = ld4(p.w, L.e);
    const V4 rv = ld4(p.rs, L.e);
    float* prim = L.psi ? p.u : p.x;
    const float* hprim = L.psi ? p.hu : p.hx;
    float pv[4], hv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pv[j] = prim[L.q[j]];
      hv[j] = hprim[L.q[j]];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wv.x[j] = wv.x[j] + step * rv.x[j];
      // x pairs with two dual entries: the first (part 0) writes it
      if (j < L.n && L.part[j] != 1) prim[L.q[j]] = pv[j] + step * hv[j];
    }
    st4(p.w, L.e, wv);
  });
}

// One warp per instance: the line search's direction value and whether
// it runs (computeLineSearchLbfgsUpdate :1250-1320; the AME variant
// :1326-1414).
template <bool BATCHED>
__global__ void ls_init_kernel(Args pb, int is_fbe) {
  const Args p = instance<BATCHED>(pb, blockIdx.x);
  if (p.st[I_DONE]) return;
  const float sum = warp_sum(p.pp, p.P, 1);
  if (threadIdx.x != 0) return;
  const float dval = is_fbe ? sum : -sum;
  const bool positive = dval > 0.f;
  const bool skip = positive || fabsf(dval) < LS_TOLERANCE;
  p.st[I_POSITIVE] = positive;
  p.st[I_SKIP] = skip;
  p.st[I_LS_DONE] = skip;
  p.sc[S_TAU] = 1.f;
  p.sc[S_APPLIED] = 0.f;
}

// One warp per instance, trial k's end: the trial count, the FBE value
// against the reference; the next cumulative tau increment (1, then
// -1/2, +1/4 - 1/2, ...: solver/quasi_newton.py:190-229), or the
// search's end.
template <bool BATCHED>
__global__ void trial_finish_kernel(Args pb, int k) {
  const Args p = instance<BATCHED>(pb, blockIdx.x);
  if (p.st[I_DONE] || p.st[I_LS_DONE]) return;
  const float val = fbe_value(p);
  if (threadIdx.x != 0) return;
  p.st[I_TRIALS] += 1;
  float tau = p.sc[S_TAU];
  p.sc[S_APPLIED] = tau;
  // a NaN value is no improvement: it ends the search
  const bool improved = val <= p.sc[S_VALUE_REF];
  const float base = k == 0 ? -1.f : tau;
  if (improved && k + 1 < LS_MAX_STEPS) tau = base + ldexpf(1.f, -(k + 1));
  p.sc[S_TAU] = tau;
  if (!improved) p.st[I_LS_DONE] = 1;
}

// Flat: the residual r = (1 - k) df - c w of the point the line search
// left (the shrinks from the instance's norm partials in their fixed
// order, as the residual pass formed it), y_prev <- y, y <- w + step r,
// yvec_prev <- yvec, and this chunk's max / min of r's three blocks.
template <bool BATCHED>
__global__ void __launch_bounds__(FLAT_THREADS, FLAT_BLOCKS_PER_SM)
dual_update_kernel(Args pb) {
  __shared__ float k12[2];
  int held = -1;                 // the instance whose shrinks k12 holds
  flat_items(pb.B, pb.P, false, Ended<BATCHED>{pb, 0}, [&](int b, int c) {
    const Args p = instance<BATCHED>(pb, b);
    const float inf = __int_as_float(0x7f800000);
    float hi[3] = {-inf, -inf, -inf}, lo[3] = {inf, inf, inf};
    const int v = c * FLAT_THREADS + threadIdx.x;
    const bool act = v < p.DV;
    const Lanes L = lanes(p, act ? v : 0);
    V4 dfv{}, yv{}, wv{}, vv{};
    if (act) {
      dfv = ld4(p.df, L.e);
      yv = ld4(p.y, L.e);
      wv = ld4(p.w, L.e);
      vv = ld4(p.yv, L.e);
    }
    if (held != b) {
      if (threadIdx.x < 32) {
        const float n1 = warp_sum(p.norm_part, p.P, 2);
        const float n2 = warp_sum(p.norm_part + 1, p.P, 2);
        if (threadIdx.x == 0) {
          k12[0] = shrink(n1, p.t1c);
          k12[1] = shrink(n2, p.t2c);
        }
      }
      __syncthreads();
      held = b;
    }
    if (act) {
      const float k1 = k12[0], k2 = k12[1], step = p.step;
      V4 yn;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int part = L.part[j];
        const float kk = part == 0 ? k1 : part == 1 ? k2 : 0.f;
        const float res = (1.f - kk) * dfv.x[j] - p.c * wv.x[j];
        yn.x[j] = wv.x[j] + step * res;
        if (j >= L.n) continue;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (part == k) {
            hi[k] = fmaxf(hi[k], res);
            lo[k] = fminf(lo[k], res);
          }
      }
      st4(p.yp, L.e, yv);
      st4(p.y, L.e, yn);
      st4(p.yvp, L.e, vv);
    }
    float* cp = p.champ_part + 6 * c;
    block_reduce(hi, cp, 2, Max());
    block_reduce(lo, cp + 1, 2, Min());
  });
}

// champion update of pallas_qn.py:269-274
__device__ __forceinline__ void champion(float& babs, float& bval,
                                         float hi, float lo) {
  const float cval = hi > -lo ? hi : lo;
  const float cabs = fabsf(cval);
  if (cabs > babs) bval = cval;
  babs = fmaxf(babs, cabs);
}

// One warp per instance: the traces at this iteration (the value and tau
// are zero at the first, qn = 0), the iteration count and, with a
// tolerance, the done flag (the JAX while_loop's test: continue while
// magnitude > tol).
template <bool BATCHED>
__global__ void finish_kernel(Args pb, int qn) {
  const Args p = instance<BATCHED>(pb, blockIdx.x);
  if (p.st[I_DONE]) return;
  const float inf = __int_as_float(0x7f800000);
  float m[6];
#pragma unroll
  for (int j = 0; j < 6; j += 2) {
    m[j] = warp_reduce(p.champ_part + j, p.P, 6, -inf, Max());
    m[j + 1] = warp_reduce(p.champ_part + j + 1, p.P, 6, inf, Min());
  }
  if (threadIdx.x != 0) return;
  float xabs = -1.f, xval = 0.f, pabs = -1.f, pval = 0.f;
  champion(xabs, xval, m[0], m[1]);
  champion(xabs, xval, m[2], m[3]);
  champion(pabs, pval, m[4], m[5]);
  const int it = p.st[I_ITERS];
  p.tr_inf[it] = fmaxf(xval, pval);
  if (qn) {
    p.tr_val[it] = p.sc[S_VALUE_REF];
    p.tr_tau[it] = p.st[I_SKIP] ? (p.st[I_POSITIVE] ? 1.f : 0.f)
                                : fabsf(p.sc[S_APPLIED]);
  }
  p.st[I_ITERS] = it + 1;
  if (p.tol_mode && !(fmaxf(xabs, pabs) > p.tol)) p.st[I_DONE] = 1;
}

// One warp per instance: the scalars of a fresh solve (L-BFGS empty,
// Hessian scale 1).
template <bool BATCHED>
__global__ void init_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.x);
  if (threadIdx.x != 0) return;
  for (int j = 0; j < I_COUNT; ++j) p.st[j] = 0;
  for (int j = 0; j < S_RHO + 2 * (p.bs + 1); ++j) p.sc[j] = 0.f;
  p.sc[S_HESS] = 1.f;
}

cudaError_t set_smem(const void* kernel, size_t bytes, int max_optin) {
  if (bytes > (size_t)max_optin) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

// Every launch of this file: enqueue on `st` and report a refused launch.
template <class... KArgs, class... Actual>
cudaError_t launch(void (*kernel)(KArgs...), dim3 blocks, int threads,
                   size_t smem, cudaStream_t st, Actual... args) {
  kernel<<<blocks, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// Dynamic shared memory (bytes) of the sweeps and of the smoothing
// product: the launch's and, through qn_solve_smem, the routing gate's
// one formula.
struct SolveSmem {
  size_t tail, prefix, fwd, smooth;
};
SolveSmem solve_smem(int N, int ns, int nx, int nu, int nv) {
  const size_t RS = (size_t)(N + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
  return {sizeof(float) * (size_t)(nu + nx + nv) * RS,
          sizeof(float) * 2 * (size_t)(nx + nv) * ns,
          sizeof(float) * (size_t)(2 * nv + nu + nx) * RS,
          (size_t)layout(N, ns, nx, nu).smooth_smem};
}

struct Plan {
  SolveSmem smem;
  dim3 slots;               // (ns, B): one block per slot and instance
  int flat_blocks;          // the flat passes' grid but the residual's
  int res_blocks;           // the residual pass's grid
  int smooth_blocks;        // the smoothing product's grid
};

// The blocks of `kernel` an SM holds at once at this block size and
// dynamic shared memory (at least 1).
int per_sm(const void* kernel, int threads, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    n = 1;
  return n > 0 ? n : 1;
}

// A grid of every block the card holds at once, or of one block per item
// where there are fewer items.
int grid_of(long long items, int sms, int per) {
  const long long most = (long long)sms * per;
  return (int)(items < most ? items : most);
}

#define QN_TRY(call)                             \
  do {                                           \
    const cudaError_t err_ = (call);             \
    if (err_ != cudaSuccess) return err_;        \
  } while (0)

// One tree sweep of the dual direction `in`: the solve step (affine) or
// the Hessian oracle into (ox, ou).
template <bool BATCHED>
cudaError_t enqueue_sweep(const Args& p, const Plan& pl, cudaStream_t st,
                          bool affine, const float* in, float* ox,
                          float* ou) {
  QN_TRY(affine ? launch(sweep_tail_kernel<true, BATCHED>, pl.slots,
                         SLOT_THREADS, pl.smem.tail, st, p, in)
                : launch(sweep_tail_kernel<false, BATCHED>, pl.slots,
                         SLOT_THREADS, pl.smem.tail, st, p, in));
  if (p.fp > 0)
    QN_TRY(launch(sweep_prefix_kernel<BATCHED>, p.B, PREFIX_THREADS,
                  pl.smem.prefix, st, p));
  return affine ? launch(sweep_forward_kernel<true, BATCHED>, pl.slots,
                         SLOT_THREADS, pl.smem.fwd, st, p, ox, ou)
                : launch(sweep_forward_kernel<false, BATCHED>, pl.slots,
                         SLOT_THREADS, pl.smem.fwd, st, p, ox, ou);
}

// One iteration's launches on `st`; qn = false for the first iteration,
// which has no curvature pair and no line search (pallas_qn.py:302).
// The direction and output pointers are instance 0's; each phase moves
// them to its own instance.  H: the history's storage.
template <class H, bool BATCHED>
cudaError_t enqueue_iteration(const Args& p, const Plan& pl, cudaStream_t st,
                              bool qn, bool is_fbe) {
  const int F = pl.flat_blocks, T = FLAT_THREADS, W = p.B;
  const float* y = p.y;
  const float* w = p.w;
  QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, true, p.y, p.x, p.u));
  QN_TRY(launch(prox_kernel<BATCHED>, F, T, 0, st, p, y, 0));
  QN_TRY(launch(residual_kernel<BATCHED>, pl.res_blocks, T, 0, st, p, y, 1,
                0));
  if (qn)
    QN_TRY(launch(smooth_kernel<BATCHED>, pl.smooth_blocks, SMOOTH_THREADS,
                  pl.smem.smooth, st, p, 0));
  if (is_fbe)
    QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, false, p.rs, p.hx, p.hu));
  QN_TRY(launch(lbfgs_dots_kernel<H, BATCHED>, F, T, 0, st, p,
                (int)is_fbe));
  if (qn) {
    QN_TRY(launch(lbfgs_update_kernel<BATCHED>, W, 32, 0, st, p));
    QN_TRY(launch(lbfgs_store_kernel<H, BATCHED>, F, T, 0, st, p));
    for (int q = 0; q < 2 * p.bs; ++q)
      QN_TRY(launch(two_loop_kernel<H, BATCHED>, F, T, 0, st, p, q,
                    (int)is_fbe));
    if (is_fbe) {
      QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, false, p.dd, p.hx, p.hu));
    } else {
      QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, false, p.rs, p.hx, p.hu));
      QN_TRY(launch(nama_step_kernel<BATCHED>, F, T, 0, st, p));
      QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, false, p.wd, p.hx, p.hu));
    }
    QN_TRY(launch(ls_init_kernel<BATCHED>, W, 32, 0, st, p, (int)is_fbe));
    for (int k = 0; k <= LS_MAX_STEPS; ++k) {
      QN_TRY(launch(prox_kernel<BATCHED>, F, T, 0, st, p, w, 1));
      QN_TRY(launch(residual_kernel<BATCHED>, pl.res_blocks, T, 0, st, p, w,
                    0, 1));
      QN_TRY(launch(smooth_kernel<BATCHED>, pl.smooth_blocks,
                    SMOOTH_THREADS, pl.smem.smooth, st, p, 1));
      QN_TRY(launch(trial_finish_kernel<BATCHED>, W, 32, 0, st, p, k));
    }
  }
  QN_TRY(launch(dual_update_kernel<BATCHED>, F, T, 0, st, p));
  return launch(finish_kernel<BATCHED>, W, 32, 0, st, p, (int)qn);
}

// Iterations 1 .. max_it - 1 as one captured graph of one iteration,
// launched once per iteration on `st`.
template <class H, bool BATCHED>
cudaError_t run_graph(const Args& p, const Plan& pl, cudaStream_t st,
                      int max_it, bool is_fbe) {
  cudaStream_t cs;
  QN_TRY(cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking));
  cudaError_t err =
      cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    const cudaError_t enq =
        enqueue_iteration<H, BATCHED>(p, pl, cs, true, is_fbe);
    cudaGraph_t graph = nullptr;
    err = cudaStreamEndCapture(cs, &graph);
    if (enq != cudaSuccess) err = enq;
    if (err == cudaSuccess) {
      cudaGraphExec_t exec = nullptr;
      err = cudaGraphInstantiateWithFlags(&exec, graph, 0);
      for (int it = 1; it < max_it && err == cudaSuccess; ++it)
        err = cudaGraphLaunch(exec, st);
      // in-flight launches complete before the executable is freed
      if (exec) cudaGraphExecDestroy(exec);
    }
    if (graph) cudaGraphDestroy(graph);
  }
  const cudaError_t err2 = cudaStreamDestroy(cs);
  return err != cudaSuccess ? err : err2;
}

// The launch plan of B instances at these sizes: shared-memory limits
// and carveout set, the grids from the kernels' occupancy.
template <class H, bool BATCHED>
cudaError_t make_plan(int N, int ns, int nx, int nu, int nv, int B,
                      Plan* out) {
  Plan pl;
  const Layout l = layout(N, ns, nx, nu);
  pl.smem = solve_smem(N, ns, nx, nu, nv);
  pl.slots = dim3(ns, B);
  int dev = 0, max_optin = 0, sms = 0;
  QN_TRY(cudaGetDevice(&dev));
  QN_TRY(cudaDeviceGetAttribute(&max_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  QN_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  QN_TRY(set_smem((const void*)sweep_tail_kernel<true, BATCHED>,
                  pl.smem.tail, max_optin));
  QN_TRY(set_smem((const void*)sweep_tail_kernel<false, BATCHED>,
                  pl.smem.tail, max_optin));
  QN_TRY(set_smem((const void*)sweep_prefix_kernel<BATCHED>,
                  pl.smem.prefix, max_optin));
  QN_TRY(set_smem((const void*)sweep_forward_kernel<true, BATCHED>,
                  pl.smem.fwd, max_optin));
  QN_TRY(set_smem((const void*)sweep_forward_kernel<false, BATCHED>,
                  pl.smem.fwd, max_optin));
  QN_TRY(set_smem((const void*)smooth_kernel<BATCHED>, pl.smem.smooth,
                  max_optin));
  // the product's blocks share an SM only with the largest carveout
  QN_TRY(cudaFuncSetAttribute((const void*)smooth_kernel<BATCHED>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared));
  // grids: every block an SM holds at once (the chunks and tiles, and so
  // every sum, are the same whatever the grid)
  const void* flat[] = {(const void*)prox_kernel<BATCHED>,
                        (const void*)lbfgs_dots_kernel<H, BATCHED>,
                        (const void*)lbfgs_store_kernel<H, BATCHED>,
                        (const void*)two_loop_kernel<H, BATCHED>,
                        (const void*)nama_step_kernel<BATCHED>,
                        (const void*)dual_update_kernel<BATCHED>};
  int flat_per = FLAT_BLOCKS_PER_SM;
  for (const void* k : flat)
    flat_per = min(flat_per, per_sm(k, FLAT_THREADS, 0));
  const long long items = (long long)B * l.P;
  pl.flat_blocks = grid_of(items, sms, flat_per);
  pl.res_blocks = grid_of(
      items, sms,
      per_sm((const void*)residual_kernel<BATCHED>, FLAT_THREADS, 0));
  pl.smooth_blocks = grid_of(
      (long long)B * l.G, sms,
      per_sm((const void*)smooth_kernel<BATCHED>, SMOOTH_THREADS,
             pl.smem.smooth));
  *out = pl;
  return cudaSuccess;
}

// The whole call: the plan, the history's zero columns, the scalars, the
// first iteration and the graph of the rest.
template <class H, bool BATCHED>
cudaError_t run_solve(const Args& p, cudaStream_t st, int max_it,
                      bool is_fbe) {
  Plan pl;
  QN_TRY((make_plan<H, BATCHED>(p.N, p.ns, p.nx, p.nu, p.nv, p.B, &pl)));

  // column 0 of each instance's history stays zero (rho[0] = 0): the
  // two-loop's visit to it after the wrap is a no-op
  // (solver/quasi_newton.py)
  for (int b = 0; b < p.B; ++b) {
    const size_t col0 = (size_t)b * (p.bs + 1) * p.D * sizeof(H);
    QN_TRY(cudaMemsetAsync(static_cast<char*>(p.ms) + col0, 0,
                           sizeof(H) * p.D, st));
    QN_TRY(cudaMemsetAsync(static_cast<char*>(p.my) + col0, 0,
                           sizeof(H) * p.D, st));
  }
  QN_TRY(launch(init_kernel<BATCHED>, p.B, 32, 0, st, p));
  if (max_it < 1) return cudaSuccess;
  QN_TRY((enqueue_iteration<H, BATCHED>(p, pl, st, false, is_fbe)));
  return run_graph<H, BATCHED>(p, pl, st, max_it, is_fbe);
}

// The multiply-shift constant of a divisor d: floor((2^64 - 1) / d) + 1,
// exact for every 32-bit dividend (0: d = 1, the dividend itself).
unsigned long long div_magic(unsigned d) {
  return d > 1 ? ~0ull / d + 1 : 0ull;
}

// The arguments of every C entry before the batch's (the history ms and
// my as float or bf16, by the entry) and after it.
#define QN_HEAD_ARGS                                                        \
  const float *d1, const float *d2, const float *g, const float *nhp,       \
      const float *rep, const float *prob, const float *xmin,               \
      const float *xmax, const float *xs, const float *umin,                \
      const float *umax, const float *L, const float *BbT,                  \
      const float *iWT, const float *LT, const float *BT, const float *Cs,  \
      const float *WT, const float *beta, const float *uhat,                \
      const float *e, const float *alpha, const float *x0,                  \
      const float *pdu, const float *pu, float *y, float *yp, float *yvp,   \
      float *w, float *rs, float *yv, float *dd, float *wd, float *df,      \
      float *x, float *u, float *hx, float *hu, float *t, float *a,         \
      void *ms, void *my, float *norm_part, float *val_part,                \
      float *dot_part, float *pp, float *champ_part, float *sc,             \
      float *tr_inf, float *tr_val, float *tr_tau, int *st
#define QN_HEAD_NAMES                                                       \
  d1, d2, g, nhp, rep, prob, xmin, xmax, xs, umin, umax, L, BbT, iWT, LT,   \
      BT, Cs, WT, beta, uhat, e, alpha, x0, pdu, pu, y, yp, yvp, w, rs, yv, \
      dd, wd, df, x, u, hx, hu, t, a, ms, my, norm_part, val_part,          \
      dot_part, pp, champ_part, sc, tr_inf, tr_val, tr_tau, st
#define QN_TAIL_ARGS                                                        \
  int N, int ns, int nx, int nu, int nv, int fp, int max_it, int bs,        \
      int is_fbe, float c, float step, float t1c, float t2c, float pstate,  \
      float psafety, float xs_upper, int tol_mode, float tol, void *stream
#define QN_TAIL_NAMES                                                       \
  N, ns, nx, nu, nv, fp, max_it, bs, is_fbe, c, step, t1c, t2c, pstate,     \
      psafety, xs_upper, tol_mode, tol, stream

// The solve of qn_solve_batch below, compiled with the per-instance
// offsets (BATCHED = true) or without them (the single solve, B = 1),
// with the history stored as H.
template <class H, bool BATCHED>
int solve(QN_HEAD_ARGS, int B, long long uhat_bs, long long e_bs,
          long long alpha_bs, QN_TAIL_ARGS) {
  if (bs < 1 || max_it < 0) return cudaErrorInvalidValue;
  if (B < 1 || B > 65535) return cudaErrorInvalidValue;   // grid.y limit
  const Layout l = layout(N, ns, nx, nu);
  // flat offsets are 32-bit, and so is the count of work items
  if (l.D >= (1LL << 31) || B * l.P >= (1LL << 31))
    return cudaErrorInvalidValue;
  Args p;
  p.B = B; p.N = N; p.ns = ns; p.nx = nx; p.nu = nu; p.nv = nv; p.fp = fp;
  p.RS = (N + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
  p.bs = bs;
  p.tol_mode = tol_mode;
  p.max_it = max_it;
  p.XI = (int)l.XI; p.XP = (int)l.XP; p.PS = (int)l.PS; p.D = (int)l.D;
  p.DV = (int)l.DV; p.XV = (int)l.XV; p.P = (int)l.P;
  p.mx = div_magic(2 * nx); p.mu = div_magic(nu);
  p.G = (int)l.G; p.TM = l.TM; p.KS = l.KS; p.NCP = l.NCP;
  p.c = c; p.step = step; p.t1c = t1c; p.t2c = t2c; p.pstate = pstate;
  p.psafety = psafety; p.xs_upper = xs_upper; p.tol = tol;
  p.uhat_bs = uhat_bs; p.e_bs = e_bs; p.alpha_bs = alpha_bs;
  p.d1 = d1; p.d2 = d2; p.g = g; p.nhp = nhp; p.rep = rep; p.prob = prob;
  p.xmin = xmin; p.xmax = xmax; p.xs = xs; p.umin = umin; p.umax = umax;
  p.L = L; p.BbT = BbT; p.iWT = iWT; p.LT = LT; p.BT = BT; p.Cs = Cs;
  p.WT = WT;
  p.beta = beta; p.uhat = uhat; p.e = e; p.alpha = alpha; p.x0 = x0;
  p.pdu = pdu; p.pu = pu;
  p.y = y; p.yp = yp; p.yvp = yvp; p.w = w; p.rs = rs; p.yv = yv;
  p.dd = dd; p.df = df;
  // FBE searches along the L-BFGS direction itself (wd = dd); NAMA along
  // dd - step r, which the last two-loop step writes into wd
  p.wd = is_fbe ? dd : wd;
  p.x = x; p.u = u; p.hx = hx; p.hu = hu; p.t = t; p.a = a; p.ms = ms;
  p.my = my;
  p.hsize = sizeof(H);
  p.norm_part = norm_part; p.val_part = val_part; p.dot_part = dot_part;
  p.pp = pp; p.champ_part = champ_part; p.sc = sc; p.tr_inf = tr_inf;
  p.tr_val = tr_val; p.tr_tau = tr_tau; p.st = st;

  cudaStream_t cst = static_cast<cudaStream_t>(stream);
  return run_solve<H, BATCHED>(p, cst, max_it, is_fbe != 0);
}

}  // namespace

// Runs max_it iterations of B independent FBE (is_fbe = 1) or NAMA solves
// on `stream` without synchronising.  Every per-instance array carries a
// leading batch axis (contiguous instances); uhat, e and alpha may
// instead be one array read by every instance (batch stride 0).  The
// caller fills y and yp (B, D) with the warm start (the flat dual buffer
// of each instance, Layout above, pads zero), zeroes x, u, yvp and the
// three traces (B, max_it), sizes the partials by qn_solve_partials, and
// reads x, u, y, the traces and, per instance, st[1] (the iteration
// count), st[4] (the rejected curvature pairs) and st[9] (the line-search
// trials that ran) of st (B, 10) after the stream has run.  The history
// ms, my (B, bs + 1, D) is float here and bf16 in qn_solve_batch_bf16.
// Returns a cudaError_t (0 on success).
extern "C" int qn_solve_batch(QN_HEAD_ARGS, int B, long long uhat_bs,
                              long long e_bs, long long alpha_bs,
                              QN_TAIL_ARGS) {
  return solve<float, true>(QN_HEAD_NAMES, B, uhat_bs, e_bs, alpha_bs,
                            QN_TAIL_NAMES);
}

extern "C" int qn_solve_batch_bf16(QN_HEAD_ARGS, int B, long long uhat_bs,
                                   long long e_bs, long long alpha_bs,
                                   QN_TAIL_ARGS) {
  return solve<__nv_bfloat16, true>(QN_HEAD_NAMES, B, uhat_bs, e_bs,
                                    alpha_bs, QN_TAIL_NAMES);
}

// The single solve: B = 1 of the batched solve compiled without the
// per-instance offsets, with the argument list the single-solve wrapper
// has always called.  The batched entry keeps them at B = 1 too, so a
// batch of one holds the batched compilation to this one.
extern "C" int qn_solve(QN_HEAD_ARGS, QN_TAIL_ARGS) {
  return solve<float, false>(QN_HEAD_NAMES, 1, 0, 0, 0, QN_TAIL_NAMES);
}

extern "C" int qn_solve_bf16(QN_HEAD_ARGS, QN_TAIL_ARGS) {
  return solve<__nv_bfloat16, false>(QN_HEAD_NAMES, 1, 0, 0, 0,
                                     QN_TAIL_NAMES);
}

// Kernel launches of one iteration after the first (the graph's nodes),
// whatever the batch.
extern "C" int qn_solve_launches_per_iteration(int is_fbe, int bs, int fp) {
  const int sweep = fp > 0 ? 3 : 2;
  // solve step: sweep, prox, residual, smoothing product; then
  // (FBE) H(r), the dots, the update, the store, the two-loop, the
  // search's sweeps (and NAMA's residual step), its set-up, four
  // launches a trial, the dual update and the traces
  return sweep + 3 + (is_fbe ? sweep : 0) + 1 + 1 + 1 + 2 * bs +
         (is_fbe ? sweep : 2 * sweep + 1) + 1 + 4 * (LS_MAX_STEPS + 1) + 2;
}

// The most dynamic shared memory (bytes) a launch at these sizes asks
// for; ops/qn_solve.py holds its routing formula to this.
extern "C" long long qn_solve_smem(int N, int ns, int nx, int nu, int nv) {
  const SolveSmem sm = solve_smem(N, ns, nx, nu, nv);
  size_t m = sm.tail > sm.prefix ? sm.tail : sm.prefix;
  m = m > sm.fwd ? m : sm.fwd;
  return (long long)(m > sm.smooth ? m : sm.smooth);
}

// The floats of the partial buffers norm_part, val_part, dot_part, pp and
// champ_part for B instances, into out[0..5); ops/qn_solve.py holds its
// sizing to this.
extern "C" void qn_solve_partials(int N, int ns, int nx, int nu, int B,
                                  long long* out) {
  const Layout l = layout(N, ns, nx, nu);
  out[0] = B * l.P * 2;
  out[1] = B * (l.P * 2 + l.G * 2);
  out[2] = B * l.P * 4;
  out[3] = B * l.P * 2;
  out[4] = B * l.P * 6;
}

extern "C" const char* qn_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
