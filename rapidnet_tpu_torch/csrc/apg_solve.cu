// Whole-solve APG for Hopper (sm_90a): the entire fixed-budget (or
// tolerance) dual APG solve from one call out of Python.
//
// Replaces the TPU kernel rapidnet_tpu/ops/pallas_apg.py::make_pallas_solve
// (kernel body :207, pallas_call :389).  Each iteration computes what that
// kernel computes:
//   extrapolation  w = (1 + lam_k) y - lam_k y_prev  (lam_k from a table),
//   backward sweep t = cumsum_tail(d1 w1 + d2 w2),
//                  inner = cumsum_tail(beta + (g wpsi) L + t Bb'),
//                  then the branching prefix with dense child->parent sums,
//   forward sweep  u = uhat + cumsum(v L') + pdu,  x = cumsum(e + u B') + x0,
//                  with v = nhp * inner invWbar',
//   prox of g      projection differences and two rep-masked global norms,
//   residual       r = (1 - k) diff - c w,  y_prev <- y,  y <- w + step r,
//   trace          the signed infeasibility champion and, with a
//                  tolerance, the true residual magnitude for the exit.
//
// What bounds it on the card.  At the Barcelona-scale problem (N = 24
// stages, ns = 25 scenario slots, nx = 63, nu = 114, nv = 97) the working
// set is ~2,260 floats on each of the 600 rows (~5.4 MB) plus ~180 KB of
// shared matrices: far above the 227 KB of shared memory a block can use,
// well inside the 50 MB L2.  So the state lives in device memory and is
// served from L2.  Three points couple the whole tree inside an iteration
// (the prefix aggregation across slots, the two penalty norms and the
// infeasibility champion), so the iteration is four kernels launched in
// order on one stream (tail, prefix, forward, dual update), the finish of
// each iteration (trace entry, tolerance exit) taken at the start of the
// next one's tail and once after the loop.  A slot's products are ~1.08 M
// FMAs an iteration (54 MFLOP for the tree: under a microsecond of the
// card's FP32 rate); what bounds the iteration is latency: the chains of
// dependent loads and FMAs inside each phase, on as many SMs as the phase
// has blocks, and the phases' handoffs.  The one-block design (one
// 256-thread block a slot on 25 of 132 SMs, the matrices read through L1
// one load per 8 FMAs, the prefix on one block, five launches an
// iteration) took ~144 us an iteration, 72.4 ms a solve; this one takes
// ~51 us, 25.3 ms, and a B = 32 call 167 ms against 197 (H100 80GB HBM3,
// 700 W; chip_smoke.py --reference-kernel, profile_solve.py).
//
// What the design does about that.
// * Cluster-split slot phases.  Each slot (of each instance) is a thread
//   block cluster of C CTAs (C <= 8, picked from the sizes and the SM
//   count).  Each CTA owns a slice of the output columns of every product
//   and stage scan; each output column is an independent fmaf chain over
//   k ascending from 0, and each scan is independent per column, so the
//   split keeps every sum in the order of the one-block design, whatever
//   C is.  Between products each CTA writes its share of the operand
//   into the other CTAs' shared memory (distributed shared memory,
//   DSMEM: stores, no CTA waits on a remote load), and a cluster barrier
//   makes it whole everywhere.  The penalty norms' slot partials keep the
//   one-block order exactly: the CTAs write their projection differences
//   into rank 0's shared memory, and rank 0 sums them with the 256-thread
//   assignment and tree of that design.  A cluster CTA runs 512 threads
//   (the elementwise passes in half the rounds); rank 0's sums use its
//   first 256.
// * Staged matrix slices.  At a launch's start each CTA copies its column
//   slices of the products' matrices (L and Bb' in the tail; iW', L' and
//   B' forward; Bb' and Cs[s] in the prefix) into shared memory with
//   cp.async (a slice's rows are strided at the matrix's odd pitch, which
//   16-byte TMA bulk copies cannot fetch without per-row landing offsets),
//   and the products read them from there.  Each thread of a product owns
//   4 or 8 stage rows of one column: 4 where the items fill the block in
//   one round (a shorter chain per output is impossible: k stays ascending
//   in one accumulator), its k loop unrolled by 8.
// * The prefix on a cluster.  Each instance's branching prefix runs on a
//   cluster of up to 8 CTAs, each owning slices of nx (the carried t) and
//   of nv (the carried inner); t of a stage is shared whole over DSMEM
//   once per stage (two buffers, one cluster barrier a stage).
// * The dual update on the slot's cluster, each CTA a share of its
//   elements; rank 0 takes the max / min of the CTAs' residual champions
//   (which max and min do not depend on the order of).
// * Programmatic dependent launch.  Every phase is launched with
//   programmatic stream serialization: it lets the next phase launch at
//   its start, stages its constant matrices, and only then waits for the
//   previous phase (griddepcontrol.wait) before reading the state
//   (measured at B = 1: 25.669 ms a solve against 28.436 without).
// The pick (pick_sizes): at B = 1 on the Barcelona problem, slot clusters
// of 8 (200 CTAs, two an SM), a prefix cluster of 8, every phase staged;
// at B = 32 the 800 slots fill the card at C = 1, where the staged
// slices' shared memory leaves fewer blocks resident than the unstaged
// variant's (measured slower), so only the prefix (32 clusters of 4) is
// staged.
// A tree whose staged slices or cluster do not fit the device runs the
// same bodies unstaged (matrices through L1/L2) and/or at C = 1: a template
// flag and a launch parameter picked in the C entry from the sizes and the
// device's limits (apg_solve_variant reports the pick).  The unstaged C = 1
// variant asks for the shared memory of the one-block design
// (apg_solve_smem, the routing gate's formula), so no tree the gate took
// is refused.
//
// The host loop launches all iterations without synchronising; lam, the
// shrink factors, the trace and a device-side done flag stay on the
// device.  The norms and the champion are reduced in two passes
// (per-block partials, then a fixed-order pass), with no atomics, so a run
// repeats itself bit for bit, and every variant gives the same bits.
//
// The batch axis.  B independent solves that share the factor step run
// in one call: what the TPU kernel's batch wrappers compute by a vmap of
// the whole-solve pallas_call, which makes the batch a grid axis
// (rapidnet_tpu/ops/pallas_apg.py:477-523, make_apg_pallas_batch and
// make_apg_pallas_batch_shared).  Every phase takes the instance from
// the grid (blockIdx.y for the per-slot phases, the cluster for the
// prefix, one block per instance for the last finish), and `instance()`
// moves each per-instance pointer to its slice; the row constants, the
// matrices, Cs and lams are read by every instance from one buffer, and
// uhat and e may be too (batch stride 0, the shared-forecast batch).
// The single solve is B = 1 of the same source, compiled without the
// per-instance offsets (BATCHED = false); the batched entry keeps them
// at every B, B = 1 included.  At B = 32 the working set is ~120 MB,
// above the 50 MB L2, so the batch streams its state from device memory.
// Done flags, iteration counts and traces are per instance; a block
// whose instance has met the tolerance returns at once, so a finished
// instance keeps its state and a zero trace past its exit, as a vmap of
// the JAX while_loop does.  The reductions keep their fixed order per
// instance, so an instance of a batch equals its single solve bit for
// bit.
//
// Products are this file's own FP32 FMA loops (no cuBLAS, no tensor
// cores, no TF32): the JAX package computes them at Precision.HIGHEST.
//
// Layout: every per-row array is row-major (R, d) with row r = s*ns + i
// (stage s, slot i), the unpadded fan layout of the JAX package's XLA
// path; the dual pair is y_xi (R, 2nx) and y_psi (R, nu).
//
// Ties in the trace: the signed champion of each residual block is taken
// as the TPU kernel takes it (pallas_apg.py:319-331: max and min, then
// hi > -lo), which differs from solve_step.signed_max_abs's first-index
// argmax only at an exact |hi| = |lo| tie.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ROW_GROUP = 8;        // stage rows are padded to a multiple
constexpr int SLOT_THREADS = 256;   // a slot's block at C = 1, and the
                                    // order of its norm partials
constexpr int WIDE_THREADS = 512;   // a slot cluster's CTA at C > 1
constexpr int PREFIX_THREADS = 512;
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int STATIC_RESERVE = 2048;   // bytes a variant past the gate's
                                       // leaves for static shared memory
constexpr int CTAS_PER_SM = 2;      // a slot cluster's CTAs the pick lets
                                    // share an SM (the slot kernels'
                                    // launch bounds hold their registers
                                    // to it)

// The parts of a block that the instrumented build times (nvcc
// -DAPG_SOLVE_CLOCK): SM cycles on thread 0 between barriers, summed over
// the blocks and launches into g_spans, with each phase's blocks counted
// into g_blocks; apg_solve_spans reads both.  The marks add barriers and
// nothing else, so the outputs stay those of the plain build; without the
// define they are empty.
enum Part {
  T_START, T_ELEM, T_SHARE, T_L, T_BBT, T_SCAN, T_STORE,
  P_LOAD, P_TS, P_SHARE, P_BBT, P_CHILD,
  F_LOAD, F_IW, F_SHARE, F_LT, F_USCAN, F_BT, F_XSCAN, F_PROX, F_NORM,
  D_SHRINK, D_UPDATE, D_REDUCE,
  N_PARTS
};
enum Phase { PH_TAIL, PH_PREFIX, PH_FORWARD, PH_DUAL, N_PHASES };
#ifdef APG_SOLVE_CLOCK
__device__ unsigned long long g_spans[N_PARTS];
__device__ unsigned long long g_blocks[N_PHASES];
#endif

// Starts a block's clock and counts the block under `phase`.
__device__ __forceinline__ void clock_start(int phase, long long& last) {
#ifdef APG_SOLVE_CLOCK
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&g_blocks[phase], 1ull);
    last = clock64();
  }
#else
  (void)phase;
  (void)last;
#endif
}

// Adds the cycles since the last mark to `part`.
__device__ __forceinline__ void clock_mark(int part, long long& last) {
#ifdef APG_SOLVE_CLOCK
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long now = clock64();
    atomicAdd(&g_spans[part], (unsigned long long)(now - last));
    last = now;
  }
#else
  (void)part;
  (void)last;
#endif
}

// ---- device primitives: clusters, dependent launches, async copies ----

// This cluster's CTA `rank`'s copy of the shared-memory address p.
template <class T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}
// Every thread of the cluster arrives, its memory accesses so far released
// to the cluster; then waits until all have arrived (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Lets the next kernel on the stream launch (programmatic dependent
// launch); it still waits for this one in pdl_wait.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// Waits until the previous kernel on the stream has finished and its
// writes are visible (at once for a launch without the attribute).
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// One float copied from device memory into shared memory by the copy
// engine's async path (cp.async): no register holds it.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
// Waits for this thread's async copies (a block barrier must follow
// before other threads read them).
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- end of device primitives ----

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

struct Args {
  int B, N, ns, nx, nu, nv, fp, RS, max_it, tol_mode;
  int C, Cp;    // CTAs of a slot's cluster (tail, forward) and of an
                // instance's prefix cluster
  float c, step, t1c, t2c, xs_upper, tol;
  // batch strides (elements) of uhat and e: N*ns*d, or 0 where every
  // instance reads the same array (the shared-forecast batch)
  long long uhat_bs, e_bs;
  // constants, per row r = s*ns + i, shared by every instance
  const float *d1, *d2, *g, *nhp, *rep, *xmin, *xmax, *xs, *umin, *umax;
  // shared matrices (row-major) and the prefix aggregation (fp, ns, ns)
  const float *L, *BbT, *iWT, *LT, *BT, *Cs, *lams;
  // per-step inputs, per instance
  const float *beta, *uhat, *e, *x0, *pdu;
  // state, outputs and scratch, per instance
  float *y_xi, *y_psi, *yp_xi, *yp_psi, *w_xi, *w_psi, *t, *a;
  float *df_xi, *df_psi, *x, *u, *norm_part, *champ_part, *trace;
  int *status;   // [done, iterations] per instance
};

// The arguments as instance b sees them: every per-instance pointer
// moved to its slice (a leading batch axis on each array), the shared
// constants untouched.  The phases are compiled twice from one source:
// BATCHED = false (B = 1, the single solve) moves nothing, so the single
// solve runs the code it ran before the batch axis existed.
template <bool BATCHED>
__device__ __forceinline__ Args instance(Args p, int b) {
  if constexpr (BATCHED) {
    const size_t R = (size_t)p.N * p.ns;
    p.beta += b * R * p.nv;
    p.uhat += b * p.uhat_bs;
    p.e += b * p.e_bs;
    p.x0 += (size_t)b * p.nx;
    p.pdu += (size_t)b * p.nu;
    const size_t xi = b * R * 2 * p.nx, psi = b * R * p.nu;
    p.y_xi += xi; p.yp_xi += xi; p.w_xi += xi; p.df_xi += xi;
    p.y_psi += psi; p.yp_psi += psi; p.w_psi += psi; p.df_psi += psi;
    p.u += psi;
    p.t += b * R * p.nx;
    p.x += b * R * p.nx;
    p.a += b * R * p.nv;
    p.norm_part += (size_t)b * p.ns * 2;
    p.champ_part += (size_t)b * p.ns * 6;
    p.trace += (size_t)b * p.max_it;
    p.status += 2 * b;
  }
  return p;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  // jnp.clip semantics: max with lo, then min with hi; NaN propagates
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// A CTA's share of `total` features (output columns) among `parts`.
struct Slice {
  int lo, n;
};
__host__ __device__ __forceinline__ Slice slice(int total, int parts,
                                                int r) {
  const int lo = (int)((long long)total * r / parts);
  return {lo, (int)((long long)total * (r + 1) / parts) - lo};
}
// The widest share: what each CTA reserves for its slice.
__host__ __device__ __forceinline__ int widest(int total, int parts) {
  return (total + parts - 1) / parts;
}
// dst (K, sl.n), row pitch sl.n  <-  columns sl of the row-major (K, ld)
// matrix M, by async copies; the caller waits (copy_wait, a barrier).
__device__ __forceinline__ void stage_columns(float* dst, const float* M,
                                              int K, int ld, Slice sl) {
  const int n = sl.n;
  for (int idx = threadIdx.x; idx < K * n; idx += blockDim.x) {
    const int k = idx / n;
    copy_async(dst + idx, M + (size_t)k * ld + sl.lo + (idx - k * n));
  }
}

// Writes this CTA's features sl of the feature-major buffer buf (`pitch`
// floats a feature, a multiple of 4) into every other CTA's buf of the
// cluster, at the same place: stores, which the next cluster barrier
// makes visible there (no CTA waits on a load from another).
__device__ __forceinline__ void share(float* buf, Slice sl, int pitch,
                                      int parts, int me) {
  float4* own = reinterpret_cast<float4*>(buf + sl.lo * pitch);
  const int n4 = sl.n * pitch / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 v = own[i];
    for (int r = 0; r < parts; ++r)
      if (r != me) peer(own, r)[i] = v;
  }
}

// out[s][c] = sum_k X[k*RS + s] * M[k*ld + c] for one slot's stage rows
// and the W columns of M from c = 0.  X is the block's operand in shared
// memory, feature-major with row stride RS (a multiple of ROW_GROUP); M
// is in shared memory (staged) or, with GLOBAL, in device memory read
// through L1/L2.  Each output is one fmaf chain over k ascending from 0.
// A thread owns R rows of one column; emit(s, c, acc) runs for s < N.
// The k loop is unrolled by 8 so that later steps' loads start early.
template <int R, bool GLOBAL, class Emit>
__device__ __forceinline__ void product_tile(const float* __restrict__ X,
                                             int RS, int N,
                                             const float* __restrict__ M,
                                             int ld, int K, int W,
                                             Emit emit) {
  const int items = (RS / R) * W;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int grp = item / W;
    const int c = item - grp * W;
    const int s0 = grp * R;
    const float* xp = X + s0;
    const float* mp = M + c;
    float acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float m = GLOBAL ? __ldg(mp + k * ld) : mp[k * ld];
#pragma unroll
      for (int j = 0; j < R; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(xp + k * RS + j);
        acc[j] = fmaf(x.x, m, acc[j]);
        acc[j + 1] = fmaf(x.y, m, acc[j + 1]);
        acc[j + 2] = fmaf(x.z, m, acc[j + 2]);
        acc[j + 3] = fmaf(x.w, m, acc[j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (s0 + j < N) emit(s0 + j, c, acc[j]);
  }
}

// acc = fmaf(a(k), b(k), acc) over k = 0..K-1 in order from 0.
template <class A, class Bf>
__device__ __forceinline__ float chain(int K, A a, Bf b) {
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = fmaf(a(k), b(k), acc);
  return acc;
}

// The product with 4 rows a thread where its items fill the block in one
// round (every chain is K steps long whatever the tile, so the smaller
// tile does less per step), else with 8.  Wider tiles (two columns a
// thread) took more registers and fewer resident blocks than the batch
// could afford (measured slower at B = 32).
template <bool GLOBAL, class Emit>
__device__ __forceinline__ void product(const float* X, int RS, int N,
                                        const float* M, int ld, int K, int W,
                                        Emit emit) {
  if ((RS / 4) * W <= (int)blockDim.x)
    product_tile<4, GLOBAL>(X, RS, N, M, ld, K, W, emit);
  else
    product_tile<8, GLOBAL>(X, RS, N, M, ld, K, W, emit);
}

// champion update of pallas_apg.py:324-329
__device__ __forceinline__ void champion(float& babs, float& bval,
                                         float hi, float lo) {
  const float cval = hi > -lo ? hi : lo;
  const float cabs = fabsf(cval);
  if (cabs > babs) bval = cval;
  babs = fmaxf(babs, cabs);
}

// The finish of iteration `it`: the trace entry from the slot champions
// (the TPU kernel's rule) and, with a tolerance, whether the solve is done
// after it (the exit test of the JAX while_loop: continue while magnitude
// > tol); with `write`, the trace entry, the iteration count and the done
// flag stored.  Every thread of the block calls it (part: 6 x 32 floats,
// done: an int, of shared memory); returns done.  Max and min do not
// depend on the order of the slots, so the first warp takes them in any.
__device__ __forceinline__ bool finish_step(const Args& p, int it,
                                            float* part, int* done,
                                            bool write) {
  const int lanes = p.ns < 32 ? p.ns : 32;
  if ((int)threadIdx.x < lanes) {
    const float* cp = p.champ_part + 6 * threadIdx.x;
    float m[6] = {cp[0], cp[1], cp[2], cp[3], cp[4], cp[5]};
    for (int b = threadIdx.x + 32; b < p.ns; b += 32) {
      const float* cb = p.champ_part + 6 * b;
      for (int j = 0; j < 6; j += 2) {
        m[j] = fmaxf(m[j], cb[j]);
        m[j + 1] = fminf(m[j + 1], cb[j + 1]);
      }
    }
    for (int j = 0; j < 6; ++j) part[j * 32 + threadIdx.x] = m[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m[6];
    for (int j = 0; j < 6; ++j) m[j] = part[j * 32];
    for (int l = 1; l < lanes; ++l)
      for (int j = 0; j < 6; j += 2) {
        m[j] = fmaxf(m[j], part[j * 32 + l]);
        m[j + 1] = fminf(m[j + 1], part[(j + 1) * 32 + l]);
      }
    float xabs = -1.f, xval = 0.f, pabs = -1.f, pval = 0.f;
    champion(xabs, xval, m[0], m[1]);
    champion(xabs, xval, m[2], m[3]);
    champion(pabs, pval, m[4], m[5]);
    const bool end = p.tol_mode && !(fmaxf(xabs, pabs) > p.tol);
    if (write) {
      p.trace[it] = fmaxf(xval, pval);
      p.status[1] = it + 1;
      if (end) p.status[0] = 1;
    }
    *done = end;
  }
  __syncthreads();
  return *done != 0;
}

// Phase 1, one cluster of C CTAs per slot i of instance blockIdx.y (CTA
// blockIdx.x = i*C + rank): extrapolation, the dual-only terms and the
// tail recursions.  Each CTA computes its share of the features of
// g wpsi and t (and of w, which it writes), shares them, and
// computes its share of the columns of a.  Writes w, and t / a for every
// stage: the tail stages (s >= fp) hold the finished t and inner; the
// prefix stages hold tb = d1 w1 + d2 w2 and a0 = beta + (g wpsi) L for
// phase 2.  First, from iteration 1 on, every CTA takes the finish of the
// iteration before (the same decision in all; slot 0's CTA 0 stores it)
// and returns if the solve is done.
template <bool BATCHED, bool STAGED>
__global__ void __launch_bounds__(WIDE_THREADS, CTAS_PER_SM)
backward_tail_kernel(Args pb, int it) {
  long long clk = 0;
  clock_start(PH_TAIL, clk);
  pdl_trigger();
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, nv = p.nv;
  const int RS = p.RS, fp = p.fp, C = p.C;
  const int i = blockIdx.x / C, me = blockIdx.x - i * C;
  const Slice kx = slice(nx, C, me), ku = slice(nu, C, me);
  const Slice cv = slice(nv, C, me);
  const int nvw = widest(nv, C);
  float* gwT = smem;               // (nu, RS)  g * wpsi, shared whole
  float* tT = gwT + nu * RS;       // (nx, RS)  t, shared whole
  float* aT = tT + nx * RS;        // (cv.n, RS)  a, then inner
  float* Ls = aT + nvw * RS;       // (nu, cv.n)  staged columns of L
  float* Bs = Ls + nu * nvw;       // (nx, cv.n)  staged columns of Bb'
  if (STAGED) {
    stage_columns(Ls, p.L, nu, nv, cv);
    stage_columns(Bs, p.BbT, nx, nv, cv);
  }
  pdl_wait();
  // the done flag read once for the block: slot 0's CTA 0 may set it
  // while other CTAs of this launch read it
  __shared__ float part[6 * 32];
  __shared__ int done;
  if (threadIdx.x == 0) done = p.status[0];
  __syncthreads();
  if (done ||
      (it > 0 && finish_step(p, it - 1, part, &done, blockIdx.x == 0))) {
    copy_wait();
    return;
  }
  clock_mark(T_START, clk);
  const float lam = p.lams[it];

  for (int idx = threadIdx.x; idx < RS * kx.n; idx += blockDim.x) {
    const int s = idx / kx.n, k = kx.lo + idx - s * kx.n;
    float tb = 0.f;
    if (s < N) {
      const size_t r = (size_t)s * ns + i;
      const size_t o1 = r * 2 * nx + k, o2 = o1 + nx;
      const float w1 = (1.f + lam) * p.y_xi[o1] - lam * p.yp_xi[o1];
      const float w2 = (1.f + lam) * p.y_xi[o2] - lam * p.yp_xi[o2];
      p.w_xi[o1] = w1;
      p.w_xi[o2] = w2;
      tb = p.d1[r * nx + k] * w1 + p.d2[r * nx + k] * w2;
    }
    tT[k * RS + s] = tb;
  }
  for (int idx = threadIdx.x; idx < RS * ku.n; idx += blockDim.x) {
    const int s = idx / ku.n, k = ku.lo + idx - s * ku.n;
    float gw = 0.f;
    if (s < N) {
      const size_t o = ((size_t)s * ns + i) * nu + k;
      const float wp = (1.f + lam) * p.y_psi[o] - lam * p.yp_psi[o];
      p.w_psi[o] = wp;
      gw = p.g[o] * wp;
    }
    gwT[k * RS + s] = gw;
  }
  __syncthreads();
  clock_mark(T_ELEM, clk);

  // the suffix cumsum of t over the tail stages fp..N-1, this CTA's
  // features; then its features of g wpsi and t to the other CTAs
  for (int k = kx.lo + threadIdx.x; k < kx.lo + kx.n; k += blockDim.x)
    for (int s = N - 2; s >= fp; --s) tT[k * RS + s] += tT[k * RS + s + 1];
  if (C > 1) {
    __syncthreads();
    share(gwT, ku, RS, C, me);
    share(tT, kx, RS, C, me);
    cluster_sync();
  }
  copy_wait();
  __syncthreads();
  clock_mark(T_SHARE, clk);

  // a = beta + (g wpsi) L
  product<!STAGED>(gwT, RS, N, STAGED ? Ls : p.L + cv.lo, STAGED ? cv.n : nv,
                   nu, cv.n, [&](int s, int c, float acc) {
                     aT[c * RS + s] =
                         p.beta[((size_t)s * ns + i) * nv + cv.lo + c] + acc;
                   });
  __syncthreads();
  clock_mark(T_L, clk);

  // tail stages: a += t Bb'
  product<!STAGED>(tT, RS, N, STAGED ? Bs : p.BbT + cv.lo,
                   STAGED ? cv.n : nv, nx, cv.n,
                   [&](int s, int c, float acc) {
                     if (s >= fp) aT[c * RS + s] += acc;
                   });
  __syncthreads();
  clock_mark(T_BBT, clk);

  // inner = suffix cumsum of a over the tail
  for (int c = threadIdx.x; c < cv.n; c += blockDim.x)
    for (int s = N - 2; s >= fp; --s) aT[c * RS + s] += aT[c * RS + s + 1];
  __syncthreads();
  clock_mark(T_SCAN, clk);

  for (int idx = threadIdx.x; idx < N * kx.n; idx += blockDim.x) {
    const int s = idx / kx.n, k = kx.lo + idx - s * kx.n;
    p.t[((size_t)s * ns + i) * nx + k] = tT[k * RS + s];
  }
  for (int idx = threadIdx.x; idx < N * cv.n; idx += blockDim.x) {
    const int s = idx / cv.n, c = idx - s * cv.n;
    p.a[((size_t)s * ns + i) * nv + cv.lo + c] = aT[c * RS + s];
  }
  clock_mark(T_STORE, clk);
}

// Phase 2, one cluster of Cp CTAs per instance (CTA blockIdx.x = b*Cp +
// rank): the branching prefix, stages fp-1..0, which couples the slots of
// that instance through the child->parent sums Cs[s] (identity where the
// tree does not branch).  Each CTA owns a share of the features of the
// carried t (q) and of the columns of the carried inner (r); t of a stage
// is shared whole for the Bb' product, into one of two buffers by
// stage (a CTA writes its features into the others' buffer of the
// stage, which they may read until the next stage's barrier).  Overwrites
// a at the prefix stages with inner.
template <bool BATCHED, bool STAGED>
__global__ void __launch_bounds__(PREFIX_THREADS)
backward_prefix_kernel(Args pb) {
  long long clk = 0;
  clock_start(PH_PREFIX, clk);
  pdl_trigger();
  const int Cp = pb.Cp, b = blockIdx.x / Cp, me = blockIdx.x - b * Cp;
  const Args p = instance<BATCHED>(pb, b);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, ns = p.ns, nx = p.nx, nv = p.nv, fp = p.fp;
  const Slice kx = slice(nx, Cp, me), cv = slice(nv, Cp, me);
  const int nxw = widest(nx, Cp), nvw = widest(nv, Cp);
  const int P = Cp > 1 ? (ns + 3) & ~3 : ns;   // a feature's floats in tS
  const int nbuf = Cp > 1 ? 2 : 1;
  float* tSb = smem;                  // (nbuf, nx, P)  t of the stage
  float* q = tSb + nbuf * nx * P;     // (kx.n, ns)  carried t
  float* r = q + nxw * ns;            // (cv.n, ns)  carried inner
  float* inS = r + nvw * ns;          // (cv.n, ns)  inner of the stage
  float* Bs = inS + nvw * ns;         // (nx, cv.n)  staged columns of Bb'
  float* Cm = Bs + nx * nvw;          // (ns, ns)  staged Cs[s]
  if (STAGED) stage_columns(Bs, p.BbT, nx, nv, cv);
  pdl_wait();
  if (p.status[0]) {
    copy_wait();
    return;
  }

  for (int idx = threadIdx.x; idx < kx.n * ns; idx += blockDim.x) {
    const int kk = idx / ns, si = idx - kk * ns;
    q[idx] = fp < N ? p.t[((size_t)fp * ns + si) * nx + kx.lo + kk] : 0.f;
  }
  for (int idx = threadIdx.x; idx < cv.n * ns; idx += blockDim.x) {
    const int cc = idx / ns, si = idx - cc * ns;
    r[idx] = fp < N ? p.a[((size_t)fp * ns + si) * nv + cv.lo + cc] : 0.f;
  }
  copy_wait();
  __syncthreads();
  clock_mark(P_LOAD, clk);

  for (int s = fp - 1; s >= 0; --s) {
    float* tS = tSb + (nbuf > 1 ? (s & 1) : 0) * nx * P;
    const float* tb = p.t + (size_t)s * ns * nx;
    float* as = p.a + (size_t)s * ns * nv;
    const float* Cg = p.Cs + (size_t)s * ns * ns;
    if (STAGED && s > 0)
      for (int idx = threadIdx.x; idx < ns * ns; idx += blockDim.x)
        copy_async(Cm + idx, Cg + idx);
    for (int idx = threadIdx.x; idx < kx.n * ns; idx += blockDim.x) {
      const int kk = idx / ns, si = idx - kk * ns, k = kx.lo + kk;
      tS[k * P + si] = tb[si * nx + k] + q[idx];
    }
    if (Cp > 1) {
      __syncthreads();
      clock_mark(P_TS, clk);
      share(tS, kx, P, Cp, me);
      cluster_sync();
      clock_mark(P_SHARE, clk);
    } else {
      __syncthreads();
      clock_mark(P_TS, clk);
    }
    for (int idx = threadIdx.x; idx < ns * cv.n; idx += blockDim.x) {
      const int si = idx / cv.n, cc = idx - si * cv.n, c = cv.lo + cc;
      const float acc = chain(
          nx, [&](int k) { return tS[k * P + si]; },
          [&](int k) {
            return STAGED ? Bs[k * cv.n + cc] : __ldg(p.BbT + k * nv + c);
          });
      const float in = as[si * nv + c] + r[cc * ns + si] + acc;
      inS[cc * ns + si] = in;
      as[si * nv + c] = in;
    }
    __syncthreads();
    clock_mark(P_BBT, clk);
    if (s > 0) {
      if (STAGED) {
        copy_wait();
        __syncthreads();
      }
      for (int idx = threadIdx.x; idx < kx.n * ns; idx += blockDim.x) {
        const int kk = idx / ns, si = idx - kk * ns, k = kx.lo + kk;
        q[idx] = chain(
            ns,
            [&](int j) {
              return STAGED ? Cm[si * ns + j] : __ldg(Cg + si * ns + j);
            },
            [&](int j) { return tS[k * P + j]; });
      }
      for (int idx = threadIdx.x; idx < cv.n * ns; idx += blockDim.x) {
        const int cc = idx / ns, si = idx - cc * ns;
        r[idx] = chain(
            ns,
            [&](int j) {
              return STAGED ? Cm[si * ns + j] : __ldg(Cg + si * ns + j);
            },
            [&](int j) { return inS[cc * ns + j]; });
      }
    }
    __syncthreads();
    clock_mark(P_CHILD, clk);
  }
}

// Deterministic tree reduction of the first `width` threads' v (a power
// of two, at most the block); every thread of the block calls it.
template <class Op>
__device__ __forceinline__ float block_reduce(float v, float* buf, Op op,
                                              int width) {
  if (threadIdx.x < width) buf[threadIdx.x] = v;
  __syncthreads();
  for (int stride = width / 2; stride > 0; stride >>= 1) {
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

// Phase 3, one cluster of C CTAs per slot and instance: v, the forward
// cumsums, x and u, the prox pre-images and projection differences, and
// this slot's partial sums of the two penalty norms.  Each CTA computes
// its share of the columns of v, u and x and shares v and u whole for
// the next product; the CTAs write their differences of the x block into
// rank 0's shared memory, and rank 0 sums the slot's norm partials in the
// order of one 256-thread block.
template <bool BATCHED, bool STAGED>
__global__ void __launch_bounds__(WIDE_THREADS, CTAS_PER_SM)
forward_prox_kernel(Args pb) {
  long long clk = 0;
  clock_start(PH_FORWARD, clk);
  pdl_trigger();
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[SLOT_THREADS];
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, nv = p.nv;
  const int RS = p.RS, C = p.C;
  const int i = blockIdx.x / C, me = blockIdx.x - i * C;
  const Slice cv = slice(nv, C, me), cu = slice(nu, C, me);
  const Slice cx = slice(nx, C, me);
  const int nvw = widest(nv, C), nuw = widest(nu, C), nxw = widest(nx, C);
  float* aT = smem;             // (nv, RS)  inner, shared whole
  float* vT = aT + nv * RS;     // (nv, RS)  v, shared whole
  float* uT = vT + nv * RS;     // (nu, RS)  v L', then u, shared whole
  float* xT = uT + nu * RS;     // (cx.n, RS)  e + u B', then x
  float* dfT = xT + nxw * RS;   // (2, nx, RS)  df1, df2 at rank 0 (C > 1)
  float* iWs = dfT + (C > 1 ? 2 * nx * RS : 0);    // (nv, cv.n)  staged
  float* LTs = iWs + nv * nvw;                     // (nv, cu.n)  columns
  float* BTs = LTs + nv * nuw;                     // (nu, cx.n)
  if (STAGED) {
    stage_columns(iWs, p.iWT, nv, nv, cv);
    stage_columns(LTs, p.LT, nv, nu, cu);
    stage_columns(BTs, p.BT, nu, nx, cx);
  }
  pdl_wait();
  if (p.status[0]) {
    copy_wait();
    return;
  }

  for (int idx = threadIdx.x; idx < RS * cv.n; idx += blockDim.x) {
    const int s = idx / cv.n, c = cv.lo + idx - s * cv.n;
    aT[c * RS + s] = s < N ? p.a[((size_t)s * ns + i) * nv + c] : 0.f;
  }
  if (C > 1) {
    __syncthreads();
    share(aT, cv, RS, C, me);
    cluster_sync();
  }
  copy_wait();
  __syncthreads();
  clock_mark(F_LOAD, clk);

  product<!STAGED>(aT, RS, N, STAGED ? iWs : p.iWT + cv.lo,
                   STAGED ? cv.n : nv, nv, cv.n,
                   [&](int s, int c, float acc) {
                     vT[(cv.lo + c) * RS + s] =
                         p.nhp[(size_t)s * ns + i] * acc;
                   });
  if (C > 1) {
    __syncthreads();
    clock_mark(F_IW, clk);
    share(vT, cv, RS, C, me);
    cluster_sync();
    clock_mark(F_SHARE, clk);
  } else {
    __syncthreads();
    clock_mark(F_IW, clk);
  }
  product<!STAGED>(vT, RS, N, STAGED ? LTs : p.LT + cu.lo,
                   STAGED ? cu.n : nu, nv, cu.n,
                   [&](int s, int c, float acc) {
                     uT[(cu.lo + c) * RS + s] = acc;
                   });
  __syncthreads();
  clock_mark(F_LT, clk);
  for (int k = cu.lo + threadIdx.x; k < cu.lo + cu.n; k += blockDim.x) {
    float du = 0.f;
    for (int s = 0; s < N; ++s) {
      du += uT[k * RS + s];
      uT[k * RS + s] = p.uhat[((size_t)s * ns + i) * nu + k] + (du + p.pdu[k]);
    }
  }
  if (C > 1) {
    __syncthreads();
    clock_mark(F_USCAN, clk);
    share(uT, cu, RS, C, me);
    cluster_sync();
    clock_mark(F_SHARE, clk);
  } else {
    __syncthreads();
    clock_mark(F_USCAN, clk);
  }
  product<!STAGED>(uT, RS, N, STAGED ? BTs : p.BT + cx.lo,
                   STAGED ? cx.n : nx, nu, cx.n,
                   [&](int s, int c, float acc) {
                     xT[c * RS + s] =
                         p.e[((size_t)s * ns + i) * nx + cx.lo + c] + acc;
                   });
  __syncthreads();
  clock_mark(F_BT, clk);
  for (int kk = threadIdx.x; kk < cx.n; kk += blockDim.x) {
    float xa = 0.f;
    for (int s = 0; s < N; ++s) {
      xa += xT[kk * RS + s];
      xT[kk * RS + s] = xa + p.x0[cx.lo + kk];
    }
  }
  __syncthreads();
  clock_mark(F_XSCAN, clk);

  // At C = 1 the share is every feature and idx runs as in one 256-thread
  // block (the launch's), so the sums accumulate here; at C > 1 rank 0's
  // first 256 threads sum below in that order.
  const float c = p.c;
  float s1 = 0.f, s2 = 0.f;
  for (int idx = threadIdx.x; idx < N * cx.n; idx += blockDim.x) {
    const int s = idx / cx.n, kk = idx - s * cx.n, k = cx.lo + kk;
    const size_t r = (size_t)s * ns + i;
    const size_t o = r * nx + k, o1 = r * 2 * nx + k, o2 = o1 + nx;
    const float xv = xT[kk * RS + s];
    p.x[o] = xv;
    const float pre1 = p.d1[o] * xv + c * p.w_xi[o1];
    const float df1 = pre1 - clip(pre1, p.xmin[o], p.xmax[o]);
    const float pre2 = p.d2[o] * xv + c * p.w_xi[o2];
    const float df2 = pre2 - clip(pre2, p.xs[o], p.xs_upper);
    p.df_xi[o1] = df1;
    p.df_xi[o2] = df2;
    if (C == 1) {
      s1 += p.rep[r] * df1 * df1;
      s2 += p.rep[r] * df2 * df2;
    } else {
      float* d = peer(dfT, 0);
      d[k * RS + s] = df1;
      d[(nx + k) * RS + s] = df2;
    }
  }
  for (int idx = threadIdx.x; idx < N * cu.n; idx += blockDim.x) {
    const int s = idx / cu.n, k = cu.lo + idx - s * cu.n;
    const size_t o = ((size_t)s * ns + i) * nu + k;
    const float uv = uT[k * RS + s];
    p.u[o] = uv;
    const float pre = p.g[o] * uv + c * p.w_psi[o];
    p.df_psi[o] = pre - clip(pre, p.umin[o], p.umax[o]);
  }
  if (C > 1) {
    cluster_sync();
    if (me == 0 && threadIdx.x < SLOT_THREADS)
      for (int idx = threadIdx.x; idx < N * nx; idx += SLOT_THREADS) {
        const int s = idx / nx, k = idx - s * nx;
        const float df1 = dfT[k * RS + s], df2 = dfT[(nx + k) * RS + s];
        const size_t r = (size_t)s * ns + i;
        s1 += p.rep[r] * df1 * df1;
        s2 += p.rep[r] * df2 * df2;
      }
  }
  clock_mark(F_PROX, clk);
  if (me == 0) {
    s1 = block_reduce(s1, red, Add(), SLOT_THREADS);
    s2 = block_reduce(s2, red, Add(), SLOT_THREADS);
    if (threadIdx.x == 0) {
      p.norm_part[2 * i] = s1;
      p.norm_part[2 * i + 1] = s2;
    }
  }
  clock_mark(F_NORM, clk);
}

__device__ __forceinline__ float shrink(float sumsq, float thresh) {
  const float dist = sqrtf(sumsq);
  return dist > thresh ? 1.f - thresh / fmaxf(dist, 1e-30f) : 0.f;
}

// Phase 4, one cluster of C CTAs per slot and instance: the shrink
// factors (every CTA sums its instance's slot partials in the same
// order), the residual, the dual update and this slot's max / min of the
// three residual blocks.  Each CTA takes a share of the slot's elements;
// rank 0 takes the max / min over the CTAs' (in any order: max and min
// do not depend on it).
template <bool BATCHED>
__global__ void __launch_bounds__(WIDE_THREADS, CTAS_PER_SM)
dual_update_kernel(Args pb) {
  long long clk = 0;
  clock_start(PH_DUAL, clk);
  pdl_trigger();
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  pdl_wait();
  if (p.status[0]) return;
  extern __shared__ float4 smem4[];
  float* parts = reinterpret_cast<float*>(smem4);   // (C, 6) at rank 0
  __shared__ float red[6 * WIDE_THREADS];
  __shared__ float k12[2];
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, C = p.C;
  const int i = blockIdx.x / C, me = blockIdx.x - i * C;
  const Slice ex = slice(N * 2 * nx, C, me), eu = slice(N * nu, C, me);
  if (threadIdx.x == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int b = 0; b < ns; ++b) {
      s1 += p.norm_part[2 * b];
      s2 += p.norm_part[2 * b + 1];
    }
    k12[0] = shrink(s1, p.t1c);
    k12[1] = shrink(s2, p.t2c);
  }
  __syncthreads();
  clock_mark(D_SHRINK, clk);
  const float k1 = k12[0], k2 = k12[1], c = p.c, step = p.step;
  const float inf = __int_as_float(0x7f800000);
  float hi1 = -inf, lo1 = inf, hi2 = -inf, lo2 = inf, hip = -inf, lop = inf;
  for (int idx = ex.lo + threadIdx.x; idx < ex.lo + ex.n;
       idx += blockDim.x) {
    const int s = idx / (2 * nx), k = idx - s * 2 * nx;
    const size_t o = ((size_t)s * ns + i) * 2 * nx + k;
    const float w = p.w_xi[o];
    const float kk = k < nx ? k1 : k2;
    const float res = (1.f - kk) * p.df_xi[o] - c * w;
    p.yp_xi[o] = p.y_xi[o];
    p.y_xi[o] = w + step * res;
    if (k < nx) {
      hi1 = fmaxf(hi1, res);
      lo1 = fminf(lo1, res);
    } else {
      hi2 = fmaxf(hi2, res);
      lo2 = fminf(lo2, res);
    }
  }
  for (int idx = eu.lo + threadIdx.x; idx < eu.lo + eu.n;
       idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    const size_t o = ((size_t)s * ns + i) * nu + k;
    const float w = p.w_psi[o];
    const float res = p.df_psi[o] - c * w;
    p.yp_psi[o] = p.y_psi[o];
    p.y_psi[o] = w + step * res;
    hip = fmaxf(hip, res);
    lop = fminf(lop, res);
  }
  clock_mark(D_UPDATE, clk);
  // the six max / min in one tree over the block
  const int T = blockDim.x;
  float m[6] = {hi1, lo1, hi2, lo2, hip, lop};
#pragma unroll
  for (int j = 0; j < 6; ++j) red[j * T + threadIdx.x] = m[j];
  __syncthreads();
  for (int stride = T / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride)
#pragma unroll
      for (int j = 0; j < 6; j += 2) {
        float* hi = red + j * T + threadIdx.x;
        float* lo = hi + T;
        *hi = fmaxf(*hi, hi[stride]);
        *lo = fminf(*lo, lo[stride]);
      }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) m[j] = red[j * T];
  if (C > 1) {
    if (threadIdx.x < 6) peer(parts, 0)[me * 6 + threadIdx.x] =
        m[threadIdx.x];
    cluster_sync();
    if (me == 0 && threadIdx.x == 0)
      for (int r = 0; r < C; ++r)
        for (int j = 0; j < 6; j += 2) {
          m[j] = fmaxf(m[j], parts[r * 6 + j]);
          m[j + 1] = fminf(m[j + 1], parts[r * 6 + j + 1]);
        }
  }
  if (me == 0 && threadIdx.x == 0) {
    float* cp = p.champ_part + 6 * i;
    for (int j = 0; j < 6; ++j) cp[j] = m[j];
  }
  clock_mark(D_REDUCE, clk);
}

// Phase 5, once a launch after the loop: the finish of the last iteration
// (the others' run at the start of the next iteration's tail).
template <bool BATCHED>
__global__ void finish_iteration_kernel(Args pb, int it) {
  pdl_trigger();
  const Args p = instance<BATCHED>(pb, blockIdx.x);
  pdl_wait();
  if (p.status[0]) return;
  __shared__ float part[6 * 32];
  __shared__ int done;
  finish_step(p, it, part, &done, true);
}

// ---- the host side: variants, shared memory, launches ----

// A launch's variant: the clusters' sizes and which phases stage their
// matrices.  Encoded for apg_solve_variant as staged tail | prefix << 1 |
// forward << 2 | C << 4 | Cp << 8.
struct Variant {
  int C, Cp;
  bool tail, prefix, fwd;
};
int encode(const Variant& v) {
  return (int)v.tail | (int)v.prefix << 1 | (int)v.fwd << 2 | v.C << 4 |
         v.Cp << 8;
}
Variant decode(int code) {
  return {(code >> 4) & 15, (code >> 8) & 15, (code & 1) != 0,
          (code & 2) != 0, (code & 4) != 0};
}

// Dynamic shared memory (bytes) of the three sweep phases of a variant.
// The unstaged variant at C = Cp = 1 is the one-block design's: the
// routing gate's formula (apg_solve_smem).
struct SweepSmem {
  size_t tail, prefix, fwd;
};
SweepSmem sweep_smem(int N, int ns, int nx, int nu, int nv,
                     const Variant& v) {
  const size_t RS = (size_t)(N + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
  const size_t C = v.C, Cp = v.Cp;
  const size_t nvw = widest(nv, C), nuw = widest(nu, C), nxw = widest(nx, C);
  const size_t pxw = widest(nx, Cp), pvw = widest(nv, Cp);
  const size_t P = Cp > 1 ? (size_t)(ns + 3) / 4 * 4 : ns;
  const size_t tail = (nu + nx + nvw) * RS + (v.tail ? (nu + nx) * nvw : 0);
  const size_t prefix = (Cp > 1 ? 2 : 1) * nx * P + (pxw + 2 * pvw) * ns +
                        (v.prefix ? nx * pvw + (size_t)ns * ns : 0);
  const size_t fwd = (2 * nv + nu + nxw) * RS + (C > 1 ? 2 * nx * RS : 0) +
                     (v.fwd ? nv * nvw + nv * nuw + nu * nxw : 0);
  return {sizeof(float) * tail, sizeof(float) * prefix, sizeof(float) * fwd};
}

struct Device {
  int sms, max_optin, clusters, smem_per_sm;
};
cudaError_t device_limits(Device* d) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d->max_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d->clusters, cudaDevAttrClusterLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d->smem_per_sm,
                                 cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                 dev);
  return err;
}

// The variant these sizes take on a device (mirrored by
// ops/apg_solve.py's `pick`): the largest C <= 8 with the B * ns * C
// slot CTAs within CTAS_PER_SM a SM, and the largest Cp <= 8 with B * Cp
// within the SM count (1 each without cluster launch); a cluster whose
// unstaged variant does not fit the shared memory (less STATIC_RESERVE)
// runs at 1; then the prefix stages its matrices where its staged variant
// fits, and the slot phases where theirs fit and the launch's CTAs are
// all resident at once (within CTAS_PER_SM a SM, that many staged CTAs
// within an SM's shared memory): past that the staged slices' shared
// memory would leave fewer CTAs resident than the unstaged variant's,
// which was measured slower at B = 32.
Variant pick_sizes(int N, int ns, int nx, int nu, int nv, int B,
                   const Device& d) {
  Variant v{1, 1, false, false, false};
  if (d.clusters) {
    for (int c = MAX_CLUSTER; c > 1 && v.C == 1; --c)
      if ((long long)B * ns * c <= (long long)CTAS_PER_SM * d.sms) v.C = c;
    for (int c = MAX_CLUSTER; c > 1 && v.Cp == 1; --c)
      if ((long long)B * c <= d.sms) v.Cp = c;
  }
  const size_t room = (size_t)(d.max_optin - STATIC_RESERVE);
  const SweepSmem plain = sweep_smem(N, ns, nx, nu, nv, v);
  if (plain.tail > room || plain.fwd > room) v.C = 1;
  if (plain.prefix > room) v.Cp = 1;
  const SweepSmem st =
      sweep_smem(N, ns, nx, nu, nv, {v.C, v.Cp, true, true, true});
  const long long ctas = (long long)B * ns * v.C;
  const int per_sm = ctas <= d.sms ? 1 : CTAS_PER_SM;
  auto resident = [&](size_t smem) {
    return smem <= room && ctas <= (long long)per_sm * d.sms &&
           per_sm * (smem + STATIC_RESERVE) <= (size_t)d.smem_per_sm;
  };
  v.tail = resident(st.tail);
  v.prefix = st.prefix <= room;
  v.fwd = resident(st.fwd);
  return v;
}

cudaError_t set_smem(const void* kernel, size_t bytes, int max_optin) {
  if (bytes > (size_t)max_optin) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

// One launch on `st`, after the previous kernel by programmatic stream
// serialization, as clusters of `cluster` CTAs along x.
template <class... Params, class... Actual>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   size_t smem, cudaStream_t st, int cluster,
                   Actual... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[n].val.programmaticStreamSerializationAllowed = 1;
  ++n;
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// A slot kernel's block: 256 threads at C = 1 (the one-block design's,
// whose order its norm partials keep), 512 a cluster CTA.
int slot_threads(int C) { return C > 1 ? WIDE_THREADS : SLOT_THREADS; }

// The three sweep kernels of a variant.
template <bool BATCHED>
struct Kernels {
  void (*tail)(Args, int);
  void (*prefix)(Args);
  void (*fwd)(Args);
};
template <bool BATCHED>
Kernels<BATCHED> kernels(const Variant& v) {
  return {v.tail ? backward_tail_kernel<BATCHED, true>
                 : backward_tail_kernel<BATCHED, false>,
          v.prefix ? backward_prefix_kernel<BATCHED, true>
                   : backward_prefix_kernel<BATCHED, false>,
          v.fwd ? forward_prox_kernel<BATCHED, true>
                : forward_prox_kernel<BATCHED, false>};
}

// Whether `kernel` can run one cluster of `cluster` CTAs with `smem`
// bytes each at once on this device.
cudaError_t cluster_fits(const void* kernel, int cluster, int threads,
                         size_t smem, bool* fits) {
  *fits = true;
  if (cluster <= 1) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  *fits = n >= 1;
  return err;
}

// The variant a launch at these sizes takes: `pick_sizes`, its clusters
// each run at 1 where the device cannot hold one at once, and the shared
// memory set on its kernels.  code >= 0 forces that variant instead
// (refused where it does not fit).
template <bool BATCHED>
cudaError_t plan(int N, int ns, int nx, int nu, int nv, int B, int code,
                 Variant* out) {
  Device d;
  cudaError_t err = device_limits(&d);
  if (err != cudaSuccess) return err;
  // the trees the routing gate takes (apg_solve_smem), whatever variant
  // runs them: a variant past the gate would run trees it refuses
  const SweepSmem gate =
      sweep_smem(N, ns, nx, nu, nv, {1, 1, false, false, false});
  if (gate.tail > (size_t)d.max_optin || gate.prefix > (size_t)d.max_optin ||
      gate.fwd > (size_t)d.max_optin)
    return cudaErrorInvalidValue;
  Variant v = code < 0 ? pick_sizes(N, ns, nx, nu, nv, B, d) : decode(code);
  if (v.C < 1 || v.C > MAX_CLUSTER || v.Cp < 1 || v.Cp > MAX_CLUSTER ||
      ((v.C > 1 || v.Cp > 1) && !d.clusters))
    return cudaErrorInvalidValue;
  for (int pass = 0; pass < 2; ++pass) {
    const SweepSmem sm = sweep_smem(N, ns, nx, nu, nv, v);
    const Kernels<BATCHED> k = kernels<BATCHED>(v);
    if ((err = set_smem((const void*)k.tail, sm.tail, d.max_optin)) !=
            cudaSuccess ||
        (err = set_smem((const void*)k.prefix, sm.prefix, d.max_optin)) !=
            cudaSuccess ||
        (err = set_smem((const void*)k.fwd, sm.fwd, d.max_optin)) !=
            cudaSuccess)
      return err;
    bool slot_ok = true, tail_ok = true, prefix_ok = true;
    const int threads = slot_threads(v.C);
    if ((err = cluster_fits((const void*)k.fwd, v.C, threads, sm.fwd,
                            &slot_ok)) != cudaSuccess ||
        (err = cluster_fits((const void*)k.tail, v.C, threads, sm.tail,
                            &tail_ok)) != cudaSuccess ||
        (err = cluster_fits((const void*)k.prefix, v.Cp, PREFIX_THREADS,
                            sm.prefix, &prefix_ok)) != cudaSuccess)
      return err;
    if (slot_ok && tail_ok && prefix_ok) {
      *out = v;
      return cudaSuccess;
    }
    if (code >= 0 || pass > 0) return cudaErrorInvalidValue;
    // a cluster the device cannot hold at once runs at 1 (then the gate's
    // smem formula holds for the unstaged variant)
    const Device one{d.sms, d.max_optin, 0, d.smem_per_sm};
    const Variant single = pick_sizes(N, ns, nx, nu, nv, B, one);
    if (!(slot_ok && tail_ok)) {
      v.C = 1;
      v.tail = single.tail;
      v.fwd = single.fwd;
    }
    if (!prefix_ok) {
      v.Cp = 1;
      v.prefix = single.prefix;
    }
  }
  return cudaErrorInvalidValue;
}

// Enqueues the p.max_it iterations, four phase kernels each, then the
// last iteration's finish, on `st`.
template <bool BATCHED>
cudaError_t run_iterations(Args p, int code, cudaStream_t st) {
  const int ns = p.ns, B = p.B;
  Variant v;
  cudaError_t err = plan<BATCHED>(p.N, ns, p.nx, p.nu, p.nv, B, code, &v);
  if (err != cudaSuccess) return err;
  p.C = v.C;
  p.Cp = v.Cp;
  const SweepSmem sm = sweep_smem(p.N, ns, p.nx, p.nu, p.nv, v);
  const Kernels<BATCHED> k = kernels<BATCHED>(v);
  const dim3 slots(ns * v.C, B);
  const int threads = slot_threads(v.C);
  const size_t dual_smem = v.C > 1 ? sizeof(float) * 6 * v.C : 0;
  for (int it = 0; it < p.max_it; ++it) {
    if ((err = launch(k.tail, slots, threads, sm.tail, st, v.C, p, it)) !=
        cudaSuccess)
      return err;
    if (p.fp > 0 &&
        (err = launch(k.prefix, dim3(B * v.Cp), PREFIX_THREADS, sm.prefix,
                      st, v.Cp, p)) != cudaSuccess)
      return err;
    if ((err = launch(k.fwd, slots, threads, sm.fwd, st, v.C, p)) !=
            cudaSuccess ||
        (err = launch(dual_update_kernel<BATCHED>, slots, threads, dual_smem,
                      st, v.C, p)) != cudaSuccess)
      return err;
  }
  if (p.max_it > 0)
    return launch(finish_iteration_kernel<BATCHED>, dim3(B), 32, 0, st, 1, p,
                  p.max_it - 1);
  return cudaSuccess;
}

// The solve of apg_solve_batch below, compiled with the per-instance
// offsets (BATCHED = true) or without them (the single solve, B = 1).
template <bool BATCHED>
int solve(
    const float* d1, const float* d2, const float* g, const float* nhp,
    const float* rep, const float* xmin, const float* xmax, const float* xs,
    const float* umin, const float* umax, const float* L, const float* BbT,
    const float* iWT, const float* LT, const float* BT, const float* Cs,
    const float* lams, const float* beta, const float* uhat, const float* e,
    const float* x0, const float* pdu, float* y_xi, float* y_psi,
    float* yp_xi, float* yp_psi, float* w_xi, float* w_psi, float* t,
    float* a, float* df_xi, float* df_psi, float* x, float* u,
    float* norm_part, float* champ_part, float* trace, int* status, int B,
    long long uhat_bs, long long e_bs, int N, int ns, int nx, int nu,
    int nv, int fp, int max_it, float c, float step, float t1c, float t2c,
    float xs_upper, int tol_mode, float tol, int code, void* stream) {
  if (B < 1 || B > 65535) return cudaErrorInvalidValue;   // grid.y limit
  Args p;
  p.B = B; p.N = N; p.ns = ns; p.nx = nx; p.nu = nu; p.nv = nv; p.fp = fp;
  p.RS = (N + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
  p.max_it = max_it;
  p.tol_mode = tol_mode;
  p.C = p.Cp = 1;
  p.c = c; p.step = step; p.t1c = t1c; p.t2c = t2c; p.xs_upper = xs_upper;
  p.tol = tol;
  p.uhat_bs = uhat_bs; p.e_bs = e_bs;
  p.d1 = d1; p.d2 = d2; p.g = g; p.nhp = nhp; p.rep = rep; p.xmin = xmin;
  p.xmax = xmax; p.xs = xs; p.umin = umin; p.umax = umax;
  p.L = L; p.BbT = BbT; p.iWT = iWT; p.LT = LT; p.BT = BT; p.Cs = Cs;
  p.lams = lams;
  p.beta = beta; p.uhat = uhat; p.e = e; p.x0 = x0; p.pdu = pdu;
  p.y_xi = y_xi; p.y_psi = y_psi; p.yp_xi = yp_xi; p.yp_psi = yp_psi;
  p.w_xi = w_xi; p.w_psi = w_psi; p.t = t; p.a = a; p.df_xi = df_xi;
  p.df_psi = df_psi; p.x = x; p.u = u; p.norm_part = norm_part;
  p.champ_part = champ_part; p.trace = trace; p.status = status;
  return run_iterations<BATCHED>(p, code, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Runs max_it iterations of B independent solves on `stream` without
// synchronising.  Every per-instance array carries a leading batch axis
// (contiguous instances); uhat and e may instead be one array read by
// every instance (batch stride 0).  The caller fills y_xi/y_psi and
// yp_xi/yp_psi with the warm start, zeroes x, u, `trace` (B, max_it)
// and `status` (B, 2), and reads x, u, y, trace and status[:, 1] after
// the stream has run.  Returns a cudaError_t (0 on success).
extern "C" int apg_solve_batch(
    const float* d1, const float* d2, const float* g, const float* nhp,
    const float* rep, const float* xmin, const float* xmax, const float* xs,
    const float* umin, const float* umax, const float* L, const float* BbT,
    const float* iWT, const float* LT, const float* BT, const float* Cs,
    const float* lams, const float* beta, const float* uhat, const float* e,
    const float* x0, const float* pdu, float* y_xi, float* y_psi,
    float* yp_xi, float* yp_psi, float* w_xi, float* w_psi, float* t,
    float* a, float* df_xi, float* df_psi, float* x, float* u,
    float* norm_part, float* champ_part, float* trace, int* status, int B,
    long long uhat_bs, long long e_bs, int N, int ns, int nx, int nu,
    int nv, int fp, int max_it, float c, float step, float t1c, float t2c,
    float xs_upper, int tol_mode, float tol, void* stream) {
  return solve<true>(
      d1, d2, g, nhp, rep, xmin, xmax, xs, umin, umax, L, BbT, iWT, LT, BT,
      Cs, lams, beta, uhat, e, x0, pdu, y_xi, y_psi, yp_xi, yp_psi, w_xi,
      w_psi, t, a, df_xi, df_psi, x, u, norm_part, champ_part, trace,
      status, B, uhat_bs, e_bs, N, ns, nx, nu, nv, fp, max_it, c, step, t1c,
      t2c, xs_upper, tol_mode, tol, -1, stream);
}

// apg_solve_batch in the variant `code` (apg_solve_variant's encoding)
// instead of the one the sizes pick: for holding the variants to each
// other and timing them.  Refuses a variant that does not fit.
extern "C" int apg_solve_batch_as(
    const float* d1, const float* d2, const float* g, const float* nhp,
    const float* rep, const float* xmin, const float* xmax, const float* xs,
    const float* umin, const float* umax, const float* L, const float* BbT,
    const float* iWT, const float* LT, const float* BT, const float* Cs,
    const float* lams, const float* beta, const float* uhat, const float* e,
    const float* x0, const float* pdu, float* y_xi, float* y_psi,
    float* yp_xi, float* yp_psi, float* w_xi, float* w_psi, float* t,
    float* a, float* df_xi, float* df_psi, float* x, float* u,
    float* norm_part, float* champ_part, float* trace, int* status, int B,
    long long uhat_bs, long long e_bs, int N, int ns, int nx, int nu,
    int nv, int fp, int max_it, float c, float step, float t1c, float t2c,
    float xs_upper, int tol_mode, float tol, void* stream, int code) {
  if (code < 0) return cudaErrorInvalidValue;
  return solve<true>(
      d1, d2, g, nhp, rep, xmin, xmax, xs, umin, umax, L, BbT, iWT, LT, BT,
      Cs, lams, beta, uhat, e, x0, pdu, y_xi, y_psi, yp_xi, yp_psi, w_xi,
      w_psi, t, a, df_xi, df_psi, x, u, norm_part, champ_part, trace,
      status, B, uhat_bs, e_bs, N, ns, nx, nu, nv, fp, max_it, c, step, t1c,
      t2c, xs_upper, tol_mode, tol, code, stream);
}

// The single solve: B = 1 of the batched solve compiled without the
// per-instance offsets, with the argument list the single-solve wrapper
// has always called.  The batched entry keeps them at B = 1 too, so a
// batch of one holds the batched compilation to this one.
extern "C" int apg_solve(
    const float* d1, const float* d2, const float* g, const float* nhp,
    const float* rep, const float* xmin, const float* xmax, const float* xs,
    const float* umin, const float* umax, const float* L, const float* BbT,
    const float* iWT, const float* LT, const float* BT, const float* Cs,
    const float* lams, const float* beta, const float* uhat, const float* e,
    const float* x0, const float* pdu, float* y_xi, float* y_psi,
    float* yp_xi, float* yp_psi, float* w_xi, float* w_psi, float* t,
    float* a, float* df_xi, float* df_psi, float* x, float* u,
    float* norm_part, float* champ_part, float* trace, int* status, int N,
    int ns, int nx, int nu, int nv, int fp, int max_it, float c, float step,
    float t1c, float t2c, float xs_upper, int tol_mode, float tol,
    void* stream) {
  return solve<false>(
      d1, d2, g, nhp, rep, xmin, xmax, xs, umin, umax, L, BbT, iWT, LT, BT,
      Cs, lams, beta, uhat, e, x0, pdu, y_xi, y_psi, yp_xi, yp_psi, w_xi,
      w_psi, t, a, df_xi, df_psi, x, u, norm_part, champ_part, trace,
      status, 1, 0, 0, N, ns, nx, nu, nv, fp, max_it, c, step, t1c, t2c,
      xs_upper, tol_mode, tol, -1, stream);
}

// The most dynamic shared memory (bytes) a launch of the unstaged variant
// at C = Cp = 1 asks for, which every tree the routing gate takes can
// run; ops/apg_solve.py holds its routing formula to this.
extern "C" long long apg_solve_smem(int N, int ns, int nx, int nu, int nv) {
  const SweepSmem sm =
      sweep_smem(N, ns, nx, nu, nv, {1, 1, false, false, false});
  size_t m = sm.tail > sm.prefix ? sm.tail : sm.prefix;
  return (long long)(m > sm.fwd ? m : sm.fwd);
}

// The dynamic shared memory (bytes) of sweep phase `phase` (0 tail, 1
// prefix, 2 forward) in the variant `code`; ops/apg_solve.py's
// `sweep_smem` mirrors it.
extern "C" long long apg_solve_sweep_smem(int N, int ns, int nx, int nu,
                                          int nv, int code, int phase) {
  const SweepSmem sm = sweep_smem(N, ns, nx, nu, nv, decode(code));
  return (long long)(phase == 0 ? sm.tail : phase == 1 ? sm.prefix : sm.fwd);
}

// The variant a single solve (B = 1, BATCHED = false) or a batched call
// of B solves at these sizes takes on the current device, encoded (staged
// tail | prefix << 1 | forward << 2 | C << 4 | Cp << 8); a negative
// cudaError_t on failure.  Sets the kernels' shared memory as a launch
// would.
extern "C" int apg_solve_variant(int N, int ns, int nx, int nu, int nv,
                                 int B) {
  Variant v;
  const cudaError_t err =
      B == 1 ? plan<false>(N, ns, nx, nu, nv, 1, -1, &v)
             : plan<true>(N, ns, nx, nu, nv, B, -1, &v);
  return err == cudaSuccess ? encode(v) : -(int)err;
}

#ifdef APG_SOLVE_CLOCK
// The instrumented build's spans (N_PARTS sums of SM cycles, in Part's
// order) and each phase's block count (N_PHASES, in Phase's order) into
// the host array `out` (N_PARTS + N_PHASES entries), then zeroed.
// Synchronises.
extern "C" int apg_solve_spans(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + N_PARTS, g_blocks, sizeof(g_blocks));
  const unsigned long long zero[N_PARTS] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_spans, zero, sizeof(g_spans));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_blocks, zero, sizeof(g_blocks));
  return (int)err;
}
#endif

extern "C" const char* apg_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
