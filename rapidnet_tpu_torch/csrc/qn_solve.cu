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
// buffer of 5) the state is ~14 dual-sized buffers of 144k floats (~8
// MB) plus the 2 x 6 history columns (~6.9 MB in float32, ~3.5 MB in
// bf16): ~15 MB, far above a block's shared memory and inside the 50 MB
// L2.  Three tree sweeps per iteration hold most of the
// operations (~54 MFLOP each); everything else is elementwise work and
// reductions over the dual space, whose every dot and norm couples the
// whole tree.  So, as in apg_solve.cu, every piece of the iteration is a
// phase kernel launched in order on one stream: one block per scenario
// slot for the sweeps' slot recursions and all elementwise work (the
// stage recursions stay inside a block), one block for the branching
// prefix, one thread for each scalar decision (the L-BFGS accept test,
// the line-search set-up, each trial's comparison, the trace).  That is
// ~60 launches per iteration, and their host enqueue would set the pace;
// so the iterations after the first, whose launch sequence is fixed, run
// as one captured CUDA graph launched once per iteration.  Every decision
// the Pallas kernel takes with pl.when is a device-side flag here: the
// search's done flag turns the remaining trials into early returns, and
// the tolerance exit's done flag (with the iteration count) turns every
// later phase into one.  The host never reads the device.
//
// Measured on an H100 (700 W): ~342 ms per 500-iteration FBE solve and
// ~350 ms per NAMA solve, the device busy 98% of it.  Half of an iteration
// (~0.69 ms) is the three sweeps, whose single-block prefix phase alone
// takes 141 us; most of the rest is the line-search trials (~220 us) and
// the ten two-loop steps (~69 us).  The elementwise and dot phases are
// short and latency-bound on ns = 25 blocks, so they run 1024 threads a
// block (at 256 they took 1.6-2.3 times as long), and the FBE value's
// smoothing product du W' uses the sweeps' register-tiled product (with
// both, the residual-and-value phase fell from 319 to 145 us an
// iteration).
//
// The batch axis.  B independent solves over one factor step run in one
// call: what the TPU kernel's batch wrappers compute by a lax.map of the
// whole-solve pallas_call (rapidnet_tpu/ops/pallas_qn.py:686-739,
// make_qn_pallas_batch and make_qn_pallas_batch_shared), as the
// batch axis of apg_solve.cu does it (apg_solve.cu:45-78).  Every phase
// takes its instance from the grid (blockIdx.y for the slot and
// elementwise phases, blockIdx.x for the prefix, one thread per instance
// for the scalar phases), and `instance()` moves each per-instance
// pointer to its slice; the row constants, the matrices, Cs and W' are
// read by every instance from one buffer, and uhat, e and alpha_price
// may be too (batch stride 0, the shared-forecast batch).  The single
// solve is B = 1 of the same source, compiled without the per-instance
// offsets (BATCHED = false); the batched entry keeps them at every B, B = 1
// included, so a batch of one is held to the single solve.  Flags live in each instance's st: a search
// or a solve that has ended turns only its own instance's later blocks
// into early returns, so a finished instance keeps its state and zero
// traces past its exit.  Launches per iteration stay the same whatever
// B, and the iterations after the first still replay one captured graph.
// Per instance the state is ~13.3 MB at Barcelona scale (21 dual-sized
// buffers with the history, the primal and sweep scratch): ~0.43 GB at
// B = 32, which streams from device memory where the single solve's
// stayed in L2; the slot phases launch B * ns blocks (800 at B = 32).
// The reductions keep their fixed order per instance, so an instance of
// a batch equals its single solve bit for bit.  On an H100 80GB HBM3
// (700 W) a B = 32 call of 500 iterations took 1812 ms (FBE) and 1895 ms
// (NAMA), 3.6-3.8 ms an iteration, 6 times the rate of single solves:
// the residual-and-value, two-loop and trial-apply phases take two
// thirds of it and the sweeps a quarter (PERF.md section 5).
//
// Reductions.  Every dot, norm and champion is reduced in two passes:
// per-block partials, then a fixed-order pass (by the scalar kernel, or
// by every block of the next phase alike).  No atomics, so a run repeats
// itself bit for bit.
//
// The sweeps are copies of the tail, prefix and forward phases of
// apg_solve.cu (:195, :270, :354) with their inputs and outputs passed in
// and the affine terms switched by a template flag; apg_solve.cu is not
// changed.
//
// Products are this file's own FP32 FMA loops (no cuBLAS, no tensor
// cores, no TF32): the JAX package computes them at Precision.HIGHEST.
//
// The history's storage (History<H>): float32 (qn_solve, qn_solve_batch)
// or bf16 (qn_solve_bf16, qn_solve_batch_bf16), the TPU kernel's
// lbfgs_dtype (pallas_qn.py:99, :128).  A bf16 pair is rounded before its
// dots and rho, stored rounded, and widened on read (:335-359, :383);
// all arithmetic stays float32, column 0 stays zero, and the launches per
// iteration are the same.  Only the history's element type differs, so
// the float32 entries compile to what they were.
//
// Layout: every per-row array is row-major (R, d) with row r = s*ns + i
// (stage s, slot i).  A dual-space buffer is flat, [xi (R, 2nx) | psi
// (R, nu)]; the history holds bs + 1 such columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROW_GROUP = 8;        // stage rows per thread in a product
constexpr int SLOT_THREADS = 256;   // the sweeps' slot blocks
constexpr int PREFIX_THREADS = 512;
// the slot blocks of the elementwise and dot phases: short, latency-bound
// work on ns blocks, so as many threads as a block may have
constexpr int EW_THREADS = 1024;
constexpr int LS_MAX_STEPS = 10;    // solver/quasi_newton.py:42-43
constexpr float LS_TOLERANCE = 1e-4f;

// float scalars: sc[S_RHO ..] rho (bs + 1), then alpha (bs + 1)
enum { S_HESS, S_VALUE_REF, S_TAU, S_APPLIED, S_RHO };
// int scalars; I_TRIALS counts the line-search trials that ran
enum { I_DONE, I_ITERS, I_COL, I_MEM, I_SKIPS, I_ACCEPT, I_LS_DONE, I_SKIP,
       I_POSITIVE, I_TRIALS, I_COUNT };

struct Args {
  int B, N, ns, nx, nu, nv, fp, RS, bs, tol_mode, max_it;
  size_t XI, D;   // xi part (R * 2nx) and whole dual buffer (+ R * nu)
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
  // per-block partials
  float *norm_part, *val_part, *dot_part, *pp, *champ_part;
  float *sc, *tr_inf, *tr_val, *tr_tau;
  int* st;
};

// The arguments as instance b sees them: every per-instance pointer
// moved to its slice (a leading batch axis on each array), the shared
// constants untouched.  BATCHED = false (B = 1, the single solve) moves
// nothing, so the single solve runs the code it ran before the batch
// axis existed (apg_solve.cu:118-145).
template <bool BATCHED>
__device__ __forceinline__ Args instance(Args p, int b) {
  if constexpr (BATCHED) {
    const size_t R = (size_t)p.N * p.ns, D = p.D;
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
    p.norm_part += (size_t)b * p.ns * 2;
    p.val_part += (size_t)b * p.ns * 4;
    p.dot_part += (size_t)b * p.ns * 4;
    p.pp += (size_t)b * p.ns * 2;
    p.champ_part += (size_t)b * p.ns * 6;
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

// The instance of a one-thread-per-instance phase, or -1 past the batch.
__device__ __forceinline__ int scalar_instance(int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  return b < B ? b : -1;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  // jnp.clip semantics: max with lo, then min with hi; NaN propagates
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// Calls f(o, r, part, q) for every dual element of slot i: o its index
// in a dual buffer, r its row, part 0 (xi1), 1 (xi2) or 2 (psi), q the
// index of the primal entry it pairs with (x for xi, u for psi).
template <class F>
__device__ __forceinline__ void for_slot_dual(const Args& p, int i, F f) {
  const int nx = p.nx, nx2 = 2 * p.nx, nu = p.nu;
  for (int idx = threadIdx.x; idx < p.N * nx2; idx += blockDim.x) {
    const int s = idx / nx2, k = idx - s * nx2;
    const size_t r = (size_t)s * p.ns + i;
    const int part = k < nx ? 0 : 1;
    f(r * nx2 + k, r, part, r * nx + (k - part * nx));
  }
  for (int idx = threadIdx.x; idx < p.N * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    const size_t r = (size_t)s * p.ns + i;
    f(p.XI + r * nu + k, r, 2, r * nu + k);
  }
}

// Deterministic tree reduction over a block of THREADS threads.
template <int THREADS, class Op>
__device__ __forceinline__ float block_reduce(float v, float* buf, Op op) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
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
  const float* in_psi = in + p.XI;

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

// The prox of g at (x, u) and the dual w, for slot i: the projection
// differences into df and this slot's partial sums of the two penalty
// norms (apg_solve.cu:406-436).  Reads x and u from device memory.
template <int THREADS>
__device__ void prox_diff(const Args& p, int i, const float* __restrict__ w,
                          float* red) {
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu;
  const float c = p.c;
  float s1 = 0.f, s2 = 0.f;
  for (int idx = threadIdx.x; idx < N * nx; idx += blockDim.x) {
    const int s = idx / nx, k = idx - s * nx;
    const size_t r = (size_t)s * ns + i;
    const size_t o = r * nx + k, o1 = r * 2 * nx + k, o2 = o1 + nx;
    const float xv = p.x[o];
    const float pre1 = p.d1[o] * xv + c * w[o1];
    const float df1 = pre1 - clip(pre1, p.xmin[o], p.xmax[o]);
    const float pre2 = p.d2[o] * xv + c * w[o2];
    const float df2 = pre2 - clip(pre2, p.xs[o], p.xs_upper);
    p.df[o1] = df1;
    p.df[o2] = df2;
    s1 += p.rep[r] * df1 * df1;
    s2 += p.rep[r] * df2 * df2;
  }
  for (int idx = threadIdx.x; idx < N * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    const size_t o = ((size_t)s * ns + i) * nu + k;
    const float pre = p.g[o] * p.u[o] + c * w[p.XI + o];
    p.df[p.XI + o] = pre - clip(pre, p.umin[o], p.umax[o]);
  }
  s1 = block_reduce<THREADS>(s1, red, Add());
  s2 = block_reduce<THREADS>(s2, red, Add());
  if (threadIdx.x == 0) {
    p.norm_part[2 * i] = s1;
    p.norm_part[2 * i + 1] = s2;
  }
}

// Sweep phase 3, one block per slot and instance: v, the forward
// cumsums, and x and u into out_x / out_u (apg_solve.cu:354).  The solve
// step (w not null) also takes the prox differences at the dual w; then
// out_x, out_u must be p.x, p.u.
template <bool AFFINE, bool BATCHED>
__global__ void __launch_bounds__(SLOT_THREADS)
sweep_forward_kernel(Args pb, float* __restrict__ out_x_b,
                     float* __restrict__ out_u_b,
                     const float* __restrict__ w_b) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE]) return;
  const size_t R = (size_t)p.N * p.ns;
  float* out_x = slice<BATCHED>(out_x_b, blockIdx.y, R * p.nx);
  float* out_u = slice<BATCHED>(out_u_b, blockIdx.y, R * p.nu);
  const float* w = slice<BATCHED>(w_b, blockIdx.y, p.D);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[SLOT_THREADS];
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
  if (w == nullptr) return;
  __syncthreads();
  prox_diff<SLOT_THREADS>(p, i, w, red);
}

// ---- residual, FBE value, L-BFGS, line search, dual update ----

// One block per slot and instance: the shrink factors (every block sums
// its instance's slot partials in the same order), the residual
// r = (1 - k) df - c w into rs and, with_value, this slot's partials of
// the FBE value: <w, r>, <r, r>, the smoothing cost sum p du' W du
// (du = u - u of the parent, the root's from prev_u) and the economic
// cost sum p u' alpha.  copy_w: also w -> p.w (the solve step, at
// w = y).  ls: a line-search trial, which returns once the search is
// done.
template <bool BATCHED>
__global__ void __launch_bounds__(EW_THREADS)
residual_value_kernel(Args pb, const float* __restrict__ w_b, int copy_w,
                      int with_value, int ls) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE] || (ls && p.st[I_LS_DONE])) return;
  const float* w = slice<BATCHED>(w_b, blockIdx.y, p.D);
  extern __shared__ float4 smem4[];
  float* duT = reinterpret_cast<float*>(smem4);   // (nu, RS)  du
  __shared__ float red[EW_THREADS];
  __shared__ float k12[2];
  const int N = p.N, ns = p.ns, nu = p.nu, RS = p.RS, i = blockIdx.x;
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
  const float k1 = k12[0], k2 = k12[1], c = p.c;
  float wr = 0.f, rr = 0.f;
  for_slot_dual(p, i, [&](size_t o, size_t r, int part, size_t) {
    const float wv = w[o];
    const float kk = part == 0 ? k1 : part == 1 ? k2 : 0.f;
    const float res = (1.f - kk) * p.df[o] - c * wv;
    p.rs[o] = res;
    if (copy_w) p.w[o] = wv;
    wr += p.rep[r] * wv * res;
    rr += p.rep[r] * res * res;
  });
  if (!with_value) return;

  for (int idx = threadIdx.x; idx < RS * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    float du = 0.f;
    if (s < N) {
      const size_t r = (size_t)s * ns + i;
      const float prev = s > 0 ? p.u[(r - ns) * nu + k] : p.pu[k];
      du = p.u[r * nu + k] - prev;
    }
    duT[k * RS + s] = du;
  }
  __syncthreads();
  // (du W')[c] = sum_k du[k] W'[k][c], by the sweeps' product (eight
  // stage rows of one column per thread)
  float sm = 0.f, ec = 0.f;
  slot_product(duT, RS, N, p.WT, nu, nu, [&](int s, int c, float acc) {
    const size_t r = (size_t)s * ns + i;
    sm += p.rep[r] * p.prob[r] * duT[c * RS + s] * acc;
  });
  for (int idx = threadIdx.x; idx < N * nu; idx += blockDim.x) {
    const int s = idx / nu, c = idx - s * nu;
    const size_t r = (size_t)s * ns + i;
    ec += p.rep[r] * p.prob[r] * p.u[r * nu + c] * p.alpha[r * nu + c];
  }
  wr = block_reduce<EW_THREADS>(wr, red, Add());
  rr = block_reduce<EW_THREADS>(rr, red, Add());
  sm = block_reduce<EW_THREADS>(sm, red, Add());
  ec = block_reduce<EW_THREADS>(ec, red, Add());
  if (threadIdx.x == 0) {
    float* vp = p.val_part + 4 * i;
    vp[0] = wr; vp[1] = rr; vp[2] = sm; vp[3] = ec;
  }
}

// The FBE value (computeValueFbe, src/SmpcController.cu:1417-1476) from
// the slot partials, in a fixed order; one thread.
__device__ float fbe_value(const Args& p) {
  float n1 = 0.f, n2 = 0.f, wr = 0.f, rr = 0.f, sm = 0.f, ec = 0.f;
  for (int b = 0; b < p.ns; ++b) {
    n1 += p.norm_part[2 * b];
    n2 += p.norm_part[2 * b + 1];
    wr += p.val_part[4 * b];
    rr += p.val_part[4 * b + 1];
    sm += p.val_part[4 * b + 2];
    ec += p.val_part[4 * b + 3];
  }
  // the g-values: penalty * distance of the post-prox point from its set,
  // k * dist (pallas_qn.py:247-248)
  const float dist1 = sqrtf(n1), dist2 = sqrtf(n2);
  const float k1 = shrink(n1, p.t1c), k2 = shrink(n2, p.t2c);
  const float vg = (k1 > 0.f ? p.pstate * k1 * dist1 : 0.f) +
                   (k2 > 0.f ? p.psafety * k2 * dist2 : 0.f);
  return wr + 0.5f * p.step * rr + vg + sm + ec;
}

// The history's storage type H: float, or bf16 (the TPU kernel's
// lbfgs_dtype, pallas_qn.py:128).  A curvature pair is rounded to H
// before its dots, rho and the accept test (pallas_qn.py:335-340), so the
// stored column and its rho agree; every sum and product stays float,
// and a column is widened as it is read (:383).
template <class H>
struct History;
template <>
struct History<float> {
  __device__ static float round(float v) { return v; }
  __device__ static float store(float v) { return v; }
  __device__ static float load(float v) { return v; }
};
template <>
struct History<__nv_bfloat16> {
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
  __device__ static float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

// Column col of a history buffer.
template <class H>
__device__ __forceinline__ H* column(void* base, int col, size_t D) {
  return static_cast<H*>(base) + (size_t)col * D;
}

// One block per slot: yvec (FBE: -(r + step H(r)), from H(r) in hx, hu;
// NAMA: -r), the two-loop's start dd = -yvec, and this slot's partials of
// <yvec, yvec>, <s, yd>, <yd, yd> and <s, s> for the curvature pair
// s = y - y_prev, yd = yvec - yvec_prev, each rounded to the history's
// storage.  Instance blockIdx.y, as in every slot phase below.
template <class H, bool BATCHED>
__global__ void __launch_bounds__(EW_THREADS)
lbfgs_dots_kernel(Args pb, int is_fbe) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE]) return;
  __shared__ float red[EW_THREADS];
  const int i = blockIdx.x;
  const float step = p.step;
  float gg = 0.f, sy = 0.f, yy = 0.f, ss = 0.f;
  for_slot_dual(p, i, [&](size_t o, size_t r, int part, size_t q) {
    float v;
    if (is_fbe) {
      const float h = part == 2 ? p.g[q] * p.hu[q]
                                : (part == 0 ? p.d1[q] : p.d2[q]) * p.hx[q];
      v = -(p.rs[o] + step * h);
    } else {
      v = -p.rs[o];
    }
    p.yv[o] = v;
    p.dd[o] = -v;
    const float s = History<H>::round(p.y[o] - p.yp[o]);
    const float yd = History<H>::round(v - p.yvp[o]);
    const float rp = p.rep[r];
    gg += rp * v * v;
    sy += rp * s * yd;
    yy += rp * yd * yd;
    ss += rp * s * s;
  });
  gg = block_reduce<EW_THREADS>(gg, red, Add());
  sy = block_reduce<EW_THREADS>(sy, red, Add());
  yy = block_reduce<EW_THREADS>(yy, red, Add());
  ss = block_reduce<EW_THREADS>(ss, red, Add());
  if (threadIdx.x == 0) {
    float* dp = p.dot_part + 4 * i;
    dp[0] = gg; dp[1] = sy; dp[2] = yy; dp[3] = ss;
  }
}

// One thread per instance: the FBE value before the search, the L-BFGS
// accept test and buffer bookkeeping (updateLbfgsBuffer,
// src/SmpcController.cu:1103-1177) and the Hessian scale.
template <bool BATCHED>
__global__ void lbfgs_update_kernel(Args pb) {
  const int inst = scalar_instance(pb.B);
  if (inst < 0) return;
  const Args p = instance<BATCHED>(pb, inst);
  if (p.st[I_DONE]) return;
  float gg = 0.f, sy = 0.f, yy = 0.f, ss = 0.f;
  for (int b = 0; b < p.ns; ++b) {
    const float* dp = p.dot_part + 4 * b;
    gg += dp[0]; sy += dp[1]; yy += dp[2]; ss += dp[3];
  }
  p.sc[S_VALUE_REF] = fbe_value(p);
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

// One block per slot: the accepted pair into its column, and the partial
// of the first two-loop step's dot <s_col, dd>.
template <class H, bool BATCHED>
__global__ void __launch_bounds__(EW_THREADS)
lbfgs_store_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE]) return;
  __shared__ float red[EW_THREADS];
  const int i = blockIdx.x, col = p.st[I_COL], mem = p.st[I_MEM];
  const bool accept = p.st[I_ACCEPT];
  H* ms = column<H>(p.ms, col, p.D);
  H* my = column<H>(p.my, col, p.D);
  float part = 0.f;
  for_slot_dual(p, i, [&](size_t o, size_t r, int, size_t) {
    if (accept) {
      ms[o] = History<H>::store(p.y[o] - p.yp[o]);
      my[o] = History<H>::store(p.yv[o] - p.yvp[o]);
    }
    if (mem > 0) part += p.rep[r] * History<H>::load(ms[o]) * p.dd[o];
  });
  part = block_reduce<EW_THREADS>(part, red, Add());
  if (threadIdx.x == 0) p.pp[i] = part;
}

// One block per slot: step q of the two-loop recursion.  Every block sums
// the step's dot partials (pp[q & 1]) in the same order; the first loop
// does dd -= a y_col with a = rho dot (block 0 keeps a as alpha[col]),
// the second dd += (alpha[col] - rho dot) s_col; after the first loop's
// last step dd *= the Hessian scale.  Then this slot's partial of the
// next step's dot into pp[(q + 1) & 1] or, after the last step, of the
// line search's direction value (FBE: <yvec, dd>; NAMA: <r, dd>, whose
// search direction wd = dd - step r is formed here).
template <class H, bool BATCHED>
__global__ void __launch_bounds__(EW_THREADS)
two_loop_kernel(Args pb, int q, int is_fbe) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE]) return;
  __shared__ float red[EW_THREADS];
  __shared__ float coef_s;
  const int i = blockIdx.x, bs = p.bs, ns = p.ns;
  const int col = p.st[I_COL], mem = p.st[I_MEM];
  const float* rho = p.sc + S_RHO;
  float* alpha = p.sc + S_RHO + bs + 1;
  bool act;
  const int icol = loop_column(q, bs, col, mem, &act);
  if (threadIdx.x == 0) {
    float coef = 0.f;
    if (act) {
      const float* part = p.pp + (q & 1) * ns;
      float dot = 0.f;
      for (int b = 0; b < ns; ++b) dot += part[b];
      const float v = rho[icol] * dot;
      if (q < bs) {
        coef = -v;
        if (blockIdx.x == 0) alpha[icol] = v;
      } else {
        coef = alpha[icol] - v;
      }
    }
    coef_s = coef;
  }
  __syncthreads();
  const float coef = coef_s;
  const H* M = column<H>(q < bs ? p.my : p.ms, icol, p.D);
  const float hess = p.sc[S_HESS];
  bool nact = false;
  const H* V = nullptr;         // the next step's other factor
  if (q + 1 < 2 * bs) {
    const int ncol = loop_column(q + 1, bs, col, mem, &nact);
    V = column<H>(q + 1 < bs ? p.ms : p.my, ncol, p.D);
  }
  const bool last = q == 2 * bs - 1, nama = !is_fbe;
  const float step = p.step;
  float part = 0.f;
  for_slot_dual(p, i, [&](size_t o, size_t r, int, size_t) {
    float d = p.dd[o];
    if (act) d = d + coef * History<H>::load(M[o]);
    if (q == bs - 1) d = hess * d;
    p.dd[o] = d;
    if (nact) part += p.rep[r] * History<H>::load(V[o]) * d;
    if (last) {
      if (nama) {
        const float res = p.rs[o];
        p.wd[o] = d - step * res;
        part += p.rep[r] * res * d;
      } else {
        part += p.rep[r] * p.yv[o] * d;
      }
    }
  });
  part = block_reduce<EW_THREADS>(part, red, Add());
  if (threadIdx.x == 0) p.pp[((q + 1) & 1) * ns + i] = part;
}

// One block per slot, NAMA only: the unconditional residual step
// w += step r, x += step H(r), u += step H(r) (pallas_qn.py:436-441).
template <bool BATCHED>
__global__ void __launch_bounds__(EW_THREADS)
nama_step_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE]) return;
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, i = blockIdx.x;
  const float step = p.step;
  for_slot_dual(p, i, [&](size_t o, size_t, int, size_t) {
    p.w[o] = p.w[o] + step * p.rs[o];
  });
  for (int idx = threadIdx.x; idx < N * nx; idx += blockDim.x) {
    const int s = idx / nx, k = idx - s * nx;
    const size_t o = ((size_t)s * ns + i) * nx + k;
    p.x[o] = p.x[o] + step * p.hx[o];
  }
  for (int idx = threadIdx.x; idx < N * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    const size_t o = ((size_t)s * ns + i) * nu + k;
    p.u[o] = p.u[o] + step * p.hu[o];
  }
}

// One thread per instance: the line search's direction value and whether
// it runs (computeLineSearchLbfgsUpdate :1250-1320; the AME variant
// :1326-1414).
template <bool BATCHED>
__global__ void ls_init_kernel(Args pb, int is_fbe) {
  const int inst = scalar_instance(pb.B);
  if (inst < 0) return;
  const Args p = instance<BATCHED>(pb, inst);
  if (p.st[I_DONE]) return;
  float sum = 0.f;
  for (int b = 0; b < p.ns; ++b) sum += p.pp[b];
  const float dval = is_fbe ? sum : -sum;
  const bool positive = dval > 0.f;
  const bool skip = positive || fabsf(dval) < LS_TOLERANCE;
  p.st[I_POSITIVE] = positive;
  p.st[I_SKIP] = skip;
  p.st[I_LS_DONE] = skip;
  p.sc[S_TAU] = 1.f;
  p.sc[S_APPLIED] = 0.f;
}

// One block per slot, trial k's apply: x += tau hx, u += tau hu,
// w += tau wd (cumulative), then the prox differences and norm partials.
template <bool BATCHED>
__global__ void __launch_bounds__(EW_THREADS)
trial_apply_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE] || p.st[I_LS_DONE]) return;
  __shared__ float red[EW_THREADS];
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, i = blockIdx.x;
  const float tau = p.sc[S_TAU];
  for_slot_dual(p, i, [&](size_t o, size_t, int, size_t) {
    p.w[o] = p.w[o] + tau * p.wd[o];
  });
  for (int idx = threadIdx.x; idx < N * nx; idx += blockDim.x) {
    const int s = idx / nx, k = idx - s * nx;
    const size_t o = ((size_t)s * ns + i) * nx + k;
    p.x[o] = p.x[o] + tau * p.hx[o];
  }
  for (int idx = threadIdx.x; idx < N * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    const size_t o = ((size_t)s * ns + i) * nu + k;
    p.u[o] = p.u[o] + tau * p.hu[o];
  }
  __syncthreads();
  prox_diff<EW_THREADS>(p, i, p.w, red);
}

// One thread per instance, trial k's end: the trial count, the FBE value
// against the reference; the next cumulative tau increment (1, then
// -1/2, +1/4 - 1/2, ...: solver/quasi_newton.py:190-229), or the
// search's end.
template <bool BATCHED>
__global__ void trial_finish_kernel(Args pb, int k) {
  const int inst = scalar_instance(pb.B);
  if (inst < 0) return;
  const Args p = instance<BATCHED>(pb, inst);
  if (p.st[I_DONE] || p.st[I_LS_DONE]) return;
  const float val = fbe_value(p);
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

// One block per slot: y_prev <- y, y <- w + step r, yvec_prev <- yvec,
// and this slot's max / min of the three residual blocks.
template <bool BATCHED>
__global__ void __launch_bounds__(EW_THREADS)
dual_update_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.st[I_DONE]) return;
  __shared__ float red[EW_THREADS];
  const int i = blockIdx.x;
  const float step = p.step;
  const float inf = __int_as_float(0x7f800000);
  float hi[3] = {-inf, -inf, -inf}, lo[3] = {inf, inf, inf};
  for_slot_dual(p, i, [&](size_t o, size_t, int part, size_t) {
    const float res = p.rs[o];
    p.yp[o] = p.y[o];
    p.y[o] = p.w[o] + step * res;
    p.yvp[o] = p.yv[o];
    hi[part] = fmaxf(hi[part], res);
    lo[part] = fminf(lo[part], res);
  });
  float* cp = p.champ_part + 6 * i;
  for (int j = 0; j < 3; ++j) {
    const float h = block_reduce<EW_THREADS>(hi[j], red, Max());
    const float l = block_reduce<EW_THREADS>(lo[j], red, Min());
    if (threadIdx.x == 0) {
      cp[2 * j] = h;
      cp[2 * j + 1] = l;
    }
  }
}

// champion update of pallas_qn.py:269-274
__device__ __forceinline__ void champion(float& babs, float& bval,
                                         float hi, float lo) {
  const float cval = hi > -lo ? hi : lo;
  const float cabs = fabsf(cval);
  if (cabs > babs) bval = cval;
  babs = fmaxf(babs, cabs);
}

// One thread per instance: the traces at this iteration (the value and
// tau are zero at the first, qn = 0), the iteration count and, with a
// tolerance, the done flag (the JAX while_loop's test: continue while
// magnitude > tol).
template <bool BATCHED>
__global__ void finish_kernel(Args pb, int qn) {
  const int inst = scalar_instance(pb.B);
  if (inst < 0) return;
  const Args p = instance<BATCHED>(pb, inst);
  if (p.st[I_DONE]) return;
  float m[6] = {p.champ_part[0], p.champ_part[1], p.champ_part[2],
                p.champ_part[3], p.champ_part[4], p.champ_part[5]};
  for (int b = 1; b < p.ns; ++b) {
    const float* cp = p.champ_part + 6 * b;
    for (int j = 0; j < 6; j += 2) {
      m[j] = fmaxf(m[j], cp[j]);
      m[j + 1] = fminf(m[j + 1], cp[j + 1]);
    }
  }
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

// One thread per instance: the scalars of a fresh solve (L-BFGS empty,
// Hessian scale 1).
template <bool BATCHED>
__global__ void init_kernel(Args pb) {
  const int inst = scalar_instance(pb.B);
  if (inst < 0) return;
  const Args p = instance<BATCHED>(pb, inst);
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

// Dynamic shared memory (bytes) of the sweeps and of the residual-and-
// value phase: the launch's and, through qn_solve_smem, the routing
// gate's one formula.
struct SolveSmem {
  size_t tail, prefix, fwd, res;
};
SolveSmem solve_smem(int N, int ns, int nx, int nu, int nv) {
  const size_t RS = (size_t)(N + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
  return {sizeof(float) * (size_t)(nu + nx + nv) * RS,
          sizeof(float) * 2 * (size_t)(nx + nv) * ns,
          sizeof(float) * (size_t)(2 * nv + nu + nx) * RS,
          sizeof(float) * (size_t)nu * RS};
}

struct Plan {
  size_t smem_tail, smem_prefix, smem_fwd, smem_res;
  dim3 slots;               // (ns, B): one block per slot and instance
  int scalar_blocks, scalar_threads;   // one thread per instance
};

#define QN_TRY(call)                             \
  do {                                           \
    const cudaError_t err_ = (call);             \
    if (err_ != cudaSuccess) return err_;        \
  } while (0)

// One tree sweep of the dual direction `in`: the solve step (affine, with
// the prox differences at w = in) or the Hessian oracle into (ox, ou).
template <bool BATCHED>
cudaError_t enqueue_sweep(const Args& p, const Plan& pl, cudaStream_t st,
                          bool affine, const float* in, float* ox, float* ou,
                          const float* w) {
  QN_TRY(affine ? launch(sweep_tail_kernel<true, BATCHED>, pl.slots,
                         SLOT_THREADS, pl.smem_tail, st, p, in)
                : launch(sweep_tail_kernel<false, BATCHED>, pl.slots,
                         SLOT_THREADS, pl.smem_tail, st, p, in));
  if (p.fp > 0)
    QN_TRY(launch(sweep_prefix_kernel<BATCHED>, p.B, PREFIX_THREADS,
                  pl.smem_prefix, st, p));
  return affine ? launch(sweep_forward_kernel<true, BATCHED>, pl.slots,
                         SLOT_THREADS, pl.smem_fwd, st, p, ox, ou, w)
                : launch(sweep_forward_kernel<false, BATCHED>, pl.slots,
                         SLOT_THREADS, pl.smem_fwd, st, p, ox, ou, w);
}

// One iteration's launches on `st`; qn = false for the first iteration,
// which has no curvature pair and no line search (pallas_qn.py:302).
// The direction and output pointers are instance 0's; each phase moves
// them to its own instance.  H: the history's storage.
template <class H, bool BATCHED>
cudaError_t enqueue_iteration(const Args& p, const Plan& pl, cudaStream_t st,
                              bool qn, bool is_fbe) {
  const dim3 S = pl.slots;
  const int T = EW_THREADS, SB = pl.scalar_blocks, ST = pl.scalar_threads;
  QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, true, p.y, p.x, p.u, p.y));
  QN_TRY(launch(residual_value_kernel<BATCHED>, S, T, pl.smem_res, st, p,
                (const float*)p.y, 1, (int)qn, 0));
  if (is_fbe)
    QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, false, p.rs, p.hx, p.hu,
                                  nullptr));
  QN_TRY(launch(lbfgs_dots_kernel<H, BATCHED>, S, T, 0, st, p,
                (int)is_fbe));
  if (qn) {
    QN_TRY(launch(lbfgs_update_kernel<BATCHED>, SB, ST, 0, st, p));
    QN_TRY(launch(lbfgs_store_kernel<H, BATCHED>, S, T, 0, st, p));
    for (int q = 0; q < 2 * p.bs; ++q)
      QN_TRY(launch(two_loop_kernel<H, BATCHED>, S, T, 0, st, p, q,
                    (int)is_fbe));
    if (is_fbe) {
      QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, false, p.dd, p.hx, p.hu,
                                    nullptr));
    } else {
      QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, false, p.rs, p.hx, p.hu,
                                    nullptr));
      QN_TRY(launch(nama_step_kernel<BATCHED>, S, T, 0, st, p));
      QN_TRY(enqueue_sweep<BATCHED>(p, pl, st, false, p.wd, p.hx, p.hu,
                                    nullptr));
    }
    QN_TRY(launch(ls_init_kernel<BATCHED>, SB, ST, 0, st, p, (int)is_fbe));
    for (int k = 0; k <= LS_MAX_STEPS; ++k) {
      QN_TRY(launch(trial_apply_kernel<BATCHED>, S, T, 0, st, p));
      QN_TRY(launch(residual_value_kernel<BATCHED>, S, T, pl.smem_res, st,
                    p, (const float*)p.w, 0, 1, 1));
      QN_TRY(launch(trial_finish_kernel<BATCHED>, SB, ST, 0, st, p, k));
    }
  }
  QN_TRY(launch(dual_update_kernel<BATCHED>, S, T, 0, st, p));
  return launch(finish_kernel<BATCHED>, SB, ST, 0, st, p, (int)qn);
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

// The whole call: shared-memory limits, the history's zero columns, the
// scalars, the first iteration and the graph of the rest.
template <class H, bool BATCHED>
cudaError_t run_solve(const Args& p, cudaStream_t st, int max_it,
                      bool is_fbe) {
  const int ns = p.ns, nx = p.nx, nu = p.nu, nv = p.nv;
  Plan pl;
  const SolveSmem sm = solve_smem(p.N, ns, nx, nu, nv);
  pl.smem_tail = sm.tail;
  pl.smem_prefix = sm.prefix;
  pl.smem_fwd = sm.fwd;
  pl.smem_res = sm.res;
  pl.slots = dim3(ns, p.B);
  pl.scalar_threads = p.B < 32 ? p.B : 32;
  pl.scalar_blocks = (p.B + pl.scalar_threads - 1) / pl.scalar_threads;
  int dev = 0, max_optin = 0;
  QN_TRY(cudaGetDevice(&dev));
  QN_TRY(cudaDeviceGetAttribute(&max_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  QN_TRY(set_smem((const void*)sweep_tail_kernel<true, BATCHED>,
                  pl.smem_tail, max_optin));
  QN_TRY(set_smem((const void*)sweep_tail_kernel<false, BATCHED>,
                  pl.smem_tail, max_optin));
  QN_TRY(set_smem((const void*)sweep_prefix_kernel<BATCHED>, pl.smem_prefix,
                  max_optin));
  QN_TRY(set_smem((const void*)sweep_forward_kernel<true, BATCHED>,
                  pl.smem_fwd, max_optin));
  QN_TRY(set_smem((const void*)sweep_forward_kernel<false, BATCHED>,
                  pl.smem_fwd, max_optin));
  QN_TRY(set_smem((const void*)residual_value_kernel<BATCHED>, pl.smem_res,
                  max_optin));

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
  QN_TRY(launch(init_kernel<BATCHED>, pl.scalar_blocks, pl.scalar_threads,
                0, st, p));
  if (max_it < 1) return cudaSuccess;
  QN_TRY((enqueue_iteration<H, BATCHED>(p, pl, st, false, is_fbe)));
  return run_graph<H, BATCHED>(p, pl, st, max_it, is_fbe);
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
  Args p;
  p.B = B; p.N = N; p.ns = ns; p.nx = nx; p.nu = nu; p.nv = nv; p.fp = fp;
  p.RS = (N + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
  p.bs = bs;
  p.tol_mode = tol_mode;
  p.max_it = max_it;
  p.XI = (size_t)N * ns * 2 * nx;
  p.D = p.XI + (size_t)N * ns * nu;
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
// [xi | psi] of each instance), zeroes x, u, yvp and the three traces
// (B, max_it), and reads x, u, y, the traces and, per instance, st[1]
// (the iteration count), st[4] (the rejected curvature pairs) and st[9]
// (the line-search trials that ran) of st (B, 10) after the stream has
// run.  The history ms, my (B, bs + 1, D) is float here and bf16 in
// qn_solve_batch_bf16.  Returns a cudaError_t (0 on success).
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
  return sweep + 1 + (is_fbe ? sweep : 0) + 1 + 1 + 1 + 2 * bs +
         (is_fbe ? sweep : 2 * sweep + 1) + 1 + 3 * (LS_MAX_STEPS + 1) + 2;
}

// The most dynamic shared memory (bytes) a launch at these sizes asks
// for; ops/qn_solve.py holds its routing formula to this.
extern "C" long long qn_solve_smem(int N, int ns, int nx, int nu, int nv) {
  const SolveSmem sm = solve_smem(N, ns, nx, nu, nv);
  size_t m = sm.tail > sm.prefix ? sm.tail : sm.prefix;
  m = m > sm.fwd ? m : sm.fwd;
  return (long long)(m > sm.res ? m : sm.res);
}

extern "C" const char* qn_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
