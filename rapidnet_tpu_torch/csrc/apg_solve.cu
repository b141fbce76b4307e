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
// served from L2; one iteration moves ~13 MB through L2, a few
// microseconds.  Three points couple the whole tree inside an iteration
// (the prefix aggregation across slots, the two penalty norms and the
// infeasibility champion), so the iteration is five kernels launched in
// order on one stream: ~2,500 launches per 500-iteration solve.  Measured
// on an H100 (700 W), the device is busy 96% of the solve: what bounds it
// is the serial latency inside the phases, not the launches, nor bytes or
// FLOPs.  The single-block prefix phase (~47 us per iteration) and the
// per-slot phases, of which only ns = 25 blocks are in flight (~34 and
// ~41 us), take most of the ~137 us per iteration.
//
// What the design does about that.  Every phase that is independent per
// scenario slot (the tail recursions, the forward cumsums, all
// elementwise work) runs as one block per slot over all N stages, so the
// stage recursions stay inside the block's shared memory and need no grid
// synchronisation.  The host loop launches all iterations without
// synchronising; lam, the shrink factors, the trace and a device-side
// done flag stay on the device.  The norms and the champion are reduced
// in two passes (per-block partials, then a fixed-order pass), with no
// atomics, so a run repeats itself bit for bit.  A persistent cooperative
// kernel or a CUDA graph that removes the launches is later work.
//
// The batch axis.  B independent solves that share the factor step run
// in one call: what the TPU kernel's batch wrappers compute by a vmap of
// the whole-solve pallas_call, which makes the batch a grid axis
// (rapidnet_tpu/ops/pallas_apg.py:477-523, make_apg_pallas_batch and
// make_apg_pallas_batch_shared).  Every phase takes the instance from
// the grid (blockIdx.y for the per-slot phases, blockIdx.x for the
// prefix, one thread per instance for the finish), and `instance()`
// moves each per-instance pointer to its slice; the row constants, the
// matrices, Cs and lams are read by every instance from one buffer, and
// uhat and e may be too (batch stride 0, the shared-forecast batch).
// The single solve is B = 1 of the same source, compiled without the
// per-instance offsets (BATCHED = false); the batched entry keeps them
// at every B, B = 1 included.  Per instance, the state,
// scratch and step inputs are ~1,570 floats per row, ~3.8 MB at
// Barcelona scale, beside ~1.7 MB of shared constants: at B = 32 the
// working set is ~120 MB, above the 50 MB L2, so the batch streams its
// state from device memory where the single solve did not.  One
// iteration moves ~10-13 MB per instance; all from device memory that
// would be ~0.1 ms per iteration at B = 32 (3.35 TB/s).  The per-slot
// phases launch B * ns blocks (800 at B = 32) and the prefix B blocks,
// so the batch also fills the SMs that the single solve leaves idle.
// Launches per call stay 5 per iteration, whatever B.  Done flags,
// iteration counts and traces are per instance; a block whose instance
// has met the tolerance returns at once, so a finished instance keeps
// its state and a zero trace past its exit, as a vmap of the JAX
// while_loop does.  The reductions keep their fixed order per instance,
// so an instance of a batch equals its single solve bit for bit.
// Measured on an H100 (700 W) at B = 32: ~199 ms per 500-iteration
// call, 161 solves/s against 14 for single solves, device busy 97.5%.
// Not the HBM stream but the per-slot products bound the batch: the
// forward and tail phases take 68% of an iteration, grow linearly in B
// and run their FMA loops at 8-10.5% of the FP32 rate (one L1 load of
// the matrix per eight FMAs); the elementwise dual update, at ~46% of
// the HBM rate, takes 15%; the prefix, one block per instance, stays
// at ~50 us per iteration whatever B is.
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

#include <cuda_runtime.h>

namespace {

constexpr int ROW_GROUP = 8;        // stage rows per thread in a product
constexpr int SLOT_THREADS = 256;   // block size of the per-slot kernels
constexpr int PREFIX_THREADS = 512;

struct Args {
  int B, N, ns, nx, nu, nv, fp, RS, max_it, tol_mode;
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

// out[s][c] = sum_k X[k*RS + s] * M[k*C + c] for one slot's stage rows.
// X is the block's operand in shared memory, feature-major with row
// stride RS (a multiple of ROW_GROUP, pad rows zero); M is a row-major
// (K, C) matrix in device memory, read through L1/L2.  Each thread owns
// ROW_GROUP rows of one output column; emit(s, c, acc) runs for s < N.
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

// Phase 1, one block per slot i (blockIdx.x) of instance blockIdx.y:
// extrapolation, the dual-only terms and the tail recursions.  Writes w, and t / a for every stage: the tail
// stages (s >= fp) hold the finished t and inner; the prefix stages hold
// tb = d1 w1 + d2 w2 and a0 = beta + (g wpsi) L for phase 2.
template <bool BATCHED>
__global__ void __launch_bounds__(SLOT_THREADS)
backward_tail_kernel(Args pb, int it) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.status[0]) return;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, nv = p.nv;
  const int RS = p.RS, fp = p.fp, i = blockIdx.x;
  float* gwT = smem;               // (nu, RS)  g * wpsi
  float* tT = gwT + nu * RS;       // (nx, RS)  t
  float* aT = tT + nx * RS;        // (nv, RS)  a, then inner
  const float lam = p.lams[it];

  for (int idx = threadIdx.x; idx < RS * nx; idx += blockDim.x) {
    const int s = idx / nx, k = idx - s * nx;
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
  for (int idx = threadIdx.x; idx < RS * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
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

  // a = beta + (g wpsi) L; meanwhile the suffix cumsum of t over the
  // tail stages fp..N-1 (disjoint buffers)
  slot_product(gwT, RS, N, p.L, nu, nv, [&](int s, int c, float acc) {
    aT[c * RS + s] = p.beta[((size_t)s * ns + i) * nv + c] + acc;
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

// Phase 2, one block per instance (blockIdx.x): the branching prefix,
// stages fp-1..0, which couples the slots of that instance through the
// child->parent sums Cs[s] (identity where the tree does not branch).
// Overwrites a at the prefix stages with inner.
template <bool BATCHED>
__global__ void __launch_bounds__(PREFIX_THREADS)
backward_prefix_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.x);
  if (p.status[0]) return;
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

// Deterministic tree reduction over a block of SLOT_THREADS threads.
template <class Op>
__device__ __forceinline__ float block_reduce(float v, float* buf, Op op) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int stride = SLOT_THREADS / 2; stride > 0; stride >>= 1) {
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

// Phase 3, one block per slot and instance: v, the forward cumsums, x
// and u, the prox pre-images and projection differences, and this
// slot's partial sums of the two penalty norms.
template <bool BATCHED>
__global__ void __launch_bounds__(SLOT_THREADS)
forward_prox_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.status[0]) return;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[SLOT_THREADS];
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, nv = p.nv;
  const int RS = p.RS, i = blockIdx.x;
  float* aT = smem;             // (nv, RS)  inner
  float* vT = aT + nv * RS;     // (nv, RS)  v
  float* uT = vT + nv * RS;     // (nu, RS)  v L', then u
  float* xT = uT + nu * RS;     // (nx, RS)  e + u B', then x

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
      uT[k * RS + s] = p.uhat[((size_t)s * ns + i) * nu + k] + (du + p.pdu[k]);
    }
  }
  __syncthreads();
  slot_product(uT, RS, N, p.BT, nu, nx, [&](int s, int c, float acc) {
    xT[c * RS + s] = p.e[((size_t)s * ns + i) * nx + c] + acc;
  });
  __syncthreads();
  for (int k = threadIdx.x; k < nx; k += blockDim.x) {
    float xa = 0.f;
    for (int s = 0; s < N; ++s) {
      xa += xT[k * RS + s];
      xT[k * RS + s] = xa + p.x0[k];
    }
  }
  __syncthreads();

  const float c = p.c;
  float s1 = 0.f, s2 = 0.f;
  for (int idx = threadIdx.x; idx < N * nx; idx += blockDim.x) {
    const int s = idx / nx, k = idx - s * nx;
    const size_t r = (size_t)s * ns + i;
    const size_t o = r * nx + k, o1 = r * 2 * nx + k, o2 = o1 + nx;
    const float xv = xT[k * RS + s];
    p.x[o] = xv;
    const float pre1 = p.d1[o] * xv + c * p.w_xi[o1];
    const float df1 = pre1 - clip(pre1, p.xmin[o], p.xmax[o]);
    const float pre2 = p.d2[o] * xv + c * p.w_xi[o2];
    const float df2 = pre2 - clip(pre2, p.xs[o], p.xs_upper);
    p.df_xi[o1] = df1;
    p.df_xi[o2] = df2;
    s1 += p.rep[r] * df1 * df1;
    s2 += p.rep[r] * df2 * df2;
  }
  for (int idx = threadIdx.x; idx < N * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    const size_t o = ((size_t)s * ns + i) * nu + k;
    const float uv = uT[k * RS + s];
    p.u[o] = uv;
    const float pre = p.g[o] * uv + c * p.w_psi[o];
    p.df_psi[o] = pre - clip(pre, p.umin[o], p.umax[o]);
  }
  s1 = block_reduce(s1, red, Add());
  s2 = block_reduce(s2, red, Add());
  if (threadIdx.x == 0) {
    p.norm_part[2 * i] = s1;
    p.norm_part[2 * i + 1] = s2;
  }
}

__device__ __forceinline__ float shrink(float sumsq, float thresh) {
  const float dist = sqrtf(sumsq);
  return dist > thresh ? 1.f - thresh / fmaxf(dist, 1e-30f) : 0.f;
}

// Phase 4, one block per slot and instance: the shrink factors (every
// block sums its instance's slot partials in the same order), the
// residual, the dual update and this slot's max / min of the three
// residual blocks.
template <bool BATCHED>
__global__ void __launch_bounds__(SLOT_THREADS)
dual_update_kernel(Args pb) {
  const Args p = instance<BATCHED>(pb, blockIdx.y);
  if (p.status[0]) return;
  __shared__ float red[SLOT_THREADS];
  __shared__ float k12[2];
  const int N = p.N, ns = p.ns, nx = p.nx, nu = p.nu, i = blockIdx.x;
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
  const float k1 = k12[0], k2 = k12[1], c = p.c, step = p.step;
  const float inf = __int_as_float(0x7f800000);
  float hi1 = -inf, lo1 = inf, hi2 = -inf, lo2 = inf, hip = -inf, lop = inf;
  for (int idx = threadIdx.x; idx < N * 2 * nx; idx += blockDim.x) {
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
  for (int idx = threadIdx.x; idx < N * nu; idx += blockDim.x) {
    const int s = idx / nu, k = idx - s * nu;
    const size_t o = ((size_t)s * ns + i) * nu + k;
    const float w = p.w_psi[o];
    const float res = p.df_psi[o] - c * w;
    p.yp_psi[o] = p.y_psi[o];
    p.y_psi[o] = w + step * res;
    hip = fmaxf(hip, res);
    lop = fminf(lop, res);
  }
  hi1 = block_reduce(hi1, red, Max());
  lo1 = block_reduce(lo1, red, Min());
  hi2 = block_reduce(hi2, red, Max());
  lo2 = block_reduce(lo2, red, Min());
  hip = block_reduce(hip, red, Max());
  lop = block_reduce(lop, red, Min());
  if (threadIdx.x == 0) {
    float* cp = p.champ_part + 6 * i;
    cp[0] = hi1; cp[1] = lo1; cp[2] = hi2; cp[3] = lo2; cp[4] = hip;
    cp[5] = lop;
  }
}

// champion update of pallas_apg.py:324-329
__device__ __forceinline__ void champion(float& babs, float& bval,
                                         float hi, float lo) {
  const float cval = hi > -lo ? hi : lo;
  const float cabs = fabsf(cval);
  if (cabs > babs) bval = cval;
  babs = fmaxf(babs, cabs);
}

// Phase 5, one thread per instance: the trace entry, the iteration count
// and, with a tolerance, the done flag (the exit test of the JAX
// while_loop: continue while magnitude > tol).
template <bool BATCHED>
__global__ void finish_iteration_kernel(Args pb, int it) {
  const int inst = blockIdx.x * blockDim.x + threadIdx.x;
  if (inst >= pb.B) return;
  const Args p = instance<BATCHED>(pb, inst);
  if (p.status[0]) return;
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
  p.trace[it] = fmaxf(xval, pval);
  p.status[1] = it + 1;
  if (p.tol_mode && !(fmaxf(xabs, pabs) > p.tol)) p.status[0] = 1;
}

// Dynamic shared memory (bytes) of the three sweep phases: the launch's
// and, through apg_solve_smem, the routing gate's one formula.
struct SweepSmem {
  size_t tail, prefix, fwd;
};
SweepSmem sweep_smem(int N, int ns, int nx, int nu, int nv) {
  const size_t RS = (size_t)(N + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
  return {sizeof(float) * (size_t)(nu + nx + nv) * RS,
          sizeof(float) * 2 * (size_t)(nx + nv) * ns,
          sizeof(float) * (size_t)(2 * nv + nu + nx) * RS};
}

cudaError_t set_smem(const void* kernel, size_t bytes, int max_optin) {
  if (bytes > (size_t)max_optin) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

// Enqueues the p.max_it iterations, five phase kernels each, on `st`.
template <bool BATCHED>
cudaError_t run_iterations(const Args& p, cudaStream_t st) {
  const int ns = p.ns, nx = p.nx, nu = p.nu, nv = p.nv, B = p.B;
  const SweepSmem sm = sweep_smem(p.N, ns, nx, nu, nv);
  const size_t smem_tail = sm.tail, smem_prefix = sm.prefix,
               smem_fwd = sm.fwd;
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if ((err = set_smem((const void*)backward_tail_kernel<BATCHED>, smem_tail,
                      max_optin)) != cudaSuccess ||
      (err = set_smem((const void*)backward_prefix_kernel<BATCHED>,
                      smem_prefix, max_optin)) != cudaSuccess ||
      (err = set_smem((const void*)forward_prox_kernel<BATCHED>, smem_fwd,
                      max_optin)) != cudaSuccess)
    return err;

  const dim3 slots(ns, B);
  const int finish_threads = 32;
  const int finish_blocks = (B + finish_threads - 1) / finish_threads;
  for (int it = 0; it < p.max_it; ++it) {
    backward_tail_kernel<BATCHED>
        <<<slots, SLOT_THREADS, smem_tail, st>>>(p, it);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (p.fp > 0) {
      backward_prefix_kernel<BATCHED>
          <<<B, PREFIX_THREADS, smem_prefix, st>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    forward_prox_kernel<BATCHED><<<slots, SLOT_THREADS, smem_fwd, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dual_update_kernel<BATCHED><<<slots, SLOT_THREADS, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    finish_iteration_kernel<BATCHED>
        <<<finish_blocks, finish_threads, 0, st>>>(p, it);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
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
    float xs_upper, int tol_mode, float tol, void* stream) {
  if (B < 1 || B > 65535) return cudaErrorInvalidValue;   // grid.y limit
  Args p;
  p.B = B; p.N = N; p.ns = ns; p.nx = nx; p.nu = nu; p.nv = nv; p.fp = fp;
  p.RS = (N + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
  p.max_it = max_it;
  p.tol_mode = tol_mode;
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
  return run_iterations<BATCHED>(p, static_cast<cudaStream_t>(stream));
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
      t2c, xs_upper, tol_mode, tol, stream);
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
      xs_upper, tol_mode, tol, stream);
}

// The most dynamic shared memory (bytes) a launch at these sizes asks
// for; ops/apg_solve.py holds its routing formula to this.
extern "C" long long apg_solve_smem(int N, int ns, int nx, int nu, int nv) {
  const SweepSmem sm = sweep_smem(N, ns, nx, nu, nv);
  size_t m = sm.tail > sm.prefix ? sm.tail : sm.prefix;
  return (long long)(m > sm.fwd ? m : sm.fwd);
}

extern "C" const char* apg_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
