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
// 36 us at 67 TFLOP/s: bytes set the bound.  This first kernel is simple:
// plain FP32 FMA loops with the shared matrices read through L1, one
// stage at a time, so the serial latency of the stage recursion, not the
// bytes, bounds it.  Measured on an H100 (700 W): 1.49 ms per iteration
// (K1 ~970 us, ~38 us per stage; K2 ~510 us, ~21 us per stage), device
// idle 0.4 %, ~0.17 TB/s: the product loops wait on their matrix
// operand, read from L1/L2 at every step, and the elementwise passes on
// rounds of dependent global loads.  Staging the matrices in shared
// memory and prefetching the next stage's tile are the next steps.
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
// The iteration counter, lam_i, upd and the shrink factors stay on the
// device (a one-block scalar phase reads the counter), so one iteration's
// launches are captured as a CUDA graph and replayed: the host enqueues
// each iteration with one call.  The squared distances and the champions
// are reduced in two passes (per-block partials, then a fixed-order
// pass), with no atomics, so a run repeats itself bit for bit.
//
// Products are this file's own FP32 FMA loops (no cuBLAS, no tensor
// cores, no TF32): the JAX package computes them at Precision.HIGHEST.
//
// Layout: every per-row array is row-major (N, ns, d) with row
// r = s * ns + i (stage s, slot i), the unpadded layout of the JAX
// package's XLA path; the dual pair is xi (N, ns, 2 nx) = [y1 | y2] and
// psi (N, ns, nu), as the whole-solve kernel keeps it.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 8;            // scenario slots per block
constexpr int GROUP = 4;           // slots per thread in a product (float4)
constexpr int THREADS = 256;       // block size of K1, K2 and the tail
constexpr int SCALAR_THREADS = 256;

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
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

// out[c][j0 .. j0+3] = sum_k M[k * C + c] * X[k * TILE + j0 .. j0+3] for
// the tile: X feature-major in shared memory, M row-major (K, C) in device
// memory, read through L1 (consecutive threads read consecutive c).  Each
// thread owns one output row c and GROUP slots; emit(c, j, acc) runs for
// every slot j of the tile.
template <class Emit>
__device__ __forceinline__ void tile_product(const float* X,
                                             const float* __restrict__ M,
                                             int K, int C, Emit emit) {
  constexpr int NG = TILE / GROUP;
  for (int item = threadIdx.x; item < C * NG; item += blockDim.x) {
    const int c = item % C;
    const int j0 = (item / C) * GROUP;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float m = __ldg(M + k * C + c);
      const float4 xv = *reinterpret_cast<const float4*>(X + k * TILE + j0);
      a0 = fmaf(xv.x, m, a0);
      a1 = fmaf(xv.y, m, a1);
      a2 = fmaf(xv.z, m, a2);
      a3 = fmaf(xv.w, m, a3);
    }
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
  float s1 = 0.f, s2 = 0.f;
  if (advance && it > 0)
    for (int b = threadIdx.x; b < p.nblocks; b += SCALAR_THREADS) {
      s1 += p.norm_part[2 * b];
      s2 += p.norm_part[2 * b + 1];
    }
  s1 = block_reduce<SCALAR_THREADS>(s1, red, Add());
  s2 = block_reduce<SCALAR_THREADS>(s2, red, Add());
  float hx = -inf(), lx = inf(), hp = -inf(), lp = inf();
  if (it >= 2)
    for (int b = threadIdx.x; b < n_champ; b += SCALAR_THREADS) {
      const float* cp = p.champ_part + 4 * b;
      hx = fmaxf(hx, cp[0]);
      lx = fminf(lx, cp[1]);
      hp = fmaxf(hp, cp[2]);
      lp = fminf(lp, cp[3]);
    }
  hx = block_reduce<SCALAR_THREADS>(hx, red, Max());
  lx = block_reduce<SCALAR_THREADS>(lx, red, Min());
  hp = block_reduce<SCALAR_THREADS>(hp, red, Max());
  lp = block_reduce<SCALAR_THREADS>(lp, red, Min());
  if (threadIdx.x == 0) {
    if (it >= 2) p.trace[it - 2] = champion(hx, lx, hp, lp);
    if (advance) {
      p.sc[0] = p.lams[it > 0 ? it - 1 : 0];
      p.sc[1] = p.lams[it];
      p.sc[2] = it > 0 ? 1.f : 0.f;
      p.sc[3] = it > 0 ? shrink(s1, p.t1c) : 0.f;
      p.sc[4] = it > 0 ? shrink(s2, p.t2c) : 0.f;
      *p.ctr = it + 1;
    }
  }
}

// K1 over stages s_hi .. s_lo (descending) for the block's TILE slots.
// gather >= 0: the carries start as the child -> parent sums of prefix
// aggregation `gather`, over the exit carries of the previous launch;
// -1: they start at zero.  Writes y', z', v, its exit carries (buffer
// launch & 1) and its champion partials (row launch * nblocks + block).
__global__ void __launch_bounds__(THREADS)
k1_kernel(Args p, int s_hi, int s_lo, int gather, int launch) {
  extern __shared__ float4 smem4[];
  float* tS = reinterpret_cast<float*>(smem4);   // (nx, TILE) t
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns;
  float* aS = tS + nx * TILE;                    // (nv, TILE) a, inner
  float* gS = aS + nv * TILE;                    // (nu, TILE) g * wp
  __shared__ float red[THREADS];
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);
  const float lam_prev = p.sc[0], lam_i = p.sc[1], upd = p.sc[2];
  const float k1f = p.sc[3], k2f = p.sc[4], c = p.c, step = p.step;
  const int W = nx + nv;
  const float* qin = p.carry + (size_t)((launch + 1) & 1) * ns * W;
  float* qout = p.carry + (size_t)(launch & 1) * ns * W;

  for (int idx = threadIdx.x; idx < TILE * W; idx += blockDim.x) {
    const int j = idx / W, k = idx - j * W;
    float acc = 0.f;
    if (gather >= 0 && j < nt) {
      const int par = p.agg_parent[(size_t)gather * ns + i0 + j];
      for (int m = p.agg_ptr[par]; m < p.agg_ptr[par + 1]; ++m)
        acc += qin[(size_t)p.agg_idx[m] * W + k];
    }
    if (k < nx)
      tS[k * TILE + j] = acc;
    else
      aS[(k - nx) * TILE + j] = acc;
  }
  __syncthreads();

  float hx = -inf(), lx = inf(), hp = -inf(), lp = inf();
  for (int s = s_hi; s >= s_lo; --s) {
    const size_t row0 = (size_t)s * ns + i0;
    // the dual update of the x blocks, the extrapolation and t
    for (int idx = threadIdx.x; idx < nt * nx; idx += blockDim.x) {
      const int j = idx / nx, k = idx - j * nx;
      const size_t r = row0 + j, sk = (size_t)s * nx + k;
      const size_t o1 = r * 2 * nx + k, o2 = o1 + nx;
      const float sqv = p.sq[r];
      const float y1 = p.y_xi[o1], y2 = p.y_xi[o2];
      const float z1 = p.z_xi[o1], z2 = p.z_xi[o2];
      const float pr1 = p.pre_xi[o1], pr2 = p.pre_xi[o2];
      const float w1p = y1 + lam_prev * z1, w2p = y2 + lam_prev * z2;
      const float r1 = residual(pr1, p.bx_min[sk] * sqv,
                                p.bx_max[sk] * sqv, 1.f - k1f, c * w1p);
      const float r2 = residual(pr2, p.bx_s[sk] * sqv, p.xs_upper,
                                1.f - k2f, c * w2p);
      const float y1n = y1 + upd * (lam_prev * z1 + step * r1);
      const float y2n = y2 + upd * (lam_prev * z2 + step * r2);
      const float z1n = y1n - y1, z2n = y2n - y2;
      p.y_xi[o1] = y1n;
      p.y_xi[o2] = y2n;
      p.z_xi[o1] = z1n;
      p.z_xi[o2] = z2n;
      hx = fmaxf(hx, fmaxf(r1, r2));
      lx = fminf(lx, fminf(r1, r2));
      const float w1 = y1n + lam_i * z1n, w2 = y2n + lam_i * z2n;
      const float d1 = p.cx1[sk] * sqv, d2 = p.cx2[sk] * sqv;
      tS[k * TILE + j] = d1 * w1 + d2 * w2 + tS[k * TILE + j];
    }
    // the dual update of the u block, the extrapolation and g wp
    for (int idx = threadIdx.x; idx < TILE * nu; idx += blockDim.x) {
      const int j = idx / nu, k = idx - j * nu;
      float gw = 0.f;
      if (j < nt) {
        const size_t r = row0 + j, sk = (size_t)s * nu + k;
        const size_t o = r * nu + k;
        const float sqv = p.sq[r];
        const float yv = p.y_psi[o], zv = p.z_psi[o], pr = p.pre_psi[o];
        const float wpp = yv + lam_prev * zv;
        const float rp = residual(pr, p.bu_min[sk] * sqv,
                                  p.bu_max[sk] * sqv, 1.f, c * wpp);
        const float ypn = yv + upd * (lam_prev * zv + step * rp);
        const float zpn = ypn - yv;
        p.y_psi[o] = ypn;
        p.z_psi[o] = zpn;
        hp = fmaxf(hp, rp);
        lp = fminf(lp, rp);
        gw = (p.cu[sk] * sqv) * (ypn + lam_i * zpn);
      }
      gS[k * TILE + j] = gw;
    }
    __syncthreads();
    // inner = beta + a + Bb t + L'(g wp), summed in that order; it is the
    // next stage's a.  Both products give a thread the same (c, slots),
    // so the second reads what the first wrote without a barrier.
    tile_product(tS, p.BbT, nx, nv, [&](int cc, int j, float acc) {
      aS[cc * TILE + j] =
          j < nt ? p.beta[(row0 + j) * nv + cc] + aS[cc * TILE + j] + acc
                 : 0.f;
    });
    tile_product(gS, p.L, nu, nv, [&](int cc, int j, float acc) {
      aS[cc * TILE + j] += acc;
    });
    __syncthreads();
    // v = nhp * iW inner
    tile_product(aS, p.iWT, nv, nv, [&](int cc, int j, float acc) {
      if (j < nt) p.v[(row0 + j) * nv + cc] = p.nhp[row0 + j] * acc;
    });
    // the next stage's dual update writes tS and gS, which this product
    // does not read; its first product waits at the barrier above it
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nt * W; idx += blockDim.x) {
    const int j = idx / W, k = idx - j * W;
    qout[(size_t)(i0 + j) * W + k] =
        k < nx ? tS[k * TILE + j] : aS[(k - nx) * TILE + j];
  }
  hx = block_reduce<THREADS>(hx, red, Max());
  lx = block_reduce<THREADS>(lx, red, Min());
  hp = block_reduce<THREADS>(hp, red, Max());
  lp = block_reduce<THREADS>(lp, red, Min());
  if (threadIdx.x == 0) {
    float* cp = p.champ_part + 4 * ((size_t)launch * gridDim.x + blockIdx.x);
    cp[0] = hx; cp[1] = lx; cp[2] = hp; cp[3] = lp;
  }
}

// K2 over stages 0 .. N-1 for the block's TILE slots: u, x, the
// pre-images and the block's partial sums of the two squared distances.
__global__ void __launch_bounds__(THREADS) k2_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* duS = reinterpret_cast<float*>(smem4);  // (nu, TILE) du
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns;
  float* uS = duS + nu * TILE;                   // (nu, TILE) u
  float* xS = uS + nu * TILE;                    // (nx, TILE) x
  float* vS = xS + nx * TILE;                    // (nv, TILE) v
  __shared__ float red[THREADS];
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);
  const float lam_i = p.sc[1], c = p.c;

  for (int idx = threadIdx.x; idx < nu * TILE; idx += blockDim.x)
    duS[idx] = p.pdu[idx / TILE];
  for (int idx = threadIdx.x; idx < nx * TILE; idx += blockDim.x)
    xS[idx] = p.x0[idx / TILE];
  float s1 = 0.f, s2 = 0.f;
  for (int s = 0; s < p.N; ++s) {
    const size_t row0 = (size_t)s * ns + i0;
    for (int idx = threadIdx.x; idx < TILE * nv; idx += blockDim.x) {
      const int j = idx / nv, k = idx - j * nv;
      vS[k * TILE + j] = j < nt ? p.v[(row0 + j) * nv + k] : 0.f;
    }
    __syncthreads();
    // du += L v, u = uhat + du
    tile_product(vS, p.LT, nv, nu, [&](int cc, int j, float acc) {
      const float du = duS[cc * TILE + j] + acc;
      duS[cc * TILE + j] = du;
      float uv = 0.f;
      if (j < nt) {
        uv = p.uhat[(row0 + j) * nu + cc] + du;
        p.u[(row0 + j) * nu + cc] = uv;
      }
      uS[cc * TILE + j] = uv;
    });
    __syncthreads();
    // x = x_prev + e + B u
    tile_product(uS, p.BT, nu, nx, [&](int cc, int j, float acc) {
      if (j < nt) {
        const float xv =
            xS[cc * TILE + j] + p.e[(row0 + j) * nx + cc] + acc;
        xS[cc * TILE + j] = xv;
        p.x[(row0 + j) * nx + cc] = xv;
      }
    });
    __syncthreads();
    // the pre-images and the squared distances of the x blocks
    for (int idx = threadIdx.x; idx < nt * nx; idx += blockDim.x) {
      const int j = idx / nx, k = idx - j * nx;
      const size_t r = row0 + j, sk = (size_t)s * nx + k;
      const size_t o1 = r * 2 * nx + k, o2 = o1 + nx;
      const float sqv = p.sq[r], xv = xS[k * TILE + j];
      const float w1 = p.y_xi[o1] + lam_i * p.z_xi[o1];
      const float w2 = p.y_xi[o2] + lam_i * p.z_xi[o2];
      const float pre1 = (p.cx1[sk] * sqv) * xv + c * w1;
      const float pre2 = (p.cx2[sk] * sqv) * xv + c * w2;
      p.pre_xi[o1] = pre1;
      p.pre_xi[o2] = pre2;
      const float df1 =
          pre1 - clip(pre1, p.bx_min[sk] * sqv, p.bx_max[sk] * sqv);
      const float df2 = pre2 - clip(pre2, p.bx_s[sk] * sqv, p.xs_upper);
      const float rv = p.rep[r];
      s1 += rv * df1 * df1;
      s2 += rv * df2 * df2;
    }
    for (int idx = threadIdx.x; idx < nt * nu; idx += blockDim.x) {
      const int j = idx / nu, k = idx - j * nu;
      const size_t r = row0 + j, o = r * nu + k;
      const float wp = p.y_psi[o] + lam_i * p.z_psi[o];
      p.pre_psi[o] = (p.cu[(size_t)s * nu + k] * p.sq[r]) * uS[k * TILE + j] +
                     c * wp;
    }
    // the next stage loads vS (read before the barrier above) and then
    // waits before it writes duS, uS and xS, which this pass reads
  }
  s1 = block_reduce<THREADS>(s1, red, Add());
  s2 = block_reduce<THREADS>(s2, red, Add());
  if (threadIdx.x == 0) {
    p.norm_part[2 * blockIdx.x] = s1;
    p.norm_part[2 * blockIdx.x + 1] = s2;
  }
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
  hx = block_reduce<THREADS>(hx, red, Max());
  lx = block_reduce<THREADS>(lx, red, Min());
  hp = block_reduce<THREADS>(hp, red, Max());
  lp = block_reduce<THREADS>(lp, red, Min());
  if (threadIdx.x == 0) {
    float* cp = p.champ_part + 4 * ((size_t)s * gridDim.x + blockIdx.x);
    cp[0] = hx; cp[1] = lx; cp[2] = hp; cp[3] = lp;
  }
}

#define SK_TRY(expr)                                 \
  do {                                               \
    const cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return err_;            \
  } while (0)

struct Plan {
  size_t smem_k1, smem_k2;
  const int* ranges;   // (first stage, last stage, gather) per K1 launch
  int n_ranges;
};

// K1: one launch per range of stages.
cudaError_t enqueue_k1(const Args& p, const Plan& pl, cudaStream_t st) {
  for (int k = 0; k < pl.n_ranges; ++k) {
    const int* r = pl.ranges + 3 * k;
    k1_kernel<<<p.nblocks, THREADS, pl.smem_k1, st>>>(p, r[0], r[1], r[2],
                                                      k);
    SK_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

cudaError_t enqueue_k2(const Args& p, const Plan& pl, cudaStream_t st) {
  k2_kernel<<<p.nblocks, THREADS, pl.smem_k2, st>>>(p);
  return cudaGetLastError();
}

// One iteration: the scalars, K1's launches and K2.
cudaError_t enqueue_iteration(const Args& p, const Plan& pl,
                              cudaStream_t st) {
  scalars_kernel<<<1, SCALAR_THREADS, 0, st>>>(p, pl.n_ranges * p.nblocks,
                                               1);
  SK_TRY(cudaGetLastError());
  SK_TRY(enqueue_k1(p, pl, st));
  return enqueue_k2(p, pl, st);
}

// The whole solve: the counter reset, max_it replays of one captured
// iteration, then the tail between two scalar phases.
cudaError_t run_solve(const Args& p, const Plan& pl, cudaStream_t st) {
  SK_TRY(cudaMemsetAsync(p.ctr, 0, sizeof(int), st));
  cudaStream_t cs;
  SK_TRY(cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking));
  cudaError_t err =
      cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    const cudaError_t enq = enqueue_iteration(p, pl, cs);
    cudaGraph_t graph = nullptr;
    err = cudaStreamEndCapture(cs, &graph);
    if (enq != cudaSuccess) err = enq;
    if (err == cudaSuccess) {
      cudaGraphExec_t exec = nullptr;
      err = cudaGraphInstantiateWithFlags(&exec, graph, 0);
      for (int it = 0; it < p.max_it && err == cudaSuccess; ++it)
        err = cudaGraphLaunch(exec, st);
      // in-flight launches complete before the executable is freed
      if (exec) cudaGraphExecDestroy(exec);
    }
    if (graph) cudaGraphDestroy(graph);
  }
  const cudaError_t err2 = cudaStreamDestroy(cs);
  SK_TRY(err);
  SK_TRY(err2);
  scalars_kernel<<<1, SCALAR_THREADS, 0, st>>>(p, pl.n_ranges * p.nblocks,
                                               1);
  SK_TRY(cudaGetLastError());
  tail_kernel<<<dim3(p.nblocks, p.N), THREADS, 0, st>>>(p);
  SK_TRY(cudaGetLastError());
  scalars_kernel<<<1, SCALAR_THREADS, 0, st>>>(p, p.N * p.nblocks, 0);
  return cudaGetLastError();
}

// Dynamic shared memory of K1 and K2 (bytes): the launch's and, through
// apg_stream_smem, the routing gate's one formula.
size_t smem_k1(int nx, int nu, int nv) {
  return sizeof(float) * (size_t)(nx + nv + nu) * TILE;
}
size_t smem_k2(int nx, int nu, int nv) {
  return sizeof(float) * (size_t)(2 * nu + nx + nv) * TILE;
}

cudaError_t set_smem(const void* kernel, size_t bytes, int max_optin) {
  if (bytes > (size_t)max_optin) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

}  // namespace

// mode 0: the whole solve of max_it iterations and the tail; the caller
// fills y_xi/y_psi with the warm start, zeroes z, the pre-images and the
// trace, and reads x, u, v, y and the trace after the stream has run.
// mode 1: one K1 pass (every range of stages), mode 2: one K2 pass, from
// the state and the scalars (sc[0..4]) the caller put in place; K1 leaves
// its champion partials in champ_part (row launch * nblocks + block), K2
// its squared-distance partials in norm_part.  Enqueued on `stream`
// without synchronising.  Returns a cudaError_t (0 on success).
extern "C" int apg_stream(
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
    int N, int ns, int nx, int nu, int nv, int max_it, const int* ranges,
    int n_ranges, float c, float step, float t1c, float t2c, float xs_upper,
    int mode, void* stream) {
  if (N < 1 || N > 65535 || ns < 1 || max_it < 1 || n_ranges < 1)
    return cudaErrorInvalidValue;
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

  Plan pl;
  pl.smem_k1 = smem_k1(nx, nu, nv);
  pl.smem_k2 = smem_k2(nx, nu, nv);
  pl.ranges = ranges;
  pl.n_ranges = n_ranges;
  int dev = 0, max_optin = 0;
  SK_TRY(cudaGetDevice(&dev));
  SK_TRY(cudaDeviceGetAttribute(&max_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  SK_TRY(set_smem((const void*)k1_kernel, pl.smem_k1, max_optin));
  SK_TRY(set_smem((const void*)k2_kernel, pl.smem_k2, max_optin));

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1) return enqueue_k1(p, pl, st);
  if (mode == 2) return enqueue_k2(p, pl, st);
  if (mode != 0) return cudaErrorInvalidValue;
  return run_solve(p, pl, st);
}

// The slots per block, which the wrapper sizes its partials by.
extern "C" int apg_stream_tile() { return TILE; }

// The most dynamic shared memory (bytes) a launch at these sizes asks
// for; ops/apg_stream.py holds its routing formula to this.
extern "C" long long apg_stream_smem(int N, int ns, int nx, int nu, int nv) {
  (void)N; (void)ns;
  const size_t k1 = smem_k1(nx, nu, nv), k2 = smem_k2(nx, nu, nv);
  return (long long)(k1 > k2 ? k1 : k2);
}

extern "C" const char* apg_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
