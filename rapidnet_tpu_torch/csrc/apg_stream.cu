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
// bytes, bounds it.  Measured on an H100 (700 W) while K1's and K2's
// stage loops were written inside the kernels: 1.49 ms per iteration
// (K1 ~970 us, ~38 us per stage; K2 ~510 us, ~21 us per stage), device
// idle 0.4 %, ~0.17 TB/s: the product loops wait on their matrix
// operand, read from L1/L2 at every step, and the elementwise passes on
// rounds of dependent global loads.  With the stage bodies as the
// __device__ functions below, K1 takes about half that and K2 a tenth
// more (PERF.md section 6; chip_smoke.py --reference-kernel times the
// two sources in turns).  Staging the matrices in shared memory and
// prefetching the next stage's tile are the next steps.
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
//
// Layout: every per-row array is row-major (N, ns, d) with row
// r = s * ns + i (stage s, slot i), the unpadded layout of the JAX
// package's XLA path; the dual pair is xi (N, ns, 2 nx) = [y1 | y2] and
// psi (N, ns, nu), as the whole-solve kernel keeps it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// The five scalars an iteration's K1 and K2 read (the layout of sc):
// lam_prev, lam_i, upd and the shrink factors k1f, k2f.
struct Scalars {
  float lam_prev, lam_i, upd, k1f, k2f;
};

__device__ __forceinline__ Scalars given_scalars(const Args& p) {
  return {p.sc[0], p.sc[1], p.sc[2], p.sc[3], p.sc[4]};
}

// The scalars of iteration `it` from the squared distances s1, s2 that
// K2 of iteration it - 1 left.
__device__ __forceinline__ Scalars scalars_of(const Args& p, int it,
                                              float s1, float s2) {
  return {p.lams[it > 0 ? it - 1 : 0], p.lams[it], it > 0 ? 1.f : 0.f,
          it > 0 ? shrink(s1, p.t1c) : 0.f,
          it > 0 ? shrink(s2, p.t2c) : 0.f};
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
  float hx = -inf(), lx = inf(), hp = -inf(), lp = inf();
  if (champ)
    for (int b = threadIdx.x; b < n_champ; b += BLOCK) {
      const float* cp = p.champ_part + 4 * b;
      hx = fmaxf(hx, cp[0]);
      lx = fminf(lx, cp[1]);
      hp = fmaxf(hp, cp[2]);
      lp = fminf(lp, cp[3]);
    }
  hx = block_reduce<BLOCK>(hx, red, Max());
  lx = block_reduce<BLOCK>(lx, red, Min());
  hp = block_reduce<BLOCK>(hp, red, Max());
  lp = block_reduce<BLOCK>(lp, red, Min());
  *ch = champion(hx, lx, hp, lp);
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

// Per-thread running max and min of the x-block and u-block residuals.
struct Champ {
  float hx, lx, hp, lp;
};

// The block's champion partials (hi_x, lo_x, hi_u, lo_u) into cp.
__device__ __forceinline__ void store_champion(Champ h, float* red,
                                               float* cp) {
  h.hx = block_reduce<THREADS>(h.hx, red, Max());
  h.lx = block_reduce<THREADS>(h.lx, red, Min());
  h.hp = block_reduce<THREADS>(h.hp, red, Max());
  h.lp = block_reduce<THREADS>(h.lp, red, Min());
  if (threadIdx.x == 0) {
    cp[0] = h.hx; cp[1] = h.lx; cp[2] = h.hp; cp[3] = h.lp;
  }
}

// K1's stage s for the block's tile (slots i0 .. i0 + nt - 1), the
// carries t and a in tS (nx, TILE) and aS (nv, TILE), gS (nu, TILE)
// scratch.  Writes y', z' and v; with `wout` also w = y' + lam_i z'
// (rows of 2nx + nu, [w1 | w2 | wp]), and with `vkeep` also v as the
// (nv, TILE) tile that K2 multiplies (zero past nt).
__device__ __forceinline__ void k1_stage(const Args& p, const Scalars& q,
                                         int s, int i0, int nt, float* tS,
                                         float* aS, float* gS, Champ& h,
                                         float* wout, float* vkeep) {
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns, D = 2 * nx + nu;
  const float c = p.c, step = p.step;
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
    const float w1p = y1 + q.lam_prev * z1, w2p = y2 + q.lam_prev * z2;
    const float r1 = residual(pr1, p.bx_min[sk] * sqv, p.bx_max[sk] * sqv,
                              1.f - q.k1f, c * w1p);
    const float r2 = residual(pr2, p.bx_s[sk] * sqv, p.xs_upper,
                              1.f - q.k2f, c * w2p);
    const float y1n = y1 + q.upd * (q.lam_prev * z1 + step * r1);
    const float y2n = y2 + q.upd * (q.lam_prev * z2 + step * r2);
    const float z1n = y1n - y1, z2n = y2n - y2;
    p.y_xi[o1] = y1n;
    p.y_xi[o2] = y2n;
    p.z_xi[o1] = z1n;
    p.z_xi[o2] = z2n;
    h.hx = fmaxf(h.hx, fmaxf(r1, r2));
    h.lx = fminf(h.lx, fminf(r1, r2));
    const float w1 = y1n + q.lam_i * z1n, w2 = y2n + q.lam_i * z2n;
    if (wout) {
      wout[r * D + k] = w1;
      wout[r * D + nx + k] = w2;
    }
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
      const float wpp = yv + q.lam_prev * zv;
      const float rp = residual(pr, p.bu_min[sk] * sqv, p.bu_max[sk] * sqv,
                                1.f, c * wpp);
      const float ypn = yv + q.upd * (q.lam_prev * zv + step * rp);
      const float zpn = ypn - yv;
      p.y_psi[o] = ypn;
      p.z_psi[o] = zpn;
      h.hp = fmaxf(h.hp, rp);
      h.lp = fminf(h.lp, rp);
      const float wp = ypn + q.lam_i * zpn;
      if (wout) wout[r * D + 2 * nx + k] = wp;
      gw = (p.cu[sk] * sqv) * wp;
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
    const float v = j < nt ? p.nhp[row0 + j] * acc : 0.f;
    if (j < nt) p.v[(row0 + j) * nv + cc] = v;
    if (vkeep) vkeep[cc * TILE + j] = v;
  });
  // the next stage's dual update writes tS and gS, which this product
  // does not read; its first product waits at the barrier above it
}

// K1 over stages s_hi .. s_lo (descending) for the block's tile, in the
// dynamic shared memory `smem`.  gather >= 0: the carries start as the
// child -> parent sums of prefix aggregation `gather`, over the exit
// carries of the previous range; -1: they start at zero.  Writes y', z',
// v (and w, v's tile, as k1_stage), its exit carries (buffer launch & 1)
// and its champion partials (row launch * nblocks + block).
__device__ __forceinline__ void k1_range(const Args& p, const Scalars& q,
                                         int s_hi, int s_lo, int gather,
                                         int launch, float* smem,
                                         float* red, float* wout,
                                         float* vkeep) {
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns;
  float* tS = smem;              // (nx, TILE) t
  float* aS = tS + nx * TILE;    // (nv, TILE) a, inner
  float* gS = aS + nv * TILE;    // (nu, TILE) g * wp
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);
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

  Champ h = {-inf(), inf(), -inf(), inf()};
  for (int s = s_hi; s >= s_lo; --s)
    k1_stage(p, q, s, i0, nt, tS, aS, gS, h, wout,
             vkeep ? vkeep + (size_t)s * nv * TILE : nullptr);
  __syncthreads();

  for (int idx = threadIdx.x; idx < nt * W; idx += blockDim.x) {
    const int j = idx / W, k = idx - j * W;
    qout[(size_t)(i0 + j) * W + k] =
        k < nx ? tS[k * TILE + j] : aS[(k - nx) * TILE + j];
  }
  store_champion(h, red,
                 p.champ_part + 4 * ((size_t)launch * p.nblocks + blockIdx.x));
}

__global__ void __launch_bounds__(THREADS)
k1_kernel(Args p, int s_hi, int s_lo, int gather, int launch) {
  extern __shared__ float4 smem4[];
  __shared__ float red[THREADS];
  k1_range(p, given_scalars(p), s_hi, s_lo, gather, launch,
           reinterpret_cast<float*>(smem4), red, nullptr, nullptr);
}

// K2's stage-s tile of v from device memory into vS (nv, TILE).
__device__ __forceinline__ const float* load_v(const Args& p, int s, int i0,
                                               int nt, float* vS) {
  const int nv = p.nv;
  const size_t row0 = (size_t)s * p.ns + i0;
  for (int idx = threadIdx.x; idx < TILE * nv; idx += blockDim.x) {
    const int j = idx / nv, k = idx - j * nv;
    vS[k * TILE + j] = j < nt ? p.v[(row0 + j) * nv + k] : 0.f;
  }
  return vS;
}

// K2's stage s for the block's tile from vX, the stage's (nv, TILE) tile
// of v: u, x, the pre-images and the slots' squared distances into s1,
// s2.  du, u and x are carried in duS, uS (nu, TILE) and xS (nx, TILE).
// w comes from `win` (rows of 2nx + nu, as k1_stage writes it) or, where
// it is null, is rebuilt from y and z.  It starts with a barrier: the
// last stage's pre-image pass reads uS and xS, and vX may just have
// been loaded.
__device__ __forceinline__ void k2_stage(const Args& p, float lam_i, int s,
                                         int i0, int nt, float* duS,
                                         float* uS, float* xS,
                                         const float* vX, const float* win,
                                         float* s1, float* s2) {
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns, D = 2 * nx + nu;
  const float c = p.c;
  const size_t row0 = (size_t)s * ns + i0;
  __syncthreads();
  // du += L v, u = uhat + du
  tile_product(vX, p.LT, nv, nu, [&](int cc, int j, float acc) {
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
      const float xv = xS[cc * TILE + j] + p.e[(row0 + j) * nx + cc] + acc;
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
    const float w1 =
        win ? win[r * D + k] : p.y_xi[o1] + lam_i * p.z_xi[o1];
    const float w2 =
        win ? win[r * D + nx + k] : p.y_xi[o2] + lam_i * p.z_xi[o2];
    const float pre1 = (p.cx1[sk] * sqv) * xv + c * w1;
    const float pre2 = (p.cx2[sk] * sqv) * xv + c * w2;
    p.pre_xi[o1] = pre1;
    p.pre_xi[o2] = pre2;
    const float df1 =
        pre1 - clip(pre1, p.bx_min[sk] * sqv, p.bx_max[sk] * sqv);
    const float df2 = pre2 - clip(pre2, p.bx_s[sk] * sqv, p.xs_upper);
    const float rv = p.rep[r];
    *s1 += rv * df1 * df1;
    *s2 += rv * df2 * df2;
  }
  for (int idx = threadIdx.x; idx < nt * nu; idx += blockDim.x) {
    const int j = idx / nu, k = idx - j * nu;
    const size_t r = row0 + j, o = r * nu + k;
    const float wp =
        win ? win[r * D + 2 * nx + k] : p.y_psi[o] + lam_i * p.z_psi[o];
    p.pre_psi[o] = (p.cu[(size_t)s * nu + k] * p.sq[r]) * uS[k * TILE + j] +
                   c * wp;
  }
}

// K2 over stages 0 .. N-1 for the block's tile in `smem`, v from vkeep
// (the (N, nv, TILE) tiles k1_stage kept) or from device memory, w from
// `win` or y and z; its partial sums of the two squared distances into
// norm_part.
__device__ __forceinline__ void k2_all(const Args& p, float lam_i,
                                       float* smem, float* red,
                                       const float* vkeep,
                                       const float* win) {
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns;
  float* duS = smem;             // (nu, TILE) du
  float* uS = duS + nu * TILE;   // (nu, TILE) u
  float* xS = uS + nu * TILE;    // (nx, TILE) x
  float* vS = xS + nx * TILE;    // (nv, TILE) v, unless kept
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);
  for (int idx = threadIdx.x; idx < nu * TILE; idx += blockDim.x)
    duS[idx] = p.pdu[idx / TILE];
  for (int idx = threadIdx.x; idx < nx * TILE; idx += blockDim.x)
    xS[idx] = p.x0[idx / TILE];
  float s1 = 0.f, s2 = 0.f;
  for (int s = 0; s < p.N; ++s) {
    const float* vX = vkeep ? vkeep + (size_t)s * nv * TILE
                            : load_v(p, s, i0, nt, vS);
    // the load writes vS, which the last stage's first product read
    // before the barriers that followed it
    k2_stage(p, lam_i, s, i0, nt, duS, uS, xS, vX, win, &s1, &s2);
  }
  s1 = block_reduce<THREADS>(s1, red, Add());
  s2 = block_reduce<THREADS>(s2, red, Add());
  if (threadIdx.x == 0) {
    p.norm_part[2 * blockIdx.x] = s1;
    p.norm_part[2 * blockIdx.x + 1] = s2;
  }
}

// K2 over stages 0 .. N-1 for the block's TILE slots: u, x, the
// pre-images and the block's partial sums of the two squared distances.
__global__ void __launch_bounds__(THREADS) k2_kernel(Args p) {
  extern __shared__ float4 smem4[];
  __shared__ float red[THREADS];
  k2_all(p, p.sc[1], reinterpret_cast<float*>(smem4), red, nullptr,
         nullptr);
}

// The K1 ranges of one iteration, passed by value to the fused kernel:
// (first stage, last stage, aggregation read at the start or -1).
constexpr int MAX_RANGES = 32;
struct Ranges {
  int n;
  int r[3 * MAX_RANGES];
};

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
// the barrier behind the gather that last read it.
__global__ void __launch_bounds__(THREADS)
fused_kernel(Args p, Ranges rg, float* w, int derive) {
  extern __shared__ float4 smem4[];
  __shared__ float red[THREADS];
  cg::grid_group grid = cg::this_grid();
  float* vkeep = reinterpret_cast<float*>(smem4);
  float* work = vkeep + (size_t)p.N * p.nv * TILE;
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
    k1_range(p, q, r[0], r[1], r[2], k, work, red, w, vkeep);
  }
  // no barrier: each block's forward pass reads only its own slots
  k2_all(p, q.lam_i, work, red, vkeep, w);
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
cudaError_t run_solve(const Args& p, const Plan& pl, cudaStream_t st) {
  SK_TRY(cudaMemsetAsync(p.ctr, 0, sizeof(int), st));
  SK_TRY(replay(
      p, st, [&](cudaStream_t s) { return enqueue_iteration(p, pl, s); }));
  return enqueue_tail(p, pl, st);
}

// Dynamic shared memory of K1 and K2 (bytes): the launch's and, through
// apg_stream_smem, the routing gate's one formula.
size_t smem_k1(int nx, int nu, int nv) {
  return sizeof(float) * (size_t)(nx + nv + nu) * TILE;
}
size_t smem_k2(int nx, int nu, int nv) {
  return sizeof(float) * (size_t)(2 * nu + nx + nv) * TILE;
}
// The fused kernel's: the (N, nv, TILE) tiles of v beside the larger of
// K1's work and K2's without its v tile.
size_t smem_fused(int N, int nx, int nu, int nv) {
  const size_t k2 = sizeof(float) * (size_t)(2 * nu + nx) * TILE;
  const size_t k1 = smem_k1(nx, nu, nv);
  return sizeof(float) * (size_t)N * nv * TILE + (k1 > k2 ? k1 : k2);
}

cudaError_t set_smem(const void* kernel, size_t bytes, int max_optin) {
  if (bytes > (size_t)max_optin) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

// One cooperative launch of the fused kernel.
cudaError_t launch_fused(const Args& p, const Ranges& rg, float* w,
                         int derive, size_t smem, cudaStream_t st) {
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
  return cudaLaunchKernelEx(&cfg, fused_kernel, p, rg, w, derive);
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

// mode 0: the whole solve of max_it iterations and the tail; the caller
// fills y_xi/y_psi with the warm start, zeroes z, the pre-images and the
// trace, and reads x, u, v, y and the trace after the stream has run.
// mode 1: one K1 pass (every range of stages), mode 2: one K2 pass, from
// the state and the scalars (sc[0..4]) the caller put in place; K1 leaves
// its champion partials in champ_part (row launch * nblocks + block), K2
// its squared-distance partials in norm_part.  Enqueued on `stream`
// without synchronising.  Returns a cudaError_t (0 on success).
extern "C" int apg_stream(APG_STREAM_ARGS, int N, int ns, int nx, int nu,
                          int nv, int max_it, const int* ranges,
                          int n_ranges, float c, float step, float t1c,
                          float t2c, float xs_upper, int mode,
                          void* stream) {
  if (N < 1 || N > 65535 || ns < 1 || max_it < 1 || n_ranges < 1)
    return cudaErrorInvalidValue;
  const Args p = make_args(APG_STREAM_ARG_NAMES, N, ns, nx, nu, nv, max_it,
                           c, step, t1c, t2c, xs_upper);
  Plan pl;
  pl.smem_k1 = smem_k1(nx, nu, nv);
  pl.smem_k2 = smem_k2(nx, nu, nv);
  pl.ranges = ranges;
  pl.n_ranges = n_ranges;
  int max_optin = 0;
  SK_TRY(device_limits(&max_optin, nullptr));
  SK_TRY(set_smem((const void*)k1_kernel, pl.smem_k1, max_optin));
  SK_TRY(set_smem((const void*)k2_kernel, pl.smem_k2, max_optin));

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1) return enqueue_k1(p, pl, st);
  if (mode == 2) return enqueue_k2(p, pl, st);
  if (mode != 0) return cudaErrorInvalidValue;
  return run_solve(p, pl, st);
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
  if (N < 1 || N > 65535 || ns < 1 || max_it < 1 || n_ranges < 1 ||
      n_ranges > MAX_RANGES)
    return cudaErrorInvalidValue;
  const Args p = make_args(APG_STREAM_ARG_NAMES, N, ns, nx, nu, nv, max_it,
                           c, step, t1c, t2c, xs_upper);
  Plan pl;
  pl.smem_k1 = smem_k1(nx, nu, nv);
  pl.smem_k2 = smem_k2(nx, nu, nv);
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
  const size_t smem = smem_fused(N, nx, nu, nv);
  SK_TRY(set_smem((const void*)fused_kernel, smem, max_optin));
  int per_sm = 0;
  SK_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_kernel, THREADS, smem));
  if ((long long)per_sm * sms < p.nblocks)
    return cudaErrorCooperativeLaunchTooLarge;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1) return launch_fused(p, rg, w, 0, smem, st);
  if (mode != 0) return cudaErrorInvalidValue;
  SK_TRY(cudaMemsetAsync(p.ctr, 0, sizeof(int), st));
  SK_TRY(replay(p, st, [&](cudaStream_t s) {
    return launch_fused(p, rg, w, 1, smem, s);
  }));
  return enqueue_tail(p, pl, st);
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

// The fused kernel's shared memory (bytes); ops/apg_stream.py holds
// fused_smem to it.
extern "C" long long apg_stream_fused_smem(int N, int ns, int nx, int nu,
                                           int nv) {
  (void)ns;
  return (long long)smem_fused(N, nx, nu, nv);
}

extern "C" const char* apg_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
