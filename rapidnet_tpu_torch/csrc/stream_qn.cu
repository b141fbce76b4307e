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
//
// What bounds it on the card.  At BASELINE config 5 (N = 24, ns = 1024,
// nx = 63, nu = 114, nv = 97) one S1 pass reads the duals (23.6 MB) and
// beta and writes v (9.5 MB); one S2 pass reads v, uhat and e and writes
// x, u and the images (~40 MB): ~10-25 us at 3.35 TB/s, against ~1 GFLOP
// of products per pair, ~15 us at 67 TFLOP/s.  This first kernel keeps
// the design of csrc/apg_stream.cu, whose stage loop is held by the
// latency of its product loops (the matrix operand read through L1/L2 at
// every step, PERF.md section 5): one pair is expected to cost about what
// K1 and K2 do, ~1.4 ms.
//
// What the design does.  Each block owns TILE consecutive scenario slots
// and walks the stages, carrying t and a (S1) or du and x (S2) in shared
// memory; a tile's rows of every (N, ns, d) array are contiguous, so its
// loads coalesce without a transpose.  S1 is one launch per range of
// stages between prefix aggregations: a launch ends by writing its tile's
// carries, and the next starts each slot's carries as the sum over the
// child slots of its parent (index lists; two carry buffers alternate).
// S2 needs no handoff (the fan layout copies a node's values over its
// subtree's slots).  Nothing is reduced, so a run repeats itself bit for
// bit.  Products are this file's FP32 FMA loops (no tensor cores, no
// TF32): the JAX package computes them at Precision.HIGHEST.
//
// Layout: every per-row array is row-major (N, ns, d), row r = s * ns + i
// (stage s, slot i).  The dual triple is one array (N, ns, 2 nx + nu),
// [w1 | w2 | wp] per row, and so are the images [p1 | p2 | pp].

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 8;            // scenario slots per block
constexpr int GROUP = 4;           // slots per thread in a product (float4)
constexpr int THREADS = 256;

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

// out[c][j0 .. j0+3] = sum_k M[k * C + c] * X[k * TILE + j0 .. j0+3] for
// the tile: X feature-major in shared memory, M row-major (K, C) in device
// memory, read through L1 (consecutive threads read consecutive c).  Each
// thread owns one output row c and GROUP slots; emit(c, j, acc) runs for
// every slot j of the tile.  (csrc/apg_stream.cu's loop.)
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

// S1 over stages s_hi .. s_lo (descending) for the block's TILE slots.
// gather >= 0: the carries start as the child -> parent sums of prefix
// aggregation `gather`, over the exit carries of the previous launch;
// -1: they start at zero.  Writes v and its exit carries (buffer
// launch & 1).
template <bool AFFINE>
__global__ void __launch_bounds__(THREADS)
s1_kernel(Args p, int s_hi, int s_lo, int gather, int launch) {
  extern __shared__ float4 smem4[];
  float* tS = reinterpret_cast<float*>(smem4);   // (nx, TILE) t
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns, D = p.D;
  float* aS = tS + nx * TILE;                    // (nv, TILE) a, inner
  float* gS = aS + nv * TILE;                    // (nu, TILE) g * wp
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

  for (int s = s_hi; s >= s_lo; --s) {
    const size_t row0 = (size_t)s * ns + i0;
    // t = d1 w1 + d2 w2 + t
    for (int idx = threadIdx.x; idx < nt * nx; idx += blockDim.x) {
      const int j = idx / nx, k = idx - j * nx;
      const size_t r = row0 + j, sk = (size_t)s * nx + k, o = r * D + k;
      const float sqv = p.sq[r];
      const float d1 = p.cx1[sk] * sqv, d2 = p.cx2[sk] * sqv;
      tS[k * TILE + j] = d1 * p.w[o] + d2 * p.w[o + nx] + tS[k * TILE + j];
    }
    // g wp
    for (int idx = threadIdx.x; idx < TILE * nu; idx += blockDim.x) {
      const int j = idx / nu, k = idx - j * nu;
      float gw = 0.f;
      if (j < nt) {
        const size_t r = row0 + j;
        gw = (p.cu[(size_t)s * nu + k] * p.sq[r]) * p.w[r * D + 2 * nx + k];
      }
      gS[k * TILE + j] = gw;
    }
    __syncthreads();
    // inner = a + Bb t + L'(g wp) [+ beta], summed in that order; it is
    // the next stage's a.  Both products give a thread the same
    // (c, slots), so the second reads what the first wrote without a
    // barrier.
    tile_product(tS, p.BbT, nx, nv, [&](int cc, int j, float acc) {
      aS[cc * TILE + j] = j < nt ? aS[cc * TILE + j] + acc : 0.f;
    });
    tile_product(gS, p.L, nu, nv, [&](int cc, int j, float acc) {
      float a = aS[cc * TILE + j] + acc;
      if (AFFINE && j < nt) a += p.beta[(row0 + j) * nv + cc];
      aS[cc * TILE + j] = a;
    });
    __syncthreads();
    // v = nhp * iW inner
    tile_product(aS, p.iWT, nv, nv, [&](int cc, int j, float acc) {
      if (j < nt) p.v[(row0 + j) * nv + cc] = p.nhp[row0 + j] * acc;
    });
    // the next stage writes tS and gS, which this product does not read;
    // its first product waits at the barrier above it
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nt * W; idx += blockDim.x) {
    const int j = idx / W, k = idx - j * W;
    qout[(size_t)(i0 + j) * W + k] =
        k < nx ? tS[k * TILE + j] : aS[(k - nx) * TILE + j];
  }
}

// S2 over stages 0 .. N-1 for the block's TILE slots: u, x and the primal
// images.
template <bool AFFINE>
__global__ void __launch_bounds__(THREADS) s2_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* duS = reinterpret_cast<float*>(smem4);  // (nu, TILE) du
  const int nx = p.nx, nu = p.nu, nv = p.nv, ns = p.ns, D = p.D;
  float* uS = duS + nu * TILE;                   // (nu, TILE) u
  float* xS = uS + nu * TILE;                    // (nx, TILE) x
  float* vS = xS + nx * TILE;                    // (nv, TILE) v
  const int i0 = blockIdx.x * TILE;
  const int nt = min(TILE, ns - i0);

  for (int idx = threadIdx.x; idx < nu * TILE; idx += blockDim.x)
    duS[idx] = AFFINE ? p.pdu[idx / TILE] : 0.f;
  for (int idx = threadIdx.x; idx < nx * TILE; idx += blockDim.x)
    xS[idx] = AFFINE ? p.x0[idx / TILE] : 0.f;
  for (int s = 0; s < p.N; ++s) {
    const size_t row0 = (size_t)s * ns + i0;
    for (int idx = threadIdx.x; idx < TILE * nv; idx += blockDim.x) {
      const int j = idx / nv, k = idx - j * nv;
      vS[k * TILE + j] = j < nt ? p.v[(row0 + j) * nv + k] : 0.f;
    }
    __syncthreads();
    // du += L v, u = du [+ uhat]
    tile_product(vS, p.LT, nv, nu, [&](int cc, int j, float acc) {
      const float du = duS[cc * TILE + j] + acc;
      duS[cc * TILE + j] = du;
      float uv = 0.f;
      if (j < nt) {
        uv = AFFINE ? p.uhat[(row0 + j) * nu + cc] + du : du;
        p.u[(row0 + j) * nu + cc] = uv;
      }
      uS[cc * TILE + j] = uv;
    });
    __syncthreads();
    // x = x_prev + B u [+ e]
    tile_product(uS, p.BT, nu, nx, [&](int cc, int j, float acc) {
      if (j < nt) {
        float xv = xS[cc * TILE + j] + acc;
        if (AFFINE) xv += p.e[(row0 + j) * nx + cc];
        xS[cc * TILE + j] = xv;
        p.x[(row0 + j) * nx + cc] = xv;
      }
    });
    __syncthreads();
    // the images d1 x, d2 x, g u
    for (int idx = threadIdx.x; idx < nt * nx; idx += blockDim.x) {
      const int j = idx / nx, k = idx - j * nx;
      const size_t r = row0 + j, sk = (size_t)s * nx + k, o = r * D + k;
      const float sqv = p.sq[r], xv = xS[k * TILE + j];
      p.pr[o] = (p.cx1[sk] * sqv) * xv;
      p.pr[o + nx] = (p.cx2[sk] * sqv) * xv;
    }
    for (int idx = threadIdx.x; idx < nt * nu; idx += blockDim.x) {
      const int j = idx / nu, k = idx - j * nu;
      const size_t r = row0 + j;
      p.pr[r * D + 2 * nx + k] =
          (p.cu[(size_t)s * nu + k] * p.sq[r]) * uS[k * TILE + j];
    }
    // the next stage loads vS (read before the barrier above) and then
    // waits before it writes duS, uS and xS, which this pass reads
  }
}

#define SQ_TRY(expr)                                 \
  do {                                               \
    const cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return err_;            \
  } while (0)

// Dynamic shared memory of S1 and S2 (bytes): the launch's and, through
// stream_qn_smem, the routing gate's one formula.
size_t smem_s1(int nx, int nu, int nv) {
  return sizeof(float) * (size_t)(nx + nv + nu) * TILE;
}
size_t smem_s2(int nx, int nu, int nv) {
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

template <bool AFFINE>
cudaError_t run(const Args& p, int mode, const int* ranges, int n_ranges,
                cudaStream_t st) {
  int dev = 0, max_optin = 0;
  SQ_TRY(cudaGetDevice(&dev));
  SQ_TRY(cudaDeviceGetAttribute(&max_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (mode == 1) {
    const size_t bytes = smem_s1(p.nx, p.nu, p.nv);
    SQ_TRY(set_smem((const void*)s1_kernel<AFFINE>, bytes, max_optin));
    for (int k = 0; k < n_ranges; ++k) {
      const int* r = ranges + 3 * k;
      s1_kernel<AFFINE><<<p.nblocks, THREADS, bytes, st>>>(p, r[0], r[1],
                                                           r[2], k);
      SQ_TRY(cudaGetLastError());
    }
    return cudaSuccess;
  }
  if (mode != 2) return cudaErrorInvalidValue;
  const size_t bytes = smem_s2(p.nx, p.nu, p.nv);
  SQ_TRY(set_smem((const void*)s2_kernel<AFFINE>, bytes, max_optin));
  s2_kernel<AFFINE><<<p.nblocks, THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// mode 1: one S1 pass (every range of stages: (first stage, last stage,
// aggregation read at the start or -1) per launch) from w to v; mode 2:
// one S2 pass from v to x, u and the images pr.  affine != 0: the solve
// step (S1 adds beta; S2 starts from pdu and x0 and adds uhat and e);
// 0: the Hessian oracle, which reads none of those pointers.  Enqueued on
// `stream` without synchronising.  Returns a cudaError_t (0 on success).
extern "C" int stream_qn(
    const float* cx1, const float* cx2, const float* cu, const float* sq,
    const float* nhp, const float* L, const float* BbT, const float* iWT,
    const float* LT, const float* BT, const int* agg_parent,
    const int* agg_ptr, const int* agg_idx, const float* beta,
    const float* uhat, const float* e, const float* x0, const float* pdu,
    const float* w, float* v, float* x, float* u, float* pr, float* carry,
    int N, int ns, int nx, int nu, int nv, const int* ranges, int n_ranges,
    int affine, int mode, void* stream) {
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
  return affine ? run<true>(p, mode, ranges, n_ranges, st)
                : run<false>(p, mode, ranges, n_ranges, st);
}

// The slots per block.
extern "C" int stream_qn_tile() { return TILE; }

// The most dynamic shared memory (bytes) a launch at these sizes asks
// for; ops/stream_qn.py holds its routing formula to this.
extern "C" long long stream_qn_smem(int N, int ns, int nx, int nu, int nv) {
  (void)N; (void)ns;
  const size_t s1 = smem_s1(nx, nu, nv), s2 = smem_s2(nx, nu, nv);
  return (long long)(s1 > s2 ? s1 : s2);
}

extern "C" const char* stream_qn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
