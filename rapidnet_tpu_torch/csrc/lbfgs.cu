// The two passes over the L-BFGS history of the streaming FBE/NAMA solve,
// for Hopper (sm_90a), with the history stored in float32 or bfloat16.
//
// Replaces the TPU kernels of rapidnet_tpu/ops/pallas_lbfgs.py::
// make_lbfgs_kernels (dots_kernel :72, pallas_call :123; comb_kernel
// :150, pallas_call :162).  The Gram-form two-loop recursion of
// solver/qn_stream.py runs on span coefficients, so an iteration touches
// the history twice:
//   dots:    for every column m of the s and y histories, the
//            rep-weighted dots <s_m, s>, <s_m, yv>, <s_m, g> and
//            <y_m, s>, <y_m, yv>, <y_m, g>, and the six self-dots
//            <s,s>, <s,yv>, <yv,yv>, <g,g>, <s,g>, <yv,g>;
//   combine: dir = sum_m cs_m s_m + sum_m cy_m y_m + cg g.
// s and yv are stored in the history's type (rounded before the dots, so
// the Gram entries describe what the history holds); g and dir are
// float32; every product and sum is float32 (bf16 values widened with
// __bfloat162float).
//
// What bounds it on the card.  At BASELINE config 5 one column is
// 24 x 1024 x 240 values (23.6 MB in float32); with a buffer of 5 the
// two histories hold 12 columns, 283 MB (142 MB in bfloat16).  Each pass
// reads them once, plus s, yv, g and rep (dots) or g (combine): ~85 us
// (f32) and ~43 us (bf16) at 3.35 TB/s, against ~0.5 GFLOP for the dots,
// 7 us at 67 TFLOP/s: bytes bound both.
//
// What the design does.  Every thread walks a grid-stride range of the
// flat (N, ns, D) index, reads each history column once with consecutive
// threads on consecutive addresses, and keeps the 6 M + 6 dot sums in
// registers (M, the columns, a template parameter).  The dots are a
// split reduction without atomics: each block reduces its threads' sums
// in a fixed order (warp shuffles, then the warps in order) into one row
// of partials, and a second kernel adds the rows in a fixed order, so a
// run repeats itself bit for bit.  combine is one elementwise pass, a
// GEMV over the columns, with the 2 M + 1 coefficients in shared memory.
//
// The bfloat16 dots have a vector body (dots_vec_kernel).  With one
// 2-byte value a load, 4 blocks of 256 threads an SM kept ~28 KB in
// flight an SM, half of what the float32 body keeps, and the pass ran at
// 28 % of its bound (PERF.md section 6), with an integer division for
// each value's row besides.  The vector body takes 8 consecutive values
// of every column with one 16-byte load each (s and yv the same way, g as
// two float4), widens them by shifts (a bfloat16 is the high half of a
// float32) and reads rep once for the 8 (D % 8 == 0, so they share a
// row).  A thread issues s, yv, g, then the columns VEC_GROUP at a time
// (8 loads of 16 bytes together), at 2 blocks of 256 threads an SM for
// M <= 8 (1 past it, where the 6 M + 6 sums take the registers): ~100 KB
// in flight an SM.  The C entry takes it where D and E are multiples of 8
// and every history operand is 16-byte aligned (lbfgs_dots_vector, a
// rule on the shapes and pointers); other shapes, and views at odd
// offsets, run the one-value body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMS = 132;           // an H100's SMs
constexpr int DOT_BLOCKS = 4 * SMS;  // the one-value body's grid
constexpr int MAX_COLS = 16;       // history columns (buffer size + 1)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A block's row of the Q partial sums: each warp's sums by shuffles, then
// the warps' in order, into part[blockIdx.x].
template <int Q>
__device__ __forceinline__ void block_partials(const float (&acc)[Q],
                                               float* __restrict__ part) {
  __shared__ float red[WARPS][Q];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float v = acc[q];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += THREADS) {
    float v = 0.f;
    for (int k = 0; k < WARPS; ++k) v += red[k][q];
    part[(size_t)blockIdx.x * Q + q] = v;
  }
}

// 8 bfloat16 values of a 16-byte load as float32: value 2p is the low
// half of word p.
__device__ __forceinline__ void widen8(const uint4 w, float (&f)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    f[2 * p] = __uint_as_float(u[p] << 16);
    f[2 * p + 1] = __uint_as_float(u[p] & 0xffff0000u);
  }
}

// Pass 1 for the columns' M dots each: block b writes its row of the
// Q = 6 M + 6 partial sums, [m][sS, sY, sG, yS, yY, yG] then the six
// self-dots.
template <typename T, int M>
__global__ void __launch_bounds__(THREADS)
dots_kernel(const float* __restrict__ rep, const T* __restrict__ ms,
            const T* __restrict__ my, const T* __restrict__ s,
            const T* __restrict__ yv, const float* __restrict__ g,
            float* __restrict__ part, long long E, int D) {
  constexpr int Q = 6 * M + 6;
  float acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.f;
  // E < 2^31 (lbfgs_dots checks), so 32-bit indices do not overflow
  const unsigned n = (unsigned)E, stride = gridDim.x * THREADS;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float rv = rep[i / (unsigned)D];
    const float sf = widen(s[i]), yf = widen(yv[i]), gf = g[i];
    const float ts = rv * sf, ty = rv * yf, tg = rv * gf;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float cs = widen(ms[(size_t)m * n + i]);
      const float cy = widen(my[(size_t)m * n + i]);
      acc[6 * m + 0] += cs * ts;
      acc[6 * m + 1] += cs * ty;
      acc[6 * m + 2] += cs * tg;
      acc[6 * m + 3] += cy * ts;
      acc[6 * m + 4] += cy * ty;
      acc[6 * m + 5] += cy * tg;
    }
    acc[6 * M + 0] += ts * sf;
    acc[6 * M + 1] += ts * yf;
    acc[6 * M + 2] += ty * yf;
    acc[6 * M + 3] += tg * gf;
    acc[6 * M + 4] += ts * gf;
    acc[6 * M + 5] += ty * gf;
  }
  block_partials<Q>(acc, part);
}

// Pass 1's vector body for a bfloat16 history: vector v is values 8 v ..
// 8 v + 7 of every operand (E8 = E / 8 of them, D8 = D / 8 a row).  The
// same partials as dots_kernel, each thread's sums in another order.
constexpr int vec_blocks_per_sm(int M) { return M <= 8 ? 2 : 1; }
constexpr int VEC_GROUP = 4;   // history columns whose loads a thread issues
                               // together (2 x 16 bytes each)

template <int M>
__global__ void __launch_bounds__(THREADS, vec_blocks_per_sm(M))
dots_vec_kernel(const float* __restrict__ rep, const uint4* __restrict__ ms,
                const uint4* __restrict__ my, const uint4* __restrict__ s,
                const uint4* __restrict__ yv, const float4* __restrict__ g,
                float* __restrict__ part, int E8, int D8) {
  constexpr int Q = 6 * M + 6;
  float acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.f;
  const int stride = gridDim.x * THREADS;
  for (int v = blockIdx.x * THREADS + threadIdx.x; v < E8; v += stride) {
    const float rv = rep[v / D8];
    const float4 g0 = g[2 * v], g1 = g[2 * v + 1];
    float sf[8], yf[8];
    widen8(s[v], sf);
    widen8(yv[v], yf);
    const float gf[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    float ts[8], ty[8], tg[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ts[e] = rv * sf[e];
      ty[e] = rv * yf[e];
      tg[e] = rv * gf[e];
      acc[6 * M + 0] += ts[e] * sf[e];
      acc[6 * M + 1] += ts[e] * yf[e];
      acc[6 * M + 2] += ty[e] * yf[e];
      acc[6 * M + 3] += tg[e] * gf[e];
      acc[6 * M + 4] += ts[e] * gf[e];
      acc[6 * M + 5] += ty[e] * gf[e];
    }
    // the columns VEC_GROUP at a time: their loads issued together
#pragma unroll
    for (int m0 = 0; m0 < M; m0 += VEC_GROUP) {
      uint4 cs[VEC_GROUP], cy[VEC_GROUP];
#pragma unroll
      for (int j = 0; j < VEC_GROUP && m0 + j < M; ++j) {
        cs[j] = ms[(size_t)(m0 + j) * E8 + v];
        cy[j] = my[(size_t)(m0 + j) * E8 + v];
      }
#pragma unroll
      for (int j = 0; j < VEC_GROUP && m0 + j < M; ++j) {
        const int m = m0 + j;
        float a[8], b[8];
        widen8(cs[j], a);
        widen8(cy[j], b);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[6 * m + 0] += a[e] * ts[e];
          acc[6 * m + 1] += a[e] * ty[e];
          acc[6 * m + 2] += a[e] * tg[e];
          acc[6 * m + 3] += b[e] * ts[e];
          acc[6 * m + 4] += b[e] * ty[e];
          acc[6 * m + 5] += b[e] * tg[e];
        }
      }
    }
  }
  block_partials<Q>(acc, part);
}

// Pass 1b: one warp per quantity adds the blocks' partials in a fixed
// order (lanes stride over the blocks, then a shuffle tree) and writes
// dS (M, 3), dY (M, 3) and the six self-dots.
__global__ void __launch_bounds__(THREADS)
dots_finish_kernel(const float* __restrict__ part, int nblocks, int M,
                   float* __restrict__ dS, float* __restrict__ dY,
                   float* __restrict__ selfd) {
  const int Q = 6 * M + 6;
  const int q = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;
  float v = 0.f;
  for (int b = lane; b < nblocks; b += 32) v += part[(size_t)b * Q + q];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane != 0) return;
  if (q >= 6 * M) {
    selfd[q - 6 * M] = v;
  } else {
    const int m = q / 6, t = q - 6 * m;
    if (t < 3)
      dS[3 * m + t] = v;
    else
      dY[3 * m + t - 3] = v;
  }
}

// Pass 2: out = cg g + sum_m (cs_m s_m + cy_m y_m), coefficients
// [cs (M), cy (M), cg].
template <typename T>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ coef, const T* __restrict__ ms,
               const T* __restrict__ my, const float* __restrict__ g,
               float* __restrict__ out, long long E, int M) {
  __shared__ float cS[2 * MAX_COLS + 1];
  for (int k = threadIdx.x; k < 2 * M + 1; k += THREADS) cS[k] = coef[k];
  __syncthreads();
  const float cg = cS[2 * M];
  const unsigned n = (unsigned)E, stride = gridDim.x * THREADS;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    float o = cg * g[i];
    for (int m = 0; m < M; ++m)
      o += cS[m] * widen(ms[(size_t)m * n + i]) +
           cS[M + m] * widen(my[(size_t)m * n + i]);
    out[i] = o;
  }
}

// Launch the dot pass's first kernel for M columns (the vector body where
// `vec`); sets *blocks to the rows of partials it writes.
template <typename T, int M>
cudaError_t launch_dots(bool vec, const float* rep, const void* ms,
                        const void* my, const void* s, const void* yv,
                        const float* g, float* part, long long E, int D,
                        int* blocks, cudaStream_t st) {
  if (vec) {
    *blocks = vec_blocks_per_sm(M) * SMS;
    dots_vec_kernel<M><<<*blocks, THREADS, 0, st>>>(
        rep, static_cast<const uint4*>(ms), static_cast<const uint4*>(my),
        static_cast<const uint4*>(s), static_cast<const uint4*>(yv),
        reinterpret_cast<const float4*>(g), part, (int)(E / 8), D / 8);
  } else {
    *blocks = DOT_BLOCKS;
    dots_kernel<T, M><<<DOT_BLOCKS, THREADS, 0, st>>>(
        rep, static_cast<const T*>(ms), static_cast<const T*>(my),
        static_cast<const T*>(s), static_cast<const T*>(yv), g, part, E, D);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dots(int M, bool vec, const float* rep, const void* ms,
                          const void* my, const void* s, const void* yv,
                          const float* g, float* part, long long E, int D,
                          int* blocks, cudaStream_t st) {
  switch (M) {
#define LBFGS_CASE(m)                                                     \
  case m:                                                                 \
    return launch_dots<T, m>(vec, rep, ms, my, s, yv, g, part, E, D, blocks, \
                             st);
    LBFGS_CASE(1) LBFGS_CASE(2) LBFGS_CASE(3) LBFGS_CASE(4)
    LBFGS_CASE(5) LBFGS_CASE(6) LBFGS_CASE(7) LBFGS_CASE(8)
    LBFGS_CASE(9) LBFGS_CASE(10) LBFGS_CASE(11) LBFGS_CASE(12)
    LBFGS_CASE(13) LBFGS_CASE(14) LBFGS_CASE(15) LBFGS_CASE(16)
#undef LBFGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

int combine_blocks(long long E) {
  const long long want = (E + THREADS - 1) / THREADS;
  return (int)(want < 4 * DOT_BLOCKS ? (want > 0 ? want : 1)
                                     : 4 * DOT_BLOCKS);
}


bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Whether lbfgs_dots takes the vector body for these operands: a
// bfloat16 history, D and E multiples of 8 and the histories, s, yv and
// g 16-byte aligned.  1 or 0.
extern "C" int lbfgs_dots_vector(const void* ms, const void* my,
                                 const void* s, const void* yv,
                                 const float* g, long long E, int D,
                                 int bf16) {
  return bf16 && D % 8 == 0 && E % 8 == 0 && aligned16(ms) &&
         aligned16(my) && aligned16(s) && aligned16(yv) && aligned16(g);
}

// The dot pass: rep (N, ns) weights the rows of D values; the histories
// ms, my are (M, E) with E = N ns D, s and yv (E) in the storage type
// (bf16 != 0: __nv_bfloat16, else float), g (E) float; part holds
// lbfgs_dot_blocks() x (6 M + 6) floats of scratch.  Writes dS (M, 3),
// dY (M, 3) and selfd (6).  Enqueued on `stream` without synchronising;
// returns a cudaError_t (0 on success).
extern "C" int lbfgs_dots(const float* rep, const void* ms, const void* my,
                          const void* s, const void* yv, const float* g,
                          float* part, float* dS, float* dY, float* selfd,
                          long long E, int D, int M, int bf16, void* stream) {
  if (E < 1 || E > 0x7fffffffLL || D < 1 || M < 1 || M > MAX_COLS)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = lbfgs_dots_vector(ms, my, s, yv, g, E, D, bf16);
  int blocks = 0;
  const cudaError_t err =
      bf16 ? dispatch_dots<__nv_bfloat16>(M, vec, rep, ms, my, s, yv, g, part,
                                          E, D, &blocks, st)
           : dispatch_dots<float>(M, false, rep, ms, my, s, yv, g, part, E, D,
                                  &blocks, st);
  if (err != cudaSuccess) return err;
  const int Q = 6 * M + 6;
  dots_finish_kernel<<<(Q + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      part, blocks, M, dS, dY, selfd);
  return cudaGetLastError();
}

// The combine pass: out (E) float from coef (2 M + 1) float, the
// histories (M, E) in the storage type and g (E) float.
extern "C" int lbfgs_combine(const float* coef, const void* ms,
                             const void* my, const float* g, float* out,
                             long long E, int M, int bf16, void* stream) {
  if (E < 1 || E > 0x7fffffffLL || M < 1 || M > MAX_COLS)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = combine_blocks(E);
  if (bf16)
    combine_kernel<__nv_bfloat16><<<nb, THREADS, 0, st>>>(
        coef, static_cast<const __nv_bfloat16*>(ms),
        static_cast<const __nv_bfloat16*>(my), g, out, E, M);
  else
    combine_kernel<float><<<nb, THREADS, 0, st>>>(
        coef, static_cast<const float*>(ms), static_cast<const float*>(my),
        g, out, E, M);
  return cudaGetLastError();
}

// The rows of partials lbfgs_dots needs, and the most columns it takes.
extern "C" int lbfgs_dot_blocks() { return DOT_BLOCKS; }
extern "C" int lbfgs_max_cols() { return MAX_COLS; }

extern "C" const char* lbfgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
