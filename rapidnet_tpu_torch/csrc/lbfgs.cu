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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DOT_BLOCKS = 528;    // 4 per SM of an H100
constexpr int MAX_COLS = 16;       // history columns (buffer size + 1)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
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
  __shared__ float red[WARPS][Q];
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

template <typename T, int M>
cudaError_t launch_dots(const float* rep, const void* ms, const void* my,
                        const void* s, const void* yv, const float* g,
                        float* part, long long E, int D, cudaStream_t st) {
  dots_kernel<T, M><<<DOT_BLOCKS, THREADS, 0, st>>>(
      rep, static_cast<const T*>(ms), static_cast<const T*>(my),
      static_cast<const T*>(s), static_cast<const T*>(yv), g, part, E, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dots(int M, const float* rep, const void* ms,
                          const void* my, const void* s, const void* yv,
                          const float* g, float* part, long long E, int D,
                          cudaStream_t st) {
  switch (M) {
#define LBFGS_CASE(m) \
  case m:             \
    return launch_dots<T, m>(rep, ms, my, s, yv, g, part, E, D, st);
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

}  // namespace

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
  const cudaError_t err =
      bf16 ? dispatch_dots<__nv_bfloat16>(M, rep, ms, my, s, yv, g, part, E,
                                          D, st)
           : dispatch_dots<float>(M, rep, ms, my, s, yv, g, part, E, D, st);
  if (err != cudaSuccess) return err;
  const int Q = 6 * M + 6;
  dots_finish_kernel<<<(Q + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      part, DOT_BLOCKS, M, dS, dY, selfd);
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
