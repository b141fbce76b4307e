// The partial distinct-parent block of a scenario shard, for Hopper
// (sm_90a): the one piece of the sharded streaming sweeps that the
// single-device kernels do not have.
//
// Replaces the last grid step of the TPU kernels of
// rapidnet_tpu/ops/pallas_stream_sharded.py: make_apg_stream_sharded's
// k1a (body :264, its o_qp / o_rp outputs :354-358, pallas_call :437)
// and make_sharded_sweeps' s1 (body :830, :873-876, pallas_call :944).
// The rest of those kernels is the single-device K1 and S1 restricted to
// the shard's block of scenario slots and to the stages N-1 .. s_hi:
// csrc/apg_stream.cu (mode 1) and csrc/stream_qn.cu (mode 1) run it
// unchanged, launched over the shard's slab with the shard's own stage
// ranges and handoff lists.  After their last launch, each local slot's
// exit carry [t | a] (nx + nv floats) holds the recursion at the top
// cross-shard stage s_hi; this kernel sums, for every parent of that
// stage, the carries of its child slots that lie in this shard:
//   out[r][k] = sum over m in ptr[r] .. ptr[r+1]-1 of carry[idx[m]][k],
// the shard's share of the parent's child sum (a parent with no child
// here gets zero).  The shards' blocks are then all-reduced, and the
// root-side stages run on the reduced parents.
//
// Bound: it reads the shard's carries once (nsl x (nx + nv) floats,
// 0.33 MB at BASELINE config 5 over 2 shards) and writes R x (nx + nv)
// floats: 0.1 us at 3.35 TB/s, below what one launch costs (R = 1 parent
// with 4 child slots a shard there; 0.9-1.4 us a call on the H100, PERF.md
// section 6).
//
// Design: one block per parent, the threads over the nx + nv columns,
// each summing its column over the parent's child slots in ascending slot
// order (the index list's order), so a run repeats itself bit for bit and
// no atomics are used.  Layout: carry row-major (nsl, W), out row-major
// (R, W), W = nx + nv; ptr (R + 1) and idx int32, slots numbered within
// the shard.
//
// stream_precision "default" (the entry partial_parents_bf16): the TPU
// kernels compute the block as a product at one bf16 pass (:357-358,
// :875-876), so each child's carry is rounded to bfloat16 (to nearest,
// ties to even) before it is added; the sum stays float32, as the
// all-reduce and the broadcast after it (HIGHEST there, :567-568) do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
partial_parents_kernel(const float* __restrict__ carry,
                       const int* __restrict__ ptr,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int W) {
  const int r = blockIdx.x;
  const int m0 = ptr[r], m1 = ptr[r + 1];
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    float acc = 0.f;
    for (int m = m0; m < m1; ++m) {
      const float c = carry[(size_t)idx[m] * W + k];
      acc += BF16 ? __bfloat162float(__float2bfloat16_rn(c)) : c;
    }
    out[(size_t)r * W + k] = acc;
  }
}

template <bool BF16>
int launch(const float* carry, const int* ptr, const int* idx, float* out,
           int R, int W, void* stream) {
  if (R < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  partial_parents_kernel<BF16><<<R, THREADS, 0, st>>>(carry, ptr, idx, out,
                                                      W);
  return cudaGetLastError();
}

}  // namespace

// Enqueue the kernel on `stream` without synchronising: out (R, W) from
// carry (nsl, W) and the parents' child-slot lists ptr (R + 1) / idx.
// Returns a cudaError_t (0 on success).
extern "C" int partial_parents(const float* carry, const int* ptr,
                               const int* idx, float* out, int R, int W,
                               void* stream) {
  return launch<false>(carry, ptr, idx, out, R, W, stream);
}

// partial_parents with each carry rounded to bfloat16 before it is added
// (stream_precision "default").
extern "C" int partial_parents_bf16(const float* carry, const int* ptr,
                                    const int* idx, float* out, int R, int W,
                                    void* stream) {
  return launch<true>(carry, ptr, idx, out, R, W, stream);
}

extern "C" const char* stream_sharded_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
