// K1: chained weightwise self-application of a whole population.
//
// Replaces the Pallas TPU kernel srnn_tpu/ops/pallas_ww.py,
// ww_apply_population (body _ww_kernel).
//
// What bounds it on an H100: the FP32 pipe.  One application of the 4-2-2-1
// net rewrites all P = 14 weights; the reference computes each through 14
// multiplies and 9 adds (322 float operations per particle).  The particle's
// weights are read once and written once per call whatever ``steps`` is, so
// at N = 1M and steps = 2000 the call moves 112 MB against the reference's
// 6.4e11 operations.  Built with --fmad=false (no multiply-add
// contraction, so the kernel rounds like the plain torch version), each
// multiply and each add is one instruction.
//
// Design: one thread per particle, the 14 weights in registers, the whole
// chain of ``steps`` applications in registers, one coalesced read and one
// coalesced write per weight row; no shared memory, no synchronisation.
// An application issues 250 FP32 instructions, not 322 (ww_common.cuh):
// layer 0's coordinate products are compile-time constants times weights,
// taken once per application (12 multiplies) where the reference takes
// them at every point (84), and products with a coordinate of 1.0 are the
// weight itself.  The two weight arrays swap roles from one step to the
// next (the loop runs two steps a trip), so no step copies its result back.

#include "ww_common.cuh"

namespace {

template <int W, int D, int A>
__global__ void __launch_bounds__(srnn::kThreads)
ww_apply_kernel(const float* __restrict__ wT, float* __restrict__ out,
                long long n, int steps) {
  constexpr int P = srnn::WW<W, D>::P;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float w[P], nw[P];
#pragma unroll
  for (int r = 0; r < P; ++r) w[r] = wT[srnn::lane(r, n, i)];
  int t = 0;
#pragma unroll 1
  for (; t + 1 < steps; t += 2) {
    srnn::apply_rows<W, D, A>(w, w, nw);
    srnn::apply_rows<W, D, A>(nw, nw, w);
  }
  if (t < steps) {
    srnn::apply_rows<W, D, A>(w, w, nw);
#pragma unroll
    for (int r = 0; r < P; ++r) w[r] = nw[r];
  }
#pragma unroll
  for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = w[r];
}

}  // namespace

// wT, out: (P, n) float32 device arrays; coords: (P, 3) float32 host array,
// which must equal the kernel's compile-time table (srnn::coords_match).
// Launches on ``stream`` and returns cudaGetLastError().
extern "C" int srnn_ww_apply(const float* wT, float* out, long long n,
                             int steps, int width, int depth, int act_code,
                             const float* coords, void* stream) {
  constexpr int W = SRNN_W, D = SRNN_D;
  if (width != W || depth != D || n <= 0 || steps < 0 ||
      !srnn::coords_match<W, D>(coords))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  SRNN_DISPATCH_ACT(act_code,
      ww_apply_kernel<W, D, A><<<srnn::blocks_for(n), srnn::kThreads, 0, s>>>(
          wT, out, n, steps));
  return static_cast<int>(cudaGetLastError());
}
