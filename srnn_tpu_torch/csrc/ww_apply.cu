// K1: chained weightwise self-application of a whole population.
//
// Replaces the Pallas TPU kernel srnn_tpu/ops/pallas_ww.py,
// ww_apply_population (body _ww_kernel).
//
// What bounds it on an H100: arithmetic.  One application of the 4-2-2-1
// net rewrites all P = 14 weights, each through 14 multiplies and 9 adds
// (322 float operations per particle); the particle's weights are read once
// and written once per call whatever ``steps`` is, so at N = 1M and
// steps = 2000 the call moves 112 MB but does 6.4e11 operations.  Built
// with --fmad=false (no multiply-add contraction, so the kernel rounds like
// the plain torch version), each operation is one FP32 instruction.
//
// Design: one thread per particle, the 14 weights in registers, the whole
// chain of ``steps`` applications in registers, one coalesced read and one
// coalesced write per weight row.  No shared memory, no synchronisation.

#include "ww_common.cuh"

namespace {

template <int W, int D, int A>
__global__ void __launch_bounds__(srnn::kThreads)
ww_apply_kernel(const float* __restrict__ wT, float* __restrict__ out,
                long long n, int steps, srnn::Coords<srnn::WW<W, D>::P> co) {
  constexpr int P = srnn::WW<W, D>::P;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float w[P];
#pragma unroll
  for (int r = 0; r < P; ++r) w[r] = wT[srnn::lane(r, n, i)];
  for (int t = 0; t < steps; ++t) {
    float nw[P];
    srnn::apply_rows<W, D, A>(w, w, nw, co);
#pragma unroll
    for (int r = 0; r < P; ++r) w[r] = nw[r];
  }
#pragma unroll
  for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = w[r];
}

}  // namespace

// wT, out: (P, n) float32 device arrays; coords: (P, 3) float32 host array.
// Launches on ``stream`` and returns cudaGetLastError().
extern "C" int srnn_ww_apply(const float* wT, float* out, long long n,
                             int steps, int width, int depth, int act_code,
                             const float* coords, void* stream) {
  if (width != 2 || depth != 2 || n <= 0 || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = 2, D = 2;
  const auto co = srnn::load_coords<srnn::WW<W, D>::P>(coords);
  const auto s = static_cast<cudaStream_t>(stream);
  SRNN_DISPATCH_ACT(act_code,
      ww_apply_kernel<W, D, A><<<srnn::blocks_for(n), srnn::kThreads, 0, s>>>(
          wT, out, n, steps, co));
  return static_cast<int>(cudaGetLastError());
}
