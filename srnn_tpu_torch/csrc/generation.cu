// K3, weightwise body: one whole weightwise soup generation in one launch
// (skeleton and design: generation_common.cuh).
//
// Replaces the weightwise float32 body of the Pallas TPU kernel
// srnn_tpu/ops/pallas_generation.py, generation_popmajor.
//
// What bounds it on an H100: arithmetic.  Every particle runs ``train``
// epochs of the 14-sample SGD chain (about 1.1e3 operations an epoch), the
// learners add ``severity`` epochs more, and the attacked lanes one
// application (322 operations).  At N = 1M, train = 10, severity = 1 and
// rates 0.1 that is about 1.1e10 operations against about 145 MB that the
// gates make it move (the population in and out, the gates, a column for
// each attacked lane, learner, recomputed target and dead lane).  ptxas'
// register report for this kernel is printed by chip_smoke.py (the build
// log); a spill costs local memory traffic and is written down in PERF.md.

#include "generation_common.cuh"
#include "ww_common.cuh"

namespace {

template <int W, int D, int A>
struct WwBody {
  static constexpr int P = srnn::WW<W, D>::P;
  using Consts = srnn::Coords<P>;
  __device__ static void apply(const float (&self)[P], const float (&x)[P],
                               float (&out)[P], const Consts& co) {
    srnn::apply_rows<W, D, A>(self, x, out, co);
  }
  __device__ static void learn(float (&rows)[P], const float (&other)[P],
                               int epochs, float lr, const Consts& co) {
    srnn::sgd_chain<W, D, A, false>(rows, other, epochs, lr, co);
  }
  __device__ static float train(float (&rows)[P], int epochs, float lr,
                                const Consts& co) {
    return srnn::sgd_chain<W, D, A, true>(rows, rows, epochs, lr, co);
  }
};

}  // namespace

// Pointers as in srnn::GenArgs<Pop> (device arrays; null disables a phase;
// Pop is float here, __nv_bfloat16 in the _bf16 entry);
// coords: (P, 3) float32 host array.  Returns cudaGetLastError().
extern "C" int SRNN_GEN_ENTRY(srnn_ww_generation)(
    SRNN_GEN_PARAMS(SRNN_GEN_POP), int width, int depth, int act_code,
    const float* coords, void* stream) {
  if (width != 2 || depth != 2 || n <= 0 || severity < 0 || train < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = 2, D = 2;
  const auto g = SRNN_GEN_ARGS(SRNN_GEN_POP);
  const auto co = srnn::load_coords<srnn::WW<W, D>::P>(coords);
  SRNN_DISPATCH_ACT(act_code,
      return srnn::launch_generation<WwBody<W, D, A>>(g, co, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
