// K3, recurrent body: one whole recurrent soup generation in one launch
// (skeleton and design: generation_common.cuh; the forward and the BPTT:
// rnn_common.cuh).
//
// Replaces the recurrent float32 body of the Pallas TPU kernel
// srnn_tpu/ops/pallas_generation.py, generation_popmajor (apply_rows'
// rnn_forward_rows, _chain_for's pallas_rnn_train._sgd_epochs).
//
// What bounds it on an H100: arithmetic.  At the soup's rates (attack 0.1,
// learn 0.1, train 10) about 1.6e10 operations at N = 1M, against about
// 170 MB that the gates make it move (the population in and out, the gates,
// a column for each attacked lane, learner, recomputed target and dead
// lane).
// The BPTT keeps about 200 floats live per thread; ptxas' spill report is
// printed by chip_smoke.py.

#include "generation_common.cuh"
#include "rnn_common.cuh"

namespace {

struct NoConsts {};

template <int W, int D, int A>
struct RnnBody {
  static constexpr int P = srnn::RNN<W, D>::P;
  using Consts = NoConsts;
  __device__ static void apply(const float (&self)[P], const float (&x)[P],
                               float (&out)[P], const Consts&) {
    srnn::rnn_apply<W, D, A, P>(self, x, out);
  }
  __device__ static void learn(float (&rows)[P], const float (&other)[P],
                               int epochs, float lr, const Consts&) {
    srnn::rnn_sgd<W, D, A, false>(rows, other, epochs, lr);
  }
  __device__ static float train(float (&rows)[P], int epochs, float lr,
                                const Consts&) {
    return srnn::rnn_sgd<W, D, A, true>(rows, rows, epochs, lr);
  }
};

}  // namespace

// Pointers as in srnn::GenArgs (device arrays; null disables a phase).
// Only width 2, depth 2 is instantiated.  Returns cudaGetLastError().
extern "C" int srnn_rnn_generation(SRNN_GEN_PARAMS, int width, int depth,
                                   int act_code, void* stream) {
  if (width != 2 || depth != 2 || n <= 0 || severity < 0 || train < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = 2, D = 2;
  const auto g = SRNN_GEN_ARGS;
  SRNN_DISPATCH_ACT(act_code,
      return srnn::launch_generation<RnnBody<W, D, A>>(g, NoConsts{}, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
