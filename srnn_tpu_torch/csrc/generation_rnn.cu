// K3, recurrent body: one whole recurrent soup generation in one launch
// (skeleton and design: generation_common.cuh; the forward and the BPTT:
// rnn_common.cuh).
//
// Replaces the recurrent float32 body of the Pallas TPU kernel
// srnn_tpu/ops/pallas_generation.py, generation_popmajor (apply_rows'
// rnn_forward_rows, _chain_for's pallas_rnn_train._sgd_epochs).
//
// What bounds it on an H100: arithmetic.  At the soup's rates (attack 0.1,
// learn 0.1, train 10) about 1.6e10 operations at N = 1M (0.24 ms at the
// data sheet's FP32 rate, 0.48 ms at the issue rate of separate multiplies
// and adds under --fmad=false), against about 170 MB that the gates make it
// move (the population in and out, the gates, a column for each attacked
// lane, learner, recomputed target and dead lane).
//
// Design: K5's (rnn_train.cu): every array in registers with the layers
// walked by template recursion (no stack frame), the BPTT's backward one
// reverse-time sweep over all layers; the attack runs the stack time-major
// and stores nothing but its output.  The gated phases (attack, learn) are
// per lane, and a warp carrying any gated lane runs them with the rest
// idle, which cost a quarter of the kernel; so the skeleton deals the
// learners and attacked lanes to the block's first threads, which cut the
// kernel by a tenth
// (generation_common.cuh, PERF.md).

#include "generation_common.cuh"
#include "rnn_common.cuh"

namespace {

struct NoConsts {};

template <int W, int D, int A>
struct RnnBody {
  static constexpr int P = srnn::RNN<W, D>::P;
  using Consts = NoConsts;
  __device__ __forceinline__ static void apply(const float (&self)[P],
                                               const float (&x)[P],
                                               float (&out)[P], const Consts&) {
    srnn::rnn_apply_streamed<W, D, A, P>(self, x, out);
  }
  __device__ __forceinline__ static void learn(float (&rows)[P],
                                               const float (&other)[P],
                                               int epochs, float lr,
                                               const Consts&) {
    srnn::rnn_sgd<W, D, A, false>(rows, other, epochs, lr);
  }
  __device__ __forceinline__ static float train(float (&rows)[P],
                                                int epochs, float lr,
                                                const Consts&) {
    return srnn::rnn_sgd<W, D, A, true>(rows, rows, epochs, lr);
  }
};

}  // namespace

// Pointers as in srnn::GenArgs<Pop> (device arrays; null disables a phase;
// Pop is float here, __nv_bfloat16 in the _bf16 entry).
// Instantiated for the build's width and depth (SRNN_W, SRNN_D:
// lane_common.cuh).  Returns cudaGetLastError().
extern "C" int SRNN_GEN_ENTRY(srnn_rnn_generation)(
    SRNN_GEN_PARAMS(SRNN_GEN_POP), int width, int depth, int act_code,
    void* stream) {
  constexpr int W = SRNN_W, D = SRNN_D;
  if (width != W || depth != D || n <= 0 || severity < 0 || train < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto g = SRNN_GEN_ARGS(SRNN_GEN_POP);
  SRNN_DISPATCH_ACT(act_code,
      return srnn::launch_generation<RnnBody<W, D, A>>(g, NoConsts{}, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
