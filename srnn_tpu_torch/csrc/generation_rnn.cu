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
// lane, learner, recomputed target and dead lane).  At width 3 / depth 3
// (P = 52) about 1.5e11 operations (2.30 ms).
//
// Design: K5's (rnn_train.cu), both of its paths: the register path at the
// default width 2 / depth 2 (every array in registers, no stack frame), the
// checkpointed one for the builds whose BPTT sequence does not fit in
// registers (at width 3 / depth 3 the register path spilled 12,104 bytes
// and ran 13.7x its bound): the sample of the learn and train phases --
// the recomputed imitation target, then the rows at each epoch top -- and
// the checkpoints in the thread's column of dynamic shared memory
// (rnn_common.cuh).  The attack runs the stack time-major and stores
// nothing but its output.  The gated phases run on about one warp in
// four, once a generation, so on the checkpointed path their code is kept
// short, because a gated warp runs it from a cold instruction cache: the
// attack runs in place on the column, one step a loop trip
// (rnn_apply_column; unrolled over T = 52 its two call sites were about
// 5,000 instructions each, and the gated phases cost 4.8 of the body's
// 12.4 ms against 7.6 train only), and a learner's imitation epochs run
// in the self-training chain's code (kStagedLearn), so that the epoch is
// compiled once (PERF.md).  The gated phases (attack, learn) are per lane,
// and a warp carrying any gated lane runs them with the rest idle, which
// cost a quarter of the kernel; so the skeleton deals the learners and
// attacked lanes to the block's first threads, which cut the kernel by a
// tenth (generation_common.cuh, PERF.md).

#include "generation_common.cuh"
#include "rnn_common.cuh"

namespace {

struct NoConsts {};

template <int W, int D, int A>
struct RnnBody {
  static constexpr int P = srnn::RNN<W, D>::P;
  static constexpr int kColumnFloats = srnn::Checkpoints<W, D>::kColumnFloats;
  static constexpr bool kStagedLearn = srnn::Checkpoints<W, D>::kCheckpointed;
  using Consts = NoConsts;
  __device__ __forceinline__ static void apply(const float (&self)[P],
                                               const float (&x)[P],
                                               float (&out)[P], const Consts&) {
    if constexpr (srnn::Checkpoints<W, D>::kCheckpointed) {
      const auto col = srnn::thread_column();
#pragma unroll
      for (int r = 0; r < P; ++r) col[r] = x[r];
      srnn::rnn_apply_column<W, D, A>(self, col);
#pragma unroll
      for (int r = 0; r < P; ++r) out[r] = col[r];
    } else {
      srnn::rnn_apply_streamed<W, D, A, P>(self, x, out);
    }
  }
  __device__ __forceinline__ static void learn(float (&rows)[P],
                                               const float (&other)[P],
                                               int epochs, float lr,
                                               const Consts&) {
    srnn::rnn_sgd<W, D, A, false>(rows, other, epochs, lr, srnn::thread_column());
  }
  __device__ __forceinline__ static float train(float (&rows)[P],
                                                int epochs, float lr,
                                                const Consts&) {
    return srnn::rnn_sgd<W, D, A, true>(rows, rows, epochs, lr, srnn::thread_column());
  }
  // the checkpointed path (kStagedLearn): the learner's target into the
  // column, then its imitation and self-training epochs as one chain
  __device__ __forceinline__ static void stage(const float (&other)[P], const Consts&) {
    const auto col = srnn::thread_column();
#pragma unroll
    for (int r = 0; r < P; ++r) col[r] = other[r];
  }
  __device__ __forceinline__ static float train(float (&rows)[P], int learned,
                                                int epochs, float lr,
                                                const Consts&) {
    const float loss = srnn::rnn_sgd_checkpointed<W, D, A>(rows, learned, epochs, lr,
                                                           srnn::thread_column());
    return epochs > 0 ? loss : 0.0f;
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

// Floats of dynamic shared memory a thread of this build's kernel takes
// (rnn_common.cuh: Checkpoints; 0 on the register path), for the
// residency reports.
extern "C" int SRNN_GEN_ENTRY(srnn_rnn_column_floats)() {
  return srnn::Checkpoints<SRNN_W, SRNN_D>::kColumnFloats;
}
