// K3, aggregating/fft body: one whole k-vector soup generation in one launch
// (skeleton and design: generation_common.cuh; the reduce, MLP, expand and
// SGD step: kvec_common.cuh).
//
// Replaces the aggregating and fft float32 bodies of the Pallas TPU kernel
// srnn_tpu/ops/pallas_generation.py, generation_popmajor (apply_rows'
// reduce -> MLP -> expand, _chain_for's pallas_kvec_train._sgd_epochs with
// the imitation sample reduced once).
//
// What bounds it on an H100: at the soup's rates (attack 0.1, learn 0.1,
// train 10) about 2.5e9 operations at N = 1M against about 200 MB that the
// gates make it move (the population in and out, the gates, a column for
// each attacked lane, learner, recomputed target and dead lane): memory,
// with the arithmetic at about 60% of it.

#include "generation_common.cuh"
#include "kvec_common.cuh"

namespace {

template <int W, int D, int K, int A, int R>
struct KvecBody {
  static constexpr int P = srnn::KV<W, D, K>::P;
  using Consts = srnn::KvecTables<P, K>;
  __device__ static void apply(const float (&self)[P], const float (&x)[P],
                               float (&out)[P], const Consts& tb) {
    srnn::kvec_apply<W, D, K, A, R>(self, x, out, tb);
  }
  __device__ static void learn(float (&rows)[P], const float (&other)[P],
                               int epochs, float lr, const Consts& tb) {
    float snap[K];
    srnn::reduce_rows<W, D, K, R>(other, snap, tb);
    srnn::kvec_sgd<W, D, K, A, R, false>(rows, snap, epochs, lr, tb);
  }
  __device__ static float train(float (&rows)[P], int epochs, float lr,
                                const Consts& tb) {
    const float none[K] = {};
    return srnn::kvec_sgd<W, D, K, A, R, true>(rows, none, epochs, lr, tb);
  }
};

}  // namespace

// Pointers as in srnn::GenArgs<Pop> (device arrays; null disables a phase;
// Pop is float here, __nv_bfloat16 in the _bf16 entry);
// tables: the float32 host array of ops/cuda_kvec_train.py, kvec_tables.
// Only width 2, depth 2, aggregates 4 is instantiated.  Returns
// cudaGetLastError().
extern "C" int SRNN_GEN_ENTRY(srnn_kvec_generation)(
    SRNN_GEN_PARAMS(SRNN_GEN_POP), int width, int depth, int aggregates,
    int act_code, int reduce_code, const float* tables, void* stream) {
  if (width != 2 || depth != 2 || aggregates != 4 || n <= 0 ||
      severity < 0 || train < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = 2, D = 2, K = 4;
  const auto g = SRNN_GEN_ARGS(SRNN_GEN_POP);
  const auto tb = srnn::load_tables<srnn::KV<W, D, K>::P, K>(tables);
  SRNN_DISPATCH_ACT(act_code, SRNN_DISPATCH_REDUCE(reduce_code,
      return srnn::launch_generation<KvecBody<W, D, K, A, R>>(g, tb, stream)));
  return static_cast<int>(cudaErrorInvalidValue);
}
