// K3, aggregating/fft body: one whole k-vector soup generation in one launch
// (skeleton and design: generation_common.cuh; the reduce, MLP, expand and
// SGD step: kvec_common.cuh).
//
// Replaces the aggregating and fft float32 bodies of the Pallas TPU kernel
// srnn_tpu/ops/pallas_generation.py, generation_popmajor (apply_rows'
// reduce -> MLP -> expand, _chain_for's pallas_kvec_train._sgd_epochs with
// the imitation sample reduced once).
//
// What bounds it on an H100: the FP32 issue rate and the population's
// bytes together.  At the soup's rates (attack 0.1, learn 0.1, train 10)
// the lanes need about 2.5e9 operations at N = 1M (0.074 ms at the
// --fmad=false issue rate) against about 200 MB that the gates make it move
// (0.059 ms at 3.35 TB/s): the population in and out, the gates, a column
// for each attacked lane, learner, recomputed target and dead lane.  The
// gated phases (an attack, an imitation epoch, a recomputed target) would
// run in about 97% of warps with most lanes idle, so the skeleton deals
// the gated lanes first; and because a dealt warp's loads and stores would
// scatter over the block's 128 columns, the body stages the block's
// population tile through shared memory (kStageTile), every thread loading
// and storing its own column.  The reduce's exact finite path and the
// compile-time DFT tables (kvec_common.cuh) cut the training's
// instructions.  Past the default build the lane's rows wait in that tile
// through the gated phases (kParkRows), whose operands are read where they
// are used: held in registers there beside the attacker's and the target's
// rows, they set the whole kernel's registers (the aggregating body at
// width 3 / depth 3: 149, 12 warps an SM; parked, 80 and 24, and 0.294 ->
// 0.240 ms of device time at N = 1M on one H100: PERF.md).

#include "generation_common.cuh"
#include "kvec_common.cuh"

namespace {

template <int W, int D, int K, int A, int R, bool TGT>
struct KvecBody {
  static constexpr int P = srnn::KV<W, D, K>::P;
  static constexpr bool kStageTile = true;
  // past the default build (P = 20), a transform that reads the lane's own
  // rows (TGT) leaves them in the tile through the gated phases
  // (generation_common.cuh, PARK; the fft transform of the attacker's own
  // rows does not hold them there, and parked was 3-5% slower at P = 28)
  static constexpr bool kParkRows = TGT && P > 20;
  struct Consts {};  // the tables are compile-time (kvec_common.cuh)
  // self, x: the rows in registers, or (parked) views that read a row where
  // it is used
  template <class Self, class X>
  __device__ static void apply(const Self& self, const X& x, float (&out)[P],
                               const Consts&) {
    srnn::kvec_apply<W, D, K, A, R, TGT>(self, x, out);
  }
  __device__ static void learn(float (&rows)[P], const float (&other)[P],
                               int epochs, float lr, const Consts&) {
    float snap[K];
    srnn::reduce_rows<W, D, K, R>(other, snap);
    srnn::kvec_sgd<W, D, K, A, R, false>(rows, snap, epochs, lr);
  }
  // learn with the rows parked in the tile column ``col``: the sample is
  // reduced before the rows come into registers
  __device__ static void learn_parked(const srnn::Column<srnn::kThreads>& col,
                                      const float (&other)[P], int epochs,
                                      float lr, const Consts&) {
    float snap[K];
    srnn::reduce_rows<W, D, K, R>(other, snap);
    float rows[P];
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = col[r];
    srnn::kvec_sgd<W, D, K, A, R, false>(rows, snap, epochs, lr);
#pragma unroll
    for (int r = 0; r < P; ++r) col[r] = rows[r];
  }
  __device__ static float train(float (&rows)[P], int epochs, float lr,
                                const Consts&) {
    const float none[K] = {};
    return srnn::kvec_sgd<W, D, K, A, R, true>(rows, none, epochs, lr);
  }
};

template <int W, int D, int K, int A, int R, class Pop>
int launch(const srnn::GenArgs<Pop>& g, bool src_target, void* stream) {
  if constexpr (R == srnn::DFT || R == srnn::RDFT) {
    if (!src_target)
      return srnn::launch_generation<KvecBody<W, D, K, A, R, false>>(g, {}, stream);
  }
  return srnn::launch_generation<KvecBody<W, D, K, A, R, true>>(g, {}, stream);
}

}  // namespace

// Pointers as in srnn::GenArgs<Pop> (device arrays; null disables a phase;
// Pop is float here, __nv_bfloat16 in the _bf16 entry);
// tables: the float32 host array of ops/cuda_kvec_train.py, kvec_tables,
// which must equal the kernel's compile-time table (srnn::tables_match); it
// also says whether the fft transform reads the target.  Instantiated for
// the build's width, depth and aggregates (SRNN_W, SRNN_D, SRNN_K:
// lane_common.cuh).  Returns cudaGetLastError().
extern "C" int SRNN_GEN_ENTRY(srnn_kvec_generation)(
    SRNN_GEN_PARAMS(SRNN_GEN_POP), int width, int depth, int aggregates,
    int act_code, int reduce_code, const float* tables, void* stream) {
  constexpr int W = SRNN_W, D = SRNN_D, K = SRNN_K, P = srnn::KV<W, D, K>::P;
  if (width != W || depth != D || aggregates != K || n <= 0 ||
      severity < 0 || train < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto g = SRNN_GEN_ARGS(SRNN_GEN_POP);
  const bool src_target = srnn::tables_src_target<P, K>(tables);
  SRNN_DISPATCH_REDUCE(reduce_code,
      if (!srnn::tables_match<P, K, R>(tables))
        return static_cast<int>(cudaErrorInvalidValue);
      SRNN_DISPATCH_ACT(act_code,
          return launch<W, D, K, A, R>(g, src_target, stream)));
  return static_cast<int>(cudaErrorInvalidValue);
}
