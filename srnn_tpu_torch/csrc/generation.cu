// K3, weightwise body: one whole weightwise soup generation in one launch
// (skeleton and design: generation_common.cuh).
//
// Replaces the weightwise float32 body of the Pallas TPU kernel
// srnn_tpu/ops/pallas_generation.py, generation_popmajor.
//
// What bounds it on an H100: the FP32 pipe.  Every particle runs ``train``
// epochs of the 14-sample SGD chain (1,079 operations an epoch in the
// reference's count), the learners add ``severity`` epochs more, and the
// attacked lanes and recomputed targets one application (322).  At N = 1M,
// train = 10, severity = 1 and rates 0.1 that is about 1.1e10 operations
// against about 145 MB that the gates make it move (the population in and
// out, the gates, a column for each attacked lane, learner, recomputed
// target and dead lane).  Built with --fmad=false, each operation is one
// instruction.
//
// Design: the arithmetic is ww_common.cuh's, with the coordinates as
// compile-time constants (an application issues 250 instructions, an epoch
// 52 fewer than the reference's count), and the skeleton deals a block's
// learners and attacked lanes to its first threads, so that the attack and imitation run in about one
// warp of the four instead of in nearly every warp with most lanes idle.
// Neither changes a rounded operation, so the results are the same bitwise.
// ptxas' report for this kernel is printed by chip_smoke.py (the build log).
//
// The builds whose unrolled epoch passes Epoch::kUnrolledMax operations
// (width 3 / depth 3) run the rolled forms of ww_common.cuh.  Unrolled, the
// gated phases cost 58% of the kernel at P = 33 (6.71 ms against 2.77 train
// only): the attack's two inlined applications and a second copy of the
// epoch, about 20,000 instructions that the gated warp ran once, from a
// cold instruction cache, while the block held its slot.  Rolled, the
// operand of each attack is staged in the thread's column of shared memory
// and transformed there by one call site of a one-point loop (the
// skeleton's kOneAttackSite), and a learner's imitation epochs run in the
// self-training chain's code (kStagedLearn), its target staged in the same
// column; the epoch itself is the rolled one that K2 runs (PERF.md).

#include "generation_common.cuh"
#include "ww_common.cuh"

namespace {

// No runtime constants: the coordinates are compile-time (ww_common.cuh).
struct NoConsts {};

template <int W, int D, int A>
struct WwBody {
  static constexpr int P = srnn::WW<W, D>::P;
  using Consts = NoConsts;
  // the rolled builds (ww_common.cuh, Epoch): the operand of the attack and
  // the learner's target staged in the thread's column, one attack call
  // site, one epoch chain, the coordinates in the block's table
  static constexpr bool kRolled = srnn::Epoch<W, D>::kRolled;
  static constexpr int kColumnFloats = kRolled ? P : 0;
  static constexpr bool kStagedLearn = kRolled;
  static constexpr bool kOneAttackSite = kRolled;
  static constexpr bool kBlockSetup = kRolled;
  __device__ static void apply(const float (&self)[P], const float (&x)[P],
                               float (&out)[P], const Consts&) {
    srnn::apply_rows<W, D, A>(self, x, out);
  }
  __device__ static void learn(float (&rows)[P], const float (&other)[P],
                               int epochs, float lr, const Consts&) {
    srnn::sgd_chain<W, D, A, false>(rows, other, epochs, lr);
  }
  __device__ static float train(float (&rows)[P], int epochs, float lr,
                                const Consts&) {
    return srnn::sgd_chain<W, D, A, true>(rows, rows, epochs, lr);
  }

  // The rolled builds' members (generation_common.cuh: kBlockSetup,
  // kStagedLearn, kOneAttackSite).
  __device__ __forceinline__ static srnn::SampleCoords* coords() {
    __shared__ srnn::SampleCoords table[P];
    return table;
  }
  __device__ __forceinline__ static void setup_block(const Consts&) {
    for (int s = threadIdx.x; s < P; s += blockDim.x) coords()[s] = srnn::sample_coords<W, D>(s);
  }
  __device__ __forceinline__ static void stage(const float (&x)[P], const Consts&) {
    const auto col = srnn::thread_column();
#pragma unroll
    for (int r = 0; r < P; ++r) col[r] = x[r];
  }
  __device__ __forceinline__ static void unstage(float (&x)[P], const Consts&) {
    const auto col = srnn::thread_column();
#pragma unroll
    for (int r = 0; r < P; ++r) x[r] = col[r];
  }
  __device__ __forceinline__ static void apply_staged(const float (&self)[P], const Consts&) {
    srnn::apply_column<W, D, A>(self, srnn::thread_column(), coords());
  }
  __device__ __forceinline__ static float train(float (&rows)[P], int learned,
                                                int epochs, float lr, const Consts&) {
    return srnn::learn_then_train<W, D, A>(rows, learned, epochs, lr,
                                           srnn::thread_column(), coords());
  }
};

}  // namespace

// Pointers as in srnn::GenArgs<Pop> (device arrays; null disables a phase;
// Pop is float here, __nv_bfloat16 in the _bf16 entry);
// coords: (P, 3) float32 host array, which must equal the kernel's
// compile-time table (srnn::coords_match).  Returns cudaGetLastError().
extern "C" int SRNN_GEN_ENTRY(srnn_ww_generation)(
    SRNN_GEN_PARAMS(SRNN_GEN_POP), int width, int depth, int act_code,
    const float* coords, void* stream) {
  constexpr int W = SRNN_W, D = SRNN_D;
  if (width != W || depth != D || n <= 0 || severity < 0 || train < 0 ||
      !srnn::coords_match<W, D>(coords))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto g = SRNN_GEN_ARGS(SRNN_GEN_POP);
  SRNN_DISPATCH_ACT(act_code,
      return srnn::launch_generation<WwBody<W, D, A>>(g, NoConsts{}, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Floats of dynamic shared memory a thread of this build's kernel takes
// (its column: P on the rolled builds, else 0), for the residency reports.
extern "C" int SRNN_GEN_ENTRY(srnn_ww_column_floats)() {
  return WwBody<SRNN_W, SRNN_D, srnn::LINEAR>::kColumnFloats;
}
