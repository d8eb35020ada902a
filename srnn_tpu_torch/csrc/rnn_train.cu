// K5: the recurrent variant's SGD chain (BPTT), self-training or imitation.
//
// Replaces the Pallas TPU kernels srnn_tpu/ops/pallas_rnn_train.py,
// rnn_train_epochs_pallas and rnn_learn_epochs_pallas (bodies
// rnn_forward_rows, _bptt_epoch and _sgd_epochs, launched through
// pallas_sgd_common.lane_call).
//
// What bounds it on an H100: arithmetic.  One epoch of the 17-weight
// 1-2-2-1 stack over its own 17-step sequence is a forward (493
// operations), the loss and its gradient (68), the BPTT (1,002) and the
// update (34): 1,597 operations; the soup's self-training runs 10 epochs.
// At N = 1M that is 1.6e10 operations: 0.24 ms at the data sheet's FP32
// rate, which counts an FMA as two operations, and 0.48 ms at the rate at
// which the card issues the separate multiplies and adds of a build with
// --fmad=false; against 140 MB read and written once (0.04 ms at
// 3.35 TB/s).  At width 3 / depth 3 (P = 52) an epoch is 15,180 operations
// (2.27 ms at N = 1M, train 10), of which the forward is 4,888.
//
// Design: one thread per particle, one coalesced read and one write per
// weight row; the weights, the gradients and the carries in registers for
// the whole chain, the layers walked by template recursion, the backward
// one reverse-time sweep over all layers (rnn_common.cuh).  Two paths, by
// the build's topology (rnn_common.cuh: Checkpoints):
//   - the register path keeps the sample and every layer's output
//     sequence in registers too: 148 registers and no stack frame at the
//     default width 2 / depth 2, 12 resident warps per SM;
//   - the checkpointed path, for the builds whose sequence does not fit in
//     registers (at width 3 / depth 3 it spilled 7,860 bytes from 255
//     registers and ran 16.6x its bound): the sample and a checkpoint of
//     the state every C steps in the thread's column of the block's
//     dynamic shared memory, each segment's outputs recomputed into
//     registers in the reverse sweep -- one more forward an epoch, no
//     spills.

#include "rnn_common.cuh"

namespace {

template <int W, int D, int A, bool REFRESH>
__global__ void __launch_bounds__(srnn::kThreads)
rnn_sgd_kernel(const float* __restrict__ wT, const float* __restrict__ otherT,
               float* __restrict__ out, float* __restrict__ loss, long long n,
               int epochs, float lr) {
  constexpr int P = srnn::RNN<W, D>::P;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float rows[P], target[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    rows[r] = wT[srnn::lane(r, n, i)];
    target[r] = REFRESH ? 0.0f : otherT[srnn::lane(r, n, i)];
  }
  const float last =
      srnn::rnn_sgd<W, D, A, REFRESH>(rows, target, epochs, lr, srnn::thread_column());
#pragma unroll
  for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = rows[r];
  loss[i] = last;
}

// One launch, with the checkpointed path's columns of dynamic shared
// memory (none on the register path).
template <int W, int D, int A, bool REFRESH>
int launch(const float* wT, const float* otherT, float* out, float* loss,
           long long n, int epochs, float lr, void* stream) {
  constexpr int smem =
      srnn::Checkpoints<W, D>::kColumnFloats * srnn::kThreads * static_cast<int>(sizeof(float));
  const auto kernel = rnn_sgd_kernel<W, D, A, REFRESH>;
  const cudaError_t set = srnn::allow_dynamic_shared(kernel, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<srnn::blocks_for(n), srnn::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      wT, otherT, out, loss, n, epochs, lr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wT, out: (P, n); otherT: (P, n) imitation targets, or null for
// self-training; loss: (n,).  Instantiated for the build's width and depth
// (SRNN_W, SRNN_D: lane_common.cuh).
extern "C" int srnn_rnn_sgd(const float* wT, const float* otherT, float* out,
                            float* loss, long long n, int epochs, float lr,
                            int width, int depth, int act_code, void* stream) {
  constexpr int W = SRNN_W, D = SRNN_D;
  if (width != W || depth != D || n <= 0 || epochs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SRNN_DISPATCH_ACT(act_code,
      return otherT == nullptr
                 ? launch<W, D, A, true>(wT, otherT, out, loss, n, epochs, lr, stream)
                 : launch<W, D, A, false>(wT, otherT, out, loss, n, epochs, lr, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Floats of dynamic shared memory a thread of this build's kernels takes
// (rnn_common.cuh: Checkpoints; 0 on the register path), for the
// residency reports.
extern "C" int srnn_rnn_column_floats() {
  return srnn::Checkpoints<SRNN_W, SRNN_D>::kColumnFloats;
}
