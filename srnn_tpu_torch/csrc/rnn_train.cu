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
// 3.35 TB/s).
//
// Design: one thread per particle; the weights, the sample, the gradients,
// every layer's output sequence and the carries in registers for the
// whole chain (148 registers, no stack frame), one coalesced read and one
// write per weight row; the layers walked by template recursion, so that
// no array falls to local memory, and the backward one reverse-time sweep
// over all layers (rnn_common.cuh: bptt_epoch).

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
  const float last = srnn::rnn_sgd<W, D, A, REFRESH>(rows, target, epochs, lr);
#pragma unroll
  for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = rows[r];
  loss[i] = last;
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
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int g = srnn::blocks_for(n);
  if (otherT == nullptr) {
    SRNN_DISPATCH_ACT(act_code,
        rnn_sgd_kernel<W, D, A, true><<<g, srnn::kThreads, 0, s>>>(
            wT, otherT, out, loss, n, epochs, lr));
  } else {
    SRNN_DISPATCH_ACT(act_code,
        rnn_sgd_kernel<W, D, A, false><<<g, srnn::kThreads, 0, s>>>(
            wT, otherT, out, loss, n, epochs, lr));
  }
  return static_cast<int>(cudaGetLastError());
}
