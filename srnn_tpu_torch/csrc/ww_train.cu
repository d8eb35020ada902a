// K2: the weightwise batch-1 SGD chain, self-training or imitation.
//
// Replaces the Pallas TPU kernels srnn_tpu/ops/pallas_ww_train.py,
// ww_train_epochs_pallas and ww_learn_epochs_pallas (body _sgd_chain,
// launched through pallas_sgd_common.lane_call).
//
// What bounds it on an H100: arithmetic.  One SGD step on one sample of the
// 4-2-2-1 net is a forward (322/14 = 23 operations), the loss, a hand-derived
// backward and the update of all 14 weights -- about 77 float operations; an
// epoch is 14 such steps, and the soup runs 10 epochs of self-training per
// generation.  At N = 1M that is about 1.1e10 operations against 116 MB read
// and written once.
//
// Design: one thread per particle; weights, sample snapshot and every layer's
// activations in registers for the whole epochs x P chain (the XLA scan the
// JAX package replaced with Pallas paid HBM round trips per step).  For
// self-training the snapshot refreshes from the rows at each epoch top; for
// imitation it is the counterpart's column, fixed.

#include "ww_common.cuh"

namespace {

template <int W, int D, int A, bool REFRESH>
__global__ void __launch_bounds__(srnn::kThreads)
ww_sgd_kernel(const float* __restrict__ wT, const float* __restrict__ otherT,
              float* __restrict__ out, float* __restrict__ loss, long long n,
              int epochs, float lr, srnn::Coords<srnn::WW<W, D>::P> co) {
  constexpr int P = srnn::WW<W, D>::P;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float rows[P];
  float target[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    rows[r] = wT[srnn::lane(r, n, i)];
    target[r] = REFRESH ? 0.0f : otherT[srnn::lane(r, n, i)];
  }
  const float last = srnn::sgd_chain<W, D, A, REFRESH>(rows, target, epochs, lr, co);
#pragma unroll
  for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = rows[r];
  loss[i] = last;
}

}  // namespace

// wT, out: (P, n); otherT: (P, n) imitation targets, or null for
// self-training; loss: (n,).  coords: (P, 3) float32 host array.
extern "C" int srnn_ww_sgd(const float* wT, const float* otherT, float* out,
                           float* loss, long long n, int epochs, float lr,
                           int width, int depth, int act_code,
                           const float* coords, void* stream) {
  if (width != 2 || depth != 2 || n <= 0 || epochs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = 2, D = 2;
  const auto co = srnn::load_coords<srnn::WW<W, D>::P>(coords);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int g = srnn::blocks_for(n);
  if (otherT == nullptr) {
    SRNN_DISPATCH_ACT(act_code,
        ww_sgd_kernel<W, D, A, true><<<g, srnn::kThreads, 0, s>>>(
            wT, otherT, out, loss, n, epochs, lr, co));
  } else {
    SRNN_DISPATCH_ACT(act_code,
        ww_sgd_kernel<W, D, A, false><<<g, srnn::kThreads, 0, s>>>(
            wT, otherT, out, loss, n, epochs, lr, co));
  }
  return static_cast<int>(cudaGetLastError());
}
