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
// imitation it is the counterpart's column, fixed.  The coordinate features
// are compile-time constants (ww_common.cuh), so the forward's and the
// layer-0 gradients' products with a coordinate of 1.0 are not issued: 52
// of the reference's 1,079 operations an epoch.
//
// The shuffled instantiation (srnn_ww_sgd_shuffled: keras' per-epoch sample
// shuffle, engine.run_training(shuffle_key=) of the JAX package) takes a
// per-lane order, uint8 (epochs, P, n), and trains step j of epoch e on
// sample order[e, j, lane].  Its sample index is known only at run time, so
// the snapshot sits in a shared-memory column per thread and the coordinate
// table in shared memory (ww_common.cuh, sgd_chain_shuffled), and an
// epoch's P order bytes are loaded at its top; every coordinate product is
// issued, the products with 1.0 too, plus one snapshot and three coordinate
// loads a step.  The unshuffled instantiations are untouched by it.
//
// The builds whose unrolled epoch passes Epoch::kUnrolledMax operations
// (width 3 / depth 3: 6,337, against the default build's 1,079) run the
// rolled epoch instead (ww_common.cuh, sgd_chain_rolled): the unrolled one
// was some 7,000 instructions a thread streamed ten times a launch at 96-122
// registers, and ran at 69% of its issue ceiling where the default build
// runs at 98% (PERF.md).  A loop over the samples, a cell's W of them a
// trip: each sample's weight feature from the thread's column of shared
// memory (the snapshot, or the imitation target), its coordinates from the
// block's table, each layer's update applied once its backward has read
// the rows.  Bitwise the same.

#include "ww_common.cuh"

namespace {

template <int W, int D, int A, bool REFRESH>
__global__ void __launch_bounds__(srnn::kThreads)
ww_sgd_kernel(const float* __restrict__ wT, const float* __restrict__ otherT,
              float* __restrict__ out, float* __restrict__ loss, long long n,
              int epochs, float lr) {
  constexpr int P = srnn::WW<W, D>::P;
  if constexpr (srnn::Epoch<W, D>::kRolled) {
    // the rolled epoch (ww_common.cuh): the sample in the thread's column,
    // the coordinates in the block's table
    __shared__ srnn::SampleCoords coords[P];
    __shared__ float column[P * srnn::kThreads];
    for (int s = threadIdx.x; s < P; s += blockDim.x) coords[s] = srnn::sample_coords<W, D>(s);
    __syncthreads();
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const srnn::Column<srnn::kThreads> col{&column[threadIdx.x]};
    float rows[P];
#pragma unroll
    for (int r = 0; r < P; ++r) {
      rows[r] = wT[srnn::lane(r, n, i)];
      if (!REFRESH) col[r] = otherT[srnn::lane(r, n, i)];
    }
    const float last = srnn::sgd_chain_rolled<W, D, A, W>(
        rows, REFRESH ? 0 : epochs, REFRESH ? epochs : 0, lr, col, coords);
#pragma unroll
    for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = rows[r];
    loss[i] = last;
  } else {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float rows[P];
    float target[P];
#pragma unroll
    for (int r = 0; r < P; ++r) {
      rows[r] = wT[srnn::lane(r, n, i)];
      target[r] = REFRESH ? 0.0f : otherT[srnn::lane(r, n, i)];
    }
    const float last = srnn::sgd_chain<W, D, A, REFRESH>(rows, target, epochs, lr);
#pragma unroll
    for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = rows[r];
    loss[i] = last;
  }
}

template <int W, int D, int A, bool REFRESH>
__global__ void __launch_bounds__(srnn::kThreads)
ww_sgd_shuffled_kernel(const float* __restrict__ wT,
                       const float* __restrict__ otherT,
                       const unsigned char* __restrict__ order,
                       float* __restrict__ out, float* __restrict__ loss,
                       long long n, int epochs, float lr) {
  constexpr int P = srnn::WW<W, D>::P;
  __shared__ float coords[3 * P];
  __shared__ float snap[P * srnn::kThreads];
  for (int t = threadIdx.x; t < 3 * P; t += blockDim.x)
    coords[t] = srnn::WW<W, D>::coord(t / 3, t % 3);
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float rows[P];
  float target[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    rows[r] = wT[srnn::lane(r, n, i)];
    target[r] = REFRESH ? 0.0f : otherT[srnn::lane(r, n, i)];
  }
  const float last = srnn::sgd_chain_shuffled<W, D, A, REFRESH>(
      rows, target, &snap[threadIdx.x], srnn::kThreads, order + i, n, coords,
      epochs, lr);
#pragma unroll
  for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = rows[r];
  loss[i] = last;
}

}  // namespace

// wT, out: (P, n); otherT: (P, n) imitation targets, or null for
// self-training; loss: (n,).  coords: (P, 3) float32 host array, which must
// equal the kernel's compile-time table (srnn::coords_match).
extern "C" int srnn_ww_sgd(const float* wT, const float* otherT, float* out,
                           float* loss, long long n, int epochs, float lr,
                           int width, int depth, int act_code,
                           const float* coords, void* stream) {
  constexpr int W = SRNN_W, D = SRNN_D;
  if (width != W || depth != D || n <= 0 || epochs < 0 ||
      !srnn::coords_match<W, D>(coords))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int g = srnn::blocks_for(n);
  if (otherT == nullptr) {
    SRNN_DISPATCH_ACT(act_code,
        ww_sgd_kernel<W, D, A, true><<<g, srnn::kThreads, 0, s>>>(
            wT, otherT, out, loss, n, epochs, lr));
  } else {
    SRNN_DISPATCH_ACT(act_code,
        ww_sgd_kernel<W, D, A, false><<<g, srnn::kThreads, 0, s>>>(
            wT, otherT, out, loss, n, epochs, lr));
  }
  return static_cast<int>(cudaGetLastError());
}

// srnn_ww_sgd's arguments and order: (epochs, P, n) uint8, a sample index
// in [0, P) per step and lane (the wrapper checks the range).
extern "C" int srnn_ww_sgd_shuffled(const float* wT, const float* otherT,
                                    float* out, float* loss, long long n,
                                    int epochs, float lr, int width,
                                    int depth, int act_code,
                                    const float* coords,
                                    const unsigned char* order,
                                    void* stream) {
  constexpr int W = SRNN_W, D = SRNN_D;
  if (width != W || depth != D || n <= 0 || epochs < 0 ||
      (epochs > 0 && order == nullptr) || !srnn::coords_match<W, D>(coords))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int g = srnn::blocks_for(n);
  if (otherT == nullptr) {
    SRNN_DISPATCH_ACT(act_code,
        ww_sgd_shuffled_kernel<W, D, A, true><<<g, srnn::kThreads, 0, s>>>(
            wT, otherT, order, out, loss, n, epochs, lr));
  } else {
    SRNN_DISPATCH_ACT(act_code,
        ww_sgd_shuffled_kernel<W, D, A, false><<<g, srnn::kThreads, 0, s>>>(
            wT, otherT, order, out, loss, n, epochs, lr));
  }
  return static_cast<int>(cudaGetLastError());
}
