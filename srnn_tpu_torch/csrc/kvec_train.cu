// K4: the k-vector (aggregating, fft) SGD chain, self-training or
// imitation.
//
// Replaces the Pallas TPU kernels srnn_tpu/ops/pallas_kvec_train.py,
// kvec_train_epochs_pallas and kvec_learn_epochs_pallas (bodies
// _reduce_rows and _sgd_epochs, launched through
// pallas_sgd_common.lane_call).
//
// What bounds it on an H100: memory and the FP32 issue rate together, at
// the soup's shapes.  An epoch of the 20-weight 4-2-2-4 net is one reduce
// (27 operations for the segment average on a lane whose weights are all
// finite, 108 with the poison chains on any other; fewer for max, the DFT's
// multiplies and adds), one forward of the k-vector (52 operations), a
// hand-derived backward and the update of 20 weights -- 155 operations;
// the soup's self-training runs 10 epochs, imitation 1.  At N = 1M and 10
// epochs that is about 1.55e9 operations (0.046 ms at the --fmad=false
// issue rate of separate multiplies and adds) against 164 MB read and
// written once (0.049 ms at 3.35 TB/s).
//
// Design: one thread per particle; weights, the k-vector sample and every
// layer's activations in registers for the whole chain; one coalesced read
// and one write per weight row.  For self-training the sample is re-reduced
// from the rows at each epoch top; for imitation it is reduced once from
// the counterpart's column.  The reduce's exact finite path and the
// compile-time DFT tables: kvec_common.cuh.

#include "kvec_common.cuh"

namespace {

template <int W, int D, int K, int A, int R, bool REFRESH>
__global__ void __launch_bounds__(srnn::kThreads)
kvec_sgd_kernel(const float* __restrict__ wT, const float* __restrict__ otherT,
                float* __restrict__ out, float* __restrict__ loss, long long n,
                int epochs, float lr) {
  constexpr int P = srnn::KV<W, D, K>::P;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float rows[P];
#pragma unroll
  for (int r = 0; r < P; ++r) rows[r] = wT[srnn::lane(r, n, i)];
  float snap[K];
  if constexpr (REFRESH) {
#pragma unroll
    for (int j = 0; j < K; ++j) snap[j] = 0.0f;
  } else {
    float other[P];
#pragma unroll
    for (int r = 0; r < P; ++r) other[r] = otherT[srnn::lane(r, n, i)];
    srnn::reduce_rows<W, D, K, R>(other, snap);
  }
  const float last = srnn::kvec_sgd<W, D, K, A, R, REFRESH>(rows, snap, epochs, lr);
#pragma unroll
  for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = rows[r];
  loss[i] = last;
}

template <int W, int D, int K, int A, int R>
int launch(const float* wT, const float* otherT, float* out, float* loss,
           long long n, int epochs, float lr, cudaStream_t s) {
  const unsigned int g = srnn::blocks_for(n);
  if (otherT == nullptr) {
    kvec_sgd_kernel<W, D, K, A, R, true><<<g, srnn::kThreads, 0, s>>>(
        wT, otherT, out, loss, n, epochs, lr);
  } else {
    kvec_sgd_kernel<W, D, K, A, R, false><<<g, srnn::kThreads, 0, s>>>(
        wT, otherT, out, loss, n, epochs, lr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wT, out: (P, n); otherT: (P, n) imitation targets, or null for
// self-training; loss: (n,).  tables: the float32 host array of
// ops/cuda_kvec_train.py, kvec_tables, which must equal the kernel's
// compile-time table (srnn::tables_match).  Instantiated for the build's
// width, depth and aggregates (SRNN_W, SRNN_D, SRNN_K: lane_common.cuh).
extern "C" int srnn_kvec_sgd(const float* wT, const float* otherT, float* out,
                             float* loss, long long n, int epochs, float lr,
                             int width, int depth, int aggregates,
                             int act_code, int reduce_code,
                             const float* tables, void* stream) {
  constexpr int W = SRNN_W, D = SRNN_D, K = SRNN_K, P = srnn::KV<W, D, K>::P;
  if (width != W || depth != D || aggregates != K || n <= 0 || epochs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  SRNN_DISPATCH_REDUCE(reduce_code,
      if (!srnn::tables_match<P, K, R>(tables))
        return static_cast<int>(cudaErrorInvalidValue);
      SRNN_DISPATCH_ACT(act_code,
          return launch<W, D, K, A, R>(wT, otherT, out, loss, n, epochs, lr, s)));
  return static_cast<int>(cudaErrorInvalidValue);
}
