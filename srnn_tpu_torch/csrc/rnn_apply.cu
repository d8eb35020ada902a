// K6: the recurrent variant's attack transform -- each attacker's stacked
// SimpleRNN rewrites its victim's weight sequence.
//
// Replaces the Pallas TPU kernel srnn_tpu/ops/pallas_rnn_apply.py,
// rnn_apply_pallas (body _apply_kernel).
//
// What bounds it on an H100: memory.  One forward of the 1-2-2-1 stack over
// a 17-step sequence is about 490 operations per particle; at N = 1M that is
// 4.9e8 operations (0.007 ms at the FP32 peak) against 204 MB moved
// (attacker and victim read, result written: 0.06 ms at 3.35 TB/s).
//
// Design: one thread per particle, the attacker's weights and the victim's
// sequence in registers, the T steps unrolled (rnn_common.cuh), one
// coalesced read of each operand row and one write per output row.  Only
// T = P (a victim of the attacker's own topology, the soup's case) is
// instantiated; the mixed-type soup's other lengths wait for their port.

#include "rnn_common.cuh"

namespace {

template <int W, int D, int A>
__global__ void __launch_bounds__(srnn::kThreads)
rnn_apply_kernel(const float* __restrict__ selfT,
                 const float* __restrict__ targetT, float* __restrict__ out,
                 long long n) {
  constexpr int P = srnn::RNN<W, D>::P;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float w[P], x[P], y[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    w[r] = selfT[srnn::lane(r, n, i)];
    x[r] = targetT[srnn::lane(r, n, i)];
  }
  srnn::rnn_apply<W, D, A, P>(w, x, y);
#pragma unroll
  for (int r = 0; r < P; ++r) out[srnn::lane(r, n, i)] = y[r];
}

}  // namespace

// selfT: (P, n) attackers; targetT, out: (t_len, n) victims and results,
// t_len == P.  Only width 2, depth 2 is instantiated.
extern "C" int srnn_rnn_apply(const float* selfT, const float* targetT,
                              float* out, long long n, int t_len, int width,
                              int depth, int act_code, void* stream) {
  constexpr int W = 2, D = 2;
  if (width != W || depth != D || n <= 0 || t_len != srnn::RNN<W, D>::P)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  SRNN_DISPATCH_ACT(act_code,
      rnn_apply_kernel<W, D, A><<<srnn::blocks_for(n), srnn::kThreads, 0, s>>>(
          selfT, targetT, out, n));
  return static_cast<int>(cudaGetLastError());
}
