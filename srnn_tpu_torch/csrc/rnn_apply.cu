// K6: the recurrent variant's attack transform -- each attacker's stacked
// SimpleRNN rewrites its victim's weight sequence.
//
// Replaces the Pallas TPU kernel srnn_tpu/ops/pallas_rnn_apply.py,
// rnn_apply_pallas (body _apply_kernel).
//
// What bounds it on an H100: memory.  One forward of the 1-2-2-1 stack over
// a T-step sequence is about 29 T operations per particle; at N = 1M and
// T = 17 that is 4.9e8 operations (0.007 ms at the FP32 peak) against
// (17 + 2 T) * 4 bytes per particle moved (attacker and victim read,
// result written): 204 MB, 0.06 ms at 3.35 TB/s.
//
// Design: one thread per particle, the attacker's 17 weights and the
// victim's sequence in registers, the T steps unrolled (rnn_common.cuh), one
// coalesced read of each operand row and one write per output row.  The
// victim's length T is a template parameter.  The default build holds the
// victims the width-2 / depth-2 topologies give: T = 14 (weightwise), 17
// (recurrent: the homogeneous soup's T = P) and 20 (aggregating, fft) --
// the mixed-type soup's cross attacks (popmajor_cross.py); any other
// attacker topology or victim length up to 64 gets a build of its own
// (SRNN_T, lane_common.cuh).  At T = 20 the thread holds w[17], x[20] and
// y[20] plus the forward's carries; ptxas' spill report is printed by
// chip_smoke.py.

#include "rnn_common.cuh"

namespace {

template <int W, int D, int A, int T>
__global__ void __launch_bounds__(srnn::kThreads)
rnn_apply_kernel(const float* __restrict__ selfT,
                 const float* __restrict__ targetT, float* __restrict__ out,
                 long long n) {
  constexpr int P = srnn::RNN<W, D>::P;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float w[P], x[T], y[T];
#pragma unroll
  for (int r = 0; r < P; ++r) w[r] = selfT[srnn::lane(r, n, i)];
#pragma unroll
  for (int t = 0; t < T; ++t) x[t] = targetT[srnn::lane(t, n, i)];
  srnn::rnn_apply<W, D, A, T>(w, x, y);
#pragma unroll
  for (int t = 0; t < T; ++t) out[srnn::lane(t, n, i)] = y[t];
}

// The instantiated victim lengths: the one SRNN_T names in a build for
// one (attacker, victim length) pair, else the default build's
// (ops/cuda_rnn_apply.py: DEFAULT_T_LENGTHS).
#ifdef SRNN_T
#define SRNN_DISPATCH_T(t_len, ...)                                          \
  {                                                                          \
    if ((t_len) != SRNN_T) return static_cast<int>(cudaErrorInvalidValue);  \
    constexpr int T = SRNN_T;                                                \
    __VA_ARGS__;                                                             \
  }
#else
#define SRNN_DISPATCH_T(t_len, ...)                          \
  switch (t_len) {                                           \
    case 14: { constexpr int T = 14; __VA_ARGS__; break; }   \
    case 17: { constexpr int T = 17; __VA_ARGS__; break; }   \
    case 20: { constexpr int T = 20; __VA_ARGS__; break; }   \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
#endif

}  // namespace

// selfT: (P, n) attackers; targetT, out: (t_len, n) victims and results.
// Instantiated for the build's attacker width and depth (SRNN_W, SRNN_D:
// lane_common.cuh) and victim lengths; any other t_len returns
// cudaErrorInvalidValue.
extern "C" int srnn_rnn_apply(const float* selfT, const float* targetT,
                              float* out, long long n, int t_len, int width,
                              int depth, int act_code, void* stream) {
  constexpr int W = SRNN_W, D = SRNN_D;
  if (width != W || depth != D || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  SRNN_DISPATCH_T(t_len, SRNN_DISPATCH_ACT(act_code,
      rnn_apply_kernel<W, D, A, T><<<srnn::blocks_for(n), srnn::kThreads, 0,
                                     s>>>(selfT, targetT, out, n)));
  return static_cast<int>(cudaGetLastError());
}
