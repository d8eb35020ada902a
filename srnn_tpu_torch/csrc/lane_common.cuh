// Device code shared by every kernel of srnn_tpu_torch: the activations and
// their output-expressed derivatives, the population-major lane indexing,
// the launch shape, the activation dispatch and the error string.
//
// Layout: a population is population-major, (P, N) float32, one column per
// particle.  Every kernel runs ONE THREAD PER PARTICLE: thread n reads
// wT[p * N + n] for each row p (a warp's 32 loads of one row are
// contiguous, so they coalesce) and keeps the particle's rows in registers
// for the whole call.  There is no cross-particle arithmetic anywhere, so
// no shared memory and no synchronisation but K3's deal of a block's lanes
// to its threads (generation_common.cuh).  The sources are built with
// --fmad=false, so every multiply and every add rounds on its own, as the
// plain torch versions' separate ops do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace srnn {

enum Act { LINEAR = 0, SIGMOID = 1, TANH = 2, RELU = 3 };

template <int A>
__device__ __forceinline__ float act(float z) {
  if constexpr (A == SIGMOID) {
    return 1.0f / (1.0f + expf(-z));
  } else if constexpr (A == TANH) {
    return tanhf(z);
  } else if constexpr (A == RELU) {
    return z < 0.0f ? 0.0f : z;  // NaN passes through, as in torch.relu
  } else {
    return z;
  }
}

// dh * act'(z), with act'(z) written in terms of the output h = act(z)
// (ops/activations.py: _OUTPUT_GRADS).
template <int A>
__device__ __forceinline__ float act_grad_mul(float dh, float h) {
  if constexpr (A == SIGMOID) {
    return dh * (h * (1.0f - h));
  } else if constexpr (A == TANH) {
    return dh * (1.0f - h * h);
  } else if constexpr (A == RELU) {
    return dh * (h > 0.0f ? 1.0f : 0.0f);
  } else {
    return dh;
  }
}

// Row r of a (rows, n) population-major array, lane i.
__device__ __forceinline__ long long lane(int r, long long n, long long i) {
  return static_cast<long long>(r) * n + i;
}

constexpr int kThreads = 128;

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace srnn

// The topology an entry point is built for.  The default build of a source
// is the width-2 / depth-2 / 4-aggregate one with every activation (and,
// for the k-vector sources, every reduce kind; for K6 the victim lengths
// 14, 17 and 20); any other topology up to 64 weights gets a build of its
// own at first use (ops/_build.py), with its width, depth and aggregates
// and its activation (SRNN_ACT), reduce kind (SRNN_REDUCE) and K6's victim
// length (SRNN_T) set by -D flags, so that the library holds that one
// instantiation.  The entry points refuse arguments that differ from what
// they were built for (cudaErrorInvalidValue).
#ifndef SRNN_W
#define SRNN_W 2
#endif
#ifndef SRNN_D
#define SRNN_D 2
#endif
#ifndef SRNN_K
#define SRNN_K 4
#endif

// Dispatch of the runtime activation code to the template instantiation.
#ifdef SRNN_ACT
#define SRNN_DISPATCH_ACT(act_code, ...)                                        \
  {                                                                             \
    if ((act_code) != SRNN_ACT) return static_cast<int>(cudaErrorInvalidValue); \
    constexpr int A = SRNN_ACT;                                                 \
    __VA_ARGS__;                                                                \
  }
#else
#define SRNN_DISPATCH_ACT(act_code, ...)                                        \
  switch (act_code) {                                                           \
    case srnn::LINEAR: { constexpr int A = srnn::LINEAR; __VA_ARGS__; break; }   \
    case srnn::SIGMOID: { constexpr int A = srnn::SIGMOID; __VA_ARGS__; break; } \
    case srnn::TANH: { constexpr int A = srnn::TANH; __VA_ARGS__; break; }       \
    case srnn::RELU: { constexpr int A = srnn::RELU; __VA_ARGS__; break; }       \
    default: return static_cast<int>(cudaErrorInvalidValue);                    \
  }
#endif

extern "C" const char* srnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
