// Device code shared by the k-vector kernels (kvec_train.cu, K4, and the
// aggregating/fft body of K3, generation_kvec.cu): the reduce of P weights
// to k aggregates or DFT coefficients, the k -> k MLP, its hand-derived
// full-batch SGD step, and the expand of K3's transform.  Layout, threading
// and rounding rules: lane_common.cuh.
//
// Template parameters: W = width, D = depth, K = aggregates, A =
// activation, R = reduce kind; every loop over them unrolls into
// straight-line register code.  The fft variant's DFT bases are float64
// tables rounded to float32 on the host (ops/cuda_kvec_train.py,
// ``kvec_tables``) and ride in by value as a kernel argument, each entry
// with its kind: skip (coefficient exactly 0.0), the row itself (exactly
// 1.0), or the row times the coefficient.
//
// The arithmetic mirrors, operation for operation, the JAX package's
// ``pallas_kvec_train._reduce_rows`` / ``_sgd_epochs`` and
// ``pallas_generation.apply_rows``, and this package's plain versions:
//   * average: each segment's add chain, plus the prefix and suffix chains
//     of 0.0-weighted rows outside it, times 1/count -- a non-finite weight
//     enters its own segment at full value and poisons every other
//     aggregate (0 * Inf = NaN), as the XLA one-hot matmul does;
//   * max: an explicit compare chain that propagates NaN (torch.maximum);
//     never fmaxf, which drops it;
//   * max_buggy: the reference's falsy max (network.py:303-308): a
//     candidate wins only when it is greater AND != 0.0;
//   * the aggregating expand keeps a 0.0-weighted term for every
//     out-of-segment aggregate.

#pragma once

#include "lane_common.cuh"

namespace srnn {

enum Reduce { AVERAGE = 0, MAX = 1, MAX_BUGGY = 2, DFT = 3 };

// Shapes of the bias-free k-vector MLP K -> W -> ... -> W -> K
// (topology.py: layer_shapes, offsets; aggregation_segments).
template <int W, int D, int K>
struct KV {
  static constexpr int L = D + 1;
  static constexpr int P = K * W + (D - 1) * W * W + W * K;
  static constexpr int M = W > K ? W : K;
  static constexpr int SEG = P / K;  // segment size; leftovers go last
  __host__ __device__ static constexpr int fan_in(int l) { return l == 0 ? K : W; }
  __host__ __device__ static constexpr int fan_out(int l) { return l == L - 1 ? K : W; }
  __host__ __device__ static constexpr int offset(int l) {
    return l == 0 ? 0 : K * W + (l - 1) * W * W;
  }
  __host__ __device__ static constexpr int seg_start(int j) { return j * SEG; }
  __host__ __device__ static constexpr int seg_end(int j) {
    return j == K - 1 ? P : (j + 1) * SEG;
  }
  __host__ __device__ static constexpr int seg_of(int m) {
    return m / SEG < K - 1 ? m / SEG : K - 1;
  }
};

enum BasisKind { SKIP = 0, ONE = 1, MUL = 2 };

// The constant tables (host layout: ops/cuda_kvec_train.py, kvec_tables).
template <int P, int K>
struct KvecTables {
  float red[K][P];                // DFT cos basis (fft variant)
  float exp[P][K];                // inverse basis (fft variant)
  unsigned char red_kind[K][P];
  unsigned char exp_kind[P][K];
  int src_target;                 // the transform reduces the target (1)
                                  // or the attacker's own weights (0)
};

template <int P, int K>
inline KvecTables<P, K> load_tables(const float* host) {
  KvecTables<P, K> tb;
  const float* red = host;
  const float* exp = red + K * P;
  const float* red_kind = exp + P * K;
  const float* exp_kind = red_kind + K * P;
  for (int j = 0; j < K; ++j)
    for (int m = 0; m < P; ++m) {
      tb.red[j][m] = red[j * P + m];
      tb.red_kind[j][m] = static_cast<unsigned char>(red_kind[j * P + m]);
    }
  for (int m = 0; m < P; ++m)
    for (int j = 0; j < K; ++j) {
      tb.exp[m][j] = exp[m * K + j];
      tb.exp_kind[m][j] = static_cast<unsigned char>(exp_kind[m * K + j]);
    }
  tb.src_target = exp_kind[P * K] != 0.0f ? 1 : 0;
  return tb;
}

// torch.maximum: NaN if either operand is NaN, else the larger.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

// P weight rows -> K aggregates / DFT coefficients (``_reduce_rows``).
template <int W, int D, int K, int R>
__device__ __forceinline__ void reduce_rows(const float (&rows)[KV<W, D, K>::P],
                                            float (&out)[K],
                                            const KvecTables<KV<W, D, K>::P, K>& tb) {
  using T = KV<W, D, K>;
  constexpr int P = T::P;
  if constexpr (R == DFT) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float acc = 0.0f;
      bool have = false;
#pragma unroll
      for (int m = 0; m < P; ++m) {
        const int kind = tb.red_kind[j][m];
        if (kind == SKIP) continue;
        const float term = kind == ONE ? rows[m] : rows[m] * tb.red[j][m];
        acc = have ? acc + term : term;
        have = true;
      }
      out[j] = acc;  // 0.0 when every coefficient was skipped
    }
  } else if constexpr (R == AVERAGE) {
    // zpre[i] = sum of 0 * rows[:i], zsuf[i] = sum of 0 * rows[i:]
    float zpre[P + 1], zsuf[P + 1];
    zpre[0] = 0.0f;
#pragma unroll
    for (int r = 0; r < P; ++r) zpre[r + 1] = zpre[r] + rows[r] * 0.0f;
    zsuf[P] = 0.0f;
#pragma unroll
    for (int r = P - 1; r >= 0; --r) zsuf[r] = zsuf[r + 1] + rows[r] * 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = T::seg_start(j), e = T::seg_end(j);
      float acc = rows[s];
#pragma unroll
      for (int r = s + 1; r < e; ++r) acc = acc + rows[r];
      const float inv = static_cast<float>(1.0 / static_cast<double>(e - s));
      out[j] = (acc + zpre[s] + zsuf[e]) * inv;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = T::seg_start(j), e = T::seg_end(j);
      float acc = rows[s];
#pragma unroll
      for (int r = s + 1; r < e; ++r) {
        const float w = rows[r];
        if constexpr (R == MAX) {
          acc = nan_max(acc, w);
        } else {
          acc = (w > acc && w != 0.0f) ? w : acc;
        }
      }
      out[j] = acc;
    }
  }
}

// The MLP with weights ``w`` on the K-vector ``x``, every layer's
// activations kept in ``acts`` (acts[0] = x, acts[L] = the output).
template <int W, int D, int K, int A>
__device__ __forceinline__ void kvec_forward(const float (&w)[KV<W, D, K>::P],
                                             const float (&x)[K],
                                             float (&acts)[KV<W, D, K>::L + 1]
                                                          [KV<W, D, K>::M]) {
  using T = KV<W, D, K>;
#pragma unroll
  for (int j = 0; j < K; ++j) acts[0][j] = x[j];
#pragma unroll
  for (int l = 0; l < T::L; ++l) {
    const int a = T::fan_in(l), b = T::fan_out(l), o = T::offset(l);
#pragma unroll
    for (int j = 0; j < b; ++j) {
      float acc = acts[l][0] * w[o + j];
#pragma unroll
      for (int i = 1; i < a; ++i) acc = acc + acts[l][i] * w[o + i * b + j];
      acts[l + 1][j] = act<A>(acc);
    }
  }
}

// ``epochs`` full-batch MSE-SGD steps on the K-vector sample
// (``_sgd_epochs``).  REFRESH: self-training, the sample re-reduced from the
// rows at each epoch top; else imitation, the sample is ``snap``.  Backward
// as ww_common.cuh's sgd_chain, with fan-in and fan-out K.  Returns the last
// epoch's pre-update loss (0 when epochs == 0).
template <int W, int D, int K, int A, int R, bool REFRESH>
__device__ __forceinline__ float kvec_sgd(float (&rows)[KV<W, D, K>::P],
                                          const float (&snap)[K], int epochs,
                                          float lr,
                                          const KvecTables<KV<W, D, K>::P, K>& tb) {
  using T = KV<W, D, K>;
  constexpr int P = T::P;
  const float scale = static_cast<float>(2.0 / K);
  float loss = 0.0f;
  for (int e = 0; e < epochs; ++e) {
    float xk[K];
    if constexpr (REFRESH) {
      reduce_rows<W, D, K, R>(rows, xk, tb);
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) xk[j] = snap[j];
    }
    float acts[T::L + 1][T::M];
    kvec_forward<W, D, K, A>(rows, xk, acts);
    float err[K];
#pragma unroll
    for (int j = 0; j < K; ++j) err[j] = acts[T::L][j] - xk[j];
    float l2 = err[0] * err[0];
#pragma unroll
    for (int j = 1; j < K; ++j) l2 = l2 + err[j] * err[j];
    loss = l2 / static_cast<float>(K);
    float dh[T::M];
#pragma unroll
    for (int j = 0; j < K; ++j) dh[j] = err[j] * scale;
    float grads[P];
#pragma unroll
    for (int li = T::L - 1; li >= 0; --li) {
      const int a = T::fan_in(li), b = T::fan_out(li), o = T::offset(li);
      if constexpr (A != LINEAR) {
#pragma unroll
        for (int j = 0; j < b; ++j) dh[j] = act_grad_mul<A>(dh[j], acts[li + 1][j]);
      }
      float dprev[T::M];
#pragma unroll
      for (int i = 0; i < a; ++i) {
        float acc = dh[0] * rows[o + i * b];
#pragma unroll
        for (int j = 1; j < b; ++j) acc = acc + dh[j] * rows[o + i * b + j];
        dprev[i] = acc;
#pragma unroll
        for (int j = 0; j < b; ++j) grads[o + i * b + j] = dh[j] * acts[li][i];
      }
#pragma unroll
      for (int i = 0; i < a; ++i) dh[i] = dprev[i];
    }
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = rows[r] - lr * grads[r];
  }
  return loss;
}

// out = f_self(x): reduce (the target, or for the fft variant without
// fft_use_target the attacker's own rows), one forward, expand
// (``pallas_generation.apply_rows``, k-vector body).
template <int W, int D, int K, int A, int R>
__device__ __forceinline__ void kvec_apply(const float (&self)[KV<W, D, K>::P],
                                           const float (&x)[KV<W, D, K>::P],
                                           float (&out)[KV<W, D, K>::P],
                                           const KvecTables<KV<W, D, K>::P, K>& tb) {
  using T = KV<W, D, K>;
  constexpr int P = T::P;
  float src[P];
#pragma unroll
  for (int r = 0; r < P; ++r) src[r] = tb.src_target ? x[r] : self[r];
  float ak[K];
  reduce_rows<W, D, K, R>(src, ak, tb);
  float acts[T::L + 1][T::M];
  kvec_forward<W, D, K, A>(self, ak, acts);
#pragma unroll
  for (int m = 0; m < P; ++m) {
    float acc;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float o = acts[T::L][j];
      float term;
      if constexpr (R == DFT) {
        term = tb.exp_kind[m][j] == ONE ? o : o * tb.exp[m][j];
      } else {
        term = j == T::seg_of(m) ? o : o * 0.0f;
      }
      acc = j == 0 ? term : acc + term;
    }
    out[m] = acc;
  }
}

}  // namespace srnn

// Dispatch of the runtime reduce code to the template instantiation.
#define SRNN_DISPATCH_REDUCE(reduce_code, ...)                                    \
  switch (reduce_code) {                                                          \
    case srnn::AVERAGE: { constexpr int R = srnn::AVERAGE; __VA_ARGS__; break; }   \
    case srnn::MAX: { constexpr int R = srnn::MAX; __VA_ARGS__; break; }           \
    case srnn::MAX_BUGGY: { constexpr int R = srnn::MAX_BUGGY; __VA_ARGS__; break; } \
    case srnn::DFT: { constexpr int R = srnn::DFT; __VA_ARGS__; break; }           \
    default: return static_cast<int>(cudaErrorInvalidValue);                      \
  }
