// Device code shared by the three weightwise kernels (ww_apply.cu,
// ww_train.cu, generation.cu): the unrolled weightwise MLP and the
// hand-derived batch-1 SGD chain.  Layout, threading and rounding rules:
// lane_common.cuh.
//
// The topology is template parameters (W = width, D = depth, A =
// activation), so every loop below has a compile-time trip count and unrolls
// into straight-line code over register arrays -- the role that Pallas's
// trace-time topology constants played on the TPU.  The normalised duplex
// coordinates (a (P, 3) table, srnn_tpu_torch/topology.py) ride in by value
// as a kernel argument (constant bank).
//
// The arithmetic mirrors, operation for operation, the JAX package's
// ``pallas_generation._mlp_rows`` / ``apply_rows`` and
// ``pallas_ww_train._sgd_chain``, and this package's plain torch versions of
// them: products and sums are taken in the same order.

#pragma once

#include "lane_common.cuh"

namespace srnn {

// Shapes of the bias-free weightwise MLP 4 -> W -> ... -> W -> 1
// (topology.py: layer_shapes, offsets).
template <int W, int D>
struct WW {
  static constexpr int L = D + 1;                       // number of kernels
  static constexpr int P = 4 * W + (D - 1) * W * W + W;  // weights
  static constexpr int M = W > 4 ? W : 4;                // widest activation
  __host__ __device__ static constexpr int fan_in(int l) { return l == 0 ? 4 : W; }
  __host__ __device__ static constexpr int fan_out(int l) { return l == L - 1 ? 1 : W; }
  __host__ __device__ static constexpr int offset(int l) {
    return l == 0 ? 0 : 4 * W + (l - 1) * W * W;
  }
};

template <int P>
struct Coords {
  float c[P][3];
};

// The MLP with weights ``w`` on one duplex point [x, c0, c1, c2].
template <int W, int D, int A>
__device__ __forceinline__ float mlp_point(const float (&w)[WW<W, D>::P],
                                           float x, const float (&c)[3]) {
  using T = WW<W, D>;
  float h[T::M];
  h[0] = x;
  h[1] = c[0];
  h[2] = c[1];
  h[3] = c[2];
#pragma unroll
  for (int l = 0; l < T::L; ++l) {
    const int a = T::fan_in(l), b = T::fan_out(l), o = T::offset(l);
    float nxt[T::M];
#pragma unroll
    for (int j = 0; j < b; ++j) {
      float acc = h[0] * w[o + j];
#pragma unroll
      for (int i = 1; i < a; ++i) acc = acc + h[i] * w[o + i * b + j];
      nxt[j] = act<A>(acc);
    }
#pragma unroll
    for (int j = 0; j < b; ++j) h[j] = nxt[j];
  }
  return h[0];
}

// out[s] = f_self(point(x[s])) for every weight s: one self-application
// (self == x) or one attack (self = attacker, x = victim).
template <int W, int D, int A>
__device__ __forceinline__ void apply_rows(const float (&self)[WW<W, D>::P],
                                           const float (&x)[WW<W, D>::P],
                                           float (&out)[WW<W, D>::P],
                                           const Coords<WW<W, D>::P>& co) {
#pragma unroll
  for (int s = 0; s < WW<W, D>::P; ++s)
    out[s] = mlp_point<W, D, A>(self, x[s], co.c[s]);
}

// ``epochs`` passes of batch-1 SGD over the P samples, in enumeration order,
// on the registers ``rows``.  REFRESH: self-training, the samples are the
// rows as they stand at the top of each epoch; else imitation, the samples
// are the fixed ``target``.  The backward is derived by hand:
//   dL/dpred = 2 (pred - y);  dz[j] = dh[j] act'(h[j]);
//   dL/dW[i][j] = dz[j] h_prev[i];  dh_prev[i] = sum_j dz[j] W[i][j].
// Returns the last epoch's mean pre-update loss (0 when epochs == 0).
template <int W, int D, int A, bool REFRESH>
__device__ __forceinline__ float sgd_chain(float (&rows)[WW<W, D>::P],
                                           const float (&target)[WW<W, D>::P],
                                           int epochs, float lr,
                                           const Coords<WW<W, D>::P>& co) {
  using T = WW<W, D>;
  constexpr int P = T::P;
  float last = 0.0f;
  float snap[P];
  for (int e = 0; e < epochs; ++e) {
#pragma unroll
    for (int r = 0; r < P; ++r) snap[r] = REFRESH ? rows[r] : target[r];
    float loss_acc = 0.0f;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const float x = snap[s];
      // forward, keeping every layer's post-activations for the backward
      float acts[T::L + 1][T::M];
      acts[0][0] = x;
      acts[0][1] = co.c[s][0];
      acts[0][2] = co.c[s][1];
      acts[0][3] = co.c[s][2];
#pragma unroll
      for (int l = 0; l < T::L; ++l) {
        const int a = T::fan_in(l), b = T::fan_out(l), o = T::offset(l);
#pragma unroll
        for (int j = 0; j < b; ++j) {
          float acc = acts[l][0] * rows[o + j];
#pragma unroll
          for (int i = 1; i < a; ++i) acc = acc + acts[l][i] * rows[o + i * b + j];
          acts[l + 1][j] = act<A>(acc);
        }
      }
      const float pred = acts[T::L][0];
      loss_acc = loss_acc + (pred - x) * (pred - x);
      // backward; dh is the gradient w.r.t. a layer's post-activation output
      float dh[T::M];
      dh[0] = 2.0f * (pred - x);
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
    last = loss_acc / static_cast<float>(P);
  }
  return last;
}

template <int P>
inline Coords<P> load_coords(const float* host) {
  Coords<P> co;
  for (int s = 0; s < P; ++s)
    for (int k = 0; k < 3; ++k) co.c[s][k] = host[s * 3 + k];
  return co;
}

}  // namespace srnn
