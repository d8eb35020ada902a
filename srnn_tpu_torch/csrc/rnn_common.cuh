// Device code shared by the recurrent kernels (rnn_train.cu, K5;
// rnn_apply.cu, K6; the recurrent body of K3, generation_rnn.cu): the
// stacked SimpleRNN forward over the weight sequence, keeping every layer's
// output sequence, and its hand-derived backprop-through-time.  Layout,
// threading and rounding rules: lane_common.cuh.
//
// Template parameters: W = width, D = depth, A = activation, T = sequence
// length (the particle's own P for training and the homogeneous soup's
// attack; the victim's weight count for a cross attack); every loop unrolls into
// straight-line register code.  The arithmetic mirrors, operation for
// operation, the JAX package's ``pallas_rnn_train.rnn_forward_rows`` /
// ``_bptt_epoch`` / ``_sgd_epochs`` and this package's plain versions
// (ops/cuda_rnn_train.py), including the explicit zero h_{-1} terms: the
// first step adds 0 * R, so a non-finite recurrent weight gives NaN there,
// as the XLA scan does.
//
// Keras' law, no bias: h_t = act(x_t @ K + h_{t-1} @ R), kernel K[i, u] at
// flat ko + i*units + u, recurrent R[v, u] at ro + v*units + u, the layers'
// (kernel, recurrent) pairs interleaved in topology.layer_shapes.
//
// Register pressure: the backward needs every layer's whole sequence
// (T x (1 + W + W + 1) values at depth 2), the weights, the gradients and
// the per-step carries at once -- about 200 live floats per thread at
// T = P = 17.  ptxas' spill report is printed by chip_smoke.py and written
// down in PERF.md.

#pragma once

#include "lane_common.cuh"

namespace srnn {

// Shapes of the stacked SimpleRNN: layer 0 (1 -> W), D - 1 layers (W -> W),
// a last layer (W -> 1) (topology.py: rnn_layer_dims, layer_shapes).
template <int W, int D>
struct RNN {
  static constexpr int NL = D + 1;  // RNN layers
  static constexpr int MU = W;      // widest layer
  __host__ __device__ static constexpr int in(int l) { return l == 0 ? 1 : W; }
  __host__ __device__ static constexpr int units(int l) { return l == NL - 1 ? 1 : W; }
  __host__ __device__ static constexpr int size(int l) {
    return in(l) * units(l) + units(l) * units(l);
  }
  __host__ __device__ static constexpr int ko(int l) {
    return l == 0 ? 0 : ko(l - 1) + size(l - 1);
  }
  __host__ __device__ static constexpr int ro(int l) { return ko(l) + in(l) * units(l); }
  static constexpr int P = ko(NL);
};

// The stack over the length-T sequence ``x``; seq[l][t][u] holds layer l's
// output at step t (layer NL - 1's unit 0 is the prediction).
template <int W, int D, int A, int T>
__device__ __forceinline__ void rnn_forward(const float (&w)[RNN<W, D>::P],
                                            const float (&x)[T],
                                            float (&seq)[RNN<W, D>::NL][T][RNN<W, D>::MU]) {
  using R = RNN<W, D>;
#pragma unroll
  for (int l = 0; l < R::NL; ++l) {
    const int ind = R::in(l), units = R::units(l), ko = R::ko(l), ro = R::ro(l);
    float h[R::MU];
#pragma unroll
    for (int v = 0; v < R::MU; ++v) h[v] = 0.0f;  // explicit zero h_{-1}
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float nxt[R::MU];
#pragma unroll
      for (int u = 0; u < units; ++u) {
        float acc = (l == 0 ? x[t] : seq[l - 1][t][0]) * w[ko + u];
#pragma unroll
        for (int i = 1; i < ind; ++i) acc = acc + seq[l - 1][t][i] * w[ko + i * units + u];
#pragma unroll
        for (int v = 0; v < units; ++v) acc = acc + h[v] * w[ro + v * units + u];
        nxt[u] = act<A>(acc);
      }
#pragma unroll
      for (int u = 0; u < units; ++u) {
        seq[l][t][u] = nxt[u];
        h[u] = nxt[u];
      }
    }
  }
}

// One full-batch MSE gradient on the sequence sample ``x`` (T = P):
// forward, then backprop through the layers (top down) and time (reverse)
// (``_bptt_epoch``):
//   dh_t[u]   = dOut_t[u] + sum_u' dz_{t+1}[u'] R[u, u']
//   dz_t[u]   = dh_t[u] act'(h_t[u])
//   dK[i, u] += x_t[i] dz_t[u];   dR[v, u] += h_{t-1}[v] dz_t[u]
//   dX_t[i]   = sum_u dz_t[u] K[i, u]   (the layer below's dOut)
// Returns the pre-update loss.
template <int W, int D, int A>
__device__ __forceinline__ float bptt_epoch(const float (&w)[RNN<W, D>::P],
                                            const float (&x)[RNN<W, D>::P],
                                            float (&grads)[RNN<W, D>::P]) {
  using R = RNN<W, D>;
  constexpr int T = R::P;
  float seq[R::NL][T][R::MU];
  rnn_forward<W, D, A, T>(w, x, seq);
  float err[T];
#pragma unroll
  for (int t = 0; t < T; ++t) err[t] = seq[R::NL - 1][t][0] - x[t];
  float loss = err[0] * err[0];
#pragma unroll
  for (int t = 1; t < T; ++t) loss = loss + err[t] * err[t];
  loss = loss / static_cast<float>(T);
#pragma unroll
  for (int p = 0; p < R::P; ++p) grads[p] = 0.0f;
  const float scale = static_cast<float>(2.0 / T);
  float d_out[T][R::MU];  // dL/d(this layer's output)
#pragma unroll
  for (int t = 0; t < T; ++t) d_out[t][0] = err[t] * scale;
#pragma unroll
  for (int l = R::NL - 1; l >= 0; --l) {
    const int ind = R::in(l), units = R::units(l), ko = R::ko(l), ro = R::ro(l);
    float d_inp[T][R::MU];
    float dcarry[R::MU];
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      float dz[R::MU];
#pragma unroll
      for (int u = 0; u < units; ++u) {
        float dh = d_out[t][u];
        if (t < T - 1) dh = dh + dcarry[u];
        dz[u] = act_grad_mul<A>(dh, seq[l][t][u]);
      }
#pragma unroll
      for (int u = 0; u < units; ++u) {
#pragma unroll
        for (int i = 0; i < ind; ++i) {
          const float xi = l == 0 ? x[t] : seq[l - 1][t][i];
          grads[ko + i * units + u] = grads[ko + i * units + u] + xi * dz[u];
        }
#pragma unroll
        for (int v = 0; v < units; ++v) {
          const float prev = t > 0 ? seq[l][t - 1][v] : 0.0f;
          grads[ro + v * units + u] = grads[ro + v * units + u] + prev * dz[u];
        }
      }
      if (l > 0) {
#pragma unroll
        for (int i = 0; i < ind; ++i) {
          float acc = dz[0] * w[ko + i * units];
#pragma unroll
          for (int u = 1; u < units; ++u) acc = acc + dz[u] * w[ko + i * units + u];
          d_inp[t][i] = acc;
        }
      }
#pragma unroll
      for (int v = 0; v < units; ++v) {
        float acc = dz[0] * w[ro + v * units];
#pragma unroll
        for (int u = 1; u < units; ++u) acc = acc + dz[u] * w[ro + v * units + u];
        dcarry[v] = acc;
      }
    }
    if (l > 0) {
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int i = 0; i < ind; ++i) d_out[t][i] = d_inp[t][i];
    }
  }
  return loss;
}

// ``epochs`` full-batch BPTT-SGD steps (``_sgd_epochs``).  REFRESH:
// self-training, the sample is the rows as they stand at each epoch top;
// else imitation, the sample is ``target``.  Returns the last epoch's loss
// (0 when epochs == 0).
template <int W, int D, int A, bool REFRESH>
__device__ __forceinline__ float rnn_sgd(float (&rows)[RNN<W, D>::P],
                                         const float (&target)[RNN<W, D>::P],
                                         int epochs, float lr) {
  constexpr int P = RNN<W, D>::P;
  float loss = 0.0f;
  for (int e = 0; e < epochs; ++e) {
    float x[P], grads[P];
#pragma unroll
    for (int r = 0; r < P; ++r) x[r] = REFRESH ? rows[r] : target[r];
    loss = bptt_epoch<W, D, A>(rows, x, grads);
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = rows[r] - lr * grads[r];
  }
  return loss;
}

// out = f_self(x): the last layer's output sequence (``apply_rows``,
// recurrent body; K6).
template <int W, int D, int A, int T>
__device__ __forceinline__ void rnn_apply(const float (&self)[RNN<W, D>::P],
                                          const float (&x)[T], float (&out)[T]) {
  using R = RNN<W, D>;
  float seq[R::NL][T][R::MU];
  rnn_forward<W, D, A, T>(self, x, seq);
#pragma unroll
  for (int t = 0; t < T; ++t) out[t] = seq[R::NL - 1][t][0];
}

}  // namespace srnn
