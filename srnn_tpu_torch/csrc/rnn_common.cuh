// Device code shared by the recurrent kernels (rnn_train.cu, K5;
// rnn_apply.cu, K6; the recurrent body of K3, generation_rnn.cu): the
// stacked SimpleRNN forward and its hand-derived backprop-through-time.
// Layout, threading and rounding rules: lane_common.cuh.
//
// Template parameters: W = width, D = depth, A = activation, T = sequence
// length (the particle's own P for training and the homogeneous soup's
// attack; the victim's weight count for a cross attack); every loop unrolls
// into straight-line code.  The arithmetic mirrors, operation for
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
// What bounds the BPTT (K5, K3's recurrent body) on an H100: the issue rate
// of its float32 multiplies and adds, which --fmad=false keeps apart (half
// the data sheet's FP32 rate, which counts an FMA as two operations).  The
// first design indexed the weights, the sample and the gradients with
// layer offsets from the recursive RNN<W, D>::ko(), which the compiler did
// not fold inside the unrolled loops: those arrays lived in local memory (a
// 136-byte stack frame; the self-training kernel's code held 220 local
// stores and 68 local loads beside its 1,589 multiplies and adds), and the
// backward ran layer by layer through two per-layer gradient sequences.
// This one:
//   - walks the layers by template recursion (Layer<W, D, L>: rnn_step,
//     bptt_step), so that every index is a constant expression and every
//     array a register -- no stack frame, no local memory;
//   - runs the backward as ONE reverse-time sweep over all layers: at each
//     t the top layer first, its input gradient handed straight to the
//     layer below as that layer's output gradient.  Every weight gradient
//     still adds over t from T - 1 down to 0, so the results are bitwise
//     those of the layer-by-layer backward, and the gradient sequences are
//     gone;
//   - runs the forward time-major (rnn_step: at each t every layer in
//     turn), which computes every output from the same operands in the same
//     order as the layer-major rnn_forward, so the results are bitwise the
//     same; the attack of K3 (rnn_apply_streamed) then stores nothing but
//     its output.
// Every layer's output sequence (85 floats at T = 17) stays in registers:
// 148 registers for K5, 12 resident warps per SM.  Moving it to a
// per-thread shared-memory column with the launch bounded to 5 blocks (20
// warps) measured no faster (PERF.md).  K6 keeps rnn_forward / rnn_apply
// (72-byte stack frame, above half of its byte bound).

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

// K6's forward: the stack over the length-T sequence ``x``, layer by layer;
// seq[l][t][u] holds layer l's output at step t (layer NL - 1's unit 0 is
// the prediction).
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

// Layer L's shape and weight offsets as constant expressions: the BPTT and
// K3's attack walk the layers by template recursion, so that every array
// index is a compile-time constant once the time loop unrolls (a register,
// never local memory).
template <int W, int D, int L>
struct Layer {
  using R = RNN<W, D>;
  static constexpr int ind = R::in(L), units = R::units(L);
  static constexpr int ko = R::ko(L), ro = R::ro(L);
};

// One time step of the stack from layer L up, time-major: on entry h[l]
// holds layer l's output at step t - 1 (zeros before step 0: the explicit
// zero h_{-1}), on exit at step t.  Layer l's input is layer l - 1's fresh
// output (x_t for layer 0); each unit's sum runs in rnn_forward's order.
template <int W, int D, int A, int L = 0>
__device__ __forceinline__ void rnn_step(const float (&w)[RNN<W, D>::P],
                                         float xt,
                                         float (&h)[RNN<W, D>::NL][RNN<W, D>::MU]) {
  using Y = Layer<W, D, L>;
  float nxt[RNN<W, D>::MU];
#pragma unroll
  for (int u = 0; u < Y::units; ++u) {
    float acc;
    if constexpr (L == 0) {
      acc = xt * w[Y::ko + u];
    } else {
      acc = h[L - 1][0] * w[Y::ko + u];
#pragma unroll
      for (int i = 1; i < Y::ind; ++i) acc = acc + h[L - 1][i] * w[Y::ko + i * Y::units + u];
    }
#pragma unroll
    for (int v = 0; v < Y::units; ++v) acc = acc + h[L][v] * w[Y::ro + v * Y::units + u];
    nxt[u] = act<A>(acc);
  }
#pragma unroll
  for (int u = 0; u < Y::units; ++u) h[L][u] = nxt[u];
  if constexpr (L + 1 < RNN<W, D>::NL) rnn_step<W, D, A, L + 1>(w, xt, h);
}

// out = f_self(x), time-major with nothing stored but the output (K3's
// attack; the same results as rnn_apply).
template <int W, int D, int A, int T>
__device__ __forceinline__ void rnn_apply_streamed(const float (&self)[RNN<W, D>::P],
                                                   const float (&x)[T], float (&out)[T]) {
  using R = RNN<W, D>;
  float h[R::NL][R::MU];
#pragma unroll
  for (int l = 0; l < R::NL; ++l)
#pragma unroll
    for (int v = 0; v < R::MU; ++v) h[l][v] = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    rnn_step<W, D, A>(self, x[t], h);
    out[t] = h[R::NL - 1][0];
  }
}

// Layer L's part of the reverse sweep at step t, then the layers below it.
// cur: every layer's output at t, prev: at t - 1 (unused at t = 0); dout
// holds dL/d(layer L's output at t) on entry, dcarry[L] the gradient
// reaching its h_t from step t + 1 (unused at t = T - 1).  Adds the layer's
// weight gradients, leaves its input gradient in dout for layer L - 1 and
// its carry into step t - 1 in dcarry[L].
template <int W, int D, int A, int L>
__device__ __forceinline__ void bptt_step(const float (&w)[RNN<W, D>::P],
                                          const float (&x)[RNN<W, D>::P], int t,
                                          const float (&cur)[RNN<W, D>::NL][RNN<W, D>::MU],
                                          const float (&prev)[RNN<W, D>::NL][RNN<W, D>::MU],
                                          float (&dout)[RNN<W, D>::MU],
                                          float (&dcarry)[RNN<W, D>::NL][RNN<W, D>::MU],
                                          float (&grads)[RNN<W, D>::P]) {
  using Y = Layer<W, D, L>;
  constexpr int T = RNN<W, D>::P;
  float dz[RNN<W, D>::MU];
#pragma unroll
  for (int u = 0; u < Y::units; ++u) {
    float dh = dout[u];
    if (t < T - 1) dh = dh + dcarry[L][u];
    dz[u] = act_grad_mul<A>(dh, cur[L][u]);
  }
#pragma unroll
  for (int u = 0; u < Y::units; ++u) {
#pragma unroll
    for (int i = 0; i < Y::ind; ++i) {
      float xi;
      if constexpr (L == 0) {
        xi = x[t];
      } else {
        xi = cur[L - 1][i];
      }
      grads[Y::ko + i * Y::units + u] = grads[Y::ko + i * Y::units + u] + xi * dz[u];
    }
#pragma unroll
    for (int v = 0; v < Y::units; ++v) {
      const float hv = t > 0 ? prev[L][v] : 0.0f;
      grads[Y::ro + v * Y::units + u] = grads[Y::ro + v * Y::units + u] + hv * dz[u];
    }
  }
  if constexpr (L > 0) {
#pragma unroll
    for (int i = 0; i < Y::ind; ++i) {
      float acc = dz[0] * w[Y::ko + i * Y::units];
#pragma unroll
      for (int u = 1; u < Y::units; ++u) acc = acc + dz[u] * w[Y::ko + i * Y::units + u];
      dout[i] = acc;
    }
  }
  if (t > 0) {
#pragma unroll
    for (int v = 0; v < Y::units; ++v) {
      float acc = dz[0] * w[Y::ro + v * Y::units];
#pragma unroll
      for (int u = 1; u < Y::units; ++u) acc = acc + dz[u] * w[Y::ro + v * Y::units + u];
      dcarry[L][v] = acc;
    }
  }
  if constexpr (L > 0) bptt_step<W, D, A, L - 1>(w, x, t, cur, prev, dout, dcarry, grads);
}

// One full-batch MSE gradient on the sequence sample ``x`` (T = P):
// the forward, time-major, keeping every layer's outputs; then ONE reverse
// sweep over time, at each t the layers top down (``_bptt_epoch``'s
// arithmetic, reordered across independent sums only):
//   dh_t[u]   = dOut_t[u] + sum_u' dz_{t+1}[u'] R[u, u']
//   dz_t[u]   = dh_t[u] act'(h_t[u])
//   dK[i, u] += x_t[i] dz_t[u];   dR[v, u] += h_{t-1}[v] dz_t[u]
//   dX_t[i]   = sum_u dz_t[u] K[i, u]   (the layer below's dOut_t)
// Returns the pre-update loss.
template <int W, int D, int A>
__device__ __forceinline__ float bptt_epoch(const float (&w)[RNN<W, D>::P],
                                            const float (&x)[RNN<W, D>::P],
                                            float (&grads)[RNN<W, D>::P]) {
  using R = RNN<W, D>;
  constexpr int T = R::P;
  float seq[T][R::NL][R::MU];  // every layer's output at every step
  float h[R::NL][R::MU];
#pragma unroll
  for (int l = 0; l < R::NL; ++l)
#pragma unroll
    for (int v = 0; v < R::MU; ++v) h[l][v] = 0.0f;
  float loss = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    rnn_step<W, D, A>(w, x[t], h);
#pragma unroll
    for (int l = 0; l < R::NL; ++l)
#pragma unroll
      for (int v = 0; v < R::MU; ++v) seq[t][l][v] = h[l][v];
    const float err = h[R::NL - 1][0] - x[t];
    loss = t == 0 ? err * err : loss + err * err;
  }
  loss = loss / static_cast<float>(T);
#pragma unroll
  for (int p = 0; p < R::P; ++p) grads[p] = 0.0f;
  const float scale = static_cast<float>(2.0 / T);
  float dcarry[R::NL][R::MU];
#pragma unroll
  for (int t = T - 1; t >= 0; --t) {
    float dout[R::MU];
    dout[0] = (seq[t][R::NL - 1][0] - x[t]) * scale;
    bptt_step<W, D, A, R::NL - 1>(w, x, t, seq[t], seq[t > 0 ? t - 1 : 0], dout,
                                   dcarry, grads);
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
