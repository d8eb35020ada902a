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
// the data sheet's FP32 rate, which counts an FMA as two operations).  Both
// paths below walk the layers by template recursion (Layer<W, D, L>:
// rnn_step, bptt_step), so that every weight and gradient index is a
// constant expression and those arrays live in registers (offsets from
// the recursive RNN<W, D>::ko(), which nvcc did not fold, had put them in
// local memory); both run the forward time-major (rnn_step: at each t
// every layer in turn, each output from the same operands in the same order
// as the layer-major rnn_forward, so bitwise the same; K3's attack,
// rnn_apply_streamed, stores nothing but its output) and the backward as ONE
// reverse-time sweep over all layers (at each t the top layer first, its
// input gradient handed straight to the layer below as that layer's output
// gradient; every weight gradient still adds over t from T - 1 down to 0, so
// the results are bitwise those of the layer-by-layer backward).  They
// differ in where the forward's outputs wait for the backward:
//   - the register path (bptt_epoch) keeps every layer's output at every
//     step, T * S floats (S = D * W + 1 outputs a step), in registers
//     beside the weights, the sample and the gradients: T * S + 3P live
//     floats, 136 at the default width 2 / depth 2 (P = 17): 148 registers
//     for K5, no stack frame, 12 resident warps per SM.  (A per-thread
//     shared-memory column for the sequence, launches bounded to 5 blocks,
//     measured no faster there: PERF.md.)
//   - the checkpointed path (bptt_epoch_checkpointed), for the builds whose
//     live floats pass 192 (Checkpoints): at width 3 / depth 3 (P = 52) the
//     register path held 676, and ptxas gave K5 255 registers, a 2,224-byte
//     stack and 7,860 spilled bytes, K3's body 12,104 (16.6x and 13.7x their
//     bounds).  The forward keeps only each layer's state at the start of
//     every segment of C steps; the reverse sweep recomputes a segment from
//     its checkpoint into a (C + 1)-step register buffer (rnn_step on the
//     same operands in the same order: bitwise the stored outputs) and runs
//     bptt_step over it, the carries and gradients staying in registers
//     across segments.  The sample and the checkpoints are indexed by the
//     run-time step, so they live in a per-thread Column: the thread's
//     column [slot][threadIdx.x] of the block's dynamic shared memory on
//     the card (a warp's 32 accesses to a slot hit 32 banks), a plain array
//     in the host harness (tests/test_torch_rnn_host.py).  The segment loop
//     stays rolled (#pragma unroll 1): only the C steps of one segment
//     unroll, so the code stays a few thousand instructions.  It costs one
//     more forward an epoch (a third more operations at P = 52).
// K6 keeps rnn_forward / rnn_apply (72-byte stack frame, above half of its
// byte bound).

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

// The shapes of the BPTT of width W / depth D over its own T = P steps.
// On the checkpointed path a segment has C steps: 4, or fewer where a
// register buffer of (C + 1) states of S floats would pass 72 floats (a
// shorter segment is shorter code: at P = 52, C = 4 / 6 / 8 measured K5
// at 7.39 / 7.64 / 7.67 ms and K3's body at 8.64 / 10.21 / 11.05, every
// one at 8 resident warps; PERF.md).  The per-thread column holds the
// sample in slots [0, T) and the checkpoint of segment s at slot(s, l, v):
// layer l's unit v entering the segment.  A build takes that path when the
// register path's live floats pass kLiveMax and its column fits a block's
// shared memory (227 KB, less K3's static 528 bytes): a deep width-1
// stack, whose state S = D + 1 is long, keeps the register path.
template <int W, int D>
struct Checkpoints {
  using R = RNN<W, D>;
  static constexpr int T = R::P;
  static constexpr int S = D * W + 1;  // every layer's outputs at one step
  // the register path holds T * S + 3P live floats (every layer's output at
  // every step, the weights, the sample, the gradients); ptxas allows 255
  // registers a thread, and the default build's 136 take 148
  static constexpr int kLive = T * S + 3 * R::P;
  static constexpr int kLiveMax = 192;
  static constexpr int C = 72 / S - 1 < 1 ? 1 : 72 / S - 1 > 4 ? 4 : 72 / S - 1;
  static constexpr int kSegments = (T + C - 1) / C;
  // a block's 227 KB of shared memory (232,448 bytes), less 1 KB for K3's
  // static arrays, over kThreads columns
  static constexpr int kMaxColumnFloats = (232448 - 1024) / (kThreads * 4);
  static constexpr bool kCheckpointed =
      kLive > kLiveMax && T + kSegments * S <= kMaxColumnFloats;
  static constexpr int kColumnFloats = kCheckpointed ? T + kSegments * S : 0;
  __host__ __device__ static constexpr int slot(int s, int l, int v) {
    return T + s * S + l * W + v;
  }
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
// xt: the sample at t (layer 0's input); cur: every layer's output at t,
// prev: at t - 1 (unused at t = 0); dout
// holds dL/d(layer L's output at t) on entry, dcarry[L] the gradient
// reaching its h_t from step t + 1 (unused at t = T - 1).  Adds the layer's
// weight gradients, leaves its input gradient in dout for layer L - 1 and
// its carry into step t - 1 in dcarry[L].
template <int W, int D, int A, int L>
__device__ __forceinline__ void bptt_step(const float (&w)[RNN<W, D>::P],
                                          float xt, int t,
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
        xi = xt;
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
  if constexpr (L > 0) bptt_step<W, D, A, L - 1>(w, xt, t, cur, prev, dout, dcarry, grads);
}

// One full-batch MSE gradient on the sequence sample ``x`` (T = P), the
// register path: the forward, time-major, keeping every layer's outputs;
// then ONE reverse sweep over time, at each t the layers top down
// (``_bptt_epoch``'s arithmetic, reordered across independent sums only):
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
    bptt_step<W, D, A, R::NL - 1>(w, x[t], t, seq[t], seq[t > 0 ? t - 1 : 0], dout,
                                   dcarry, grads);
  }
  return loss;
}

// rnn_apply_streamed in place on the column: out = f_self(x) with x in the
// column's slots [0, T) on entry and out there on exit, one step a loop
// trip (rolled), so that K3's attack on a checkpointed build runs one
// step's code and not T unrolled steps of it (code that a gated warp ran
// once, from a cold instruction cache); the same operations in the same
// order, so bitwise rnn_apply_streamed's outputs.
template <int W, int D, int A, class Col>
__device__ __forceinline__ void rnn_apply_column(const float (&self)[RNN<W, D>::P],
                                                 const Col& col) {
  using R = RNN<W, D>;
  float h[R::NL][R::MU];
#pragma unroll
  for (int l = 0; l < R::NL; ++l)
#pragma unroll
    for (int v = 0; v < R::MU; ++v) h[l][v] = 0.0f;
#pragma unroll 1
  for (int t = 0; t < R::P; ++t) {
    rnn_step<W, D, A>(self, col[t], h);
    col[t] = h[R::NL - 1][0];
  }
}

// Every layer's state (its outputs at one step) to / from checkpoint s of
// the column; only the units each layer has.
template <int W, int D, class Col>
__device__ __forceinline__ void save_state(const Col& col, int s,
                                           const float (&h)[RNN<W, D>::NL][RNN<W, D>::MU]) {
  using R = RNN<W, D>;
#pragma unroll
  for (int l = 0; l < R::NL; ++l)
#pragma unroll
    for (int v = 0; v < R::units(l); ++v) col[Checkpoints<W, D>::slot(s, l, v)] = h[l][v];
}

template <int W, int D, class Col>
__device__ __forceinline__ void load_state(const Col& col, int s,
                                           float (&h)[RNN<W, D>::NL][RNN<W, D>::MU]) {
  using R = RNN<W, D>;
#pragma unroll
  for (int l = 0; l < R::NL; ++l)
#pragma unroll
    for (int v = 0; v < R::units(l); ++v) h[l][v] = col[Checkpoints<W, D>::slot(s, l, v)];
}

// bptt_epoch on the checkpointed path, the sample in the column's slots
// [0, T).  Segment s covers steps [t0, t0 + C) with t0 = T - (kSegments -
// s) * C, so that the first one (and only it) may start before step 0,
// whose steps below 0 are skipped: the state entering it is the explicit
// zero h_{-1}.  The forward saves the state entering each segment and sums
// the loss; the reverse sweep, last segment first, recomputes the segment's
// outputs from its checkpoint and runs bptt_step over them, top step first.
// The same operations on the same operands in the same order as bptt_epoch:
// bitwise its gradients and loss.
template <int W, int D, int A, class Col>
__device__ __forceinline__ float bptt_epoch_checkpointed(const float (&w)[RNN<W, D>::P],
                                                         const Col& col,
                                                         float (&grads)[RNN<W, D>::P]) {
  using R = RNN<W, D>;
  using K = Checkpoints<W, D>;
  constexpr int T = K::T, C = K::C, NS = K::kSegments;
  float h[R::NL][R::MU];
#pragma unroll
  for (int l = 0; l < R::NL; ++l)
#pragma unroll
    for (int v = 0; v < R::MU; ++v) h[l][v] = 0.0f;
  float loss = 0.0f;
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    const int t0 = T - (NS - s) * C;
    save_state<W, D>(col, s, h);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = t0 + c;
      if (t >= 0) {
        const float xt = col[t];
        rnn_step<W, D, A>(w, xt, h);
        const float err = h[R::NL - 1][0] - xt;
        loss = t == 0 ? err * err : loss + err * err;
      }
    }
  }
  loss = loss / static_cast<float>(T);
#pragma unroll
  for (int p = 0; p < R::P; ++p) grads[p] = 0.0f;
  const float scale = static_cast<float>(2.0 / T);
  float dcarry[R::NL][R::MU];  // read only below step T - 1, after it is set
#pragma unroll
  for (int l = 0; l < R::NL; ++l)
#pragma unroll
    for (int v = 0; v < R::MU; ++v) dcarry[l][v] = 0.0f;
#pragma unroll 1
  for (int s = NS - 1; s >= 0; --s) {
    const int t0 = T - (NS - s) * C;
    float seq[C + 1][R::NL][R::MU];  // seq[c + 1]: the outputs at t0 + c
    float xs[C];
    load_state<W, D>(col, s, seq[0]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int l = 0; l < R::NL; ++l)
#pragma unroll
        for (int v = 0; v < R::MU; ++v) seq[c + 1][l][v] = seq[c][l][v];
      if (t0 + c >= 0) {
        xs[c] = col[t0 + c];
        rnn_step<W, D, A>(w, xs[c], seq[c + 1]);
      }
    }
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const int t = t0 + c;
      if (t >= 0) {
        float dout[R::MU];
        dout[0] = (seq[c + 1][R::NL - 1][0] - xs[c]) * scale;
        bptt_step<W, D, A, R::NL - 1>(w, xs[c], t, seq[c + 1], seq[c], dout, dcarry,
                                       grads);
      }
    }
  }
  return loss;
}

// The checkpointed path's SGD chain: ``learned`` imitation epochs toward
// the sample that the column's slots [0, T) hold on entry, then ``epochs``
// self-training epochs, the sample refreshed from the rows at each epoch
// top.  One copy of the epoch's code serves both: K3's body runs its
// learn_from and its self-training through one call (a second inlined copy
// measured 0.4 ms slower at P = 52: code that a gated warp ran once, from
// a cold instruction cache).  Returns the last epoch's loss (0 when there
// is none).
template <int W, int D, int A, class Col>
__device__ __forceinline__ float rnn_sgd_checkpointed(float (&rows)[RNN<W, D>::P],
                                                      int learned, int epochs,
                                                      float lr, const Col& col) {
  constexpr int P = RNN<W, D>::P;
  float loss = 0.0f;
  for (int e = 0; e < learned + epochs; ++e) {
    if (e >= learned) {
#pragma unroll
      for (int r = 0; r < P; ++r) col[r] = rows[r];
    }
    float grads[P];
    loss = bptt_epoch_checkpointed<W, D, A>(rows, col, grads);
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = rows[r] - lr * grads[r];
  }
  return loss;
}

// ``epochs`` full-batch BPTT-SGD steps (``_sgd_epochs``).  REFRESH:
// self-training, the sample is the rows as they stand at each epoch top;
// else imitation, the sample is ``target``.  Returns the last epoch's loss
// (0 when epochs == 0).  ``col``: the thread's column of
// Checkpoints<W, D>::kColumnFloats floats, which the checkpointed path
// holds the sample and the checkpoints in (the register path ignores it).
template <int W, int D, int A, bool REFRESH, class Col>
__device__ __forceinline__ float rnn_sgd(float (&rows)[RNN<W, D>::P],
                                         const float (&target)[RNN<W, D>::P],
                                         int epochs, float lr, const Col& col) {
  constexpr int P = RNN<W, D>::P;
  if constexpr (Checkpoints<W, D>::kCheckpointed) {
    if (REFRESH) return rnn_sgd_checkpointed<W, D, A>(rows, 0, epochs, lr, col);
#pragma unroll
    for (int r = 0; r < P; ++r) col[r] = target[r];
    return rnn_sgd_checkpointed<W, D, A>(rows, epochs, 0, lr, col);
  } else {
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
