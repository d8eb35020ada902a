// Device code shared by the three weightwise kernels (ww_apply.cu,
// ww_train.cu, generation.cu): the unrolled weightwise MLP, the
// hand-derived batch-1 SGD chain, and that chain in a per-lane sample order
// (sgd_chain_shuffled, K2's shuffled instantiation).  Layout, threading and rounding rules:
// lane_common.cuh.
//
// The topology is template parameters (W = width, D = depth, A =
// activation), so every loop below has a compile-time trip count and unrolls
// into straight-line code over register arrays -- the role that Pallas's
// trace-time topology constants played on the TPU.
//
// What bounds these kernels on an H100 is the FP32 pipe's issue rate: built
// with --fmad=false, every multiply and every add is one instruction.  So the
// normalised duplex coordinates, the inputs c0..c2 of the net's first layer,
// are compile-time constants here (WW::coord, built from the integer
// (layer, cell, index) ids as srnn_tpu_torch/topology.py builds them), never
// a kernel argument: then every product of a coordinate and a weight is
// visible to the compiler, and two savings become exact.  A product with a
// coordinate of 1.0 equals its weight bit for bit, so it is not issued.  And
// one application multiplies the same layer-0 weight by the same
// coordinate value at many points (width 2 / depth 2: 3 layer values, 4 cell
// values and 2 index values over 14 points), so apply_rows takes each such
// product once per application and shares it between the points (12
// multiplies, not 84).  Products with 0.0 stay: 0 * inf is NaN and x + 0 * -y
// can turn -0 into +0.  The host still passes topology.py's table, and the
// entry points refuse a table that differs from WW::coord (coords_match).
//
// The arithmetic mirrors, operation for operation, the JAX package's
// ``pallas_generation._mlp_rows`` / ``apply_rows`` and
// ``pallas_ww_train._sgd_chain``, and this package's plain torch versions of
// them: every rounded product and sum keeps its operands and its order.

#pragma once

#include <string.h>

#include <utility>

#include "lane_common.cuh"

namespace srnn {

// Shapes of the bias-free weightwise MLP 4 -> W -> ... -> W -> 1
// (topology.py: layer_shapes, offsets), and the duplex coordinates of its
// weights (topology.py: weight_coords, normalized_weight_coords).
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
  __host__ __device__ static constexpr int layer_of(int s) {
    int l = 0;
    while (l + 1 < L && s >= offset(l + 1)) ++l;
    return l;
  }
  // Weight s's integer id on axis k (0: layer, 1: cell, 2: index in cell)
  // and the largest id of that axis in its scope.
  __host__ __device__ static constexpr int coord_id(int s, int k) {
    const int l = layer_of(s), r = s - offset(l);
    return k == 0 ? l : k == 1 ? r / fan_out(l) : r % fan_out(l);
  }
  __host__ __device__ static constexpr int coord_scope(int s, int k) {
    const int l = layer_of(s);
    return k == 0 ? L - 1 : k == 1 ? fan_in(l) - 1 : fan_out(l) - 1;
  }
  // The normalised coordinate: a float64 division where the scope's largest
  // id exceeds 1, else the id itself, rounded to float32.
  __host__ __device__ static constexpr float coord(int s, int k) {
    const int id = coord_id(s, k), m = coord_scope(s, k);
    return m > 1 ? static_cast<float>(static_cast<double>(id) / m)
                 : static_cast<float>(id);
  }
  // The first weight whose coordinate on axis k equals weight s's: where
  // an application takes the product that s shares.
  __host__ __device__ static constexpr int first_alike(int s, int k) {
    int f = 0;
    while (coord(f, k) != coord(s, k)) ++f;
    return f;
  }
};

// Coordinate k of weight S, as constants of the device code.
template <int W, int D, int S, int K>
struct Coord {
  static constexpr float value = WW<W, D>::coord(S, K);
  static constexpr bool one = value == 1.0f;
  static constexpr int first = WW<W, D>::first_alike(S, K);
};

// Does the (P, 3) float32 table ``host`` equal WW::coord bit for bit?
template <int W, int D>
inline bool coords_match(const float* host) {
  for (int s = 0; s < WW<W, D>::P; ++s)
    for (int k = 0; k < 3; ++k) {
      const float c = WW<W, D>::coord(s, k);
      if (memcmp(&host[s * 3 + k], &c, sizeof c) != 0) return false;
    }
  return true;
}

// Layer 0's coordinate products of one application of the net ``w``:
// t[s][k][j] = coord(s, k) * w[(k + 1) * W0 + j], filled only at the first
// weight s of each coordinate value other than 1.0 (the other entries are
// never written or read, and the compiler keeps no register for them).
template <int W, int D>
using Layer0Terms = float[WW<W, D>::P][3][WW<W, D>::fan_out(0)];

template <int W, int D, int S, int K>
__device__ __forceinline__ void hoist_axis(const float (&w)[WW<W, D>::P],
                                           Layer0Terms<W, D>& t) {
  using C = Coord<W, D, S, K>;
  constexpr int b = WW<W, D>::fan_out(0);
  if constexpr (C::first == S && !C::one) {
#pragma unroll
    for (int j = 0; j < b; ++j) t[S][K][j] = C::value * w[(K + 1) * b + j];
  }
}

template <int W, int D, int... S>
__device__ __forceinline__ void hoist(const float (&w)[WW<W, D>::P],
                                      Layer0Terms<W, D>& t,
                                      std::integer_sequence<int, S...>) {
  ((hoist_axis<W, D, S, 0>(w, t), hoist_axis<W, D, S, 1>(w, t),
    hoist_axis<W, D, S, 2>(w, t)), ...);
}

// coord(S, K) * w[(K + 1) * W0 + j], the term of point S's coordinate K in
// layer 0's column j: the weight itself where the coordinate is 1.0, else
// the product that the application took once.
template <int W, int D, int S, int K>
__device__ __forceinline__ float coord_term(const float (&w)[WW<W, D>::P],
                                            const Layer0Terms<W, D>& t,
                                            int j) {
  using C = Coord<W, D, S, K>;
  if constexpr (C::one) {
    return w[(K + 1) * WW<W, D>::fan_out(0) + j];
  } else {
    return t[C::first][K][j];
  }
}

// Layers 1..L-1 of the net ``w`` on the activations ``h`` (in place).
template <int W, int D, int A>
__device__ __forceinline__ void upper_layers(const float (&w)[WW<W, D>::P],
                                             float (&h)[WW<W, D>::M]) {
  using T = WW<W, D>;
#pragma unroll
  for (int l = 1; l < T::L; ++l) {
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
}

// The MLP with weights ``w`` on duplex point S, [x, c0, c1, c2], its layer-0
// coordinate terms taken from ``t``.
template <int W, int D, int A, int S>
__device__ __forceinline__ float mlp_point(const float (&w)[WW<W, D>::P],
                                           float x,
                                           const Layer0Terms<W, D>& t) {
  using T = WW<W, D>;
  float h[T::M];
#pragma unroll
  for (int j = 0; j < T::fan_out(0); ++j) {
    float acc = x * w[j];
    acc = acc + coord_term<W, D, S, 0>(w, t, j);
    acc = acc + coord_term<W, D, S, 1>(w, t, j);
    acc = acc + coord_term<W, D, S, 2>(w, t, j);
    h[j] = act<A>(acc);
  }
  upper_layers<W, D, A>(w, h);
  return h[0];
}

template <int W, int D, int A, int... S>
__device__ __forceinline__ void apply_points(
    const float (&self)[WW<W, D>::P], const float (&x)[WW<W, D>::P],
    float (&out)[WW<W, D>::P], const Layer0Terms<W, D>& t,
    std::integer_sequence<int, S...>) {
  ((out[S] = mlp_point<W, D, A, S>(self, x[S], t)), ...);
}

// out[s] = f_self(point(x[s])) for every weight s: one self-application
// (self == x) or one attack (self = attacker, x = victim).  Layer 0's
// coordinate products are taken once, then the P points.
template <int W, int D, int A>
__device__ __forceinline__ void apply_rows(const float (&self)[WW<W, D>::P],
                                           const float (&x)[WW<W, D>::P],
                                           float (&out)[WW<W, D>::P]) {
  constexpr auto points = std::make_integer_sequence<int, WW<W, D>::P>{};
  Layer0Terms<W, D> t;
  hoist<W, D>(self, t, points);
  apply_points<W, D, A>(self, x, out, t, points);
}

// Layer 0's input feature K + 1 of sample S, c_K, times ``v``: ``v`` itself
// where c_K is 1.0.
template <int W, int D, int S, int K>
__device__ __forceinline__ float times_coord(float v) {
  using C = Coord<W, D, S, K>;
  if constexpr (C::one) {
    return v;
  } else {
    return C::value * v;
  }
}

// One batch-1 SGD step on sample S with weight feature ``x`` (and target
// ``x``): forward, loss, the hand-derived backward, the update of every row.
//   dL/dpred = 2 (pred - y);  dz[j] = dh[j] act'(h[j]);
//   dL/dW[i][j] = dz[j] h_prev[i];  dh_prev[i] = sum_j dz[j] W[i][j].
template <int W, int D, int A, int S>
__device__ __forceinline__ void sgd_step(float (&rows)[WW<W, D>::P], float x,
                                         float& loss_acc, float lr) {
  using T = WW<W, D>;
  constexpr int P = T::P, b0 = T::fan_out(0);
  // forward, keeping every layer's post-activations for the backward; the
  // coordinate features are constants, acts[0] holds only x
  float acts[T::L + 1][T::M];
  acts[0][0] = x;
#pragma unroll
  for (int j = 0; j < b0; ++j) {
    float acc = x * rows[j];
    acc = acc + times_coord<W, D, S, 0>(rows[b0 + j]);
    acc = acc + times_coord<W, D, S, 1>(rows[2 * b0 + j]);
    acc = acc + times_coord<W, D, S, 2>(rows[3 * b0 + j]);
    acts[1][j] = act<A>(acc);
  }
#pragma unroll
  for (int l = 1; l < T::L; ++l) {
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
  for (int li = T::L - 1; li >= 1; --li) {
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
  // layer 0: its input gradient is never read; its weights' gradients are
  // dz[j] times the sample's features
  if constexpr (A != LINEAR) {
#pragma unroll
    for (int j = 0; j < b0; ++j) dh[j] = act_grad_mul<A>(dh[j], acts[1][j]);
  }
#pragma unroll
  for (int j = 0; j < b0; ++j) {
    grads[j] = dh[j] * x;
    grads[b0 + j] = times_coord<W, D, S, 0>(dh[j]);
    grads[2 * b0 + j] = times_coord<W, D, S, 1>(dh[j]);
    grads[3 * b0 + j] = times_coord<W, D, S, 2>(dh[j]);
  }
#pragma unroll
  for (int r = 0; r < P; ++r) rows[r] = rows[r] - lr * grads[r];
}

// sgd_step on a sample whose coordinates c[0..2] are known only at run time
// (sgd_chain_shuffled): the same rounded operations, every coordinate
// product issued (IEEE gives 1.0 * v == v, and a product with 0.0 is
// issued in both).  A twin of sgd_step rather than a body shared with it,
// so that the unshuffled instantiations keep their SASS byte for byte.
template <int W, int D, int A>
__device__ __forceinline__ void sgd_step_rt(float (&rows)[WW<W, D>::P],
                                            float x, const float (&c)[3],
                                            float& loss_acc, float lr) {
  using T = WW<W, D>;
  constexpr int P = T::P, b0 = T::fan_out(0);
  // forward, keeping every layer's post-activations for the backward;
  // acts[0] holds only x
  float acts[T::L + 1][T::M];
  acts[0][0] = x;
#pragma unroll
  for (int j = 0; j < b0; ++j) {
    float acc = x * rows[j];
    acc = acc + c[0] * rows[b0 + j];
    acc = acc + c[1] * rows[2 * b0 + j];
    acc = acc + c[2] * rows[3 * b0 + j];
    acts[1][j] = act<A>(acc);
  }
#pragma unroll
  for (int l = 1; l < T::L; ++l) {
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
  for (int li = T::L - 1; li >= 1; --li) {
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
  // layer 0: its input gradient is never read; its weights' gradients are
  // dz[j] times the sample's features
  if constexpr (A != LINEAR) {
#pragma unroll
    for (int j = 0; j < b0; ++j) dh[j] = act_grad_mul<A>(dh[j], acts[1][j]);
  }
#pragma unroll
  for (int j = 0; j < b0; ++j) {
    grads[j] = dh[j] * x;
    grads[b0 + j] = c[0] * dh[j];
    grads[2 * b0 + j] = c[1] * dh[j];
    grads[3 * b0 + j] = c[2] * dh[j];
  }
#pragma unroll
  for (int r = 0; r < P; ++r) rows[r] = rows[r] - lr * grads[r];
}

template <int W, int D, int A, int... S>
__device__ __forceinline__ float sgd_epoch(float (&rows)[WW<W, D>::P],
                                           const float (&snap)[WW<W, D>::P],
                                           float lr,
                                           std::integer_sequence<int, S...>) {
  float loss_acc = 0.0f;
  (sgd_step<W, D, A, S>(rows, snap[S], loss_acc, lr), ...);
  return loss_acc;
}

// ``epochs`` passes of batch-1 SGD over the P samples, in enumeration order,
// on the registers ``rows``.  REFRESH: self-training, the samples are the
// rows as they stand at the top of each epoch; else imitation, the samples
// are the fixed ``target``.  Returns the last epoch's mean pre-update loss
// (0 when epochs == 0).
template <int W, int D, int A, bool REFRESH>
__device__ __forceinline__ float sgd_chain(float (&rows)[WW<W, D>::P],
                                           const float (&target)[WW<W, D>::P],
                                           int epochs, float lr) {
  constexpr int P = WW<W, D>::P;
  float last = 0.0f;
  float snap[P];
  for (int e = 0; e < epochs; ++e) {
#pragma unroll
    for (int r = 0; r < P; ++r) snap[r] = REFRESH ? rows[r] : target[r];
    const float loss_acc = sgd_epoch<W, D, A>(
        rows, snap, lr, std::make_integer_sequence<int, P>{});
    last = loss_acc / static_cast<float>(P);
  }
  return last;
}

// sgd_chain in a per-lane sample order, keras' shuffled epoch: step j of
// epoch e trains on sample order[(e * P + j) * order_stride].  A runtime
// index into a register array would send it to local memory, so the
// sample's weight feature and coordinates are read from memory the caller
// gives: ``snap``, this lane's snapshot (P values ``snap_stride`` apart; the
// kernel gives each thread a column of shared memory, conflict-free), and
// ``coords``, the (P, 3) table (the block's, in shared memory).  An epoch's
// P order bytes are loaded at its top, all at once, so that their latency
// is paid once an epoch and the unrolled steps read them from registers.
// Every rounded operation is sgd_chain's on the ordered samples.
template <int W, int D, int A, bool REFRESH>
__device__ __forceinline__ float sgd_chain_shuffled(
    float (&rows)[WW<W, D>::P], const float (&target)[WW<W, D>::P],
    float* snap, int snap_stride, const unsigned char* order,
    long long order_stride, const float* coords, int epochs, float lr) {
  constexpr int P = WW<W, D>::P;
  float last = 0.0f;
  if constexpr (!REFRESH) {
#pragma unroll
    for (int r = 0; r < P; ++r) snap[r * snap_stride] = target[r];
  }
  for (int e = 0; e < epochs; ++e) {
    const unsigned char* step_order =
        order + static_cast<long long>(e) * P * order_stride;
    int ord[P];
#pragma unroll
    for (int j = 0; j < P; ++j) ord[j] = step_order[j * order_stride];
    if constexpr (REFRESH) {
#pragma unroll
      for (int r = 0; r < P; ++r) snap[r * snap_stride] = rows[r];
    }
    float loss_acc = 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = ord[j];
      const float c[3] = {coords[3 * s], coords[3 * s + 1], coords[3 * s + 2]};
      sgd_step_rt<W, D, A>(rows, snap[s * snap_stride], c, loss_acc, lr);
    }
    last = loss_acc / static_cast<float>(P);
  }
  return last;
}

}  // namespace srnn
