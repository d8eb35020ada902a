// The skeleton of K3, one whole soup generation in one launch -- masked
// attack, learn_from with the counterpart's attack recomputed,
// self-training, and the respawn predicates with the fresh column selected
// for dead lanes -- shared by the variant bodies (generation.cu weightwise,
// generation_kvec.cu aggregating/fft, generation_rnn.cu recurrent).
//
// Replaces the Pallas TPU kernel srnn_tpu/ops/pallas_generation.py,
// generation_popmajor -> _generation_popmajor (body
// _make_generation_kernel), float32 bodies.
//
// Design: one thread per particle, every operand column loaded straight into
// registers, every phase run on the resident rows, one write back -- the
// population crosses device memory once per generation, as the Pallas
// megakernel's block did through VMEM.  The phase gates are per-lane ints: a
// lane whose gate is off skips that phase (the JAX kernel computed it and
// discarded it with a where; the result is the same), so at the paper's
// rates most warps skip the attack and learn work.  The learner's imitation
// target is recomputed to its post-attack value in-thread from the target's
// pre-attack column and its attacker's column, so no mid-generation round
// trip through device memory is needed.
//
// A body B (the role of pallas_generation.apply_rows / _chain_for) gives:
//   B::P                              the particle's weight count;
//   B::Consts                         its constant tables, passed by value;
//   B::apply(self, x, out, co)        the attack transform, out = f_self(x);
//   B::learn(rows, other, e, lr, co)  e imitation epochs toward ``other``
//                                     (its sample derived once);
//   B::train(rows, e, lr, co)         e self-training epochs, the sample
//                                     refreshed at each epoch top; returns
//                                     the last epoch's loss (0 for e = 0).

#pragma once

#include "lane_common.cuh"

namespace srnn {

struct GenArgs {
  const int* gates;    // (3, n): has_attacker, learn_gate, other_attacked
  const float* wT;     // (P, n) start-of-generation population
  const float* fresh;  // (P, n) respawn replacements
  const float* atk;    // (P, n) attacker columns, or null: no attack phase
  const float* oth;    // (P, n) imitation targets (pre-attack), or null
  const float* oatk;   // (P, n) the targets' attackers, or null
  float* out;          // (P, n)
  float* loss;         // (n,) last self-training epoch's loss
  int* dead;           // (2, n): divergent, zero
  long long n;
  int severity;        // learn_from epochs (0: no learn phase)
  int train;           // self-training epochs
  float lr;
  float eps;
  int remove_divergent;
  int remove_zero;
};

template <class B>
__global__ void __launch_bounds__(kThreads)
generation_kernel(GenArgs g, typename B::Consts co) {
  constexpr int P = B::P;
  const long long n = g.n;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float rows[P];
#pragma unroll
  for (int r = 0; r < P; ++r) rows[r] = g.wT[lane(r, n, i)];

  // attack: the gated lanes are rewritten by their attacker's net
  if (g.atk != nullptr && g.gates[lane(0, n, i)] != 0) {
    float a[P], t[P];
#pragma unroll
    for (int r = 0; r < P; ++r) a[r] = g.atk[lane(r, n, i)];
    B::apply(a, rows, t, co);
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = t[r];
  }

  // learn_from: imitate the counterpart as it stands after this
  // generation's attack
  if (g.oth != nullptr && g.severity > 0 && g.gates[lane(1, n, i)] != 0) {
    float o[P];
#pragma unroll
    for (int r = 0; r < P; ++r) o[r] = g.oth[lane(r, n, i)];
    if (g.oatk != nullptr && g.gates[lane(2, n, i)] != 0) {
      float a[P], t[P];
#pragma unroll
      for (int r = 0; r < P; ++r) a[r] = g.oatk[lane(r, n, i)];
      B::apply(a, o, t, co);
#pragma unroll
      for (int r = 0; r < P; ++r) o[r] = t[r];
    }
    B::learn(rows, o, g.severity, g.lr, co);
  }

  // self-training, sample refreshed at each epoch top
  const float last = B::train(rows, g.train, g.lr, co);

  // respawn: divergent first, then zero among the finite
  bool div = false;
  if (g.remove_divergent) {
#pragma unroll
    for (int r = 0; r < P; ++r) div = div || !isfinite(rows[r]);
  }
  bool zero = false;
  if (g.remove_zero) {
    zero = true;
#pragma unroll
    for (int r = 0; r < P; ++r) zero = zero && rows[r] >= -g.eps && rows[r] <= g.eps;
    zero = zero && !div;
  }
  const bool dead = div || zero;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const long long k = lane(r, n, i);
    g.out[k] = dead ? g.fresh[k] : rows[r];
  }
  g.loss[i] = last;
  g.dead[lane(0, n, i)] = div ? 1 : 0;
  g.dead[lane(1, n, i)] = zero ? 1 : 0;
}

template <class B>
inline int launch_generation(const GenArgs& g, const typename B::Consts& co,
                             void* stream) {
  generation_kernel<B><<<blocks_for(g.n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(g, co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace srnn

// The C entry points' common head: the GenArgs fields, in order.
#define SRNN_GEN_PARAMS                                                     \
  const int *gates, const float *wT, const float *fresh, const float *atk, \
      const float *oth, const float *oatk, float *out, float *loss,        \
      int *dead, long long n, int severity, int train, float lr, float eps, \
      int remove_divergent, int remove_zero
#define SRNN_GEN_ARGS                                                     \
  srnn::GenArgs {                                                         \
    gates, wT, fresh, atk, oth, oatk, out, loss, dead, n, severity, train, \
        lr, eps, remove_divergent, remove_zero                            \
  }
