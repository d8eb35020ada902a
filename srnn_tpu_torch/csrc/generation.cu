// K3: one whole weightwise soup generation in one launch -- masked attack,
// learn_from with the counterpart's attack recomputed, self-training, and
// the respawn predicates with the fresh column selected for dead lanes.
//
// Replaces the Pallas TPU kernel srnn_tpu/ops/pallas_generation.py,
// generation_popmajor -> _generation_popmajor (body
// _make_generation_kernel), weightwise float32 body only.
//
// What bounds it on an H100: arithmetic.  Every particle runs ``train``
// epochs of the 14-sample SGD chain (about 1.1e3 operations an epoch), the
// learners add ``severity`` epochs more, and the attacked lanes one
// application (322 operations).  At N = 1M, train = 10, severity = 1 and
// rates 0.1 that is about 1.2e10 operations against about 360 MB moved
// (five (14, N) float32 inputs, the gates, the outputs).
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
// trip through device memory is needed.  ptxas' register report for this
// kernel is printed by chip_smoke.py (the build log); a spill costs local
// memory traffic and is written down in PERF.md.

#include "ww_common.cuh"

namespace {

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

template <int W, int D, int A>
__global__ void __launch_bounds__(srnn::kThreads)
generation_kernel(GenArgs g, srnn::Coords<srnn::WW<W, D>::P> co) {
  constexpr int P = srnn::WW<W, D>::P;
  const long long n = g.n;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float rows[P];
#pragma unroll
  for (int r = 0; r < P; ++r) rows[r] = g.wT[srnn::lane(r, n, i)];

  // attack: the gated lanes are rewritten by their attacker's net
  if (g.atk != nullptr && g.gates[srnn::lane(0, n, i)] != 0) {
    float a[P], t[P];
#pragma unroll
    for (int r = 0; r < P; ++r) a[r] = g.atk[srnn::lane(r, n, i)];
    srnn::apply_rows<W, D, A>(a, rows, t, co);
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = t[r];
  }

  // learn_from: imitate the counterpart as it stands after this
  // generation's attack
  if (g.oth != nullptr && g.severity > 0 && g.gates[srnn::lane(1, n, i)] != 0) {
    float o[P];
#pragma unroll
    for (int r = 0; r < P; ++r) o[r] = g.oth[srnn::lane(r, n, i)];
    if (g.oatk != nullptr && g.gates[srnn::lane(2, n, i)] != 0) {
      float a[P], t[P];
#pragma unroll
      for (int r = 0; r < P; ++r) a[r] = g.oatk[srnn::lane(r, n, i)];
      srnn::apply_rows<W, D, A>(a, o, t, co);
#pragma unroll
      for (int r = 0; r < P; ++r) o[r] = t[r];
    }
    srnn::sgd_chain<W, D, A, false>(rows, o, g.severity, g.lr, co);
  }

  // self-training, snapshot refreshed at each epoch top
  const float last = srnn::sgd_chain<W, D, A, true>(rows, rows, g.train, g.lr, co);

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
    const long long k = srnn::lane(r, n, i);
    g.out[k] = dead ? g.fresh[k] : rows[r];
  }
  g.loss[i] = last;
  g.dead[srnn::lane(0, n, i)] = div ? 1 : 0;
  g.dead[srnn::lane(1, n, i)] = zero ? 1 : 0;
}

}  // namespace

// Pointers as in GenArgs (device arrays; null disables a phase); coords:
// (P, 3) float32 host array.  Returns cudaGetLastError().
extern "C" int srnn_ww_generation(const int* gates, const float* wT,
                                  const float* fresh, const float* atk,
                                  const float* oth, const float* oatk,
                                  float* out, float* loss, int* dead,
                                  long long n, int severity, int train,
                                  float lr, float eps, int remove_divergent,
                                  int remove_zero, int width, int depth,
                                  int act_code, const float* coords,
                                  void* stream) {
  if (width != 2 || depth != 2 || n <= 0 || severity < 0 || train < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = 2, D = 2;
  const GenArgs g{gates, wT, fresh, atk, oth, oatk, out, loss, dead, n,
                  severity, train, lr, eps, remove_divergent, remove_zero};
  const auto co = srnn::load_coords<srnn::WW<W, D>::P>(coords);
  const auto s = static_cast<cudaStream_t>(stream);
  SRNN_DISPATCH_ACT(act_code,
      generation_kernel<W, D, A><<<srnn::blocks_for(n), srnn::kThreads, 0, s>>>(
          g, co));
  return static_cast<int>(cudaGetLastError());
}
