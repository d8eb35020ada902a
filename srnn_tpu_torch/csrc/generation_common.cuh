// The skeleton of K3, one whole soup generation in one launch -- masked
// attack, learn_from with the counterpart's attack recomputed,
// self-training, and the respawn predicates with the fresh column selected
// for dead lanes -- shared by the variant bodies (generation.cu weightwise,
// generation_kvec.cu aggregating/fft, generation_rnn.cu recurrent).
//
// Replaces the Pallas TPU kernel srnn_tpu/ops/pallas_generation.py,
// generation_popmajor -> _generation_popmajor (body
// _make_generation_kernel), float32 and bfloat16 populations.
//
// Population dtype: the skeleton is a template of the population operands'
// type Pop (float, or __nv_bfloat16 for population_dtype='bf16'): wT, the
// attacker, imitation-target and target-attacker columns, and the output.
// Every load upcasts to float (exact), every phase computes in float, and
// the store rounds once, to nearest even (__float2bfloat16_rn, as torch's
// .to(torch.bfloat16) does), the same once-per-generation rounding point as
// the phase chain (pallas_generation.py's mixed-precision contract).  The
// fresh replacements, the loss and the dead masks stay float32 / int32.  The
// bfloat16 instantiations live in their own sources (generation*_bf16.cu),
// so that the longest nvcc of the build does not grow.
//
// Design: one thread per particle, every operand column loaded straight into
// registers, every phase run on the resident rows, one write back -- the
// population crosses device memory once per generation, as the Pallas
// megakernel's block did through VMEM.  The phase gates are per-lane ints: a
// lane whose gate is off skips that phase (the JAX kernel computed it and
// discarded it with a where; the result is the same).  A warp runs a phase
// when any of its 32 lanes is gated, so at the paper's rates (0.1) about
// 1 - 0.9^32 = 97% of warps would run the attack and the learn work with
// most lanes idle.  The weightwise and recurrent bodies opt in
// (B::kSortGated) to dealing each block's lanes to its threads gated first
// (deal_lane), so that those phases run in about one warp of the four; the
// k-vector body, whose training is cheap beside its memory traffic, does
// not.  The learner's imitation target is recomputed to its post-attack
// value in-thread from the target's pre-attack column and its attacker's
// column, so no mid-generation round trip through device memory is needed.
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

#include <cuda_bf16.h>

#include <type_traits>

#include "lane_common.cuh"

namespace srnn {

__device__ __forceinline__ float load_f32(const float* p, long long k) { return p[k]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long k) {
  return __bfloat162float(p[k]);
}
__device__ __forceinline__ void store_pop(float* p, long long k, float v) { p[k] = v; }
__device__ __forceinline__ void store_pop(__nv_bfloat16* p, long long k, float v) {
  p[k] = __float2bfloat16_rn(v);
}

template <class Pop>
struct GenArgs {
  const int* gates;    // (3, n): has_attacker, learn_gate, other_attacked
  const Pop* wT;       // (P, n) start-of-generation population
  const float* fresh;  // (P, n) respawn replacements
  const Pop* atk;      // (P, n) attacker columns, or null: no attack phase
  const Pop* oth;      // (P, n) imitation targets (pre-attack), or null
  const Pop* oatk;     // (P, n) the targets' attackers, or null
  Pop* out;            // (P, n)
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

// The lane this thread runs.  Unsorted: its own.  SORT: the block's lanes
// dealt to its threads gated first -- the learners, then the other attacked
// lanes, then the rest (each group in no set order) -- so that the gated
// phases run in the first warp or so while the other warps go straight to
// self-training.  Every lane's arithmetic is its own either way, so the
// results are the same bitwise.
template <bool SORT, class Pop>
__device__ __forceinline__ long long deal_lane(const GenArgs<Pop>& g) {
  const long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
  if constexpr (!SORT) {
    return base + threadIdx.x;
  } else {
    const long long n = g.n;
    const long long mine = base + threadIdx.x;
    __shared__ int count[3];  // learners, other attacked lanes, the rest
    __shared__ int order[kThreads];
    if (threadIdx.x < 3) count[threadIdx.x] = 0;
    __syncthreads();
    int group = 2;
    if (mine < n) {
      if (g.oth != nullptr && g.severity > 0 && g.gates[lane(1, n, mine)] != 0) {
        group = 0;
      } else if (g.atk != nullptr && g.gates[lane(0, n, mine)] != 0) {
        group = 1;
      }
    }
    const int ticket = atomicAdd(&count[group], 1);
    __syncthreads();
    order[(group > 0 ? count[0] : 0) + (group > 1 ? count[1] : 0) + ticket] =
        threadIdx.x;
    __syncthreads();
    return base + order[threadIdx.x];
  }
}

template <class B, class = void>
struct SortGated : std::false_type {};
template <class B>
struct SortGated<B, std::void_t<decltype(B::kSortGated)>>
    : std::bool_constant<B::kSortGated> {};

template <class B, class Pop, bool SORT>
__global__ void __launch_bounds__(kThreads)
generation_kernel(GenArgs<Pop> g, typename B::Consts co) {
  constexpr int P = B::P;
  const long long n = g.n;
  const long long i = deal_lane<SORT>(g);
  if (i >= n) return;
  float rows[P];
#pragma unroll
  for (int r = 0; r < P; ++r) rows[r] = load_f32(g.wT, lane(r, n, i));

  // attack: the gated lanes are rewritten by their attacker's net
  if (g.atk != nullptr && g.gates[lane(0, n, i)] != 0) {
    float a[P], t[P];
#pragma unroll
    for (int r = 0; r < P; ++r) a[r] = load_f32(g.atk, lane(r, n, i));
    B::apply(a, rows, t, co);
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = t[r];
  }

  // learn_from: imitate the counterpart as it stands after this
  // generation's attack
  if (g.oth != nullptr && g.severity > 0 && g.gates[lane(1, n, i)] != 0) {
    float o[P];
#pragma unroll
    for (int r = 0; r < P; ++r) o[r] = load_f32(g.oth, lane(r, n, i));
    if (g.oatk != nullptr && g.gates[lane(2, n, i)] != 0) {
      float a[P], t[P];
#pragma unroll
      for (int r = 0; r < P; ++r) a[r] = load_f32(g.oatk, lane(r, n, i));
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
    store_pop(g.out, k, dead ? g.fresh[k] : rows[r]);
  }
  g.loss[i] = last;
  g.dead[lane(0, n, i)] = div ? 1 : 0;
  g.dead[lane(1, n, i)] = zero ? 1 : 0;
}

template <class B, class Pop>
inline int launch_generation(const GenArgs<Pop>& g,
                             const typename B::Consts& co, void* stream) {
  generation_kernel<B, Pop, SortGated<B>::value><<<blocks_for(g.n), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(g, co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace srnn

// The C entry points' common head: the GenArgs<Pop> fields, in order.
#define SRNN_GEN_PARAMS(Pop)                                              \
  const int *gates, const Pop *wT, const float *fresh, const Pop *atk,   \
      const Pop *oth, const Pop *oatk, Pop *out, float *loss, int *dead, \
      long long n, int severity, int train, float lr, float eps,         \
      int remove_divergent, int remove_zero
#define SRNN_GEN_ARGS(Pop)                                                \
  srnn::GenArgs<Pop> {                                                    \
    gates, wT, fresh, atk, oth, oatk, out, loss, dead, n, severity, train, \
        lr, eps, remove_divergent, remove_zero                            \
  }

// A body source's population type and entry-point names: float32 unless a
// generation*_bf16.cu source defines SRNN_GEN_BF16 before including it.
#ifdef SRNN_GEN_BF16
#define SRNN_GEN_POP __nv_bfloat16
#define SRNN_GEN_ENTRY(name) name##_bf16
#else
#define SRNN_GEN_POP float
#define SRNN_GEN_ENTRY(name) name
#endif
