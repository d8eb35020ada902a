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
// most lanes idle.  So each block's lanes are dealt to its threads gated
// first (deal_lane), and those phases run in about one warp of the four.
// A dealt warp's loads and stores of a population row then spread over the
// block's 128 columns; the k-vector body, whose training is short beside
// its memory traffic, opts in (B::kStageTile) to staging the block's tile
// through shared memory so that they stay coalesced (generation_kernel's
// STAGE).  The learner's imitation target is recomputed to its post-attack
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
//                                     the last epoch's loss (0 for e = 0);
//   B::kStageTile                     optional, false when absent: stage
//                                     the block's tile (STAGE below);
//   B::kParkRows                      optional, false when absent (needs
//                                     kStageTile): the lane's rows wait in
//                                     the dealt thread's own column of the
//                                     tile through the gated phases (PARK
//                                     below); B::apply then takes views
//                                     that read a row where it is used
//                                     (the attacker's, the target's
//                                     column: PopColumn, the tile's:
//                                     Column) and, instead of B::learn,
//                                     B::learn_parked(col, other, e, lr,
//                                     co) reads the rows from the tile
//                                     column ``col`` and writes them back;
//   B::kColumnFloats                  optional, 0 when absent: the floats
//                                     of dynamic shared memory a thread
//                                     gets (its column, [slot][threadIdx.x]);
//   B::kStagedLearn                   optional, false when absent: instead
//                                     of B::learn, B::stage(other, co)
//                                     keeps a learner's target and
//                                     B::train(rows, l, e, lr, co) runs its
//                                     l imitation epochs before the e
//                                     self-training ones, one chain;
//   B::kOneAttackSite                 optional, false when absent (needs
//                                     kStagedLearn): the attack and the
//                                     learner's recomputed target run one
//                                     call site, a two-pass loop that
//                                     stages each operand (B::stage),
//                                     transforms it where it is staged
//                                     (B::apply_staged(self, co)) and, for
//                                     the attack, takes it back
//                                     (B::unstage(rows, co)); the learner's
//                                     target stays staged for B::train;
//   B::kBlockSetup                    optional, false when absent:
//                                     B::setup_block(co), run by every
//                                     thread before the deal, fills the
//                                     block's shared tables (the deal's
//                                     barriers publish them).

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

// A lane's column of a (P, n) population in device memory, each row read
// where it is used (PARK's operands).
template <class Pop>
struct PopColumn {
  const Pop* p;
  long long n, i;
  __device__ __forceinline__ float operator[](int r) const { return load_f32(p, lane(r, n, i)); }
};

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

// The lane this thread runs: the block's lanes dealt to its threads gated
// first -- the learners, then the other attacked lanes, then the rest (each
// group in no set order) -- so that the gated phases run in the first warp
// or so while the other warps go straight to self-training.  Every lane's
// arithmetic is its own, so the results are the same bitwise whichever
// thread runs it.
template <class Pop>
__device__ __forceinline__ long long deal_lane(const GenArgs<Pop>& g) {
  const long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
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

template <class B, class = void>
struct StageTile : std::false_type {};
template <class B>
struct StageTile<B, std::void_t<decltype(B::kStageTile)>>
    : std::bool_constant<B::kStageTile> {};

template <class B, class = void>
struct StagedLearn : std::false_type {};
template <class B>
struct StagedLearn<B, std::void_t<decltype(B::kStagedLearn)>>
    : std::bool_constant<B::kStagedLearn> {};

template <class B, class = void>
struct OneAttackSite : std::false_type {};
template <class B>
struct OneAttackSite<B, std::void_t<decltype(B::kOneAttackSite)>>
    : std::bool_constant<B::kOneAttackSite> {};

template <class B, class = void>
struct BlockSetup : std::false_type {};
template <class B>
struct BlockSetup<B, std::void_t<decltype(B::kBlockSetup)>>
    : std::bool_constant<B::kBlockSetup> {};

template <class B, class = void>
struct ParkRows : std::false_type {};
template <class B>
struct ParkRows<B, std::void_t<decltype(B::kParkRows)>>
    : std::bool_constant<B::kParkRows> {};

template <class B, class = void>
struct ColumnFloats : std::integral_constant<int, 0> {};
template <class B>
struct ColumnFloats<B, std::void_t<decltype(B::kColumnFloats)>>
    : std::integral_constant<int, B::kColumnFloats> {};

// STAGE (B::kStageTile): the block's (P, kThreads) tile of the population,
// and its loss and dead masks, cross device memory through shared memory.  Every thread loads and stores its own column, so each
// warp's access to a row stays one contiguous 128 bytes (4 sectors), and
// the dealt thread reads and writes its lane's column of the tile; dealt
// straight from device memory, a warp's access to a row spans the block's
// 128 columns (up to 16 sectors).  The gated operand columns (attacker,
// target, its attacker) are read by the dealt thread, sparse either way.
template <int P>
struct StagedTile {
  float rows[P][kThreads];
  float loss[kThreads];
  int dead[2][kThreads];
};

// PARK (B::kParkRows, on a staged tile): a lane's rows in registers through
// the gated phases would sit beside the attacker's rows and, for a learner,
// its target's and that target's attacker's -- three or four P-long arrays
// at once, which set the whole kernel's registers.  Parked, they wait in
// the tile, and the gated phases read every operand where they use it:
// the attack reduces the rows from the tile before it reads the attacker's
// weights from device memory, and writes its result back to the tile; a
// learner's target is transformed the same way, reduced to its sample, and
// only then are the rows read for the imitation epochs.  The tile holds
// them in the dealt thread's own column (a thread dealt past the end
// copies the last lane's there first), so no two threads write one
// column.

// The block's staged tile (a function's shared memory, so that a kernel
// that does not stage declares none).
template <int P>
__device__ __forceinline__ StagedTile<P>& staged_tile() {
  __shared__ StagedTile<P> tile;
  return tile;
}

// Column c of the block's staged tile, row r at [r].
template <int P>
__device__ __forceinline__ Column<kThreads> tile_column(int c) {
  return {&staged_tile<P>().rows[0][c]};
}

template <class B, class Pop, bool STAGE>
__global__ void __launch_bounds__(kThreads)
generation_kernel(GenArgs<Pop> g, typename B::Consts co) {
  constexpr int P = B::P;
  const long long n = g.n;
  const long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
  if constexpr (STAGE) {
    const long long mine = base + threadIdx.x;
    if (mine < n) {
#pragma unroll
      for (int r = 0; r < P; ++r)
        staged_tile<P>().rows[r][threadIdx.x] = load_f32(g.wT, lane(r, n, mine));
    }
  }
  if constexpr (BlockSetup<B>::value) B::setup_block(co);
  const long long dealt = deal_lane(g);  // its barriers publish the tile
  if constexpr (!STAGE) {
    if (dealt >= n) return;
  }
  // a staged block's threads all reach its barriers: a thread dealt a
  // column past the end runs the last lane's phases and keeps nothing
  const long long i = STAGE && dealt >= n ? n - 1 : dealt;
  constexpr bool PARK = ParkRows<B>::value;
  static_assert(!PARK || (STAGE && !OneAttackSite<B>::value && !StagedLearn<B>::value),
                "kParkRows parks the rows in the staged tile");
  [[maybe_unused]] const int own = static_cast<int>(dealt - base);  // PARK's column
  float rows[P];
  if constexpr (PARK) {
    if (dealt >= n) {
      const Column<kThreads> parked = tile_column<P>(own);
#pragma unroll
      for (int r = 0; r < P; ++r) parked[r] = staged_tile<P>().rows[r][i - base];
    }
    __syncthreads();  // every column read before any is overwritten
  } else if constexpr (STAGE) {
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = staged_tile<P>().rows[r][i - base];
    __syncthreads();  // every column read before any is overwritten
  } else {
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = load_f32(g.wT, lane(r, n, i));
  }

  // attack: the gated lanes are rewritten by their attacker's net (on a
  // body with one attack call site, pass 0 below)
  if constexpr (!OneAttackSite<B>::value) {
    if constexpr (PARK) {
      if (g.atk != nullptr && g.gates[lane(0, n, i)] != 0) {
        const Column<kThreads> parked = tile_column<P>(own);
        float t[P];
        B::apply(PopColumn<Pop>{g.atk, n, i}, parked, t, co);
#pragma unroll
        for (int r = 0; r < P; ++r) parked[r] = t[r];
      }
    } else if (g.atk != nullptr && g.gates[lane(0, n, i)] != 0) {
      float a[P], t[P];
#pragma unroll
      for (int r = 0; r < P; ++r) a[r] = load_f32(g.atk, lane(r, n, i));
      B::apply(a, rows, t, co);
#pragma unroll
      for (int r = 0; r < P; ++r) rows[r] = t[r];
    }
  }

  // learn_from: imitate the counterpart as it stands after this
  // generation's attack
  int learned = 0;  // imitation epochs left to B::train (B::kStagedLearn)
  if constexpr (OneAttackSite<B>::value) {
    static_assert(StagedLearn<B>::value, "kOneAttackSite stages the target");
    // pass 0 stages this lane's rows and, gated, has its attacker rewrite
    // them; pass 1 stages a learner's target and, gated, has the target's
    // attacker rewrite it there, for B::train to imitate
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const Pop* by;
      if (pass == 0) {
        if (g.atk == nullptr || g.gates[lane(0, n, i)] == 0) continue;
        B::stage(rows, co);
        by = g.atk;
      } else {
        if (g.oth == nullptr || g.severity <= 0 || g.gates[lane(1, n, i)] == 0) break;
        float o[P];
#pragma unroll
        for (int r = 0; r < P; ++r) o[r] = load_f32(g.oth, lane(r, n, i));
        B::stage(o, co);
        learned = g.severity;
        if (g.oatk == nullptr || g.gates[lane(2, n, i)] == 0) break;
        by = g.oatk;
      }
      float a[P];
#pragma unroll
      for (int r = 0; r < P; ++r) a[r] = load_f32(by, lane(r, n, i));
      B::apply_staged(a, co);
      if (pass == 0) B::unstage(rows, co);
    }
  } else if (g.oth != nullptr && g.severity > 0 && g.gates[lane(1, n, i)] != 0) {
    if constexpr (PARK) {
      const PopColumn<Pop> other{g.oth, n, i};
      float o[P];  // the target, transformed where its attacker is recomputed
      if (g.oatk != nullptr && g.gates[lane(2, n, i)] != 0) {
        B::apply(PopColumn<Pop>{g.oatk, n, i}, other, o, co);
      } else {
#pragma unroll
        for (int r = 0; r < P; ++r) o[r] = other[r];
      }
      B::learn_parked(tile_column<P>(own), o, g.severity, g.lr, co);
    } else {
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
      if constexpr (StagedLearn<B>::value) {
        B::stage(o, co);
        learned = g.severity;
      } else {
        B::learn(rows, o, g.severity, g.lr, co);
      }
    }
  }
  if constexpr (PARK) {
    const Column<kThreads> parked = tile_column<P>(own);
#pragma unroll
    for (int r = 0; r < P; ++r) rows[r] = parked[r];
  }

  // self-training, sample refreshed at each epoch top
  float last;
  if constexpr (StagedLearn<B>::value) {
    last = B::train(rows, learned, g.train, g.lr, co);
  } else {
    last = B::train(rows, g.train, g.lr, co);
  }

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
  if constexpr (STAGE) {
    StagedTile<P>& tile = staged_tile<P>();
    const int c = static_cast<int>(dealt - base);
#pragma unroll
    for (int r = 0; r < P; ++r) tile.rows[r][c] = dead ? g.fresh[lane(r, n, i)] : rows[r];
    tile.loss[c] = last;
    tile.dead[0][c] = div ? 1 : 0;
    tile.dead[1][c] = zero ? 1 : 0;
    __syncthreads();
    const long long mine = base + threadIdx.x;
    if (mine < n) {
#pragma unroll
      for (int r = 0; r < P; ++r) store_pop(g.out, lane(r, n, mine), tile.rows[r][threadIdx.x]);
      g.loss[mine] = tile.loss[threadIdx.x];
      g.dead[lane(0, n, mine)] = tile.dead[0][threadIdx.x];
      g.dead[lane(1, n, mine)] = tile.dead[1][threadIdx.x];
    }
  } else {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const long long k = lane(r, n, i);
      store_pop(g.out, k, dead ? g.fresh[k] : rows[r]);
    }
    g.loss[i] = last;
    g.dead[lane(0, n, i)] = div ? 1 : 0;
    g.dead[lane(1, n, i)] = zero ? 1 : 0;
  }
}

template <class B, class Pop>
inline int launch_generation(const GenArgs<Pop>& g,
                             const typename B::Consts& co, void* stream) {
  constexpr int smem = ColumnFloats<B>::value * kThreads * static_cast<int>(sizeof(float));
  const auto kernel = generation_kernel<B, Pop, StageTile<B>::value>;
  const cudaError_t set = allow_dynamic_shared(kernel, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<blocks_for(g.n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g, co);
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
