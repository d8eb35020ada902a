// Device code shared by the k-vector kernels (kvec_train.cu, K4, and the
// aggregating/fft body of K3, generation_kvec.cu): the reduce of P weights
// to k aggregates or DFT coefficients, the k -> k MLP, its hand-derived
// full-batch SGD step, and the expand of K3's transform.  Layout, threading
// and rounding rules: lane_common.cuh.
//
// Template parameters: W = width, D = depth, K = aggregates, A =
// activation, R = reduce kind (the fft variant's by fft_mode), and for K3's
// transform TGT = whether it reduces the target (aggregating; fft with
// fft_use_target) or the attacker's own rows; every loop over them unrolls
// into straight-line register code.
//
// What bounds these kernels on an H100 is the FP32 pipe's issue rate beside
// the population's bytes: built with --fmad=false, every multiply and add is
// one instruction, and at the soup's 10 self-training epochs an epoch's
// instructions decide how close K4 and K3 come to their byte bound.  Two
// savings are exact, so they change no rounded result:
//   * the average's poison chains (below) are 80 of the reduce's 108
//     operations, and on a lane whose rows are all finite every chain value
//     is exactly +0.0 (each starts at +0.0, and +0 + (+-0) = +0 under round
//     to nearest).  Every segment sum adds each of its rows once, so when
//     the sums' total is finite every row is, and the lane takes
//     (S_j + 0.0f) * inv -- the chains' value bit for bit, -0 sums made +0
//     included; any other lane (a non-finite row, or sums whose total
//     overflows) runs the chains.  An epoch issues 155 instead of 236;
//   * the fft variant's DFT bases are compile-time constants (DftTable: the
//     float32 values of ops/cuda_kvec_train.py's kvec_tables, written out),
//     so no term branches on a table at run time, a coefficient of exactly
//     0.0 issues nothing and one of 1.0 is the row itself, as kvec_tables
//     marks them.  The host still passes kvec_tables, and the entry points
//     refuse one that differs from the compiled table (tables_match).
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

#include <string.h>

#include <utility>

#include "lane_common.cuh"

namespace srnn {

// Reduce kinds: the aggregators, and the fft variant's DFT by fft_mode
// (ops/cuda_kvec_train.py: REDUCE_CODES).
enum Reduce { AVERAGE = 0, MAX = 1, MAX_BUGGY = 2, DFT = 3, RDFT = 4 };

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

// The fft variant's bases for P weights and K coefficients by reduce kind
// (DFT: fft_mode 'fft', RDFT: 'rfft'): red[j][m], the truncated DFT's real
// cos basis, and exp[m][j], the inverse basis -- the float32 values of
// ops/cuda_kvec_train.py's kvec_tables (dft_cos_rows, kvec_expand_basis:
// float64, rounded once) as hex-float literals;
// tests/test_torch_kvec_host.py holds them against it bit for bit.  Written
// here for width 2, depth 2, aggregates 4 (P = 20); a build for another fft
// topology includes its table, generated from kvec_tables into the build
// directory (ops/cuda_kvec_train.py, dft_table_header; SRNN_DFT_TABLE).
template <int P, int K, int R>
struct DftTable;

template <>
struct DftTable<20, 4, DFT> {  // fft_mode 'fft'
  static constexpr float red[4][20] = {
      {0x1p+0f, 0x1p+0f, 0x1p+0f, 0x1p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f},
      {0x1p+0f, 0x1.1a6264p-54f, -0x1p+0f, -0x1.a79394p-53f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f},
      {0x1p+0f, -0x1p+0f, 0x1p+0f, -0x1p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f},
      {0x1p+0f, -0x1.a79394p-53f, -0x1p+0f, 0x1.3daebp-51f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f,
       0x0p+0f, 0x0p+0f, 0x0p+0f, 0x0p+0f}};
  static constexpr float exp[20][4] = {
      {0x1.99999ap-5f, 0x1.99999ap-5f, 0x1.99999ap-5f, 0x1.99999ap-5f},
      {0x1.99999ap-5f, 0x1.858d8p-5f, 0x1.4b5f94p-5f, 0x1.e1838p-6f},
      {0x1.99999ap-5f, 0x1.4b5f94p-5f, 0x1.fa4b2p-7f, -0x1.fa4b2p-7f},
      {0x1.99999ap-5f, 0x1.e1838p-6f, -0x1.fa4b2p-7f, -0x1.858d8p-5f},
      {0x1.99999ap-5f, 0x1.fa4b2p-7f, -0x1.4b5f94p-5f, -0x1.4b5f94p-5f},
      {0x1.99999ap-5f, 0x1.99999ap-59f, -0x1.99999ap-5f, 0x0p+0f},
      {0x1.99999ap-5f, -0x1.fa4b2p-7f, -0x1.4b5f94p-5f, 0x1.4b5f94p-5f},
      {0x1.99999ap-5f, -0x1.e1838p-6f, -0x1.fa4b2p-7f, 0x1.858d8p-5f},
      {0x1.99999ap-5f, -0x1.4b5f94p-5f, 0x1.fa4b2p-7f, 0x1.fa4b2p-7f},
      {0x1.99999ap-5f, -0x1.858d8p-5f, 0x1.4b5f94p-5f, -0x1.e1838p-6f},
      {0x1.99999ap-5f, -0x1.99999ap-5f, 0x1.99999ap-5f, -0x1.99999ap-5f},
      {0x1.99999ap-5f, -0x1.858d8p-5f, 0x1.4b5f94p-5f, -0x1.e1838p-6f},
      {0x1.99999ap-5f, -0x1.4b5f94p-5f, 0x1.fa4b2p-7f, 0x1.fa4b2p-7f},
      {0x1.99999ap-5f, -0x1.e1838p-6f, -0x1.fa4b2p-7f, 0x1.858d8p-5f},
      {0x1.99999ap-5f, -0x1.fa4b2p-7f, -0x1.4b5f94p-5f, 0x1.4b5f94p-5f},
      {0x1.99999ap-5f, 0x0p+0f, -0x1.99999ap-5f, -0x1.99999ap-59f},
      {0x1.99999ap-5f, 0x1.fa4b2p-7f, -0x1.4b5f94p-5f, -0x1.4b5f94p-5f},
      {0x1.99999ap-5f, 0x1.e1838p-6f, -0x1.fa4b2p-7f, -0x1.858d8p-5f},
      {0x1.99999ap-5f, 0x1.4b5f94p-5f, 0x1.fa4b2p-7f, -0x1.fa4b2p-7f},
      {0x1.99999ap-5f, 0x1.858d8p-5f, 0x1.4b5f94p-5f, 0x1.e1838p-6f}};
};

template <>
struct DftTable<20, 4, RDFT> {  // fft_mode 'rfft'
  static constexpr float red[4][20] = {
      {0x1p+0f, 0x1p+0f, 0x1p+0f, 0x1p+0f,
       0x1p+0f, 0x1p+0f, 0x1p+0f, 0x1p+0f,
       0x1p+0f, 0x1p+0f, 0x1p+0f, 0x1p+0f,
       0x1p+0f, 0x1p+0f, 0x1p+0f, 0x1p+0f,
       0x1p+0f, 0x1p+0f, 0x1p+0f, 0x1p+0f},
      {0x1p+0f, 0x1.e6f0e2p-1f, 0x1.9e377ap-1f, 0x1.2cf23p-1f,
       0x1.3c6ef4p-2f, 0x1.1a6264p-54f, -0x1.3c6ef4p-2f, -0x1.2cf23p-1f,
       -0x1.9e377ap-1f, -0x1.e6f0e2p-1f, -0x1p+0f, -0x1.e6f0e2p-1f,
       -0x1.9e377ap-1f, -0x1.2cf23p-1f, -0x1.3c6ef4p-2f, -0x1.a79394p-53f,
       0x1.3c6ef4p-2f, 0x1.2cf23p-1f, 0x1.9e377ap-1f, 0x1.e6f0e2p-1f},
      {0x1p+0f, 0x1.9e377ap-1f, 0x1.3c6ef4p-2f, -0x1.3c6ef4p-2f,
       -0x1.9e377ap-1f, -0x1p+0f, -0x1.9e377ap-1f, -0x1.3c6ef4p-2f,
       0x1.3c6ef4p-2f, 0x1.9e377ap-1f, 0x1p+0f, 0x1.9e377ap-1f,
       0x1.3c6ef4p-2f, -0x1.3c6ef4p-2f, -0x1.9e377ap-1f, -0x1p+0f,
       -0x1.9e377ap-1f, -0x1.3c6ef4p-2f, 0x1.3c6ef4p-2f, 0x1.9e377ap-1f},
      {0x1p+0f, 0x1.2cf23p-1f, -0x1.3c6ef4p-2f, -0x1.e6f0e2p-1f,
       -0x1.9e377ap-1f, -0x1.a79394p-53f, 0x1.9e377ap-1f, 0x1.e6f0e2p-1f,
       0x1.3c6ef4p-2f, -0x1.2cf23p-1f, -0x1p+0f, -0x1.2cf23p-1f,
       0x1.3c6ef4p-2f, 0x1.e6f0e2p-1f, 0x1.9e377ap-1f, 0x1.3daebp-51f,
       -0x1.9e377ap-1f, -0x1.e6f0e2p-1f, -0x1.3c6ef4p-2f, 0x1.2cf23p-1f}};
  static constexpr float exp[20][4] = {
      {0x1.99999ap-5f, 0x1.99999ap-4f, 0x1.99999ap-4f, 0x1.99999ap-4f},
      {0x1.99999ap-5f, 0x1.858d8p-4f, 0x1.4b5f94p-4f, 0x1.e1838p-5f},
      {0x1.99999ap-5f, 0x1.4b5f94p-4f, 0x1.fa4b2p-6f, -0x1.fa4b2p-6f},
      {0x1.99999ap-5f, 0x1.e1838p-5f, -0x1.fa4b2p-6f, -0x1.858d8p-4f},
      {0x1.99999ap-5f, 0x1.fa4b2p-6f, -0x1.4b5f94p-4f, -0x1.4b5f94p-4f},
      {0x1.99999ap-5f, 0x1.99999ap-58f, -0x1.99999ap-4f, 0x0p+0f},
      {0x1.99999ap-5f, -0x1.fa4b2p-6f, -0x1.4b5f94p-4f, 0x1.4b5f94p-4f},
      {0x1.99999ap-5f, -0x1.e1838p-5f, -0x1.fa4b2p-6f, 0x1.858d8p-4f},
      {0x1.99999ap-5f, -0x1.4b5f94p-4f, 0x1.fa4b2p-6f, 0x1.fa4b2p-6f},
      {0x1.99999ap-5f, -0x1.858d8p-4f, 0x1.4b5f94p-4f, -0x1.e1838p-5f},
      {0x1.99999ap-5f, -0x1.99999ap-4f, 0x1.99999ap-4f, -0x1.99999ap-4f},
      {0x1.99999ap-5f, -0x1.858d8p-4f, 0x1.4b5f94p-4f, -0x1.e1838p-5f},
      {0x1.99999ap-5f, -0x1.4b5f94p-4f, 0x1.fa4b2p-6f, 0x1.fa4b2p-6f},
      {0x1.99999ap-5f, -0x1.e1838p-5f, -0x1.fa4b2p-6f, 0x1.858d8p-4f},
      {0x1.99999ap-5f, -0x1.fa4b2p-6f, -0x1.4b5f94p-4f, 0x1.4b5f94p-4f},
      {0x1.99999ap-5f, 0x0p+0f, -0x1.99999ap-4f, -0x1.99999ap-58f},
      {0x1.99999ap-5f, 0x1.fa4b2p-6f, -0x1.4b5f94p-4f, -0x1.4b5f94p-4f},
      {0x1.99999ap-5f, 0x1.e1838p-5f, -0x1.fa4b2p-6f, -0x1.858d8p-4f},
      {0x1.99999ap-5f, 0x1.4b5f94p-4f, 0x1.fa4b2p-6f, -0x1.fa4b2p-6f},
      {0x1.99999ap-5f, 0x1.858d8p-4f, 0x1.4b5f94p-4f, 0x1.e1838p-5f}};
};

#ifdef SRNN_DFT_TABLE
#include "srnn_dft_table.cuh"
#endif

// Entry kinds of kvec_tables' bases: a reduce coefficient of exactly 0.0 is
// skipped, one of exactly 1.0 takes the row itself, any other multiplies;
// the expand skips nothing.
enum BasisKind { SKIP = 0, ONE = 1, MUL = 2 };
__host__ __device__ constexpr int red_kind(float c) {
  return c == 0.0f ? SKIP : c == 1.0f ? ONE : MUL;
}
__host__ __device__ constexpr int exp_kind(float c) { return c == 1.0f ? ONE : MUL; }

// Coefficient J of the reduce basis at row M and of the expand basis at
// output M, as constants of the device code.
template <int P, int K, int R, int J, int M>
struct DftCoef {
  static constexpr float red = DftTable<P, K, R>::red[J][M];
  static constexpr float exp = DftTable<P, K, R>::exp[M][J];
};

// Does the host's float32 table (ops/cuda_kvec_train.py, kvec_tables:
// reduce basis (K, P), expand basis (P, K), their kinds, then whether the
// transform reads the target) equal the compiled one of reduce kind R bit
// for bit?  The aggregators' bases are all zeros, and their transform reads
// the target; the fft variant's may read either (fft_use_target).
template <int P, int K, int R>
inline bool tables_match(const float* host) {
  float want[4 * K * P + 1] = {};
  if constexpr (R == DFT || R == RDFT) {
    using Tb = DftTable<P, K, R>;
    for (int j = 0; j < K; ++j)
      for (int m = 0; m < P; ++m) {
        want[j * P + m] = Tb::red[j][m];
        want[K * P + m * K + j] = Tb::exp[m][j];
        want[2 * K * P + j * P + m] = static_cast<float>(red_kind(Tb::red[j][m]));
        want[3 * K * P + m * K + j] = static_cast<float>(exp_kind(Tb::exp[m][j]));
      }
    want[4 * K * P] = host[4 * K * P] == 0.0f ? 0.0f : 1.0f;
  } else {
    want[4 * K * P] = 1.0f;
  }
  return memcmp(want, host, sizeof want) == 0;
}

// Does the host's table say that the fft transform reads the target?
template <int P, int K>
inline bool tables_src_target(const float* host) { return host[4 * K * P] != 0.0f; }

// torch.maximum: NaN if either operand is NaN, else the larger.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

// The DFT's terms, one per (coefficient J, row M) as template parameters:
// acc chains the terms whose coefficient is not 0.0, the first one starting
// it.
template <int P, int K, int R, int J, int M>
__device__ __forceinline__ void dft_term(const float (&rows)[P], float& acc,
                                         bool& have) {
  using C = DftCoef<P, K, R, J, M>;
  if constexpr (red_kind(C::red) != SKIP) {
    float term;
    if constexpr (red_kind(C::red) == ONE) {
      term = rows[M];
    } else {
      term = rows[M] * C::red;
    }
    acc = have ? acc + term : term;
    have = true;
  }
}

template <int P, int K, int R, int J, int... Ms>
__device__ __forceinline__ float dft_coefficient(const float (&rows)[P],
                                                 std::integer_sequence<int, Ms...>) {
  float acc = 0.0f;  // 0.0 when every coefficient is skipped
  bool have = false;
  (dft_term<P, K, R, J, Ms>(rows, acc, have), ...);
  return acc;
}

template <int P, int K, int R, int... Js>
__device__ __forceinline__ void dft_reduce(const float (&rows)[P], float (&out)[K],
                                           std::integer_sequence<int, Js...>) {
  ((out[Js] = dft_coefficient<P, K, R, Js>(rows, std::make_integer_sequence<int, P>())),
   ...);
}

// The inverse transform: output M chains the K coefficients' terms.
template <int P, int K, int R, int M, int J>
__device__ __forceinline__ void dft_expand_term(const float (&o)[K], float& acc) {
  using C = DftCoef<P, K, R, J, M>;
  float term;
  if constexpr (exp_kind(C::exp) == ONE) {
    term = o[J];
  } else {
    term = o[J] * C::exp;
  }
  acc = J == 0 ? term : acc + term;
}

template <int P, int K, int R, int M, int... Js>
__device__ __forceinline__ float dft_expand_row(const float (&o)[K],
                                                std::integer_sequence<int, Js...>) {
  float acc = 0.0f;
  (dft_expand_term<P, K, R, M, Js>(o, acc), ...);
  return acc;
}

template <int P, int K, int R, int... Ms>
__device__ __forceinline__ void dft_expand(const float (&o)[K], float (&out)[P],
                                           std::integer_sequence<int, Ms...>) {
  ((out[Ms] = dft_expand_row<P, K, R, Ms>(o, std::make_integer_sequence<int, K>())),
   ...);
}

// P weight rows -> K aggregates / DFT coefficients (``_reduce_rows``).
template <int W, int D, int K, int R>
__device__ __forceinline__ void reduce_rows(const float (&rows)[KV<W, D, K>::P],
                                            float (&out)[K]) {
  using T = KV<W, D, K>;
  constexpr int P = T::P;
  if constexpr (R == DFT || R == RDFT) {
    dft_reduce<P, K, R>(rows, out, std::make_integer_sequence<int, K>());
  } else if constexpr (R == AVERAGE) {
    float sum[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = T::seg_start(j), e = T::seg_end(j);
      float acc = rows[s];
#pragma unroll
      for (int r = s + 1; r < e; ++r) acc = acc + rows[r];
      sum[j] = acc;
    }
    float total = sum[0];
#pragma unroll
    for (int j = 1; j < K; ++j) total = total + sum[j];
    if (isfinite(total)) {
      // every row finite: both chains are +0.0 wherever they are read
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int s = T::seg_start(j), e = T::seg_end(j);
        const float inv = static_cast<float>(1.0 / static_cast<double>(e - s));
        out[j] = (sum[j] + 0.0f) * inv;
      }
      return;
    }
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
      const float inv = static_cast<float>(1.0 / static_cast<double>(e - s));
      out[j] = (sum[j] + zpre[s] + zsuf[e]) * inv;
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
                                          float lr) {
  using T = KV<W, D, K>;
  constexpr int P = T::P;
  const float scale = static_cast<float>(2.0 / K);
  float loss = 0.0f;
  for (int e = 0; e < epochs; ++e) {
    float xk[K];
    if constexpr (REFRESH) {
      reduce_rows<W, D, K, R>(rows, xk);
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
// fft_use_target the attacker's own rows: TGT), one forward, expand
// (``pallas_generation.apply_rows``, k-vector body).
template <int W, int D, int K, int A, int R, bool TGT>
__device__ __forceinline__ void kvec_apply(const float (&self)[KV<W, D, K>::P],
                                           const float (&x)[KV<W, D, K>::P],
                                           float (&out)[KV<W, D, K>::P]) {
  using T = KV<W, D, K>;
  constexpr int P = T::P;
  float ak[K];
  if constexpr (TGT) {
    reduce_rows<W, D, K, R>(x, ak);
  } else {
    reduce_rows<W, D, K, R>(self, ak);
  }
  float acts[T::L + 1][T::M];
  kvec_forward<W, D, K, A>(self, ak, acts);
  float o[K];
#pragma unroll
  for (int j = 0; j < K; ++j) o[j] = acts[T::L][j];
  if constexpr (R == DFT || R == RDFT) {
    dft_expand<P, K, R>(o, out, std::make_integer_sequence<int, P>());
  } else {
#pragma unroll
    for (int m = 0; m < P; ++m) {
      float acc;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float term = j == T::seg_of(m) ? o[j] : o[j] * 0.0f;
        acc = j == 0 ? term : acc + term;
      }
      out[m] = acc;
    }
  }
}

}  // namespace srnn

// Dispatch of the runtime reduce code to the template instantiation (the
// one kind SRNN_REDUCE names, in a build for one topology: lane_common.cuh).
#ifdef SRNN_REDUCE
#define SRNN_DISPATCH_REDUCE(reduce_code, ...)                                    \
  {                                                                               \
    if ((reduce_code) != SRNN_REDUCE) return static_cast<int>(cudaErrorInvalidValue); \
    constexpr int R = SRNN_REDUCE;                                                \
    __VA_ARGS__;                                                                  \
  }
#else
#define SRNN_DISPATCH_REDUCE(reduce_code, ...)                                    \
  switch (reduce_code) {                                                          \
    case srnn::AVERAGE: { constexpr int R = srnn::AVERAGE; __VA_ARGS__; break; }   \
    case srnn::MAX: { constexpr int R = srnn::MAX; __VA_ARGS__; break; }           \
    case srnn::MAX_BUGGY: { constexpr int R = srnn::MAX_BUGGY; __VA_ARGS__; break; } \
    case srnn::DFT: { constexpr int R = srnn::DFT; __VA_ARGS__; break; }           \
    case srnn::RDFT: { constexpr int R = srnn::RDFT; __VA_ARGS__; break; }         \
    default: return static_cast<int>(cudaErrorInvalidValue);                      \
  }
#endif
