"""The k-vector kernels' device arithmetic (``csrc/kvec_common.cuh``), built
for the CPU with the host's C++ compiler, against the plain torch versions
on the CPU, bit for bit.

The header holds the reduce of K4 and of K3's k-vector body
(``reduce_rows``: the segment average with its poison chains and their
exact finite path, max, max_buggy, the DFT of both fft modes), their SGD
chain (``kvec_sgd``, self-training and imitation) and K3's transform
(``kvec_apply``), with the fft variant's bases as compile-time tables
(``DftTable``) that the entry points hold against the host's
``kvec_tables`` (``tables_match``).  On the same inputs it must give the
plain versions' outputs bit for bit, the sign of zero included: an average
whose segment sum is -0 comes out +0 only through the chains' +0.0 (or the
finite path's ``+ 0.0f``).  The first lanes are edge cases: an Inf inside
one segment and so outside every other, a NaN, rows of -0, all-negative
rows, and finite rows whose segment sum (or the sums' total) overflows to
Inf, which must take the chains.  The header compiles as C++17 once a shim
defines CUDA's function qualifiers and a stub ``cuda_runtime.h`` gives the
few runtime names that ``lane_common.cuh`` uses; ``-ffp-contract=off`` keeps
every multiply and add rounding on its own, as ``--fmad=false`` does on the
card.  sigmoid and tanh are left to the card: the host's ``expf``/``tanhf``
are not CUDA's.

Each test runs at width 2 / depth 2 with 4 aggregates (P = 20, the
default build's, its DFT tables written out in the header), at width 3 /
depth 3 with 4 aggregates (P = 42: segments of 10 and a last one of 12)
and at width 2 / depth 2 with 6 aggregates (P = 28), the harness built
with ``SRNN_W`` / ``SRNN_D`` / ``SRNN_K`` set and, off P = 20, with the
DFT tables generated for its topology (``dft_table_header``), as a build
of that topology has them.

Skips where no C++ compiler is installed.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from srnn_tpu_torch import Topology
from srnn_tpu_torch.ops.cuda_kvec_train import (REDUCE_CODES,
                                                dft_table_header,
                                                kvec_apply_rows_plain,
                                                kvec_sgd_plain, kvec_tables,
                                                reduce_kind,
                                                reduce_rows_plain)

CSRC = Path(__file__).resolve().parent.parent / "srnn_tpu_torch" / "csrc"
N = 300
LR = 0.01
ACTS = {"linear": 0, "relu": 3}
#: the topology fields of the five reduce kinds
KINDS = {
    "average": dict(variant="aggregating"),
    "max": dict(variant="aggregating", aggregator="max"),
    "max_buggy": dict(variant="aggregating", aggregator="max_buggy"),
    "fft": dict(variant="fft"),
    "rfft": dict(variant="fft", fft_mode="rfft"),
}
#: (width, depth, aggregates) of each harness build
SHAPES = {"w2d2k4": (2, 2, 4), "w3d3k4": (3, 3, 4), "w2d2k6": (2, 2, 6)}

SHIM = """
#define __device__
#define __host__
#define __forceinline__ inline
"""

CUDA_RUNTIME_STUB = """
#pragma once
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline const char* cudaGetErrorString(cudaError_t) { return "stub"; }
"""

HARNESS = """
#include "kvec_common.cuh"

namespace {
constexpr int W = SRNN_W, D = SRNN_D, K = SRNN_K, P = srnn::KV<W, D, K>::P;

template <int R>
int reduce(const float* rowsT, float* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    float rows[P], o[K];
    for (int r = 0; r < P; ++r) rows[r] = rowsT[r * n + i];
    srnn::reduce_rows<W, D, K, R>(rows, o);
    for (int j = 0; j < K; ++j) out[j * n + i] = o[j];
  }
  return 0;
}

template <int A, int R>
int sgd(const float* wT, const float* otherT, float* out, float* loss,
        long long n, int epochs, float lr) {
  for (long long i = 0; i < n; ++i) {
    float rows[P];
    for (int r = 0; r < P; ++r) rows[r] = wT[r * n + i];
    if (otherT) {
      float other[P], snap[K];
      for (int r = 0; r < P; ++r) other[r] = otherT[r * n + i];
      srnn::reduce_rows<W, D, K, R>(other, snap);
      loss[i] = srnn::kvec_sgd<W, D, K, A, R, false>(rows, snap, epochs, lr);
    } else {
      const float none[K] = {};
      loss[i] = srnn::kvec_sgd<W, D, K, A, R, true>(rows, none, epochs, lr);
    }
    for (int r = 0; r < P; ++r) out[r * n + i] = rows[r];
  }
  return 0;
}

template <int R>
int dft_table(float* red, float* exp) {
  if constexpr (R == srnn::DFT || R == srnn::RDFT) {
    for (int j = 0; j < K; ++j)
      for (int m = 0; m < P; ++m) {
        red[j * P + m] = srnn::DftTable<P, K, R>::red[j][m];
        exp[m * K + j] = srnn::DftTable<P, K, R>::exp[m][j];
      }
    return 0;
  }
  return 1;
}

template <int A, int R, bool TGT>
int apply(const float* selfT, const float* xT, float* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    float self[P], x[P], o[P];
    for (int r = 0; r < P; ++r) {
      self[r] = selfT[r * n + i];
      x[r] = xT[r * n + i];
    }
    srnn::kvec_apply<W, D, K, A, R, TGT>(self, x, o);
    for (int r = 0; r < P; ++r) out[r * n + i] = o[r];
  }
  return 0;
}
}  // namespace

#define HOST_ACT(act, ...)                                   \\
  switch (act) {                                             \\
    case srnn::LINEAR: { constexpr int A = srnn::LINEAR; __VA_ARGS__; } \\
    case srnn::RELU: { constexpr int A = srnn::RELU; __VA_ARGS__; }     \\
    default: return 1;                                       \\
  }

extern "C" int host_weights() { return P; }

extern "C" int host_dft_table(int reduce_code, float* red, float* exp) {
  SRNN_DISPATCH_REDUCE(reduce_code, return dft_table<R>(red, exp));
  return 1;
}

extern "C" int host_tables_match(int reduce_code, const float* host) {
  SRNN_DISPATCH_REDUCE(reduce_code,
                       return srnn::tables_match<P, K, R>(host) ? 1 : 0);
  return 0;
}

extern "C" int host_reduce(int reduce_code, const float* rowsT, float* out,
                           long long n) {
  SRNN_DISPATCH_REDUCE(reduce_code, return reduce<R>(rowsT, out, n));
  return 1;
}

extern "C" int host_sgd(int reduce_code, int act, const float* wT,
                        const float* otherT, float* out, float* loss,
                        long long n, int epochs, float lr) {
  SRNN_DISPATCH_REDUCE(reduce_code,
      HOST_ACT(act, return sgd<A, R>(wT, otherT, out, loss, n, epochs, lr)));
  return 1;
}

extern "C" int host_apply(int reduce_code, int act, int tgt,
                          const float* selfT, const float* xT, float* out,
                          long long n) {
  SRNN_DISPATCH_REDUCE(reduce_code,
      HOST_ACT(act, return tgt ? apply<A, R, true>(selfT, xT, out, n)
                               : apply<A, R, false>(selfT, xT, out, n)));
  return 1;
}
"""


class Host:
    """A harness build: its library and the shape it was built for."""

    def __init__(self, h, width, depth, aggregates):
        self.h, self.shape = h, (width, depth, aggregates)

    def __getattr__(self, name):
        return getattr(self.h, name)

    def topo(self, kind, **kw):
        w, d, k = self.shape
        return Topology(width=w, depth=d, aggregates=k, **KINDS[kind], **kw)


@pytest.fixture(scope="module", params=list(SHAPES))
def lib(request, tmp_path_factory):
    width, depth, k = SHAPES[request.param]
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host to build kvec_common.cuh")
    d = tmp_path_factory.mktemp(f"kvec_host_{request.param}")
    (d / "shim.h").write_text(SHIM)
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_STUB)
    (d / "harness.cpp").write_text(HARNESS)
    defines = [f"-DSRNN_W={width}", f"-DSRNN_D={depth}", f"-DSRNN_K={k}"]
    if (width, depth, k) != (2, 2, 4):
        (d / "srnn_dft_table.cuh").write_text("".join(
            dft_table_header(Topology("fft", width=width, depth=depth,
                                      aggregates=k, fft_mode=m))
            for m in ("fft", "rfft")))
        defines.append("-DSRNN_DFT_TABLE=1")
    so = d / "kvec_host.so"
    cmd = [cxx, "-std=c++17", "-O0", "-ffp-contract=off", "-fPIC", "-shared",
           "-Wno-unknown-pragmas", "-include", str(d / "shim.h"), "-I",
           str(d), "-I", str(CSRC), *defines, "-o", str(so),
           str(d / "harness.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    h = ctypes.CDLL(str(so))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    h.host_dft_table.argtypes = [i, p, p]
    h.host_tables_match.argtypes = [i, p]
    h.host_reduce.argtypes = [i, p, p, ll]
    h.host_sgd.argtypes = [i, i, p, p, p, p, ll, i, f]
    h.host_apply.argtypes = [i, i, i, p, p, p, ll]
    return Host(h, width, depth, k)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _population(topo, seed: int, scale: float = 0.5) -> np.ndarray:
    """(P, N) float32 lanes from numpy, edge cases in the first lanes."""
    p, seg = topo.num_weights, topo.num_weights // topo.aggregates
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((p, N)) * scale).astype(np.float32)
    w[3, 0] = np.inf          # inside segment 0, outside the others
    w[p - 1, 1] = -np.inf     # in the last segment (it takes the leftovers)
    w[9, 2] = np.nan
    w[:, 3] = -0.0            # every segment sum -0
    w[:, 4] = -np.abs(w[:, 4]) - np.float32(0.25)  # all negative
    w[0:seg, 5] = np.float32(3e38)  # finite rows, segment 0's sum overflows
    w[0, 6] = np.float32(2e38)      # finite sums whose total overflows
    w[seg, 6] = np.float32(2e38)
    w[0:seg, 7] = -0.0        # one segment sum -0, the others finite
    return np.ascontiguousarray(w)


def _assert_bitwise(got: np.ndarray, ref: np.ndarray) -> None:
    """NaN at the same places, and elsewhere the same float32 bits (so -0
    and +0 differ)."""
    got = np.ascontiguousarray(got, dtype=np.float32)
    ref = np.ascontiguousarray(ref, dtype=np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    keep = ~np.isnan(ref)
    bad = got.view(np.uint32)[keep] != ref.view(np.uint32)[keep]
    assert not bad.any(), (got[keep][bad][:8], ref[keep][bad][:8])


def _rows(a: np.ndarray):
    return list(torch.from_numpy(a).unbind(0))


@pytest.mark.parametrize("kind,use_target", [
    ("average", False), ("max", False), ("max_buggy", False),
    ("fft", False), ("fft", True), ("rfft", False), ("rfft", True)])
def test_compiled_tables_are_kvec_tables(lib, kind, use_target):
    topo = lib.topo(kind, fft_use_target=use_target)
    code = REDUCE_CODES[reduce_kind(topo)]
    host = np.ascontiguousarray(kvec_tables(topo))
    p, k = topo.num_weights, topo.aggregates
    assert lib.host_weights() == p
    if topo.variant == "fft":
        red = np.empty(k * p, dtype=np.float32)
        exp = np.empty(p * k, dtype=np.float32)
        assert lib.host_dft_table(code, _ptr(red), _ptr(exp)) == 0
        assert np.array_equal(red.view(np.uint32),
                              host[:k * p].view(np.uint32))
        assert np.array_equal(exp.view(np.uint32),
                              host[k * p:2 * k * p].view(np.uint32))
    assert lib.host_tables_match(code, _ptr(host)) == 1
    drifted = host.copy()
    drifted[k * p + 7] = np.nextafter(drifted[k * p + 7], np.float32(1))
    assert lib.host_tables_match(code, _ptr(drifted)) == 0
    other = host.copy()
    other[-1] = 1.0 - other[-1]  # the other transform source
    assert lib.host_tables_match(code, _ptr(other)) == \
        (1 if topo.variant == "fft" else 0)


@pytest.mark.parametrize("kind", list(KINDS))
def test_reduce_rows_bitwise(lib, kind):
    topo = lib.topo(kind)
    w = _population(topo, 1)
    got = np.empty((topo.aggregates, N), dtype=np.float32)
    assert lib.host_reduce(REDUCE_CODES[reduce_kind(topo)], _ptr(w),
                           _ptr(got), N) == 0
    ref = torch.stack(reduce_rows_plain(topo, _rows(w))).numpy()
    _assert_bitwise(got, ref)


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("mode,epochs", [("train", 3), ("learn", 2)])
def test_kvec_sgd_bitwise(lib, kind, activation, mode, epochs):
    topo = lib.topo(kind, activation=activation)
    w = _population(topo, 2)
    other = _population(topo, 3) if mode == "learn" else None
    got = np.empty_like(w)
    loss = np.empty(N, dtype=np.float32)
    assert lib.host_sgd(REDUCE_CODES[reduce_kind(topo)], ACTS[activation],
                        _ptr(w), None if other is None else _ptr(other),
                        _ptr(got), _ptr(loss), N, epochs, LR) == 0
    ref_w, ref_l = kvec_sgd_plain(
        topo, torch.from_numpy(w),
        None if other is None else torch.from_numpy(other), epochs, LR)
    _assert_bitwise(got, ref_w.numpy())
    _assert_bitwise(loss, ref_l.numpy())


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("kind,use_target", [
    ("average", True), ("max", True), ("max_buggy", True), ("fft", False),
    ("fft", True), ("rfft", False), ("rfft", True)])
def test_kvec_apply_bitwise(lib, kind, use_target, activation):
    topo = lib.topo(kind, activation=activation,
                    fft_use_target=use_target and KINDS[kind]["variant"]
                    == "fft")
    self_w, x = _population(topo, 4), _population(topo, 5)
    # an attacker of -0 weights on an all-negative target: -0 everywhere
    self_w[:, 8] = -0.0
    x[:, 8] = -np.abs(x[:, 8]) - np.float32(0.5)
    got = np.empty_like(x)
    assert lib.host_apply(REDUCE_CODES[reduce_kind(topo)], ACTS[activation],
                          int(use_target), _ptr(self_w), _ptr(x), _ptr(got),
                          N) == 0
    ref = torch.stack(kvec_apply_rows_plain(topo, _rows(self_w),
                                            _rows(x))).numpy()
    _assert_bitwise(got, ref)
