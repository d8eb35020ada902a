"""The weightwise kernels' device arithmetic (``csrc/ww_common.cuh``), built
for the CPU with the host's C++ compiler, against the plain torch versions
on the CPU, bitwise.

The header holds K1's application (``apply_rows``), the batch-1 SGD chain
of K2 and K3 (``sgd_chain``) and K2's shuffled chain (``sgd_chain_shuffled``,
a per-lane sample order, its snapshot and coordinate table read at run
time), with the duplex coordinates as compile-time
constants (``WW::coord``), layer 0's coordinate products shared between the
points of an application and products with a coordinate of 1.0 not taken.
Those savings change no rounded operation, so on the same inputs the chains
must give the plain versions' weights bit for bit, and the mean loss within
1 ulp.  The header compiles as C++17 once a shim defines CUDA's function
qualifiers and a stub ``cuda_runtime.h`` gives the few runtime names that
``lane_common.cuh`` uses; ``-ffp-contract=off`` keeps every multiply and add
rounding on its own, as ``--fmad=false`` does on the card.  sigmoid and tanh
are left to the card: the host's ``expf``/``tanhf`` are not CUDA's.

Each test runs at width 2 / depth 2 (P = 14, the default build's) and at
width 3 / depth 3 (P = 33), the harness built with ``SRNN_W`` / ``SRNN_D``
set as a build of that topology sets them (the latter at -O0, which
rounds alike and compiles the unrolled P = 33 chains in a fifth of -O2's
time).

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
from srnn_tpu_torch.ops.cuda_ww import ww_apply_population_plain
from srnn_tpu_torch.ops.cuda_ww_train import ww_sgd_plain
from srnn_tpu_torch.topology import normalized_weight_coords

CSRC = Path(__file__).resolve().parent.parent / "srnn_tpu_torch" / "csrc"
N = 300
LR = 0.01
ACTS = {"linear": 0, "relu": 3}

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
#include "ww_common.cuh"

namespace {
constexpr int W = SRNN_W, D = SRNN_D, P = srnn::WW<W, D>::P;

template <int A>
void apply_chain(const float* wT, float* out, long long n, int steps) {
  for (long long i = 0; i < n; ++i) {
    float w[P], nw[P];
    for (int r = 0; r < P; ++r) w[r] = wT[r * n + i];
    for (int t = 0; t < steps; ++t) {
      srnn::apply_rows<W, D, A>(w, w, nw);
      for (int r = 0; r < P; ++r) w[r] = nw[r];
    }
    for (int r = 0; r < P; ++r) out[r * n + i] = w[r];
  }
}

template <int A>
void sgd(const float* wT, const float* otherT, float* out, float* loss,
         long long n, int epochs, float lr) {
  for (long long i = 0; i < n; ++i) {
    float rows[P], target[P];
    for (int r = 0; r < P; ++r) {
      rows[r] = wT[r * n + i];
      target[r] = otherT ? otherT[r * n + i] : 0.0f;
    }
    loss[i] = otherT
        ? srnn::sgd_chain<W, D, A, false>(rows, target, epochs, lr)
        : srnn::sgd_chain<W, D, A, true>(rows, target, epochs, lr);
    for (int r = 0; r < P; ++r) out[r * n + i] = rows[r];
  }
}
template <int A>
void sgd_shuffled(const float* wT, const float* otherT,
                  const unsigned char* order, float* out, float* loss,
                  long long n, int epochs, float lr) {
  float coords[3 * P];
  for (int t = 0; t < 3 * P; ++t)
    coords[t] = srnn::WW<W, D>::coord(t / 3, t % 3);
  for (long long i = 0; i < n; ++i) {
    float rows[P], target[P], snap[P];
    for (int r = 0; r < P; ++r) {
      rows[r] = wT[r * n + i];
      target[r] = otherT ? otherT[r * n + i] : 0.0f;
    }
    loss[i] = otherT
        ? srnn::sgd_chain_shuffled<W, D, A, false>(
              rows, target, snap, 1, order + i, n, coords, epochs, lr)
        : srnn::sgd_chain_shuffled<W, D, A, true>(
              rows, target, snap, 1, order + i, n, coords, epochs, lr);
    for (int r = 0; r < P; ++r) out[r * n + i] = rows[r];
  }
}
}  // namespace

extern "C" int host_weights() { return P; }

extern "C" void host_coords(float* out) {
  for (int s = 0; s < P; ++s)
    for (int k = 0; k < 3; ++k) out[s * 3 + k] = srnn::WW<W, D>::coord(s, k);
}

extern "C" int host_coords_match(const float* coords) {
  return srnn::coords_match<W, D>(coords) ? 1 : 0;
}

extern "C" void host_apply(const float* wT, float* out, long long n,
                           int steps, int act) {
  if (act == srnn::RELU) apply_chain<srnn::RELU>(wT, out, n, steps);
  else apply_chain<srnn::LINEAR>(wT, out, n, steps);
}

extern "C" void host_sgd(const float* wT, const float* otherT, float* out,
                         float* loss, long long n, int epochs, float lr,
                         int act) {
  if (act == srnn::RELU) sgd<srnn::RELU>(wT, otherT, out, loss, n, epochs, lr);
  else sgd<srnn::LINEAR>(wT, otherT, out, loss, n, epochs, lr);
}

extern "C" void host_sgd_shuffled(const float* wT, const float* otherT,
                                  const unsigned char* order, float* out,
                                  float* loss, long long n, int epochs,
                                  float lr, int act) {
  if (act == srnn::RELU)
    sgd_shuffled<srnn::RELU>(wT, otherT, order, out, loss, n, epochs, lr);
  else
    sgd_shuffled<srnn::LINEAR>(wT, otherT, order, out, loss, n, epochs, lr);
}
"""


#: (width, depth, optimisation level) of each harness build
SHAPES = {"w2d2": (2, 2, "-O2"), "w3d3": (3, 3, "-O0")}


class Host:
    """A harness build: its library and the topology it was built for."""

    def __init__(self, h, width, depth):
        self.h, self.width, self.depth = h, width, depth

    def __getattr__(self, name):
        return getattr(self.h, name)

    def topo(self, activation="linear"):
        return Topology("weightwise", width=self.width, depth=self.depth,
                        activation=activation)


@pytest.fixture(scope="module", params=list(SHAPES))
def lib(request, tmp_path_factory):
    width, depth, opt = SHAPES[request.param]
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host to build ww_common.cuh")
    d = tmp_path_factory.mktemp(f"ww_host_{request.param}")
    (d / "shim.h").write_text(SHIM)
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "ww_host.so"
    cmd = [cxx, "-std=c++17", opt, "-ffp-contract=off", "-fPIC", "-shared",
           "-Wno-unknown-pragmas", "-include", str(d / "shim.h"), "-I",
           str(d), "-I", str(CSRC), f"-DSRNN_W={width}", f"-DSRNN_D={depth}",
           "-o", str(so), str(d / "harness.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    h = ctypes.CDLL(str(so))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    h.host_coords.argtypes = [p]
    h.host_coords_match.argtypes = [p]
    h.host_apply.argtypes = [p, p, ll, i, i]
    h.host_sgd.argtypes = [p, p, p, p, ll, i, f, i]
    h.host_sgd_shuffled.argtypes = [p, p, p, p, p, ll, i, f, i]
    return Host(h, width, depth)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _population(topo, seed: int, scale: float) -> np.ndarray:
    """(P, N) float32 lanes from numpy, with edge cases in the first lanes:
    an Inf weight, a NaN weight, an all-zero particle and a -0 weight."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((topo.num_weights, N)) * scale).astype(
        np.float32)
    w[3, 0] = np.inf
    w[9, 1] = np.nan
    w[:, 2] = 0.0
    w[5, 3] = -0.0
    return np.ascontiguousarray(w)


def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 bits as integers in the floats' order, -0 and +0 both 0."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.int32).astype(
        np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def _assert_ulps(got: np.ndarray, ref: np.ndarray, ulps: int) -> None:
    """The same NaN and Inf pattern; within ``ulps`` float32 ulps where
    finite (0: bitwise up to the sign of zero)."""
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    inf = np.isinf(ref)
    assert np.array_equal(got[inf], ref[inf])
    fin = np.isfinite(ref)
    d = np.abs(_ordered(got) - _ordered(ref))[fin]
    assert d.size == 0 or int(d.max()) <= ulps, int(d.max())


def test_coordinate_table_is_the_topologys(lib):
    topo = lib.topo()
    assert lib.host_weights() == topo.num_weights
    got = np.empty((topo.num_weights, 3), dtype=np.float32)
    lib.host_coords(_ptr(got))
    ref = normalized_weight_coords(topo)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert lib.host_coords_match(_ptr(np.ascontiguousarray(ref))) == 1
    drifted = ref.copy()
    drifted[5, 1] = np.nextafter(drifted[5, 1], np.float32(1))
    assert lib.host_coords_match(_ptr(drifted)) == 0


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("steps", [1, 5])
def test_apply_rows_bitwise(lib, activation, steps):
    topo = lib.topo(activation)
    w = _population(topo, 10 + steps, 0.5)
    got = np.empty_like(w)
    lib.host_apply(_ptr(w), _ptr(got), N, steps, ACTS[activation])
    ref = ww_apply_population_plain(topo, torch.from_numpy(w), steps).numpy()
    _assert_ulps(got, ref, 0)


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("mode,epochs", [("train", 2), ("learn", 1)])
def test_sgd_chain_bitwise(lib, activation, mode, epochs):
    topo = lib.topo(activation)
    w = _population(topo, 20 + epochs, 0.5)
    other = _population(topo, 30 + epochs, 0.5) if mode == "learn" else None
    got = np.empty_like(w)
    loss = np.empty(N, dtype=np.float32)
    lib.host_sgd(_ptr(w), None if other is None else _ptr(other), _ptr(got),
                 _ptr(loss), N, epochs, LR, ACTS[activation])
    ref_w, ref_l = ww_sgd_plain(
        topo, torch.from_numpy(w),
        None if other is None else torch.from_numpy(other), epochs, LR)
    _assert_ulps(got, ref_w.numpy(), 0)
    _assert_ulps(loss, ref_l.numpy(), 1)


def _orders(p: int, epochs: int, seed: int) -> np.ndarray:
    """uint8 (epochs, P, N): an independent permutation of the P samples
    per epoch and lane."""
    rng = np.random.default_rng(seed)
    return np.ascontiguousarray(
        rng.random((epochs, p, N)).argsort(axis=1).astype(np.uint8))


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("mode,epochs", [("train", 2), ("learn", 1)])
def test_shuffled_chain_bitwise(lib, activation, mode, epochs):
    """K2's shuffled chain against the plain chain in the same per-lane
    order, bitwise; in the identity order against the unshuffled chain,
    bitwise (a runtime multiply by a coordinate of 1.0 is the skipped
    product)."""
    topo = lib.topo(activation)
    p = topo.num_weights
    w = _population(topo, 40 + epochs, 0.5)
    other = _population(topo, 50 + epochs, 0.5) if mode == "learn" else None
    optr = None if other is None else _ptr(other)
    order = _orders(p, epochs, 60 + epochs)
    got = np.empty_like(w)
    loss = np.empty(N, dtype=np.float32)
    lib.host_sgd_shuffled(_ptr(w), optr, _ptr(order), _ptr(got), _ptr(loss),
                          N, epochs, LR, ACTS[activation])
    ref_w, ref_l = ww_sgd_plain(
        topo, torch.from_numpy(w),
        None if other is None else torch.from_numpy(other), epochs, LR,
        torch.from_numpy(order))
    _assert_ulps(got, ref_w.numpy(), 0)
    _assert_ulps(loss, ref_l.numpy(), 0)

    ident = np.ascontiguousarray(np.broadcast_to(
        np.arange(p, dtype=np.uint8)[None, :, None], (epochs, p, N)))
    lib.host_sgd_shuffled(_ptr(w), optr, _ptr(ident), _ptr(got), _ptr(loss),
                          N, epochs, LR, ACTS[activation])
    ref = np.empty_like(w)
    ref_loss = np.empty(N, dtype=np.float32)
    lib.host_sgd(_ptr(w), optr, _ptr(ref), _ptr(ref_loss), N, epochs, LR,
                 ACTS[activation])
    _assert_ulps(got, ref, 0)
    _assert_ulps(loss, ref_loss, 0)
