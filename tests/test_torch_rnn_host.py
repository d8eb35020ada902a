"""The recurrent kernels' device arithmetic (``csrc/rnn_common.cuh``), built
for the CPU with the host's C++ compiler, against the plain torch versions
on the CPU, bit for bit.

The header holds the BPTT-SGD chain of K5 and of K3's recurrent body
(``rnn_sgd``: self-training, the sample refreshed at each epoch top, and
imitation of a fixed target) and K3's attack (``rnn_apply_streamed``, and
``rnn_apply_column``, in place on the column, which the checkpointed
builds run).  Its
BPTT has two paths, chosen per build from the topology
(``Checkpoints<W, D>::kCheckpointed``): the register path keeps every
layer's output sequence in registers; the checkpointed path keeps a
checkpoint of the state every C steps in a per-thread column and
recomputes each segment in the reverse sweep.  Both must give
``rnn_sgd_plain``'s weights and loss, and both attacks
``rnn_apply_rows_plain``'s outputs, bit for bit.  The column is a plain
array here (``Column<1>``), filled with NaN before each lane, so that a read
of a slot the chain has not written poisons the result.  The first lanes
are edge cases: an Inf weight, a NaN weight, rows of -0.

Each test runs at width 2 / depth 2 (P = 17, the default build's: the
register path); at width 3 / depth 3 (P = 52: 13 segments of 4 steps),
width 7 / depth 1 (P = 64, the fence: 16 of 4), width 2 / depth 6 (P =
49: 13 of 4, the first cut to 1) and width 1 / depth 15 (P = 32: 11 of 3,
the first cut to 2), which take the checkpointed path; and at width 1 /
depth 31 (P = 64), whose column would not fit a block's shared memory, so
that it keeps the register path.
The header compiles as C++17 once a shim defines CUDA's function
qualifiers and a stub ``cuda_runtime.h`` gives the few runtime names that
``lane_common.cuh`` uses; ``-ffp-contract=off`` keeps every multiply and
add rounding on its own, as ``--fmad=false`` does on the card.  sigmoid
and tanh are left to the card: the host's ``expf``/``tanhf`` are not
CUDA's.

Skips where no C++ compiler is installed.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from srnn_tpu_torch import Topology
from srnn_tpu_torch.ops.cuda_rnn_train import (rnn_apply_rows_plain,
                                               rnn_sgd_plain)
from test_torch_kvec_host import (CSRC, CUDA_RUNTIME_STUB, SHIM,
                                  _assert_bitwise, _ptr, _rows)

N = 256
LR = 0.01
ACTS = {"linear": 0, "relu": 3}
#: (width, depth, checkpointed, steps a segment) of each harness build
SHAPES = {"w2d2": (2, 2, False, 4),
          "w3d3": (3, 3, True, 4),
          "w2d6": (2, 6, True, 4),
          "w7d1": (7, 1, True, 4),
          "w1d15": (1, 15, True, 3),
          "w1d31": (1, 31, False, 1)}
#: floats of a block's column past which a build keeps the register path
MAX_COLUMN = (232448 - 1024) // (128 * 4)

HARNESS = """
#include <math.h>

#include "rnn_common.cuh"

namespace {
constexpr int W = SRNN_W, D = SRNN_D, P = srnn::RNN<W, D>::P;
using K = srnn::Checkpoints<W, D>;
constexpr int kColumn = K::kColumnFloats > 0 ? K::kColumnFloats : 1;

template <int A>
int sgd(const float* wT, const float* otherT, float* out, float* loss,
        long long n, int epochs, float lr) {
  for (long long i = 0; i < n; ++i) {
    float rows[P], target[P], column[kColumn];
    for (int k = 0; k < kColumn; ++k) column[k] = NAN;
    const srnn::Column<1> col{column};
    for (int r = 0; r < P; ++r) {
      rows[r] = wT[r * n + i];
      target[r] = otherT ? otherT[r * n + i] : 0.0f;
    }
    loss[i] = otherT
        ? srnn::rnn_sgd<W, D, A, false>(rows, target, epochs, lr, col)
        : srnn::rnn_sgd<W, D, A, true>(rows, rows, epochs, lr, col);
    for (int r = 0; r < P; ++r) out[r * n + i] = rows[r];
  }
  return 0;
}

// K3's learn_from then self-training: on the checkpointed path one chain
// toward the target staged in the column, on the register path two calls
template <int A>
int chain(const float* wT, const float* otherT, float* out, float* loss,
          long long n, int learned, int epochs, float lr) {
  for (long long i = 0; i < n; ++i) {
    float rows[P], target[P], column[kColumn];
    for (int k = 0; k < kColumn; ++k) column[k] = NAN;
    const srnn::Column<1> col{column};
    for (int r = 0; r < P; ++r) {
      rows[r] = wT[r * n + i];
      target[r] = otherT[r * n + i];
    }
    if constexpr (K::kCheckpointed) {
      for (int r = 0; r < P; ++r) col[r] = target[r];
      loss[i] = srnn::rnn_sgd_checkpointed<W, D, A>(rows, learned, epochs,
                                                    lr, col);
    } else {
      loss[i] = srnn::rnn_sgd<W, D, A, false>(rows, target, learned, lr, col);
      if (epochs > 0)
        loss[i] = srnn::rnn_sgd<W, D, A, true>(rows, rows, epochs, lr, col);
    }
    for (int r = 0; r < P; ++r) out[r * n + i] = rows[r];
  }
  return 0;
}

template <int A>
int apply(const float* selfT, const float* xT, float* out, long long n,
          int in_column) {
  for (long long i = 0; i < n; ++i) {
    float self[P], x[P], o[P], column[P];
    for (int r = 0; r < P; ++r) {
      self[r] = selfT[r * n + i];
      x[r] = xT[r * n + i];
    }
    if (in_column) {
      const srnn::Column<1> col{column};
      for (int r = 0; r < P; ++r) col[r] = x[r];
      srnn::rnn_apply_column<W, D, A>(self, col);
      for (int r = 0; r < P; ++r) o[r] = col[r];
    } else {
      srnn::rnn_apply_streamed<W, D, A, P>(self, x, o);
    }
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
extern "C" int host_checkpointed() { return K::kCheckpointed ? 1 : 0; }
extern "C" int host_segment_steps() { return K::C; }
extern "C" int host_column_floats() { return K::kColumnFloats; }

extern "C" int host_sgd(int act, const float* wT, const float* otherT,
                        float* out, float* loss, long long n, int epochs,
                        float lr) {
  HOST_ACT(act, return sgd<A>(wT, otherT, out, loss, n, epochs, lr));
}

extern "C" int host_chain(int act, const float* wT, const float* otherT,
                          float* out, float* loss, long long n, int learned,
                          int epochs, float lr) {
  HOST_ACT(act, return chain<A>(wT, otherT, out, loss, n, learned, epochs,
                                lr));
}

extern "C" int host_apply(int act, const float* selfT, const float* xT,
                          float* out, long long n, int in_column) {
  HOST_ACT(act, return apply<A>(selfT, xT, out, n, in_column));
}
"""


class Host:
    """A harness build: its library and the shape it was built for."""

    def __init__(self, h, width, depth, checkpointed, steps):
        self.h, self.shape = h, (width, depth)
        self.checkpointed, self.steps = checkpointed, steps

    def __getattr__(self, name):
        return getattr(self.h, name)

    def topo(self, **kw):
        w, d = self.shape
        return Topology("recurrent", width=w, depth=d, **kw)


@pytest.fixture(scope="module", params=list(SHAPES))
def lib(request, tmp_path_factory):
    width, depth, checkpointed, steps = SHAPES[request.param]
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host to build rnn_common.cuh")
    d = tmp_path_factory.mktemp(f"rnn_host_{request.param}")
    (d / "shim.h").write_text(SHIM)
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "rnn_host.so"
    cmd = [cxx, "-std=c++17", "-O0", "-ffp-contract=off", "-fPIC", "-shared",
           "-Wno-unknown-pragmas", "-include", str(d / "shim.h"), "-I",
           str(d), "-I", str(CSRC), f"-DSRNN_W={width}", f"-DSRNN_D={depth}",
           "-o", str(so), str(d / "harness.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    h = ctypes.CDLL(str(so))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    h.host_sgd.argtypes = [i, p, p, p, p, ll, i, f]
    h.host_apply.argtypes = [i, p, p, p, ll, i]
    h.host_chain.argtypes = [i, p, p, p, p, ll, i, i, f]
    return Host(h, width, depth, checkpointed, steps)


def _population(topo, seed: int) -> np.ndarray:
    """(P, N) float32 lanes from numpy, scaled so that most lanes' 52-step
    chains stay finite; edge cases in the first lanes."""
    p = topo.num_weights
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((p, N)) * (0.5 / np.sqrt(topo.width))).astype(
        np.float32)
    w[p - 1, 0] = np.inf      # the last layer's recurrent weight
    w[9, 1] = np.nan
    w[:, 2] = -0.0            # a lane of -0 rows
    w[0, 3] = -0.0            # the first kernel weight -0
    return np.ascontiguousarray(w)


def test_build_takes_its_path(lib):
    """The build's path and column: the register path at P = 17 (no
    column), the checkpointed one at the wide shapes, with segments of as
    many steps as a 72-float buffer of their states holds and a column of
    the sample and one checkpoint of D * W + 1 floats a segment."""
    p = lib.topo().num_weights
    width, depth = lib.shape
    assert lib.host_weights() == p
    assert lib.host_checkpointed() == int(lib.checkpointed)
    assert lib.host_segment_steps() == lib.steps
    column = p + -(-p // lib.steps) * (depth * width + 1)
    assert lib.host_column_floats() == (column if lib.checkpointed else 0)
    if lib.shape == (1, 31):
        # over the live limit, but its column (2,112 floats) would not fit
        assert column > MAX_COLUMN
    elif lib.checkpointed:
        assert column <= MAX_COLUMN


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("mode,epochs", [("train", 1), ("train", 3),
                                         ("learn", 1), ("learn", 3)])
def test_rnn_sgd_bitwise(lib, activation, mode, epochs):
    topo = lib.topo(activation=activation)
    w = _population(topo, 2)
    other = _population(topo, 3) if mode == "learn" else None
    got = np.empty_like(w)
    loss = np.empty(N, dtype=np.float32)
    assert lib.host_sgd(ACTS[activation], _ptr(w),
                        None if other is None else _ptr(other), _ptr(got),
                        _ptr(loss), N, epochs, LR) == 0
    ref_w, ref_l = rnn_sgd_plain(
        topo, torch.from_numpy(w),
        None if other is None else torch.from_numpy(other), epochs, LR)
    # the chains stay finite on most lanes, so the comparison has teeth
    assert np.isfinite(ref_w.numpy()).all(axis=0).mean() > 0.9
    _assert_bitwise(got, ref_w.numpy())
    _assert_bitwise(loss, ref_l.numpy())


@pytest.mark.parametrize("activation", list(ACTS))
@pytest.mark.parametrize("learned,epochs", [(1, 3), (2, 0), (0, 2)])
def test_learn_then_train_bitwise(lib, activation, learned, epochs):
    """K3's learn_from then self-training: ``learned`` imitation epochs,
    then ``epochs`` self-training epochs, on the checkpointed path one
    chain (``rnn_sgd_checkpointed``) toward the target staged in the
    column; the plain imitation chain, then the plain self-training
    chain, and the last epoch's loss."""
    topo = lib.topo(activation=activation)
    w, other = _population(topo, 6), _population(topo, 7)
    got = np.empty_like(w)
    loss = np.empty(N, dtype=np.float32)
    assert lib.host_chain(ACTS[activation], _ptr(w), _ptr(other), _ptr(got),
                          _ptr(loss), N, learned, epochs, LR) == 0
    ref_w, ref_l = rnn_sgd_plain(topo, torch.from_numpy(w),
                                 torch.from_numpy(other), learned, LR)
    if epochs:
        ref_w, ref_l = rnn_sgd_plain(topo, ref_w, None, epochs, LR)
    _assert_bitwise(got, ref_w.numpy())
    _assert_bitwise(loss, ref_l.numpy())


@pytest.mark.parametrize("in_column", [False, True],
                         ids=["streamed", "column"])
@pytest.mark.parametrize("activation", list(ACTS))
def test_rnn_apply_bitwise(lib, activation, in_column):
    topo = lib.topo(activation=activation)
    self_w, x = _population(topo, 4), _population(topo, 5)
    # an attacker of -0 weights on an all-negative victim
    self_w[:, 4] = -0.0
    x[:, 4] = -np.abs(x[:, 4]) - np.float32(0.5)
    got = np.empty_like(x)
    assert lib.host_apply(ACTS[activation], _ptr(self_w), _ptr(x), _ptr(got),
                          N, int(in_column)) == 0
    ref = torch.stack(rnn_apply_rows_plain(topo, _rows(self_w),
                                           _rows(x))).numpy()
    _assert_bitwise(got, ref)
