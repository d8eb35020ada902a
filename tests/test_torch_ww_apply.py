"""K1's plain version and the row-major transform against the JAX package:
``ww_apply_population`` runs the Pallas kernel in interpret mode, as the JAX
package's own tests run it on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu.nets import apply_to_weights
from srnn_tpu.ops.pallas_ww import ww_apply_population as j_apply_population
from srnn_tpu.ops.predicates import is_fixpoint as j_is_fixpoint
from srnn_tpu_torch import Topology
from srnn_tpu_torch.init import glorot_limit_rows
from srnn_tpu_torch.nets import weightwise as tww
from srnn_tpu_torch.ops import cuda_ww
from srnn_tpu_torch.ops.predicates import is_fixpoint
from tests.test_apply import identity_fixpoint_flat

ACTIVATIONS = ["linear", "sigmoid", "tanh", "relu"]
RTOL, ATOL = 1e-5, 1e-7  # tests/test_pallas_ww.py


def _pop(topo, n, seed, scale):
    """(P, n) float32 glorot population times ``scale``, from numpy."""
    rng = np.random.default_rng(seed)
    lim = glorot_limit_rows(topo)
    return (rng.uniform(-1, 1, (topo.num_weights, n)) * lim[:, None]
            * scale).astype(np.float32)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_matches_pallas_interpret(activation, steps):
    topo = Topology("weightwise", activation=activation)
    wT = _pop(topo, 300, 0, 0.3)  # 300: not a multiple of 128 or of a block
    ref = j_apply_population(JTopology("weightwise", activation=activation),
                             jnp.asarray(wT), steps=steps, interpret=True)
    got = cuda_ww.ww_apply_population(topo, torch.from_numpy(wT), steps)
    assert got.shape == (14, 300) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert cuda_ww.WW_APPLY.launches == 0  # CPU tensors never launch


def test_identity_fixpoint_exact():
    ident = identity_fixpoint_flat()
    topo = Topology("weightwise")
    wT = torch.from_numpy(np.tile(ident[:, None], (1, 8)))
    out = cuda_ww.ww_apply_population(topo, wT, steps=10)
    assert torch.equal(out, wT)
    flat = torch.from_numpy(ident)
    assert bool(is_fixpoint(lambda t: tww.apply(topo, flat, t), flat, 1,
                            epsilon=1e-6))
    jt = JTopology("weightwise")
    jflat = jnp.asarray(ident)
    assert bool(j_is_fixpoint(lambda t: apply_to_weights(jt, jflat, t),
                              jflat, 1, epsilon=1e-6))


@pytest.mark.parametrize("activation", ["linear", "tanh"])
def test_rowmajor_apply_matches_jax(activation):
    topo = Topology("weightwise", activation=activation)
    w = _pop(topo, 64, 1, 0.3).T.copy()
    jt = JTopology("weightwise", activation=activation)
    ref = jax.vmap(lambda x: apply_to_weights(jt, x, x))(jnp.asarray(w))
    got = tww.apply(topo, torch.from_numpy(w), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_wrapper_rejects_what_kernels_do_not_take():
    topo = Topology("weightwise")
    with pytest.raises(ValueError, match="float32"):
        cuda_ww.ww_apply_population(topo, torch.zeros(14, 4,
                                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="variant"):
        cuda_ww.ww_apply_population(Topology("aggregating"),
                                    torch.zeros(16, 4))
    with pytest.raises(ValueError, match="population"):
        cuda_ww.ww_apply_population(topo, torch.zeros(13, 4))
