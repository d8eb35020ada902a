"""The weightwise full batch (``train_mode='full_batch'``: one step an
epoch on the mean loss over the P samples), which the JAX package takes
with ``jax.grad`` and the port with a hand-derived step in plain torch
(``ops/popmajor.ww_full_batch_epochs``), against the JAX package's soups
in the two spellings the port added: the population-major phase chain
(``_evolve_parallel_popmajor`` over ``ww_fit_epoch_popmajor``,
``srnn_tpu/ops/popmajor.py:91-136``) and the sequential mode; inside the
port, both layouts of the parallel soup bitwise against each other.

Two JAX configurations, one compile each in a module-scoped fixture: 16
weightwise particles, 3 generations of attack 0.3, learn_from 0.3
(severity 2), train 2, both removals, from the port's seed with particle 0
all zero and particle 1 diverged.  Bounds as in
tests/test_torch_soup_sequential.py: integers exact, float32 weights
rtol 2e-5 / atol 1e-6, losses rtol 1e-4 / atol 1e-6, each generation
taken from JAX's state before it: these linear particles' weights grow by
three orders of magnitude in one generation, and run on from the port's
own state they carry the packages' last-bit differences past rtol 2e-5
by the second generation.
"""

import jax
import numpy as np
import pytest
import torch

from srnn_tpu.init import fresh_lanes as j_fresh_lanes
import srnn_tpu_torch as st
from srnn_tpu_torch import convert
from srnn_tpu_torch.ops import popmajor
from test_torch_soup_sequential import (JCFG, check_generation,
                                        jax_generations,
                                        jax_sequential_draws, port_config,
                                        start)

FULL = JCFG._replace(size=16, train_mode="full_batch", learn_from_severity=2)
CONFIGS = {
    "sequential": FULL,
    "popmajor": FULL._replace(mode="parallel", layout="popmajor"),
}


def jax_parallel_draws(cfg):
    """One JAX parallel generation's draws (``soup.py:553-614``),
    jitted."""
    n = cfg.size

    def draws(key):
        _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
        return (jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate,
                jax.random.randint(k_at, (n,), 0, n),
                jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate,
                jax.random.randint(k_lt, (n,), 0, n),
                j_fresh_lanes(cfg.topo, k_re, n, cfg.respawn_draws))

    jitted = jax.jit(draws)
    return lambda key: st.SoupDraws(*(np.asarray(x) for x in jitted(key)))


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request):
    jcfg = CONFIGS[request.param]
    ps, js = start(jcfg)
    draws_of = (jax_sequential_draws if jcfg.mode == "sequential"
                else jax_parallel_draws)(jcfg)
    return request.param, jcfg, ps, jax_generations(jcfg, draws_of, js)


def test_full_batch_soup_matches_jax(jax_run):
    """The port's sequential and population-major weightwise full-batch
    soups on JAX's draws against JAX's, each generation from JAX's state
    before it."""
    name, jcfg, state, steps = jax_run
    cfg = port_config(jcfg)
    assert cfg.train_mode == "full_batch"
    for g, (draws, after, jev) in enumerate(steps):
        got, ev = st.evolve_step(cfg, state, draws)
        check_generation(got, ev, after, jev, f"{name} gen {g}")
        state = convert.soup_state_from_arrays(
            np.asarray(after.weights), np.asarray(after.uids),
            int(after.next_uid), int(after.time), device="cpu")


def test_full_batch_layouts_agree_and_fused_refuses():
    """From one seed the row-major and population-major full-batch soups
    are one soup, bitwise (the same step on the same lanes); the fused
    route refuses the weightwise full batch, as the JAX package's does
    (``soup._check_popmajor``);
    the step itself: the soup's train call is ``ww_full_batch_epochs``,
    and a row's full-batch epoch in ``train.py`` is the same."""
    cfg = port_config(FULL, mode="parallel")
    s0, _ = start(FULL)
    row = st.evolve(cfg, s0, 3)
    pop = st.evolve(cfg._replace(layout="popmajor"), s0, 3)
    assert torch.equal(row.weights, pop.weights)
    assert torch.equal(row.uids, pop.uids)
    with pytest.raises(ValueError, match="full_batch"):
        st.evolve_step(cfg._replace(layout="popmajor",
                                    generation_impl="fused"), s0)
    wT = row.weights.t().contiguous()
    got = popmajor.train_epochs_popmajor(cfg.topo, wT, 3,
                                         mode="full_batch")
    ref = popmajor.ww_full_batch_epochs(cfg.topo, wT, 3)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    flat, loss = st.train.fit_epochs_flat(cfg.topo, row.weights, 3,
                                          mode="full_batch")
    assert torch.equal(flat, ref[0].t()) and torch.equal(loss, ref[1])
