"""The port's row-major mixed soup (``layout='rowmajor'``, the default of
both packages) against the JAX package's ``_evolve_multi_step``, fed the
JAX package's own draws; ``evolve_multi`` in both layouts; the mixed
checkpoints.

Three JAX configurations, one compile each in a module-scoped fixture: the
four width-2 variants at sizes (6, 5, 4, 5) in float32 (as
tests/test_cross.py:143-150), weightwise and aggregating types in
bfloat16, weightwise and fft types in int8; the recurrent type runs
sigmoid (tests/test_torch_multisoup.py).  Both packages start from the
port's seed with a zero particle and a diverged one planted in the
weightwise type, so that both respawns happen and a diverged particle
attacks.  The draws are
replayed from the JAX state's key as ``multisoup._evolve_multi_step``
makes them (the row-major ``fresh_rows`` is ``fresh_lanes`` transposed).

Bounds (tests/test_torch_soup_rowmajor.py): integer state (uids, next_uid,
time, actions, counterparts) and ``count_multi`` exact; float32 weights
rtol 2e-5 / atol 1e-6 every generation, losses rtol 1e-4 / atol 1e-6;
bfloat16 weights within one bfloat16 ulp; int8 codes within one step and
scales within rtol 2e-5.  Inside the port every comparison is bitwise.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import multisoup as jms
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
import srnn_tpu_torch as st
from srnn_tpu_torch import convert, experiment
from srnn_tpu_torch import multisoup as ms
from srnn_tpu_torch.setups import common

GENERATIONS = 3
SIG_RNN = JTopology("recurrent", width=2, depth=2, activation="sigmoid")
WW = JTopology("weightwise", width=2, depth=2)
AGG = JTopology("aggregating", width=2, depth=2, aggregates=4)
FFT = JTopology("fft", width=2, depth=2, aggregates=4)
BASE = jms.MultiSoupConfig(
    topos=(WW, AGG, FFT, SIG_RNN), sizes=(6, 5, 4, 5), attacking_rate=0.5,
    learn_from_rate=0.3, learn_from_severity=2, train=2,
    remove_divergent=True, remove_zero=True)
CONFIGS = {
    "four": BASE,
    "bf16": BASE._replace(topos=(WW, AGG), sizes=(8, 7),
                          population_dtype="bf16"),
    "int8": BASE._replace(topos=(WW, FFT), sizes=(8, 7),
                          population_dtype="int8"),
}
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


def jax_multi_draws(cfg):
    """A function of the state's key giving one JAX mixed generation's
    draws, either layout (multisoup.py:152-156, :484-530), jitted: eager,
    each type's first ``fresh_lanes`` costs seconds of small compiles."""
    def draws(key):
        n = cfg.total
        _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
        re_keys = jax.random.split(k_re, len(cfg.topos))
        return (
            jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate,
            jax.random.randint(k_at, (n,), 0, n),
            jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate,
            tuple(jax.random.randint(jax.random.fold_in(k_lt, t), (n_t,), 0,
                                     n_t)
                  for t, n_t in enumerate(cfg.sizes)),
            tuple(j_fresh_lanes(topo, re_keys[t], n_t, cfg.respawn_draws)
                  for t, (topo, n_t) in enumerate(zip(cfg.topos,
                                                      cfg.sizes))))

    jitted = jax.jit(draws)
    return lambda key: ms.MultiSoupDraws(
        *jax.tree.map(np.asarray, jitted(key)))


def port_multi_config(jcfg, **kw):
    fields = jcfg._asdict()
    fields["topos"] = [dataclasses.asdict(t) for t in jcfg.topos]
    return convert.multisoup_config_from_fields(fields)._replace(**kw)


def port_multi_state(js):
    return convert.multisoup_state_from_arrays(
        [np.asarray(w) for w in js.weights], [np.asarray(u) for u in js.uids],
        int(js.next_uid), int(js.time), device="cpu",
        scales=None if js.scales is None
        else [np.asarray(s) for s in js.scales])


def _start(jcfg):
    """The port's seed (3) with weightwise particle 0 all zero and particle
    1 diverged, so that both respawns happen and a diverged particle
    attacks; and the same state as the JAX package's (seeding there
    compiles its initializers, the slowest part of a cold run)."""
    ps = ms.seed_multi(port_multi_config(jcfg), 3, device="cpu")
    w0 = ps.weights[0].clone()
    w0[0] = 0
    scales = None if ps.scales is None else list(ps.scales)
    if scales is None:
        w0[1, 3] = float("inf")
    else:
        w0[1] = 127  # int8: a diverged particle's codes and scale
        scales[0] = scales[0].clone()
        scales[0][1] = float("inf")
        scales = tuple(scales)
    ps = ps._replace(weights=(w0,) + ps.weights[1:], scales=scales)
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16,
             "int8": jnp.int8}[jcfg.population_dtype]
    js = jms.MultiSoupState(
        weights=tuple(jnp.asarray(w.float().numpy() if w.is_floating_point()
                                  else w.numpy(), dtype=dtype)
                      for w in ps.weights),
        uids=tuple(jnp.asarray(u.numpy()) for u in ps.uids),
        next_uid=jnp.int32(jcfg.total), time=jnp.int32(0),
        key=jax.random.key(3),
        scales=None if scales is None
        else tuple(jnp.asarray(sc.numpy()) for sc in scales))
    return ps, js


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request):
    """Three JAX row-major generations of one configuration: (name, config,
    the port's start, [(the generation's draws, state after, events)])."""
    cfg = CONFIGS[request.param]
    ps, s = _start(cfg)
    draws_of = jax_multi_draws(cfg)
    steps = []
    for _ in range(GENERATIONS):
        s2, ev = jms.evolve_multi_step(cfg, s)
        steps.append((draws_of(s.key), s2, ev))
        s = s2
    return request.param, cfg, ps, steps


def _check_weights(cfg, got, ref, msg):
    ref = np.asarray(ref)
    if cfg.population_dtype == "bf16":
        assert got.dtype == torch.bfloat16, msg
        np.testing.assert_allclose(got.float().numpy(),
                                   ref.astype(np.float32), **BF16_TOL,
                                   err_msg=msg)
    elif cfg.population_dtype == "int8":
        assert got.dtype == torch.int8, msg
        off = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
        assert off.max() <= 1, msg
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=1e-6,
                                   err_msg=msg)


def _check_generation(cfg, state, ev, after, jev, msg):
    for field in ("next_uid", "time"):
        assert int(getattr(state, field)) == int(getattr(after, field)), msg
    for t in range(len(cfg.topos)):
        m = f"{msg} type {t}"
        np.testing.assert_array_equal(state.uids[t].numpy(),
                                      np.asarray(after.uids[t]), m)
        np.testing.assert_array_equal(ev.action[t].numpy(),
                                      np.asarray(jev.action[t]), m)
        np.testing.assert_array_equal(ev.counterpart[t].numpy(),
                                      np.asarray(jev.counterpart[t]), m)
        np.testing.assert_allclose(ev.loss[t].numpy(),
                                   np.asarray(jev.loss[t]), rtol=1e-4,
                                   atol=1e-6, err_msg=m)
        _check_weights(cfg, state.weights[t], after.weights[t], m)
        if state.scales is not None:
            np.testing.assert_allclose(state.scales[t].numpy(),
                                       np.asarray(after.scales[t]),
                                       rtol=2e-5, err_msg=m)


def test_rowmajor_multisoup_matches_jax(jax_run):
    """The port's row-major ``evolve_multi_step`` chain on JAX's draws
    against JAX's row-major generations, generation by generation, and
    ``count_multi`` of the last (the four-type mix: one more JAX
    compile)."""
    name, jcfg, state, steps = jax_run
    cfg = port_multi_config(jcfg)
    assert (cfg.layout, cfg.train_impl, cfg.apply_impl) == (
        "rowmajor", "plain", "plain")
    for g, (draws, after, jev) in enumerate(steps):
        state, ev = ms.evolve_multi_step(cfg, state, draws)
        _check_generation(cfg, state, ev, after, jev, f"{name} gen {g}")
    if name != "four":
        return
    final = steps[-1][1]
    np.testing.assert_array_equal(
        ms.count_multi(cfg, port_multi_state(final)).numpy(),
        np.asarray(jms.count_multi(jcfg, final)))
    np.testing.assert_array_equal(ms.count_multi(cfg, state).numpy(),
                                  np.asarray(jms.count_multi(jcfg, final)))


@pytest.mark.parametrize("layout", ["rowmajor", "popmajor"])
def test_evolve_multi_matches_steps(jax_run, layout, monkeypatch):
    """``evolve_multi`` over three generations in either layout, its
    generator's draws replaced by JAX's: the row-major run equals the
    port's own step chain bitwise and JAX's last state within the bounds;
    the population-major one equals its own step chain bitwise."""
    name, jcfg, start, steps = jax_run
    cfg = port_multi_config(jcfg, layout=layout)
    draws = [dr for dr, _, _ in steps]
    chain = start
    for dr in draws:
        chain, _ = ms.evolve_multi_step(cfg, chain, dr)
    feed = iter(draws)
    monkeypatch.setattr(ms, "draw_multi", lambda config, gen, device:
                        ms._resolve_draws(config, None, device, next(feed)))
    got = ms.evolve_multi(cfg, start, GENERATIONS)
    assert int(start.time) == 0  # the caller's state is left as it was
    assert int(got.time) == GENERATIONS
    assert torch.equal(got.next_uid, chain.next_uid)
    for t in range(len(cfg.topos)):
        assert torch.equal(got.weights[t], chain.weights[t])
        assert torch.equal(got.uids[t], chain.uids[t])
    if layout == "rowmajor":
        after = steps[-1][1]
        for t in range(len(cfg.topos)):
            _check_weights(cfg, got.weights[t], after.weights[t], name)


def _mega_config(**kw):
    topos = (st.Topology("weightwise", width=2, depth=2),
             st.Topology("aggregating", width=2, depth=2, aggregates=4))
    return ms.MultiSoupConfig(topos=topos, sizes=(9, 8), attacking_rate=0.4,
                              learn_from_rate=0.3, learn_from_severity=1,
                              train=2, remove_divergent=True,
                              remove_zero=True, **kw)


def _equal(a, b) -> bool:
    fields = [(a.next_uid, b.next_uid), (a.time, b.time)]
    fields += list(zip(a.weights, b.weights)) + list(zip(a.uids, b.uids))
    if (a.scales is None) != (b.scales is None):
        return False
    if a.scales is not None:
        fields += list(zip(a.scales, b.scales))
    return all(torch.equal(x, y) for x, y in fields)


def test_rowmajor_equals_popmajor_and_defaults():
    """From one seed (so one stream of draws), the row-major mixed soup of
    weightwise and aggregating types equals the population-major phase
    chain bitwise (their cross transforms sum alike); the defaults are
    JAX's; the row-major refusals are JAX's."""
    topos = (st.Topology("weightwise"), st.Topology("recurrent"))
    default = ms.MultiSoupConfig(topos=topos, sizes=(4, 4))
    assert (default.layout, default.generation_impl, default.train_impl,
            default.apply_impl) == ("rowmajor", "phases", "plain", "plain")
    s = ms.seed_multi(default, 0, device="cpu")
    assert int(ms.evolve_multi(default, s, 2).time) == 2
    cfg = _mega_config()
    s0 = ms.seed_multi(cfg, 5, device="cpu")
    row = ms.evolve_multi(cfg, s0, 3)
    pop = ms.evolve_multi(cfg._replace(layout="popmajor"), s0, 3)
    assert _equal(row, pop)
    uids = torch.cat(row.uids)
    assert int(torch.unique(uids).numel()) == cfg.total
    assert int(uids.max()) < int(row.next_uid)
    counts = ms.count_multi(cfg, row)
    assert counts.sum(dim=1).tolist() == list(cfg.sizes)
    assert not ms.fused_supported_multi(cfg)
    assert ms.fused_supported_multi(cfg._replace(layout="popmajor"))
    for bad, match in ((dict(generation_impl="fused"), "megakernel"),
                       (dict(train_impl="kernel"), "train_impl"),
                       (dict(apply_impl="kernel"), "apply_impl"),
                       (dict(layout="columnar"), "layout")):
        with pytest.raises(ValueError, match=match):
            ms.evolve_multi_step(cfg._replace(**bad), s0)
        with pytest.raises(ValueError, match=match):
            ms.evolve_multi(cfg._replace(**bad), s0, 1)
    # the popmajor layout keeps its spellings; the fused generation already
    # fuses the per-type kernels, so their 'kernel' spellings beside it are
    # refused, as the JAX package refuses 'pallas'
    fused = cfg._replace(layout="popmajor", generation_impl="fused")
    assert int(ms.evolve_multi(fused, s0, 1).time) == 1
    for field in ("train_impl", "apply_impl"):
        with pytest.raises(ValueError, match="already fuses"):
            ms.evolve_multi(fused._replace(**{field: "kernel"}), s0, 1)


@pytest.mark.parametrize("layout,dtype", [("rowmajor", "f32"),
                                          ("rowmajor", "int8"),
                                          ("popmajor", "bf16")])
def test_multi_checkpoint_round_trip(tmp_path, layout, dtype):
    """Evolve 3 generations, save, restore, evolve 2 more: equal to 5
    generations in one go, bitwise, the generator's stream included; a
    directory without its marker is never trusted, and the soup and mixed
    checkpoints do not read as each other."""
    cfg = _mega_config(layout=layout, population_dtype=dtype)
    s0 = ms.seed_multi(cfg, 9, device="cpu")
    mid = ms.evolve_multi(cfg, s0, 3)
    path = experiment.save_multi_checkpoint(str(tmp_path / "ckpt-gen3"), mid)
    assert common.checkpoint_intact(path)
    back = experiment.restore_multi_checkpoint(path)
    assert _equal(back, mid)
    assert torch.equal(back.key.get_state(), mid.key.get_state())
    assert _equal(ms.evolve_multi(cfg, back, 2), ms.evolve_multi(cfg, s0, 5))
    # overwriting a checkpoint, a torn one, and the other kind
    experiment.save_multi_checkpoint(path, ms.evolve_multi(cfg, back, 1))
    assert int(experiment.restore_multi_checkpoint(path).time) == 4
    torn = tmp_path / "ckpt-gen7"
    experiment.save_multi_checkpoint(str(torn), mid)
    os.remove(torn / experiment.CKPT_OK_MARKER)
    assert not common.checkpoint_intact(str(torn))
    assert common.latest_checkpoint(str(tmp_path)) == path
    with pytest.raises(ValueError, match="multisoup"):
        experiment.restore_checkpoint(path)
    soup_cfg = st.SoupConfig(topo=st.Topology("weightwise"), size=4)
    soup_path = experiment.save_checkpoint(
        str(tmp_path / "soup"), st.seed(soup_cfg, 0, device="cpu"))
    with pytest.raises(ValueError, match="soup"):
        experiment.restore_multi_checkpoint(soup_path)
