"""The port's small analysis utilities against the JAX package's
(``srnn_tpu_torch/utils/{debug,profiling,printing}.py``).

  * ``divergence_onset`` against JAX's on JAX's own draws (N = 8, 4
    generations, one slot non-finite at the start, the removals on in the
    config and so turned off by the probe): the onsets, uids, next_uid and
    time exact; the weights within the generation tolerance of
    tests/test_torch_soup.py (rtol 2e-5 / atol 1e-6) with the non-finite
    pattern exact.  The JAX reference runs its phase chain (its fused
    spelling is that chain on the CPU); the port runs both spellings.
  * ``checked_apply_to_weights`` raises exactly where JAX's ``checkify``
    raises, and returns JAX's weights within rtol 1e-6 where neither does.
  * ``timed``'s keys and ``warmup`` semantics, ``trace`` writes a non-empty
    file, ``phase`` is a named range, and ``PrintingObject``'s surface.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from srnn_tpu import Topology as JTopology
from srnn_tpu import soup as jsoup
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
from srnn_tpu.utils import debug as jdebug
from srnn_tpu.utils.printing import PrintingObject as JPrintingObject
import srnn_tpu_torch as st
from srnn_tpu_torch import convert
from srnn_tpu_torch.utils import (NonFiniteOutputError, PrintingObject,
                                  checked_apply_to_weights, divergence_onset,
                                  phase, timed, trace)

GENERATIONS = 4
JCFG = jsoup.SoupConfig(
    topo=JTopology("weightwise", width=2, depth=2), size=8,
    attacking_rate=0.5, learn_from_rate=0.5, learn_from_severity=1, train=1,
    remove_divergent=True, remove_zero=True, layout="popmajor")
DEAD_SLOT = 2


def _port_config(jcfg, **kw):
    import dataclasses

    fields = jcfg._asdict()
    fields["topo"] = dataclasses.asdict(jcfg.topo)
    return convert.soup_config_from_fields(fields)._replace(**kw)


@pytest.fixture(scope="module")
def jax_onset():
    """JAX's divergence_onset and the draws of each of its generations
    (replayed from the key as ``soup._evolve_parallel_popmajor`` makes
    them: the state's key advances to the first of its six splits)."""
    # the state built by hand (an eager jsoup.seed compiles for seconds)
    w = np.random.default_rng(5).uniform(
        -0.7, 0.7, (JCFG.size, JCFG.topo.num_weights)).astype(np.float32)
    w[DEAD_SLOT] = np.nan
    s = jsoup.SoupState(jnp.asarray(w), jnp.arange(JCFG.size, dtype=jnp.int32),
                        jnp.int32(JCFG.size), jnp.int32(0), jax.random.key(5))
    onset, final = jdebug.divergence_onset(JCFG, s, GENERATIONS)
    probe = JCFG._replace(remove_divergent=False, remove_zero=False)
    n = JCFG.size

    @jax.jit
    def draws(key):
        nxt, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
        return nxt, (jax.random.uniform(k_ag, (n,)) < probe.attacking_rate,
                     jax.random.randint(k_at, (n,), 0, n),
                     jax.random.uniform(k_lg, (n,)) < probe.learn_from_rate,
                     jax.random.randint(k_lt, (n,), 0, n),
                     j_fresh_lanes(probe.topo, k_re, n, probe.respawn_draws))

    key, per_gen = s.key, []
    for _ in range(GENERATIONS):
        key, d = draws(key)
        per_gen.append(st.SoupDraws(*(np.asarray(x) for x in d)))
    return s, np.asarray(onset), final, per_gen


@pytest.mark.parametrize("impl", ["phases", "fused"])
def test_divergence_onset_matches_jax(jax_onset, impl):
    s, onset, final, draws = jax_onset
    state = convert.soup_state_from_arrays(
        np.asarray(s.weights), np.asarray(s.uids), int(s.next_uid),
        int(s.time), device="cpu")
    cfg = _port_config(JCFG, generation_impl=impl)
    got, got_final = divergence_onset(cfg, state, GENERATIONS, draws)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), onset)
    # the run is one that shows each case: the slot dead at the start, a
    # slot that diverges on the way, and one that never does
    assert onset[DEAD_SLOT] == 0 and (onset > 0).any() and (onset < 0).any()
    for field in ("uids", "next_uid", "time"):
        np.testing.assert_array_equal(getattr(got_final, field).numpy(),
                                      np.asarray(getattr(final, field)))
    w, jw = got_final.weights.numpy(), np.asarray(final.weights)
    np.testing.assert_array_equal(np.isfinite(w), np.isfinite(jw))
    np.testing.assert_allclose(w, jw, rtol=2e-5, atol=1e-6)
    # the caller's state is left as it was
    assert bool(torch.isnan(state.weights[DEAD_SLOT]).all())
    assert int(state.time) == 0


def test_divergence_onset_own_draws_matches_step_recount():
    """Without draws: the onsets equal a recount over evolve_step calls of
    the same state (one generator stream), and a wrong draw count is
    refused."""
    cfg = _port_config(JCFG, generation_impl="fused")
    state = st.seed(cfg, 9, device="cpu")
    state = state._replace(weights=state.weights.clone())
    state.weights[DEAD_SLOT] = float("inf")
    onset, final = divergence_onset(cfg, state, GENERATIONS)
    probe = cfg._replace(remove_divergent=False, remove_zero=False)
    want = np.where(np.isfinite(state.weights.numpy()).all(1), -1, 0)
    s = state
    for _ in range(GENERATIONS):
        s, _ = st.evolve_step(probe, s)
        bad = ~np.isfinite(s.weights.numpy()).all(1)
        want = np.where((want < 0) & bad, int(s.time), want)
    np.testing.assert_array_equal(onset.numpy(), want)
    assert torch.equal(final.weights.nan_to_num(7.0),
                       s.weights.nan_to_num(7.0))
    with pytest.raises(ValueError, match="draws holds 1 generations"):
        divergence_onset(cfg, state, 2, draws=[None])


def _identity(topo):
    """The identity fixpoint of the 4-2-2-1 weightwise net, or the same
    pattern in each kernel of another variant's net."""
    parts = []
    for a, b in topo.layer_shapes:
        k = np.zeros((a, b), np.float32)
        k[0, 0] = 1.0
        parts.append(k.reshape(-1))
    return np.concatenate(parts)


def _pairs(topo):
    """(self, target) pairs: the identity fixpoint (finite out), a pair
    whose output overflows from finite inputs, a NaN target and an Inf
    self (non-finite in, so no check fires)."""
    ident = _identity(topo)
    p = ident.size
    rng = np.random.default_rng(0)
    big = np.full(p, 1e18, np.float32)
    nan_t = rng.normal(size=p).astype(np.float32)
    nan_t[1] = np.nan
    inf_s = ident.copy()
    inf_s[0] = np.inf
    return {"identity": (ident, ident), "overflow": (big, big),
            "nan-target": (ident, nan_t), "inf-self": (inf_s, ident)}


TOPOS = {
    "weightwise": dict(variant="weightwise", width=2, depth=2),
    "aggregating": dict(variant="aggregating", width=2, depth=2,
                        aggregates=4),
    "recurrent": dict(variant="recurrent", width=2, depth=2),
}


@pytest.mark.parametrize("case", ["identity", "overflow", "nan-target",
                                  "inf-self"])
@pytest.mark.parametrize("variant", list(TOPOS))
def test_checked_apply_raises_where_jax_raises(variant, case):
    jtopo = JTopology(**TOPOS[variant])
    s, t = _pairs(jtopo)[case]
    try:
        want = np.asarray(jdebug.checked_apply_to_weights(jtopo, s, t))
        jax_raised = False
    except checkify.JaxRuntimeError:
        jax_raised = True
    topo = convert.topology_from_fields(TOPOS[variant])
    if jax_raised:
        with pytest.raises(NonFiniteOutputError,
                           match=rf"apply_to_weights\({variant}\) produced "
                                 "non-finite output from finite inputs"):
            checked_apply_to_weights(topo, torch.from_numpy(s),
                                     torch.from_numpy(t))
    else:
        got = checked_apply_to_weights(topo, torch.from_numpy(s),
                                       torch.from_numpy(t)).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the cases that must raise do, on both sides
    assert jax_raised == (case == "overflow")
    assert issubclass(NonFiniteOutputError, RuntimeError)


def test_timed_trace_and_phase(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return {"out": (None, x * 2.0)}

    x = torch.arange(4.0)
    res = timed(fn, x, iters=3, warmup=0)
    assert set(res) == {"mean_s", "median_s", "min_s", "max_s", "iters",
                        "times_s"}
    assert res["iters"] == 3 and len(res["times_s"]) == 3 and len(calls) == 3
    assert res["min_s"] <= res["median_s"] <= res["max_s"]
    timed(fn, x, iters=1, warmup=2)
    assert len(calls) == 6
    log_dir = str(tmp_path / "profile")
    with trace(log_dir):
        with phase("soup.evolve"):
            (x @ x.reshape(4, 1)).sum()
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    assert files and all(os.path.getsize(f) > 0 for f in files)
    with open(files[0]) as f:
        assert "soup.evolve" in f.read()


def test_printing_object_surface(capsys):
    """The port's mixin has JAX's surface and behaviour."""
    names = {n for n in dir(JPrintingObject) if not n.startswith("__")}
    assert names == {n for n in dir(PrintingObject)
                     if not n.startswith("__")}

    class Obj(PrintingObject):
        pass

    o = Obj()
    assert o.is_silent() and o.get_silence()
    o._print("hidden")
    assert o.unset_silence() is o and not o.silent
    o._print("shown")
    with o.silence():
        assert o.silent
        o._print("hidden too")
    assert not o.silent
    assert o.with_silence(True).is_silent()
    assert o.set_silence(False).get_silence() is False
    assert capsys.readouterr().out == "shown\n"
