"""``attack_impl`` / ``learn_from_impl='compact'``: the population-major
phases over a block of the gated lanes only.

* Compact equals full BITWISE on the CPU, generation by generation (the
  weights, uids and event record of ``evolve(record=True)``), for the
  weightwise, aggregating, fft and recurrent particles, compacting the
  attack, learn_from or both.  The port's chains are per-lane and explicit,
  so a lane's result does not depend on the block it rides in (the JAX
  package allows 1 ulp of FMA contraction there).  N = 640 at rate 0.1,
  where the block's capacity (256 lanes) is below N, so the compacted
  branch is what runs.
* The overflow fallback: with the capacity set to 8 or 16 lanes, fewer than
  are gated, the phase runs at full width and still equals 'full' bitwise;
  a dropped overflow would leave gated lanes at their old values.
* Ungated lanes are bitwise untouched; the fused generation ignores the
  compaction (bitwise equal to fused + full), as the JAX package's
  ``_phases_view`` does.
* ``_attack_capacity`` against the JAX package's over a grid of (n, rate);
  the refusals against the JAX package's ``evolve_step``, with its wording.
* One compact generation of each spelling against the JAX package's compact
  generation, fed its draws: integer state exact, weights rtol 2e-5 /
  atol 1e-6, losses rtol 1e-4 / atol 1e-6 (tests/test_fused_generation.py's
  generation tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import soup as jsoup
import srnn_tpu_torch as st
from srnn_tpu_torch import soup as psoup
from srnn_tpu_torch.ops.popmajor import apply_popmajor, learn_epochs_popmajor
from tests.test_torch_soup import _jax_draws, _port_config, _port_state

N, RATE, GENERATIONS = 640, 0.1, 4
TOPOS = {
    "weightwise": st.Topology("weightwise"),
    "aggregating": st.Topology("aggregating", aggregates=4),
    "fft": st.Topology("fft", aggregates=4),
    "recurrent": st.Topology("recurrent"),
}
COMPACT = {"attack": dict(attack_impl="compact"),
           "learn": dict(learn_from_impl="compact"),
           "both": dict(attack_impl="compact", learn_from_impl="compact")}


def _config(topo, **kw):
    return st.SoupConfig(topo=topo, size=N, attacking_rate=RATE,
                         learn_from_rate=RATE, learn_from_severity=1,
                         train=1, remove_divergent=True, remove_zero=True,
                         respawn_draws="fused", layout="popmajor", **kw)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A float tensor's bit patterns: equal bits are equal values, NaN
    included."""
    return t.contiguous().view(torch.int32).numpy()


def _assert_runs_equal(a, b):
    (fa, (ev_a, w_a, u_a)), (fb, (ev_b, w_b, u_b)) = a, b
    np.testing.assert_array_equal(_bits(w_a), _bits(w_b))
    np.testing.assert_array_equal(u_a.numpy(), u_b.numpy())
    for x, y in zip(ev_a, ev_b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(_bits(fa.weights), _bits(fb.weights))
    assert int(fa.next_uid) == int(fb.next_uid)


def _record(cfg, s0):
    return st.evolve(cfg, s0, GENERATIONS, record=True)


def test_capacity_is_below_n():
    assert psoup._attack_capacity(N, RATE) == 256 < N


@pytest.mark.parametrize("phase", list(COMPACT))
@pytest.mark.parametrize("variant", list(TOPOS))
def test_compact_equals_full_bitwise(variant, phase):
    cfg = _config(TOPOS[variant])
    s0 = st.seed(cfg, 7, device="cpu")
    _assert_runs_equal(_record(cfg._replace(**COMPACT[phase]), s0),
                       _record(cfg, s0))


@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("variant", ["weightwise", "recurrent"])
def test_overflow_falls_back_to_full(monkeypatch, variant, cap):
    """Every generation gates ~64 lanes, past a capacity of 8 or 16: the
    fallback runs each compacted phase at full width."""
    cfg = _config(TOPOS[variant])
    s0 = st.seed(cfg, 8, device="cpu")
    full = _record(cfg, s0)
    monkeypatch.setattr(psoup, "_attack_capacity", lambda n, rate: cap)
    _assert_runs_equal(_record(cfg._replace(**COMPACT["both"]), s0), full)


def _population(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.normal(size=(TOPOS["weightwise"].num_weights, n))
        .astype(np.float32))


@pytest.mark.parametrize("cap", [8, 16])
def test_attack_overflow_every_lane_updated(cap):
    """Every lane attacked, capacity 8 / 16: every lane carries the full
    path's update, none keeps its pre-attack value."""
    topo, n = TOPOS["weightwise"], 32
    wT = _population(n)
    att_idx = torch.arange(n) % 7
    has = torch.ones(n, dtype=torch.bool)
    want = apply_popmajor(topo, wT[:, att_idx], wT)
    got = psoup._attack_popmajor_compact(topo, wT, att_idx, has, cap)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not (got == wT).all(0).any()


@pytest.mark.parametrize("phase", ["attack", "learn"])
def test_ungated_lanes_untouched(phase):
    """Sparse gates (every 11th lane) in a block of 16: gated lanes equal
    the full phase bitwise, ungated lanes keep their bits; lane 0 is gated,
    so a fill slot written back to lane 0 would show."""
    topo, n = TOPOS["weightwise"], 48
    wT = _population(n, 2)
    gate = (torch.arange(n) % 11) == 0
    tgt = (torch.arange(n) * 5) % n
    if phase == "attack":
        att_idx = torch.where(gate, tgt, -1)
        full = apply_popmajor(topo, wT[:, att_idx.clamp(min=0)], wT)
        got = psoup._attack_popmajor_compact(topo, wT, att_idx, gate, 16)
    else:
        cfg = _config(topo)
        full, _ = learn_epochs_popmajor(topo, wT, wT[:, tgt], 1, cfg.lr,
                                        layout="popmajor")
        got = psoup._learn_popmajor_compact(cfg, topo, wT, gate, tgt, 16)
    np.testing.assert_array_equal(_bits(got[:, gate]), _bits(full[:, gate]))
    np.testing.assert_array_equal(_bits(got[:, ~gate]), _bits(wT[:, ~gate]))


@pytest.mark.parametrize("variant", ["weightwise", "aggregating"])
def test_fused_ignores_compaction(variant):
    cfg = _config(TOPOS[variant], generation_impl="fused")
    s0 = st.seed(cfg, 9, device="cpu")
    _assert_runs_equal(_record(cfg._replace(**COMPACT["both"]), s0),
                       _record(cfg, s0))


def test_attack_capacity_matches_jax():
    for n in (1, 7, 128, 512, 640, 4096, 65_536, 1_000_000):
        for rate in (-0.5, 0.0, 0.01, 0.05, 0.1, 0.3, 0.5, 1.0, 1.5):
            assert psoup._attack_capacity(n, rate) == \
                jsoup._attack_capacity(n, rate), (n, rate)
    assert psoup._attack_capacity(1_000_000, 0.1) == 102_528


def _jax_state(n, p):
    return jsoup.SoupState(
        weights=jnp.zeros((n, p), jnp.float32),
        uids=jnp.arange(n, dtype=jnp.int32), next_uid=jnp.int32(n),
        time=jnp.int32(0), key=jax.random.key(0))


@pytest.mark.parametrize("variant,layout,impl,match", [
    ("weightwise", "rowmajor", dict(attack_impl="compact"),
     "compact lanes of the popmajor layout"),
    ("weightwise", "rowmajor", dict(learn_from_impl="compact"),
     "compact lanes of the popmajor layout"),
    ("weightwise", "popmajor", dict(attack_impl="sparse"),
     "unknown attack_impl"),
    ("weightwise", "popmajor", dict(learn_from_impl="sparse"),
     "unknown learn_from_impl"),
    ("recurrent", "popmajor",
     dict(apply_impl="kernel", attack_impl="compact"),
     "mutually exclusive")],
    ids=["rowmajor-attack", "rowmajor-learn", "unknown-attack",
         "unknown-learn", "kernel-apply"])
def test_refusals_match_jax(variant, layout, impl, match):
    topo = TOPOS[variant]
    jimpl = {k: ("pallas" if v == "kernel" else v) for k, v in impl.items()}
    jcfg = jsoup.SoupConfig(topo=JTopology(variant), size=4, train=1,
                            layout=layout, **jimpl)
    with pytest.raises(ValueError, match=match):
        jsoup.evolve_step(jcfg, _jax_state(4, topo.num_weights))
    cfg = st.SoupConfig(topo=topo, size=4, train=1, layout=layout, **impl)
    s0 = st.seed(cfg._replace(attack_impl="full", learn_from_impl="full",
                              apply_impl="plain"), 0, device="cpu")
    with pytest.raises(ValueError, match=match):
        st.evolve_step(cfg, s0)
    with pytest.raises(ValueError, match=match):
        st.evolve(cfg, s0, 1)


JCFG = jsoup.SoupConfig(
    topo=JTopology("weightwise", width=2, depth=2), size=512,
    attacking_rate=RATE, learn_from_rate=RATE, learn_from_severity=1,
    train=2, remove_divergent=True, remove_zero=True, layout="popmajor",
    attack_impl="compact", learn_from_impl="compact")


@pytest.fixture(scope="module")
def jax_compact_step():
    """One JAX compact generation (the compacted branch: capacity 128 of
    512 lanes)."""
    assert jsoup._attack_capacity(JCFG.size, RATE) < JCFG.size
    s = jsoup.seed(JCFG, jax.random.key(5))
    s, _ = jsoup.evolve_step(JCFG, s)  # a generation in, off the init law
    after, ev = jsoup.evolve_step(JCFG, s)
    return s, after, ev


@pytest.mark.parametrize("impl", [
    dict(), dict(attack_impl="full", learn_from_impl="full"),
    dict(train_impl="kernel")], ids=["compact", "full", "compact-kernel"])
def test_compact_generation_matches_jax(jax_compact_step, impl):
    before, after, jev = jax_compact_step
    cfg = _port_config(JCFG, **impl)
    state, ev = st.evolve_step(cfg, _port_state(before),
                               _jax_draws(JCFG, before.key))
    for field in ("uids", "next_uid", "time"):
        np.testing.assert_array_equal(getattr(state, field).numpy(),
                                      np.asarray(getattr(after, field)))
    np.testing.assert_array_equal(ev.action.numpy(), np.asarray(jev.action))
    np.testing.assert_array_equal(ev.counterpart.numpy(),
                                  np.asarray(jev.counterpart))
    np.testing.assert_allclose(state.weights.numpy(),
                               np.asarray(after.weights), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ev.loss.numpy(), np.asarray(jev.loss),
                               rtol=1e-4, atol=1e-6)
