"""Population precision in the port: ``population_dtype`` 'bf16' and
'int8' against the JAX package's popmajor soups, fed the JAX package's own
draws; the two routes bitwise equal inside the port; and the int8
quantizer's edge cases against the JAX package's ``_downcast``.

Tolerances (one rounding per generation, so one float32 ulp of difference
before it may flip the rounding): bfloat16 weights within one bfloat16 ulp
(rtol 2^-7, atol 1e-6); int8 codes within one step, scales within rtol
2e-5; losses rtol 1e-4 / atol 1e-6; integer state exact.  Inside the port
the fused and phase routes round at the same points, so they agree bit for
bit, as tests/test_fused_generation.py asserts for the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import soup as jsoup
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
import srnn_tpu_torch as st
from srnn_tpu_torch import convert
from srnn_tpu_torch import soup as psoup

GENERATIONS = 3
JCFG = jsoup.SoupConfig(
    topo=JTopology("weightwise", width=2, depth=2), size=64,
    attacking_rate=0.3, learn_from_rate=0.3, learn_from_severity=1, train=2,
    remove_divergent=True, remove_zero=True, layout="popmajor")
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


def _jax_draws(cfg, key) -> st.SoupDraws:
    """The draws of one JAX popmajor generation (soup.py:553-614)."""
    n = cfg.size
    _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
    return st.SoupDraws(
        np.asarray(jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate),
        np.asarray(jax.random.randint(k_at, (n,), 0, n)),
        np.asarray(jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate),
        np.asarray(jax.random.randint(k_lt, (n,), 0, n)),
        np.asarray(j_fresh_lanes(cfg.topo, k_re, n, cfg.respawn_draws)))


def _port_config(jcfg, **kw):
    fields = jcfg._asdict()
    fields["topo"] = dataclasses.asdict(jcfg.topo)
    return convert.soup_config_from_fields(fields)._replace(**kw)


def _port_state(js):
    return convert.soup_state_from_arrays(
        np.asarray(js.weights), np.asarray(js.uids), int(js.next_uid),
        int(js.time), device="cpu",
        scales=None if js.scales is None else np.asarray(js.scales))


@pytest.fixture(scope="module", params=["bf16", "int8"])
def jax_run(request):
    """Three JAX generations at one storage dtype: (config, [(state_before,
    state_after, events)])."""
    cfg = JCFG._replace(population_dtype=request.param)
    s = jsoup.seed(cfg, jax.random.key(3))
    steps = []
    for _ in range(GENERATIONS):
        s2, ev = jsoup.evolve_step(cfg, s)
        steps.append((s, s2, ev))
        s = s2
    return cfg, steps


@pytest.mark.parametrize("impl", ["phases", "fused"])
def test_precision_soup_matches_jax(jax_run, impl):
    jcfg, steps = jax_run
    dtype = jcfg.population_dtype
    cfg = _port_config(jcfg, generation_impl=impl)
    state = _port_state(steps[0][0])
    assert state.weights.dtype == psoup._pop_dtype(cfg)
    for g, (before, after, jev) in enumerate(steps):
        state, ev = st.evolve_step(cfg, state, _jax_draws(jcfg, before.key))
        msg = f"generation {g}"
        for field in ("uids", "next_uid", "time"):
            np.testing.assert_array_equal(
                getattr(state, field).numpy(),
                np.asarray(getattr(after, field)), msg)
        np.testing.assert_array_equal(ev.action.numpy(),
                                      np.asarray(jev.action), msg)
        np.testing.assert_array_equal(ev.counterpart.numpy(),
                                      np.asarray(jev.counterpart), msg)
        np.testing.assert_allclose(ev.loss.numpy(), np.asarray(jev.loss),
                                   rtol=1e-4, atol=1e-6, err_msg=msg)
        ref = np.asarray(after.weights)
        if dtype == "bf16":
            assert state.weights.dtype == torch.bfloat16
            np.testing.assert_allclose(state.weights.float().numpy(),
                                       ref.astype(np.float32), **BF16_TOL,
                                       err_msg=msg)
        else:
            assert state.weights.dtype == torch.int8
            steps_off = np.abs(state.weights.numpy().astype(np.int32)
                               - ref.astype(np.int32))
            assert steps_off.max() <= 1, msg
            np.testing.assert_allclose(state.scales.numpy(),
                                       np.asarray(after.scales), rtol=2e-5,
                                       err_msg=msg)
    # classification of the stored view (bfloat16 as stored, int8
    # dequantized) on the same stored weights, at the default epsilon and
    # at one that int8's quantization step can meet
    final = steps[-1][1]
    stored = _port_state(final)
    for eps in (jcfg.epsilon, 2e-2):
        np.testing.assert_array_equal(
            st.count(cfg._replace(epsilon=eps), stored).numpy(),
            np.asarray(jsoup.count(jcfg._replace(epsilon=eps), final)))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("variant", ["weightwise", "recurrent"])
def test_fused_matches_phases_bitwise(variant, dtype):
    """Both routes round once per generation at the same point."""
    topo = st.Topology(variant, width=2, depth=2,
                       activation="sigmoid" if variant == "recurrent"
                       else "linear")
    cfg = _port_config(JCFG)._replace(topo=topo, size=128,
                                      population_dtype=dtype)
    s0 = st.seed(cfg, 5, device="cpu")
    assert s0.weights.dtype == psoup._pop_dtype(cfg)
    a = st.evolve(cfg, s0, GENERATIONS)
    b = st.evolve(cfg._replace(generation_impl="fused"), s0, GENERATIONS)
    assert torch.equal(a.weights, b.weights)
    assert torch.equal(a.uids, b.uids)
    if dtype == "int8":
        assert torch.equal(a.scales, b.scales)
    else:
        assert a.scales is None and b.scales is None
    assert int(st.count(cfg, a).sum()) == cfg.size


def test_generation_kernel_dtype_fence(monkeypatch):
    """K3 takes float32 or bfloat16 populations of one dtype, with float32
    fresh columns; anything else raises before any launch."""
    from srnn_tpu_torch.ops import cuda_generation as cg

    topo = st.Topology("weightwise", width=2, depth=2)
    w = torch.zeros(topo.num_weights, 8)
    monkeypatch.setattr(cg, "is_cpu", lambda t: False)  # as for the card
    for wT, fresh, atk in ((w.half(), w, None),
                           (w.bfloat16(), w, w),
                           (w.bfloat16(), w.bfloat16(), None),
                           (w, w, w.bfloat16())):
        with pytest.raises(ValueError):
            cg.generation_popmajor(topo, wT, fresh, atk,
                                   torch.zeros(8, dtype=torch.bool), train=1)
    assert cg.GENERATION.launches == cg.GENERATION_BF16.launches == 0


def test_downcast_edge_cases_match_jax():
    """int8: an all-zero particle keeps scale 1; a particle with NaN, +inf
    or -inf stores scale +inf and codes 127 (and dequantizes to +inf);
    halves round to even.  bfloat16: halves between two bfloat16 values
    round to even."""
    w = np.zeros((6, 5), np.float32)
    w[1] = [1.0, np.nan, 2.0, -3.0, 0.5]
    w[2] = [np.inf, 1.0, 1.0, 1.0, 1.0]
    w[3] = [-np.inf, 0.0, 0.0, 0.0, 0.0]
    w[4] = [127.0, 0.5, 1.5, 2.5, -0.5]        # scale 1: exact halves
    w[5] = [-254.0, 1.0, 3.0, -5.0, 253.0]     # scale 2: exact halves
    cfg8 = _port_config(JCFG)._replace(population_dtype="int8")
    q, sc = psoup._downcast(cfg8, torch.from_numpy(w))
    jq, jsc = jsoup._downcast(JCFG._replace(population_dtype="int8"),
                              jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert sc[0] == 1.0 and (q[0] == 0).all()
    assert np.isinf(sc[1:4].numpy()).all() and (q[1:4] == 127).all()
    assert q[4].tolist() == [127, 0, 2, 2, 0]
    assert q[5].tolist() == [-127, 0, 2, -2, 126]
    back = psoup._upcast(cfg8, q, sc)
    assert torch.isinf(back[1:4]).all() and (back[0] == 0).all()
    # population-major: the particle axis is the last
    qT, scT = psoup._downcast(cfg8, torch.from_numpy(w.T.copy()), paxis=-1)
    assert torch.equal(qT, q.t()) and torch.equal(scT, sc)

    cfg16 = _port_config(JCFG)._replace(population_dtype="bf16")
    halves = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8),
                       2.0 ** -130 * 3], np.float32)
    got, none = psoup._downcast(cfg16, torch.from_numpy(halves))
    ref = np.asarray(jnp.asarray(halves).astype(jnp.bfloat16),
                     np.float32)
    assert none is None
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert got.float().tolist()[:2] == [1.0, 1 + 2.0 ** -6]
