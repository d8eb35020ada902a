"""The experiment service's tenant axis, stacked engines, scheduler,
in-process service and transport (``srnn_tpu_torch/serve``) against the
JAX package's (``srnn_tpu/serve``, ``tests/test_serve.py``), on the CPU.

* Against JAX, on JAX's draws (the port's ``soup.draw`` /
  ``multisoup.draw_multi`` replaced, as in tests/test_torch_dynamics.py):
  K = 3 stacked tenants at N = 16 for 3 generations with ``metrics=`` and
  ``lineage=`` through ``serve.tenant.evolve_stacked`` (weightwise,
  aggregating and a sigmoid recurrent particle) and
  ``evolve_multi_stacked``; ``fixpoint_density_stacked`` and
  ``run_fixpoint_stacked`` on the same populations.  Every integer exact
  (uids, next_uid, actions, generations, pids and edges, census), weights
  rtol 2e-5 / atol 1e-6 (the bound of tests/test_torch_soup.py), loss
  sums rtol 1e-4.  One JAX compile per soup, made at its first read.
* Against the port's own solo runs, bitwise: every stacked tenant's
  state, record, carries and lineage; the stacked capture's ``.traj``
  bytes; the service's results.
* Against JAX exactly: the scheduler's plans on one request trace, the
  soup request schema's defaults, the serve CLI's flag set and defaults;
  a port client against a JAX server (the protocol, one direction).

``test_serve.py::test_stacked_warmup_entry_names`` has no twin: it names
the AOT warmup spellings of ``utils/aot.py``, which waits for ROADMAP.md
A.7; ``test_warm_dispatches_every_width`` holds the port's ``warm``.
``test_service_process_end_to_end`` is slow-marked as in the JAX package;
chip_smoke.py's phase "experiment service" runs the setups as clients of
a service process on the card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import Topology as JTopology
from srnn_tpu import engine as jengine
from srnn_tpu import multisoup as jms
from srnn_tpu import soup as jsoup
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
from srnn_tpu.serve import scheduler as jscheduler
from srnn_tpu.serve import service as jservice
from srnn_tpu.serve import tenant as jtenant
from srnn_tpu.telemetry import dynamics as jdyn
from srnn_tpu_torch import convert, engine
from srnn_tpu_torch import multisoup as ms
from srnn_tpu_torch import soup as psoup
from srnn_tpu_torch.init import init_population, make_generator
from srnn_tpu_torch.serve import (ExperimentService, plan_dispatches,
                                  stack_tenants, unstack_tenants)
from srnn_tpu_torch.serve.scheduler import Request
from srnn_tpu_torch.serve.service import GROUP_KEYS, _soup_config_from_params
from srnn_tpu_torch.serve.tenant import (evolve_multi_stacked, evolve_stacked,
                                         evolve_stacked_captured,
                                         init_population_stacked,
                                         seed_stacked)
from srnn_tpu_torch.setups.common import (STANDARD_VARIANTS, generator,
                                          population)
from srnn_tpu_torch.telemetry.dynamics import (seed_lineage,
                                               seed_lineage_blocks)
from srnn_tpu_torch.topology import Topology
from torch_lazy import Lazy

K, N, G = 3, 16, 3
CAP = 64
F_TOL = dict(rtol=2e-5, atol=1e-6)
WW = Topology("weightwise", width=2, depth=2)
AGG = Topology("aggregating", width=2, depth=2, aggregates=4)
DYNAMICS = dict(attacking_rate=0.3, learn_from_rate=0.3,
                learn_from_severity=1, train=1, remove_divergent=True,
                remove_zero=True)
CFG = psoup.SoupConfig(topo=WW, size=N, **DYNAMICS)
TOPOS = {"weightwise": dict(variant="weightwise", width=2, depth=2),
         "aggregating": dict(variant="aggregating", width=2, depth=2,
                             aggregates=4),
         "recurrent": dict(variant="recurrent", width=2, depth=2,
                           activation="sigmoid")}


def _bits(x):
    x = x.detach().contiguous().reshape(-1)
    return x.view(torch.uint8) if x.dtype.is_floating_point else x


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    return [leaf for t in tree for leaf in _leaves(t)]


def _assert_bits_equal(a, b, what=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert torch.equal(_bits(x), _bits(y)), f"{what} leaf {i}"


def _states(cfg, k=K):
    return [psoup.seed(cfg, t, "cpu") for t in range(k)]


# ---------------------------------------------------------------------------
# stacked against the port's solo runs, bitwise
# ---------------------------------------------------------------------------


def _linear(variant):
    """The variant's particle with a linear activation: torch's CPU
    sigmoid takes its vectorized and its scalar path by an element's place
    in the tensor (one element of 16 seen apart), so a row's sigmoid is
    not bitwise the same at every place on the CPU; the card computes
    every element alike (chip_smoke.py holds the stacked service there)."""
    return Topology(**{**TOPOS[variant], "activation": "linear"})


@pytest.mark.parametrize("variant", list(TOPOS))
def test_stacked_soup_full_carry_parity(variant):
    """K = 3 stacked with metrics, health and lineage == 3 solo runs, bit
    for bit: state (generators too), carries, lineage pids and edges."""
    cfg = CFG._replace(topo=_linear(variant))
    states = _states(cfg)
    lins = [seed_lineage(N, device="cpu") for _ in range(K)]
    solo = [psoup.evolve(cfg, s, 4, metrics=True, health=True, lineage=True,
                         lineage_state=lin, lineage_capacity=CAP)
            for s, lin in zip(states, lins)]
    out = evolve_stacked(cfg, stack_tenants(states), 4, metrics=True,
                         health=True, lineage=True,
                         lineage_state=stack_tenants(lins),
                         lineage_capacity=CAP)
    for t, got in enumerate(unstack_tenants(out, K)):
        _assert_bits_equal(solo[t], got, f"tenant {t}")
    assert int(out[3][1].n_edges.sum()) > 0


def test_stacked_soup_seed_and_events_parity():
    """seed_stacked == per-tenant seed; the recorded per-generation event
    streams (action / counterpart / loss) and stored views match too."""
    stacked = seed_stacked(CFG, [generator(t) for t in range(K)], "cpu")
    for t, got in enumerate(unstack_tenants(stacked, K)):
        _assert_bits_equal(psoup.seed(CFG, generator(t), "cpu"), got,
                           f"seed tenant {t}")
    states = _states(CFG)
    solo = [psoup.evolve(CFG, s, 4, record=True) for s in states]
    out = evolve_stacked(CFG, stack_tenants(states), 4, record=True)
    for t in range(K):
        _assert_bits_equal(solo[t][1], [[x[:, t] for x in out[1][0]],
                                        out[1][1][:, t], out[1][2][:, t]],
                           f"record tenant {t}")


def test_stacked_multisoup_parity():
    """The mixed soup stacked == solo, bitwise, int8 too (each type's
    learn and train one call over every tenant's lanes)."""
    rnn = _linear("recurrent")
    for dtype in ("f32", "int8"):
        mcfg = ms.MultiSoupConfig(topos=(WW, AGG, rnn), sizes=(8, 8, 6),
                                  population_dtype=dtype, **DYNAMICS)
        states = [ms.seed_multi(mcfg, t, "cpu") for t in range(K)]
        lins = [seed_lineage_blocks(mcfg.sizes, device="cpu")
                for _ in range(K)]
        solo = [ms.evolve_multi(mcfg, s, 3, metrics=True, health=True,
                                lineage=True, lineage_state=lin,
                                lineage_capacity=CAP)
                for s, lin in zip(states, lins)]
        out = evolve_multi_stacked(mcfg, stack_tenants(states), 3,
                                   metrics=True, health=True, lineage=True,
                                   lineage_state=stack_tenants(lins),
                                   lineage_capacity=CAP)
        for t, got in enumerate(unstack_tenants(out, K)):
            _assert_bits_equal(solo[t], got, f"{dtype} multi tenant {t}")


@pytest.mark.parametrize("pipelined", [False, True])
def test_stacked_traj_capture_parity(tmp_path, pipelined):
    """Per-tenant ``.traj`` files of one stacked captured run are byte
    for byte the solo ``evolve_captured`` files (same stride)."""
    from srnn_tpu_torch.utils import TrajStore, evolve_captured
    from srnn_tpu_torch.utils.pipeline import BackgroundWriter

    gens, every = 6, 2
    states = _states(CFG)
    for t, s in enumerate(states):
        with TrajStore(str(tmp_path / f"solo{t}.traj"), N,
                       WW.num_weights) as store:
            evolve_captured(CFG, s, gens, store, every=every,
                            pipelined=False)
    stores = [TrajStore(str(tmp_path / f"stk{t}.traj"), N, WW.num_weights)
              for t in range(K)]
    writer = BackgroundWriter(name="test-capture") if pipelined else None
    try:
        final = evolve_stacked_captured(CFG, stack_tenants(states), gens,
                                        stores, every=every, writer=writer)
    finally:
        if writer is not None:
            writer.close()
        for s in stores:
            s.close()
    assert final.time.tolist() == [gens] * K
    for t in range(K):
        assert (tmp_path / f"solo{t}.traj").read_bytes() == \
            (tmp_path / f"stk{t}.traj").read_bytes(), t


def test_stackability_gate():
    """The gate and its wording are the JAX package's."""
    assert psoup.tenant_stackable(CFG)
    for bad in (dict(layout="popmajor"), dict(mode="sequential")):
        jcfg = jsoup.SoupConfig(topo=JTopology("weightwise", width=2,
                                               depth=2), size=N, **bad)
        with pytest.raises(ValueError) as want:
            jsoup.check_tenant_stackable(jcfg)
        with pytest.raises(ValueError) as got:
            psoup.check_tenant_stackable(CFG._replace(**bad))
        assert str(got.value) == str(want.value)
        assert not psoup.tenant_stackable(CFG._replace(**bad))
    with pytest.raises(ValueError, match="rowmajor"):
        evolve_stacked(CFG._replace(layout="popmajor"),
                       stack_tenants(_states(CFG)), 1)
    mcfg = ms.MultiSoupConfig(topos=(WW, AGG), sizes=(8, 8))
    assert ms.tenant_stackable_multi(mcfg)
    assert not ms.tenant_stackable_multi(mcfg._replace(layout="popmajor"))
    with pytest.raises(ValueError) as got:
        ms.check_tenant_stackable_multi(mcfg._replace(layout="popmajor"))
    with pytest.raises(ValueError) as want:
        jms.check_tenant_stackable_multi(jms.MultiSoupConfig(
            topos=(JTopology("weightwise", width=2, depth=2),), sizes=(8,),
            layout="popmajor"))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# stacked against JAX's serve.tenant, on JAX's draws
# ---------------------------------------------------------------------------


def _jax_draws(cfg, key):
    n = cfg.size
    _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
    return (jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate,
            jax.random.randint(k_at, (n,), 0, n),
            jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate,
            jax.random.randint(k_lt, (n,), 0, n),
            j_fresh_lanes(cfg.topo, k_re, n, cfg.respawn_draws),
            jax.random.split(key, 6)[0])


def _jax_multi_draws(cfg, key):
    n = cfg.total
    _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
    re_keys = jax.random.split(k_re, len(cfg.topos))
    return (jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate,
            jax.random.randint(k_at, (n,), 0, n),
            jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate,
            tuple(jax.random.randint(jax.random.fold_in(k_lt, t), (n_t,), 0,
                                     n_t) for t, n_t in enumerate(cfg.sizes)),
            tuple(j_fresh_lanes(topo, re_keys[t], n_t, cfg.respawn_draws)
                  for t, (topo, n_t) in enumerate(zip(cfg.topos,
                                                      cfg.sizes))),
            jax.random.split(key, 6)[0])


def _draw_lists(fn, cfg, keys):
    """JAX's draws per generation, each generation's K tenants in order
    (the order the port's stacked generation draws them)."""
    step = jax.jit(lambda k: fn(cfg, k))
    keys, out = list(keys), []
    for _ in range(G):
        for t in range(K):
            *d, keys[t] = step(keys[t])
            out.append(jax.tree.map(np.asarray, tuple(d)))
    return out


def _tensors(x):
    if isinstance(x, tuple):
        return tuple(_tensors(t) for t in x)
    dtype = {"b": torch.bool, "i": torch.int64}.get(x.dtype.kind,
                                                      torch.float32)
    return torch.from_numpy(np.array(x)).to(dtype)


def _feed(monkeypatch, module, name, draws, cls):
    feed = iter(draws)
    monkeypatch.setattr(module, name,
                        lambda config, gen, device: cls(*_tensors(next(feed))))


def _jcfg(variant):
    return jsoup.SoupConfig(topo=JTopology(**TOPOS[variant]), size=N,
                            respawn_draws="fused", **DYNAMICS)


def _start_weights(p, k=K, scale=0.5):
    rng = np.random.default_rng(11)
    return [(rng.normal(size=(N, p)) * scale).astype(np.float32)
            for _ in range(k)]


@pytest.fixture(scope="module")
def jax_stacked():
    """Per soup: the tenants' start weights, JAX's draws and its stacked
    run with ``metrics=`` and ``lineage=`` (host arrays)."""
    def run(name):
        if name == "mixed":
            jcfg = jms.MultiSoupConfig(
                topos=(JTopology(**TOPOS["weightwise"]),
                       JTopology(**TOPOS["aggregating"])), sizes=(8, 8),
                respawn_draws="fused", **DYNAMICS)
            rng = np.random.default_rng(12)
            ws = [[(rng.normal(size=(n, t.num_weights)) * 0.5).astype(
                np.float32) for t, n in zip(jcfg.topos, jcfg.sizes)]
                for _ in range(K)]
            keys = [jax.random.key(20 + t) for t in range(K)]
            states = [jms.MultiSoupState(
                tuple(jnp.asarray(w) for w in ws[t]),
                (jnp.arange(8, dtype=jnp.int32),
                 jnp.arange(8, 16, dtype=jnp.int32)),
                jnp.int32(16), jnp.int32(0), keys[t]) for t in range(K)]
            lins = jtenant.stack_tenants([jdyn.seed_lineage_blocks((8, 8))
                                          for _ in range(K)])
            res = jtenant.evolve_multi_stacked(
                jcfg, jtenant.stack_tenants(states), generations=G,
                metrics=True, lineage=True, lineage_state=lins,
                lineage_capacity=CAP)
            draws = _draw_lists(_jax_multi_draws, jcfg, keys)
        else:
            jcfg = _jcfg(name)
            ws = _start_weights(jcfg.topo.num_weights)
            keys = [jax.random.key(10 + t) for t in range(K)]
            states = [jsoup.SoupState(jnp.asarray(w),
                                      jnp.arange(N, dtype=jnp.int32),
                                      jnp.int32(N), jnp.int32(0), k)
                      for w, k in zip(ws, keys)]
            lins = jtenant.stack_tenants([jdyn.seed_lineage(N)
                                          for _ in range(K)])
            res = jtenant.evolve_stacked(
                jcfg, jtenant.stack_tenants(states), generations=G,
                metrics=True, lineage=True, lineage_state=lins,
                lineage_capacity=CAP)
            draws = _draw_lists(_jax_draws, jcfg, keys)
        final, *carries = res
        final = final._replace(key=None)
        return ws, draws, jax.tree.map(np.asarray, (final, *carries))

    return Lazy(run)


def _np(x):
    return x.detach().cpu().numpy()


def _check_carries(m, lin_triple, jm, jlin_triple, t):
    np.testing.assert_array_equal(_np(m.actions[t]), jm.actions[t])
    assert int(m.generations[t]) == int(jm.generations[t]) == G
    np.testing.assert_allclose(float(m.loss_sum[t]), float(jm.loss_sum[t]),
                               rtol=1e-4)
    lin, win, stats = lin_triple
    jlin, jwin, jstats = jlin_triple
    for a, b in zip(lin, jlin):
        np.testing.assert_array_equal(_np(a[t]), b[t])
    for a, b in zip(win, jwin):
        np.testing.assert_array_equal(_np(a[t]), b[t])
    for f in ("census", "transitions"):
        np.testing.assert_array_equal(_np(getattr(stats, f)[t]),
                                      getattr(jstats, f)[t])


@pytest.mark.parametrize("variant", list(TOPOS))
def test_stacked_soup_matches_jax(jax_stacked, monkeypatch, variant):
    ws, draws, (jfinal, jm, jlin) = jax_stacked[variant]
    cfg = convert.soup_config_from_fields(
        {**_jcfg(variant)._asdict(), "topo": TOPOS[variant]})
    _feed(monkeypatch, psoup, "draw", draws, psoup.SoupDraws)
    states = [convert.soup_state_from_arrays(w, np.arange(N), N, 0,
                                             device="cpu") for w in ws]
    lins = stack_tenants([seed_lineage(N, device="cpu") for _ in range(K)])
    final, m, lin = evolve_stacked(cfg, stack_tenants(states), G,
                                   metrics=True, lineage=True,
                                   lineage_state=lins, lineage_capacity=CAP)
    np.testing.assert_array_equal(final.uids.numpy(), jfinal.uids)
    np.testing.assert_array_equal(final.next_uid.numpy(), jfinal.next_uid)
    np.testing.assert_allclose(final.weights.numpy(), jfinal.weights,
                               **F_TOL)
    for t in range(K):
        _check_carries(m, lin, jm, jlin, t)


def test_stacked_multisoup_matches_jax(jax_stacked, monkeypatch):
    ws, draws, (jfinal, jms_, jlin) = jax_stacked["mixed"]
    mcfg = ms.MultiSoupConfig(topos=(WW, AGG), sizes=(8, 8),
                              respawn_draws="fused", **DYNAMICS)
    _feed(monkeypatch, ms, "draw_multi", draws, ms.MultiSoupDraws)
    states = [convert.multisoup_state_from_arrays(
        w, (np.arange(8), np.arange(8, 16)), 16, 0, device="cpu")
        for w in ws]
    lins = stack_tenants([seed_lineage_blocks((8, 8), device="cpu")
                          for _ in range(K)])
    final, mets, (lins, win, stats) = evolve_multi_stacked(
        mcfg, stack_tenants(states), G, metrics=True, lineage=True,
        lineage_state=lins, lineage_capacity=CAP)
    jlins, jwin, jstats = jlin
    for typ in range(2):
        np.testing.assert_array_equal(final.uids[typ].numpy(),
                                      jfinal.uids[typ])
        np.testing.assert_allclose(final.weights[typ].numpy(),
                                   jfinal.weights[typ], **F_TOL)
        for t in range(K):
            _check_carries(mets[typ], (lins[typ], win, stats[typ]),
                           jms_[typ], (jlins[typ], jwin, jstats[typ]), t)
    np.testing.assert_array_equal(final.next_uid.numpy(), jfinal.next_uid)


def test_engine_stacked_parity():
    """The stacked engines == the solo ones bitwise (every variant) and
    JAX's stacked engines on the same populations (class counts and steps
    exact, weights within the bound)."""
    eps = [1e-4, 1e-3, 1e-5]
    for variant in ("weightwise", "aggregating", "recurrent"):
        topo = Topology(**{**TOPOS[variant], "activation": "linear"})
        pops = torch.stack([init_population(topo, make_generator(t, "cpu"),
                                            32, "cpu") for t in range(K)])
        st = engine.fixpoint_density_stacked(topo, pops, eps)
        run = engine.run_fixpoint_stacked(topo, pops, step_limit=8,
                                          epsilons=torch.tensor(eps))
        one = engine.run_fixpoint_stacked(topo, pops, step_limit=1,
                                          epsilons=eps)
        for t in range(K):
            assert torch.equal(st[t], engine.fixpoint_density(topo, pops[t],
                                                              eps[t]))
            solo = engine.run_fixpoint(topo, pops[t], step_limit=8,
                                       epsilon=eps[t])
            _assert_bits_equal(solo[:4], [x[t] for x in run[:4]],
                               f"{variant} tenant {t}")
        if variant == "weightwise":
            jtopo = JTopology("weightwise", width=2, depth=2)
            jeps = jnp.asarray(eps, jnp.float32)
            jpops = jnp.asarray(pops.numpy())
            np.testing.assert_array_equal(
                st.numpy(), np.asarray(jengine.fixpoint_density_stacked(
                    jtopo, jpops, jeps)))
            jrun = jengine.run_fixpoint_stacked(jtopo, jpops, step_limit=8,
                                                epsilons=jeps)
            np.testing.assert_array_equal(run.steps.numpy(),
                                          np.asarray(jrun.steps))
            np.testing.assert_array_equal(run.counts.numpy(),
                                          np.asarray(jrun.counts))
            # the weights after one step (eight steps grow them past the
            # bound: the same amplification tests/test_torch_engine.py
            # sees, where it holds the class counts)
            jone = jengine.run_fixpoint_stacked(jtopo, jpops, step_limit=1,
                                                epsilons=jeps)
            np.testing.assert_allclose(one.weights.numpy(),
                                       np.asarray(jone.weights), **F_TOL)
    with pytest.raises(TypeError, match="epsilons="):
        engine.run_fixpoint_stacked(WW, pops)
    assert engine.run_fixpoint_stacked_donated is engine.run_fixpoint_stacked


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


def _trace(req_cls):
    params = [("fixpoint_density", dict(trials=64, batch=32, seed=0)),
              ("fixpoint_density", dict(trials=64, batch=32, seed=1)),
              ("fixpoint_density", dict(trials=48, batch=24, seed=2)),
              ("soup", dict(size=8, generations=4, seed=0)),
              ("soup", dict(size=8, generations=4, seed=1)),
              ("soup", dict(size=8, generations=4, seed=2,
                            layout="popmajor")),
              ("soup", dict(generations=2)),   # malformed: no size
              ("fixpoint_density", dict(trials=64, batch=32, seed=3))]
    return [req_cls(ticket=f"t{i}", kind=kind, params=p,
                    tenant=f"tn{i % 3}", submitted_s=0.0)
            for i, (kind, p) in enumerate(params)]


def _plan_shape(plan):
    return [(d.kind, d.stacked, [r.ticket for r in d.requests])
            for d in plan]


@pytest.mark.parametrize("max_stack, fair", [(8, False), (2, False),
                                             (2, True)])
def test_scheduler_groups_and_falls_back(max_stack, fair):
    """The port's plan is JAX's on the same trace: stacked groups, solo
    fallbacks (the popmajor and the malformed soup), chunking, fairness."""
    assert GROUP_KEYS["soup"](_trace(Request)[5].params) is None
    got = plan_dispatches(_trace(Request), GROUP_KEYS, max_stack, fair=fair)
    want = jscheduler.plan_dispatches(_trace(jscheduler.Request),
                                      jservice.GROUP_KEYS, max_stack,
                                      fair=fair)
    assert _plan_shape(got) == _plan_shape(want)
    modes = [(d.kind, len(d.requests)) for d in got]
    assert ("soup", 1) in modes and ("fixpoint_density", 1) in modes


def test_soup_request_schema_defaults_match_soupconfig():
    """Unstated request knobs take the port's ``SoupConfig`` defaults, and
    every stated one reads as in the JAX package."""
    import dataclasses

    assert _soup_config_from_params({"size": 8}) == \
        psoup.SoupConfig(topo=WW, size=8)
    for params in ({"size": 8},
                   {"size": 12, "variant": "aggregating", "aggregates": 4,
                    "attacking_rate": 0.2, "learn_from_rate": -1.0,
                    "train": 3, "learn_from_severity": 2,
                    "remove_divergent": True, "remove_zero": True,
                    "epsilon": 1e-3, "lr": 0.05, "train_mode": "full_batch",
                    "layout": "popmajor", "respawn_draws": "fused"}):
        jcfg = jservice._soup_config_from_params(params)
        want = convert.soup_config_from_fields(
            {**jcfg._asdict(), "topo": dataclasses.asdict(jcfg.topo)})
        assert _soup_config_from_params(params) == want
    # the port's one extra field, read only when stated
    assert _soup_config_from_params(
        {"size": 8, "layout": "popmajor",
         "generation_impl": "fused"}).generation_impl == "fused"


# ---------------------------------------------------------------------------
# the service in process
# ---------------------------------------------------------------------------


def _local_density(seed, trials, batch, eps=1e-4):
    """The setups' process-mode sweep (setups/fixpoint_density.py)."""
    out = []
    for v, (_name, topo) in enumerate(STANDARD_VARIANTS[:2]):
        total = torch.zeros(5, dtype=torch.int32)
        done = 0
        while done < trials:
            n = min(batch, trials - done)
            total = total + engine.fixpoint_density(
                topo, population(topo, n, "cpu", seed, v, done), eps)
            done += n
        out.append(total.tolist())
    return out


def test_service_stacks_matching_and_solos_odd(tmp_path):
    svc = ExperimentService(str(tmp_path / "svc"), max_stack=8, device="cpu")
    with svc:
        t1 = svc.submit("fixpoint_density",
                        {"seed": 0, "trials": 64, "batch": 32}, tenant="a")
        t2 = svc.submit("fixpoint_density",
                        {"seed": 1, "trials": 64, "batch": 32}, tenant="b")
        t3 = svc.submit("fixpoint_density",
                        {"seed": 2, "trials": 48, "batch": 24}, tenant="c")
        assert svc.run_pending() == 3
        e1, e2, e3 = (svc.poll(t) for t in (t1, t2, t3))
        assert (e1["mode"], e2["mode"], e3["mode"]) == \
            ("stacked", "stacked", "solo")
        for entry, args in ((e1, (0, 64, 32)), (e2, (1, 64, 32)),
                            (e3, (2, 48, 24))):
            assert entry["result"]["counters"] == _local_density(*args)
        assert [n for n, _ in STANDARD_VARIANTS[:2]] == \
            e1["result"]["variant_names"]
        reg = svc.registry
        assert reg.counter("serve_dispatches_total").value(
            kind="fixpoint_density", mode="stacked") == 1
        assert reg.counter("serve_dispatches_total").value(
            kind="fixpoint_density", mode="solo") == 1
        svc.writer.flush()
    prom = (tmp_path / "svc" / "metrics.prom").read_text()
    assert 'srnn_serve_dispatches_total{kind="fixpoint_density",' \
           'mode="stacked"} 1' in prom
    from srnn_tpu_torch.serve.service import NOT_PORTED

    assert NOT_PORTED and not any(name in prom for name in NOT_PORTED)


def test_service_soup_matches_solo_and_streams_lineage(tmp_path):
    svc = ExperimentService(str(tmp_path / "svc"), max_stack=8, device="cpu")
    params = {"size": 12, "generations": 4, "train": 1,
              "attacking_rate": 0.25, "remove_divergent": True,
              "remove_zero": True, "lineage": True}
    with svc:
        tickets = [svc.submit("soup", dict(params, seed=i),
                              tenant=f"tenant{i}") for i in range(3)]
        solo_t = svc.submit("soup", dict(params, seed=1, lineage=False))
        svc.run_pending()
        entries = [svc.poll(t) for t in tickets]
        assert all(e["mode"] == "stacked" for e in entries)
        assert svc.poll(solo_t)["mode"] == "solo"
        cfg = _soup_config_from_params(params)
        for seed, e in ((1, entries[1]), (1, svc.poll(solo_t))):
            final, m = psoup.evolve(cfg, psoup.seed(cfg, generator(seed),
                                                    "cpu"), 4, metrics=True)
            r = e["result"]
            assert r["counters"] == psoup.count(cfg, final).tolist()
            assert r["weights"] == final.weights.tolist()
            assert r["uids"] == final.uids.tolist()
            assert (r["final_time"], r["next_uid"]) == (4, int(
                final.next_uid))
            assert r["metrics"] == {"generations": 4,
                                    "actions": m.actions.tolist(),
                                    "loss_sum": float(m.loss_sum)}
        svc.writer.flush()
        rows = [json.loads(line) for line in
                open(os.path.join(svc.root, "lineage.jsonl"))]
        assert [r["tenant"] for r in rows] == ["tenant0", "tenant1",
                                               "tenant2"]
        assert all(r["kind"] == "window" for r in rows)
    events = [json.loads(line) for line in
              open(os.path.join(str(tmp_path / "svc"), "events.jsonl"))]
    assert {e["tenant"] for e in events if e.get("kind") == "serve_tenant"} \
        >= {"tenant0", "tenant1", "tenant2"}


def test_service_failed_request_reports_error(tmp_path):
    svc = ExperimentService(str(tmp_path / "svc"), device="cpu")
    with svc:
        with pytest.raises(ValueError):
            svc.submit("no_such_kind", {})
        t1 = svc.submit("soup", {"size": 8, "generations": 2,
                                 "train_mode": "bogus"})
        t0 = svc.submit("soup", {"generations": 2})   # no size
        t2 = svc.submit("fixpoint_density",
                        {"seed": 0, "trials": 32, "batch": 32})
        svc.run_pending()
        assert svc.poll(t1)["status"] == "failed"
        assert "bogus" in svc.poll(t1)["error"]
        assert svc.poll(t0)["status"] == "failed"
        assert svc.poll(t2)["status"] == "done"
        assert svc.registry.counter("serve_requests_failed_total").value(
            kind="soup") == 2
        assert svc.wait(t2, timeout_s=5)["status"] == "done"
        assert svc.poll(t2) is None


def test_warm_dispatches_every_width(tmp_path):
    """``warm`` runs the executor at ``max_stack`` and solo (building the
    spelling's kernels on the card) and touches no serve metric."""
    svc = ExperimentService(str(tmp_path / "svc"), max_stack=3, device="cpu")
    with svc:
        svc.warm("soup", {"size": 6, "generations": 1, "lineage": True})
        svc.warm("fixpoint_density", {"trials": 8, "batch": 8})
        assert svc.stats()["distinct_programs"] == 6
        assert svc.stats()["completed"] == 0
        svc.writer.flush()
        assert not os.path.exists(os.path.join(svc.root, "lineage.jsonl"))


# ---------------------------------------------------------------------------
# socket transport and the CLI
# ---------------------------------------------------------------------------


def test_socket_server_round_trip(tmp_path):
    from srnn_tpu_torch.serve.client import ServiceClient, ServiceError
    from srnn_tpu_torch.serve.server import ServiceServer
    from srnn_tpu_torch.utils.pipeline import spawn_thread

    svc = ExperimentService(str(tmp_path / "svc"), max_stack=4, device="cpu")
    sock = str(tmp_path / "serve.sock")
    server = ServiceServer(svc, sock, batch_window_s=0.05)
    thread = spawn_thread(server.serve_until_shutdown, name="test-serve")
    try:
        client = ServiceClient(sock)
        client.wait_until_up(30)
        result = client.request(
            "fixpoint_density", {"seed": 3, "trials": 32, "batch": 32},
            tenant="sock", timeout_s=120)
        assert result["counters"] == _local_density(3, 32, 32)
        assert client.stats()["completed"] == 1
        with pytest.raises(ServiceError, match="unknown"):
            client._op({"op": "nope"})
    finally:
        ServiceClient(sock).shutdown()
        thread.join(timeout=30)
        svc.close()
    assert not thread.is_alive()
    assert not os.path.exists(sock)


def test_port_client_talks_to_jax_server(tmp_path):
    """The protocol is the JAX package's: the port's client pings, submits
    (a request that fails in dispatch, so no JAX compile), waits, reads
    stats and shuts down a JAX server."""
    from srnn_tpu.serve.server import ServiceServer as JServer
    from srnn_tpu.utils.pipeline import spawn_thread as jspawn
    from srnn_tpu_torch.serve.client import ServiceClient, ServiceError

    jsvc = jservice.ExperimentService(str(tmp_path / "jsvc"))
    sock = str(tmp_path / "j.sock")
    server = JServer(jsvc, sock, batch_window_s=0.01)
    thread = jspawn(server.serve_until_shutdown, name="test-jax-serve")
    try:
        client = ServiceClient(sock)
        client.wait_until_up(30)
        ticket = client.submit("soup", {"size": 8, "train_mode": "bogus"},
                               tenant="port", idempotency_key="k")
        assert ticket == "t000001"
        assert client.submit("soup", {"size": 8}, idempotency_key="k") \
            == ticket
        with pytest.raises(ServiceError, match="bogus"):
            client.wait(ticket, timeout_s=60)
        assert client.stats()["completed"] == 1
    finally:
        ServiceClient(sock).shutdown()
        thread.join(timeout=30)
        jsvc.close()
    assert not thread.is_alive()


def test_serve_flag_census():
    """Every flag of the JAX package's serve parser, with its default, and
    nothing else."""
    from srnn_tpu.serve.__main__ import build_parser as jparser
    from srnn_tpu_torch.serve.__main__ import build_parser

    def census(p):
        return {a.option_strings[0]: (a.dest, a.default, a.nargs, a.type)
                for a in p()._actions
                if a.option_strings and a.dest != "help"}

    assert census(build_parser) == census(jparser)


@pytest.mark.slow
def test_service_process_end_to_end(tmp_path):
    """A service process on a Unix socket; two same-shape setups clients
    stack, an odd one solos, artifacts equal local runs, metrics.prom
    records the dispatch modes, clean ``--shutdown``."""
    import glob
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, SRNN_SETUPS_PLATFORM="cpu", PYTHONPATH=repo)
    root = str(tmp_path / "svc")
    sock = os.path.join(root, "serve.sock")
    # the fixed 2 s window (the A/B oracle) holds the three clients'
    # tickets for one drain; the adaptive window would start at its floor
    proc = subprocess.Popen(
        [sys.executable, "-m", "srnn_tpu_torch.serve", "--root", root,
         "--batch-window-s", "2", "--no-adaptive"], cwd=repo, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        from srnn_tpu_torch.serve.client import ServiceClient

        ServiceClient(sock).wait_until_up(60)

        def client(seed, extra):
            return subprocess.Popen(
                [sys.executable, "-m", "srnn_tpu_torch.setups",
                 "fixpoint_density", "--seed", str(seed), "--root",
                 str(tmp_path / "exp"), "--service", sock] + extra,
                cwd=repo, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.STDOUT)

        clients = [client(0, ["--smoke"]), client(1, ["--smoke"]),
                   client(2, ["--trials", "48", "--batch", "24"])]
        for c in clients:
            assert c.wait(timeout=240) == 0
        assert subprocess.run(
            [sys.executable, "-m", "srnn_tpu_torch.serve", "--socket", sock,
             "--shutdown"], cwd=repo, env=env).returncode == 0
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    time.sleep(0)
    prom = open(os.path.join(root, "metrics.prom")).read()
    assert 'mode="stacked"} 1' in prom and 'mode="solo"} 1' in prom
    runs = glob.glob(str(tmp_path / "exp" / "exp-*"))
    match = [d for d in runs
             if json.load(open(os.path.join(d, "meta.json")))["seed"] == 1]
    counters = np.load(os.path.join(match[0], "all_counters.npz"))
    assert counters[counters.files[0]].tolist() == _local_density(1, 64, 32)
    assert json.load(open(os.path.join(
        match[0], "config.json")))["execution_mode"] == "service"
