"""The port's sharded soups (``srnn_tpu_torch.parallel``) on gloo worlds of
ranks on the CPU, against the port's single-device soups and against the
JAX package's sharded soups.

Each world -- 1, 2 and 4 ranks, on a 1-D ``"soup"`` mesh, the world of 4
also on the 2 x 2 multislice ``(slices, soup)`` mesh -- is spawned once
per test module and runs all its cases in one spawn
(``tests/torch_worlds.py``, about 4 s of imports and set-up a world; the
worlds run side by side); the parametrised tests read its results.  The
world of 2 runs every solo case, the world of 4 a subset with both
routes in every dtype and compact on each, the world of 1 three.  The
worlds run their solo cases while the test process runs the JAX package,
then the cases made from its runs.  The JAX runs compile once each
(``torch_lazy.Lazy``), on the 8-device virtual CPU mesh of
``tests/conftest.py`` (the row-major soup on 2 of its devices, the
multislice run on a 2 x 2 mesh of 4).

* Against the port's solo soup, bitwise: the population-major soup at
  N = 512 (phases and fused, full and compact, float32, bfloat16 and
  int8) and the mixed soup of three types at sizes (256, 128, 128) in
  both layouts, three generations with the metrics, health and lineage
  carries: weights, uids, next_uid, the carries (the lineage carry's pids
  and the census exactly; the window, per rank side by side, as a set of
  edges with the same counts).  Every rank holds at least 32 lanes of
  every type: below that torch's CPU column sums (``sum(dim=0)`` of a
  (P, n) block, the census's L2 distance) round differently with the
  lane count (ROADMAP C), which the card's per-lane kernels do not.
* Against the JAX package's ``sharded_evolve_step`` fed the JAX
  package's draws, one generation from each JAX state of a run (three
  generations; two of the row-major mixed soup, one of the others): the
  population-major weightwise soup (phases, fused, compact;
  the JAX package runs its fused route as the phase chain on the CPU),
  the aggregating soup, the mixed soup in both layouts, and the
  row-major soup with JAX's per-device respawn draws (world 2 against a
  2-device JAX mesh); against ``sharded_evolve`` (three generations on
  JAX's 2 x 2 multislice mesh) for the 1-D worlds and the 2 x 2 world,
  and against ``sharded_evolve_multi`` (two row-major generations);
  ``sharded_count`` and ``sharded_count_multi``.  Integers exact; float32
  weights within the port's bound a generation (rtol 2e-5, atol 1e-6;
  the aggregating and mixed soups within the JAX test's own sharded
  bound, rtol 1e-4 / atol 1e-6, ``test_parallel.py:266-275``), the
  three-generation runs within ``test_parallel.py:153-158``'s (rtol
  1e-4, atol 2e-6).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from srnn_tpu import Topology as JTopology
from srnn_tpu import multisoup as jms
from srnn_tpu import parallel as jpar
from srnn_tpu import soup as jsoup
from srnn_tpu.init import fresh_lanes as j_fresh_lanes
from srnn_tpu.init import fresh_rows as j_fresh_rows
from srnn_tpu_torch import Topology, convert
from srnn_tpu_torch import multisoup as ms
from srnn_tpu_torch import soup as st
from srnn_tpu_torch.telemetry.dynamics import seed_lineage, seed_lineage_blocks
from torch_lazy import Lazy
from torch_worlds import Worlds

GENS = 3
WW = Topology("weightwise", width=2, depth=2)
MIX = (WW, Topology("aggregating", width=2, depth=2, aggregates=4),
       Topology("recurrent", width=2, depth=2))
CAPACITY = 2048

# ---------------------------------------------------------------- solo


def _pm_config(impl, comp, dt):
    return st.SoupConfig(
        topo=WW, size=512, attacking_rate=0.1, learn_from_rate=0.1,
        train=2, remove_divergent=True, remove_zero=True,
        layout="popmajor", generation_impl=impl, population_dtype=dt,
        attack_impl=comp, learn_from_impl=comp)


SOLO = {f"pm-{impl}-{comp}-{dt}": ("soup", _pm_config(impl, comp, dt))
        for impl in ("phases", "fused") for comp in ("full", "compact")
        for dt in ("f32", "bf16", "int8")}
SOLO.update({
    f"mx-{layout}-{impl}-{dt}": ("multi", ms.MultiSoupConfig(
        topos=MIX, sizes=(256, 128, 128), attacking_rate=0.3,
        learn_from_rate=0.3, train=1, remove_divergent=True,
        remove_zero=True, layout=layout, generation_impl=impl,
        population_dtype=dt))
    for layout, impl, dt in (("rowmajor", "phases", "f32"),
                             ("rowmajor", "phases", "int8"),
                             ("popmajor", "phases", "bf16"),
                             ("popmajor", "fused", "f32"))})
SEED = 5
#: the solo cases the world of one runs
ONE = ("pm-phases-full-f32", "pm-fused-compact-int8",
       "mx-popmajor-fused-f32")
#: the solo cases the world of four runs: both routes in every dtype,
#: compact on each route, the mixed soup in both layouts
FOUR = tuple(f"pm-{impl}-full-{dt}" for impl in ("phases", "fused")
             for dt in ("f32", "bf16", "int8")) + (
    "pm-phases-compact-f32", "pm-fused-compact-bf16",
    "mx-rowmajor-phases-int8", "mx-popmajor-fused-f32")


def _solo_cases():
    return [{"name": name, "kind": kind, "cfg": cfg, "seed": SEED,
             "gens": GENS, "carries": True, "capacity": CAPACITY}
            for name, (kind, cfg) in SOLO.items()]


def _solo_run(name):
    """The port's single-device run of a solo case, as numpy."""
    from torch_worlds import _np

    kind, cfg = SOLO[name]
    if kind == "soup":
        out = st.evolve(cfg, st.seed(cfg, SEED, "cpu"), GENS, metrics=True,
                        health=True, lineage=True,
                        lineage_state=seed_lineage(cfg.size, device="cpu"),
                        lineage_capacity=CAPACITY)
        count = st.count(cfg, out[0])
    else:
        out = ms.evolve_multi(
            cfg, ms.seed_multi(cfg, SEED, "cpu"), GENS, metrics=True,
            health=True, lineage=True,
            lineage_state=seed_lineage_blocks(cfg.sizes, device="cpu"),
            lineage_capacity=CAPACITY)
        count = ms.count_multi(cfg, out[0])
    final, m, h, (lin, win, stats) = out
    return {"state": _np(final), "count": _np(count),
            "carries": _np((m, h, lin, win, stats))}


@pytest.fixture(scope="module")
def solo():
    return Lazy(_solo_run)


# ----------------------------------------------------------- JAX oracle

JPM = jsoup.SoupConfig(
    topo=JTopology("weightwise", width=2, depth=2), size=64,
    attacking_rate=0.5, learn_from_rate=0.3, learn_from_severity=1, train=2,
    remove_divergent=True, remove_zero=True, layout="popmajor")
JMIX = jms.MultiSoupConfig(
    topos=(JTopology("weightwise", width=2, depth=2),
           JTopology("aggregating", width=2, depth=2)),
    sizes=(16, 16), attacking_rate=0.5, learn_from_rate=0.3,
    learn_from_severity=1, train=1, remove_divergent=True, remove_zero=True)
#: the JAX step runs: name -> (config, seed, kind, steps)
JSTEPS = {
    "pm": (JPM, 7, "soup", GENS),
    "agg": (JPM._replace(topo=JTopology("aggregating", width=2, depth=2),
                         learn_from_rate=-1.0, train=1, size=32), 9, "soup",
            1),
    "mx-pm": (JMIX._replace(layout="popmajor"), 11, "multi", 1),
    "mx-rm": (JMIX, 11, "multi", 2),
    # the row-major soup test's configuration (test_torch_soup_rowmajor's
    # JCFG, attack 0.3): at JPM's attack 0.5 one particle of seed 3
    # reaches |w| ~ 6 and its two training epochs amplify the row-major
    # transform's rounding (the port's multiply-add chains against XLA's
    # dots; unsharded alike) to 1.4e-3
    "rm": (JPM._replace(layout="rowmajor", attacking_rate=0.3), 3, "soup",
           1),
}


def _jax_draws(cfg, key, devices=None):
    """One JAX generation's draws: the global ones, or with ``devices``
    the row-major draws of each device -- the global gates and the
    device's respawn rows (``fold_in(k_re, d)``, ``sharded_soup.py:188``)
    as the rank's (P, N / D) replacements."""
    gates, fresh = jax.tree.map(np.asarray, _draws_fn(cfg, devices)(key))
    if devices is None:
        return st.SoupDraws(*gates, fresh[0])
    return {r: st.SoupDraws(*gates, f) for r, f in enumerate(fresh)}


@functools.lru_cache(maxsize=None)
def _draws_fn(cfg, devices):
    """The draws of ``_jax_draws``, jitted once a configuration (eager,
    the fresh draws cost seconds of small compiles)."""
    n = cfg.size

    def draws(key):
        _, k_ag, k_at, k_lg, k_lt, k_re = jax.random.split(key, 6)
        gates = (jax.random.uniform(k_ag, (n,)) < cfg.attacking_rate,
                 jax.random.randint(k_at, (n,), 0, n),
                 jax.random.uniform(k_lg, (n,)) < cfg.learn_from_rate,
                 jax.random.randint(k_lt, (n,), 0, n))
        if devices is None:
            return gates, (j_fresh_lanes(cfg.topo, k_re, n,
                                         cfg.respawn_draws),)
        return gates, tuple(j_fresh_rows(
            cfg.topo, jax.random.fold_in(k_re, r), n // devices,
            cfg.respawn_draws).T for r in range(devices))

    return jax.jit(draws)


def _jax_multi_draws(cfg, key):
    return ms.MultiSoupDraws(*jax.tree.map(np.asarray,
                                           _multi_draws_fn(cfg)(key)))


@functools.lru_cache(maxsize=None)
def _multi_draws_fn(cfg):
    n = cfg.total

    def draws(key):
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

    return jax.jit(draws)


def _port_config(jcfg, **kw):
    fields = jcfg._asdict()
    if "topos" in fields:
        fields["topos"] = [dataclasses.asdict(t) for t in jcfg.topos]
        return convert.multisoup_config_from_fields(fields)._replace(**kw)
    fields["topo"] = dataclasses.asdict(jcfg.topo)
    return convert.soup_config_from_fields(fields)._replace(**kw)


def _state_args(js, multi):
    if multi:
        return dict(weights=[np.asarray(w) for w in js.weights],
                    uids=[np.asarray(u) for u in js.uids],
                    next_uid=int(js.next_uid), time=int(js.time),
                    scales=None if js.scales is None
                    else [np.asarray(s) for s in js.scales])
    return dict(weights=np.asarray(js.weights), uids=np.asarray(js.uids),
                next_uid=int(js.next_uid), time=int(js.time),
                scales=None if js.scales is None else np.asarray(js.scales))


def _jax_run(name):
    """A JAX sharded run: per step (state before, draws, state after,
    events), and the final state's ``sharded_count`` /
    ``sharded_count_multi``; for 'pm' also ``sharded_evolve`` of the same
    generations on the 2 x 2 multislice mesh, for 'mx-rm'
    ``sharded_evolve_multi``."""
    cfg, seed, kind, steps = JSTEPS[name]
    multi = kind == "multi"
    devices = 2 if name == "rm" else 8
    mesh = jpar.soup_mesh(devices=jax.devices()[:devices])
    make = jpar.make_sharded_multi_state if multi else jpar.make_sharded_state
    step = jpar.sharded_evolve_multi_step if multi \
        else jpar.sharded_evolve_step
    s = make(cfg, mesh, jax.random.key(seed))
    out = {"steps": []}
    for _ in range(steps):
        if name == "rm":
            draws = _jax_draws(cfg, s.key, devices)
        elif multi:
            draws = _jax_multi_draws(cfg, s.key)
        else:
            draws = _jax_draws(cfg, s.key)
        s2, ev = step(cfg, mesh, s)
        out["steps"].append((s, draws, s2, ev))
        s = s2
    if multi:
        out["count"] = np.asarray(jpar.sharded_count_multi(cfg, mesh, s))
    elif name == "pm":
        out["count"] = np.asarray(jpar.sharded_count(cfg, mesh, s))
        mesh2 = jpar.multislice_soup_mesh(2, devices=jax.devices()[:4])
        out["evolve"] = jpar.sharded_evolve(
            cfg, mesh2, make(cfg, mesh2, jax.random.key(seed)),
            generations=steps)
    if name == "mx-rm":
        out["evolve"] = jpar.sharded_evolve_multi(
            cfg, mesh, make(cfg, mesh, jax.random.key(seed)),
            generations=steps)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return Lazy(_jax_run)


PM_IMPLS = {"phases": {}, "fused": {"generation_impl": "fused"},
            "compact": {"attack_impl": "compact",
                        "learn_from_impl": "compact"}}


def _jax_cases(jax_runs, world):
    """The cases that replay the JAX runs on a world: every step (the
    row-major one on a world of 2), and the three-generation runs, also
    on the 2 x 2 multislice mesh of a world of 4 (named ``2x2/...``)."""
    cases = []
    for name, (jcfg, _, kind, _) in JSTEPS.items():
        if name == "rm" and world != 2:
            continue
        impls = PM_IMPLS if name == "pm" else {"phases": {}}
        for impl, kw in impls.items():
            cfg = _port_config(jcfg, **kw)
            for g, (s, draws, _, _) in enumerate(jax_runs[name]["steps"]):
                cases.append({"name": f"jx-{name}-{impl}-g{g}", "kind": kind,
                              "cfg": cfg, "gens": 1, "step": True,
                              "state": _state_args(s, kind == "multi"),
                              "draws": {r: [d] for r, d in draws.items()}
                              if name == "rm" else [draws]})
    for slices in ((None, 2) if world == 4 else (None,)):
        for name in ("pm", "mx-rm"):
            jcfg, _, kind, steps = JSTEPS[name]
            run = jax_runs[name]["steps"]
            cases.append({"name": ("2x2/" if slices else "")
                          + f"jx-{name}-evolve", "slices": slices,
                          "kind": kind, "cfg": _port_config(jcfg),
                          "gens": steps,
                          "state": _state_args(run[0][0], kind == "multi"),
                          "draws": [d for _, d, _, _ in run]})
    return cases


#: the spawned worlds: name -> (ranks, the solo cases it runs)
WORLDS = {"1": (1, ONE), "2": (2, tuple(SOLO)), "4": (4, FOUR)}


@pytest.fixture(scope="module")
def worlds(jax_runs):
    """World name -> rank 0's results.  The first read starts every world
    at once on its solo cases, runs the JAX package meanwhile and feeds
    the worlds of several ranks the cases made from it (each world runs
    all its cases in one spawn); a failure is kept, so that it stands for
    every test that reads it rather than respawning the worlds (a JAX
    failure stands for the JAX tests, which read ``jax_runs`` first)."""
    results = {}

    names = (*WORLDS, "2x2")

    def spawn():
        try:
            spawned = Worlds({
                name: (ranks, [c for c in _solo_cases() if c["name"] in solo])
                for name, (ranks, solo) in WORLDS.items()})
        except Exception as e:  # kept, re-raised by every reader
            results.update({name: e for name in names})
            return
        try:
            spawned.feed({name: _jax_cases(jax_runs, ranks)
                          for name, (ranks, _) in WORLDS.items() if ranks > 1})
        except Exception:
            pass  # the JAX tests meet it again in jax_runs
        try:
            results.update(spawned.wait())
        except Exception as e:
            results.update({name: e for name in names})
            return
        four = results["4"]
        results["2x2"] = {k[4:]: four.pop(k) for k in list(four)
                          if k.startswith("2x2/")}

    def read(name):
        if not results:
            spawn()
        if isinstance(results[name], Exception):
            raise results[name]
        return results[name]

    return read


# ------------------------------------------------------------- helpers


def _bits(a):
    """float32 (or bfloat16 widened) arrays as their bits; others as they
    are: bitwise comparison that also holds NaN and the sign of zero."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want, where=""):
    """Bitwise equality of two nested results."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want), where)


def _edges(win, capacity):
    """The valid edge rows of a (per-rank side by side) window, sorted."""
    edges = np.asarray(win["edges"]).reshape(-1, capacity, 5)
    counts = np.asarray(win["n_edges"]).reshape(-1)
    rows = [tuple(r) for seg, c in zip(edges, counts) for r in seg[:c]]
    return sorted(rows)


# --------------------------------------------------------------- tests


@pytest.mark.parametrize("world, name", [
    (w, n) for w, (_, solo) in WORLDS.items() for n in solo])
def test_sharded_equals_solo_bitwise(worlds, solo, world, name):
    """The sharded soup (world of 1, 2 and 4 ranks) equals the port's
    single-device soup bit for bit: the state, the class counts, the
    metrics and health carries, the lineage carry and census; the
    window's edges as a set, with the same counts."""
    got = worlds(world)[name]
    want = solo[name]
    _same(got["state"], want["state"], "state")
    _same(got["count"], want["count"], "count")
    (gm, gh, glin, gwin, gstats) = got["carries"]
    (wm, wh, wlin, wwin, wstats) = want["carries"]
    _same(gm, wm, "metrics")
    _same(gh, wh, "health")
    _same(glin, wlin, "lineage")
    _same(gstats, wstats, "fixpoints")
    assert _edges(gwin, CAPACITY) == _edges(wwin, CAPACITY)
    for f in ("births", "dropped"):
        np.testing.assert_array_equal(
            np.asarray(gwin[f]).reshape(-1, *np.asarray(wwin[f]).shape[1:])
            .sum(0), np.asarray(wwin[f]).sum(0), f)


def _check_soup(got, js, cfg, rtol, atol, msg):
    gw = np.asarray(got["weights"])
    jw = np.asarray(js.weights)
    np.testing.assert_allclose(gw, jw, rtol=rtol, atol=atol, err_msg=msg)
    np.testing.assert_array_equal(got["uids"], np.asarray(js.uids), msg)
    assert int(got["next_uid"]) == int(js.next_uid), msg
    assert int(got["time"]) == int(js.time), msg


def _check_multi(got, js, rtol, atol, msg):
    for t, (gw, jw) in enumerate(zip(got["weights"], js.weights)):
        np.testing.assert_allclose(np.asarray(gw), np.asarray(jw), rtol=rtol,
                                   atol=atol, err_msg=f"{msg} type {t}")
        np.testing.assert_array_equal(got["uids"][t], np.asarray(js.uids[t]),
                                      msg)
    assert int(got["next_uid"]) == int(js.next_uid), msg


def _check_events(got, ev, msg):
    for f in ("action", "counterpart"):
        g, w = got[f], getattr(ev, f)
        if isinstance(w, tuple):
            for gt, wt in zip(g, w):
                np.testing.assert_array_equal(gt, np.asarray(wt), msg)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), msg)


JAX_STEP_CASES = [(name, impl, g)
                  for name, (_, _, _, steps) in JSTEPS.items()
                  for impl in (PM_IMPLS if name == "pm" else ("phases",))
                  for g in range(steps)]


@pytest.mark.parametrize("world, name, impl, g", [
    (w, *case) for w in ("2", "4") for case in JAX_STEP_CASES
    if case[0] != "rm" or w == "2"])
def test_sharded_step_matches_jax(worlds, jax_runs, world, name, impl, g):
    """One generation of the port's ``sharded_evolve_step`` from a JAX
    state, fed JAX's draws, against JAX's ``sharded_evolve_step``: the
    integers exact, the weights within a generation's bound (the
    row-major soup on the world of 2 only: its per-device respawn draws
    are a 2-device JAX mesh's)."""
    _, _, s2, ev = jax_runs[name]["steps"][g]
    got = worlds(world)[f"jx-{name}-{impl}-g{g}"]
    rtol, atol = (2e-5, 1e-6) if name in ("pm", "rm") else (1e-4, 1e-6)
    if JSTEPS[name][2] == "multi":
        _check_multi(got["state"], s2, rtol, atol, name)
    else:
        _check_soup(got["state"], s2, None, rtol, atol, name)
    _check_events(got["events"][0], ev, name)


@pytest.mark.parametrize("world", ["2", "4", "2x2"])
def test_sharded_evolve_and_count_match_jax(worlds, jax_runs, world):
    """Three generations of the port's ``sharded_evolve`` (the 1-D worlds
    and the 2 x 2 multislice world) against JAX's ``sharded_evolve`` on
    its 2 x 2 multislice mesh and the last of JAX's steps, fed its draws;
    two of ``sharded_evolve_multi`` (row-major) against JAX's;
    ``sharded_count`` exact."""
    jpm, jmx = jax_runs["pm"], jax_runs["mx-rm"]
    res = worlds(world)
    if world == "2x2":
        for name in ("jx-pm-evolve", "jx-mx-rm-evolve"):
            assert res[name]["mesh"] == (("slices", "soup"), (2, 2), 4)
    got = res["jx-pm-evolve"]
    for want in (jpm["evolve"], jpm["steps"][-1][2]):
        _check_soup(got["state"], want, None, 1e-4, 2e-6, world)
    np.testing.assert_array_equal(got["count"], jpm["count"])
    _check_multi(res["jx-mx-rm-evolve"]["state"], jmx["evolve"], 1e-4, 1e-6,
                 world)


@pytest.mark.parametrize("world", ["2", "4"])
@pytest.mark.parametrize("name", ["mx-pm", "mx-rm"])
def test_sharded_count_multi_matches_jax(worlds, jax_runs, world, name):
    """``sharded_count_multi`` after the mixed step, exact."""
    want = jax_runs[name]["count"]
    got = worlds(world)[f"jx-{name}-phases-g{JSTEPS[name][3] - 1}"]
    np.testing.assert_array_equal(got["count"], want)


class _TwoRanks:
    """A mesh of two ranks, for the checks a sharded call makes before
    its first collective."""
    size, rank = 2, 0

    def block(self, n):
        from srnn_tpu_torch.parallel.mesh import SoupMesh

        return SoupMesh.block(self, n)


def test_placement_and_probe(monkeypatch):
    """``shard_population`` keeps the rank's block of the full host
    value, ``replicate`` the whole value, both on the mesh's device, as
    JAX's ``global_device_put`` contract; ``probe_devices`` sees the CPU
    alone on a CPU run, and keeps it when verified."""
    import torch

    from srnn_tpu_torch import parallel as par

    class Rank1(_TwoRanks):
        rank, device = 1, torch.device("cpu")

    pop = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    blk = par.shard_population(Rank1(), pop)
    assert torch.equal(blk, pop[4:]) and blk.is_contiguous()
    assert torch.equal(par.replicate(Rank1(), pop), pop)
    assert par.replicate(Rank1(), 7) == 7
    with pytest.raises(ValueError, match="divisible by the mesh's 2"):
        par.shard_population(Rank1(), pop[:7])
    monkeypatch.setenv("SRNN_SETUPS_PLATFORM", "cpu")
    cpu = [torch.device("cpu")]
    assert par.probe_devices() == cpu == par.probe_devices(verify=True)


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_keep_jax_wording(mesh):
    """Compact and fused in the row-major layout, an indivisible size and
    an indivisible type refuse with the JAX package's words."""
    from srnn_tpu_torch import parallel as par

    two = _TwoRanks()
    for kw in ({"attack_impl": "compact"}, {"generation_impl": "fused"}):
        jcfg = JPM._replace(layout="rowmajor", size=16, **kw)
        want = _jax_error(lambda: jpar.sharded_evolve_step(
            jcfg, mesh, jpar.make_sharded_state(
                jcfg._replace(attack_impl="full", generation_impl="phases"),
                mesh, jax.random.key(0))))
        cfg = _port_config(jcfg)
        s0 = st.seed(cfg._replace(attack_impl="full",
                                  generation_impl="phases"), 0, "cpu")
        with pytest.raises(ValueError) as e:
            par.sharded_evolve_step(cfg, two, s0._replace(
                weights=s0.weights[:8], uids=s0.uids[:8]))
        assert str(e.value) == want
    jcfg = jms.MultiSoupConfig(topos=(JTopology("weightwise"),
                                      JTopology("aggregating")),
                               sizes=(16, 9))
    with pytest.raises(ValueError) as e:
        jpar.make_sharded_multi_state(jcfg, mesh, jax.random.key(0))
    cfg = _port_config(jcfg)
    with pytest.raises(ValueError) as e2:
        par.make_sharded_multi_state(cfg, two, 0)
    assert str(e2.value) == str(e.value).replace("8 devices", "2 devices")
    with pytest.raises(ValueError, match="must be divisible by the mesh's 2"):
        par.place_sharded_state(two, st.seed(_pm_config("phases", "full",
                                                         "f32")._replace(
                                                             size=15),
                                             0, "cpu"))
