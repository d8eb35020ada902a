"""Streaming trajectory capture (``srnn_tpu_torch/utils/capture.py``) and
``soup_trajectorys --store``.

* ``evolve_captured`` / ``evolve_multi_captured``: the pipelined frames
  equal the blocking ones, and both equal ``evolve(record=True)`` at the
  captured generations, BITWISE, at every 1 and 3, for float32 and int8
  populations, homogeneous (population-major) and mixed (row-major); the
  final state equals the uncaptured run's, and no writer thread is left.
* An int8 population's frames hold its dequantized view, as
  ``evolve(record=True)`` records it; the JAX package's ``evolve_captured``
  writes the raw codes (ROADMAP.md, C, known gaps), shown here on the same
  kind of population.
* ``python -m srnn_tpu_torch.setups soup_trajectorys --store
  --capture-every 2`` writes ``soup.traj``, which the JAX package's
  ``read_store`` reads, equal to the same run's recorded history.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

import srnn_tpu_torch as st
from srnn_tpu import Topology as JTopology
from srnn_tpu import soup as jsoup
from srnn_tpu.utils import TrajStore as JTrajStore
from srnn_tpu.utils import evolve_captured as j_evolve_captured
from srnn_tpu.utils import read_store as j_read_store
from srnn_tpu_torch import experiment
from srnn_tpu_torch.setups.__main__ import main as setups_main
from srnn_tpu_torch.soup import ACTION_NAMES
from srnn_tpu_torch.telemetry import EVENT_COUNTERS, MetricsRegistry
from srnn_tpu_torch.utils import (TrajStore, evolve_captured,
                                  evolve_multi_captured, read_store)
from srnn_tpu_torch.utils.pipeline import BackgroundWriter, live_threads

GENERATIONS = 6
FIELDS = ("weights", "uids", "action", "counterpart", "loss")
DYNAMICS = dict(attacking_rate=0.3, learn_from_rate=0.3,
                learn_from_severity=1, train=1, remove_divergent=True,
                remove_zero=True)


def _soup(dtype):
    cfg = st.SoupConfig(topo=st.Topology("weightwise"), size=24,
                        layout="popmajor", population_dtype=dtype,
                        **DYNAMICS)
    return cfg, st.seed(cfg, 3, device="cpu")


def _mixed(dtype):
    cfg = st.MultiSoupConfig(
        topos=(st.Topology("weightwise"),
               st.Topology("aggregating", aggregates=4),
               st.Topology("recurrent")),
        sizes=(8, 6, 7), population_dtype=dtype, **DYNAMICS)
    return cfg, st.seed_multi(cfg, 4, device="cpu")


def _record_multi(cfg, state, generations):
    """The mixed soup's per-generation history, a step at a time: per
    generation (weights in the stored view, uids, action, counterpart,
    loss), each a tuple over the types."""
    rows = []
    for _ in range(generations):
        state, ev = st.evolve_multi_step(cfg, state)
        views = tuple(st.soup._stored_view(
            cfg, w, None if state.scales is None else state.scales[t])
            for t, w in enumerate(state.weights))
        rows.append((views, state.uids, *ev))
    return state, rows


def _capture(fn, cfg, state, stores_shape, path, every, pipelined,
             writer=None):
    paths = [f"{path}-{t}.traj" for t in range(len(stores_shape))]
    stores = [TrajStore(p, n, pw) for p, (n, pw) in zip(paths, stores_shape)]
    try:
        arg = stores if fn is evolve_multi_captured else stores[0]
        final = fn(cfg, state, GENERATIONS, arg, every=every,
                   pipelined=pipelined, writer=writer)
    finally:
        for s in stores:
            s.close()
    return final, [read_store(p) for p in paths]


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("kind", ["soup", "mixed"])
def test_frames_equal_record_bitwise(tmp_path, kind, every, dtype):
    if kind == "soup":
        cfg, s0 = _soup(dtype)
        shapes = [(cfg.size, cfg.topo.num_weights)]
        fn = evolve_captured
        final_ref, (ev, w, u) = st.evolve(cfg, s0, GENERATIONS, record=True)
        rows = [tuple((x[g],) for x in (w, u, *ev))
                for g in range(GENERATIONS)]
    else:
        cfg, s0 = _mixed(dtype)
        shapes = [(n, t.num_weights) for n, t in zip(cfg.sizes, cfg.topos)]
        fn = evolve_multi_captured
        final_ref, rows = _record_multi(cfg, s0, GENERATIONS)
    runs = {}
    for pipelined in (True, False):
        runs[pipelined] = _capture(fn, cfg, s0, shapes,
                                   str(tmp_path / f"p{pipelined}"), every,
                                   pipelined)
    assert live_threads() == []
    captured = list(range(every - 1, GENERATIONS, every))
    for pipelined, (final, outs) in runs.items():
        for t, out in enumerate(outs):
            assert out["generations"].tolist() == [g + 1 for g in captured]
            for i, g in enumerate(captured):
                for key, x in zip(FIELDS, rows[g]):
                    np.testing.assert_array_equal(
                        out[key][i].view(np.int32),
                        x[t].float().numpy().view(np.int32)
                        if key in ("weights", "loss") else x[t].numpy(),
                        err_msg=f"{key} generation {g + 1} type {t}")
        finals = (final.weights if kind == "mixed" else (final.weights,))
        refs = (final_ref.weights if kind == "mixed"
                else (final_ref.weights,))
        for a, b in zip(finals, refs):
            assert torch.equal(a, b)
    for a, b in zip(runs[True][1], runs[False][1]):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_shared_writer_and_refusals(tmp_path):
    """A caller's writer is used and left open (the caller flushes and
    closes it); a stride that does not divide the run, and ``registry=``,
    raise."""
    cfg, s0 = _soup("f32")
    path = str(tmp_path / "w.traj")
    writer = BackgroundWriter(name="t-capture")
    try:
        with TrajStore(path, cfg.size, cfg.topo.num_weights) as store:
            evolve_captured(cfg, s0, 4, store, every=2, writer=writer)
            writer.flush()
        assert read_store(path)["generations"].tolist() == [2, 4]
        writer.submit(lambda: None)  # still open
    finally:
        writer.close()
    with TrajStore(str(tmp_path / "x.traj"), cfg.size,
                   cfg.topo.num_weights) as store:
        with pytest.raises(ValueError, match="divisible"):
            evolve_captured(cfg, s0, 5, store, every=2)
    # registry= meters every generation, pipelined and blocking alike: the
    # counters equal the metrics carry of the uncaptured run
    _, m = st.evolve(cfg, s0, 4, metrics=True)
    for pipelined in (True, False):
        reg = MetricsRegistry()
        with TrajStore(str(tmp_path / f"m{pipelined}.traj"), cfg.size,
                       cfg.topo.num_weights) as store:
            evolve_captured(cfg, s0, 4, store, every=2, registry=reg,
                            pipelined=pipelined)
        assert reg.counter("soup_generations_total").value() == 4
        assert reg.counter("soup_particle_generations_total").value() == \
            4 * cfg.size
        for code, name in enumerate(ACTION_NAMES):
            if name in EVENT_COUNTERS:
                assert reg.counter(EVENT_COUNTERS[name][0]).value() == \
                    int(m.actions[code]), name
    assert live_threads() == []


def test_int8_frames_hold_the_dequantized_view(tmp_path):
    """The port's frame of an int8 population is its dequantized float32
    view (bitwise ``evolve(record=True)``'s), not its codes; the JAX
    package's ``evolve_captured`` stores the codes (integers in
    [-127, 127]) where its own ``evolve(record=True)`` records the view."""
    cfg, s0 = _soup("int8")
    path = str(tmp_path / "q.traj")
    with TrajStore(path, cfg.size, cfg.topo.num_weights) as store:
        evolve_captured(cfg, s0, 1, store)
    frame = read_store(path)["weights"][0]
    _, (_, w, _) = st.evolve(cfg, s0, 1, record=True)
    np.testing.assert_array_equal(frame, w[0].numpy())
    assert not np.array_equal(frame, np.round(frame))

    jcfg = jsoup.SoupConfig(topo=JTopology("weightwise"), size=8,
                            layout="popmajor", population_dtype="int8",
                            attacking_rate=0.3, learn_from_rate=-1.0)
    js = jsoup.seed(jcfg, jax.random.key(0))
    jpath = str(tmp_path / "j.traj")
    with JTrajStore(jpath, 8, 14) as store:
        j_evolve_captured(jcfg, js, 1, store, pipelined=False)
    jframe = j_read_store(jpath)["weights"][0]
    _, (_, jw, _) = jsoup.evolve(jcfg, js, 1, record=True)
    assert np.array_equal(jframe, np.round(jframe))
    assert np.abs(jframe).max() <= 127
    assert not np.array_equal(jframe, np.asarray(jw[0]))


def test_soup_trajectorys_store_read_by_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SRNN_SETUPS_PLATFORM", "cpu")
    args = ["soup_trajectorys", "--soup-size", "6", "--generations", "4",
            "--train", "2", "--seed", "1"]
    runs = {}
    for name, flags in (("store", ["--store", "--capture-every", "2",
                                   "--checkpoint"]), ("record", [])):
        root = tmp_path / name
        assert setups_main([*args, "--root", str(root), *flags]) == 0
        (runs[name],) = glob.glob(str(root / "*"))
    out = j_read_store(os.path.join(runs["store"], "soup.traj"))
    hist = experiment.load_artifact(os.path.join(runs["record"], "soup"))
    assert out["generations"].tolist() == [2, 4]
    for key in FIELDS:
        np.testing.assert_array_equal(out[key], hist[key][[1, 3]])
    final = experiment.restore_checkpoint(os.path.join(runs["store"],
                                                       "checkpoint"))
    np.testing.assert_array_equal(final.uids.numpy(), out["uids"][-1])
    np.testing.assert_array_equal(
        experiment.load_artifact(os.path.join(runs["store"],
                                              "all_counters")),
        experiment.load_artifact(os.path.join(runs["record"],
                                              "all_counters")))
    assert not os.path.exists(os.path.join(runs["store"], "soup.npz"))
