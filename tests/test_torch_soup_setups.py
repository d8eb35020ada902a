"""The port's soup setups on the CPU: the stacked trials of
``setups.common.evolve_trials`` against the same soups evolved alone, the
soup checkpoints, and the three soup CLIs (``python -m
srnn_tpu_torch.setups soup_trajectorys | learn_from_soup | mixed_soup``)
in ``--smoke`` under ``SRNN_SETUPS_PLATFORM=cpu``, their artifacts loaded
through the JAX package's ``srnn_tpu.experiment.load_artifact`` with the
keys, shapes and dtypes that the JAX package's setups write
(``srnn_tpu/setups/soup_trajectorys.py``, ``learn_from_soup.py``,
``mixed_soup.py``).  Every comparison inside the port is bitwise."""

import json
import os

import numpy as np
import pytest
import torch

from srnn_tpu import experiment as jexperiment
from srnn_tpu.utils import read_store
import srnn_tpu_torch as st
from srnn_tpu_torch import experiment
from srnn_tpu_torch import soup
from srnn_tpu_torch.setups import common
from srnn_tpu_torch.setups.__main__ import main as setups_main

VARIANT_NAMES = [name for name, _ in common.STANDARD_VARIANTS]
CPU = torch.device("cpu")


def _config(variant="weightwise", **kw):
    topo = st.Topology(variant, width=2, depth=2, aggregates=4)
    return st.SoupConfig(topo=topo, size=8, attacking_rate=0.3,
                         learn_from_rate=0.3, learn_from_severity=1,
                         train=2, remove_divergent=True, remove_zero=True,
                         **kw)


def _equal(a: st.SoupState, b: st.SoupState) -> bool:
    same = all(torch.equal(x, y) for x, y in zip(
        (a.weights, a.uids, a.next_uid, a.time),
        (b.weights, b.uids, b.next_uid, b.time)))
    if (a.scales is None) != (b.scales is None):
        return False
    return same and (a.scales is None or torch.equal(a.scales, b.scales))


@pytest.mark.parametrize("kw", [dict(), dict(train_mode="full_batch"),
                                dict(variant="aggregating"),
                                dict(population_dtype="int8")],
                         ids=["weightwise", "full_batch", "aggregating",
                              "int8"])
def test_trials_equal_lone_soups(kw):
    """(e): B = 3 trials in one batch equal the three soups evolved alone,
    bitwise: from ``evolve_trials``' own seeds, and from states with a zero
    and a diverged particle planted (respawns, uids ranked per trial)."""
    cfg = _config(**kw)
    got = common.evolve_trials(cfg, 3, 3, CPU, 11, 2)
    assert got.weights.shape == (3, 8, cfg.topo.num_weights)
    for t in range(3):
        lone = st.evolve(cfg, st.seed(cfg, common.generator(11, 2, t),
                                      CPU), 3)
        assert torch.equal(got.weights[t], lone.weights)
        assert torch.equal(got.uids[t], lone.uids)
        assert int(got.next_uid[t]) == int(lone.next_uid)
    states = []
    for t in range(3):
        s = st.seed(cfg, common.generator(5, t), CPU)
        w = s.weights.clone()
        w[t] = 0
        if s.scales is None:
            w[(t + 1) % 8, 2] = float("inf")
        states.append(s._replace(weights=w))
    batch, (ev, w_rec, uids_rec) = st.evolve(cfg, soup.stack(states), 2,
                                             record=True)
    assert w_rec.shape == (2, 3, 8, cfg.topo.num_weights)
    assert ev.action.shape == uids_rec.shape == (2, 3, 8)
    for t, s in enumerate(states):
        lone, (lev, lw, luids) = st.evolve(cfg, s, 2, record=True)
        assert torch.equal(batch.weights[t], lone.weights)
        assert torch.equal(batch.uids[t], lone.uids)
        assert int(batch.next_uid[t]) == int(lone.next_uid)
        assert torch.equal(ev.action[:, t], lev.action)
        assert torch.equal(ev.counterpart[:, t], lev.counterpart)
        assert torch.equal(w_rec[:, t], lw)
        assert int(lone.next_uid) > 8  # a respawn happened
    counts = common.count_soup_trials(cfg, got)
    assert counts.dtype == np.int64 and counts.sum() == 24
    np.testing.assert_array_equal(counts, st.count(cfg, got).numpy())


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_checkpoint_round_trip(tmp_path, dtype):
    """(f): evolve 3 generations, save, restore, evolve 2 more: equal to 5
    generations in one go, bitwise, the generator's stream included."""
    cfg = _config(population_dtype=dtype)
    s0 = st.seed(cfg, 9, device="cpu")
    mid = st.evolve(cfg, s0, 3)
    path = experiment.save_checkpoint(str(tmp_path / "ckpt-gen3"), mid)
    assert common.checkpoint_intact(path)
    back = experiment.restore_checkpoint(path)
    assert _equal(back, mid)
    assert torch.equal(back.key.get_state(), mid.key.get_state())
    assert _equal(st.evolve(cfg, back, 2), st.evolve(cfg, s0, 5))
    # overwriting a checkpoint, and one without its marker
    experiment.save_checkpoint(path, st.evolve(cfg, back, 1))
    assert int(experiment.restore_checkpoint(path).time) == 4
    torn = tmp_path / "ckpt-gen7"
    experiment.save_checkpoint(str(torn), mid)
    os.remove(torn / experiment.CKPT_OK_MARKER)
    assert not common.checkpoint_intact(str(torn))
    assert not common.checkpoint_intact(str(tmp_path / "absent"))
    assert common.latest_checkpoint(str(tmp_path)) == path
    with pytest.raises(ValueError, match="stacked"):
        experiment.save_checkpoint(str(tmp_path / "x"),
                                   soup.stack([mid, mid]))


@pytest.fixture
def on_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv(common.PLATFORM_ENV, "cpu")
    counts = tmp_path / "launches.json"
    monkeypatch.setenv("SRNN_LAUNCH_COUNTS", str(counts))
    return counts


def _run(name, root, flags=()):
    assert setups_main([name, "--smoke", "--root", str(root), "--seed", "1",
                        *flags]) == 0
    (run_dir,) = [os.path.join(root, d) for d in os.listdir(root)]
    return run_dir


def _load(run_dir, name):
    return jexperiment.load_artifact(os.path.join(run_dir, name))


def _shapes(tree):
    return {k: (v.shape, v.dtype) for k, v in tree.items()}


def test_soup_trajectorys_smoke(tmp_path, on_cpu):
    """(g) soup_trajectorys: the (G, N, P) history and the counters, a
    checkpoint that restores, ``--store`` streaming the history to
    ``soup.traj`` instead (tests/test_torch_capture.py holds its frames),
    and ``--service`` a client of a running service (none answers here,
    so the submit fails; tests/test_torch_serve.py drives a live one)."""
    run_dir = _run("soup_trajectorys", tmp_path / "runs", ["--checkpoint"])
    g, n = 5, 6
    assert _shapes(_load(run_dir, "soup")) == {
        "weights": ((g, n, 14), np.float32), "uids": ((g, n), np.int32),
        "action": ((g, n), np.int32), "counterpart": ((g, n), np.int32),
        "loss": ((g, n), np.float32)}
    assert _load(run_dir, "action_names") == list(soup.ACTION_NAMES)
    counters = _load(run_dir, "all_counters")
    assert (counters.shape, counters.dtype) == ((5,), np.int32)
    assert counters.sum() == n
    final = experiment.restore_checkpoint(os.path.join(run_dir,
                                                       "checkpoint"))
    assert int(final.time) == g
    np.testing.assert_array_equal(final.uids.numpy(),
                                  _load(run_dir, "soup")["uids"][-1])
    assert json.loads(on_cpu.read_text())["ww_sgd"] == 0
    stored = _run("soup_trajectorys", tmp_path / "stored", ["--store"])
    assert read_store(os.path.join(stored, "soup.traj"))[
        "generations"].tolist() == list(range(1, g + 1))
    assert not os.path.exists(os.path.join(stored, "soup.npz"))
    with pytest.raises(OSError):
        setups_main(["soup_trajectorys", "--smoke", "--root",
                     str(tmp_path / "refused"), "--service",
                     str(tmp_path / "no.sock")])


@pytest.mark.parametrize("name", ["learn_from_soup", "mixed_soup"])
def test_soup_sweep_smoke(tmp_path, on_cpu, name):
    """(g) the two sweeps: ``all_names``, ``all_data`` per point, and
    learn_from_soup's last stacked trials."""
    run_dir = _run(name, tmp_path / "runs")
    names = _load(run_dir, "all_names")
    data = _load(run_dir, "all_data")
    if name == "learn_from_soup":
        assert names == VARIANT_NAMES[:1]
        assert [d["xs"] for d in data] == [[0, 2]]
        assert _shapes(_load(run_dir, "soup")) == {
            "weights": ((2, 10, 14), np.float32),
            "uids": ((2, 10), np.int32)}
    else:
        assert names == VARIANT_NAMES[:2]
        assert [d["xs"] for d in data] == [[0, 3]] * 2
    for d in data:
        # averages per soup of 10 particles
        assert all(0.0 <= v <= 10.0 for v in d["ys"] + d["zs"])
    assert set(json.loads(on_cpu.read_text()).values()) == {0}
