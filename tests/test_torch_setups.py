"""The port's run layer (``experiment.py``) and its six fixpoint setups
(``python -m srnn_tpu_torch.setups``) on the CPU: every CLI runs in
``--smoke`` under ``SRNN_SETUPS_PLATFORM=cpu``, and its artifacts load
through the JAX package's ``srnn_tpu.experiment.load_artifact`` with the
keys, shapes and dtypes that the JAX package's setups write
(``srnn_tpu/setups/*.py``); its ``log.txt`` counter lines are the JAX
package's ``format_counters`` text of those counts.  Artifacts written by
either package load in the other."""

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srnn_tpu import experiment as jexperiment
from srnn_tpu_torch import experiment
from srnn_tpu_torch.setups import REGISTRY
from srnn_tpu_torch.setups import common
from srnn_tpu_torch.setups.__main__ import main as setups_main

NAMES = ["applying_fixpoints", "fixpoint_density", "known_fixpoint_variation",
         "mixed_self_fixpoints", "network_trajectorys", "training_fixpoints"]
VARIANT_NAMES = [name for name, _ in common.STANDARD_VARIANTS]

#: per setup at --smoke: artifact -> (shape, dtype) of a bare array,
#: {key: (shape, dtype)} of an npz tree, or the parsed JSON
EXPECTED = {
    "applying_fixpoints": {
        "all_counters": ((3, 5), np.int32),
        "all_names": VARIANT_NAMES,
        "trajectorys": {"weightwise": ((11, 4, 14), np.float32),
                        "aggregating": ((11, 4, 20), np.float32),
                        "recurrent": ((11, 4, 17), np.float32)},
    },
    "fixpoint_density": {
        "all_counters": ((2, 5), np.int32),
        "all_names": VARIANT_NAMES[:2],
        "config": {"trials": 64, "batch": 32, "epsilon": 1e-4,
                   "execution_mode": "process"},
    },
    "known_fixpoint_variation": {
        "data": {"xs": ((24,), np.float64), "ys": ((24,), np.int32),
                 "zs": ((24,), np.int32)},
        "meta_sweep": {"depth": 3, "trials": 8, "max_steps": 20},
    },
    "mixed_self_fixpoints": {"all_names": VARIANT_NAMES},
    "network_trajectorys": {
        "trajectorys": {"weights": ((11, 3, 14), np.float32),
                        "classes": ((3,), np.int32)},
        "all_counters": ((5,), np.int32),
    },
    "training_fixpoints": {
        "all_counters": ((3, 5), np.int32),
        "all_names": VARIANT_NAMES,
        "trajectorys": {"weightwise": ((21, 4, 14), np.float32),
                        "aggregating": ((21, 4, 20), np.float32),
                        "recurrent": ((21, 4, 17), np.float32)},
    },
}
EXTRA_FLAGS = {"applying_fixpoints": ["--record"],
               "training_fixpoints": ["--record"]}


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv(common.PLATFORM_ENV, "cpu")


def _run(name, root, flags=()):
    assert setups_main([name, "--smoke", "--root", str(root), "--seed", "1",
                        *flags]) == 0
    (run_dir,) = [os.path.join(root, d) for d in os.listdir(root)]
    return run_dir


def test_registry():
    assert sorted(REGISTRY) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_setup_smoke_artifacts_load_in_jax(name, tmp_path, on_cpu,
                                           monkeypatch):
    counts_path = tmp_path / "launches.json"
    monkeypatch.setenv("SRNN_LAUNCH_COUNTS", str(counts_path))
    run_dir = _run(name, tmp_path / "runs", EXTRA_FLAGS.get(name, ()))
    for fname in ("log.txt", "meta.json", "events.jsonl"):
        assert os.path.exists(os.path.join(run_dir, fname))
    for artifact, want in EXPECTED[name].items():
        got = jexperiment.load_artifact(os.path.join(run_dir, artifact))
        if isinstance(want, tuple):
            assert (got.shape, got.dtype) == want, artifact
        elif isinstance(want, dict) and all(isinstance(v, tuple)
                                            for v in want.values()):
            assert sorted(got) == sorted(want), artifact
            for key, (shape, dtype) in want.items():
                assert got[key].shape == shape, (artifact, key)
                assert got[key].dtype == dtype, (artifact, key)
        else:
            assert got == want, artifact
    if name == "mixed_self_fixpoints":
        data = jexperiment.load_artifact(os.path.join(run_dir, "all_data"))
        assert [d["xs"] for d in data] == [[0, 5]] * 3
        assert all(0.0 <= y <= 1.0 for d in data for y in d["ys"])
    # on the CPU no kernel launches; the counts file lists the kernels
    launches = json.loads(counts_path.read_text())
    assert "ww_apply" in launches and set(launches.values()) == {0}


@pytest.mark.parametrize("name", ["applying_fixpoints", "fixpoint_density",
                                  "training_fixpoints",
                                  "network_trajectorys"])
def test_log_counter_lines_are_jax_text(name, tmp_path, on_cpu):
    """Each counter line of log.txt is ``<name>: <dict>``, the dict the
    JAX package's ``format_counters`` text of the saved counts."""
    run_dir = _run(name, tmp_path)
    counters = np.atleast_2d(jexperiment.load_artifact(
        os.path.join(run_dir, "all_counters")))
    with open(os.path.join(run_dir, "log.txt")) as f:
        lines = [line.rstrip("\n") for line in f if ": {'divergent'" in line]
    assert len(lines) == len(counters)
    for line, row in zip(lines, counters):
        label, text = line.split(": ", 1)
        assert text == jexperiment.format_counters(jnp.asarray(row))
        assert sum(ast.literal_eval(text).values()) == row.sum() > 0
        if name != "network_trajectorys":
            assert label in VARIANT_NAMES


def test_known_fixpoint_variation_log_and_reproducibility(tmp_path, on_cpu):
    a = _run("known_fixpoint_variation", tmp_path / "a")
    b = _run("known_fixpoint_variation", tmp_path / "b")
    da, db = (jexperiment.load_artifact(os.path.join(d, "data"))
              for d in (a, b))
    for key in ("xs", "ys", "zs"):
        np.testing.assert_array_equal(da[key], db[key])
    np.testing.assert_array_equal(da["xs"], np.repeat([1.0, 0.1, 0.01], 8))
    with open(os.path.join(a, "log.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "variation 10e-0"
    assert lines[1] == ("avg time to vergence "
                        + str(float(np.mean(da["ys"][:8]))))


def test_full_batch_mode_runs(tmp_path, on_cpu):
    run_dir = _run("mixed_self_fixpoints", tmp_path,
                   ["--train-mode", "full_batch"])
    assert len(jexperiment.load_artifact(
        os.path.join(run_dir, "all_data"))) == 3


def test_without_card_fails_and_service_is_refused(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.delenv(common.PLATFORM_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert setups_main(["training_fixpoints", "--smoke", "--root",
                        str(tmp_path)]) == 1
    assert "SRNN_SETUPS_PLATFORM=cpu" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
    monkeypatch.setenv(common.PLATFORM_ENV, "cpu")
    with pytest.raises(SystemExit) as e:
        setups_main(["fixpoint_density", "--smoke", "--root", str(tmp_path),
                     "--service", "/tmp/serve.sock"])
    assert e.value.code == 2
    assert "--service" in capsys.readouterr().err
    assert setups_main([]) == 0 and setups_main(["no_such_setup"]) == 2


def test_artifacts_cross_load_and_counters_text(tmp_path):
    value = {"b": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                   "c": np.arange(3, dtype=np.int32)},
             "a": [torch.ones(2), np.zeros(1)]}
    jvalue = {"b": {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
                    "c": jnp.arange(3, dtype=jnp.int32)},
              "a": [jnp.ones(2), jnp.zeros(1)]}
    for saver, loader, v in (
            (experiment.save_artifact, jexperiment.load_artifact, value),
            (jexperiment.save_artifact, experiment.load_artifact, jvalue)):
        for stem, item in (("tree", v), ("bare", v["b"]["w"]),
                           ("doc", {"names": ["x", "y"], "n": 3})):
            saver(str(tmp_path / f"{stem}-{saver.__module__}"), item)
            got = loader(str(tmp_path / f"{stem}-{saver.__module__}"))
            if stem == "tree":
                assert sorted(got) == ["a/0", "a/1", "b/c", "b/w"]
                np.testing.assert_array_equal(got["b/w"],
                                              np.arange(6).reshape(2, 3))
                assert got["b/c"].dtype == np.int32
            elif stem == "bare":
                assert got.shape == (2, 3) and got.dtype == np.float32
            else:
                assert got == {"names": ["x", "y"], "n": 3}
    counts = np.array([1, 2, 3, 0, 5], np.int32)
    assert experiment.format_counters(torch.from_numpy(counts)) == \
        jexperiment.format_counters(jnp.asarray(counts))
    assert experiment.counters_dict(counts) == \
        jexperiment.counters_dict(counts)


def test_experiment_run_dirs(tmp_path):
    exp = experiment.Experiment("unit", root=str(tmp_path), seed=3)
    for i in range(2):
        with exp as e:
            e.log("line", counts=np.arange(5))
        assert e.dir.endswith(f"-{i}")
    with open(os.path.join(exp.dir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["iteration"] == 1 and meta["seed"] == 3
    with open(os.path.join(exp.dir, "events.jsonl")) as f:
        event = json.loads(f.readline())
    assert event["message"] == "line" and event["counts"] == [0, 1, 2, 3, 4]
    again = experiment.Experiment.attach(exp.dir)
    again.log("more")
    again.__exit__(None, None, None)
    with open(os.path.join(exp.dir, "log.txt")) as f:
        assert f.read().splitlines() == ["line", "more"]
