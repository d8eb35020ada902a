"""The viz tier (``srnn_tpu_torch/viz.py``, ``viz_html.py``,
``reference_artifacts.py``) against the JAX package's copies.

Everything here is host numpy on both sides, so the comparisons are exact:
trajectory extraction, column sampling and the PCA fit equal (arrays equal,
the same numpy SVD on the same rows), the HTML views byte-identical, the
walker's outputs the same relative paths on two copies of one tree written
by the port's own ``--smoke`` setups, and the reference loader's tree the
same.  A subprocess with matplotlib and dill blocked, as on a host without
them, imports the three modules, runs the CLI and writes the HTML view.
"""

import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from srnn_tpu import reference_artifacts as jref
from srnn_tpu import viz as jviz
from srnn_tpu import viz_html as jviz_html
from srnn_tpu_torch import reference_artifacts as ref
from srnn_tpu_torch import viz, viz_html

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _artifacts():
    """The artifacts of tests/test_viz.py: trial columns, a respawn, a
    non-finite frame, and 1,000 columns (the subsampling cap's)."""
    rng = np.random.default_rng(0)
    resp = np.zeros((6, 2, 3), np.float32)
    resp[:, 1] = rng.normal(size=(6, 3))
    nonfinite = np.ones((4, 1, 3), np.float32)
    nonfinite[2] = np.nan
    return {
        "columns": {"weights": rng.normal(size=(12, 5, 14)).astype(
            np.float32).cumsum(axis=0)},
        "respawn": {"weights": resp,
                    "uids": np.array([[0, 1]] * 3 + [[5, 1]] * 3)},
        "nonfinite": {"weights": nonfinite},
        "wide": {"weights": np.random.default_rng(0).normal(
            size=(3, 1000, 4))},
    }


ARTIFACTS = _artifacts()


def _same_trajs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"trajectory", "time", "uid"}
        assert g["uid"] == w["uid"]
        np.testing.assert_array_equal(g["time"], w["time"])
        np.testing.assert_array_equal(g["trajectory"], w["trajectory"])


@pytest.mark.parametrize("cap", [None, 64, 2])
@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_particle_trajectories_match_jax(name, cap):
    art = ARTIFACTS[name]
    got = viz.particle_trajectories(art, max_particles=cap)
    _same_trajs(got, jviz.particle_trajectories(art, max_particles=cap))
    if name == "respawn" and cap is None:
        assert sorted(len(t["trajectory"]) for t in got) == [3, 3, 6]
    if name == "nonfinite":
        assert len(got[0]["trajectory"]) == 3
    if name == "wide" and cap == 64:
        assert len(got) == 64 and got[-1]["uid"] == 999


@pytest.mark.parametrize("n,cap", [(5, 2048), (2048, 2048), (2049, 2048),
                                   (1_000_000, 2048), (1000, 64)])
def test_render_columns_match_jax(n, cap):
    np.testing.assert_array_equal(viz.render_columns(n, cap),
                                  jviz.render_columns(n, cap))


@pytest.mark.parametrize("name", ["columns", "respawn", "wide"])
def test_extract_pca_and_html_match_jax(name, tmp_path):
    art = ARTIFACTS[name]
    trajs, mean, comps = viz.extract_pca(art)
    jtrajs, jmean, jcomps = jviz.extract_pca(art)
    _same_trajs(trajs, jtrajs)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(comps, jcomps)
    out = viz_html.write_html_trajectories_3d(art, str(tmp_path / "p.html"),
                                              title=name)
    jout = jviz_html.write_html_trajectories_3d(
        art, str(tmp_path / "j.html"), title=name)
    assert filecmp.cmp(out, jout, shallow=False)


def test_palette_is_tab20():
    import matplotlib
    import matplotlib.colors

    tab20 = tuple(matplotlib.colors.to_hex(matplotlib.colormaps["tab20"](i))
                  for i in range(20))
    assert viz_html._PALETTE == tab20 == jviz_html._PALETTE


def _smoke_tree(root):
    """One small tree from the port's own --smoke setups: a captured soup
    trajectory (soup.traj) with its counters, the known-fixpoint variation
    boxes, and a mega run with its lineage stream."""
    from srnn_tpu_torch.setups import REGISTRY

    env = os.environ.get("SRNN_SETUPS_PLATFORM")
    os.environ["SRNN_SETUPS_PLATFORM"] = "cpu"
    try:
        REGISTRY["soup_trajectorys"](["--smoke", "--root", root, "--store",
                                      "--capture-every", "1"])
        REGISTRY["known_fixpoint_variation"](["--smoke", "--root", root])
        REGISTRY["mega_soup"](["--smoke", "--lineage", "--root", root])
    finally:
        if env is None:
            os.environ.pop("SRNN_SETUPS_PLATFORM")
        else:
            os.environ["SRNN_SETUPS_PLATFORM"] = env


def test_search_and_apply_matches_jax(tmp_path):
    src = str(tmp_path / "runs")
    _smoke_tree(src)
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(src, mine)
    shutil.copytree(src, theirs)
    outs = viz.search_and_apply(mine)
    jouts = jviz.search_and_apply(theirs)
    rel = sorted(os.path.relpath(o, mine) for o in outs)
    assert rel == sorted(os.path.relpath(o, theirs) for o in jouts)
    names = {os.path.basename(o) for o in rel}
    assert {"soup_trajectories_3d.png", "soup_trajectories_3d.html",
            "counters.png", "variation_box.png", "mega_curve.png",
            "dynamics.png"} <= names
    htmls = [r for r in rel if r.endswith(".html")]
    assert htmls
    for r in htmls:
        assert filecmp.cmp(os.path.join(mine, r), os.path.join(theirs, r),
                           shallow=False), r
    assert viz.search_and_apply(mine) == []


_BLOCKED = r"""
import os, runpy, sys
sys.modules["matplotlib"] = None
sys.modules["dill"] = None
import numpy as np
from srnn_tpu_torch import reference_artifacts, viz, viz_html
art = {"weights": np.random.default_rng(0).normal(size=(6, 4, 5))}
out = viz_html.write_html_trajectories_3d(art, sys.argv[1])
assert os.path.getsize(out) > 0
assert len(viz.particle_trajectories(art)) == 4
sys.argv = ["viz", "-i", os.path.dirname(sys.argv[1])]
runpy.run_module("srnn_tpu_torch.viz", run_name="__main__")
print("mods", sorted(m for m in ("matplotlib", "dill", "jax", "srnn_tpu")
                     if sys.modules.get(m) is not None))
"""


def test_imports_and_html_without_matplotlib_or_dill(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    np.savez(d / "soup.npz", __value__=np.zeros(1))  # unreadable as a soup
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(d / "t.html")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("mods []")
    assert "viz: skipping soup" in out.stdout
    html = (d / "t.html").read_text()
    assert html.startswith("<!DOCTYPE html>") and html.count('"color"') == 4


def _write_reference_pickle(path):
    """A small 2019-style artifact: an ``experiment.Experiment`` holding
    one live ``network.ParticleDecorator`` (states under ``.states``) and
    one plain state list, pickled with dill under the reference's module
    and class names."""
    import types

    import dill

    mods = {}
    for mod_name, cls_names in (("experiment", ("Experiment",)),
                                ("network", ("ParticleDecorator",))):
        mod = types.ModuleType(mod_name)
        for cls_name in cls_names:
            cls = type(cls_name, (), {})
            cls.__module__ = mod_name
            setattr(mod, cls_name, cls)
        mods[mod_name] = mod
    saved = {m: sys.modules.get(m) for m in mods}
    sys.modules.update(mods)
    try:
        rng = np.random.default_rng(3)
        particle = mods["network"].ParticleDecorator()
        particle.states = [
            {"class": "WeightwiseNeuralNetwork", "time": t,
             "weights": rng.normal(size=14).astype(np.float32),
             "action": "train_self"} for t in range(4)]
        exp = mods["experiment"].Experiment()
        exp.historical_particles = {
            0: particle,
            7: [{"class": "AggregatingNeuralNetwork", "time": t,
                 "weights": rng.normal(size=(5, 4)).astype(np.float32)}
                for t in range(2)]}
        exp.name = "shim"
        with open(path, "wb") as f:
            dill.dump(exp, f)
    finally:
        for m, prev in saved.items():
            if prev is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = prev


def test_reference_loader_matches_jax(tmp_path):
    path = str(tmp_path / "exp" / "trajectorys.dill")
    os.makedirs(os.path.dirname(path))
    _write_reference_pickle(path)
    obj, jobj = ref.load_artifact(path), jref.load_artifact(path)
    assert type(obj).__name__ == type(jobj).__name__ == "Experiment"
    assert obj.name == jobj.name == "shim"
    states, jstates = ref.particle_states(obj), jref.particle_states(jobj)
    assert list(states) == list(jstates) == [0, 7]
    for uid in states:
        for s, js in zip(states[uid], jstates[uid]):
            assert s.keys() == js.keys()
            np.testing.assert_array_equal(s["weights"], js["weights"])
    art, jart = ref.trajectory_artifact(obj), jref.trajectory_artifact(jobj)
    assert art.keys() == jart.keys()
    for k in art:
        np.testing.assert_array_equal(art[k], jart[k])
    rows, jrows = ref.scan(str(tmp_path)), jref.scan(str(tmp_path))
    assert rows == jrows and rows[0]["loads"] and rows[0]["step_pairs"] == 4
    # the shims are gone again
    assert "experiment" not in sys.modules and "network" not in sys.modules
