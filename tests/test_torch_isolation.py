"""srnn_tpu_torch stands alone: importing it loads neither jax nor any
module of the JAX package, and its entry points run on the card unless told
otherwise."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import srnn_tpu_torch
names = ["srnn_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(srnn_tpu_torch.__path__,
                                          "srnn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "srnn_tpu" or m.startswith("srnn_tpu."))
print(len(names), bad)
"""


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 25  # the new variants' nets and kernel wrappers too
    assert bad == "[]"


def test_chip_smoke_imports_no_jax():
    """Every import statement of chip_smoke.py, at any depth, names neither
    jax nor the JAX package."""
    path = os.path.join(REPO, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "srnn_tpu_torch" in {n.split(".")[0] for n in names}
    for n in names:
        top = n.split(".")[0]
        assert top not in ("jax", "jaxlib", "srnn_tpu"), n


def test_default_device_is_cuda(monkeypatch):
    import srnn_tpu_torch as st

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = st.SoupConfig(topo=st.Topology("weightwise"), size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.seed(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.init_population(cfg.topo, 0, 8)
    assert st.seed(cfg, 0, device="cpu").weights.device.type == "cpu"


def test_kernel_topology_fence():
    from srnn_tpu_torch import Topology
    from srnn_tpu_torch.ops.cuda_sgd_common import check_kernel_topology

    for variant in ("weightwise", "aggregating", "fft", "recurrent"):
        check_kernel_topology(Topology(variant, width=2, depth=2))
    for topo, what in ((Topology("weightwise", width=3), "width"),
                       (Topology("weightwise", depth=3), "depth"),
                       (Topology("weightwise", activation="gelu"),
                        "activation"),
                       (Topology("aggregating", width=3), "width"),
                       (Topology("aggregating", aggregates=5), "aggregates"),
                       (Topology("fft", aggregates=5), "aggregates"),
                       (Topology("recurrent", depth=3), "depth"),
                       (Topology("recurrent", rnn_scan="associative"),
                        "rnn_scan"),
                       (Topology("aggregating", shuffler="random"),
                        "shuffler")):
        with pytest.raises(ValueError, match=what):
            check_kernel_topology(topo)
