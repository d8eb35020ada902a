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
for name in ("srnn_tpu_torch.multisoup", "srnn_tpu_torch.nets.cross",
             "srnn_tpu_torch.ops.popmajor_cross", "srnn_tpu_torch.train",
             "srnn_tpu_torch.netops", "srnn_tpu_torch.fixtures",
             "srnn_tpu_torch.ops.flatten", "srnn_tpu_torch.experiment",
             "srnn_tpu_torch.bench", "srnn_tpu_torch.setups.__main__",
             "srnn_tpu_torch.setups.common",
             "srnn_tpu_torch.setups.applying_fixpoints",
             "srnn_tpu_torch.setups.fixpoint_density",
             "srnn_tpu_torch.setups.known_fixpoint_variation",
             "srnn_tpu_torch.setups.mixed_self_fixpoints",
             "srnn_tpu_torch.setups.training_fixpoints",
             "srnn_tpu_torch.setups.network_trajectorys",
             "srnn_tpu_torch.setups.soup_trajectorys",
             "srnn_tpu_torch.setups.learn_from_soup",
             "srnn_tpu_torch.setups.mixed_soup",
             "srnn_tpu_torch.utils.pipeline", "srnn_tpu_torch.utils.trajstore",
             "srnn_tpu_torch.utils.capture", "srnn_tpu_torch.telemetry",
             "srnn_tpu_torch.telemetry.metrics",
             "srnn_tpu_torch.telemetry.device",
             "srnn_tpu_torch.telemetry.dynamics",
             "srnn_tpu_torch.telemetry.soup_metrics",
             "srnn_tpu_torch.telemetry.flightrec",
             "srnn_tpu_torch.telemetry.genealogy",
             "srnn_tpu_torch.telemetry.heartbeat",
             "srnn_tpu_torch.telemetry.tracing",
             "srnn_tpu_torch.telemetry.timeseries",
             "srnn_tpu_torch.telemetry.alerts",
             "srnn_tpu_torch.telemetry.exporter",
             "srnn_tpu_torch.telemetry.profiler",
             "srnn_tpu_torch.resilience",
             "srnn_tpu_torch.resilience.supervisor",
             "srnn_tpu_torch.resilience.chaos",
             "srnn_tpu_torch.setups.mega_soup",
             "srnn_tpu_torch.setups.mega_multisoup",
             "srnn_tpu_torch.viz", "srnn_tpu_torch.viz_html",
             "srnn_tpu_torch.reference_artifacts", "srnn_tpu_torch.proto",
             "srnn_tpu_torch.optimize", "srnn_tpu_torch.utils.debug",
             "srnn_tpu_torch.utils.profiling",
             "srnn_tpu_torch.utils.printing",
             "srnn_tpu_torch.utils.atomicio",
             "srnn_tpu_torch.telemetry.exemplars", "srnn_tpu_torch.serve",
             "srnn_tpu_torch.serve.__main__", "srnn_tpu_torch.serve.client",
             "srnn_tpu_torch.serve.controller",
             "srnn_tpu_torch.serve.journal", "srnn_tpu_torch.serve.pool",
             "srnn_tpu_torch.serve.scheduler",
             "srnn_tpu_torch.serve.server", "srnn_tpu_torch.serve.service",
             "srnn_tpu_torch.serve.tenant", "srnn_tpu_torch.parallel",
             "srnn_tpu_torch.parallel.mesh",
             "srnn_tpu_torch.parallel.sharded_soup",
             "srnn_tpu_torch.parallel.sharded_multisoup",
             "srnn_tpu_torch.parallel.multihost",
             "srnn_tpu_torch.distributed",
             "srnn_tpu_torch.distributed.bootstrap",
             "srnn_tpu_torch.distributed.hostio",
             "srnn_tpu_torch.distributed.launch"):
    assert name in names, name
"""


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 50  # the engines, run layer and setups too
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
    cfg = st.SoupConfig(topo=st.Topology("weightwise"), size=8,
                        layout="popmajor")
    with pytest.raises(RuntimeError, match="CUDA"):
        st.seed(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.init_population(cfg.topo, 0, 8)
    assert st.seed(cfg, 0, device="cpu").weights.device.type == "cpu"


def test_mixed_and_precision_entry_points_default_to_cuda(monkeypatch):
    import srnn_tpu_torch as st
    from srnn_tpu_torch import multisoup as ms

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcfg = ms.MultiSoupConfig(topos=(st.Topology("weightwise"),
                                     st.Topology("recurrent")), sizes=(4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        ms.seed_multi(mcfg, 0)
    s = ms.seed_multi(mcfg, 0, device="cpu")
    assert all(w.device.type == "cpu" for w in s.weights)
    for dtype, torch_dtype in (("bf16", torch.bfloat16),
                               ("int8", torch.int8)):
        cfg = st.SoupConfig(topo=st.Topology("weightwise"), size=8,
                            layout="popmajor", population_dtype=dtype)
        with pytest.raises(RuntimeError, match="CUDA"):
            st.seed(cfg, 0)
        assert st.seed(cfg, 0, device="cpu").weights.dtype == torch_dtype


def test_kernel_topology_fence():
    from srnn_tpu_torch import Topology
    from srnn_tpu_torch.ops.cuda_sgd_common import check_kernel_topology

    for variant in ("weightwise", "aggregating", "fft", "recurrent"):
        check_kernel_topology(Topology(variant, width=2, depth=2))
    # the envelope is the JAX package's Pallas fence: any width, depth and
    # aggregates up to 64 weights; a field that takes P past it raises,
    # naming the field's value and P
    for topo, wider, what in (
            (Topology("weightwise", width=3), Topology("weightwise", width=6),
             "width=6"),
            (Topology("weightwise", depth=3),
             Topology("weightwise", depth=15), "depth=15"),
            (Topology("aggregating", width=3),
             Topology("aggregating", width=6), "width=6"),
            (Topology("aggregating", aggregates=5),
             Topology("aggregating", aggregates=17), "aggregates=17"),
            (Topology("fft", aggregates=5), Topology("fft", aggregates=17),
             "aggregates=17"),
            (Topology("recurrent", depth=3), Topology("recurrent", depth=8),
             "depth=8")):
        assert topo.num_weights <= 64 < wider.num_weights
        check_kernel_topology(topo)
        with pytest.raises(ValueError, match=f"{what}.*P={wider.num_weights}"):
            check_kernel_topology(wider)
    with pytest.raises(ValueError, match="activation"):
        check_kernel_topology(Topology("weightwise", activation="gelu"))
    # the SGD chains read no deaggregation and the population-major
    # recurrence is the serial scan for either rnn_scan: the kernels take
    # both options; the fused generation's attack refuses the shuffler
    from srnn_tpu_torch.ops.cuda_generation import fused_kernel_supported

    check_kernel_topology(Topology("recurrent", rnn_scan="associative"))
    shuffled = Topology("aggregating", shuffler="random")
    check_kernel_topology(shuffled)
    assert not fused_kernel_supported(shuffled, "sequential")


def test_engine_layer_entry_points_default_to_cuda(monkeypatch):
    """The fixtures, the bench and the setups run on the card unless told
    otherwise; the setups' CLI has no CPU fallback."""
    from srnn_tpu_torch import bench, fixtures
    from srnn_tpu_torch.setups import common

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = fixtures.Topology("weightwise")
    with pytest.raises(RuntimeError, match="CUDA"):
        fixtures.identity_fixpoint_flat(topo)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure(n=8)
    assert fixtures.identity_fixpoint_flat(topo, "cpu").device.type == "cpu"
    monkeypatch.delenv(common.PLATFORM_ENV, raising=False)
    with pytest.raises(common.NoDeviceError, match="SRNN_SETUPS_PLATFORM"):
        common.device()
    monkeypatch.setenv(common.PLATFORM_ENV, "cpu")
    assert common.device().type == "cpu"
    row = bench.measure(n=8, device="cpu")
    assert row["unit"] == "applications/s" and row["value"] > 0
