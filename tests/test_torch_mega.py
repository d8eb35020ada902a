"""The port's mega runs (``python -m srnn_tpu_torch.setups mega_soup`` /
``mega_multisoup``) on the CPU under ``SRNN_SETUPS_PLATFORM=cpu
--smoke`` (N = 64 / 48, 6 generations, a checkpoint every 2): bitwise
resume, capture across a resume, the recovery drills end to end (device
loss, SIGTERM, SIGKILL), the invariances of the run plumbing, the JAX
package's readers on the port's run directories, the flag census against
the JAX package's parsers, and thread hygiene.

No JAX soup is compiled here: the JAX package is used only for its
host-side readers and parsers.  A run is compared with another through its
final checkpoint, read back bitwise: weights, uids, next_uid, time and the
generator's state.
"""

import dataclasses
import glob
import json
import os
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from srnn_tpu_torch.experiment import (restore_checkpoint,
                                       restore_multi_checkpoint)
from srnn_tpu_torch.resilience import EXIT_PREEMPTED_CLEAN, EXIT_RECOVERED
from srnn_tpu_torch.setups import REGISTRY, common
from srnn_tpu_torch.setups.__main__ import main as setups_main
from srnn_tpu_torch.utils.pipeline import live_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = ["--backoff-base-s", "0.01", "--backoff-max-s", "0.05"]
LAST = "ckpt-gen00000006"


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(common.PLATFORM_ENV, "cpu")
        yield


def _state(run_dir, ckpt=LAST, multi=False):
    """A checkpoint as plain arrays (the generator's state included)."""
    path = os.path.join(run_dir, ckpt)
    return _arrays((restore_multi_checkpoint if multi
                    else restore_checkpoint)(path), multi)


def _arrays(s, multi=False):
    """A soup's or a mixed soup's state as plain arrays."""
    ws = s.weights if multi else (s.weights,)
    uids = s.uids if multi else (s.uids,)
    return ([w.numpy() for w in ws] + [u.numpy() for u in uids]
            + [s.next_uid.numpy(), s.time.numpy(),
               s.key.get_state().numpy()])


def _assert_same(a, b, what):
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=what)


def _run(name, root, *flags):
    return REGISTRY[name](["--smoke", "--root", str(root), *flags])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Smoke runs by (name, flags), each made once per module."""
    cache = {}

    def get(name, *flags):
        key = (name, flags)
        if key not in cache:
            cache[key] = _run(name, tmp_path_factory.mktemp(name), *flags)
        return cache[key]

    return get


# ---------------------------------------------------------------------------
# bitwise resume and the invariances of the plumbing
# ---------------------------------------------------------------------------


def test_mega_soup_bitwise_resume(runs, tmp_path):
    """An interrupted run resumed from its last checkpoint ends bitwise
    equal to an uninterrupted one; the conflicting ``--attacking-rate``
    loses to the run's saved config."""
    want = _state(runs("mega_soup"))
    d_half = _run("mega_soup", tmp_path, "--generations", "4")
    d_resumed = REGISTRY["mega_soup"](
        ["--smoke", "--resume", d_half, "--attacking-rate", "0.9"])
    assert d_resumed == d_half
    _assert_same(_state(d_half), want, "resumed")
    log = open(os.path.join(d_half, "log.txt")).read()
    assert "resumed from ckpt-gen00000004" in log and "done:" in log
    assert "not in srnn_tpu_torch yet (ROADMAP.md, A.7)" in log


@pytest.mark.parametrize("flags", [
    ("--checkpoint-every", "3"),
    ("--no-pipeline",),
    ("--no-spans", "--no-export", "--no-profile", "--no-health"),
    ("--lineage",),
    ("--no-costs", "--no-autotune", "--metrics-port", "0"),
], ids=["checkpoint-every-3", "no-pipeline", "planes-off", "lineage",
        "no-costs"])
def test_plumbing_leaves_the_state_unchanged(runs, flags):
    """The chunking, the pipeline and every host-side plane leave the
    evolved population bitwise the same."""
    d = runs("mega_soup", *flags)
    _assert_same(_state(d), _state(runs("mega_soup")), " ".join(flags))
    if "--no-spans" in flags:
        names = os.listdir(d)
        assert "metrics_history.jsonl" not in names
        assert "profile.folded" not in names


def test_mega_soup_capture_survives_resume(tmp_path):
    """Interrupt a capturing run and resume it without re-passing
    ``--capture-every``: capture continues from the saved config, the store
    is appended to, and every frame reads back, in the JAX package's
    reader too."""
    from srnn_tpu.utils import read_store as jread_store
    from srnn_tpu_torch.utils import read_store

    d_half = _run("mega_soup", tmp_path, "--generations", "4",
                  "--capture-every", "2")
    traj = os.path.join(d_half, "soup.traj")
    pre = read_store(traj)
    assert pre["generations"].tolist() == [2, 4]
    assert REGISTRY["mega_soup"](["--smoke", "--resume", d_half]) == d_half
    out = read_store(traj)
    assert out["generations"].tolist() == [2, 4, 6]
    np.testing.assert_array_equal(out["weights"][:2], pre["weights"])
    np.testing.assert_array_equal(jread_store(traj)["weights"],
                                  out["weights"])
    log = open(os.path.join(d_half, "log.txt")).read()
    assert "appending after 2 existing frames" in log


def test_bad_capture_cadence_leaves_no_run_dir(tmp_path):
    with pytest.raises(SystemExit):
        _run("mega_soup", tmp_path / "r", "--capture-every", "3",
             "--checkpoint-every", "4")
    assert not os.path.exists(tmp_path / "r")


def test_resume_refuses_jax_checkpoints(tmp_path):
    """A run directory of the JAX package (orbax checkpoints, no
    ``state.pt``) is refused with a clear error."""
    run = tmp_path / "jax-run"
    (run / "ckpt-gen00000002" / "d").mkdir(parents=True)
    (run / "ckpt-gen00000002" / "_METADATA").write_text("{}")
    (run / "config.json").write_text(json.dumps({"size": 64}))
    with pytest.raises(SystemExit, match="orbax"):
        REGISTRY["mega_soup"](["--smoke", "--resume", str(run)])


def test_mega_multisoup_bitwise_resume(runs, tmp_path):
    want = _state(runs("mega_multisoup"), multi=True)
    d_half = _run("mega_multisoup", tmp_path, "--generations", "4")
    assert REGISTRY["mega_multisoup"](
        ["--smoke", "--resume", d_half, "--attacking-rate", "0.9"]) == d_half
    _assert_same(_state(d_half, multi=True), want, "multisoup resumed")
    log = open(os.path.join(d_half, "log.txt")).read()
    assert "resumed from ckpt-gen00000004" in log
    assert "done: ww[" in log


# ---------------------------------------------------------------------------
# recovery drills end to end
# ---------------------------------------------------------------------------


def test_device_loss_recovery_bitwise_and_sigterm_resumable(runs, tmp_path):
    """(a) A device loss at generation 4 is recovered in-process (exit 3)
    and the run ends bitwise equal to the uninterrupted one; (b) SIGTERM
    gives a preempted-clean exit (75) whose last checkpoint resumes to the
    same end; no thread is left behind by either."""
    want = _state(runs("mega_soup"))
    assert setups_main(["mega_soup", "--smoke", "--root",
                        str(tmp_path / "loss"), "--chaos",
                        "device_loss@4", *FAST]) == EXIT_RECOVERED
    assert not live_threads()
    (d,) = glob.glob(str(tmp_path / "loss" / "exp-*"))
    _assert_same(_state(d), want, "recovered")
    log = open(os.path.join(d, "log.txt")).read()
    assert "supervisor: restart 1 after device_loss fault" in log
    assert "srnn_soup_restarts_total 1" in open(
        os.path.join(d, "metrics.prom")).read()
    events = [json.loads(l) for l in open(os.path.join(d, "events.jsonl"))]
    assert any(e.get("kind") == "restart" for e in events)

    with pytest.raises(SystemExit) as ei:
        setups_main(["mega_soup", "--smoke", "--root",
                     str(tmp_path / "term"), "--chaos", "sigterm@2", *FAST])
    assert ei.value.code == EXIT_PREEMPTED_CLEAN
    assert not live_threads()
    (d_term,) = glob.glob(str(tmp_path / "term" / "exp-*"))
    assert common.latest_checkpoint(d_term).endswith("ckpt-gen00000004")
    assert "SIGTERM honored" in open(os.path.join(d_term, "log.txt")).read()
    assert setups_main(["mega_soup", "--smoke", "--resume", d_term]) == 0
    _assert_same(_state(d_term), want, "preempted and resumed")


def test_multisoup_device_loss_recovery_bitwise(runs, tmp_path):
    want = _state(runs("mega_multisoup"), multi=True)
    d = _run("mega_multisoup", tmp_path, "--chaos", "device_loss@4", *FAST)
    _assert_same(_state(d, multi=True), want, "multisoup recovered")
    assert "supervisor: restart 1 after device_loss fault" in open(
        os.path.join(d, "log.txt")).read()


def test_sigkill_mid_run_resume_traj_bitwise(runs, tmp_path):
    """A mega_soup process killed by SIGKILL at generation 4 (no cleanup
    at all) resumes from its newest surviving checkpoint; the captured
    stream and the final checkpoint equal an uninterrupted run's."""
    from srnn_tpu_torch.utils import read_store

    oracle = runs("mega_soup", "--capture-every", "1")
    want = read_store(os.path.join(oracle, "soup.traj"))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "srnn_tpu_torch.setups", "mega_soup",
         "--smoke", "--root", str(tmp_path), "--capture-every", "1",
         "--no-pipeline", "--chaos", "sigkill@4"],
        env=env, cwd=REPO, capture_output=True, timeout=240)
    assert proc.returncode == -9, proc.stderr.decode(errors="replace")
    (d,) = glob.glob(str(tmp_path / "exp-*"))
    newest = common.latest_checkpoint(d)
    assert REGISTRY["mega_soup"](["--smoke", "--resume", d]) == d
    assert f"resumed from {os.path.basename(newest)}" in open(
        os.path.join(d, "log.txt")).read()
    got = read_store(os.path.join(d, "soup.traj"))
    assert got["generations"].tolist() == want["generations"].tolist()
    for key in ("weights", "uids", "action", "counterpart", "loss"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    _assert_same(_state(d), _state(oracle), "killed and resumed")


# ---------------------------------------------------------------------------
# the JAX package's readers on the port's run directories
# ---------------------------------------------------------------------------


def test_jax_readers_read_a_port_mega_run(runs):
    """``report.summarize`` / ``summarize_profile``, ``fleet.
    perfetto_trace`` and the genealogy read a port mega run directory:
    its generations, counts, spans, heartbeats and checkpoints."""
    from srnn_tpu.telemetry import fleet, genealogy, report

    d = runs("mega_soup", "--lineage")
    s = report.summarize(d)
    hb = s["heartbeats"]["mega_soup"]
    assert hb["beats"] == 4 and hb["last"]["generation"] == 6
    assert hb["last"]["total_generations"] == 6 and "rss_mb" in hb["last"]
    assert s["spans"]["mega_soup.chunk"]["count"] == 3
    final = s["metrics"]
    assert final["srnn_soup_generations_total"] == 6
    assert sum(v for k, v in final.items()
               if k.startswith("srnn_soup_class_particles{")) == 64
    assert s["history"]["samples"] == 3 and s["has_prom_file"]
    assert s["config"]["size"] == 64 and s["meta"]["error"] is None
    prof = report.summarize_profile(d)
    assert not prof["no_data"] and prof["samples_by_thread"]
    assert prof["utilization"]
    trace = fleet.perfetto_trace(d)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"mega_soup.chunk", "mega_soup.device_wait",
            "mega_soup.host_io"} <= names
    dyn = genealogy.summarize_dynamics(d)
    assert dyn["windows"] == 3
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(d, "ckpt-gen*"))) == [
        "ckpt-gen00000002", "ckpt-gen00000004", LAST]


# ---------------------------------------------------------------------------
# the flag census against the JAX package's parsers
# ---------------------------------------------------------------------------


def _value(action):
    """A non-default value the JAX parser accepts for ``action``."""
    if action.choices:
        return str([c for c in action.choices if c != action.default][-1])
    if action.type is int:
        return "2"
    if action.type is float:
        return "0.5"
    return "x"


@pytest.mark.parametrize("name", ["mega_soup", "mega_multisoup"])
def test_flag_census(name, capsys):
    """Every flag of the JAX package's parser is accepted by the port's
    (its value stored) or refused with the ROADMAP.md item named; the
    service flags are accepted and ignored, as the JAX package's mega runs
    ignore them.  Since the sharded soups are ported, no flag is refused
    at parse time (``--sharded``, ``--max-devices`` and the ``--dist-*``
    flags are stored as the JAX package stores them)."""
    import importlib

    jparser = importlib.import_module(
        f"srnn_tpu.setups.{name}").build_parser()
    parser = importlib.import_module(
        f"srnn_tpu_torch.setups.{name}").build_parser()
    refused = set()
    for action in jparser._actions:
        if not action.option_strings or action.dest == "help":
            continue
        flag = action.option_strings[0]
        argv = [flag] if action.nargs == 0 else [flag, _value(action)]
        try:
            ns = parser.parse_args(argv)
        except SystemExit:
            err = capsys.readouterr().err
            assert "ROADMAP.md" in err, (flag, err)
            refused.add(flag)
            continue
        want = jparser.parse_args(argv)
        assert getattr(ns, action.dest) == getattr(want, action.dest), flag
    assert refused == set()


def _port_config(jcfg):
    """A JAX package's soup or mixed-soup config as the port's: the same
    fields, the routes' spellings 'xla' / 'pallas' read as 'plain' /
    'kernel'."""
    from srnn_tpu_torch.multisoup import MultiSoupConfig
    from srnn_tpu_torch.soup import SoupConfig
    from srnn_tpu_torch.topology import Topology

    def topo(t):
        return Topology(**{f.name: getattr(t, f.name)
                           for f in dataclasses.fields(t)})

    kw = jcfg._asdict()
    for key in ("train_impl", "apply_impl"):
        if key in kw:
            kw[key] = {"xla": "plain", "pallas": "kernel"}[kw[key]]
    if "topos" in kw:
        kw["topos"] = tuple(topo(t) for t in kw["topos"])
        return MultiSoupConfig(**kw)
    kw["topo"] = topo(kw["topo"])
    return SoupConfig(**kw)


@pytest.mark.parametrize("name, argv", [
    ("mega_soup", []),
    ("mega_soup", ["--size", "1000", "--train", "3", "--learn-from-rate",
                   "0.2", "--generation-impl", "fused", "--population-dtype",
                   "bf16", "--respawn-draws", "perparticle", "--epsilon",
                   "1e-3"]),
    ("mega_soup", ["--size", "500", "--train-impl", "pallas",
                   "--attack-impl", "compact",
                   "--learn-from-impl", "compact", "--learn-from-rate",
                   "0.3", "--train", "2"]),
    ("mega_soup", ["--layout", "rowmajor", "--attacking-rate", "0.3",
                   "--train", "1", "--train-mode", "full_batch"]),
    ("mega_multisoup", []),
    ("mega_multisoup", ["--size", "100", "--learn-from-severity", "2",
                        "--train-impl", "pallas", "--apply-impl", "pallas",
                        "--population-dtype", "int8"]),
    ("mega_multisoup", ["--size", "50", "--layout", "rowmajor", "--train",
                        "0", "--respawn-draws", "perparticle"]),
    ("mega_multisoup", ["--size", "1001", "--generation-impl", "fused",
                        "--attacking-rate", "0.2"]),
], ids=["soup-default", "soup-fused-bf16", "soup-compact", "soup-rowmajor",
        "multi-default", "multi-kernels-int8", "multi-rowmajor",
        "multi-fused-odd"])
def test_config_matches_the_jax_package(name, argv):
    """The config a mega run evolves (``configure``, as ``run_mega`` calls
    it) is, field by field, the one the JAX package's ``_make_config``
    makes of the same arguments (its split into thirds included)."""
    import importlib

    jmod = importlib.import_module(f"srnn_tpu.setups.{name}")
    mod = importlib.import_module(f"srnn_tpu_torch.setups.{name}")
    mega = mod._Soup() if name == "mega_soup" else mod._Multi()
    mega.configure(mod.build_parser().parse_args(argv))
    want = _port_config(jmod._make_config(jmod.build_parser().parse_args(
        argv)))
    for field in want._fields:
        assert getattr(mega.cfg, field) == getattr(want, field), field
    assert mega.cfg == want


@pytest.mark.parametrize("name", ["mega_soup", "mega_multisoup"])
def test_smoke_run_is_the_bare_evolve(runs, name):
    """A ``--smoke`` run ends bitwise where a bare ``evolve`` /
    ``evolve_multi`` of its 6 generations from ``seed(cfg, 0)`` ends, with
    the config the JAX package's ``_make_config`` makes of the smoke
    arguments (its smoke size; the mixed soup's train shrunk to 1): the
    chunking, the carries and the plumbing add nothing to the soup."""
    import importlib

    from srnn_tpu_torch import multisoup, soup

    multi = name == "mega_multisoup"
    jmod = importlib.import_module(f"srnn_tpu.setups.{name}")
    smoke = ["--size", "48", "--train", "1"] if multi else ["--size", "64"]
    cfg = _port_config(jmod._make_config(jmod.build_parser().parse_args(
        smoke)))
    if multi:
        state = multisoup.evolve_multi(
            cfg, multisoup.seed_multi(cfg, 0, "cpu"), 6)
    else:
        state = soup.evolve(cfg, soup.seed(cfg, 0, "cpu"), 6)
    _assert_same(_state(runs(name), multi=multi), _arrays(state, multi),
                 f"{name} --smoke against the bare evolve")


# ---------------------------------------------------------------------------
# threads and the live endpoint
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_exporter_answers_during_a_run_and_no_thread_survives(tmp_path):
    """A run with the live endpoint up answers /metrics and /healthz (the
    exporter probed from the heartbeat job), and no registered thread
    outlives the run."""
    from srnn_tpu_torch.telemetry import exporter as ex

    seen = {}
    real = ex.MetricsExporter.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen["url"] = self.url

    port = _free_port()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex.MetricsExporter, "__init__", spy)
        mp.setattr(ex.LivePlane, "close", _probe_then_close(seen))
        d = _run("mega_soup", tmp_path, "--metrics-port", str(port))
    assert seen["url"] == f"http://127.0.0.1:{port}"
    assert "srnn_heartbeat_generation" in seen["metrics"]
    assert seen["healthz"]["ok"] and seen["healthz"]["stage"] == "mega_soup"
    assert not live_threads()
    assert f"live on http://127.0.0.1:{port}" in open(
        os.path.join(d, "log.txt")).read()


def _probe_then_close(seen):
    from srnn_tpu_torch.telemetry.exporter import LivePlane

    real = LivePlane.close

    def close(self):
        base = self.exporter.url
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            seen["metrics"] = r.read().decode()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            seen["healthz"] = json.loads(r.read())
        real(self)

    return close
