"""Shared plumbing for the paper-experiment entry points and the mega runs;
port of the one-process part of ``srnn_tpu/setups/common.py``.

Each module in this package is the equivalent of one reference
``code/setups/*.py`` script (SURVEY §2.2): same experiment, same knobs, same
artifact names, with trials run as one batch on the card.  Every script
exposes ``build_parser()``, ``run(args)`` and ``main(argv)``, and registers
itself so ``python -m srnn_tpu_torch.setups <name>`` dispatches.
``--smoke`` shrinks every knob to a seconds-scale sanity run.

Runs go on the card; ``SRNN_SETUPS_PLATFORM=cpu`` runs them on the CPU
instead.  Without that and without a card a run fails (``NoDeviceError``):
there is no fallback.  Initial populations are drawn on the CPU from a
``torch.Generator`` seeded from the run's ``--seed`` and the trial batch's
place in the sweep (variant index, sweep index, batch offset), then moved to
the device, so a seed gives the same populations on either device; they
cannot reproduce the JAX package's threefry streams.  The soup setups'
soups carry such CPU generators too and draw there (``evolve_trials``), so
a seed gives one soup on either device wherever their arithmetic agrees.
``--service SOCKET`` makes ``fixpoint_density`` and ``soup_trajectorys``
clients of a running experiment service (``python -m
srnn_tpu_torch.serve``): the service runs the same compute, seeded the
same way, and the setup writes the same artifacts
(:func:`submit_to_service`, ``execution_mode`` "service" in
``config.json``); the other setups accept and ignore the flag, as the
JAX package's do.  The mega runs' chunk loop is :func:`run_mega`; with
``--sharded`` it runs the sharded soups (``parallel``) over the ranks of a
multi-process run (``distributed``).
"""

import argparse
import contextlib
import os
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import soup
from ..experiment import (CKPT_OK_MARKER, CKPT_STATE, Experiment,
                          atomic_write_text, format_counters)
from ..init import init_population
from ..topology import Topology

REGISTRY: Dict[str, Callable] = {}

#: the environment variable that puts the setups on the CPU
PLATFORM_ENV = "SRNN_SETUPS_PLATFORM"


class NoDeviceError(RuntimeError):
    """No CUDA card, and the CPU was not asked for."""


def register(name: str):
    def deco(main_fn):
        REGISTRY[name] = main_fn
        return main_fn
    return deco


# the three standard archs every sweep iterates, in the reference's order
# and with its display names (e.g. mixed-self-fixpoints.py:63-66)
STANDARD_VARIANTS: Tuple[Tuple[str, Topology], ...] = (
    ("WeightwiseNeuralNetwork activation='linear' use_bias=False",
     Topology("weightwise", width=2, depth=2)),
    ("AggregatingNeuralNetwork activation='linear' use_bias=False",
     Topology("aggregating", width=2, depth=2, aggregates=4)),
    ("RecurrentNeuralNetwork activation='linear' use_bias=False",
     Topology("recurrent", width=2, depth=2)),
)


class _Parser(argparse.ArgumentParser):
    """Refuses the flags whose tier is not ported (the mega runs' sharding
    and distributed flags, :func:`refuse`): a run never silently ignores
    one."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.refusals = []

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        for dest, given, message in self.refusals:
            if given(getattr(ns, dest)):
                self.error(message)
        return ns


def refuse(p: argparse.ArgumentParser, dest: str, message: str,
           given=bool) -> None:
    """Make ``p`` exit with ``message`` when the flag stored at ``dest``
    is ``given`` (truthy by default)."""
    p.refusals.append((dest, given, message))


def base_parser(description: str) -> argparse.ArgumentParser:
    p = _Parser(description=description)
    p.add_argument("--root", default="experiments",
                   help="parent directory for run dirs")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed")
    p.add_argument("--epsilon", type=float, default=1e-4,
                   help="fixpoint epsilon (every reference experiment uses 1e-4)")
    p.add_argument("--smoke", action="store_true",
                   help="shrink all knobs to a seconds-scale sanity run")
    p.add_argument("--service", default=None, metavar="SOCKET",
                   help="submit this experiment to a running experiment "
                        "service (python -m srnn_tpu_torch.serve) on the "
                        "given Unix socket instead of dispatching locally "
                        "-- the service may stack it with other tenants' "
                        "requests (bitwise-equal results either way); "
                        "setups that do not support submit mode ignore "
                        "this")
    p.add_argument("--service-timeout-s", type=float, default=600.0,
                   metavar="S", help="client-side wait budget in submit mode")
    return p


def execution_mode(args) -> str:
    """How this run's compute was dispatched, recorded in config.json so
    that artifact readers can tell service-stacked runs from solo-process
    runs."""
    return "service" if getattr(args, "service", None) else "process"


def submit_to_service(args, kind: str, params: dict, tenant: str = None):
    """Submit one experiment request to the service named by
    ``args.service`` and block for its result (the setups' submit
    mode)."""
    from ..serve.client import ServiceClient

    timeout = getattr(args, "service_timeout_s", 600.0)
    client = ServiceClient(args.service, timeout_s=timeout)
    return client.request(kind, params, tenant=tenant, timeout_s=timeout)


def device() -> torch.device:
    """The device the setups run on: the card, or the CPU under
    ``SRNN_SETUPS_PLATFORM=cpu``.  Raises ``NoDeviceError`` without a card
    otherwise."""
    if os.environ.get(PLATFORM_ENV) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA card is available; set SRNN_SETUPS_PLATFORM=cpu to run "
            "the setups on the CPU")
    return torch.device("cuda")


def generator(seed: int, *where: int) -> torch.Generator:
    """A CPU generator seeded from the run's seed and a place in its sweep
    (numpy's ``SeedSequence`` mixes them)."""
    state = np.random.SeedSequence([seed, *where]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state >> np.uint64(1)))


def population(topo: Topology, n: int, dev: torch.device, seed: int,
               *where: int) -> torch.Tensor:
    """``n`` fresh (n, P) nets of ``topo``'s init law, drawn on the CPU
    from ``generator(seed, *where)`` and moved to ``dev``."""
    return init_population(topo, generator(seed, *where), n, "cpu").to(dev)


def evolve_trials(cfg: soup.SoupConfig, trials: int, generations: int,
                  dev: torch.device, seed: int, *where: int
                  ) -> soup.SoupState:
    """Seed and evolve ``trials`` independent soups as one stacked batch,
    as the JAX package's ``vmap`` does (the reference loops soups one at a
    time, e.g. ``mixed-soup.py:79-92``); every phase is one kernel launch
    per generation for the whole batch.  Trial ``t`` draws from its own
    generator, ``generator(seed, *where, t)`` on the CPU, its draws moved
    to ``dev``: so trial ``t`` equals, bitwise, the soup
    ``soup.seed(cfg, generator(seed, *where, t), dev)`` evolved alone, on
    either device.  Returns the stacked state (``soup.stack``)."""
    states = [soup.seed(cfg, generator(seed, *where, t), dev)
              for t in range(trials)]
    return soup.evolve(cfg, soup.stack(states), generations)


def count_soup_trials(cfg: soup.SoupConfig,
                      states: soup.SoupState) -> np.ndarray:
    """(5,) histogram over all particles of all trial soups, the setups'
    per-particle ``count(counters, soup)`` accumulation
    (``mixed-soup.py:27-52``)."""
    return soup.count(cfg, states).cpu().numpy().astype(np.int64)


def checkpoint_intact(path: str) -> bool:
    """Is ``path`` a checkpoint directory a resume may trust (a soup's or
    a mixed soup's)?  Its ``SRNN_CKPT_OK`` marker, published after the
    state file, is the proof,
    with a state file that is not empty.  The port writes no checkpoint
    without the marker, so a directory without one is torn (the JAX
    package's structural test of pre-marker orbax trees has nothing to
    read here)."""
    state = os.path.join(path, CKPT_STATE)
    return (os.path.exists(os.path.join(path, CKPT_OK_MARKER))
            and os.path.isfile(state) and os.path.getsize(state) > 0)


def latest_checkpoint(run_dir: str) -> str:
    """The newest intact ``ckpt-gen<N>`` directory of ``run_dir``.  A torn
    one (:func:`checkpoint_intact` fails) is skipped with a warning, so a
    resume falls back to the newest checkpoint that is whole."""
    import glob

    ckpts = sorted(
        (p for p in glob.glob(os.path.join(run_dir, "ckpt-gen*"))
         if p.rsplit("gen", 1)[1].isdigit()),
        key=lambda p: int(p.rsplit("gen", 1)[1]))
    for p in reversed(ckpts):
        if checkpoint_intact(p):
            return p
        print(f"latest_checkpoint: skipping torn checkpoint {p}",
              file=sys.stderr, flush=True)
    raise FileNotFoundError(
        f"no finalized ckpt-gen* checkpoints under {run_dir}"
        + (f" ({len(ckpts)} torn candidate(s) skipped)" if ckpts else ""))


def log_sweep(exp: Experiment, name: str, data: dict):
    """Reference logging shape: name line, data dict line, blank line
    (``mixed-self-fixpoints.py:98-101``)."""
    exp.log(name)
    exp.log(data)
    exp.log("\n")


def log_counters(exp: Experiment, name: str, counts) -> None:
    arr = counts.cpu().numpy() if isinstance(counts, torch.Tensor) \
        else np.asarray(counts)
    exp.log(f"{name}: {format_counters(arr)}", counts=arr, name=name)


def save_run_config(run_dir: str, args, fields, extra=None) -> None:
    """Persist the run's knobs (and optional ``extra`` metadata) as
    config.json, atomically, with the JAX package's ``execution_mode``
    field ("process" | "service", :func:`execution_mode`)."""
    import json

    doc = {k: getattr(args, k) for k in fields}
    doc.setdefault("execution_mode", execution_mode(args))
    doc.update(extra or {})
    atomic_write_text(os.path.join(run_dir, "config.json"),
                      json.dumps(doc, indent=1))


# ---- shared mega-run plumbing (mega_soup / mega_multisoup) ----------------
#
# One process per card.  The JAX package's fleet readers
# (update_fleet_gauges) wait for ROADMAP.md A.6; probe_run_costs (the cost
# plane) for A.7.


def load_run_config(run_dir: str, args, fields, legacy_defaults=None) -> None:
    """Resume continues the original run's dynamics: saved fields override
    the CLI; ``legacy_defaults`` pins fields an older config lacks to the
    behaviour that run had."""
    import json

    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    legacy = legacy_defaults or {}
    for k in fields:
        fallback = legacy.get(k, getattr(args, k))
        setattr(args, k, saved.get(k, fallback))


def resume_checkpoint(run_dir: str) -> str:
    """The checkpoint a ``--resume`` of ``run_dir`` starts from
    (:func:`latest_checkpoint`).  A run directory whose checkpoints hold no
    ``state.pt`` -- the JAX package's orbax checkpoints -- is refused: the
    port resumes only runs it wrote."""
    import glob

    ckpts = [p for p in glob.glob(os.path.join(run_dir, "ckpt-gen*"))
             if p.rsplit("gen", 1)[1].isdigit()]
    if ckpts and not any(os.path.isfile(os.path.join(p, CKPT_STATE))
                         for p in ckpts):
        raise SystemExit(
            f"--resume {run_dir}: its checkpoints hold no {CKPT_STATE} (they "
            "are the JAX package's orbax checkpoints); srnn_tpu_torch resumes "
            "only the runs it wrote")
    return latest_checkpoint(run_dir)


def add_pipeline_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The async-pipeline knobs of the mega runs.  ``--no-costs`` and
    ``--no-autotune`` are accepted: they ask for what the port does anyway
    (it has neither plane yet, ROADMAP.md A.7), and the run log says so."""
    p.add_argument("--no-pipeline", action="store_true",
                   help="run the blocking chunk loop (checkpoints and sink "
                        "writes on the critical path) instead of the "
                        "dispatch-ahead pipeline; the checkpoints and "
                        "resumes are bitwise the same either way")
    p.add_argument("--heartbeat-fsync-every", type=int, default=1,
                   metavar="N",
                   help="fsync every N-th heartbeat row (default 1)")
    p.add_argument("--no-spans", action="store_true",
                   help="drop the structured span rows (per-chunk "
                        "device-wait / host-I/O attribution in "
                        "events.jsonl); spans are host-only, so results "
                        "are bitwise the same either way")
    p.add_argument("--no-costs", action="store_true",
                   help="accepted: the port has no cost plane yet "
                        "(ROADMAP.md, A.7), so a run never probes costs")
    p.add_argument("--no-autotune", action="store_true",
                   help="accepted: the port has no block autotuner yet "
                        "(ROADMAP.md, A.7); its kernels' blocks are fixed")
    return p


def note_absent_planes(exp) -> None:
    """The one run-log line on the JAX package's cost plane and block
    autotuner, which the port does not have."""
    exp.log("cost plane and block autotuner: not in srnn_tpu_torch yet "
            "(ROADMAP.md, A.7); no cost probe and fixed kernel blocks, as "
            "--no-costs / --no-autotune ask")


def make_pipeline(args, registry, stage: str):
    """A mega loop's async-pipeline trio (``utils.pipeline``): one
    background writer owning every host-I/O job in submission order, the
    overlap meter, and the chunk driver deferring chunk k's host finisher
    until chunk k+1 is launched.  ``--no-pipeline`` degrades all three to
    the blocking order (writer None, depth 0).  ``--stall-timeout-s`` arms
    the driver's finisher deadline.  Returns ``(pipelined, writer, meter,
    driver)``."""
    from ..utils.pipeline import BackgroundWriter, ChunkDriver, OverlapMeter

    pipelined = not args.no_pipeline
    writer = BackgroundWriter(name=f"{stage}-io") if pipelined else None
    meter = OverlapMeter(registry, stage=stage, writer=writer)
    driver = ChunkDriver(depth=1 if pipelined else 0,
                         stall_timeout_s=getattr(args, "stall_timeout_s",
                                                 0.0) or 0.0)
    return pipelined, writer, meter, driver


def add_sharding_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--sharded`` and the distributed bring-up flags
    (``distributed.bootstrap.add_distributed_args``) of the mega runs."""
    from ..distributed import add_distributed_args

    p.add_argument("--sharded", action="store_true",
                   help="shard the particle axis over the ranks of the run "
                        "(one per card: python -m "
                        "srnn_tpu_torch.distributed.launch --processes N "
                        "-- ...; alone, one shard); the population is "
                        "bitwise the unsharded run's in the popmajor "
                        "layout")
    add_distributed_args(p)
    return p


#: the ROADMAP.md item named by the refusal of a sharded capture
SHARDED_CAPTURE = ("ROADMAP.md, A.6 (the sharded capture: "
                   "utils/capture.sharded_evolve_captured with per-process "
                   ".traj shards)")


def validate_sharded(args) -> None:
    """The sharding flags' check before any run directory exists: the
    trajectory capture of a sharded run waits for its item."""
    if args.sharded and args.capture_every:
        raise SystemExit(f"--capture-every with --sharded: the sharded "
                         f"capture waits for {SHARDED_CAPTURE}; drop one")


# ---- distributed-tier plumbing (mega_soup / mega_multisoup) ----------------


def init_distributed(args):
    """Multi-process bring-up for a mega loop (``distributed.bootstrap``):
    idempotent, inactive for plain runs.  A multi-process run without
    ``--sharded`` would leave every other process outside the population
    mesh, so it is refused up front."""
    from ..distributed import ensure_initialized

    dist = ensure_initialized(args)
    if dist.active and not getattr(args, "sharded", False):
        raise SystemExit("distributed runs need --sharded (the population "
                         "mesh must span every process's devices)")
    return dist


def build_soup_mesh(args, dist, dev, shard_sizes):
    """The mega loops' one mesh builder (``build_soup_mesh``,
    ``setups/common.py:281`` of the JAX package): every rank of the run
    (``--max-devices`` may not ask for fewer or more); a topology split
    into slice groups (``SRNN_FORCE_SLICES``) takes the ``(slices,
    soup)`` grid of ``parallel.reramp_soup_mesh``, whose size must divide
    every published shard."""
    from ..parallel import reramp_soup_mesh, slice_groups, soup_mesh
    from ..parallel.multihost import _Rank

    budget = getattr(args, "max_devices", 0) or None
    world = dist.num_processes if dist.active else 1
    budget = None if budget is None or budget >= world else budget
    try:
        if len(slice_groups([_Rank(r) for r in range(world)])) >= 2:
            if budget is not None:
                raise ValueError(f"requested {budget} devices of a run of "
                                 f"{world} processes")
            return reramp_soup_mesh(shard_sizes=shard_sizes, device=dev)
        return soup_mesh(budget, device=dev)
    except ValueError as e:
        raise SystemExit(f"--sharded: {e}")


def stage_label(stage: str, dist=None) -> str:
    """Heartbeat stage label: per process in distributed runs
    (``mega_soup@p1/2``), so that the heartbeat file that went quiet names
    the wedged worker."""
    if dist is None or not dist.active:
        return stage
    return f"{stage}@p{dist.process_id}/{dist.num_processes}"


def set_distributed_gauges(registry, dist, mesh) -> None:
    """The ``soup_distributed_*`` shape-of-the-run gauges."""
    registry.gauge("soup_distributed_processes",
                   help="process count of this run").set(
        dist.num_processes if (dist is not None and dist.active) else 1)
    if mesh is not None:
        registry.gauge("soup_distributed_slices",
                       help="slice groups of the population mesh").set(
            mesh.shape[0] if len(mesh.shape) == 2 else 1)


def fetch_for_checkpoint(state, mesh, meter, registry):
    """A sharded chunk's checkpoint source: one synchronous collective
    gather of the state onto every rank (``distributed.hostio.
    fetch_tree``; process 0 then writes it).  Runs on the loop thread,
    never on the background writer, whose jobs run at different times on
    different processes."""
    import time as _time

    from ..distributed.hostio import fetch_tree

    t0 = _time.perf_counter()
    with meter.waiting():
        full = fetch_tree(state, mesh)
    if registry is not None:
        registry.histogram("soup_distributed_gather_seconds",
                           help="per-chunk state gather (checkpoint "
                                "source) wall time",
                           unit="seconds").observe(
            _time.perf_counter() - t0)
    return full


def open_run(args, name: str, resume: Optional[str] = None,
             dist=None) -> Experiment:
    """This run's Experiment under the process-0 I/O contract: process 0
    (or a single process) attaches to ``resume`` or makes a fresh one
    under ``--root`` and, in a distributed run, broadcasts its directory;
    every other process gets a ``distributed.hostio.WorkerLog`` on that
    directory (its narration to stderr, its heartbeats to
    ``events-p<i>.jsonl``)."""
    active = dist is not None and dist.active
    if not active or dist.primary:
        exp = Experiment.attach(resume) if resume \
            else Experiment(name, root=args.root, seed=args.seed).__enter__()
        if active:
            from ..distributed.hostio import broadcast_run_dir

            broadcast_run_dir(exp.dir)
        return exp
    from ..distributed.hostio import WorkerLog, broadcast_run_dir

    return WorkerLog(broadcast_run_dir(None), dist.process_id)


def make_spans(args, exp, registry, writer, stage: str, dist=None):
    """The run's structured-span stream (``telemetry.tracing.SpanStream``,
    trace id the run directory's basename, rows tagged with the process),
    installed as the ``distributed.hostio`` collective span sink; or
    ``None`` under ``--no-spans`` (the bitwise A/B reference)."""
    from ..distributed.hostio import set_span_sink

    if getattr(args, "no_spans", False):
        set_span_sink(None)
        return None
    from ..telemetry.tracing import SpanStream

    active = dist is not None and dist.active
    spans = SpanStream(exp, trace_id=os.path.basename(exp.dir),
                       process=dist.process_id if active else 0,
                       writer=writer, registry=registry)

    def hostio_emit(name, dur_s, **labels):
        spans.emit(name, spans.now() - dur_s, dur_s, stage=stage, **labels)

    set_span_sink(hostio_emit)
    return spans


def emit_chunk_spans(spans, stage: str, gen: int, chunk: int,
                     pipeline_row: dict) -> None:
    """One chunk's span family, from the finisher after
    ``OverlapMeter.chunk_done`` (its attribution reused, never
    re-measured): a ``<stage>.chunk`` root over the chunk's wall with
    ``device_wait`` and ``host_io`` children."""
    if spans is None:
        return
    end = spans.now()
    wall = float(pipeline_row.get("wall_s", 0.0))
    start = end - wall
    root = spans.emit(f"{stage}.chunk", start, wall, generation=gen,
                      generations=chunk)
    spans.emit(f"{stage}.device_wait", start,
               float(pipeline_row.get("device_wait_s", 0.0)), parent=root,
               generation=gen)
    spans.emit(f"{stage}.host_io", start,
               float(pipeline_row.get("host_io_s", 0.0)), parent=root,
               generation=gen)


def add_telemetry_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The live telemetry plane's knobs (``telemetry.exporter`` /
    ``timeseries`` / ``alerts``)."""
    p.add_argument("--metrics-port", type=int, default=0, metavar="PORT",
                   help="serve the run's live metrics registry at "
                        "http://127.0.0.1:PORT/metrics (and /healthz); "
                        "0 = off")
    p.add_argument("--no-export", action="store_true",
                   help="drop the live telemetry plane (HTTP exporter, "
                        "metric history and metrics_history.jsonl, alert "
                        "engine); it is host-side, so results are bitwise "
                        "the same either way")
    p.add_argument("--history-ring", type=int, default=512, metavar="N",
                   help="per-series metric-history ring capacity (one "
                        "sample a chunk)")
    p.add_argument("--alert-nan-frac", type=float, default=0.02,
                   metavar="F",
                   help="alert when the NaN/Inf particle fraction exceeds "
                        "F (the soup_nan_frac rule)")
    p.add_argument("--alert-straggler-skew", type=float, default=4.0,
                   metavar="R",
                   help="the soup_straggler_skew rule's bound; it watches "
                        "a fleet gauge that a one-process run never "
                        "registers, so it never fires here")
    return p


def add_profile_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The continuous-profiling plane's knobs (``telemetry.profiler``)."""
    p.add_argument("--no-profile", action="store_true",
                   help="drop the profiling plane (the host stack sampler, "
                        "profile.folded / profile.jsonl, the utilization "
                        "gauges, anomaly capture); it is host-side, so "
                        "results are bitwise the same either way")
    p.add_argument("--profile-hz", type=float, default=50.0, metavar="HZ",
                   help="host stack-sampling rate")
    p.add_argument("--profile-ring-s", type=float, default=30.0,
                   metavar="S",
                   help="seconds of raw samples kept for anomaly bundles")
    p.add_argument("--anomaly-captures", type=int, default=4, metavar="N",
                   help="keep at most N anomaly/<rule>-<seq>/ bundles "
                        "(the oldest goes first)")
    return p


def make_profiler(args, exp, registry, stage: str, primary: bool = True):
    """The run's profiling plane: the sampler (every process) and the
    anomaly capture (process 0's; handed to :func:`make_live_plane`).
    ``(None, None)`` under ``--no-profile``."""
    if getattr(args, "no_profile", False):
        return None, None
    from ..telemetry.profiler import AnomalyCapture, SamplingProfiler

    profiler = SamplingProfiler(
        hz=getattr(args, "profile_hz", 50.0),
        ring_s=getattr(args, "profile_ring_s", 30.0)).start()
    capture = None
    if primary:
        capture = AnomalyCapture(
            exp.dir, profiler=profiler, registry=registry,
            max_bundles=getattr(args, "anomaly_captures", 4),
            ring_s=getattr(args, "profile_ring_s", 30.0))
    exp.log(f"profiler: sampling {profiler.hz:g}Hz "
            f"(ring {profiler.ring_s:g}s"
            + (f", anomaly captures ≤{capture.max_bundles}" if capture
               else "") + ")")
    return profiler, capture


def make_live_plane(args, exp, registry, stage: str, capture=None,
                    dist=None):
    """The run's live telemetry plane (``telemetry.exporter.LivePlane``):
    the history ring with ``metrics_history.jsonl`` and the alert engine
    (process 0's), and the HTTP exporter when ``--metrics-port`` is set
    (process ``i`` of a distributed run binds PORT + i).  ``None`` under
    ``--no-export``.  An exporter that cannot bind is logged and the run
    goes on."""
    if getattr(args, "no_export", False):
        return None
    from ..telemetry.alerts import AlertEngine, default_run_rules
    from ..telemetry.exporter import (LivePlane, MetricsExporter,
                                      healthz_metrics)
    from ..telemetry.timeseries import MetricHistory

    active = dist is not None and dist.active
    primary = dist.primary if active else True
    history = MetricHistory(
        registry, capacity=getattr(args, "history_ring", 512),
        path=os.path.join(exp.dir, "metrics_history.jsonl")
        if primary else None)
    engine = None
    if primary:
        engine = AlertEngine(
            default_run_rules(
                nan_frac=getattr(args, "alert_nan_frac", 0.02),
                straggler_skew=getattr(args, "alert_straggler_skew", 4.0)),
            registry, history)
    exporter = None
    port = getattr(args, "metrics_port", 0) or 0
    if port:
        port += dist.process_id if active else 0

        def healthz():
            out = {"ok": True, "stage": stage,
                   "metrics": healthz_metrics(registry)}
            if engine is not None:
                out["active_alerts"] = engine.active()
            return out

        try:
            exporter = MetricsExporter(registry, port=port, healthz=healthz)
            exp.log(f"telemetry: /metrics + /healthz live on "
                    f"{exporter.url}")
        except OSError as e:
            exp.log(f"telemetry: exporter bind failed on :{port} "
                    f"({e}); continuing without the live endpoint")
    return LivePlane(history=history, engine=engine, exporter=exporter,
                     capture=capture if engine is not None else None)


def add_resilience_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The run supervisor's knobs (``srnn_tpu_torch.resilience``): bounded
    retries with deterministic backoff, the device budget of a sharded
    run and the chaos drills."""
    p.add_argument("--max-restarts", type=int, default=3, metavar="N",
                   help="in-process recovery budget: a classified "
                        "device-loss / stall / I/O fault restarts the run "
                        "from its newest intact checkpoint at most N times "
                        "(0 = unsupervised; exit codes: 0 clean, 3 "
                        "recovered, 69 retries exhausted or card unusable, "
                        "75 preempted-clean)")
    p.add_argument("--backoff-base-s", type=float, default=2.0, metavar="S",
                   help="restart k backs off base*2^k seconds (capped by "
                        "--backoff-max-s) with deterministic +/-jitter "
                        "seeded by --seed")
    p.add_argument("--backoff-max-s", type=float, default=60.0, metavar="S",
                   help="backoff ceiling in seconds")
    p.add_argument("--backoff-jitter", type=float, default=0.1, metavar="F",
                   help="jitter fraction on each backoff delay (0 disables)")
    p.add_argument("--max-devices", type=int, default=0, metavar="N",
                   help="device budget of a --sharded run (0 = every rank "
                        "of the run); one process owns one card, so a "
                        "budget under the run's process count is refused: "
                        "launch that many processes instead")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="deterministic fault injection for recovery drills: "
                        "comma-separated device_loss@G, host_loss@G[:H], "
                        "coordinator_timeout@G, stall@G[:HOLD_S] "
                        "(needs --stall-timeout-s), writer@N, sigterm@G, "
                        "sigkill@G; every event fires once "
                        "(see resilience.chaos)")
    return p


def add_dynamics_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The replication-dynamics knobs (``telemetry.dynamics``)."""
    p.add_argument("--lineage", action="store_true",
                   help="carry per-particle lineage ids, attack / learn / "
                        "respawn edges and a fixpoint census through the "
                        "run and stream one window a chunk to "
                        "lineage.jsonl (the population is bitwise the same "
                        "either way)")
    p.add_argument("--lineage-edges", type=int, default=4096, metavar="N",
                   help="edge rows per window; overflow drops edges "
                        "(counted in edges_dropped)")
    return p


def make_lineage(args, exp_dir: str, *, sizes, start_gen: int,
                 resume: bool, device, type_names=None, mesh=None,
                 primary: bool = True):
    """The lineage trio ``(state, writer, capacity)``, ``(None, None, 0)``
    without ``--lineage``.  On a resume the carry comes from the
    ``lineage_state.npz`` sidecar when its generation matches the
    checkpoint (the stream continues its epoch); otherwise a fresh carry
    opens a new epoch.  ``sizes`` is ``(n,)`` for the soup or the per-type
    sizes (one pid space).  Under sharding (``mesh``) every rank builds
    the whole carry and keeps its block; process 0 alone (``primary``)
    gets the writer."""
    if not getattr(args, "lineage", False):
        return None, None, 0
    from ..telemetry.dynamics import (LineageWriter, load_lineage_state,
                                      place_lineage, seed_lineage,
                                      seed_lineage_blocks)

    lin = load_lineage_state(exp_dir, start_gen, device) if resume else None
    restored = lin is not None
    if lin is None:
        lin = (seed_lineage(sizes[0], time=start_gen, device=device)
               if len(sizes) == 1
               else seed_lineage_blocks(sizes, time=start_gen,
                                        device=device))
    if mesh is not None:
        lin = (place_lineage(mesh, lin) if hasattr(lin, "next_pid")
               else tuple(place_lineage(mesh, lt) for lt in lin))
    meta = {"start_gen": start_gen, "sizes": list(sizes)}
    if type_names is not None:
        meta["type_names"] = list(type_names)
    writer = None
    if primary:
        writer = LineageWriter(exp_dir, n=sum(sizes),
                               capacity=args.lineage_edges,
                               epsilon=args.epsilon, resume=resume,
                               continue_epoch=restored, meta=meta)
    return lin, writer, args.lineage_edges


def flush_lineage_window(lwriter, registry, writer, exp_dir: str,
                         gen_start: int, gen_end: int, ltriple,
                         capacity: int, type_names=None) -> None:
    """One chunk's lineage flush from the chunk finisher: the window read
    on the host, then (on the writer, in order) the jsonl row, the
    ``soup_dynamics_*`` metrics and the resume sidecar."""
    from ..telemetry.dynamics import (save_lineage_state,
                                      update_dynamics_registry,
                                      window_record)
    from ..utils.pipeline import submit_or_run

    lin, win, stats = ltriple
    next_pid = (lin if hasattr(lin, "next_pid") else lin[0]).next_pid
    row = window_record(gen_start, gen_end, win, stats, capacity,
                        next_pid=int(next_pid), type_names=type_names)

    def flush():
        lwriter.append(row)
        update_dynamics_registry(registry, row)
        save_lineage_state(exp_dir, lin, gen_end)

    submit_or_run(writer, flush)


def flush_lineage_probe(lwriter, registry, writer, gen_start: int,
                        gen_end: int, stats, type_names=None) -> None:
    """Census-only flush for capture chunks (no carry there;
    ``soup.probe_dynamics``)."""
    from ..telemetry.dynamics import probe_record, update_dynamics_registry
    from ..utils.pipeline import submit_or_run

    row = probe_record(gen_start, gen_end, stats, type_names=type_names)

    def flush():
        lwriter.append(row)
        update_dynamics_registry(registry, row)

    submit_or_run(writer, flush)


def add_flightrec_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flight recorder's knobs (``telemetry.flightrec``)."""
    p.add_argument("--no-health", action="store_true",
                   help="drop the population-health carry (NaN / zero "
                        "fractions, weight-norm sketch); the population is "
                        "bitwise the same either way")
    p.add_argument("--no-watchdog", action="store_true",
                   help="record the flight-recorder ring but never trip or "
                        "write triage bundles")
    p.add_argument("--flightrec-ring", type=int, default=256, metavar="N",
                   help="flight-recorder ring capacity in chunks")
    p.add_argument("--watchdog-nan-frac", type=float, default=0.02,
                   metavar="F",
                   help="trip when the NaN/Inf particle fraction exceeds F "
                        "(<=0 disables)")
    p.add_argument("--watchdog-zero-frac", type=float, default=0.9,
                   metavar="F",
                   help="trip when the zero-collapse fraction exceeds F "
                        "(<=0 disables)")
    p.add_argument("--watchdog-respawn-frac", type=float, default=0.25,
                   metavar="F",
                   help="trip when a chunk's respawns exceed F of its "
                        "particle-generations (<=0 disables)")
    p.add_argument("--watchdog-gens-regress", type=float, default=0.0,
                   metavar="F",
                   help="trip when gens/s falls below (1-F) of the ring "
                        "median (0 disables)")
    p.add_argument("--watchdog-max-bundles", type=int, default=2,
                   metavar="N",
                   help="most triage bundles one run may write")
    p.add_argument("--stall-timeout-s", type=float, default=0.0,
                   metavar="S",
                   help="chunk-finisher stall deadline: a chunk whose "
                        "results do not land within S seconds raises a "
                        "StallError with a host-only triage bundle "
                        "(0 = off)")
    return p


def make_flightrec(args):
    """The (recorder, watchdog) pair; the watchdog is ``None`` under
    ``--no-watchdog``."""
    from ..telemetry.flightrec import FlightRecorder, Watchdog

    recorder = FlightRecorder(capacity=args.flightrec_ring)
    watchdog = None if args.no_watchdog else Watchdog(
        recorder,
        nan_frac=args.watchdog_nan_frac,
        zero_frac=args.watchdog_zero_frac,
        respawn_frac=args.watchdog_respawn_frac,
        gens_regress=args.watchdog_gens_regress,
        max_bundles=args.watchdog_max_bundles)
    return recorder, watchdog


def watchdog_chunk(watchdog, row, *, exp, registry, snapshot_state,
                   save_fn, gen) -> None:
    """One chunk's watchdog turn: close a trace window armed by an earlier
    trip, evaluate the rules on the ring-stamped ``row``, and on a trip
    count it, write the bundle (``snapshot_state`` / ``save_fn``: the
    chunk's checkpoint source and its writer) and log it."""
    if watchdog is None:
        return
    watchdog.chunk_boundary()
    reasons = watchdog.check(row)
    if not reasons:
        return
    registry.counter("soup_watchdog_trips_total",
                     help="watchdog anomaly trips").inc(1)
    bundle = watchdog.trip(reasons, row, run_dir=exp.dir,
                           snapshot_state=snapshot_state, save_fn=save_fn,
                           registry=registry, generation=gen)
    exp.log(f"WATCHDOG tripped [{', '.join(reasons)}]"
            + (f": triage bundle {bundle}" if bundle
               else " (bundle quota spent)"),
            kind="watchdog", reasons=reasons, bundle=bundle, generation=gen)


def save_checkpoint_source(path: str, source) -> str:
    """Write a chunk's checkpoint source (a soup's or a mixed soup's state,
    or its ``experiment.CheckpointSnapshot``) as the checkpoint directory
    ``path``."""
    from ..experiment import (CheckpointSnapshot, MultiSoupState,
                              save_checkpoint, save_multi_checkpoint)

    if isinstance(source, CheckpointSnapshot):
        return source.save(path)
    if isinstance(source, MultiSoupState):
        return save_multi_checkpoint(path, source)
    return save_checkpoint(path, source)


# ---- the mega chunk loop (mega_soup / mega_multisoup) ----------------------


def validate_capture(args) -> None:
    """The capture cadence's checks, before any run directory exists."""
    if args.capture_every < 0:
        raise SystemExit("--capture-every must be >= 0")
    if args.capture_every and args.checkpoint_every % args.capture_every:
        raise SystemExit("--capture-every must divide --checkpoint-every")
    if args.capture_every and args.generations % args.capture_every:
        # else the last partial chunk fails the capture's divisibility
        # check hours into the run
        raise SystemExit("--capture-every must divide --generations")


def _open_stores(mega, args, exp, state, writer):
    """The run's trajectory stores (one per type), appending after the
    frames of the restored checkpoint on a resume."""
    from ..utils import TrajStore, truncate_frames

    paths = mega.store_paths(exp.dir)
    resume = bool(args.resume)
    if resume:
        # drop frames captured after the restored checkpoint, so that the
        # re-evolved generations are not appended twice
        for path in paths:
            truncate_frames(path, int(state.time) // args.capture_every)
    stores = [TrajStore(path, n_particles=n, n_weights=topo.num_weights,
                        mode="a" if resume else "w")
              for path, n, topo in zip(paths, mega.sizes, mega.topos)]
    frames = {s.existing_frames for s in stores}
    if len(frames) > 1:
        raise SystemExit(
            f"per-type stores disagree on existing frames {frames}; "
            "repair or remove soup.t*.traj before resuming")
    if stores[0].existing_frames:
        exp.log(f"{mega.store_label}: appending after "
                f"{stores[0].existing_frames} existing frames")
    exp.log(f"capturing every {args.capture_every} generations to "
            + (mega.store_label if len(stores) == 1
               else f"{len(stores)} per-type stores"))
    if writer is not None:
        for store in stores:
            # crash path: close() drains queued appends and joins the store
            writer.add_close_hook(store.join)
    return stores


def run_mega(args, ctx, mega):
    """One attempt of a mega run (``mega_soup`` / ``mega_multisoup``:
    ``_run_once`` of the JAX package's two loops, one loop here).  ``mega``
    describes the population (``mega_soup._Soup``,
    ``mega_multisoup._Multi``): its config, seed and restore, count,
    chunk and capture, and its per-type labels -- a soup is one unlabelled
    type.

    Per chunk, in the JAX package's pipelined order: launch the chunk
    (``evolve`` / ``evolve_multi`` with the metrics, health and lineage
    carries), launch its count, take the checkpoint source (in the
    pipelined loop an ``experiment.CheckpointSnapshot``, whose copy to the
    host is ordered after the chunk), then hand the host finisher to the
    driver, which runs it one chunk later.  ``gen`` advances on the host:
    the loop reads nothing back from the card; the finisher resolves the
    counts and carries.  Every registry mutation of chunk k rides the
    writer ahead of chunk k's metrics flush and checkpoint.  SIGTERM stops
    the loop at the next chunk boundary after the drain (``Preempted``).

    With ``--sharded`` the chunk runs the sharded soup
    (``sharded_evolve`` / ``sharded_evolve_multi``, ``sharded_count``)
    over every rank of the run (``init_distributed``, one process per
    card); the checkpoint source (and the lineage carry to flush) is
    gathered onto every rank on the loop thread
    (:func:`fetch_for_checkpoint`), and process 0 alone writes the run's
    artifacts (:func:`open_run`)."""
    import time as _time

    from ..experiment import CheckpointSnapshot
    from ..resilience import Preempted, preempt_requested
    from ..soup import ACT_DIV_DEAD, ACT_ZERO_DEAD, probe_dynamics
    from ..telemetry import Heartbeat, MetricsRegistry
    from ..telemetry.device import host, probe_health
    from ..telemetry.flightrec import (combined_health_summary,
                                       health_summary, record_recovery,
                                       update_health_gauges,
                                       write_triage_bundle)
    from ..telemetry.profiler import update_utilization_gauges
    from ..telemetry.soup_metrics import (set_precision_gauges,
                                          update_class_gauges,
                                          update_fused_counters,
                                          update_registry)
    from ..utils.pipeline import submit_or_run

    from ..distributed.hostio import fetch_tree, set_span_sink

    chaos = ctx.chaos if ctx is not None else None
    restarts = ctx.restarts if ctx is not None else 0
    stage = mega.stage
    dev = device()
    # multi-process bring-up first (inactive, and free, for plain runs);
    # process 0 owns every host write but the heartbeats
    dist = init_distributed(args)
    primary = dist.primary
    if dist.active:
        dev = dist.device
    # everything cheap is validated before the Experiment exists, so a bad
    # invocation never leaves a run directory without meta.json
    ckpt = None
    if args.resume:
        # the original dynamics win over the CLI
        load_run_config(args.resume, args, mega.config_fields,
                        legacy_defaults=mega.legacy_defaults)
        ckpt = resume_checkpoint(args.resume)
    mega.validate(args)
    validate_capture(args)
    validate_sharded(args)
    mesh = None
    if args.sharded:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = build_soup_mesh(args, dist, dev, (args.size,))
    try:
        mega.configure(args, mesh.size if mesh is not None else 1)
        exp = open_run(args, mega.name, resume=args.resume, dist=dist)
    except BaseException:
        if mesh is not None:
            mesh.close()
        raise
    labels = mega.labels
    multi = mega.type_names is not None
    stores = writer = live = prof = capture = spans = None
    with contextlib.ExitStack() as teardown:
        # the callbacks run bottom-up: an armed watchdog trace window, the
        # profiler's sampler and capture window, the span stream's writer
        # (a late span is then written inline), the writer (drains queued
        # jobs, joins, re-raises a job failure), the live plane (after the
        # writer: queued sample jobs use it), the stores, the lineage
        # stream, and the Experiment exactly once with the real exception,
        # so that meta.json records a crash; last of all the world of one
        # a launcher-less sharded run formed
        if mesh is not None:
            teardown.callback(mesh.close)
        teardown.push(exp.__exit__)
        if args.resume:
            # every rank restores the same files and keeps its block
            state = mega.restore(ckpt, mesh)
            exp.log(f"resumed from {os.path.basename(ckpt)} "
                    f"at generation {int(state.time)}")
        else:
            if primary:
                save_run_config(exp.dir, args, mega.config_fields,
                                extra=mega.config_extra)
            state = mega.seed(args.seed, dev, mesh)
            exp.log(mega.header()
                    + (f" sharded over {mesh.size} devices"
                       if mesh is not None else "")
                    + (f" across {dist.num_processes} processes"
                       if dist.active else ""))
        if ctx is not None:
            ctx.run_dir = exp.dir  # the supervisor resumes from here
        if restarts:
            last = ctx.recoveries[-1]
            exp.log(f"supervisor: restart {restarts} after "
                    f"{last['kind']} fault ({last['error']}; backoff "
                    f"{last['backoff_s']}s)",
                    kind="restart", restarts=restarts, fault=last["kind"])
        else:
            note_absent_planes(exp)

        registry = MetricsRegistry()
        set_precision_gauges(registry, mega.cfg)
        set_distributed_gauges(registry, dist, mesh)
        fused = mega.cfg.generation_impl == "fused"
        kernel_types = [fused and mega.fused_type(t) and dev.type == "cuda"
                        for t in range(len(labels))]
        if fused:
            exp.log("generation_impl=fused: " + mega.fused_line(dev)
                    + f", population_dtype={mega.cfg.population_dtype}")
        health_on = not args.no_health
        flightrec, watchdog = make_flightrec(args)
        if not primary:
            # triage bundles are run-directory artifacts: process 0's
            watchdog = None
        record_recovery(registry, flightrec, ctx)
        lin, lin_writer, lincap = make_lineage(
            args, exp.dir, sizes=mega.sizes, start_gen=int(state.time),
            resume=bool(args.resume), device=dev,
            type_names=mega.type_names, mesh=mesh, primary=primary)
        lineage_on = lin is not None
        if lin_writer is not None:
            teardown.callback(lin_writer.close)
            exp.log(f"lineage: epoch {lin_writer.epoch}, "
                    f"{lincap} edge rows/window -> lineage.jsonl")
        teardown.callback(lambda: [store.close() for store in stores or ()])
        teardown.callback(lambda: live is not None and live.close())
        teardown.callback(lambda: writer is not None and writer.close())
        teardown.callback(
            lambda: spans is not None and setattr(spans, "writer", None))
        teardown.callback(lambda: capture is not None and capture.close())
        teardown.callback(lambda: prof is not None and prof.stop())
        if watchdog is not None:
            teardown.callback(watchdog.stop_trace)

        pipelined, writer, meter, driver = make_pipeline(args, registry,
                                                         stage)
        if chaos is not None and writer is not None:
            chaos.attach_writer(writer)
        gen = int(state.time)

        def on_stall(timeout_s):
            # a host-only triage bundle: the card is presumed hung, so no
            # snapshot
            return write_triage_bundle(
                exp.dir, ["stall"], (flightrec.tail(1) or [None])[-1],
                recorder=flightrec, registry=registry,
                thresholds={"stall_timeout_s": timeout_s}, generation=gen)

        driver.on_stall = on_stall if primary else None
        spans = make_spans(args, exp, registry, writer, stage, dist)
        # the collective span sink closes over this attempt's writer
        teardown.callback(set_span_sink, None)
        prof, capture = make_profiler(args, exp, registry, stage, primary)
        live = make_live_plane(args, exp, registry, stage, capture=capture,
                               dist=dist)
        hb = Heartbeat(exp, stage=stage_label(stage, dist),
                       total_generations=args.generations,
                       registry=registry,
                       fsync_every=args.heartbeat_fsync_every,
                       writer=writer)
        hb.beat(generation=gen)
        if args.capture_every:
            stores = _open_stores(mega, args, exp, state, writer)
        with meter.waiting():
            counts = mega.count(state, mesh).cpu().numpy()
        t_last = _time.perf_counter()

        def class_gauges(counts, prev):
            for t, label in enumerate(labels):
                update_class_gauges(registry, counts[t], type_name=label,
                                    prev=prev[t])

        def metrics_carries(ms):
            for t, m in enumerate(ms):
                update_registry(registry, m, type_name=labels[t],
                                n_particles=mega.sizes[t])

        def finisher(gen, chunk, counts_dev, ckpt_state, ms=None, hs=None,
                     ldata=None):
            def finish():
                nonlocal counts, t_last
                with meter.waiting():
                    new_counts = counts_dev.cpu().numpy()  # chunk landed
                prev, counts = counts, new_counts
                now = _time.perf_counter()
                dt, t_last = max(now - t_last, 1e-9), now
                exp.log(f"gen {gen}/{args.generations}  "
                        f"{chunk / dt:.2f} gens/s  "
                        f"{mega.format_counts(counts)}",
                        generation=gen, gens_per_sec=round(chunk / dt, 3),
                        counts=mega.counts_doc(counts))
                row = {"gen": gen, "chunk": chunk,
                       "gens_per_sec": round(chunk / dt, 3),
                       "counts": mega.counts_doc(counts), "seed": args.seed}
                hsums = None
                if ms is not None:
                    acts = [host(m.actions) for m in ms]
                    row["respawns_divergent"] = sum(
                        int(a[ACT_DIV_DEAD]) for a in acts)
                    row["respawns_zero"] = sum(int(a[ACT_ZERO_DEAD])
                                               for a in acts)
                    row["respawns"] = row["respawns_divergent"] \
                        + row["respawns_zero"]
                    row["particle_gens"] = chunk * sum(mega.sizes)
                if hs is not None:
                    hsums = [health_summary(h, n)
                             for h, n in zip(hs, mega.sizes)]
                    if multi:
                        row["health"] = combined_health_summary(hsums)
                        row["health_by_type"] = dict(zip(labels, hsums))
                    else:
                        row["health"] = hsums[0]
                # every registry mutation of this chunk rides the writer
                # here, in order, ahead of its flush_events
                with meter.host_io():
                    if ms is not None:
                        submit_or_run(writer, metrics_carries, ms)
                    if fused:
                        for t, label in enumerate(labels):
                            submit_or_run(writer, update_fused_counters,
                                          registry, chunk, kernel_types[t],
                                          type_name=label)
                    submit_or_run(writer, class_gauges, counts, prev)
                    for t, hsum in enumerate(hsums or ()):
                        submit_or_run(writer, update_health_gauges,
                                      registry, hsum, labels[t])
                    if ldata is not None and lin_writer is not None:
                        kind, payload = ldata
                        if kind == "window":
                            flush_lineage_window(
                                lin_writer, registry, writer, exp.dir,
                                gen - chunk, gen, payload, lincap,
                                type_names=mega.type_names)
                        else:
                            flush_lineage_probe(
                                lin_writer, registry, writer, gen - chunk,
                                gen, payload, type_names=mega.type_names)
                    hb.beat(generation=gen, gens_per_sec=chunk / dt,
                            chunk_seconds=round(dt, 3))
                    if live is not None:
                        # history sample and alerts ride the writer after
                        # this chunk's gauges and before its flush
                        live.sample(exp, writer, generation=gen)
                    if prof is not None:
                        if primary:
                            prof.flush(exp.dir, writer, registry)
                        else:
                            submit_or_run(writer, prof.update_gauges,
                                          registry)
                    # run-directory artifacts are process 0's: the other
                    # processes contribute through the collectives
                    if primary:
                        submit_or_run(writer, registry.flush_events, exp)
                        submit_or_run(writer, registry.write_textfile,
                                      os.path.join(exp.dir, "metrics.prom"))
                        submit_or_run(writer, save_checkpoint_source,
                                      os.path.join(exp.dir,
                                                   f"ckpt-gen{gen:08d}"),
                                      ckpt_state)
                row["pipeline"] = meter.chunk_done(dt)
                if prof is not None:
                    row["utilization"] = update_utilization_gauges(
                        registry, row["pipeline"])
                emit_chunk_spans(spans, stage, gen, chunk, row["pipeline"])
                # the stamped copy is what the rules see
                row = flightrec.record(row)
                watchdog_chunk(watchdog, row, exp=exp, registry=registry,
                               snapshot_state=ckpt_state,
                               save_fn=save_checkpoint_source, gen=gen)
            return finish

        preempted = False
        while gen < args.generations:
            # top of the chunk: honour a pending SIGTERM (the drain below
            # makes the last checkpoint durable before the preempted-clean
            # exit), then fire the chaos events that are due
            if preempt_requested():
                exp.log(f"SIGTERM honored: stopping at generation "
                        f"{gen}/{args.generations} (drain + final "
                        "checkpoint, then exit preempted-clean)",
                        kind="preempt", generation=gen)
                preempted = True
                break
            if chaos is not None:
                chaos.chunk_start(gen)
            chunk = min(args.checkpoint_every, args.generations - gen)
            ms = hs = ldata = None
            if stores is not None:
                # capture chunks meter through the capture helpers; health
                # and the lineage census are probed at the chunk's end
                state = mega.capture(state, chunk, stores,
                                     every=args.capture_every, owned=True,
                                     registry=registry, pipelined=pipelined,
                                     writer=writer)
                weights = mega.weights(state)
                if health_on:
                    hs = tuple(probe_health(w, -1, mega.cfg.epsilon)
                               for w in weights)
                if lineage_on:
                    stats = tuple(probe_dynamics(topo, w, mega.cfg.epsilon)
                                  for topo, w in zip(mega.topos, weights))
                    ldata = ("probe", stats if multi else stats[0])
            else:
                kw = {"metrics": True, "health": health_on}
                if lineage_on:
                    kw.update(lineage=True, lineage_state=lin,
                              lineage_capacity=lincap)
                out = mega.evolve(state, chunk, mesh, **kw)
                state, ms = out[0], out[1]
                if not multi:
                    ms = (ms,)
                rest = list(out[2:])
                if health_on:
                    hs = rest.pop(0)
                    if not multi:
                        hs = (hs,)
                if lineage_on:
                    lt = rest.pop(0)
                    lin = lt[0]
                    if mesh is not None:
                        # the whole carry for the sidecar (a collective,
                        # on the loop thread); the rank keeps its block
                        lt = (fetch_tree(lt[0], mesh),) + tuple(lt[1:])
                    ldata = ("window", lt)
            gen += chunk
            # both launched before the next chunk
            counts_dev = mega.count(state, mesh)
            source = state if mesh is None else fetch_for_checkpoint(
                state, mesh, meter, registry)
            ckpt_state = CheckpointSnapshot(source) if pipelined else source
            fin = finisher(gen, chunk, counts_dev, ckpt_state, ms, hs, ldata)
            if chaos is not None:
                fin = chaos.wrap_finisher(fin, gen)
            driver.step(fin)
        # run the deferred finishers and drain the writer (sinks and
        # checkpoints durable before the last log line)
        driver.drain()
        if writer is not None:
            writer.flush()
        exp.event(kind="pipeline", pipelined=pipelined, **meter.summary())
        if preempted:
            raise Preempted(gen)
        exp.log(f"done: {mega.format_counts(counts)}")
    return exp.dir
