"""``python -m srnn_tpu_torch.serve`` — run (or talk to) the experiment
service; port of ``srnn_tpu/serve/__main__.py``, with every flag of its
parser.  The service runs on the card; ``SRNN_SETUPS_PLATFORM=cpu`` puts
it on the CPU (without either it exits 1).

Server mode (default): replay any journaled-unfinished tickets from a
previous (possibly killed) service on the same ``--root``, bind the Unix
socket, warm any requested spellings, and serve until a ``shutdown`` op
or SIGTERM.  SIGTERM drains gracefully: the in-flight dispatch finishes,
the queued rest stays journaled, and the process exits 0 so a restart
resumes exactly where it stopped.  Client mode (``--shutdown`` /
``--drain`` / ``--stats`` / ``--ping``) talks to a RUNNING service on
the same socket — the smoke scripts use it for clean teardown.

Where ``SRNN_LAUNCH_COUNTS`` names a file, a server writes its kernel
launch counts there at exit as one JSON object ({kernel name: launches}),
as the setups' CLI does.
"""

import argparse
import json
import os
import signal
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default="serve_root",
                   help="service directory (events.jsonl, lineage.jsonl, "
                        "metrics.prom; default socket lives here too)")
    p.add_argument("--socket", default=None,
                   help="Unix socket path (default <root>/serve.sock)")
    p.add_argument("--max-stack", type=int, default=8, metavar="K",
                   help="most tenants per stacked dispatch")
    p.add_argument("--batch-window-s", type=float, default=0.25, metavar="S",
                   help="the stacking window CEILING: the adaptive "
                        "controller grows each scheduler group's dispatch "
                        "window toward S when the SLO has headroom and "
                        "shrinks it under burn; with --no-adaptive, the "
                        "fixed per-cycle window")
    p.add_argument("--no-adaptive", action="store_true",
                   help="disable the continuous-batching controller (and "
                        "the tenant-fairness plan that ships with it): "
                        "the dispatcher sleeps the fixed --batch-window-s "
                        "every cycle — the A/B oracle that reproduces the "
                        "fixed-window results bitwise")
    p.add_argument("--workers", type=int, default=1, metavar="N",
                   help="dispatch processes: N>1 runs a worker fleet "
                        "behind this socket (per-tenant sticky "
                        "round-robin, journal-backed replay when a worker "
                        "dies; see serve/pool.py); every worker is a "
                        "process on the one card")
    p.add_argument("--slo-p95-ms", type=float, default=0.0, metavar="MS",
                   help="latency target: each request slower than MS "
                        "counts into serve_slo_violations_total and the "
                        "stats/watch SLO view (0 = no target)")
    p.add_argument("--warm-fixpoint-density", default=None,
                   metavar="TRIALS,BATCH",
                   help="pre-dispatch the fixpoint-density executor at "
                        "these shapes (stacked at --max-stack AND solo) "
                        "before accepting traffic")
    p.add_argument("--max-queue", type=int, default=0, metavar="N",
                   help="admission control: reject submits with a typed "
                        "'overloaded' response once N tickets are queued "
                        "(0 = unbounded)")
    p.add_argument("--results-ttl-s", type=float, default=3600.0,
                   metavar="S",
                   help="evict completed-but-never-collected results "
                        "after S seconds (0 = keep until the retention "
                        "cap)")
    p.add_argument("--dispatch-retries", type=int, default=2, metavar="N",
                   help="bounded retries for transient classified "
                        "dispatch faults (device_loss/io/stall) before "
                        "bisection/failure")
    p.add_argument("--retry-backoff-s", type=float, default=0.05,
                   metavar="S",
                   help="base of the deterministic dispatch-retry "
                        "backoff")
    p.add_argument("--metrics-port", type=int, default=0, metavar="PORT",
                   help="live telemetry: serve the service registry at "
                        "http://127.0.0.1:PORT/metrics (+/healthz with "
                        "queue depth and the active-alerts panel); 0 = "
                        "off.  The history rings + metrics_history.jsonl "
                        "+ alert rules run either way (host-side only)")
    p.add_argument("--no-profile", action="store_true",
                   help="drop the continuous profiling plane (host stack "
                        "sampler, profile.folded, utilization gauges, "
                        "anomaly capture); host-side only, so serve "
                        "results are identical either way")
    p.add_argument("--profile-hz", type=float, default=50.0, metavar="HZ",
                   help="host stack-sampling rate of the continuous "
                        "profiler (see telemetry.profiler)")
    p.add_argument("--profile-ring-s", type=float, default=30.0,
                   metavar="S",
                   help="seconds of raw profiler samples kept for "
                        "anomaly bundles (samples.jsonl)")
    p.add_argument("--anomaly-captures", type=int, default=4, metavar="N",
                   help="FIFO retention bound on anomaly/<rule>-<seq>/ "
                        "bundles in the service root")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="serve-layer fault injection, e.g. "
                        "'serve_kill@1,serve_dispatch_fault@2:io,"
                        "serve_poison_tenant@3' (resilience.chaos "
                        "schedule syntax; drills the recovery ladders)")
    p.add_argument("--ping", action="store_true",
                   help="client mode: exit 0 iff a service answers")
    p.add_argument("--stats", action="store_true",
                   help="client mode: print a running service's stats JSON")
    p.add_argument("--drain", action="store_true",
                   help="client mode: graceful drain — finish in-flight "
                        "dispatches, keep the queued rest journaled for "
                        "a restart to replay")
    p.add_argument("--shutdown", action="store_true",
                   help="client mode: ask a running service to exit")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sock = args.socket or os.path.join(args.root, "serve.sock")

    if args.ping or args.stats or args.shutdown or args.drain:
        from .client import ServiceClient, ServiceError

        client = ServiceClient(sock)
        try:
            if args.ping:
                return 0 if client.ping() else 1
            if args.stats:
                print(json.dumps(client.stats(), indent=1, default=str))
                return 0
            if args.drain:
                client.drain()
                return 0
            client.shutdown()
            return 0
        except (OSError, ServiceError) as e:
            print(f"serve client: {e}", file=sys.stderr)
            return 1

    if args.workers > 1:
        # fleet mode: the front process touches no device — each worker
        # is a full solo service on its own sub-root, admission/replay
        # live in serve/pool.py
        from .pool import run_pool

        worker_args = ["--max-stack", str(args.max_stack),
                       "--batch-window-s", str(args.batch_window_s),
                       "--slo-p95-ms", str(args.slo_p95_ms),
                       "--results-ttl-s", str(args.results_ttl_s),
                       "--dispatch-retries", str(args.dispatch_retries),
                       "--retry-backoff-s", str(args.retry_backoff_s)]
        worker_args += ["--profile-hz", str(args.profile_hz),
                        "--profile-ring-s", str(args.profile_ring_s),
                        "--anomaly-captures", str(args.anomaly_captures)]
        if args.no_profile:
            worker_args.append("--no-profile")
        if args.no_adaptive:
            worker_args.append("--no-adaptive")
        if args.warm_fixpoint_density:
            worker_args += ["--warm-fixpoint-density",
                            args.warm_fixpoint_density]
        if args.chaos:
            worker_args += ["--chaos", args.chaos]
        return run_pool(args, worker_args)

    from ..setups.common import NoDeviceError
    from .server import ServiceServer
    from .service import ExperimentService

    os.makedirs(args.root, exist_ok=True)
    chaos = None
    if args.chaos:
        from ..resilience.chaos import ChaosMonkey, parse_schedule

        try:
            chaos = ChaosMonkey(parse_schedule(args.chaos))
        except ValueError as e:
            raise SystemExit(f"--chaos: {e}")
    try:
        # the card, or the CPU under SRNN_SETUPS_PLATFORM=cpu; no fallback
        service = ExperimentService(args.root, max_stack=args.max_stack,
                                    slo_p95_ms=args.slo_p95_ms,
                                    max_queue=args.max_queue,
                                    results_ttl_s=args.results_ttl_s,
                                    dispatch_retries=args.dispatch_retries,
                                    retry_backoff_s=args.retry_backoff_s,
                                    chaos=chaos)
    except NoDeviceError as e:
        print(f"serve: {e}", file=sys.stderr, flush=True)
        return 1
    # live telemetry plane: history ring + metrics_history.jsonl in the
    # service root, the serve alert rules (queue depth at the admission
    # bound, SLO burn, overload pushback), and — with --metrics-port —
    # the /metrics + /healthz endpoint over the SAME registry that
    # writes metrics.prom
    from ..telemetry.alerts import AlertEngine, default_serve_rules
    from ..telemetry.timeseries import MetricHistory

    history = MetricHistory(
        service.registry,
        path=os.path.join(args.root, "metrics_history.jsonl"))
    engine = AlertEngine(default_serve_rules(max_queue=args.max_queue),
                         service.registry, history)
    # continuous profiling plane: the stack sampler watches this
    # process's dispatcher/writer/exporter threads; anomaly bundles land
    # in the service root on each serve-rule firing edge
    prof = capture = None
    if not args.no_profile:
        from ..telemetry.profiler import AnomalyCapture, SamplingProfiler

        prof = SamplingProfiler(hz=args.profile_hz,
                                ring_s=args.profile_ring_s).start()
        capture = AnomalyCapture(args.root, profiler=prof,
                                 registry=service.registry,
                                 max_bundles=args.anomaly_captures,
                                 ring_s=args.profile_ring_s)
    service.attach_live(history, engine, capture=capture, profiler=prof)
    exporter = None
    if args.metrics_port:
        from ..telemetry.exporter import MetricsExporter, healthz_metrics

        def healthz():
            return {"ok": True, "queue_depth": service.queue_depth(),
                    "active_alerts": engine.active(),
                    "metrics": healthz_metrics(service.registry)}

        # bind failures are non-fatal (same contract as the mega loops'
        # make_live_plane): observability must never take down the
        # service — the journaled tickets still need their replay
        try:
            exporter = MetricsExporter(service.registry,
                                       port=args.metrics_port,
                                       healthz=healthz)
            print(f"serve: /metrics + /healthz live on {exporter.url}",
                  flush=True)
        except OSError as e:
            print(f"serve: metrics exporter bind failed on "
                  f":{args.metrics_port} ({e}); continuing without the "
                  "live endpoint", flush=True)
    replayed = service.recover()
    # replayed tickets restored a (possibly at-the-bound) queue before
    # the dispatch loop exists — sample now so the depth alert's firing
    # edge is on the record even if the first drain resolves it
    service._sample_live()
    if replayed:
        print(f"serve: replayed {replayed} journaled ticket(s) from a "
              "previous run", flush=True)
    if args.warm_fixpoint_density:
        trials, batch = (int(x) for x in
                         args.warm_fixpoint_density.split(","))
        service.warm("fixpoint_density", {"trials": trials, "batch": batch})
    from .controller import make_controller

    controller = make_controller(args.batch_window_s, args.slo_p95_ms,
                                 adaptive=not args.no_adaptive)
    server = ServiceServer(service, sock,
                           batch_window_s=args.batch_window_s,
                           controller=controller)
    # SIGTERM is the preemption signal (the supervisor tier's contract):
    # drain gracefully — finish in flight, journal the rest, exit clean
    prev = signal.signal(signal.SIGTERM, lambda *_: server.stop(drain=True))
    print(f"serve: listening on {sock} (root={args.root}, "
          f"device={service.device}, "
          f"max_stack={args.max_stack}, "
          f"batch_window_s={args.batch_window_s}, "
          f"dispatch={'adaptive' if controller else 'fixed'}"
          + (f", max_queue={args.max_queue}" if args.max_queue else "")
          + (f", chaos={args.chaos}" if args.chaos else "") + ")",
          flush=True)
    try:
        server.serve_until_shutdown()
    finally:
        signal.signal(signal.SIGTERM, prev)
        if exporter is not None:
            exporter.close()
        # halt sampling before close — service.close() writes the final
        # profile.folded/.jsonl from the frozen tables
        if prof is not None:
            prof.stop()
        service.close()
        counts_path = os.environ.get("SRNN_LAUNCH_COUNTS")
        if counts_path:
            from ..ops.cuda_sgd_common import KERNELS

            with open(counts_path, "w") as f:
                json.dump({k.name: k.launches for k in KERNELS}, f)
    unfinished = service._self_healing_stats()["journal_unfinished"]
    if unfinished:
        print(f"serve: exiting with {unfinished} ticket(s) journaled for "
              "replay on restart", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
