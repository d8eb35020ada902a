"""Where a soup generation's time goes on the card.

    python -m srnn_tpu_torch.profile_soup [--size 1000000] [--generations 10]
        [--population-dtype f32|bf16|int8] [--mixed] [--telemetry]

Runs the full-dynamics soup (attack 0.1, learn_from 0.1, severity 1,
train 10, both removals, fused respawn draws) of the weightwise,
aggregating and recurrent standard particles (width 2, depth 2,
aggregates 4) on each route -- ``fused`` (the
variant's generation kernel) and ``phases`` (phase chain: its SGD kernel,
and the recurrent attack kernel), both population-major, and ``rowmajor``
(the default layout: the row-major attack in plain torch, its SGD
kernel) -- under ``torch.profiler`` after a
warm-up, and prints one JSON line per variant and route: wall time per
generation, the device's busy share (summed device time of all kernels
over wall time), and the device time by kernel, largest first.
``--population-dtype`` stores the populations in that dtype; ``--mixed``
profiles instead the mixed-type soup at setups/mega_multisoup.py's split
(the size in thirds: weightwise takes the remainder, then aggregating and
recurrent), the same dynamics, on the same three routes (``rowmajor``:
the row-major cross attack in plain torch, the types' SGD kernels).
``--telemetry`` runs every soup with the device telemetry carries
(``metrics=``, ``health=``, ``lineage=``, one window over the profiled
generations).  Needs a CUDA card.
"""

import argparse
import json
import sys
import time

import torch

from . import (MultiSoupConfig, SoupConfig, Topology, evolve, evolve_multi,
               seed, seed_multi)

#: the full-dynamics settings every profiled soup runs
DYNAMICS = dict(attacking_rate=0.1, learn_from_rate=0.1,
                learn_from_severity=1, train=10, remove_divergent=True,
                remove_zero=True, respawn_draws="fused")


def _device_us(event) -> float:
    """Device time of a kernel (or copy) event; 0 for host-side operator
    events, whose device time is their kernels' and would count twice."""
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_route(cfg, generations: int, top: int = 12,
                  telemetry: bool = False) -> dict:
    """Profile ``generations`` generations of a ``SoupConfig`` or a
    ``MultiSoupConfig``, after a warm-up generation; with ``telemetry``
    all three device telemetry carries on."""
    from .telemetry.dynamics import seed_lineage, seed_lineage_blocks

    mixed = isinstance(cfg, MultiSoupConfig)
    state = (seed_multi if mixed else seed)(cfg, 0, device="cuda")
    evolve_fn = evolve_multi if mixed else evolve

    def run(state, gens):
        if not telemetry:
            return evolve_fn(cfg, state, gens)
        lin = (seed_lineage_blocks(cfg.sizes, device="cuda") if mixed
               else seed_lineage(cfg.size, device="cuda"))
        return evolve_fn(cfg, state, gens, metrics=True, health=True,
                         lineage=True, lineage_state=lin)[0]

    state = run(state, 1)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = run(state, generations)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    rows.sort(key=lambda r: -r[2])
    device_us = sum(r[2] for r in rows)
    return {
        "ms_per_generation": wall * 1e3 / generations,
        "device_ms_per_generation": device_us / 1e3 / generations,
        "device_busy_share": device_us / 1e6 / wall,
        "by_kernel": [{"name": k[:90], "calls_per_generation":
                       c / generations, "device_ms_per_generation":
                       us / 1e3 / generations} for k, c, us in rows[:top]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=1_000_000)
    ap.add_argument("--generations", type=int, default=10)
    ap.add_argument("--population-dtype", default="f32",
                    choices=("f32", "bf16", "int8"))
    ap.add_argument("--mixed", action="store_true",
                    help="profile the mixed-type soup (mega_multisoup's "
                         "split) instead of the homogeneous soups")
    ap.add_argument("--telemetry", action="store_true",
                    help="run with the metrics, health and lineage carries")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_soup: needs a CUDA card", file=sys.stderr)
        return 1
    topos = tuple(Topology(v, width=2, depth=2, aggregates=4)
                  for v in ("weightwise", "aggregating", "recurrent"))
    if args.mixed:
        third = args.size // 3
        bases = [("mixed", MultiSoupConfig(
            topos=topos, sizes=(args.size - 2 * third, third, third),
            layout="popmajor", population_dtype=args.population_dtype,
            **DYNAMICS))]
    else:
        bases = [(t.variant, SoupConfig(
            topo=t, size=args.size, layout="popmajor",
            population_dtype=args.population_dtype, **DYNAMICS))
            for t in topos]
    for variant, base in bases:
        routes = [(name, base._replace(generation_impl=name))
                  for name in ("fused", "phases")]
        routes.append(("rowmajor", base._replace(layout="rowmajor")))
        for name, cfg in routes:
            row = {"variant": variant, "route": name, "size": args.size,
                   "population_dtype": args.population_dtype,
                   "generations": args.generations,
                   "telemetry": args.telemetry,
                   "device": torch.cuda.get_device_name(0)}
            row.update(profile_route(cfg, args.generations,
                                     telemetry=args.telemetry))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
