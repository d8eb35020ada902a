"""Where a soup generation's time goes on the card.

    python -m srnn_tpu_torch.profile_soup [--size 1000000] [--generations 10]

Runs the full-dynamics soup (attack 0.1, learn_from 0.1, severity 1,
train 10, both removals, fused respawn draws) of the weightwise,
aggregating and recurrent standard particles (width 2, depth 2,
aggregates 4) on each route -- ``fused`` (the
variant's generation kernel) and ``phases`` (phase chain: its SGD kernel,
and the recurrent attack kernel) -- under ``torch.profiler`` after a
warm-up, and prints one JSON line per variant and route: wall time per
generation, the device's busy share (summed device time of all kernels
over wall time), and the device time by kernel, largest first.  Needs a
CUDA card.
"""

import argparse
import json
import sys
import time

import torch

from . import SoupConfig, Topology, evolve, seed


def _device_us(event) -> float:
    """Device time of a kernel (or copy) event; 0 for host-side operator
    events, whose device time is their kernels' and would count twice."""
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_route(cfg: SoupConfig, generations: int, top: int = 12) -> dict:
    state = seed(cfg, 0, device="cuda")
    state = evolve(cfg, state, 1)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = evolve(cfg, state, generations)
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_soup: needs a CUDA card", file=sys.stderr)
        return 1
    for variant in ("weightwise", "aggregating", "recurrent"):
        base = SoupConfig(topo=Topology(variant, width=2, depth=2,
                                        aggregates=4),
                          size=args.size, attacking_rate=0.1,
                          learn_from_rate=0.1, learn_from_severity=1,
                          train=10, remove_divergent=True, remove_zero=True,
                          respawn_draws="fused")
        for name, cfg in (("fused", base._replace(generation_impl="fused")),
                          ("phases", base)):
            row = {"variant": variant, "route": name, "size": args.size,
                   "generations": args.generations,
                   "device": torch.cuda.get_device_name(0)}
            row.update(profile_route(cfg, args.generations))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
