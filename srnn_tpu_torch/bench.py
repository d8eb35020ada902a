"""Applications/s of the port: ``python -m srnn_tpu_torch.bench``.

The program of the JAX package's ``bench.py`` (``_bench_fn``/``_measure``):
N = 1,000,000 weightwise particles (the 4-2-2-1 net, width 2 / depth 2),
their glorot init damped by 0.05 so that the chain stays finite, held
population-major (P, N), and ``STEPS`` = 2000 chained self-applications
per call.  On the card the chain is one launch of K1 (``ops/cuda_ww``,
``csrc/ww_apply.cu``); ``--device cpu`` runs its plain torch chain instead
(slow at this size: pass a smaller ``--n``).  One warm-up call, then
``CALLS`` timed calls, each ending in a synchronise; prints one JSON line:

    {"metric": "self-applications/sec/chip", "value": ..., "unit":
     "applications/s", "device": ..., "n": ..., "steps": ..., "calls": ...,
     "seconds": ...}
"""

import argparse
import json
import sys
import time

import torch

from .init import init_population, resolve_device
from .ops.cuda_ww import ww_apply_population
from .topology import Topology

STEPS = 2000  # chained self-applications per call (bench.py's STEPS_PER_CALL)
CALLS = 3     # timed calls
SEED = 0      # the init draws


def measure(n: int = 1_000_000, device="cuda") -> dict:
    """Time ``CALLS`` calls of the ``STEPS``-long self-application chain
    over ``n`` particles on ``device``; returns the JSON row."""
    steps, calls = STEPS, CALLS
    dev = resolve_device(device)
    topo = Topology("weightwise", width=2, depth=2)
    wT = (init_population(topo, SEED, n, dev) * 0.05).t().contiguous()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = ww_apply_population(topo, wT, steps)  # warm-up (and kernel load)
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = ww_apply_population(topo, wT, steps)
    sync()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("the self-application chain left non-finite "
                           "weights")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"metric": "self-applications/sec/chip",
            "value": n * steps * calls / dt, "unit": "applications/s",
            "device": kind, "n": n, "steps": steps, "calls": calls,
            "seconds": dt}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1_000_000, help="particles")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    row = measure(args.n, args.device)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
