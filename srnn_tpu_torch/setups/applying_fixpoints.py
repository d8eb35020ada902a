"""Pure self-application to fixpoint, per architecture.

Reference: ``setups/applying-fixpoints.py`` -- 50 trials x {WW, Agg, RNN},
up to 100 self-attacks each (loop at ``:55-56``), classify into the 5-way
counters, save ``all_counters``/``trajectorys``/``all_names``.  Port of
``srnn_tpu/setups/applying_fixpoints.py``; each variant's trials are drawn
from a generator seeded from (seed, variant index), not the JAX package's
streams.
"""

import torch

from ..engine import run_fixpoint
from ..experiment import Experiment
from .common import (STANDARD_VARIANTS, base_parser, device, log_counters,
                     population, register)


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--trials", type=int, default=50)
    p.add_argument("--run-count", type=int, default=100,
                   help="max self-attacks per trial (applying-fixpoints.py:37)")
    p.add_argument("--record", action="store_true",
                   help="also save full weight trajectories")
    return p


def run(args):
    if args.smoke:
        args.trials, args.run_count = 4, 10
    dev = device()
    with Experiment("applying_fixpoint", root=args.root, seed=args.seed) as exp:
        all_counters, all_names, trajectories = [], [], {}
        for i, (name, topo) in enumerate(STANDARD_VARIANTS):
            pop = population(topo, args.trials, dev, args.seed, i)
            res = run_fixpoint(topo, pop, step_limit=args.run_count,
                               epsilon=args.epsilon, record=args.record)
            log_counters(exp, name, res.counts)
            all_counters.append(res.counts)
            all_names.append(name)
            if args.record:
                trajectories[topo.variant] = res.trajectory
        exp.save(all_counters=torch.stack(all_counters), all_names=all_names)
        if args.record:
            exp.save(trajectorys=trajectories)
        return exp.dir


@register("applying_fixpoints")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
