"""Pure self-training ("learn to be a fixpoint"), per architecture.

Reference: ``setups/training-fixpoints.py`` -- 50 trials x {WW, Agg, RNN},
1000 batch-size-1 SGD epochs on the net's own samples (loop at
``:55-56``), then classify; saves ``all_counters``/``trajectorys``/
``all_names``.  Port of ``srnn_tpu/setups/training_fixpoints.py``: on the
card one SGD kernel launch per epoch; each variant's trials are drawn from
a generator seeded from (seed, variant index), not the JAX package's
streams.
"""

import torch

from ..engine import run_training
from ..experiment import Experiment
from .common import (STANDARD_VARIANTS, base_parser, device, log_counters,
                     population, register)


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--trials", type=int, default=50)
    p.add_argument("--epochs", type=int, default=1000,
                   help="train calls per trial (training-fixpoints.py:37)")
    p.add_argument("--train-mode", default="sequential",
                   choices=("sequential", "full_batch"),
                   help="sequential = faithful batch_size=1 SGD (SURVEY §2.4.10)")
    p.add_argument("--record", action="store_true")
    return p


def run(args):
    if args.smoke:
        args.trials, args.epochs = 4, 20
    dev = device()
    with Experiment("training_fixpoint", root=args.root, seed=args.seed) as exp:
        all_counters, all_names, trajectories = [], [], {}
        for i, (name, topo) in enumerate(STANDARD_VARIANTS):
            pop = population(topo, args.trials, dev, args.seed, i)
            res = run_training(topo, pop, epochs=args.epochs,
                               epsilon=args.epsilon, train_mode=args.train_mode,
                               record=args.record)
            log_counters(exp, name, res.counts)
            all_counters.append(res.counts)
            all_names.append(name)
            if args.record:
                trajectories[topo.variant] = res.trajectory
        exp.save(all_counters=torch.stack(all_counters), all_names=all_names)
        if args.record:
            exp.save(trajectorys=trajectories)
        return exp.dir


@register("training_fixpoints")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
