"""Interleaved self-attack + self-training sweep.

Reference: ``setups/mixed-self-fixpoints.py`` -- per arch, sweep
trains-per-self-attack over {0, 50, ..., 500} (``:58``), 20 trials of up to
4 self-attacks each (``:81-86``), record the fixpoint rate
(fix_zero + fix_other) / trials; saves ``all_names``/``all_data`` with
``{'xs', 'ys'}`` per arch.  Port of
``srnn_tpu/setups/mixed_self_fixpoints.py``; each point's trials are drawn
from a generator seeded from (seed, variant index, sweep index), not the
JAX package's streams.
"""

from ..engine import run_mixed_fixpoint
from ..experiment import Experiment
from .common import (STANDARD_VARIANTS, base_parser, device, log_sweep,
                     population, register)


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--selfattacks", type=int, default=4)
    p.add_argument("--train-values", type=int, nargs="*",
                   default=[50 * i for i in range(11)])
    p.add_argument("--train-mode", default="sequential",
                   choices=("sequential", "full_batch"))
    return p


def run(args):
    if args.smoke:
        args.trials, args.selfattacks, args.train_values = 3, 2, [0, 5]
    dev = device()
    with Experiment("mixed-self-fixpoints", root=args.root,
                    seed=args.seed) as exp:
        all_names, all_data = [], []
        for i, (name, topo) in enumerate(STANDARD_VARIANTS):
            xs, ys = [], []
            for j, trains in enumerate(args.train_values):
                pop = population(topo, args.trials, dev, args.seed, i, j)
                res = run_mixed_fixpoint(
                    topo, pop, trains_per_application=trains,
                    step_limit=args.selfattacks, epsilon=args.epsilon,
                    train_mode=args.train_mode)
                counts = res.counts.tolist()
                xs.append(trains)
                # fixpoint rate = (fix_zero + fix_other) / trials (:90)
                ys.append(float(counts[1] + counts[2]) / args.trials)
            all_names.append(name)
            all_data.append({"xs": xs, "ys": ys})
            log_sweep(exp, name, all_data[-1])
        exp.save(all_names=all_names, all_data=all_data)
        return exp.dir


@register("mixed_self_fixpoints")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
