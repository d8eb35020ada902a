"""Soup sweep over self-training intensity.

Reference: ``setups/mixed-soup.py`` -- per arch (WW, Agg; RNN commented out
there), soup of 10 particles, life 5 generations, attacking_rate 0.1,
learn_from off (-1 sentinel), sweep train in {0, 10, ..., 100} (``:61``),
10 trial soups per point; record avg zero-fixpoints (ys) and avg non-zero
fixpoints (zs) per soup (``:94-96``); saves ``all_names``/``all_data``.
Port of ``srnn_tpu/setups/mixed_soup.py``: the trials of a point evolve as
one stacked row-major batch (``common.evolve_trials``), one self-training
launch per generation for all of them.
"""

from ..experiment import Experiment
from ..soup import SoupConfig
from .common import (STANDARD_VARIANTS, base_parser, count_soup_trials,
                     device, evolve_trials, log_sweep, register)


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--soup-size", type=int, default=10)
    p.add_argument("--soup-life", type=int, default=5)
    p.add_argument("--train-values", type=int, nargs="*",
                   default=[10 * i for i in range(11)])
    p.add_argument("--attacking-rate", type=float, default=0.1)
    p.add_argument("--train-mode", default="sequential",
                   choices=("sequential", "full_batch"))
    return p


def run(args):
    if args.smoke:
        args.trials, args.soup_life, args.train_values = 2, 2, [0, 3]
    dev = device()
    variants = STANDARD_VARIANTS[:2]  # reference runs WW + Agg only (:66-68)
    with Experiment("mixed-soup", root=args.root, seed=args.seed) as exp:
        all_names, all_data = [], []
        for i, (name, topo) in enumerate(variants):
            xs, ys, zs = [], [], []
            for j, trains in enumerate(args.train_values):
                cfg = SoupConfig(
                    topo=topo, size=args.soup_size,
                    attacking_rate=args.attacking_rate,
                    learn_from_rate=-1.0, learn_from_severity=-1,
                    train=trains, epsilon=args.epsilon,
                    train_mode=args.train_mode)
                states = evolve_trials(cfg, args.trials, args.soup_life, dev,
                                       args.seed, i, j)
                counts = count_soup_trials(cfg, states)
                xs.append(trains)
                ys.append(float(counts[1]) / args.trials)  # avg fix_zero per soup
                zs.append(float(counts[2]) / args.trials)  # avg fix_other per soup
            all_names.append(name)
            all_data.append({"xs": xs, "ys": ys, "zs": zs})
            log_sweep(exp, name, all_data[-1])
        exp.save(all_names=all_names, all_data=all_data)
        return exp.dir


@register("mixed_soup")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
