"""Soup sweep over imitation severity.

Reference: ``setups/learn_from_soup.py`` -- weightwise only (``:71-73``),
soup of 10, life 100, attack off (-1), learn_from_rate 0.1, sweep
learn_from_severity in {0, 10, ..., 100} (``:66``), 10 trials; record avg
zero / non-zero fixpoints per soup; saves ``all_names``/``all_data`` and a
final ``soup`` state artifact (``:104-106``).  Port of
``srnn_tpu/setups/learn_from_soup.py``: the trials of a severity evolve as
one stacked row-major batch (``common.evolve_trials``), one imitation
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
    p.add_argument("--soup-life", type=int, default=100)
    p.add_argument("--severity-values", type=int, nargs="*",
                   default=[10 * i for i in range(11)])
    p.add_argument("--learn-from-rate", type=float, default=0.1)
    p.add_argument("--train-mode", default="sequential",
                   choices=("sequential", "full_batch"))
    return p


def run(args):
    if args.smoke:
        args.trials, args.soup_life, args.severity_values = 2, 3, [0, 2]
    dev = device()
    name, topo = STANDARD_VARIANTS[0]  # weightwise only (:71-73)
    with Experiment("learn-from-soup", root=args.root, seed=args.seed) as exp:
        xs, ys, zs = [], [], []
        last_states = None
        for j, severity in enumerate(args.severity_values):
            cfg = SoupConfig(
                topo=topo, size=args.soup_size,
                attacking_rate=-1.0, learn_from_rate=args.learn_from_rate,
                learn_from_severity=severity, train=0,
                epsilon=args.epsilon, train_mode=args.train_mode)
            states = evolve_trials(cfg, args.trials, args.soup_life, dev,
                                   args.seed, j)
            counts = count_soup_trials(cfg, states)
            xs.append(severity)
            ys.append(float(counts[1]) / args.trials)
            zs.append(float(counts[2]) / args.trials)
            last_states = states
        all_names = [name]
        all_data = [{"xs": xs, "ys": ys, "zs": zs}]
        log_sweep(exp, name, all_data[0])
        exp.save(all_names=all_names, all_data=all_data,
                 soup={"weights": last_states.weights,
                       "uids": last_states.uids})
        return exp.dir


@register("learn_from_soup")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
