"""Robustness of the known identity fixpoint under perturbation.

Reference: ``setups/known-fixpoint-variation.py`` -- start from the
analytically-known weightwise identity fixpoint (``:20-25``), perturb each
weight by +-U(0,1)*scale (``vary``, ``:37-46``), sweep scale 1.0 -> 1e-9
(/10 per level, ``:59,89``), 100 trials x <=100 self-attacks; measure
time-to-vergence (ys) and time-as-fixpoint (zs) per trial; log the
per-scale averages (``:90-93``).

The reference *appears* to set activation='sigmoid' (``:30``) but
``with_keras_params`` after construction never rebuilds the model
(SURVEY §2.4.11), so the experiment actually ran linear, which this config
makes explicit.  Port of ``srnn_tpu/setups/known_fixpoint_variation.py``;
each level's perturbations are drawn from a generator seeded from (seed,
level), not the JAX package's streams.
"""

import numpy as np

from ..engine import run_known_fixpoint_variation
from ..experiment import Experiment
from ..fixtures import identity_fixpoint_flat, vary
from ..topology import Topology
from .common import base_parser, device, generator, register


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--depth", type=int, default=10,
                   help="number of /10 scale levels (:51)")
    p.add_argument("--trials", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=100)
    return p


def run(args):
    if args.smoke:
        args.depth, args.trials, args.max_steps = 3, 8, 20
    dev = device()
    topo = Topology("weightwise", width=2, depth=2)
    fixpoint = identity_fixpoint_flat(topo, "cpu")
    with Experiment("known-fixpoint-variation", root=args.root,
                    seed=args.seed) as exp:
        xs, ys, zs = [], [], []
        scale = 1.0
        for level in range(args.depth):
            base = fixpoint.expand(args.trials, -1)
            pop = vary(generator(args.seed, level), base, scale).to(dev)
            res = run_known_fixpoint_variation(
                topo, pop, max_steps=args.max_steps, epsilon=args.epsilon)
            xs += [scale] * args.trials
            ys += res.time_to_vergence.tolist()
            zs += res.time_as_fixpoint.tolist()
            scale /= 10.0
        for d in range(args.depth):
            sl = slice(d * args.trials, (d + 1) * args.trials)
            exp.log("variation 10e-" + str(d))
            exp.log("avg time to vergence " + str(float(np.mean(ys[sl]))))
            exp.log("avg time as fixpoint " + str(float(np.mean(zs[sl]))))
        exp.save(data={"xs": np.asarray(xs), "ys": np.asarray(ys, np.int32),
                       "zs": np.asarray(zs, np.int32)},
                 meta_sweep={"depth": args.depth, "trials": args.trials,
                             "max_steps": args.max_steps})
        return exp.dir


@register("known_fixpoint_variation")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
