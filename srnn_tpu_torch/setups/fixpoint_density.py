"""Natural density of fixpoints among random initializations.

Reference: ``setups/fixpoint-density.py`` -- 100,000 random inits per arch
(WW and Agg; the script notes "FFT doesn't work though", ``:34-35``),
classified immediately with no dynamics (``:54``).  Statistics are a direct
function of the init law, which matches keras defaults (``init.py``).
Port of ``srnn_tpu/setups/fixpoint_density.py``; each batch is drawn from a
generator seeded from (seed, variant index, batch offset), not the JAX
package's streams.
"""

import torch

from ..engine import fixpoint_density
from ..experiment import Experiment
from .common import (STANDARD_VARIANTS, base_parser, device, log_counters,
                     population, register, save_run_config)


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--trials", type=int, default=100_000)
    p.add_argument("--batch", type=int, default=25_000,
                   help="classification batch (bounds device memory)")
    return p


def run(args):
    if args.smoke:
        args.trials, args.batch = 64, 32
    dev = device()
    variants = STANDARD_VARIANTS[:2]  # WW + Agg, like the reference (:42-43)
    with Experiment("fixpoint_density", root=args.root, seed=args.seed) as exp:
        # the draws are seeded per batch on the cumulative sample count, so
        # reproducing a run needs trials AND batch: record the invocation
        save_run_config(exp.dir, args, ("trials", "batch", "epsilon"))
        all_counters, all_names = [], []
        for i, (name, topo) in enumerate(variants):
            total = torch.zeros(5, dtype=torch.int32, device=dev)
            done = 0
            while done < args.trials:
                n = min(args.batch, args.trials - done)
                pop = population(topo, n, dev, args.seed, i, done)
                total = total + fixpoint_density(topo, pop, args.epsilon)
                done += n
            log_counters(exp, name, total)
            all_counters.append(total)
            all_names.append(name)
        exp.save(all_counters=torch.stack(all_counters), all_names=all_names)
        return exp.dir


@register("fixpoint_density")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
