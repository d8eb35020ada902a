"""Trajectory recordings of single-net self-application runs.

Reference: ``setups/network_trajectorys.py`` -- the active block runs 20
weightwise nets through ``FixpointExperiment.run_net`` with state recording
(``:20-29``); dormant ``if False`` blocks cover the other archs and
training-trajectory variants.  Here every arch is a flag away, and the
trajectory artifact is the dense ``(steps+1, N, P)`` weight history.  Port
of ``srnn_tpu/setups/network_trajectorys.py``; the nets are drawn from a
generator seeded from the seed alone, not the JAX package's streams.
"""

from ..engine import run_fixpoint, run_training
from ..experiment import Experiment
from ..topology import Topology
from .common import base_parser, device, log_counters, population, register

_TOPOS = {
    "weightwise": Topology("weightwise", width=2, depth=2),
    "aggregating": Topology("aggregating", width=2, depth=2, aggregates=4),
    "fft": Topology("fft", width=2, depth=2, aggregates=4),
    "recurrent": Topology("recurrent", width=2, depth=2),
}


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--variant", default="weightwise", choices=sorted(_TOPOS))
    p.add_argument("--runs", type=int, default=20,
                   help="trajectories to record (:23)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--mode", default="apply", choices=("apply", "train"),
                   help="'apply' = self-application runs (:20-29); 'train' = "
                        "the dormant weightwise_learning block (:53-67)")
    return p


def run(args):
    if args.smoke:
        args.runs, args.steps = 3, 10
    dev = device()
    topo = _TOPOS[args.variant]
    name = f"{args.variant}_self_application" if args.mode == "apply" \
        else f"{args.variant}_learning"
    with Experiment(name, root=args.root, seed=args.seed) as exp:
        pop = population(topo, args.runs, dev, args.seed)
        if args.mode == "apply":
            res = run_fixpoint(topo, pop, step_limit=args.steps,
                               epsilon=args.epsilon, record=True)
        else:
            res = run_training(topo, pop, epochs=args.steps,
                               epsilon=args.epsilon, record=True)
        log_counters(exp, name, res.counts)
        exp.save(trajectorys={"weights": res.trajectory,
                              "classes": res.classes},
                 all_counters=res.counts)
        return exp.dir


@register("network_trajectorys")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
