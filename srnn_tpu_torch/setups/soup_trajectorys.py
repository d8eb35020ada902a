"""Soup run with full trajectory + event recording.

Reference: ``setups/soup_trajectorys.py`` -- Soup(20, weightwise+train),
train=30, learn_from off, remove divergent/zero, 100 generations, log the
final count and save ``soup.dill`` (``:12-32``).  The artifact here is the
dense per-generation history (weights, uids, action codes, counterparts),
the vectorized equivalent of ``historical_particles[uid].states``.  Port of
``srnn_tpu/setups/soup_trajectorys.py``: the row-major soup, seeded from a
generator on the CPU (not the JAX package's stream); ``--checkpoint``
writes ``checkpoint/`` (``experiment.save_checkpoint``).  ``--store``
streams every ``--capture-every``-th generation to ``soup.traj`` in the run
directory (``utils.evolve_captured``; the file format of the JAX package's
``read_store``) instead of keeping the history on the device -- the
mega-soup path.
"""

from ..experiment import Experiment, format_counters, save_checkpoint
from ..soup import ACTION_NAMES, SoupConfig, count, evolve, seed
from ..topology import Topology
from ..utils import TrajStore, evolve_captured
from .common import base_parser, device, generator, register


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--soup-size", type=int, default=20)
    p.add_argument("--generations", type=int, default=100)
    p.add_argument("--train", type=int, default=30)
    p.add_argument("--attacking-rate", type=float, default=0.1)
    p.add_argument("--train-mode", default="sequential",
                   choices=("sequential", "full_batch"))
    p.add_argument("--checkpoint", action="store_true",
                   help="also write a resumable checkpoint of the final "
                        "state (checkpoint/)")
    p.add_argument("--store", action="store_true",
                   help="stream frames to a native trajstore (soup.traj) "
                        "instead of materializing the full history on device "
                        "-- the mega-soup path")
    p.add_argument("--capture-every", type=int, default=1,
                   help="store every k-th generation (trajectory stride)")
    return p


def run(args):
    if args.smoke:
        args.soup_size, args.generations, args.train = 6, 5, 2
    dev = device()
    topo = Topology("weightwise", width=2, depth=2)
    cfg = SoupConfig(
        topo=topo, size=args.soup_size, attacking_rate=args.attacking_rate,
        learn_from_rate=-1.0, train=args.train,
        remove_divergent=True, remove_zero=True,
        epsilon=args.epsilon, train_mode=args.train_mode)
    with Experiment("soup", root=args.root, seed=args.seed) as exp:
        state = seed(cfg, generator(args.seed), dev)
        if args.store:
            with TrajStore(f"{exp.dir}/soup.traj", cfg.size,
                           topo.num_weights) as store:
                final = evolve_captured(cfg, state, args.generations, store,
                                        every=args.capture_every)
            history = {}
        else:
            final, (events, weights_hist, uids_hist) = evolve(
                cfg, state, generations=args.generations, record=True)
            history = {"soup": {
                "weights": weights_hist,      # (G, N, P)
                "uids": uids_hist,            # (G, N)
                "action": events.action,      # (G, N) ACTION_NAMES codes
                "counterpart": events.counterpart,
                "loss": events.loss,
            }}
        counts = count(cfg, final)
        exp.log(format_counters(counts), counts=counts)
        exp.save(**history, action_names=list(ACTION_NAMES),
                 all_counters=counts)
        if args.checkpoint:
            save_checkpoint(f"{exp.dir}/checkpoint", final)
        return exp.dir


@register("soup_trajectorys")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
