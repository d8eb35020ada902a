"""The north-star mega-soup: BASELINE.json's 1M-particle /
1000-generation workload as a resumable production run; port of
``srnn_tpu/setups/mega_soup.py``.

The weightwise soup at mega scale (``layout='popmajor'`` by default: the
particle axis on the lanes), periodic checkpoints with a bitwise
``--resume``, per-chunk class counts, the run telemetry (metrics, health
and, with ``--lineage``, lineage carries; heartbeats, spans, the live
plane, the host profiler, the flight recorder) and optional strided
trajectory capture to ``soup.traj``, all under the run supervisor
(``srnn_tpu_torch.resilience``).

    python -m srnn_tpu_torch.setups mega_soup --size 1000000 --generations 1000
    python -m srnn_tpu_torch.setups mega_soup --resume experiments/exp-mega-soup-...-0

An interrupted run continues from its last checkpoint on the same random
stream (the checkpoint carries the generator's state), so an interrupted
and resumed run ends bitwise equal to an uninterrupted one, and so do a
pipelined and a ``--no-pipeline`` run, any ``--checkpoint-every``, and
runs with or without the host-side planes.  ``--train-impl xla|pallas``
reads as the port's ``train_impl`` 'plain' | 'kernel'.  The soup seeds a
generator on the run's device from ``--seed`` (not the JAX package's
stream).  ``--sharded``, ``--max-devices`` and the ``--dist-*`` flags are
refused (ROADMAP.md, A.6); the exit codes are the supervisor's.
"""

import os

from ..experiment import counters_dict, format_counters, restore_checkpoint
from ..resilience import supervised_run
from ..soup import SoupConfig, _check_config, count, evolve, seed
from ..topology import Topology
from ..utils import evolve_captured
from .common import (add_dynamics_args, add_flightrec_args,
                     add_mega_refusals, add_pipeline_args, add_profile_args,
                     add_resilience_args, add_telemetry_args, base_parser,
                     register, run_mega)

#: the JAX package's spellings of the SGD / apply routes -> the port's
IMPLS = {"xla": "plain", "pallas": "kernel"}


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--size", type=int, default=1_000_000)
    p.add_argument("--generations", type=int, default=1000)
    p.add_argument("--attacking-rate", type=float, default=0.1)
    p.add_argument("--learn-from-rate", type=float, default=-1.0)
    p.add_argument("--train", type=int, default=0)
    p.add_argument("--train-mode", default="sequential",
                   choices=("sequential", "full_batch"))
    p.add_argument("--layout", default="popmajor",
                   choices=("rowmajor", "popmajor"))
    p.add_argument("--checkpoint-every", type=int, default=100,
                   help="generations per checkpoint/log chunk")
    p.add_argument("--capture-every", type=int, default=0, metavar="K",
                   help="stream every K-th generation's soup frame to "
                        "soup.traj (0 = off); must divide "
                        "--checkpoint-every and --generations")
    p.add_argument("--resume", default=None, metavar="RUN_DIR",
                   help="continue a previous run from its latest checkpoint")
    p.add_argument("--attack-impl", choices=("full", "compact"),
                   default="full",
                   help="'compact': transform only attacked lanes "
                        "(popmajor; SoupConfig.attack_impl)")
    p.add_argument("--learn-from-impl", choices=("full", "compact"),
                   default="full",
                   help="'compact': imitation SGD on learner lanes only")
    p.add_argument("--train-impl", choices=("xla", "pallas"),
                   default="xla",
                   help="'pallas' asks for the SGD kernel for the train "
                        "and learn phases (SoupConfig.train_impl='kernel')")
    p.add_argument("--generation-impl", choices=("phases", "fused"),
                   default="phases",
                   help="'fused' runs the whole generation as one launch "
                        "of the generation kernel (popmajor)")
    p.add_argument("--population-dtype", choices=("f32", "bf16", "int8"),
                   default="f32",
                   help="population storage dtype (PARITY.md)")
    p.add_argument("--respawn-draws", choices=("perparticle", "fused"),
                   default="fused",
                   help="respawn replacement draws: 'fused' (one draw, "
                        "the same iid glorot law) or 'perparticle'")
    add_pipeline_args(p)
    add_telemetry_args(p)
    add_profile_args(p)
    add_flightrec_args(p)
    add_dynamics_args(p)
    add_resilience_args(p)
    add_mega_refusals(p)
    return p


_CONFIG_FIELDS = ("size", "attacking_rate", "learn_from_rate", "train",
                  "train_mode", "layout", "epsilon", "capture_every",
                  "sharded", "respawn_draws", "attack_impl",
                  "learn_from_impl", "train_impl", "generation_impl",
                  "population_dtype")


def _make_config(args) -> SoupConfig:
    return SoupConfig(
        topo=Topology("weightwise", width=2, depth=2),
        size=args.size,
        attacking_rate=args.attacking_rate,
        learn_from_rate=args.learn_from_rate,
        train=args.train,
        train_mode=args.train_mode,
        remove_divergent=True,
        remove_zero=True,
        epsilon=args.epsilon,
        layout=args.layout,
        respawn_draws=args.respawn_draws,
        attack_impl=args.attack_impl,
        learn_from_impl=args.learn_from_impl,
        train_impl=IMPLS[args.train_impl],
        generation_impl=args.generation_impl,
        population_dtype=args.population_dtype,
    )


class _Soup:
    """The homogeneous soup for ``common.run_mega``: one unlabelled type."""

    stage = "mega_soup"
    name = "mega-soup"
    config_fields = _CONFIG_FIELDS
    # fields an older config lacks resume with the behaviour that run had
    legacy_defaults = {"respawn_draws": "perparticle", "attack_impl": "full",
                       "learn_from_impl": "full", "train_impl": "xla",
                       "generation_impl": "phases",
                       "population_dtype": "f32"}
    config_extra = None
    labels = (None,)
    type_names = None
    store_label = "soup.traj"

    def validate(self, args) -> None:
        if (args.attack_impl != "full" or args.learn_from_impl != "full") \
                and args.layout != "popmajor":
            raise SystemExit("--attack-impl/--learn-from-impl compact need "
                             "--layout popmajor")
        if args.train_impl == "pallas" and args.layout != "popmajor":
            raise SystemExit("--train-impl pallas is the popmajor lane "
                             "kernel; --layout rowmajor needs --train-impl "
                             "xla")
        if args.generation_impl == "fused" and args.layout != "popmajor":
            raise SystemExit("--generation-impl fused is the popmajor lane "
                             "megakernel; --layout rowmajor needs phases")

    def configure(self, args) -> None:
        self.cfg = _make_config(args)
        try:
            _check_config(self.cfg)
        except ValueError as e:
            raise SystemExit(f"mega_soup: {e}")
        self.sizes = (self.cfg.size,)
        self.topos = (self.cfg.topo,)

    def restore(self, ckpt):
        return restore_checkpoint(ckpt)

    def seed(self, seed_, dev):
        return seed(self.cfg, seed_, dev)

    def header(self) -> str:
        cfg = self.cfg
        return (f"mega-soup N={cfg.size} layout={cfg.layout} "
                f"attack={cfg.attacking_rate} "
                f"train={cfg.train}/{cfg.train_mode}")

    def fused_type(self, t: int) -> bool:
        return True  # the config check refuses a topology off the kernel

    def fused_line(self, dev) -> str:
        return ("generation kernel" if dev.type == "cuda"
                else "its plain version (CPU)")

    def count(self, state):
        return count(self.cfg, state)[None]

    def format_counts(self, counts) -> str:
        return format_counters(counts[0])

    def counts_doc(self, counts):
        return counters_dict(counts[0])

    def evolve(self, state, generations, **kw):
        return evolve(self.cfg, state, generations, **kw)

    def capture(self, state, generations, stores, **kw):
        return evolve_captured(self.cfg, state, generations, stores[0], **kw)

    def weights(self, state):
        return (state.weights,)

    def store_paths(self, run_dir):
        return [os.path.join(run_dir, "soup.traj")]


def run(args):
    """One supervised mega run: the chunk loop (``common.run_mega``) under
    the run supervisor; ``--max-restarts 0`` runs it bare (faults
    propagate unchanged)."""
    return supervised_run(args, _run_once)


def _run_once(args, ctx=None):
    if args.smoke:
        # shrink only the knobs left at their defaults
        args.size = 64 if args.size == 1_000_000 else args.size
        args.generations = 6 if args.generations == 1000 else args.generations
        args.checkpoint_every = 2 if args.checkpoint_every == 100 \
            else args.checkpoint_every
    return run_mega(args, ctx, _Soup())


@register("mega_soup")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
