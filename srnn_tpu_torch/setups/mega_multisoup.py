"""The heterogeneous mega-soup: BASELINE's mixed-type configuration
(weightwise, aggregating and recurrent subpopulations with cross-type
attacks) as a resumable production run; port of
``srnn_tpu/setups/mega_multisoup.py``.

``srnn_tpu_torch.multisoup`` (one typed population, any-on-any attacks)
under the production run of ``mega_soup``: the population-major layout by
default, periodic checkpoints with a bitwise ``--resume``, per-chunk
per-type class counts, the run telemetry and supervisor.  ``--size`` is
split about a third per type (weightwise gets the remainder).

    python -m srnn_tpu_torch.setups mega_multisoup --size 1000000 --generations 1000
    python -m srnn_tpu_torch.setups mega_multisoup --resume experiments/exp-mega-multisoup-...-0

Trajectory capture writes one store per type (``soup.t0.traj``,
``soup.t1.traj``, ...) through ``utils.evolve_multi_captured``.
``--train-impl`` / ``--apply-impl xla|pallas`` read as 'plain' | 'kernel'.
``--sharded`` shards every type over the ranks of the run
(``parallel.sharded_multisoup``; launch it as ``mega_soup``'s): each
type's size is rounded to a multiple of the rank count, as in the JAX
package (so a sharded run's population is the unsharded run's only where
the sizes agree), and ``--size`` must divide by it and be at least three
times it.  ``--capture-every`` with ``--sharded`` is refused, as in the
JAX package.
"""

import os

from ..experiment import restore_multi_checkpoint
from ..multisoup import (MultiSoupConfig, _check_multi, count_multi,
                         evolve_multi, resolved_generation_impl,
                         resolved_train_impls, seed_multi)
from ..ops.predicates import CLASS_NAMES
from ..parallel import (make_sharded_multi_state, place_sharded_multi_state,
                        sharded_count_multi, sharded_evolve_multi)
from ..resilience import supervised_run
from ..telemetry.soup_metrics import type_names
from ..topology import Topology
from ..utils import evolve_multi_captured
from .common import (add_dynamics_args, add_flightrec_args,
                     add_pipeline_args, add_profile_args,
                     add_resilience_args, add_sharding_args,
                     add_telemetry_args, base_parser,
                     register, run_mega)
from .mega_soup import IMPLS


def build_parser():
    p = base_parser(__doc__)
    p.add_argument("--size", type=int, default=1_000_000,
                   help="total particles, split ~1/3 per type (weightwise "
                        "gets the remainder)")
    p.add_argument("--generations", type=int, default=1000)
    p.add_argument("--attacking-rate", type=float, default=0.1)
    p.add_argument("--learn-from-rate", type=float, default=0.1)
    p.add_argument("--learn-from-severity", type=int, default=1)
    p.add_argument("--train", type=int, default=10)
    p.add_argument("--train-mode", default="sequential",
                   choices=("sequential", "full_batch"))
    p.add_argument("--layout", default="popmajor",
                   choices=("rowmajor", "popmajor"))
    p.add_argument("--respawn-draws", choices=("perparticle", "fused"),
                   default="fused")
    p.add_argument("--train-impl", choices=("xla", "pallas"), default="xla")
    p.add_argument("--generation-impl", choices=("phases", "fused"),
                   default="phases",
                   help="'fused' runs each type's learn+train+respawn as "
                        "one launch of its generation kernel (popmajor; "
                        "the cross-type attack runs before it)")
    p.add_argument("--population-dtype", choices=("f32", "bf16", "int8"),
                   default="f32",
                   help="per-type population storage dtype (PARITY.md)")
    p.add_argument("--apply-impl", choices=("xla", "pallas"), default="xla",
                   help="'pallas' asks for the recurrent attack kernel for "
                        "every recurrent attacker (apply_impl='kernel')")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--capture-every", type=int, default=0, metavar="K",
                   help="stream every K-th generation's per-type frames to "
                        "soup.tN.traj stores (0 = off); must divide "
                        "--checkpoint-every and --generations")
    p.add_argument("--resume", default=None, metavar="RUN_DIR")
    add_pipeline_args(p)
    add_telemetry_args(p)
    add_profile_args(p)
    add_flightrec_args(p)
    add_dynamics_args(p)
    add_resilience_args(p)
    add_sharding_args(p)
    return p


_CONFIG_FIELDS = ("size", "attacking_rate", "learn_from_rate",
                  "learn_from_severity", "train", "train_mode", "layout",
                  "epsilon", "sharded", "respawn_draws", "train_impl",
                  "apply_impl", "capture_every", "generation_impl",
                  "population_dtype")


def _make_config(args, n_dev: int = 1) -> MultiSoupConfig:
    """A third of ``--size`` each to the aggregating and recurrent types,
    the rest to the weightwise one; under sharding each third is rounded
    down to a multiple of the ``n_dev`` ranks (the weightwise remainder
    then divides too: ``--size`` is checked to)."""
    third = args.size // 3
    if n_dev > 1:
        third = (third // n_dev) * n_dev
    return MultiSoupConfig(
        topos=(Topology("weightwise", width=2, depth=2),
               Topology("aggregating", width=2, depth=2),
               Topology("recurrent", width=2, depth=2)),
        sizes=(args.size - 2 * third, third, third),
        attacking_rate=args.attacking_rate,
        learn_from_rate=args.learn_from_rate,
        learn_from_severity=args.learn_from_severity,
        train=args.train,
        train_mode=args.train_mode,
        remove_divergent=True,
        remove_zero=True,
        epsilon=args.epsilon,
        layout=args.layout,
        respawn_draws=args.respawn_draws,
        train_impl=IMPLS[args.train_impl],
        apply_impl=IMPLS[args.apply_impl],
        generation_impl=args.generation_impl,
        population_dtype=args.population_dtype,
    )


def _format_type_counts(counts) -> str:
    names = ("ww", "agg", "rnn")
    parts = []
    for t, row in enumerate(counts):
        cells = ", ".join(f"{c}={int(v)}" for c, v in zip(CLASS_NAMES, row)
                          if v)
        parts.append(f"{names[t]}[{cells or '0'}]")
    return " ".join(parts)


class _Multi:
    """The mixed soup for ``common.run_mega``: one labelled type each."""

    stage = "mega_multisoup"
    name = "mega-multisoup"
    config_fields = _CONFIG_FIELDS
    legacy_defaults = {"generation_impl": "phases",
                       "population_dtype": "f32"}
    store_label = "soup.t*.traj"

    def validate(self, args) -> None:
        if (args.train_impl == "pallas" or args.apply_impl == "pallas") \
                and args.layout != "popmajor":
            raise SystemExit("--train-impl/--apply-impl pallas are popmajor "
                             "lane kernels; --layout rowmajor needs 'xla'")
        if args.generation_impl == "fused" and args.layout != "popmajor":
            raise SystemExit("--generation-impl fused is the popmajor lane "
                             "megakernel; --layout rowmajor needs phases")

    def configure(self, args, n_dev: int = 1) -> None:
        if args.sharded:
            if args.size % n_dev:
                raise SystemExit(
                    f"--sharded needs --size divisible by the {n_dev} "
                    f"devices (got {args.size})")
            if args.size < 3 * n_dev:
                raise SystemExit(
                    f"--sharded needs --size >= 3x the {n_dev} devices so "
                    "every type keeps at least one shard per device")
        self.cfg = _make_config(args, n_dev)
        try:
            _check_multi(self.cfg)
        except ValueError as e:
            raise SystemExit(f"mega_multisoup: {e}")
        self.sizes = self.cfg.sizes
        self.topos = self.cfg.topos
        self.labels = self.type_names = tuple(type_names(self.cfg))
        self.config_extra = {"type_names": [t.variant for t in self.topos]}

    def restore(self, ckpt, mesh=None):
        state = restore_multi_checkpoint(ckpt)
        got = tuple(w.shape[0] for w in state.weights)
        if got != self.cfg.sizes:
            raise SystemExit(
                f"checkpointed per-type sizes {got} do not match the "
                f"configuration's {self.cfg.sizes}")
        return state if mesh is None \
            else place_sharded_multi_state(mesh, state)

    def seed(self, seed_, dev, mesh=None):
        if mesh is not None:
            return make_sharded_multi_state(self.cfg, mesh, seed_)
        return seed_multi(self.cfg, seed_, dev)

    def header(self) -> str:
        cfg = self.cfg
        impls = resolved_train_impls(cfg) if cfg.layout == "popmajor" \
            else cfg.train_impl
        return (f"mega-multisoup N={cfg.total} sizes={cfg.sizes} "
                f"layout={cfg.layout} attack={cfg.attacking_rate} "
                f"train={cfg.train}/{cfg.train_mode} train_impl={impls}")

    def fused_type(self, t: int) -> bool:
        return resolved_generation_impl(self.cfg, self.topos[t]) == "fused"

    def fused_line(self, dev) -> str:
        return ",".join(f"{t.variant}={resolved_generation_impl(self.cfg, t)}"
                        for t in self.topos)

    def count(self, state, mesh=None):
        if mesh is not None:
            return sharded_count_multi(self.cfg, mesh, state)
        return count_multi(self.cfg, state)

    def format_counts(self, counts) -> str:
        return _format_type_counts(counts)

    def counts_doc(self, counts):
        return counts.tolist()

    def evolve(self, state, generations, mesh=None, **kw):
        if mesh is not None:
            return sharded_evolve_multi(self.cfg, mesh, state, generations,
                                        **kw)
        return evolve_multi(self.cfg, state, generations, **kw)

    def capture(self, state, generations, stores, **kw):
        return evolve_multi_captured(self.cfg, state, generations, stores,
                                     **kw)

    def weights(self, state):
        return state.weights

    def store_paths(self, run_dir):
        return [os.path.join(run_dir, f"soup.t{t}.traj")
                for t in range(len(self.topos))]


def run(args):
    """One supervised heterogeneous mega run (``mega_soup.run``'s
    contract)."""
    return supervised_run(args, _run_once)


def _run_once(args, ctx=None):
    if args.smoke:
        args.size = 48 if args.size == 1_000_000 else args.size
        args.generations = 6 if args.generations == 1000 else args.generations
        args.checkpoint_every = 2 if args.checkpoint_every == 100 \
            else args.checkpoint_every
        args.train = 1 if args.train == 10 else args.train
    return run_mega(args, ctx, _Multi())


@register("mega_multisoup")
def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
