"""The Soup: population dynamics of self-replicating particles; port of
the parallel mode of ``srnn_tpu/soup.py``, in both of its layouts.

Reference: ``Soup`` (``soup.py:10-108``).  Per generation, per particle:
with p=attacking_rate pick a uniform random other (possibly self) and
*attack* it (overwrite the victim's weights with self applied to them); with
p=learn_from_rate imitate a random other for ``learn_from_severity`` SGD
epochs; run ``train`` self-training epochs; respawn dead particles in place
-- divergent first, then zero -- with fresh uids.  Rates <= 0 disable a
phase.  All particles step together from the start-of-phase state; attack
collisions resolve last-attacker-wins, as in the JAX package.

Scope of this port: all four variants (weightwise, aggregating, fft,
recurrent) with every activation, width, depth and aggregates, either
``rnn_scan`` and, row-major, either shuffler; the three population dtypes
(``population_dtype`` 'f32' | 'bf16' | 'int8'), ``mode='parallel'`` in
either layout below, and ``mode='sequential'``:

  * ``layout='rowmajor'`` (the default, as in the JAX package): the
    population stays (N, P) between generations.  The attack is the
    row-major transform (``nets.dispatch.apply_to_weights``, plain torch,
    every variant; its nets run as explicit multiply-add chains,
    ``ops/mlp.mlp_apply``, which round alike on the card and the CPU);
    learn_from and self-training run over the (P, N) transpose on the
    particle's route (``train.py``'s, below).  A state may carry a leading trial axis -- B soups side by
    side, each with its own generator (``stack``) -- and then one kernel
    launch per phase per generation serves all of them.
  * ``layout='popmajor'``: the population is held (P, N), in either train
    mode.  ``generation_impl='fused'`` runs the whole generation as one
    launch of the variant's generation kernel (the weightwise variant's in
    its sequential train mode only); ``generation_impl='phases'`` runs the
    phases one after another, the train and learn_from chains on the
    variant's SGD kernel (the weightwise full batch on its plain step) and
    the recurrent attack on its attack kernel.  ``attack_impl`` /
    ``learn_from_impl='compact'`` run the attack / learn_from phase of the
    phase chain on a block of the gated lanes only (``_attack_capacity``
    lanes, the full width on overflow), bitwise equal to 'full'; the fused
    generation ignores them, as the JAX package's ``_phases_view`` does.
  * ``mode='sequential'`` (``_evolve_sequential``, ``soup.py:880-943`` of
    the JAX package; row-major, float32, per-particle respawn draws, no
    trial axis): the reference's strict particle-by-particle order, each
    particle seeing every change the particles before it made this
    generation.  Particle i's attack overwrites its victim's row with the
    row-major transform; its learn_from and training run on its own row as
    one lane (P, 1) on its route (on the variant's SGD kernel: one launch
    per learner and one per particle a generation); it respawns from its
    own fresh row
    and the next uid.  The generation's draws (``SoupDraws``, read particle
    by particle) depend on no state, so they are made up front and read on
    the host once a generation.

Routes (``ops/popmajor.train_route``, decided from the configuration
before any launch): the learn_from and train phases run on the variant's
SGD kernel (K2 weightwise, K4 aggregating/fft, K5 recurrent) for the
particles inside the kernels' envelope (the JAX package's Pallas one: an
output-expressible activation, up to 64 weights), on the weightwise full
batch's hand-derived step (``ops/popmajor.ww_full_batch_epochs``), or on
the autograd chains (elu, softmax, swish, gelu; particles over 64
weights; row-major ``rnn_scan='associative'``, whose JAX train
differentiates through the associative forward).  The population's device
picks the side inside each kernel's wrapper: CUDA tensors launch the
kernels, CPU tensors run their plain versions; nothing gives way to a plain
version at run time.  ``train_impl`` ('plain' | 'kernel', the JAX
package's 'xla' | 'pallas'): 'plain' (the default) takes those routes;
'kernel' asks for the kernels and raises upfront for a particle outside
their envelope, and in the row-major layout, as the JAX package's
'pallas' does.  ``apply_impl`` 'kernel' asks for K6 for the
population-major recurrent attack and raises, as the JAX package's
'pallas' does, for any other particle, in the row-major layout and beside
``generation_impl='fused'`` (as ``train_impl='kernel'`` does there); the
recurrent attack takes K6 under 'plain' too, where the particle is inside
the envelope.  A random shuffler needs the
row-major layout (the JAX package's refusal); its row-major attack passes
no permutation, so it raises where the JAX package's does.

On the CPU the row-major weightwise and aggregating soups equal the
population-major phase chain bitwise: their transforms agree bitwise and
the SGD chains are the same calls.  The recurrent ones do not (the
population-major recurrence, K6's, sums in another order).

Population precision (``soup.py:133-148``, ``:175-247`` of the JAX
package): a 'bf16' population stores bfloat16 weights, an 'int8' one int8
codes with a per-particle float32 scale (``SoupState.scales``).  Every phase
computes in float32 and the stored weights round exactly once per
generation, at its exit.  The phase routes upcast at entry and round at
exit; on the fused route a bfloat16 population rides the generation kernel
at storage width (its columns gathered as bfloat16, upcast at load, rounded
at store), and an int8 one is dequantized before the gathers and
re-quantized at the same exit point.  So the routes round at the same
points and agree bitwise wherever their float32 arithmetic does.

Randomness: the state carries a ``torch.Generator`` (field ``key``), seeded
from an int.  ``evolve_step`` and ``evolve`` draw from a copy of it and hand
the advanced copy back in the new state, so a state, like the JAX package's,
can be evolved twice to the same result.  Both layouts draw the same
numbers in the same order (``draw``), as the JAX package's do, so one seed
gives one soup in either layout wherever their arithmetic agrees.  A
generator on another device than the population (the CPU) draws there and
the draws move to the population's device.  A caller may instead hand
``evolve_step`` the generation's draws (``SoupDraws``) -- the tests hand
over the JAX package's own draws.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .engine import classify_batch
from .init import (fresh_lanes, init_population, make_generator,
                   resolve_device)
from .init import on_device as _on
from .nets.dispatch import apply_to_weights
from .ops.cuda_generation import fused_kernel_supported, generation_popmajor
from .ops.cuda_sgd_common import KERNEL_MAX_WEIGHTS
from .ops.popmajor import (DEFAULT_LR, apply_popmajor, apply_route,
                           check_train_mode, learn_epochs_popmajor,
                           resolved_train_impl, train_epochs_popmajor)
from .ops.predicates import (DEFAULT_EPSILON, count_classes, is_diverged,
                             is_zero)
from .topology import Topology
from .train import fit_epochs_flat

# action codes for the event log (reference action strings, soup.py:60-85)
ACTION_NAMES = ("none", "init", "attacking", "learn_from", "train_self",
                "divergent_dead", "zero_dead")
(ACT_NONE, ACT_INIT, ACT_ATTACK, ACT_LEARN, ACT_TRAIN,
 ACT_DIV_DEAD, ACT_ZERO_DEAD) = range(7)


class SoupConfig(NamedTuple):
    """Soup hyperparameters; the fields of the JAX package's ``SoupConfig``
    (see its docstrings for each)."""
    topo: Topology
    size: int
    attacking_rate: float = 0.1
    learn_from_rate: float = 0.1
    train: int = 0
    learn_from_severity: int = 1
    remove_divergent: bool = False
    remove_zero: bool = False
    epsilon: float = DEFAULT_EPSILON
    lr: float = DEFAULT_LR
    train_mode: str = "sequential"
    mode: str = "parallel"
    layout: str = "rowmajor"            # 'rowmajor' | 'popmajor'
    respawn_draws: str = "perparticle"  # 'perparticle' | 'fused': one law
    train_impl: str = "plain"           # 'plain' | 'kernel' (routes)
    attack_impl: str = "full"           # 'full' | 'compact' (popmajor)
    learn_from_impl: str = "full"       # 'full' | 'compact' (popmajor)
    apply_impl: str = "plain"           # 'plain' | 'kernel' (K6)
    generation_impl: str = "phases"     # 'phases' | 'fused'
    population_dtype: str = "f32"


class SoupState(NamedTuple):
    """Population as struct-of-arrays.  A stacked state (``stack``) holds
    B soups of one config side by side: every field gains a leading trial
    axis and ``key`` is a tuple of the trials' generators."""
    weights: torch.Tensor   # (N, P) in the storage dtype (float32,
    #                         bfloat16, or int8 codes)
    uids: torch.Tensor      # (N,) int32 -- stable identity across respawns
    next_uid: torch.Tensor  # () int32
    time: torch.Tensor      # () int32 generation counter
    key: torch.Generator    # the soup's random stream
    scales: Optional[torch.Tensor] = None  # (N,) float32, int8 populations
    #                                        only (None otherwise)


class SoupEvents(NamedTuple):
    """Per-generation event record (one row per particle)."""
    action: torch.Tensor       # (N,) int32 action code (last action of the step)
    counterpart: torch.Tensor  # (N,) int32 counterpart uid or -1
    loss: torch.Tensor         # (N,) f32 last train loss or 0


class SoupDraws(NamedTuple):
    """One generation's random numbers.  Tensors or numpy arrays; the
    attack (learn) fields are read only when that phase is on."""
    attack_gate: object  # (N,) bool
    attack_tgt: object   # (N,) int, victim index per attacker
    learn_gate: object   # (N,) bool
    learn_tgt: object    # (N,) int, counterpart index per learner
    fresh: object        # (P, N) float32 respawn replacements


_POP_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "int8": torch.int8}


def _pop_dtype(config) -> torch.dtype:
    """Storage dtype of the population (``population_dtype`` field)."""
    dtype = _POP_DTYPES.get(config.population_dtype)
    if dtype is None:
        raise ValueError(
            f"unknown population_dtype {config.population_dtype!r}; "
            "expected 'f32', 'bf16' or 'int8'")
    return dtype


def _upcast(config, w: torch.Tensor, scales: Optional[torch.Tensor] = None,
            paxis: int = 0) -> torch.Tensor:
    """Storage -> float32 compute view (no-op for float32 populations).
    bfloat16 upcasts exactly; int8 dequantizes ``codes * scale``, the
    per-particle ``scales`` broadcast along the particle axis ``paxis`` (0
    for row-major (N, P), -1 for population-major (P, N)).  A diverged
    particle's scale is +inf and its codes 127, so it dequantizes to +inf
    and stays divergent."""
    if config.population_dtype == "bf16":
        return w.float()
    if config.population_dtype == "int8":
        shape = [1] * w.dim()
        shape[paxis] = -1
        return w.float() * scales.reshape(shape)
    return w


def _downcast(config, w: torch.Tensor, paxis: int = 0
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Float32 compute result -> ``(storage, scales or None)``: the
    reduced-precision modes' one rounding point per generation.

    int8 quantizes symmetrically per particle: ``scale = amax / 127``
    (floored at the smallest normal float32), ``codes = clip(round(w /
    scale), -127, 127)``, rounding half to even as ``jnp.round`` does.  An
    all-zero particle keeps ``scale = 1``; a particle with any non-finite
    weight (its amax is NaN or +inf: ``amax`` propagates NaN) stores
    ``scale = +inf`` and codes 127."""
    if config.population_dtype == "bf16":
        return w.to(torch.bfloat16), None
    if config.population_dtype != "int8":
        return w, None
    paxis = paxis % w.dim()
    dims = tuple(a for a in range(w.dim()) if a != paxis)
    amax = w.abs().amax(dim=dims)
    div = ~torch.isfinite(amax)
    # a tensor divisor: torch divides a CUDA tensor by a Python scalar as a
    # multiply by its reciprocal, which can round the scale differently
    step = amax / torch.full_like(amax, 127.0)
    safe = torch.where((amax > 0) & ~div,
                       step.clamp_min(torch.finfo(torch.float32).tiny),
                       torch.ones_like(amax))
    shape = [1] * w.dim()
    shape[paxis] = -1
    q = torch.clamp(torch.round(w / safe.reshape(shape)), -127.0, 127.0)
    q = torch.where(div.reshape(shape), 127.0, q).to(torch.int8)
    scales = torch.where(div, torch.full_like(safe, float("inf")), safe)
    return q, scales


def _stored_view(config, w: torch.Tensor, scales: Optional[torch.Tensor],
                 paxis: int = 0) -> torch.Tensor:
    """What consumers of stored weights read (classification): the
    dequantized float32 view of int8 codes; float32 and bfloat16 weights as
    they are stored."""
    if config.population_dtype == "int8":
        return _upcast(config, w, scales, paxis)
    return w


def seed(config: SoupConfig, seed, device="cuda") -> SoupState:
    """Create the initial population (``Soup.seed``, ``soup.py:45-49``) on
    ``device``, in the storage dtype.  ``seed`` is an int, which seeds a
    generator on ``device``, or a ``torch.Generator``, which may live on
    another device (the CPU): the soup carries it, draws there and moves
    the draws to ``device``, so one generator gives one soup on either
    device."""
    _check_config(config)
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) \
        else make_generator(seed, dev)
    w = init_population(config.topo, gen, config.size, gen.device).to(dev)
    w, scales = _downcast(config, w)
    return SoupState(
        weights=w,
        uids=torch.arange(config.size, dtype=torch.int32, device=dev),
        next_uid=torch.tensor(config.size, dtype=torch.int32, device=dev),
        time=torch.tensor(0, dtype=torch.int32, device=dev),
        key=gen, scales=scales)


def _check_config(config: SoupConfig) -> None:
    """The JAX package's ``_evolve_step`` checks (``soup.py:945-982``) and
    ``_check_popmajor``, with the kernels' envelope (the JAX package's
    Pallas one) as the envelope of 'kernel' and of the fused generation."""
    if config.layout not in ("rowmajor", "popmajor"):
        raise ValueError(f"unknown soup layout {config.layout!r}")
    rowmajor = config.layout == "rowmajor"
    if config.mode not in ("parallel", "sequential"):
        raise ValueError(f"unknown soup mode {config.mode!r}")
    sequential = config.mode == "sequential"
    if sequential and config.respawn_draws != "perparticle":
        raise ValueError("mode='sequential' is the strict-parity mode and "
                         "requires respawn_draws='perparticle'")
    _pop_dtype(config)
    if sequential and config.population_dtype != "f32":
        raise ValueError("mode='sequential' is the strict-parity mode and "
                         "requires population_dtype='f32'")
    if sequential and not rowmajor:
        raise ValueError(
            "layout='popmajor' requires mode='parallel'; the "
            "sequential-parity scan mutates one particle at a time and "
            "cannot ride the lane layout")
    if config.generation_impl not in ("phases", "fused"):
        raise ValueError(
            f"unknown generation_impl {config.generation_impl!r}")
    if rowmajor and config.generation_impl == "fused":
        raise ValueError(
            "generation_impl='fused' is the popmajor lane megakernel; "
            "layout='rowmajor' needs generation_impl='phases'")
    for field in ("train_impl", "apply_impl"):
        if getattr(config, field) not in ("plain", "kernel"):
            raise ValueError(f"unknown {field} {getattr(config, field)!r}")
        if rowmajor and getattr(config, field) == "kernel":
            raise ValueError(
                f"{field}='kernel' is the popmajor lane kernel; "
                f"layout='rowmajor' needs {field}='plain'")
    for field in ("attack_impl", "learn_from_impl"):
        if getattr(config, field) == "full":
            continue
        if rowmajor:
            raise ValueError(
                "attack_impl/learn_from_impl='compact' compact lanes of the "
                "popmajor layout; layout='rowmajor' needs 'full'")
        if getattr(config, field) != "compact":
            raise ValueError(f"unknown {field} {getattr(config, field)!r}")
    topo = config.topo
    if not rowmajor and topo.shuffler == "random":
        raise ValueError(
            "layout='popmajor' requires shuffler='not': a per-particle "
            "random permutation of the weight axis is a per-lane gather "
            "that defeats the lane layout — use layout='rowmajor'")
    check_train_mode(topo, config.train_mode)
    if config.respawn_draws not in ("perparticle", "fused"):
        raise ValueError(f"unknown respawn_draws {config.respawn_draws!r}")
    if config.generation_impl == "fused":
        if config.train_impl == "kernel" or config.apply_impl == "kernel":
            raise ValueError(
                "generation_impl='fused' already fuses the SGD chains and "
                "the apply transform in one launch; use train_impl='plain' "
                "and apply_impl='plain' (the per-phase kernel legs are "
                "subsumed)")
        if not fused_kernel_supported(topo, config.train_mode):
            raise ValueError(
                "generation_impl='fused' fuses the whole generation on the "
                "generation kernel: activation with an output-expressible "
                "derivative (linear/sigmoid/tanh/relu), particles up to "
                f"{KERNEL_MAX_WEIGHTS} weights, shuffler='not' (the "
                "weightwise variant additionally needs "
                "train_mode='sequential'); this config "
                f"(variant={topo.variant!r}, "
                f"activation={topo.activation!r}, "
                f"train_mode={config.train_mode!r}, P={topo.num_weights}) "
                "needs generation_impl='phases'")
    if config.apply_impl == "kernel" and apply_route(topo) != "kernel":
        raise ValueError(
            "apply_impl='kernel' fuses the RECURRENT variant's serial "
            "forward on its kernel (K6: activation with an "
            "output-expressible derivative, particles up to "
            f"{KERNEL_MAX_WEIGHTS} weights); this config "
            f"(variant={topo.variant!r}, activation={topo.activation!r}, "
            f"P={topo.num_weights}) needs apply_impl='plain'")
    if config.apply_impl == "kernel" and config.attack_impl == "compact":
        raise ValueError(
            "apply_impl='kernel' and attack_impl='compact' are mutually "
            "exclusive, as in the JAX package (its compact block defeats "
            "the kernel's lane blocking); use attack_impl='full'")
    resolved_train_impl(topo, config.train_mode, config.train_impl,
                        config.layout)


def check_tenant_stackable(config: SoupConfig) -> None:
    """Validate that ``config`` may ride the serve tenant axis
    (``serve.tenant``; ``check_tenant_stackable``, ``soup.py:832`` of the
    JAX package): K soups of this config with different seeds stacked
    into one (K, N, P) state (``stack``), each trial's slice of the
    stacked run bitwise its solo run.

    Only the parallel row-major path qualifies, as in the JAX package:
    there one launch per phase serves the K * N rows, each row its own
    lane.  The population-major layout stays solo (the JAX package's
    lane reductions reassociate under its tenant vmap; this port's
    per-lane kernels would not, but the port adds no stacking the JAX
    package lacks), and the sequential strict-parity mode is a
    per-particle validation mode with nothing to amortize.  The serve
    scheduler falls back to solo dispatch for configs that fail this
    check."""
    if config.mode != "parallel":
        raise ValueError(
            "tenant stacking rides the parallel step; "
            f"mode={config.mode!r} is unsupported (solo dispatch only)")
    if config.layout != "rowmajor":
        raise ValueError(
            "tenant stacking requires layout='rowmajor': the popmajor "
            "lane layout's reductions reassociate under the tenant vmap "
            "axis, breaking the bitwise-equal-to-solo contract")


def tenant_stackable(config: SoupConfig) -> bool:
    """Would this config's evolve ride the serve tenant axis?"""
    try:
        check_tenant_stackable(config)
    except ValueError:
        return False
    return True


def draw(config: SoupConfig, gen: torch.Generator,
         device) -> SoupDraws:
    """One generation's draws from ``gen``, in a fixed order, made on the
    generator's device and moved to ``device``; both layouts take them."""
    n = config.size
    dev = gen.device
    u_att = torch.rand(n, generator=gen, device=dev)
    t_att = torch.randint(0, n, (n,), generator=gen, device=dev)
    u_lrn = torch.rand(n, generator=gen, device=dev)
    t_lrn = torch.randint(0, n, (n,), generator=gen, device=dev)
    fresh = fresh_lanes(config.topo, gen, n, config.respawn_draws, dev)
    return SoupDraws(*(t.to(device) for t in (
        u_att < config.attacking_rate, t_att,
        u_lrn < config.learn_from_rate, t_lrn, fresh)))


def _resolve_draws(config: SoupConfig, gen: torch.Generator, device,
                   draws: Optional[SoupDraws]) -> SoupDraws:
    if draws is None:
        return draw(config, gen, device)
    n, p = config.size, config.topo.num_weights
    d = SoupDraws(_on(draws.attack_gate, device, torch.bool),
                  _on(draws.attack_tgt, device, torch.int64),
                  _on(draws.learn_gate, device, torch.bool),
                  _on(draws.learn_tgt, device, torch.int64),
                  _on(draws.fresh, device, torch.float32))
    for name, t in zip(SoupDraws._fields[:4], d[:4]):
        if t.shape != (n,):
            raise ValueError(f"draws.{name} must have shape ({n},)")
    for name, t in (("attack_tgt", d.attack_tgt), ("learn_tgt", d.learn_tgt)):
        if bool(((t < 0) | (t >= n)).any()):
            raise ValueError(f"draws.{name} holds indices outside [0, {n})")
    if d.fresh.shape != (p, n):
        raise ValueError(f"draws.fresh must have shape ({p}, {n})")
    return d


def _event_record(n, attack_gate, attack_cp, learn_gate, learn_cp, train_on,
                  death_action, death_cp):
    """Last-action-wins event tail (reference description-dict overwrite
    quirk, ``soup.py:55-87``)."""
    dev = attack_gate.device
    action = torch.full((n,), ACT_NONE, dtype=torch.int32, device=dev)
    counterpart = torch.full((n,), -1, dtype=torch.int32, device=dev)
    action = torch.where(attack_gate, ACT_ATTACK, action)
    counterpart = torch.where(attack_gate, attack_cp, counterpart)
    action = torch.where(learn_gate, ACT_LEARN, action)
    counterpart = torch.where(learn_gate, learn_cp, counterpart)
    if train_on:
        action = torch.full_like(action, ACT_TRAIN)
        counterpart = torch.full_like(counterpart, -1)
    died = death_action != ACT_NONE
    action = torch.where(died, death_action, action)
    counterpart = torch.where(died, death_cp, counterpart)
    return action.to(torch.int32), counterpart.to(torch.int32)


def _gates(config: SoupConfig, d: SoupDraws, n: int, dev):
    """Resolved phase gates: (attack_gate, attack_tgt, att_idx, learn_gate,
    learn_tgt).  ``att_idx[v]`` is the highest-indexed attacker of victim v,
    or -1 (last attacker wins: ``segment_max`` in the JAX package)."""
    zeros_b = torch.zeros(n, dtype=torch.bool, device=dev)
    zeros_i = torch.zeros(n, dtype=torch.int64, device=dev)
    att_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if config.attacking_rate > 0:
        attack_gate, attack_tgt = d.attack_gate, d.attack_tgt
        src = torch.where(attack_gate, torch.arange(n, device=dev), -1)
        att_idx = att_idx.scatter_reduce(0, attack_tgt, src, "amax",
                                         include_self=True)
    else:
        attack_gate, attack_tgt = zeros_b, zeros_i
    if config.learn_from_rate > 0:
        learn_gate, learn_tgt = d.learn_gate, d.learn_tgt
    else:
        learn_gate, learn_tgt = zeros_b, zeros_i
    return attack_gate, attack_tgt, att_idx, learn_gate, learn_tgt


def _respawn_uids(uids, base, dead_div, dead_zero):
    """Fresh uids ``base, base + 1, ...`` for the dead lanes in lane order
    (the ``cumsum`` rank) along the last axis, each row of a (B, N) batch
    from its own ``base`` (B, 1); returns (uids, deaths per row, death
    action, death counterpart)."""
    dead = dead_div | dead_zero
    rank = torch.cumsum(dead.to(torch.int64), -1) - 1
    uids = torch.where(dead, base + rank.to(torch.int32), uids).to(
        torch.int32)
    action = torch.full_like(uids, ACT_NONE)
    action = torch.where(dead_div, ACT_DIV_DEAD, action)
    action = torch.where(dead_zero, ACT_ZERO_DEAD, action)
    return (uids, dead.sum(-1).to(torch.int32), action,
            torch.where(dead, uids, -1))


def _finish(config: SoupConfig, state: SoupState, gates, wT, train_loss,
            dead_div, dead_zero):
    """The stored population (rounded once, here), the uids of the
    respawned, the event record and the new state."""
    wT, scales = _downcast(config, wT, paxis=-1)
    attack_gate, attack_tgt, _, learn_gate, learn_tgt = gates
    uids, deaths, action, death_cp = _respawn_uids(
        state.uids, state.next_uid, dead_div, dead_zero)
    act, cp = _event_record(
        config.size, attack_gate, state.uids[attack_tgt], learn_gate,
        state.uids[learn_tgt], config.train > 0, action, death_cp)
    new_state = SoupState(state.weights, uids, state.next_uid + deaths,
                          state.time + 1, state.key, scales)
    return new_state, SoupEvents(act, cp, train_loss), wT


def _attack_capacity(n: int, rate: float) -> int:
    """Lane capacity of a compacted phase's block (the JAX package's
    ``_attack_capacity``, ``soup.py:413-424``): the lineage edge block's
    Binomial(n, rate) bound, ``telemetry.dynamics.edge_capacity``.
    P(overflow) < 1e-14."""
    from .telemetry.dynamics import edge_capacity

    return edge_capacity(n, rate)


def _compact_gated_lanes(wT: torch.Tensor, gate: torch.Tensor, cap: int,
                         block_fn) -> torch.Tensor:
    """Run ``block_fn`` on the gated lanes of ``wT`` only and put its
    columns back (``_compact_gated_lanes``, ``soup.py:426-455`` of the JAX
    package).

    ``block_fn(cols)`` returns the transformed columns ``wT[:, cols]`` by
    per-lane arithmetic alone, so a lane's result does not depend on the
    block it rides in: the result equals the full-width phase bitwise, and
    ungated lanes are untouched.  The block holds the first ``cap`` gated
    lanes in lane order (``jnp.nonzero(size=cap, fill_value=n)``: the
    k-th gated lane is where the running count first reaches k); its fill
    slots compute on lane 0's columns and are never read back.  The
    results come back by a gather, each gated lane reading its slot, so no
    two writes land on one lane.  When more than ``cap`` lanes are gated
    the phase runs at full width: the count is read on the host, one
    synchronisation per compacted phase (the JAX package decides on the
    device with ``lax.cond``)."""
    n = wT.shape[1]
    running = torch.cumsum(gate, 0) if cap < n else None
    if running is None or int(running[-1]) > cap:
        return torch.where(gate[None, :],
                           block_fn(torch.arange(n, device=wT.device)), wT)
    lanes = torch.searchsorted(
        running, torch.arange(1, cap + 1, device=wT.device))
    block = block_fn(torch.where(lanes < n, lanes, 0))
    slot = (running - 1).clamp(0, cap - 1)
    return torch.where(gate[None, :], block[:, slot], wT)


def _attack_popmajor_compact(topo: Topology, wT: torch.Tensor,
                             att_idx: torch.Tensor, has_attacker: torch.Tensor,
                             cap: int, source: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The attack over the attacked victims' lanes only
    (``_attack_popmajor_compact``, ``soup.py:458-478`` of the JAX
    package): the transform of ``apply_popmajor`` on a block of ``cap``
    lanes (K6 for a recurrent particle on its route).  The attackers'
    columns come from ``source`` (default ``wT``) by index: under sharding
    the victims are a rank's own lanes and ``source`` the gathered
    population, ``att_idx`` global indices into it."""
    attacker = att_idx.clamp(min=0)
    source = wT if source is None else source

    def block(cols):
        return apply_popmajor(topo, source[:, attacker[cols]], wT[:, cols])

    return _compact_gated_lanes(wT, has_attacker, cap, block)


def _learn_popmajor_compact(config, topo: Topology, wT: torch.Tensor,
                            learn_gate: torch.Tensor, learn_tgt: torch.Tensor,
                            cap: int, source: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """learn_from over the learners' lanes only
    (``_learn_popmajor_compact``, ``soup.py:481-503`` of the JAX package):
    the imitation chain on its route (K2, K4 or K5 on the card) over a
    block of ``cap`` lanes toward the post-attack counterparts, read from
    ``source`` (default ``wT``; the gathered post-attack population under
    sharding) at the global indices ``learn_tgt``."""
    source = wT if source is None else source

    def block(cols):
        learned, _ = learn_epochs_popmajor(
            topo, wT[:, cols], source[:, learn_tgt[cols]],
            config.learn_from_severity, config.lr, config.train_mode,
            layout=config.layout)
        return learned

    return _compact_gated_lanes(wT, learn_gate, cap, block)


def _learn_train_respawn(config, topo: Topology, wT, fresh, learn_gate,
                         learn_tgt, learn_cap: Optional[int] = None,
                         source=None):
    """The phase chain after the attack (``soup.py:62-86``): learn_from
    toward the (post-attack) counterparts, train, the respawn predicates
    and the fresh select.  ``config`` is a ``SoupConfig`` or a mixed
    soup's config (the same dynamics fields); ``learn_cap``, where given,
    compacts learn_from to a block of that many lanes.  ``source`` is
    where the counterparts are read (default ``wT``): a callable making
    the gathered post-attack population of a sharded soup, called only
    where learn_from runs.  Returns (wT, last train loss, dead_div,
    dead_zero)."""
    n = wT.shape[1]
    dev = wT.device
    if config.learn_from_rate > 0 and config.learn_from_severity > 0:
        src = wT if source is None else source(wT)
        if learn_cap is not None:
            wT = _learn_popmajor_compact(config, topo, wT, learn_gate,
                                         learn_tgt, learn_cap, source=src)
        else:
            learned, _ = learn_epochs_popmajor(
                topo, wT, src[:, learn_tgt], config.learn_from_severity,
                config.lr, config.train_mode, layout=config.layout)
            wT = torch.where(learn_gate[None, :], learned, wT)
    if config.train > 0:
        wT, train_loss = train_epochs_popmajor(
            topo, wT, config.train, config.lr, config.train_mode,
            layout=config.layout)
    else:
        train_loss = torch.zeros(n, dtype=wT.dtype, device=dev)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    dead_div = is_diverged(wT, axis=0) if config.remove_divergent else none
    dead_zero = (is_zero(wT, config.epsilon, axis=0) & ~dead_div) \
        if config.remove_zero else none
    wT = torch.where((dead_div | dead_zero)[None, :], fresh, wT)
    return wT, train_loss, dead_div, dead_zero


def _record_lineage(lineage, gen, att_idx, learn_gate, learn_tgt, dead,
                    mesh=None):
    """The lineage carry advanced by one generation's gates, read after
    its weights math (``dynamics.record_step``): ``lineage`` is (lin, win,
    (caps, capacity)); returns (lin, win).  Under sharding (``mesh``) the
    gates are the rank's lanes and the indices global."""
    from .telemetry.dynamics import lookup_pids, record_step

    lin, win, (caps, capacity) = lineage
    return record_step(
        lin, win, gen=gen, attacked=att_idx >= 0,
        attacker_pid=lookup_pids(lin.pid, att_idx.clamp(min=0), mesh),
        learn_gate=learn_gate, learn_tgt=learn_tgt, dead=dead, caps=caps,
        capacity=capacity, mesh=mesh)


def _evolve_parallel_popmajor(config: SoupConfig, state: SoupState,
                              wT: torch.Tensor,
                              draws: Optional[SoupDraws] = None,
                              lineage=None):
    """One generation on the stored (P, N) population ``wT``
    (``state.weights`` is carried only for metadata).  Returns (new_state,
    events, new stored wT), and with a ``lineage`` carry (lin, win,
    (caps, capacity)) the advanced (lin, win) after them."""
    if config.generation_impl == "fused":
        return _evolve_fused_popmajor(config, state, wT, draws, lineage)
    n = config.size
    topo = config.topo
    dev = wT.device
    wT = _upcast(config, wT, state.scales, paxis=-1)
    d = _resolve_draws(config, state.key, dev, draws)
    gates = _gates(config, d, n, dev)
    _, _, att_idx, learn_gate, learn_tgt = gates

    # --- attack (soup.py:56-61) -----------------------------------------
    if config.attacking_rate > 0:
        has_attacker = att_idx >= 0
        if config.attack_impl == "compact":
            wT = _attack_popmajor_compact(
                topo, wT, att_idx, has_attacker,
                _attack_capacity(n, config.attacking_rate))
        else:
            attacked = apply_popmajor(topo, wT[:, att_idx.clamp(min=0)], wT)
            wT = torch.where(has_attacker[None, :], attacked, wT)

    # --- learn_from, train, respawn (soup.py:62-86) -----------------------
    learn_cap = _attack_capacity(n, config.learn_from_rate) \
        if config.learn_from_impl == "compact" else None
    wT, train_loss, dead_div, dead_zero = _learn_train_respawn(
        config, topo, wT, d.fresh, learn_gate, learn_tgt, learn_cap)
    out = _finish(config, state, gates, wT, train_loss, dead_div, dead_zero)
    if lineage is None:
        return out
    return out + _record_lineage(lineage, state.time, att_idx, learn_gate,
                                 learn_tgt, dead_div | dead_zero)


def _evolve_fused_popmajor(config: SoupConfig, state: SoupState,
                           wT: torch.Tensor,
                           draws: Optional[SoupDraws] = None, lineage=None):
    """One generation as one launch of the generation kernel: the same
    draws, phase order and event record as the phase chain.  Counterpart
    operands are gathered from the START-of-generation population; the
    kernel re-applies the attack to imitation targets, so learners see
    post-attack weights like the phase chain.  A bfloat16 population
    enters the kernel as it is stored; an int8 one is dequantized here,
    before the gathers."""
    n = config.size
    dev = wT.device
    if config.population_dtype == "int8":
        wT = _upcast(config, wT, state.scales, paxis=-1)
    d = _resolve_draws(config, state.key, dev, draws)
    gates = _gates(config, d, n, dev)
    _, _, att_idx, learn_gate, learn_tgt = gates
    attacking = config.attacking_rate > 0
    sgd_learn = config.learn_from_rate > 0 and config.learn_from_severity > 0

    attackerT = wT[:, att_idx.clamp(min=0)] if attacking else None
    otherT = other_attackerT = other_attacked = None
    if sgd_learn:
        otherT = wT[:, learn_tgt]
        if attacking:
            other_att = att_idx[learn_tgt]
            other_attackerT = wT[:, other_att.clamp(min=0)]
            other_attacked = other_att >= 0
    wT, train_loss, dead_div, dead_zero = generation_popmajor(
        config.topo, wT, d.fresh, attackerT,
        att_idx >= 0 if attacking else None, otherT, other_attackerT,
        other_attacked, learn_gate if sgd_learn else None,
        severity=config.learn_from_severity if sgd_learn else 0,
        train=config.train, lr=config.lr,
        remove_divergent=config.remove_divergent,
        remove_zero=config.remove_zero, epsilon=config.epsilon)
    out = _finish(config, state, gates, wT, train_loss, dead_div, dead_zero)
    if lineage is None:
        return out
    return out + _record_lineage(lineage, state.time, att_idx, learn_gate,
                                 learn_tgt, dead_div | dead_zero)


def _rowmajor_generation(config: SoupConfig, state: SoupState,
                         draws: Optional[Sequence[SoupDraws]] = None,
                         lineage=None):
    """One parallel row-major generation (``_evolve_parallel``,
    ``soup.py:330-410`` of the JAX package) of the B soups of a stacked
    ``state`` at once; ``draws`` replaces the trials' draws (one
    ``SoupDraws`` each).  Each trial's attack and learn targets index
    within its own trial (a ``b * N`` offset on the flattened rows), and
    every phase runs on all B * N rows: one kernel launch per phase.
    Returns (new stacked state, events (B, N)), and with ``lineage`` (one
    (lin, win, (caps, capacity)) carry per trial) the list of each
    trial's advanced (lin, win) after them: every trial's gates are read
    in its own indices, so its carry is the one its solo run advances."""
    b, n, p = state.weights.shape
    topo = config.topo
    dev = state.weights.device
    ds = [_resolve_draws(config, gen, dev, None if draws is None
                         else draws[t]) for t, gen in enumerate(state.key)]

    def rows_of(field):
        return torch.cat([getattr(d, field) for d in ds])

    rows = _upcast(config, state.weights.reshape(b * n, p),
                   None if state.scales is None
                   else state.scales.reshape(-1))
    off = torch.arange(b, device=dev).repeat_interleave(n) * n
    none = torch.zeros(b * n, dtype=torch.bool, device=dev)
    zero_tgt = torch.zeros(b * n, dtype=torch.int64, device=dev)

    # --- attack (soup.py:56-61): last attacker wins ----------------------
    if config.attacking_rate > 0:
        attack_gate, attack_tgt = rows_of("attack_gate"), rows_of("attack_tgt")
        src = torch.where(attack_gate, torch.arange(b * n, device=dev), -1)
        att_idx = torch.full((b * n,), -1, dtype=torch.int64, device=dev)
        att_idx = att_idx.scatter_reduce(0, attack_tgt + off, src, "amax",
                                         include_self=True)
        attacked = apply_to_weights(topo, rows[att_idx.clamp(min=0)], rows)
        rows = torch.where((att_idx >= 0)[:, None], attacked, rows)
    else:
        attack_gate, attack_tgt = none, zero_tgt
        att_idx = torch.full((b * n,), -1, dtype=torch.int64, device=dev)

    # --- learn_from (soup.py:62-68): the counterparts' samples fixed ------
    if config.learn_from_rate > 0:
        learn_gate, learn_tgt = rows_of("learn_gate"), rows_of("learn_tgt")
        if config.learn_from_severity > 0:
            other = rows[learn_tgt + off]
            learned, _ = learn_epochs_popmajor(
                topo, rows.t().contiguous(), other.t().contiguous(),
                config.learn_from_severity, config.lr, config.train_mode,
                layout="rowmajor")
            rows = torch.where(learn_gate[:, None], learned.t(), rows)
    else:
        learn_gate, learn_tgt = none, zero_tgt

    # --- train (soup.py:69-76) -------------------------------------------
    rows, train_loss = fit_epochs_flat(topo, rows, config.train, config.lr,
                                       config.train_mode)

    # --- respawn (soup.py:77-86), uids ranked per trial ------------------
    dead_div = is_diverged(rows) if config.remove_divergent else none
    dead_zero = (is_zero(rows, config.epsilon) & ~dead_div) \
        if config.remove_zero else none
    fresh = torch.cat([d.fresh.t() for d in ds])
    rows = torch.where((dead_div | dead_zero)[:, None], fresh, rows)
    uids, deaths, death_action, death_cp = _respawn_uids(
        state.uids, state.next_uid[:, None], dead_div.view(b, n),
        dead_zero.view(b, n))
    flat_uids = state.uids.reshape(-1)
    act, cp = _event_record(
        b * n, attack_gate, flat_uids[attack_tgt + off], learn_gate,
        flat_uids[learn_tgt + off], config.train > 0,
        death_action.reshape(-1), death_cp.reshape(-1))

    stored, scales = _downcast(config, rows)
    new_state = SoupState(
        stored.reshape(b, n, p), uids, state.next_uid + deaths,
        state.time + 1, state.key,
        None if scales is None else scales.reshape(b, n))
    events = SoupEvents(act.reshape(b, n), cp.reshape(b, n),
                        train_loss.reshape(b, n))
    if lineage is None:
        return new_state, events
    dead = dead_div | dead_zero
    lin_wins = []
    for t, carry in enumerate(lineage):
        rows_t = slice(t * n, (t + 1) * n)
        att_t = att_idx[rows_t]
        lin_wins.append(_record_lineage(
            carry, state.time[t], torch.where(att_t >= 0, att_t - t * n, -1),
            learn_gate[rows_t], learn_tgt[rows_t], dead[rows_t]))
    return new_state, events, lin_wins


def _evolve_sequential(config: SoupConfig, state: SoupState,
                       draws: Optional[SoupDraws] = None):
    """One sequential generation (``_evolve_sequential``, ``soup.py:880-943``
    of the JAX package) of a lone row-major float32 soup.  Returns
    (new_state, events).

    The particles act in index order on one population that each of them
    mutates in place.  Draw i is particle i's: attack gate and victim,
    learn gate and counterpart, and replacement ``fresh[:, i]``.  The event
    record keeps the JAX package's reading of the counterpart's uid AFTER
    particle i's own respawn: a particle j <= i shows its new uid, j > i
    its old one."""
    n, topo = config.size, config.topo
    w = state.weights.clone()
    dev = w.device
    d = _resolve_draws(config, state.key, dev, draws)
    attack_gate, attack_tgt, _, learn_gate, learn_tgt = _gates(config, d, n,
                                                               dev)
    # the gates steer the host's loop: one read of them a generation
    attacks = attack_gate.tolist()
    victims = attack_tgt.tolist()
    learns = learn_gate.tolist() if config.learn_from_severity > 0 \
        else [False] * n
    teachers = learn_tgt.tolist()
    fresh = d.fresh.t()
    dead_div = torch.zeros(n, dtype=torch.bool, device=dev)
    dead_zero = torch.zeros(n, dtype=torch.bool, device=dev)
    loss = torch.zeros(n, dtype=w.dtype, device=dev)
    for i in range(n):
        if attacks[i]:  # overwrite the VICTIM's row
            v = victims[i]
            w[v] = apply_to_weights(topo, w[i], w[v])
        wT = w[i][:, None]  # particle i as one lane (P, 1)
        if learns[i]:
            t = teachers[i]
            wT, _ = learn_epochs_popmajor(
                topo, wT.contiguous(), w[t][:, None].contiguous(),
                config.learn_from_severity, config.lr, config.train_mode,
                layout="rowmajor")
        if config.train > 0:
            wT, loss_i = train_epochs_popmajor(
                topo, wT.contiguous(), config.train, config.lr,
                config.train_mode, layout="rowmajor")
            loss[i:i + 1] = loss_i
        if config.remove_divergent:
            dead_div[i:i + 1] = is_diverged(wT, axis=0)
        if config.remove_zero:
            dead_zero[i:i + 1] = is_zero(wT, config.epsilon, axis=0) & \
                ~dead_div[i:i + 1]
        dead = dead_div[i:i + 1] | dead_zero[i:i + 1]
        w[i] = torch.where(dead, fresh[i], wT[:, 0])

    # the uids were minted in index order: the cumsum rank of the dead
    uids, deaths, death_action, death_cp = _respawn_uids(
        state.uids, state.next_uid, dead_div, dead_zero)
    order = torch.arange(n, device=dev)

    def uid_seen(tgt):
        return torch.where(tgt <= order, uids[tgt], state.uids[tgt])

    act, cp = _event_record(n, attack_gate, uid_seen(attack_tgt), learn_gate,
                            uid_seen(learn_tgt), config.train > 0,
                            death_action, death_cp)
    new_state = SoupState(w, uids, state.next_uid + deaths, state.time + 1,
                          state.key, None)
    return new_state, SoupEvents(act, cp, loss)


def _sequential(config: SoupConfig, state: SoupState) -> SoupState:
    """``state`` checked for the sequential mode: one soup, no trial
    axis."""
    if isinstance(state.key, tuple):
        raise ValueError("mode='sequential' takes one soup, not a stacked "
                         "state (trial axis)")
    _check_lone(config, state)
    return _forked(state)


def stack(states: Sequence[SoupState]) -> SoupState:
    """B soups of one config as one stacked state (a leading trial axis on
    every field, ``key`` the tuple of their generators), which the
    row-major ``evolve_step`` / ``evolve`` / ``count`` take."""
    return stack_carries(list(states))


def _stacked(config: SoupConfig, state: SoupState) -> Tuple[SoupState, bool]:
    """``state`` with a leading trial axis (a lone soup as B = 1), checked,
    and whether it came stacked."""
    is_stacked = isinstance(state.key, tuple)
    if not is_stacked:
        state = stack([state])
    b = len(state.key)
    shape = (b, config.size, config.topo.num_weights)
    dtype = _pop_dtype(config)
    if tuple(state.weights.shape) != shape or state.weights.dtype != dtype:
        raise ValueError(f"state.weights must be {dtype} {shape[1:]} (a "
                         f"stacked state {shape}), got {state.weights.dtype} "
                         f"{tuple(state.weights.shape)}")
    if tuple(state.uids.shape) != shape[:2] or \
            tuple(state.next_uid.shape) != (b,):
        raise ValueError("state.uids must be (N,) and state.next_uid a "
                         "scalar (a stacked state: (B, N) and (B,))")
    if (state.scales is None) != (config.population_dtype != "int8") or (
            state.scales is not None and
            tuple(state.scales.shape) != shape[:2]):
        raise ValueError("state.scales must be (N,) float32 for an int8 "
                         "population and None otherwise")
    return state, is_stacked


def _unstacked(state: SoupState, is_stacked: bool) -> SoupState:
    if is_stacked:
        return state
    return SoupState(state.weights[0], state.uids[0], state.next_uid[0],
                     state.time[0], state.key[0],
                     None if state.scales is None else state.scales[0])


def _check_lone(config: SoupConfig, state: SoupState) -> None:
    """Raise unless ``state`` is one soup (no trial axis) of ``config``'s
    shape and storage dtype."""
    shape = (config.size, config.topo.num_weights)
    dtype = _pop_dtype(config)
    if tuple(state.weights.shape) != shape or state.weights.dtype != dtype:
        raise ValueError(f"state.weights must be {dtype} {shape}, got "
                         f"{state.weights.dtype} {tuple(state.weights.shape)}")
    if (state.scales is None) != (config.population_dtype != "int8") or (
            state.scales is not None and
            tuple(state.scales.shape) != (config.size,)):
        raise ValueError("state.scales must be (N,) float32 for an int8 "
                         "population and None otherwise")


def _popmajor(config: SoupConfig, state: SoupState) -> torch.Tensor:
    if isinstance(state.key, tuple):
        raise ValueError("a stacked state (trial axis) needs "
                         "layout='rowmajor'")
    _check_lone(config, state)
    return state.weights.t().contiguous()


def _fork(gen: torch.Generator) -> torch.Generator:
    copy = torch.Generator(device=gen.device)
    copy.set_state(gen.get_state())
    return copy


def _forked(state: SoupState) -> SoupState:
    """The state with a copy of its generator(s), so that the caller's
    state stays as it was and can be evolved again to the same result."""
    if isinstance(state.key, tuple):
        return state._replace(key=tuple(_fork(g) for g in state.key))
    return state._replace(key=_fork(state.key))


def evolve_step(config: SoupConfig, state: SoupState, draws=None):
    """One generation (``Soup.evolve`` body, ``soup.py:51-87``).  Returns
    (new_state, events); ``state`` is left as it was.  ``draws`` (a
    ``SoupDraws``; for a stacked state, one per trial) replaces the
    generator's draws for this generation."""
    _check_config(config)
    if config.mode == "sequential":
        return _evolve_sequential(config, _sequential(config, state), draws)
    if config.layout == "popmajor":
        new_state, events, wT = _evolve_parallel_popmajor(
            config, _forked(state), _popmajor(config, state), draws)
        return new_state._replace(weights=wT.t().contiguous()), events
    trials, is_stacked = _stacked(config, _forked(state))
    if draws is not None and not is_stacked:
        draws = [draws]
    trials, events = _rowmajor_generation(config, trials, draws)
    if not is_stacked:
        events = SoupEvents(*(e[0] for e in events))
    return _unstacked(trials, is_stacked), events


class _Record:
    """The stacked per-generation record of ``evolve(record=True)``,
    preallocated on the population's device: events (G, ...) and the
    weights (G, ..., N, P) in the stored view, uids (G, ..., N)."""

    def __init__(self, config: SoupConfig, generations: int, lead: tuple,
                 device):
        def buf(shape, dtype):
            return torch.empty((generations, *lead, *shape), dtype=dtype,
                               device=device)

        n, p = config.size, config.topo.num_weights
        view = torch.bfloat16 if config.population_dtype == "bf16" \
            else torch.float32
        self.events = SoupEvents(buf((n,), torch.int32),
                                 buf((n,), torch.int32),
                                 buf((n,), torch.float32))
        self.weights = buf((n, p), view)
        self.uids = buf((n,), torch.int32)

    def put(self, g: int, events: SoupEvents, view: torch.Tensor,
            uids: torch.Tensor) -> None:
        for out, e in zip(self.events, events):
            out[g] = e.reshape(out.shape[1:])
        self.weights[g] = view.reshape(self.weights.shape[1:])
        self.uids[g] = uids.reshape(self.uids.shape[1:])

    def result(self):
        return self.events, self.weights, self.uids


def _lineage_caps(n: int, config, capacity: int) -> Tuple[int, int, int]:
    """Per-generation edge-row widths (attack, learn, respawn) of an
    ``n``-particle population (``_lineage_caps``, ``soup.py:1004`` of the
    JAX package): the Binomial bound for the gated phases, full width
    (clipped to the window) for respawn storms, 0 for a phase the config
    turns off, which removes its block (``dynamics.record_step``)."""
    from .telemetry.dynamics import edge_capacity

    return (min(edge_capacity(n, config.attacking_rate), capacity)
            if config.attacking_rate > 0 else 0,
            min(edge_capacity(n, config.learn_from_rate), capacity)
            if config.learn_from_rate > 0 else 0,
            min(n, capacity)
            if (config.remove_divergent or config.remove_zero) else 0)


class _Meters:
    """The ``metrics=`` / ``health=`` / ``lineage=`` carries of one
    population (a soup, or one type of a mixed soup) on its device, folded
    once a generation; each reads the generation's record and gates and
    writes nothing the run returns.  With a ``lineage_state`` (a soup's;
    a mixed soup chains its types' carries through one shared window
    itself) ``lineage`` is the (carry, window, (caps, capacity)) that
    each generation's ``record_step`` advances."""

    def __init__(self, config, topo: Topology, device, metrics: bool,
                 health: bool, lineage_state=None,
                 lineage_capacity: int = 0):
        from .telemetry.device import zero_health, zero_soup_metrics
        from .telemetry.dynamics import zero_window

        self.config, self.topo = config, topo
        self.m = zero_soup_metrics(device) if metrics else None
        self.h = zero_health(device) if health else None
        self.lineage = None
        if lineage_state is not None:
            self.lineage = (lineage_state, zero_window(lineage_capacity,
                                                       device),
                            (_lineage_caps(config.size, config,
                                           lineage_capacity),
                             lineage_capacity))

    def fold(self, action: torch.Tensor, loss: torch.Tensor,
             view: Optional[torch.Tensor], axis: int) -> None:
        """One generation's event record and stored view (read for
        health)."""
        from .telemetry.device import accumulate_health, accumulate_soup_metrics

        if self.m is not None:
            self.m = accumulate_soup_metrics(self.m, action.reshape(-1),
                                             loss.reshape(-1))
        if self.h is not None:
            self.h = accumulate_health(self.h, view, axis,
                                       self.config.epsilon)

    def advance(self, lin_win) -> None:
        self.lineage = tuple(lin_win) + self.lineage[2:]

    def outputs(self, w: torch.Tensor, scales, axis: int) -> tuple:
        """The carries in the JAX package's order, the window closed on
        the final stored population ``w`` (``_close_window``)."""
        out = tuple(c for c in (self.m, self.h) if c is not None)
        if self.lineage is not None:
            lin, win = self.lineage[:2]
            lin, stats = _close_window(self.config, self.topo, lin, w,
                                       scales, axis)
            out += ((lin, win, stats),)
        return out


def _close_window(config, topo: Topology, lin, w: torch.Tensor, scales,
                  axis: int):
    """(labelled lineage carry, ``FixpointStats``) of a stored population
    ``w`` ((P, N) with ``axis=0``, else (N, P)), self-applied in float32
    as the JAX package's window close computes it per layout:
    ``apply_popmajor`` (K6 for a recurrent particle on its route)
    population-major, the row-major transform row-major (for the
    recurrent particle they differ in the last bits)."""
    from .telemetry.dynamics import close_window

    wc = _upcast(config, w, scales, paxis=-1 if axis == 0 else 0)
    fw = apply_popmajor(topo, wc, wc) if axis == 0 \
        else apply_to_weights(topo, wc, wc)
    return close_window(lin, wc, fw, axis, config.epsilon)


def _check_lineage_state(lin, n: int, device, lead: tuple = ()) -> None:
    shape = (*lead, n)
    if tuple(lin.pid.shape) != shape or lin.pid.device != device:
        raise ValueError(f"lineage_state must hold {shape} tensors on "
                         f"{device}, got {tuple(lin.pid.shape)} on "
                         f"{lin.pid.device}")


def stack_carries(items: Sequence):
    """K same-shaped carries or states (tensors, or named tuples and
    tuples of them, nested) as one, each tensor stacked on a new leading
    trial axis; the generators of K states become the stacked state's
    tuple ``key`` and a ``None`` field stays ``None``."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Generator):   # a stacked state's key
        return tuple(items)
    if isinstance(first, torch.Tensor):
        return torch.stack(list(items))
    parts = [stack_carries(xs) for xs in zip(*items)]
    return type(first)(*parts) if hasattr(first, "_fields") \
        else type(first)(parts)


def trial_carry(tree, t: int):
    """Trial ``t``'s slice of a stacked carry (``stack_carries``)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor) or (
            tree and isinstance(tree[0], torch.Generator)):
        return tree[t]
    parts = [trial_carry(x, t) for x in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") \
        else type(tree)(parts)


def evolve(config: SoupConfig, state: SoupState, generations: int = 1,
           record: bool = False, metrics: bool = False,
           health: bool = False, lineage: bool = False,
           lineage_state=None, lineage_capacity: int = 4096):
    """Evolve ``generations`` steps (``_evolve``, ``soup.py:1020-1170`` of
    the JAX package); ``state`` is left as it was.  The row-major
    population stays (N, P), or (B, N, P) for a stacked state; the
    population-major one is kept (P, N) between generations (one transpose
    at entry and one at exit).

    With ``record=True`` also returns (SoupEvents stacked (G, N), weights
    (G, N, P) in the stored view, uids (G, N)) (a stacked state: (G, B, N)
    and (G, B, N, P)), preallocated on the population's device; an int8
    population records its dequantized float32 view.

    The device telemetry carries (``telemetry``), folded once a
    generation on the population's device with no read on the host, the
    evolved state bit for bit the unmetered run's.  A stacked (row-major)
    state folds one carry per trial from the trial's own slice and
    returns each with a leading trial axis (``stack_carries``), trial b's
    slice bitwise its solo run's carry; its ``lineage_state`` is stacked
    the same way (pids minted per trial):

      * ``metrics=True``: a ``telemetry.device.SoupMetrics`` (the action
        histogram and summed train loss of the event record);
      * ``health=True``: a ``telemetry.device.HealthStats`` from each
        generation's stored view (NaN/Inf and zero-collapse counts, the
        weight-norm sketch);
      * ``lineage=True`` (parallel mode; ``lineage_state`` the persistent
        ``telemetry.dynamics.LineageState``, from ``seed_lineage``): the
        triple (advanced lineage state, the window's ``LineageWindow`` of
        ``lineage_capacity`` edge rows, the end-of-window
        ``FixpointStats``).  The window closes on the float32 population's
        self-application as the JAX package computes it per layout:
        ``apply_popmajor`` (K6 for a recurrent particle on its route) in
        the population-major layout, the row-major transform in the
        row-major one.

    Returns ``final``, then the record, then the metrics, health and
    lineage carries, those asked for, in that order (``final`` alone if
    none is)."""
    _check_config(config)
    if lineage:
        if config.mode != "parallel":
            raise ValueError(
                "lineage=True rides the parallel step's phase gates; "
                f"mode={config.mode!r} is unsupported")
        if lineage_state is None:
            raise ValueError("lineage=True needs lineage_state= (seed one "
                             "with telemetry.dynamics.seed_lineage)")
    metered = metrics or health or lineage

    def lone_meters():
        """The carries of a lone (unstacked) soup, or None."""
        if not metered:
            return None
        dev = state.weights.device
        if lineage:
            _check_lineage_state(lineage_state, config.size, dev)
        return _Meters(config, config.topo, dev, metrics, health,
                       lineage_state if lineage else None, lineage_capacity)

    rec = None
    if config.mode == "sequential":
        state = _sequential(config, state)
        meters = lone_meters()
        if record:
            rec = _Record(config, generations, (), state.weights.device)
        for g in range(generations):
            state, events = _evolve_sequential(config, state)
            if record:
                rec.put(g, events, state.weights, state.uids)
            if meters is not None:
                meters.fold(events.action, events.loss, state.weights, -1)
        final = state
        carries = () if meters is None else meters.outputs(state.weights,
                                                           None, -1)
    elif config.layout == "popmajor":
        wT = _popmajor(config, state)
        meters = lone_meters()
        state = _forked(state)
        if record:
            rec = _Record(config, generations, (), wT.device)
        for g in range(generations):
            out = _evolve_parallel_popmajor(
                config, state, wT,
                lineage=None if meters is None else meters.lineage)
            state, events, wT = out[:3]
            view = _stored_view(config, wT, state.scales, paxis=-1) \
                if (health or record) else None
            if record:
                rec.put(g, events, view.t(), state.uids)
            if meters is not None:
                meters.fold(events.action, events.loss, view, 0)
                if lineage:
                    meters.advance(out[3:])
        final = state._replace(weights=wT.t().contiguous())
        carries = () if meters is None else meters.outputs(wT, state.scales,
                                                           0)
    else:
        trials, is_stacked = _stacked(config, _forked(state))
        b = len(trials.key)
        dev = trials.weights.device
        if record:
            lead = (b,) if is_stacked else ()
            rec = _Record(config, generations, lead, dev)
        per_trial = []   # one _Meters per trial, each folding its slice
        if metered:
            lins = [None] * b
            if lineage:
                _check_lineage_state(lineage_state, config.size, dev,
                                     (b,) if is_stacked else ())
                lins = [trial_carry(lineage_state, t) for t in range(b)] \
                    if is_stacked else [lineage_state]
            per_trial = [_Meters(config, config.topo, dev, metrics, health,
                                 lins[t], lineage_capacity)
                         for t in range(b)]
        for g in range(generations):
            out = _rowmajor_generation(
                config, trials,
                lineage=[m.lineage for m in per_trial] if lineage else None)
            trials, events = out[:2]
            view = _rows_view(config, trials) if (health or record) else None
            if record:
                rec.put(g, events, view, trials.uids)
            for t, m in enumerate(per_trial):
                # the trial's losses copied out of the (B, N) record: the
                # sum reads the same buffer layout as the solo run's
                m.fold(events.action[t], events.loss[t].clone(),
                       view[t] if health else None, -1)
                if lineage:
                    m.advance(out[2][t])
        final = _unstacked(trials, is_stacked)
        outs = [m.outputs(trials.weights[t],
                          None if trials.scales is None else trials.scales[t],
                          -1)
                for t, m in enumerate(per_trial)]
        carries = () if not outs else (
            stack_carries(outs) if is_stacked else outs[0])
    out = (final,) + ((rec.result(),) if record else ()) + carries
    return out if len(out) > 1 else final


def probe_dynamics(topo: Topology, weights: torch.Tensor,
                   epsilon: float = DEFAULT_EPSILON):
    """One-shot fixpoint census of a row-major (N, P) population already in
    hand (``probe_dynamics``, ``soup.py:1174`` of the JAX package), on its
    device: every particle self-applied once and labelled, no pids, no
    edges, the transitions from the unknown row."""
    from .telemetry.dynamics import BASIN_UNKNOWN, fixpoint_stats

    fw = apply_to_weights(topo, weights, weights)
    prev = torch.full((weights.shape[0],), BASIN_UNKNOWN, dtype=torch.int32,
                      device=weights.device)
    return fixpoint_stats(weights, fw, -1, epsilon, prev)[1]


def _rows_view(config: SoupConfig, state: SoupState) -> torch.Tensor:
    """The stored view of a row-major population, stacked or not."""
    w = state.weights
    p = w.shape[-1]
    scales = None if state.scales is None else state.scales.reshape(-1)
    return _stored_view(config, w.reshape(-1, p), scales).reshape(w.shape)


def count(config: SoupConfig, state: SoupState) -> torch.Tensor:
    """(5,) class histogram of the current population (``Soup.count``,
    ``soup.py:89-103``), classified from its stored view; over every
    particle of every trial for a stacked state."""
    view = _rows_view(config, state)
    return count_classes(classify_batch(
        config.topo, view.reshape(-1, view.shape[-1]), config.epsilon))
