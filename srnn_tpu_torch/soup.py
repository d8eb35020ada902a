"""The Soup: population dynamics of self-replicating particles; port of the
population-major parallel mode of ``srnn_tpu/soup.py``.

Reference: ``Soup`` (``soup.py:10-108``).  Per generation, per particle:
with p=attacking_rate pick a uniform random other (possibly self) and
*attack* it (overwrite the victim's weights with self applied to them); with
p=learn_from_rate imitate a random other for ``learn_from_severity`` SGD
epochs; run ``train`` self-training epochs; respawn dead particles in place
-- divergent first, then zero -- with fresh uids.  Rates <= 0 disable a
phase.  All particles step together from the start-of-phase state; attack
collisions resolve last-attacker-wins, as in the JAX package.

Scope of this port: all four variants (weightwise, aggregating, fft,
recurrent), ``layout='popmajor'``, ``mode='parallel'``, full-width phases,
the three population dtypes (``population_dtype`` 'f32' | 'bf16' |
'int8'); the weightwise variant in the sequential (batch-1) train mode, the
others in either mode (one sample per epoch makes them one program).  Any
other setting raises.  ``layout`` defaults to 'popmajor' here, the only
layout the port has.  ``generation_impl='fused'`` runs the whole
generation as one launch of the variant's generation kernel;
``generation_impl='phases'`` runs the phases one after another, the train
and learn_from chains on the variant's SGD kernel and the recurrent attack
on its attack kernel.  The population's device picks the route inside each
kernel's wrapper: CUDA tensors launch the kernels, CPU tensors run their
plain versions.  ``train_impl`` and ``apply_impl`` ('plain' | 'kernel', the
JAX package's 'xla' | 'pallas') are kept so that the JAX package's configs
convert; they select nothing here.

Population precision (``soup.py:133-148``, ``:175-247`` of the JAX
package): a 'bf16' population stores bfloat16 weights, an 'int8' one int8
codes with a per-particle float32 scale (``SoupState.scales``).  Every phase
computes in float32 and the stored weights round exactly once per
generation, at its exit.  The phase route upcasts at entry and rounds at
exit; on the fused route a bfloat16 population rides the generation kernel
at storage width (its columns gathered as bfloat16, upcast at load, rounded
at store), and an int8 one is dequantized before the gathers and
re-quantized at the same exit point.  So the two routes round at the same
points and agree bitwise wherever their float32 arithmetic does.

Randomness: the state carries a ``torch.Generator`` (field ``key``), seeded
from an int.  ``evolve_step`` and ``evolve`` draw from a copy of it and hand
the advanced copy back in the new state, so a state, like the JAX package's,
can be evolved twice to the same result.  A caller may instead
hand ``evolve_step`` the generation's draws (``SoupDraws``) -- the tests
hand over the JAX package's own draws.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .engine import classify_batch
from .init import fresh_lanes, init_population, make_generator
from .ops.cuda_generation import fused_kernel_supported, generation_popmajor
from .ops.popmajor import (DEFAULT_LR, apply_popmajor, check_train_mode,
                           learn_epochs_popmajor, train_epochs_popmajor)
from .ops.predicates import (DEFAULT_EPSILON, count_classes, is_diverged,
                             is_zero)
from .topology import Topology

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
    layout: str = "popmajor"
    respawn_draws: str = "perparticle"  # 'perparticle' | 'fused': one law
    train_impl: str = "kernel"          # accepted, selects nothing
    attack_impl: str = "full"
    learn_from_impl: str = "full"
    apply_impl: str = "plain"           # accepted, selects nothing
    generation_impl: str = "phases"     # 'phases' | 'fused'
    population_dtype: str = "f32"


class SoupState(NamedTuple):
    """Population as struct-of-arrays."""
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


def seed(config: SoupConfig, seed: int, device="cuda") -> SoupState:
    """Create the initial population (``Soup.seed``, ``soup.py:45-49``) on
    ``device``, in the storage dtype; ``seed`` seeds the generator the soup
    then carries."""
    _check_config(config)
    gen = make_generator(seed, device)
    w = init_population(config.topo, gen, config.size, gen.device)
    dev = w.device
    w, scales = _downcast(config, w)
    return SoupState(
        weights=w,
        uids=torch.arange(config.size, dtype=torch.int32, device=dev),
        next_uid=torch.tensor(config.size, dtype=torch.int32, device=dev),
        time=torch.tensor(0, dtype=torch.int32, device=dev),
        key=gen, scales=scales)


def _check_config(config: SoupConfig) -> None:
    """The JAX package's ``_check_popmajor`` plus the limits of this port."""
    if config.layout != "popmajor":
        raise ValueError(f"layout={config.layout!r} is not ported; "
                         "srnn_tpu_torch runs layout='popmajor'")
    if config.mode != "parallel":
        raise ValueError(f"mode={config.mode!r} is not ported; "
                         "srnn_tpu_torch runs mode='parallel'")
    _pop_dtype(config)
    if config.topo.shuffler == "random":
        raise ValueError("layout='popmajor' requires shuffler='not'")
    if config.topo.variant == "recurrent" and \
            config.topo.rnn_scan != "sequential":
        raise ValueError(f"rnn_scan={config.topo.rnn_scan!r} is not ported; "
                         "srnn_tpu_torch runs the serial scan")
    check_train_mode(config.topo, config.train_mode)
    if config.respawn_draws not in ("perparticle", "fused"):
        raise ValueError(f"unknown respawn_draws {config.respawn_draws!r}")
    for field in ("attack_impl", "learn_from_impl"):
        if getattr(config, field) != "full":
            raise ValueError(f"{field}={getattr(config, field)!r} is not "
                             "ported; srnn_tpu_torch runs 'full'")
    for field in ("train_impl", "apply_impl"):
        if getattr(config, field) not in ("plain", "kernel"):
            raise ValueError(f"unknown {field} {getattr(config, field)!r}")
    if config.generation_impl not in ("phases", "fused"):
        raise ValueError(
            f"unknown generation_impl {config.generation_impl!r}")
    if not fused_kernel_supported(config.topo, config.train_mode):
        raise ValueError(
            "the soup's kernels need an activation with an "
            "output-expressible derivative (linear/sigmoid/tanh/relu) and "
            f"at most 64 weights; got {config.topo.activation!r}, "
            f"P={config.topo.num_weights}")


def draw(config: SoupConfig, gen: torch.Generator,
         device) -> SoupDraws:
    """One generation's draws from ``gen``, in a fixed order."""
    n = config.size
    u_att = torch.rand(n, generator=gen, device=device)
    t_att = torch.randint(0, n, (n,), generator=gen, device=device)
    u_lrn = torch.rand(n, generator=gen, device=device)
    t_lrn = torch.randint(0, n, (n,), generator=gen, device=device)
    fresh = fresh_lanes(config.topo, gen, n, config.respawn_draws, device)
    return SoupDraws(u_att < config.attacking_rate, t_att,
                     u_lrn < config.learn_from_rate, t_lrn, fresh)


def _on(x, device, dtype) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))  # a copy: the caller's may be read-only
    return x.to(device=device, dtype=dtype).contiguous()


def _resolve_draws(config: SoupConfig, state: SoupState, device,
                   draws: Optional[SoupDraws]) -> SoupDraws:
    if draws is None:
        return draw(config, state.key, device)
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
    (the ``cumsum`` rank); returns (uids, deaths, death action, death
    counterpart)."""
    dead = dead_div | dead_zero
    rank = torch.cumsum(dead.to(torch.int64), 0) - 1
    uids = torch.where(dead, base + rank.to(torch.int32), uids).to(
        torch.int32)
    action = torch.full_like(uids, ACT_NONE)
    action = torch.where(dead_div, ACT_DIV_DEAD, action)
    action = torch.where(dead_zero, ACT_ZERO_DEAD, action)
    return (uids, dead.sum().to(torch.int32), action,
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


def _learn_train_respawn(config, topo: Topology, wT, fresh, learn_gate,
                         learn_tgt):
    """The phase chain after the attack (``soup.py:62-86``): learn_from
    toward the (post-attack) counterparts, train, the respawn predicates
    and the fresh select.  ``config`` is a ``SoupConfig`` or a mixed
    soup's config (the same dynamics fields).  Returns (wT, last train
    loss, dead_div, dead_zero)."""
    n = wT.shape[1]
    dev = wT.device
    if config.learn_from_rate > 0 and config.learn_from_severity > 0:
        learned, _ = learn_epochs_popmajor(
            topo, wT, wT[:, learn_tgt], config.learn_from_severity,
            config.lr, config.train_mode)
        wT = torch.where(learn_gate[None, :], learned, wT)
    if config.train > 0:
        wT, train_loss = train_epochs_popmajor(
            topo, wT, config.train, config.lr, config.train_mode)
    else:
        train_loss = torch.zeros(n, dtype=wT.dtype, device=dev)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    dead_div = is_diverged(wT, axis=0) if config.remove_divergent else none
    dead_zero = (is_zero(wT, config.epsilon, axis=0) & ~dead_div) \
        if config.remove_zero else none
    wT = torch.where((dead_div | dead_zero)[None, :], fresh, wT)
    return wT, train_loss, dead_div, dead_zero


def _evolve_parallel_popmajor(config: SoupConfig, state: SoupState,
                              wT: torch.Tensor,
                              draws: Optional[SoupDraws] = None):
    """One generation on the stored (P, N) population ``wT``
    (``state.weights`` is carried only for metadata).  Returns (new_state,
    events, new stored wT)."""
    if config.generation_impl == "fused":
        return _evolve_fused_popmajor(config, state, wT, draws)
    n = config.size
    topo = config.topo
    dev = wT.device
    wT = _upcast(config, wT, state.scales, paxis=-1)
    d = _resolve_draws(config, state, dev, draws)
    gates = _gates(config, d, n, dev)
    _, _, att_idx, learn_gate, learn_tgt = gates

    # --- attack (soup.py:56-61) -----------------------------------------
    if config.attacking_rate > 0:
        has_attacker = att_idx >= 0
        attacked = apply_popmajor(topo, wT[:, att_idx.clamp(min=0)], wT)
        wT = torch.where(has_attacker[None, :], attacked, wT)

    # --- learn_from, train, respawn (soup.py:62-86) -----------------------
    wT, train_loss, dead_div, dead_zero = _learn_train_respawn(
        config, topo, wT, d.fresh, learn_gate, learn_tgt)
    return _finish(config, state, gates, wT, train_loss, dead_div, dead_zero)


def _evolve_fused_popmajor(config: SoupConfig, state: SoupState,
                           wT: torch.Tensor,
                           draws: Optional[SoupDraws] = None):
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
    d = _resolve_draws(config, state, dev, draws)
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
    return _finish(config, state, gates, wT, train_loss, dead_div, dead_zero)


def _popmajor(config: SoupConfig, state: SoupState) -> torch.Tensor:
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
    return state.weights.t().contiguous()


def _forked(state: SoupState) -> SoupState:
    """The state with a copy of its generator, so that the caller's state
    stays as it was and can be evolved again to the same result."""
    gen = torch.Generator(device=state.key.device)
    gen.set_state(state.key.get_state())
    return state._replace(key=gen)


def evolve_step(config: SoupConfig, state: SoupState,
                draws: Optional[SoupDraws] = None):
    """One generation (``Soup.evolve`` body, ``soup.py:51-87``).  Returns
    (new_state, events); ``state`` is left as it was.  ``draws`` replaces
    the generator's draws for this generation."""
    _check_config(config)
    new_state, events, wT = _evolve_parallel_popmajor(
        config, _forked(state), _popmajor(config, state), draws)
    return new_state._replace(weights=wT.t().contiguous()), events


def evolve(config: SoupConfig, state: SoupState,
           generations: int = 1) -> SoupState:
    """Evolve ``generations`` steps, the population kept (P, N) between
    them (one transpose at entry and one at exit); ``state`` is left as it
    was."""
    _check_config(config)
    wT = _popmajor(config, state)
    state = _forked(state)
    for _ in range(generations):
        state, _, wT = _evolve_parallel_popmajor(config, state, wT)
    return state._replace(weights=wT.t().contiguous())


def count(config: SoupConfig, state: SoupState) -> torch.Tensor:
    """(5,) class histogram of the current population (``Soup.count``,
    ``soup.py:89-103``), classified from its stored view."""
    return count_classes(classify_batch(
        config.topo, _stored_view(config, state.weights, state.scales),
        config.epsilon))
