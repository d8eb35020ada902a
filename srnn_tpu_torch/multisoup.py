"""Heterogeneous soups: mixed-type populations with cross-type attacks;
port of ``srnn_tpu/multisoup.py``, in both of its layouts.

The particles belong to typed subpopulations (one ``Topology`` each), and
any particle may attack any other: a recurrent net rewriting a weightwise
net's weights and so on (``nets/cross.py`` row-major,
``ops/popmajor_cross.py`` population-major).  Each generation follows the
homogeneous soup phase for phase (attack -> learn_from -> train ->
respawn, last-action-wins events), with the JAX package's typed choices:

  * attack: one global gate and target over all n = sum(N_t) particles,
    resolved last-attacker-wins; then for every (victim type, attacker
    type) pair a full-width cross apply, selected by the attacker-type mask
    (``multisoup.py:148-173`` and ``:311-336``);
  * learn_from: the gate is a slice of one global uniform over n, the
    counterpart is drawn from the learner's OWN type (imitation needs the
    teacher's sample space to match);
  * learn, train and respawn run per type: on the type's route
    (``ops/popmajor.train_route``: its SGD kernel, K2, K4 or K5, inside the
    kernels' envelope; the weightwise full batch's hand-derived step;
    the autograd chains for every other type, so that an elu type sits
    beside kernel types), the predicates and the fresh select, or, on the
    fused route, as one launch of the type's generation kernel (K3) with no
    attack operand (the cross-type attack already ran) and the imitation
    columns gathered post-attack;
  * respawned uids come in blocks type by type: type t's base is
    ``next_uid`` plus the deaths of the types before it.

Layouts (``layout``):

  * ``'rowmajor'`` (the default, as in the JAX package): every type stays
    (N_t, P_t) between generations.  The attack runs ``nets/cross.py``'s
    row-major transforms in plain torch (explicit multiply-add chains, so
    the card and the CPU round alike; the recurrent attackers' recurrence
    too, so no generation launches K6), and each type's learn, train and
    respawn run on its (P_t, N_t) transpose, one transpose in and one out:
    K2/K4/K5 twice a generation per type on the card.  The lane-kernel
    spellings (``generation_impl='fused'``, ``train_impl`` or
    ``apply_impl='kernel'``) raise, as the JAX package's row-major step
    does.
  * ``'popmajor'``: every type is a (P_t, N_t) lane matrix between
    generations (``evolve_multi`` transposes once per type at entry and
    exit); the recurrent attackers run K6 once per victim type a
    generation where K6 takes the pair (``apply_route``), its plain
    version elsewhere; ``generation_impl`` 'phases' or 'fused', the latter
    per type where the generation kernel takes it and the phases
    elsewhere, as the JAX package falls back per type
    (``resolved_generation_impl``).  A random shuffler is refused here, as
    in the JAX package.

The types share ``population_dtype``: weights upcast to float32 at
generation entry and round once at exit, as in ``soup.py`` (the fused
route's K3 runs its float32 bodies here).  The metrics, health and lineage
carries of ``evolve_multi`` are not ported.

Randomness: as in ``soup.py``, the state carries a ``torch.Generator``
(``key``) and ``evolve_multi_step`` draws from a copy of it, unless the
caller hands it the generation's draws (``MultiSoupDraws``; the tests hand
over the JAX package's, which both of its layouts draw alike).  The draw
law and structure are the JAX package's: the recurrent type's fresh
replacements are drawn kernel by kernel (``init.fresh_lanes``).
"""

from typing import NamedTuple, Optional, Tuple

import torch

from .engine import classify_batch
from .init import fresh_lanes, init_population, make_generator
from .nets.cross import cross_apply
from .ops.cuda_generation import fused_kernel_supported, generation_popmajor
from .ops.popmajor import DEFAULT_LR, apply_route, resolved_train_impl
from .ops.popmajor_cross import cross_apply_popmajor
from .ops.predicates import DEFAULT_EPSILON, count_classes
from .soup import (SoupConfig, _check_config, _downcast, _event_record,
                   _forked, _learn_train_respawn, _on, _pop_dtype,
                   _respawn_uids, _stored_view, _upcast)
from .topology import Topology


class MultiSoupConfig(NamedTuple):
    """Mixed-soup hyperparameters; the fields of the JAX package's
    ``MultiSoupConfig``, with its defaults ('xla' reads 'plain' here).
    ``train_impl`` 'plain' routes each type (``resolved_train_impls``);
    'kernel' asks for the kernels for every type and raises upfront where a
    type is outside their envelope.  ``apply_impl`` 'kernel' asks for K6
    for every recurrent attacker and victim type.  Their 'kernel'
    spellings are refused by the row-major layout and beside
    ``generation_impl='fused'``, as the JAX package refuses 'pallas'
    there."""
    topos: Tuple[Topology, ...]
    sizes: Tuple[int, ...]
    attacking_rate: float = 0.1
    learn_from_rate: float = 0.1
    train: int = 0
    learn_from_severity: int = 1
    remove_divergent: bool = False
    remove_zero: bool = False
    epsilon: float = DEFAULT_EPSILON
    lr: float = DEFAULT_LR
    train_mode: str = "sequential"
    layout: str = "rowmajor"            # 'rowmajor' | 'popmajor'
    respawn_draws: str = "perparticle"
    train_impl: str = "plain"           # 'plain' | 'kernel' (routes)
    apply_impl: str = "plain"           # 'plain' | 'kernel' (K6)
    generation_impl: str = "phases"     # 'phases' | 'fused'
    population_dtype: str = "f32"       # 'f32' | 'bf16' | 'int8'

    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for s in self.sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    def type_config(self, t: int) -> SoupConfig:
        """Type ``t``'s view as a homogeneous soup config."""
        return SoupConfig(
            topo=self.topos[t], size=self.sizes[t],
            attacking_rate=self.attacking_rate,
            learn_from_rate=self.learn_from_rate, train=self.train,
            learn_from_severity=self.learn_from_severity,
            remove_divergent=self.remove_divergent,
            remove_zero=self.remove_zero, epsilon=self.epsilon, lr=self.lr,
            train_mode=self.train_mode, layout=self.layout,
            respawn_draws=self.respawn_draws, train_impl=self.train_impl, apply_impl=self.apply_impl,
            generation_impl=self.generation_impl,
            population_dtype=self.population_dtype)


class MultiSoupState(NamedTuple):
    weights: Tuple[torch.Tensor, ...]  # per type (N_t, P_t), storage dtype
    uids: Tuple[torch.Tensor, ...]     # per type (N_t,) int32
    next_uid: torch.Tensor             # () int32
    time: torch.Tensor                 # () int32
    key: torch.Generator
    scales: Optional[Tuple[torch.Tensor, ...]] = None  # int8: per type (N_t,)


class MultiSoupEvents(NamedTuple):
    action: Tuple[torch.Tensor, ...]
    counterpart: Tuple[torch.Tensor, ...]
    loss: Tuple[torch.Tensor, ...]


class MultiSoupDraws(NamedTuple):
    """One mixed generation's random numbers, for either layout.  Tensors
    or numpy arrays; the attack (learn) fields are read only when that
    phase is on.  ``fresh`` is lane-major in both layouts: the JAX
    package's row-major ``fresh_rows`` transposed, its population-major
    ``fresh_lanes`` as it is."""
    attack_gate: object  # (n,) bool over all particles
    attack_tgt: object   # (n,) int, global victim index per attacker
    learn_gate: object   # (n,) bool over all particles
    learn_tgt: tuple     # per type (N_t,) int, counterpart within the type
    fresh: tuple         # per type (P_t, N_t) float32 respawn replacements


def _check_multi(config: MultiSoupConfig) -> None:
    """The JAX package's ``_evolve_multi_step`` checks (``:451-483``) and
    the limits of this port (each type as a homogeneous soup config, on
    the route it resolves to, as the JAX package falls back per type)."""
    if config.layout not in ("rowmajor", "popmajor"):
        raise ValueError(f"unknown multisoup layout {config.layout!r}")
    if config.layout == "rowmajor":
        for field in ("train_impl", "apply_impl"):
            if getattr(config, field) == "kernel":
                raise ValueError(
                    f"{field}='kernel' is the popmajor lane kernel; the "
                    f"row-major multisoup needs {field}='plain'")
        if config.generation_impl == "fused":
            raise ValueError(
                "generation_impl='fused' is the popmajor lane megakernel; "
                "the row-major multisoup needs generation_impl='phases'")
    if len(config.topos) != len(config.sizes) or not config.topos:
        raise ValueError("topos and sizes must be non-empty and of one "
                         "length")
    if any(s < 1 for s in config.sizes):
        raise ValueError(f"every type needs at least one particle, got "
                         f"sizes {config.sizes}")
    if config.generation_impl == "fused" and (
            config.train_impl == "kernel" or config.apply_impl == "kernel"):
        raise ValueError(
            "generation_impl='fused' already fuses the per-type SGD "
            "chains; use train_impl='plain' and apply_impl='plain' (the "
            "per-phase kernel legs are subsumed)")
    if config.layout == "popmajor" and any(
            t.shuffler == "random" for t in config.topos):
        raise ValueError(
            "layout='popmajor' requires shuffler='not' on every topo "
            "(per-lane permutation — use layout='rowmajor')")
    for t, topo in enumerate(config.topos):
        # the attack is checked for every (attacker, victim) pair below
        _check_config(config.type_config(t)._replace(
            generation_impl=resolved_generation_impl(config, topo),
            apply_impl="plain"))
    if config.apply_impl == "kernel":
        for att in config.topos:
            for vic in config.topos:
                if att.variant == "recurrent" and apply_route(
                        att, vic.num_weights) != "kernel":
                    raise ValueError(
                        "apply_impl='kernel' runs every recurrent attack on "
                        "K6: an attacker with an output-expressible "
                        "activation, attacker and victim of up to 64 "
                        f"weights; the attacker ({att.activation}, P = "
                        f"{att.num_weights}) on a victim of "
                        f"{vic.num_weights} needs apply_impl='plain'")


def fused_supported_multi(config: MultiSoupConfig) -> bool:
    """Would ``generation_impl='fused'`` be a valid spelling of this mixed
    config?  (Population-major only, as in the JAX package.)"""
    if config.layout != "popmajor":
        return False
    try:
        _check_multi(config._replace(generation_impl="fused"))
    except ValueError:
        return False
    return True


def resolved_train_impls(config: MultiSoupConfig) -> str:
    """The route each type's train phase takes, as the JAX package's
    mega_multisoup writes it in its run header
    (``weightwise=autograd,aggregating=kernel,...``;
    ``ops/popmajor.resolved_train_impl``), 'fused' for a type that the
    fused route runs on its generation kernel."""
    return ",".join(
        f"{t.variant}=" + ("fused" if resolved_generation_impl(config, t)
                           == "fused" else resolved_train_impl(
                               t, config.train_mode, config.train_impl,
                               config.layout))
        for t in config.topos)


def resolved_generation_impl(config: MultiSoupConfig,
                             topo: Topology) -> str:
    """The generation route type ``topo`` takes: 'fused' where the config
    asks for it and the generation kernel takes the topology
    (``fused_kernel_supported``), else 'phases', per type, as the JAX
    package falls back (``multisoup.resolved_generation_impl``)."""
    return "fused" if (config.generation_impl == "fused" and
                       fused_kernel_supported(topo, config.train_mode)) \
        else "phases"


def seed_multi(config: MultiSoupConfig, seed: int,
               device="cuda") -> MultiSoupState:
    """Create the typed populations (``multisoup.seed_multi``) on
    ``device``, type by type from one generator seeded with ``seed``; uids
    are global, type t holding ``offsets[t] .. offsets[t + 1] - 1``."""
    _check_multi(config)
    gen = make_generator(seed, device)
    dev = gen.device
    weights, uids, scales = [], [], []
    offs = config.offsets
    for t, topo in enumerate(config.topos):
        w = init_population(topo, gen, config.sizes[t], dev)
        w, sc = _downcast(config, w)
        weights.append(w)
        scales.append(sc)
        uids.append(torch.arange(offs[t], offs[t + 1], dtype=torch.int32,
                                 device=dev))
    return MultiSoupState(
        weights=tuple(weights), uids=tuple(uids),
        next_uid=torch.tensor(config.total, dtype=torch.int32, device=dev),
        time=torch.tensor(0, dtype=torch.int32, device=dev), key=gen,
        scales=tuple(scales) if config.population_dtype == "int8" else None)


def draw_multi(config: MultiSoupConfig, gen: torch.Generator,
               device) -> MultiSoupDraws:
    """One mixed generation's draws from ``gen``, in a fixed order."""
    n = config.total
    u_att = torch.rand(n, generator=gen, device=device)
    t_att = torch.randint(0, n, (n,), generator=gen, device=device)
    u_lrn = torch.rand(n, generator=gen, device=device)
    t_lrn = tuple(torch.randint(0, n_t, (n_t,), generator=gen, device=device)
                  for n_t in config.sizes)
    fresh = tuple(fresh_lanes(topo, gen, n_t, config.respawn_draws, device)
                  for topo, n_t in zip(config.topos, config.sizes))
    return MultiSoupDraws(u_att < config.attacking_rate, t_att,
                          u_lrn < config.learn_from_rate, t_lrn, fresh)


def _resolve_draws(config: MultiSoupConfig, state: MultiSoupState, device,
                   draws: Optional[MultiSoupDraws]) -> MultiSoupDraws:
    if draws is None:
        return draw_multi(config, state.key, device)
    n, types = config.total, len(config.topos)
    if len(draws.learn_tgt) != types or len(draws.fresh) != types:
        raise ValueError(f"draws.learn_tgt and draws.fresh need one entry "
                         f"per type ({types})")
    d = MultiSoupDraws(
        _on(draws.attack_gate, device, torch.bool),
        _on(draws.attack_tgt, device, torch.int64),
        _on(draws.learn_gate, device, torch.bool),
        tuple(_on(t, device, torch.int64) for t in draws.learn_tgt),
        tuple(_on(f, device, torch.float32) for f in draws.fresh))
    for name in ("attack_gate", "attack_tgt", "learn_gate"):
        if getattr(d, name).shape != (n,):
            raise ValueError(f"draws.{name} must have shape ({n},)")
    if bool(((d.attack_tgt < 0) | (d.attack_tgt >= n)).any()):
        raise ValueError(f"draws.attack_tgt holds indices outside [0, {n})")
    for t, (topo, n_t) in enumerate(zip(config.topos, config.sizes)):
        tgt = d.learn_tgt[t]
        if tgt.shape != (n_t,) or bool(((tgt < 0) | (tgt >= n_t)).any()):
            raise ValueError(f"draws.learn_tgt[{t}] must be ({n_t},) indices "
                             f"in [0, {n_t})")
        if d.fresh[t].shape != (topo.num_weights, n_t):
            raise ValueError(f"draws.fresh[{t}] must have shape "
                             f"({topo.num_weights}, {n_t})")
    return d


def _attack(config: MultiSoupConfig, ws, d: MultiSoupDraws, dev):
    """The cross-type attack phase on the float32 populations ``ws`` in the
    config's layout: (new ws, attack_gate, attack_tgt).  ``att_idx[v]`` is
    victim v's highest-indexed attacker or -1 (last attacker wins)."""
    n, offs = config.total, config.offsets
    if config.attacking_rate <= 0:
        return (ws, torch.zeros(n, dtype=torch.bool, device=dev),
                torch.zeros(n, dtype=torch.int64, device=dev))
    rowmajor = config.layout == "rowmajor"
    gate, tgt = d.attack_gate, d.attack_tgt
    src = torch.where(gate, torch.arange(n, device=dev), -1)
    att_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    att_idx = att_idx.scatter_reduce(0, tgt, src, "amax", include_self=True)
    new = []
    for b, vic in enumerate(config.topos):
        att_b = att_idx[offs[b]:offs[b + 1]]
        out = ws[b]
        for a, atk in enumerate(config.topos):
            mask = (att_b >= offs[a]) & (att_b < offs[a + 1])
            idx = (att_b - offs[a]).clamp(0, config.sizes[a] - 1)
            if rowmajor:
                attacked = cross_apply(atk, ws[a][idx], vic, ws[b])
                out = torch.where(mask[:, None], attacked, out)
            else:
                attacked = cross_apply_popmajor(atk, ws[a][:, idx], vic,
                                                ws[b])
                out = torch.where(mask[None, :], attacked, out)
        new.append(out)
    return new, gate, tgt


def _type_generation(config: MultiSoupConfig, topo: Topology, wT, fresh,
                     learn_gate, learn_tgt):
    """Learn, train and respawn one type on its (P_t, N_t) lanes: (wT,
    loss, dead_div, dead_zero).  The fused route's generation kernel gets
    no attack operand, and its imitation columns are gathered
    post-attack."""
    if resolved_generation_impl(config, topo) == "phases":
        return _learn_train_respawn(config, topo, wT, fresh, learn_gate,
                                    learn_tgt)
    sgd_learn = config.learn_from_rate > 0 and config.learn_from_severity > 0
    return generation_popmajor(
        topo, wT, fresh, otherT=wT[:, learn_tgt] if sgd_learn else None,
        learn_gate=learn_gate if sgd_learn else None,
        severity=config.learn_from_severity if sgd_learn else 0,
        train=config.train, lr=config.lr,
        remove_divergent=config.remove_divergent,
        remove_zero=config.remove_zero, epsilon=config.epsilon)


def _evolve_multi_generation(config: MultiSoupConfig, state: MultiSoupState,
                             ws, draws: Optional[MultiSoupDraws] = None):
    """One mixed generation on the stored populations ``ws`` in the
    config's layout, (N_t, P_t) row-major or (P_t, N_t) population-major
    (``state.weights`` is carried only for metadata); the JAX package's
    ``_evolve_multi_step`` and ``_evolve_multi_popmajor``.  Returns
    (new_state, events, new stored ws in the same layout)."""
    offs = config.offsets
    rowmajor = config.layout == "rowmajor"
    paxis = 0 if rowmajor else -1
    dev = ws[0].device
    d = _resolve_draws(config, state, dev, draws)
    ws = [_upcast(config, w, None if state.scales is None
                  else state.scales[t], paxis=paxis)
          for t, w in enumerate(ws)]
    ws, attack_gate, attack_tgt = _attack(config, ws, d, dev)

    all_uids = torch.cat(state.uids)
    attack_cp = all_uids[attack_tgt]
    out_ws, out_scales, new_uids = [], [], []
    actions, counterparts, losses = [], [], []
    total_deaths = torch.zeros((), dtype=torch.int32, device=dev)
    for t, topo in enumerate(config.topos):
        n_t, sl = config.sizes[t], slice(offs[t], offs[t + 1])
        if config.learn_from_rate > 0:
            learn_gate, learn_tgt = d.learn_gate[sl], d.learn_tgt[t]
        else:
            learn_gate = torch.zeros(n_t, dtype=torch.bool, device=dev)
            learn_tgt = torch.zeros(n_t, dtype=torch.int64, device=dev)
        # learn, train and respawn on the lanes: a row-major type goes
        # there and back, bitwise as a transpose around each SGD call
        wT = ws[t].t().contiguous() if rowmajor else ws[t]
        wT, loss, dead_div, dead_zero = _type_generation(
            config, topo, wT, d.fresh[t], learn_gate, learn_tgt)

        # uid blocks type by type: base = next_uid + earlier types' deaths
        uids, deaths, death, death_cp = _respawn_uids(
            state.uids[t], state.next_uid + total_deaths, dead_div,
            dead_zero)
        total_deaths = total_deaths + deaths
        action, counterpart = _event_record(
            n_t, attack_gate[sl], attack_cp[sl], learn_gate,
            state.uids[t][learn_tgt], config.train > 0, death, death_cp)

        stored, scales = _downcast(config, wT, paxis=-1)
        out_ws.append(stored.t().contiguous() if rowmajor else stored)
        out_scales.append(scales)
        new_uids.append(uids)
        actions.append(action)
        counterparts.append(counterpart)
        losses.append(loss)

    new_state = MultiSoupState(
        weights=state.weights, uids=tuple(new_uids),
        next_uid=state.next_uid + total_deaths, time=state.time + 1,
        key=state.key,
        scales=tuple(out_scales) if config.population_dtype == "int8"
        else None)
    events = MultiSoupEvents(tuple(actions), tuple(counterparts),
                             tuple(losses))
    return new_state, events, out_ws


def _stored_multi(config: MultiSoupConfig, state: MultiSoupState) -> list:
    """The state's per-type populations, checked, in the config's layout
    (a population-major config transposes each)."""
    dtype = _pop_dtype(config)
    for t, (w, topo, n_t) in enumerate(zip(state.weights, config.topos,
                                           config.sizes)):
        shape = (n_t, topo.num_weights)
        if tuple(w.shape) != shape or w.dtype != dtype:
            raise ValueError(f"state.weights[{t}] must be {dtype} {shape}, "
                             f"got {w.dtype} {tuple(w.shape)}")
    if (state.scales is None) != (config.population_dtype != "int8"):
        raise ValueError("state.scales must hold one (N_t,) float32 vector "
                         "per type for an int8 population, None otherwise")
    if config.layout == "rowmajor":
        return list(state.weights)
    return [w.t().contiguous() for w in state.weights]


def _with_weights(config: MultiSoupConfig, state: MultiSoupState,
                  ws) -> MultiSoupState:
    if config.layout == "popmajor":
        ws = [wT.t().contiguous() for wT in ws]
    return state._replace(weights=tuple(ws))


def evolve_multi_step(config: MultiSoupConfig, state: MultiSoupState,
                      draws: Optional[MultiSoupDraws] = None):
    """One mixed generation.  Returns (new_state, events); ``state`` is
    left as it was.  ``draws`` replaces the generator's draws for this
    generation."""
    _check_multi(config)
    new_state, events, ws = _evolve_multi_generation(
        config, _forked(state), _stored_multi(config, state), draws)
    return _with_weights(config, new_state, ws), events


def evolve_multi(config: MultiSoupConfig, state: MultiSoupState,
                 generations: int = 1) -> MultiSoupState:
    """Evolve ``generations`` mixed steps, every type kept in the config's
    layout between them (population-major: one transpose per type at
    entry and one at exit); ``state`` is left as it was."""
    _check_multi(config)
    ws = _stored_multi(config, state)
    state = _forked(state)
    for _ in range(generations):
        state, _, ws = _evolve_multi_generation(config, state, ws)
    return _with_weights(config, state, ws)


def count_multi(config: MultiSoupConfig,
                state: MultiSoupState) -> torch.Tensor:
    """(T, 5) per-type class histograms, each type classified by its own
    transform from its stored view (the state is row-major in either
    layout)."""
    rows = [count_classes(classify_batch(
                config.topos[t],
                _stored_view(config, state.weights[t],
                             None if state.scales is None
                             else state.scales[t]),
                config.epsilon))
            for t in range(len(config.topos))]
    return torch.stack(rows)
