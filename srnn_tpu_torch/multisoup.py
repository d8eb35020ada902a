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
route's K3 runs its float32 bodies here).  ``evolve_multi`` takes the
device telemetry carries (``metrics=`` / ``health=`` / ``lineage=``, one
per type; see ``soup.evolve``).

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


def _resolve_draws(config: MultiSoupConfig, gen: torch.Generator, device,
                   draws: Optional[MultiSoupDraws]) -> MultiSoupDraws:
    if draws is None:
        return draw_multi(config, gen, device)
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
    config's layout: (new ws, attack_gate, attack_tgt, att_idx).
    ``att_idx[v]`` is victim v's highest-indexed attacker or -1 (last
    attacker wins)."""
    n, offs = config.total, config.offsets
    if config.attacking_rate <= 0:
        return (ws, torch.zeros(n, dtype=torch.bool, device=dev),
                torch.zeros(n, dtype=torch.int64, device=dev),
                torch.full((n,), -1, dtype=torch.int64, device=dev))
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
    return new, gate, tgt, att_idx


def _type_generation(config: MultiSoupConfig, topo: Topology, wT, fresh,
                     learn_gate, learn_tgt, source=None):
    """Learn, train and respawn one type on its (P_t, N_t) lanes: (wT,
    loss, dead_div, dead_zero).  The fused route's generation kernel gets
    no attack operand, and its imitation columns are gathered
    post-attack: from ``wT``, or from ``source(wT)`` (a sharded soup's
    gathered post-attack lanes of the type, ``learn_tgt`` indices into
    them)."""
    if resolved_generation_impl(config, topo) == "phases":
        return _learn_train_respawn(config, topo, wT, fresh, learn_gate,
                                    learn_tgt, source=source)
    sgd_learn = config.learn_from_rate > 0 and config.learn_from_severity > 0
    src = (wT if source is None else source(wT)) if sgd_learn else None
    return generation_popmajor(
        topo, wT, fresh, otherT=src[:, learn_tgt] if sgd_learn else None,
        learn_gate=learn_gate if sgd_learn else None,
        severity=config.learn_from_severity if sgd_learn else 0,
        train=config.train, lr=config.lr,
        remove_divergent=config.remove_divergent,
        remove_zero=config.remove_zero, epsilon=config.epsilon)


def _record_multi_lineage(lins, win, gen, lin_info, lincfg, mesh=None):
    """One mixed generation's lineage bookkeeping (``_record_multi_lineage``,
    ``multisoup.py:176-205`` of the JAX package), run after the whole
    weights loop: per type ``dynamics.record_step`` with mint bases chained
    type-major through one shared counter (the respawn uid blocks' order).
    ``lin_info`` holds per type (att_idx slice, learn_gate, learn_tgt,
    dead); the attacker pids are the start-of-generation ones of every
    type.  Under sharding (``mesh``) the lanes are a rank's and the pid
    tables gathered.  Returns (the per-type carries, all on the shared
    counter, the window)."""
    from .telemetry.dynamics import record_step

    all_pid0 = torch.cat([lin.pid if mesh is None else mesh.gather(lin.pid)
                          for lin in lins])
    running = lins[0].next_pid
    new_lins = []
    for t, (att_b, learn_gate, learn_tgt, dead) in enumerate(lin_info):
        lin_t, win = record_step(
            lins[t]._replace(next_pid=running), win, gen=gen,
            attacked=att_b >= 0, attacker_pid=all_pid0[att_b.clamp(min=0)],
            learn_gate=learn_gate, learn_tgt=learn_tgt, dead=dead,
            caps=lincfg[0][t], capacity=lincfg[1], mesh=mesh)
        running = lin_t.next_pid
        new_lins.append(lin_t)
    return tuple(lin._replace(next_pid=running) for lin in new_lins), win


def _tenant(x, b: int, stacked: bool):
    """Trial ``b``'s slice of a stacked field, or the field of a lone
    soup."""
    return x[b] if stacked else x


def _lanes(parts):
    """Per-tenant lane blocks side by side (a lone block as it is)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def _evolve_multi_generation(config: MultiSoupConfig, state: MultiSoupState,
                             ws, draws: Optional[MultiSoupDraws] = None,
                             lineage=None):
    """One mixed generation on the stored populations ``ws`` in the
    config's layout, (N_t, P_t) row-major or (P_t, N_t) population-major
    (``state.weights`` is carried only for metadata); the JAX package's
    ``_evolve_multi_step`` and ``_evolve_multi_popmajor``.

    A stacked state (row-major; ``key`` the tuple of the K trials'
    generators, every other field with a leading trial axis, ``ws`` per
    type (K, N_t, P_t)) runs its K trials side by side: each trial draws
    from its own generator and attacks within itself, then each type's
    learn, train and respawn run on the K * N_t lanes of all trials at
    once (one launch per type and phase), each trial's learn targets
    offset into its own lanes, and uids, events and lineage are read per
    trial.  ``draws`` (one ``MultiSoupDraws``; a stacked state: one per
    trial) replaces the generators' draws.

    Returns (new_state, events, new stored ws in the same layout), and
    with ``lineage`` (one (lins, win, (per-type caps, capacity)) carry
    per trial) the list of each trial's advanced (lins, win) after
    them."""
    offs = config.offsets
    rowmajor = config.layout == "rowmajor"
    paxis = 0 if rowmajor else -1
    dev = ws[0].device
    stacked = isinstance(state.key, tuple)
    keys = state.key if stacked else (state.key,)
    k = len(keys)

    def scales(t, b):
        return None if state.scales is None \
            else _tenant(state.scales[t], b, stacked)

    # per trial: (draws, attacked ws, gate, tgt, att_idx, attack_cp)
    trials = []
    for b, key in enumerate(keys):
        d = _resolve_draws(config, key, dev,
                           draws[b] if stacked and draws is not None
                           else draws)
        w_b = [_upcast(config, _tenant(w, b, stacked), scales(t, b),
                       paxis=paxis) for t, w in enumerate(ws)]
        w_b, gate, tgt, att_idx = _attack(config, w_b, d, dev)
        all_uids = torch.cat([_tenant(u, b, stacked) for u in state.uids])
        trials.append((d, w_b, gate, tgt, att_idx, all_uids[tgt]))

    zero_deaths = torch.zeros((), dtype=torch.int32, device=dev)
    total_deaths = [zero_deaths] * k
    lin_info = [[] for _ in range(k)]
    out_ws, out_scales, new_uids = [], [], []
    actions, counterparts, losses = [], [], []
    for t, topo in enumerate(config.topos):
        n_t, sl = config.sizes[t], slice(offs[t], offs[t + 1])
        gates, tgts = [], []
        for d, *_ in trials:
            if config.learn_from_rate > 0:
                gates.append(d.learn_gate[sl])
                tgts.append(d.learn_tgt[t])
            else:
                gates.append(torch.zeros(n_t, dtype=torch.bool, device=dev))
                tgts.append(torch.zeros(n_t, dtype=torch.int64, device=dev))
        # learn, train and respawn on the lanes of every trial at once: a
        # row-major type goes there and back, bitwise as a transpose
        # around each SGD call
        wT = _lanes([w_b[t].t().contiguous() if rowmajor else w_b[t]
                     for _, w_b, *_ in trials])
        wT, loss, dead_div, dead_zero = _type_generation(
            config, topo, wT, _lanes([d.fresh[t] for d, *_ in trials]),
            _lanes(gates), _lanes([tg + b * n_t for b, tg in enumerate(tgts)]))

        type_ws, type_scales, type_uids = [], [], []
        type_act, type_cp, type_loss = [], [], []
        for b, (d, _, attack_gate, _, att_idx, attack_cp) in \
                enumerate(trials):
            lanes = slice(b * n_t, (b + 1) * n_t)
            uids0 = _tenant(state.uids[t], b, stacked)
            # uid blocks type by type: base = next_uid + earlier types'
            # deaths, per trial
            uids, deaths, death, death_cp = _respawn_uids(
                uids0, _tenant(state.next_uid, b, stacked) + total_deaths[b],
                dead_div[lanes], dead_zero[lanes])
            total_deaths[b] = total_deaths[b] + deaths
            if lineage is not None:
                lin_info[b].append((att_idx[sl], gates[b], tgts[b],
                                    dead_div[lanes] | dead_zero[lanes]))
            action, counterpart = _event_record(
                n_t, attack_gate[sl], attack_cp[sl], gates[b],
                uids0[tgts[b]], config.train > 0, death, death_cp)
            stored, sc = _downcast(config, wT[:, lanes], paxis=-1)
            type_ws.append(stored.t().contiguous() if rowmajor else stored)
            type_scales.append(sc)
            type_uids.append(uids)
            type_act.append(action)
            type_cp.append(counterpart)
            type_loss.append(loss[lanes])

        def join(parts):
            return torch.stack(parts) if stacked else parts[0]

        out_ws.append(join(type_ws))
        out_scales.append(None if type_scales[0] is None
                          else join(type_scales))
        new_uids.append(join(type_uids))
        actions.append(join(type_act))
        counterparts.append(join(type_cp))
        losses.append(join(type_loss))

    deaths = torch.stack(total_deaths) if stacked else total_deaths[0]
    new_state = MultiSoupState(
        weights=state.weights, uids=tuple(new_uids),
        next_uid=state.next_uid + deaths, time=state.time + 1,
        key=state.key,
        scales=tuple(out_scales) if config.population_dtype == "int8"
        else None)
    events = MultiSoupEvents(tuple(actions), tuple(counterparts),
                             tuple(losses))
    if lineage is None:
        return new_state, events, out_ws
    lin_wins = []
    for b, (lins, win, lincfg) in enumerate(lineage):
        lin_wins.append(_record_multi_lineage(
            lins, win, _tenant(state.time, b, stacked), lin_info[b], lincfg))
    return new_state, events, out_ws, lin_wins


def _stored_multi(config: MultiSoupConfig, state: MultiSoupState) -> list:
    """The state's per-type populations, checked, in the config's layout
    (a population-major config transposes each); a stacked state's keep
    their leading trial axis (row-major only)."""
    dtype = _pop_dtype(config)
    stacked = isinstance(state.key, tuple)
    if stacked:
        check_tenant_stackable_multi(config)
    lead = (len(state.key),) if stacked else ()
    for t, (w, topo, n_t) in enumerate(zip(state.weights, config.topos,
                                           config.sizes)):
        shape = (*lead, n_t, topo.num_weights)
        if tuple(w.shape) != shape or w.dtype != dtype:
            raise ValueError(f"state.weights[{t}] must be {dtype} {shape}, "
                             f"got {w.dtype} {tuple(w.shape)}")
        if tuple(state.uids[t].shape) != shape[:-1]:
            raise ValueError(f"state.uids[{t}] must be {shape[:-1]}, got "
                             f"{tuple(state.uids[t].shape)}")
    if tuple(state.next_uid.shape) != lead:
        raise ValueError(f"state.next_uid must be {lead}, got "
                         f"{tuple(state.next_uid.shape)}")
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


def check_tenant_stackable_multi(config: MultiSoupConfig) -> None:
    """Validate that ``config`` may ride the serve tenant axis (see
    ``soup.check_tenant_stackable``; ``multisoup.py:233`` of the JAX
    package): parallel row-major only, bitwise-equal per tenant to the
    solo run."""
    if config.layout != "rowmajor":
        raise ValueError(
            "tenant stacking requires layout='rowmajor': the popmajor "
            "lane layout's reductions reassociate under the tenant vmap "
            "axis, breaking the bitwise-equal-to-solo contract")


def tenant_stackable_multi(config: MultiSoupConfig) -> bool:
    """Would this mixed config's evolve ride the serve tenant axis?"""
    try:
        check_tenant_stackable_multi(config)
    except ValueError:
        return False
    return True


def evolve_multi_step(config: MultiSoupConfig, state: MultiSoupState,
                      draws: Optional[MultiSoupDraws] = None):
    """One mixed generation.  Returns (new_state, events); ``state`` is
    left as it was.  ``draws`` replaces the generator's draws for this
    generation (a stacked state: one ``MultiSoupDraws`` per trial)."""
    _check_multi(config)
    new_state, events, ws = _evolve_multi_generation(
        config, _forked(state), _stored_multi(config, state), draws)
    return _with_weights(config, new_state, ws), events


def evolve_multi(config: MultiSoupConfig, state: MultiSoupState,
                 generations: int = 1, metrics: bool = False,
                 health: bool = False, lineage: bool = False,
                 lineage_state=None, lineage_capacity: int = 4096):
    """Evolve ``generations`` mixed steps, every type kept in the config's
    layout between them (population-major: one transpose per type at
    entry and one at exit); ``state`` is left as it was.

    The device telemetry carries of ``soup.evolve``, one per type, on the
    population's device, the evolved state bit for bit the unmetered
    run's (``_evolve_multi``, ``multisoup.py:585-750`` of the JAX
    package): ``metrics=True`` a tuple of ``SoupMetrics``; ``health=True``
    a tuple of ``HealthStats`` from each type's stored view;
    ``lineage=True`` (``lineage_state`` one ``LineageState`` per type over
    one pid space, ``telemetry.dynamics.seed_lineage_blocks``) the triple
    (the advanced per-type carries, one shared ``LineageWindow``, per-type
    ``FixpointStats``), each type's window closed on its own
    self-application as the layout computes it.  Returns ``final``, then
    those asked for in that order (``final`` alone if none is).

    A stacked row-major state (``soup.stack_carries`` of K states: the
    generators' tuple in ``key``, a leading trial axis on every other
    field) evolves its K trials as one (``_evolve_multi_generation``) and
    returns every carry with a leading trial axis, trial b's slice
    bitwise its solo run's; its ``lineage_state`` is stacked the same
    way."""
    from .soup import (_Meters, _check_lineage_state, _close_window,
                       _lineage_caps, stack_carries, trial_carry)
    from .telemetry.dynamics import zero_window

    _check_multi(config)
    types = len(config.topos)
    if lineage and (lineage_state is None or len(lineage_state) != types):
        raise ValueError(
            "lineage=True needs lineage_state= (one "
            "telemetry.dynamics.LineageState per type — seed with "
            "seed_lineage over each type's uid block)")
    ws = _stored_multi(config, state)
    stacked = isinstance(state.key, tuple)
    k = len(state.key) if stacked else 1
    lead = (k,) if stacked else ()
    dev = ws[0].device
    meters = [[_Meters(config, topo, dev, metrics, health)
               for topo in config.topos] for _ in range(k)]
    carries = None
    if lineage:
        for lin, n_t in zip(lineage_state, config.sizes):
            _check_lineage_state(lin, n_t, dev, lead)
        lincfg = (tuple(_lineage_caps(n_t, config, lineage_capacity)
                        for n_t in config.sizes), lineage_capacity)
        carries = [(trial_carry(tuple(lineage_state), b) if stacked
                    else tuple(lineage_state),
                    zero_window(lineage_capacity, dev), lincfg)
                   for b in range(k)]
    rowmajor = config.layout == "rowmajor"
    paxis, axis = (0, -1) if rowmajor else (-1, 0)
    state = _forked(state)

    def scales(t, b):
        return None if state.scales is None \
            else _tenant(state.scales[t], b, stacked)

    for _ in range(generations):
        out = _evolve_multi_generation(config, state, ws, lineage=carries)
        state, events, ws = out[:3]
        if lineage:
            carries = [tuple(lw) + c[2:] for lw, c in zip(out[3], carries)]
        for b, row in enumerate(meters):
            for t, m in enumerate(row):
                w_bt = _tenant(ws[t], b, stacked)
                # the trial's losses copied out of the (K, N_t) record:
                # the sum reads the same buffer layout as the solo run's
                m.fold(_tenant(events.action[t], b, stacked),
                       _tenant(events.loss[t], b, stacked).clone(),
                       _stored_view(config, w_bt, scales(t, b), paxis=paxis)
                       if health else None, axis)
    final = _with_weights(config, state, ws)
    outs = []
    for b, row in enumerate(meters):
        per_type = [m.outputs(_tenant(w, b, stacked), scales(t, b), axis)
                    for t, (m, w) in enumerate(zip(row, ws))]
        out_b = tuple(zip(*per_type))
        if lineage:
            lins, win = carries[b][:2]
            closed = [_close_window(config, topo, lin_t,
                                    _tenant(w, b, stacked), scales(t, b),
                                    axis)
                      for t, (topo, lin_t, w) in enumerate(zip(
                          config.topos, lins, ws))]
            out_b += ((tuple(c[0] for c in closed), win,
                       tuple(c[1] for c in closed)),)
        outs.append(out_b)
    carried = (stack_carries(outs) if stacked else outs[0]) if outs[0] \
        else ()
    out = (final,) + tuple(carried)
    return out if len(out) > 1 else final


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
