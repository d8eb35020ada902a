"""The soup sharded over the ranks of a process group; port of
``srnn_tpu/parallel/sharded_soup.py``.

Each rank owns a contiguous block of ``N / D`` lanes of the population
(:class:`~.mesh.SoupMesh`: rank ``r`` holds lanes ``[r * N / D, (r + 1) *
N / D)``) and does all the heavy work of a generation -- the kernels of
its route (K3 once a generation on the fused route; K2, K4 or K5 twice
and the attack's transform or K6 on the phase chain) -- on that block
only.  A ``SoupState`` here holds the rank's block of ``weights``,
``uids`` and ``scales``; ``next_uid``, ``time`` and the generator are
replicated.

  * The generator is replicated: every rank holds one seeded alike and
    draws the same global (N,) gates and targets and, in the
    population-major layout, the same (P, N) fresh draw as the
    single-device soup (``soup.draw``), then takes its block (the JAX
    package's replicated-key contract, ``sharded_soup.py:9-11``).  No
    random number crosses the wire.
  * Counterpart columns (the attackers of the rank's victims, the
    teachers of its learners) come from tiled gathers of the population
    (:meth:`~.mesh.SoupMesh.gather`): one (P, N) gather before the
    attack and, on the phase chain, a second after it, so that learners
    imitate post-attack weights as the single-device chain does.  The
    fused route gathers once: the generation kernel re-applies the
    counterpart's attack itself.  An int8 population gathers codes and
    scales before the attack (dequantizing is per particle, so
    gather-then-dequantize is dequantize-then-gather) and, on the fused
    route, the dequantized float32 columns; a bfloat16 one gathers its
    storage dtype where the single-device route reads it.
  * Respawned uids are the single-device ones: a dead lane's uid is
    ``next_uid`` plus its rank among the dead in global lane order -- the
    deaths of the ranks before it (one gather of per-rank counts) plus
    its local rank (the JAX package gathers the death mask and cumsums
    it, ``:477-486``; the counts give the same ranks).

So the population-major sharded soup, phase chain and fused route, full
and compact, every population dtype, is bitwise the single-device soup
at any world size wherever the kernels' arithmetic is per lane (it is,
for every route the soup runs; on the CPU torch's sigmoid and its column
sums over fewer than 32 lanes round by place, ROADMAP C).  With
``metrics=`` / ``health=`` / ``lineage=`` the carries are folded per rank
and reduced once per :func:`sharded_evolve` call
(``telemetry.device.psum_*``, ``dynamics.psum_fixpoints``), also bitwise
the single-device ones: the loss sum is summed in the single-device order
from each generation's gathered per-lane losses (one gather of N floats a
generation, where training runs), and the health peaks from the
per-generation global counts (the JAX package's peaks are a shard-wise
upper bound).  The lineage window is per rank, concatenated at the
boundary, as in the JAX package; the pids are the single-device ones.

The row-major layout keeps the JAX package's two documented differences
(``sharded_soup.py:23-29``): imitation targets are read from the
start-of-generation gather, not the post-attack population, and the
respawn draws are per rank -- rank ``r`` draws its (P, N / D) replacements
from a generator seeded from the soup generator's seed, the generation and
``r`` (the JAX package folds the device index into the key), so that the
soup generator draws only the gates.  Its attack and train phases are
the single-device ones under matched draws; ``draws=`` takes a rank's
draws (global gates, the rank's own replacements), which is how the tests
hand it the JAX package's.
"""

from typing import Optional

import numpy as np
import torch

from ..engine import classify_batch
from ..init import fresh_lanes
from ..nets.dispatch import apply_to_weights
from ..ops.cuda_generation import generation_popmajor
from ..ops.popmajor import apply_popmajor, learn_epochs_popmajor
from ..ops.predicates import count_classes, is_diverged, is_zero
from ..soup import (SoupConfig, SoupDraws, SoupEvents, SoupState,
                    _attack_capacity, _attack_popmajor_compact,
                    _check_config, _close_window, _downcast, _event_record,
                    _forked, _gates, _learn_train_respawn, _lineage_caps,
                    _on, _pop_dtype, _record_lineage, _resolve_draws,
                    _respawn_uids, _stored_view, _upcast, seed)
from ..train import fit_epochs_flat
from .mesh import SoupMesh, global_device_put


def _check_sharded(config: SoupConfig, mesh: SoupMesh,
                   state: SoupState) -> int:
    """The config's checks and the rank's block shape; returns N / D."""
    _check_config(config)
    if config.mode != "parallel":
        raise ValueError("a sharded soup steps all particles together; "
                         f"mode={config.mode!r} needs one device")
    blk = mesh.block(config.size)
    n_loc = blk.stop - blk.start
    shape = (n_loc, config.topo.num_weights)
    dtype = _pop_dtype(config)
    if tuple(state.weights.shape) != shape or state.weights.dtype != dtype:
        raise ValueError(f"a rank's state.weights must be {dtype} {shape} "
                         f"(its block of the population), got "
                         f"{state.weights.dtype} {tuple(state.weights.shape)}")
    if (state.scales is None) != (config.population_dtype != "int8"):
        raise ValueError("state.scales must be the rank's (N / D,) float32 "
                         "block for an int8 population and None otherwise")
    return n_loc


def _respawn_global(mesh: SoupMesh, uids, next_uid, dead_div, dead_zero):
    """(uids, next_uid, death action, death counterpart) of a rank's lanes
    with the single-device uids: the deaths of the ranks before this one
    offset its local ranks."""
    dead = dead_div | dead_zero
    base, total = mesh.exclusive_prefix(dead.sum(dtype=torch.int32))
    uids, _, action, death_cp = _respawn_uids(uids, next_uid + base,
                                              dead_div, dead_zero)
    return uids, next_uid + total, action, death_cp


def _finish(config: SoupConfig, mesh: SoupMesh, state: SoupState, gates,
            blk: slice, wT, train_loss, dead_div, dead_zero):
    """A rank's stored lanes (rounded once, here), uids, events and new
    state (``soup._finish`` over the rank's block)."""
    wT, scales = _downcast(config, wT, paxis=-1)
    attack_gate, attack_tgt, _, learn_gate, learn_tgt = gates
    uids, next_uid, action, death_cp = _respawn_global(
        mesh, state.uids, state.next_uid, dead_div, dead_zero)
    all_uids = mesh.gather(state.uids)
    act, cp = _event_record(
        blk.stop - blk.start, attack_gate[blk], all_uids[attack_tgt[blk]],
        learn_gate[blk], all_uids[learn_tgt[blk]], config.train > 0, action,
        death_cp)
    new_state = SoupState(state.weights, uids, next_uid, state.time + 1,
                          state.key, scales)
    return new_state, SoupEvents(act, cp, train_loss), wT


def _local_evolve_popmajor(config: SoupConfig, mesh: SoupMesh,
                           state: SoupState, wT_loc: torch.Tensor,
                           draws: Optional[SoupDraws] = None, lineage=None):
    """One population-major generation of a rank's (P, N / D) stored lanes
    ``wT_loc`` (``_local_evolve_popmajor``, ``sharded_soup.py:217``):
    the phase chain, compact included, or the fused route.  ``draws``
    are the generation's global draws.  Returns (new_state, events, new
    stored lanes), and with a ``lineage`` carry the advanced (lin, win)
    after them."""
    if config.generation_impl == "fused":
        return _local_fused_popmajor(config, mesh, state, wT_loc, draws,
                                     lineage)
    n, topo = config.size, config.topo
    dev = wT_loc.device
    blk = mesh.block(n)
    n_loc = wT_loc.shape[1]
    wT = _upcast(config, wT_loc, state.scales, paxis=-1)
    d = _resolve_draws(config, state.key, dev, draws)
    gates = _gates(config, d, n, dev)
    _, _, att_idx, learn_gate, learn_tgt = gates
    att_loc = att_idx[blk]

    # --- attack: the attackers' columns from the start-of-generation
    # gather, in the storage dtype (int8: codes and scales)
    if config.attacking_rate > 0:
        all_s = mesh.gather(state.scales) \
            if config.population_dtype == "int8" else None
        all_wT = _upcast(config, mesh.gather(wT_loc, 1), all_s, paxis=-1)
        has_attacker = att_loc >= 0
        if config.attack_impl == "compact":
            # per-rank capacity over the rank's own lanes; a rank that
            # overflows runs its block at full width for that step
            wT = _attack_popmajor_compact(
                topo, wT, att_loc, has_attacker,
                _attack_capacity(n_loc, config.attacking_rate),
                source=all_wT)
        else:
            attacked = apply_popmajor(topo, all_wT[:, att_loc.clamp(min=0)],
                                      wT)
            wT = torch.where(has_attacker[None, :], attacked, wT)

    # --- learn_from (teachers from the POST-attack gather), train, respawn
    learn_cap = _attack_capacity(n_loc, config.learn_from_rate) \
        if config.learn_from_impl == "compact" else None
    wT, train_loss, dead_div, dead_zero = _learn_train_respawn(
        config, topo, wT, d.fresh[:, blk].contiguous(), learn_gate[blk],
        learn_tgt[blk], learn_cap, source=lambda w: mesh.gather(w, 1))
    out = _finish(config, mesh, state, gates, blk, wT, train_loss, dead_div,
                  dead_zero)
    if lineage is None:
        return out
    return out + _record_lineage(lineage, state.time, att_loc,
                                 learn_gate[blk], learn_tgt[blk],
                                 dead_div | dead_zero, mesh)


def _local_fused_popmajor(config: SoupConfig, mesh: SoupMesh,
                          state: SoupState, wT_loc: torch.Tensor,
                          draws: Optional[SoupDraws] = None, lineage=None):
    """One generation of a rank's lanes as one launch of the generation
    kernel (``_local_fused_popmajor``, ``sharded_soup.py:385``): ONE
    pre-attack gather serves the attackers' and the counterparts' columns
    (the kernel re-applies a counterpart's own attack); an int8
    population is dequantized before it, a bfloat16 one gathered as it is
    stored.  Respawn uids from the global dead rank."""
    n = config.size
    dev = wT_loc.device
    blk = mesh.block(n)
    if config.population_dtype == "int8":
        wT_loc = _upcast(config, wT_loc, state.scales, paxis=-1)
    d = _resolve_draws(config, state.key, dev, draws)
    gates = _gates(config, d, n, dev)
    _, _, att_idx, learn_gate, learn_tgt = gates
    attacking = config.attacking_rate > 0
    sgd_learn = config.learn_from_rate > 0 and config.learn_from_severity > 0
    all_wT = mesh.gather(wT_loc, 1) if (attacking or sgd_learn) else None
    att_loc, lg, lt = att_idx[blk], learn_gate[blk], learn_tgt[blk]

    attackerT = all_wT[:, att_loc.clamp(min=0)] if attacking else None
    otherT = other_attackerT = other_attacked = None
    if sgd_learn:
        otherT = all_wT[:, lt]
        if attacking:
            other_att = att_idx[lt]
            other_attackerT = all_wT[:, other_att.clamp(min=0)]
            other_attacked = other_att >= 0
    wT, train_loss, dead_div, dead_zero = generation_popmajor(
        config.topo, wT_loc, d.fresh[:, blk].contiguous(), attackerT,
        att_loc >= 0 if attacking else None, otherT, other_attackerT,
        other_attacked, lg if sgd_learn else None,
        severity=config.learn_from_severity if sgd_learn else 0,
        train=config.train, lr=config.lr,
        remove_divergent=config.remove_divergent,
        remove_zero=config.remove_zero, epsilon=config.epsilon)
    out = _finish(config, mesh, state, gates, blk, wT, train_loss, dead_div,
                  dead_zero)
    if lineage is None:
        return out
    return out + _record_lineage(lineage, state.time, att_loc, lg, lt,
                                 dead_div | dead_zero, mesh)


def respawn_generator(gen: torch.Generator, generation: int,
                      rank: int) -> torch.Generator:
    """Rank ``rank``'s row-major respawn stream of generation
    ``generation``: a generator on the soup generator's device seeded
    from its seed, the generation and the rank (the JAX package's
    ``fold_in(k_re, d)``).  Reads nothing from the card."""
    state = np.random.SeedSequence(
        [gen.initial_seed(), int(generation), int(rank)]).generate_state(
            1, np.uint64)[0]
    return torch.Generator(device=gen.device).manual_seed(
        int(state >> np.uint64(1)))


def draw_rowmajor(config: SoupConfig, gen: torch.Generator, device,
                  generation: int, mesh: SoupMesh) -> SoupDraws:
    """One row-major generation's draws of a rank: the global gates and
    targets from the replicated generator (in ``soup.draw``'s order,
    without its fresh draw), and the rank's (P, N / D) replacements from
    :func:`respawn_generator`."""
    n = config.size
    dev = gen.device
    u_att = torch.rand(n, generator=gen, device=dev)
    t_att = torch.randint(0, n, (n,), generator=gen, device=dev)
    u_lrn = torch.rand(n, generator=gen, device=dev)
    t_lrn = torch.randint(0, n, (n,), generator=gen, device=dev)
    n_loc = n // mesh.size
    fresh = fresh_lanes(config.topo,
                        respawn_generator(gen, generation, mesh.rank),
                        n_loc, config.respawn_draws, dev)
    return SoupDraws(*(t.to(device) for t in (
        u_att < config.attacking_rate, t_att,
        u_lrn < config.learn_from_rate, t_lrn, fresh)))


def _rank_draws(config: SoupConfig, d: SoupDraws, device,
                n_loc: int) -> SoupDraws:
    """A caller's row-major rank draws, checked: global gates, the rank's
    (P, N / D) replacements."""
    n, p = config.size, config.topo.num_weights
    out = SoupDraws(_on(d.attack_gate, device, torch.bool),
                    _on(d.attack_tgt, device, torch.int64),
                    _on(d.learn_gate, device, torch.bool),
                    _on(d.learn_tgt, device, torch.int64),
                    _on(d.fresh, device, torch.float32))
    for name, t in zip(SoupDraws._fields[:4], out[:4]):
        if t.shape != (n,):
            raise ValueError(f"draws.{name} must have shape ({n},)")
    if out.fresh.shape != (p, n_loc):
        raise ValueError(f"a rank's draws.fresh must have shape "
                         f"({p}, {n_loc})")
    return out


def _local_evolve(config: SoupConfig, mesh: SoupMesh, state: SoupState,
                  generation: int, draws: Optional[SoupDraws] = None,
                  lineage=None):
    """One row-major generation of a rank's (N / D, P) block
    (``_local_evolve``, ``sharded_soup.py:98``).  ``generation`` is the
    absolute generation (the respawn stream's); ``draws`` the rank's
    draws.  Returns (new_state, events), and with ``lineage`` the
    advanced (lin, win)."""
    n, topo = config.size, config.topo
    dev = state.weights.device
    blk = mesh.block(n)
    n_loc = blk.stop - blk.start
    w = _upcast(config, state.weights, state.scales)
    d = draw_rowmajor(config, state.key, dev, generation, mesh) \
        if draws is None else _rank_draws(config, draws, dev, n_loc)
    gates = _gates(config, d, n, dev)
    _, _, att_idx, learn_gate, learn_tgt = gates
    att_loc, lg, lt = att_idx[blk], learn_gate[blk], learn_tgt[blk]
    # one gather: everyone sees the start-of-generation population (the
    # storage dtype on the wire; int8 with its scales)
    all_s = mesh.gather(state.scales) \
        if config.population_dtype == "int8" else None
    all_w = _upcast(config, mesh.gather(state.weights), all_s)

    # --- attack ---------------------------------------------------------
    if config.attacking_rate > 0:
        attacked = apply_to_weights(topo, all_w[att_loc.clamp(min=0)], w)
        w = torch.where((att_loc >= 0)[:, None], attacked, w)
    # --- learn_from: teachers from the start-of-generation gather -------
    if config.learn_from_rate > 0 and config.learn_from_severity > 0:
        learned, _ = learn_epochs_popmajor(
            topo, w.t().contiguous(), all_w[lt].t().contiguous(),
            config.learn_from_severity, config.lr, config.train_mode,
            layout="rowmajor")
        w = torch.where(lg[:, None], learned.t(), w)
    # --- train -----------------------------------------------------------
    w, train_loss = fit_epochs_flat(topo, w, config.train, config.lr,
                                    config.train_mode)
    # --- respawn from the rank's own draws -------------------------------
    none = torch.zeros(n_loc, dtype=torch.bool, device=dev)
    dead_div = is_diverged(w) if config.remove_divergent else none
    dead_zero = (is_zero(w, config.epsilon) & ~dead_div) \
        if config.remove_zero else none
    w = torch.where((dead_div | dead_zero)[:, None], d.fresh.t(), w)
    new_state, events, wT = _finish(config, mesh, state, gates, blk, w.t(),
                                    train_loss, dead_div, dead_zero)
    new_state = new_state._replace(weights=wT.t().contiguous())
    if lineage is None:
        return new_state, events
    return (new_state, events) + _record_lineage(
        lineage, state.time, att_loc, lg, lt, dead_div | dead_zero, mesh)


def sharded_evolve_step(config: SoupConfig, mesh: SoupMesh,
                        state: SoupState, draws: Optional[SoupDraws] = None):
    """One generation with the particle axis sharded over ``mesh``
    (``sharded_evolve_step``, ``sharded_soup.py:519``); ``state`` is the
    rank's block and is left as it was.  Returns (the rank's new state,
    its events).  ``draws`` replaces the generator's draws: the global
    ones (population-major), or the rank's (row-major)."""
    _check_sharded(config, mesh, state)
    state = _forked(state)
    if config.layout == "popmajor":
        new_state, events, wT = _local_evolve_popmajor(
            config, mesh, state, state.weights.t().contiguous(), draws)
        return new_state._replace(weights=wT.t().contiguous()), events
    return _local_evolve(config, mesh, state, int(state.time), draws)


#: the JAX package's buffer-donating spelling; the port donates nothing
sharded_evolve_step_donated = sharded_evolve_step


class _ShardMeters:
    """The ``metrics=`` / ``health=`` / ``lineage=`` carries of a rank's
    lanes, folded once a generation and reduced over the ranks once, in
    :meth:`outputs` (``soup._Meters`` per rank).  Where training can make
    the losses nonzero, each generation's are gathered as it is folded
    and their (N,) sum added to a scalar, the single-device carry's order
    (one gather of N floats a generation; nothing kept across
    generations); the per-generation nonfinite / zero counts (two
    integers a generation) are kept so that the peaks are the global
    ones."""

    def __init__(self, config, topo, mesh: SoupMesh, device, metrics: bool,
                 health: bool, lineage_state=None, lineage_capacity: int = 0,
                 n_loc: int = 0):
        from ..telemetry.device import zero_health, zero_soup_metrics
        from ..telemetry.dynamics import zero_window

        self.config, self.topo, self.mesh = config, topo, mesh
        self.m = zero_soup_metrics(device) if metrics else None
        self.h = zero_health(device) if health else None
        #: the global loss sum in the single-device order (None: the
        #: ranks' sums are reduced instead, every loss being zero)
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=device) \
            if metrics and config.train > 0 else None
        self.counts = []
        self.lineage = None
        if lineage_state is not None:
            self.lineage = (lineage_state,
                            zero_window(lineage_capacity, device),
                            (_lineage_caps(n_loc, config, lineage_capacity),
                             lineage_capacity))

    def fold(self, action, loss, view, axis: int) -> None:
        from ..telemetry.device import (accumulate_health,
                                        accumulate_soup_metrics)

        if self.m is not None:
            self.m = accumulate_soup_metrics(self.m, action, loss)
            if self.loss_sum is not None:
                # the generation's (N,) losses in a buffer of their own,
                # summed as the single-device carry sums them
                self.loss_sum = self.loss_sum + self.mesh.gather(loss).sum(
                    dtype=torch.float32)
        if self.h is not None:
            self.h = accumulate_health(self.h, view, axis,
                                       self.config.epsilon)
            self.counts.append(torch.stack([self.h.nonfinite, self.h.zero]))

    def advance(self, lin_win) -> None:
        self.lineage = tuple(lin_win) + self.lineage[2:]

    def outputs(self, w, scales, axis: int) -> tuple:
        """The reduced carries in the JAX package's order; the lineage
        window closed on the rank's stored lanes ``w``."""
        from ..telemetry.device import psum_health, psum_soup_metrics
        from ..telemetry.dynamics import gather_window, psum_fixpoints

        mesh = self.mesh
        out = ()
        if self.m is not None:
            out += (psum_soup_metrics(self.m, mesh, self.loss_sum),)
        if self.h is not None:
            out += (psum_health(self.h, mesh, torch.stack(self.counts)
                                if self.counts else None),)
        if self.lineage is not None:
            lin, win = self.lineage[:2]
            lin, stats = _close_window(self.config, self.topo, lin, w,
                                       scales, axis)
            out += ((lin, gather_window(win, mesh),
                     psum_fixpoints(stats, mesh)),)
        return out


def sharded_evolve(config: SoupConfig, mesh: SoupMesh, state: SoupState,
                   generations: int = 1, metrics: bool = False,
                   health: bool = False, lineage: bool = False,
                   lineage_state=None, lineage_capacity: int = 4096):
    """Evolve ``generations`` sharded steps (``sharded_evolve``,
    ``sharded_soup.py:576``); ``state`` (the rank's block) is left as it
    was.  The population-major block is kept (P, N / D) between
    generations (one transpose at entry, one at exit).

    The carries (see ``soup.evolve``) are folded per rank and reduced
    once, at the end: ``metrics=True`` the global ``SoupMetrics``,
    ``health=True`` the global ``HealthStats``, ``lineage=True``
    (``lineage_state`` the rank's block of the carry, ``dynamics.
    place_lineage``) the triple (the rank's advanced carry, every rank's
    window side by side, the global ``FixpointStats``).  Returns ``final``
    then those asked for, in that order (``final`` alone if none is)."""
    n_loc = _check_sharded(config, mesh, state)
    if lineage:
        if lineage_state is None:
            raise ValueError("lineage=True needs lineage_state= (seed with "
                             "telemetry.dynamics.seed_lineage, place with "
                             "place_lineage)")
        if tuple(lineage_state.pid.shape) != (n_loc,):
            raise ValueError(f"lineage_state must be the rank's ({n_loc},) "
                             "block (telemetry.dynamics.place_lineage)")
    dev = state.weights.device
    meters = _ShardMeters(config, config.topo, mesh, dev, metrics, health,
                          lineage_state if lineage else None,
                          lineage_capacity, n_loc)
    state = _forked(state)
    if config.layout == "popmajor":
        wT = state.weights.t().contiguous()
        for _ in range(generations):
            out = _local_evolve_popmajor(config, mesh, state, wT,
                                         lineage=meters.lineage)
            state, events, wT = out[:3]
            view = _stored_view(config, wT, state.scales, paxis=-1) \
                if health else None
            meters.fold(events.action, events.loss, view, 0)
            if lineage:
                meters.advance(out[3:])
        final = state._replace(weights=wT.t().contiguous())
        carries = meters.outputs(wT, state.scales, 0)
    else:
        # the respawn streams are keyed by the absolute generation: one
        # read of the counter a call
        t0 = int(state.time)
        for g in range(generations):
            out = _local_evolve(config, mesh, state, t0 + g,
                                lineage=meters.lineage)
            state, events = out[:2]
            view = _stored_view(config, state.weights, state.scales) \
                if health else None
            meters.fold(events.action, events.loss, view, -1)
            if lineage:
                meters.advance(out[2:])
        final = state
        carries = meters.outputs(state.weights, state.scales, -1)
    out = (final,) + carries
    return out if len(out) > 1 else final


#: the JAX package's buffer-donating spelling; the port donates nothing
sharded_evolve_donated = sharded_evolve


def sharded_count(config: SoupConfig, mesh: SoupMesh,
                  state: SoupState) -> torch.Tensor:
    """(5,) global class histogram: the rank's lanes classified from their
    stored view, summed over the ranks (``sharded_count``,
    ``sharded_soup.py:796``)."""
    local = count_classes(classify_batch(
        config.topo, _stored_view(config, state.weights, state.scales),
        config.epsilon))
    return mesh.all_reduce(local)


def _place_key(mesh: SoupMesh, key: torch.Generator) -> torch.Generator:
    """The replicated generator on the rank's device, in the same state."""
    gen = torch.Generator(device=mesh.device)
    gen.set_state(key.get_state())
    return gen


def place_sharded_state(mesh: SoupMesh, state: SoupState) -> SoupState:
    """The rank's part of a full ``SoupState`` every rank holds (seeded or
    restored from a checkpoint): its block of the particle axis, the
    scalars and the generator whole (``place_sharded_state``,
    ``sharded_soup.py:826``)."""
    # a population that does not divide (a checkpoint resumed on another
    # number of processes) raises the fresh start's message
    # (``SoupMesh.block``)
    return SoupState(
        weights=global_device_put(state.weights, mesh, 0),
        uids=global_device_put(state.uids, mesh, 0),
        next_uid=global_device_put(state.next_uid, mesh),
        time=global_device_put(state.time, mesh),
        key=_place_key(mesh, state.key),
        scales=None if state.scales is None
        else global_device_put(state.scales, mesh, 0))


def make_sharded_state(config: SoupConfig, mesh: SoupMesh,
                       seed_) -> SoupState:
    """Seed the whole population on the rank's device from the replicated
    seed (an int, or a generator every rank holds alike) and keep the
    rank's block: the state equals ``soup.seed``'s
    (``make_sharded_state``, ``sharded_soup.py:845``)."""
    mesh.block(config.size)  # divisible, checked before the seed
    return place_sharded_state(mesh, seed(config, seed_, mesh.device))
