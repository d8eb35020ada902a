"""The mixed-type soup sharded over the ranks of a process group; port of
``srnn_tpu/parallel/sharded_multisoup.py``.

Every type's particle axis is sharded over the same mesh: rank ``r`` owns
lanes ``[r * N_t / D, (r + 1) * N_t / D)`` of every type ``t``
(``sizes`` must divide by D).  Cross-type attacks need every victim to
read any attacker's weights, so each generation starts with one gather
per type (the storage dtype; int8 with its scales), after which the
T x T masked cross-apply runs on the rank's victims only.  Then per type,
on the rank's lanes: learn_from toward same-type teachers read from a
gather of the type's POST-attack lanes (both layouts, as the
single-device soup reads them), train and respawn on the type's route --
its SGD kernel (K2, K4, K5) on the phase chain, or one launch of its
generation kernel (K3) on the fused route -- exactly as
``multisoup._evolve_multi_generation`` runs them.

The generator is replicated and draws the single-device soup's draws
(``multisoup.draw_multi``: global gates and targets, every type's (P_t,
N_t) fresh draw), of which each rank takes its block; respawned uids come
in the single-device type-major blocks, each type's ranked over the
global lane order (the deaths of the ranks before this one offset its
local ranks).  So the sharded mixed soup is bitwise the single-device one
in both layouts wherever the per-lane arithmetic is (every route; on the
CPU torch's sigmoid and its column sums over fewer than 32 lanes round by
place, ROADMAP C): integer state exact, weights too.  (The JAX package's sharded mixed soup matches its single-device one
to reassociation tolerance: XLA tiles the row-internal reductions of a
shard's batch differently.)
"""

from typing import Optional

import torch

from ..engine import classify_batch
from ..multisoup import (MultiSoupConfig, MultiSoupDraws, MultiSoupEvents,
                         MultiSoupState, _check_multi, _record_multi_lineage,
                         _resolve_draws, _type_generation, seed_multi)
from ..nets.cross import cross_apply
from ..ops.popmajor_cross import cross_apply_popmajor
from ..ops.predicates import count_classes
from ..soup import (_downcast, _event_record, _forked, _lineage_caps,
                    _pop_dtype, _stored_view, _upcast)
from .mesh import SoupMesh, global_device_put
from .sharded_soup import _ShardMeters, _place_key, _respawn_global


def _type_blocks(sizes, mesh: SoupMesh) -> list:
    """The rank's block of every type, each type's size divisible by the
    mesh's (the JAX package's message otherwise)."""
    for t, n_t in enumerate(sizes):
        if n_t % mesh.size:
            raise ValueError(
                f"type-{t} population {n_t} must be divisible by the "
                f"mesh's {mesh.size} devices (each device owns an equal "
                "shard per type)")
    return [mesh.block(n_t) for n_t in sizes]


def _check_sharded_multi(config: MultiSoupConfig, mesh: SoupMesh,
                         state: MultiSoupState) -> list:
    """The config's checks and every type's block; returns the blocks."""
    _check_multi(config)
    blks = _type_blocks(config.sizes, mesh)
    dtype = _pop_dtype(config)
    for t, (w, topo, blk) in enumerate(zip(state.weights, config.topos,
                                           blks)):
        shape = (blk.stop - blk.start, topo.num_weights)
        if tuple(w.shape) != shape or w.dtype != dtype:
            raise ValueError(f"a rank's state.weights[{t}] must be {dtype} "
                             f"{shape} (its block of the type), got "
                             f"{w.dtype} {tuple(w.shape)}")
    if (state.scales is None) != (config.population_dtype != "int8"):
        raise ValueError("state.scales must hold the rank's block of every "
                         "type's scales for an int8 population, None "
                         "otherwise")
    return blks


def _local_evolve_multi(config: MultiSoupConfig, mesh: SoupMesh,
                        state: MultiSoupState, ws, blks,
                        draws: Optional[MultiSoupDraws] = None,
                        lineage=None):
    """One mixed generation of a rank's stored per-type blocks ``ws``
    ((N_t / D, P_t) row-major or (P_t, N_t / D) population-major): the JAX
    package's ``_local_evolve_multi`` (``sharded_multisoup.py:87``) and
    ``_local_evolve_multi_popmajor`` (``:244``, the K3-per-type route at
    ``:346-375``).  ``draws`` are the generation's global draws.  Returns
    (new_state, events, new stored blocks), and with ``lineage`` (lins,
    win, lincfg) the advanced (lins, win) after them."""
    offs, n = config.offsets, config.total
    rowmajor = config.layout == "rowmajor"
    paxis, lane_dim = (0, 0) if rowmajor else (-1, 1)
    dev = ws[0].device
    int8 = config.population_dtype == "int8"
    d = _resolve_draws(config, state.key, dev, draws)

    def scales(t):
        return None if state.scales is None else state.scales[t]

    # start-of-generation gathers: every type's population (the storage
    # dtype on the wire, int8 with its scales) and its uids
    w_loc = [_upcast(config, w, scales(t), paxis=paxis)
             for t, w in enumerate(ws)]
    all_w = [_upcast(config, mesh.gather(w, lane_dim),
                     mesh.gather(scales(t)) if int8 else None, paxis=paxis)
             for t, w in enumerate(ws)]
    uids_t = [mesh.gather(u) for u in state.uids]
    all_uids = torch.cat(uids_t)

    # --- attack: global gates, the rank's victims of every type ---------
    gate, tgt = d.attack_gate, d.attack_tgt
    att_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if config.attacking_rate > 0:
        src = torch.where(gate, torch.arange(n, device=dev), -1)
        att_idx = att_idx.scatter_reduce(0, tgt, src, "amax",
                                         include_self=True)
    else:
        gate = torch.zeros(n, dtype=torch.bool, device=dev)
        tgt = torch.zeros(n, dtype=torch.int64, device=dev)

    def glob(t):
        """Type t's rank lanes as a slice of the global particle axis."""
        return slice(offs[t] + blks[t].start, offs[t] + blks[t].stop)

    if config.attacking_rate > 0:
        for b, vic in enumerate(config.topos):
            att_b = att_idx[glob(b)]
            out = w_loc[b]
            for a, atk in enumerate(config.topos):
                mask = (att_b >= offs[a]) & (att_b < offs[a + 1])
                idx = (att_b - offs[a]).clamp(0, config.sizes[a] - 1)
                if rowmajor:
                    attacked = cross_apply(atk, all_w[a][idx], vic, w_loc[b])
                    out = torch.where(mask[:, None], attacked, out)
                else:
                    attacked = cross_apply_popmajor(atk, all_w[a][:, idx],
                                                    vic, w_loc[b])
                    out = torch.where(mask[None, :], attacked, out)
            w_loc[b] = out

    next_uid = state.next_uid
    lin_info = []
    out_ws, out_scales, new_uids = [], [], []
    actions, counterparts, losses = [], [], []
    for t, topo in enumerate(config.topos):
        blk, n_loc = blks[t], blks[t].stop - blks[t].start
        if config.learn_from_rate > 0:
            lg, lt = d.learn_gate[glob(t)], d.learn_tgt[t][blk]
        else:
            lg = torch.zeros(n_loc, dtype=torch.bool, device=dev)
            lt = torch.zeros(n_loc, dtype=torch.int64, device=dev)
        wT = w_loc[t].t().contiguous() if rowmajor else w_loc[t]
        wT, loss, dead_div, dead_zero = _type_generation(
            config, topo, wT, d.fresh[t][:, blk].contiguous(), lg, lt,
            source=lambda w: mesh.gather(w, 1))
        # uid blocks type by type: base = next_uid + the earlier types'
        # deaths, each type ranked over the global lane order
        uids, next_uid, death, death_cp = _respawn_global(
            mesh, state.uids[t], next_uid, dead_div, dead_zero)
        if lineage is not None:
            lin_info.append((att_idx[glob(t)], lg, lt, dead_div | dead_zero))
        action, counterpart = _event_record(
            n_loc, gate[glob(t)], all_uids[tgt[glob(t)]], lg, uids_t[t][lt],
            config.train > 0, death, death_cp)
        stored, sc = _downcast(config, wT, paxis=-1)
        out_ws.append(stored.t().contiguous() if rowmajor else stored)
        out_scales.append(sc)
        new_uids.append(uids)
        actions.append(action)
        counterparts.append(counterpart)
        losses.append(loss)

    new_state = MultiSoupState(
        weights=state.weights, uids=tuple(new_uids), next_uid=next_uid,
        time=state.time + 1, key=state.key,
        scales=tuple(out_scales) if int8 else None)
    events = MultiSoupEvents(tuple(actions), tuple(counterparts),
                             tuple(losses))
    if lineage is None:
        return new_state, events, out_ws
    lins, win, lincfg = lineage
    return (new_state, events, out_ws) + _record_multi_lineage(
        lins, win, state.time, lin_info, lincfg, mesh)


def sharded_evolve_multi_step(config: MultiSoupConfig, mesh: SoupMesh,
                              state: MultiSoupState,
                              draws: Optional[MultiSoupDraws] = None):
    """One mixed generation with every type's particle axis sharded
    (``sharded_evolve_multi_step``, ``sharded_multisoup.py:454``);
    ``state`` (the rank's blocks) is left as it was.  Returns (the rank's
    new state, its events)."""
    blks = _check_sharded_multi(config, mesh, state)
    rowmajor = config.layout == "rowmajor"
    ws = [w if rowmajor else w.t().contiguous() for w in state.weights]
    new_state, events, ws = _local_evolve_multi(config, mesh, _forked(state),
                                                ws, blks, draws)
    return new_state._replace(weights=tuple(
        w if rowmajor else w.t().contiguous() for w in ws)), events


#: the JAX package's buffer-donating spelling; the port donates nothing
sharded_evolve_multi_step_donated = sharded_evolve_multi_step


def sharded_evolve_multi(config: MultiSoupConfig, mesh: SoupMesh,
                         state: MultiSoupState, generations: int = 1,
                         metrics: bool = False, health: bool = False,
                         lineage: bool = False, lineage_state=None,
                         lineage_capacity: int = 4096):
    """Evolve ``generations`` sharded mixed steps
    (``sharded_evolve_multi``, ``sharded_multisoup.py:510``), every
    type's block kept in the config's layout between them; ``state`` is
    left as it was.  The per-type carries (``multisoup.evolve_multi``)
    are folded per rank and reduced once, at the end: ``metrics=True`` a
    tuple of global ``SoupMetrics``, ``health=True`` of global
    ``HealthStats``, ``lineage=True`` (``lineage_state`` the rank's block
    of every type's carry, ``dynamics.place_lineage``) the triple (the
    rank's advanced per-type carries, every rank's window side by side,
    the global per-type ``FixpointStats``).  Returns ``final`` then those
    asked for, in that order."""
    from ..soup import _close_window
    from ..telemetry.dynamics import gather_window, psum_fixpoints, zero_window

    blks = _check_sharded_multi(config, mesh, state)
    types = len(config.topos)
    if lineage and (lineage_state is None or len(lineage_state) != types):
        raise ValueError(
            "lineage=True needs lineage_state= (one "
            "telemetry.dynamics.LineageState per type, the rank's block: "
            "seed_lineage_blocks, then place_lineage)")
    rowmajor = config.layout == "rowmajor"
    paxis, axis = (0, -1) if rowmajor else (-1, 0)
    dev = state.weights[0].device
    meters = [_ShardMeters(config, topo, mesh, dev, metrics, health)
              for topo in config.topos]
    carry = None
    if lineage:
        lincfg = (tuple(_lineage_caps(blk.stop - blk.start, config,
                                      lineage_capacity) for blk in blks),
                  lineage_capacity)
        carry = (tuple(lineage_state), zero_window(lineage_capacity, dev),
                 lincfg)
    state = _forked(state)
    ws = [w if rowmajor else w.t().contiguous() for w in state.weights]

    def scales(t):
        return None if state.scales is None else state.scales[t]

    for _ in range(generations):
        out = _local_evolve_multi(config, mesh, state, ws, blks,
                                  lineage=carry)
        state, events, ws = out[:3]
        if lineage:
            carry = tuple(out[3:]) + carry[2:]
        for t, m in enumerate(meters):
            m.fold(events.action[t], events.loss[t],
                   _stored_view(config, ws[t], scales(t), paxis=paxis)
                   if health else None, axis)
    final = state._replace(weights=tuple(
        w if rowmajor else w.t().contiguous() for w in ws))
    per_type = [m.outputs(w, scales(t), axis)
                for t, (m, w) in enumerate(zip(meters, ws))]
    out = (final,) + tuple(zip(*per_type))
    if lineage:
        lins, win = carry[:2]
        closed = [_close_window(config, topo, lin_t, w, scales(t), axis)
                  for t, (topo, lin_t, w) in enumerate(zip(
                      config.topos, lins, ws))]
        out += ((tuple(c[0] for c in closed), gather_window(win, mesh),
                 tuple(psum_fixpoints(c[1], mesh) for c in closed)),)
    return out if len(out) > 1 else final


#: the JAX package's buffer-donating spelling; the port donates nothing
sharded_evolve_multi_donated = sharded_evolve_multi


def sharded_count_multi(config: MultiSoupConfig, mesh: SoupMesh,
                        state: MultiSoupState) -> torch.Tensor:
    """(T, 5) per-type global class histograms: the rank's lanes
    classified, summed over the ranks (``sharded_count_multi``,
    ``sharded_multisoup.py:723``)."""
    rows = [count_classes(classify_batch(
                config.topos[t],
                _stored_view(config, state.weights[t],
                             None if state.scales is None
                             else state.scales[t]),
                config.epsilon))
            for t in range(len(config.topos))]
    return mesh.all_reduce(torch.stack(rows))


def place_sharded_multi_state(mesh: SoupMesh, state: MultiSoupState
                              ) -> MultiSoupState:
    """The rank's part of a full ``MultiSoupState`` every rank holds: its
    block of every type, the scalars and the generator whole
    (``place_sharded_multi_state``, ``sharded_multisoup.py:751``)."""
    _type_blocks([w.shape[0] for w in state.weights], mesh)
    return MultiSoupState(
        weights=tuple(global_device_put(w, mesh, 0) for w in state.weights),
        uids=tuple(global_device_put(u, mesh, 0) for u in state.uids),
        next_uid=global_device_put(state.next_uid, mesh),
        time=global_device_put(state.time, mesh),
        key=_place_key(mesh, state.key),
        scales=None if state.scales is None
        else tuple(global_device_put(s, mesh, 0) for s in state.scales))


def make_sharded_multi_state(config: MultiSoupConfig, mesh: SoupMesh,
                             seed_: int) -> MultiSoupState:
    """Seed the whole mixed population on the rank's device from the
    replicated seed and keep the rank's blocks (equal to
    ``multisoup.seed_multi``'s state)."""
    _type_blocks(config.sizes, mesh)  # checked before the seed
    return place_sharded_multi_state(mesh, seed_multi(config, seed_,
                                                      mesh.device))
