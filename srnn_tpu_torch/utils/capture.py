"""Streaming soup evolution with strided trajectory capture; port of
``srnn_tpu/utils/capture.py`` (``evolve_captured``,
``evolve_multi_captured``).

Evolve in chunks of ``every`` generations on the population's device, take
only the LAST generation of each chunk to the host, and append it to a
:class:`TrajStore` (one per type for a mixed soup).  ``every=1`` keeps the
reference's full ``ParticleDecorator.save_state`` history; a larger stride
is what a mega-soup can afford.

A chunk runs ``evolve(config, state, every - 1)`` and then
``evolve_step`` (``evolve_multi`` / ``evolve_multi_step``), each picking up
the generator the chunk before handed back, so a captured run draws what
an uncaptured one draws and its frames equal ``evolve(record=True)`` at
the captured generations bitwise.  A frame holds the stored view of the
weights (``_stored_view``): float32 and bfloat16 populations as stored
(bfloat16 widened exactly to the file's float32), an int8 population
dequantized.  The JAX package writes an int8 population's raw codes
(ROADMAP.md, C).

Pipelined capture (the default, ``pipelined=True``): each frame is
:func:`pipeline.snapshot`-ed -- its copy to page-locked host memory starts
on a side stream at once -- and the wait for it and the append run on a
bounded :class:`pipeline.BackgroundWriter`, so the host loop keeps
launching the next chunk while frames drain to disk.  The stream written
is byte-identical to the blocking loop's (``pipelined=False``: a copy to
the host and an append after every chunk).  Pass ``writer=`` to share a
caller's writer (the caller then owns flush ordering); otherwise a private
writer is created and closed -- joined and flushed -- before returning.

``registry=`` (a ``telemetry.MetricsRegistry``) meters every generation,
not a stride sample: the chunk's ``every - 1`` generations ride
``evolve``'s metrics carry and the captured step's events, already in
hand, are counted with ``telemetry.count_events``; ``update_registry``
folds both (per type, ``type=<variant>``, for a mixed soup).  Pipelined,
the carries are snapshotted like the frames and folded on the writer
thread, so the loop reads nothing back; blocking, they are folded after
each chunk.  The sharded capture (``open_process_shard``,
``sharded_evolve_captured``) waits for multi-GPU (ROADMAP.md, A.6).
"""

from typing import Optional

import torch

from ..multisoup import (MultiSoupConfig, MultiSoupState, _check_multi,
                         evolve_multi, evolve_multi_step)
from ..soup import SoupConfig, SoupState, _stored_view, evolve, evolve_step
from .pipeline import BackgroundWriter, PinnedPool, resolve, snapshot
from .trajstore import TrajStore


def _check(generations: int, every: int) -> None:
    if every < 1 or generations % every != 0:
        raise ValueError(
            f"generations={generations} not divisible by every={every}")


def _update(registry, carries, labels) -> None:
    """Fold metrics carries (device tensors or host arrays) into the
    registry, one ``update_registry`` keyword set each."""
    from ..telemetry.device import SoupMetrics
    from ..telemetry.soup_metrics import update_registry

    for m, kw in zip(carries, labels):
        update_registry(registry, SoupMetrics(*m), **kw)


def _update_snapshot(registry, snap, labels) -> None:
    """Writer job: wait for snapshotted metrics carries, fold them, hand
    the buffers back."""
    try:
        _update(registry, resolve(snap), labels)
    finally:
        snap.release()


def _view(config, weights, scales):
    """The stored view as the file's float32 (bfloat16 widens exactly)."""
    return _stored_view(config, weights, scales).float()


def _own(state):
    """The state with its tensors copied: the run never shares a tensor
    with the caller's state (``owned=False``)."""
    def copy(x):
        if isinstance(x, tuple):
            return tuple(copy(t) for t in x)
        return x.clone() if isinstance(x, torch.Tensor) else x

    return type(state)(*(copy(f) for f in state))


def _frame(config: SoupConfig, state: SoupState, events):
    """A soup's frame in the mixed soup's form (a type of one)."""
    return (state.time, (_view(config, state.weights, state.scales),),
            (state.uids,), (events.action,), (events.counterpart,),
            (events.loss,))


def _multi_frame(config: MultiSoupConfig, state: MultiSoupState, events):
    views = tuple(_view(config, w, None if state.scales is None
                        else state.scales[t])
                  for t, w in enumerate(state.weights))
    return (state.time, views, state.uids, events.action,
            events.counterpart, events.loss)


def _append(stores, t, ws, uids, action, counterpart, loss) -> None:
    """Store i takes entry i of every field (type i of a mixed soup, or
    trial i of a stacked one, whose ``t`` holds one time per trial)."""
    for i, store in enumerate(stores):
        store.append(int(t[i] if t.ndim else t), ws[i], uids[i], action[i],
                     counterpart[i], loss[i])


def _append_snapshot(stores, snap) -> None:
    """Writer job: wait for one snapshotted frame, append it to the stores
    (one per type), hand its buffers back."""
    try:
        _append(stores, *resolve(snap))
    finally:
        snap.release()


def _run(stores, generations, every, chunk, pipelined, writer,
         registry) -> None:
    """The capture loop over the stores (one per type) of ``chunk()``
    results: a (time, per-type weights, uids, action, counterpart, loss)
    frame of tensors, and the chunk's metrics carries with their
    ``update_registry`` keywords (empty without a ``registry``)."""
    if not pipelined:
        for _ in range(generations // every):
            frame, carries, labels = chunk()
            _append(stores, *resolve(frame))
            if registry is not None:
                _update(registry, carries, labels)
        for store in stores:
            store.flush()
        return
    own_writer = writer is None
    w = BackgroundWriter(name="srnn-capture-io") if own_writer else writer
    if own_writer:
        for store in stores:
            w.add_close_hook(store.join)  # crash path: appended frames durable
    pool = PinnedPool()
    try:
        for _ in range(generations // every):
            frame, carries, labels = chunk()
            if registry is not None:
                w.submit(_update_snapshot, registry,
                         snapshot([tuple(m) for m in carries], pool), labels)
            w.submit(_append_snapshot, stores, snapshot(frame, pool))
        for store in stores:
            w.submit(store.flush)
    finally:
        if own_writer:
            w.close()  # join + flush; re-raises any writer-job error


def evolve_captured(
    config: SoupConfig,
    state: SoupState,
    generations: int,
    store: TrajStore,
    every: int = 1,
    owned: bool = False,
    registry=None,
    pipelined: bool = True,
    writer: Optional[BackgroundWriter] = None,
) -> SoupState:
    """Evolve ``generations`` steps, appending one frame per ``every``
    generations to ``store``.  Returns the final state.

    Frames carry the true event record of the captured generation
    (action / counterpart / loss), so the event log matches the unsampled
    run at the captured points.  ``owned=True`` says the caller hands
    ``state`` over and skips the copy of its tensors that otherwise keeps
    the run from sharing any with it.  ``registry`` / ``pipelined`` /
    ``writer``: see the module docstring."""
    from ..telemetry.device import count_events

    _check(generations, every)
    if not owned:
        state = _own(state)
    carry = [state]
    kw = {"n_particles": config.size}

    def chunk():
        s = carry[0]
        carries = []
        if every > 1:
            if registry is not None:
                s, m = evolve(config, s, every - 1, metrics=True)
                carries.append(m)
            else:
                s = evolve(config, s, every - 1)
        s, events = evolve_step(config, s)
        if registry is not None:
            carries.append(count_events(events.action, events.loss))
        carry[0] = s
        return _frame(config, s, events), carries, [kw] * len(carries)

    _run((store,), generations, every, chunk, pipelined, writer, registry)
    return carry[0]


def evolve_multi_captured(
    config: MultiSoupConfig,
    state: MultiSoupState,
    generations: int,
    stores,
    every: int = 1,
    owned: bool = False,
    registry=None,
    pipelined: bool = True,
    writer: Optional[BackgroundWriter] = None,
) -> MultiSoupState:
    """Mixed-soup twin of :func:`evolve_captured`: one :class:`TrajStore`
    per TYPE (``stores[t]`` holds type t's (N_t, P_t) frames).  Returns the
    final state; ``registry`` meters every generation per type
    (``type=<variant>``, ``telemetry.soup_metrics.type_names``)."""
    from ..telemetry.device import count_events
    from ..telemetry.soup_metrics import type_names

    _check(generations, every)
    _check_multi(config)
    if len(stores) != len(config.topos):
        raise ValueError(f"need one store per type "
                         f"({len(config.topos)}), got {len(stores)}")
    if not owned:
        state = _own(state)
    carry = [state]
    kws = [{"type_name": name, "n_particles": n}
           for name, n in zip(type_names(config), config.sizes)]

    def chunk():
        s = carry[0]
        carries, labels = [], []
        if every > 1:
            if registry is not None:
                s, ms = evolve_multi(config, s, every - 1, metrics=True)
                carries += list(ms)
                labels += kws
            else:
                s = evolve_multi(config, s, every - 1)
        s, events = evolve_multi_step(config, s)
        if registry is not None:
            carries += [count_events(a, l)
                        for a, l in zip(events.action, events.loss)]
            labels += kws
        carry[0] = s
        return _multi_frame(config, s, events), carries, labels

    _run(tuple(stores), generations, every, chunk, pipelined, writer,
         registry)
    return carry[0]
