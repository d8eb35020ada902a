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

``registry=`` (the telemetry registry) is not ported (ROADMAP.md, A.3) and
raises; the sharded capture (``open_process_shard``,
``sharded_evolve_captured``) waits for multi-GPU (A.6).
"""

from typing import Optional

import torch

from ..multisoup import (MultiSoupConfig, MultiSoupState, _check_multi,
                         evolve_multi, evolve_multi_step)
from ..soup import SoupConfig, SoupState, _stored_view, evolve, evolve_step
from .pipeline import BackgroundWriter, PinnedPool, resolve, snapshot
from .trajstore import TrajStore


def _check(generations: int, every: int, registry) -> None:
    if every < 1 or generations % every != 0:
        raise ValueError(
            f"generations={generations} not divisible by every={every}")
    if registry is not None:
        raise NotImplementedError(
            "registry=: the metrics registry is not ported to "
            "srnn_tpu_torch (ROADMAP.md, A.3)")


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
    for i, store in enumerate(stores):
        store.append(int(t), ws[i], uids[i], action[i], counterpart[i],
                     loss[i])


def _append_snapshot(stores, snap) -> None:
    """Writer job: wait for one snapshotted frame, append it to the stores
    (one per type), hand its buffers back."""
    try:
        _append(stores, *resolve(snap))
    finally:
        snap.release()


def _run(stores, generations, every, chunk, pipelined, writer) -> None:
    """The capture loop over the stores (one per type) of ``chunk()``
    frames, each a (time, per-type weights, uids, action, counterpart,
    loss) tree of tensors."""
    if not pipelined:
        for _ in range(generations // every):
            _append(stores, *resolve(chunk()))
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
            w.submit(_append_snapshot, stores, snapshot(chunk(), pool))
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
    the run from sharing any with it.  ``pipelined`` / ``writer``: see the
    module docstring."""
    _check(generations, every, registry)
    if not owned:
        state = _own(state)
    carry = [state]

    def chunk():
        s = carry[0]
        if every > 1:
            s = evolve(config, s, every - 1)
        s, events = evolve_step(config, s)
        carry[0] = s
        return _frame(config, s, events)

    _run((store,), generations, every, chunk, pipelined, writer)
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
    final state."""
    _check(generations, every, registry)
    _check_multi(config)
    if len(stores) != len(config.topos):
        raise ValueError(f"need one store per type "
                         f"({len(config.topos)}), got {len(stores)}")
    if not owned:
        state = _own(state)
    carry = [state]

    def chunk():
        s = carry[0]
        if every > 1:
            s = evolve_multi(config, s, every - 1)
        s, events = evolve_multi_step(config, s)
        carry[0] = s
        return _multi_frame(config, s, events)

    _run(tuple(stores), generations, every, chunk, pipelined, writer)
    return carry[0]
