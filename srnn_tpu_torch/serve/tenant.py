"""The tenant axis: K independent experiment configs as ONE dispatch; port
of ``srnn_tpu/serve/tenant.py``.

K tenants whose configs share the same static spelling (same topology,
same ``SoupConfig``; tenants differ in seeds only) stack their states on a
leading tenant axis (``soup.stack_carries``: the K generators become the
stacked state's ``key`` tuple) and evolve as one (K, N, P) row-major soup:
each tenant draws from its own generator in its solo order, and every
phase runs on all K * N rows at once, one launch of the variant's SGD
kernel (K2, K4 or K5) per phase a generation whatever K is
(``soup._rowmajor_generation``).

The contract is bitwise equality to solo: every tenant's slice of a
stacked dispatch carries exactly the bits its solo run produces --
weights, uids, generator state, event records, the metrics / health
carries and the lineage pids and edges.  That holds on the parallel
row-major path only (``soup.check_tenant_stackable``, with the JAX
package's gate and wording); the scheduler dispatches everything else
solo.

The JAX package's ``_donated`` twins hand XLA the input buffers to reuse.
The port's evolve never writes into its input state, so it has nothing to
donate: each ``_donated`` name is the same function as its twin.
"""

from typing import List, Optional, Sequence

import torch

from ..init import init_population
from ..multisoup import (MultiSoupConfig, check_tenant_stackable_multi,
                         evolve_multi)
from ..soup import (SoupConfig, SoupState, _rows_view, check_tenant_stackable,
                    evolve, evolve_step, seed, stack_carries, trial_carry)
from ..topology import Topology


# ---------------------------------------------------------------------------
# stacking / unstacking per-tenant states and carries
# ---------------------------------------------------------------------------


def stack_tenants(items: Sequence):
    """Stack K same-shaped states or carries (``SoupState``,
    ``MultiSoupState``, ``LineageState``, ...) on a new leading tenant
    axis; the states' generators become the stacked ``key`` tuple."""
    return stack_carries(list(items))


def unstack_tenants(tree, k: int) -> List:
    """Split a stacked state or result back into K per-tenant ones (views
    of the stacked tensors, and each tenant's own generator)."""
    return [trial_carry(tree, i) for i in range(k)]


def seed_stacked(config: SoupConfig, keys: Sequence,
                 device="cuda") -> SoupState:
    """Seed K tenant soups from K seeds or generators (``soup.seed``'s
    ``seed``): tenant i's slice is bitwise ``seed(config, keys[i],
    device)``."""
    return stack_tenants([seed(config, k, device) for k in keys])


def init_population_stacked(topo: Topology, keys: Sequence[torch.Generator],
                            n: int, device="cuda") -> torch.Tensor:
    """K generators -> (K, n, P) fresh populations on ``device``, tenant i
    bitwise ``init_population(topo, keys[i], n)`` drawn on its
    generator's device (the fixpoint-density executor's per-batch
    draw)."""
    return torch.stack([init_population(topo, g, n, g.device).to(device)
                        for g in keys])


# ---------------------------------------------------------------------------
# the stacked evolve surfaces
# ---------------------------------------------------------------------------


def evolve_stacked(
    config: SoupConfig,
    states: SoupState,
    generations: int = 1,
    record: bool = False,
    metrics: bool = False,
    health: bool = False,
    lineage: bool = False,
    lineage_state=None,
    lineage_capacity: int = 4096,
):
    """Tenant-stacked ``soup.evolve``: ``states`` is a stacked state
    (``stack_tenants``); returns ``soup.evolve``'s result with a leading
    tenant axis on every field (final state, then record / metrics /
    health / lineage per the flags).  ``lineage_state`` is a stacked
    ``LineageState``."""
    check_tenant_stackable(config)
    return evolve(config, states, generations=generations, record=record,
                  metrics=metrics, health=health, lineage=lineage,
                  lineage_state=lineage_state,
                  lineage_capacity=lineage_capacity)


#: the JAX package's buffer-donating twin; the same function here
evolve_stacked_donated = evolve_stacked


def evolve_stacked_step(config: SoupConfig, states: SoupState):
    """Tenant-stacked single generation (``soup.evolve_step``'s twin):
    (stacked state, events (K, N)) -- the stacked capture loop's frame
    step."""
    check_tenant_stackable(config)
    return evolve_step(config, states)


#: the JAX package's buffer-donating twin; the same function here
evolve_stacked_step_donated = evolve_stacked_step


def evolve_multi_stacked(
    config: MultiSoupConfig,
    states,
    generations: int = 1,
    metrics: bool = False,
    health: bool = False,
    lineage: bool = False,
    lineage_state=None,
    lineage_capacity: int = 4096,
):
    """Tenant-stacked ``multisoup.evolve_multi``: one launch per type and
    phase for all K tenants; ``lineage_state`` is the per-type tuple of
    stacked ``LineageState`` carries."""
    check_tenant_stackable_multi(config)
    return evolve_multi(config, states, generations=generations,
                        metrics=metrics, health=health, lineage=lineage,
                        lineage_state=lineage_state,
                        lineage_capacity=lineage_capacity)


#: the JAX package's buffer-donating twin; the same function here
evolve_multi_stacked_donated = evolve_multi_stacked


# ---------------------------------------------------------------------------
# stacked trajectory capture
# ---------------------------------------------------------------------------


def evolve_stacked_captured(
    config: SoupConfig,
    states: SoupState,
    generations: int,
    stores: Sequence,
    every: int = 1,
    owned: bool = False,
    writer: Optional[object] = None,
) -> SoupState:
    """Stacked twin of ``utils.capture.evolve_captured``: evolve K stacked
    tenants in chunks of ``every`` generations and append each tenant's
    captured frame to ITS OWN ``TrajStore`` in ``stores``.

    A chunk is the solo capture loop's (``evolve`` for ``every - 1``
    generations, then ``evolve_step``) on the stacked state, so every
    tenant's ``.traj`` stream is byte-identical to its solo
    ``evolve_captured(..., every=every)`` stream.  With ``writer`` (a
    ``pipeline.BackgroundWriter``) the frames are snapshotted and appended
    on the writer's thread, as the solo pipelined path does; without one
    the loop copies and appends each frame before the next chunk."""
    from ..utils.capture import _own, _run

    check_tenant_stackable(config)
    if len(stores) != len(states.key):
        raise ValueError(f"need one store per tenant ({len(states.key)}), "
                         f"got {len(stores)}")
    if every < 1 or generations % every != 0:
        raise ValueError(
            f"generations={generations} not divisible by every={every}")
    carry = [states if owned else _own(states)]

    def chunk():
        s = carry[0]
        if every > 1:
            s = evolve(config, s, every - 1)
        s, events = evolve_step(config, s)
        carry[0] = s
        frame = (s.time, _rows_view(config, s).float(), s.uids,
                 events.action, events.counterpart, events.loss)
        return frame, [], []

    _run(tuple(stores), generations, every, chunk, writer is not None,
         writer, None)
    return carry[0]
