"""Replication-dynamics telemetry: lineage, event edges and the fixpoint
census of a soup run; port of ``srnn_tpu/telemetry/dynamics.py``.

Three carries ride ``soup.evolve`` / ``multisoup.evolve_multi`` behind
``lineage=True``, all tensors on the population's device:

  * :class:`LineageState` -- per-particle instance ids (pid) with parent
    pid, birth generation and last basin label.  A new pid is minted where
    a slot's identity changes: at seed and respawn (roots, ``parent=-1``)
    and where an attack overwrites the victim (``parent`` = the attacker's
    pid).  ``learn_from`` mints nothing and only adds an event edge.
  * :class:`LineageWindow` -- a fixed-capacity buffer of event-edge rows
    ``(kind, gen, src_pid, dst_pid, prev_pid)``.  A generation's rows land
    in one scatter (:func:`record_step`); past the capacity the excess is
    dropped and counted in ``dropped``, while ``births`` stays exact (it
    sums the masks, not the buffer).
  * :class:`FixpointStats` -- the end-of-window census: each particle's
    self-application distance ``f(w) - w`` (L2 and L-inf, sketched into the
    health sketch's log2 buckets), its basin label and the
    window-over-window basin transitions.

Basin labels: ``divergent`` iff any weight or the distance is NaN/Inf;
else ``zero`` iff every weight lies within ``[-epsilon, epsilon]``; else
``fixpoint`` iff ``L-inf < epsilon``; else ``drifting``.  Particles minted
in the window enter the transitions from the ``unknown`` row.

Nothing here reads the card on the host inside a generation: the append
slots are mask ranks (a cumsum), the first ``caps[i]`` gated lanes of each
phase are found by a ``searchsorted`` on that cumsum, and rows that fall
past the buffer land on one spare row that is cut off (torch has no
``mode='drop'`` scatter).  The integers match the JAX package's exactly
for the same gates; the census is exact for the same weights and
``f(w)``.

The host half (:class:`LineageWriter`, :func:`update_dynamics_registry`,
the ``lineage_state.npz`` sidecar) writes what the JAX package writes, so
either package's ``genealogy`` and ``load_lineage_state`` read the
other's files.

Sharded runs (``parallel.sharded_soup``): :func:`record_step` and
:func:`lookup_pids` take the mesh, so that pids minted on different ranks
are globally unique and equal to the single-device run's;
:func:`place_lineage` keeps a rank's block of a carry,
:func:`gather_window` concatenates the per-rank windows (the JAX
package's ``window_specs``) and :func:`psum_fixpoints` reduces the census
once per ``sharded_evolve`` call.
"""

import json
import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import (N_HEALTH_BUCKETS, code_histogram, host, log2_buckets,
                     rounded)

#: basin labels of the census, in label precedence
N_BASINS = 4
BASIN_NAMES = ("fixpoint", "drifting", "divergent", "zero")
BASIN_FIX, BASIN_DRIFT, BASIN_DIV, BASIN_ZERO = range(N_BASINS)
BASIN_UNKNOWN = -1  # minted this window / first window: no previous label

#: event-edge kinds (the ``kind`` column of a :class:`LineageWindow` row)
EDGE_NAMES = ("attack", "learn", "respawn")
EDGE_ATTACK, EDGE_LEARN, EDGE_RESPAWN = range(3)
#: columns of one edge row: (kind, gen, src_pid, dst_pid, prev_pid)
EDGE_WIDTH = 5

#: edge-buffer rows of a window (the mega loops' --lineage-edges default)
DEFAULT_EDGE_CAPACITY = 4096


class LineageState(NamedTuple):
    """Persistent per-particle lineage carry (input and output of
    ``evolve``: pids persist across windows)."""
    pid: torch.Tensor       # (N,) int32 -- current instance id of each slot
    parent: torch.Tensor    # (N,) int32 -- parent pid (-1 for roots)
    birth: torch.Tensor     # (N,) int32 -- generation the instance was minted
    basin: torch.Tensor     # (N,) int32 -- label at last window close (-1)
    next_pid: torch.Tensor  # () int32 -- the mint counter


class LineageWindow(NamedTuple):
    """Per-window event-edge buffer."""
    edges: torch.Tensor    # (cap, EDGE_WIDTH) int32
    n_edges: torch.Tensor  # (1,) int32 -- valid rows
    dropped: torch.Tensor  # (1,) int32 -- edges lost to capacity
    births: torch.Tensor   # (1, 2) int32 -- exact attack / respawn mints


class FixpointStats(NamedTuple):
    """End-of-window fixpoint census."""
    census: torch.Tensor       # (N_BASINS,) int32
    transitions: torch.Tensor  # (N_BASINS + 1, N_BASINS) int32 -- rows:
    #                            unknown, then the previous basin
    l2_hist: torch.Tensor      # (N_HEALTH_BUCKETS,) int32
    linf_hist: torch.Tensor    # (N_HEALTH_BUCKETS,) int32
    l2_max: torch.Tensor       # () float32 -- max finite L2 (-inf if none)
    linf_max: torch.Tensor     # () float32


def _full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.int32, device=device)


def seed_lineage(n: int, base: int = 0, time: int = 0,
                 device="cuda") -> LineageState:
    """Fresh lineage of an ``n``-particle population: roots
    ``pid = base + [0, n)`` born at ``time``."""
    return LineageState(
        pid=torch.arange(base, base + n, dtype=torch.int32, device=device),
        parent=_full((n,), -1, device),
        birth=_full((n,), time, device),
        basin=_full((n,), BASIN_UNKNOWN, device),
        next_pid=_full((), base + n, device))


def seed_lineage_blocks(sizes: Sequence[int], time: int = 0,
                        device="cuda") -> Tuple[LineageState, ...]:
    """Per-type carries over one pid space: type ``t``'s roots are its uid
    block and every carry starts from the same counter ``sum(sizes)``."""
    total = sum(sizes)
    lins, off = [], 0
    for n in sizes:
        lin = seed_lineage(n, base=off, time=time, device=device)
        lins.append(lin._replace(next_pid=_full((), total, device)))
        off += n
    return tuple(lins)


def zero_window(capacity: int, device="cuda") -> LineageWindow:
    """The empty per-window buffer."""
    if capacity < 1:
        raise ValueError(f"lineage edge capacity must be >= 1, got {capacity}")
    return LineageWindow(
        edges=_full((capacity, EDGE_WIDTH), -1, device),
        n_edges=_full((1,), 0, device),
        dropped=_full((1,), 0, device),
        births=_full((1, 2), 0, device))


def edge_capacity(n: int, rate: float) -> int:
    """Per-generation edge block of a Binomial(n, rate) gated-lane count:
    mean + 8 sd, plus 16, rounded up to a multiple of 128, at most n."""
    rate = min(max(rate, 0.0), 1.0)
    mean = n * rate
    sd = math.sqrt(n * rate * (1.0 - rate))
    cap = int(math.ceil(mean + 8.0 * sd)) + 16
    return min(n, ((cap + 127) // 128) * 128)


def lookup_pids(pid: torch.Tensor, idx: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """pid of a (global) particle index; under sharding (``mesh``, a
    ``parallel.SoupMesh``) the pid table is gathered from every rank
    first."""
    table = pid if mesh is None else mesh.gather(pid)
    return table[idx]


def _rank_and_total(cnt: torch.Tensor, mesh):
    """(mint base of this rank, global count) per phase from the local
    counts ``cnt``: zeros and ``cnt`` on one device; under sharding the
    counts of the ranks before this one and of all ranks (one gather), so
    that a lane's global mint rank is its local rank plus the base -- the
    JAX package's gathered-mask cumsum (``_rank_and_total``,
    ``dynamics.py:182-198``), from counts instead of masks."""
    if mesh is None:
        return torch.zeros_like(cnt), cnt
    counts = mesh.gather(cnt).view(mesh.size, -1)
    return counts[:mesh.rank].sum(0, dtype=cnt.dtype), \
        counts.sum(0, dtype=cnt.dtype)


def mint(lin: LineageState, mask: torch.Tensor, parent_pid: torch.Tensor,
         gen: torch.Tensor) -> LineageState:
    """A fresh pid for every masked lane, ranked from ``next_pid`` in lane
    order; ``parent_pid`` per lane (-1 for roots), birth ``gen``, basin
    unknown."""
    rank = torch.cumsum(mask, 0) - 1
    return LineageState(
        pid=torch.where(mask, (lin.next_pid + rank).to(torch.int32),
                        lin.pid),
        parent=torch.where(mask, parent_pid, lin.parent),
        birth=torch.where(mask, gen.to(torch.int32), lin.birth),
        basin=torch.where(mask, BASIN_UNKNOWN, lin.basin),
        next_pid=lin.next_pid + mask.sum(dtype=torch.int32))


def _kinds(phases, device) -> torch.Tensor:
    """The EDGE_* codes of the phases on, as one ``arange`` (any subset of
    three consecutive codes is an arithmetic progression)."""
    step = phases[1] - phases[0] if len(phases) > 1 else 1
    return torch.arange(phases[0], phases[-1] + 1, step, dtype=torch.int32,
                        device=device)


def record_step(lin: LineageState, win: LineageWindow, *,
                gen: torch.Tensor, attacked: torch.Tensor,
                attacker_pid: torch.Tensor, learn_gate: torch.Tensor,
                learn_tgt: torch.Tensor, dead: torch.Tensor,
                caps: Tuple[int, int, int], capacity: int, mesh=None
                ) -> Tuple[LineageState, LineageWindow]:
    """One generation's lineage bookkeeping, fed the gates the generation
    computed: the ``attacked`` lanes with their winning ``attacker_pid``
    (start-of-generation pids), the learners with their teacher's index
    (its pid read AFTER the attack mints: a particle imitating a just
    attacked victim learns from the new instance), and the respawned
    ``dead`` lanes.  Attack mints, then learn edges, then respawn mints.
    A zero entry of ``caps`` (the per-phase row widths,
    :func:`edge_capacity`) removes that phase, as a phase that cannot
    fire.

    The phases share one running count of their masks (``cumsum``): a
    lane's mint rank, and its row's slot.  The first ``caps[i]`` gated
    lanes of each phase are found by one ``searchsorted``, their rows
    gathered at once, and every row of the generation lands in one
    scatter; the phases append in order until the buffer is full (phase
    i's rows start after min(rows wanted by the phases before it, room)),
    and a row past it goes to a spare row that is cut off.

    Under sharding (``mesh``, a ``parallel.SoupMesh``; the masks are the
    rank's own lanes, ``learn_tgt`` global indices) the pids are minted
    from global ranks (this rank's base from the counts of the ranks
    before it) and the teacher's pid is read from the gathered table, so
    a lane gets the pid the single-device run gives it; the window is the
    rank's own (its rows, counts and births), as in the JAX package."""
    phases = [i for i in range(3) if caps[i] > 0]
    if not phases:
        return lin, win
    dev = lin.pid.device
    n = lin.pid.shape[0]
    gen = gen.to(torch.int32)
    at = {i: r for r, i in enumerate(phases)}
    masks = (attacked, learn_gate, dead)
    # one scan over the phases' masks end to end, each row's count then
    # restarted at its start: torch scans each row of a (P, N) tensor in
    # one block, about a millisecond a row at N = 1M
    flat = torch.cumsum(torch.stack([masks[i] for i in phases]).view(-1), 0,
                        dtype=torch.int32).view(len(phases), n)
    running = flat - torch.cat([flat.new_zeros(1), flat[:-1, -1]])[:, None]
    cnt = running[:, -1]
    rank = running - 1
    base, total = _rank_and_total(cnt, mesh)

    old_pid = mid_pid = pid = lin.pid
    parent, next_pid = lin.parent, lin.next_pid
    neg1 = torch.full_like(old_pid, -1)
    cols = []
    if 0 in at:
        mid_pid = pid = torch.where(
            attacked, next_pid + base[at[0]] + rank[at[0]], pid)
        parent = torch.where(attacked, attacker_pid, parent)
        next_pid = next_pid + total[at[0]]
        cols += [attacker_pid, mid_pid, old_pid]
    if 1 in at:
        cols += [lookup_pids(mid_pid, learn_tgt, mesh), mid_pid, neg1]
    if 2 in at:
        pid = torch.where(dead, next_pid + base[at[2]] + rank[at[2]], pid)
        parent = torch.where(dead, neg1, parent)
        next_pid = next_pid + total[at[2]]
        cols += [neg1, pid, mid_pid]
    minted = None
    if 0 in at:
        minted = attacked
    if 2 in at:
        minted = dead if minted is None else minted | dead
    if minted is not None:
        lin = LineageState(pid, parent,
                           torch.where(minted, gen, lin.birth),
                           torch.where(minted, BASIN_UNKNOWN, lin.basin),
                           next_pid)

    # the rows of the first `width` gated lanes of each phase, in lane
    # order: the k-th gated lane is where the running count reaches k
    width = max(min(caps[i], capacity) for i in phases)
    k = torch.arange(1, width + 1, dtype=torch.int32,
                     device=dev).repeat(len(phases), 1)
    lanes = torch.searchsorted(running, k).clamp(max=n - 1)
    vals = torch.stack(cols).view(len(phases), 3, n).gather(
        2, lanes[:, None, :].expand(-1, 3, -1))
    head = torch.stack([_kinds(phases, dev)[:, None].expand(-1, width),
                        gen.expand(len(phases), width)], 1)
    rows = torch.cat([head, vals], 1).transpose(1, 2).reshape(-1, EDGE_WIDTH)

    # slots: each phase appends min(its gated count, its width) rows while
    # the buffer has room; a row past it goes to the spare slot `capacity`
    want = torch.stack([cnt[at[i]].clamp(max=min(caps[i], capacity))
                        for i in phases])
    upto = torch.cumsum(want, 0)
    base = win.n_edges[0]
    room = (capacity - base).clamp(min=0)
    done, before = torch.minimum(upto, room), torch.minimum(upto - want, room)
    ahead = before[:, None] + k
    slots = torch.where(ahead <= done[:, None], base + ahead - 1, capacity)
    buf = torch.cat([win.edges, win.edges[-1:]])  # the spare row, cut off
    buf = buf.scatter(0, slots.reshape(-1, 1).expand(-1, EDGE_WIDTH), rows)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    births = torch.stack([cnt[at[0]] if 0 in at else zero,
                          cnt[at[2]] if 2 in at else zero])
    return lin, LineageWindow(
        edges=buf[:capacity],
        n_edges=win.n_edges + done[-1],
        dropped=win.dropped + (cnt.sum(dtype=torch.int32) - done[-1]),
        births=win.births + births[None])


def fixpoint_stats(w: torch.Tensor, fw: torch.Tensor, axis: int,
                   epsilon: float, prev_basin: torch.Tensor
                   ) -> Tuple[torch.Tensor, FixpointStats]:
    """Per-particle basin labels and the census from the self-application
    ``fw = f(w)`` (computed by the caller, which owns the variant
    dispatch).  ``axis`` is the weight axis ((N, P): -1; (P, N): 0);
    ``epsilon`` is the zero-collapse bound and the strict L-inf fixpoint
    threshold."""
    eps = rounded(epsilon, w.dtype)
    diff = fw - w
    l2 = torch.sqrt((diff * diff).sum(dim=axis, dtype=torch.float32))
    linf = diff.abs().amax(dim=axis).float()
    div = (~torch.isfinite(w)).any(dim=axis) | ~torch.isfinite(linf)
    zero = ((w >= -eps) & (w <= eps)).all(dim=axis) & ~div
    fix = ~div & ~zero & (linf < rounded(epsilon, linf.dtype))
    basin = torch.where(div, BASIN_DIV, torch.where(
        zero, BASIN_ZERO, torch.where(fix, BASIN_FIX, BASIN_DRIFT))).to(
            torch.int32)
    pair = (prev_basin + 1) * N_BASINS + basin
    finite = torch.isfinite(l2) & torch.isfinite(linf)
    inf = float("inf")
    stats = FixpointStats(
        census=code_histogram(basin, N_BASINS),
        transitions=code_histogram(pair, (N_BASINS + 1) * N_BASINS).reshape(
            N_BASINS + 1, N_BASINS),
        l2_hist=code_histogram(log2_buckets(l2, finite), N_HEALTH_BUCKETS,
                               include=finite),
        linf_hist=code_histogram(log2_buckets(linf, finite),
                                 N_HEALTH_BUCKETS, include=finite),
        l2_max=torch.where(finite, l2, -inf).amax(),
        linf_max=torch.where(finite, linf, -inf).amax())
    return basin, stats


def close_window(lin: LineageState, w: torch.Tensor, fw: torch.Tensor,
                 axis: int, epsilon: float
                 ) -> Tuple[LineageState, FixpointStats]:
    """End-of-window close: label every particle's basin, fold the
    transitions from the carried labels, and store the new labels."""
    basin, stats = fixpoint_stats(w, fw, axis, epsilon, lin.basin)
    return lin._replace(basin=basin), stats


def psum_fixpoints(s: FixpointStats, mesh) -> FixpointStats:
    """The global census from every rank's (``psum_fixpoints``,
    ``dynamics.py:382`` of the JAX package): counts summed, maxima
    maxed -- one reduction of the integers and one of the two maxima."""
    ints = mesh.all_reduce(torch.cat([
        s.census, s.transitions.reshape(-1), s.l2_hist, s.linf_hist]))
    n, m = N_BASINS, (N_BASINS + 1) * N_BASINS
    maxima = mesh.all_reduce(torch.stack([s.l2_max, s.linf_max]), "max")
    return FixpointStats(
        census=ints[:n],
        transitions=ints[n:n + m].reshape(s.transitions.shape),
        l2_hist=ints[n + m:n + m + N_HEALTH_BUCKETS],
        linf_hist=ints[n + m + N_HEALTH_BUCKETS:], l2_max=maxima[0],
        linf_max=maxima[1])


def gather_window(win: LineageWindow, mesh) -> LineageWindow:
    """Every rank's window side by side, in rank order (the JAX package's
    per-shard ``window_specs``): ``window_record`` reads the shards'
    rows by their own counts."""
    return LineageWindow(*(mesh.gather(x) for x in win))


def place_lineage(mesh, lin: LineageState) -> LineageState:
    """This rank's block of a lineage carry every rank holds in full (the
    per-particle fields; the mint counter whole)."""
    from ..parallel.mesh import global_device_put

    return LineageState(*(global_device_put(x, mesh, None if f == "next_pid"
                                            else 0)
                          for f, x in zip(LineageState._fields, lin)))


# ---------------------------------------------------------------------------
# host half: the lineage.jsonl stream, registry metrics, the sidecar
# ---------------------------------------------------------------------------


def window_edge_rows(win: LineageWindow, capacity: int) -> list:
    """Valid edge rows of a flushed window as a list of 5-int lists."""
    edges = host(win.edges).reshape(-1, capacity, EDGE_WIDTH)
    counts = host(win.n_edges).reshape(-1)
    rows = []
    for seg, cnt in zip(edges, counts):
        rows.extend(seg[: int(cnt)].tolist())
    return rows


def _fixpoint_doc(s: FixpointStats) -> dict:
    census = host(s.census)
    l2m, linfm = float(host(s.l2_max)), float(host(s.linf_max))
    return {
        "census": {name: int(census[i]) for i, name in enumerate(BASIN_NAMES)},
        "transitions": host(s.transitions).tolist(),
        "l2_hist": host(s.l2_hist).tolist(),
        "linf_hist": host(s.linf_hist).tolist(),
        "l2_max": l2m if math.isfinite(l2m) else None,
        "linf_max": linfm if math.isfinite(linfm) else None,
    }


def window_record(gen_start: int, gen_end: int, win: LineageWindow,
                  stats, capacity: int, next_pid: int,
                  type_names: Optional[Sequence[str]] = None) -> dict:
    """One flushed window as the ``lineage.jsonl`` row the genealogy layer
    reads.  ``stats`` is one :class:`FixpointStats` or, for a mixed soup, a
    per-type sequence labelled by ``type_names``."""
    births = host(win.births).reshape(-1, 2).sum(axis=0)
    doc = {
        "kind": "window",
        "gen_start": int(gen_start),
        "gen_end": int(gen_end),
        "edges": window_edge_rows(win, capacity),
        "edges_dropped": int(host(win.dropped).sum()),
        "births_attack": int(births[0]),
        "births_respawn": int(births[1]),
        "next_pid": int(next_pid),
    }
    if type_names is not None:
        doc["fixpoints_by_type"] = {
            name: _fixpoint_doc(s) for name, s in zip(type_names, stats)}
    else:
        doc["fixpoints"] = _fixpoint_doc(stats)
    return doc


def probe_record(gen_start: int, gen_end: int, stats,
                 type_names: Optional[Sequence[str]] = None) -> dict:
    """Census-only window row (no edges, no pids; transitions from the
    unknown row), for runs without the in-loop carry."""
    doc = {"kind": "probe", "gen_start": int(gen_start),
           "gen_end": int(gen_end)}
    if type_names is not None:
        doc["fixpoints_by_type"] = {
            name: _fixpoint_doc(s) for name, s in zip(type_names, stats)}
    else:
        doc["fixpoints"] = _fixpoint_doc(stats)
    return doc


class LineageWriter:
    """Append-only ``lineage.jsonl`` stream of a run directory: a header
    row per writer epoch (a fresh run, or a resume without the restored
    carry, opens a new epoch; ``continue_epoch=True`` extends the last
    one), then one row per flushed window, flushed per row so a killed run
    keeps every completed window."""

    NAME = "lineage.jsonl"

    def __init__(self, run_dir: str, *, n: int, capacity: int,
                 epsilon: float, resume: bool = False,
                 continue_epoch: bool = False,
                 meta: Optional[dict] = None):
        self.path = os.path.join(run_dir, self.NAME)
        last = None
        if resume and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    for line in f:
                        try:
                            row = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        if row.get("kind") == "header":
                            last = int(row.get("epoch", 0))
            except OSError:
                pass
        continues = continue_epoch and last is not None
        self.epoch = last if continues else (0 if last is None else last + 1)
        self._f = open(self.path, "a" if resume else "w")
        if resume:
            # a kill mid-append can leave a torn last line: end it before
            # the header so the two do not glue into one unreadable line
            try:
                with open(self.path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    if f.tell() > 0:
                        f.seek(-1, os.SEEK_END)
                        if f.read(1) != b"\n":
                            self._f.write("\n")
            except OSError:
                pass
        header = {"kind": "header", "epoch": self.epoch,
                  "continues": continues, "n": int(n),
                  "capacity": int(capacity), "epsilon": float(epsilon),
                  "basins": list(BASIN_NAMES), "edge_kinds": list(EDGE_NAMES)}
        header.update(meta or {})
        self.append(header)

    def append(self, row: dict) -> None:
        self._f.write(json.dumps(row, separators=(",", ":")) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def update_dynamics_registry(registry, row: dict) -> None:
    """Fold one flushed window row into the ``soup_dynamics_*`` metrics."""
    registry.counter("soup_dynamics_windows_total",
                     help="flushed replication-dynamics windows").inc(1)
    if "edges" in row:
        by_kind = {}
        for e in row["edges"]:
            by_kind[e[0]] = by_kind.get(e[0], 0) + 1
        for code, name in enumerate(EDGE_NAMES):
            registry.counter(
                "soup_dynamics_edges_total",
                help="recorded lineage event edges").inc(
                    by_kind.get(code, 0), kind=name)
        registry.counter(
            "soup_dynamics_edges_dropped_total",
            help="event edges lost to window capacity").inc(
                int(row.get("edges_dropped", 0)))
        registry.counter("soup_dynamics_births_total",
                         help="fresh particle instances minted").inc(
                             int(row.get("births_attack", 0)), kind="attack")
        registry.counter("soup_dynamics_births_total",
                         help="fresh particle instances minted").inc(
                             int(row.get("births_respawn", 0)),
                             kind="respawn")
        registry.gauge("soup_dynamics_next_pid",
                       help="global lineage mint counter").set(
                           int(row.get("next_pid", 0)))
    docs = ([(None, row["fixpoints"])] if "fixpoints" in row
            else list(row.get("fixpoints_by_type", {}).items()))
    for tname, doc in docs:
        labels = {"type": tname} if tname else {}
        for name, count in doc.get("census", {}).items():
            registry.gauge("soup_dynamics_basin_particles",
                           help="particles per fixpoint basin").set(
                               int(count), basin=name, **labels)
        trans = doc.get("transitions")
        if trans:
            src_names = ("unknown",) + BASIN_NAMES
            for i, src in enumerate(src_names):
                for j, dst in enumerate(BASIN_NAMES):
                    v = int(trans[i][j])
                    if v:
                        registry.counter(
                            "soup_dynamics_basin_transitions_total",
                            help="window-over-window basin transitions"
                        ).inc(v, src=src, dst=dst, **labels)
        for key, metric in (("l2_max", "soup_dynamics_fixpoint_l2_max"),
                            ("linf_max", "soup_dynamics_fixpoint_linf_max")):
            if doc.get(key) is not None:
                registry.gauge(
                    metric,
                    help="max finite self-application distance").set(
                        float(doc[key]), **labels)


STATE_NAME = "lineage_state.npz"


def save_lineage_state(run_dir: str, lin, gen: int) -> None:
    """The lineage carry at generation ``gen`` as the run directory's
    ``lineage_state.npz`` (the JAX package's sidecar: the same arrays under
    the same names), replaced atomically.  ``lin`` is one
    :class:`LineageState` or a per-type tuple."""
    lins = (lin,) if hasattr(lin, "next_pid") else tuple(lin)
    arrays = {"gen": np.int64(gen), "types": np.int64(len(lins))}
    for t, l in enumerate(lins):
        for field, v in l._asdict().items():
            arrays[f"t{t}_{field}"] = host(v)
    path = os.path.join(run_dir, STATE_NAME)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_lineage_state(run_dir: str, expect_gen: int, device="cuda"):
    """The sidecar's carry on ``device`` if it was saved at ``expect_gen``;
    None (the caller starts a fresh epoch) otherwise."""
    path = os.path.join(run_dir, STATE_NAME)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["gen"]) != int(expect_gen):
                return None
            lins = tuple(
                LineageState(**{f: torch.as_tensor(
                    np.array(z[f"t{t}_{f}"], dtype=np.int32), device=device)
                    for f in LineageState._fields})
                for t in range(int(z["types"])))
    except (OSError, KeyError, ValueError):
        return None
    return lins if len(lins) > 1 else lins[0]
