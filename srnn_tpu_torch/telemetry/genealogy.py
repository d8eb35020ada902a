"""Offline genealogy reconstruction from a run's ``lineage.jsonl`` stream;
a copy of ``srnn_tpu/telemetry/genealogy.py``.

The host-side analysis half of the replication-dynamics telemetry
(:mod:`srnn_tpu_torch.telemetry.dynamics` is the device half): reads the
append-only window stream that :class:`~.dynamics.LineageWriter` writes
(the JAX package's format, so either package reads the other's) and
reconstructs the ancestry forest —

  * **forest**: every pid with its parent pid, birth generation and mint
    kind (``seed`` / ``attack`` / ``respawn``); attack edges are the
    lineage links (the attacker reproduced onto the victim's slot),
    respawns and the seed population are roots.
  * **dominant-lineage table**: live descendants and total mints per
    root, the "which lineage took over the soup" ranking.
  * **clone-survival curve**: lifespan distribution of terminated
    instances (birth → overwrite/respawn generation).
  * **attack / imitation graph stats**: out-degree distributions and the
    top attackers/teachers.
  * **basin-transition matrix** and the **fixpoint census trajectory**
    summed/collected over windows.

Edge buffers are fixed-capacity samples (``edges_dropped`` > 0 on a
window means the graph is subsampled for that window — counts become
lower bounds; the census/births/transition numbers are always exact
because they are mask-sums, not buffer reads).  A stream may contain
several epochs (a resume that could not restore the lineage carry starts
a new header); pids are unique within an epoch, so all per-pid analysis
is per-epoch and :func:`summarize_dynamics` reports the last (current)
epoch.
"""

import json
import os
from typing import Dict, List, Optional, Tuple

from .dynamics import (BASIN_NAMES, EDGE_ATTACK, EDGE_LEARN, EDGE_RESPAWN,
                       LineageWriter)

#: mint kinds of a forest node
KIND_SEED, KIND_ATTACK, KIND_RESPAWN = "seed", "attack", "respawn"


def load_lineage(path: str) -> List[dict]:
    """Parse a ``lineage.jsonl`` (file path or run dir) into epochs:
    ``[{"header": {...}, "windows": [row, ...]}, ...]``.  Torn tails of a
    killed run are skipped like every other jsonl reader in the package."""
    if os.path.isdir(path):
        path = os.path.join(path, LineageWriter.NAME)
    epochs: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if row.get("kind") == "header":
                if row.get("continues") and epochs:
                    # a resume that restored the lineage carry: the same
                    # epoch keeps accumulating under its original header
                    continue
                epochs.append({"header": row, "windows": []})
            elif epochs:
                epochs[-1]["windows"].append(row)
    if not epochs:
        raise ValueError(f"{path}: no lineage header rows")
    return epochs


class Forest:
    """Ancestry forest of one epoch: pid -> (parent, birth, kind), plus
    termination generations and the imitation edge list."""

    def __init__(self) -> None:
        self.parent: Dict[int, int] = {}
        self.birth: Dict[int, Optional[int]] = {}
        self.kind: Dict[int, str] = {}
        self.ended: Dict[int, int] = {}
        self.learn_edges: List[Tuple[int, int, int]] = []  # (gen, teacher, student)
        self.dropped = 0
        self._root_memo: Dict[int, int] = {}

    def add(self, pid: int, parent: int, birth: Optional[int],
            kind: str) -> None:
        self.parent[pid] = parent
        self.birth[pid] = birth
        self.kind[pid] = kind

    def _ensure(self, pid: int) -> None:
        # a pid referenced by a surviving edge whose own mint edge was
        # dropped: keep it as an implicit root so walks never KeyError
        if pid >= 0 and pid not in self.parent:
            self.add(pid, -1, None, KIND_SEED)

    def root(self, pid: int) -> int:
        """Walk parents to the founding root (memoized)."""
        chain = []
        while pid not in self._root_memo:
            chain.append(pid)
            self._ensure(pid)
            parent = self.parent.get(pid, -1)
            if parent < 0 or parent not in self.parent:
                self._root_memo[pid] = pid
                break
            pid = parent
        root = self._root_memo[pid if pid in self._root_memo else chain[-1]]
        for p in chain:
            self._root_memo[p] = root
        return root

    @property
    def alive(self) -> List[int]:
        return [p for p in self.parent if p not in self.ended]


def build_forest(epoch: dict) -> Forest:
    """Reconstruct one epoch's forest from its header + window rows."""
    header = epoch["header"]
    f = Forest()
    base = int(header.get("pid_base", 0))
    start = int(header.get("start_gen", 0))
    for pid in range(base, base + int(header.get("n", 0))):
        f.add(pid, -1, start, KIND_SEED)
    for w in epoch["windows"]:
        f.dropped += int(w.get("edges_dropped", 0))
        for kind, gen, src, dst, prev in w.get("edges", ()):
            if kind == EDGE_ATTACK:
                f._ensure(src)
                f.add(dst, src, gen, KIND_ATTACK)
                if prev >= 0:
                    f._ensure(prev)
                    f.ended.setdefault(prev, gen)
            elif kind == EDGE_RESPAWN:
                f.add(dst, -1, gen, KIND_RESPAWN)
                if prev >= 0:
                    f._ensure(prev)
                    f.ended.setdefault(prev, gen)
            elif kind == EDGE_LEARN:
                f._ensure(src)
                f._ensure(dst)
                f.learn_edges.append((gen, src, dst))
    return f


def dominant_lineages(f: Forest, top: int = 10) -> List[dict]:
    """Roots ranked by live descendants (the dominant-lineage table)."""
    live: Dict[int, int] = {}
    total: Dict[int, int] = {}
    for pid in f.parent:
        r = f.root(pid)
        total[r] = total.get(r, 0) + 1
        if pid not in f.ended:
            live[r] = live.get(r, 0) + 1
    rows = [
        {"root": r, "alive": live.get(r, 0), "minted": total[r],
         "kind": f.kind.get(r, KIND_SEED), "birth": f.birth.get(r)}
        for r in total]
    rows.sort(key=lambda d: (-d["alive"], -d["minted"], d["root"]))
    return rows[:top]


def survival_stats(f: Forest) -> dict:
    """Lifespan distribution of terminated instances plus a survival
    curve (fraction of terminated clones living >= g generations)."""
    spans = sorted(
        f.ended[p] - f.birth[p]
        for p in f.ended if f.birth.get(p) is not None
        and f.ended[p] >= f.birth[p])
    if not spans:
        return {"terminated": 0}
    n = len(spans)

    def q(frac: float) -> int:
        return spans[min(n - 1, int(frac * n))]

    horizon = spans[-1]
    points = []
    for g in sorted({0, 1, 2, 5, 10, 20, 50, 100, horizon}):
        if g > horizon:
            continue
        surviving = sum(1 for s in spans if s >= g)
        points.append({"generations": g, "fraction": round(surviving / n, 4)})
    return {
        "terminated": n,
        "lifespan": {"min": spans[0], "p50": q(0.5), "p90": q(0.9),
                     "max": horizon},
        "curve": points,
    }


def graph_stats(f: Forest, top: int = 5) -> dict:
    """Attack / imitation graph statistics from the surviving edges."""
    attacks: Dict[int, int] = {}
    for pid, kind in f.kind.items():
        if kind == KIND_ATTACK:
            src = f.parent.get(pid, -1)
            if src >= 0:
                attacks[src] = attacks.get(src, 0) + 1
    teaches: Dict[int, int] = {}
    for _gen, teacher, _student in f.learn_edges:
        teaches[teacher] = teaches.get(teacher, 0) + 1

    def summary(deg: Dict[int, int]) -> dict:
        if not deg:
            return {"edges": 0}
        counts = sorted(deg.values(), reverse=True)
        return {
            "edges": sum(counts),
            "actors": len(deg),
            "max_out_degree": counts[0],
            "top": [{"pid": p, "count": c} for p, c in
                    sorted(deg.items(), key=lambda kv: (-kv[1], kv[0]))[:top]],
        }

    return {"attack": summary(attacks), "imitation": summary(teaches),
            "edges_dropped": f.dropped}


def _sum_matrices(a: Optional[List[List[int]]], b: List[List[int]]):
    if a is None:
        return [row[:] for row in b]
    return [[x + y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def _fix_docs(w: dict) -> List[Tuple[Optional[str], dict]]:
    if "fixpoints" in w:
        return [(None, w["fixpoints"])]
    return list(w.get("fixpoints_by_type", {}).items())


def basin_matrix(windows: List[dict]) -> Dict[Optional[str], list]:
    """Per-type (or ``None``-keyed homogeneous) transition-matrix sums."""
    out: Dict[Optional[str], list] = {}
    for w in windows:
        for tname, doc in _fix_docs(w):
            trans = doc.get("transitions")
            if trans:
                out[tname] = _sum_matrices(out.get(tname), trans)
    return out


def census_trajectory(windows: List[dict]) -> List[dict]:
    """``[{gen, <basin counts or per-type census>}, ...]`` per window —
    what the viz fixpoint-census panel plots."""
    rows = []
    for w in windows:
        row: dict = {"gen": w.get("gen_end"), "probe": w.get("kind") == "probe"}
        for tname, doc in _fix_docs(w):
            census = doc.get("census", {})
            if tname is None:
                row.update(census)
            else:
                row[tname] = census
        rows.append(row)
    return rows


def summarize_dynamics(run_dir: str, top: int = 10) -> dict:
    """Machine-readable dynamics summary of a run dir (JSON-ready; the
    JAX package's ``report --dynamics --json`` payload)."""
    epochs = load_lineage(run_dir)
    epoch = epochs[-1]
    windows = epoch["windows"]
    forest = build_forest(epoch)
    alive = forest.alive
    return {
        "run_dir": os.path.abspath(run_dir),
        "epochs": len(epochs),
        "header": epoch["header"],
        "windows": len(windows),
        "minted": len(forest.parent),
        "alive": len(alive),
        "dominant_lineages": dominant_lineages(forest, top=top),
        "survival": survival_stats(forest),
        "graph": graph_stats(forest),
        "basin_matrix": {k if k is not None else "": v
                         for k, v in basin_matrix(windows).items()},
        "census_trajectory": census_trajectory(windows),
        "basins": list(BASIN_NAMES),
    }
