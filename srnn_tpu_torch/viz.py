"""Analysis & visualization of run-dir artifacts (reference layer L5); a
copy of ``srnn_tpu/viz.py``.

Reference tools (``visualization.py``, ``line_plots.py``, ``bar_plot.py``,
``box_plots.py``) dill-load experiment artifacts and emit offline plotly
HTML.  This module renders the same views from the npz/json artifacts the
port's runs write (the JAX package's formats), using matplotlib for the
PNGs.  matplotlib is imported inside the PNG renderers only: the
trajectory extraction (``render_columns``, ``particle_trajectories``,
``pca2_fit``, ``extract_pca``) and the HTML view (``viz_html``) run
without it.

  * :func:`plot_latent_trajectories_3d` — per-particle weight trajectories
    embedded by PCA(2) fit on ALL trajectories stacked
    (``visualization.py:109-115``), drawn as 3-D lines with x/y = PCA
    components, z = time, red start / black end markers
    (``visualization.py:119-154``).
  * :func:`plot_latent_trajectories` — 2-D t-SNE scatter of trajectory
    points (``visualization.py:43-93``).
  * :func:`line_plot` — fixpoint-rate-vs-sweep curves from
    ``all_data``/``all_names`` (``line_plots.py:27-81``).
  * :func:`plot_bars` — stacked class-distribution bars from
    ``all_counters`` (``bar_plot.py:28-59``).
  * :func:`plot_box` — time-to-vergence / time-as-fixpoint boxes per
    perturbation scale (``box_plots.py:28-94``).
  * :func:`search_and_apply` — recursive walker that renders every known
    artifact that doesn't have an output image yet
    (``visualization.py:255-275``), CLI
    ``python -m srnn_tpu_torch.viz -i <dir> [--redo] [-o OUT]``.

Trajectory views are emitted twice per artifact: a static PNG and an
interactive, dependency-free HTML (``viz_html.py``) — the stand-in for the
reference's offline plotly HTML output.

Soup trajectories are split at uid changes, so each respawned particle gets
its own line — the equivalent of the reference's per-uid
``historical_particles`` registry (``soup.py:37-43``).
"""

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .experiment import load_artifact
from .ops.predicates import CLASS_NAMES

CLASS_COLORS = ("#d62728", "#1f77b4", "#2ca02c", "#9467bd", "#7f7f7f")


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first PNG
    render (a host without matplotlib runs everything else)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# trajectory extraction
# ---------------------------------------------------------------------------


MAX_RENDER_PARTICLES = 2048


def render_columns(n: int, max_particles: int = MAX_RENDER_PARTICLES
                   ) -> np.ndarray:
    """THE deterministic even-stride column subset used everywhere a
    mega-scale population is sampled (renders, packaged trajectory
    samples) — one definition so plots and committed samples can never
    silently diverge."""
    if n <= max_particles:
        return np.arange(n)
    return np.unique(np.linspace(0, n - 1, max_particles).astype(int))


def particle_trajectories(artifact: Dict[str, np.ndarray],
                          max_particles: Optional[int] = None,
                          ) -> List[Dict[str, np.ndarray]]:
    """Artifact -> list of {'trajectory': (T, P), 'time': (T,), 'uid': int}.

    Accepts both artifact shapes the setups write:
      * experiment trajectories: ``{"weights": (T, N, P)}`` — one particle
        per trial column, uid = column index;
      * soup histories: ``{"weights": (G, N, P), "uids": (G, N)}`` — slots
        are split wherever the uid changes (respawn), mirroring
        ``build_from_soup_or_exp`` (``visualization.py:27-40``).

    ``max_particles`` caps the rendered slots by a deterministic even
    stride over the columns — a mega-soup capture holds 1M slots, and a
    plot of 1M lines is neither readable nor computable; ``None`` keeps
    every column (the paper-scale artifacts).
    """
    w = np.asarray(artifact["weights"])
    if w.ndim != 3:
        raise ValueError(f"expected (T, N, P) weights, got {w.shape}")
    t_len, n, _ = w.shape
    uids = np.asarray(artifact["uids"]) if "uids" in artifact else \
        np.broadcast_to(np.arange(n, dtype=np.int64), (t_len, n))
    cols = range(n) if max_particles is None else \
        render_columns(n, max_particles)
    out = []
    for col in cols:
        col_uids = uids[:, col]
        # contiguous segments of constant uid = one particle lifetime
        breaks = np.flatnonzero(np.diff(col_uids) != 0) + 1
        for seg in np.split(np.arange(t_len), breaks):
            traj = w[seg, col]
            finite = np.isfinite(traj).all(axis=-1)
            traj = traj[finite]
            if len(traj) < 1:
                continue
            out.append({
                "trajectory": traj,
                "time": seg[finite].astype(np.int64),
                "uid": int(col_uids[seg[0]]),
            })
    return out


def pca2_fit(stacked: np.ndarray):
    """PCA to 2 components via SVD (replaces the reference's
    ``sklearn.manifold.t_sne.PCA`` import from a private pre-0.22 path,
    ``visualization.py:17``). Returns (mean, (P, 2) components)."""
    mean = stacked.mean(axis=0)
    centered = stacked - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return mean, vt[:2].T


# ---------------------------------------------------------------------------
# plots
# ---------------------------------------------------------------------------


def extract_pca(artifact, max_particles: Optional[int] = MAX_RENDER_PARTICLES):
    """Shared per-artifact preprocessing for the 3-D trajectory views:
    -> (trajs, mean, (P, 2) components).  Compute once, render many.
    Renders cap at ``MAX_RENDER_PARTICLES`` deterministically-strided
    slots so mega-scale captures stay plottable."""
    trajs = particle_trajectories(artifact, max_particles=max_particles)
    if not trajs:
        raise ValueError("no finite trajectories to plot")
    mean, comps = pca2_fit(np.vstack([t["trajectory"] for t in trajs]))
    return trajs, mean, comps


def plot_latent_trajectories_3d(artifact, out_path: str, title: str = "",
                                extracted=None) -> str:
    """3-D PCA trajectory plot (``plot_latent_trajectories_3D``,
    ``visualization.py:109-154``): PCA fit on all trajectories stacked,
    per-particle lines, red start / black end markers."""
    plt = _pyplot()
    trajs, mean, comps = extracted if extracted is not None else extract_pca(artifact)
    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_subplot(projection="3d")
    cmap = plt.get_cmap("tab20")
    for i, t in enumerate(trajs):
        xy = (t["trajectory"] - mean) @ comps
        z = t["time"]
        ax.plot(xy[:, 0], xy[:, 1], z, lw=1.0, color=cmap(i % 20), alpha=0.8)
        ax.scatter(*xy[0], z[0], color="red", s=14)      # start marker
        ax.scatter(*xy[-1], z[-1], color="black", s=14)  # end marker
    ax.set_xlabel("PCA 1")
    ax.set_ylabel("PCA 2")
    ax.set_zlabel("time")
    ax.set_title(title or "weight-space trajectories (PCA)")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_latent_trajectories(artifact, out_path: str, title: str = "",
                             perplexity: float = 12.0) -> str:
    """2-D t-SNE scatter of all trajectory points, colored per particle
    (``plot_latent_trajectories``, ``visualization.py:43-93``)."""
    plt = _pyplot()
    from sklearn.manifold import TSNE

    # t-SNE is ~quadratic in POINTS (= particles x frames), so cap the
    # particle count so the stacked rows stay bounded — a mega-scale
    # capture would otherwise hang the embedding even after the generic
    # MAX_RENDER_PARTICLES cap
    t_len = np.asarray(artifact["weights"]).shape[0]
    cap = min(MAX_RENDER_PARTICLES, max(8, 20_000 // max(1, t_len)))
    trajs = particle_trajectories(artifact, max_particles=cap)
    stacked = np.vstack([t["trajectory"] for t in trajs])
    perplexity = min(perplexity, max(2.0, (len(stacked) - 1) / 3))
    emb = TSNE(n_components=2, perplexity=perplexity,
               init="pca", random_state=0).fit_transform(stacked)
    fig, ax = plt.subplots(figsize=(8, 7))
    cmap = plt.get_cmap("tab20")
    pos = 0
    for i, t in enumerate(trajs):
        n = len(t["trajectory"])
        seg = emb[pos:pos + n]
        ax.plot(seg[:, 0], seg[:, 1], lw=0.8, color=cmap(i % 20), alpha=0.7)
        pos += n
    ax.set_title(title or "weight-space trajectories (t-SNE)")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def line_plot(all_data: Sequence[dict], all_names: Sequence[str],
              out_path: str, xlabel: str = "trains per self-attack",
              ylabel: str = "fixpoint rate") -> str:
    """Sweep curves (``line_plots.line_plot``, ``line_plots.py:27-81``).
    Each entry contributes its 'ys' (and 'zs' dashed, when present)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for i, (data, name) in enumerate(zip(all_data, all_names)):
        color = plt.get_cmap("tab10")(i % 10)
        ax.plot(data["xs"], data["ys"], "-o", color=color, label=str(name))
        if "zs" in data:
            ax.plot(data["xs"], data["zs"], "--s", color=color,
                    label=f"{name} (non-zero)")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_bars(all_counters: np.ndarray, all_names: Sequence[str],
              out_path: str) -> str:
    """Stacked class-distribution bars (``bar_plot.plot_bars``,
    ``bar_plot.py:28-59``): one bar per experiment, stacked by the 5
    classes."""
    plt = _pyplot()
    counters = np.atleast_2d(np.asarray(all_counters))
    fig, ax = plt.subplots(figsize=(1.8 + 1.1 * len(counters), 5))
    x = np.arange(len(counters))
    bottom = np.zeros(len(counters), dtype=float)
    for cls in range(counters.shape[1]):
        vals = counters[:, cls].astype(float)
        ax.bar(x, vals, bottom=bottom, color=CLASS_COLORS[cls],
               label=CLASS_NAMES[cls])
        bottom += vals
    ax.set_xticks(x)
    ax.set_xticklabels([str(n)[:28] for n in all_names], rotation=20,
                       ha="right", fontsize=7)
    ax.set_ylabel("count")
    ax.legend(fontsize=7)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_box(data: Dict[str, np.ndarray], out_path: str,
             trials: Optional[int] = None) -> str:
    """Perturbation-robustness boxes (``box_plots.plot_box``,
    ``box_plots.py:28-94``): per scale level, boxplots of time-to-vergence
    and time-as-fixpoint."""
    plt = _pyplot()
    xs, ys, zs = (np.asarray(data[k]) for k in ("xs", "ys", "zs"))
    scales = sorted(set(xs.tolist()), reverse=True)
    by_scale_y = [ys[xs == s] for s in scales]
    by_scale_z = [zs[xs == s] for s in scales]
    fig, axes = plt.subplots(1, 2, figsize=(12, 5), sharey=True)
    for ax, series, name in zip(axes, (by_scale_y, by_scale_z),
                                ("time to vergence", "time as fixpoint")):
        ax.boxplot(series, tick_labels=[f"{s:.0e}" for s in scales])
        ax.set_xlabel("perturbation scale")
        ax.set_title(name)
        ax.tick_params(axis="x", rotation=45)
    axes[0].set_ylabel("steps")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_histogram(bars_dict_list: Sequence[dict], out_path: str,
                   title: str = "") -> str:
    """Generic categorical count histogram (``visualization.plot_histogram``,
    ``visualization.py:183-206``): one series per dict, counted over its
    'name' categories."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4.5))
    cmap = plt.get_cmap("RdYlBu")
    names = []
    for d in bars_dict_list:
        xs = d.get("name", "unnamed")
        names += list(np.atleast_1d(xs))
    cats = sorted(set(names))
    for i, d in enumerate(bars_dict_list):
        xs = np.atleast_1d(d.get("name", "unnamed"))
        counts = [int(np.sum(xs == c)) for c in cats]
        offset = (i - (len(bars_dict_list) - 1) / 2) * 0.8 / max(len(bars_dict_list), 1)
        ax.bar(np.arange(len(cats)) + offset,
               counts, width=0.8 / max(len(bars_dict_list), 1),
               color=cmap(i / max(len(bars_dict_list) - 1, 1)))
    ax.set_xticks(np.arange(len(cats)))
    ax.set_xticklabels(cats, rotation=20, ha="right", fontsize=8)
    ax.set_ylabel("count")
    if title:
        ax.set_title(title)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def line_plot_with_bands(line_dict_list: Sequence[dict], out_path: str,
                         title: str = "") -> str:
    """Generic mean curves with shaded upper/lower bands
    (``visualization.line_plot``, ``visualization.py:209-252``): each dict
    carries 'x', 'main_y', 'upper_y', 'lower_y', and optionally 'name'."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for i, d in enumerate(line_dict_list):
        color = plt.get_cmap("RdYlGn")(i / max(len(line_dict_list) - 1, 1))
        x = np.asarray(d["x"])
        ax.fill_between(x, np.asarray(d["lower_y"]), np.asarray(d["upper_y"]),
                        color=color, alpha=0.4, lw=0)
        ax.plot(x, np.asarray(d["main_y"]), color=color,
                label=str(d.get("name", f"series {i}")))
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    if title:
        ax.set_title(title)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


# ---------------------------------------------------------------------------
# run-dir walker
# ---------------------------------------------------------------------------

def _render_traj_views(artifact, run_dir: str, stem: str, title: str = "") -> List[str]:
    """Static PNG + interactive HTML (the reference emits offline plotly
    HTML per artifact, ``visualization.py:119-179``).  Trajectory extraction
    and the PCA fit run once, shared by both renderers."""
    from .viz_html import write_html_trajectories_3d

    extracted = extract_pca(artifact)
    return [
        plot_latent_trajectories_3d(
            artifact, os.path.join(run_dir, stem + ".png"), title=title,
            extracted=extracted),
        write_html_trajectories_3d(
            artifact, os.path.join(run_dir, stem + ".html"), title=title,
            extracted=extracted),
    ]


def _render_trajectories(run_dir: str, path: str) -> List[str]:
    art = load_artifact(path)
    outs = []
    if "weights" in art:  # soup-style single artifact
        outs += _render_traj_views(art, run_dir, "trajectories_3d")
    else:  # per-variant dict of (T, N, P) histories
        for variant in sorted({k.split("/")[0] for k in art}):
            sub = {"weights": art[f"{variant}/__value__"]} \
                if f"{variant}/__value__" in art else {"weights": art[variant]}
            outs += _render_traj_views(
                sub, run_dir, f"trajectories_3d_{variant}", title=variant)
    return outs


def _render_soup(run_dir: str, path: str) -> List[str]:
    return _render_traj_views(load_artifact(path), run_dir, "soup_trajectories_3d")


def _render_sweep(run_dir: str, path: str) -> List[str]:
    data = load_artifact(path)
    names_path = os.path.join(os.path.dirname(path), "all_names")
    names = load_artifact(names_path) if os.path.exists(names_path + ".json") \
        else [f"series {i}" for i in range(len(data))]
    return [line_plot(data, names, os.path.join(run_dir, "sweep.png"))]


def _render_counters(run_dir: str, path: str) -> List[str]:
    counters = load_artifact(path)
    names_path = os.path.join(os.path.dirname(path), "all_names")
    names = load_artifact(names_path) if os.path.exists(names_path + ".json") \
        else [f"exp {i}" for i in range(np.atleast_2d(counters).shape[0])]
    return [plot_bars(counters, names, os.path.join(run_dir, "counters.png"))]


def _render_variation(run_dir: str, path: str) -> List[str]:
    return [plot_box(load_artifact(path), os.path.join(run_dir, "variation_box.png"))]


def _render_mega_curve(run_dir: str, path: str) -> List[str]:
    """Class-count trajectory of a mega run, from the structured event log
    (``config.json`` marks a mega run dir; events carry per-chunk
    ``generation`` + ``counts``).  Homogeneous ``mega_soup`` events hold one
    name->count dict; heterogeneous ``mega_multisoup`` events hold a list of
    per-type 5-class count arrays (ww/agg/rnn — the entry point's fixed
    blend), rendered one panel per type."""
    plt = _pyplot()
    import json as _json

    events_path = os.path.join(os.path.dirname(path), "events.jsonl")
    if not os.path.exists(events_path):
        return []
    gens, rows = [], []
    with open(events_path) as f:
        for line in f:
            try:
                ev = _json.loads(line)
            except ValueError:
                continue
            if "generation" not in ev or "counts" not in ev:
                continue
            gens.append(ev["generation"])
            rows.append(ev["counts"])
    multi = bool(rows) and isinstance(rows[0], list)
    # always write the marker PNG — even with no counts yet — so the walk
    # stays idempotent; staleness vs the growing events.jsonl is handled by
    # the mtime rule in search_and_apply
    if multi:
        n_types = len(rows[0])
        # per-type panel titles come from the run's own config.json when the
        # entry point recorded them (mega_multisoup writes "type_names");
        # legacy run dirs fall back to the historical fixed blend
        type_names = ("weightwise", "aggregating", "recurrent")
        try:
            recorded = load_artifact(path).get("type_names")
            if recorded:
                type_names = tuple(str(n) for n in recorded)
        except Exception:
            pass
        fig, axes = plt.subplots(1, n_types, figsize=(6 * n_types, 5),
                                 sharex=True)
        axes = [axes] if n_types == 1 else list(axes)
        for t, ax in enumerate(axes):
            for i, name in enumerate(CLASS_NAMES):
                ax.plot(gens, [r[t][i] for r in rows],
                        color=CLASS_COLORS[i], label=name)
            ax.set_title(type_names[t] if t < len(type_names)
                         else f"type {t}")
            ax.set_xlabel("generation")
            ax.grid(alpha=0.3)
        axes[0].set_ylabel("particles")
        axes[0].legend(fontsize=8)
    else:
        fig, ax = plt.subplots(figsize=(9, 5))
        for i, name in enumerate(CLASS_NAMES):
            ax.plot(gens, [r.get(name, 0) for r in rows],
                    color=CLASS_COLORS[i], label=name)
        ax.set_xlabel("generation")
        ax.set_ylabel("particles")
        if gens:
            ax.legend(fontsize=8)
        else:
            ax.set_title("no generation counts logged yet")
        ax.grid(alpha=0.3)
    out = os.path.join(run_dir, "mega_curve.png")
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return [out]


#: basin label colors for the replication-dynamics panels
#: (telemetry.dynamics.BASIN_NAMES order: fixpoint/drifting/divergent/zero)
BASIN_COLORS = ("tab:green", "tab:blue", "tab:red", "tab:gray")


def _render_dynamics(run_dir: str, path: str) -> List[str]:
    """Replication-dynamics panels of a ``--lineage`` run, from the
    ``lineage.jsonl`` window stream (``telemetry.dynamics``): the fixpoint
    census trajectory (per-type subplots for a multisoup run) and the
    per-window event-edge/birth rates.  Renders the CURRENT (last) epoch,
    like ``report --dynamics``."""
    plt = _pyplot()
    from .telemetry.dynamics import BASIN_NAMES
    from .telemetry.genealogy import census_trajectory, load_lineage

    epoch = load_lineage(path + ".jsonl")[-1]
    windows = epoch["windows"]
    traj = census_trajectory(windows)
    multi = bool(traj) and any(
        isinstance(v, dict) for row in traj for v in row.values())
    type_names = sorted({k for row in traj for k, v in row.items()
                         if isinstance(v, dict)}) if multi else [None]

    n_panels = len(type_names)
    fig, axes = plt.subplots(1, n_panels + 1,
                             figsize=(6 * (n_panels + 1), 5))
    axes = list(np.atleast_1d(axes))
    gens = [row.get("gen") for row in traj]
    for t, tname in enumerate(type_names):
        ax = axes[t]
        for i, basin in enumerate(BASIN_NAMES):
            if multi:
                ys = [(row.get(tname) or {}).get(basin, 0) for row in traj]
            else:
                ys = [row.get(basin, 0) for row in traj]
            ax.plot(gens, ys, color=BASIN_COLORS[i], label=basin)
        ax.set_title(f"fixpoint census — {tname}" if tname
                     else "fixpoint census")
        ax.set_xlabel("generation")
        ax.set_ylabel("particles")
        ax.grid(alpha=0.3)
        if gens:
            ax.legend(fontsize=8)
        else:
            ax.set_title("no dynamics windows logged yet")

    # event-rate panel: births + recorded/dropped edges per window
    ax = axes[-1]
    wrows = [w for w in windows if w.get("kind") == "window"]
    wg = [w.get("gen_end") for w in wrows]
    for key, label, color in (
            ("births_attack", "attack births", "tab:purple"),
            ("births_respawn", "respawn births", "tab:orange"),
            ("edges_dropped", "edges dropped", "tab:red")):
        ax.plot(wg, [int(w.get(key, 0)) for w in wrows], label=label,
                color=color)
    ax.plot(wg, [len(w.get("edges", ())) for w in wrows],
            label="edges recorded", color="tab:blue")
    ax.set_title("replication events per window")
    ax.set_xlabel("generation")
    ax.set_ylabel("count")
    ax.grid(alpha=0.3)
    if wg:
        ax.legend(fontsize=8)
    out = os.path.join(run_dir, "dynamics.png")
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return [out]


#: artifact basename -> (renderer(run_dir, artifact_path) -> [outputs],
#:                        output-file marker prefix)
RENDERERS = {
    "trajectorys": (_render_trajectories, "trajectories_3d"),
    "soup": (_render_soup, "soup_trajectories_3d"),
    "all_data": (_render_sweep, "sweep"),
    "all_counters": (_render_counters, "counters"),
    "data": (_render_variation, "variation_box"),
    "config": (_render_mega_curve, "mega_curve"),
    "lineage": (_render_dynamics, "dynamics"),
}


def search_and_apply(directory: str, redo: bool = False,
                     out_dir: Optional[str] = None) -> List[str]:
    """Walk ``directory`` recursively; for every known artifact whose run
    dir has no rendered .png yet (unless ``redo``), render all applicable
    views (``search_and_apply``, ``visualization.py:255-275``).

    Reference-format dill artifacts (``trajectorys.dill`` / ``soup.dill``,
    the exact filenames the reference CLI targets at
    ``visualization.py:255-275``) render too, via the 2019-artifact shim
    loader — a migration path for existing reference result trees.  Because
    such trees may be read-only, ``out_dir`` mirrors the directory
    structure somewhere writable for EVERY render in the walk (renderers
    keep reading their inputs from the source tree); ``None`` renders next
    to each artifact like the reference CLI does.
    """
    import re

    outputs = []
    directory = os.path.normpath(directory)
    for root, _dirs, files in os.walk(directory):
        render_dir = root if out_dir is None else os.path.join(
            out_dir, os.path.relpath(root, directory))
        # done-detection must look where the renders actually go
        rendered = files if render_dir == root else (
            sorted(os.listdir(render_dir)) if os.path.isdir(render_dir)
            else [])
        for f in sorted(files):
            if f not in ("trajectorys.dill", "soup.dill"):
                continue
            stem = f[:-5] + "_ref_trajectories_3d"
            done = all(stem + ext in rendered for ext in (".png", ".html"))
            if done and not redo:
                continue
            from . import reference_artifacts as ref
            try:
                art = ref.trajectory_artifact(
                    ref.load_artifact(os.path.join(root, f)))
                os.makedirs(render_dir, exist_ok=True)
                outputs += _render_traj_views(art, render_dir, stem)
            except Exception as e:  # empty without_particles() shells etc.
                print(f"viz: skipping {f} in {root}: {e!r}")
        # native trajectory stores render like soup artifacts; a multihost
        # capture leaves only per-process shards (soup.traj.pNNNNofMMMM) —
        # collapse those to their base name so the merged store renders once
        bases = set()
        for f in files:
            if f.endswith(".traj"):
                bases.add(f)
            else:
                m = re.match(r"(.+\.traj)\.p\d+of\d+$", f)
                if m:
                    bases.add(m.group(1))
        for f in sorted(bases):
            stem = f[:-5] + "_trajectories_3d"
            done = all(stem + ext in rendered for ext in (".png", ".html"))
            if done and not redo:
                continue
            from .utils import read_store_artifact
            from .utils.trajstore import store_shape
            try:
                os.makedirs(render_dir, exist_ok=True)
                # sample columns at READ time: a mega store's full frames
                # would exhaust host RAM long before the render cap runs
                n_slots = store_shape(os.path.join(root, f))[0]
                cols = render_columns(n_slots) \
                    if n_slots > MAX_RENDER_PARTICLES else None
                outputs += _render_traj_views(
                    read_store_artifact(os.path.join(root, f),
                                        columns=cols), render_dir, stem)
            except Exception as e:
                print(f"viz: skipping {f} in {root}: {e!r}")
        basenames = {f.rsplit(".", 1)[0] for f in files
                     if f.endswith((".npz", ".json", ".jsonl"))}
        for base, (renderer, marker) in RENDERERS.items():
            if base not in basenames:
                continue
            done_marker = any(f.endswith(".png") and f.startswith(marker)
                              for f in rendered)
            if base in ("trajectorys", "soup"):
                # trajectory renderers also emit the interactive HTML twin;
                # any PNG without its own .html sibling (pre-HTML run dirs,
                # partial multi-variant failure) must be revisited so the
                # walker backfills the missing HTML
                pngs = [f for f in rendered
                        if f.endswith(".png") and f.startswith(marker)]
                done_marker = bool(pngs) and all(
                    f[:-4] + ".html" in rendered for f in pngs)
            if base == "config" and done_marker:
                # events.jsonl is append-only (resumed runs grow it): the
                # curve is only done if at least as new as the event log
                png = os.path.join(render_dir, marker + ".png")
                ev = os.path.join(root, "events.jsonl")
                done_marker = not os.path.exists(ev) or \
                    os.path.getmtime(png) >= os.path.getmtime(ev)
            if base == "lineage" and done_marker:
                # lineage.jsonl is append-only too (resumes extend it)
                png = os.path.join(render_dir, marker + ".png")
                src = os.path.join(root, "lineage.jsonl")
                done_marker = not os.path.exists(src) or \
                    os.path.getmtime(png) >= os.path.getmtime(src)
            if done_marker and not redo:
                continue
            try:
                os.makedirs(render_dir, exist_ok=True)
                outputs += renderer(render_dir, os.path.join(root, base))
            except Exception as e:  # keep walking like the reference CLI
                print(f"viz: skipping {base} in {root}: {e!r}")
    return outputs


def main(argv=None):
    p = argparse.ArgumentParser(description="render plots for run-dir artifacts")
    p.add_argument("-i", "--in-dir", dest="in_dir", default="experiments",
                   help="directory tree to scan (visualization.py:20-24)")
    p.add_argument("--redo", action="store_true", help="re-render existing plots")
    p.add_argument("-o", "--out-dir", dest="out_dir", default=None,
                   help="mirror renders of reference .dill artifacts here "
                        "(for read-only result trees)")
    args = p.parse_args(argv)
    outs = search_and_apply(args.in_dir, redo=args.redo, out_dir=args.out_dir)
    for o in outs:
        print(o)
    return 0


if __name__ == "__main__":
    main()
