"""A helper of the port's tests: gloo worlds of ranks on the CPU that run
a list of sharded-soup cases in one spawn and hand the gathered results
back as numpy.

``Worlds({name: (ranks, cases)})`` starts each world's ranks as
processes of this file (each imports torch and ``srnn_tpu_torch`` only,
never jax), every world at once; each forms one process group on a file
store and runs its cases on a mesh of all its ranks -- 1-D ``"soup"``,
or ``(slices, soup)`` for a case with ``slices`` -- then the cases handed
to :meth:`Worlds.feed`
(made meanwhile by the caller, say from the JAX package's runs), and
``wait()`` returns each world's rank 0 dict of results, one entry per
case name.

A case is a dict: ``kind`` 'soup' | 'multi'; ``cfg`` the port's config;
``slices`` (a multislice mesh of that many slices; the result then
also holds the mesh's (axis names, shape, size) as ``mesh``); the
start, ``seed`` (an int: ``make_sharded_state``) or ``state`` (the
full state as numpy arrays, ``convert``'s keyword arguments); ``gens``;
``step`` (run ``sharded_evolve_step`` once a generation instead of one
``sharded_evolve``); ``draws`` (one generation's draws per generation,
global; for a row-major soup a dict rank -> that rank's draws), handed
to the port in place of its own; ``carries`` (metrics, health and
lineage on ``sharded_evolve``).  A result holds the final state, its
``sharded_count``, the carries and, in step mode, each generation's
events.
"""

import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


class Worlds:
    """Worlds started at once, fed more cases (:meth:`feed`) and waited
    for later (:meth:`wait`), so that the caller can work meanwhile."""

    def __init__(self, jobs):
        self.tmp = tempfile.TemporaryDirectory()
        env = dict(os.environ, PYTHONPATH=REPO, SRNN_SETUPS_PLATFORM="cpu",
                   OMP_NUM_THREADS="1")
        self.procs = {}
        for name, (world, cases) in jobs.items():
            wdir = os.path.join(self.tmp.name, f"w{len(self.procs)}")
            os.makedirs(wdir)
            job = os.path.join(wdir, "job.pkl")
            with open(job, "wb") as f:
                pickle.dump(cases, f)
            self.procs[name] = (wdir, [subprocess.Popen(
                [sys.executable, __file__, str(r), str(world),
                 os.path.join(wdir, "store"), job, wdir],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for r in range(world)])
        self.fed = False

    def feed(self, cases):
        """Hand each world (``{name: cases}``; a world not named gets
        none) the cases it runs after its first ones."""
        for name, (wdir, _) in self.procs.items():
            tmp = os.path.join(wdir, "more.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(cases.get(name, []), f)
            os.replace(tmp, os.path.join(wdir, "more.pkl"))
        self.fed = True

    def wait(self, timeout: float = 300.0):
        """Each world's rank 0 results by name (feeding none where
        :meth:`feed` was not called); a failed world raises with its
        ranks' output."""
        out = {}
        try:
            if not self.fed:
                self.feed({})
            for name, (wdir, ranks) in self.procs.items():
                logs = [p.communicate(timeout=timeout)[0] for p in ranks]
                if any(p.returncode for p in ranks):
                    raise RuntimeError(f"world {name} failed:\n" + "\n".join(
                        f"--- rank {r} rc {p.returncode}\n{o[-4000:]}"
                        for r, (p, o) in enumerate(zip(ranks, logs))))
                with open(os.path.join(wdir, "out0.pkl"), "rb") as f:
                    out[name] = pickle.load(f)
        finally:
            for _, ranks in self.procs.values():
                for p in ranks:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            self.tmp.cleanup()
        return out


def _np(x):
    """Tensors of a result as numpy (bfloat16 widened exactly)."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    if isinstance(x, torch.Generator):
        return None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _np(v) for f, v in zip(x._fields, x)}
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x


class _Feed:
    """The draws a case hands over, one generation after another, in
    place of the port's draw function: ``convert(config, device, draws)``
    makes each the tensors the port draws."""

    def __init__(self, draws, convert):
        self.draws = list(draws)
        self.convert = convert
        self.at = 0

    def __call__(self, config, gen, device, *_rest):
        d = self.draws[self.at]
        self.at += 1
        return self.convert(config, device, d)


def _run_case(case, mesh, rank):
    import torch

    from srnn_tpu_torch import convert, multisoup, soup
    from srnn_tpu_torch import parallel as par
    from srnn_tpu_torch.distributed.hostio import fetch_tree
    from srnn_tpu_torch.parallel import sharded_soup
    from srnn_tpu_torch.telemetry.dynamics import (place_lineage,
                                                   seed_lineage,
                                                   seed_lineage_blocks)

    cfg, multi = case["cfg"], case["kind"] == "multi"
    if "seed" in case:
        state = (par.make_sharded_multi_state if multi
                 else par.make_sharded_state)(cfg, mesh, case["seed"])
    else:
        full = (convert.multisoup_state_from_arrays if multi
                else convert.soup_state_from_arrays)(**case["state"],
                                                     device="cpu")
        state = (par.place_sharded_multi_state if multi
                 else par.place_sharded_state)(mesh, full)
    draws = case.get("draws")
    if isinstance(draws, dict):
        draws = draws[rank]
    if multi:
        conv = lambda c, dev, d: multisoup._resolve_draws(c, None, dev, d)
    elif cfg.layout == "rowmajor":
        conv = lambda c, dev, d: sharded_soup._rank_draws(
            c, d, dev, c.size // mesh.size)
    else:
        conv = lambda c, dev, d: soup._resolve_draws(c, None, dev, d)
    feed = _Feed(draws, conv) if draws is not None else None
    out = {}
    if case.get("step"):
        step = par.sharded_evolve_multi_step if multi \
            else par.sharded_evolve_step
        events = []
        for g in range(case["gens"]):
            state, ev = step(cfg, mesh, state,
                             None if feed is None else feed.draws[g])
            events.append(_gather_events(ev, mesh))
        out["events"] = events
    else:
        kw = {}
        if case.get("carries"):
            kw = dict(metrics=True, health=True, lineage=True,
                      lineage_capacity=case.get("capacity", 256))
            sizes = cfg.sizes if multi else (cfg.size,)
            lin = seed_lineage_blocks(sizes, device="cpu") if multi \
                else seed_lineage(cfg.size, device="cpu")
            kw["lineage_state"] = tuple(place_lineage(mesh, x) for x in lin) \
                if multi else place_lineage(mesh, lin)
        patched = (multisoup, "draw_multi") if multi else (
            (sharded_soup, "draw_rowmajor") if cfg.layout == "rowmajor"
            else (soup, "draw"))
        own = getattr(*patched)
        if feed is not None:
            setattr(*patched, feed)
        run = par.sharded_evolve_multi if multi else par.sharded_evolve
        try:
            res = run(cfg, mesh, state, case["gens"], **kw)
        finally:
            setattr(*patched, own)
        if kw:
            state, m, h, (lin, win, stats) = res
            out["carries"] = _np((m, h, fetch_tree(lin, mesh)
                                  if not multi else
                                  tuple(fetch_tree(x, mesh) for x in lin),
                                  win, stats))
        else:
            state = res
    count = (par.sharded_count_multi if multi
             else par.sharded_count)(cfg, mesh, state)
    out["state"] = _np(fetch_tree(state, mesh))
    out["count"] = _np(count)
    torch.distributed.barrier()
    return out


def _gather_events(ev, mesh):
    """A step's events, every rank's lanes side by side."""
    def one(x):
        return tuple(mesh.gather(v) for v in x) if isinstance(x, tuple) \
            else mesh.gather(x)

    return _np(type(ev)(*(one(x) for x in ev)))


def _main(rank: int, world: int, store: str, job: str, out_dir: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(job, "rb") as f:
        cases = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from srnn_tpu_torch import parallel as par

    meshes = {}

    def run(case):
        slices = case.get("slices")
        if slices not in meshes:
            meshes[slices] = par.multislice_soup_mesh(slices, device="cpu") \
                if slices else par.soup_mesh(device="cpu")
        mesh = meshes[slices]
        out = _run_case(case, mesh, rank)
        if slices:
            out["mesh"] = (mesh.axis_names, mesh.shape, mesh.size)
        results[case["name"]] = out

    results = {}
    for case in cases:
        run(case)
    more = os.path.join(out_dir, "more.pkl")
    deadline = time.monotonic() + 300.0
    while not os.path.exists(more):
        if time.monotonic() > deadline:
            raise TimeoutError("no second list of cases within 300 s")
        time.sleep(0.02)
    with open(more, "rb") as f:
        for case in pickle.load(f):
            run(case)
    if rank == 0:
        with open(os.path.join(out_dir, "out0.pkl"), "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
          sys.argv[5])
