#!/usr/bin/env python3
"""Drive srnn_tpu_torch's main path on one NVIDIA GPU and hold every CUDA
kernel against its plain torch version.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build the kernels from ``srnn_tpu_torch/csrc`` (one nvcc per source, all
   at once) and print ptxas' register and spill report;
3. each kernel against its plain version on the same inputs at N = 1M,
   P = 14 (the weightwise 4-2-2-1 net), plus every instantiated activation at
   a small N; max abs / max rel difference, integer outputs equal, median
   times of kernel and plain version (CUDA events) beside the kernel's bound;
4. the main path through the public entry points, each of its three runs
   with the launch counts set to 0 just before it and checked just after
   against the launches that run must make: the N = 1M full-dynamics soup
   (attack 0.1, learn_from 0.1, severity 1, train 10, both removals, fused
   respawn draws), 20 generations with generation_impl='fused' (generation
   kernel only), then 20 with 'phases' (SGD kernel only); generations/s,
   class counts, unique uids; then the applications/s program, N = 1M,
   steps = 2000 (self-application kernel only);
5. a small soup on the card against the same soup on the CPU, fed the same
   draws, over 3 generations on both routes;
6. one JSON line listing every kernel, then the card's name and power limit,
   then the result line ``{"ok": true, "device": {...}}``.

It imports neither jax nor the JAX package.  Without a CUDA card, or outside
a checkout, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N = 1_000_000
BENCH_STEPS = 2000
GENERATIONS = 20
RTOL, ATOL = 1e-5, 1e-6


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- counting


def apply_ops_per_point(topo) -> int:
    """Multiplies and adds of one MLP forward on one duplex point."""
    return sum(b * (2 * a - 1) for a, b in topo.layer_shapes)


def sgd_ops_per_epoch(topo) -> int:
    """Operations of one epoch of the batch-1 chain, as the kernel needs
    them (linear activation): per sample the forward, the loss (sub, mul,
    add), dL/dpred, each layer's weight gradients, the back-propagated
    gradients of every layer above the first, and the update of every
    weight (mul, sub); per epoch the mean."""
    shapes = topo.layer_shapes
    back = sum(a * b for a, b in shapes)
    back += sum(a * (2 * b - 1) for a, b in shapes[1:])
    per_sample = apply_ops_per_point(topo) + 3 + 1 + back + 2 * topo.num_weights
    return topo.num_weights * per_sample + 1


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- helpers


def timed_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def compare(torch, what: str, got, ref):
    """Max abs / max rel difference over finite entries; the non-finite
    pattern must agree exactly.  Raises when outside RTOL/ATOL."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    fin = torch.isfinite(got) & torch.isfinite(ref)
    same_nonfinite = bool(((torch.isnan(got) == torch.isnan(ref))
                           & ((got == ref) | ~torch.isinf(ref))).all())
    diff = torch.where(fin, (got - ref).abs(), torch.zeros_like(got))
    rel = diff / ref.abs().clamp_min(torch.finfo(torch.float32).tiny)
    max_abs = float(diff.max())
    max_rel = float(torch.where(fin, rel, torch.zeros_like(rel)).max())
    within = bool(((diff <= ATOL + RTOL * ref.abs()) | ~fin).all())
    bitwise = bool(same_nonfinite and (diff == 0).all())
    log(f"  {what}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
        f"bitwise {bitwise} nonfinite_pattern_equal {same_nonfinite}")
    if not (within and same_nonfinite):
        raise AssertionError(f"{what}: outside rtol {RTOL} atol {ATOL}")
    return max_abs


def equal_ints(torch, what: str, got, ref) -> None:
    eq = bool(torch.equal(got.cpu(), ref.cpu()))
    log(f"  {what}: integer outputs equal {eq}")
    if not eq:
        raise AssertionError(f"{what}: integer outputs differ")


# ----------------------------------------------------------------- phases


def build_kernels():
    from srnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.nvcc_path()})")
    for name in _build.SOURCES:
        for line in _build.resource_usage(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def population(topo, n, gen, scale=1.0):
    from srnn_tpu_torch.init import init_popmajor_fused

    return (init_popmajor_fused(topo, gen, n, "cuda") * scale).contiguous()


def gen_operands(torch, topo, wT, gen, rate=0.1):
    """Kernel operands as the soup builds them: attacked lanes with their
    attacker's column, learners with their target's pre-attack column and
    that target's attacker."""
    from srnn_tpu_torch.init import init_popmajor_fused

    n = wT.shape[1]
    dev = wT.device
    has_attacker = torch.rand(n, generator=gen, device=dev) < rate
    atk_idx = torch.randint(0, n, (n,), generator=gen, device=dev)
    learn_gate = torch.rand(n, generator=gen, device=dev) < rate
    tgt = torch.randint(0, n, (n,), generator=gen, device=dev)
    attackerT = wT[:, atk_idx]
    return dict(freshT=init_popmajor_fused(topo, gen, n, "cuda"),
                attackerT=attackerT, has_attacker=has_attacker,
                otherT=wT[:, tgt], other_attackerT=attackerT[:, tgt],
                other_attacked=has_attacker[tgt], learn_gate=learn_gate)


def check_kernels(torch, rows):
    """Phase 3: every kernel against its plain version on the card."""
    from srnn_tpu_torch import Topology
    from srnn_tpu_torch.ops import cuda_generation as cg
    from srnn_tpu_torch.ops import cuda_ww, cuda_ww_train

    topo = Topology("weightwise", width=2, depth=2)
    p = topo.num_weights
    gen = torch.Generator(device="cuda").manual_seed(0)
    pts = apply_ops_per_point(topo)
    epoch_ops = sgd_ops_per_epoch(topo)

    # K1: damped inputs keep the chain finite
    log(f"K1 ww_apply N={N}")
    w_damped = population(topo, N, gen, 0.05)
    for steps in (1, 50):
        got = cuda_ww.ww_apply_population(topo, w_damped, steps)
        ref = cuda_ww.ww_apply_population_plain(topo, w_damped, steps)
        err = compare(torch, f"steps={steps}", got, ref)
    k1_ms = timed_ms(torch, lambda: cuda_ww.ww_apply_population(
        topo, w_damped, BENCH_STEPS), 5)
    k1_plain = timed_ms(torch, lambda: cuda_ww.ww_apply_population_plain(
        topo, w_damped, BENCH_STEPS), 1)
    b, by = bound_ms(2 * p * N * 4, BENCH_STEPS * N * p * pts)
    log(f"  steps={BENCH_STEPS}: kernel {k1_ms:.3f} ms, plain "
        f"{k1_plain:.3f} ms, bound {b:.3f} ms ({by})")
    rows["ww_apply"].update(max_abs_err=err, ms=k1_ms, plain_ms=k1_plain,
                            bound_ms=b, bound_by=by)

    # K2: train 10 epochs and learn severity 1 on glorot populations
    log(f"K2 ww_sgd N={N}")
    w = population(topo, N, gen)
    other = population(topo, N, gen)
    errs = []
    for what, fn, fn_plain in (
            ("train epochs=10",
             lambda: cuda_ww_train.ww_train_epochs(topo, w, 10),
             lambda: cuda_ww_train.ww_sgd_plain(topo, w, None, 10, 0.01)),
            ("learn severity=1",
             lambda: cuda_ww_train.ww_learn_epochs(topo, w, other, 1),
             lambda: cuda_ww_train.ww_sgd_plain(topo, w, other, 1, 0.01))):
        (gw, gl), (rw, rl) = fn(), fn_plain()
        errs.append(compare(torch, what + " weights", gw, rw))
        errs.append(compare(torch, what + " loss", gl, rl))
    k2_ms = timed_ms(torch, lambda: cuda_ww_train.ww_train_epochs(
        topo, w, 10), 10)
    k2_plain = timed_ms(torch, lambda: cuda_ww_train.ww_sgd_plain(
        topo, w, None, 10, 0.01), 3)
    b, by = bound_ms((2 * p + 1) * N * 4, N * 10 * epoch_ops)
    log(f"  train epochs=10: kernel {k2_ms:.3f} ms, plain {k2_plain:.3f} ms,"
        f" bound {b:.3f} ms ({by})")
    rows["ww_sgd"].update(max_abs_err=max(errs), ms=k2_ms, plain_ms=k2_plain,
                          bound_ms=b, bound_by=by)

    # K3: all phases on, both removals; lanes 0..99 forced divergent,
    # 100..199 forced zero (their gates off so that nothing rewrites them)
    log(f"K3 generation N={N}")
    wT = w.clone()
    wT[3, :100] = float("inf")
    wT[:, 100:200] = 0.0
    ops = gen_operands(torch, topo, wT, gen)
    for k in ("has_attacker", "learn_gate"):
        ops[k][:200] = False
    kw = dict(severity=1, train=10, lr=0.01, remove_divergent=True,
              remove_zero=True, epsilon=1e-4)
    got = cg.generation_popmajor(topo, wT, **ops, **kw)
    ref = cg.generation_popmajor_plain(topo, wT, **ops, **kw)
    errs = [compare(torch, "weights", got[0], ref[0]),
            compare(torch, "loss", got[1], ref[1])]
    equal_ints(torch, "dead_div", got[2], ref[2])
    equal_ints(torch, "dead_zero", got[3], ref[3])
    if not (bool(got[2][:100].all()) and bool(got[3][100:200].all())):
        raise AssertionError("forced divergent/zero lanes were not respawned")
    log(f"  deaths: divergent {int(got[2].sum())}, zero {int(got[3].sum())}")
    k3_ms = timed_ms(torch, lambda: cg.generation_popmajor(
        topo, wT, **ops, **kw), 10)
    k3_plain = timed_ms(torch, lambda: cg.generation_popmajor_plain(
        topo, wT, **ops, **kw), 3)
    n_att = int(ops["has_attacker"].sum())
    n_learn = int(ops["learn_gate"].sum())
    n_re = int((ops["learn_gate"] & ops["other_attacked"]).sum())
    k3_ops = ((n_att + n_re) * p * pts + n_learn * 1 * epoch_ops
              + N * 10 * epoch_ops + N * 3 * p)
    k3_bytes = (3 * N + 5 * p * N + p * N + N + 2 * N) * 4
    b, by = bound_ms(k3_bytes, k3_ops)
    log(f"  kernel {k3_ms:.3f} ms, plain {k3_plain:.3f} ms, bound "
        f"{b:.3f} ms ({by}); attacked {n_att}, learners {n_learn}, "
        f"recomputed {n_re}")
    rows["generation"].update(max_abs_err=max(errs), ms=k3_ms,
                              plain_ms=k3_plain, bound_ms=b, bound_by=by)

    # every instantiated activation, small N
    n = 65536
    for act in ("sigmoid", "tanh", "relu", "linear"):
        t = Topology("weightwise", width=2, depth=2, activation=act)
        log(f"activation {act} N={n}")
        ws = population(t, n, gen, 0.3)
        compare(torch, "K1 steps=5", cuda_ww.ww_apply_population(t, ws, 5),
                cuda_ww.ww_apply_population_plain(t, ws, 5))
        gw, gl = cuda_ww_train.ww_train_epochs(t, ws, 3)
        rw, rl = cuda_ww_train.ww_sgd_plain(t, ws, None, 3, 0.01)
        compare(torch, "K2 train=3 weights", gw, rw)
        compare(torch, "K2 train=3 loss", gl, rl)
        o = gen_operands(torch, t, ws, gen, rate=0.5)
        kw2 = dict(kw, train=2)
        got = cg.generation_popmajor(t, ws, **o, **kw2)
        ref = cg.generation_popmajor_plain(t, ws, **o, **kw2)
        compare(torch, "K3 weights", got[0], ref[0])
        compare(torch, "K3 loss", got[1], ref[1])
        equal_ints(torch, "K3 dead", torch.stack(got[2:]),
                   torch.stack(ref[2:]))


def check_launches(kernels, what: str, expect: dict) -> dict:
    """This run's launch counts, which must be exactly ``expect`` (0 for a
    kernel that ``expect`` does not name)."""
    got = {k.name: k.launches for k in kernels}
    want = {k.name: expect.get(k.name, 0) for k in kernels}
    log(f"  {what} launches {got}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return got


def main_path(torch, kernels):
    """Phase 4: the soup and the applications/s program at N = 1M through
    the public entry points, each run with its own launch counts; returns
    the launch counts summed over the three runs."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch.ops import cuda_ww

    topo = st.Topology("weightwise", width=2, depth=2)
    cfg = st.SoupConfig(topo=topo, size=N, attacking_rate=0.1,
                        learn_from_rate=0.1, learn_from_severity=1, train=10,
                        remove_divergent=True, remove_zero=True,
                        respawn_draws="fused")
    totals = {k.name: 0 for k in kernels}
    state = st.seed(cfg, 0, device="cuda")
    # one warm-up generation per route, one warm-up call of the program
    for impl, c, expect in (
            ("fused", cfg._replace(generation_impl="fused"),
             {"generation": GENERATIONS + 1}),
            ("phases", cfg, {"ww_sgd": 2 * (GENERATIONS + 1)})):
        for k in kernels:
            k.launches = 0
        st.evolve(c, state, 1)  # warm-up generation
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = st.evolve(c, state, GENERATIONS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = st.count(cfg, state)
        uids = state.uids
        if int(torch.unique(uids).numel()) != N:
            raise AssertionError(f"{impl}: uids are not unique")
        if int(counts.sum()) != N or not bool(torch.isfinite(
                state.weights).all()):
            raise AssertionError(f"{impl}: counts {counts.tolist()} or "
                                 "non-finite weights after respawn")
        log(f"soup {impl}: {GENERATIONS / dt:.3f} generations/s at N={N} "
            f"({dt * 1e3 / GENERATIONS:.3f} ms/generation), counts "
            f"[divergent, fix_zero, fix_other, fix_sec, other] "
            f"{counts.tolist()}, next_uid {int(state.next_uid)}")
        for name, n in check_launches(kernels, f"soup {impl}",
                                      expect).items():
            totals[name] += n
    # applications/s: N particles x BENCH_STEPS chained self-applications
    w = (st.init_population(topo, 1, N, "cuda") * 0.05).t().contiguous()
    for k in kernels:
        k.launches = 0
    out = cuda_ww.ww_apply_population(topo, w, BENCH_STEPS)
    torch.cuda.synchronize()
    calls = 3
    t0 = time.perf_counter()
    for _ in range(calls):
        out = cuda_ww.ww_apply_population(topo, w, BENCH_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("applications/s program: non-finite output")
    log(f"applications/s: {N * BENCH_STEPS * calls / dt:.6e} at N={N}, "
        f"steps={BENCH_STEPS} ({dt * 1e3 / calls:.3f} ms per call)")
    for name, n in check_launches(kernels, "applications/s program",
                                  {"ww_apply": calls + 1}).items():
        totals[name] += n
    return totals


def small_soup_vs_cpu(torch):
    """Phase 5: the card's soup against the CPU's on the same draws."""
    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch.init import glorot_limit_rows

    topo = st.Topology("weightwise", width=2, depth=2)
    n, p = 2048, topo.num_weights
    base = st.SoupConfig(topo=topo, size=n, attacking_rate=0.3,
                         learn_from_rate=0.3, learn_from_severity=1, train=2,
                         remove_divergent=True, remove_zero=True)
    rng = np.random.default_rng(0)
    lim = glorot_limit_rows(topo)
    w0 = (rng.uniform(-1, 1, (n, p)) * lim).astype(np.float32)
    draws = [st.SoupDraws(rng.random(n) < 0.3, rng.integers(0, n, n),
                          rng.random(n) < 0.3, rng.integers(0, n, n),
                          (rng.uniform(-1, 1, (p, n)) * lim[:, None])
                          .astype(np.float32)) for _ in range(3)]
    from srnn_tpu_torch.convert import soup_state_from_arrays

    for cfg in (base._replace(generation_impl="fused"), base):
        states = {d: soup_state_from_arrays(w0, np.arange(n), n, 0,
                                            device=d) for d in ("cuda", "cpu")}
        for g, dr in enumerate(draws):
            ev = {}
            for d in states:
                states[d], ev[d] = st.evolve_step(cfg, states[d], dr)
            tag = f"{cfg.generation_impl} gen {g}"
            for f in ("uids", "next_uid"):
                equal_ints(torch, f"{tag} {f}", getattr(states["cuda"], f),
                           getattr(states["cpu"], f))
            equal_ints(torch, f"{tag} actions", ev["cuda"].action,
                       ev["cpu"].action)
            compare(torch, f"{tag} weights", states["cuda"].weights.cpu(),
                    states["cpu"].weights)


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false; this drive needs "
                    "a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(here, "srnn_tpu_torch", "__init__.py")):
        return fail("srnn_tpu_torch/ is not beside chip_smoke.py; run from a "
                    "checkout of the repository")
    sys.path.insert(0, here)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    t_start = time.perf_counter()

    from srnn_tpu_torch.ops.cuda_generation import GENERATION
    from srnn_tpu_torch.ops.cuda_ww import WW_APPLY
    from srnn_tpu_torch.ops.cuda_ww_train import WW_SGD

    kernels = (WW_APPLY, WW_SGD, GENERATION)
    rows = {k.name: {"name": k.name, "route": "cuda",
                     "source": f"srnn_tpu_torch/csrc/{k.source}.cu",
                     "replaces": k.replaces, "library_ms": None}
            for k in kernels}

    build_kernels()
    log(f"tolerance: floats rtol {RTOL} atol {ATOL} with the non-finite "
        "pattern exact; integer outputs exact")
    check_kernels(torch, rows)
    launches = main_path(torch, kernels)
    small_soup_vs_cpu(torch)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    for k in kernels:
        rows[k.name]["launches"] = launches[k.name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: rows[k.name][key] for key in keys}
                                  for k in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
