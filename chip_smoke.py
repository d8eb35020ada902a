#!/usr/bin/env python3
"""Drive srnn_tpu_torch's main path on one NVIDIA GPU and hold every CUDA
kernel against its plain torch version.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build the kernels from ``srnn_tpu_torch/csrc`` (one nvcc per library,
   all at once: every source's default build, width 2 / depth 2 / 4
   aggregates, and the builds of the topologies off it that the main path
   runs: width 3 / depth 3 of every variant, aggregating with 6
   aggregates, and the fence of 64 weights) and print ptxas' register,
   stack and spill report per build;
3. each kernel against its plain version on the same inputs at N = 1M:
   the weightwise kernels (K1-K3, P = 14, the 4-2-2-1 net), the k-vector
   SGD chain (K4, aggregating 4-2-2-4, P = 20), the recurrent BPTT chain and
   attack (K5, K6, the 1-2-2-1 stack, P = 17; K6 also on the cross-type
   victims of length T = 14 and T = 20), K3's aggregating, fft and
   recurrent bodies, and K3's three bfloat16 bodies; every other
   instantiated activation, aggregator and fft mode at a small N; max abs /
   max rel difference, integer outputs equal, median times of kernel and
   plain version (CUDA events) and the kernel's device time (its launches'
   own durations under torch.profiler) beside the kernel's bound, and for
   K1, K2, K4 and K3 beside the --fmad=false ceiling of the FP32
   instructions they issue; every kernel bitwise (weights, attack outputs
   and the mean loss equal where finite with the same non-finite pattern),
   and K3's bodies also timed with no attack and no learn operand (train
   only), which puts a number on their gated phases; the SM clock and power
   draw (nvidia-smi, sampled meanwhile) beside K1's and K3's times; K2's
   shuffled instantiation (keras' shuffled epoch, uniform per-lane orders)
   train 10 and learn 1 against its plain twin bitwise, in the identity
   order against the unshuffled K2 bitwise, its bound the unshuffled
   operations and the order's bytes; then each kernel off its default
   build the same way: K1, K2, K3's float32 and bfloat16 weightwise bodies
   at width 3 / depth 3 (P = 33), K4 and K3's k-vector body of the
   width-3 / depth-3 aggregating and fft particles (P = 42) and of the
   aggregating one with 6 aggregates (P = 28) at N = 1M and of the fence's
   (width 4, depth 1, 8 aggregates: P = 64) at N = 4,096, K5 and K3's
   recurrent body at width 3 / depth 3 (P = 52), K6 for that attacker on
   victims of T = 33, 42 and 52; and at a small N the width-3 / depth-3
   tanh K2 and K3 weightwise body and K2's shuffled instantiation;
4. the main path through the public entry points, each of its runs with
   the launch counts set to 0 just before it and checked just after against
   the launches that run must make: the N = 1M full-dynamics soup (attack
   0.1, learn_from 0.1, severity 1, train 10, both removals, fused respawn
   draws) of the weightwise, aggregating and recurrent particles, 20
   generations of the population-major soup (layout='popmajor') with
   generation_impl='fused' (the variant's generation kernel only), then 20
   with 'phases' (its SGD kernel, and the recurrent attack kernel); then
   20 of the row-major soup (layout='rowmajor', the default; its SGD
   kernel twice a generation and no other kernel, counted after a warm-up
   generation); generations/s, class counts, unique uids; then the
   mixed-type soup at setups/mega_multisoup.py's split (N = 1M as 333,334
   weightwise, 333,333 aggregating, 333,333 recurrent particles, the same
   dynamics), 20 generations on each route (fused: one generation kernel
   per type; phases: the types' SGD kernels; both: the recurrent attack
   kernel once per victim type), then 20 in the row-major layout (the
   default: the types' SGD kernels twice a generation each and no other
   kernel, counted after a warm-up generation; the cross attack is plain
   torch); then the weightwise, aggregating and
   recurrent soups with population_dtype='bf16' on the fused route (K3's
   bfloat16 bodies); then each particle on its route: the mixed phase
   chain at the same split with an elu weightwise third (the autograd
   chain: no K2 launch), the aggregating third on K4 and an associative
   recurrent third on K5 and K6 (the population-major serial scan), 20
   generations, its per-type routes printed as the JAX package's
   mega_multisoup writes them; the row-major soups of an elu weightwise
   particle and of a width-3 / depth-3 one (P = 33), 10 generations each
   at N = 1M with no kernel launch at all; then the applications/s
   program, N = 1M, steps = 2000
   (self-application kernel only, through ``srnn_tpu_torch.bench``); then,
   to inform, ``run_fixpoint`` class counts of fresh aggregating and
   recurrent nets; then (PR 11) the kernels off their default builds: the
   N = 1M soups of the width-3 / depth-3 weightwise, aggregating, fft and
   recurrent particles and of the aggregating one with 6 aggregates, 20
   generations on each route (fused: K3's body; phases: the SGD kernel,
   and K6 at T = 52 for the recurrent one), the bfloat16 width-3 / depth-3
   weightwise soup fused, the fence's soups at N = 4,096 (3 generations
   each route), the mixed phase chain at the same split of width-3 /
   depth-3 thirds (the types' SGD kernels, K6 at T = 33, 42 and 52), the
   width-3 / depth-3 row-major weightwise soup (K2), each run's launches
   exact per build, generations/s beside PR 10's autograd route; and the
   autograd route driven by a particle past the fence (weightwise width 6
   / depth 2, P = 66, 3 generations);
5. the fixpoint engines and setups: at N = 1M, weightwise ``run_fixpoint``
   (100 steps: K1 once a step), ``run_training`` (100 epochs: K2 once an
   epoch), ``run_training`` with a shuffle generator (100 epochs: K2's
   shuffled instantiation once an epoch, no unshuffled launch, its wall
   beside the unshuffled run's), ``run_mixed_fixpoint`` (4 steps x 50 trains: K1 and K2 once a
   step), ``run_known_fixpoint_variation`` (100 steps: K1 once a step and
   once more) and ``fixpoint_density`` (no kernel), and ``run_training`` of
   the aggregating and recurrent variants (100 epochs: K4 / K5 once an
   epoch), ``run_fixpoint`` and ``run_training`` at width 3 / depth 3 (K1;
   K2, K4 of the aggregating and fft particles, K5), each run's launch
   counts exact, class counts summing to N and
   weights non-finite exactly where a trial is classed divergent; the six
   fixpoint setups and the three soup setups at their default sizes, all
   at once, each through ``python -m srnn_tpu_torch.setups`` in a
   subprocess, their artifacts loaded and their launch counts
   (SRNN_LAUNCH_COUNTS) exact, the soup setups' science printed beside the
   CPU reference's (BASELINE.md) to inform; then every
   engine on 512 trials of each standard variant on the card against the
   same call on the CPU (integers exact, floats bitwise), the weightwise
   run_training also shuffled, in the same orders;
6. a small soup of each variant (at width 2 / depth 2 and at each
   topology off the default builds), a small mixed soup, and small bf16 and
   int8 soups, each on the card against the same soup on the CPU, fed the
   same draws, over 3 generations on both routes; the same for the
   row-major soups (each variant, the weightwise full batch, bf16, int8),
   the weightwise (both train modes) and aggregating row-major soups
   against the population-major phase chain on the card, and a checkpoint
   round trip on the card (3 generations, save, restore, 2 more, against 5
   at once, bitwise with the generator); the row-major mixed soup the same
   way (four types with fft within rtol/atol a generation at a time,
   three-type mixes in float32, bfloat16 and int8 bitwise, chained), a
   weightwise and aggregating mix row-major
   against population-major on the card, and a mixed checkpoint round
   trip; the sequential soup (mode='sequential') of each standard variant
   and of the weightwise full batch, card against CPU bitwise with each
   generation's launches exact; the population-major weightwise full batch
   card against CPU, and its step's time at N = 1M (to inform); small
   soups off the kernels card against CPU a generation at a time (elu,
   swish, gelu and softmax weightwise, an elu aggregating particle, the
   row-major associative recurrent soup; rtol 1e-5 / atol
   1e-6 with the non-finite pattern exact, whether bitwise logged), and the
   random shuffler's transforms with the same permutations (bitwise but
   fft);
   then, to inform, the sequential weightwise soup at soup_trajectorys'
   size (exactly one K2 launch per particle a generation), its ms per
   generation and final classes beside BASELINE.md's;
7. one JSON line listing every kernel (K3 once per variant body and
   population dtype, K6 once per victim length, K2's shuffled
   instantiation on its own row; then a row per build off the default one,
   ``name[tag]``, each launched on the main path), then the
   card's name and power limit, then the result line
   ``{"ok": true, "device": {...}}``.

It imports neither jax nor the JAX package.  Without a CUDA card, or outside
a checkout, it exits non-zero and prints no result.
"""

import collections
import json
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# The data sheet counts an FMA as two operations; the kernels are built with
# --fmad=false, so their separate multiplies and adds issue at half of it.
FMAD_OFF_OPS_PER_S = PEAK_FP32_FLOPS / 2

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


def coord_values(topo):
    """Per axis of the duplex coordinates, the set of values its points
    take (topology.normalized_weight_coords)."""
    from srnn_tpu_torch.topology import normalized_weight_coords

    c = normalized_weight_coords(topo)
    return [set(c[:, k].tolist()) for k in range(3)]


def ww_apply_issued(topo) -> int:
    """FP32 instructions the redesigned weightwise application issues per
    particle (csrc/ww_common.cuh): layer 0's coordinate products taken once
    per application for each coordinate value other than 1.0, then at each
    point the weight feature's product and three adds per layer-0 column and
    the upper layers as the reference has them."""
    (a0, b0), upper = topo.layer_shapes[0], topo.layer_shapes[1:]
    shared = b0 * sum(len(v - {1.0}) for v in coord_values(topo))
    per_point = b0 * a0 + sum(b * (2 * a - 1) for a, b in upper)
    return shared + topo.num_weights * per_point


def ww_sgd_issued_per_epoch(topo) -> int:
    """FP32 instructions of one epoch of the redesigned batch-1 chain: the
    reference's count less the forward's and the layer-0 gradients' products
    with a coordinate of 1.0."""
    from srnn_tpu_torch.topology import normalized_weight_coords

    ones = int((normalized_weight_coords(topo) == 1.0).sum())
    return sgd_ops_per_epoch(topo) - 2 * topo.layer_shapes[0][1] * ones


def kvec_reduce_ops(topo) -> int:
    """Operations of one reduce of P weights to k values, as the kernel
    does it: the average's poison chains, segment sums and scale; the max
    compares; the DFT basis' multiplies and adds."""
    from srnn_tpu_torch.ops.cuda_kvec_train import kvec_tables

    p, k = topo.num_weights, topo.aggregates
    if topo.variant == "fft":
        kinds = kvec_tables(topo)[2 * k * p:3 * k * p].reshape(k, p)
        terms = (kinds != 0).sum(axis=1)
        return int((kinds == 2).sum() + (terms - 1).clip(min=0).sum())
    if topo.aggregator == "average":
        return 4 * p + (p - k) + 3 * k
    return (p - k) * (2 if topo.aggregator == "max_buggy" else 1)


def kvec_reduce_issued(topo) -> int:
    """FP32 instructions of one reduce as the redesigned kernels issue it on
    a lane whose weights are all finite (csrc/kvec_common.cuh): the
    average's segment sums, their total and (sum + 0.0) * 1/count, without
    the poison chains; the other kinds as ``kvec_reduce_ops`` counts them."""
    p, k = topo.num_weights, topo.aggregates
    if topo.variant == "aggregating" and topo.aggregator == "average":
        return (p - k) + (k - 1) + 2 * k
    return kvec_reduce_ops(topo)


def kvec_sgd_ops_per_epoch(topo, refresh: bool, reduce=kvec_reduce_ops) -> int:
    """Operations of one full-batch epoch of the k-vector chain: the
    reduce (self-training; ``reduce`` counts it), the forward, the error,
    loss and its gradient, the weight gradients, the back-propagated
    gradients above the first layer and the update."""
    shapes, k = topo.layer_shapes, topo.aggregates
    back = sum(a * b for a, b in shapes)
    back += sum(a * (2 * b - 1) for a, b in shapes[1:])
    fwd = apply_ops_per_point(topo)
    return ((reduce(topo) if refresh else 0) + fwd + k + 2 * k
            + k + back + 2 * topo.num_weights)


def kvec_apply_ops(topo, reduce=kvec_reduce_ops) -> int:
    """One k-vector transform: reduce, forward, expand (P rows of k
    products and k - 1 adds)."""
    p, k = topo.num_weights, topo.aggregates
    return reduce(topo) + apply_ops_per_point(topo) + p * (2 * k - 1)


def rnn_forward_ops(topo, t_len: int) -> int:
    """One stacked-SimpleRNN forward over ``t_len`` steps."""
    return t_len * sum(u * (2 * i - 1 + 2 * u) for i, u in
                       topo.rnn_layer_dims)


def rnn_sgd_ops_per_epoch(topo) -> int:
    """One BPTT epoch, as the kernel needs it (linear activation): the
    forward, the errors, the loss and its gradient; per layer and step the
    carried gradient's add (not at the last step), the weight gradients, the
    input gradients (above layer 0) and the recurrent carry (not out of step
    0); then the update."""
    t = p = topo.num_weights
    ops = rnn_forward_ops(topo, t) + t + 2 * t + t
    for layer, (i, u) in enumerate(topo.rnn_layer_dims):
        ops += (t - 1) * u + t * 2 * u * (i + u) + (t - 1) * u * (2 * u - 1)
        if layer > 0:
            ops += t * i * (2 * u - 1)
    return ops + 2 * p


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fmad_off_ms(ops: float) -> float:
    """The issue-rate ceiling of ``ops`` separate multiplies and adds."""
    return ops / FMAD_OFF_OPS_PER_S * 1e3


def device_ms(fn, reps: int = 50) -> float:
    """A kernel's own device time: the mean duration of its launches in
    ``reps`` runs of ``fn`` under torch.profiler
    (``bench_kernels.device_ms``)."""
    from srnn_tpu_torch.bench_kernels import device_ms as traced

    return traced(fn, reps)


# ---------------------------------------------------------------- helpers


def timed_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up
    run unless ``warm`` is false (``fn`` ran just before, in a check)."""
    if warm:
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


#: (what, start, end) of the timings that the SM clock and power draw are
#: read beside (K1, K3), matched to the nvidia-smi samples after phase 3
CLOCK_WINDOWS = []


def timed_clocked(torch, what: str, fn, reps: int, warm: bool = True):
    """``timed_ms``, its window kept for the clock and power readings."""
    import datetime

    t0 = datetime.datetime.now()
    ms = timed_ms(torch, fn, reps, warm)
    CLOCK_WINDOWS.append((what, t0, datetime.datetime.now()))
    return ms


def compare(torch, what: str, got, ref, ulps=None):
    """Max abs / max rel difference over finite entries; the non-finite
    pattern must agree exactly.  Raises when outside RTOL/ATOL, or, where
    ``ulps`` is given (0 for every kernel against its plain version), when
    more than ``ulps`` float32 ulps apart where finite or with another
    finite/NaN/Inf pattern.  Values are compared as float32, so bfloat16
    outputs are compared bit for bit where finite and by NaN/Inf position
    elsewhere (the card's and torch's bfloat16 conversions may give NaNs
    different payloads)."""
    from srnn_tpu_torch.bench_kernels import check_exact, max_ulps

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
    held = "" if ulps is None else (f" ulps {max_ulps(got, ref)} (allowed "
                                    f"{ulps})")
    log(f"  {what}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
        f"bitwise {bitwise} nonfinite_pattern_equal {same_nonfinite}{held}")
    if not (within and same_nonfinite):
        raise AssertionError(f"{what}: outside rtol {RTOL} atol {ATOL}")
    if ulps is not None:
        check_exact(what, got, ref, ulps)
    return max_abs


def equal_ints(torch, what: str, got, ref) -> None:
    eq = bool(torch.equal(got.cpu(), ref.cpu()))
    log(f"  {what}: integer outputs equal {eq}")
    if not eq:
        raise AssertionError(f"{what}: integer outputs differ")


# ----------------------------------------------------------------- phases


def build_kernels():
    """Build every kernel source's default build and every build off it
    that the wide topologies need (``wide_jobs``), one nvcc each, all at
    once; print each one's finish time (its log's last write) and ptxas'
    report summed over the build's instantiations: registers, stack frame,
    spilled bytes, shared memory per block; for the default builds of the
    sources that bench_kernels compares (its groups) also the linear
    (k-vector: linear average) instantiations' resident warps per SM."""
    import re

    from srnn_tpu_torch.bench_kernels import (GROUPS, census_fragment,
                                              linear_resources)
    from srnn_tpu_torch.ops import _build

    jobs = [(name, _build.DEFAULT) for name in _build.SOURCES] + wide_jobs()
    t0, wall0 = time.perf_counter(), time.time()
    _build.build(jobs)
    log(f"build: {len(jobs)} libraries ({len(_build.SOURCES)} default "
        f"builds) in {time.perf_counter() - t0:.1f} s (nvcc "
        f"{_build.nvcc_path()})")
    for name, b in jobs:
        done = os.path.getmtime(_build.log_path(name, b)) - wall0
        report = _build.resource_usage(name, b)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame",
                                            report)]
        spills = sum(int(x) for x in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", report))
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", report)]
        log(f"  {name} {b.tag or 'default'}: nvcc done after {done:.1f} s; "
            f"{len(regs)} kernels, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)}, stack frame up to "
            f"{max(stack, default=0)} bytes, spilled bytes {spills}, "
            f"shared memory up to {max(smem, default=0)} bytes a block")
        if b == _build.DEFAULT and any(name in g for g in GROUPS.values()):
            res = linear_resources(_build.log_path(name),
                                   census_fragment(name))
            log(f"    linear instantiations: {res}")


def population(topo, n, gen, scale=1.0):
    """(P, n) population on the card: the glorot lane draw, or the
    kernel-by-kernel draw with orthogonal kernels for the recurrent
    variant."""
    from srnn_tpu_torch.init import fresh_lanes

    return (fresh_lanes(topo, gen, n, "fused", "cuda") * scale).contiguous()


def gen_operands(torch, topo, wT, gen, rate=0.1):
    """Kernel operands as the soup builds them: attacked lanes with their
    attacker's column, learners with their target's pre-attack column and
    that target's attacker."""
    n = wT.shape[1]
    dev = wT.device
    has_attacker = torch.rand(n, generator=gen, device=dev) < rate
    atk_idx = torch.randint(0, n, (n,), generator=gen, device=dev)
    learn_gate = torch.rand(n, generator=gen, device=dev) < rate
    tgt = torch.randint(0, n, (n,), generator=gen, device=dev)
    attackerT = wT[:, atk_idx]
    return dict(freshT=population(topo, n, gen),
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
        err = compare(torch, f"steps={steps}", got, ref, 0)
    k1_run = lambda: cuda_ww.ww_apply_population(topo, w_damped, BENCH_STEPS)
    k1_ms = timed_clocked(torch, f"K1 steps={BENCH_STEPS}", k1_run, 5)
    k1_device = device_ms(k1_run, 3)
    k1_plain = timed_ms(torch, lambda: cuda_ww.ww_apply_population_plain(
        topo, w_damped, BENCH_STEPS), 1, warm=False)
    b, by = bound_ms(2 * p * N * 4, BENCH_STEPS * N * p * pts)
    issued = ww_apply_issued(topo)
    log(f"  steps={BENCH_STEPS}: kernel {k1_ms:.3f} ms (device "
        f"{k1_device:.4f}), plain "
        f"{k1_plain:.3f} ms, bound {b:.3f} ms ({by}; {p * pts} operations "
        f"an application); the kernel issues {issued} FP32 instructions an "
        f"application, --fmad=false ceiling "
        f"{fmad_off_ms(BENCH_STEPS * N * issued):.3f} ms")
    rows["ww_apply"].update(max_abs_err=err, ms=k1_ms, device_ms=k1_device,
                            plain_ms=k1_plain, bound_ms=b, bound_by=by)

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
        errs.append(check_sgd(torch, what, fn, fn_plain))
    k2_run = lambda: cuda_ww_train.ww_train_epochs(topo, w, 10)
    k2_ms = timed_ms(torch, k2_run, 10)
    k2_device = device_ms(k2_run)
    k2_plain = timed_ms(torch, lambda: cuda_ww_train.ww_sgd_plain(
        topo, w, None, 10, 0.01), 1, warm=False)
    b, by = bound_ms((2 * p + 1) * N * 4, N * 10 * epoch_ops)
    log(f"  train epochs=10: kernel {k2_ms:.3f} ms (device "
        f"{k2_device:.4f}), plain {k2_plain:.3f} ms,"
        f" bound {b:.3f} ms ({by}); the kernel issues "
        f"{ww_sgd_issued_per_epoch(topo)} FP32 instructions an epoch "
        f"({epoch_ops} operations), --fmad=false ceiling "
        f"{fmad_off_ms(N * 10 * ww_sgd_issued_per_epoch(topo)):.3f} ms")
    rows["ww_sgd"].update(max_abs_err=max(errs), ms=k2_ms,
                          device_ms=k2_device, plain_ms=k2_plain, bound_ms=b,
                          bound_by=by)

    # K2 shuffled: keras' shuffled epoch, a uniform per-lane sample order
    log(f"K2 ww_sgd_shuffled N={N}")
    order10, order1 = (torch.rand((e, p, N), generator=gen, device="cuda")
                       .argsort(dim=1).to(torch.uint8) for e in (10, 1))
    errs = []
    for what, fn, fn_plain in (
            ("train epochs=10",
             lambda: cuda_ww_train.ww_train_epochs(topo, w, 10,
                                                   order=order10),
             lambda: cuda_ww_train.ww_sgd_plain(topo, w, None, 10, 0.01,
                                                order10)),
            ("learn severity=1",
             lambda: cuda_ww_train.ww_learn_epochs(topo, w, other, 1,
                                                   order=order1),
             lambda: cuda_ww_train.ww_sgd_plain(topo, w, other, 1, 0.01,
                                                order1))):
        errs.append(check_sgd(torch, what, fn, fn_plain))
    ident = torch.arange(p, dtype=torch.uint8, device="cuda")[
        None, :, None].expand(10, p, N).contiguous()
    check_sgd(torch, "identity order against the unshuffled kernel",
              lambda: cuda_ww_train.ww_train_epochs(topo, w, 10, order=ident),
              lambda: cuda_ww_train.ww_train_epochs(topo, w, 10))
    del ident
    k2s_run = lambda: cuda_ww_train.ww_train_epochs(topo, w, 10,
                                                    order=order10)
    k2s_ms = timed_ms(torch, k2s_run, 10)
    k2s_device = device_ms(k2s_run)
    k2s_plain = timed_ms(torch, lambda: cuda_ww_train.ww_sgd_plain(
        topo, w, None, 10, 0.01, order10), 1, warm=False)
    b, by = bound_ms((2 * p + 1) * N * 4 + 10 * p * N, N * 10 * epoch_ops)
    log(f"  train epochs=10: kernel {k2s_ms:.3f} ms (device "
        f"{k2s_device:.4f}; the unshuffled kernel's device time "
        f"{k2_device:.4f}), plain {k2s_plain:.3f} ms, bound {b:.3f} ms "
        f"({by}; {epoch_ops} operations an epoch and the order's "
        f"{10 * p * N} bytes)")
    rows["ww_sgd_shuffled"].update(max_abs_err=max(errs), ms=k2s_ms,
                                   device_ms=k2s_device, plain_ms=k2s_plain,
                                   bound_ms=b, bound_by=by)

    # K3: all phases on, both removals
    log(f"K3 generation N={N}")
    err, k3_ms, k3_plain, ops, kw, n_dead, only = check_generation_body(
        torch, topo, cg.GENERATION, w, gen)
    b, by = gen_body_bound(topo, ops, kw, n_dead, p * pts, epoch_ops,
                           epoch_ops)
    log(f"  kernel {k3_ms:.3f} ms (device {only['device']:.4f}), plain "
        f"{k3_plain:.3f} ms, bound {b:.3f} ms ({by})")
    log_train_only(k3_ms, only)
    rows["generation"].update(max_abs_err=err, ms=k3_ms,
                              device_ms=only["device"], plain_ms=k3_plain,
                              bound_ms=b, bound_by=by)

    # every instantiated activation, small N
    n = 65536
    for act in ("sigmoid", "tanh", "relu", "linear"):
        t = Topology("weightwise", width=2, depth=2, activation=act)
        log(f"activation {act} N={n}")
        ws = population(t, n, gen, 0.3)
        compare(torch, "K1 steps=5", cuda_ww.ww_apply_population(t, ws, 5),
                cuda_ww.ww_apply_population_plain(t, ws, 5), 0)
        check_sgd(torch, "K2 train=3",
                  lambda: cuda_ww_train.ww_train_epochs(t, ws, 3),
                  lambda: cuda_ww_train.ww_sgd_plain(t, ws, None, 3, 0.01))
        o = gen_operands(torch, t, ws, gen, rate=0.5)
        kw2 = dict(severity=1, train=2, lr=0.01, remove_divergent=True,
                   remove_zero=True, epsilon=1e-4)
        check_small_generation(torch, t, ws, o, kw2)


def check_small_generation(torch, topo, ws, o, kw, bf16=True):
    """K3 against its plain version on a small population, with a float32
    and (``bf16``) with a bfloat16 population (the operand columns rounded
    too), bitwise."""
    from srnn_tpu_torch.ops import cuda_generation as cg

    for dtype in (torch.float32, torch.bfloat16)[:2 if bf16 else 1]:
        cast = {k: v.to(dtype) if k.endswith("T") and k != "freshT" else v
                for k, v in o.items()}
        wd = ws.to(dtype)
        got = cg.generation_popmajor(topo, wd, **cast, **kw)
        ref = cg.generation_popmajor_plain(topo, wd, **cast, **kw)
        tag = "K3" if dtype == torch.float32 else "K3 bf16"
        compare(torch, f"{tag} weights", got[0], ref[0], 0)
        compare(torch, f"{tag} loss", got[1], ref[1], 0)
        equal_ints(torch, f"{tag} dead", torch.stack(got[2:]),
                   torch.stack(ref[2:]))


def check_generation_body(torch, topo, kernel, w, gen, reps=100):
    """One K3 body against its plain version at all phases (train 10),
    both removals, lanes 0..99 forced divergent and 100..199 forced zero
    (their gates off; bench_kernels.generation_inputs), bitwise, and also
    checked and timed with no attack and no learn operand (train only).
    Returns (max abs error, kernel ms, plain ms, operands, kwargs, number of
    dead lanes, {"device": device ms, "train_only": train-only ms,
    "train_only_device": its device ms}, or None for ``reps`` 0)."""
    from srnn_tpu_torch.bench_kernels import GEN_KW, generation_inputs
    from srnn_tpu_torch.ops import cuda_generation as cg

    wT, ops, train_only = generation_inputs(topo, w, gen)
    kw = GEN_KW
    errs = []
    for tag, o in (("", ops), ("train only ", train_only)):
        got = cg.generation_popmajor(topo, wT, **o, **kw)
        ref = cg.generation_popmajor_plain(topo, wT, **o, **kw)
        errs += [compare(torch, f"{tag}weights", got[0], ref[0], 0),
                 compare(torch, f"{tag}loss", got[1], ref[1], 0)]
        equal_ints(torch, f"{tag}dead_div", got[2], ref[2])
        equal_ints(torch, f"{tag}dead_zero", got[3], ref[3])
        if not (bool(got[2][:100].all()) and bool(got[3][100:200].all())):
            raise AssertionError("forced divergent/zero lanes were not "
                                 "respawned")
        if tag == "":
            n_dead = int((got[2] | got[3]).sum())
            log(f"  deaths: divergent {int(got[2].sum())}, zero "
                f"{int(got[3].sum())}")
    if not reps:
        return max(errs), None, None, ops, kw, n_dead, None
    before = kernel.launches
    run = lambda: cg.generation_popmajor(topo, wT, **ops, **kw)
    run_only = lambda: cg.generation_popmajor(topo, wT, **train_only, **kw)
    ms = timed_clocked(torch, f"K3 {kernel.name}", run, reps)
    plain = timed_ms(torch, lambda: cg.generation_popmajor_plain(
        topo, wT, **ops, **kw), 1, warm=False)
    only = {"device": device_ms(run),
            "train_only": timed_clocked(torch, f"K3 {kernel.name} train only",
                                        run_only, reps),
            "train_only_device": device_ms(run_only)}
    if kernel.launches == before:
        raise AssertionError(f"{kernel.name} was not launched")
    return max(errs), ms, plain, ops, kw, n_dead, only


def log_train_only(ms, only) -> None:
    dev, dev_only = only["device"], only["train_only_device"]
    log(f"  train only (no attack, no learn operand): {only['train_only']:.3f}"
        f" ms (device {dev_only:.4f}); the gated phases "
        f"{ms - only['train_only']:.3f} ms, device {dev - dev_only:.4f} ms, "
        f"{100 * (dev - dev_only) / dev:.1f}% of the kernel's device time")


def gen_body_bound(topo, ops, kw, n_dead, apply_ops, learn_ops, train_ops,
                   pop_bytes=4, issued=None, n=N):
    """Bound of one K3 launch from this run's gates: every lane trains,
    the attacked lanes and recomputed targets apply once, the learners run
    their imitation chain.  Bytes as the kernel's gates need them, counted
    by element (not by 32-byte sector): the population, two gates a lane
    and the third for learners, an attacker column for each attacked lane,
    a target column for each learner, its attacker's column for each
    recomputed target (``pop_bytes`` each: 4 for float32, 2 for bfloat16),
    a fresh column (float32) for each dead lane; the population, loss and
    both dead masks written.  ``issued``: the (apply, learn, train-epoch)
    FP32 instructions the kernel issues instead, logged as its
    --fmad=false ceiling."""
    p = topo.num_weights
    n_att = int(ops["has_attacker"].sum())
    n_learn = int(ops["learn_gate"].sum())
    n_re = int((ops["learn_gate"] & ops["other_attacked"]).sum())

    def ops_of(apply_n, learn_n, train_n):
        return ((n_att + n_re) * apply_n + n_learn * learn_n
                + n * kw["train"] * train_n + n * 3 * p)

    total = ops_of(apply_ops, learn_ops, train_ops)
    nbytes = ((2 * n + n_learn) * 4
              + p * (n + n_att + n_learn + n_re) * pop_bytes
              + p * n_dead * 4
              + p * n * pop_bytes + (n + 2 * n) * 4)
    log(f"  attacked {n_att}, learners {n_learn}, recomputed {n_re}, "
        f"dead {n_dead}; {nbytes / 1e6:.1f} MB, {total / 1e9:.3f} Gop "
        f"(--fmad=false ceiling {fmad_off_ms(total):.3f} ms)")
    if issued is not None:
        total_issued = ops_of(*issued)
        log(f"  the kernel issues {total_issued / 1e9:.3f} G FP32 "
            f"instructions (--fmad=false ceiling "
            f"{fmad_off_ms(total_issued):.3f} ms)")
    return bound_ms(nbytes, total)


def gen_body_ops(topo, reduce=kvec_reduce_ops):
    """(apply, learn, train-epoch) operation counts of a K3 body; for the
    k-vector body ``reduce`` counts the reduce."""
    if topo.variant == "weightwise":
        epoch = sgd_ops_per_epoch(topo)
        return topo.num_weights * apply_ops_per_point(topo), epoch, epoch
    if topo.variant == "recurrent":
        epoch = rnn_sgd_ops_per_epoch(topo)
        return rnn_forward_ops(topo, topo.num_weights), epoch, epoch
    return (kvec_apply_ops(topo, reduce),
            reduce(topo) + kvec_sgd_ops_per_epoch(topo, False, reduce),
            kvec_sgd_ops_per_epoch(topo, True, reduce))


def check_sgd(torch, what, fn, fn_plain):
    """An SGD chain against its plain version: the weights and the mean
    loss bitwise."""
    (gw, gl), (rw, rl) = fn(), fn_plain()
    return max(compare(torch, what + " weights", gw, rw, 0),
               compare(torch, what + " loss", gl, rl, 0))


def check_variant_kernels(torch, rows):
    """Phase 3, the aggregating, fft and recurrent kernels: K4, K5, K6 and
    K3's k-vector and recurrent bodies against their plain versions."""
    from srnn_tpu_torch import Topology
    from srnn_tpu_torch.ops import cuda_generation as cg
    from srnn_tpu_torch.ops import cuda_kvec_train as ck
    from srnn_tpu_torch.ops import cuda_rnn_apply as cra
    from srnn_tpu_torch.ops import cuda_rnn_train as crt

    gen = torch.Generator(device="cuda").manual_seed(1)
    agg = Topology("aggregating", width=2, depth=2, aggregates=4)
    fft = Topology("fft", width=2, depth=2, aggregates=4)
    rnn = Topology("recurrent", width=2, depth=2)

    # K4: aggregating average, train 10 and learn 1, with a non-finite
    # weight inside and outside a segment
    p = agg.num_weights
    log(f"K4 kvec_sgd N={N} (aggregating, P={p})")
    w = population(agg, N, gen)
    other = population(agg, N, gen)
    w[3, 0] = float("inf")
    w[10, 1] = float("nan")
    err = max(check_sgd(torch, "train epochs=10",
                        lambda: ck.kvec_train_epochs(agg, w, 10),
                        lambda: ck.kvec_sgd_plain(agg, w, None, 10, 0.01)),
              check_sgd(torch, "learn severity=1",
                        lambda: ck.kvec_learn_epochs(agg, w, other, 1),
                        lambda: ck.kvec_sgd_plain(agg, w, other, 1, 0.01)))
    run = lambda: ck.kvec_train_epochs(agg, w, 10)
    ms = timed_ms(torch, run, 10)
    dev = device_ms(run)
    plain = timed_ms(torch, lambda: ck.kvec_sgd_plain(agg, w, None, 10,
                                                      0.01), 1, warm=False)
    epoch_ops = kvec_sgd_ops_per_epoch(agg, True)
    issued = kvec_sgd_ops_per_epoch(agg, True, kvec_reduce_issued)
    b, by = bound_ms((2 * p + 1) * N * 4, N * 10 * epoch_ops)
    log(f"  train epochs=10: kernel {ms:.3f} ms (device {dev:.4f}), plain "
        f"{plain:.3f} ms, bound {b:.3f} ms ({by}); the kernel issues {issued} "
        f"FP32 instructions an epoch on a finite lane ({epoch_ops} "
        f"operations), --fmad=false ceiling "
        f"{fmad_off_ms(N * 10 * issued):.3f} ms")
    rows["kvec_sgd"].update(max_abs_err=err, ms=ms, device_ms=dev,
                            plain_ms=plain, bound_ms=b, bound_by=by)

    # K5: train 10 and learn 1
    p = rnn.num_weights
    log(f"K5 rnn_sgd N={N} (recurrent, P={p})")
    w = population(rnn, N, gen, 0.5)
    other = population(rnn, N, gen, 0.5)
    w[16, 0] = float("inf")
    err = max(check_sgd(torch, "train epochs=10",
                        lambda: crt.rnn_train_epochs(rnn, w, 10),
                        lambda: crt.rnn_sgd_plain(rnn, w, None, 10, 0.01)),
              check_sgd(torch, "learn severity=1",
                        lambda: crt.rnn_learn_epochs(rnn, w, other, 1),
                        lambda: crt.rnn_sgd_plain(rnn, w, other, 1, 0.01)))
    run = lambda: crt.rnn_train_epochs(rnn, w, 10)
    ms = timed_ms(torch, run, 10)
    dev = device_ms(run)
    plain = timed_ms(torch, lambda: crt.rnn_sgd_plain(rnn, w, None, 10,
                                                      0.01), 1, warm=False)
    ops = N * 10 * rnn_sgd_ops_per_epoch(rnn)
    b, by = bound_ms((2 * p + 1) * N * 4, ops)
    log(f"  train epochs=10: kernel {ms:.3f} ms (device {dev:.4f}), plain "
        f"{plain:.3f} ms, bound {b:.3f} ms ({by}), --fmad=false ceiling "
        f"{fmad_off_ms(ops):.3f} ms")
    rows["rnn_sgd"].update(max_abs_err=err, ms=ms, device_ms=dev,
                           plain_ms=plain, bound_ms=b, bound_by=by)

    # K6: the attack, on victims of the attacker's length T = P and on the
    # mixed soup's cross victims (weightwise T = 14, aggregating T = 20)
    victims = {17: w}
    for t_len, vic in ((14, Topology("weightwise", width=2, depth=2)),
                       (20, agg)):
        victims[t_len] = population(vic, N, gen)
    for t_len, vT in victims.items():
        kernel = cra.RNN_APPLY_BY_T[t_len]
        log(f"K6 {kernel.name} N={N} (victims T={t_len})")
        err = compare(torch, "attack", cra.rnn_apply(rnn, other, vT),
                      cra.rnn_apply_plain(rnn, other, vT), 0)
        run = lambda: cra.rnn_apply(rnn, other, vT)
        ms = timed_ms(torch, run, 10)
        dev = device_ms(run)
        plain = timed_ms(torch, lambda: cra.rnn_apply_plain(rnn, other, vT),
                         1, warm=False)
        b, by = bound_ms((p + 2 * t_len) * N * 4,
                         N * rnn_forward_ops(rnn, t_len))
        log(f"  kernel {ms:.3f} ms (device {dev:.4f}), plain {plain:.3f} ms, "
            f"bound {b:.3f} ms ({by})")
        rows[kernel.name].update(max_abs_err=err, ms=ms, device_ms=dev,
                                 plain_ms=plain, bound_ms=b, bound_by=by)
    try:
        cra.rnn_apply(rnn, other, torch.zeros((65, N), device="cuda"))
    except ValueError:
        log("  T = 65 raises ValueError on the card, as documented (the "
            "fence of 64 weights)")
    else:
        raise AssertionError("rnn_apply took a victim longer than the "
                             "fence")

    # K3 bodies at N = 1M: the float32 ones and the bfloat16 ones, the
    # latter on the same population rounded to bfloat16
    ww = Topology("weightwise", width=2, depth=2)
    for topo, kernel, key, scale, dtype in (
            (agg, cg.GENERATION_KVEC, "generation_kvec", 1.0,
             torch.float32),
            (fft, cg.GENERATION_KVEC, None, 1.0, torch.float32),
            (rnn, cg.GENERATION_RNN, "generation_rnn", 0.5, torch.float32),
            (ww, cg.GENERATION_BF16, "generation_bf16", 1.0, torch.bfloat16),
            (agg, cg.GENERATION_KVEC_BF16, "generation_kvec_bf16", 1.0,
             torch.bfloat16),
            (rnn, cg.GENERATION_RNN_BF16, "generation_rnn_bf16", 0.5,
             torch.bfloat16)):
        log(f"K3 {kernel.name} N={N} ({topo.variant}, {dtype})")
        w = population(topo, N, gen, scale).to(dtype)
        err, ms, plain, ops, kw, n_dead, only = check_generation_body(
            torch, topo, kernel, w, gen, reps=100 if key else 0)
        if key is None:
            continue
        issued = gen_body_ops(topo, kvec_reduce_issued) \
            if topo.variant == "aggregating" else None
        b, by = gen_body_bound(topo, ops, kw, n_dead, *gen_body_ops(topo),
                               pop_bytes=w.element_size(), issued=issued)
        log(f"  kernel {ms:.3f} ms (device {only['device']:.4f}), plain "
            f"{plain:.3f} ms, bound {b:.3f} ms ({by})")
        log_train_only(ms, only)
        rows[key].update(max_abs_err=err, ms=ms, device_ms=only["device"],
                         plain_ms=plain, bound_ms=b, bound_by=by)

    # every other instantiation at a small N
    n = 65536
    small = [Topology("aggregating", aggregator=a) for a in ("max",
                                                             "max_buggy")]
    small += [Topology("fft", fft_mode=m) for m in ("fft", "rfft")]
    small += [Topology("fft", fft_use_target=True)]
    small += [Topology("aggregating", activation=a)
              for a in ("sigmoid", "tanh", "relu")]
    small += [Topology("recurrent", activation=a)
              for a in ("linear", "sigmoid", "tanh", "relu")]
    for t in small:
        log(f"{t.variant} aggregator={t.aggregator} fft_mode={t.fft_mode} "
            f"fft_use_target={t.fft_use_target} activation={t.activation} "
            f"N={n}")
        ws = population(t, n, gen, 0.5)
        os_ = population(t, n, gen, 0.5)
        if t.variant == "recurrent":
            check_sgd(torch, "K5 train=3", lambda: crt.rnn_train_epochs(
                t, ws, 3), lambda: crt.rnn_sgd_plain(t, ws, None, 3, 0.01))
            check_sgd(torch, "K5 learn=2", lambda: crt.rnn_learn_epochs(
                t, ws, os_, 2), lambda: crt.rnn_sgd_plain(t, ws, os_, 2,
                                                         0.01))
            compare(torch, "K6", cra.rnn_apply(t, os_, ws),
                    cra.rnn_apply_plain(t, os_, ws), 0)
            for t_len in (14, 20):
                vs = population(Topology("weightwise") if t_len == 14
                                else Topology("aggregating"), n, gen, 0.5)
                compare(torch, f"K6 T={t_len}", cra.rnn_apply(t, os_, vs),
                        cra.rnn_apply_plain(t, os_, vs), 0)
        else:
            check_sgd(torch, "K4 train=3", lambda: ck.kvec_train_epochs(
                t, ws, 3), lambda: ck.kvec_sgd_plain(t, ws, None, 3, 0.01))
            check_sgd(torch, "K4 learn=2", lambda: ck.kvec_learn_epochs(
                t, ws, os_, 2), lambda: ck.kvec_sgd_plain(t, ws, os_, 2,
                                                         0.01))
        o = gen_operands(torch, t, ws, gen, rate=0.5)
        kw = dict(severity=1, train=2, lr=0.01, remove_divergent=True,
                  remove_zero=True, epsilon=1e-4)
        check_small_generation(torch, t, ws, o, kw)




def reset(kernels) -> None:
    """Set every kernel's launch counts to 0."""
    for k in kernels:
        k.reset()


def row_name(kernel, tag: str) -> str:
    """The row of a kernel's build: its name for the default build,
    ``name[tag]`` for the build of another topology."""
    return f"{kernel.name}[{tag}]" if tag else kernel.name


def row_counts(kernels) -> dict:
    """The kernels' launch counts by row (one per kernel and build)."""
    out = {}
    for k in kernels:
        out[k.name] = k.launches_by.get("", 0)
        for tag, n in k.launches_by.items():
            if tag:
                out[row_name(k, tag)] = n
    return out


def check_launches(kernels, what: str, expect: dict, got=None) -> dict:
    """This run's launch counts by row (the kernels' own, or ``got``:
    {name: launches} of default builds, a name it lacks counting 0), which
    must be exactly ``expect`` ({row: launches}; 0 for a row that
    ``expect`` does not name)."""
    if got is None:
        got = row_counts(kernels)
    else:
        got = {k.name: got.get(k.name, 0) for k in kernels}
    rows = set(got) | set(expect)
    got = {r: got.get(r, 0) for r in sorted(rows)}
    want = {r: expect.get(r, 0) for r in sorted(rows)}
    log(f"  {what} launches {({r: n for r, n in got.items() if n})}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return got


def soup_runs(torch, kernels, totals, topo, expect_fused, expect_phases,
              population_dtype="f32", n=N, generations=GENERATIONS):
    """The N = 1M (or ``n``) full-dynamics soup of ``topo``, 20 (or
    ``generations``) generations on each route after a warm-up generation
    (on the fused route only where ``expect_phases`` is None), each run's
    own launch counts checked exactly and added to ``totals``; returns
    {route: generations/s}."""
    import srnn_tpu_torch as st

    rates = {}
    cfg = st.SoupConfig(topo=topo, size=n, attacking_rate=0.1,
                        learn_from_rate=0.1, learn_from_severity=1, train=10,
                        remove_divergent=True, remove_zero=True,
                        respawn_draws="fused", layout="popmajor",
                        population_dtype=population_dtype)
    state = st.seed(cfg, 0, device="cuda")
    routes = [("fused", cfg._replace(generation_impl="fused"), expect_fused)]
    if expect_phases is not None:
        routes.append(("phases", cfg, expect_phases))
    for impl, c, expect in routes:
        reset(kernels)
        st.evolve(c, state, 1)  # warm-up generation
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = st.evolve(c, state, generations)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = st.count(cfg, state)
        uids = state.uids
        what = (f"{topo.variant} width {topo.width} depth {topo.depth} "
                f"k={topo.aggregates} {population_dtype} soup {impl}")
        if int(torch.unique(uids).numel()) != n:
            raise AssertionError(f"{what}: uids are not unique")
        if int(counts.sum()) != n or not bool(torch.isfinite(
                state.weights.float()).all()):
            raise AssertionError(f"{what}: counts {counts.tolist()} or "
                                 "non-finite weights after respawn")
        rates[impl] = generations / dt
        log(f"{what}: {generations / dt:.3f} generations/s at N={n}, "
            f"P={topo.num_weights} ({dt * 1e3 / generations:.3f} "
            f"ms/generation), counts [divergent, fix_zero, fix_other, "
            f"fix_sec, other] {counts.tolist()}, unique uids "
            f"{int(torch.unique(uids).numel())}, next_uid "
            f"{int(state.next_uid)}")
        for name, k in check_launches(kernels, what, expect).items():
            totals[name] += k
    return rates


def rowmajor_soup_run(torch, kernels, totals, topo, kernel):
    """The N = 1M full-dynamics row-major soup (``layout='rowmajor'``, the
    default) of ``topo``: 20 generations after a warm-up generation, its
    launch counts set to 0 after the warm-up and checked exactly just
    after (``kernel``, the variant's SGD kernel, twice a generation: one
    learn_from and one self-training launch; the attack is the row-major
    transform in plain torch) and added to ``totals``."""
    import srnn_tpu_torch as st

    cfg = st.SoupConfig(topo=topo, size=N, attacking_rate=0.1,
                        learn_from_rate=0.1, learn_from_severity=1, train=10,
                        remove_divergent=True, remove_zero=True,
                        respawn_draws="fused")
    state = st.evolve(cfg, st.seed(cfg, 0, device="cuda"), 1)  # warm-up
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    state = st.evolve(cfg, state, GENERATIONS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    what = (f"{topo.variant} width {topo.width} depth {topo.depth} rowmajor "
            "soup")
    got = check_launches(kernels, what, {kernel: 2 * GENERATIONS})
    counts = st.count(cfg, state)
    n_unique = int(torch.unique(state.uids).numel())
    if n_unique != N or int(state.uids.max()) >= int(state.next_uid):
        raise AssertionError(f"{what}: uids are not unique")
    if int(counts.sum()) != N or not bool(torch.isfinite(
            state.weights).all()):
        raise AssertionError(f"{what}: counts {counts.tolist()} or "
                             "non-finite weights after respawn")
    log(f"{what}: {GENERATIONS / dt:.3f} generations/s at N={N}, "
        f"P={topo.num_weights} ({dt * 1e3 / GENERATIONS:.3f} "
        f"ms/generation), counts [divergent, fix_zero, fix_other, "
        f"fix_sec, other] {counts.tolist()}, unique uids {n_unique}, "
        f"next_uid {int(state.next_uid)}")
    for name, n in got.items():
        totals[name] += n
    return GENERATIONS / dt


def multisoup_runs(torch, kernels, totals, per_generation_fused,
                   per_generation_phases):
    """The mixed-type soup at setups/mega_multisoup.py's split and
    dynamics, N = 1M, 20 generations on each route after a warm-up
    generation, each run's own launch counts checked exactly and added to
    ``totals``."""
    from srnn_tpu_torch import multisoup as ms

    cfg = mega_multi_config(layout="popmajor")
    state = ms.seed_multi(cfg, 0, device="cuda")
    runs = GENERATIONS + 1
    for impl, per_gen in (("fused", per_generation_fused),
                          ("phases", per_generation_phases)):
        c = cfg._replace(generation_impl=impl)
        reset(kernels)
        ms.evolve_multi(c, state, 1)  # warm-up generation
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ms.evolve_multi(c, state, GENERATIONS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_multi_state(torch, c, state, f"mixed soup {impl}", dt)
        expect = {name: n * runs for name, n in per_gen.items()}
        for name, n in check_launches(kernels, f"mixed soup {impl}",
                                      expect).items():
            totals[name] += n


def mega_multi_config(**kw):
    """The mixed soup at setups/mega_multisoup.py's split, N = 1M as
    333,334 weightwise, 333,333 aggregating and 333,333 recurrent
    particles, with the full dynamics."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch import multisoup as ms

    third = N // 3
    return ms.MultiSoupConfig(
        topos=(st.Topology("weightwise", width=2, depth=2),
               st.Topology("aggregating", width=2, depth=2, aggregates=4),
               st.Topology("recurrent", width=2, depth=2)),
        sizes=(N - 2 * third, third, third), attacking_rate=0.1,
        learn_from_rate=0.1, learn_from_severity=1, train=10,
        remove_divergent=True, remove_zero=True, respawn_draws="fused", **kw)


def check_multi_state(torch, cfg, state, what, dt):
    """A mixed soup after ``GENERATIONS`` generations in ``dt`` seconds:
    uids globally unique, each type's class counts summing to N_t, weights
    finite; logs generations/s."""
    from srnn_tpu_torch import multisoup as ms

    counts = ms.count_multi(cfg, state)
    uids = torch.cat(state.uids)
    n_unique = int(torch.unique(uids).numel())
    if n_unique != N or int(uids.max()) >= int(state.next_uid):
        raise AssertionError(f"{what}: uids are not globally unique")
    if counts.sum(dim=1).tolist() != list(cfg.sizes) or not all(
            bool(torch.isfinite(w).all()) for w in state.weights):
        raise AssertionError(f"{what}: counts {counts.tolist()} or "
                             "non-finite weights after respawn")
    log(f"{what}: {GENERATIONS / dt:.3f} generations/s at N={N} "
        f"(sizes {cfg.sizes}; {dt * 1e3 / GENERATIONS:.3f} "
        f"ms/generation), per-type counts [divergent, fix_zero, "
        f"fix_other, fix_sec, other] {counts.tolist()}, unique uids "
        f"{n_unique}, next_uid {int(state.next_uid)}")


def rowmajor_multisoup_run(torch, kernels, totals):
    """The mixed soup in the row-major layout (the default) at
    mega_multisoup's split: 20 generations after a warm-up generation, its
    launch counts set to 0 after the warm-up and checked exactly just
    after (each type's SGD kernel twice a generation: K2, K4 and K5; the
    cross attack is plain torch, so no K6) and added to ``totals``."""
    from srnn_tpu_torch import multisoup as ms

    cfg = mega_multi_config()
    state = ms.evolve_multi(cfg, ms.seed_multi(cfg, 0, device="cuda"), 1)
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    state = ms.evolve_multi(cfg, state, GENERATIONS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    what = "mixed rowmajor soup"
    got = check_launches(kernels, what, {name: 2 * GENERATIONS for name in
                                         ("ww_sgd", "kvec_sgd", "rnn_sgd")})
    check_multi_state(torch, cfg, state, what, dt)
    for name, n in got.items():
        totals[name] += n


def routes_multisoup_run(torch, kernels, totals):
    """The mixed phase chain at mega_multisoup's split, N = 1M, the full
    dynamics, 20 generations after a warm-up generation, each type on its
    route: the weightwise third elu (the autograd chain, no K2 launch), the
    aggregating third on K4 twice a generation, the recurrent third with
    rnn_scan='associative' on K5 twice and K6 once per victim type (the
    population-major serial scan, as in the JAX package); launch counts
    exact, added to ``totals``."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch import multisoup as ms

    base = mega_multi_config(layout="popmajor")
    cfg = base._replace(topos=(
        st.Topology("weightwise", width=2, depth=2, activation="elu"),
        base.topos[1],
        st.Topology("recurrent", width=2, depth=2, rnn_scan="associative")))
    what = "mixed soup routes"
    log(f"{what}: train_impl {ms.resolved_train_impls(cfg)}")
    state = ms.seed_multi(cfg, 0, device="cuda")
    reset(kernels)
    ms.evolve_multi(cfg, state, 1)  # warm-up generation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ms.evolve_multi(cfg, state, GENERATIONS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_multi_state(torch, cfg, state, what, dt)
    per_gen = {"kvec_sgd": 2, "rnn_sgd": 2, "rnn_apply_t14": 1,
               "rnn_apply_t20": 1, "rnn_apply": 1}
    for name, n in check_launches(kernels, what, {
            k: n * (GENERATIONS + 1) for k, n in per_gen.items()}).items():
        totals[name] += n


def autograd_soup_run(torch, kernels, topo, generations=10):
    """The N = 1M full-dynamics row-major soup of a particle outside every
    kernel's instantiation (its attack plain torch, its learn_from and
    training the autograd chain): ``generations`` after a warm-up
    generation, exactly no kernel launch from the warm-up on;
    generations/s, to inform."""
    import srnn_tpu_torch as st

    cfg = st.SoupConfig(topo=topo, size=N, attacking_rate=0.1,
                        learn_from_rate=0.1, learn_from_severity=1, train=10,
                        remove_divergent=True, remove_zero=True,
                        respawn_draws="fused")
    reset(kernels)
    state = st.evolve(cfg, st.seed(cfg, 0, device="cuda"), 1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = st.evolve(cfg, state, generations)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    what = (f"{topo.variant} {topo.activation} width {topo.width} depth "
            f"{topo.depth} rowmajor soup (autograd route)")
    check_launches(kernels, what, {})
    counts = st.count(cfg, state)
    n_unique = int(torch.unique(state.uids).numel())
    if n_unique != N or int(counts.sum()) != N or not bool(
            torch.isfinite(state.weights).all()):
        raise AssertionError(f"{what}: uids, counts {counts.tolist()} or "
                             "non-finite weights after respawn")
    log(f"{what}: {generations / dt:.3f} generations/s at N={N}, "
        f"P={topo.num_weights} ({dt * 1e3 / generations:.3f} "
        f"ms/generation), counts [divergent, fix_zero, fix_other, fix_sec, "
        f"other] {counts.tolist()}, unique uids {n_unique}")


# ------------------------------------------- off the default builds (PR 11)


def wide_topos():
    """The topologies off the default builds that the main path runs: width
    3 / depth 3 of every variant (weightwise P = 33, aggregating and fft
    with 4 aggregates P = 42, recurrent P = 52), aggregating with 6
    aggregates (P = 28), and the fence, aggregating width 4 / depth 1 with
    8 aggregates (P = 64)."""
    from srnn_tpu_torch import Topology

    return {"ww": Topology("weightwise", width=3, depth=3),
            "agg": Topology("aggregating", width=3, depth=3),
            "fft": Topology("fft", width=3, depth=3),
            "rnn": Topology("recurrent", width=3, depth=3),
            "k6": Topology("aggregating", aggregates=6),
            "k8": Topology("aggregating", width=4, depth=1, aggregates=8)}


#: the width-3 / depth-3 recurrent attacker's victim lengths: the mixed
#: chain's weightwise, k-vector and recurrent thirds
WIDE_T = (33, 42, 52)
#: particles of the fence's soups and checks
FENCE_N = 4096


def wide_jobs():
    """The (source, build) jobs of the wide topologies' builds, and of the
    width-3 / depth-3 tanh K2 and K3 weightwise body."""
    import dataclasses

    from srnn_tpu_torch.ops.cuda_generation import builds_for

    t = wide_topos()
    jobs = []
    for name, topo in t.items():
        jobs += builds_for(topo, WIDE_T if name == "rnn" else (),
                           bf16=name == "ww")
    tanh = dataclasses.replace(t["ww"], activation="tanh")
    return jobs + [j for j in builds_for(tanh) if j[0] != "ww_apply"]


def wide_row(kernel, topo, t_len=None) -> str:
    """The row of ``kernel``'s build for ``topo`` (K6: on victims of
    ``t_len``)."""
    from srnn_tpu_torch.ops.cuda_kvec_train import kvec_build
    from srnn_tpu_torch.ops.cuda_sgd_common import kernel_build

    b = kvec_build(topo) if topo.variant in ("aggregating", "fft") \
        else kernel_build(topo, t_len=t_len)
    return row_name(kernel, b.tag)


def wide_rows():
    """(kernel, topology, victim length) of every row off the default
    builds."""
    from srnn_tpu_torch.ops import cuda_generation as cg
    from srnn_tpu_torch.ops import cuda_kvec_train as ck
    from srnn_tpu_torch.ops import cuda_rnn_apply as cra
    from srnn_tpu_torch.ops import cuda_rnn_train as crt
    from srnn_tpu_torch.ops import cuda_ww, cuda_ww_train

    t = wide_topos()
    out = [(cuda_ww.WW_APPLY, t["ww"], None),
           (cuda_ww_train.WW_SGD, t["ww"], None),
           (cg.GENERATION, t["ww"], None),
           (cg.GENERATION_BF16, t["ww"], None)]
    for key in ("agg", "fft", "k6", "k8"):
        out += [(ck.KVEC_SGD, t[key], None),
                (cg.GENERATION_KVEC, t[key], None)]
    out += [(crt.RNN_SGD, t["rnn"], None),
            (cg.GENERATION_RNN, t["rnn"], None)]
    out += [(cra.rnn_apply_kernel(tl), t["rnn"], tl) for tl in WIDE_T]
    return out


def check_wide_kernels(torch, rows):
    """Phase 3, off the default builds: each kernel of the wide topologies
    against its plain version on the card at the main path's N (the
    fence's at FENCE_N), bitwise (weights, attack outputs, the mean loss
    and the dead masks), timed beside its bound; at a small N, the
    width-3 / depth-3 tanh K2 and K3 weightwise body and K2's shuffled
    instantiation, bitwise."""
    import dataclasses

    from srnn_tpu_torch.ops import cuda_generation as cg
    from srnn_tpu_torch.ops import cuda_kvec_train as ck
    from srnn_tpu_torch.ops import cuda_rnn_apply as cra
    from srnn_tpu_torch.ops import cuda_rnn_train as crt
    from srnn_tpu_torch.ops import cuda_ww, cuda_ww_train as cwt

    t = wide_topos()
    gen = torch.Generator(device="cuda").manual_seed(11)

    def fill(row, err, ms, dev, plain, b, by):
        rows[row].update(max_abs_err=err, ms=ms, device_ms=dev,
                         plain_ms=plain, bound_ms=b, bound_by=by)
        log(f"  {row}: kernel {ms:.3f} ms (device {dev:.4f}), plain "
            f"{plain:.3f} ms, bound {b:.4f} ms ({by}), device / bound "
            f"{dev / b:.2f}")

    def sgd_row(kernel, topo, n, train, learn, plain, ops_epoch, scale=1.0,
                poison=()):
        """The SGD chain of ``topo``: train 10 and learn 1 bitwise, train
        10 timed."""
        p = topo.num_weights
        log(f"{kernel.name} N={n} ({topo.variant} width {topo.width} depth "
            f"{topo.depth} k={topo.aggregates}, P={p})")
        w = population(topo, n, gen, scale)
        other = population(topo, n, gen, scale)
        for (r, c), v in poison:
            w[r, c] = v
        err = max(check_sgd(torch, "train epochs=10",
                            lambda: train(topo, w, 10),
                            lambda: plain(topo, w, None, 10, 0.01)),
                  check_sgd(torch, "learn severity=1",
                            lambda: learn(topo, w, other, 1),
                            lambda: plain(topo, w, other, 1, 0.01)))
        run = lambda: train(topo, w, 10)
        b, by = bound_ms((2 * p + 1) * n * 4, n * 10 * ops_epoch)
        fill(wide_row(kernel, topo), err, timed_ms(torch, run, 10),
             device_ms(run), timed_ms(torch, lambda: plain(
                 topo, w, None, 10, 0.01), 1, warm=False), b, by)
        return w, other

    def body_row(kernel, topo, n, scale=1.0, dtype=torch.float32):
        """K3's body for ``topo``, all phases, train 10."""
        log(f"K3 {kernel.name} N={n} ({topo.variant} width {topo.width} "
            f"depth {topo.depth} k={topo.aggregates}, {dtype})")
        w = population(topo, n, gen, scale).to(dtype)
        err, ms, plain, ops, kw, n_dead, only = check_generation_body(
            torch, topo, kernel, w, gen)
        b, by = gen_body_bound(topo, ops, kw, n_dead, *gen_body_ops(topo),
                               pop_bytes=w.element_size(), n=n)
        log_train_only(ms, only)
        fill(wide_row(kernel, topo), err, ms, only["device"], plain, b, by)

    # K1: 50 steps (the plain chain of 2000 would take minutes)
    ww = t["ww"]
    p = ww.num_weights
    log(f"K1 ww_apply N={N} (weightwise width 3 depth 3, P={p})")
    wd = population(ww, N, gen, 0.05)
    for steps in (1, 50):
        err = compare(torch, f"steps={steps}",
                      cuda_ww.ww_apply_population(ww, wd, steps),
                      cuda_ww.ww_apply_population_plain(ww, wd, steps), 0)
    run = lambda: cuda_ww.ww_apply_population(ww, wd, 50)
    b, by = bound_ms(2 * p * N * 4, 50 * N * p * apply_ops_per_point(ww))
    log(f"  steps=50: the kernel issues {ww_apply_issued(ww)} FP32 "
        f"instructions an application ({p * apply_ops_per_point(ww)} "
        f"operations), --fmad=false ceiling "
        f"{fmad_off_ms(50 * N * ww_apply_issued(ww)):.3f} ms")
    fill(wide_row(cuda_ww.WW_APPLY, ww), err, timed_ms(torch, run, 5),
         device_ms(run, 5), timed_ms(torch, lambda: cuda_ww.
                                     ww_apply_population_plain(ww, wd, 50),
                                     1, warm=False), b, by)
    # K2 and K3's weightwise bodies
    w, _ = sgd_row(cwt.WW_SGD, ww, N, cwt.ww_train_epochs,
                   cwt.ww_learn_epochs, cwt.ww_sgd_plain,
                   sgd_ops_per_epoch(ww))
    log(f"  K2 issues {ww_sgd_issued_per_epoch(ww)} FP32 instructions an "
        f"epoch, --fmad=false ceiling "
        f"{fmad_off_ms(N * 10 * ww_sgd_issued_per_epoch(ww)):.3f} ms")
    body_row(cg.GENERATION, ww, N)
    body_row(cg.GENERATION_BF16, ww, N, dtype=torch.bfloat16)
    # at a small N: tanh's K2 and K3 weightwise body, K2 shuffled
    n = 65536
    tanh = dataclasses.replace(ww, activation="tanh")
    log(f"weightwise width 3 depth 3 tanh, and K2 shuffled, N={n}")
    ws = population(tanh, n, gen, 0.3)
    check_sgd(torch, "K2 tanh train=3",
              lambda: cwt.ww_train_epochs(tanh, ws, 3),
              lambda: cwt.ww_sgd_plain(tanh, ws, None, 3, 0.01))
    check_small_generation(torch, tanh, ws, gen_operands(torch, tanh, ws,
                                                         gen, rate=0.5),
                           dict(severity=1, train=2, lr=0.01,
                                remove_divergent=True, remove_zero=True,
                                epsilon=1e-4), bf16=False)
    order = torch.rand((3, p, n), generator=gen, device="cuda").argsort(
        dim=1).to(torch.uint8)
    check_sgd(torch, "K2 shuffled train=3",
              lambda: cwt.ww_train_epochs(ww, ws, 3, order=order),
              lambda: cwt.ww_sgd_plain(ww, ws, None, 3, 0.01, order))
    # K4 and K3's k-vector bodies; the fence at FENCE_N
    for key, n in (("agg", N), ("fft", N), ("k6", N), ("k8", FENCE_N)):
        topo = t[key]
        sgd_row(ck.KVEC_SGD, topo, n, ck.kvec_train_epochs,
                ck.kvec_learn_epochs, ck.kvec_sgd_plain,
                kvec_sgd_ops_per_epoch(topo, True),
                poison=(((3, 0), float("inf")), ((10, 1), float("nan"))))
        body_row(cg.GENERATION_KVEC, topo, n)
    # K5, K6 on the victims of the soup and the mixed chain, K3's body
    rnn = t["rnn"]
    p = rnn.num_weights
    w, other = sgd_row(crt.RNN_SGD, rnn, N, crt.rnn_train_epochs,
                       crt.rnn_learn_epochs, crt.rnn_sgd_plain,
                       rnn_sgd_ops_per_epoch(rnn), scale=0.5,
                       poison=(((p - 1, 0), float("inf")),))
    victims = {33: population(ww, N, gen), 42: population(t["agg"], N, gen),
               52: w}
    for t_len, vT in victims.items():
        kernel = cra.rnn_apply_kernel(t_len)
        log(f"K6 {kernel.name} N={N} (width 3 depth 3 attacker, victims "
            f"T={t_len})")
        err = compare(torch, "attack", cra.rnn_apply(rnn, other, vT),
                      cra.rnn_apply_plain(rnn, other, vT), 0)
        run = lambda: cra.rnn_apply(rnn, other, vT)
        b, by = bound_ms((p + 2 * t_len) * N * 4,
                         N * rnn_forward_ops(rnn, t_len))
        fill(wide_row(kernel, rnn, t_len), err, timed_ms(torch, run, 10),
             device_ms(run), timed_ms(torch, lambda: cra.rnn_apply_plain(
                 rnn, other, vT), 1, warm=False), b, by)
    body_row(cg.GENERATION_RNN, rnn, N, scale=0.5)


def wide_multisoup_run(torch, kernels, totals):
    """The mixed phase chain at mega_multisoup's split, N = 1M, the full
    dynamics, of width-3 / depth-3 thirds: 20 generations after a warm-up
    generation, each type on its SGD kernel twice a generation and the
    recurrent attacker on K6 once per victim type (T = 33, 42, 52); launch
    counts exact, added to ``totals``.  Returns generations/s."""
    from srnn_tpu_torch import multisoup as ms
    from srnn_tpu_torch.ops import cuda_kvec_train as ck
    from srnn_tpu_torch.ops import cuda_rnn_apply as cra
    from srnn_tpu_torch.ops import cuda_rnn_train as crt
    from srnn_tpu_torch.ops import cuda_ww_train as cwt

    t = wide_topos()
    cfg = mega_multi_config(layout="popmajor")._replace(
        topos=(t["ww"], t["agg"], t["rnn"]))
    what = "mixed soup width 3 depth 3 phases"
    state = ms.seed_multi(cfg, 0, device="cuda")
    reset(kernels)
    ms.evolve_multi(cfg, state, 1)  # warm-up generation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ms.evolve_multi(cfg, state, GENERATIONS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_multi_state(torch, cfg, state, what, dt)
    per_gen = {wide_row(cwt.WW_SGD, t["ww"]): 2,
               wide_row(ck.KVEC_SGD, t["agg"]): 2,
               wide_row(crt.RNN_SGD, t["rnn"]): 2}
    per_gen.update({wide_row(cra.rnn_apply_kernel(tl), t["rnn"], tl): 1
                    for tl in WIDE_T})
    for name, n in check_launches(kernels, what, {
            k: n * (GENERATIONS + 1) for k, n in per_gen.items()}).items():
        totals[name] += n
    return GENERATIONS / dt


def wide_main_path(torch, kernels, totals):
    """Phase 4, off the default builds: at N = 1M the full-dynamics
    population-major soups of the width-3 / depth-3 weightwise,
    aggregating, fft and recurrent particles and of the aggregating one
    with 6 aggregates on both routes (fused: K3's body; phases: the SGD
    kernel twice a generation, and K6 on T = 52 for the recurrent one),
    the bfloat16 weightwise one fused, the mixed phase chain of
    width-3 / depth-3 thirds, and the width-3 / depth-3 row-major
    weightwise soup (K2 twice a generation); at N = 4,096 the fence's
    soups, 3 generations on each route.  Launch counts exact by build;
    generations/s logged beside the autograd route's."""
    from srnn_tpu_torch.ops import cuda_generation as cg
    from srnn_tpu_torch.ops import cuda_kvec_train as ck
    from srnn_tpu_torch.ops import cuda_rnn_apply as cra
    from srnn_tpu_torch.ops import cuda_rnn_train as crt
    from srnn_tpu_torch.ops import cuda_ww_train as cwt

    t = wide_topos()
    runs = GENERATIONS + 1
    rates = {}
    for key, body, sgd, extra in (
            ("ww", cg.GENERATION, cwt.WW_SGD, {}),
            ("agg", cg.GENERATION_KVEC, ck.KVEC_SGD, {}),
            ("fft", cg.GENERATION_KVEC, ck.KVEC_SGD, {}),
            ("rnn", cg.GENERATION_RNN, crt.RNN_SGD,
             {wide_row(cra.rnn_apply_kernel(52), t["rnn"], 52): runs}),
            ("k6", cg.GENERATION_KVEC, ck.KVEC_SGD, {})):
        topo = t[key]
        for route, r in soup_runs(torch, kernels, totals, topo,
                                  {wide_row(body, topo): runs},
                                  {wide_row(sgd, topo): 2 * runs,
                                   **extra}).items():
            rates[f"{key} {route}"] = r
    rates["ww bf16 fused"] = soup_runs(
        torch, kernels, totals, t["ww"],
        {wide_row(cg.GENERATION_BF16, t["ww"]): runs}, None,
        population_dtype="bf16")["fused"]
    k8 = t["k8"]
    soup_runs(torch, kernels, totals, k8,
              {wide_row(cg.GENERATION_KVEC, k8): 4},
              {wide_row(ck.KVEC_SGD, k8): 8}, n=FENCE_N, generations=3)
    rates["mixed phases"] = wide_multisoup_run(torch, kernels, totals)
    rates["ww rowmajor"] = rowmajor_soup_run(
        torch, kernels, totals, t["ww"], wide_row(cwt.WW_SGD, t["ww"]))
    log(f"generations/s off the default builds at N={N}: " + ", ".join(
        f"{what} {r:.3f}" for what, r in rates.items())
        + " (PR 10's width-3 / depth-3 row-major weightwise soup on the "
        "autograd route: 0.910-1.202)")


def main_path(torch, kernels):
    """Phase 4: the soups and the applications/s program at N = 1M through
    the public entry points, each run with its own launch counts; returns
    the launch counts summed over the runs."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch.bench import measure

    runs = GENERATIONS + 1
    totals = collections.defaultdict(int, {k.name: 0 for k in kernels})
    topo = st.Topology("weightwise", width=2, depth=2)
    soup_runs(torch, kernels, totals, topo, {"generation": runs},
              {"ww_sgd": 2 * runs})
    soup_runs(torch, kernels, totals,
              st.Topology("aggregating", width=2, depth=2, aggregates=4),
              {"generation_kvec": runs}, {"kvec_sgd": 2 * runs})
    soup_runs(torch, kernels, totals,
              st.Topology("recurrent", width=2, depth=2),
              {"generation_rnn": runs},
              {"rnn_sgd": 2 * runs, "rnn_apply": runs})
    # the row-major soups (the default layout): their SGD kernel only
    for variant, kernel in (("weightwise", "ww_sgd"),
                            ("aggregating", "kvec_sgd"),
                            ("recurrent", "rnn_sgd")):
        rowmajor_soup_run(torch, kernels, totals,
                          st.Topology(variant, width=2, depth=2,
                                      aggregates=4), kernel)
    # the mixed soup: every generation attacks each victim type once with
    # the recurrent kernel (T = 14, 20, 17), whatever the route
    attacks = {"rnn_apply_t14": 1, "rnn_apply_t20": 1, "rnn_apply": 1}
    multisoup_runs(torch, kernels, totals,
                   {"generation": 1, "generation_kvec": 1,
                    "generation_rnn": 1, **attacks},
                   {"ww_sgd": 2, "kvec_sgd": 2, "rnn_sgd": 2, **attacks})
    # the mixed soup in the row-major layout (the default): the types' SGD
    # kernels only
    rowmajor_multisoup_run(torch, kernels, totals)
    # every particle the JAX package trains: the mixed phase chain with an
    # elu weightwise type (the autograd route: no K2) and an associative
    # recurrent one (K5 and K6, popmajor's serial scan); row-major soups
    # wholly off the kernels (no launch at all)
    routes_multisoup_run(torch, kernels, totals)
    autograd_soup_run(torch, kernels, st.Topology("weightwise", width=2,
                                                  depth=2, activation="elu"))
    # a particle past the fence of 64 weights (width 6 / depth 2, P = 66):
    # the autograd route; 3 generations, host-bound at about 2 s each
    autograd_soup_run(torch, kernels, st.Topology("weightwise", width=6,
                                                  depth=2), generations=3)
    # every kernel off its default build (PR 11)
    wide_main_path(torch, kernels, totals)
    # bfloat16 populations on the fused route: K3's bfloat16 bodies
    for variant, kernel in (("weightwise", "generation_bf16"),
                            ("aggregating", "generation_kvec_bf16"),
                            ("recurrent", "generation_rnn_bf16")):
        soup_runs(torch, kernels, totals,
                  st.Topology(variant, width=2, depth=2, aggregates=4),
                  {kernel: runs}, None, population_dtype="bf16")
    # applications/s: N particles x 2000 chained self-applications,
    # the program of python -m srnn_tpu_torch.bench (it checks the output
    # is finite)
    reset(kernels)
    row = measure(N)
    calls = row["calls"]
    log(f"applications/s: {row['value']:.6e} at N={N}, steps={row['steps']} "
        f"({row['seconds'] * 1e3 / calls:.3f} ms per call; "
        f"srnn_tpu_torch.bench)")
    for name, n in check_launches(kernels, "applications/s program",
                                  {"ww_apply": calls + 1}).items():
        totals[name] += n
    fixpoint_census(torch)
    return totals


def fixpoint_census(torch):
    """To inform: class counts of fresh aggregating and recurrent nets
    self-applied to fixpoint (the reference's headline experiment;
    BASELINE.md has the CPU reference's proportions for 50 trials)."""
    import srnn_tpu_torch as st

    trials = 500
    for topo in (st.Topology("aggregating", width=2, depth=2, aggregates=4),
                 st.Topology("recurrent", width=2, depth=2)):
        pop = st.init_population(topo, 7, trials, "cuda")
        t0 = time.perf_counter()
        res = st.run_fixpoint(topo, pop, step_limit=100)
        counts = res.counts.tolist()
        log(f"run_fixpoint {topo.variant}: {trials} trials, 100 steps, "
            f"counts [divergent, fix_zero, fix_other, fix_sec, other] "
            f"{counts} ({time.perf_counter() - t0:.1f} s)")
        if sum(counts) != trials:
            raise AssertionError(f"run_fixpoint {topo.variant}: counts "
                                 f"{counts} do not sum to {trials}")


#: launches of each setup's CLI at its default sizes: applying_fixpoints and
#: network_trajectorys 100 weightwise steps; known_fixpoint_variation 10
#: levels of 100 steps and one more application each; mixed_self_fixpoints
#: 11 train values x 4 self-attacks (no SGD launch for 0 trains) per
#: variant; training_fixpoints 1000 epochs per variant.  The soup setups
#: launch once per generation for a whole batch of trials: soup_trajectorys
#: 100 generations of train 30; learn_from_soup 10 non-zero severities x 100
#: generations, all imitation (train 0, and severity 0 skips the phase);
#: mixed_soup 10 non-zero train values x 5 generations per variant
SETUP_LAUNCHES = {
    "applying_fixpoints": {"ww_apply": 100},
    "fixpoint_density": {},
    "known_fixpoint_variation": {"ww_apply": 10 * 101},
    "mixed_self_fixpoints": {"ww_apply": 44, "ww_sgd": 40, "kvec_sgd": 40,
                             "rnn_sgd": 40},
    "training_fixpoints": {"ww_sgd": 1000, "kvec_sgd": 1000,
                           "rnn_sgd": 1000},
    "network_trajectorys": {"ww_apply": 100},
    "soup_trajectorys": {"ww_sgd": 100},
    "learn_from_soup": {"ww_sgd": 1000},
    "mixed_soup": {"ww_sgd": 50, "kvec_sgd": 50},
}
ENGINE_STEPS = 100
#: the device the engines' phase runs on
CARD = "cuda"


def check_engine_result(torch, what, res, n):
    """Class counts sum to n, and a trial's weights are non-finite exactly
    where it is classed divergent (the JAX package's is_diverged)."""
    from srnn_tpu_torch.ops.predicates import CLS_DIVERGENT

    counts = res.counts.tolist()
    if sum(counts) != n:
        raise AssertionError(f"{what}: counts {counts} do not sum to {n}")
    diverged = ~torch.isfinite(res.weights).all(dim=1)
    if not bool(torch.equal(diverged, res.classes == CLS_DIVERGENT)):
        raise AssertionError(f"{what}: non-finite weights and the divergent "
                             "class disagree")
    return counts


def engine_runs(torch, kernels, totals):
    """The fixpoint engines at N = 1M on the card through the package's
    entry points, each run with its own launch counts (added to
    ``totals``): the weightwise engines on K1 and K2, and run_training of
    the aggregating and recurrent variants on K4 and K5."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch.fixtures import identity_fixpoint_flat, vary

    gen = torch.Generator(device=CARD).manual_seed(3)
    ww = st.Topology("weightwise", width=2, depth=2)
    agg = st.Topology("aggregating", width=2, depth=2, aggregates=4)
    rnn = st.Topology("recurrent", width=2, depth=2)
    pop = st.init_population(ww, gen, N, CARD)
    fix = identity_fixpoint_flat(ww, CARD).expand(N, -1)
    varied = vary(gen, fix, 1e-5)

    def run(what, fn, expect):
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for name, k in check_launches(kernels, what, expect).items():
            totals[name] += k
        return res, dt

    steps = ENGINE_STEPS
    agg_pop = st.init_population(agg, gen, N, CARD)
    rnn_pop = st.init_population(rnn, gen, N, CARD)
    walls = {}
    cases = [
            (f"run_fixpoint weightwise {steps} steps",
             lambda: st.run_fixpoint(ww, pop, steps), {"ww_apply": steps},
             steps),
            (f"run_training weightwise {steps} epochs",
             lambda: st.run_training(ww, pop, steps), {"ww_sgd": steps},
             steps),
            (f"run_training weightwise {steps} epochs shuffled",
             lambda: st.run_training(
                 ww, pop, steps, shuffle_key=torch.Generator(
                     device=CARD).manual_seed(7)),
             {"ww_sgd_shuffled": steps}, steps),
            ("run_mixed_fixpoint weightwise 4 steps x 50 trains",
             lambda: st.run_mixed_fixpoint(ww, pop, 50, 4),
             {"ww_apply": 4, "ww_sgd": 4}, 4),
            (f"run_training aggregating {steps} epochs",
             lambda: st.run_training(agg, agg_pop, steps),
             {"kvec_sgd": steps}, steps),
            (f"run_training recurrent {steps} epochs",
             lambda: st.run_training(rnn, rnn_pop, steps),
             {"rnn_sgd": steps}, steps)]
    # width 3 / depth 3 (PR 11): K1 and the SGD kernels off their default
    # builds
    from srnn_tpu_torch.ops import cuda_kvec_train as ck
    from srnn_tpu_torch.ops import cuda_rnn_train as crt
    from srnn_tpu_torch.ops import cuda_ww as cw
    from srnn_tpu_torch.ops import cuda_ww_train as cwt

    wide = wide_topos()
    wpop = {key: st.init_population(wide[key], gen, N, CARD)
            for key in ("ww", "agg", "fft", "rnn")}
    cases.append((f"run_fixpoint weightwise width 3 depth 3 {steps} steps",
                  lambda: st.run_fixpoint(wide["ww"], wpop["ww"], steps),
                  {wide_row(cw.WW_APPLY, wide["ww"]): steps}, steps))
    for key, kernel in (("ww", cwt.WW_SGD), ("agg", ck.KVEC_SGD),
                        ("fft", ck.KVEC_SGD), ("rnn", crt.RNN_SGD)):
        cases.append((f"run_training {wide[key].variant} width 3 depth 3 "
                      f"{steps} epochs",
                      lambda key=key: st.run_training(wide[key], wpop[key],
                                                      steps),
                      {wide_row(kernel, wide[key]): steps}, steps))
    for what, fn, expect, n_steps in cases:
        res, dt = run(what, fn, expect)
        counts = check_engine_result(torch, what, res, N)
        extra = ""
        if hasattr(res, "losses"):
            if tuple(res.losses.shape) != (steps, N):
                raise AssertionError(f"{what}: losses {tuple(res.losses.shape)}")
            extra = (f", last epoch's mean loss over finite trials "
                     f"{float(res.losses[-1][torch.isfinite(res.losses[-1])].mean()):.6e}")
        walls[what] = dt
        if what.endswith("shuffled"):
            extra += (f"; the unshuffled run's wall "
                      f"{walls[what[:-len(' shuffled')]]:.4f} s")
        log(f"{what}: {dt:.4f} s at N={N} ({dt * 1e3 / n_steps:.4f} ms a "
            f"step or epoch), counts [divergent, fix_zero, fix_other, "
            f"fix_sec, other] {counts}{extra}")
    what = f"run_known_fixpoint_variation weightwise {steps} steps (e=1e-5)"
    res, dt = run(what, lambda: st.run_known_fixpoint_variation(ww, varied,
                                                                steps),
                  {"ww_apply": steps + 1})
    t_some, t_fix = res.time_to_vergence, res.time_as_fixpoint
    if not (bool((t_fix <= t_some).all()) and int(t_some.max()) <= steps):
        raise AssertionError(f"{what}: times out of range")
    log(f"{what}: {dt:.4f} s at N={N} ({dt * 1e3 / steps:.4f} ms a step), "
        f"mean time to vergence "
        f"{float(t_some.float().mean()):.3f}, as fixpoint "
        f"{float(t_fix.float().mean()):.3f}")
    what = "fixpoint_density weightwise"
    counts, dt = run(what, lambda: st.fixpoint_density(ww, pop), {})
    if int(counts.sum()) != N:
        raise AssertionError(f"{what}: counts {counts.tolist()}")
    log(f"{what}: {dt:.4f} s at N={N}, counts {counts.tolist()}")
    # the device time of one launch as the engines make it, beside their
    # walls a step: how much of a step the card is busy
    from srnn_tpu_torch.ops import (cuda_kvec_train, cuda_rnn_train, cuda_ww,
                                    cuda_ww_train)

    lanes = {t: p.t().contiguous() for t, p in ((ww, pop), (agg, agg_pop),
                                                (rnn, rnn_pop))}
    for what, fn in (
            ("K1 steps=1", lambda: cuda_ww.ww_apply_population(
                ww, lanes[ww], 1)),
            ("K2 epochs=1", lambda: cuda_ww_train.ww_train_epochs(
                ww, lanes[ww], 1)),
            ("K2 epochs=50", lambda: cuda_ww_train.ww_train_epochs(
                ww, lanes[ww], 50)),
            ("K4 epochs=1", lambda: cuda_kvec_train.kvec_train_epochs(
                agg, lanes[agg], 1)),
            ("K5 epochs=1", lambda: cuda_rnn_train.rnn_train_epochs(
                rnn, lanes[rnn], 1))):
        log(f"{what} at N={N}: device {device_ms(fn, 20):.4f} ms a launch")


def engines_vs_cpu(torch):
    """Every engine on a 512-trial population of each standard variant on
    the card against the same call on the CPU: integer fields exact, floats
    bitwise with the same non-finite pattern (the weightwise full batch's
    too: its step is the hand-derived elementwise chain)."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch.fixtures import identity_fixpoint_flat, vary
    from srnn_tpu_torch.train import sample_order

    n = 512
    cpu = torch.Generator().manual_seed(5)
    for topo in (st.Topology("weightwise", width=2, depth=2),
                 st.Topology("aggregating", width=2, depth=2, aggregates=4),
                 st.Topology("recurrent", width=2, depth=2)):
        pop = st.init_population(topo, cpu, n, "cpu")
        pop[0] = 0.0
        pop[1, 3] = float("inf")
        if topo.variant == "weightwise":
            varied = vary(cpu, identity_fixpoint_flat(topo, "cpu")
                          .expand(n, -1), 1e-3)
        else:
            varied = pop * 0.05
        calls = {
            "run_fixpoint": lambda p: st.run_fixpoint(topo, p, 40,
                                                      record=True),
            "run_training": lambda p: st.run_training(topo, p, 20),
            "run_mixed_fixpoint": lambda p: st.run_mixed_fixpoint(topo, p,
                                                                  10, 4),
            "run_known_fixpoint_variation":
                lambda p: st.run_known_fixpoint_variation(topo, p, 40),
            "fixpoint_density": lambda p: st.fixpoint_density(topo, p),
        }
        if topo.variant == "weightwise":
            calls["run_training full_batch"] = lambda p: st.run_training(
                topo, p, 10, train_mode="full_batch")
            # keras' shuffled epoch: K2's shuffled instantiation on the
            # card, its plain twin on the CPU, the same orders
            order = sample_order(cpu, 20, topo.num_weights, n, "cpu")
            calls["run_training shuffled"] = lambda p: st.run_training(
                topo, p, 20, order=order)
        for name, fn in calls.items():
            p = varied if name == "run_known_fixpoint_variation" else pop
            got, ref = fn(p.to(CARD)), fn(p)
            tag = f"{topo.variant} {name} card vs cpu"
            if name == "fixpoint_density":
                equal_ints(torch, f"{tag} counts", got, ref)
                continue
            for field, g, r in zip(ref._fields, got, ref):
                if r is None:
                    continue
                if r.dtype == torch.int32:
                    equal_ints(torch, f"{tag} {field}", g, r)
                else:
                    compare(torch, f"{tag} {field}", g.cpu(), r, 0)


def soup_science(name, run_dir) -> str:
    """To inform, not a gate: a soup setup's result beside the CPU
    reference's (BASELINE.md; the streams differ from the reference's)."""
    from srnn_tpu_torch.experiment import counters_dict, load_artifact

    if name == "soup_trajectorys":
        counts = counters_dict(load_artifact(os.path.join(run_dir,
                                                          "all_counters")))
        return (f"final classes {counts} (BASELINE.md:29: 13 fix_other / "
                "7 other)")
    data = load_artifact(os.path.join(run_dir, "all_data"))[0]
    zs = dict(zip(data["xs"], data["zs"]))
    what = {"mixed_soup": ("WW zs at train", "BASELINE.md:25"),
            "learn_from_soup": ("zs at severity", "BASELINE.md:27")}[name]
    ref = {"mixed_soup": "0.0 -> 8.8", "learn_from_soup": "0.0 -> 9.9"}
    return (f"{what[0]} 0 and 100: {zs.get(0)} -> {zs.get(100)} ({what[1]}: "
            f"{ref[name]})")


def setup_runs(torch, kernels, totals):
    """The nine setups at their default sizes, each through
    ``python -m srnn_tpu_torch.setups`` in a subprocess on the card (all nine
    at once), their artifacts loaded and their launch counts (written by
    the CLI to SRNN_LAUNCH_COUNTS) checked and added to ``totals``; the
    soup setups' science printed beside the reference's."""
    import shutil
    import tempfile

    from srnn_tpu_torch.experiment import load_artifact

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="srnn_setups_")
    env = {k: v for k, v in os.environ.items()
           if k != "SRNN_SETUPS_PLATFORM"}
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in SETUP_LAUNCHES:
            counts = os.path.join(root, f"{name}.launches.json")
            # output to files, not pipes: a full pipe would block the setup
            with open(os.path.join(root, f"{name}.out"), "w") as out, \
                    open(os.path.join(root, f"{name}.err"), "w") as err:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "srnn_tpu_torch.setups", name,
                     "--root", os.path.join(root, name)], cwd=here,
                    env={**env, "SRNN_LAUNCH_COUNTS": counts},
                    stdout=out, stderr=err)
        walls = {}
        while len(walls) < len(procs):
            for name, proc in procs.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 600:
                raise AssertionError("setups: not done after 600 s")
            time.sleep(0.05)
        for name, proc in procs.items():
            with open(os.path.join(root, f"{name}.out")) as f:
                out = f.read()
            with open(os.path.join(root, f"{name}.err")) as f:
                err = f.read()
            if proc.returncode != 0:
                raise AssertionError(f"setup {name}: rc {proc.returncode}\n"
                                     f"{err[-4000:]}")
            run_dir = out.strip().splitlines()[-1]
            loaded = []
            for fname in sorted(os.listdir(run_dir)):
                stem, ext = os.path.splitext(fname)
                if ext in (".npz", ".json"):
                    load_artifact(os.path.join(run_dir, stem))
                    loaded.append(fname)
            if not os.path.exists(os.path.join(run_dir, "log.txt")):
                raise AssertionError(f"setup {name}: no log.txt")
            with open(os.path.join(root, f"{name}.launches.json")) as f:
                got = json.load(f)
            with open(os.path.join(run_dir, "meta.json")) as f:
                run_wall = json.load(f)["wall_seconds"]
            log(f"setup {name}: {walls[name]:.1f} s wall of the process, "
                f"{run_wall:.2f} s of the run (meta.json; "
                f"{len(procs)} at once), artifacts {loaded}")
            if name in ("soup_trajectorys", "learn_from_soup",
                        "mixed_soup"):
                log(f"  {name} science: {soup_science(name, run_dir)}")
            for k, c in check_launches(kernels, f"setup {name}",
                                       SETUP_LAUNCHES[name], got).items():
                totals[k] += c
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)


def engines_and_setups(torch, kernels, totals):
    """Phase 5, the fixpoint engines: at N = 1M, the six setups' CLIs, and
    small populations on the card against the CPU."""
    engine_runs(torch, kernels, totals)
    setup_runs(torch, kernels, totals)
    engines_vs_cpu(torch)


def small_soup_vs_cpu(torch, kernels):
    """Phase 6: each variant's soup on the card against the same soup on
    the CPU, fed the same draws, at width 2 / depth 2 and at the wide
    topologies (PR 11); then the mixed soup and the bfloat16 and int8 soups
    the same way."""
    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch.convert import soup_state_from_arrays
    from srnn_tpu_torch.init import init_population

    n = 2048
    cpu = torch.Generator().manual_seed(0)
    for topo in (st.Topology("weightwise", width=2, depth=2),
                 st.Topology("aggregating", width=2, depth=2, aggregates=4),
                 st.Topology("fft", width=2, depth=2, aggregates=4),
                 st.Topology("recurrent", width=2, depth=2),
                 *wide_topos().values()):
        base = st.SoupConfig(topo=topo, size=n, attacking_rate=0.3,
                             learn_from_rate=0.3, learn_from_severity=1,
                             train=2, remove_divergent=True, remove_zero=True,
                             layout="popmajor")
        rng = np.random.default_rng(0)
        w0 = init_population(topo, cpu, n, "cpu").numpy()
        draws = [st.SoupDraws(rng.random(n) < 0.3, rng.integers(0, n, n),
                              rng.random(n) < 0.3, rng.integers(0, n, n),
                              init_population(topo, cpu, n, "cpu").t()
                              .numpy()) for _ in range(3)]
        for cfg in (base._replace(generation_impl="fused"), base):
            states = {d: soup_state_from_arrays(w0, np.arange(n), n, 0,
                                                device=d)
                      for d in ("cuda", "cpu")}
            for g, dr in enumerate(draws):
                ev = {}
                for d in states:
                    states[d], ev[d] = st.evolve_step(cfg, states[d], dr)
                tag = (f"{topo.variant} width {topo.width} depth "
                       f"{topo.depth} k={topo.aggregates} "
                       f"{cfg.generation_impl} gen {g}")
                for f in ("uids", "next_uid"):
                    equal_ints(torch, f"{tag} {f}",
                               getattr(states["cuda"], f),
                               getattr(states["cpu"], f))
                equal_ints(torch, f"{tag} actions", ev["cuda"].action,
                           ev["cpu"].action)
                compare(torch, f"{tag} weights",
                        states["cuda"].weights.cpu(), states["cpu"].weights)
    small_multisoup_vs_cpu(torch, cpu)
    small_precision_vs_cpu(torch, cpu)
    small_rowmajor_vs_cpu(torch, cpu)
    rowmajor_checkpoint(torch)
    small_rowmajor_multisoup_vs_cpu(torch, cpu)
    multisoup_checkpoint(torch)
    small_sequential_vs_cpu(torch, cpu, kernels)
    popmajor_full_batch_vs_cpu(torch, cpu)
    small_routes_vs_cpu(torch, cpu)
    shuffler_vs_cpu(torch, cpu)


def small_multisoup_vs_cpu(torch, cpu):
    """The mixed soup (weightwise, aggregating and recurrent types) on the
    card against the same soup on the CPU, fed the same draws, on both
    routes."""
    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch import multisoup as ms
    from srnn_tpu_torch.convert import multisoup_state_from_arrays
    from srnn_tpu_torch.init import init_population

    topos = (st.Topology("weightwise", width=2, depth=2),
             st.Topology("aggregating", width=2, depth=2, aggregates=4),
             st.Topology("recurrent", width=2, depth=2))
    sizes = (700, 683, 665)
    n = sum(sizes)
    base = ms.MultiSoupConfig(topos=topos, sizes=sizes, attacking_rate=0.3,
                              learn_from_rate=0.3, learn_from_severity=1,
                              train=2, remove_divergent=True,
                              remove_zero=True, layout="popmajor")
    rng = np.random.default_rng(1)
    w0 = [init_population(t, cpu, k, "cpu").numpy()
          for t, k in zip(topos, sizes)]
    u0 = np.split(np.arange(n), np.cumsum(sizes)[:-1])
    draws = [ms.MultiSoupDraws(
        rng.random(n) < 0.3, rng.integers(0, n, n), rng.random(n) < 0.3,
        tuple(rng.integers(0, k, k) for k in sizes),
        tuple(init_population(t, cpu, k, "cpu").t().numpy()
              for t, k in zip(topos, sizes))) for _ in range(3)]
    for impl in ("fused", "phases"):
        cfg = base._replace(generation_impl=impl)
        states = {d: multisoup_state_from_arrays(w0, u0, n, 0, device=d)
                  for d in ("cuda", "cpu")}
        for g, dr in enumerate(draws):
            ev = {}
            for d in states:
                states[d], ev[d] = ms.evolve_multi_step(cfg, states[d], dr)
            equal_ints(torch, f"mixed {impl} gen {g} next_uid",
                       states["cuda"].next_uid, states["cpu"].next_uid)
            for t, topo in enumerate(topos):
                tag = f"mixed {impl} gen {g} {topo.variant}"
                equal_ints(torch, f"{tag} uids", states["cuda"].uids[t],
                           states["cpu"].uids[t])
                equal_ints(torch, f"{tag} actions", ev["cuda"].action[t],
                           ev["cpu"].action[t])
                compare(torch, f"{tag} weights",
                        states["cuda"].weights[t].cpu(),
                        states["cpu"].weights[t])


def small_precision_vs_cpu(torch, cpu):
    """bfloat16 soups of the three K3 bodies' variants and an int8
    weightwise soup on the card against the same soups on the CPU, fed the
    same draws, on both routes."""
    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch.init import init_population

    n = 2048
    for topo, dtype in ((st.Topology("weightwise", width=2, depth=2),
                         "bf16"),
                        (st.Topology("aggregating", width=2, depth=2,
                                     aggregates=4), "bf16"),
                        (st.Topology("recurrent", width=2, depth=2), "bf16"),
                        (st.Topology("weightwise", width=2, depth=2),
                         "int8")):
        base = st.SoupConfig(topo=topo, size=n, attacking_rate=0.3,
                             learn_from_rate=0.3, learn_from_severity=1,
                             train=2, remove_divergent=True, remove_zero=True,
                             layout="popmajor", population_dtype=dtype)
        rng = np.random.default_rng(2)
        s0 = st.seed(base, 0, device="cpu")
        draws = [st.SoupDraws(rng.random(n) < 0.3, rng.integers(0, n, n),
                              rng.random(n) < 0.3, rng.integers(0, n, n),
                              init_population(topo, cpu, n, "cpu").t()
                              .numpy()) for _ in range(3)]
        for cfg in (base._replace(generation_impl="fused"), base):
            states = {d: st.SoupState(
                s0.weights.to(d), s0.uids.to(d), s0.next_uid.to(d),
                s0.time.to(d), torch.Generator(device=d),
                None if s0.scales is None else s0.scales.to(d))
                for d in ("cuda", "cpu")}
            for g, dr in enumerate(draws):
                ev = {}
                for d in states:
                    states[d], ev[d] = st.evolve_step(cfg, states[d], dr)
                tag = (f"{topo.variant} {dtype} {cfg.generation_impl} "
                       f"gen {g}")
                for f in ("uids", "next_uid"):
                    equal_ints(torch, f"{tag} {f}",
                               getattr(states["cuda"], f),
                               getattr(states["cpu"], f))
                equal_ints(torch, f"{tag} actions", ev["cuda"].action,
                           ev["cpu"].action)
                if dtype == "int8":
                    equal_ints(torch, f"{tag} int8 codes",
                               states["cuda"].weights, states["cpu"].weights)
                    compare(torch, f"{tag} scales",
                            states["cuda"].scales.cpu(), states["cpu"].scales)
                else:
                    compare(torch, f"{tag} bf16 weights",
                            states["cuda"].weights.cpu(),
                            states["cpu"].weights)


#: the small row-major soups held card against CPU: (variant, population
#: dtype, train mode, ulps allowed).  None holds rtol/atol, where the two
#: devices' libraries differ: cuFFT against pocketfft in the fft attack.
#: The weightwise full batch runs its hand-derived step in elementwise
#: chains (``ops/popmajor.ww_full_batch_epochs``), bitwise on either device
ROWMAJOR_VS_CPU = (
    ("weightwise", "f32", "sequential", 0),
    ("aggregating", "f32", "sequential", 0),
    ("fft", "f32", "sequential", None),
    ("recurrent", "f32", "sequential", 0),
    ("weightwise", "f32", "full_batch", 0),
    ("weightwise", "bf16", "sequential", 0),
    ("weightwise", "int8", "sequential", 0),
)


def _state_on(torch, st, s0, dev):
    """A copy of ``s0`` on ``dev`` with a generator there (the draws are
    handed over)."""
    return st.SoupState(s0.weights.to(dev), s0.uids.to(dev),
                        s0.next_uid.to(dev), s0.time.to(dev),
                        torch.Generator(device=dev),
                        None if s0.scales is None else s0.scales.to(dev))


def small_rowmajor_vs_cpu(torch, cpu):
    """The row-major soup (the default layout) of each variant, of the
    weightwise full batch, and bfloat16 and int8 weightwise soups, on the
    card against the same soup on the CPU, fed the same draws, over 3
    generations; then the weightwise (both train modes) and aggregating
    row-major soups against the population-major phase chain on the card,
    from the same state and draws.  To inform: the row-major weightwise
    forward as a matmul (cuBLAS) against the explicit chains the
    self-application runs."""
    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch.bench_kernels import max_ulps
    from srnn_tpu_torch.init import init_population
    from srnn_tpu_torch.nets.weightwise import points
    from srnn_tpu_torch.ops.mlp import mlp_apply, mlp_forward

    n = 2048
    for variant, dtype, mode, ulps in ROWMAJOR_VS_CPU:
        topo = st.Topology(variant, width=2, depth=2, aggregates=4)
        cfg = st.SoupConfig(topo=topo, size=n, attacking_rate=0.3,
                            learn_from_rate=0.3, learn_from_severity=1,
                            train=2, remove_divergent=True, remove_zero=True,
                            train_mode=mode, population_dtype=dtype)
        rng = np.random.default_rng(3)
        s0 = st.seed(cfg, cpu, device="cpu")
        draws = [st.SoupDraws(rng.random(n) < 0.3, rng.integers(0, n, n),
                              rng.random(n) < 0.3, rng.integers(0, n, n),
                              init_population(topo, cpu, n, "cpu").t()
                              .numpy()) for _ in range(3)]
        runs = [("card vs cpu", cfg, cfg, ("cuda", "cpu"), ulps)]
        if variant in ("weightwise", "aggregating") and dtype == "f32":
            runs.append(("vs popmajor phases on the card", cfg,
                         cfg._replace(layout="popmajor"), ("cuda", "cuda"),
                         0))
        for what, cfg_a, cfg_b, (dev_a, dev_b), held in runs:
            a, b = _state_on(torch, st, s0, dev_a), \
                _state_on(torch, st, s0, dev_b)
            for g, dr in enumerate(draws):
                a, ev_a = st.evolve_step(cfg_a, a, dr)
                b, ev_b = st.evolve_step(cfg_b, b, dr)
                tag = f"rowmajor {variant} {dtype} {mode} {what} gen {g}"
                for f in ("uids", "next_uid"):
                    equal_ints(torch, f"{tag} {f}", getattr(a, f),
                               getattr(b, f))
                equal_ints(torch, f"{tag} actions", ev_a.action, ev_b.action)
                if dtype == "int8":
                    equal_ints(torch, f"{tag} int8 codes", a.weights,
                               b.weights)
                    compare(torch, f"{tag} scales", a.scales.cpu(),
                            b.scales.cpu(), held)
                else:
                    compare(torch, f"{tag} weights", a.weights.cpu(),
                            b.weights.cpu(), held)
                compare(torch, f"{tag} loss", ev_a.loss.cpu(),
                        ev_b.loss.cpu(), held)
    topo = st.Topology("weightwise", width=2, depth=2)
    w = init_population(topo, cpu, n, "cpu").cuda()
    x = points(topo, w)
    got, chain = mlp_forward(topo, w, x), mlp_apply(topo, w, x)
    log(f"  to inform: row-major weightwise forward on the card, matmul "
        f"against mlp_apply's chains: bitwise {bool(torch.equal(got, chain))}"
        f", max ulps {max_ulps(got, chain)}, max abs "
        f"{float((got - chain).abs().max()):.3e}")


def rowmajor_checkpoint(torch):
    """A checkpoint round trip on the card: 3 generations, save, restore,
    2 more, against 5 in one go, bitwise, the generator included; float32
    and int8 row-major weightwise soups."""
    import shutil
    import tempfile

    import srnn_tpu_torch as st
    from srnn_tpu_torch.experiment import restore_checkpoint, save_checkpoint

    root = tempfile.mkdtemp(prefix="srnn_ckpt_")
    try:
        for dtype in ("f32", "int8"):
            cfg = st.SoupConfig(
                topo=st.Topology("weightwise", width=2, depth=2), size=2048,
                attacking_rate=0.3, learn_from_rate=0.3, train=2,
                remove_divergent=True, remove_zero=True,
                population_dtype=dtype)
            s0 = st.seed(cfg, 5, device="cuda")
            path = save_checkpoint(os.path.join(root, dtype),
                                   st.evolve(cfg, s0, 3))
            back = restore_checkpoint(path)
            if back.weights.device.type != "cuda" or \
                    back.key.device.type != "cuda":
                raise AssertionError("checkpoint: restored off the card")
            got, ref = st.evolve(cfg, back, 2), st.evolve(cfg, s0, 5)
            tag = f"checkpoint {dtype} 3 + 2 generations vs 5"
            for f in ("weights", "uids", "next_uid", "time") + (
                    ("scales",) if dtype == "int8" else ()):
                g, r = getattr(got, f), getattr(ref, f)
                if g.is_floating_point():
                    compare(torch, f"{tag} {f}", g.cpu(), r.cpu(), 0)
                else:
                    equal_ints(torch, f"{tag} {f}", g, r)
            equal_ints(torch, f"{tag} generator state", got.key.get_state(),
                       ref.key.get_state())
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: the small row-major mixed soups held card against CPU: (name, variants,
#: population dtype, ulps allowed).  The fft type's attack goes through
#: cuFFT against pocketfft, and its attacks reach every type: that mix is
#: held to rtol/atol (None), each generation from the CPU's state before
#: it, since its linear recurrent particles (|w| up to 1e4) amplify the
#: transforms' last-bit differences past rtol 1e-5 within three chained
#: generations (PERF.md); the others bitwise, chained
MULTI_ROWMAJOR_VS_CPU = (
    ("four", ("weightwise", "aggregating", "fft", "recurrent"), "f32", None),
    ("three", ("weightwise", "aggregating", "recurrent"), "f32", 0),
    ("three", ("weightwise", "aggregating", "recurrent"), "bf16", 0),
    ("three", ("weightwise", "aggregating", "recurrent"), "int8", 0),
)


def _multi_draws(np, cpu, topos, sizes, rng, generations=3):
    """Mixed-soup draws from numpy and a CPU generator, handed to both
    devices."""
    from srnn_tpu_torch import multisoup as ms
    from srnn_tpu_torch.init import init_population

    n = sum(sizes)
    return [ms.MultiSoupDraws(
        rng.random(n) < 0.3, rng.integers(0, n, n), rng.random(n) < 0.3,
        tuple(rng.integers(0, k, k) for k in sizes),
        tuple(init_population(t, cpu, k, "cpu").t().numpy()
              for t, k in zip(topos, sizes))) for _ in range(generations)]


def _multi_on(torch, ms, s0, dev):
    """A copy of the mixed state ``s0`` on ``dev`` with a generator there
    (the draws are handed over)."""
    return ms.MultiSoupState(
        tuple(w.to(dev) for w in s0.weights),
        tuple(u.to(dev) for u in s0.uids), s0.next_uid.to(dev),
        s0.time.to(dev), torch.Generator(device=dev),
        None if s0.scales is None else tuple(x.to(dev) for x in s0.scales))


def _compare_multi(torch, tag, a, ev_a, b, ev_b, dtype, ulps):
    equal_ints(torch, f"{tag} next_uid", a.next_uid, b.next_uid)
    for t in range(len(a.weights)):
        tt = f"{tag} type {t}"
        equal_ints(torch, f"{tt} uids", a.uids[t], b.uids[t])
        equal_ints(torch, f"{tt} actions", ev_a.action[t], ev_b.action[t])
        equal_ints(torch, f"{tt} counterparts", ev_a.counterpart[t],
                   ev_b.counterpart[t])
        if dtype == "int8":
            equal_ints(torch, f"{tt} int8 codes", a.weights[t], b.weights[t])
            compare(torch, f"{tt} scales", a.scales[t].cpu(),
                    b.scales[t].cpu(), ulps)
        else:
            compare(torch, f"{tt} weights", a.weights[t].cpu(),
                    b.weights[t].cpu(), ulps)
        compare(torch, f"{tt} loss", ev_a.loss[t].cpu(), ev_b.loss[t].cpu(),
                ulps)


def small_rowmajor_multisoup_vs_cpu(torch, cpu):
    """The row-major mixed soup (the default layout) on the card against
    the same soup on the CPU, fed the same draws, over 3 generations: four
    types with fft (each generation from the CPU's state), and three-type
    mixes in float32, bfloat16 and int8 (chained); then a mix of
    weightwise and aggregating types row-major against the
    population-major phase chain on the card, bitwise."""
    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch import multisoup as ms

    rng = np.random.default_rng(4)
    runs = [(f"{name} {dtype} card vs cpu", variants, dtype, "cpu", ulps)
            for name, variants, dtype, ulps in MULTI_ROWMAJOR_VS_CPU]
    runs.append(("weightwise+aggregating f32 rowmajor vs popmajor phases "
                 "on the card", ("weightwise", "aggregating"), "f32", "cuda",
                 0))
    for what, variants, dtype, dev_b, ulps in runs:
        topos = tuple(st.Topology(v, width=2, depth=2, aggregates=4)
                      for v in variants)
        sizes = tuple(700 - 17 * t for t in range(len(topos)))
        cfg = ms.MultiSoupConfig(
            topos=topos, sizes=sizes, attacking_rate=0.3,
            learn_from_rate=0.3, learn_from_severity=1, train=2,
            remove_divergent=True, remove_zero=True, population_dtype=dtype)
        cfg_b = cfg if dev_b == "cpu" else cfg._replace(layout="popmajor")
        s0 = ms.seed_multi(cfg, 6, device="cpu")
        a, b = _multi_on(torch, ms, s0, "cuda"), _multi_on(torch, ms, s0,
                                                           dev_b)
        for g, dr in enumerate(_multi_draws(np, cpu, topos, sizes, rng)):
            a, ev_a = ms.evolve_multi_step(cfg, a, dr)
            b, ev_b = ms.evolve_multi_step(cfg_b, b, dr)
            _compare_multi(torch, f"mixed rowmajor {what} gen {g}", a, ev_a,
                           b, ev_b, dtype, ulps)
            if ulps is None:
                a = _multi_on(torch, ms, b, "cuda")


def multisoup_checkpoint(torch):
    """A mixed-soup checkpoint round trip on the card: 3 generations,
    save, restore, 2 more, against 5 in one go, bitwise, the generator
    included; float32 and int8 row-major mixes."""
    import shutil
    import tempfile

    import srnn_tpu_torch as st
    from srnn_tpu_torch import multisoup as ms
    from srnn_tpu_torch.experiment import (restore_multi_checkpoint,
                                           save_multi_checkpoint)

    root = tempfile.mkdtemp(prefix="srnn_mckpt_")
    try:
        for dtype in ("f32", "int8"):
            cfg = ms.MultiSoupConfig(
                topos=(st.Topology("weightwise", width=2, depth=2),
                       st.Topology("aggregating", width=2, depth=2,
                                   aggregates=4),
                       st.Topology("recurrent", width=2, depth=2)),
                sizes=(700, 683, 665), attacking_rate=0.3,
                learn_from_rate=0.3, train=2, remove_divergent=True,
                remove_zero=True, population_dtype=dtype)
            s0 = ms.seed_multi(cfg, 5, device="cuda")
            path = save_multi_checkpoint(os.path.join(root, dtype),
                                         ms.evolve_multi(cfg, s0, 3))
            back = restore_multi_checkpoint(path)
            if back.weights[0].device.type != "cuda" or \
                    back.key.device.type != "cuda":
                raise AssertionError("mixed checkpoint: restored off the "
                                     "card")
            got, ref = ms.evolve_multi(cfg, back, 2), \
                ms.evolve_multi(cfg, s0, 5)
            tag = f"mixed checkpoint {dtype} 3 + 2 generations vs 5"
            for t in range(3):
                for f in ("weights", "uids") + (
                        ("scales",) if dtype == "int8" else ()):
                    g, r = getattr(got, f)[t], getattr(ref, f)[t]
                    if g.is_floating_point():
                        compare(torch, f"{tag} type {t} {f}", g.cpu(),
                                r.cpu(), 0)
                    else:
                        equal_ints(torch, f"{tag} type {t} {f}", g, r)
            for f in ("next_uid", "time"):
                equal_ints(torch, f"{tag} {f}", getattr(got, f),
                           getattr(ref, f))
            equal_ints(torch, f"{tag} generator state", got.key.get_state(),
                       ref.key.get_state())
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: the small sequential soups held card against CPU, bitwise: (variant,
#: train mode, the SGD kernel a learner and a trainer launch, or None)
SEQUENTIAL_VS_CPU = (
    ("weightwise", "sequential", "ww_sgd"),
    ("aggregating", "sequential", "kvec_sgd"),
    ("recurrent", "sequential", "rnn_sgd"),
    ("weightwise", "full_batch", None),
)


def small_sequential_vs_cpu(torch, cpu, kernels):
    """The sequential soup (``mode='sequential'``) of each standard variant
    and of the weightwise full batch, 20 particles, 3 generations, on the
    card against the same soup on the CPU, fed the same draws, bitwise;
    each generation's launches on the card exact: one of the variant's SGD
    kernel per learner and one per particle (its one-lane learn and train
    calls), none for the full batch."""
    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch.init import init_population

    n = 20
    rng = np.random.default_rng(5)
    for variant, mode, kernel in SEQUENTIAL_VS_CPU:
        topo = st.Topology(variant, width=2, depth=2, aggregates=4)
        cfg = st.SoupConfig(topo=topo, size=n, attacking_rate=0.3,
                            learn_from_rate=0.3, learn_from_severity=1,
                            train=2, remove_divergent=True, remove_zero=True,
                            mode="sequential", train_mode=mode)
        s0 = st.seed(cfg, cpu, device="cpu")
        a, b = _state_on(torch, st, s0, "cuda"), _state_on(torch, st, s0,
                                                           "cpu")
        for g in range(3):
            dr = st.SoupDraws(rng.random(n) < 0.3, rng.integers(0, n, n),
                              rng.random(n) < 0.3, rng.integers(0, n, n),
                              init_population(topo, cpu, n, "cpu").t()
                              .numpy())
            reset(kernels)
            a, ev_a = st.evolve_step(cfg, a, dr)
            tag = f"sequential {variant} {mode} card vs cpu gen {g}"
            want = {} if kernel is None else {
                kernel: int(dr.learn_gate.sum()) + n}
            check_launches(kernels, tag, want)
            b, ev_b = st.evolve_step(cfg, b, dr)
            for f in ("uids", "next_uid"):
                equal_ints(torch, f"{tag} {f}", getattr(a, f), getattr(b, f))
            equal_ints(torch, f"{tag} actions", ev_a.action, ev_b.action)
            equal_ints(torch, f"{tag} counterparts", ev_a.counterpart,
                       ev_b.counterpart)
            compare(torch, f"{tag} weights", a.weights.cpu(), b.weights, 0)
            compare(torch, f"{tag} loss", ev_a.loss.cpu(), ev_b.loss, 0)


def popmajor_full_batch_vs_cpu(torch, cpu):
    """The population-major weightwise full batch (its plain step) on the
    card against the CPU, fed the same draws, bitwise; its step's time at
    N = 1M, 10 epochs, beside K2's sequential chain on the same
    population (to inform)."""
    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch.init import init_population
    from srnn_tpu_torch.ops.cuda_ww_train import ww_train_epochs
    from srnn_tpu_torch.ops.popmajor import ww_full_batch_epochs

    n = 2048
    topo = st.Topology("weightwise", width=2, depth=2)
    cfg = st.SoupConfig(topo=topo, size=n, attacking_rate=0.3,
                        learn_from_rate=0.3, learn_from_severity=1, train=2,
                        remove_divergent=True, remove_zero=True,
                        train_mode="full_batch", layout="popmajor")
    rng = np.random.default_rng(6)
    s0 = st.seed(cfg, cpu, device="cpu")
    a, b = _state_on(torch, st, s0, "cuda"), _state_on(torch, st, s0, "cpu")
    for g in range(3):
        dr = st.SoupDraws(rng.random(n) < 0.3, rng.integers(0, n, n),
                          rng.random(n) < 0.3, rng.integers(0, n, n),
                          init_population(topo, cpu, n, "cpu").t().numpy())
        a, ev_a = st.evolve_step(cfg, a, dr)
        b, ev_b = st.evolve_step(cfg, b, dr)
        tag = f"popmajor weightwise full_batch card vs cpu gen {g}"
        for f in ("uids", "next_uid"):
            equal_ints(torch, f"{tag} {f}", getattr(a, f), getattr(b, f))
        equal_ints(torch, f"{tag} actions", ev_a.action, ev_b.action)
        compare(torch, f"{tag} weights", a.weights.cpu(), b.weights, 0)
        compare(torch, f"{tag} loss", ev_a.loss.cpu(), ev_b.loss, 0)
    wT = population(topo, N, torch.Generator(device="cuda").manual_seed(7))
    fb = timed_ms(torch, lambda: ww_full_batch_epochs(topo, wT, 10), 3)
    k2 = timed_ms(torch, lambda: ww_train_epochs(topo, wT, 10), 10)
    log(f"  to inform: weightwise full-batch step at N={N}, 10 epochs: "
        f"{fb:.3f} ms a call (plain torch, "
        f"{10 * topo.num_weights} forward/backward chains); K2's sequential"
        f" chain on the same population {k2:.3f} ms")


#: (topology, layout) of the small autograd-route soups card vs CPU
ROUTE_SOUPS = (
    (dict(variant="weightwise", activation="elu"), "popmajor"),
    (dict(variant="weightwise", activation="elu"), "rowmajor"),
    (dict(variant="weightwise", activation="swish"), "rowmajor"),
    (dict(variant="weightwise", activation="gelu"), "popmajor"),
    (dict(variant="weightwise", activation="softmax"), "rowmajor"),
    (dict(variant="aggregating", activation="elu"), "popmajor"),
    (dict(variant="recurrent", rnn_scan="associative"), "rowmajor"),
)


def small_routes_vs_cpu(torch, cpu):
    """Small soups off the kernels on the card against the same soup on
    the CPU, fed the same draws, each generation from the CPU's state: the
    autograd route (elu, swish, gelu and softmax weightwise; an elu
    aggregating particle) and the row-major associative
    recurrent soup.  Integers exact; weights and losses within rtol 1e-5 /
    atol 1e-6 with the non-finite pattern exact, whether bitwise logged
    (the activations take their exp / expm1 / tanh in float64, rounded
    once, so that the card and the CPU round alike; autograd's reductions,
    as the associative scan's over the broadcast recurrent kernel, may sum
    in another order on the card)."""
    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch.init import init_population

    n = 2048
    rng = np.random.default_rng(8)
    for fields, layout in ROUTE_SOUPS:
        topo = st.Topology(**fields)
        cfg = st.SoupConfig(topo=topo, size=n, attacking_rate=0.3,
                            learn_from_rate=0.3, learn_from_severity=1,
                            train=2, remove_divergent=True, remove_zero=True,
                            layout=layout)
        b = st.seed(cfg, cpu, device="cpu")
        for g in range(3):
            dr = st.SoupDraws(rng.random(n) < 0.3, rng.integers(0, n, n),
                              rng.random(n) < 0.3, rng.integers(0, n, n),
                              init_population(topo, cpu, n, "cpu").t()
                              .numpy())
            a, ev_a = st.evolve_step(cfg, _state_on(torch, st, b, "cuda"),
                                     dr)
            b, ev_b = st.evolve_step(cfg, b, dr)
            tag = (f"{topo.variant} {topo.activation} {topo.rnn_scan} "
                   f"k={topo.aggregates} {layout} card vs cpu gen {g}")
            for f in ("uids", "next_uid"):
                equal_ints(torch, f"{tag} {f}", getattr(a, f), getattr(b, f))
            equal_ints(torch, f"{tag} actions", ev_a.action, ev_b.action)
            compare(torch, f"{tag} weights", a.weights.cpu(), b.weights)
            compare(torch, f"{tag} loss", ev_a.loss.cpu(), ev_b.loss)


def shuffler_vs_cpu(torch, cpu):
    """shuffler='random' transforms on the card against the CPU with the
    same permutations: the aggregating apply and an aggregating attack on
    weightwise victims bitwise (one-hot chains and a gather), the fft
    apply within rtol 1e-5 / atol 1e-6 (cuFFT and the CPU's FFT sum
    apart)."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch.nets import apply_to_weights
    from srnn_tpu_torch.nets.aggregating import random_perm
    from srnn_tpu_torch.nets.cross import cross_apply

    n = 4096
    for att, vic, ulps in (
            (st.Topology("aggregating", shuffler="random"), None, 0),
            (st.Topology("aggregating", shuffler="random"),
             st.Topology("weightwise"), 0),
            (st.Topology("fft", shuffler="random"), None, None)):
        v = vic or att
        a = st.init_population(att, cpu, n, "cpu")
        x = st.init_population(v, cpu, n, "cpu")
        perm = random_perm(cpu, (n,), v.num_weights, "cpu")
        if vic is None:
            fn = lambda d: apply_to_weights(att, a.to(d), x.to(d),
                                            perm=perm.to(d))
        else:
            fn = lambda d: cross_apply(att, a.to(d), vic, x.to(d),
                                       perm=perm.to(d))
        compare(torch, f"shuffled {att.variant} on {v.variant} card vs cpu",
                fn("cuda").cpu(), fn("cpu"), ulps)


def sequential_trajectory(torch, kernels):
    """To inform: the sequential weightwise soup at soup_trajectorys' size
    (20 particles, attack 0.1, no learn_from, train 30, both removals, 100
    generations, its draws from a CPU generator as the setups make them)
    on the card: exactly one K2 launch per particle per generation, the
    wall per generation, and the final classes beside the reference's
    (BASELINE.md:29, 13 fix_other / 7 other)."""
    import srnn_tpu_torch as st

    gens, n = 100, 20
    cfg = st.SoupConfig(topo=st.Topology("weightwise", width=2, depth=2),
                        size=n, attacking_rate=0.1, learn_from_rate=-1.0,
                        train=30, remove_divergent=True, remove_zero=True,
                        mode="sequential")
    state = st.seed(cfg, torch.Generator().manual_seed(0), device="cuda")
    st.evolve(cfg, state, 1)  # warm-up generation
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    final = st.evolve(cfg, state, gens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_launches(kernels, "sequential soup_trajectorys soup",
                   {"ww_sgd": n * gens})
    counts = st.count(cfg, final)
    log(f"  to inform: sequential weightwise soup, {n} particles, train 30,"
        f" {gens} generations: {dt * 1e3 / gens:.3f} ms/generation, final "
        f"classes [divergent, fix_zero, fix_other, fix_sec, other] "
        f"{counts.tolist()} (BASELINE.md:29: 13 fix_other / 7 other)")


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

    from srnn_tpu_torch.ops.cuda_generation import (
        GENERATION, GENERATION_BF16, GENERATION_KVEC, GENERATION_KVEC_BF16,
        GENERATION_RNN, GENERATION_RNN_BF16)
    from srnn_tpu_torch.ops.cuda_kvec_train import KVEC_SGD
    from srnn_tpu_torch.ops.cuda_rnn_apply import (RNN_APPLY_BY_T,
                                                   rnn_apply_kernel)
    from srnn_tpu_torch.ops.cuda_rnn_train import RNN_SGD
    from srnn_tpu_torch.ops.cuda_ww import WW_APPLY
    from srnn_tpu_torch.ops.cuda_ww_train import WW_SGD, WW_SGD_SHUFFLED

    kernels = (WW_APPLY, WW_SGD, GENERATION, KVEC_SGD, RNN_SGD,
               RNN_APPLY_BY_T[17], GENERATION_KVEC, GENERATION_RNN,
               RNN_APPLY_BY_T[14], RNN_APPLY_BY_T[20], GENERATION_BF16,
               GENERATION_KVEC_BF16, GENERATION_RNN_BF16, WW_SGD_SHUFFLED,
               *(rnn_apply_kernel(t) for t in WIDE_T))
    # a row per kernel's default build, then per build off it (PR 11)
    row_kernels = [(k.name, k) for k in kernels[:14]]
    row_kernels += [(wide_row(k, topo, t_len), k)
                    for k, topo, t_len in wide_rows()]
    rows = {name: {"name": name, "route": "cuda",
                   "source": f"srnn_tpu_torch/csrc/{k.source}.cu",
                   "replaces": k.replaces, "library_ms": None}
            for name, k in row_kernels}

    def phase(what, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {what}: {time.perf_counter() - t0:.1f} s")
        return out

    phase("build", build_kernels)
    log(f"tolerance: floats rtol {RTOL} atol {ATOL} with the non-finite "
        "pattern exact; every kernel against its plain version bitwise "
        "where finite (weights, attack outputs, the mean loss: 0 ulps); "
        "integer outputs exact")
    from srnn_tpu_torch.bench_kernels import SmiSampler

    sampler = SmiSampler()
    try:
        phase("weightwise kernels", check_kernels, torch, rows)
        phase("variant kernels", check_variant_kernels, torch, rows)
        phase("kernels off the default builds", check_wide_kernels, torch,
              rows)
    finally:
        sampler.stop()
    for what, t0, t1 in CLOCK_WINDOWS:
        log(f"clocks during {what}: {sampler.at(t0, t1)}")
    launches = phase("main path", main_path, torch, kernels)
    phase("fixpoint engines and setups", engines_and_setups, torch, kernels,
          launches)
    phase("small soups vs cpu", small_soup_vs_cpu, torch, kernels)
    phase("sequential soup (to inform)", sequential_trajectory, torch,
          kernels)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    for name in rows:
        rows[name]["launches"] = launches.get(name, 0)
    idle = [name for name in rows if not rows[name]["launches"]]
    if idle:
        return fail(f"kernels of the main path never launched: {idle}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{key: row[key] for key in keys}
                                  for row in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
