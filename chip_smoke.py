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
   stack and spill report per build, ptxas' line for the rolled weightwise
   epoch's builds of K2 and K3 at width 3 / depth 3 (P = 33) and for each
   instantiation of the width-3 / depth-3 k-vector builds (P = 42) of K4
   (average, fft) and K3 (average), and the SASS digest of each kernel of
   the default builds of ww_train, generation, generation_bf16,
   kvec_train, generation_kvec and generation_kvec_bf16;
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
   build the same way: K1 (its row at steps 50; steps 1, a run_fixpoint
   step, timed beside it), K2, K3's float32 and bfloat16 weightwise bodies
   at width 3 / depth 3 (P = 33), K4 (at P = 42 also train 1 and learn 1
   timed, the shapes of a run_training epoch and of the learn phase) and
   K3's k-vector body of the
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
   / depth 2, P = 66, 3 generations); then attack_impl /
   learn_from_impl='compact' against 'full' on the population-major phase
   chain at N = 1M (the weightwise, aggregating and recurrent particles and
   the width-3 / depth-3 weightwise one, 20 generations each way): weights,
   uids and the last events bitwise equal, launches exact, the learn
   launches (and the recurrent attack's K6) over the block's 102,528 lanes
   and the train launches over N, ms a generation both ways, the host
   synchronisations of a generation by line (torch's sync debug mode; the
   compact one has exactly two more, one per compacted phase), the learn
   kernel's device ms over the block and over N; fused + compact against
   fused + full bitwise, one K3 launch a generation; then streaming
   capture: ``utils.evolve_captured`` of the N = 1M weightwise fused soup,
   20 generations, a 72 MB frame every 5, into a temporary directory,
   pipelined and blocking, every frame bitwise equal to
   ``evolve(record=True)``, the walls beside the uncaptured run's, the K3
   launches exact, whether the native writer loaded; and
   ``evolve_multi_captured`` of a mixed soup at N = 30,000 against its
   generations bitwise; then, after the mega runs, the analysis tier
   (``analysis_path``): ``utils.divergence_onset`` of the N = 1M weightwise
   fused soup, 20 generations (K3 once a generation, bitwise equal to a
   recount over ``evolve_step`` calls, ms a generation beside a bare
   ``evolve``), the hill climber at 65,536 shots x 100 rounds (no kernel,
   rounds/s), ``utils.timed`` / ``utils.trace`` of a fused generation, and
   the HTML view of a captured N = 1M store read at 2,048 columns; and
   small runs of ``divergence_onset``, ``optimize.hillclimb`` and
   ``proto.fit`` card against CPU, bitwise; then the experiment service
   (``serve_path``): ``python -m srnn_tpu_torch.serve`` processes on the
   card driven by ``ServiceClient`` with the paper's traffic (8 soup
   tickets of soup_trajectorys' config, 2 fixpoint_density sweeps), a
   wide stack of 8 weightwise, 4 aggregating and 4 recurrent row-major
   tickets at N = 16,384 and one population-major fused ticket at
   N = 1M, every result bitwise equal to a bare ``soup.evolve`` or sweep
   in this process and the service's launch counts exactly its
   dispatches' (the SGD kernel once a phase a generation whatever the
   stack's width, K3 once a generation), ``run_fixpoint_stacked`` of 4
   tenants (K1 once a step), the io-fault, poisoned-tenant, kill -9 and
   restart and two-worker drills bitwise, the setups as clients equal to
   their process-mode runs, and to inform tickets/s at max_stack 8
   against 1, ticket latency and the device's busy share;
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


#: operations of a weightwise epoch past which a build runs it rolled
#: (csrc/ww_common.cuh: Epoch::kUnrolledMax)
WW_UNROLLED_MAX = 2048


def ww_sgd_issued_per_epoch(topo) -> int:
    """FP32 instructions of one epoch of the redesigned batch-1 chain: the
    reference's count less the forward's and the layer-0 gradients' products
    with a coordinate of 1.0; the rolled epoch of the builds past
    ``WW_UNROLLED_MAX`` issues every product."""
    from srnn_tpu_torch.topology import normalized_weight_coords

    ops = sgd_ops_per_epoch(topo)
    if ops > WW_UNROLLED_MAX:
        return ops
    ones = int((normalized_weight_coords(topo) == 1.0).sum())
    return ops - 2 * topo.layer_shapes[0][1] * ones


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
    spilled bytes, shared memory per block (for K3's builds with
    per-thread columns, the recurrent BPTT's checkpointed ones and the
    weightwise body's rolled ones, also their dynamic shared memory and the
    resident warps per SM); for the default builds of the sources that
    bench_kernels compares (its groups) also the linear (k-vector: linear
    average) instantiations' resident warps per SM; then ptxas' line for
    the rolled weightwise builds that K2 and K3 run at width 3 / depth 3
    (P = 33) and for each instantiation of the width-3 / depth-3 k-vector
    builds (P = 42) of K4 (average and fft) and K3 (average), and the SASS
    digest of each kernel template of the default builds of ww_train,
    generation, generation_bf16, kvec_train, generation_kvec and
    generation_kvec_bf16 (bench_kernels' ``sass_digests_by_kernel``), so
    that a later change can show that they held."""
    import re

    from srnn_tpu_torch.bench_kernels import (GROUPS, census_fragment,
                                              dynamic_smem,
                                              linear_resources,
                                              resident_blocks,
                                              resources_by_entry,
                                              resources_by_kernel,
                                              sass_digests_by_kernel,
                                              sass_text)
    from srnn_tpu_torch.ops import _build
    from srnn_tpu_torch.ops.cuda_kvec_train import kvec_build
    from srnn_tpu_torch.ops.cuda_sgd_common import kernel_build

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
        dyn = dynamic_smem(_build.library_path(name, b))
        log(f"  {name} {b.tag or 'default'}: nvcc done after {done:.1f} s; "
            f"{len(regs)} kernels, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)}, stack frame up to "
            f"{max(stack, default=0)} bytes, spilled bytes {spills}, "
            f"shared memory up to {max(smem, default=0)} bytes a block"
            + (f" and {dyn} bytes of per-thread columns, "
               f"{resident_blocks(max(regs), max(smem, default=0) + dyn, 128) * 4} "
               f"resident warps an SM" if dyn else ""))
        if b == _build.DEFAULT and any(name in g for g in GROUPS.values()):
            res = linear_resources(_build.log_path(name),
                                   census_fragment(name))
            log(f"    linear instantiations: {res}")
    rolled = kernel_build(wide_topos()["ww"])
    for name, kernel in (("ww_train", "ww_sgd_kernel"),
                         ("generation", "generation_kernel"),
                         ("generation_bf16", "generation_kernel")):
        dyn = dynamic_smem(_build.library_path(name, rolled))
        res = resources_by_kernel(_build.log_path(name, rolled), "",
                                  dyn)[kernel]
        log(f"  ptxas {name}[{rolled.tag}] {kernel} (rolled epoch, P = 33):"
            f" {res['registers']} registers, {res['stack_bytes']} bytes "
            f"stack frame, {res['spill_bytes']} bytes spilled, "
            f"{res['smem_bytes']} + {dyn} bytes shared memory a block, "
            f"{res['warps_per_sm']} resident warps an SM")
    t = wide_topos()
    for name, key in (("kvec_train", "agg"), ("kvec_train", "fft"),
                      ("generation_kvec", "agg")):
        b = kvec_build(t[key])
        for entry, res in resources_by_entry(_build.log_path(name, b),
                                             "").items():
            log(f"  ptxas {name}[{b.tag}] {entry} (P = 42): "
                f"{res['registers']} registers, {res['stack_bytes']} bytes "
                f"stack frame, {res['spill_bytes']} bytes spilled, "
                f"{res['smem_bytes']} bytes shared memory a block, "
                f"{res['warps_per_sm']} resident warps an SM")
    for name in ("ww_train", "generation", "generation_bf16", "kvec_train",
                 "generation_kvec", "generation_kvec_bf16"):
        digests = sass_digests_by_kernel(sass_text(_build.library_path(name)))
        log(f"  SASS digests by kernel, {name} default build: {digests}")


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


def fence_rnn():
    """The recurrent fence: width 7 / depth 1 (P = 64), tanh, whose K5
    build runs the checkpointed BPTT with a non-linear activation."""
    from srnn_tpu_torch import Topology

    return Topology("recurrent", width=7, depth=1, activation="tanh")


#: the width-3 / depth-3 recurrent attacker's victim lengths: the mixed
#: chain's weightwise, k-vector and recurrent thirds
WIDE_T = (33, 42, 52)
#: particles of the fence's soups and checks
FENCE_N = 4096


def wide_jobs():
    """The (source, build) jobs of the wide topologies' builds (K3's
    bfloat16 body too for the weightwise and recurrent ones), of the
    width-3 / depth-3 tanh K2 and K3 weightwise body, and of the recurrent
    fence's K5."""
    import dataclasses

    from srnn_tpu_torch.ops.cuda_generation import builds_for
    from srnn_tpu_torch.ops.cuda_sgd_common import kernel_build

    t = wide_topos()
    jobs = []
    for name, topo in t.items():
        jobs += builds_for(topo, WIDE_T if name == "rnn" else (),
                           bf16=name in ("ww", "rnn"))
    tanh = dataclasses.replace(t["ww"], activation="tanh")
    return jobs + [j for j in builds_for(tanh) if j[0] != "ww_apply"] + [
        ("rnn_train", kernel_build(fence_rnn()))]


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
    instantiation, bitwise; at that N, K5 at the recurrent fence (tanh)
    and K3's width-3 / depth-3 recurrent bodies in float32 and bfloat16,
    bitwise."""
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
                poison=(), learn_ops=None):
        """The SGD chain of ``topo``: train 10 and learn 1 bitwise, train
        10 timed; with ``learn_ops`` (an imitation epoch's operations) also
        train 1 and learn 1 timed, the shapes of a ``run_training`` epoch
        and of the soups' learn phase."""
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
        if learn_ops is not None:
            for what, fn, nbytes, ops in (
                    ("train 1", lambda: train(topo, w, 1), (2 * p + 1) * n * 4,
                     n * ops_epoch),
                    ("learn 1", lambda: learn(topo, w, other, 1),
                     (3 * p + 1) * n * 4, n * learn_ops)):
                b, by = bound_ms(nbytes, ops)
                log(f"  {what}: kernel {timed_ms(torch, fn, 10):.4f} ms "
                    f"(device {device_ms(fn):.4f}), bound {b:.4f} ms ({by})")
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
    step = lambda: cuda_ww.ww_apply_population(ww, wd, 1)
    b, by = bound_ms(2 * p * N * 4, N * p * apply_ops_per_point(ww))
    log(f"  steps=1 (a run_fixpoint step): kernel "
        f"{timed_ms(torch, step, 10):.4f} ms (device {device_ms(step):.4f}), "
        f"bound {b:.4f} ms ({by}), --fmad=false ceiling "
        f"{fmad_off_ms(N * ww_apply_issued(ww)):.4f} ms")
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
    # at a small N, on the checkpointed BPTT: K5 at the recurrent
    # fence (width 7 / depth 1, P = 64, tanh), K3's recurrent bodies at
    # width 3 / depth 3 in float32 and bfloat16
    fence = fence_rnn()
    log(f"recurrent fence width 7 depth 1 tanh (P={fence.num_weights}) and "
        f"recurrent width 3 depth 3 K3 f32 / bf16, N={n}")
    wf = population(fence, n, gen, 0.5)
    of = population(fence, n, gen, 0.5)
    wf[fence.num_weights - 1, 0] = float("inf")
    wf[9, 1] = float("nan")
    check_sgd(torch, "K5 fence train=3",
              lambda: crt.rnn_train_epochs(fence, wf, 3),
              lambda: crt.rnn_sgd_plain(fence, wf, None, 3, 0.01))
    check_sgd(torch, "K5 fence learn=1",
              lambda: crt.rnn_learn_epochs(fence, wf, of, 1),
              lambda: crt.rnn_sgd_plain(fence, wf, of, 1, 0.01))
    wr = population(t["rnn"], n, gen, 0.5)
    check_small_generation(torch, t["rnn"], wr, gen_operands(
        torch, t["rnn"], wr, gen, rate=0.5), dict(
            severity=1, train=2, lr=0.01, remove_divergent=True,
            remove_zero=True, epsilon=1e-4))
    # K4 and K3's k-vector bodies; the fence at FENCE_N
    for key, n in (("agg", N), ("fft", N), ("k6", N), ("k8", FENCE_N)):
        topo = t[key]
        sgd_row(ck.KVEC_SGD, topo, n, ck.kvec_train_epochs,
                ck.kvec_learn_epochs, ck.kvec_sgd_plain,
                kvec_sgd_ops_per_epoch(topo, True),
                poison=(((3, 0), float("inf")), ((10, 1), float("nan"))),
                learn_ops=(kvec_reduce_ops(topo)
                           + kvec_sgd_ops_per_epoch(topo, False))
                if key in ("agg", "fft") else None)
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


# ------------------------------------------------- compact phases, capture


#: the lane-count argument of each wrapped entry point (lane_call's n for
#: the SGD kernels, K6's n)
LANES_ARG = {"ww_train": 4, "kvec_train": 4, "rnn_train": 4, "rnn_apply": 3}


class LanesSeen:
    """While inside, every launch of the SGD kernels and K6 is recorded by
    row as (learn / train / apply, lanes); the launch counts are the
    wrappers' own."""

    def __init__(self, kernels):
        self.kernels = [k for k in kernels if k.source in LANES_ARG]
        self.seen = collections.defaultdict(collections.Counter)

    def __enter__(self):
        for k in self.kernels:
            def launch(build, *args, k=k, orig=k.launch):
                orig(build, *args)
                what = ("apply" if k.source == "rnn_apply" else
                        "learn" if args[1] else "train")
                self.seen[row_name(k, build.tag)][
                    (what, args[LANES_ARG[k.source]])] += 1
            k.launch = launch
        return self.seen

    def __exit__(self, *exc):
        for k in self.kernels:
            del k.launch


def count_syncs(torch, fn) -> collections.Counter:
    """Host synchronisations of ``fn()``, as torch's sync debug mode warns
    of them, by the line of the package that made each."""
    import traceback
    import warnings

    torch.cuda.synchronize()
    where = collections.Counter()

    def record(message, *args, **kw):
        if "called a synchronizing CUDA operation" in str(message):
            frames = [f for f in traceback.extract_stack()
                      if "srnn_tpu_torch" in f.filename]
            where[f"{os.path.basename(frames[-1].filename)}:"
                  f"{frames[-1].lineno}" if frames else "?"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return where


def states_equal(torch, what, a, ev_a, b, ev_b) -> None:
    """Two soups' weights, uids, next_uid and last events, bitwise."""
    pairs = [("weights", a.weights, b.weights), ("uids", a.uids, b.uids),
             ("next_uid", a.next_uid, b.next_uid)]
    pairs += [(f"events.{f}", x, y) for f, x, y in zip(ev_a._fields, ev_a,
                                                        ev_b)]
    for field, x, y in pairs:
        if x.dtype.is_floating_point:
            x, y = x.float().view(torch.int32), y.float().view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {field} differ")
    log(f"  {what}: weights, uids, next_uid and the last events bitwise "
        "equal")


def compact_topos():
    """(topology, SGD kernel row, expected per-generation launches of the
    phase chain) of the compact phase: the three standard particles at
    width 2 / depth 2 and the weightwise one at width 3 / depth 3."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch.ops import cuda_ww_train as cwt

    ww3 = wide_topos()["ww"]
    return ((st.Topology("weightwise"), "ww_sgd", {"ww_sgd": 2}),
            (st.Topology("aggregating", aggregates=4), "kvec_sgd",
             {"kvec_sgd": 2}),
            (st.Topology("recurrent"), "rnn_sgd",
             {"rnn_sgd": 2, "rnn_apply": 1}),
            (ww3, wide_row(cwt.WW_SGD, ww3), {wide_row(cwt.WW_SGD, ww3): 2}))


def compact_path(torch, kernels, totals):
    """attack_impl / learn_from_impl='compact' against 'full' at N = 1M on
    the population-major phase chain: per particle, 20 generations after a
    warm-up generation each way (the last one through evolve_step for its
    events), weights, uids and last events bitwise equal, launch counts
    exact with the learn (and K6) launches over the block's lanes, ms a
    generation both ways, and the host synchronisations of one generation;
    then the learn kernel's device ms over the block's lanes and over N;
    then fused + compact against fused + full, one K3 launch a
    generation."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch.ops import cuda_kvec_train as ck
    from srnn_tpu_torch.ops import cuda_rnn_train as crt
    from srnn_tpu_torch.ops import cuda_ww_train as cwt
    from srnn_tpu_torch.soup import _attack_capacity

    cap = _attack_capacity(N, 0.1)
    log(f"compact block: {cap} lanes of N={N} at rate 0.1 "
        "(soup._attack_capacity)")
    g = GENERATIONS
    learn = {"weightwise": (cwt.ww_learn_epochs, sgd_ops_per_epoch),
             "aggregating": (ck.kvec_learn_epochs, lambda t: (
                 kvec_reduce_ops(t) + kvec_sgd_ops_per_epoch(t, False))),
             "recurrent": (crt.rnn_learn_epochs, rnn_sgd_ops_per_epoch)}
    for topo, sgd_row, per_gen in compact_topos():
        base = st.SoupConfig(topo=topo, size=N, attacking_rate=0.1,
                             learn_from_rate=0.1, learn_from_severity=1,
                             train=10, remove_divergent=True,
                             remove_zero=True, respawn_draws="fused",
                             layout="popmajor")
        what = (f"{topo.variant} width {topo.width} depth {topo.depth} "
                "soup phases")
        s0 = st.evolve(base, st.seed(base, 0, device="cuda"), 1)
        out, ms, syncs = {}, {}, {}
        for impl in ("full", "compact"):
            cfg = base._replace(attack_impl=impl, learn_from_impl=impl)
            st.evolve(cfg, s0, 1)  # warm-up
            torch.cuda.synchronize()
            reset(kernels)
            with LanesSeen(kernels) as seen:
                t0 = time.perf_counter()
                s = st.evolve(cfg, s0, g - 1)
                out[impl] = st.evolve_step(cfg, s)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            ms[impl] = dt * 1e3 / g
            got = check_launches(kernels, f"{what} {impl}",
                                 {r: n * g for r, n in per_gen.items()})
            for name, n in got.items():
                totals[name] += n
            lanes = {r: dict(c) for r, c in seen.items()}
            log(f"  {what} {impl}: launches by (phase, lanes) {lanes}")
            block = cap if impl == "compact" else N
            want = {sgd_row: {("learn", block): g, ("train", N): g}}
            if "rnn_apply" in per_gen:
                want["rnn_apply"] = {("apply", block): g}
            if lanes != want:
                raise AssertionError(f"{what} {impl}: launches by lanes "
                                     f"{lanes}, expected {want}")
            where = count_syncs(torch, lambda: st.evolve(cfg, s0, 1))
            syncs[impl] = sum(where.values())
            log(f"  {what} {impl}: {ms[impl]:.3f} ms/generation at N={N}, "
                f"{syncs[impl]} host synchronisations in a generation "
                f"{dict(where)}")
        if syncs["compact"] != syncs["full"] + 2:
            raise AssertionError(
                f"{what}: {syncs['compact']} host synchronisations a "
                f"compact generation, expected the full one's "
                f"{syncs['full']} + 2 (one per compacted phase)")
        (a, ev_a), (b, ev_b) = out["full"], out["compact"]
        states_equal(torch, f"{what} compact vs full", a, ev_a, b, ev_b)
        log(f"  {what}: compact {ms['compact']:.3f} vs full "
            f"{ms['full']:.3f} ms/generation (compact / full "
            f"{ms['compact'] / ms['full']:.3f})")
        # the learn kernel over the block and over N (learn 1)
        fn, ops_of = learn[topo.variant]
        gen = torch.Generator(device="cuda").manual_seed(13)
        p = topo.num_weights
        for n in (cap, N):
            w = population(topo, n, gen, 0.5)
            other = population(topo, n, gen, 0.5)
            run = lambda: fn(topo, w, other, 1)
            b, by = bound_ms((3 * p + 1) * n * 4, n * ops_of(topo))
            log(f"  {sgd_row} learn 1 over {n} lanes: kernel "
                f"{timed_ms(torch, run, 10):.4f} ms (device "
                f"{device_ms(run):.4f}), bound {b:.4f} ms ({by})")
    # fused + compact: the compaction is ignored (the JAX package's
    # _phases_view), one K3 launch a generation
    topo = st.Topology("weightwise")
    base = st.SoupConfig(topo=topo, size=N, attacking_rate=0.1,
                         learn_from_rate=0.1, learn_from_severity=1,
                         train=10, remove_divergent=True, remove_zero=True,
                         respawn_draws="fused", layout="popmajor",
                         generation_impl="fused")
    s0 = st.seed(base, 1, device="cuda")
    out = {}
    for impl in ("full", "compact"):
        cfg = base._replace(attack_impl=impl, learn_from_impl=impl)
        reset(kernels)
        s = st.evolve(cfg, s0, g - 1)
        out[impl] = st.evolve_step(cfg, s)
        torch.cuda.synchronize()
        for name, n in check_launches(kernels, f"weightwise fused {impl}",
                                      {"generation": g}).items():
            totals[name] += n
    states_equal(torch, "weightwise fused compact vs full", *out["full"],
                 *out["compact"])


def frames_equal(np, what, out, ref_weights, ref_uids, gens) -> None:
    """A store's frames against the recorded history (generations 1, 2,
    ... of a run from time 0) at ``gens``, bitwise."""
    if out["generations"].tolist() != list(gens):
        raise AssertionError(f"{what}: generations {out['generations']}")
    idx = [x - 1 for x in gens]
    if not (np.array_equal(out["weights"].view(np.int32),
                           ref_weights[idx].view(np.int32))
            and np.array_equal(out["uids"], ref_uids[idx])):
        raise AssertionError(f"{what}: frames differ from the record")
    log(f"  {what}: {len(idx)} frames bitwise equal to the recorded "
        "generations")


def capture_path(torch, kernels, totals):
    """Streaming capture: evolve_captured at N = 1M, the weightwise fused
    soup, 20 generations, a frame every 5 (4 frames of 72 MB) into a
    temporary directory, pipelined and blocking, each frame bitwise equal
    to evolve(record=True), each run's walls beside the uncaptured run's
    and its K3 launches exact; then evolve_multi_captured of a mixed soup
    at N = 30,000 (the population-major phase chain), pipelined and
    blocking, against the generations of evolve_multi_step."""
    import shutil
    import tempfile

    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch.soup import _stored_view
    from srnn_tpu_torch.utils import (TrajStore, evolve_captured,
                                      evolve_multi_captured,
                                      native_available, read_store)
    from srnn_tpu_torch.utils.pipeline import live_threads

    log(f"trajectory store: native writer {native_available()}")
    g, every = GENERATIONS, 5
    gens = list(range(every, g + 1, every))
    topo = st.Topology("weightwise")
    cfg = st.SoupConfig(topo=topo, size=N, attacking_rate=0.1,
                        learn_from_rate=0.1, learn_from_severity=1,
                        train=10, remove_divergent=True, remove_zero=True,
                        respawn_draws="fused", layout="popmajor",
                        generation_impl="fused")
    s0 = st.seed(cfg, 2, device="cuda")
    # the record, also the warm-up of the runs below
    _, (_, w_rec, u_rec) = st.evolve(cfg, s0, g, record=True)
    w_rec, u_rec = w_rec.cpu().numpy(), u_rec.cpu().numpy()
    walls = {}
    tmp = tempfile.mkdtemp(prefix="srnn-capture-")
    try:
        for run in ("uncaptured", "pipelined", "blocking", "pipelined 2",
                    "uncaptured 2"):
            torch.cuda.synchronize()
            reset(kernels)
            path = os.path.join(tmp, "soup.traj")
            t0 = time.perf_counter()
            if run.startswith("uncaptured"):
                st.evolve(cfg, s0, g)
                torch.cuda.synchronize()
            else:
                with TrajStore(path, N, topo.num_weights) as store:
                    evolve_captured(cfg, s0, g, store, every=every,
                                    pipelined=run.startswith("pipelined"))
            walls[run] = time.perf_counter() - t0
            for name, n in check_launches(kernels, f"capture {run}",
                                          {"generation": g}).items():
                totals[name] += n
            if not run.startswith("uncaptured"):
                frames_equal(np, f"capture {run}", read_store(path), w_rec,
                             u_rec, gens)
                os.remove(path)
        log("  walls of 20 generations, a frame every 5 (4 frames of "
            f"{(8 + N * topo.num_weights * 4 + 16 * N + 4) / 1e6:.1f} MB): "
            + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
        if live_threads():
            raise AssertionError(f"capture left threads {live_threads()}")
        # the mixed soup, smaller
        from srnn_tpu_torch import multisoup as ms

        mcfg = mega_multi_config(layout="popmajor")._replace(
            sizes=(10_000, 10_000, 10_000))
        m0 = ms.seed_multi(mcfg, 3, device="cuda")
        state, rec = m0, []
        for _ in range(g):
            state, _ev = ms.evolve_multi_step(mcfg, state)
            rec.append([_stored_view(mcfg, w, None).cpu().numpy()
                        for w in state.weights]
                       + [u.cpu().numpy() for u in state.uids])
        types = len(mcfg.topos)
        for run in ("pipelined", "blocking"):
            paths = [os.path.join(tmp, f"t{t}.traj") for t in range(types)]
            stores = [TrajStore(p, n, tp.num_weights) for p, n, tp in
                      zip(paths, mcfg.sizes, mcfg.topos)]
            try:
                evolve_multi_captured(mcfg, m0, g, stores, every=every,
                                      pipelined=run == "pipelined")
            finally:
                for s in stores:
                    s.close()
            for t in range(types):
                frames_equal(np, f"mixed capture {run} type {t}",
                             read_store(paths[t]),
                             np.stack([r[t] for r in rec]),
                             np.stack([r[types + t] for r in rec]), gens)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------- device telemetry


#: the three flags of evolve / evolve_multi (lineage_state added per run)
FLAGS = dict(metrics=True, health=True, lineage=True)


def metered(torch, cfg, state, generations, **kw):
    """``evolve`` with all three carries on, seeded with a fresh lineage."""
    import srnn_tpu_torch as st
    from srnn_tpu_torch.telemetry.dynamics import seed_lineage

    return st.evolve(cfg, state, generations, **FLAGS,
                     lineage_state=seed_lineage(cfg.size, device="cuda"),
                     **kw)


def syncs_per_generation(torch, run) -> tuple:
    """(host synchronisations a generation, those of the call around it,
    where the 1-generation call made them) of ``run(generations)``: from
    one call of 1 generation and one of 3."""
    where = count_syncs(torch, lambda: run(1))
    one = sum(where.values())
    three = sum(count_syncs(torch, lambda: run(3)).values())
    per_gen = (three - one) / 2
    return per_gen, one - per_gen, dict(where)


def traced_per_generation(torch, run) -> dict:
    """Host operators, device events (kernels and copies) and device ms a
    generation of ``run(generations)`` under torch.profiler, from one
    traced call of 1 generation and one of 3 (to inform: the profiler
    inflates host time)."""
    from srnn_tpu_torch.profile_soup import _device_us

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = []
    for gens in (1, 3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            run(gens)
            torch.cuda.synchronize()
        ops = sum(1 for e in prof.events()
                  if e.name.startswith("aten::") and e.cpu_parent is None)
        dev = [(e.count, _device_us(e)) for e in prof.key_averages()
               if _device_us(e) > 0]
        out.append((ops, sum(c for c, _ in dev),
                    sum(us for _, us in dev) / 1e3))
    return {key: (b - a) / 2 for key, a, b in
            zip(("host_ops", "device_events", "device_ms"), *out)}


def np_health(np, views, epsilon):
    """NumPy recount of a HealthStats from per-generation (N, P) float32
    views (the JAX package's formula: max |w| per particle, float32 log2
    buckets)."""
    from srnn_tpu_torch.telemetry import device as dev

    hist = np.zeros(dev.N_HEALTH_BUCKETS, np.int64)
    counts, lo, hi = [], np.inf, -np.inf
    for w in views:
        norm = np.abs(w).max(axis=-1)
        finite = np.isfinite(norm)
        counts.append((int((~finite).sum()),
                       int((finite & (norm <= np.float32(epsilon))).sum())))
        safe = np.where(finite & (norm > 0), norm,
                        np.float32(2.0) ** dev.HEALTH_BUCKET_LO)
        b = np.clip((np.floor(np.log2(safe)).astype(np.int64)
                     - dev.HEALTH_BUCKET_LO) // dev.HEALTH_BUCKET_STEP, 0,
                    dev.N_HEALTH_BUCKETS - 1)
        hist += np.bincount(b[finite], minlength=dev.N_HEALTH_BUCKETS)
        if finite.any():
            lo, hi = min(lo, norm[finite].min()), max(hi, norm[finite].max())
    return counts, hist, lo, hi


def np_census(np, w, fw, epsilon):
    """NumPy basin labels of (N, P) weights and their self-application."""
    from srnn_tpu_torch.telemetry import dynamics as dyn

    linf = np.abs(fw - w).max(axis=-1)
    div = ~np.isfinite(w).all(axis=-1) | ~np.isfinite(linf)
    eps = np.float32(epsilon)
    zero = (np.abs(w) <= eps).all(axis=-1) & ~div
    fix = ~div & ~zero & (linf < eps)
    return np.select([div, zero, fix], [dyn.BASIN_DIV, dyn.BASIN_ZERO,
                                        dyn.BASIN_FIX], dyn.BASIN_DRIFT)


def check_carries_on_host(torch, what, cfg, s0, final, recs, m, h, lineage):
    """The carries of a metered ``evolve(record=True)`` at N = 1M against
    the host: actions against a bincount of the recorded events, health
    against a NumPy recount of every recorded view, the census and labels
    against a NumPy recount of the final state and its self-application,
    respawn births against the uid advance, the window within capacity."""
    import numpy as np

    from srnn_tpu_torch.ops.popmajor import apply_popmajor
    from srnn_tpu_torch.telemetry import device as dev

    ev, views, _ = recs
    acts = np.bincount(ev.action.cpu().numpy().reshape(-1),
                       minlength=dev.N_ACTIONS)
    if not np.array_equal(acts, m.actions.cpu().numpy()):
        raise AssertionError(f"{what}: actions {m.actions.tolist()} against "
                             f"the recorded events' {acts.tolist()}")
    loss = float(ev.loss.double().sum())
    if abs(float(m.loss_sum) - loss) > 1e-5 * abs(loss):
        raise AssertionError(f"{what}: loss_sum {float(m.loss_sum)} against "
                             f"{loss}")
    counts, hist, lo, hi = np_health(
        np, (views[g].float().cpu().numpy() for g in range(len(views))),
        cfg.epsilon)
    got = (int(h.nonfinite), int(h.zero), int(h.nonfinite_peak),
           int(h.zero_peak), float(h.norm_min), float(h.norm_max))
    want = (counts[-1][0], counts[-1][1], max(c[0] for c in counts),
            max(c[1] for c in counts), float(lo), float(hi))
    if got != want or not np.array_equal(hist, h.norm_hist.cpu().numpy()):
        raise AssertionError(f"{what}: health {got} {h.norm_hist.tolist()} "
                             f"against the recount {want} {hist.tolist()}")
    lin, win, stats = lineage
    wT = final.weights.float().t().contiguous()
    fw = apply_popmajor(cfg.topo, wT, wT).t().cpu().numpy()
    basin = np_census(np, final.weights.float().cpu().numpy(), fw,
                      cfg.epsilon)
    census = np.bincount(basin, minlength=4)
    if not (np.array_equal(census, stats.census.cpu().numpy())
            and np.array_equal(basin, lin.basin.cpu().numpy())):
        raise AssertionError(f"{what}: census {stats.census.tolist()} "
                             f"against the recount {census.tolist()}")
    births = win.births.cpu().numpy()[0]
    advance = int(final.next_uid) - int(s0.next_uid)
    if births[1] != advance or int(lin.next_pid) != cfg.size + births.sum():
        raise AssertionError(f"{what}: births {births.tolist()}, uid advance "
                             f"{advance}, next_pid {int(lin.next_pid)}")
    if not 0 < int(win.n_edges) <= win.edges.shape[0]:
        raise AssertionError(f"{what}: n_edges {int(win.n_edges)}")
    log(f"  {what}: carries equal the host recounts: actions "
        f"{acts.tolist()}, health nonfinite/zero {counts[-1]} (peaks "
        f"{want[2:4]}, norms {lo:.6g}..{hi:.6g}), census [fixpoint, "
        f"drifting, divergent, zero] {census.tolist()}, births "
        f"{births.tolist()} (uid advance {advance}), edges "
        f"{int(win.n_edges)} kept / {int(win.dropped)} dropped")


def fused_telemetry_run(torch, kernels, totals, topo, row, close):
    """The fused soup of ``topo`` at N = 1M, 20 generations with the three
    carries against 20 without: state and recorded events bitwise, launches
    exact (``row`` once a generation, ``close`` at the window's close), the
    synchronisations a generation no more than unmetered, ms a generation
    both ways in turns, and the carries against the host."""
    import srnn_tpu_torch as st

    g = GENERATIONS
    what = f"{topo.variant} fused soup"
    cfg = st.SoupConfig(topo=topo, size=N, attacking_rate=0.1,
                        learn_from_rate=0.1, learn_from_severity=1, train=10,
                        remove_divergent=True, remove_zero=True,
                        respawn_draws="fused", layout="popmajor",
                        generation_impl="fused")
    s0 = st.evolve(cfg, st.seed(cfg, 0, device="cuda"), 1)  # warm-up
    metered(torch, cfg, s0, 1)
    torch.cuda.synchronize()
    ms_gen = collections.defaultdict(list)
    for run in ("off", "on", "off", "on"):
        reset(kernels)
        t0 = time.perf_counter()
        if run == "on":
            metered(torch, cfg, s0, g)
        else:
            st.evolve(cfg, s0, g)
        torch.cuda.synchronize()
        ms_gen[run].append((time.perf_counter() - t0) * 1e3 / g)
        expect = {row: g, **({r: n for r, n in close.items()}
                             if run == "on" else {})}
        for name, n in check_launches(kernels, f"{what} flags {run}",
                                      expect).items():
            totals[name] += n
    sync = {run: syncs_per_generation(torch, (
        lambda k: metered(torch, cfg, s0, k)) if run == "on" else (
        lambda k: st.evolve(cfg, s0, k))) for run in ("off", "on")}
    if sync["on"][0] > sync["off"][0]:
        raise AssertionError(f"{what}: {sync['on'][0]} host synchronisations "
                             f"a metered generation, {sync['off'][0]} "
                             "unmetered")
    traced = {run: traced_per_generation(torch, (
        lambda k: metered(torch, cfg, s0, k)) if run == "on" else (
        lambda k: st.evolve(cfg, s0, k))) for run in ("off", "on")}
    log(f"  {what}: a generation under torch.profiler: off {traced['off']}, "
        f"on {traced['on']}")
    log(f"  {what}: ms a generation at N={N}, in turns: off "
        f"{ms_gen['off']}, on {ms_gen['on']}; host synchronisations a "
        f"generation off {sync['off'][0]:g}, on {sync['on'][0]:g} (the call "
        f"around them: off {sync['off'][1]:g}, on {sync['on'][1]:g}; a "
        f"1-generation call's by line: off {sync['off'][2]}, on "
        f"{sync['on'][2]})")
    plain, recs = st.evolve(cfg, s0, g, record=True)
    final, recs2, m, h, lineage = metered(torch, cfg, s0, g, record=True)
    states_equal(torch, f"{what} flags on vs off", plain,
                 st.SoupEvents(*(e[-1] for e in recs[0])), final,
                 st.SoupEvents(*(e[-1] for e in recs2[0])))
    for name, x, y in zip(("action", "counterpart", "loss", "views", "uids"),
                          (*recs[0], recs[1], recs[2]),
                          (*recs2[0], recs2[1], recs2[2])):
        if x.dtype.is_floating_point:
            x, y = x.float().view(torch.int32), y.float().view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: recorded {name} differ with the "
                                 "flags on")
    check_carries_on_host(torch, what, cfg, s0, final, recs2, m, h, lineage)
    return {"ms_off": ms_gen["off"], "ms_on": ms_gen["on"],
            "syncs_off": sync["off"][0], "syncs_on": sync["on"][0],
            "traced_off": traced["off"], "traced_on": traced["on"]}


def bitwise_metered(torch, kernels, totals, what, run, expect_off,
                    expect_on):
    """``run(metered)`` (the final state; ``metered`` True runs the three
    carries) both ways: launches exact each way, the states bitwise."""
    out = {}
    for flag in (False, True):
        reset(kernels)
        out[flag] = run(flag)
        torch.cuda.synchronize()
        for name, n in check_launches(
                kernels, f"{what} flags {'on' if flag else 'off'}",
                expect_on if flag else expect_off).items():
            totals[name] += n
    a, b = out[False], out[True]
    for field in ("weights", "uids"):
        xs, ys = getattr(a, field), getattr(b, field)
        for x, y in zip(xs if isinstance(xs, tuple) else (xs,),
                        ys if isinstance(ys, tuple) else (ys,)):
            if x.dtype.is_floating_point:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: {field} differ with the "
                                     "flags on")
    if not torch.equal(a.next_uid, b.next_uid):
        raise AssertionError(f"{what}: next_uid differs with the flags on")
    log(f"  {what}: weights, uids and next_uid bitwise with the flags on")


def telemetry_path(torch, kernels, totals):
    """Device telemetry (``metrics=`` / ``health=`` / ``lineage=``): the
    fused weightwise, aggregating and recurrent soups at N = 1M, metered
    against unmetered (``fused_telemetry_run``); then bitwise against
    unmetered with launches exact: the weightwise phase chain, the
    row-major weightwise soup, the mixed fused soup at mega_multisoup's
    split, and the N = 1M capture run with a registry (its counters
    against the metrics carry of the same 20 generations); then a small
    metered soup on the card against the same soup on the CPU."""
    import shutil
    import tempfile

    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch import multisoup as ms
    from srnn_tpu_torch.telemetry import (EVENT_COUNTERS, MetricsRegistry,
                                          seed_lineage, seed_lineage_blocks)
    from srnn_tpu_torch.utils import TrajStore, evolve_captured

    g = GENERATIONS
    report = {}
    for topo, row, close in (
            (st.Topology("weightwise"), "generation", {}),
            (st.Topology("aggregating", aggregates=4), "generation_kvec", {}),
            # the popmajor close self-applies through K6 (apply_popmajor)
            (st.Topology("recurrent"), "generation_rnn", {"rnn_apply": 1})):
        report[topo.variant] = fused_telemetry_run(torch, kernels, totals,
                                                   topo, row, close)
    log(f"telemetry overhead (ms a generation, syncs a generation): "
        f"{json.dumps(report)}")

    base = dict(size=N, attacking_rate=0.1, learn_from_rate=0.1,
                learn_from_severity=1, train=10, remove_divergent=True,
                remove_zero=True, respawn_draws="fused")
    ww = st.Topology("weightwise")
    for what, cfg in (("weightwise phase chain", st.SoupConfig(
            topo=ww, layout="popmajor", **base)),
            ("weightwise row-major soup", st.SoupConfig(topo=ww, **base))):
        s0 = st.seed(cfg, 5, device="cuda")
        bitwise_metered(
            torch, kernels, totals, what,
            lambda on, cfg=cfg, s0=s0: metered(torch, cfg, s0, g)[0] if on
            else st.evolve(cfg, s0, g), {"ww_sgd": 2 * g}, {"ww_sgd": 2 * g})
    mcfg = mega_multi_config(layout="popmajor", generation_impl="fused")
    m0 = ms.seed_multi(mcfg, 6, device="cuda")
    attacks = {"rnn_apply_t14": g, "rnn_apply_t20": g, "rnn_apply": g}
    bitwise_metered(
        torch, kernels, totals, "mixed fused soup",
        lambda on: ms.evolve_multi(
            mcfg, m0, g, **FLAGS,
            lineage_state=seed_lineage_blocks(mcfg.sizes, device="cuda"))[0]
        if on else ms.evolve_multi(mcfg, m0, g),
        {"generation": g, "generation_kvec": g, "generation_rnn": g,
         **attacks},
        {"generation": g, "generation_kvec": g, "generation_rnn": g,
         **attacks, "rnn_apply": g + 1})

    # the capture run with a registry: every generation metered
    cfg = st.SoupConfig(topo=ww, layout="popmajor", generation_impl="fused",
                        **base)
    s0 = st.seed(cfg, 7, device="cuda")
    _, m = st.evolve(cfg, s0, g, metrics=True)
    tmp = tempfile.mkdtemp(prefix="srnn-telemetry-")
    try:
        reg = MetricsRegistry()
        reset(kernels)
        with TrajStore(os.path.join(tmp, "soup.traj"), N,
                       ww.num_weights) as store:
            final = evolve_captured(cfg, s0, g, store, every=5, registry=reg)
        for name, n in check_launches(kernels, "capture with a registry",
                                      {"generation": g}).items():
            totals[name] += n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counters = {name: reg.counter(EVENT_COUNTERS[name][0]).value()
                for name in EVENT_COUNTERS}
    want = {name: int(m.actions[st.soup.ACTION_NAMES.index(name)])
            for name in EVENT_COUNTERS}
    if reg.counter("soup_generations_total").value() != g or \
            counters != want or not torch.equal(
                final.weights, st.evolve(cfg, s0, g).weights):
        raise AssertionError(f"capture with a registry: counters {counters} "
                             f"against the metrics carry {want}")
    log(f"  capture with a registry: {g} generations metered, counters "
        f"{counters} equal the metrics carry, the state bitwise")

    # a small metered soup, card against CPU, from one CPU generator
    for impl in ("fused", "phases"):
        cfg = st.SoupConfig(topo=ww, size=640, attacking_rate=0.3,
                            learn_from_rate=0.3, learn_from_severity=1,
                            train=2, remove_divergent=True, remove_zero=True,
                            layout="popmajor", generation_impl=impl)
        out = {}
        for d in ("cuda", "cpu"):
            s = st.seed(cfg, torch.Generator().manual_seed(9), device=d)
            out[d] = st.evolve(cfg, s, 5, **FLAGS, lineage_state=seed_lineage(
                640, device=d), lineage_capacity=512)
        tag = f"small metered {impl} soup"
        (fa, ma, ha, (la, wa, sa)), (fb, mb, hb, (lb, wb, sb)) = \
            out["cuda"], out["cpu"]
        for name, x, y in (("uids", fa.uids, fb.uids),
                           ("actions", ma.actions, mb.actions),
                           *((f"health.{f}", getattr(ha, f), getattr(hb, f))
                             for f in ("nonfinite", "zero", "norm_hist")),
                           *((f"lineage.{f}", x, y) for f, x, y in
                             zip(la._fields, la, lb)),
                           *((f"window.{f}", x, y) for f, x, y in
                             zip(wa._fields, wa, wb)),
                           ("census", sa.census, sb.census),
                           ("transitions", sa.transitions, sb.transitions)):
            equal_ints(torch, f"{tag} {name}", x, y)
        compare(torch, f"{tag} weights", fa.weights.cpu(), fb.weights)
        compare(torch, f"{tag} loss_sum", ma.loss_sum.cpu(), mb.loss_sum)
        compare(torch, f"{tag} norm extrema",
                torch.stack([ha.norm_min, ha.norm_max]).cpu(),
                torch.stack([hb.norm_min, hb.norm_max]))
        compare(torch, f"{tag} distance maxima",
                torch.stack([sa.l2_max, sa.linf_max]).cpu(),
                torch.stack([sb.l2_max, sb.linf_max]))
    return report

# ------------------------------------------------------------- mega runs
#: mega_soup as the phase "mega runs" drives it: N = 1M, 20 generations in
#: two chunks, training and imitation on, the fused route, every plane on
MEGA_GENERATIONS = 20
MEGA_SOUP = ["--size", str(N), "--generations", str(MEGA_GENERATIONS),
             "--checkpoint-every", "10", "--train", "10",
             "--learn-from-rate", "0.1", "--generation-impl", "fused",
             "--lineage"]
#: the steady-rate runs' generations: six chunks of 10
MEGA_STEADY = 60
MEGA_MULTI_GENERATIONS = 10
MEGA_MULTI = ["--size", str(N), "--generations",
              str(MEGA_MULTI_GENERATIONS), "--generation-impl", "fused"]
MEGA_FAST_BACKOFF = ["--backoff-base-s", "0.01", "--backoff-max-s", "0.05"]
MEGA_PIPE_PLANES_OFF = ["--no-spans", "--no-export", "--no-profile",
                        "--no-health"]
MEGA_PLANES_OFF = ["--no-pipeline"] + MEGA_PIPE_PLANES_OFF


def mega_start(root, tag, name, argv):
    """Start ``python -m srnn_tpu_torch.setups name argv`` on the card, its
    output and its launch counts to files under ``root``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k != "SRNN_SETUPS_PLATFORM"}
    env["SRNN_LAUNCH_COUNTS"] = os.path.join(root, f"{tag}.launches.json")
    with open(os.path.join(root, f"{tag}.out"), "w") as out, \
            open(os.path.join(root, f"{tag}.err"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "srnn_tpu_torch.setups", name, *argv],
            cwd=here, env=env, stdout=out, stderr=err)
    return tag, proc, time.perf_counter()


def mega_wait(root, started, want_rc) -> dict:
    """Wait for the started CLIs; each must exit with ``want_rc[tag]``.
    Returns tag -> (stdout, launches, wall seconds of the process)."""
    out = {}
    try:
        for tag, proc, t0 in started:
            rc = proc.wait(timeout=600)
            wall = time.perf_counter() - t0
            with open(os.path.join(root, f"{tag}.out")) as f:
                text = f.read()
            with open(os.path.join(root, f"{tag}.err")) as f:
                err = f.read()
            if rc != want_rc[tag]:
                raise AssertionError(f"mega {tag}: rc {rc}, expected "
                                     f"{want_rc[tag]}\n{text[-3000:]}\n"
                                     f"{err[-3000:]}")
            with open(os.path.join(root, f"{tag}.launches.json")) as f:
                out[tag] = (text, json.load(f), wall)
    finally:
        for _, proc, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def mega_rate(text, skip: int = 0) -> float:
    """Generations/s of a mega run's chunk loop from its log: the
    generations of its chunk lines over the sum of their seconds (a line's
    seconds run from the previous finisher to its own, so one chunk's
    share can land in the next line's; their sum is the loop's wall),
    past the first ``skip`` lines of an attempt."""
    gens, secs, last, seen = 0, 0.0, None, 0
    for line in text.splitlines():
        if line.startswith("gen ") and "gens/s" in line:
            g = int(line.split()[1].split("/")[0])
            seen += 1
            if last is not None and seen > skip:
                gens += g - last
                secs += (g - last) / float(line.split()[2])
            last = g
        elif line.startswith("resumed from") or line.startswith(
                "mega-soup N=") or line.startswith("mega-multisoup N="):
            last = int(line.split()[-1]) if line.startswith("resumed") \
                else 0
            seen = 0
    return gens / secs if secs else float("nan")


def mega_checkpoint(torch, run_dir, gen):
    """A mega run's checkpoint ``gen`` as its saved tree."""
    path = os.path.join(run_dir, f"ckpt-gen{gen:08d}", "state.pt")
    return torch.load(path, map_location="cpu", weights_only=True)


def mega_same(torch, what, a, b) -> None:
    """Two checkpoint trees bitwise: population, uids, counters and the
    generator's state."""
    for key in ("weights", "uids", "next_uid", "time", "key_state"):
        x, y = a[key], b[key]
        xs, ys = (x, y) if isinstance(x, list) else ([x], [y])
        if len(xs) != len(ys) or not all(
                torch.equal(u, v) for u, v in zip(xs, ys)):
            raise AssertionError(f"{what}: checkpoint {key} differs")


def mega_tree(state) -> dict:
    """A soup's or a mixed soup's state as a checkpoint's tree (on the
    host)."""
    def cpu(x):
        return [t.cpu() for t in x] if isinstance(x, (list, tuple)) \
            else x.cpu()

    return {"weights": cpu(state.weights), "uids": cpu(state.uids),
            "next_uid": state.next_uid.cpu(), "time": state.time.cpu(),
            "key_state": state.key.get_state()}


def mega_pipeline(run_dir) -> dict:
    """A mega run's pipeline attribution (its ``kind: pipeline`` event:
    chunks, wall, device wait and host I/O seconds, the writer's busy
    seconds in the last)."""
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"pipeline"' in line]
    return [r for r in rows if r.get("kind") == "pipeline"][-1]


def mega_checkpoint_ms(torch, root, state) -> dict:
    """ms of one N = 1M checkpoint write, three times each: pipelined
    (``CheckpointSnapshot`` taken, then saved: the writer's job) and
    blocking (``save_checkpoint``)."""
    from srnn_tpu_torch.experiment import CheckpointSnapshot, save_checkpoint

    out = {"snapshot+save": [], "save_checkpoint": []}
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointSnapshot(state).save(os.path.join(root, f"snap{i}"))
        out["snapshot+save"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(root, f"blocking{i}"), state)
        out["save_checkpoint"].append((time.perf_counter() - t0) * 1e3)
    return out


def mega_sane(torch, what, tree, n) -> None:
    """A final checkpoint holds n finite particles with unique uids."""
    ws = tree["weights"] if isinstance(tree["weights"], list) \
        else [tree["weights"]]
    uids = torch.cat(tree["uids"] if isinstance(tree["uids"], list)
                     else [tree["uids"]])
    if sum(w.shape[0] for w in ws) != n or not all(
            bool(torch.isfinite(w).all()) for w in ws):
        raise AssertionError(f"{what}: not {n} finite particles")
    if int(torch.unique(uids).numel()) != n:
        raise AssertionError(f"{what}: uids are not unique")


def mega_bare(torch):
    """mega_soup's config (``mega_soup._make_config`` of ``MEGA_SOUP``) and
    a ``run(generations)`` of a bare ``soup.evolve`` with the same carries
    from its seed, no run plumbing."""
    from srnn_tpu_torch import soup as sp
    from srnn_tpu_torch.setups.mega_soup import _make_config, build_parser
    from srnn_tpu_torch.telemetry.dynamics import seed_lineage

    cfg = _make_config(build_parser().parse_args(MEGA_SOUP))
    state = sp.seed(cfg, 0, "cuda")

    def run(generations, state=state):
        return sp.evolve(cfg, state, generations, metrics=True, health=True,
                         lineage=True, lineage_state=seed_lineage(
                             cfg.size, device="cuda"))

    return cfg, state, run


def mega_multi_bare(torch):
    """mega_multisoup's final state as a bare ``evolve_multi`` of
    ``MEGA_MULTI``'s config from its seed, with the run's carries."""
    from srnn_tpu_torch import multisoup as ms
    from srnn_tpu_torch.setups.mega_multisoup import (_make_config,
                                                      build_parser)

    cfg = _make_config(build_parser().parse_args(MEGA_MULTI))
    return ms.evolve_multi(cfg, ms.seed_multi(cfg, 0, "cuda"),
                           MEGA_MULTI_GENERATIONS, metrics=True,
                           health=True)[0]


def mega_bare_loop(torch) -> float:
    """To inform: mega_soup's two chunks as a bare ``soup.evolve`` loop of
    the same config and carries, the count read after each: ms a
    generation after a warm-up generation."""
    from srnn_tpu_torch import soup as sp

    cfg, state, run = mega_bare(torch)
    state = run(1)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MEGA_GENERATIONS // 10):
        state = run(10, state)[0]
        sp.count(cfg, state).cpu()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / MEGA_GENERATIONS


def mega_syncs(torch, root) -> dict:
    """Host synchronisations a generation (``syncs_per_generation``): of
    the mega loop itself -- an in-process mega_soup of one chunk of 1
    generation against one of 3, every plane on -- and of the bare evolve
    of the same config and carries."""
    from srnn_tpu_torch.setups import REGISTRY

    def loop(generations):
        argv = list(MEGA_SOUP)
        argv[argv.index("--generations") + 1] = str(generations)
        argv[argv.index("--checkpoint-every") + 1] = "100"
        REGISTRY["mega_soup"](argv + ["--root", os.path.join(
            root, f"syncs{generations}")])

    return {"loop": syncs_per_generation(torch, loop),
            "bare": syncs_per_generation(torch, mega_bare(torch)[2])}


def mega_path(torch, kernels, totals, keep_runs=None):
    """Phase "mega runs": the CLIs as subprocesses on the card.

    mega_soup at N = 1M, 20 generations, a checkpoint every 10, every
    plane on and --lineage: exit 0 with K3 launched exactly once a
    generation (20).  The same with --chaos sigterm@0 (the flag is seen
    at the gen-10 boundary: exit 75), then --resume (exit 0); with
    --chaos device_loss@10 (exit 3: the gen-10 checkpoint is still in the
    pipeline, so the attempt restarts from scratch); both final
    checkpoints bitwise equal to the uninterrupted run's, and it equal to
    a bare ``soup.evolve`` of its config from its seed.  mega_multisoup
    at N = 1M, 10 generations, fused: exit 0, K3 once a type a
    generation, K6 once a victim type a generation, its checkpoint equal
    to a bare ``evolve_multi``'s.  To inform: generations/s of each log,
    the run with every plane off, the steady rate of 60 generations with
    the planes on, off but pipelined, and off and blocking, with their
    pipeline attribution, the time of one checkpoint write, a bare evolve
    loop, and the host synchronisations a generation of the loop (no more
    than the bare evolve's).  With ``keep_runs`` (a list) the run
    directories are kept for a later phase: their root is appended to it
    and the caller removes it."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="srnn_mega_")
    kept = False
    try:
        runs = os.path.join(root, "runs")
        reset(kernels)
        # the drills and the mixed soup, three processes at once
        got = mega_wait(root, [
            mega_start(root, "sigterm", "mega_soup",
                       MEGA_SOUP + ["--chaos", "sigterm@0", "--root",
                                    os.path.join(runs, "sigterm")]),
            mega_start(root, "device_loss", "mega_soup",
                       MEGA_SOUP + ["--chaos", "device_loss@10", "--root",
                                    os.path.join(runs, "loss")]
                       + MEGA_FAST_BACKOFF),
            mega_start(root, "multisoup", "mega_multisoup",
                       MEGA_MULTI + ["--root", os.path.join(runs, "multi")]),
        ], {"sigterm": 75, "device_loss": 3, "multisoup": 0})
        (d_term,) = [os.path.join(runs, "sigterm", d)
                     for d in os.listdir(os.path.join(runs, "sigterm"))]
        got.update(mega_wait(root, [mega_start(
            root, "resumed", "mega_soup", MEGA_SOUP + ["--resume", d_term])],
            {"resumed": 0}))
        # alone on the card: the run every other is held against, then the
        # same with every plane off
        port = _free_port()
        got.update(mega_wait(root, [mega_start(
            root, "uninterrupted", "mega_soup",
            MEGA_SOUP + ["--metrics-port", str(port), "--root",
                         os.path.join(runs, "full")])],
            {"uninterrupted": 0}))
        got.update(mega_wait(root, [mega_start(
            root, "planes_off", "mega_soup",
            MEGA_SOUP + MEGA_PLANES_OFF + ["--root",
                                           os.path.join(runs, "off")])],
            {"planes_off": 0}))
        # to inform: the loop's steady rate, six chunks with every plane
        # on and off, the first two chunks' lines left out
        steady = ["--generations", str(MEGA_STEADY)]
        got.update(mega_wait(root, [mega_start(
            root, "steady_on", "mega_soup",
            MEGA_SOUP + steady + ["--root", os.path.join(runs, "son")])],
            {"steady_on": 0}))
        got.update(mega_wait(root, [mega_start(
            root, "steady_pipe_off", "mega_soup",
            MEGA_SOUP + MEGA_PIPE_PLANES_OFF + steady
            + ["--root", os.path.join(runs, "spipe")])],
            {"steady_pipe_off": 0}))
        got.update(mega_wait(root, [mega_start(
            root, "steady_off", "mega_soup",
            MEGA_SOUP + MEGA_PLANES_OFF + steady
            + ["--root", os.path.join(runs, "soff")])], {"steady_off": 0}))
        k3 = {"generation": MEGA_GENERATIONS}
        for tag, expect in (
                ("uninterrupted", k3), ("planes_off", k3),
                ("steady_on", {"generation": MEGA_STEADY}),
                ("steady_pipe_off", {"generation": MEGA_STEADY}),
                ("steady_off", {"generation": MEGA_STEADY}),
                # 10 generations before the preemption, 10 after
                ("sigterm", {"generation": 10}),
                ("resumed", {"generation": 10}),
                # 10 before the fault, then 20 from scratch
                ("device_loss", {"generation": 10 + MEGA_GENERATIONS}),
                ("multisoup", {
                    name: MEGA_MULTI_GENERATIONS for name in (
                        "generation", "generation_kvec", "generation_rnn",
                        "rnn_apply_t14", "rnn_apply_t20", "rnn_apply")})):
            counts = check_launches(kernels, f"mega {tag}", expect,
                                    got[tag][1])
            if tag in ("uninterrupted", "multisoup"):
                for name, n in counts.items():
                    totals[name] += n
        run_dir = {tag: got[tag][0].strip().splitlines()[-1]
                   for tag in got}
        want = mega_checkpoint(torch, run_dir["uninterrupted"],
                               MEGA_GENERATIONS)
        mega_sane(torch, "mega uninterrupted", want, N)
        for tag in ("resumed", "device_loss", "planes_off"):
            mega_same(torch, f"mega {tag}", mega_checkpoint(
                torch, run_dir[tag], MEGA_GENERATIONS), want)
        if run_dir["resumed"] != d_term:
            raise AssertionError("mega resumed: another run directory")
        multi = mega_checkpoint(torch, run_dir["multisoup"],
                                MEGA_MULTI_GENERATIONS)
        mega_sane(torch, "mega multisoup", multi, N)
        # the reference: a bare evolve of the run's config from its seed
        _, state0, run = mega_bare(torch)
        mega_same(torch, "mega uninterrupted against the bare evolve",
                  want, mega_tree(run(MEGA_GENERATIONS)[0]))
        mega_same(torch, "mega multisoup against the bare evolve_multi",
                  multi, mega_tree(mega_multi_bare(torch)))
        with open(os.path.join(run_dir["uninterrupted"], "log.txt")) as f:
            text = f.read()
        for needle in ("done:", f"live on http://127.0.0.1:{port}",
                       "lineage: epoch 0"):
            if needle not in text:
                raise AssertionError(f"mega uninterrupted: log lacks "
                                     f"{needle!r}")
        log("  mega bitwise: the SIGTERM-resumed, device-loss-recovered "
            "and planes-off runs' final checkpoints equal the "
            "uninterrupted run's, and it a bare soup.evolve of its config "
            "from its seed; the mixed run's a bare evolve_multi's "
            "(weights, uids, next_uid, time, generator state)")
        for tag, (text, _, wall) in got.items():
            skip = 2 if tag.startswith("steady") else 0
            log(f"  mega {tag}: {wall:.1f} s of process, "
                f"{mega_rate(text, skip):.3f} generations/s in its chunk "
                "loop" + (" past its first two chunks" if skip else "")
                + (" (three processes at once)" if tag in
                   ("sigterm", "device_loss", "multisoup") else ""))
        for tag in ("steady_on", "steady_pipe_off", "steady_off"):
            pipe = mega_pipeline(run_dir[tag])
            log(f"  mega {tag} pipeline: {pipe['chunks']} chunks, wall "
                f"{pipe['wall_s']} s, device wait {pipe['device_wait_s']} "
                f"s, host I/O {pipe['host_io_s']} s (pipelined: the "
                f"writer's busy seconds), pipelined "
                f"{pipe.get('pipelined')}")
        ckpt_ms = mega_checkpoint_ms(torch, root, state0)
        for what, ms in ckpt_ms.items():
            log(f"  mega checkpoint of N = {N}, {what}: "
                + " / ".join(f"{t:.3f}" for t in ms) + " ms (warm page "
                "cache)")
        log(f"  mega bare soup.evolve loop, same config and carries: "
            f"{mega_bare_loop(torch):.3f} ms/generation")
        syncs = mega_syncs(torch, os.path.join(root, "syncs"))
        for what, (per_gen, per_call, where) in syncs.items():
            log(f"  mega {what} host synchronisations: {per_gen:g} a "
                f"generation, {per_call:g} a call (of 1 generation: "
                f"{where})")
        if syncs["loop"][0] > syncs["bare"][0]:
            raise AssertionError("mega loop: the run plumbing synchronises "
                                 "the host every generation")
        if keep_runs is not None:
            keep_runs.append(root)
            kept = True
    finally:
        if not kept:
            shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ analysis tier


#: the analysis phase's sizes: the hill climber's shots and rounds at scale
#: and card against CPU, the prototype fits' epochs
CLIMB_SHOTS, CLIMB_ROUNDS = 65_536, 100
SMALL_SHOTS, SMALL_ROUNDS = 64, 10
PROTO_EPOCHS = 500


def onset_recount(torch, st, cfg, state, generations):
    """The onsets of ``generations`` steps recounted: ``soup.evolve_step``
    of the probe config (removals off) one generation at a time, with
    ``is_diverged`` read after each; returns (onsets, final state)."""
    from srnn_tpu_torch.ops.predicates import is_diverged

    probe = cfg._replace(remove_divergent=False, remove_zero=False)
    onset = torch.where(is_diverged(state.weights), 0, -1).to(torch.int32)
    for _ in range(generations):
        state, _ = st.evolve_step(probe, state)
        now = is_diverged(state.weights).cpu()
        onset = torch.where((onset.cpu() < 0) & now, int(state.time),
                            onset.cpu()).to(torch.int32)
    return onset, state


def analysis_path(torch, kernels, totals, mega_runs=()):
    """Phase "analysis tier" (ROADMAP A.5): the analysis modules on the
    card.  ``utils.divergence_onset`` of the N = 1M weightwise fused soup
    (the README dynamics, removals off, one slot non-finite at the start),
    20 generations: exactly 20 K3 and no other kernel, the onsets and the
    final state bitwise equal to a recount over 20 ``soup.evolve_step``
    calls, its ms a generation beside a bare ``evolve`` of the same config
    in turns; the same at N = 64 over 5 generations card against CPU on
    the same draws, bitwise.  ``optimize.hillclimb`` of a weightwise net,
    65,536 shots x 100 rounds: no kernel, the trace monotone
    non-increasing, rounds/s; 64 shots x 10 rounds card against CPU on the
    same noise, bitwise.  ``proto.fit``, feed-forward and recurrent, 500
    epochs card against CPU, bitwise.  ``utils.checked_apply_to_weights``
    passes the identity fixpoint and raises on a pair that overflows.
    ``utils.timed`` of one fused generation (its K3 launches exact) and a
    ``utils.trace`` of one, a non-empty file.  The viz tier without
    matplotlib: the soup captured through ``utils.evolve_captured`` (20
    generations, a frame every 5) read at 2,048 strided columns and
    written as the HTML view (wall and size); ``viz.search_and_apply`` of
    that directory and of the mega phase's run directories where
    matplotlib is installed (printed whether it ran).  The K3 launches of
    the onset run, ``timed``, ``trace`` and the capture are the main
    path's; the card-against-CPU runs count none."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np

    import srnn_tpu_torch as st
    from srnn_tpu_torch import convert, optimize, proto, viz, viz_html
    from srnn_tpu_torch.soup import draw
    from srnn_tpu_torch.utils import (NonFiniteOutputError, TrajStore,
                                      checked_apply_to_weights,
                                      divergence_onset, evolve_captured,
                                      read_store_artifact, timed, trace)
    from srnn_tpu_torch.utils.trajstore import store_shape

    def main_run(what, expect, fn):
        reset(kernels)
        out = fn()
        torch.cuda.synchronize()
        for name, n in check_launches(kernels, what, expect).items():
            totals[name] += n
        return out

    g = GENERATIONS
    topo = st.Topology("weightwise")
    cfg = st.SoupConfig(topo=topo, size=N, attacking_rate=0.1,
                        learn_from_rate=0.1, learn_from_severity=1,
                        train=10, remove_divergent=True, remove_zero=True,
                        respawn_draws="fused", layout="popmajor",
                        generation_impl="fused")
    probe = cfg._replace(remove_divergent=False, remove_zero=False)
    s0 = st.seed(cfg, 11, device="cuda")
    s0 = s0._replace(weights=s0.weights.clone())
    s0.weights[0] = float("nan")
    onset, final = main_run("divergence_onset", {"generation": g},
                            lambda: divergence_onset(cfg, s0, g))
    want, ref = onset_recount(torch, st, cfg, s0, g)
    equal_ints(torch, "divergence_onset onsets against the recount",
               onset, want)
    compare(torch, "divergence_onset final weights against the recount",
            final.weights, ref.weights, ulps=0)
    for field in ("uids", "next_uid", "time"):
        equal_ints(torch, f"divergence_onset final {field} against the "
                   "recount", getattr(final, field), getattr(ref, field))
    o = onset.cpu()
    log(f"  divergence_onset N = {N}, {g} generations: launches exact "
        "(K3 once a generation), onsets and final state bitwise equal to "
        f"{g} evolve_step calls; slots dead at the start "
        f"{int((o == 0).sum())}, diverged on the way "
        f"{int((o > 0).sum())}, never {int((o < 0).sum())}")
    walls = collections.defaultdict(list)
    for run in ("onset", "bare", "onset", "bare"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "onset":
            divergence_onset(cfg, s0, g)
        else:
            st.evolve(probe, s0, g)
        torch.cuda.synchronize()
        walls[run].append((time.perf_counter() - t0) * 1e3 / g)
    log("  ms a generation in turns: divergence_onset "
        + " / ".join(f"{t:.3f}" for t in walls["onset"])
        + ", bare evolve of the same config "
        + " / ".join(f"{t:.3f}" for t in walls["bare"]))

    # card against CPU: N = 64, 5 generations, the same draws
    small = cfg._replace(size=64, attacking_rate=0.3, learn_from_rate=0.3)
    cpu0 = st.seed(small, 12, device="cpu")
    cpu0 = cpu0._replace(weights=cpu0.weights.clone())
    cpu0.weights[5] = float("inf")
    gen = torch.Generator().manual_seed(13)
    draws = [draw(small, gen, "cpu") for _ in range(5)]
    got = divergence_onset(small, convert.soup_state_from_arrays(
        cpu0.weights.numpy(), cpu0.uids.numpy(), int(cpu0.next_uid),
        int(cpu0.time), device="cuda"), 5, draws)
    want = divergence_onset(small, cpu0, 5, draws)
    equal_ints(torch, "divergence_onset N = 64 onsets card against CPU",
               got[0], want[0])
    compare(torch, "divergence_onset N = 64 final weights card against CPU",
            got[1].weights.cpu(), want[1].weights, ulps=0)
    for field in ("uids", "next_uid", "time"):
        equal_ints(torch, f"divergence_onset N = 64 final {field} card "
                   "against CPU", getattr(got[1], field),
                   getattr(want[1], field))
    o = want[0]
    log(f"  divergence_onset N = 64, 5 generations card against CPU: "
        f"bitwise (slots dead at the start {int((o == 0).sum())}, diverged "
        f"on the way {int((o > 0).sum())}, never {int((o < 0).sum())})")

    # the hill climber
    w0 = st.init_population(topo, 14, 1, device="cpu")[0]
    gen = torch.Generator(device="cuda").manual_seed(15)
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    best, trace_ = optimize.hillclimb(topo, w0.cuda(), gen, CLIMB_SHOTS,
                                      CLIMB_ROUNDS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_launches(kernels, "hillclimb", {})
    if not bool((trace_.diff() <= 0).all()):
        raise AssertionError("hillclimb: the trace rises")
    log(f"  hillclimb weightwise, {CLIMB_SHOTS} shots x {CLIMB_ROUNDS} "
        f"rounds: {CLIMB_ROUNDS / dt:.1f} rounds/s ({dt:.3f} s), loss "
        f"{float(optimize.fixpoint_loss(topo, w0)):.6g} -> "
        f"{float(trace_[-1]):.6g}, monotone non-increasing")
    noise = torch.randn((SMALL_ROUNDS, SMALL_SHOTS, topo.num_weights),
                        generator=torch.Generator().manual_seed(16))
    got = optimize.hillclimb(topo, w0.cuda(), None, SMALL_SHOTS,
                             SMALL_ROUNDS, noise=noise.numpy())
    want = optimize.hillclimb(topo, w0, None, SMALL_SHOTS, SMALL_ROUNDS,
                              noise=noise.numpy())
    compare(torch, "hillclimb best card against CPU", got[0].cpu(), want[0],
            ulps=0)
    compare(torch, "hillclimb trace card against CPU", got[1].cpu(),
            want[1], ulps=0)
    log(f"  hillclimb {SMALL_SHOTS} shots x {SMALL_ROUNDS} rounds card "
        "against CPU, the same noise: best weights and trace bitwise")

    # the prototypes
    for rec in (False, True):
        pt = proto.ProtoTopology(recurrent=rec)
        w = proto.init_proto(pt, 17, device="cpu") * 0.5
        t0 = time.perf_counter()
        got = proto.fit(pt, w.cuda(), PROTO_EPOCHS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = proto.fit(pt, w, PROTO_EPOCHS)
        what = f"proto.fit {'recurrent' if rec else 'feed-forward'}"
        compare(torch, f"{what} weights card against CPU", got[0].cpu(),
                want[0], ulps=0)
        compare(torch, f"{what} losses card against CPU", got[1].cpu(),
                want[1], ulps=0)
        log(f"  {what}, {PROTO_EPOCHS} epochs: card against CPU bitwise, "
            f"{dt:.3f} s on the card, losses {float(want[1][0]):.6g} -> "
            f"{float(want[1][-1]):.6g}")

    # checked self-application
    ident = torch.zeros(topo.num_weights, device="cuda")
    for o in topo.offsets[:-1]:
        ident[o] = 1.0
    out = checked_apply_to_weights(topo, ident, ident)
    compare(torch, "checked_apply_to_weights identity", out, ident, ulps=0)
    big = torch.full((topo.num_weights,), 1e18, device="cuda")
    try:
        checked_apply_to_weights(topo, big, big)
        raise AssertionError("checked_apply_to_weights did not raise on an "
                             "overflowing pair")
    except NonFiniteOutputError as e:
        log(f"  checked_apply_to_weights: the identity fixpoint passes, an "
            f"overflowing pair raises ({e})")

    # timed and trace
    res = main_run("timed", {"generation": 4},
                   lambda: timed(st.evolve_step, cfg, s0, iters=3,
                                 warmup=1))
    tmp = tempfile.mkdtemp(prefix="srnn_analysis_")
    try:
        tdir = os.path.join(tmp, "trace")
        with trace(tdir):
            main_run("trace", {"generation": 1},
                     lambda: st.evolve_step(cfg, s0))
        files = [os.path.join(tdir, f) for f in os.listdir(tdir)]
        sizes = [os.path.getsize(f) for f in files]
        if not files or not all(sizes):
            raise AssertionError(f"trace: files {files} sizes {sizes}")
        log(f"  timed one fused generation: median "
            f"{res['median_s'] * 1e3:.3f} ms of {res['iters']}; trace "
            f"{len(files)} file(s), {sum(sizes)} bytes")

        # the viz tier on the captured soup
        cap = os.path.join(tmp, "capture")
        os.makedirs(cap)
        path = os.path.join(cap, "soup.traj")

        def capture():
            with TrajStore(path, N, topo.num_weights) as store:
                evolve_captured(cfg, st.seed(cfg, 2, device="cuda"), g,
                                store, every=5)

        main_run("capture", {"generation": g}, capture)
        t0 = time.perf_counter()
        n_slots = store_shape(path)[0]
        art = read_store_artifact(path,
                                  columns=viz.render_columns(n_slots))
        t1 = time.perf_counter()
        out = viz_html.write_html_trajectories_3d(
            art, os.path.join(cap, "soup_trajectories_3d.html"))
        t2 = time.perf_counter()
        size = os.path.getsize(out)
        if size < 10_000 or art["weights"].shape[1] != min(
                n_slots, viz.MAX_RENDER_PARTICLES):
            raise AssertionError(f"html view: {size} bytes of "
                                 f"{art['weights'].shape} columns")
        log(f"  viz: the N = {n_slots} store read at "
            f"{art['weights'].shape[1]} strided columns in "
            f"{(t1 - t0) * 1e3:.1f} ms, {art['weights'].shape[0]} frames; "
            f"HTML view {size} bytes in {(t2 - t1) * 1e3:.1f} ms")
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        if has_mpl:
            outs = viz.search_and_apply(cap)
            for root in mega_runs:
                outs += viz.search_and_apply(os.path.join(root, "runs"))
            log(f"  viz.search_and_apply ran (matplotlib found): "
                f"{len(outs)} renders")
        else:
            log("  viz.search_and_apply did not run: matplotlib is not "
                "installed (the PNG renderers need it; the HTML view "
                "above does not)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for root in mega_runs:
            shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------ experiment service

#: the paper's traffic: soup_trajectorys' submit-mode soup (its defaults:
#: N = 20, 100 generations, train 30, attack 0.1, no learn_from, both
#: removals) and fixpoint_density's sweep (trials 100,000, batch 25,000)
SERVE_PAPER = {"size": 20, "generations": 100, "train": 30,
               "attacking_rate": 0.1, "learn_from_rate": -1.0,
               "remove_divergent": True, "remove_zero": True,
               "epsilon": 1e-4, "train_mode": "sequential"}
SERVE_DENSITY = {"trials": 100_000, "batch": 25_000, "epsilon": 1e-4}
#: the wide stack: the largest N whose state the service still returns
#: for the weightwise particle (N * P <= 262,144, 16,384 * 14)
SERVE_WIDE = {"size": 16_384, "generations": 10, "train": 10,
              "learn_from_rate": 0.1, "remove_divergent": True,
              "remove_zero": True}
SERVE_VARIANTS = {"weightwise": {}, "aggregating": {"aggregates": 4},
                  "recurrent": {}}
#: one population-major fused weightwise ticket (solo, K3)
SERVE_FUSED = dict(SERVE_WIDE, size=N, generations=5, layout="popmajor",
                   generation_impl="fused")
SERVE_SGD = {"weightwise": "ww_sgd", "aggregating": "kvec_sgd",
             "recurrent": "rnn_sgd"}


def serve_params(variant, **kw):
    return dict(SERVE_WIDE, variant=variant, **SERVE_VARIANTS[variant], **kw)


def serve_start(root, tag, *argv, counts=True):
    """Start ``python -m srnn_tpu_torch.serve`` on the card with its root
    ``root/tag`` and its output in ``root/tag.log``; with ``counts`` it
    writes its launch counts to ``root/tag.launches.json`` at exit."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("SRNN_SETUPS_PLATFORM", "SRNN_LAUNCH_COUNTS")}
    if counts:
        env["SRNN_LAUNCH_COUNTS"] = os.path.join(root, f"{tag}.launches.json")
    with open(os.path.join(root, f"{tag}.log"), "a") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "srnn_tpu_torch.serve", "--root",
             os.path.join(root, tag), *argv], cwd=here, env=env, stdout=out,
            stderr=subprocess.STDOUT)


def serve_client(root, tag, **kw):
    from srnn_tpu_torch.serve import ServiceClient

    return ServiceClient(os.path.join(root, tag, "serve.sock"), **kw)


def serve_log(root, tag) -> str:
    with open(os.path.join(root, f"{tag}.log")) as f:
        return f.read()[-3000:]


class ServeReference:
    """The bare runs each service result is held against, in this process
    on the card, made once per (kind, params, seed)."""

    def __init__(self, torch):
        self.torch = torch
        self._memo = {}

    def soup(self, params, seed):
        key = ("soup", json.dumps(params, sort_keys=True), seed)
        if key not in self._memo:
            from srnn_tpu_torch import soup as sp
            from srnn_tpu_torch.serve.service import _soup_config_from_params
            from srnn_tpu_torch.setups.common import generator

            cfg = _soup_config_from_params(params)
            final, m = sp.evolve(cfg, sp.seed(cfg, generator(seed), "cuda"),
                                 int(params["generations"]), metrics=True)
            self._memo[key] = (cfg, final, m, sp.count(cfg, final))
        return self._memo[key]

    def density(self, params, seed):
        key = ("density", json.dumps(params, sort_keys=True), seed)
        if key not in self._memo:
            from srnn_tpu_torch.engine import fixpoint_density
            from srnn_tpu_torch.setups.common import (STANDARD_VARIANTS,
                                                      population)

            out = []
            for v, (_name, topo) in enumerate(STANDARD_VARIANTS[:2]):
                total = self.torch.zeros(5, dtype=self.torch.int32,
                                         device="cuda")
                done = 0
                while done < params["trials"]:
                    n = min(params["batch"], params["trials"] - done)
                    total = total + fixpoint_density(
                        topo, population(topo, n, "cuda", seed, v, done),
                        params["epsilon"])
                    done += n
                out.append(total.tolist())
            self._memo[key] = out
        return self._memo[key]

    def check(self, what, kind, params, seed, result):
        """``result`` (a service ticket's) against the bare run: integers
        exact, weights and the loss sum at 0 ulps (raises otherwise)."""
        torch = self.torch
        if kind == "fixpoint_density":
            if result["counters"] != self.density(params, seed):
                raise AssertionError(f"{what}: counters {result['counters']}"
                                     f" != {self.density(params, seed)}")
            return
        cfg, final, m, counts = self.soup(params, seed)
        want = {"counters": counts.tolist(),
                "final_time": int(final.time),
                "next_uid": int(final.next_uid),
                "metrics": {"generations": int(m.generations),
                            "actions": m.actions.tolist()}}
        got = {k: result[k] for k in ("counters", "final_time", "next_uid")}
        got["metrics"] = {k: result["metrics"][k]
                          for k in ("generations", "actions")}
        if got != want:
            raise AssertionError(f"{what}: {got} != {want}")
        from srnn_tpu_torch.bench_kernels import check_exact

        check_exact(f"{what} loss_sum",
                    torch.tensor([result["metrics"]["loss_sum"]]),
                    m.loss_sum.reshape(1).cpu())
        if cfg.size * cfg.topo.num_weights <= 262_144:
            if "weights" not in result:
                raise AssertionError(f"{what}: the state was not returned")
            check_exact(f"{what} weights",
                        torch.tensor(result["weights"], dtype=torch.float32),
                        final.weights.float().cpu())
            if result["uids"] != final.uids.tolist():
                raise AssertionError(f"{what}: uids differ")


def serve_expected_launches(events_path, tenants) -> dict:
    """The launches the dispatches of a service's events.jsonl must make:
    per soup dispatch, K3 once a generation for a fused population-major
    spelling, else the variant's SGD kernel once a generation per phase
    on (learn_from, train), whatever the stack's width; ``tenants`` maps
    each tenant to its (kind, params)."""
    from srnn_tpu_torch.serve.service import _soup_config_from_params

    expect = collections.Counter()
    dispatches = []
    with open(events_path) as f:
        for line in f:
            row = json.loads(line)
            if row.get("kind") != "serve_dispatch" or row.get("error"):
                continue
            dispatches.append((row["mode"], len(row["tenants"])))
            kind, params = tenants[row["tenants"][0]]
            if kind != "soup":
                continue
            cfg = _soup_config_from_params(params)
            gens = int(params["generations"])
            if cfg.generation_impl == "fused":
                expect["generation"] += gens
                continue
            per_gen = int(cfg.learn_from_rate > 0
                          and cfg.learn_from_severity > 0) + int(cfg.train > 0)
            expect[SERVE_SGD[cfg.topo.variant]] += per_gen * gens
    return dict(expect), dispatches


def serve_inprocess_drills(torch, kernels, totals, ref, root):
    """The transient fault and the poisoned tenant, through an in-process
    ``ExperimentService`` on the card (the service's own admission and
    dispatch paths; launch counts exact, results bitwise)."""
    from srnn_tpu_torch.resilience.chaos import ChaosMonkey, parse_schedule
    from srnn_tpu_torch.serve import ExperimentService

    ww, agg = serve_params("weightwise"), serve_params("aggregating")
    reset(kernels)
    svc = ExperimentService(os.path.join(root, "fault"), device="cuda",
                            retry_backoff_s=0.01, chaos=ChaosMonkey(
                                parse_schedule("serve_dispatch_fault@2:io")))
    with svc:
        t_ww = [(svc.submit("soup", dict(ww, seed=s)), s)
                for s in (40, 41, 42, 43)]
        t_agg = [(svc.submit("soup", dict(agg, seed=s)), s) for s in (44, 45)]
        svc.run_pending()
        # the service's launches, read before the bare runs launch theirs
        got = check_launches(kernels, "serve fault drill (io fault at the "
                             "2nd dispatch, retried)",
                             {"ww_sgd": 20, "kvec_sgd": 20})
        for group, params in ((t_ww, ww), (t_agg, agg)):
            for t, s in group:
                e = svc.poll(t)
                if e["status"] != "done":
                    raise AssertionError(f"serve fault drill: {e}")
                ref.check(f"serve fault drill seed {s}", "soup", params, s,
                          e["result"])
        sh = svc.stats()["self_healing"]
        if sh["dispatch_retries"] != 1 or sh["quarantined"]:
            raise AssertionError(f"serve fault drill: {sh}")
    for name, n in got.items():
        totals[name] += n
    reset(kernels)
    svc = ExperimentService(os.path.join(root, "poison"), device="cuda",
                            retry_backoff_s=0.01, chaos=ChaosMonkey(
                                parse_schedule("serve_poison_tenant@2")))
    with svc:
        tickets = [(svc.submit("soup", dict(ww, seed=s)), s)
                   for s in (40, 41, 42, 43)]
        svc.run_pending()
        # the stack of 4 and its half holding the poison raise before any
        # launch; the innocent solo quarter and the last pair run
        check_launches(kernels, "serve poison drill (2nd ticket poisoned, "
                       "bisected)", {"ww_sgd": 2 * 20})
        entries = [svc.poll(t) for t, _ in tickets]
        if [e["status"] for e in entries] != ["done", "failed", "done",
                                              "done"] \
                or not entries[1].get("quarantined"):
            raise AssertionError(f"serve poison drill: {entries}")
        for (t, s), e in zip(tickets, entries):
            if e["status"] == "done":
                ref.check(f"serve poison drill seed {s}", "soup", ww, s,
                          e["result"])
    log("  serve drills in process: io fault retried once, the poisoned "
        "ticket alone quarantined, every other result bitwise")


def serve_throughput(torch, kernels, root):
    """To inform: tickets/s of the eight wide weightwise tickets through an
    in-process service at max_stack 8 against max_stack 1, in turns, and
    the device's busy share of one stacked drain (torch.profiler)."""
    from srnn_tpu_torch.profile_soup import _device_us
    from srnn_tpu_torch.serve import ExperimentService

    ww = serve_params("weightwise")

    def drain(k, tag, seeds=range(8)):
        svc = ExperimentService(os.path.join(root, tag), max_stack=k,
                                device="cuda")
        with svc:
            for s in seeds:
                svc.submit("soup", dict(ww, seed=s))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.run_pending()
            dt = time.perf_counter() - t0
        return len(seeds) / dt

    drain(8, "warm")
    rates = {8: [], 1: []}
    for i, k in enumerate((8, 1, 1, 8)):
        rates[k].append(drain(k, f"turn{i}"))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        drain(8, "traced")
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(_device_us(e) for e in prof.key_averages()) / wall_us
    log(f"  serve wide stack (8 weightwise tickets, N = 16,384, 10 "
        f"generations) tickets/s: max_stack 8 {rates[8]}, max_stack 1 "
        f"{rates[1]} (turns 8, 1, 1, 8); device busy share of one stacked "
        f"drain under torch.profiler {busy:.3f}")


def serve_path(torch, kernels, totals):
    """Phase "experiment service": ``python -m srnn_tpu_torch.serve`` on the
    card as subprocesses, driven by ``ServiceClient``.

    The main service (fixed 2 s window, max_stack 8) takes the paper's
    traffic (8 soup tickets of soup_trajectorys' config, seeds 0-7; 2
    fixpoint_density sweeps, seeds 0-1), the wide stack (8 weightwise, 4
    aggregating and 4 recurrent row-major tickets at N = 16,384, train 10,
    learn_from 0.1, both removals, 10 generations) and one
    population-major fused weightwise ticket at N = 1M (5 generations),
    and the setups ``soup_trajectorys`` and ``fixpoint_density`` as
    clients (``--service``) beside their process-mode runs.  Every result
    is held bitwise against a bare ``soup.evolve`` (``metrics=True``) or
    fixpoint-density sweep in this process; the service's launch counts
    (``SRNN_LAUNCH_COUNTS``) must be exactly its dispatches' (events.jsonl):
    per soup dispatch the SGD kernel once a generation per phase on,
    whatever the stack's width, K3 once a generation for the fused one.
    In this process: ``engine.run_fixpoint_stacked`` of 4 tenants at
    N = 65,536, 20 steps (K1 20 times, each tenant bitwise its solo run);
    the io-fault and poisoned-tenant drills.  Drills in processes, every
    result bitwise: ``--chaos serve_kill@3`` then a restart on the same
    root that replays the journal; ``--workers 2`` with worker 0 killed
    while its tickets are queued.  To inform: tickets/s of the wide stack
    at max_stack 8 against 1 in turns, p50 / p95 ticket latency, the
    device's busy share of a stacked drain."""
    import shutil
    import signal
    import tempfile

    from srnn_tpu_torch import engine
    from srnn_tpu_torch.experiment import load_artifact
    from srnn_tpu_torch.init import init_population, make_generator
    from srnn_tpu_torch.serve import read_journal
    from srnn_tpu_torch.topology import Topology

    root = tempfile.mkdtemp(prefix="srnn_serve_")
    procs = []
    ref = ServeReference(torch)
    try:
        # three services start at once while this process works
        procs.append(serve_start(root, "main", "--no-adaptive",
                                 "--batch-window-s", "2"))
        procs.append(serve_start(root, "kill", "--no-adaptive",
                                 "--batch-window-s", "1", "--chaos",
                                 "serve_kill@3", counts=False))
        procs.append(serve_start(root, "fleet", "--workers", "2",
                                 "--no-adaptive", "--batch-window-s", "2",
                                 counts=False))
        main, kill, fleet = procs

        # the stacked fixpoint engine: one K1 launch a step for 4 tenants
        ww = Topology("weightwise", width=2, depth=2)
        pops = torch.stack([init_population(ww, make_generator(t, "cuda"),
                                            65_536, "cuda")
                            for t in range(4)])
        eps = [1e-4, 1e-3, 1e-4, 1e-5]
        reset(kernels)
        run = engine.run_fixpoint_stacked(ww, pops, step_limit=20,
                                          epsilons=eps)
        torch.cuda.synchronize()
        for name, n in check_launches(kernels, "serve run_fixpoint_stacked "
                                      "(4 x 65,536, 20 steps)",
                                      {"ww_apply": 20}).items():
            totals[name] += n
        for t in range(4):
            solo = engine.run_fixpoint(ww, pops[t], step_limit=20,
                                       epsilon=eps[t])
            compare(torch, f"serve run_fixpoint_stacked tenant {t} weights",
                    run.weights[t], solo.weights, ulps=0)
            equal_ints(torch, f"serve run_fixpoint_stacked tenant {t} steps,"
                       " classes, counts", torch.cat([
                           run.steps[t], run.classes[t], run.counts[t]]),
                       torch.cat([solo.steps, solo.classes, solo.counts]))
        serve_inprocess_drills(torch, kernels, totals, ref, root)

        # the main service: every ticket of the traffic in one window
        tenants = {}
        client = serve_client(root, "main")
        client.wait_until_up(180)

        def submit(tenant, kind, params, seed):
            tenants[tenant] = (kind, params)
            return (tenant, kind, params, seed,
                    client.submit(kind, dict(params, seed=seed),
                                  tenant=tenant))

        t0 = time.perf_counter()
        subs = [submit(f"paper-soup{s}", "soup", SERVE_PAPER, s)
                for s in range(8)]
        subs += [submit(f"paper-density{s}", "fixpoint_density",
                        SERVE_DENSITY, s) for s in range(2)]
        for variant, k in (("weightwise", 8), ("aggregating", 4),
                           ("recurrent", 4)):
            subs += [submit(f"wide-{variant}{s}", "soup",
                            serve_params(variant), s) for s in range(k)]
        subs.append(submit("fused", "soup", SERVE_FUSED, 0))
        log(f"  serve main: {len(subs)} tickets admitted in "
            f"{time.perf_counter() - t0:.3f} s")
        # the setups as clients, beside their process-mode runs
        sock = os.path.join(root, "main", "serve.sock")
        tenants["soup-seed0"] = ("soup", SERVE_PAPER)
        tenants["fixpoint_density-seed0"] = ("fixpoint_density",
                                             SERVE_DENSITY)
        setups = mega_wait(root, [
            mega_start(root, f"{name}-{mode}", name,
                       ["--root", os.path.join(root, f"runs-{mode}")]
                       + (["--service", sock] if mode == "service" else []))
            for name in ("soup_trajectorys", "fixpoint_density")
            for mode in ("service", "process")],
            {f"{name}-{mode}": 0 for name in ("soup_trajectorys",
                                              "fixpoint_density")
             for mode in ("service", "process")})
        results = {tenant: client.wait(ticket, timeout_s=600)
                   for tenant, _, _, _, ticket in subs}
        for tenant, kind, params, seed, _ in subs:
            ref.check(f"serve {tenant}", kind, params, seed, results[tenant])
        log(f"  serve main: {len(subs)} tickets bitwise equal to their bare "
            f"runs; paper soup seed 0 counters "
            f"{results['paper-soup0']['counters']} (BASELINE.md: about 13 "
            f"fix_other, 7 other), fused N = 1M counters "
            f"{results['fused']['counters']}")
        stats = client.stats()
        client.shutdown()
        if main.wait(timeout=120) != 0:
            raise AssertionError("serve main: exit code "
                                 f"{main.returncode}\n"
                                 + serve_log(root, "main"))
        for name in ("soup_trajectorys", "fixpoint_density"):
            dirs = {mode: setups[f"{name}-{mode}"][0].strip().splitlines()[-1]
                    for mode in ("service", "process")}
            a = load_artifact(os.path.join(dirs["service"], "all_counters"))
            b = load_artifact(os.path.join(dirs["process"], "all_counters"))
            if not (np_equal(a, b)):
                raise AssertionError(f"serve setup {name}: counters {a} "
                                     f"!= {b}")
            with open(os.path.join(dirs["service"], "config.json")) as f:
                mode = json.load(f)["execution_mode"]
            if mode != "service":
                raise AssertionError(f"serve setup {name}: {mode}")
            if name == "soup_trajectorys":
                fin = load_artifact(os.path.join(dirs["service"],
                                                 "soup_final"))
                hist = load_artifact(os.path.join(dirs["process"], "soup"))
                compare(torch, "serve setup soup_trajectorys final weights "
                        "against the process run's last frame",
                        torch.from_numpy(fin["weights"]),
                        torch.from_numpy(hist["weights"][-1]), ulps=0)
                if not np_equal(fin["uids"], hist["uids"][-1]):
                    raise AssertionError("serve setup soup_trajectorys: "
                                         "uids differ")
        log("  serve setups: soup_trajectorys and fixpoint_density "
            "--service artifacts equal to their process-mode runs, "
            "execution_mode service")
        expect, dispatches = serve_expected_launches(
            os.path.join(root, "main", "events.jsonl"), tenants)
        with open(os.path.join(root, "main.launches.json")) as f:
            got = check_launches(kernels, "serve main service process",
                                 expect, json.load(f))
        for name, n in got.items():
            totals[name] += n
        log(f"  serve main dispatches (mode, K): {dispatches}")
        lat = sorted(row["latency_s"] for row in map(json.loads, open(
            os.path.join(root, "main", "events.jsonl")))
            if row.get("kind") == "serve_tenant")
        log(f"  serve main ticket latency p50 {lat[len(lat) // 2]:.4f} s, "
            f"p95 {lat[int(0.95 * (len(lat) - 1))]:.4f} s over {len(lat)} "
            f"tickets (a 2 s fixed window; to inform); "
            f"slo {stats['slo']}")

        # kill -9 at the 3rd dispatch attempt, then a restart that replays
        kc = serve_client(root, "kill")
        kc.wait_until_up(180)
        small = dict(SERVE_DENSITY, trials=4096, batch=4096)
        for s in (0, 1):   # dispatches 1 and 2
            ref.check(f"serve kill drill density {s}", "fixpoint_density",
                      small, s, kc.request("fixpoint_density",
                                           dict(small, seed=s)))
        wwp = serve_params("weightwise")
        doomed = [(kc.submit("soup", dict(wwp, seed=s),
                             idempotency_key=f"kill-{s}"), s)
                  for s in (50, 51, 52, 53)]
        if kill.wait(timeout=120) != -signal.SIGKILL:
            raise AssertionError(f"serve kill drill: rc {kill.returncode}")
        unfinished, _, _ = read_journal(os.path.join(root, "kill",
                                                     "journal.jsonl"))
        if [e.ticket for e in unfinished] != [t for t, _ in doomed]:
            raise AssertionError(f"serve kill drill: journal {unfinished}")
        procs.append(serve_start(root, "kill", "--no-adaptive",
                                 "--batch-window-s", "0.05", counts=False))
        kc = serve_client(root, "kill", retries=5, backoff_base_s=0.2)
        kc.wait_until_up(180)
        if kc.submit("soup", dict(wwp, seed=50),
                     idempotency_key="kill-50") != doomed[0][0]:
            raise AssertionError("serve kill drill: the resubmit did not "
                                 "dedupe onto the journaled ticket")
        for t, s in doomed:
            ref.check(f"serve kill drill replayed seed {s}", "soup", wwp, s,
                      kc.wait(t, timeout_s=600))
        if kc.stats()["self_healing"]["replayed"] != 4:
            raise AssertionError("serve kill drill: replay count")
        kc.shutdown()
        if procs[-1].wait(timeout=120) != 0:
            raise AssertionError("serve kill drill: restart exit code")
        log("  serve kill drill: SIGKILL at the 3rd dispatch, 4 journaled "
            "tickets replayed after the restart, bitwise")

        # the fleet: worker 0 killed while its tickets are queued
        fc = serve_client(root, "fleet", retries=5, backoff_base_s=0.2)
        fc.wait_until_up(240)
        fleet_t = [(fc.submit("soup", dict(wwp, seed=s), tenant=tenant,
                              idempotency_key=f"fleet-{s}"), s)
                   for tenant, seeds in (("ta", (60, 61, 62, 63)),
                                         ("tb", (64, 65, 66, 67)))
                   for s in seeds]
        st = fc.stats()
        os.kill(st["fleet"]["w0"]["pid"], signal.SIGKILL)
        for t, s in fleet_t:
            ref.check(f"serve fleet seed {s}", "soup", wwp, s,
                      fc.wait(t, timeout_s=600))
        st = fc.stats()["front"]
        if st["deaths"] != 1 or st["workers"] != 1 or st["replayed"] < 1:
            raise AssertionError(f"serve fleet: {st}")
        fc.shutdown()
        if fleet.wait(timeout=120) != 0:
            raise AssertionError("serve fleet: exit code "
                                 f"{fleet.returncode}\n"
                                 + serve_log(root, "fleet"))
        log(f"  serve fleet: worker 0 killed with its tickets queued, "
            f"{st['replayed']} replayed onto worker 1, all 8 bitwise")
        serve_throughput(torch, kernels, root)
    except BaseException:
        for tag in ("main", "kill", "fleet"):
            if os.path.exists(os.path.join(root, f"{tag}.log")):
                log(f"--- serve {tag} log tail:\n{serve_log(root, tag)}")
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


def np_equal(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    phase("compact phases", compact_path, torch, kernels, launches)
    phase("trajectory capture", capture_path, torch, kernels, launches)
    phase("device telemetry", telemetry_path, torch, kernels, launches)
    mega_runs = []
    phase("mega runs", mega_path, torch, kernels, launches, mega_runs)
    phase("analysis tier", analysis_path, torch, kernels, launches,
          mega_runs)
    phase("experiment service", serve_path, torch, kernels, launches)
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
