"""Time versions of the recurrent BPTT kernels side by side on the card.

    python -m srnn_tpu_torch.bench_rnn [--variant LABEL=DIR ...]
        [--size 1000000] [--rounds 3] [--reps 10]

Builds K5 (``csrc/rnn_train.cu``) and K3's recurrent bodies
(``csrc/generation_rnn.cu``, ``generation_rnn_bf16.cu``) from each
variant's source directory ``DIR`` with the package's nvcc flags, one nvcc
per source, all at once.  ``DIR`` may hold another commit's sources
(``git archive <commit> srnn_tpu_torch/csrc``), so that two versions are
compared in turns on one card.  Without ``--variant`` it times the
package's own sources.

Each variant's outputs are held against the plain versions on the same
inputs: weights and dead masks bitwise equal where finite with the same
non-finite pattern, the mean loss within 1 ulp.  Then, in each of
``--rounds`` rounds, the variants in turn: K5 self-training 10 epochs, and
K3's recurrent body in float32 and bfloat16 at the soup's gates (attack
0.1, learn_from 0.1, severity 1, train 10, both removals) and with no
attack and no learn operand (train only), each the median of ``--reps``
CUDA-event timings.  Prints the card and its power limit, then one JSON
line per variant: ptxas' registers, stack frame, spills and shared memory
per block of the linear instantiations, the resident blocks and warps per
SM those admit, and each time per round.  Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import math
import re
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

import torch

from . import Topology
from .init import fresh_lanes
from .ops import _build
from .ops import cuda_generation as cg
from .ops import cuda_rnn_train as crt

SOURCES = ("rnn_train", "generation_rnn", "generation_rnn_bf16")

# One H100 SM (CUDA occupancy rules for compute capability 9.0): registers
# in four partitions of 16,384, allocated per warp in units of 256; 228 KB
# of shared memory, 1 KB of it reserved per block; 64 warps, 32 blocks.
PARTITION_REGS, PARTITIONS, REG_UNIT = 16384, 4, 256
SM_SMEM, BLOCK_SMEM_RESERVED = 233472, 1024
MAX_WARPS, MAX_BLOCKS = 64, 32


class Variant(NamedTuple):
    label: str
    csrc: Path


def parse_variant(spec: str) -> Variant:
    label, _, src = spec.partition("=")
    if not label or not src:
        raise argparse.ArgumentTypeError(
            f"--variant {spec!r}: expected LABEL=DIR")
    return Variant(label, Path(src).resolve())


def build(variants: List[Variant]) -> Dict[str, Dict[str, Path]]:
    """Compile every (variant, source), all nvcc processes at once; returns
    label -> source -> library (its ptxas report beside it, ``.log``; its
    nvcc seconds in ``.seconds``)."""
    jobs, libs = [], {}
    t0 = time.time()
    for v in variants:
        out = _build.BUILD_DIR / "variants" / v.label
        out.mkdir(parents=True, exist_ok=True)
        libs[v.label] = {}
        for name in SOURCES:
            lib = out / f"{name}.so"
            lib.unlink(missing_ok=True)
            log = open(out / f"{name}.log", "w")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(v.csrc),
                   "-o", str(lib), str(v.csrc / f"{name}.cu")]
            jobs.append((v.label, name, lib, log,
                         subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT)))
            libs[v.label][name] = lib
    failed = []
    for label, name, lib, log, proc in jobs:
        rc = proc.wait()
        log.close()
        lib.with_suffix(".seconds").write_text(
            f"{Path(log.name).stat().st_mtime - t0:.1f}")
        if rc != 0:
            failed.append(f"{label}/{name}.cu (nvcc rc {rc}):\n"
                          + Path(log.name).read_text()[-3000:])
    if failed:
        raise RuntimeError("variant build failed:\n" + "\n".join(failed))
    return libs


def ptxas_entries(report: str) -> Dict[str, dict]:
    """Per entry function of a ptxas -v report: registers, shared memory
    per block, stack frame and spilled bytes."""
    entries, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w.$]+)", line)
        if m:
            cur = entries.setdefault(m.group(1), {"smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)),
                       spill=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return entries


def resident_blocks(regs: int, smem: int, threads: int) -> int:
    """Blocks of ``threads`` that one SM holds at ``regs`` registers a
    thread and ``smem`` bytes of static shared memory a block."""
    warps = threads // 32
    per_warp = math.ceil(regs * 32 / REG_UNIT) * REG_UNIT
    by_regs = PARTITIONS * (PARTITION_REGS // per_warp) // warps
    by_smem = SM_SMEM // (smem + BLOCK_SMEM_RESERVED) if smem else MAX_BLOCKS
    return min(by_regs, by_smem, MAX_WARPS // warps, MAX_BLOCKS)


def linear_resources(log: Path, threads: int = 128) -> dict:
    """ptxas' numbers for the linear-activation (width 2, depth 2)
    instantiations of one library, and the residency they admit."""
    ents = {k: e for k, e in ptxas_entries(log.read_text()).items()
            if "Li2ELi2ELi0E" in k and "regs" in e}
    regs = max(e["regs"] for e in ents.values())
    smem = max(e["smem"] for e in ents.values())
    blocks = resident_blocks(regs, smem, threads)
    return {"registers": regs, "smem_bytes": smem,
            "stack_bytes": max(e.get("stack", 0) for e in ents.values()),
            "spill_bytes": sum(e.get("spill", 0) for e in ents.values()),
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}


def install(libs: Dict[str, Path]) -> None:
    """Make the wrappers launch these libraries (``_build.load``'s cache)."""
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.srnn_error_string.argtypes = [ctypes.c_int]
        lib.srnn_error_string.restype = ctypes.c_char_p
        _build._LOADED[name] = lib


def ordered(t: torch.Tensor) -> torch.Tensor:
    """float32 bit patterns mapped to integers in the floats' order (-0 and
    +0 both to 0), so that a difference counts ulps."""
    b = t.float().contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


def same_nonfinite(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """NaN where the other has NaN, Inf of the same sign where it has Inf,
    finite where it is finite."""
    got, ref = got.float(), ref.float()
    return bool(((torch.isnan(got) == torch.isnan(ref))
                 & (torch.isfinite(got) == torch.isfinite(ref))
                 & ((got == ref) | ~torch.isinf(ref))).all())


def max_ulps(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Largest distance in float32 ulps over the entries finite in both
    (bfloat16 values compare as the float32 they widen to exactly)."""
    fin = torch.isfinite(got.float()) & torch.isfinite(ref.float())
    if not bool(fin.any()):
        return 0
    return int((ordered(got) - ordered(ref)).abs()[fin].max())


def check_exact(what: str, got, ref, ulps: int = 0) -> None:
    """Raise unless ``got`` has ``ref``'s non-finite pattern and lies within
    ``ulps`` of it where finite (0: bitwise; -0 equals +0 only by value,
    so a sign-of-zero difference counts as 0 ulps)."""
    d = max_ulps(got, ref)
    if not same_nonfinite(got, ref) or d > ulps:
        raise AssertionError(f"{what}: {d} ulps (allowed {ulps}), non-finite"
                             f" pattern equal {same_nonfinite(got, ref)}")


def timed_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up
    run."""
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


def cases(n: int) -> Dict[str, tuple]:
    """name -> (kernel run, plain run, output kinds): the timed calls."""
    topo = Topology("recurrent", width=2, depth=2)
    gen = torch.Generator(device="cuda").manual_seed(4)

    def pop():
        return (fresh_lanes(topo, gen, n, "fused", "cuda") * 0.5).contiguous()

    w, other = pop(), pop()
    w[16, 0] = float("inf")
    has_attacker = torch.rand(n, generator=gen, device="cuda") < 0.1
    atk_idx = torch.randint(0, n, (n,), generator=gen, device="cuda")
    learn_gate = torch.rand(n, generator=gen, device="cuda") < 0.1
    tgt = torch.randint(0, n, (n,), generator=gen, device="cuda")
    fresh = pop()
    kw = dict(severity=1, train=10, lr=0.01, remove_divergent=True,
              remove_zero=True, epsilon=1e-4)
    out = {
        "k5_train10": (lambda: crt.rnn_train_epochs(topo, w, 10),
                       lambda: crt.rnn_sgd_plain(topo, w, None, 10, 0.01)),
        "k5_learn1": (lambda: crt.rnn_learn_epochs(topo, w, other, 1),
                      lambda: crt.rnn_sgd_plain(topo, w, other, 1, 0.01)),
    }
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        wd = w.to(dtype)
        att = wd[:, atk_idx]
        gated = dict(attackerT=att, has_attacker=has_attacker,
                     otherT=wd[:, tgt], other_attackerT=att[:, tgt],
                     other_attacked=has_attacker[tgt], learn_gate=learn_gate)
        for gates, ops in (("gates", gated), ("train_only", {})):
            out[f"k3_{tag}_{gates}"] = (
                lambda wd=wd, ops=ops: cg.generation_popmajor(
                    topo, wd, fresh, **ops, **kw),
                lambda wd=wd, ops=ops: cg.generation_popmajor_plain(
                    topo, wd, fresh, **ops, **kw))
    return out


def check(label: str, runs: Dict[str, tuple], refs: Dict[str, tuple]) -> None:
    for name, (fn, _) in runs.items():
        got, ref = fn(), refs[name]
        check_exact(f"{label} {name} weights", got[0], ref[0])
        check_exact(f"{label} {name} loss", got[1], ref[1], ulps=1)
        for g, r in zip(got[2:], ref[2:]):
            if not torch.equal(g, r):
                raise AssertionError(f"{label} {name}: dead masks differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", type=parse_variant, action="append",
                    default=[], help="LABEL=DIR")
    ap.add_argument("--size", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_rnn needs a CUDA card")
    variants = args.variant or [Variant("tree", _build.CSRC_DIR)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    libs = build(variants)
    runs = cases(args.size)
    refs = {name: plain() for name, (_, plain) in runs.items()}
    results = {}
    for v in variants:
        install(libs[v.label])
        check(v.label, runs, refs)
        results[v.label] = {
            "label": v.label, "csrc": str(v.csrc),
            "card": smi, "bitwise": True,
            "ptxas": {name: {**linear_resources(path.with_suffix(".log")),
                             "nvcc_s": float(path.with_suffix(
                                 ".seconds").read_text())}
                      for name, path in libs[v.label].items()},
            "ms": {name: [] for name in runs if name != "k5_learn1"}}
    for _ in range(args.rounds):
        for v in variants:
            install(libs[v.label])
            for name, times in results[v.label]["ms"].items():
                times.append(timed_ms(runs[name][0], args.reps))
    for v in variants:
        print(json.dumps(results[v.label]), flush=True)
    _build._LOADED.clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
