"""Time versions of the hand-written kernels side by side on the card.

    python -m srnn_tpu_torch.bench_kernels [--variant LABEL=DIR ...]
        [--group ww|rnn|kvec ...] [--size 1000000] [--rounds 3] [--reps 10]
        [--sass-only]

Builds the kernels of each ``--group`` from each variant's source directory
``DIR`` with the package's nvcc flags, one nvcc per library, all at once:
``ww`` is K1 (``csrc/ww_apply.cu``), K2 (``ww_train.cu``) and K3's
weightwise bodies (``generation.cu``, ``generation_bf16.cu``), and also K1,
K2 and both K3 bodies built for the weightwise topologies of ``WW_WIDE``
(width 3 / depth 3, linear: ``k1w3d3_*``, ``k2w3d3_*``, ``k3www3d3_*``);
``rnn`` is
K5 (``rnn_train.cu``) and K3's recurrent bodies (``generation_rnn.cu``,
``generation_rnn_bf16.cu``), and also K5 and K3's float32 body built for
the recurrent topologies of ``RNN_WIDE`` (their ``kernel_build`` macros,
linear; the wrappers launch them under the build's tag), of which width 3
/ depth 3 is run and the others only compiled for ptxas and the SASS
census; ``kvec`` is K4 (``kvec_train.cu``), K3's
k-vector bodies (``generation_kvec.cu``, ``generation_kvec_bf16.cu``) and K6
(``rnn_apply.cu``), and also K4 and K3's float32 k-vector body built for
the topologies of ``KVEC_WIDE`` (width 3 / depth 3 with 4 aggregates and
width 2 / depth 2 with 6, linear, average and fft: ``k4w3d3k4{avg,fft}_*``,
``k3kvecw3d3k4{avg,fft}_*``, ``k4w2d2k6avg_*``, ...).  ``DIR`` may hold
another commit's sources
(``git archive <commit> srnn_tpu_torch/csrc``), so that two versions are
compared in turns on one card.  Without ``--variant`` it times the
package's own sources; without ``--group``, every group.

Each variant's outputs are held against the plain versions on the same
inputs, bitwise: weights, the mean loss and the attack's output equal
where finite with the same non-finite pattern, dead masks equal.  Then,
in each of ``--rounds`` rounds, the variants in turn, each time the median
of ``--reps`` CUDA-event timings (20 times as many for K3's short launches),
K1's and K3's with the SM clock and the power draw that ``nvidia-smi``
sampled meanwhile: K1 at steps 2000 on damped glorot lanes (at width 3 /
depth 3 at steps 1, a ``run_fixpoint`` step, and 50); K2 and K5
self-training 10 epochs and 1 (a ``run_training`` epoch); K2's shuffled
instantiation self-training 10 epochs and 1 and imitating 1 in random
per-lane sample orders (``k2s``, where a
variant's ``ww_train.cu`` has it); K3's bodies in float32 and bfloat16 on
``chip_smoke.py``'s inputs (glorot lanes, 100 forced divergent and 100
forced zero, attack 0.1, learn_from 0.1, severity 1, train 10, both
removals) and with no attack and no learn operand (train only), the
k-vector bodies on aggregating (average) and fft particles; K4
self-training 10 epochs (the soups' train phase) and 1 (a ``run_training``
epoch) and imitating 1 (the learn phase), an Inf and a NaN weight among
glorot lanes; K6 on victims of length T = 14, 17 and 20 (weightwise,
recurrent and aggregating lanes); K5 self-training 10 epochs and
imitating 1 and K3's recurrent float32 body, as above, at width 3 / depth
3; K3's
weightwise float32 body on the operands of one generation of the
N-particle weightwise soup (seeded, five generations in), launched as the
others and in the soup itself (the median of ten of the soup's own
launches, the glue kernels between them); and the soup's milliseconds a
generation over 20 generations (host clock, ending in a synchronise).
Each kernel timing brackets one call of the wrapper after a synchronise,
as ``chip_smoke.py`` times, so it also counts the host's time in the
wrapper before the launch; K2 to K5 are also timed ``_streamed``, 200
calls enqueued between one pair of events, which hides it where the
kernel takes longer than the wrapper's host work (K6 only so); and K1 to K6
``_device``, the mean of the kernel launches' own durations under
``torch.profiler`` (CUPTI), which are device times for any kernel length.
The ``kvec`` group also runs K3's aggregating float32 body on one
generation's operands of the aggregating soup, in that soup, and the soup's
milliseconds a generation, as ``ww`` does for the weightwise ones.

Prints the card and its power limit, then one JSON line per variant: for
each library (``source`` for a default build, ``source[tag]`` for another),
ptxas' registers, stack frame, spills and shared memory per block of the
linear instantiations (for the k-vector sources the linear average ones;
every kernel of a build off the default one) and the resident blocks and
warps per SM those admit, over the library, per kernel template and per
instantiation; the local memory of each instantiation's PTX (nvcc
``-ptx -lineinfo``, the library's flags otherwise): the depot's bytes, which
ptxas reports as the stack frame, and its local loads and stores by the
source line they come from (``ptx_locals``); the
SASS census of those instantiations (``cuobjdump -sass``: instructions,
FMUL, FADD, FFMA, MOV, local loads and stores), a digest of the whole
library's SASS (the anonymous namespace's hash masked, so that two builds
of the same code agree) and one per kernel template (``ww_sgd_kernel``,
``ww_sgd_shuffled_kernel``, ...), so that a source that gains a kernel
shows its other kernels' SASS unchanged; then each time per round.  With
``--sass-only`` it builds and prints those reports only, no check and no
timing.  Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import datetime
import hashlib
import json
import math
import re
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import torch

from . import Topology
from .init import fresh_lanes
from .ops import _build
from .ops import cuda_generation as cg
from .ops import cuda_kvec_train as ck
from .ops import cuda_rnn_apply as cra
from .ops import cuda_rnn_train as crt
from .ops import cuda_ww as cw
from .ops import cuda_ww_train as cwt
from .ops.cuda_sgd_common import kernel_build

GROUPS = {
    "ww": ("ww_apply", "ww_train", "generation", "generation_bf16"),
    "rnn": ("rnn_train", "generation_rnn", "generation_rnn_bf16"),
    "kvec": ("kvec_train", "generation_kvec", "generation_kvec_bf16",
             "rnn_apply"),
}

#: the weightwise topologies (width, depth) off the default build whose K2
#: and K3 float32 and bfloat16 bodies the ``ww`` group also builds and
#: runs, linear: width 3 / depth 3, the rolled epoch's build
WW_WIDE = ((3, 3),)

#: the k-vector topologies (width, depth, aggregates) off the default build
#: whose K4 and K3 float32 body the ``kvec`` group also builds and runs,
#: linear, once per reduce kind of ``KVEC_WIDE_KINDS``: width 3 / depth 3
#: with 4 aggregates (P = 42) and width 2 / depth 2 with 6 (P = 28), whose
#: last segment is longer than the others
KVEC_WIDE = ((3, 3, 4), (2, 2, 6))
#: reduce kind of the KVEC_WIDE builds -> (variant, its short name in a case)
KVEC_WIDE_KINDS = {"average": ("aggregating", "avg"), "fft": ("fft", "fft")}

#: the recurrent topologies (width, depth) off the default build whose K5
#: and K3 float32 body the ``rnn`` group also builds, linear: width 3 /
#: depth 3, which its cases run, and for ptxas and the SASS census only
#: width 2 / depth 6, width 4 / depth 2 and the fence, width 7 / depth 1
RNN_WIDE = ((3, 3), (2, 6), (4, 2), (7, 1))

# One H100 SM (CUDA occupancy rules for compute capability 9.0): registers
# in four partitions of 16,384, allocated per warp in units of 256; 228 KB
# of shared memory, 1 KB of it reserved per block; 64 warps, 32 blocks.
PARTITION_REGS, PARTITIONS, REG_UNIT = 16384, 4, 256
SM_SMEM, BLOCK_SMEM_RESERVED = 233472, 1024
MAX_WARPS, MAX_BLOCKS = 64, 32
#: mangled-name fragment of the width-2 / depth-2 / linear instantiations,
#: and of the k-vector kernels' aggregates-4 / linear / average ones
LINEAR = "Li2ELi2ELi0E"
KVEC_LINEAR = "Li2ELi2ELi4ELi0ELi0E"
#: threads a block of every kernel (``csrc/lane_common.cuh``: kThreads)
THREADS = 128
#: SASS opcodes the census counts
CENSUS = ("FMUL", "FADD", "FFMA", "MOV", "LDL", "STL")
#: nvcc flags of the PTX that ``ptx_locals`` reads: the libraries' code
#: generation (``_build.NVCC_FLAGS``) stopped at PTX, with source lines
PTX_FLAGS = ("-arch=compute_90a", "-std=c++17", "-O3", "--fmad=false",
             "-ptx", "-lineinfo")

K1_STEPS = 2000
SOUP_GENERATIONS = 5
#: calls enqueued between one pair of events (streamed_ms)
STREAMED = 200
#: calls traced for their kernels' durations (device_ms)
TRACED = 50
#: the port's kernels, by a part of the name the profiler gives them
KERNEL_NAMES = ("ww_apply_kernel", "ww_sgd_kernel", "ww_sgd_shuffled_kernel",
                "generation_kernel",
                "kvec_sgd_kernel", "rnn_sgd_kernel", "rnn_apply_kernel")


class Variant(NamedTuple):
    label: str
    csrc: Path


def parse_variant(spec: str) -> Variant:
    label, _, src = spec.partition("=")
    if not label or not src:
        raise argparse.ArgumentTypeError(
            f"--variant {spec!r}: expected LABEL=DIR")
    return Variant(label, Path(src).resolve())


def kvec_wide_topos():
    """(short name, topology) of each ``KVEC_WIDE`` build: ``w3d3k4avg``,
    ``w3d3k4fft``, ``w2d2k6avg``, ..."""
    return [(f"w{w}d{d}k{k}{short}",
             Topology(variant, width=w, depth=d, aggregates=k))
            for w, d, k in KVEC_WIDE
            for variant, short in KVEC_WIDE_KINDS.values()]


def jobs_for(groups) -> List[Tuple[str, _build.Build]]:
    """The (source, build) jobs of ``groups``: each source's default build,
    for ``ww`` the builds of ``WW_WIDE`` (and K1's, which its cases run at
    steps 1 and 50), for ``rnn`` those of ``RNN_WIDE`` and for ``kvec``
    those of ``KVEC_WIDE``."""
    jobs = [(name, _build.DEFAULT) for g in groups for name in GROUPS[g]]
    if "ww" in groups:
        for w, d in WW_WIDE:
            b = kernel_build(Topology("weightwise", width=w, depth=d))
            jobs += [(name, b) for name in GROUPS["ww"]]
    if "rnn" in groups:
        for w, d in RNN_WIDE:
            b = kernel_build(Topology("recurrent", width=w, depth=d))
            jobs += [("rnn_train", b), ("generation_rnn", b)]
    if "kvec" in groups:
        for _, topo in kvec_wide_topos():
            b = ck.kvec_build(topo)
            jobs += [("kvec_train", b), ("generation_kvec", b)]
    return jobs


def job_key(name: str, b: _build.Build) -> str:
    """A library's name in the report: the source for its default build,
    ``source[tag]`` for another (``chip_smoke.py``'s row names)."""
    return name if b == _build.DEFAULT else f"{name}[{b.tag}]"


def build(variants: List[Variant], jobs) -> Dict[str, Dict[tuple, Path]]:
    """Compile every (variant, job), all nvcc processes at once, each build
    with its ``-D`` macros and generated headers; returns label ->
    (source, build) -> library (its ptxas report beside it, ``.log``; its
    nvcc seconds in ``.seconds``; its PTX with source lines, ``.ptx``)."""
    procs, libs = [], {}
    t0 = time.time()
    for v in variants:
        out = _build.BUILD_DIR / "variants" / v.label
        out.mkdir(parents=True, exist_ok=True)
        libs[v.label] = {}
        for name, b in jobs:
            stem = name if b == _build.DEFAULT else f"{name}-{b.tag}"
            lib = out / f"{stem}.so"
            lib.unlink(missing_ok=True)
            log = open(out / f"{stem}.log", "w")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(v.csrc)]
            if b.headers:
                inc = out / f"{stem}.include"
                inc.mkdir(exist_ok=True)
                for fname, text in b.headers:
                    (inc / fname).write_text(text)
                cmd += ["-I", str(inc)]
            cmd += [f"-D{k}={val}" for k, val in b.defines]
            procs.append((v.label, job_key(name, b), lib, log,
                          subprocess.Popen(cmd + ["-o", str(lib),
                                                  str(v.csrc / f"{name}.cu")],
                                           stdout=log,
                                           stderr=subprocess.STDOUT)))
            ptx = [cmd[0], *PTX_FLAGS, *cmd[1 + len(_build.NVCC_FLAGS):],
                   "-o", str(lib.with_suffix(".ptx")),
                   str(v.csrc / f"{name}.cu")]
            procs.append((v.label, job_key(name, b) + " (ptx)", lib, None,
                          subprocess.Popen(ptx, stdout=subprocess.DEVNULL,
                                           stderr=subprocess.DEVNULL)))
            libs[v.label][(name, b)] = lib
    failed = []
    for label, key, lib, log, proc in procs:
        rc = proc.wait()
        if log is None:  # the PTX of a library: ptx_locals reads it if any
            continue
        log.close()
        lib.with_suffix(".seconds").write_text(
            f"{Path(log.name).stat().st_mtime - t0:.1f}")
        if rc != 0:
            failed.append(f"{label}/{key} (nvcc rc {rc}):\n"
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


def ptx_locals(ptx: str) -> Dict[str, dict]:
    """Per entry function of a PTX listing that uses local memory: the
    bytes of its local depot (the arrays the compiler kept in memory, which
    ptxas reports as its stack frame), and its local loads and stores by
    the source line (``file:line``, from ``-lineinfo``) they were compiled
    from, innermost inlined line first."""
    files, out, entry, line = {}, {}, None, "?"
    for text in ptx.splitlines():
        m = re.match(r'\s*\.file\s+(\d+)\s+"([^"]+)"', text)
        if m:
            files[m.group(1)] = Path(m.group(2)).name
            continue
        m = re.match(r"\s*(?:\.visible\s+|\.weak\s+)?\.entry\s+([\w.$]+)",
                     text)
        if m:
            entry = {"depot_bytes": 0, "ld": 0, "st": 0, "lines": {}}
            out[m.group(1)] = entry
            continue
        if entry is None:
            continue
        m = re.search(r"__local_depot\d+\[(\d+)\]", text)
        if m:
            entry["depot_bytes"] += int(m.group(1))
            continue
        m = re.match(r"\s*\.loc\s+(\d+)\s+(\d+)", text)
        if m:
            line = f"{files.get(m.group(1), m.group(1))}:{m.group(2)}"
            continue
        m = re.search(r"\b(ld|st)\.local\b", text)
        if m:
            entry[m.group(1)] += 1
            counts = entry["lines"].setdefault(line, {"ld": 0, "st": 0})
            counts[m.group(1)] += 1
    return {k: e for k, e in out.items()
            if e["depot_bytes"] or e["ld"] or e["st"]}


def resident_blocks(regs: int, smem: int, threads: int) -> int:
    """Blocks of ``threads`` that one SM holds at ``regs`` registers a
    thread and ``smem`` bytes of static shared memory a block."""
    warps = threads // 32
    per_warp = math.ceil(regs * 32 / REG_UNIT) * REG_UNIT
    by_regs = PARTITIONS * (PARTITION_REGS // per_warp) // warps
    by_smem = SM_SMEM // (smem + BLOCK_SMEM_RESERVED) if smem else MAX_BLOCKS
    return min(by_regs, by_smem, MAX_WARPS // warps, MAX_BLOCKS)


def census_fragment(source: str, b: _build.Build = _build.DEFAULT) -> str:
    """The mangled-name fragment of the instantiations that the census and
    the resource report of ``csrc/<source>.cu``'s build ``b`` cover: every
    kernel of a build off the default one (it holds one activation)."""
    if b != _build.DEFAULT:
        return ""
    return KVEC_LINEAR if "kvec" in source else LINEAR


def dynamic_smem(lib: Path) -> int:
    """Bytes of dynamic shared memory a block of the library's kernels
    launches with, which ptxas does not report: K3's per-thread columns
    (the recurrent BPTT's checkpointed path, the weightwise body's rolled
    builds), as the library gives them (``srnn_rnn_column_floats``,
    ``srnn_ww_column_floats``, ``..._bf16``), else none."""
    h = ctypes.CDLL(str(lib))
    for symbol in ("srnn_rnn_column_floats", "srnn_rnn_column_floats_bf16",
                   "srnn_ww_column_floats", "srnn_ww_column_floats_bf16"):
        if hasattr(h, symbol):
            return getattr(h, symbol)() * THREADS * 4
    return 0


def _resources(ents: Dict[str, dict], threads: int, dynamic: int) -> dict:
    """ptxas' numbers over the entries ``ents`` and the residency they
    admit with ``dynamic`` bytes of dynamic shared memory a block beside
    the static."""
    regs = max(e["regs"] for e in ents.values())
    smem = max(e["smem"] for e in ents.values())
    blocks = resident_blocks(regs, smem + dynamic, threads)
    return {"registers": regs, "smem_bytes": smem,
            "dynamic_smem_bytes": dynamic,
            "stack_bytes": max(e.get("stack", 0) for e in ents.values()),
            "spill_bytes": sum(e.get("spill", 0) for e in ents.values()),
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}


def _entries(log: Path, frag: str) -> Dict[str, dict]:
    return {k: e for k, e in ptxas_entries(log.read_text()).items()
            if frag in k and "regs" in e}


def linear_resources(log: Path, frag: str = LINEAR, threads: int = THREADS,
                     dynamic: int = 0) -> dict:
    """ptxas' numbers for the instantiations of one library whose names
    hold ``frag`` (the linear-activation, width 2, depth 2 ones), and the
    residency they admit with ``dynamic`` bytes of dynamic shared memory a
    block beside the static."""
    return _resources(_entries(log, frag), threads, dynamic)


def resources_by_kernel(log: Path, frag: str = LINEAR,
                        dynamic: int = 0) -> Dict[str, dict]:
    """``linear_resources`` of each kernel template's instantiations on
    their own: template name (``ww_sgd_kernel``,
    ``ww_sgd_shuffled_kernel``, ...) -> its numbers."""
    ents = _entries(log, frag)
    return {name: _resources({k: e for k, e in ents.items()
                              if kernel_template(k) == name},
                             THREADS, dynamic)
            for name in sorted({kernel_template(k) for k in ents})}


def resources_by_entry(log: Path, frag: str = LINEAR,
                       dynamic: int = 0) -> Dict[str, dict]:
    """``linear_resources`` of each instantiation (entry function) on its
    own: mangled name -> its numbers."""
    return {k: _resources({k: e}, THREADS, dynamic)
            for k, e in sorted(_entries(log, frag).items())}


def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump")
    return found or str(Path(_build.nvcc_path()).with_name("cuobjdump"))


def sass_text(lib: Path) -> str:
    return subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def sass_digest(sass: str) -> str:
    """Hash of a library's SASS: the multiset of its kernels' instruction
    streams, names left out (the anonymous namespace's name differs between
    two builds of the same source), whitespace runs collapsed (cuobjdump
    pads its columns to the library's longest instruction) and branch
    labels (``.L_x_<n>``, numbered across the library) renumbered per
    kernel in order of first use, so that a kernel's stream does not change
    when the library gains another kernel."""
    kernels, cur = [], None
    for line in sass.splitlines():
        if re.search(r"Function : \S+", line):
            cur = []
            labels = {}
            kernels.append(cur)
        elif cur is not None and re.match(r"\s+/\*[0-9a-f]+\*/", line):
            cur.append(re.sub(
                r"\.L_x_\d+",
                lambda m: labels.setdefault(m.group(0), f".L{len(labels)}"),
                re.sub(r"\s+", " ", line.strip())))
    h = hashlib.sha256()
    for code in sorted("\n".join(k) for k in kernels):
        h.update(hashlib.sha256(code.encode()).digest())
    return h.hexdigest()[:16]


def kernel_template(mangled: str) -> str:
    """The template's name in a kernel's mangled name: the first
    length-prefixed identifier that ends in ``_kernel`` (a length may
    follow other digits, as in ``_GLOBAL__N_113ww_sgd_kernel``)."""
    for m in re.finditer(r"\d+", mangled):
        digits = m.group(0)
        for k in range(len(digits)):
            name = mangled[m.end():m.end() + int(digits[k:])]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*",
                                                         name):
                return name
    return mangled


def sass_digests_by_kernel(sass: str) -> Dict[str, str]:
    """``sass_digest`` of each kernel template's instantiations on their
    own: template name -> digest."""
    parts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = parts.setdefault(kernel_template(m.group(1)), [])
        if cur is not None:
            cur.append(line)
    return {name: sass_digest("\n".join(lines))
            for name, lines in sorted(parts.items())}


def sass_census(sass: str, frag: str = LINEAR) -> Dict[str, dict]:
    """Per kernel of a library's SASS whose name holds ``frag`` (a linear
    instantiation): its SASS instruction count and the counts of the
    ``CENSUS`` opcodes (predicated ones included)."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = Counter() if frag in m.group(1) else None
            if cur is not None:
                out[m.group(1)] = cur
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if m and cur is not None:
            cur["instructions"] += 1
            cur[m.group(1)] += 1
    return {name: {"instructions": c["instructions"],
                   **{op: c[op] for op in CENSUS}}
            for name, c in out.items()}


def install(libs: Dict[tuple, Path]) -> None:
    """Make the wrappers launch these libraries, each under its build's tag
    (``_build.load``'s cache)."""
    for (name, b), path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.srnn_error_string.argtypes = [ctypes.c_int]
        lib.srnn_error_string.restype = ctypes.c_char_p
        _build._LOADED[(name, b.tag)] = lib


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


class SmiSampler:
    """``nvidia-smi`` sampling the SM clock (MHz) and the power draw (W)
    every ``ms`` milliseconds in the background, for the whole run; ``at``
    gives the medians over a window of the host's wall clock."""

    def __init__(self, ms: int = 20):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
             "--format=csv,noheader,nounits", f"-lms={ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.samples = None

    def stop(self) -> None:
        if self.samples is not None:
            return
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                stamp = datetime.datetime.strptime(parts[0],
                                                   "%Y/%m/%d %H:%M:%S.%f")
                self.samples.append((stamp, float(parts[1]), float(parts[2])))
            except (ValueError, IndexError):
                continue

    def at(self, t0: datetime.datetime, t1: datetime.datetime) -> dict:
        self.stop()
        got = [(c, p) for s, c, p in self.samples if t0 <= s <= t1]
        if not got:
            return {"samples": 0, "sm_mhz": None, "power_w": None}
        clocks = sorted(c for c, _ in got)
        power = sorted(p for _, p in got)
        return {"samples": len(got), "sm_mhz": clocks[len(clocks) // 2],
                "power_w": power[len(power) // 2]}


def timed_ms(fn, reps: int, warm: bool = True) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up
    run unless ``warm`` is false."""
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


def streamed_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``reps`` runs of ``fn`` enqueued back to back
    between one pair of events, after a warm-up run: the host's time in the
    wrapper overlaps the device's work instead of adding to it."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


#: profiler sessions ``device_ms`` opens before it gives up on a trace
#: that holds no device event at all
TRACE_ATTEMPTS = 3


def device_ms(fn, reps: int = TRACED) -> float:
    """Mean duration of the port's kernel launches in ``reps`` runs of
    ``fn`` under ``torch.profiler``, after a warm-up run: the device's time
    in the kernels alone, whatever the host spends around them.  A session
    whose trace holds no device event at all (the profiler lost its CUDA
    activity records, which happens now and then on one card) is traced
    again, up to ``TRACE_ATTEMPTS`` sessions; a trace with device events
    but none of the port's kernels raises at once."""
    from .profile_soup import _device_us

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(TRACE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        traced = [(e.key, e.count, _device_us(e))
                  for e in prof.key_averages()]
        ours = [(c, us) for k, c, us in traced
                if us > 0 and any(name in k for name in KERNEL_NAMES)]
        if ours:
            return sum(us for _, us in ours) / sum(c for c, _ in ours) / 1e3
        seen = sorted(k[:60] for k, _, us in traced if us > 0)
        if seen:
            break
    raise RuntimeError(f"the profiler recorded no kernel of the port in "
                       f"{reps} runs; device events: {seen[:12]}")


def generation_inputs(topo, wT, gen, rate=0.1):
    """``chip_smoke.py``'s K3 inputs on the population ``wT``: lanes 0..99
    forced divergent and 100..199 forced zero with their gates off, attacked
    lanes with their attacker's column, learners with their target's
    pre-attack column and that target's attacker.  Returns (wT, operands
    with the fresh columns, train-only operands)."""
    n = wT.shape[1]
    wT = wT.clone()
    wT[3, :100] = float("inf")
    wT[:, 100:200] = 0.0
    has_attacker = torch.rand(n, generator=gen, device=wT.device) < rate
    atk_idx = torch.randint(0, n, (n,), generator=gen, device=wT.device)
    learn_gate = torch.rand(n, generator=gen, device=wT.device) < rate
    tgt = torch.randint(0, n, (n,), generator=gen, device=wT.device)
    has_attacker[:200] = False
    learn_gate[:200] = False
    fresh = fresh_lanes(topo, gen, n, "fused", wT.device).contiguous()
    attackerT = wT[:, atk_idx]
    ops = dict(freshT=fresh, attackerT=attackerT, has_attacker=has_attacker,
               otherT=wT[:, tgt], other_attackerT=attackerT[:, tgt],
               other_attacked=has_attacker[tgt], learn_gate=learn_gate)
    return wT, ops, {"freshT": fresh}


GEN_KW = dict(severity=1, train=10, lr=0.01, remove_divergent=True,
              remove_zero=True, epsilon=1e-4)


class SoupProbe:
    """The float32 soup of ``topo`` (weightwise unless given), N = n
    particles, with the full dynamics of ``profile_soup``, seeded and
    ``SOUP_GENERATIONS`` generations in: the operands of its next K3 launch,
    and K3's time on the soup's own launches."""

    def __init__(self, n: int, topo: Topology = None):
        from . import soup as st
        from .profile_soup import DYNAMICS

        self.st = st
        self.cfg = st.SoupConfig(
            topo=topo or Topology("weightwise", width=2, depth=2), size=n,
            layout="popmajor", generation_impl="fused", **DYNAMICS)
        self.state = st.evolve(self.cfg, st.seed(self.cfg, 0, device="cuda"),
                               SOUP_GENERATIONS)
        seen = []
        self._evolve(lambda launch, *a, **k: (seen.append((a, k)),
                                              launch(*a, **k))[1], 1)
        self.args, self.kwargs = seen[0]

    def _evolve(self, wrap, generations: int) -> None:
        """Evolve from the probe's state with the soup's K3 launches passed
        through ``wrap(launch, *args, **kwargs)``."""
        launch = self.st.generation_popmajor
        self.st.generation_popmajor = lambda *a, **k: wrap(launch, *a, **k)
        try:
            self.st.evolve(self.cfg, self.state, generations)
        finally:
            self.st.generation_popmajor = launch

    def launch(self):
        return cg.generation_popmajor(*self.args, **self.kwargs)

    def plain(self):
        return cg.generation_popmajor_plain(*self.args, **self.kwargs)

    def ms_per_generation(self, generations: int = 20) -> float:
        """Host-clock milliseconds a generation of the soup takes, over
        ``generations`` from the probe's state, ending in a synchronise."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.st.evolve(self.cfg, self.state, generations)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / generations

    def in_soup_ms(self, generations: int = 10) -> float:
        """Median CUDA-event time of K3 over ``generations`` of the soup's
        own launches, the glue kernels between them."""
        events = []

        def timed(launch, *a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = launch(*a, **k)
            e1.record()
            events.append((e0, e1))
            return out

        self._evolve(timed, generations)
        torch.cuda.synchronize()
        times = sorted(e0.elapsed_time(e1) for e0, e1 in events)
        return times[len(times) // 2]


def cases(n: int, groups) -> Dict[str, tuple]:
    """name -> (kernel run, plain run, timed?): the checked calls."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    if "ww" in groups:
        out.update(ww_cases(n, gen))
    if "rnn" in groups:
        out.update(rnn_cases(n, gen))
    if "kvec" in groups:
        out.update(kvec_cases(n, gen))
    # the short launches also streamed and traced (timed by themselves:
    # their runs return the time)
    for name, (run, plain, timed) in list(out.items()):
        if name.startswith(("k2", "k3", "k4", "k5")) and plain and timed:
            out[f"{name}_streamed"] = (
                lambda run=run: streamed_ms(run, STREAMED), None, True)
        if name.startswith(("k1", "k2", "k3", "k4", "k5", "k6")) and plain:
            out[f"{name}_device"] = (lambda run=run: device_ms(run), None,
                                     True)
    return out


def ww_cases(n: int, gen) -> Dict[str, tuple]:
    """K1 at steps 1, 50 and K1_STEPS; K2 train 10, train 1 and learn 1,
    unshuffled and shuffled; K3's weightwise bodies, and on the soup's
    operands."""
    ww = Topology("weightwise", width=2, depth=2)
    damped = (fresh_lanes(ww, gen, n, "fused", "cuda") * 0.05).contiguous()
    w = fresh_lanes(ww, gen, n, "fused", "cuda").contiguous()
    other = fresh_lanes(ww, gen, n, "fused", "cuda").contiguous()
    out = {}
    for steps in (1, 50, K1_STEPS):
        out[f"k1_steps{steps}"] = (
            lambda steps=steps: cw.ww_apply_population(ww, damped, steps),
            lambda steps=steps: cw.ww_apply_population_plain(ww, damped,
                                                             steps),
            steps == K1_STEPS)
    out["k2_train10"] = (lambda: cwt.ww_train_epochs(ww, w, 10),
                         lambda: cwt.ww_sgd_plain(ww, w, None, 10, 0.01),
                         True)
    out["k2_train1"] = (lambda: cwt.ww_train_epochs(ww, w, 1),
                        lambda: cwt.ww_sgd_plain(ww, w, None, 1, 0.01),
                        False)
    out["k2_learn1"] = (lambda: cwt.ww_learn_epochs(ww, w, other, 1),
                        lambda: cwt.ww_sgd_plain(ww, w, other, 1, 0.01),
                        False)
    p = ww.num_weights
    order10, order1 = (
        torch.rand((e, p, n), generator=gen, device="cuda").argsort(dim=1)
        .to(torch.uint8) for e in (10, 1))
    out["k2s_train10"] = (
        lambda: cwt.ww_train_epochs(ww, w, 10, order=order10),
        lambda: cwt.ww_sgd_plain(ww, w, None, 10, 0.01, order10), True)
    out["k2s_train1"] = (
        lambda: cwt.ww_train_epochs(ww, w, 1, order=order1),
        lambda: cwt.ww_sgd_plain(ww, w, None, 1, 0.01, order1), False)
    out["k2s_learn1"] = (
        lambda: cwt.ww_learn_epochs(ww, w, other, 1, order=order1),
        lambda: cwt.ww_sgd_plain(ww, w, other, 1, 0.01, order1), False)
    out.update(generation_cases(ww, w, gen))
    for width, depth in WW_WIDE:
        out.update(ww_wide_cases(n, gen, width, depth))
    probe = SoupProbe(n)
    out["k3ww_f32_soup"] = (probe.launch, probe.plain, True)
    # timed by themselves: their runs return the time
    out["k3ww_f32_in_soup"] = (probe.in_soup_ms, None, True)
    out["soup_ww_fused_ms_per_generation"] = (probe.ms_per_generation, None,
                                              True)
    return out


def ww_wide_cases(n: int, gen, width: int, depth: int) -> Dict[str, tuple]:
    """K1 at steps 1 (a ``run_fixpoint`` step) and 50 on damped glorot
    lanes, K2 train 10, train 1 (a ``run_training`` epoch) and learn 1 and
    K3's float32 and bfloat16 weightwise
    bodies at ``width`` / ``depth`` (``k1w3d3_*``, ``k2w3d3_*``,
    ``k3www3d3_*``: the build ``w3d3-linear``)."""
    topo = Topology("weightwise", width=width, depth=depth)
    tag = f"w{width}d{depth}"
    damped = (fresh_lanes(topo, gen, n, "fused", "cuda") * 0.05).contiguous()
    w = fresh_lanes(topo, gen, n, "fused", "cuda").contiguous()
    other = fresh_lanes(topo, gen, n, "fused", "cuda").contiguous()
    out = {}
    for steps in (1, 50):
        out[f"k1{tag}_steps{steps}"] = (
            lambda steps=steps: cw.ww_apply_population(topo, damped, steps),
            lambda steps=steps: cw.ww_apply_population_plain(topo, damped,
                                                             steps), True)
    out.update({
        f"k2{tag}_train10": (lambda: cwt.ww_train_epochs(topo, w, 10),
                             lambda: cwt.ww_sgd_plain(topo, w, None, 10,
                                                      0.01), True),
        f"k2{tag}_train1": (lambda: cwt.ww_train_epochs(topo, w, 1),
                            lambda: cwt.ww_sgd_plain(topo, w, None, 1,
                                                     0.01), False),
        f"k2{tag}_learn1": (lambda: cwt.ww_learn_epochs(topo, w, other, 1),
                            lambda: cwt.ww_sgd_plain(topo, w, other, 1,
                                                     0.01), True)})
    out.update(generation_cases(topo, w, gen, tag))
    return out


def rnn_cases(n: int, gen) -> Dict[str, tuple]:
    """K5 train 10, train 1 and learn 1 and K3's recurrent bodies at width
    2 / depth 2; K5 train 10, train 1 and learn 1 and K3's float32 body at
    width 3 /
    depth 3 (``k5w3d3``, ``k3rnnw3d3``: the build ``w3d3-linear``)."""
    out = {}
    for tag, topo in (("", Topology("recurrent", width=2, depth=2)),
                      ("w3d3", Topology("recurrent", width=3, depth=3))):
        p = topo.num_weights
        w = (fresh_lanes(topo, gen, n, "fused", "cuda") * 0.5).contiguous()
        other = (fresh_lanes(topo, gen, n, "fused", "cuda")
                 * 0.5).contiguous()
        w[p - 1, 0] = float("inf")
        out.update({
            f"k5{tag}_train10": (
                lambda topo=topo, w=w: crt.rnn_train_epochs(topo, w, 10),
                lambda topo=topo, w=w: crt.rnn_sgd_plain(topo, w, None, 10,
                                                         0.01), True),
            f"k5{tag}_train1": (
                lambda topo=topo, w=w: crt.rnn_train_epochs(topo, w, 1),
                lambda topo=topo, w=w: crt.rnn_sgd_plain(topo, w, None, 1,
                                                         0.01), False),
            f"k5{tag}_learn1": (
                lambda topo=topo, w=w, o=other: crt.rnn_learn_epochs(
                    topo, w, o, 1),
                lambda topo=topo, w=w, o=other: crt.rnn_sgd_plain(
                    topo, w, o, 1, 0.01), False)})
        out.update(generation_cases(topo, w, gen, tag,
                                    ("f32", "bf16") if not tag else ("f32",)))
    return out


def kvec_sgd_cases(topo, w, other, tag: str = "") -> Dict[str, tuple]:
    """K4 of ``topo``: self-training 10 epochs (the soup's train phase) and
    1 (a ``run_training`` epoch), imitating 1 (the learn phase)."""
    out = {}
    for mode, epochs in (("train", 10), ("train", 1), ("learn", 1)):
        o = other if mode == "learn" else None
        run = (lambda e=epochs: ck.kvec_train_epochs(topo, w, e)) \
            if o is None else (lambda e=epochs: ck.kvec_learn_epochs(
                topo, w, o, e))
        out[f"k4{tag}_{mode}{epochs}"] = (
            run, lambda e=epochs, o=o: ck.kvec_sgd_plain(topo, w, o, e, 0.01),
            True)
    return out


def kvec_cases(n: int, gen) -> Dict[str, tuple]:
    """K4 train 10, train 1 and learn 1 (an Inf and a NaN weight among
    glorot lanes); K3's k-vector bodies on aggregating and fft particles;
    the same for each ``KVEC_WIDE`` build, K3 in float32 (``k4w3d3k4avg_*``,
    ``k3kvecw3d3k4fft_*``, ...); K6 at T = 14, 17 and 20, streamed only."""
    agg = Topology("aggregating", width=2, depth=2, aggregates=4)
    fft = Topology("fft", width=2, depth=2, aggregates=4)
    rnn = Topology("recurrent", width=2, depth=2)
    w = fresh_lanes(agg, gen, n, "fused", "cuda").contiguous()
    other = fresh_lanes(agg, gen, n, "fused", "cuda").contiguous()
    out = kvec_sgd_cases(agg, poisoned(w), other)
    out.update(generation_cases(agg, w, gen))
    out.update(generation_cases(
        fft, fresh_lanes(fft, gen, n, "fused", "cuda").contiguous(), gen))
    for tag, topo in kvec_wide_topos():
        wide = fresh_lanes(topo, gen, n, "fused", "cuda").contiguous()
        out.update(kvec_sgd_cases(
            topo, poisoned(wide),
            fresh_lanes(topo, gen, n, "fused", "cuda").contiguous(), tag))
        out.update(generation_cases(topo, wide, gen, dtypes=("f32",),
                                    tag=f"k3kvec{tag}"))
    probe = SoupProbe(n, agg)
    out["k3agg_f32_soup"] = (probe.launch, probe.plain, True)
    # timed by themselves: their runs return the time
    out["k3agg_f32_in_soup"] = (probe.in_soup_ms, None, True)
    out["soup_agg_fused_ms_per_generation"] = (probe.ms_per_generation, None,
                                               True)
    attackers = (fresh_lanes(rnn, gen, n, "fused", "cuda") * 0.5).contiguous()
    for t_len, vic in ((14, Topology("weightwise", width=2, depth=2)),
                       (17, rnn), (20, agg)):
        vT = (fresh_lanes(vic, gen, n, "fused", "cuda") * 0.5).contiguous()
        run = lambda vT=vT: cra.rnn_apply(rnn, attackers, vT)
        out[f"k6_t{t_len}"] = (
            run, lambda vT=vT: cra.rnn_apply_plain(rnn, attackers, vT), False)
        out[f"k6_t{t_len}_streamed"] = (
            lambda run=run: streamed_ms(run, STREAMED), None, True)
    return out


def poisoned(w: torch.Tensor) -> torch.Tensor:
    """A copy of the lanes ``w`` with an Inf at (3, 0) and a NaN at (10, 1),
    as chip_smoke.py poisons K4's: the average's poison chains run there."""
    w = w.clone()
    w[3, 0] = float("inf")
    w[10, 1] = float("nan")
    return w


#: K3 cases' tag by variant
K3_TAGS = {"weightwise": "k3ww", "recurrent": "k3rnn", "aggregating": "k3agg",
           "fft": "k3fft"}


def generation_cases(topo, w, gen, shape: str = "",
                     dtypes=("f32", "bf16"), tag: str = "") -> Dict[str, tuple]:
    """K3's body of ``topo`` in each of ``dtypes`` (float32, bfloat16), at
    the gates and train only; ``shape`` tags a topology off the default
    build, ``tag`` replaces the cases' whole prefix."""
    tag = tag or K3_TAGS[topo.variant] + shape
    out = {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dt not in dtypes:
            continue
        wd, ops, only = generation_inputs(topo, w.to(dtype), gen)
        ops = {k: v.to(dtype) if k.endswith("T") and k != "freshT" else v
               for k, v in ops.items()}
        for gates, o in (("gates", ops), ("train_only", only)):
            out[f"{tag}_{dt}_{gates}"] = (
                lambda wd=wd, o=o: cg.generation_popmajor(topo, wd, **o,
                                                          **GEN_KW),
                lambda wd=wd, o=o: cg.generation_popmajor_plain(topo, wd, **o,
                                                                **GEN_KW),
                True)
    return out


def check(label: str, runs: Dict[str, tuple], refs: Dict[str, tuple]) -> None:
    for name, (fn, plain, _) in runs.items():
        if plain is None:
            continue
        got, ref = fn(), refs[name]
        if isinstance(got, torch.Tensor):
            check_exact(f"{label} {name}", got, ref)
            continue
        check_exact(f"{label} {name} weights", got[0], ref[0])
        check_exact(f"{label} {name} loss", got[1], ref[1])
        for g, r in zip(got[2:], ref[2:]):
            if not torch.equal(g, r):
                raise AssertionError(f"{label} {name}: dead masks differ")


def reports(libs: Dict[tuple, Path]) -> dict:
    """What the compiler made of each library of one variant: ptxas'
    numbers (over the census fragment's instantiations and per kernel
    template) and nvcc's seconds, the PTX's local memory (``ptx_locals``),
    the SASS census and the SASS digests, whole and per kernel template;
    each keyed by ``job_key``."""
    built = {job_key(*job): (job, path) for job, path in libs.items()}
    sass = {key: sass_text(path) for key, (_, path) in built.items()}
    return {
        "ptxas": {key: {**linear_resources(
            path.with_suffix(".log"), census_fragment(*job),
            dynamic=dynamic_smem(path)),
                        "by_kernel": resources_by_kernel(
                            path.with_suffix(".log"), census_fragment(*job),
                            dynamic_smem(path)),
                        "by_instantiation": resources_by_entry(
                            path.with_suffix(".log"), census_fragment(*job),
                            dynamic_smem(path)),
                        "nvcc_s": float(path.with_suffix(
                            ".seconds").read_text())}
                  for key, (job, path) in built.items()},
        "ptx_locals": {key: ptx_locals(path.with_suffix(".ptx").read_text())
                       for key, (_, path) in built.items()
                       if path.with_suffix(".ptx").exists()},
        "sass": {key: sass_census(sass[key], census_fragment(*job))
                 for key, (job, _) in built.items()},
        "sass_digest": {key: sass_digest(sass[key]) for key in built},
        "sass_digest_by_kernel": {
            key: sass_digests_by_kernel(sass[key]) for key in built}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", type=parse_variant, action="append",
                    default=[], help="LABEL=DIR")
    ap.add_argument("--group", action="append", choices=sorted(GROUPS),
                    default=[])
    ap.add_argument("--size", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sass-only", action="store_true",
                    help="build and report ptxas, PTX local memory and SASS "
                         "only: no checks, no timing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs a CUDA card")
    variants = args.variant or [Variant("tree", _build.CSRC_DIR)]
    groups = args.group or sorted(GROUPS)
    jobs = jobs_for(groups)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    libs = build(variants, jobs)
    if args.sass_only:
        for v in variants:
            print(json.dumps({"label": v.label, "csrc": str(v.csrc),
                              "card": smi, **reports(libs[v.label])}),
                  flush=True)
        return 0
    runs = cases(args.size, groups)
    refs = {name: plain() for name, (_, plain, _) in runs.items() if plain}
    results, failed = {}, []
    avail = {}
    for v in variants:
        install(libs[v.label])
        # K2's shuffled instantiation only where the variant has it
        shuffled = ("ww_train", _build.DEFAULT) not in libs[v.label] or hasattr(
            _build._LOADED[("ww_train", _build.DEFAULT.tag)],
            cwt.WW_SGD_SHUFFLED.symbol)
        avail[v.label] = {name: r for name, r in runs.items()
                          if shuffled or not name.startswith("k2s")}
        try:
            check(v.label, avail[v.label], refs)
        except AssertionError as e:
            # reported, and left out of the timing; the run fails at the end
            print(f"{v.label}: {e}", flush=True)
            failed.append(v.label)
            continue
        results[v.label] = {
            "label": v.label, "csrc": str(v.csrc),
            "card": smi, "bitwise": True, **reports(libs[v.label]),
            "ms": {name: [] for name, (_, _, t) in avail[v.label].items()
                   if t},
            "clocks": {name: [] for name, (_, _, t) in avail[v.label].items()
                       if t and name.startswith(("k1", "k3"))}}
    smi_log = SmiSampler()
    windows = []
    variants = [v for v in variants if v.label in results]
    for _ in range(args.rounds):
        for v in variants:
            install(libs[v.label])
            for name, times in results[v.label]["ms"].items():
                # K3's launches are short: enough of them for the sampler
                reps = args.reps * (20 if name.startswith("k3") else 1)
                run, plain, _ = runs[name]
                t0 = datetime.datetime.now()
                times.append(timed_ms(run, reps) if plain else run())
                if name in results[v.label]["clocks"]:
                    windows.append((v.label, name, t0,
                                    datetime.datetime.now()))
    smi_log.stop()
    for label, name, t0, t1 in windows:
        results[label]["clocks"][name].append(smi_log.at(t0, t1))
    for v in variants:
        print(json.dumps(results[v.label]), flush=True)
    _build._LOADED.clear()
    if failed:
        print(f"not bitwise equal to the plain versions: {failed}",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
