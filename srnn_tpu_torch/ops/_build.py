"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` (Hopper) into
shared libraries with a plain C interface, loaded with ``ctypes``: its
default build (width 2, depth 2, 4 aggregates, every activation; what the
paper's setups run), and one build per other topology that a run asks for
(a ``Build``: the topology's macros as ``-D`` flags, and any header
generated for it, such as an fft topology's DFT table).  Libraries go into
``srnn_tpu_torch/_build/`` (git-ignored) under a name that carries the
build's tag and a hash of the flags, the generated headers and every file
of ``csrc/`` -- ``ww_train-<digest>.so`` for the default build,
``ww_train-w3d3-linear-<digest>.so`` for another -- so any edit rebuilds
and an unchanged tree is reused.  The build happens at first use;
``build()`` starts one ``nvcc`` per missing library, all at once, and waits
for them.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Tuple, Union

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: kernel sources, ``csrc/<name>.cu``
SOURCES = ("ww_apply", "ww_train", "generation", "kvec_train", "rnn_train",
           "rnn_apply", "generation_kvec", "generation_rnn", "generation_bf16",
           "generation_kvec_bf16", "generation_rnn_bf16")

#: --fmad=false: every multiply and add rounds on its own, like the plain
#: torch versions; -Xptxas -v: registers, shared memory and spills per
#: kernel, kept in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class Build(NamedTuple):
    """One build of a kernel source: ``tag`` names it in the library's file
    name ('' for the default build), ``defines`` are its ``-D`` macros, and
    ``headers`` the (file name, text) of the headers generated for it,
    written beside the library and on its include path."""
    tag: str = ""
    defines: Tuple[Tuple[str, int], ...] = ()
    headers: Tuple[Tuple[str, str], ...] = ()


DEFAULT = Build()

#: a job of ``build``: a source's default build, or (source, build)
Job = Union[str, Tuple[str, Build]]

_LOADED: Dict[Tuple[str, str], ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
        "(nvcc on PATH or under /usr/local/cuda)")


def _digest() -> str:
    """Hash of the flags and of every file of ``csrc/``: the sources, the
    headers they share, and the body sources the bf16 sources include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.iterdir()):
        h.update(f.name.encode() + f.read_bytes())
    return h.hexdigest()[:12]


def _stem(name: str, b: Build) -> str:
    if b == DEFAULT:
        return f"{name}-{_digest()}"
    h = hashlib.sha256((_digest() + repr(b.defines) + repr(b.headers))
                       .encode())
    return f"{name}-{b.tag}-{h.hexdigest()[:12]}"


def library_path(name: str, b: Build = DEFAULT) -> Path:
    return BUILD_DIR / f"{_stem(name, b)}.so"


def log_path(name: str, b: Build = DEFAULT) -> Path:
    return library_path(name, b).with_suffix(".log")


def _own_file(path: Path) -> Path:
    """This process's private twin of ``path``, renamed over it when
    complete."""
    return path.with_name(f"{path.name}.tmp{os.getpid()}")


def _job(job: Job) -> Tuple[str, Build]:
    name, b = (job, DEFAULT) if isinstance(job, str) else job
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    return name, b


def build(jobs: Iterable[Job] = SOURCES) -> Dict[Tuple[str, str], Path]:
    """Compile every library of ``jobs`` that is not built yet, all
    ``nvcc`` processes started together.  Raises with the compiler's output
    if any fails.  Returns (source, build tag) -> library path.

    Several processes may build the same library at once (the workers of
    a serve fleet, a restarted service): each compiles into files of its
    own (``.tmp<pid>``) and publishes the library, its log and its
    generated headers by an atomic rename, so no process reads a
    half-written one."""
    jobs = [_job(j) for j in jobs]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, b in jobs:
        lib = library_path(name, b)
        if lib.exists() or (name, b) in running:
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        log = open(_own_file(log_path(name, b)), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR)]
        if b.headers:
            inc = lib.with_suffix(".include")
            inc.mkdir(exist_ok=True)
            for fname, text in b.headers:
                own = _own_file(inc / fname)
                own.write_text(text)
                os.replace(own, inc / fname)
            cmd += ["-I", str(inc)]
        cmd += [f"-D{k}={v}" for k, v in b.defines]
        cmd += ["-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        running[(name, b)] = (subprocess.Popen(cmd, stdout=log,
                                               stderr=subprocess.STDOUT),
                              log, tmp)
    failed = []
    for (name, b), (proc, log, tmp) in running.items():
        rc = proc.wait()
        log.close()
        os.replace(log.name, log_path(name, b))
        if rc != 0:
            failed.append(f"{name}.cu {b.tag or 'default'} (nvcc rc {rc}):\n"
                          + log_path(name, b).read_text()[-4000:])
            continue
        os.replace(tmp, library_path(name, b))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {(name, b.tag): library_path(name, b) for name, b in jobs}


def load(name: str, b: Build = DEFAULT) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``'s build ``b``, built first
    if needed."""
    lib = _LOADED.get((name, b.tag))
    if lib is None:
        path = build([(name, b)])[(name, b.tag)]
        lib = ctypes.CDLL(str(path))
        lib.srnn_error_string.argtypes = [ctypes.c_int]
        lib.srnn_error_string.restype = ctypes.c_char_p
        _LOADED[(name, b.tag)] = lib
    return lib


def resource_usage(name: str, b: Build = DEFAULT) -> str:
    """ptxas' report (registers, spills) from the build ``b`` of ``name``."""
    path = log_path(name, b)
    return path.read_text() if path.exists() else ""
