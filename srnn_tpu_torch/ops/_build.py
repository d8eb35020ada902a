"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` (Hopper) into
its own shared library with a plain C interface, loaded with ``ctypes``.
Libraries go into ``srnn_tpu_torch/_build/`` (git-ignored) under a name that
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  The build happens at first use; ``build()``
starts one ``nvcc`` per missing library, all at once, and waits for them.
Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: kernel sources, ``csrc/<name>.cu``
SOURCES = ("ww_apply", "ww_train", "generation", "kvec_train", "rnn_train",
           "rnn_apply", "generation_kvec", "generation_rnn")
HEADERS = ("lane_common.cuh", "ww_common.cuh", "kvec_common.cuh",
           "rnn_common.cuh", "generation_common.cuh")

#: --fmad=false: every multiply and add rounds on its own, like the plain
#: torch versions; -Xptxas -v: registers, shared memory and spills per
#: kernel, kept in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


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


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC_DIR / f).read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes started together.  Raises with the compiler's output
    if any fails.  Returns name -> library path."""
    names = tuple(names)
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"unknown kernel source {name!r}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        log = open(log_path(name), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for name, (proc, log, tmp) in jobs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}.cu (nvcc rc {rc}):\n"
                          + log_path(name).read_text()[-4000:])
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        lib.srnn_error_string.argtypes = [ctypes.c_int]
        lib.srnn_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def resource_usage(name: str) -> str:
    """ptxas' report (registers, spills) from the build of ``name``."""
    path = log_path(name)
    return path.read_text() if path.exists() else ""
