"""Trajectory/event store: ctypes bindings for the native writer; port of
``srnn_tpu/utils/trajstore.py``, the same file format byte for byte.

The native library (``native/libtrajstore.so``, built from
``native/trajstore.cpp``) streams soup frames (weights, uids, action
codes, counterparts, losses per generation) to disk from a background C++
thread, so host IO overlaps the next chunk of device compute.  This
replaces the reference's keep-everything-in-RAM
``ParticleDecorator.save_state`` history (``network.py:193-198``) with a
bounded-memory stream -- the only workable shape at 1M particles.

The committed library is loaded as it is; nothing is built.  Where it will
not load, a pure-Python writer and reader produce and read the identical
file format (same header, same CRC32 per frame), so readers never care
which side wrote a file; ``native_available()`` says which one runs.  The
JAX package's files and this package's are interchangeable.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = b"SRNNTRJ1"
_VERSION = 1
_HEADER = struct.Struct("<8sII QQ")  # magic, version, reserved, N, P


def _frame_bytes(n: int, p: int) -> int:
    """On-disk frame size: u64 generation + f32 weights[N*P] + 3x i32[N]
    (uids/action/counterpart) + f32 loss[N] + u32 crc.  Single source of
    truth for writer, reader, and resume reconciliation (mirror of
    ``payload_bytes`` in native/trajstore.cpp)."""
    return 8 + n * p * 4 + 3 * n * 4 + n * 4 + 4

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Load the committed libtrajstore.so; None if it will not load."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(os.path.join(_NATIVE_DIR, "libtrajstore.so"))
    except OSError:
        return None
    lib.ts_create.restype = ctypes.c_void_p
    lib.ts_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.ts_open_append.restype = ctypes.c_void_p
    lib.ts_open_append.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_uint64)]
    lib.ts_append.restype = ctypes.c_int
    lib.ts_append.argtypes = [ctypes.c_void_p, ctypes.c_uint64] + \
        [ctypes.c_void_p] * 5
    lib.ts_flush.restype = ctypes.c_int
    lib.ts_flush.argtypes = [ctypes.c_void_p]
    lib.ts_close.restype = ctypes.c_int
    lib.ts_close.argtypes = [ctypes.c_void_p]
    lib.ts_open_read.restype = ctypes.c_void_p
    lib.ts_open_read.argtypes = [ctypes.c_char_p]
    lib.ts_meta.restype = ctypes.c_int
    lib.ts_meta.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint64)] * 3
    lib.ts_read_frames.restype = ctypes.c_int
    lib.ts_read_frames.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_uint64] + [ctypes.c_void_p] * 6
    lib.ts_close_read.restype = ctypes.c_int
    lib.ts_close_read.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    """True where the native writer and reader run, False where the
    pure-Python ones do."""
    return _load_native() is not None


class TrajStore:
    """Appendable frame store for one soup run.

    >>> with TrajStore(path, n_particles=N, n_weights=P) as store:
    ...     store.append(gen, weights, uids, action, counterpart, loss)

    ``mode='w'`` starts a NEW store (truncates any existing file);
    ``mode='a'`` reopens an existing one for a resumed run — the header is
    validated against (N, P), a torn trailing frame from a crashed writer
    is dropped, and ``existing_frames`` reports what was already on disk.
    Previously captured frames are never lost on resume.

    Uses the native background-thread writer when available, else a
    format-identical pure-Python writer (``native=False`` forces that).
    """

    def __init__(self, path: str, n_particles: int, n_weights: int,
                 native: Optional[bool] = None, mode: str = "w"):
        if mode not in ("w", "a"):
            raise ValueError(f"mode must be 'w' or 'a', got {mode!r}")
        self.path = path
        self.n = int(n_particles)
        self.p = int(n_weights)
        self.existing_frames = 0
        lib = _load_native() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("native trajstore requested but unavailable")
        self._lib = lib
        if lib is not None:
            if mode == "a":
                if os.path.exists(path) and os.path.getsize(path) < _HEADER.size:
                    os.remove(path)  # torn header: unrecoverable, start fresh
                existing = ctypes.c_uint64()
                self._h = lib.ts_open_append(path.encode(), self.n, self.p,
                                             ctypes.byref(existing))
                if not self._h:
                    raise OSError(
                        f"ts_open_append failed for {path} (header mismatch "
                        f"or IO error)")
                self.existing_frames = existing.value
            else:
                self._h = lib.ts_create(path.encode(), self.n, self.p)
                if not self._h:
                    raise OSError(f"ts_create failed for {path}")
            self._f = None
        else:
            self._h = None
            if mode == "a" and os.path.exists(path) \
                    and os.path.getsize(path) >= _HEADER.size:
                self._f = self._reopen_py(path)
            else:
                # absent file — or one whose buffered header never hit disk
                # (a crash right after creation): nothing recoverable, start
                # the store fresh rather than failing the resume
                self._f = open(path, "wb")
                self._f.write(_HEADER.pack(_MAGIC, _VERSION, 0, self.n, self.p))
        self.frames_written = 0

    def _reopen_py(self, path: str):
        """Pure-Python append reopen: validate header, truncate a torn tail,
        seek to the end of the last complete frame."""
        f = open(path, "r+b")
        try:
            head = f.read(_HEADER.size)
            if len(head) < _HEADER.size:
                raise OSError(f"{path}: truncated header")
            magic, version, _res, n, p = _HEADER.unpack(head)
            if magic != _MAGIC or version != _VERSION:
                raise OSError(f"{path}: not a trajstore file")
            if (n, p) != (self.n, self.p):
                raise OSError(
                    f"{path}: store is (N={n}, P={p}) but resume expects "
                    f"(N={self.n}, P={self.p})")
            frame_bytes = _frame_bytes(n, p)
            f.seek(0, os.SEEK_END)
            frames = (f.tell() - _HEADER.size) // frame_bytes
            valid_end = _HEADER.size + frames * frame_bytes
            f.truncate(valid_end)
            f.seek(valid_end)
            self.existing_frames = int(frames)
            return f
        except Exception:
            f.close()
            raise

    def append(self, generation: int, weights, uids, action, counterpart, loss):
        w = np.ascontiguousarray(np.asarray(weights, np.float32)
                                 .reshape(self.n, self.p))
        u = np.ascontiguousarray(np.asarray(uids, np.int32).reshape(self.n))
        a = np.ascontiguousarray(np.asarray(action, np.int32).reshape(self.n))
        c = np.ascontiguousarray(np.asarray(counterpart, np.int32).reshape(self.n))
        l = np.ascontiguousarray(np.asarray(loss, np.float32).reshape(self.n))
        if self._h is not None:
            rc = self._lib.ts_append(
                self._h, int(generation),
                w.ctypes.data_as(ctypes.c_void_p), u.ctypes.data_as(ctypes.c_void_p),
                a.ctypes.data_as(ctypes.c_void_p), c.ctypes.data_as(ctypes.c_void_p),
                l.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise OSError(f"ts_append failed with {rc}")
        else:
            payload = (struct.pack("<Q", int(generation)) + w.tobytes() +
                       u.tobytes() + a.tobytes() + c.tobytes() + l.tobytes())
            self._f.write(payload + struct.pack("<I", zlib.crc32(payload)))
        self.frames_written += 1

    def flush(self):
        if self._h is not None:
            rc = self._lib.ts_flush(self._h)
            if rc != 0:
                raise OSError(f"ts_flush failed with {rc}")
        elif self._f is not None:
            self._f.flush()

    # -- pipeline hooks ---------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._h is None and self._f is None

    def join(self):
        """Block until every queued frame is handed to the OS: the native
        writer drains its background C++ queue (``ts_flush`` joins the
        in-flight tail), the pure-Python writer flushes its buffer.  This
        is the flush/join hook an async pipeline's ``BackgroundWriter``
        owns (``add_close_hook``), so even an error-path shutdown leaves
        every frame that DID append durable.  No-op on a closed store —
        the hook may fire after the owning loop already closed it."""
        if not self.closed:
            self.flush()

    def close(self):
        if self._h is not None:
            rc = self._lib.ts_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"ts_close failed with {rc}")
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_store(path: str, start: int = 0, count: Optional[int] = None
               ) -> Dict[str, np.ndarray]:
    """Read frames [start, start+count) -> dict of arrays:
    generations (G,), weights (G, N, P), uids/action/counterpart (G, N),
    loss (G, N).  CRC failures raise; a torn trailing frame from a crashed
    writer is silently excluded (truncation recovery)."""
    lib = _load_native()
    if lib is not None:
        h = lib.ts_open_read(path.encode())
        if not h:
            raise OSError(f"cannot open {path}")
        try:
            n, p, frames = (ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64())
            lib.ts_meta(h, ctypes.byref(n), ctypes.byref(p), ctypes.byref(frames))
            n, p, frames = n.value, p.value, frames.value
            count = frames - start if count is None else count
            out = {
                "generations": np.empty(count, np.uint64),
                "weights": np.empty((count, n, p), np.float32),
                "uids": np.empty((count, n), np.int32),
                "action": np.empty((count, n), np.int32),
                "counterpart": np.empty((count, n), np.int32),
                "loss": np.empty((count, n), np.float32),
            }
            rc = lib.ts_read_frames(
                h, start, count,
                *(out[k].ctypes.data_as(ctypes.c_void_p) for k in
                  ("generations", "weights", "uids", "action", "counterpart", "loss")))
            if rc != 0:
                raise OSError(f"ts_read_frames failed with {rc}"
                              + (" (CRC mismatch)" if rc == -2 else ""))
            return out
        finally:
            lib.ts_close_read(h)
    return _read_store_py(path, start, count)


def _read_store_py(path: str, start: int, count: Optional[int]
                   ) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        n, p = _parse_header(f, path)
        frame_bytes = _frame_bytes(n, p)
        body = frame_bytes - 4
        f.seek(0, os.SEEK_END)
        total = (f.tell() - _HEADER.size) // frame_bytes
        count = total - start if count is None else count
        if start + count > total:
            raise OSError(f"{path}: range [{start}, {start + count}) > {total}")
        out = {
            "generations": np.empty(count, np.uint64),
            "weights": np.empty((count, n, p), np.float32),
            "uids": np.empty((count, n), np.int32),
            "action": np.empty((count, n), np.int32),
            "counterpart": np.empty((count, n), np.int32),
            "loss": np.empty((count, n), np.float32),
        }
        f.seek(_HEADER.size + start * frame_bytes)
        for i in range(count):
            raw = f.read(frame_bytes)
            payload, crc = raw[:body], struct.unpack("<I", raw[body:])[0]
            if zlib.crc32(payload) != crc:
                raise OSError(f"{path}: CRC mismatch in frame {start + i}")
            off = 0
            out["generations"][i] = struct.unpack_from("<Q", payload, off)[0]
            off += 8
            out["weights"][i] = np.frombuffer(
                payload, np.float32, n * p, off).reshape(n, p)
            off += n * p * 4
            for key in ("uids", "action", "counterpart"):
                out[key][i] = np.frombuffer(payload, np.int32, n, off)
                off += n * 4
            out["loss"][i] = np.frombuffer(payload, np.float32, n, off)
    return out


def truncate_frames(path: str, keep: int) -> int:
    """Truncate a store to its first ``keep`` frames (no-op if it already
    has fewer).  Returns the frame count after truncation.

    Resume reconciliation: a run killed AFTER capture flushed frames but
    BEFORE the next checkpoint finalized would otherwise re-evolve and
    re-append those generations, duplicating frames.  The resuming caller
    truncates to the frames consistent with the restored checkpoint first.
    """
    if not os.path.exists(path) or os.path.getsize(path) < _HEADER.size:
        return 0
    with open(path, "r+b") as f:
        n, p = _parse_header(f, path)
        fb = _frame_bytes(n, p)
        f.seek(0, os.SEEK_END)
        frames = (f.tell() - _HEADER.size) // fb
        keep = min(int(keep), int(frames))
        f.truncate(_HEADER.size + keep * fb)
    return keep


def read_store_sampled(path: str, columns: np.ndarray,
                       chunk_frames: int = 4) -> Dict[str, np.ndarray]:
    """Read a store keeping only the given particle ``columns``, streaming
    ``chunk_frames`` frames at a time so peak memory is bounded by the
    WINDOW, not the store (a 1M-particle capture is ~56 MB/frame — a
    whole-store read of a long run OOMs exactly at the scale the sampling
    exists for).  Returns the full dict including ``generations``."""
    columns = np.asarray(columns)
    # one-frame peek fixes the shapes/keys without loading the store
    peek = read_sharded_store(path, 0, min(1, _total_frames(path)))
    total = _total_frames(path)
    parts = {k: [] for k in peek if k != "generations"}
    gens = []
    for start in range(0, total, chunk_frames):
        win = read_sharded_store(path, start,
                                 min(chunk_frames, total - start))
        gens.append(win.pop("generations"))
        for k, v in win.items():
            parts[k].append(v[:, columns] if v.ndim >= 2 else v)
    out = {k: np.concatenate(v, axis=0) if v else peek[k][:0]
           for k, v in parts.items()}
    out["generations"] = np.concatenate(gens) if gens else \
        peek["generations"][:0]
    return out


def _total_frames(path: str) -> int:
    """Complete merged frame count for a plain store or a shard set."""
    shards = _find_shards(path)
    if not shards:
        return store_frame_count(path)
    return min(store_frame_count(p) for _, _, p in shards)


def read_store_artifact(path: str,
                        columns: Optional[np.ndarray] = None
                        ) -> Dict[str, np.ndarray]:
    """Read a store in the soup-artifact shape (weights/uids/action/
    counterpart/loss keys, the JAX package's viz input).  Accepts both a
    single-process store and the base path of a per-process shard set
    (merged via :func:`read_sharded_store`).  ``columns`` restricts to a
    particle subset via the memory-bounded streaming reader — pass it for
    mega-scale stores."""
    if columns is not None:
        out = read_store_sampled(path, columns)
    else:
        out = read_sharded_store(path)
    out.pop("generations")
    return out


# ---------------------------------------------------------------------------
# Multihost shards: one .traj per process, merged on read.
#
# At multi-host mega-soup scale, pulling full GLOBAL frames through one
# process moves ~56 MB x every captured frame between hosts.  Instead each
# process appends only its addressable particle rows to its own
# shard file; the merge reader reassembles global frames offline.  Scales
# the reference's never-lose-history registry (soup.py:37-43) to multihost.
# ---------------------------------------------------------------------------


def shard_path(base: str, process_index: int, num_processes: int) -> str:
    """Per-process shard file name.  A single-process run keeps the plain
    ``base`` path, so existing single-host artifacts/readers are unchanged."""
    if num_processes <= 1:
        return base
    return f"{base}.p{process_index:04d}of{num_processes:04d}"


def _find_shards(base: str):
    import glob as _glob
    import re

    paths = sorted(_glob.glob(base + ".p*of*"))
    shards = []
    for p in paths:
        m = re.search(r"\.p(\d+)of(\d+)$", p)
        if m:
            shards.append((int(m.group(1)), int(m.group(2)), p))
    return shards


def _parse_header(f, path: str):
    """Validate the magic/version and return (n_particles, n_weights).
    Single source for every reader/maintenance path."""
    head = f.read(_HEADER.size)
    if len(head) < _HEADER.size:
        raise OSError(f"{path}: truncated header")
    magic, version, _res, n, p = _HEADER.unpack(head)
    if magic != _MAGIC or version != _VERSION:
        raise OSError(f"{path}: not a trajstore file")
    return n, p


def store_frame_count(path: str) -> int:
    """Number of complete frames in a store, from the header + file size
    alone (no frame data read)."""
    with open(path, "rb") as f:
        n, p = _parse_header(f, path)
        f.seek(0, os.SEEK_END)
        return (f.tell() - _HEADER.size) // _frame_bytes(n, p)


def store_shape(path: str) -> "Tuple[int, int]":
    """(total particles, weights per particle) from headers alone — the
    merged particle count for a shard set, no frame data read."""
    shards = _find_shards(path)
    paths = [p for _, _, p in shards] if shards else [path]
    n_total, p_dim = 0, None
    for sp in paths:
        with open(sp, "rb") as f:
            n, p = _parse_header(f, sp)
        n_total += n
        p_dim = p
    return n_total, p_dim


def read_sharded_store(base: str, start: int = 0,
                       count: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Merge per-process shards of a captured run into GLOBAL frames.

    Falls back to ``read_store(base)`` when no ``.pNNNNofMMMM`` shards
    exist (single-process store).  Shards are concatenated in process
    order along the particle axis — processes own contiguous global row
    blocks (the JAX package's ``capture.sharded_evolve_captured`` layout;
    the port's sharded capture is still to come, ROADMAP.md A.6).  A run
    killed mid-capture may leave shards at different lengths; only frames
    present in EVERY shard are returned (the global frame is otherwise
    torn).

    Only the requested [start, start+count) window is read from each
    shard — a mega-soup global frame is ~56 MB, so reading whole shards to
    serve one frame would not scale.
    """
    shards = _find_shards(base)
    if not shards:
        return read_store(base, start, count)
    if os.path.exists(base):
        # a plain base store PLUS shards means the process count changed
        # across a resume; merging would silently drop one of the two
        # histories — refuse instead of losing frames
        raise OSError(
            f"{base}: both a single-process store and per-process shards "
            "exist; a resume must keep the original process count (or the "
            "histories must be merged explicitly)")
    num = shards[0][1]
    have = sorted(s[0] for s in shards)
    if have != list(range(num)) or any(s[1] != num for s in shards):
        raise OSError(
            f"{base}: incomplete shard set {have} (expected 0..{num - 1})")
    complete = min(store_frame_count(p) for _, _, p in shards)
    count = complete - start if count is None else count
    if count < 0 or start + count > complete:
        raise OSError(f"{base}: range [{start}, {start + count}) exceeds the "
                      f"{complete} complete merged frames")
    parts = [read_store(p, start, count) for _, _, p in shards]
    gens = parts[0]["generations"]
    for p in parts[1:]:
        if not np.array_equal(p["generations"], gens):
            raise OSError(f"{base}: shard generation sequences disagree")
    if len(gens) > 1 and not np.all(np.diff(gens) > 0):
        # shards agree but the shared timeline itself runs backwards: a
        # mis-reconciled resume (truncate_sharded_frames skipped, or applied
        # to only some shards before new appends) — e.g. [2, 4, 2, 4, 6]
        import warnings

        warnings.warn(
            f"{base}: merged generation sequence is not strictly "
            "increasing — a resume appended without truncating frames "
            "past the checkpoint; run truncate_sharded_frames before "
            "appending to repair the store", stacklevel=2)
    out = {"generations": gens}
    for key in ("weights", "uids", "action", "counterpart", "loss"):
        out[key] = np.concatenate([p[key] for p in parts], axis=1)
    return out


def truncate_sharded_frames(base: str, keep: int) -> int:
    """Resume reconciliation across shards: truncate the base store AND
    every shard to ``keep`` frames.  Returns the resulting complete-frame
    count (min across shards)."""
    shards = _find_shards(base)
    if not shards:
        return truncate_frames(base, keep)
    if os.path.exists(base):
        raise OSError(
            f"{base}: both a single-process store and per-process shards "
            "exist; a resume must keep the original process count")
    return min(truncate_frames(p, keep) for _, _, p in shards)
