"""Crash-safe small-file writes: write-tmp → fsync → atomic rename; a
copy of ``srnn_tpu/utils/atomicio.py``.

A mega run killed mid-write (SIGKILL, preemption, power) must never leave
a *plausible-looking but torn* file where the resume path will trip over
it.  ``os.replace`` alone survives a kill between open and rename, but
not a kill between rename and the data reaching disk — the fsync before
the rename closes that window (POSIX: an fsync'd tmp file renamed over
the target is the canonical atomic-publish sequence).

Used for the checkpoint ``SRNN_CKPT_OK`` markers (``experiment.py``),
``config.json`` (``setups.common.save_run_config``) and the lineage
resume sidecar — the files ``--resume`` reads first.
"""

import os


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a just-published rename inside it is durable:
    ``os.replace`` updates the directory entry, and until the directory
    itself syncs a power loss can resurrect the OLD file beside newer
    siblings (a stale ``metrics.prom`` next to a newer ``events.jsonl``,
    a vanished checkpoint marker).  Fail-soft: filesystems that refuse
    directory fsync (some network mounts) lose only this extra guarantee,
    never the write."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Publish ``data`` at ``path`` atomically (tmp + fsync + rename +
    parent-directory fsync).  The tmp file lives in the target's
    directory so the rename never crosses a filesystem boundary."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))
    return path


def atomic_write_text(path: str, text: str) -> str:
    return atomic_write_bytes(path, text.encode("utf-8"))
