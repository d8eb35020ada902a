"""The port's trajectory store (``srnn_tpu_torch/utils/trajstore.py``)
against the JAX package's (``srnn_tpu/utils/trajstore.py``).

For the same arrays, the port's and the JAX package's writers make
byte-identical files, native and pure-Python alike, and each package reads
the other's files (``read_store``, ``truncate_frames``,
``read_store_sampled``, ``read_store_artifact``).  The port's append mode
keeps a file's frames, drops a torn tail and refuses another shape, as the
JAX package's does (tests/test_trajstore.py).
"""

import os

import numpy as np
import pytest

from srnn_tpu.utils import trajstore as jts
from srnn_tpu_torch.utils import trajstore as pts

N, P, G = 6, 14, 5
PACKAGES = {"port": pts, "jax": jts}


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return [dict(
        generation=i + 1,
        weights=rng.normal(size=(N, P)).astype(np.float32),
        uids=rng.integers(0, 100, size=N).astype(np.int32),
        action=rng.integers(0, 7, size=N).astype(np.int32),
        counterpart=rng.integers(-1, 100, size=N).astype(np.int32),
        loss=rng.normal(size=N).astype(np.float32),
    ) for i in range(G)]


def _write(mod, path, frames, native, mode="w"):
    with mod.TrajStore(str(path), N, P, native=native, mode=mode) as s:
        for fr in frames:
            s.append(fr["generation"], fr["weights"], fr["uids"],
                     fr["action"], fr["counterpart"], fr["loss"])
        return s.existing_frames


def test_native_library_loads():
    """The committed library loads here, in both packages."""
    assert pts.native_available() and jts.native_available()


@pytest.mark.parametrize("native", [False, True])
def test_files_byte_identical(tmp_path, native):
    frames = _frames()
    paths = {}
    for name, mod in PACKAGES.items():
        for nat in (False, native):
            paths[name, nat] = tmp_path / f"{name}-{nat}.traj"
            _write(mod, paths[name, nat], frames, nat)
    data = {k: p.read_bytes() for k, p in paths.items()}
    ref = data["jax", False]
    assert len(ref) == 32 + G * pts._frame_bytes(N, P)
    for key, raw in data.items():
        assert raw == ref, key


def _check_read(out, frames, start=0):
    got = len(out["uids"])
    np.testing.assert_array_equal(
        out["generations"], [f["generation"] for f in
                             frames[start:start + got]])
    for key in ("weights", "uids", "action", "counterpart", "loss"):
        np.testing.assert_array_equal(
            out[key], np.stack([f[key] for f in frames[start:start + got]]))


@pytest.mark.parametrize("reader", list(PACKAGES))
@pytest.mark.parametrize("writer", list(PACKAGES))
def test_each_package_reads_the_others_files(tmp_path, writer, reader):
    frames = _frames(1)
    path = str(tmp_path / "s.traj")
    _write(PACKAGES[writer], path, frames, None)
    mod = PACKAGES[reader]
    _check_read(mod.read_store(path), frames)
    _check_read(mod.read_store(path, 1, 3), frames, 1)
    _check_read(mod._read_store_py(path, 2, 2), frames, 2)
    cols = np.array([0, 3, 5])
    sampled = mod.read_store_sampled(path, cols, chunk_frames=2)
    np.testing.assert_array_equal(sampled["weights"],
                                  np.stack([f["weights"][cols]
                                            for f in frames]))
    np.testing.assert_array_equal(sampled["generations"], np.arange(1, G + 1))
    art = mod.read_store_artifact(path)
    assert "generations" not in art
    np.testing.assert_array_equal(art["uids"],
                                  np.stack([f["uids"] for f in frames]))
    assert mod.store_shape(path) == (N, P)
    assert mod.truncate_frames(path, 3) == 3
    assert mod.store_frame_count(path) == 3
    other = PACKAGES["jax" if reader == "port" else "port"]
    _check_read(other.read_store(path), frames[:3])


@pytest.mark.parametrize("native", [False, True])
def test_append_mode_keeps_frames_and_drops_torn_tail(tmp_path, native):
    frames = _frames(2)
    path = tmp_path / "a.traj"
    _write(pts, path, frames[:3], native)
    with open(path, "ab") as f:
        f.write(b"\x00" * 17)  # a torn frame from a crashed writer
    assert _write(pts, path, frames[3:], native, mode="a") == 3
    _check_read(jts.read_store(str(path)), frames)
    with pytest.raises(OSError):
        pts.TrajStore(str(path), N + 1, P, native=native, mode="a")


def test_shards_merge_as_in_the_jax_package(tmp_path):
    """A per-process shard set written by the port merges the same way in
    both packages (the plain-file helpers; the sharded capture waits for
    multi-GPU)."""
    frames = _frames(3)
    base = str(tmp_path / "m.traj")
    for i in range(2):
        path = pts.shard_path(base, i, 2)
        with pts.TrajStore(path, N, P) as s:
            for fr in frames:
                s.append(fr["generation"], fr["weights"], fr["uids"],
                         fr["action"], fr["counterpart"], fr["loss"])
    ours = pts.read_sharded_store(base)
    theirs = jts.read_sharded_store(base)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours["weights"].shape == (G, 2 * N, P)
    assert pts.truncate_sharded_frames(base, 2) == 2
    assert os.path.getsize(pts.shard_path(base, 1, 2)) == \
        32 + 2 * pts._frame_bytes(N, P)
