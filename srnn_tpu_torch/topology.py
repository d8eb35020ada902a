"""Static topology descriptors for self-replicating networks.

The port's own copy of ``srnn_tpu/topology.py`` (numpy only; importing the
JAX package would load its engine).  Its tables -- ``layer_shapes``,
``offsets``, ``weight_coords``, ``normalized_weight_coords`` -- are held
equal to the JAX package's by ``tests/test_torch_topology.py``.  Fields that
only the JAX package's paths read (``precision``, ``rnn_scan``) are kept so
that a JAX ``Topology`` converts field for field (``convert.py``).

A *topology* captures everything shape-related about one network variant so
that a particle's parameters can live as a single flat ``(P,)`` vector.  This
replaces the reference's keras ``Sequential`` objects (reference:
``network.py:213-574``) with constants: layer shapes, flat offsets, and the
precomputed positional-encoding table used by the weightwise variant
(reference ``network.py:239-255``).

Weight layout parity: the reference stores weights as keras' list of 2-D
kernels iterated layer -> cell (row) -> weight (column)
(``network.py:64-74``).  We keep exactly that enumeration order when
flattening, so flat index <-> (layer, cell, weight) coordinates match the
reference bit-for-bit.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np

VARIANTS = ("weightwise", "aggregating", "fft", "recurrent")


@dataclass(frozen=True)
class Topology:
    """Hashable, trace-static description of one network variant.

    Attributes mirror the reference constructors:
      - ``weightwise``  : MLP f: R^4 -> R^1      (``network.py:222-230``)
      - ``aggregating`` : MLP f: R^k -> R^k      (``network.py:324-333``)
      - ``fft``         : MLP f: R^k -> R^k      (``network.py:465-474``)
      - ``recurrent``   : SimpleRNN stack, feature dim 1 (``network.py:526-535``)

    ``activation`` applies to every layer (keras_params semantics,
    ``network.py:80``); default 'linear', no biases anywhere.
    """

    variant: str
    width: int = 2
    depth: int = 2
    aggregates: int = 4          # only used by aggregating / fft
    activation: str = "linear"
    # aggregating-variant options (reference ``network.py:338-345``):
    #   aggregator: 'average' (default) | 'max' | 'max_buggy'
    #     'max_buggy' replicates the reference's falsy-max quirk
    #     (``network.py:303-308``) where a candidate equal to 0.0 never wins.
    #   shuffler: 'not' (default) | 'random' — 'random' requires a PRNG key
    #     at apply time (functional stand-in for ``shuffle_random``).
    aggregator: str = "average"
    shuffler: str = "not"
    # fft-variant option: the reference transform FFTs its *own* current
    # weights and ignores the passed-in target (``network.py:494-499``), so
    # ``attack(other)`` writes self-derived values. False keeps that
    # behavior; True fixes the quirk and transforms the target instead.
    fft_use_target: bool = False
    # fft-variant transform: 'fft' (reference ``aggregate_fft``,
    # ``network.py:444-448``) or 'rfft' — the real-input transform the
    # related/EP prototype's FeatureReduction offered alongside fft
    # (``related/EP/src/FeatureReduction.py:9-16``); coefficients are the
    # first k real-FFT bins, inverse via irfft.
    fft_mode: str = "fft"
    # matmul precision: 'highest' keeps f32 accumulation on the MXU so that
    # |delta| < 1e-4 fixpoint thresholds are meaningful on TPU (bf16 rounding
    # is ~3e-3 at unit scale — larger than epsilon).  'default' opts into
    # fast bf16 passes for throughput-only workloads.
    precision: str = "highest"
    # recurrent-variant option: 'sequential' (default) is the serial
    # lax.scan matching keras step order; 'associative' exploits that the
    # linear-activation recurrence is affine and solves each layer with an
    # associative scan in O(log T) depth — the TPU-native fast path for
    # giant-particle sequences (requires activation='linear'; floating-point
    # reassociation means bitwise differences from the serial scan).
    rnn_scan: str = "sequential"

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}; expected one of {VARIANTS}")
        if self.width < 1 or self.depth < 1:
            raise ValueError("width and depth must be >= 1")
        if self.variant in ("aggregating", "fft") and self.aggregates < 1:
            raise ValueError("aggregates must be >= 1")
        if self.precision not in ("default", "high", "highest"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.aggregator not in ("average", "max", "max_buggy"):
            raise ValueError(f"unknown aggregator {self.aggregator!r}")
        if self.shuffler not in ("not", "random"):
            raise ValueError(f"unknown shuffler {self.shuffler!r}")
        if self.fft_mode not in ("fft", "rfft"):
            raise ValueError(f"unknown fft_mode {self.fft_mode!r}")
        if self.rnn_scan not in ("sequential", "associative"):
            raise ValueError(f"unknown rnn_scan {self.rnn_scan!r}")
        if (self.variant == "recurrent" and self.rnn_scan == "associative"
                and self.activation != "linear"):
            raise ValueError(
                "rnn_scan='associative' requires activation='linear' "
                "(the recurrence must be affine)")

    # ---- shape metadata -------------------------------------------------

    @property
    def layer_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """Kernel shapes in keras ``get_weights()`` order.

        Dense kernels are ``(fan_in, fan_out)``.  SimpleRNN layers contribute
        two entries each — input kernel then recurrent kernel — matching
        keras' weight list for ``use_bias=False``.
        """
        w, d = self.width, self.depth
        if self.variant == "weightwise":
            return ((4, w),) + ((w, w),) * (d - 1) + ((w, 1),)
        if self.variant in ("aggregating", "fft"):
            k = self.aggregates
            return ((k, w),) + ((w, w),) * (d - 1) + ((w, k),)
        # recurrent: depth SimpleRNN(units=w) layers + final SimpleRNN(units=1)
        shapes = [(1, w), (w, w)]
        for _ in range(d - 1):
            shapes += [(w, w), (w, w)]
        shapes += [(w, 1), (1, 1)]
        return tuple(shapes)

    @property
    def num_weights(self) -> int:
        """Total scalar parameter count P (``get_amount_of_weights``, ``network.py:347-353``)."""
        return int(sum(a * b for a, b in self.layer_shapes))

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Flat start offset of each kernel, plus the total as last element."""
        offs = [0]
        for a, b in self.layer_shapes:
            offs.append(offs[-1] + a * b)
        return tuple(offs)

    @property
    def num_layers(self) -> int:
        return len(self.layer_shapes)

    # ---- recurrent helpers ---------------------------------------------

    @property
    def rnn_layer_dims(self) -> Tuple[Tuple[int, int], ...]:
        """(input_dim, units) per SimpleRNN layer, in order."""
        assert self.variant == "recurrent"
        w, d = self.width, self.depth
        dims = [(1, w)] + [(w, w)] * (d - 1) + [(w, 1)]
        return tuple(dims)

    # ---- convenience ----------------------------------------------------

    def with_(self, **kw) -> "Topology":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Precomputed constants (cached per topology; numpy so they become XLA
# constants when closed over inside jit).
# ---------------------------------------------------------------------------


def _normalize_id(value: np.ndarray, norm: float) -> np.ndarray:
    """Reference ``normalize_id`` (``network.py:215-220``): divide only when
    the max index exceeds 1, else keep the raw index."""
    if norm > 1:
        return value / float(norm)
    return value.astype(np.float64)


@functools.lru_cache(maxsize=None)
def weight_coords(topo: Topology) -> np.ndarray:
    """Integer (layer, cell, weight) ids per flat position — shape (P, 3)."""
    rows = []
    for layer_id, (a, b) in enumerate(topo.layer_shapes):
        for cell_id in range(a):
            for weight_id in range(b):
                rows.append((layer_id, cell_id, weight_id))
    return np.asarray(rows, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def normalized_weight_coords(topo: Topology) -> np.ndarray:
    """Normalized duplex points, shape (P, 3) float32.

    Matches ``compute_all_duplex_weight_points`` (``network.py:239-255``):
    each id is divided by the *max id in its own axis scope* — layer ids by
    the global max layer id, cell ids by (rows-in-this-layer - 1), weight ids
    by (cols-in-this-cell - 1) — but only when that max exceeds 1.
    """
    coords = weight_coords(topo).astype(np.float64)
    out = np.empty_like(coords)
    max_layer_id = topo.num_layers - 1
    out[:, 0] = _normalize_id(coords[:, 0], max_layer_id)
    pos = 0
    for layer_id, (a, b) in enumerate(topo.layer_shapes):
        n = a * b
        sl = slice(pos, pos + n)
        out[sl, 1] = _normalize_id(coords[sl, 1], a - 1)
        out[sl, 2] = _normalize_id(coords[sl, 2], b - 1)
        pos += n
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def segments_for(p: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Segment ids + counts chunking ``p`` weights into ``k`` collections.

    Reference ``collect_weights`` (``network.py:388-403``): weights are
    chunked into groups of ``p // k`` in flat order; the trailing ``p % k``
    leftovers are appended to the *last* collection.  Keyed by (p, k) so
    cross-architecture application (an aggregating attacker chunking a
    *victim's* weight count) shares the same rule.

    Returns (segment_ids (p,) int32, counts (k,) int32).
    """
    size = p // k
    if size == 0:
        raise ValueError(f"aggregates={k} exceeds weight count {p}")
    seg = np.minimum(np.arange(p) // size, k - 1).astype(np.int32)
    counts = np.bincount(seg, minlength=k).astype(np.int32)
    return seg, counts


def aggregation_segments(topo: Topology) -> Tuple[np.ndarray, np.ndarray]:
    """Segments of a topology's own weights under its own ``aggregates``."""
    return segments_for(topo.num_weights, topo.aggregates)
