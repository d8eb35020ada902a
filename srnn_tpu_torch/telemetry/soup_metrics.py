"""Host-side interpretation of the device metrics carry; port of
``srnn_tpu/telemetry/soup_metrics.py``.

Maps the :class:`~srnn_tpu_torch.telemetry.device.SoupMetrics` action
histogram onto named registry counters (the soup-science metrics: attack /
learn_from / train event counts, divergent / zero respawn counts) and
maintains the class-histogram gauges and deltas the run loops flush.  The
metric names are the JAX package's, spelled alike, so either package's
readers take either's ``events.jsonl`` and ``.prom`` files.  Rates are left
to readers (divide by ``soup_particle_generations_total``): everything
stored is a monotone counter or a last-value gauge.  A carry on the card is
read here (a host synchronisation): call this where the run flushes, or on
a background writer.
"""

import math
from typing import Optional, Sequence

from ..ops.predicates import CLASS_NAMES
from ..soup import ACTION_NAMES
from .device import N_ACTIONS, SoupMetrics, host
from .metrics import MetricsRegistry

assert len(ACTION_NAMES) == N_ACTIONS, (
    "telemetry.device.N_ACTIONS fell out of sync with soup.ACTION_NAMES")

#: action-code -> (counter name, help).  'none'/'init' are not events.
#: The zero-respawn action is 'zero_dead' (the reference persisted it as
#: 'zweo_dead'; the counter name never carried the typo).
EVENT_COUNTERS = {
    "attacking": ("soup_attacks_total",
                  "particles whose last action was attacking another"),
    "learn_from": ("soup_learns_total",
                   "particles whose last action was imitation SGD"),
    "train_self": ("soup_train_events_total",
                   "particles whose last action was self-training"),
    "divergent_dead": ("soup_respawns_divergent_total",
                       "particles respawned after diverging"),
    "zero_dead": ("soup_respawns_zero_total",
                  "particles respawned after collapsing to zero"),
}


def update_registry(registry: MetricsRegistry, m: SoupMetrics,
                    type_name: Optional[str] = None,
                    n_particles: Optional[int] = None) -> None:
    """Fold one flushed device carry into ``registry``'s counters.

    ``type_name`` labels heterogeneous (multisoup) per-type carries;
    ``n_particles`` additionally advances the particle-generations
    denominator counter so readers can compute per-particle rates.
    """
    labels = {"type": type_name} if type_name else {}
    actions = host(m.actions)
    gens = int(host(m.generations))
    registry.counter("soup_generations_total",
                     help="soup generations evolved").inc(gens, **labels)
    if n_particles is not None:
        registry.counter(
            "soup_particle_generations_total",
            help="particles x generations (rate denominator)").inc(
                gens * int(n_particles), **labels)
    for code, action_name in enumerate(ACTION_NAMES):
        named = EVENT_COUNTERS.get(action_name)
        if named is None:
            continue
        name, help_ = named
        registry.counter(name, help=help_).inc(int(actions[code]), **labels)
    # a soup with diverging particles legitimately produces inf/nan train
    # losses; a counter must stay finite and monotone, so count those
    # windows separately instead of poisoning (or crashing) the total
    loss = float(host(m.loss_sum))
    if math.isfinite(loss) and loss >= 0:
        registry.counter("soup_train_loss_sum",
                         help="summed per-particle train losses").inc(
                             loss, **labels)
    else:
        registry.counter(
            "soup_train_loss_nonfinite_flushes_total",
            help="flush windows whose loss sum was inf/nan (divergence)"
        ).inc(1, **labels)


def update_class_gauges(registry: MetricsRegistry, counts,
                        type_name: Optional[str] = None,
                        prev=None) -> None:
    """Record a (5,) class histogram as gauges — current particle count
    per class plus, when ``prev`` (the previous flush's histogram) is
    given, the delta since then (the chunk-over-chunk drift the science
    watches)."""
    labels = {"type": type_name} if type_name else {}
    counts = host(counts)
    prev = None if prev is None else host(prev)
    for i, cls in enumerate(CLASS_NAMES):
        registry.gauge("soup_class_particles",
                       help="particles per class").set(
                           int(counts[i]), cls=cls, **labels)
        if prev is not None:
            registry.gauge(
                "soup_class_delta",
                help="particles-per-class change since last flush").set(
                    int(counts[i]) - int(prev[i]), cls=cls, **labels)


def type_names(config) -> list:
    """Per-type label values for a ``MultiSoupConfig``: the variant name
    when unique, disambiguated by type index otherwise — two same-variant
    subpopulations (e.g. weightwise at two widths) must not silently merge
    their counters under one label."""
    names = [t.variant for t in config.topos]
    if len(set(names)) == len(names):
        return names
    return [f"{v}[{i}]" for i, v in enumerate(names)]


def update_multi_registry(registry: MetricsRegistry,
                          ms: Sequence[SoupMetrics], config) -> None:
    """Per-type carries of a ``MultiSoupConfig`` run, labeled by variant."""
    labels = type_names(config)
    for t, m in enumerate(ms):
        update_registry(registry, m, type_name=labels[t],
                        n_particles=config.sizes[t])


def set_precision_gauges(registry: MetricsRegistry, config) -> None:
    """Run-start gauges for the population's precision mode: storage bits
    per weight and the resulting population bytes (``SoupConfig`` or
    ``MultiSoupConfig``)."""
    bits = {"bf16": 16, "int8": 8}.get(config.population_dtype, 32)
    if hasattr(config, "topos"):
        weights = sum(t.num_weights * n
                      for t, n in zip(config.topos, config.sizes))
    else:
        weights = config.topo.num_weights * config.size
    registry.gauge("soup_precision_weight_bits",
                   help="population storage bits per weight").set(bits)
    # int8's per-particle scale vector is an O(N) float rider next to the
    # O(N*P) codes; the footprint gauge counts the weight storage only
    registry.gauge("soup_precision_population_bytes",
                   help="population storage footprint at the configured "
                   "dtype").set(weights * bits // 8)


def update_fused_counters(registry: MetricsRegistry, generations: int,
                          kernel: bool,
                          type_name: Optional[str] = None) -> None:
    """Per-chunk fused-generation accounting for ``generation_impl='fused'``
    runs: generations run under the fused spelling, and those of them that
    ran the phase chain instead of the generation kernel (a mixed soup's
    type outside the kernel's envelope, ``multisoup.resolved_generation_impl``;
    the mixed loop calls this once per type, so a mixed-route run shows
    its phase-chain types)."""
    labels = {"type": type_name} if type_name else {}
    registry.counter(
        "soup_fused_generations_total",
        help="generations run under generation_impl='fused'").inc(
            int(generations), **labels)
    if not kernel:
        registry.counter(
            "soup_fused_fallback_generations_total",
            help="fused-spelling generations that ran the XLA phase-chain "
            "fallback (no Mosaic backend / off-envelope type)").inc(
                int(generations), **labels)
