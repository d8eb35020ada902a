"""srnn_tpu_torch.telemetry -- the device-side soup telemetry and its host
half; port of ``srnn_tpu/telemetry`` (its metrics, device, dynamics,
soup_metrics, flightrec and genealogy modules).

  * **Carries** folded on the population's device once a generation by
    ``soup.evolve`` / ``multisoup.evolve_multi`` (``metrics=``,
    ``health=``, ``lineage=``), read on the host only where a caller
    flushes them: ``device.SoupMetrics``, ``device.HealthStats``,
    ``dynamics.LineageState`` / ``LineageWindow`` / ``FixpointStats``.
  * **Registry** (``metrics.MetricsRegistry``): counters, gauges and
    histograms with the ``events.jsonl`` and Prometheus-textfile sinks,
    byte-identical to the JAX package's for the same updates;
    ``soup_metrics`` folds the carries into it.
  * **Forensics**: the flight recorder, the watchdog and triage bundles
    (``flightrec``), and the ``lineage.jsonl`` stream with its offline
    genealogy (``dynamics.LineageWriter``, ``genealogy``).

  * **Run plumbing** of the mega runs, host-only: heartbeat rows
    (``heartbeat``), structured spans (``tracing``), the metric history
    and alert rules (``timeseries``, ``alerts``), the HTTP exporter and
    live plane (``exporter``), the host sampling profiler and anomaly
    capture (``profiler``).

  * **The experiment service's** tail-kept trace exemplars
    (``exemplars``) and its alert rule tables (``alerts``).

A sharded run reduces its carries once per ``sharded_evolve`` call
(``device.psum_soup_metrics`` / ``psum_health``, ``dynamics.
psum_fixpoints``); the fleet readers of several processes' files wait for
ROADMAP.md A.6.
"""

from .device import (N_ACTIONS, N_HEALTH_BUCKETS, HealthStats, SoupMetrics,
                     accumulate_health, accumulate_soup_metrics,
                     count_events, merge_health, merge_soup_metrics,
                     probe_health, zero_health, zero_soup_metrics)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, RUNTIME
from .soup_metrics import (EVENT_COUNTERS, update_class_gauges,
                           update_multi_registry, update_registry)
from .flightrec import (FlightRecorder, StallSentinel, Watchdog,
                        combined_health_summary, health_summary,
                        update_health_gauges, write_triage_bundle)
from .heartbeat import Heartbeat, device_memory_stats, rss_bytes
from .tracing import Span, SpanStream, annotate, span
from .timeseries import MetricHistory, sparkline, summarize_history
from .alerts import (AlertEngine, Rule, default_pool_rules,
                     default_run_rules, default_serve_rules)
from .exporter import LivePlane, MetricsExporter, healthz_metrics
from .profiler import (AnomalyCapture, SamplingProfiler, capture_index,
                       update_utilization_gauges, utilization_from_pipeline)
from .flightrec import record_recovery
from .dynamics import (BASIN_NAMES, EDGE_NAMES, FixpointStats, LineageState,
                       LineageWindow, LineageWriter, seed_lineage,
                       seed_lineage_blocks, update_dynamics_registry,
                       window_record)

__all__ = [
    "N_ACTIONS", "SoupMetrics", "accumulate_soup_metrics", "count_events",
    "merge_soup_metrics", "zero_soup_metrics",
    "N_HEALTH_BUCKETS", "HealthStats", "accumulate_health", "merge_health",
    "probe_health", "zero_health",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RUNTIME",
    "EVENT_COUNTERS", "update_class_gauges", "update_multi_registry",
    "update_registry",
    "FlightRecorder", "StallSentinel", "Watchdog",
    "combined_health_summary", "health_summary", "update_health_gauges",
    "write_triage_bundle",
    "BASIN_NAMES", "EDGE_NAMES", "FixpointStats", "LineageState",
    "LineageWindow", "LineageWriter", "seed_lineage", "seed_lineage_blocks",
    "update_dynamics_registry", "window_record",
    "Heartbeat", "device_memory_stats", "rss_bytes",
    "Span", "SpanStream", "annotate", "span",
    "MetricHistory", "sparkline", "summarize_history",
    "AlertEngine", "Rule", "default_pool_rules", "default_run_rules",
    "default_serve_rules",
    "LivePlane", "MetricsExporter", "healthz_metrics",
    "AnomalyCapture", "SamplingProfiler", "capture_index",
    "update_utilization_gauges", "utilization_from_pipeline",
    "record_recovery",
]
