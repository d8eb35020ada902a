"""Declarative alert engine over the registry and its history rings; port
of ``srnn_tpu/telemetry/alerts.py`` (the run, serve and pool rule
tables).

An :class:`AlertEngine` evaluates a small :class:`Rule` table at every
history sample (once a chunk):

  * ``threshold`` -- the metric's latest value (label sets summed)
    against a bound (``soup_health_nan_frac > 0.02``);
  * ``rate`` -- the per-second rate over a trailing window (watchdog trips
    arriving);
  * ``absence`` -- the metric has not been sampled within the window (with
    a grace of one window from the first evaluation).

Rules latch per name: the ``firing`` and ``cleared`` edges are reported
once each.  Every firing increments ``soup_alerts_total{rule=}``, the
active count rides the ``soup_alerts_active`` gauge, and the caller emits
each transition as a ``{"kind": "alert"}`` events row
(``exporter.LivePlane``; the experiment service and its fleet front
emit their own).
"""

import threading
from typing import Callable, Dict, List, Optional

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

KINDS = ("threshold", "rate", "absence")


class Rule:
    """One declarative alert rule: ``metric`` the bare registry name,
    ``kind`` one of ``threshold`` / ``rate`` / ``absence``, ``op`` and
    ``value`` the bound, ``window_s`` the rate window or the staleness
    bound."""

    def __init__(self, *, name: str, metric: str, kind: str = "threshold",
                 op: str = ">", value: float = 0.0, window_s: float = 60.0,
                 help: str = ""):
        if kind not in KINDS:
            raise ValueError(f"rule {name!r}: unknown kind {kind!r} "
                             f"(expected one of {KINDS})")
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: unknown op {op!r} "
                             f"(expected one of {sorted(_OPS)})")
        self.name = name
        self.metric = metric
        self.kind = kind
        self.op = op
        self.value = float(value)
        self.window_s = float(window_s)
        self.help = help

    def __repr__(self):
        bound = (f"stale>{self.window_s:g}s" if self.kind == "absence"
                 else f"{self.op}{self.value:g}"
                 + (f"/{self.window_s:g}s" if self.kind == "rate" else ""))
        return f"Rule({self.name}: {self.kind} {self.metric} {bound})"


def default_run_rules(*, nan_frac: float = 0.02, zero_frac: float = 0.9,
                      straggler_skew: float = 4.0) -> List[Rule]:
    """The mega runs' rule table (the JAX package's; thresholds mirror the
    watchdog's defaults).  A rule over a metric a run never registers (the
    straggler gauge of a one-process run) never fires."""
    return [
        Rule(name="soup_nan_frac", metric="soup_health_nan_frac",
             kind="threshold", op=">", value=nan_frac,
             help="NaN/Inf particle fraction past the divergence bound"),
        Rule(name="soup_zero_collapse", metric="soup_health_zero_frac",
             kind="threshold", op=">", value=zero_frac,
             help="population collapsing to the zero fixpoint"),
        Rule(name="soup_straggler_skew",
             metric="soup_straggler_skew_ratio",
             kind="threshold", op=">=", value=straggler_skew,
             help="fastest/slowest process gens-per-sec skew (a host is "
                  "dragging the fleet)"),
        Rule(name="soup_watchdog_burn", metric="soup_watchdog_trips_total",
             kind="rate", op=">", value=0.0, window_s=600.0,
             help="watchdog trips arriving (anomalous chunks)"),
    ]


def default_serve_rules(*, max_queue: int = 0,
                        window_s: float = 60.0) -> List[Rule]:
    """The experiment service's rule table.  The queue-depth bound is
    ``--max-queue`` when admission control is armed (depth AT the bound
    means submits are being rejected) and a generous default otherwise."""
    depth = float(max_queue) if max_queue else 512.0
    return [
        Rule(name="serve_queue_full", metric="serve_queue_depth",
             kind="threshold", op=">=", value=depth,
             help="dispatch queue at the admission bound"),
        Rule(name="serve_slo_burn", metric="serve_slo_violations_total",
             kind="rate", op=">", value=0.0, window_s=window_s,
             help="requests exceeding the --slo-p95-ms target"),
        Rule(name="serve_overload", metric="serve_overload_rejections_total",
             kind="rate", op=">", value=0.0, window_s=window_s,
             help="submits rejected at admission"),
    ]


def default_pool_rules(*, workers: int,
                       window_s: float = 60.0) -> List[Rule]:
    """The serve fleet's rule table (the front process's engine, layered
    on ``default_serve_rules``): a fleet running below its configured
    worker count, and worker deaths arriving at all, both page -- the
    replay ladder heals the work, the alert names the capacity loss."""
    return [
        Rule(name="serve_worker_down", metric="serve_workers",
             kind="threshold", op="<", value=float(workers),
             help="live workers below the configured --workers count"),
        Rule(name="serve_worker_churn", metric="serve_worker_deaths_total",
             kind="rate", op=">", value=0.0, window_s=window_s,
             help="worker processes dying (replay ladder active)"),
    ]


class AlertEngine:
    """Evaluate a rule table against one registry and history pair.

    ``evaluate()`` returns this turn's transitions (``state: "firing" |
    "cleared"`` dicts, ready for an events row); ``active()`` snapshots the
    firing set (read from other threads by /healthz -- locked)."""

    def __init__(self, rules: List[Rule], registry, history):
        self.rules = list(rules)
        self.registry = registry
        self.history = history
        self._lock = threading.Lock()
        self._state: Dict[str, dict] = {}
        self._born: Optional[float] = None
        # registered at once, so that a clean run scrapes the 0
        registry.counter("soup_alerts_total",
                         help="alert rule firing transitions")
        registry.gauge("soup_alerts_active",
                       help="alert rules currently firing").set(0)

    def _check(self, rule: Rule, now: float):
        """(value, firing) of one rule at ``now``."""
        if rule.kind == "absence":
            age = self.history.age_s(rule.metric, now=now)
            if age is None:
                born = self._born if self._born is not None else now
                return None, (now - born) > rule.window_s
            return round(age, 3), age > rule.window_s
        if rule.kind == "rate":
            r = self.history.rate(rule.metric, rule.window_s, now=now)
            if r is None:
                return None, False
            return round(r, 6), _OPS[rule.op](r, rule.value)
        v = self.history.latest_sum(rule.metric)
        if v is None:
            return None, False
        return round(v, 6), _OPS[rule.op](v, rule.value)

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation turn (after ``history.sample()``, so that the
        rules see the sample they ride with).  Returns the transitions."""
        now = self.history.now() if now is None else float(now)
        transitions: List[dict] = []
        with self._lock:
            if self._born is None:
                self._born = now
            for rule in self.rules:
                value, firing = self._check(rule, now)
                st = self._state.setdefault(
                    rule.name, {"firing": False, "since": None,
                                "value": None})
                if firing:
                    st["value"] = value
                if firing and not st["firing"]:
                    st.update(firing=True, since=now)
                    transitions.append(self._transition(
                        rule, "firing", value))
                    self.registry.counter(
                        "soup_alerts_total",
                        help="alert rule firing transitions").inc(
                            1, rule=rule.name)
                elif not firing and st["firing"]:
                    st.update(firing=False, since=now)
                    transitions.append(self._transition(
                        rule, "cleared", value))
            n_active = sum(1 for st in self._state.values()
                           if st["firing"])
        self.registry.gauge("soup_alerts_active",
                            help="alert rules currently firing").set(
                                n_active)
        return transitions

    @staticmethod
    def _transition(rule: Rule, state: str, value) -> dict:
        return {"rule": rule.name, "state": state, "metric": rule.metric,
                "rule_kind": rule.kind, "value": value,
                "threshold": (None if rule.kind == "absence"
                              else rule.value),
                "window_s": (rule.window_s
                             if rule.kind in ("rate", "absence") else None),
                "help": rule.help or None}

    def active(self) -> List[dict]:
        """The firing rules (name, observed value, seconds since the
        firing edge)."""
        now = self.history.now()
        with self._lock:
            return [{"rule": name, "value": st["value"],
                     "for_s": round(now - st["since"], 1)
                     if st["since"] is not None else None}
                    for name, st in sorted(self._state.items())
                    if st["firing"]]
