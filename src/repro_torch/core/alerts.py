"""Declarative SLO alerting over the metrics timeline.

Three rule kinds, evaluated at block cadence against the ``MetricsRegistry``
snapshot timeline (never against live device state — an alert decision is a
pure function of the recorded timeline, which is what makes every firing
*auditable*: replaying the rule over the same snapshots must reproduce it):

* ``threshold`` — a gauge/counter series (or a histogram quantile via the
  shared ``quantile_from_buckets`` helper) compared against a bound.
* ``burn_rate`` — the SRE error-budget burn multiple over a trailing
  window: ``(Δbad / Δ(bad+good)) / (1 - slo_target)`` computed from the
  timeline deltas between ``query(now - window)`` and ``query(now)``;
  fires when the multiple exceeds ``threshold`` (1.0 = burning budget
  exactly as fast as the SLO allows).
* ``baseline_delta`` — relative deviation of a series from a fixed
  expected baseline (e.g. energy-per-token drifting from a calibrated
  value).

Firings are edge-triggered (a rule increments ``greenllm_alerts_total
{rule,severity}`` when it *transitions* into the firing state, and the
engine keeps a resolved/firing state machine), logged as typed ``Alert``
records, and mirrored as tracer instant events when a tracer is attached.
``audit()`` re-evaluates every logged firing from the timeline and raises
if any is not reproducible.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

from .metrics import MetricsRegistry, quantile_from_buckets

__all__ = ["AlertRule", "Alert", "AlertEngine"]


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule.  Use the classmethod constructors — the flat
    field set is the union over the three kinds."""
    name: str
    kind: str                           # threshold | burn_rate | baseline_delta
    metric: str = ""                    # family name (threshold/baseline)
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    op: str = ">"                       # threshold comparison: > or <
    bound: float = 0.0                  # threshold bound / baseline value
    quantile: Optional[float] = None    # threshold over histogram quantile
    window_s: float = 1.0               # burn_rate trailing window
    slo_target: float = 0.95            # burn_rate availability target
    burn_threshold: float = 1.0         # burn multiple that fires
    min_events: int = 1                 # burn_rate min Δtotal (debounce)
    bad_labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    good_labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    rel_delta: float = 0.1              # baseline_delta relative deviation
    severity: str = "warning"

    @classmethod
    def threshold(cls, name: str, metric: str, op: str, bound: float, *,
                  labels: Optional[Mapping[str, str]] = None,
                  quantile: Optional[float] = None,
                  severity: str = "warning") -> "AlertRule":
        if op not in (">", "<"):
            raise ValueError(f"threshold op must be '>' or '<', got {op!r}")
        return cls(name=name, kind="threshold", metric=metric, op=op,
                   bound=bound, labels=dict(labels or {}), quantile=quantile,
                   severity=severity)

    @classmethod
    def burn_rate(cls, name: str, metric: str, *,
                  bad_labels: Mapping[str, str],
                  good_labels: Mapping[str, str],
                  window_s: float, slo_target: float,
                  burn_threshold: float = 1.0, min_events: int = 1,
                  severity: str = "page") -> "AlertRule":
        if not 0.0 <= slo_target < 1.0:
            raise ValueError(
                f"slo_target must be in [0, 1) — a target of 1.0 has no "
                f"error budget to burn (got {slo_target})")
        return cls(name=name, kind="burn_rate", metric=metric,
                   bad_labels=dict(bad_labels), good_labels=dict(good_labels),
                   window_s=window_s, slo_target=slo_target,
                   burn_threshold=burn_threshold, min_events=min_events,
                   severity=severity)

    @classmethod
    def baseline_delta(cls, name: str, metric: str, baseline: float,
                       rel_delta: float, *,
                       labels: Optional[Mapping[str, str]] = None,
                       severity: str = "warning") -> "AlertRule":
        if baseline == 0.0:
            raise ValueError("baseline_delta needs a nonzero baseline")
        return cls(name=name, kind="baseline_delta", metric=metric,
                   bound=baseline, rel_delta=rel_delta,
                   labels=dict(labels or {}), severity=severity)


@dataclasses.dataclass(frozen=True)
class Alert:
    """One edge-triggered firing (or resolution) of a rule."""
    t: float
    rule: str
    severity: str
    value: float                        # the quantity the rule compared
    fired: bool                         # False = resolved transition
    message: str = ""


def _select(snap: Mapping[str, float], metric: str,
            labels: Mapping[str, str]) -> List[Tuple[str, float]]:
    """All series of family ``metric`` whose label set includes ``labels``
    (matched on the flat-key text; label values here are trusted metric
    constants, not hostile strings)."""
    out = []
    want = [f'{k}="{v}"' for k, v in labels.items()]
    for key, val in snap.items():
        if not key.startswith(metric):
            continue
        rest = key[len(metric):]
        if rest and not rest.startswith("{"):
            continue                     # longer family name sharing a prefix
        if all(w in rest for w in want):
            out.append((key, val))
    return out


class AlertEngine:
    """Evaluate rules against a registry's timeline at block cadence."""

    def __init__(self, registry: MetricsRegistry, rules, tracer=None):
        self.registry = registry
        self.rules: List[AlertRule] = list(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.tracer = tracer
        self._counter = registry.counter(
            "greenllm_alerts_total", "alert rule firings (edge-triggered)",
            ("rule", "severity"))
        # pre-bind children so alert series exist at 0 before any firing
        self._children = {r.name: self._counter.labels(rule=r.name,
                                                       severity=r.severity)
                          for r in self.rules}
        self._firing: Dict[str, bool] = {r.name: False for r in self.rules}
        self.log: List[Alert] = []

    # -- rule evaluation (pure functions of the timeline) --------------------
    def _eval(self, rule: AlertRule, now: float) -> Tuple[float, bool]:
        """(value, firing) for ``rule`` at ``now``, reading only timeline
        snapshots — so ``audit()`` can reproduce every decision."""
        snap = self.registry.query(now)
        if snap is None:
            return math.nan, False
        if rule.kind == "threshold":
            if rule.quantile is not None:
                pairs = []
                for key, val in _select(snap, rule.metric + "_bucket",
                                        rule.labels):
                    le = key.rsplit('le="', 1)[1].split('"', 1)[0]
                    pairs.append((float(le), val))
                value = quantile_from_buckets(pairs, rule.quantile) \
                    if pairs else math.nan
            else:
                series = _select(snap, rule.metric, rule.labels)
                value = max((v for _, v in series), default=math.nan)
            if value != value:
                return value, False
            return value, (value > rule.bound if rule.op == ">"
                           else value < rule.bound)
        if rule.kind == "burn_rate":
            past = self.registry.query(now - rule.window_s) or {}

            def delta(labels):
                cur = sum(v for _, v in
                          _select(snap, rule.metric, labels))
                old = sum(v for _, v in
                          _select(past, rule.metric, labels))
                return max(cur - old, 0.0)

            bad = delta(rule.bad_labels)
            total = bad + delta(rule.good_labels)
            if total < rule.min_events:
                return 0.0, False
            burn = (bad / total) / (1.0 - rule.slo_target)
            return burn, burn >= rule.burn_threshold
        if rule.kind == "baseline_delta":
            series = _select(snap, rule.metric, rule.labels)
            value = max((v for _, v in series), default=math.nan)
            if value != value:
                return value, False
            dev = abs(value - rule.bound) / abs(rule.bound)
            return dev, dev > rule.rel_delta
        raise ValueError(f"unknown rule kind {rule.kind!r}")

    def evaluate(self, now: float) -> List[Alert]:
        """One evaluation round; returns the transitions it produced."""
        fired: List[Alert] = []
        for rule in self.rules:
            value, firing = self._eval(rule, now)
            was = self._firing[rule.name]
            if firing == was:
                continue
            self._firing[rule.name] = firing
            a = Alert(t=now, rule=rule.name, severity=rule.severity,
                      value=value, fired=firing,
                      message=f"{rule.kind} {'fired' if firing else 'resolved'}"
                              f" at {value:.4g}")
            self.log.append(a)
            fired.append(a)
            if firing:
                self._children[rule.name].inc()
            if self.tracer is not None:
                self.tracer.instant(
                    "alert" if firing else "alert_resolved", -1, now,
                    "alerts", rule=rule.name, severity=rule.severity,
                    value=float(value))
        return fired

    def firing(self) -> List[str]:
        """Names of the rules currently in the firing state."""
        return [n for n, f in self._firing.items() if f]

    def audit(self) -> int:
        """Re-derive every logged firing from the timeline: each ``fired``
        record's rule must evaluate to firing at the recorded instant with
        the recorded value.  Returns the number of firings audited; raises
        AssertionError on any non-reproducible alert."""
        by_name = {r.name: r for r in self.rules}
        audited = 0
        for a in self.log:
            if not a.fired:
                continue
            value, firing = self._eval(by_name[a.rule], a.t)
            assert firing, (
                f"alert {a.rule!r} @ t={a.t:.4f} does not reproduce from "
                f"the timeline (re-evaluated value {value:.4g})")
            assert value == a.value or (value != value and a.value != a.value), (
                f"alert {a.rule!r} @ t={a.t:.4f}: logged value {a.value!r} "
                f"!= timeline value {value!r}")
            audited += 1
        return audited
