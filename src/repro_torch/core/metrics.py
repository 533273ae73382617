"""Production metrics: a labelled counter/gauge/histogram registry with
Prometheus text exposition and a JSONL snapshot timeline.

GreenLLM's headline claim — energy saved at bounded SLO damage — is a
*telemetry* claim, so the serving planes publish first-class metrics instead
of only post-hoc ``ServingReport``s: per-replica SM frequency, per-phase
energy, page-pool occupancy, queue depths, lifecycle counters, TTFT/TBT
histograms.  The registry is deliberately small and dependency-free:

* ``Counter`` / ``Gauge`` / ``Histogram`` families with label names; children
  are created lazily per label-value tuple and cached, so the hot path is a
  dict lookup + float add.
* ``render_prometheus()`` emits the text exposition format (``# HELP`` /
  ``# TYPE`` + one line per series; histograms as ``_bucket``/``_sum``/
  ``_count`` with cumulative ``le`` buckets).  ``parse_prometheus`` is the
  matching validator used by CI and tests.
* ``record_snapshot(t)`` appends a flat ``{series: value}`` dict to an
  in-memory timeline keyed by *virtual-clock* time; ``query(t)`` returns the
  last snapshot at or before ``t``, which is what makes frequency / energy /
  occupancy / tail-TBT queryable at any instant of a replayed trace.
  ``write_timeline_jsonl`` / ``read_timeline_jsonl`` round-trip it.

Emission rides the backends' existing block cadence (see
``serving.engine``): metric updates are host-side float math on values the
engine already computed — publishing adds **no device syncs**, and a backend
with no registry installed skips every site (the ``events_on`` pattern).

Metric *names* are a stable API (ROADMAP invariants): renaming a series
is a breaking change to every dashboard built on it.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple


def _format_value(v: float) -> str:
    if v != v:                  # NaN first: int(nan) raises
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    """Text-exposition label-value escaping: backslash, double quote and
    newline (in that order — escaping the escape char first)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


# flat() runs at block cadence and rebuilds the key of every live series
# each snapshot; label escaping made that measurably hot, so keys are
# memoized (sound: children are immutable per label-value tuple, and the
# cache is bounded by series cardinality)
_KEY_CACHE: Dict[Tuple[str, Tuple[str, ...], Tuple[str, ...]], str] = {}


def _series_key(name: str, labelnames: Sequence[str],
                labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return name
    ck = (name, tuple(labelnames), tuple(labelvalues))
    key = _KEY_CACHE.get(ck)
    if key is None:
        inner = ",".join(f'{k}="{_escape_label(v)}"'
                         for k, v in zip(labelnames, labelvalues))
        key = _KEY_CACHE[ck] = f"{name}{{{inner}}}"
    return key


class _Family:
    """Shared plumbing of a metric family: label handling + child cache."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child(self, labelvalues: Tuple[str, ...]):
        c = self._children.get(labelvalues)
        if c is None:
            if len(labelvalues) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected labels {self.labelnames}, "
                    f"got {labelvalues}")
            c = self._make_child()
            self._children[labelvalues] = c
        return c

    def labels(self, *labelvalues, **labelkv):
        """Bind a child for one label-value combination (cached).  Hot
        paths should bind once and hold the child."""
        if labelkv:
            labelvalues = tuple(str(labelkv[k]) for k in self.labelnames)
        else:
            labelvalues = tuple(str(v) for v in labelvalues)
        return self._child(labelvalues)

    def _make_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def samples(self) -> Iterable[Tuple[str, Tuple[str, ...], float]]:
        """(suffix, labelvalue-extension, value) triples for exposition."""
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc {amount})")
        self.value += amount


class Counter(_Family):
    """Monotone cumulative count (requests, joules, tokens, faults)."""

    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount) if self.labelnames \
            else self._child(()).inc(amount)

    def samples(self):
        for lv, c in self._children.items():
            yield "", lv, c.value


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge(_Family):
    """Point-in-time value (frequency, occupancy, queue depth)."""

    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float, **labels) -> None:
        (self.labels(**labels) if self.labelnames
         else self._child(())).set(value)

    def samples(self):
        for lv, c in self._children.items():
            yield "", lv, c.value


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)      # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value`` ``n`` times (``n`` > 1 for per-step TBTs shared
        by a whole decode batch — exact, without n python calls)."""
        i = bisect.bisect_left(self.buckets, value)
        self.counts[i] += n
        self.sum += value * n
        self.count += n

    def quantile(self, q: float) -> float:
        """Bucket-quantile estimate (p50/p95/p99) from this child's
        cumulative counts — see ``quantile_from_buckets``."""
        pairs: List[Tuple[float, float]] = []
        cum = 0
        for b, n in zip(self.buckets, self.counts):
            cum += n
            pairs.append((b, float(cum)))
        pairs.append((math.inf, float(self.count)))
        return quantile_from_buckets(pairs, q)


def quantile_from_buckets(pairs: Sequence[Tuple[float, float]],
                          q: float) -> float:
    """Prometheus-style ``histogram_quantile`` over cumulative buckets:
    ``pairs`` is ``(le, cumulative_count)`` including the ``+Inf`` bucket.
    Linear interpolation inside the bucket containing rank ``q * count``;
    a rank landing in the ``+Inf`` bucket clamps to the highest finite
    bound (there is no upper edge to interpolate toward).  Returns NaN on
    an empty histogram.  This is the one shared implementation for alert
    rules, the dashboard, and ad-hoc analysis — don't re-derive it.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    pairs = sorted(pairs, key=lambda p: p[0])
    if not pairs:
        return math.nan
    total = pairs[-1][1]
    if total <= 0:
        return math.nan
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0        # implicit lower edge of bucket 0
    for le, cum in pairs:
        if cum >= rank:
            if math.isinf(le):
                return prev_le          # clamp: highest finite bound
            if cum == prev_cum:
                return le
            return prev_le + (le - prev_le) * (rank - prev_cum) \
                / (cum - prev_cum)
        prev_le, prev_cum = le, cum
    return prev_le


DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


class Histogram(_Family):
    """Cumulative-bucket distribution (TTFT, TBT)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float, n: int = 1, **labels) -> None:
        (self.labels(**labels) if self.labelnames
         else self._child(())).observe(value, n)

    def quantile(self, q: float, **labels) -> float:
        """Bucket-quantile estimate for one child (NaN when empty)."""
        return (self.labels(**labels) if self.labelnames
                else self._child(())).quantile(q)

    def samples(self):
        for lv, c in self._children.items():
            cum = 0
            for b, n in zip(self.buckets, c.counts):
                cum += n
                yield "_bucket", lv + (("le", _format_value(b)),), float(cum)
            yield "_bucket", lv + (("le", "+Inf"),), float(c.count)
            yield "_sum", lv, c.sum
            yield "_count", lv, float(c.count)


class MetricsRegistry:
    """One namespace of metric families plus the snapshot timeline.

    ``snapshot_min_dt`` throttles ``record_snapshot``: a backend may call it
    every block, and the registry keeps at most one snapshot per
    ``snapshot_min_dt`` virtual seconds (0 keeps everything).
    """

    def __init__(self, snapshot_min_dt: float = 0.0):
        self._families: Dict[str, _Family] = {}
        self.snapshot_min_dt = float(snapshot_min_dt)
        self.timeline: List[Tuple[float, Dict[str, float]]] = []

    # -- family construction (get-or-create, type-checked) ---------------------
    def _get(self, cls, name: str, help: str, labelnames, **kw):
        fam = self._families.get(name)
        if fam is None:
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam
        if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} re-registered with a different type or "
                f"label set ({fam.kind}{fam.labelnames} vs "
                f"{cls.kind}{tuple(labelnames)})")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    # -- export -----------------------------------------------------------------
    def flat(self) -> Dict[str, float]:
        """Every series as ``name{label="v",...} -> value`` (histograms
        expanded to ``_bucket``/``_sum``/``_count``)."""
        out: Dict[str, float] = {}
        for fam in self._families.values():
            base = list(fam.labelnames)
            for suffix, lv, value in fam.samples():
                if suffix == "_bucket":
                    names = base + [lv[-1][0]]
                    values = list(lv[:-1]) + [lv[-1][1]]
                else:
                    names, values = base, list(lv)
                out[_series_key(fam.name + suffix, names, values)] = value
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            base = list(fam.labelnames)
            for suffix, lv, value in fam.samples():
                if suffix == "_bucket":
                    names = base + [lv[-1][0]]
                    values = list(lv[:-1]) + [lv[-1][1]]
                else:
                    names, values = base, list(lv)
                key = _series_key(fam.name + suffix, names, values)
                lines.append(f"{key} {_format_value(value)}")
        return "\n".join(lines) + "\n"

    # -- the timeline -----------------------------------------------------------
    def record_snapshot(self, t: float) -> bool:
        """Append the current flat view at virtual time ``t`` (throttled by
        ``snapshot_min_dt``; a later call at the same ``t`` replaces the
        snapshot so one instant has one state).  Returns True if recorded."""
        if self.timeline:
            last_t = self.timeline[-1][0]
            if t < last_t:
                return False             # clocks never move backwards
            if t == last_t:
                self.timeline[-1] = (t, self.flat())
                return True
            if self.snapshot_min_dt and t - last_t < self.snapshot_min_dt:
                return False
        self.timeline.append((float(t), self.flat()))
        return True

    def query(self, t: float) -> Optional[Dict[str, float]]:
        """The metric state at virtual instant ``t``: the last snapshot at
        or before ``t`` (None before the first snapshot)."""
        times = [s[0] for s in self.timeline]
        i = bisect.bisect_right(times, t)
        return None if i == 0 else self.timeline[i - 1][1]

    def series(self, key: str) -> List[Tuple[float, float]]:
        """One series' (t, value) trajectory across the timeline (missing
        snapshots skipped) — e.g. a replica's frequency over the run."""
        return [(t, snap[key]) for t, snap in self.timeline if key in snap]

    def write_timeline_jsonl(self, path: str) -> int:
        """One JSON object per snapshot: ``{"t": .., "metrics": {...}}``.
        Returns the number of lines written."""
        with open(path, "w") as fh:
            for t, snap in self.timeline:
                fh.write(json.dumps({"t": t, "metrics": snap}) + "\n")
        return len(self.timeline)


def read_timeline_jsonl(path: str) -> List[Tuple[float, Dict[str, float]]]:
    out = []
    with open(path) as fh:
        for line in fh:
            if line.strip():
                doc = json.loads(line)
                out.append((float(doc["t"]), dict(doc["metrics"])))
    return out


def _parse_series(line: str, lineno: int) -> Tuple[str, str]:
    """Split one sample line into (series key, raw value), scanning the
    label block character-by-character: quoted label values may contain
    commas, spaces, braces and the escapes ``\\\\``, ``\\"``, ``\\n``, so
    naive ``split(",")`` / ``rpartition(" ")`` slicing is wrong on hostile
    labels.  The key keeps the escaped text verbatim — exactly what
    ``flat()`` uses — so exposition round-trips key-for-key."""
    n = len(line)
    i = 0
    while i < n and (line[i].isalnum() or line[i] in "_:"):
        i += 1
    name = line[:i]
    if not name or not (name[0].isalpha() or name[0] == "_"):
        raise ValueError(f"line {lineno}: bad metric name in {line!r}")
    if i < n and line[i] == "{":
        i += 1
        while True:
            if i >= n:
                raise ValueError(f"line {lineno}: unbalanced labels: {line!r}")
            if line[i] == "}":
                i += 1
                break
            j = i
            while j < n and (line[j].isalnum() or line[j] == "_"):
                j += 1
            if j == i or line[i].isdigit() or j >= n or line[j] != "=":
                raise ValueError(
                    f"line {lineno}: bad label name at col {i}: {line!r}")
            i = j + 1
            if i >= n or line[i] != '"':
                raise ValueError(
                    f"line {lineno}: unquoted label value: {line!r}")
            i += 1
            while i < n and line[i] != '"':
                if line[i] == "\\":
                    if i + 1 >= n or line[i + 1] not in ('\\', '"', 'n'):
                        raise ValueError(
                            f"line {lineno}: bad escape at col {i}: {line!r}")
                    i += 1
                i += 1
            if i >= n:
                raise ValueError(
                    f"line {lineno}: unterminated label value: {line!r}")
            i += 1                       # closing quote
            if i < n and line[i] == ",":
                i += 1                   # separator (or legal trailing comma)
            elif i >= n or line[i] != "}":
                raise ValueError(
                    f"line {lineno}: expected ',' or '}}' at col {i}: "
                    f"{line!r}")
    key = line[:i]
    rest = line[i:]
    if not rest or rest[0] not in " \t":
        raise ValueError(f"line {lineno}: no value: {line!r}")
    fields = rest.split()
    if not fields:
        raise ValueError(f"line {lineno}: no value: {line!r}")
    return key, fields[0]                # fields[1], if any, is a timestamp


def parse_prometheus(text: str) -> Dict[str, float]:
    """Validating parser for the text exposition format: returns
    ``{series_key: value}`` and raises ``ValueError`` on malformed lines.
    Used by CI to check that what ``render_prometheus`` wrote is readable;
    round-trips hostile label values (quotes, commas, newlines, braces,
    backslashes) and legal non-finite samples (``NaN``, ``+Inf``)."""
    out: Dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, raw = _parse_series(line, lineno)
        try:
            out[key] = float(raw)
        except ValueError as e:
            raise ValueError(f"line {lineno}: bad value {raw!r}") from e
    return out
