"""The reduction of a ``torch.profiler`` trace of whole engine rounds.

The profiler records host operators (CPU activity) and device activity
(CUDA: kernels, copies, fills).  Its raw events are read in memory
(``kineto_results.events()``), not written out.  From them:

* ``busy_s``: the union of the device's activity intervals;
* ``window_s``: the traced slice, from the profiler's start to its stop;
* the device time by kernel name, and by a family of name patterns;
* the idle gaps of the device, each named by the innermost host operator
  that was running across its middle on the harness's thread.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Ev:
    name: str
    device: bool                # on the device (else a host operator)
    start_ns: int
    end_ns: int
    thread: int = 0


def events_of(prof) -> List[Ev]:
    """The raw events of a stopped ``torch.profiler.profile``.  A host
    range (``record_function``) also appears on the device's timeline as a
    user annotation spanning the work launched in it; it is not device
    activity and is left out there."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        if dur <= 0:
            continue
        dev = "CUDA" in str(e.device_type())
        if dev and e.is_user_annotation():
            continue
        thread = 0 if dev else e.start_thread_id()
        out.append(Ev(e.name(), dev, e.start_ns(), e.start_ns() + dur,
                      thread))
    return out


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class Slice:
    start_ns: int
    end_ns: int
    events: Sequence[Ev]
    host_thread: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def _device(self) -> List[Ev]:
        return [e for e in self.events if e.device
                and e.end_ns > self.start_ns and e.start_ns < self.end_ns]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        return merge((max(e.start_ns, self.start_ns),
                      min(e.end_ns, self.end_ns)) for e in self._device())

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def by_name(self) -> Dict[str, float]:
        """Device seconds by activity name."""
        out: Dict[str, float] = defaultdict(float)
        for e in self._device():
            out[e.name] += (min(e.end_ns, self.end_ns)
                            - max(e.start_ns, self.start_ns)) / 1e9
        return dict(out)

    def family_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the activities whose name holds any of
        ``patterns`` (union of their intervals)."""
        return sum(b - a for a, b in merge(
            (max(e.start_ns, self.start_ns), min(e.end_ns, self.end_ns))
            for e in self._device()
            if any(p in e.name for p in patterns))) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        out, t = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end_ns > t:
            out.append((t, self.end_ns))
        return out

    def idle_by_host_op(self) -> Dict[str, float]:
        """Idle device seconds by the innermost host operator running
        across each gap's middle ("no host operator" where none was)."""
        host = sorted((e for e in self.events
                       if not e.device and e.thread == self.host_thread),
                      key=lambda e: (e.start_ns, -e.end_ns))
        starts = [e.start_ns for e in host]
        out: Dict[str, float] = defaultdict(float)
        gaps = sorted(self.gaps(), key=lambda g: g[0] + g[1])
        stack: List[Ev] = []
        i = 0
        for a, b in gaps:
            mid = (a + b) // 2
            j = bisect.bisect_right(starts, mid)
            while i < j:
                stack.append(host[i])
                i += 1
            # host operators on one thread nest: one that has ended lies
            # above every one that still runs
            name = "no host operator"
            for e in reversed(stack):
                if e.end_ns > mid:
                    name = e.name
                    break
            while stack and stack[-1].end_ns <= mid:
                stack.pop()
            out[name] += (b - a) / 1e9
        return dict(out)


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k[:200], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
