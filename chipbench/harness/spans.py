"""The serving engine's profiler ranges in a traced slice.

The port's engine opens ``record_function`` ranges named ``serve.*`` at its
layer boundaries while a profiler records (``serving/engine.py``): the
round (``serve.step``), admission, a prompt's prefill, a chunk, page
growth, a decode block and each of its steps, and the block's bookkeeping.
They run on the thread that calls ``step()``, the harness's own.  A
metric's ``spans.txt`` names the ranges it reads, each matched whole: a
range named ``serve.decode`` is not ``serve.decode.step``.  A reader that
finds none of its ranges in the slice (a program without them) returns
None.
"""
from __future__ import annotations

from typing import List, Optional

from chipbench.harness.trace import Ev, Slice

PREFIX = "serve."


def _ranges(sl: Slice) -> List[Ev]:
    return [e for e in sl.events if not e.device
            and e.thread == sl.host_thread and e.name.startswith(PREFIX)]


def serve_slice(sl: Slice) -> Slice:
    """A copy of ``sl`` whose host events are only the engine's ranges on
    its thread, so that an idle gap is named by the innermost range."""
    return Slice(sl.start_ns, sl.end_ns,
                 [e for e in sl.events if e.device] + _ranges(sl),
                 sl.host_thread)


def idle_share_under(r) -> Optional[float]:
    """Share of the traced slice with the device idle while the innermost
    ``serve.*`` range is one of ``r.patterns``, in %."""
    sl = r.slice
    if sl is None or sl.window_s <= 0 or not any(
            e.name in r.patterns and e.end_ns > sl.start_ns
            and e.start_ns < sl.end_ns for e in _ranges(sl)):
        return None
    idle = serve_slice(sl).idle_by_host_op()
    return 100.0 * sum(idle.get(n, 0.0) for n in r.patterns) / sl.window_s


def mean_range_ms(r) -> Optional[float]:
    """Mean duration of the ranges named in ``r.patterns`` that lie wholly
    in the traced slice, in ms."""
    sl = r.slice
    if sl is None:
        return None
    d = [e.end_ns - e.start_ns for e in _ranges(sl) if e.name in r.patterns
         and e.start_ns >= sl.start_ns and e.end_ns <= sl.end_ns]
    return sum(d) / len(d) / 1e6 if d else None
