"""The end-to-end metrics, from the host-clock stamps of drained events.

Each request carries: when it was due (open loop) or sent (closed loop),
the drain time of its first and last token, its token count, and its
finish drain time.  The window is ``[t0, t1]``; ``t1`` is the end of the
first engine round that reaches ``t0 + seconds``, so the window holds whole
rounds and a rate is taken over all of its work and all of its time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile by linear interpolation between order
    statistics (numpy's default): rank (n - 1) * p / 100.  An infinite
    value (a request that never got its token) sorts last."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    r = (len(xs) - 1) * p / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if r > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


@dataclasses.dataclass
class Record:
    prompt_len: int
    max_tokens: int
    sent: float                         # due time (open) or submit time
    first: Optional[float] = None       # drain time of the first token
    last: Optional[float] = None        # drain time of the last token
    tokens: int = 0
    finished: Optional[float] = None
    failed: bool = False
    preempted: int = 0


def ttft_s(records: Sequence[Record], t0: float, t1: float) -> List[float]:
    """Time to first token of every request due in [t0, t1), from when it
    was due; a request with no first token (failed) is infinite."""
    return [(r.first - r.sent) if r.first is not None and not r.failed
            else math.inf for r in records if t0 <= r.sent < t1]


def tpot_s(records: Sequence[Record], t0: float, t1: float) -> List[float]:
    """(last token's drain - first token's) / (tokens - 1) of every
    request that finished in [t0, t1] with two tokens or more."""
    return [(r.last - r.first) / (r.tokens - 1) for r in records
            if r.finished is not None and t0 <= r.finished <= t1
            and r.tokens > 1]


def window_metrics(records: Sequence[Record], drained: Sequence,
                   t0: float, t1: float, joules: float) -> Dict[str, float]:
    """Every end-to-end metric but ``setup_s`` over the window [t0, t1].

    ``drained``: (drain time, tokens) of every token drain; ``joules``: the
    card's energy over the window."""
    out_tok = sum(n for t, n in drained if t0 <= t <= t1)
    in_tok = sum(r.prompt_len for r in records
                 if r.first is not None and t0 <= r.first <= t1)
    res = {"out_tok_s": out_tok / (t1 - t0),
           "j_per_tok": joules / (in_tok + out_tok)
           if in_tok + out_tok else math.inf}
    ttft = ttft_s(records, t0, t1)
    if ttft:
        res["ttft_p90_ms"] = 1e3 * percentile(ttft, 90)
    tpot = tpot_s(records, t0, t1)
    if tpot:
        res["tpot_p90_ms"] = 1e3 * percentile(tpot, 90)
    return res

