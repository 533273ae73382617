"""One generator for every traffic mix; a mix is a file of parameters.

A mix (``traffic/<name>.json``) gives:

* ``loop``: ``"open"`` (arrivals on a schedule, at ``rate`` requests a
  second) or ``"closed"`` (``clients`` callers, each sending its next
  request as soon as its last one finished, with no think time);
* ``prompt`` and ``output``: lognormal lengths in tokens, ``{"median",
  "sigma", "min", "max"}``, clipped to [min, max].

Lengths are not drawn at random: a run uses a fixed list of the
distribution's quantiles, and the seed only shuffles their order (and the
arrival gaps and the token ids).  Every seed then serves the same multiset
of lengths, so token totals do not swing with the seed.  An open loop takes
``round(rate * seconds)`` prompt and output quantiles and as many gaps, the
quantiles of an exponential distribution (Poisson arrivals), scaled to fill
the window exactly.  A closed loop takes its requests in blocks of
``clients``, each block a fresh permutation of the same quantile lists, so
any number of whole blocks holds the same lengths.  Token ids are uniform
over the vocabulary; no prefix is shared.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, Iterator, List, Optional

import numpy as np

# independent streams of one seed
_IDS, _ORDER, _GAPS, _WARM = 1, 2, 3, 4


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def lognormal_quantiles(n: int, spec: Dict) -> List[int]:
    """The n quantiles at (i + 1/2) / n of a lognormal length distribution
    (``median``, ``sigma``), rounded and clipped to [``min``, ``max``]."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        x = round(spec["median"] * math.exp(spec["sigma"] * z))
        out.append(int(min(max(x, spec["min"]), spec["max"])))
    return out


def exponential_gaps(n: int, seconds: float) -> List[float]:
    """The n quantiles at (i + 1/2) / n of an exponential distribution,
    scaled so that they sum to ``seconds``."""
    g = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    s = sum(g)
    return [x * seconds / s for x in g]


@dataclasses.dataclass
class Req:
    prompt: np.ndarray          # int32 token ids
    max_tokens: int
    offset: Optional[float] = None   # open loop: due seconds after start


class Traffic:
    def __init__(self, spec: Dict, vocab: int):
        if spec["loop"] not in ("open", "closed"):
            raise ValueError(f"loop must be open or closed: {spec['loop']}")
        self.spec = spec
        self.vocab = int(vocab)
        self.loop = spec["loop"]

    @property
    def clients(self) -> int:
        return int(self.spec["clients"])

    def _ids(self, rng, n: int) -> np.ndarray:
        return rng.integers(0, self.vocab, size=n, dtype=np.int64) \
            .astype(np.int32)

    def open_schedule(self, seed: int, seconds: float,
                      rate: Optional[float] = None) -> List[Req]:
        """The open loop's requests due in ``seconds``, with their offsets:
        the first is due at 0, the last a gap before ``seconds``."""
        rate = float(self.spec["rate"] if rate is None else rate)
        n = max(int(round(rate * seconds)), 1)
        order = _rng(seed, _ORDER)
        plen = order.permutation(lognormal_quantiles(n, self.spec["prompt"]))
        olen = order.permutation(lognormal_quantiles(n, self.spec["output"]))
        gaps = _rng(seed, _GAPS).permutation(exponential_gaps(n, seconds))
        ids = _rng(seed, _IDS)
        out, t = [], 0.0
        for i in range(n):
            out.append(Req(self._ids(ids, int(plen[i])), int(olen[i]), t))
            t += float(gaps[i])
        return out

    def closed_stream(self, seed: int) -> Iterator[Req]:
        """The closed loop's requests in the order the clients take them:
        blocks of ``clients``, each a permutation of the same quantiles."""
        m = self.clients
        pq = lognormal_quantiles(m, self.spec["prompt"])
        oq = lognormal_quantiles(m, self.spec["output"])
        order, ids = _rng(seed, _ORDER), _rng(seed, _IDS)
        while True:
            plen, olen = order.permutation(pq), order.permutation(oq)
            for j in range(m):
                yield Req(self._ids(ids, int(plen[j])), int(olen[j]))

    def warmup(self, seed: int, buckets: List[int], batch: int,
               tokens: int) -> List[Req]:
        """A burst of ``batch`` requests from another stream of the seed
        that touches every prefill bucket this mix's prompts can fall in
        (one prompt at the longest length of each) and fills the batch
        with prompts of the shortest length; ``tokens`` new tokens each."""
        lo, hi = self.spec["prompt"]["min"], self.spec["prompt"]["max"]
        lens, below = [], 0
        for b in buckets:
            if b >= lo and below < hi:
                lens.append(min(b, hi))
            below = b
        lens = lens[:batch] + [lo] * max(batch - len(lens), 0)
        rng = _rng(seed, _WARM)
        return [Req(self._ids(rng, n), tokens) for n in lens]
