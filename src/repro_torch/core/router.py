"""Adaptive prompt routing (paper §3.1).

Length-based partitioning: (n-1) threshold cut-offs divide traffic among n
prefill worker pools (n = 2 in the paper: short/medium "SM" up to ~1024
tokens, long "L" above).  Isolating long prompts removes head-of-line
blocking for the short-prompt majority.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from .types import Request


@dataclasses.dataclass(frozen=True)
class LengthRouter:
    thresholds: Sequence[int] = (1024,)
    class_names: Sequence[str] = ("SM", "L")

    def __post_init__(self):
        assert len(self.class_names) == len(self.thresholds) + 1
        assert list(self.thresholds) == sorted(self.thresholds)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def classify(self, prompt_len: int) -> int:
        for i, t in enumerate(self.thresholds):
            if prompt_len <= t:
                return i
        return len(self.thresholds)

    def route(self, req: Request) -> int:
        idx = self.classify(req.prompt_len)
        req.cls = self.class_names[idx]
        return idx


SINGLE_QUEUE = LengthRouter(thresholds=(), class_names=("SM",))


def make_router(enabled: bool = True) -> LengthRouter:
    """Paper default: 2 classes split at 1024 tokens; disabled -> one queue
    (the DefaultNV baseline routes everything to one pool)."""
    return LengthRouter() if enabled else SINGLE_QUEUE
