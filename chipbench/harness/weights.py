"""Weights drawn from the seed on the device, in the harness's own layout.

A family's reference file lists its tensors (``WEIGHTS(config)``: name,
shape, dtype and how each is drawn); every tensor is drawn whole, per-layer
tensors stacked on a leading layer axis, in the dtype it is served in, by
one generator on the device.  Both the program (through the family's
adapter) and the reference read these same tensors.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def draw(spec: List[Tuple], seed: int, device, dtype: str) -> Dict:
    """``spec``: (name, shape, kind, value) rows, ``kind`` "normal" (mean 0,
    standard deviation ``value``) or "one_plus" (1 plus normal noise of
    deviation ``value``, for norm scales, always float32).  "normal"
    tensors take ``dtype``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + 0x5EED) % 2 ** 63)
    out = {}
    for name, shape, kind, value in spec:
        dt = torch.float32 if kind == "one_plus" else DTYPES[dtype]
        t = torch.randn(tuple(shape), generator=g, device=device, dtype=dt)
        t.mul_(value)
        if kind == "one_plus":
            t.add_(1.0)
        elif kind != "normal":
            raise ValueError(f"unknown weight kind {kind!r}")
        out[name] = t
    return out
