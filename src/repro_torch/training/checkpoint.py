"""Checkpoints of parameter and optimizer trees in the reference's
MessagePack format (port of ``src/repro/training/checkpoint.py``): a map
{"leaves": [...], "treedef": str}, each leaf a map {b"__nd__": True,
b"dtype": numpy dtype string, b"shape": [...], b"data": raw bytes}, leaves
in JAX's flatten order, bfloat16 stored upcast to float32 and cast back to
the target tree's dtype on load.  A checkpoint written by either package
loads in the other.  The reference writes its treedef's repr and never
reads it; the port writes a description of its tree there.  The codec is
the port's own (``msgpack_codec``): the machine with the GPU has no
``msgpack`` package."""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from . import msgpack_codec
from .pytree import leaves, unflatten


def _encode(t) -> dict:
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()     # not a numpy type: stored upcast
    arr = t.cpu().contiguous().numpy()
    return {b"__nd__": True, b"dtype": arr.dtype.str,
            b"shape": list(arr.shape), b"data": arr.tobytes()}


def _decode(obj) -> np.ndarray:
    return np.frombuffer(obj[b"data"], dtype=np.dtype(obj[b"dtype"].decode())) \
        .reshape(obj[b"shape"]).copy()


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def save_checkpoint(path: str, tree: Any) -> None:
    payload = {"leaves": [_encode(x) for x in leaves(tree)],
               "treedef": f"repro_torch tree {_describe(tree)}"}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_codec.packb(payload))


def load_checkpoint(path: str, like: Any) -> Any:
    """The checkpoint's leaves in ``like``'s structure, each cast to its
    like leaf's dtype and shape, on its device."""
    with open(path, "rb") as f:
        payload = msgpack_codec.unpackb(f.read())
    got = [_decode(x) for x in payload[b"leaves"]]
    flat_like = leaves(like)
    assert len(got) == len(flat_like), "checkpoint/tree mismatch"
    return unflatten(like, [
        torch.from_numpy(a).to(device=x.device).to(x.dtype).reshape(x.shape)
        for a, x in zip(got, flat_like)])
