"""AdamW and the cosine learning-rate schedule on parameter trees (port of
``src/repro/training/optimizer.py``, line for line).  The step count is an
int32 tensor on the parameters' device and every scalar stays there: an
update reads nothing back to the host."""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch

from .pytree import leaves, unflatten


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: AdamWConfig, step):
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``:
    float32, from an integer step tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params) -> Dict[str, Any]:
    """Float32 zeros for m and v, one per leaf, and step 0 (int32)."""
    first = leaves(params)[0]

    def zeros(p):
        return unflatten(p, [torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device) for x in leaves(p)])
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree):
    """sqrt of the sum of every leaf's float32 sum of squares, in order."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def adamw_update(params, grads, opt, cfg: AdamWConfig):
    """(params, opt, {"grad_norm", "lr"}) after one step.  ``grads`` is a
    tree like ``params`` or its leaves in flatten order.  Gradients are
    clipped to a global norm of ``grad_clip`` (the raw norm is reported);
    decoupled weight decay applies to every leaf of 2 or more dims (the
    stacked per-layer norm scales included, as the reference's tree)."""
    step = opt["step"] + 1
    flat_g = grads if isinstance(grads, list) else leaves(grads)
    gn = global_norm(flat_g)
    scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    flat_p = leaves(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, flat_g, leaves(opt["m"]), leaves(opt["v"]))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gn, "lr": lr}
