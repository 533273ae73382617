"""The training step with microbatch gradient accumulation (port of
``src/repro/training/train_loop.py``).  The reference's ZeRO-1 layout of
the float32 accumulators (``grad_specs`` and its sharding constraint) is
mesh work and comes with the port's multi-device support (ROADMAP A14);
this step runs on one device."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import ModelConfig, init_params, loss_fn
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .pytree import leaves, unflatten


def _grads(params, cfg: ModelConfig, micro):
    """(loss, metrics, float32-or-param-dtype gradient leaves): autograd
    through ``loss_fn`` on leaves detached from ``params`` (a leaf that no
    gradient reaches gets zeros, as ``jax.grad`` gives)."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(params, flat), cfg, micro)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1):
    """train_step(state, batch) -> (state, metrics).

    state = {params, opt}; batch = {tokens (B,S), [prefix_embeds]}.
    Gradients are accumulated in float32 over ``num_microbatches``
    sequential slices of the batch (bounding the activations' live range),
    divided by their count, then AdamW applies.  Metrics: loss, ce, aux
    (with microbatches ce is the mean loss and aux 0, as the reference's),
    grad_norm and lr, all device tensors."""

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        mb = num_microbatches
        if mb == 1:
            loss, metrics, grads = _grads(params, cfg, batch)
        else:
            def micro(x, i):
                B = x.shape[0]
                return x.reshape(mb, B // mb, *x.shape[1:])[i]

            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=grads[0].device)
            for i in range(mb):
                l, _, g = _grads(params, cfg,
                                 {k: micro(v, i) for k, v in batch.items()})
                grads = [a + b.float() for a, b in zip(grads, g)]
                loss_sum = loss_sum + l
            grads = [g / mb for g in grads]
            loss = loss_sum / mb
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        new_params, new_opt, opt_metrics = adamw_update(params, grads, opt,
                                                        opt_cfg)
        out = {"loss": loss, **metrics, **opt_metrics}
        return {"params": new_params, "opt": new_opt}, out

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random parameters on ``gen.device`` (``models.init_params``) and a
    fresh optimizer state."""
    params = init_params(gen, cfg)
    return {"params": params, "opt": init_opt_state(params)}
