"""The training step with microbatch gradient accumulation and ZeRO-1
state sharding (port of ``src/repro/training/train_loop.py``).

Without a mesh (``shd`` = ``NOSHARD``) the step runs on one device.  On a
mesh the state and the batch are DTensors (``launch.specs.build_train``
places them): DTensor's sharding propagation plays GSPMD for the products
and the elementwise work, and the kernels run on each rank's shards
(``models.sharding.local_call``).  ``grad_specs`` is the reference's
ZeRO-1 layout: each gradient is constrained to it (a partial sum over the
batch axes becomes a reduce-scatter), the float32 accumulators start and
stay in it, and AdamW updates each rank's shard of p, m and v before the
new params go back to their own placement (an all-gather)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import ModelConfig, init_params, loss_fn
from repro_torch.models.sharding import (NOSHARD, ShardCtx, is_dtensor,
                                         placements, replicated)
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .pytree import leaves, unflatten


def _grads(params, cfg: ModelConfig, micro, shd: ShardCtx = NOSHARD):
    """(loss, metrics, float32-or-param-dtype gradient leaves): autograd
    through ``loss_fn`` on leaves detached from ``params`` (a leaf that no
    gradient reaches gets zeros, as ``jax.grad`` gives)."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(params, flat), cfg, micro,
                                shd=shd)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _micro(x, mb: int, i: int):
    """Microbatch ``i`` of ``mb``: rows i*B/mb.. of the batch (of a
    DTensor, the caller has gathered it whole: a microbatch holds the same
    rows on any mesh, as the reference's reshape of the global batch)."""
    B = x.shape[0]
    return x.reshape(mb, B // mb, *x.shape[1:])[i]


def _plain(x):
    """A metric as a plain tensor (a DTensor's whole value)."""
    return x.full_tensor() if is_dtensor(x) else x


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, *, shd: ShardCtx = NOSHARD,
                    grad_specs=None):
    """train_step(state, batch) -> (state, metrics).

    state = {params, opt}; batch = {tokens (B,S), [prefix_embeds]}.
    Gradients are accumulated in float32 over ``num_microbatches``
    sequential slices of the batch (bounding the activations' live range),
    divided by their count, then AdamW applies.  Metrics: loss, ce, aux
    (with microbatches ce is the mean loss and aux 0, as the reference's),
    grad_norm and lr, all device tensors (plain, also on a mesh).

    ``shd`` (a ``ShardCtx`` with a mesh) runs the step on DTensors; the
    gradients and the float32 accumulators are constrained to
    ``grad_specs`` (a spec tree like the params, ZeRO-1's), and so are
    the params while AdamW updates them."""

    def constrain(flat):
        if grad_specs is None or shd.mesh is None:
            return flat
        out = []
        for x, s in zip(flat, leaves(grad_specs)):
            pls = placements(s, shd.mesh)
            out.append(x if tuple(x.placements) == tuple(pls)
                       else x.redistribute(shd.mesh, pls))
        return out

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        mb = num_microbatches
        if mb == 1:
            loss, metrics, grads = _grads(params, cfg, batch, shd)
            grads = constrain(grads)
        else:
            if shd.mesh is not None:
                # each microbatch's rows are then split over the batch axes
                # at the kernel entries (every rank takes its share)
                batch = {k: v.redistribute(shd.mesh, replicated(shd.mesh))
                         for k, v in batch.items()}
            grads = constrain([_zeros_f32(p) for p in leaves(params)])
            loss_sum = _zeros_f32(leaves(params)[0], ())
            for i in range(mb):
                l, _, g = _grads(params, cfg,
                                 {k: _micro(v, mb, i)
                                  for k, v in batch.items()}, shd)
                grads = [a + b for a, b in zip(
                    grads, constrain([b.float() for b in g]))]
                loss_sum = loss_sum + l
            grads = [g / mb for g in grads]
            loss = loss_sum / mb
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        flat_p = leaves(params)
        zp = constrain(flat_p)
        new_params, new_opt, opt_metrics = adamw_update(
            unflatten(params, zp), grads, opt, opt_cfg)
        if zp is not flat_p:
            new_params = unflatten(params, [
                n if tuple(n.placements) == tuple(p.placements)
                else n.redistribute(shd.mesh, p.placements)
                for n, p in zip(leaves(new_params), flat_p)])
        out = {k: _plain(v) for k, v in
               {"loss": loss, **metrics, **opt_metrics}.items()}
        return {"params": new_params, "opt": new_opt}, out

    return train_step


def _zeros_f32(p, shape=None):
    """Float32 zeros of ``p``'s shape (or ``shape``), placed as ``p`` is
    when it is a DTensor (replicated for a scalar)."""
    shape = p.shape if shape is None else shape
    if not is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, zeros
    pls = p.placements if shape == p.shape else \
        [Replicate()] * p.device_mesh.ndim
    return zeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                 placements=pls)


def init_train_state(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random parameters on ``gen.device`` (``models.init_params``) and a
    fresh optimizer state."""
    params = init_params(gen, cfg)
    return {"params": params, "opt": init_opt_state(params)}
