"""Token-choice top-k Mixture-of-Experts FFN (port of
``src/repro/models/moe.py``).

Two dispatch implementations with the same semantics:

* ``moe_einsum``: (B,S,E,C) one-hot dispatch and combine tensors and two
  einsums around the batched expert FFN.
* ``moe_scatter``: tokens scattered into (E*C, d) expert buffers, the FFN
  as a (E,C,d) x (E,d,ff) batched product, results gathered back.

Each row of ``x`` (B,S,d) is one routing group: expert capacity C follows
from its S tokens, slots rank token-choices in token order within each
expert, and choices past C are dropped, as in Switch / GSPMD.  Bucket pads
take no capacity: ``lengths`` (host ints, one per row) marks row b's first
``lengths[b]`` tokens as real (the reference's ``valid = arange(S) <
length``), and the capacity is clamped to what the true count gives.  The
expert products are PyTorch operators, as they are XLA in the reference:
MoE has no Pallas kernel there.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig


def init_moe(gen, cfg: ModelConfig, dtype, lead=()):
    """The reference's ``init_moe`` leaves with a leading ``lead`` stack:
    a float32 router (d, E) and the expert stacks (E, d, ff) / (E, ff, d)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)
    p = {"router": L.dense_init(gen, lead + (d, E), d, torch.float32),
         "down": L.dense_init(gen, lead + (E, ff, d), ff, dtype),
         "up": L.dense_init(gen, lead + (E, d, ff), d, dtype)}
    if cfg.glu:
        p["gate"] = L.dense_init(gen, lead + (E, d, ff), d, dtype)
    return p


EXPERT_LEAVES = ("down", "gate", "up")


def is_expert_leaf(cfg: ModelConfig, path, shape) -> bool:
    """Is this param-tree leaf a per-expert weight stack?

    ``path`` is the leaf's key path into the stacked params tree (dict keys
    and sequence indices, e.g. ``("stages", 0, "blocks", 0, "moe",
    "up")``); expert leaves live under a ``"moe"`` dict with a stacked shape
    of ``(n_rep, num_experts, ...)``.  ``launch.shardings.
    serving_param_specs`` uses this to shard the expert axis over the
    'model' mesh axis so each expert's weights live on exactly one model
    shard."""
    keys = list(path)
    return ("moe" in keys and keys[-1] in EXPERT_LEAVES
            and len(shape) >= 2 and shape[1] == cfg.num_experts)


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(cfg.capacity_factor * tokens_per_group * cfg.experts_per_token
            / cfg.num_experts)
    return max(c, cfg.experts_per_token)


def _routing(cfg: ModelConfig, p, x):
    """x (B,S,d) -> (weights (B,S,k), experts (B,S,k) int64, aux loss):
    float32 router logits, softmax, top-k renormalised, the Switch
    load-balancing loss over every token (pads included, as the reference
    routes before it masks).  ``torch.topk`` returns the k choices sorted
    by descending probability, as ``jax.lax.top_k`` does; among exactly
    equal probabilities JAX prefers the lower index and torch promises no
    order, so an exact tie on a real token may choose differently (pads
    never reach the tie: they are rerouted after)."""
    logits = x.float() @ p["router"]                          # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    E = cfg.num_experts
    density = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    density_proxy = probs.mean(dim=(0, 1))
    aux = (density * density_proxy).sum() * E
    return w, idx, aux


def _valid(lengths: Sequence[int], B: int, S: int, device):
    """(B,S) bool: row b's first ``lengths[b]`` tokens are real.  Equal
    lengths (one prompt, or a batch at one length) compare with a host
    scalar; only unequal ones upload a (B,) vector."""
    ar = torch.arange(S, device=device)
    if len(set(lengths)) == 1:
        return (ar < lengths[0])[None].expand(B, S)
    return ar[None] < torch.tensor(list(lengths), device=device)[:, None]


def _mask_pads(cfg: ModelConfig, w, idx, valid):
    """Pads route to the out-of-range expert E, which claims no capacity
    slot in ``_slots``, and their combine weights become 0."""
    if valid is None:
        return w, idx
    v = valid[..., None]
    return w * v.to(w.dtype), torch.where(v, idx, cfg.num_experts)


def _dynamic_capacity(cfg: ModelConfig, lengths: Sequence[int], C: int,
                      device):
    """Per-row capacity clamp from the true token counts: ``min(capacity(n),
    C)`` computed on the host through ``capacity`` itself (the reference's
    table lookup), a Python int when every row has the same count, else a
    (B,1,1) tensor."""
    caps = [min(capacity(cfg, int(n)), C) for n in lengths]
    if len(set(caps)) == 1:
        return caps[0]
    return torch.tensor(caps, device=device).view(-1, 1, 1)


def _slots(cfg: ModelConfig, idx):
    """Position-in-expert for every (token, choice), (B,S,k): the rank of
    the choice among the row's choices of that expert in token order (>= C
    means dropped).  Pads (expert E) rank in a column of their own."""
    B, S, k = idx.shape
    flat = idx.reshape(B, S * k)
    onehot = F.one_hot(flat, cfg.num_experts + 1).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    return pos.gather(-1, flat[..., None])[..., 0].reshape(B, S, k)


def _dispatch(cfg: ModelConfig, p, x, lengths: Optional[Sequence[int]]):
    """Routing shared by both implementations: (w, idx, slot, keep, aux,
    C); ``slot`` is 0 where ``keep`` is False."""
    B, S, _ = x.shape
    C = capacity(cfg, S)
    w, idx, aux = _routing(cfg, p, x)
    valid = None if lengths is None else _valid(lengths, B, S, x.device)
    w, idx = _mask_pads(cfg, w, idx, valid)
    slot = _slots(cfg, idx)
    keep = slot < C
    if valid is not None:
        keep &= ((slot < _dynamic_capacity(cfg, lengths, C, x.device))
                 & valid[..., None])
    slot = torch.where(keep, slot, 0)
    return w, idx, slot, keep, aux, C


def _ffn(cfg: ModelConfig, p, h):
    """h (..., E, C, d) -> (..., E, C, d); batched per-expert FFN."""
    if cfg.glu:
        g = L.activation(cfg, torch.einsum("...ecd,edf->...ecf", h,
                                           p["gate"]))
        hh = g * torch.einsum("...ecd,edf->...ecf", h, p["up"])
    else:
        hh = L.activation(cfg, torch.einsum("...ecd,edf->...ecf", h,
                                            p["up"]))
    return torch.einsum("...ecf,efd->...ecd", hh, p["down"])


def moe_einsum(cfg: ModelConfig, p, x, lengths=None):
    """Dispatch-einsum MoE. x (B,S,d) -> (B,S,d), aux.

    The reference accumulates the (B,S,E,C) dispatch and combine tensors
    one routing choice at a time; a token's k choices hit distinct experts,
    so every (token, expert, slot) cell receives at most one nonzero term
    and one scatter of all choices writes the same values.  Dropped choices
    write zeros into an overflow column that is cut off."""
    B, S, d = x.shape
    E = cfg.num_experts
    w, idx, slot, keep, aux, C = _dispatch(cfg, p, x, lengths)
    cell = torch.where(keep, idx * C + slot, E * C)              # (B,S,k)
    disp = x.new_zeros(B, S, E * C + 1).scatter_(-1, cell, keep.to(x.dtype))
    comb = x.new_zeros(B, S, E * C + 1).scatter_(
        -1, cell, torch.where(keep, w, 0.0).to(x.dtype))
    disp = disp[..., :E * C].reshape(B, S, E, C)
    comb = comb[..., :E * C].reshape(B, S, E, C)
    h = torch.einsum("bsec,bsd->becd", disp, x)
    y = _ffn(cfg, p, h)                                          # (B,E,C,d)
    return torch.einsum("bsec,becd->bsd", comb, y), aux


def moe_scatter(cfg: ModelConfig, p, x, lengths=None):
    """Scatter/gather MoE with the semantics of ``moe_einsum``.  Dropped
    choices all write the overflow row E*C, the only row that takes
    duplicate indices, and it is discarded, so the result is
    deterministic."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    w, idx, slot, keep, aux, C = _dispatch(cfg, p, x, lengths)
    dest = torch.where(keep, idx * C + slot, E * C).reshape(B, S * k)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = x.new_zeros(B, E * C + 1, d)
    buf[rows, dest] = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    y = _ffn(cfg, p, buf[:, :E * C].reshape(B, E, C, d)).reshape(B, E * C, d)
    y = torch.cat([y, y.new_zeros(B, 1, d)], dim=1)
    out_k = y[rows, dest].reshape(B, S, k, d)
    return (out_k * w[..., None].to(x.dtype)).sum(dim=2), aux


def apply_moe(cfg: ModelConfig, p, x, lengths=None):
    """Routing groups of ``cfg.moe_group`` tokens bound the capacity C (and
    the dispatch tensor) independently of the sequence length.  ``lengths``
    (host ints, one per row of x, or None) marks each row's real tokens;
    a group's count is its share of its row's, so bucket pads are kept
    out of capacity competition in every group."""
    B, S, d = x.shape
    fn = moe_scatter if cfg.moe_impl == "scatter" else moe_einsum
    G = cfg.moe_group
    if S > G and S % G == 0:
        g = S // G
        lg = None if lengths is None else [
            min(max(n - j * G, 0), G) for n in lengths for j in range(g)]
        out, aux = fn(cfg, p, x.reshape(B * g, G, d), lg)
        return out.reshape(B, S, d), aux
    return fn(cfg, p, x, lengths)
