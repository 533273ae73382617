"""The arithmetic of the per-layer metrics, each read by a small file under
``metrics/<name>/`` that calls one of these with the ``Readings`` of a
traced run.  A reader that finds nothing to read returns None, and the
metric is left out of the result line; a share of a peak or a roofline is
never reported as 0 for want of data."""
from __future__ import annotations

from typing import Optional


def rows_per_step(r) -> Optional[float]:
    """Decode tokens per decode step over the window (the engine's
    ``step()`` returns its decode steps; the tokens are the drained
    ``TokenEvent``s after each request's first)."""
    c = r.counters
    return c["decode_tokens"] / c["decode_steps"] if c["decode_steps"] \
        else None


def pool_peak_share(r) -> Optional[float]:
    """The page pool's peak use over the window, in % of its usable pages
    (``engine.pager.peak_used``, reset at the window's start)."""
    c = r.counters
    return 100.0 * c["pool_peak_pages"] / c["pool_usable_pages"]


def mfu(r) -> Optional[float]:
    """Model FLOPs of the traced rounds over the device's busy time at the
    peak bf16 rate, in %."""
    if r.slice is None or not r.work.model_flops or r.slice.busy_s <= 0:
        return None
    return 100.0 * r.work.model_flops / (r.slice.busy_s * r.peak["bf16_flops"])


def idle_share(r) -> Optional[float]:
    """Share of the traced slice with nothing running on the device, %."""
    if r.slice is None or r.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.slice.busy_s / r.slice.window_s)


def decode_attn_roofline(r) -> Optional[float]:
    """The K/V bytes of every decoded row's live context at the peak HBM
    rate, over the device time of the decode-attention kernels, in %."""
    t = r.slice.family_s(r.patterns) if r.slice is not None else 0.0
    if t <= 0 or not r.work.decode_kv_bytes:
        return None
    return 100.0 * r.work.decode_kv_bytes / r.peak["hbm_bytes_per_s"] / t


def prefill_attn_roofline(r) -> Optional[float]:
    """The causal attention FLOPs of the prompts prefilled at the peak bf16
    rate, over the device time of the prefill-attention kernels, in %."""
    t = r.slice.family_s(r.patterns) if r.slice is not None else 0.0
    if t <= 0 or not r.work.prefill_attn_flops:
        return None
    return 100.0 * r.work.prefill_attn_flops / r.peak["bf16_flops"] / t
