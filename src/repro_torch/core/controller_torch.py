"""Dual-loop decode controller (paper §3.3) as a pure step over a state of
tensors, batched over fleets of controllers.

The Python ``DualLoopController`` is the serving-path implementation (it
runs off the accelerator's critical path, as the paper prescribes).  This
module gives the same control law as a *pure function over a NamedTuple of
tensors*, so fleets of controllers step together on the device: batch
what-if sweeps over thousands of SLO / margin / telemetry scenarios.

Batching: every field of ``CtlParams`` and ``CtlState`` may carry the same
leading fleet dims (``tps_grid`` and ``freq_for`` keep their bucket axis
last), parameters included, and the telemetry of ``simulate`` is ``(T,)``
or ``(..., T)``.  Shapes broadcast like elementwise operands, so one set of
parameters drives a fleet of traces and a grid of parameters drives one
trace or one trace each.

Simplifications vs the Python class:
* telemetry arrives as per-fine-tick aggregates (tokens, p95 TBT estimate)
  instead of raw event streams — the sim/serving layers produce exactly
  these aggregates at 20 ms boundaries;
* the 6 s band-adaptation loop is not included (stateful table mutation);
  band selection + hysteresis + fine loop are bit-identical.

Arithmetic is float32 (int32 for counters and buckets) on every device, in
the reference formulation's order, so a fleet on CUDA gives the same bits
as on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .hardware import HardwareProfile
from .models import TPSFreqTable

F32, I32 = torch.float32, torch.int32


class CtlParams(NamedTuple):
    tps_grid: torch.Tensor       # (..., n_buckets)
    freq_for: torch.Tensor       # (..., n_buckets)
    f_min: torch.Tensor
    f_max: torch.Tensor
    f_step: torch.Tensor
    tbt_slo: torch.Tensor
    up_margin: torch.Tensor
    down_margin: torch.Tensor
    hysteresis: torch.Tensor     # int32
    ticks_per_coarse: torch.Tensor  # int32: fine ticks per coarse interval


class CtlState(NamedTuple):
    freq: torch.Tensor
    band_lo: torch.Tensor
    band_hi: torch.Tensor
    bucket: torch.Tensor         # int32, -1 = unset
    pending: torch.Tensor        # int32
    pending_count: torch.Tensor  # int32
    tick: torch.Tensor           # int32 fine-tick counter
    window_tokens: torch.Tensor  # tokens accumulated this coarse interval


_GRIDS = ("tps_grid", "freq_for")


def make_params(hw: HardwareProfile, table: TPSFreqTable,
                tbt_slo=0.100, hysteresis=3, fine_period: float = 0.020,
                coarse_period: float = 0.200, device="cuda") -> CtlParams:
    """Parameters on ``device``.  ``tbt_slo`` and ``hysteresis`` may be
    arrays: their shape becomes the fleet dims of that field (a sweep over
    SLOs).  A sweep over margins sets them with ``_replace``."""
    dev = torch.device(device)

    def t(x, dtype=F32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return CtlParams(
        tps_grid=t(table.tps_grid),
        freq_for=t(table.freq_for),
        f_min=t(hw.f_min),
        f_max=t(hw.f_max),
        f_step=t(hw.f_step),
        tbt_slo=t(tbt_slo),
        up_margin=t(1.0),
        down_margin=t(0.65),
        hysteresis=t(hysteresis, I32),
        ticks_per_coarse=t(round(coarse_period / fine_period), I32),
    )


def fleet_shape(p: CtlParams, *shapes) -> torch.Size:
    """The fleet dims of ``p`` broadcast with ``shapes``."""
    dims = [x.shape[:-1] if name in _GRIDS else x.shape
            for name, x in zip(CtlParams._fields, p)]
    return torch.broadcast_shapes(*dims, *shapes)


def broadcast_params(p: CtlParams, shape) -> CtlParams:
    """``p`` with every field expanded to the fleet dims ``shape`` (the
    grids contiguous, as ``torch.searchsorted`` wants them)."""
    shape = tuple(shape)
    return CtlParams(*(
        x.expand(shape + x.shape[-1:]).contiguous() if name in _GRIDS
        else x.expand(shape)
        for name, x in zip(CtlParams._fields, p)))


def init_state(p: CtlParams) -> CtlState:
    shape = fleet_shape(p)

    def full(v, dtype):
        return torch.full(shape, v, dtype=dtype, device=p.f_max.device)

    f_max = p.f_max.expand(shape).clone()
    return CtlState(
        freq=f_max,
        band_lo=(p.f_max - p.f_step).expand(shape).clone(),
        band_hi=f_max.clone(),
        bucket=full(-1, I32),
        pending=full(-1, I32),
        pending_count=full(0, I32),
        tick=full(0, I32),
        window_tokens=full(0.0, F32),
    )


def _band(p: CtlParams, bucket):
    grid = p.freq_for.expand(bucket.shape + p.freq_for.shape[-1:])
    f = grid.gather(-1, bucket.long().unsqueeze(-1)).squeeze(-1)
    return (torch.maximum(f - p.f_step, p.f_min),
            torch.minimum(f + p.f_step, p.f_max))


def _bucket_of(p: CtlParams, tps):
    grid = p.tps_grid
    if grid.dim() == 1:
        idx = torch.searchsorted(grid, tps, right=False)
    else:
        grid = grid.expand(tps.shape + grid.shape[-1:]).contiguous()
        idx = torch.searchsorted(grid, tps.unsqueeze(-1),
                                 right=False).squeeze(-1)
    return idx.clamp(0, grid.shape[-1] - 1).to(I32)


def controller_step(p: CtlParams, s: CtlState, tokens, p95_tbt
                    ) -> Tuple[CtlState, torch.Tensor]:
    """One 20 ms fine tick. tokens: emitted this tick; p95_tbt: current
    window P95 (s; 0 = no samples). Returns (state, frequency)."""
    window_tokens = s.window_tokens + tokens
    tick = s.tick + 1
    coarse_due = (tick % p.ticks_per_coarse) == 0

    # ---- coarse loop ------------------------------------------------------
    # both branches, then a select per field: what ``lax.cond`` lowers to
    # under ``vmap``
    tps = window_tokens / (p.ticks_per_coarse.to(F32) * 0.020)
    bucket_now = _bucket_of(p, tps)
    first = s.bucket < 0
    same = bucket_now == s.bucket
    pend_same = bucket_now == s.pending
    new_count = torch.where(
        same, 0, torch.where(pend_same, s.pending_count + 1, 1))
    commit = torch.logical_and(~same, new_count >= p.hysteresis)
    adopt = torch.logical_or(first, commit)
    bucket = torch.where(adopt, bucket_now, s.bucket)
    lo, hi = _band(p, bucket)
    settled = torch.logical_or(same, commit)
    pending = torch.where(settled, -1, bucket_now)
    count = torch.where(settled, 0, new_count)
    adopt = torch.logical_and(coarse_due, adopt)
    band_lo = torch.where(adopt, lo, s.band_lo)
    band_hi = torch.where(adopt, hi, s.band_hi)
    bucket = torch.where(coarse_due, bucket, s.bucket)
    pending = torch.where(coarse_due, pending, s.pending)
    count = torch.where(coarse_due, count, s.pending_count)
    window_tokens = torch.where(coarse_due, 0.0, window_tokens)

    # ---- fine loop ---------------------------------------------------------
    margin = p95_tbt / p.tbt_slo
    has_data = p95_tbt > 0.0
    up = torch.logical_and(has_data, margin > p.up_margin)
    down = torch.logical_and(has_data, margin < p.down_margin)
    freq = torch.where(up, torch.minimum(s.freq + p.f_step, band_hi),
                       torch.where(down,
                                   torch.maximum(s.freq - p.f_step, band_lo),
                                   s.freq))
    freq = torch.minimum(torch.maximum(freq, band_lo), band_hi)
    s = CtlState(freq=freq, band_lo=band_lo, band_hi=band_hi, bucket=bucket,
                 pending=pending, pending_count=count, tick=tick,
                 window_tokens=window_tokens)
    return s, freq


def simulate(p: CtlParams, tokens_per_tick, p95_per_tick):
    """Run the controller over a telemetry trace, one step per tick.
    tokens_per_tick, p95_per_tick: (T,) or (..., T), on ``p``'s device.
    Returns (final_state, freqs (..., T)) with the fleet dims of the
    parameters and the telemetry broadcast together."""
    dev = p.f_max.device
    tokens = torch.as_tensor(tokens_per_tick, dtype=F32, device=dev)
    p95 = torch.as_tensor(p95_per_tick, dtype=F32, device=dev)
    shape = fleet_shape(p, tokens.shape[:-1], p95.shape[:-1])
    p = broadcast_params(p, shape)
    tokens = tokens.expand(shape + tokens.shape[-1:])
    p95 = p95.expand(shape + p95.shape[-1:])
    T = tokens.shape[-1]
    s = init_state(p)
    freqs = torch.empty(tuple(shape) + (T,), dtype=F32, device=dev)
    for t in range(T):
        s, freqs[..., t] = controller_step(p, s, tokens[..., t], p95[..., t])
    return s, freqs
