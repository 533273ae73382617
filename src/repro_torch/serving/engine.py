"""Slot-native serving engine, dense subset (port of
``src/repro/serving/engine.py``): continuous batching over a shared slotted
KV cache, driven by the same GreenLLM control plane (router, plant, decode
controller, accounting) as the reference.

Data plane:

* **Bucketed slot prefill** — prompts are right-padded to power-of-two
  buckets (capped at ``max_len // 2``, the prompt truncation length) and run
  through ``models.prefill_into_slot``, which writes K/V in place into one
  row of the batch cache.  The first token is the argmax of the last
  logits.
* **k-step decode blocks** — ``kb`` steps run back to back over the cache
  viewed as ``[:, :ctx]`` (the smallest context bucket covering every
  position in the block), with per-slot positions and an active mask:
  inactive rows hold their token and position.  Nothing inside a block
  reads a device value on the host; the block's tokens are drained once at
  its end (``_host_drains`` counts the drains, as in the reference).

Virtual time and energy come from the numpy plant model, so a run's
report depends only on the tokens, and identical tokens give a report
identical to the reference engine's.

Not ported yet, and rejected with ``NotImplementedError`` naming the
ROADMAP item: paged KV, the prefix cache and chunked prefill (A7), the
legacy ``slot_native=False`` plane (A7), int8 KV (A9 / B5), sampling with
``temperature > 0`` (A6), serving meshes (A14) and observability sinks
(A7).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import (DualLoopController, MaxFreqController, Request,
                              RequestState, ServingReport, SLOConfig,
                              StateEvent, TokenEvent, build_report,
                              make_router)
from repro_torch.core.hardware import HardwareProfile, A100_SXM4_40G
from repro_torch.models import ModelConfig, decode_step, init_cache, \
    init_params, prefill_into_slot
from repro_torch.models.config import FULL_ATTN, LOCAL_ATTN
from repro_torch.models.kvcache import attn_buffer_len
from repro_torch.sim import PlantModel
from repro_torch.sim.profiling import profile_decode_table


def _slice_caches(caches, ctx: int, max_len: int):
    """Views of the full-length attention buffers cut to ``ctx`` positions
    (stacked leaves (n_rep, B, buf_len, KH, hd)).  Writes through a view
    land in the full buffer, so nothing is spliced back."""
    out = []
    for stage in caches:
        blocks = []
        for d in stage:
            n = d["k"].shape[2]
            if n == max_len and ctx < n:
                blocks.append({kk: vv[:, :, :ctx] for kk, vv in d.items()})
            else:
                blocks.append(d)
        out.append(tuple(blocks))
    return out


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_len: int = 256
    governor: str = "greenllm"      # greenllm | defaultnv
    use_wall_clock: bool = False    # account measured latency per decode block
    slot_native: bool = True        # False -> legacy data plane (benchmarks)
    decode_block: int = 64          # max decode steps in flight per host drain
    min_bucket: int = 16            # smallest prefill padding bucket
    # paged KV cache (serving.pager): full-length attention buffers become a
    # shared page pool; capacity = tokens in flight, not max_batch * max_len
    paged: bool = False
    page_size: int = 16             # tokens per page
    num_pages: int = 0              # per-layer pool size incl. scratch page;
    #                                 0 -> dense-equivalent capacity
    # split prompts longer than the largest bucket into bucket-sized chunks
    # admitted across successive decode blocks (False -> legacy eager-prefill
    # fallback; forced True when paged)
    chunked_prefill: bool = True
    cache_dtype: str = "bfloat16"   # K/V buffer dtype (f32 for exactness tests)
    # deadline-aware admission (graceful degradation under overload): a
    # request whose absolute deadline has already passed when it reaches the
    # queue head is SHED instead of served — burning prefill+decode energy
    # on a guaranteed SLO miss only delays every request behind it
    shed_past_deadline: bool = True
    # content-addressed prefix cache (serving.prefix_cache): admission
    # matches the longest cached page-aligned prompt prefix and shares those
    # pages (refcounted, copy-on-write) instead of re-prefilling them.
    # Requires paged; only fully-paged models (dense/GQA/kv_quant full
    # attention) actually share — hybrids with ring/recurrent state always
    # miss.  Off by default: bare runs are step-for-step identical to
    # pre-cache behavior.
    prefix_cache: bool = False
    prefix_cache_pages: int = 0     # retained-page cap (0 = pool-pressure
    #                                 bounded: reclaim on allocation failure)
    # deadline-aware eviction of *admitted* decoding streams (opt-in): a
    # stream whose absolute deadline lapses mid-decode is freed via the
    # cancel machinery and reported SHED — the tokens it would still emit
    # are guaranteed-late, so the energy belongs to streams that can pass
    evict_lapsed: bool = False
    # SLO targets for stats() pass-rate reporting (parity with
    # sim.replay.Metrics); virtual-time accounting itself is unaffected
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    # (data, model) serving mesh shape: the replica's data plane spans a
    # device mesh slice instead of one chip.  Per-slot state, cache rows and
    # the page pool/table shard along 'data'; params are storage-sharded and
    # gathered at kernel entry, so every mesh shape serves bit-identically
    # to mesh=None (the sharded==single-device invariant).  None: unsharded.
    mesh: Optional[tuple] = None

    def __post_init__(self):
        """Reject impossible configurations here, with a readable message,
        instead of letting them fail deep inside jitted shape logic."""
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")
        if self.decode_block < 1:
            raise ValueError(
                f"decode_block must be >= 1, got {self.decode_block}")
        if self.min_bucket < 1:
            raise ValueError(
                f"min_bucket must be >= 1, got {self.min_bucket}")
        if self.min_bucket > max(self.max_len // 2, 1):
            raise ValueError(
                f"min_bucket={self.min_bucket} exceeds the prefill bucket "
                f"cap max_len//2={self.max_len // 2} (prompts are truncated "
                f"to max_len//2, so no bucket could ever be used)")
        if self.paged:
            if not self.slot_native:
                raise ValueError(
                    "paged KV requires the slot-native data plane "
                    "(slot_native=True)")
            if self.page_size < 1:
                raise ValueError(
                    f"page_size must be >= 1, got {self.page_size}")
            if self.max_len % self.page_size:
                raise ValueError(
                    f"max_len={self.max_len} must be divisible by "
                    f"page_size={self.page_size}: pages are linear "
                    "(position == logical index) and ctx buckets round to "
                    "page multiples")
            if self.num_pages and self.num_pages < 2:
                # undersized pools (< one page per slot) are legal: pool
                # pressure is handled by preemption + recompute-on-resume.
                # But page 0 is the reserved scratch page, so the pool
                # needs at least one usable page beyond it.
                raise ValueError(
                    f"num_pages={self.num_pages} leaves no usable pages: "
                    "page 0 is the reserved scratch page (need num_pages "
                    ">= 2, or 0 for dense-equivalent capacity)")
        if self.mesh is not None:
            try:
                dp, tp = (int(v) for v in self.mesh)
            except (TypeError, ValueError):
                raise ValueError(
                    f"mesh must be a (data, model) pair, got {self.mesh!r}")
            self.mesh = (dp, tp)
            if dp < 1 or tp < 1:
                raise ValueError(
                    f"mesh axes must be >= 1, got mesh=({dp},{tp})")
            if not self.slot_native:
                raise ValueError(
                    "mesh serving requires the slot-native data plane "
                    "(slot_native=True): the legacy plane is a single-"
                    "device benchmark baseline")
            if self.max_batch % dp:
                raise ValueError(
                    f"max_batch={self.max_batch} is not divisible by the "
                    f"data axis dp={dp}: per-slot state, cache rows, and "
                    "the page table shard max_batch rows along 'data' — "
                    "raise max_batch or shrink dp")
            if self.paged and self.num_pages and self.num_pages % dp:
                raise ValueError(
                    f"num_pages={self.num_pages} is not divisible by the "
                    f"data axis dp={dp}: the paged KV pool shards its page "
                    "axis along 'data' — round num_pages up to a multiple "
                    "of dp (or pass num_pages=0 for an auto-sized pool)")
        if self.prefix_cache and not self.paged:
            raise ValueError(
                "prefix_cache=True requires paged=True: cache entries are "
                "refcounted pages in the PageAllocator pool")
        if self.prefix_cache_pages < 0:
            raise ValueError(
                f"prefix_cache_pages must be >= 0, "
                f"got {self.prefix_cache_pages}")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


class _Stream:
    def __init__(self, req: Request, slot: int, pos: int):
        self.req = req
        self.slot = slot
        self.pos = pos


class ServingEngine:
    """Batched decode over a shared slotted KV cache (continuous batching)
    on ``device`` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, params=None, *,
                 ecfg: Optional[EngineConfig] = None,
                 hw: HardwareProfile = A100_SXM4_40G, seed: int = 0,
                 plant_cfg: ModelConfig = None, device="cuda"):
        # plant_cfg: config used for virtual-time/energy accounting (e.g. the
        # FULL model) while `cfg` (possibly reduced) produces real tokens.
        self.cfg = cfg
        self.ecfg = ecfg = ecfg if ecfg is not None else EngineConfig()
        for flag, what, item in (
                (ecfg.paged, "paged KV (EngineConfig.paged)", "A7 / B3"),
                (ecfg.prefix_cache, "the prefix cache", "A7"),
                (ecfg.mesh is not None, "mesh serving", "A14"),
                (not ecfg.slot_native, "the legacy slot_native=False plane",
                 "A7"),
                (cfg.kv_quant, "int8 KV (kv_quant)", "A9 / B5")):
            if flag:
                raise _not_ported(what, item)
        self.device = torch.device(device)
        self.params = params if params is not None else init_params(
            torch.Generator(device=self.device).manual_seed(seed), cfg)
        self.router = make_router(ecfg.governor.lower() != "defaultnv")
        self.plant = PlantModel(cfg=plant_cfg or cfg, hw=hw, n_chips=1,
                                seed=seed)
        if ecfg.governor.lower() == "greenllm":
            self.controller = DualLoopController(
                hw, profile_decode_table(self.plant))
        else:
            self.controller = MaxFreqController(hw)

        B = ecfg.max_batch
        self.caches = init_cache(cfg, B, ecfg.max_len,
                                 dtype=getattr(torch, ecfg.cache_dtype),
                                 device=self.device)
        self.active: Dict[int, _Stream] = {}
        self.free_slots = list(range(B))
        self.pending: List[Request] = []
        self.vtime = 0.0
        # per-phase accounting (matches sim.replay.Metrics)
        self.prefill_energy_j = 0.0
        self.decode_energy_j = 0.0
        self.idle_energy_j = 0.0    # billed when waiting on future arrivals
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self._tbt: Dict[int, List[float]] = {}
        self.requests: List[Request] = []  # everything this engine has seen
        self._events: List = []     # buffered stream events (drain_events)
        # False -> skip event buffering entirely (serving.api.Server clears
        # this unless an on_event callback is installed)
        self.events_on = True
        self._host_drains = 0       # one per decode block (the audit count)

        # device-resident decode state
        self._tok = torch.zeros((B,), dtype=torch.int32, device=self.device)
        self._pos = torch.zeros((B,), dtype=torch.int32, device=self.device)
        self._active_host = np.zeros(B, bool)
        self._sync_active()

        # prefill buckets: powers of two, capped by the smallest attention
        # buffer and by the prompt truncation length
        attn_kinds = [k for k in set(cfg.layer_kinds)
                      if k in (FULL_ATTN, LOCAL_ATTN)]
        slot_cap = min([attn_buffer_len(cfg, k, ecfg.max_len, False)
                        for k in attn_kinds] or [ecfg.max_len])
        if slot_cap < ecfg.min_bucket:
            raise ValueError(
                f"min_bucket={ecfg.min_bucket} exceeds the smallest "
                f"attention buffer ({slot_cap} positions — sliding-window / "
                f"long-context ring) of model '{cfg.name}': no prefill "
                "bucket would fit a slot write; lower EngineConfig.min_bucket"
            )
        cap = min(slot_cap, max(ecfg.max_len // 2, 1))
        self.buckets: List[int] = []
        b = ecfg.min_bucket
        while b <= cap:
            self.buckets.append(b)
            b *= 2
        if not self.buckets or self.buckets[-1] != cap:
            self.buckets.append(cap)

        # context buckets for decode: attention cost is O(cache buffer), so
        # a block runs over the cache cut to the smallest bucket covering
        # every position in the block
        self.ctx_buckets: List[int] = []
        b = max(ecfg.min_bucket, 32)
        while b < ecfg.max_len:
            self.ctx_buckets.append(b)
            b *= 2
        self.ctx_buckets.append(ecfg.max_len)
        self._k_blocks = tuple(sorted({1, 4, 16, ecfg.decode_block},
                                      reverse=True))
        # (ctx, kb) shapes already dispatched: wall-clock accounting bills a
        # shape's first block to the plant model (it includes the one-time
        # kernel build), as the reference does for its jit compiles
        self._warmed: set = set()

    def install_observability(self, metrics=None, tracer=None,
                              ledger=None) -> None:
        raise _not_ported("observability sinks (metrics, tracer, ledger)",
                          "A7")

    def _sync_active(self) -> None:
        """Re-upload the host active mask (one small transfer per stream
        join/leave)."""
        self._active = torch.from_numpy(self._active_host.copy()).to(
            self.device)

    # -- request intake --------------------------------------------------------
    def submit(self, req: Request, prompt_tokens: Optional[np.ndarray] = None):
        sp = req.sampling        # temperature None or 0 means greedy
        if sp is not None and sp.temperature is not None \
                and sp.temperature > 0.0:
            raise _not_ported("sampling with temperature > 0", "A6")
        if not req.cls:
            req.cls = self.router.class_names[
                self.router.classify(req.prompt_len)]
        if prompt_tokens is None:
            rng = np.random.default_rng(req.rid)
            prompt_tokens = rng.integers(
                0, self.cfg.vocab_size, size=max(req.prompt_len, 1))
        req.prompt = np.asarray(prompt_tokens, np.int32)[-self.ecfg.max_len // 2:]
        req.state = RequestState.QUEUED
        self.pending.append(req)
        self.requests.append(req)

    def _emit(self, ev) -> None:
        if self.events_on:
            self._events.append(ev)

    def _account_prefill(self, req: Request):
        n_tokens = req.prompt_len
        t_pf = self.plant.prefill_latency(n_tokens, self.controller.freq)
        p_pf = self.plant.prefill_power(n_tokens, self.controller.freq, t_pf)
        self.prefill_energy_j += t_pf * p_pf
        self.prefill_tokens += n_tokens
        self.vtime += t_pf
        req.prefill_start = self.vtime - t_pf
        req.first_token = self.vtime

    def _start_stream(self, req: Request, slot: int, tok: int, pos: int):
        self.active[slot] = _Stream(req, slot, pos)
        req.tokens.append(tok)
        req.tokens_emitted = 1
        self._emit(TokenEvent(req.rid, self.vtime, (tok,), 1))
        req.state = RequestState.DECODING
        self._emit(StateEvent(req.rid, self.vtime, RequestState.DECODING))
        self._active_host[slot] = True
        self._sync_active()

    def _admit_slot(self, req: Request, slot: int):
        prompt = req.prompt
        L = len(prompt)
        bucket = next(b for b in self.buckets if b >= L)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :L] = prompt
        logits, self.caches, _ = prefill_into_slot(
            self.params, self.cfg, torch.from_numpy(padded).to(self.device),
            L, self.caches, slot)
        self._tok[slot] = logits[0].argmax().to(torch.int32)
        self._pos[slot] = L
        self._account_prefill(req)
        # one tiny host read per admission (the first token id)
        self._start_stream(req, slot, int(self._tok[slot]), L)

    def _admit(self):
        while self.pending and self.free_slots:
            req = self.pending[0]
            if max(req.arrival, req.not_before) > self.vtime + 1e-12:
                break        # FIFO head not arrived yet; the driver jumps
                #              the clock when fully idle
            if self.ecfg.shed_past_deadline and req.deadline >= 0 \
                    and self.vtime > req.deadline + 1e-12:
                self.pending.pop(0)
                self._mark_shed(req)
                continue
            if req.tokens or len(req.prompt) > self.buckets[-1]:
                raise _not_ported(
                    "a prompt longer than the largest prefill bucket "
                    "(the chunked-prefill route)", "A7")
            self.pending.pop(0)
            self._admit_slot(req, self.free_slots.pop(0))

    # -- cancellation / failure ------------------------------------------------
    def cancel(self, rid: int) -> bool:
        """Cancel a queued or decoding request, freeing its slot at once.
        False for unknown or already-terminal requests."""
        return self._terminate(rid, RequestState.CANCELLED)

    def fail(self, rid: int) -> bool:
        """Like ``cancel`` with the FAILED terminal state (the system gave
        up on the request, not the caller)."""
        return self._terminate(rid, RequestState.FAILED)

    def _terminate(self, rid: int, state: RequestState) -> bool:
        for i, req in enumerate(self.pending):
            if req.rid == rid:
                self.pending.pop(i)
                return self._mark_terminal(req, state)
        for slot, st in list(self.active.items()):
            if st.req.rid == rid:
                del self.active[slot]
                self._release_slot(slot)
                return self._mark_terminal(st.req, state)
        return False

    def _release_slot(self, slot: int) -> None:
        self._active_host[slot] = False
        self._sync_active()
        self.free_slots.append(slot)

    def _mark_terminal(self, req: Request, state: RequestState) -> bool:
        req.state = state
        self._emit(StateEvent(req.rid, self.vtime, state))
        return True

    def _evict_lapsed(self) -> None:
        """Opt-in (``EngineConfig.evict_lapsed``): free decoding streams
        whose deadline has lapsed and report them SHED."""
        if not self.ecfg.evict_lapsed:
            return
        for slot, st in list(self.active.items()):
            req = st.req
            if req.deadline >= 0 and self.vtime > req.deadline + 1e-12:
                del self.active[slot]
                self._release_slot(slot)
                self._mark_shed(req)

    def _mark_shed(self, req: Request) -> None:
        req.state = RequestState.SHED
        self._emit(StateEvent(req.rid, self.vtime, RequestState.SHED))

    # -- decode ----------------------------------------------------------------
    def _account_decode_step(self, batch: int, ctx: float, dur=None) -> float:
        f = self.controller.maybe_tick(self.vtime)
        if dur is None:
            dur = self.plant.decode_step_latency(batch, ctx, f)
        self.decode_energy_j += dur * self.plant.decode_power(batch, ctx, f,
                                                              dur)
        self.decode_tokens += batch
        self.vtime += dur
        self.controller.record_tokens(self.vtime, batch, dur)
        return dur

    def _finish_check(self, st: _Stream) -> bool:
        if (st.req.tokens_emitted >= st.req.output_len
                or st.pos >= self.ecfg.max_len - 1):
            st.req.finish = self.vtime
            st.req.state = RequestState.FINISHED
            return True
        return False

    def _retire(self, slots: List[int]):
        for slot in slots:
            self.free_slots.append(slot)
            del self.active[slot]
            self._active_host[slot] = False
        if slots:
            self._sync_active()

    def _run_block(self, ctx: int, kb: int) -> torch.Tensor:
        """``kb`` decode steps over the caches cut to ``ctx`` positions;
        returns the (kb, B) tokens, still on the device."""
        sliced = _slice_caches(self.caches, ctx, self.ecfg.max_len)
        tok, pos, active = self._tok, self._pos, self._active
        out = []
        for _ in range(kb):
            logits, _ = decode_step(self.params, self.cfg, tok[:, None],
                                    sliced, pos)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            tok = torch.where(active, nxt, tok)
            pos = pos + active.to(torch.int32)
            out.append(tok)
        self._tok, self._pos = tok, pos
        return torch.stack(out)

    def _decode_block(self, k: int) -> int:
        """Run ``k`` decode steps with a single host drain at the end.  The
        batch composition is fixed for the block (the caller sizes ``k`` to
        the next leave event), so the virtual-time accounting needs no
        device data."""
        snapshot = list(self.active.items())
        batch = len(snapshot)
        if batch == 0:
            return 0
        max_pos = max(st.pos for st in self.active.values())
        wall = self.ecfg.use_wall_clock
        toks_dev = []
        durs: List[Optional[float]] = []   # per-step; None -> plant model
        left = k
        while left > 0:
            # fill the current ctx bucket before stepping up to the next one
            ctx = next((c for c in self.ctx_buckets if c > max_pos),
                       self.ecfg.max_len)
            room = max(ctx - max_pos, 1)
            kb = next((b for b in self._k_blocks if b <= min(left, room)), 1)
            t0 = time.perf_counter() if wall else 0.0
            tk = self._run_block(ctx, kb)
            toks_dev.append(tk)
            if wall:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                seen = (ctx, kb) in self._warmed
                self._warmed.add((ctx, kb))
                dt = (time.perf_counter() - t0) / kb
                durs.extend([dt if seen else None] * kb)
            else:
                durs.extend([None] * kb)
            max_pos += kb
            left -= kb
        # single drain per block: (k, B) int32
        self._host_drains += 1
        toks = torch.cat(toks_dev).cpu().numpy()
        done: List[int] = []
        block_toks: Dict[int, List[int]] = {slot: [] for slot, _ in snapshot}
        for i in range(k):
            ctx = float(np.mean([st.pos for st in self.active.values()
                                 if st.slot not in done]))
            alive = batch - len(done)
            dur = self._account_decode_step(alive, ctx, durs[i])
            for slot, st in snapshot:
                if slot in done:
                    continue
                tok = int(toks[i, slot])
                st.req.tokens.append(tok)
                block_toks[slot].append(tok)
                st.pos += 1
                st.req.tokens_emitted += 1
                self._tbt.setdefault(st.req.rid, []).append(dur)
                if self._finish_check(st):
                    done.append(slot)
        for slot, st in snapshot:       # one TokenEvent per stream per block
            if block_toks[slot]:
                self._emit(TokenEvent(
                    st.req.rid, self.vtime, tuple(block_toks[slot]),
                    len(block_toks[slot])))
        by_slot = dict(snapshot)        # FINISHED strictly after the tokens
        for slot in done:
            self._emit(StateEvent(by_slot[slot].req.rid, self.vtime,
                                  RequestState.FINISHED))
        self._retire(done)
        return k

    # -- Backend protocol --------------------------------------------------------
    def has_work(self) -> bool:
        """Anything queued or decoding."""
        return bool(self.pending or self.active)

    def drain_events(self) -> List:
        """Hand out (and clear) the buffered stream events."""
        ev, self._events = self._events, []
        return ev

    def _advance_idle(self) -> bool:
        """Nothing running and the FIFO head not yet arrived: jump the
        virtual clock to the head's arrival, billing the gap at idle
        power."""
        if not self.pending:
            return False
        head = self.pending[0]
        nxt = max(head.arrival, head.not_before)
        if nxt <= self.vtime + 1e-12:
            return False
        self.idle_energy_j += (nxt - self.vtime) * self.plant.idle_power
        self.vtime = nxt
        return True

    def step(self, k: Optional[int] = None) -> int:
        """One scheduling round: admit arrived requests, then decode a block
        of ``k`` steps (default: the horizon to the next guaranteed leave).
        Returns the number of decode steps executed."""
        self._evict_lapsed()
        self._admit()
        if not self.active:
            if self._advance_idle():
                return 0
            if self.pending:
                raise RuntimeError(
                    "serving stalled: pending streams cannot obtain slots "
                    "and nothing is decoding")
            return 0
        horizon = self._horizon()
        return self._decode_block(max(min(k, horizon) if k is not None
                                      else horizon, 1))

    def _horizon(self) -> int:
        """Steps until the next guaranteed stream leave, capped at
        ``decode_block``."""
        rem_out = min(max(st.req.output_len - st.req.tokens_emitted, 1)
                      for st in self.active.values())
        rem_len = min(self.ecfg.max_len - 1 - st.pos
                      for st in self.active.values())
        return max(1, min(rem_out, rem_len, self.ecfg.decode_block))

    @property
    def now(self) -> float:
        """The engine's virtual time."""
        return self.vtime

    def report(self) -> ServingReport:
        """The typed serving report (the scoring shared with the
        reference's backends)."""
        return build_report(
            backend="engine", requests=self.requests, tbt_records=self._tbt,
            slo=self.ecfg.slo, class_names=self.router.class_names,
            prefill_energy_j=self.prefill_energy_j,
            decode_energy_j=self.decode_energy_j,
            idle_energy_j=self.idle_energy_j,
            prefill_tokens=self.prefill_tokens,
            decode_tokens=self.decode_tokens,
            duration_s=self.vtime, preempted=0, migrated=0,
            page_occupancy_peak=0.0)
