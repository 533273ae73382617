"""Slot-native serving engine (port of ``src/repro/serving/engine.py``):
continuous batching over a shared slotted KV cache or a shared page pool,
driven by the same GreenLLM control plane (router, plant, decode
controller, accounting) as the reference.

Data plane:

* **Bucketed slot prefill** — prompts are right-padded to power-of-two
  buckets (capped at ``max_len // 2``, the prompt truncation length) and run
  through ``models.prefill_into_slot``, which writes K/V in place into one
  row of the batch cache (or into the stream's page chain).  The first
  token is drawn from the last logits.
* **k-step decode blocks** — ``kb`` steps run back to back over the cache
  viewed as ``[:, :ctx]`` (the smallest context bucket covering every
  position in the block), or, when paged, over the page table sliced to the
  pages of that bucket, with per-slot positions and an active mask:
  inactive rows hold their token and position.  Nothing inside a block
  reads a device value on the host; the block's tokens are drained once at
  its end (``_host_drains`` counts the drains, as in the reference).
* **Paged KV** (``EngineConfig.paged``) — full-length attention buffers are
  a shared pool of pages (``serving.pager``); chains grow at block
  boundaries, and a dry pool shrinks the block, reclaims cached prefixes,
  then preempts the youngest stream (recompute-on-resume).  The page table
  has a device mirror, uploaded only after the host table changed.
  Buffers shorter than ``max_len`` (gemma2's and recurrentgemma's
  sliding-window rings) and recurrent row states (SSM, RG-LRU) stay dense
  rows beside the pools; such a hybrid never shares prefixes.
* **Chunked prefill** — a prefix hit, a resume after preemption or a prompt
  longer than the largest bucket (capped by the smallest ring) is
  prefilled in bucket-sized chunks (``models.prefill_chunk_into_slot``,
  into page chains and dense rows alike), one per stream per scheduling
  round, interleaved with decode blocks.  A recurrent row state is frozen
  by the active mask while its stream is between chunks, and a stream's
  first chunk starts it from zeros, so a slot freed by a finished, cancelled
  or preempted stream is refilled from a clean row with no extra work.
* **Prefix cache** (``EngineConfig.prefix_cache``) — admission matches the
  longest cached page-aligned prompt prefix and shares those pages
  (refcounted, copy-on-write) instead of prefilling them again.
* **Per-slot sampling** — each batch row carries its own temperature,
  top-k, top-p and threefry *base* key in device vectors, written only at
  slot assignment.  The draw for the token at position q folds q into the
  row's key (``core.prng.fold_in``), so a stream's draws are a pure
  function of (lane, position) and replay identically after preemption
  with recompute.  Whether a block samples is a host-known flag:
  all-greedy blocks take the plain argmax.

Observability (``install_observability``): metrics, a tracer and an energy
ledger, each behind one ``is None`` check, published from host floats at
the points that already run on the host (prefill accounting, the end of a
decode block, an idle jump); an instrumented run is step-identical to a
bare one.

Profiler ranges: while a ``torch.profiler`` records, a round opens named
``record_function`` ranges at its layer boundaries, which the profiler's
timeline lays over the device's kernels: ``serve.step`` (the whole round)
holds ``serve.admit`` (with ``serve.prefill`` for each bucketed prompt,
upload through the first token's host read), ``serve.chunk`` (one chunk
of a chunked prefill), ``serve.decode`` (a decode block up to its drain,
one ``serve.decode.step`` per step) and ``serve.account`` (the block's
host bookkeeping after the drain); ``serve.pages`` holds page growth,
reclaim and preemption wherever they run.  With no profiler running a
range costs one flag read (``_range``).

Virtual time and energy come from the numpy plant model, so a run's
report depends only on the tokens, and identical tokens give a report
identical to the reference engine's.

Int8 KV (``cfg.kv_quant``): the caches or pools hold int8 K/V with
float32 scales, whatever ``cache_dtype`` says (as in the reference);
quantizing happens inside the writes and adds no host sync.

Stream migration (``export_stream`` / ``import_stream``): a decoding
stream leaves one engine as a ``StreamHandoff`` (copies of its page chain,
its dense rows and recurrent rows, on the device, with its position, last
token, resolved sampling config and lane) and joins another engine's decode
batch; ``serving.cluster`` moves every prefilled stream this way.

The legacy plane (``EngineConfig(slot_native=False)``), ported as the
reference keeps it, as a benchmark baseline: each prompt through the
unpadded ``models.prefill`` into a fresh one-row cache spliced into the
batch cache, then one decode step of the whole batch per round at the
batch-wide ``max(pos)`` with a host argmax (greedy only; wrong for
mixed-position batches, as in the reference).  With
``chunked_prefill=False`` the slot-native engine admits a prompt longer
than the largest bucket the same way (the eager fallback) and decodes it
in its blocks.

Serving mesh (``EngineConfig.mesh = (dp, tp)``): the engine's stored
tensors live on a ``torch.distributed`` (data, model) mesh of ``dp * tp``
ranks, each rank running this same engine (``launch.mesh``).  Params are
stored by ``launch.shardings.serving_param_specs``; per-slot vectors, the
page table, and the page axis of a pool (or the rows of a dense cache)
along 'data'.  Every kernel entry (prefill, chunk, decode block) gathers
what it reads to replicated plain tensors in one all-gather, computes the
*whole* batch on every rank (a GEMM over a subset of rows can round
differently from the full batch's, ROADMAP §C), and each rank keeps its
own shard of what the entry wrote.  The host scheduler runs identically on
every rank and per-row sampling lanes make every rank draw the same
tokens, so each mesh shape serves bit-identically to ``mesh=None``.  At
(1,1) nothing is sharded, and neither the gather nor the write-back
copies: the path is the single-device one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch.core import (CounterfactualPricer, DualLoopController,
                              MaxFreqController, Request, RequestState,
                              SamplingParams, ServingReport, SLOConfig,
                              StateEvent, TokenEvent, build_report,
                              make_router)
from repro_torch.core.hardware import HardwareProfile, A100_SXM4_40G
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.core.report import slo_pass_metrics
from repro_torch.core.telemetry import TBTMeter
from repro_torch.launch.shardings import (gather_replicated, keep_shards,
                                          local_row, make_serving_shard_ctx,
                                          place, place_tree,
                                          serving_param_specs,
                                          shard_serving_caches)
from repro_torch.models import ModelConfig, decode_step, init_cache, \
    init_params, prefill, prefill_chunk_into_slot, prefill_into_slot, \
    sample_tokens_batched
from repro_torch.models.config import FULL_ATTN, LOCAL_ATTN
from repro_torch.models.kvcache import (attn_buffer_len, cache_row_extract,
                                        cache_row_insert, is_paged,
                                        paged_chain_extract,
                                        paged_chain_insert, paged_page_copy)
from repro_torch.sim import PlantModel
from repro_torch.sim.profiling import profile_decode_table
from .pager import PageAllocator
from .prefix_cache import PrefixCache

_NO_RANGE = contextlib.nullcontext()


def _range(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records,
    else a shared no-op context: a bare run pays one flag read.  The flag
    is read through its module on every call, as the profiler rebinds it."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return _NO_RANGE


def _slice_caches(caches, ctx: int, max_len: int):
    """Views of the full-length dense attention buffers cut to ``ctx``
    positions (stacked leaves (n_rep, B, buf_len, KH, hd)); ring buffers
    (shorter than max_len) and page pools are kept whole.  Writes through
    a view land in the full buffer, so nothing is spliced back."""
    out = []
    for stage in caches:
        blocks = []
        for d in stage:
            if "k" in d and d["k"].shape[2] == max_len and ctx < max_len:
                blocks.append({kk: vv[:, :, :ctx] for kk, vv in d.items()})
            else:
                blocks.append(d)
        out.append(tuple(blocks))
    return out


def _row_subkeys(keys: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One draw key per batch row: each token's sequence position folded
    into the row's base lane.  Lanes never advance, so draw i is a pure
    function of (lane, position i), which is what makes seeded streams
    replay identical tokens after preemption with recompute."""
    return fold_in(keys, positions)


def _sample_rows(sampled: bool, logits, pos_next, keys, temps, topk, topp):
    """Per-row temperature / top-k / top-p draws when ``sampled`` (a
    host-known flag: does any live row sample?), the plain argmax otherwise,
    so all-greedy blocks never pay for the sampler's sort."""
    if sampled:
        return sample_tokens_batched(logits, temps, topk, topp,
                                     _row_subkeys(keys, pos_next))
    return logits.argmax(dim=-1).to(torch.int32)


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


@dataclasses.dataclass
class StreamHandoff:
    """A stream extracted from one engine for adoption by another (the
    disaggregated prefill -> decode migration unit).

    ``blocks`` parallels the engine's caches: per stage, a tuple of
    ``("pages", extracted chain dict | None)`` for paged attention pools
    (only the live chain's pages) or ``("row", row dict)`` for bounded
    dense buffers (sliding-window rings) and recurrent SSM / RG-LRU
    states, all copies on the exporter's device.  With ``pos``,
    ``last_token``, the sampling config and the lane this is the stream's
    whole decodable state: import followed by decode gives the tokens of a
    stream that never migrated, sampled ones included, because draw i is
    ``fold_in(rng_lane, position i)``.
    """
    req: Request
    pos: int
    last_token: int
    n_pages: int                    # chain length to adopt (0 = nothing paged)
    blocks: List                    # per-stage tuples of (kind, payload)
    export_time: float              # exporter's vtime at extraction
    page_size: int = 0              # 0 when the exporter is unpaged
    cfg_name: str = ""              # guard against cross-model migration
    sampling: Optional[SamplingParams] = None   # exporter-resolved config
    rng_lane: Optional[object] = None  # (2,) uint32 base lane (np.ndarray)
    # the stream's partial energy ledger (core.attribution.LedgerCarry); a
    # no-op on adoption when both replicas share one ledger (the cluster)
    ledger_carry: Optional[object] = None
    # exporter's (data, model) mesh shape (None = unsharded): the adopter
    # refuses a stream from another mesh shape — adopting across meshes
    # would silently reshard mid-stream
    mesh_shape: Optional[tuple] = None


class _Stream:
    def __init__(self, req: Request, slot: int, pos: int, order: int = 0):
        self.req = req
        self.slot = slot
        self.pos = pos
        self.order = order          # admission sequence; preemption victims
        #                             are chosen youngest-first


class _ChunkState:
    """A stream mid-chunked-prefill: it owns a slot (the key it is filed
    under) and that slot's page chain, and does not decode yet.  ``tokens``
    is the full context to prefill and ``start`` the next chunk's position;
    ``resume_tok`` carries the already-emitted next token of a preempted
    stream being recomputed."""

    def __init__(self, req: Request, tokens: np.ndarray,
                 resume_tok: Optional[int] = None, order: int = 0):
        self.req = req
        self.tokens = tokens
        self.start = 0
        self.resume_tok = resume_tok
        self.order = order
        self.last_tok = None        # the last chunk's draw (device scalar)
        self.billed = False         # the first *computed* chunk sets
        #                             prefill_start (a prefix hit starts at
        #                             start > 0)


class ServingEngine:
    """Batched decode over a shared slotted KV cache or page pool
    (continuous batching) on ``device`` ("cuda" unless the caller asks for
    the CPU)."""

    def __init__(self, cfg: ModelConfig, params=None, *,
                 ecfg: Optional[EngineConfig] = None,
                 hw: HardwareProfile = A100_SXM4_40G, seed: int = 0,
                 plant_cfg: ModelConfig = None, plant: PlantModel = None,
                 decode_table=None, controller=None, device="cuda",
                 name: str = "engine", metrics=None, tracer=None,
                 ledger=None):
        # plant_cfg: config used for virtual-time/energy accounting (e.g. the
        # FULL model) while `cfg` (possibly reduced) produces real tokens.
        # plant / decode_table / controller: the cluster's injection points
        # (one shared profiling pass, each replica its role's controller).
        # name labels this engine's metric series and spans; metrics /
        # tracer / ledger are the observability sinks (None: every emission
        # site is skipped).
        self.cfg = cfg
        self.ecfg = ecfg = ecfg if ecfg is not None else EngineConfig()
        if ecfg.mesh is not None:
            self._validate_mesh(cfg, ecfg)
        self.device = torch.device(device)
        params = params if params is not None else init_params(
            torch.Generator(device=self.device).manual_seed(seed), cfg)
        # serving mesh (None = the single-device plane).  Built before any
        # other device allocation so caches and slot vectors land sharded.
        self.mesh = None
        self._shd = None
        if ecfg.mesh is not None:
            from repro_torch.launch.mesh import make_serving_mesh
            self.mesh = make_serving_mesh(*ecfg.mesh, device=self.device)
            self._shd = make_serving_shard_ctx(self.mesh)
            specs, _ = serving_param_specs(cfg, self.mesh)
            params = place_tree(params, specs, self.mesh)
        self.params = params
        self.router = make_router(ecfg.governor.lower() != "defaultnv")
        self.plant = plant if plant is not None else PlantModel(
            cfg=plant_cfg or cfg, hw=hw, n_chips=1, seed=seed)
        if controller is not None:
            self.controller = controller
        elif ecfg.governor.lower() == "greenllm":
            table = decode_table if decode_table is not None else \
                profile_decode_table(self.plant)
            self.controller = DualLoopController(hw, table)
        else:
            self.controller = MaxFreqController(hw)

        B = ecfg.max_batch
        # paged mode needs chunking (a resume replays an arbitrary-length
        # context); tracked here, the caller's config is never mutated
        self._chunked = bool(ecfg.chunked_prefill or ecfg.paged)
        if ecfg.paged:
            ps = ecfg.page_size
            self._max_pages = -(-ecfg.max_len // ps)
            n_pages = ecfg.num_pages or (B * self._max_pages + 1)
            if self.mesh is not None:
                # auto-sized pools round up so the page axis stays divisible
                dp = ecfg.mesh[0]
                n_pages = -(-n_pages // dp) * dp
            self.pager = PageAllocator(n_pages, ps, B, self._max_pages)
            if self.mesh is not None:
                # (max_streams, max_pages) table rows shard along 'data'
                self.pager.place = self._row_pin
            pool = (n_pages, ps)
        else:
            self.pager = None
            pool = None
        self.caches = init_cache(cfg, B, ecfg.max_len,
                                 dtype=getattr(torch, ecfg.cache_dtype),
                                 device=self.device, paged_pool=pool)
        if self.mesh is not None:
            self.caches = shard_serving_caches(self.caches, self.mesh)
        # prefix sharing is sound only when every cache leaf is a page pool
        self._cacheable = ecfg.prefix_cache and all(
            is_paged(d) for stage in self.caches for d in stage)
        self.prefix_cache = PrefixCache(
            self.pager, ecfg.prefix_cache_pages) \
            if ecfg.prefix_cache else None
        self.active: Dict[int, _Stream] = {}
        self.prefilling: Dict[int, _ChunkState] = {}
        self.free_slots = list(range(B))
        self.pending: List[Request] = []
        self.vtime = 0.0
        self.energy_j = 0.0         # prefill + decode, in billing order
        # per-phase accounting (matches sim.replay.Metrics)
        self.prefill_energy_j = 0.0
        self.decode_energy_j = 0.0
        self.idle_energy_j = 0.0    # billed when waiting on future arrivals
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self._order = 0
        self._tbt: Dict[int, List[float]] = {}
        self._completed = 0
        self._preempted = 0
        self._cancelled = 0
        self._failed = 0            # given up via fail()
        self._shed = 0              # dropped for a lapsed deadline
        self._imported = 0          # adopted handoffs (report().migrated);
        #                             exports are counted by the cluster
        self.requests: List[Request] = []  # everything this engine has seen
        self._events: List = []     # buffered stream events (drain_events)
        # False -> skip event buffering entirely (serving.api.Server clears
        # this unless an on_event callback is installed)
        self.events_on = True
        self._host_drains = 0       # one per decode block (the audit count)
        self.name = name
        self.metrics = None
        self.tracer = None
        self.ledger = None          # core.attribution.EnergyLedger (opt-in)
        self._cf = None             # counterfactual pricer (with a ledger)
        self._m = None              # bound metric children (with metrics)
        self._obs_tbt = None        # engine-level TBT window for p95/p99
        if metrics is not None or tracer is not None or ledger is not None:
            self.install_observability(metrics, tracer, ledger)

        # device-resident decode state
        self._tok = self._row_pin(
            torch.zeros((B,), dtype=torch.int32, device=self.device))
        self._pos = self._row_pin(
            torch.zeros((B,), dtype=torch.int32, device=self.device))
        self._active_host = np.zeros(B, bool)
        self._sync_active()
        # per-slot sampling lanes: temperature / top-k / top-p and each row's
        # threefry base key (two 32-bit words in int64), written only at
        # slot assignment and read only by the draws
        self._temps = self._row_pin(
            torch.zeros((B,), dtype=torch.float32, device=self.device))
        self._topk = self._row_pin(
            torch.zeros((B,), dtype=torch.int32, device=self.device))
        self._topp = self._row_pin(
            torch.ones((B,), dtype=torch.float32, device=self.device))
        self._keys = self._row_pin(
            torch.zeros((B, 2), dtype=torch.int64, device=self.device))
        self._sampled_host = np.zeros(B, bool)  # host mirror of temps > 0
        self._base_key = prng_key(seed + 1)     # unseeded-lane source

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
        # every position in the block.  Paged mode slices the page table
        # instead, so its buckets are rounded up to page multiples.
        self.ctx_buckets: List[int] = []
        b = max(ecfg.min_bucket, 32)
        while b < ecfg.max_len:
            self.ctx_buckets.append(b)
            b *= 2
        self.ctx_buckets.append(ecfg.max_len)
        if ecfg.paged:
            ps = ecfg.page_size
            self.ctx_buckets = sorted({-(-c // ps) * ps
                                       for c in self.ctx_buckets})
        # chunked prefill: chunk length = the largest admission bucket
        self.chunk_len = self.buckets[-1]
        self._k_blocks = tuple(sorted({1, 4, 16, ecfg.decode_block},
                                      reverse=True))
        # (ctx, kb) shapes already dispatched: wall-clock accounting bills a
        # shape's first block to the plant model (it includes the one-time
        # kernel build), as the reference does for its jit compiles
        self._warmed: set = set()

    # -- serving mesh ----------------------------------------------------------
    @staticmethod
    def _validate_mesh(cfg: ModelConfig, ecfg: "EngineConfig") -> None:
        """Model-dependent mesh divisibility, rejected with an actionable
        message before any process group is needed.  (Model-independent
        checks — max_batch/num_pages vs dp — live in
        ``EngineConfig.__post_init__``.)"""
        dp, tp = ecfg.mesh
        if tp > 1 and cfg.num_heads % tp:
            raise ValueError(
                f"model '{cfg.name}' has num_heads={cfg.num_heads}, not "
                f"divisible by the model axis tp={tp}: attention heads "
                "partition over 'model' — pick tp from the divisors of "
                "num_heads (or tp=1)")
        if tp > 1 and cfg.is_moe and cfg.num_experts % tp:
            raise ValueError(
                f"MoE model '{cfg.name}' has num_experts={cfg.num_experts}, "
                f"not divisible by the model axis tp={tp}: expert weights "
                "place each expert on exactly one model shard — pick tp "
                "from the divisors of num_experts (or tp=1)")

    def _row_pin(self, x):
        """Store a per-slot device tensor (leading dim max_batch) along
        'data': this rank keeps its rows.  Identity off mesh, and no copy
        where 'data' has one rank."""
        if self.mesh is None:
            return x
        return place(x, self._shd.row_spec(x.ndim), self.mesh)

    def _put_row(self, vec, slot: int, value) -> None:
        """Write row ``slot`` of a per-slot tensor in place; on a mesh into
        the shard that holds it (every rank computed ``value`` itself)."""
        if self.mesh is None:
            vec[slot] = value
            return
        i = local_row(vec, slot)
        if i is not None:
            vec.to_local()[i] = value

    def _replicated(self, table: bool = False):
        """What a kernel entry reads, as replicated plain tensors gathered
        in one collective: {"params", "caches", "rows" (the per-slot
        vectors by name), "table" (the page table, when asked)}.  Off mesh,
        and for every unsharded leaf, the stored tensors themselves."""
        rows = {"tok": self._tok, "pos": self._pos, "active": self._active,
                "temps": self._temps, "topk": self._topk,
                "topp": self._topp, "keys": self._keys}
        tree = {"params": self.params, "caches": self.caches, "rows": rows,
                "table": self.pager.table_device(self.device)
                if table else None}
        return gather_replicated(tree, self.mesh)

    def _caches_full(self):
        """The caches gathered to replicated (themselves off mesh); after
        writing into them, ``keep_shards(self.caches, full, self.mesh)``."""
        return gather_replicated(self.caches, self.mesh)

    def _agree(self, value: float) -> float:
        """Rank 0's ``value`` on every rank of a multi-rank mesh (a measured
        wall-clock time, so that every rank's scheduler takes the same
        decisions); ``value`` itself otherwise."""
        if self.mesh is None or self.mesh.size() == 1:
            return value
        import torch.distributed as dist
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0)
        return float(t[0])

    def install_observability(self, metrics=None, tracer=None,
                              ledger=None) -> None:
        """Install metric / trace / attribution sinks (``Server(metrics=...,
        tracer=..., ledger=...)`` routes through here).  Any may be None;
        with all None every emission site below is a skipped ``is not
        None`` check, as with ``events_on``.  Emission rides the existing host-sync points only:
        publishing reads host floats the engine already computed, never a
        device value.  ``ledger`` (a ``core.attribution.EnergyLedger``,
        shareable across replicas) mirrors every billed joule — and prices
        the same intervals at max frequency through a noiseless plant
        clone, so the live plant's RNG (and hence the run) is untouched."""
        self.metrics = metrics
        self.tracer = tracer
        if ledger is not None:
            self.ledger = ledger
            ledger.register(self.name)
            self._cf = CounterfactualPricer(self.plant)
        if tracer is not None:
            self.controller.on_decision = tracer.bind(self.name)
        if metrics is not None:
            self._init_metrics(metrics)

    def _init_metrics(self, reg) -> None:
        """Bind this replica's metric children once (hot paths touch bound
        children — a float add — not the label-resolution path).  Metric
        names are a stable API; see README "Observability"."""
        r = self.name
        ev = reg.counter("greenllm_requests_total",
                         "request lifecycle events", ("replica", "event"))
        slo = reg.counter("greenllm_slo_total",
                          "per-request SLO verdicts at finish",
                          ("replica", "kind", "outcome"))
        self._m = {
            "ev": {k: ev.labels(replica=r, event=k) for k in
                   ("submitted", "completed", "cancelled", "failed", "shed",
                    "preempted", "imported", "exported")},
            "slo": {(k, o): slo.labels(replica=r, kind=k, outcome=o)
                    for k in ("ttft", "tbt") for o in ("pass", "miss")},
            "tok_pf": reg.counter("greenllm_tokens_total",
                                  "tokens processed by phase",
                                  ("replica", "phase"))
                         .labels(replica=r, phase="prefill"),
            "tok_dec": reg.counter("greenllm_tokens_total", "",
                                   ("replica", "phase"))
                          .labels(replica=r, phase="decode"),
            "e_pf": reg.counter("greenllm_energy_joules_total",
                                "energy by phase (virtual-clock accounting)",
                                ("replica", "phase"))
                       .labels(replica=r, phase="prefill"),
            "e_dec": reg.counter("greenllm_energy_joules_total", "",
                                 ("replica", "phase"))
                        .labels(replica=r, phase="decode"),
            "e_idle": reg.counter("greenllm_energy_joules_total", "",
                                  ("replica", "phase"))
                         .labels(replica=r, phase="idle"),
            "e_saved": reg.counter(
                "greenllm_energy_saved_joules_total",
                "counterfactual joules saved vs max frequency (estimate)",
                ("replica",)).labels(replica=r),
            "freq": reg.gauge("greenllm_frequency_mhz",
                              "controller SM clock set point", ("replica",))
                       .labels(replica=r),
            "occ": reg.gauge("greenllm_page_occupancy",
                             "KV page-pool occupancy [0,1]", ("replica",))
                      .labels(replica=r),
            "frag": reg.gauge("greenllm_page_fragmentation",
                              "last-page slack fraction", ("replica",))
                       .labels(replica=r),
            "q_pending": reg.gauge("greenllm_queue_depth",
                                   "streams by lifecycle stage",
                                   ("replica", "queue"))
                            .labels(replica=r, queue="pending"),
            "q_prefill": reg.gauge("greenllm_queue_depth", "",
                                   ("replica", "queue"))
                            .labels(replica=r, queue="prefilling"),
            "q_active": reg.gauge("greenllm_queue_depth", "",
                                  ("replica", "queue"))
                           .labels(replica=r, queue="active"),
            "ttft": reg.histogram("greenllm_ttft_seconds",
                                  "time to first token", ("replica",),
                                  buckets=(0.05, 0.1, 0.2, 0.4, 0.8, 1.6,
                                           3.2, 6.4))
                       .labels(replica=r),
            "tbt": reg.histogram("greenllm_tbt_seconds",
                                 "time between tokens", ("replica",),
                                 buckets=(0.005, 0.01, 0.02, 0.04, 0.08,
                                          0.1, 0.15, 0.25, 0.5))
                      .labels(replica=r),
            "p95": reg.gauge("greenllm_tbt_p95_seconds",
                             "sliding-window p95 TBT", ("replica",))
                      .labels(replica=r),
            "p99": reg.gauge("greenllm_tbt_p99_seconds",
                             "sliding-window p99 TBT", ("replica",))
                      .labels(replica=r),
        }
        if self.tracer is not None:
            # ring-buffer overflow in the tracer is otherwise silent
            # truncation; surface the drop counts where dashboards look
            self._m["drop_spans"] = reg.gauge(
                "greenllm_tracer_dropped_spans",
                "trace spans lost to ring-buffer overflow").labels()
            self._m["drop_decisions"] = reg.gauge(
                "greenllm_tracer_dropped_decisions",
                "DVFS decisions lost to ring-buffer overflow").labels()
        if self.ecfg.prefix_cache:
            # registered only when caching is on: a bare engine's metric
            # families are byte-identical to pre-cache exposition
            self._m["pc_hits"] = reg.counter(
                "greenllm_prefix_cache_hits_total",
                "admissions that matched >= 1 cached prompt page",
                ("replica",)).labels(replica=r)
            self._m["pc_misses"] = reg.counter(
                "greenllm_prefix_cache_misses_total",
                "admissions with no cached prefix", ("replica",)) \
                .labels(replica=r)
            self._m["pc_evictions"] = reg.counter(
                "greenllm_prefix_cache_evictions_total",
                "cache entries reclaimed under pool pressure",
                ("replica",)).labels(replica=r)
            self._m["pc_shared"] = reg.gauge(
                "greenllm_prefix_cache_shared_pages",
                "cached pages currently shared with live streams",
                ("replica",)).labels(replica=r)
        # published-so-far totals: counters publish deltas at block cadence
        self._pub = {"e_pf": 0.0, "e_dec": 0.0, "e_idle": 0.0,
                     "e_saved": 0.0, "tok_pf": 0, "tok_dec": 0,
                     "pc_hits": 0, "pc_misses": 0, "pc_evictions": 0}
        self._obs_tbt = TBTMeter(horizon=1.0)

    def _publish_metrics(self) -> None:
        """Flush gauges + counter deltas and stamp a timeline snapshot at
        the current virtual time.  Called only from existing host-side
        points (end of a decode block, after prefill/idle accounting) —
        this is bookkeeping over already-host-resident floats."""
        m = self._m
        if m is None:
            return
        pub = self._pub
        for key, cur in (("e_pf", self.prefill_energy_j),
                         ("e_dec", self.decode_energy_j),
                         ("e_idle", self.idle_energy_j),
                         ("tok_pf", self.prefill_tokens),
                         ("tok_dec", self.decode_tokens)):
            d = cur - pub[key]
            if d > 0:
                m[key].inc(d)
                pub[key] = cur
        if self.ledger is not None:
            cur = self.ledger.replica_saved_j(self.name)
            d = cur - pub["e_saved"]
            if d > 0:                   # counters are monotone; savings can
                m["e_saved"].inc(d)     # dip (noise near f_max) — hold then
                pub["e_saved"] = cur
        if self.tracer is not None and "drop_spans" in m:
            m["drop_spans"].set(self.tracer.dropped_spans)
            m["drop_decisions"].set(self.tracer.dropped_decisions)
        m["freq"].set(self.controller.freq)
        m["q_pending"].set(len(self.pending))
        m["q_prefill"].set(len(self.prefilling))
        m["q_active"].set(len(self.active))
        if self.pager is not None:
            occ = self.pager.occupancy()
            m["occ"].set(occ["occupancy"])
            m["frag"].set(occ["fragmentation"])
        if self.prefix_cache is not None and "pc_hits" in m:
            pc = self.prefix_cache
            for key, cur in (("pc_hits", pc.hits),
                             ("pc_misses", pc.misses),
                             ("pc_evictions", pc.evictions)):
                d = cur - pub[key]
                if d > 0:
                    m[key].inc(d)
                    pub[key] = cur
            m["pc_shared"].set(pc.shared_pages())
        if self._obs_tbt is not None and len(self._obs_tbt):
            p95 = self._obs_tbt.p95(self.vtime)
            if p95 > 0.0:               # nan-safe: hold last on empty window
                m["p95"].set(p95)
                m["p99"].set(self._obs_tbt.p99(self.vtime))
        self.metrics.record_snapshot(self.vtime)

    def _obs_finish(self, req: Request) -> None:
        """Score a FINISHED request's SLO verdicts into the counters (the
        same targets ``core.report.slo_pass_metrics`` scores post-hoc)."""
        m = self._m
        if m is None:
            return
        m["ev"]["completed"].inc()
        slo = self.ecfg.slo
        if req.first_token >= 0:
            ttft = req.first_token - req.arrival
            ok = ttft <= slo.ttft_target(req.cls or "S")
            m["slo"][("ttft", "pass" if ok else "miss")].inc()
        recs = self._tbt.get(req.rid)
        if recs:
            ok = float(np.percentile(recs, 95)) <= slo.tbt_target
            m["slo"][("tbt", "pass" if ok else "miss")].inc()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on a GPU through pinned
        memory, without blocking the host on the work already queued."""
        t = torch.from_numpy(arr.copy())
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _sync_active(self) -> None:
        """Re-upload the host active mask (one small transfer per stream
        join/leave; sharded along 'data' on a mesh)."""
        self._active = self._row_pin(self._upload(self._active_host))

    def evict(self, rid: int) -> bool:
        """Drop a *terminal* request's bookkeeping (its report row and TBT
        records) so a long-lived server does not grow with the traffic it
        served.  False for unknown or non-terminal requests."""
        for i, req in enumerate(self.requests):
            if req.rid == rid:
                if not req.state.terminal:
                    return False
                self.requests.pop(i)
                self._tbt.pop(rid, None)
                return True
        return self._tbt.pop(rid, None) is not None

    # -- request intake --------------------------------------------------------
    def submit(self, req: Request, prompt_tokens: Optional[np.ndarray] = None):
        if not self.ecfg.slot_native and self._resolve_sampling(req)[0] > 0.0:
            # the legacy plane decodes with a host argmax: a sampled request
            # is refused, never silently served greedily
            raise ValueError(
                "per-request sampling (temperature > 0) requires the "
                "slot-native data plane; the legacy slot_native=False "
                "baseline decodes greedily")
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
        if self._m is not None:
            self._m["ev"]["submitted"].inc()
        if self.tracer is not None:
            self.tracer.instant("submit", req.rid, self.vtime, self.name,
                                prompt_len=req.prompt_len, cls=req.cls)

    def _emit(self, ev) -> None:
        if self.events_on:
            self._events.append(ev)

    # -- per-slot sampling lanes ---------------------------------------------
    def _resolve_sampling(self, req: Request):
        """(temperature, top_k, top_p) of a request; ``temperature=None``
        means greedy, as 0 does."""
        sp = req.sampling
        if sp is None or sp.temperature is None:
            return 0.0, (int(sp.top_k) if sp else 0), \
                (float(sp.top_p) if sp else 1.0)
        return float(sp.temperature), int(sp.top_k), float(sp.top_p)

    def _lane_for(self, req: Request) -> np.ndarray:
        """The request's base lane, made at its first admission (seeded:
        ``prng_key(seed)``; unseeded: the engine key folded with the rid)
        and pinned on the request, so a recomputed stream draws the same
        tokens again."""
        if req.rng_lane is None:
            sp = req.sampling
            if sp is not None and sp.seed is not None:
                lane = prng_key(sp.seed)
            else:
                lane = fold_in(self._base_key, req.rid)
            req.rng_lane = lane.numpy().astype(np.uint32)
        return req.rng_lane

    def _set_slot_sampling(self, slot: int, req: Request) -> None:
        """Write a stream's lane into row ``slot`` of the device vectors
        (admission-time work; the decode loop never touches them from the
        host)."""
        temp, top_k, top_p = self._resolve_sampling(req)
        self._put_row(self._temps, slot, temp)
        self._put_row(self._topk, slot, top_k)
        self._put_row(self._topp, slot, top_p)
        self._put_row(self._keys, slot, self._upload(
            self._lane_for(req).astype(np.int64)))
        self._sampled_host[slot] = temp > 0.0

    def _draw_first(self, rows, slot: int, logits: torch.Tensor,
                    pos: int) -> torch.Tensor:
        """The token drawn from a prefill's last logits (1, V) for the
        stream in ``slot`` (``rows``: the gathered per-slot vectors); it
        lands at position ``pos``, so its key is the lane folded with
        ``pos``."""
        s = slice(slot, slot + 1)
        return _sample_rows(
            bool(self._sampled_host[slot]), logits,
            torch.full((1,), pos, dtype=torch.int64, device=self.device),
            rows["keys"][s], rows["temps"][s], rows["topk"][s],
            rows["topp"][s])[0]

    def _account_prefill_tokens(self, n_tokens: int, first: bool,
                                req: Request):
        """Bill ``n_tokens`` of prefill work (one prompt or one chunk)."""
        t_pf = self.plant.prefill_latency(n_tokens, self.controller.freq)
        p_pf = self.plant.prefill_power(n_tokens, self.controller.freq, t_pf)
        self.energy_j += t_pf * p_pf
        self.prefill_energy_j += t_pf * p_pf
        self.prefill_tokens += n_tokens
        self.vtime += t_pf
        if self.ledger is not None:
            # the prefilling stream is this interval's only resident; the
            # mirror sees the identical float the counters above added
            e = t_pf * p_pf
            self.ledger.record_prefill(
                self.name, req.rid, e, tokens=n_tokens,
                saved_j=self._cf.prefill_j(n_tokens) - e)
        if first:
            req.prefill_start = self.vtime - t_pf

    def _account_prefill(self, req: Request):
        self._account_prefill_tokens(req.prompt_len, True, req)
        req.first_token = self.vtime

    def _start_stream(self, req: Request, slot: int, tok: int, pos: int,
                      resumed: bool = False):
        self._order += 1
        self.active[slot] = _Stream(req, slot, pos, self._order)
        if not resumed:
            req.tokens.append(tok)
            req.tokens_emitted = 1
            self._emit(TokenEvent(req.rid, self.vtime, (tok,), 1))
            if self._m is not None and req.first_token >= 0:
                self._m["ttft"].observe(
                    max(req.first_token - req.arrival, 0.0))
        req.state = RequestState.DECODING
        self._emit(StateEvent(req.rid, self.vtime, RequestState.DECODING))
        self._active_host[slot] = True
        self._sync_active()

    def _pt_rows(self, table, slot: int, upto: int) -> torch.Tensor:
        """(1, n_ctx) row of the (gathered) page table covering the
        positions below the smallest ctx bucket >= ``upto``."""
        ctx = next((c for c in self.ctx_buckets if c >= upto),
                   self.ctx_buckets[-1])
        n_ctx = min(-(-ctx // self.ecfg.page_size), self._max_pages)
        return table[slot:slot + 1, :n_ctx]

    def _padded(self, toks: np.ndarray) -> torch.Tensor:
        """(1, bucket) tokens right-padded to the smallest bucket."""
        bucket = next(b for b in self.buckets if b >= len(toks))
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(toks)] = toks
        return self._upload(padded)

    def _admit_slot(self, req: Request, slot: int):
        L = len(req.prompt)
        if self.pager is not None:
            ok = self.pager.ensure(slot, L)      # gated by _admit
            assert ok, "admission gate let an unallocatable prompt through"
        with _range("serve.prefill"):
            padded = self._padded(req.prompt)
            self._set_slot_sampling(slot, req)
            g = self._replicated(table=self.pager is not None)
            pt_row = None if self.pager is None else \
                self._pt_rows(g["table"], slot, padded.shape[1])
            logits, _, _ = prefill_into_slot(
                g["params"], self.cfg, padded, L, g["caches"], slot,
                page_table=pt_row)
            tok = self._draw_first(g["rows"], slot, logits, L)
            keep_shards(self.caches, g["caches"], self.mesh)
            self._put_row(self._tok, slot, tok)
            self._put_row(self._pos, slot, L)
            # one tiny host read per admission (the first token id)
            first = int(tok)
        t0 = self.vtime
        self._account_prefill(req)
        if self.tracer is not None:
            self.tracer.span("prefill", req.rid, t0, self.vtime, self.name,
                             tokens=L, bucket=padded.shape[1])
        self._register_prefix(req, slot, L)
        self._publish_metrics()
        self._start_stream(req, slot, first, L)

    def _admit_legacy(self, req: Request, slot: int):
        """The reference path: the unpadded prefill of the prompt into a
        fresh one-row cache, spliced into row ``slot`` of every batch cache
        leaf (each (n_rep, B, ...)) in place.  Taken by every prompt of
        ``slot_native=False`` and, with chunked prefill off, by a prompt
        longer than the largest bucket (a ring shorter than the prompt
        keeps its last positions)."""
        L = len(req.prompt)
        with _range("serve.prefill"):
            caches = init_cache(self.cfg, 1, self.ecfg.max_len,
                                dtype=getattr(torch, self.ecfg.cache_dtype),
                                device=self.device)
            self._set_slot_sampling(slot, req)
            g = self._replicated()
            logits, caches, _ = prefill(
                g["params"], self.cfg,
                self._upload(np.asarray(req.prompt, np.int64)[None]), caches)
            for stage, one_stage in zip(g["caches"], caches):
                for d, one in zip(stage, one_stage):
                    for name, leaf in d.items():
                        leaf[:, slot:slot + 1] = one[name]
            tok = self._draw_first(g["rows"], slot, logits, L)
            keep_shards(self.caches, g["caches"], self.mesh)
            self._put_row(self._tok, slot, tok)
            self._put_row(self._pos, slot, L)
            first = int(tok)
        t0 = self.vtime
        self._account_prefill(req)
        if self.tracer is not None:
            self.tracer.span("prefill", req.rid, t0, self.vtime, self.name,
                             tokens=L, legacy=True)
        self._publish_metrics()
        self._start_stream(req, slot, first, L)

    def _admit(self):
        with _range("serve.admit"):
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
                resume = bool(req.tokens)        # preempted stream: recompute
                ctx_toks = req.prompt if not resume else np.concatenate(
                    [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
                need = min(len(ctx_toks), self.chunk_len)
                if self.pager is not None and not self.pager.can_admit(need):
                    # cached prefixes go before the FIFO head stalls
                    if not (self._reclaim_cached()
                            and self.pager.can_admit(need)):
                        break                    # head-of-line: wait for pages
                self.pending.pop(0)
                slot = self.free_slots.pop(0)
                # longest cached prefix (after the admission gates: a lookup
                # that cannot admit must not skew the hit/miss counters)
                hit_pages: List[int] = []
                hit_tok = 0
                if self._cacheable:
                    hit_pages, hit_tok = self.prefix_cache.lookup(ctx_toks)
                if self.tracer is not None:
                    self.tracer.span("queue", req.rid,
                                     max(req.arrival, req.not_before),
                                     self.vtime, self.name, slot=slot,
                                     resume=resume)
                if not self.ecfg.slot_native:
                    self._admit_legacy(req, slot)
                elif hit_tok or resume or len(ctx_toks) > self.buckets[-1]:
                    if self._chunked:
                        self._start_chunked(req, slot, ctx_toks, resume,
                                            hit_pages, hit_tok)
                    else:
                        self._admit_legacy(req, slot)
                else:
                    self._admit_slot(req, slot)

    # -- chunked prefill, prefix sharing, preemption ---------------------------
    def _start_chunked(self, req: Request, slot: int, ctx_toks: np.ndarray,
                       resume: bool, hit_pages: List[int], hit_tok: int):
        """Admit via chunked prefill: the stream owns ``slot`` now and joins
        the decode batch after its last chunk (``_advance_chunks``).  A
        prefix hit seeds the chain with the shared pages and starts at
        ``hit_tok``."""
        if hit_tok:
            hit_tok = self._share_prefix(slot, hit_pages, hit_tok)
        self._order += 1
        self._set_slot_sampling(slot, req)
        cs = _ChunkState(
            req, np.asarray(ctx_toks, np.int32),
            resume_tok=req.tokens[-1] if resume else None, order=self._order)
        cs.start = hit_tok
        self.prefilling[slot] = cs
        req.state = RequestState.PREFILLING
        self._emit(StateEvent(req.rid, self.vtime, RequestState.PREFILLING))

    def _share_prefix(self, slot: int, pages: List[int], hit_tok: int) -> int:
        """Adopt cached pages into ``slot``'s chain, copy the last one on
        write if the hit ends mid-page, and seed the device position so the
        held-position write of the still-inactive row lands at ``hit_tok``
        (a private or unallocated page, never a shared one).  Returns the
        hit length: 0 when the copy cannot get a page even after reclaiming
        (the share is rolled back and admission proceeds as a miss)."""
        ps = self.ecfg.page_size
        self.pager.share_chain(slot, pages)
        if hit_tok % ps:
            old = pages[-1]
            new = self.pager.cow_page(slot, len(pages) - 1)
            if new is None and self._reclaim_cached():
                new = self.pager.cow_page(slot, len(pages) - 1)
            if new is None:
                self.pager.free_chain(slot)     # roll back: admit as a miss
                return 0
            if new != old:
                full = self._caches_full()
                for stage in full:
                    for d in stage:
                        paged_page_copy(d, old, new)
                keep_shards(self.caches, full, self.mesh)
        self._put_row(self._pos, slot, hit_tok)
        if self.tracer is not None:
            self.tracer.instant("prefix_hit", -1, self.vtime, self.name,
                                pages=len(pages), tokens=hit_tok)
        return hit_tok

    def _reclaim_cached(self) -> bool:
        """Evict up to a chunk's worth of LRU cache-only pages; False when
        caching is off or nothing is evictable."""
        if self.prefix_cache is None:
            return False
        return self.prefix_cache.reclaim(
            -(-self.chunk_len // self.ecfg.page_size)) > 0

    def _register_prefix(self, req: Request, slot: int, upto: int) -> None:
        """Publish the fully written prompt pages of ``slot``'s chain."""
        if not self._cacheable or req.prompt is None:
            return
        chain = self.pager.chains.get(slot)
        if chain:
            self.prefix_cache.register(req.prompt, chain,
                                       min(upto, len(req.prompt)))

    def _advance_chunks(self) -> bool:
        """Process one chunk for every mid-prefill stream (once per
        scheduling round, interleaved with decode blocks).  Returns True if
        any advanced."""
        progressed = False
        finished: List[int] = []
        for slot, cs in list(self.prefilling.items()):
            if slot not in self.prefilling:
                continue        # preempted by a later stream's growth
            chunk = cs.tokens[cs.start: cs.start + self.chunk_len]
            if self.pager is not None:
                with _range("serve.pages"):
                    ok = self.pager.ensure(slot, cs.start + len(chunk))
                    while not ok and (
                            self._reclaim_cached()
                            or self._preempt_for_pages(exclude=slot)):
                        ok = self.pager.ensure(slot, cs.start + len(chunk))
                if not ok:
                    continue             # stall this chunk; retry next round
            with _range("serve.chunk"):
                padded = self._padded(chunk)
                g = self._replicated(table=self.pager is not None)
                pt_row = None if self.pager is None else self._pt_rows(
                    g["table"], slot, cs.start + padded.shape[1])
                logits, _ = prefill_chunk_into_slot(
                    g["params"], self.cfg, padded, cs.start, len(chunk),
                    g["caches"], slot, page_table=pt_row)
                # every chunk draws at its end position; only the final
                # chunk's token survives to seed decoding (the draws touch
                # no lane state)
                end = cs.start + len(chunk)
                cs.last_tok = self._draw_first(g["rows"], slot, logits, end)
                keep_shards(self.caches, g["caches"], self.mesh)
                self._put_row(self._tok, slot, cs.last_tok)
                self._put_row(self._pos, slot, end)
            # resumed streams keep their original prefill_start/first_token
            t0 = self.vtime
            self._account_prefill_tokens(
                len(chunk), not cs.billed and cs.resume_tok is None, cs.req)
            cs.billed = True
            if self.tracer is not None:
                self.tracer.span("prefill_chunk", cs.req.rid, t0, self.vtime,
                                 self.name, chunk_start=cs.start,
                                 tokens=len(chunk))
            cs.start += len(chunk)
            self._register_prefix(cs.req, slot, cs.start)
            progressed = True
            if cs.start >= len(cs.tokens):
                finished.append(slot)
        for slot in finished:
            cs = self.prefilling.pop(slot, None)
            if cs is None:
                continue        # preempted after its last chunk this round
            if cs.resume_tok is not None:
                # recomputed stream: its next token was emitted before the
                # preemption; restore it instead of the chunk's
                self._put_row(self._tok, slot, cs.resume_tok)
                self._start_stream(cs.req, slot, cs.resume_tok,
                                   len(cs.tokens), resumed=True)
            else:
                cs.req.first_token = self.vtime
                self._start_stream(cs.req, slot, int(cs.last_tok),
                                   len(cs.tokens))
        if progressed:
            self._publish_metrics()
        return progressed

    def _preempt_for_pages(self, exclude: Optional[int] = None) -> bool:
        """Free the youngest stream's pages (decoding or mid-prefill, by
        admission order) and requeue it at the head for recompute-on-resume.
        ``exclude`` keeps a chunk from preempting itself.  False when there
        is nothing (else) to preempt."""
        order = {s: st.order for s, st in self.active.items()}
        order.update({s: cs.order for s, cs in self.prefilling.items()
                      if s != exclude})
        if not order:
            return False
        slot = max(order, key=order.get)
        if slot in self.active:
            req = self.active.pop(slot).req
        else:
            req = self.prefilling.pop(slot).req
        self._release_slot(slot)
        self.pending.insert(0, req)
        self._preempted += 1
        req.state = RequestState.QUEUED
        self._emit(StateEvent(req.rid, self.vtime, RequestState.QUEUED))
        if self._m is not None:
            self._m["ev"]["preempted"].inc()
        if self.tracer is not None:
            self.tracer.instant("preempt", req.rid, self.vtime, self.name)
        return True

    # -- cancellation / failure ------------------------------------------------
    def cancel(self, rid: int) -> bool:
        """Cancel a queued, prefilling or decoding request, freeing its slot
        and page chain at once.  False for unknown or already-terminal
        requests."""
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
        for slot, cs in list(self.prefilling.items()):
            if cs.req.rid == rid:
                del self.prefilling[slot]
                self._release_slot(slot)
                return self._mark_terminal(cs.req, state)
        for slot, st in list(self.active.items()):
            if st.req.rid == rid:
                del self.active[slot]
                self._release_slot(slot)
                return self._mark_terminal(st.req, state)
        return False

    def _release_slot(self, slot: int) -> None:
        """Return a slot and its page chain; its batch row turns inactive
        (its held-position writes then land in the scratch page)."""
        if self.pager is not None:
            self.pager.free_chain(slot)
        self._active_host[slot] = False
        self._sampled_host[slot] = False
        self._sync_active()
        self.free_slots.append(slot)

    def _mark_terminal(self, req: Request, state: RequestState) -> bool:
        req.state = state
        if state is RequestState.CANCELLED:
            self._cancelled += 1
            kind = "cancelled"
        else:
            self._failed += 1
            kind = "failed"
        self._emit(StateEvent(req.rid, self.vtime, state))
        if self._m is not None:
            self._m["ev"][kind].inc()
        if self.tracer is not None:
            self.tracer.instant("cancel" if kind == "cancelled" else "fail",
                                req.rid, self.vtime, self.name,
                                tokens_emitted=req.tokens_emitted)
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
        self._shed += 1
        self._emit(StateEvent(req.rid, self.vtime, RequestState.SHED))
        if self._m is not None:
            self._m["ev"]["shed"].inc()
        if self.tracer is not None:
            self.tracer.instant("shed", req.rid, self.vtime, self.name,
                                deadline=req.deadline)

    # -- replica-to-replica migration (disaggregated serving) ------------------
    def export_stream(self, slot: int) -> StreamHandoff:
        """Extract an active (decodable) stream for adoption by another
        engine: copies of its page-chain K/V, bounded dense rows (sliding-
        window rings) and recurrent row state, on the device, with its
        position and last token.  The slot, its pages and its batch row are
        released here, so the stream leaves nothing on this engine; the
        payload is a copy, so the next stream written into the slot and the
        pages cannot reach it."""
        st = self.active.pop(slot)
        self._active_host[slot] = False
        self._sampled_host[slot] = False
        self._sync_active()
        self.free_slots.append(slot)
        chain = list(self.pager.chains.get(slot, [])) \
            if self.pager is not None else []
        blocks = []
        for stage in self._caches_full():
            sblocks = []
            for d in stage:
                if is_paged(d):
                    sblocks.append(("pages", paged_chain_extract(d, chain)
                                    if chain else None))
                else:
                    sblocks.append(("row", cache_row_extract(d, slot)))
            blocks.append(tuple(sblocks))
        if self.pager is not None:
            self.pager.export_chain(slot)
        # snapshot the *resolved* sampling config (a None temperature
        # becomes an explicit 0.0): the adopter never re-resolves anything
        sp = st.req.sampling
        if sp is None or sp.temperature is None:
            temp, top_k, top_p = self._resolve_sampling(st.req)
            sp = SamplingParams(
                max_tokens=sp.max_tokens if sp else st.req.output_len,
                temperature=temp, top_k=top_k, top_p=top_p,
                seed=sp.seed if sp else None)
        if self._m is not None:
            self._m["ev"]["exported"].inc()
        if self.tracer is not None:
            self.tracer.instant("handoff_export", st.req.rid, self.vtime,
                                self.name, pages=len(chain), pos=st.pos)
        return StreamHandoff(
            req=st.req, pos=st.pos, last_token=st.req.tokens[-1],
            n_pages=len(chain), blocks=blocks, export_time=self.vtime,
            page_size=self.ecfg.page_size if self.pager is not None else 0,
            cfg_name=self.cfg.name, sampling=sp,
            rng_lane=self._lane_for(st.req),
            ledger_carry=self.ledger.export_carry(self.name, st.req.rid)
            if self.ledger is not None else None,
            mesh_shape=self.ecfg.mesh)

    def import_stream(self, ho: StreamHandoff) -> bool:
        """Adopt a migrated stream: take a slot and a page chain of the
        handed-off length, write the extracted pages and rows into them in
        place, and join the decode batch at the handed-off position and
        token.  All or nothing: False, taking nothing, when no slot is free
        or the pool cannot cover the chain (the caller retries later)."""
        assert ho.cfg_name == self.cfg.name, (
            f"cross-model handoff: {ho.cfg_name} -> {self.cfg.name}")
        assert ho.mesh_shape == self.ecfg.mesh, (
            f"cross-mesh handoff: exporter mesh {ho.mesh_shape} -> adopter "
            f"mesh {self.ecfg.mesh}; replicas in one cluster must share a "
            "mesh shape (handoff blocks are extracted per-shard-agnostic, "
            "but mixed shapes break the bit-exactness contract)")
        if ho.n_pages:
            assert self.pager is not None and \
                ho.page_size == self.ecfg.page_size, \
                "handoff requires matching paged layouts on both replicas"
        if not self.free_slots:
            return False
        slot = self.free_slots[0]
        chain = None
        if ho.n_pages:
            chain = self.pager.adopt_chain(slot, ho.n_pages)
            if chain is None and self._reclaim_cached():
                chain = self.pager.adopt_chain(slot, ho.n_pages)
            if chain is None:
                return False
        self.free_slots.pop(0)
        full = self._caches_full()
        for stage, hstage in zip(full, ho.blocks):
            for d, (kind, payload) in zip(stage, hstage):
                if kind == "row":
                    cache_row_insert(d, payload, slot)
                elif payload is not None:
                    paged_chain_insert(d, payload, chain)
        keep_shards(self.caches, full, self.mesh)
        # in place: the decode block's token and position vectors keep
        # their storage
        self._put_row(self._tok, slot, ho.last_token)
        self._put_row(self._pos, slot, ho.pos)
        # the lane and the exporter-resolved sampling config travel with
        # the stream: the adopter continues the exporter's draws
        if ho.rng_lane is not None:
            ho.req.rng_lane = np.asarray(ho.rng_lane, np.uint32)
        if ho.sampling is not None:
            ho.req.sampling = ho.sampling
        self._set_slot_sampling(slot, ho.req)
        # the adopted prompt pages are this pool's bits now: share them
        self._register_prefix(ho.req, slot, ho.pos)
        if self.ledger is not None:
            # a no-op when the exporter billed into this same ledger
            self.ledger.adopt_carry(ho.ledger_carry, ho.req.rid)
        self._imported += 1
        self.requests.append(ho.req)
        if self._m is not None:
            self._m["ev"]["imported"].inc()
        if self.tracer is not None:
            # the stream's in-flight window between replicas (clamped: the
            # adopter's clock may lag the exporter's)
            self.tracer.span("handoff", ho.req.rid, ho.export_time,
                             max(self.vtime, ho.export_time), self.name,
                             pages=ho.n_pages, pos=ho.pos)
        self._start_stream(ho.req, slot, ho.last_token, ho.pos, resumed=True)
        return True

    # -- decode ----------------------------------------------------------------
    def _account_decode_step(self, batch: int, ctx: float, dur=None,
                             rids=None) -> float:
        f = self.controller.maybe_tick(self.vtime)
        if dur is None:
            dur = self.plant.decode_step_latency(batch, ctx, f)
        e = dur * self.plant.decode_power(batch, ctx, f, dur)
        self.energy_j += e
        self.decode_energy_j += e
        self.decode_tokens += batch
        self.vtime += dur
        if rids is not None:
            # each alive row produced one token this step: an equal split
            self.ledger.record_decode(
                self.name, rids, e,
                saved_j=self._cf.decode_j(batch, ctx) - e)
        self.controller.record_tokens(self.vtime, batch, dur)
        return dur

    def _finish_check(self, st: _Stream) -> bool:
        if (st.req.tokens_emitted >= st.req.output_len
                or st.pos >= self.ecfg.max_len - 1):
            st.req.finish = self.vtime
            st.req.state = RequestState.FINISHED
            self._completed += 1
            return True
        return False

    def _retire(self, slots: List[int]):
        for slot in slots:
            self.free_slots.append(slot)
            del self.active[slot]
            self._active_host[slot] = False
            self._sampled_host[slot] = False
            if self.pager is not None:
                self.pager.free_chain(slot)
        if slots:
            self._sync_active()

    def _grow_for_block(self, k: int) -> int:
        """Grow every active chain to cover ``pos + k`` before the block
        (the in-block writes must stay inside allocated pages).  A dry pool
        reclaims cached prefixes, then shrinks ``k``, then preempts the
        youngest stream."""
        with _range("serve.pages"):
            while True:
                ordered = sorted(self.active.items(),
                                 key=lambda kv: kv[1].order)   # oldest first
                if all(self.pager.ensure(s, st.pos + k) for s, st in ordered):
                    return k
                if self._reclaim_cached():
                    continue
                if k > 1:
                    k = max(k // 2, 1)
                    continue
                if len(self.active) + len(self.prefilling) > 1:
                    self._preempt_for_pages()
                    continue
                raise RuntimeError(
                    "page pool exhausted: a lone stream cannot grow by one "
                    f"page ({self.pager.pages_used}/"
                    f"{self.pager.num_pages - 1} used)")

    def _run_block(self, ctx: int, kb: int, sampled: bool) -> torch.Tensor:
        """``kb`` decode steps over the caches cut to ``ctx`` positions (the
        page table cut to its pages when paged); returns the (kb, B) tokens,
        still on the device.  The token drawn at row r lands at position
        ``pos[r] + 1``, so that is the position its key folds in."""
        g = self._replicated(table=self.pager is not None)
        rows = g["rows"]
        pt = None
        if self.pager is not None:
            n_ctx = min(ctx // self.ecfg.page_size, self._max_pages)
            pt = g["table"][:, :n_ctx]
            caches = g["caches"]
        else:
            caches = _slice_caches(g["caches"], ctx, self.ecfg.max_len)
        tok, pos, active = rows["tok"], rows["pos"], rows["active"]
        out = []
        for _ in range(kb):
            with _range("serve.decode.step"):
                logits, _ = decode_step(g["params"], self.cfg, tok[:, None],
                                        caches, pos, page_table=pt,
                                        active=active)
                nxt = _sample_rows(sampled, logits, pos + 1, rows["keys"],
                                   rows["temps"], rows["topk"], rows["topp"])
                tok = torch.where(active, nxt, tok)
                pos = pos + active.to(torch.int32)
            out.append(tok)
        keep_shards(self.caches, g["caches"], self.mesh)
        self._tok, self._pos = self._row_pin(tok), self._row_pin(pos)
        return torch.stack(out)

    def _decode_block(self, k: int) -> int:
        """Run ``k`` decode steps with a single host drain at the end;
        returns the steps executed (pool pressure may shrink ``k``).  The
        batch composition is fixed for the block (the caller sizes ``k`` to
        the next leave event), so the virtual-time accounting needs no
        device data."""
        with _range("serve.decode"):
            if self.pager is not None and self.active:
                k = self._grow_for_block(k)
            snapshot = list(self.active.items())
            batch = len(snapshot)
            if batch == 0:
                return 0
            max_pos = max(st.pos for st in self.active.values())
            if self.prefilling:
                # mid-prefill rows are inactive but still receive the held-pos
                # write each step: the ctx bucket must cover their positions
                max_pos = max(max_pos,
                              max(cs.start for cs in self.prefilling.values()))
            wall = self.ecfg.use_wall_clock
            # does any *decoding* row sample?  From host metadata, no device
            # read; a sampled stream still mid-prefill (inactive) does not
            # count
            sampled = bool(self._sampled_host[self._active_host].any())
            toks_dev = []
            durs: List[Optional[float]] = []   # per-step; None -> plant model
            left = k
            while left > 0:
                # fill this ctx bucket before stepping up to the next one
                ctx = next((c for c in self.ctx_buckets if c > max_pos),
                           self.ecfg.max_len)
                room = max(ctx - max_pos, 1)
                kb = next((b for b in self._k_blocks
                           if b <= min(left, room)), 1)
                t0 = time.perf_counter() if wall else 0.0
                tk = self._run_block(ctx, kb, sampled)
                toks_dev.append(tk)
                if wall:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    seen = (ctx, kb) in self._warmed
                    self._warmed.add((ctx, kb))
                    dt = self._agree((time.perf_counter() - t0) / kb)
                    durs.extend([dt if seen else None] * kb)
                else:
                    durs.extend([None] * kb)
                max_pos += kb
                left -= kb
            # single drain per block: (k, B) int32
            self._host_drains += 1
            toks = torch.cat(toks_dev).cpu().numpy()
        with _range("serve.account"):
            t_block = self.vtime
            done: List[int] = []
            block_toks: Dict[int, List[int]] = {
                slot: [] for slot, _ in snapshot}
            for i in range(k):
                ctx = float(np.mean([st.pos for st in self.active.values()
                                     if st.slot not in done]))
                alive = batch - len(done)
                rids = None if self.ledger is None else \
                    [st.req.rid for slot, st in snapshot if slot not in done]
                dur = self._account_decode_step(alive, ctx, durs[i], rids)
                if self._m is not None:
                    # one bucketed observation per step, weighted by its rows
                    self._m["tbt"].observe(dur, alive)
                    self._obs_tbt.record_tbt(self.vtime, dur)
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
                        self._obs_finish(st.req)
                        if self.tracer is not None:
                            self.tracer.instant(
                                "finish", st.req.rid, self.vtime, self.name,
                                tokens=st.req.tokens_emitted)
            for slot, st in snapshot:   # one TokenEvent per stream per block
                if block_toks[slot]:
                    self._emit(TokenEvent(
                        st.req.rid, self.vtime, tuple(block_toks[slot]),
                        len(block_toks[slot])))
            by_slot = dict(snapshot)    # FINISHED strictly after the tokens
            for slot in done:
                self._emit(StateEvent(by_slot[slot].req.rid, self.vtime,
                                      RequestState.FINISHED))
            self._retire(done)
            if self.pager is not None:
                # live occupancy (cache-only pages excluded) biases the
                # controller toward higher clocks before the pool forces
                # preemption
                occ = self.pager.occupancy()["occupancy_live"]
                self.controller.record_occupancy(self.vtime, occ)
            if self.tracer is not None:
                self.tracer.span("decode_block", -1, t_block, self.vtime,
                                 self.name, steps=k, batch=batch,
                                 freq_mhz=self.controller.freq)
            self._publish_metrics()
            return k

    def _step_legacy(self) -> int:
        """One decode step of the legacy plane (the reference's
        ``_step_legacy``), kept only as the benchmark baseline: the batch's
        last tokens from the host, the batch-wide max(pos) as every row's
        position, a host argmax, one decode accounting.  Wrong for
        mixed-position batches, as in the reference (ROADMAP §C)."""
        B = self.ecfg.max_batch
        tok = np.zeros((B, 1), np.int32)
        for slot, st in self.active.items():
            tok[slot, 0] = st.req.tokens[-1]
        pos = max(st.pos for st in self.active.values())
        logits, _ = decode_step(self.params, self.cfg, self._upload(tok),
                                self.caches, pos)
        nxt = logits.argmax(dim=-1).cpu().numpy()
        batch = len(self.active)
        ctx = float(np.mean([st.pos for st in self.active.values()]))
        rids = None if self.ledger is None else \
            [st.req.rid for st in self.active.values()]
        dur = self._account_decode_step(batch, ctx, rids=rids)
        done = []
        for slot, st in self.active.items():
            t = int(nxt[slot])
            st.req.tokens.append(t)
            st.pos += 1
            st.req.tokens_emitted += 1
            self._tbt.setdefault(st.req.rid, []).append(dur)
            self._emit(TokenEvent(st.req.rid, self.vtime, (t,), 1))
            if self._finish_check(st):
                self._emit(StateEvent(st.req.rid, self.vtime,
                                      RequestState.FINISHED))
                done.append(slot)
        self._retire(done)
        return batch

    # -- Backend protocol --------------------------------------------------------
    def has_work(self) -> bool:
        """Anything queued, mid-prefill or decoding."""
        return bool(self.pending or self.prefilling or self.active)

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
        e_idle = (nxt - self.vtime) * self.plant.idle_power
        self.idle_energy_j += e_idle
        if self.ledger is not None:
            self.ledger.record_idle(self.name, e_idle)
        self.vtime = nxt
        self._publish_metrics()
        return True

    def step(self, k: Optional[int] = None) -> int:
        """One scheduling round: admit arrived requests, advance chunked
        prefills, then decode a block of ``k`` steps (default: the horizon
        to the next guaranteed leave).  Returns the number of decode steps
        executed."""
        with _range("serve.step"):
            self._evict_lapsed()
            self._admit()
            progressed = self.ecfg.slot_native and self._advance_chunks()
            if not self.active:
                if progressed or self._advance_idle():
                    return 0
                if self.prefilling or self.pending:
                    raise RuntimeError(
                        "serving stalled: pending/prefilling streams cannot "
                        "obtain pages or slots and nothing is decoding")
                return 0
            if not self.ecfg.slot_native:
                self._step_legacy()
                return 1
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

    def effective_prefill_tokens(self, req: Request) -> int:
        """Prefill tokens this engine would compute for ``req``: the prompt
        length minus the currently cached prefix (a pure probe)."""
        if not self._cacheable or req.prompt is None:
            return req.prompt_len
        return max(req.prompt_len - self.prefix_cache.probe(req.prompt), 1)

    def page_occupancy_peak(self) -> float:
        """Peak page-pool occupancy over the run (0 when unpaged)."""
        if self.pager is None:
            return 0.0
        live = {sl: st.pos for sl, st in self.active.items()}
        live.update({sl: cs.start for sl, cs in self.prefilling.items()})
        return self.pager.occupancy(live)["peak_occupancy"]

    def report(self) -> ServingReport:
        """The typed serving report (the scoring shared with the
        reference's backends)."""
        led = {}
        if self.ledger is not None:
            led = dict(energy_by_rid=self.ledger.energy_by_rid(),
                       saved_by_rid=self.ledger.saved_by_rid(),
                       energy_saved_j=self.ledger.replica_saved_j(self.name))
        return build_report(
            backend="engine", requests=self.requests, tbt_records=self._tbt,
            slo=self.ecfg.slo, class_names=self.router.class_names,
            prefill_energy_j=self.prefill_energy_j,
            decode_energy_j=self.decode_energy_j,
            idle_energy_j=self.idle_energy_j,
            prefill_tokens=self.prefill_tokens,
            decode_tokens=self.decode_tokens,
            duration_s=self.vtime, preempted=self._preempted,
            # adopted handoffs only, as the cluster counts them
            migrated=self._imported,
            page_occupancy_peak=self.page_occupancy_peak(), **led)

    def _slo_stats(self) -> Dict:
        """Per-class p90 TTFT and TTFT/TBT SLO pass rates —
        ``core.report.slo_pass_metrics`` is the single scoring definition,
        applied to the same population as ``report()`` (every request with
        a first token, cancelled included), so the legacy dict and the
        typed report can never diverge."""
        m = slo_pass_metrics(self.requests, self._tbt, self.ecfg.slo,
                             self.router.class_names)
        return {"ttft_pass": m["ttft_pass"], "tbt_pass": m["tbt_pass"],
                "p90_ttft_s": m["p90_ttft"]}

    def stats(self) -> Dict:
        tbts = [x for v in self._tbt.values() for x in v]
        s = {
            "completed": self._completed,
            "cancelled": self._cancelled,
            "failed": self._failed,
            "shed": self._shed,
            "pending": len(self.pending),
            "active": len(self.active),
            "prefilling": len(self.prefilling),
            "vtime_s": self.vtime,
            # active + idle, matching the cluster's legacy dict (idle is 0
            # for batch workloads; billed only while waiting on arrivals)
            "energy_j": self.energy_j + self.idle_energy_j,
            "idle_energy_j": self.idle_energy_j,
            # per-phase split, comparable with sim.replay.Metrics
            "prefill_energy_j": self.prefill_energy_j,
            "decode_energy_j": self.decode_energy_j,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "p95_tbt_ms": float(np.percentile(tbts, 95)) * 1e3 if tbts else 0,
            "p99_tbt_ms": float(np.percentile(tbts, 99)) * 1e3 if tbts else 0,
            "freq_mhz": self.controller.freq,
        }
        s.update(self._slo_stats())
        if self.pager is not None:
            # a stream at position pos holds K/V for positions 0..pos-1
            live = {sl: st.pos for sl, st in self.active.items()}
            live.update({sl: cs.start for sl, cs in self.prefilling.items()})
            occ = self.pager.occupancy(live)
            s.update({
                "pages_used": occ["pages_used"],
                "pages_total": occ["pages_total"],
                "pages_shared": occ["pages_shared"],
                "pages_reserved": occ["pages_reserved"],
                "pages_cached": occ["pages_cached"],
                "page_occupancy": occ["occupancy"],
                "page_occupancy_live": occ["occupancy_live"],
                "page_occupancy_peak": occ["peak_occupancy"],
                "page_fragmentation": occ["fragmentation"],
                "preempted": self._preempted,
            })
        if self.prefix_cache is not None:
            pc = self.prefix_cache.stats()
            s.update({f"prefix_cache_{k}": v for k, v in pc.items()})
        return s
