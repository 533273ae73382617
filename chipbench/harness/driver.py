"""One run of one cell: set-up, the measured window, the traced slice and
the check.

The window drives ``repro_torch.serving.api.Server`` over
``repro_torch.serving.engine.ServingEngine`` (paged KV, chunked prefill,
no prefix cache, greedy), and this module is the driver loop: each round
calls the engine's ``step()`` and ``drain_events()``, as ``Server._pump``
does, and hands every event to a sink that stamps it with the host clock
as it is drained.  A request is submitted with ``arrival=engine.now``, so
the engine's virtual-clock admission gate never holds a request the wall
clock has released, and with no deadline, so nothing is shed.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from chipbench.harness import check, spec, stats
from chipbench.harness import trace as tr
from chipbench.harness import traffic as tf
from chipbench.harness import weights as wt
from chipbench.harness.work import Dims, Work

WARM_TOKENS = 22        # a warm-up request's tokens: decode blocks of 16, 4, 1
PROFILE_FROM = 0.3      # the traced slice starts this share into the window
PROFILE_S = 3.0         # and takes whole rounds for at least this long
FOLLOW_S = 60.0         # due requests are followed to a first token this long
RETAIN = 256            # finished requests the server keeps


def log(out, *a) -> None:
    print(*a, file=out, flush=True)


class Sink:
    """Every drained stream event, stamped with ``time.perf_counter()``.

    Keeps each tracked request's record (``stats.Record``), its tokens,
    every drain of tokens, and adds the work of each token to the ``Work``
    objects in ``self.works``."""

    def __init__(self):
        self.rec: Dict[int, stats.Record] = {}
        self.prompt: Dict[int, np.ndarray] = {}
        self.tokens: Dict[int, List[int]] = {}
        self.drained: List = []         # (drain time, tokens)
        self.works: List[Work] = []
        self.ended: List[int] = []      # rids finished or failed since read
        self.decode_tokens = 0
        self.preemptions = 0

    def track(self, rid: int, prompt: np.ndarray, max_tokens: int,
              sent: float) -> None:
        self.rec[rid] = stats.Record(len(prompt), max_tokens, sent)
        self.prompt[rid] = prompt
        self.tokens[rid] = []

    def __call__(self, ev) -> None:
        from repro_torch.core import RequestState, TokenEvent
        t = time.perf_counter()
        r = self.rec.get(ev.rid)
        if r is None:
            return
        if isinstance(ev, TokenEvent):
            if r.first is None:
                r.first = t
                for w in self.works:
                    w.prefill(r.prompt_len)
            for w in self.works:
                w.decode(r.prompt_len, r.tokens + 1, ev.n)
            self.decode_tokens += ev.n - (r.tokens == 0)
            r.tokens += ev.n
            r.last = t
            self.tokens[ev.rid].extend(ev.tokens)
            self.drained.append((t, ev.n))
        elif ev.state is RequestState.FINISHED:
            r.finished = t
            self.ended.append(ev.rid)
        elif ev.state is RequestState.QUEUED:
            r.preempted += 1
            self.preemptions += 1
        elif ev.state.terminal:
            r.failed = True
            self.ended.append(ev.rid)

    def take_ended(self) -> List[int]:
        out, self.ended = self.ended, []
        return out


class Run:
    """A cell set up on ``device`` from ``seed``: weights, engine, warm-up."""

    def __init__(self, cell: spec.Cell, seed: int, device, *, energy, out):
        from repro_torch.serving.api import Server
        from repro_torch.serving.engine import EngineConfig, ServingEngine
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.energy, self.out = energy, out
        c = cell.config
        self.dtype = c["dtype"]
        self.ref = spec.reference_of(c["family"])
        adapter = spec.adapter_of(c["family"])
        self.cfg = adapter.port_config(c, self.dtype)
        self.dims = Dims.of(c)
        t = time.perf_counter()
        self.W = wt.draw(self.ref.WEIGHTS(c), self.seed, self.device,
                         self.dtype)
        params = adapter.port_params(self.W)
        self._sync()
        self.t_weights = time.perf_counter() - t
        e = c["engine"]
        self.ecfg = EngineConfig(
            max_batch=e["max_batch"], max_len=e["max_len"], paged=True,
            page_size=e["page_size"], num_pages=e["num_pages"],
            chunked_prefill=True, prefix_cache=False,
            cache_dtype=self.dtype, governor="greenllm")
        t = time.perf_counter()
        self.engine = ServingEngine(self.cfg, params=params, ecfg=self.ecfg,
                                    device=self.device,
                                    seed=self.seed % 2 ** 31)
        self.sink = Sink()
        self.server = Server(self.engine, on_event=self.sink,
                             retain_reports=RETAIN)
        self._sync()
        self.t_engine = time.perf_counter() - t
        self.traffic = tf.Traffic(cell.traffic, c["vocab_size"])
        self.usable_pages = e["num_pages"] - 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the driver loop --------------------------------------------------------
    def submit(self, req: tf.Req, sent: float) -> int:
        from repro_torch.core import SamplingParams
        h = self.server.submit(req.prompt, SamplingParams(
            max_tokens=req.max_tokens), arrival=self.engine.now)
        self.sink.track(h.rid, req.prompt, req.max_tokens, sent)
        return h.rid

    def round(self) -> int:
        """One engine round; returns its decode steps."""
        with torch.profiler.record_function("chipbench.step"):
            n = self.engine.step()
        with torch.profiler.record_function("chipbench.drain"):
            for ev in self.engine.drain_events():
                self.sink(ev)
        # Server._pump's retention: bounded bookkeeping of finished requests
        self.server._retire()
        return n

    def warm_up(self) -> float:
        """Set-up's serving.  An open loop serves one burst of its traffic
        from another stream of the seed (``Traffic.warmup``: every prefill
        bucket its prompts can fall in, a full batch) to completion.  A
        closed loop sends its clients' first requests, the first block of
        its own stream (every length of the mix, so every bucket it hits),
        and serves them to their first tokens: the window starts with the
        batch full, as a server that has been running, not with a cold
        start of one prefill per client."""
        t = time.perf_counter()
        if self.traffic.loop == "closed":
            self.stream = self.traffic.closed_stream(self.seed)
            for _ in range(self.traffic.clients):
                self.submit(next(self.stream), t)
            while any(r.first is None for r in self.sink.rec.values()):
                self.round()
        else:
            for req in self.traffic.warmup(self.seed, self.engine.buckets,
                                           self.ecfg.max_batch, WARM_TOKENS):
                self.submit(req, t)
            while self.engine.has_work():
                self.round()
            self.sink = Sink()
        self._sync()
        return time.perf_counter() - t

    def window(self, seconds: float, trace: bool,
               rate: Optional[float] = None) -> Dict:
        """The measured window; returns what the metrics need."""
        eng, sink = self.engine, self.sink
        win = Work(self.dims)
        sink.works = [win]
        prof = slice_work = slice_span = None
        steps = 0
        eng.pager.peak_used = eng.pager.pages_used   # this window's peak
        plant_j0 = eng.energy_j
        closed = self.traffic.loop == "closed"
        sched = None if closed else \
            self.traffic.open_schedule(self.seed, seconds, rate)
        stream = self.stream if closed else None
        late: List[float] = []
        i = 0
        t_prof = None
        t1 = joules = None
        dec0, pre0 = sink.decode_tokens, sink.preemptions
        t0 = time.perf_counter()
        e0 = self.energy.joules()
        while True:
            now = time.perf_counter()
            if not closed:
                while i < len(sched) and t0 + sched[i].offset <= now:
                    due = t0 + sched[i].offset
                    self.submit(sched[i], due)
                    late.append(now - due)
                    i += 1
            if eng.has_work():
                if trace and prof is None and t1 is None \
                        and now >= t0 + PROFILE_FROM * seconds:
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    prof.start()
                    slice_work = Work(self.dims)
                    sink.works.append(slice_work)
                    slice_span = torch.profiler.record_function(
                        "chipbench.slice")
                    slice_span.__enter__()
                    t_prof = time.perf_counter()
                n = self.round()
                if t1 is None:
                    steps += n
            elif t1 is None:
                nxt = t0 + sched[i].offset if i < len(sched) else t0 + seconds
                time.sleep(max(min(nxt, t0 + seconds) - time.perf_counter(),
                               0.0))
            now = time.perf_counter()
            if slice_span is not None and t_prof is not None and (
                    now >= t0 + seconds or (
                        now - t_prof >= PROFILE_S and slice_work.prefills
                        and slice_work.decode_tokens)):
                slice_span.__exit__(None, None, None)
                self._sync()
                prof.stop()
                sink.works.remove(slice_work)
                t_prof = None
            if closed:
                for _ in sink.take_ended():
                    if now < t0 + seconds:
                        self.submit(next(stream), now)
            if t1 is None and now >= t0 + seconds:
                t1, joules = now, self.energy.joules() - e0
                sink.works.remove(win)
                decode_tokens = sink.decode_tokens - dec0
                preemptions = sink.preemptions - pre0
                pool_peak = eng.pager.peak_used
            if t1 is not None:
                if closed:
                    break
                waiting = [r for r in sink.rec.values()
                           if r.first is None and not r.failed]
                if i >= len(sched) and not waiting:
                    break
                if now > t1 + FOLLOW_S:
                    for r in waiting:
                        r.failed = True
                    break
        self._sync()
        return {"t0": t0, "t1": t1, "joules": joules, "steps": steps,
                "decode_tokens": decode_tokens, "preemptions": preemptions,
                "pool_peak": pool_peak, "late": late, "work": win,
                "prof": prof, "slice_work": slice_work,
                "plant_j": eng.energy_j - plant_j0,
                "freq_mhz": eng.controller.freq}

    def finished(self, w: Dict):
        """({rid: (prompt, served tokens)} of the requests finished in the
        window ``w``, the rids preempted at least once)."""
        rec = self.sink.rec
        done = {rid: (self.sink.prompt[rid], self.sink.tokens[rid])
                for rid, r in rec.items() if r.finished is not None
                and w["t0"] <= r.finished <= w["t1"]}
        return done, {rid for rid, r in rec.items() if r.preempted}

    def free(self) -> None:
        """Drop the program's state (engine, pool, server); the weights,
        which are the run's inputs, stay."""
        self.engine = self.server = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def peaks(kind: str) -> Dict:
    table = spec.load_json(spec.BENCH_DIR / "peaks.json")
    if kind not in table:
        raise KeyError(f"no peaks for device {kind!r} in chipbench/peaks.json")
    return table[kind]


class Readings:
    """What a per-layer metric's reader reads (``metrics/<name>/read.py``
    gets this object with ``patterns`` set to its kernel-name patterns)."""

    def __init__(self, counters, work, slice_, peak):
        self.counters, self.work, self.slice, self.peak = \
            counters, work, slice_, peak
        self.patterns: List[str] = []


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", energy=None, started: Optional[float] = None,
             out=None) -> Dict:
    """Run ``cell`` once and return its result line as a dict."""
    import sys
    out = out or sys.stderr
    started = time.perf_counter() if started is None else started
    t_entry = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        log(out, f"device {kind}, torch {torch.__version__}, CUDA "
                 f"{torch.version.cuda}, power limit "
                 f"{energy.power_limit_w()} W (NVML: {energy.name()})")
    else:
        kind = "cpu"
    log(out, f"energy source {energy.source}")
    run = Run(cell, seed, dev, energy=energy, out=out)
    t_warm = run.warm_up()
    w = run.window(seconds, trace)
    t0, t1 = w["t0"], w["t1"]
    setup_s = t0 - started
    log(out, f"setup {setup_s:.3f} s: process start to the harness "
             f"{t_entry - started:.3f} s, weights {run.t_weights:.3f} s, "
             f"engine {run.t_engine:.3f} s, warm-up {t_warm:.3f} s")
    peak_bytes = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    sink = run.sink
    recs = sink.rec
    if run.traffic.loop == "open":
        attempted = [r for r in recs.values() if t0 <= r.sent < t1]
        late = sorted(w["late"])
        log(out, f"generator lateness: median "
                 f"{1e3 * stats.percentile(late, 50):.3f} ms, p90 "
                 f"{1e3 * stats.percentile(late, 90):.3f} ms, max "
                 f"{1e3 * late[-1]:.3f} ms over {len(late)} requests")
    else:
        attempted = [r for r in recs.values() if r.sent <= t1]
    failed = sum(r.failed for r in attempted)
    log(out, f"window {t1 - t0:.3f} s: {len(attempted)} requests, "
             f"{failed} failed, {w['steps']} decode steps, "
             f"{w['decode_tokens']} decode tokens, {w['preemptions']} "
             f"preemptions, pool peak {w['pool_peak']} of "
             f"{run.usable_pages} pages; plant model (virtual clock) "
             f"{w['plant_j']:.3f} J, controller {w['freq_mhz']} MHz")
    finished, preempted = run.finished(w)
    short = sum(len(toks) != recs[rid].max_tokens
                for rid, (_, toks) in finished.items())
    result = {"attempted": len(attempted), "failed": failed}
    if trace:
        sl = _slice(w["prof"])
        readings = Readings(
            {"decode_tokens": w["decode_tokens"], "decode_steps": w["steps"],
             "pool_peak_pages": w["pool_peak"],
             "pool_usable_pages": run.usable_pages},
            w["slice_work"], sl, peaks(kind) if dev.type == "cuda" else None)
        result["metrics"] = _per_layer(cell, readings)
        result["breakdown"] = {
            "device_ops": tr.top(sl.by_name()),
            "idle_gaps": tr.top(sl.idle_by_host_op())}
        log(out, f"traced slice {sl.window_s:.3f} s, device busy "
                 f"{sl.busy_s:.3f} s, {w['slice_work'].prefills} prefills, "
                 f"{w['slice_work'].decode_tokens} decode tokens")
    else:
        m = stats.window_metrics(list(recs.values()), sink.drained, t0, t1,
                                 w["joules"])
        m["setup_s"] = setup_s
        units = {e["name"]: e["unit"] for e in cell.end_to_end}
        missing = [k for k in units if k not in m]
        if missing:
            raise RuntimeError(f"the window gave no value for {missing}")
        result["metrics"] = {k: {"value": m[k], "unit": u}
                             for k, u in units.items()}
    run.free()
    checked = check.judge(run.ref, run.W, cell.config, finished, preempted,
                          cell.check, run.seed, out)
    checked["short_outputs"] = {"value": short, "limit": 0}
    checked["failed_requests"] = {"value": failed, "limit": 0}
    result["correct"] = all(
        v["value"] <= v["limit"] if k != "served_tokens" else
        v["value"] >= v["limit"] for k, v in checked.items())
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                        "kind": kind, "count": cell.chips,
                        "memory_peak_bytes": int(peak_bytes)}
    if trace:
        result["device"]["busy_s"] = sl.busy_s
        result["device"]["window_s"] = sl.window_s
    for k, v in checked.items():
        log(out, f"check {k} {v['value']} limit {v['limit']}")
    result["check"] = checked
    return result


def _slice(prof) -> tr.Slice:
    if prof is None:
        raise RuntimeError("the window ended before the traced slice began")
    events = tr.events_of(prof)
    span = [e for e in events if e.name == "chipbench.slice"]
    if not span:
        raise RuntimeError("the trace holds no chipbench.slice span")
    s = span[0]
    return tr.Slice(s.start_ns, s.end_ns, events, s.thread)


def _per_layer(cell: spec.Cell, readings: Readings) -> Dict:
    out = {}
    for m in cell.per_layer:
        read, patterns = spec.metric_reader(m["name"])
        readings.patterns = patterns
        v = read(readings)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
