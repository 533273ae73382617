"""Serving launcher of the port: drive the slot-native engine, or the
disaggregated prefill/decode cluster, through the ``serving.api.Server``
front door with the reference launcher's synthetic burst, and print the
typed ``ServingReport``.

  python -m repro_torch.launch.serve                    # qwen2-1.5b smoke, CUDA
  python -m repro_torch.launch.serve --full-width       # the full config
  # any of the reference's 11 archs, e.g. qwen3-14b (the paper's model),
  # gemma2-9b (local/full rings, softcaps), qwen3-moe-30b-a3b (MoE),
  # mamba2-370m (SSM) or recurrentgemma-9b (RG-LRU + local MQA)
  python -m repro_torch.launch.serve --arch qwen3-14b --full-width
  python -m repro_torch.launch.serve --arch recurrentgemma-9b --paged
  python -m repro_torch.launch.serve --device cpu --requests 4
  python -m repro_torch.launch.serve --paged            # paged KV pool
  python -m repro_torch.launch.serve --prefix-cache     # + prefix cache
  # 1 prefill + 1 decode replica, streams handed off between them
  python -m repro_torch.launch.serve --cluster [--prefix-cache]
  # every second request samples at --temperature (--top-k / --top-p /
  # --seed), the rest stay greedy
  python -m repro_torch.launch.serve --mixed-sampling --temperature 0.8
  # observability: Prometheus text + metrics timeline, request trace,
  # per-request energy attribution, SLO alert rules
  python -m repro_torch.launch.serve --metrics-out m.prom \
      --trace-out trace.jsonl --attribution-out energy.jsonl --alerts
  # a (data, model) serving mesh: (1,1) in this process, a larger one as
  # that many ranks (gloo on the CPU, NCCL on GPUs); only rank 0 prints
  python -m repro_torch.launch.serve --mesh 1,1
  python -m torch.distributed.run --nproc-per-node 8 \
      -m repro_torch.launch.serve --device cpu --mesh 2,4

Defaults match ``python -m repro.launch.serve`` (qwen2-1.5b, governor
greenllm, unpaged, greedy, max_batch 8, max_len 192).  ``--prefix-cache``
implies ``--paged`` and, as in the reference, opens every synthetic prompt
with one shared 48-token system prompt.  ``--full-width``
serves ``get_config(arch)`` itself, with random seeded weights, instead of
its ``.smoke()`` reduction; virtual time and energy are accounted on the
full config either way.  ``--cluster`` serves a 1 prefill + 1 decode
cluster on the paged plane and prints one row per replica.  ``--mesh dp,tp``
serves on a (data, model) mesh (``serving.engine``'s mesh path) of
``dp * tp`` ranks, bit-identically to no mesh: under
``torch.distributed.run`` every rank runs this launcher (on GPUs each on
``cuda:<local rank>``); without it only (1,1) can start, in this process.
"""
import argparse
import json
import os
import sys

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import (AlertEngine, AlertRule, EnergyLedger,
                              MetricsRegistry, SamplingParams, SLOConfig,
                              Tracer, verify_conservation)
from repro_torch.serving import (EngineConfig, Server, ServingCluster,
                                 ServingEngine)


def sampling_for(args, i: int, max_tokens: int) -> SamplingParams:
    """Per-request sampling: greedy by default; ``--temperature`` samples
    every request, and ``--mixed-sampling`` restores greedy on the even
    ones (a multi-tenant-style heterogeneous batch)."""
    if args.temperature <= 0.0 or (args.mixed_sampling and i % 2 == 0):
        return SamplingParams(max_tokens=max_tokens)
    return SamplingParams(max_tokens=max_tokens,
                          temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p,
                          seed=None if args.seed < 0 else args.seed + i)


def workload(args, vocab):
    """(arrival, prompt_tokens, max_tokens) triples: a named trace's
    arrival/length mix, or the synthetic burst."""
    rng = np.random.default_rng(0)
    # with --prefix-cache every prompt opens with the same system prefix
    # (the chat/RAG traffic shape the cache targets) so the dashboard's
    # hit rate reflects real sharing instead of random-prompt misses; the
    # tail is capped so the engine's keep-the-last-max_len/2 prompt
    # truncation never chops (and misaligns) the shared head
    sys_prompt = rng.integers(0, vocab, size=48) if args.prefix_cache \
        else np.empty(0, np.int64)
    cap = max(args.max_len // 2 - len(sys_prompt), 1)
    if args.trace != "synthetic":
        from repro_torch.data import get_trace
        trace = get_trace(args.trace, duration=args.duration)
        for r in trace[: args.requests]:
            plen = min(r.prompt_len, args.max_len // 2, cap)
            yield (r.arrival,
                   np.concatenate([sys_prompt,
                                   rng.integers(0, vocab, size=plen)]),
                   min(r.output_len, args.max_len // 3))
    else:
        for _ in range(args.requests):
            plen = min(int(rng.integers(16, 80)), cap)
            yield (0.0,
                   np.concatenate([sys_prompt,
                                   rng.integers(0, vocab, size=plen)]),
                   int(rng.integers(16, 64)))


def default_alert_rules(slo: SLOConfig):
    """The ``--alerts`` rule set: TTFT/TBT error-budget burn rate over a
    trailing window plus a hard p95-TBT latency ceiling."""
    rules = [AlertRule.burn_rate(
        f"{kind}-burn", "greenllm_slo_total",
        bad_labels={"kind": kind, "outcome": "miss"},
        good_labels={"kind": kind, "outcome": "pass"},
        window_s=2.0, slo_target=0.9, burn_threshold=1.0, min_events=4,
        severity="page") for kind in ("ttft", "tbt")]
    rules.append(AlertRule.threshold(
        "p95-tbt-high", "greenllm_tbt_p95_seconds", ">",
        2.0 * slo.tbt_target, severity="warning"))
    return rules


class Dashboard:
    """Periodic one-line stderr dashboard, driven by the event stream's
    virtual timestamps — it fires when drained events cross the period
    boundary (the backend's block cadence), never per token."""

    def __init__(self, period: float, metrics: MetricsRegistry,
                 out=sys.stderr, alerts=None):
        self.period = period
        self.metrics = metrics
        self.out = out
        self.alerts = alerts
        self._next = period

    def __call__(self, ev) -> None:
        t = getattr(ev, "time", 0.0)
        while t >= self._next:
            self.line(self._next)
            self._next += self.period

    def line(self, t: float) -> None:
        flat = self.metrics.flat()

        def total(prefix, needle=""):
            return sum(v for k, v in flat.items()
                       if k.startswith(prefix) and needle in k)

        freqs = {k.split('replica="')[1].rstrip('"}'): v
                 for k, v in flat.items()
                 if k.startswith("greenllm_frequency_mhz")}
        p95 = max((v for k, v in flat.items()
                   if k.startswith("greenllm_tbt_p95_seconds")),
                  default=0.0)
        fstr = " ".join(f"{n}={f:.0f}" for n, f in sorted(freqs.items()))
        extra = ""
        saved = total("greenllm_energy_saved_joules_total")
        if saved:
            extra += f" saved={saved / 1e3:.2f}kJ"
        drops = total("greenllm_tracer_dropped")
        if drops:
            extra += f" trace_drops={drops:.0f}"
        pc_hits = total("greenllm_prefix_cache_hits_total")
        pc_miss = total("greenllm_prefix_cache_misses_total")
        if pc_hits + pc_miss:
            extra += f" pc_hit={100 * pc_hits / (pc_hits + pc_miss):.0f}%"
        if self.alerts is not None:
            firing = self.alerts.firing()
            if firing:
                extra += " ALERTS[" + ",".join(sorted(firing)) + "]"
        print(f"[serve t={t:8.3f}s] "
              f"done={total('greenllm_requests_total', 'completed'):.0f} "
              f"E={total('greenllm_energy_joules_total') / 1e3:.2f}kJ "
              f"p95_tbt={p95 * 1e3:5.1f}ms MHz[{fstr}]{extra}",
              file=self.out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--governor", default="greenllm",
                    choices=["greenllm", "defaultnv"])
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=192)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (page-table data plane)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed prompt prefix cache over the "
                         "paged pool (implies --paged); the synthetic "
                         "workload prepends a shared system prompt")
    ap.add_argument("--chunked", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="chunked prefill admission (always on when paged)")
    ap.add_argument("--mesh", default="",
                    help="'dp,tp' serving mesh (data x model): dp*tp ranks, "
                         "one process for 1,1, else under "
                         "torch.distributed.run")
    ap.add_argument("--cluster", action="store_true",
                    help="disaggregated 1-prefill + 1-decode cluster with "
                         "paged-KV handoff instead of one colocated engine")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for submitted requests "
                         "(0: greedy; per-request, not engine-global)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k filter (0: disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="per-request nucleus mass (1.0: disabled)")
    ap.add_argument("--seed", type=int, default=-1,
                    help="base sampling seed; request i uses seed+i "
                         "(-1: unseeded lanes)")
    ap.add_argument("--mixed-sampling", action="store_true",
                    help="alternate greedy and sampled requests in one "
                         "batch (multi-tenant mix; needs --temperature)")
    ap.add_argument("--trace", default="synthetic",
                    help="synthetic | chat_5qps | azure_code8 | azure_conv5 "
                         "| ... (data.traces names; arrivals replayed on "
                         "the virtual clock)")
    ap.add_argument("--duration", type=float, default=60.0,
                    help="trace horizon in seconds (named traces only)")
    ap.add_argument("--metrics-out", default="",
                    help="write the Prometheus text exposition here at "
                         "exit, plus the full metrics timeline next to it "
                         "(<path>.timeline.jsonl)")
    ap.add_argument("--trace-out", default="",
                    help="write the request-lifecycle trace here as JSONL, "
                         "plus a Chrome/Perfetto trace next to it "
                         "(<path>.chrome.json)")
    ap.add_argument("--dashboard", type=float, default=0.0,
                    help="print a one-line stderr dashboard every N "
                         "virtual seconds (0: off; implies a metrics "
                         "registry)")
    ap.add_argument("--attribution-out", default="",
                    help="install the per-request energy ledger and write "
                         "its attribution rows here as JSONL at exit "
                         "(conservation-checked against the report)")
    ap.add_argument("--alerts", action="store_true",
                    help="evaluate the default SLO alert rule set (TTFT/"
                         "TBT burn rate + p95-TBT ceiling) at block "
                         "cadence; implies a metrics registry; firings "
                         "are audited against the timeline at exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (cuda: the "
                         "port's kernels; cpu: their plain versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the full config instead of its .smoke() "
                         "reduction")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        try:
            mesh = tuple(int(v) for v in args.mesh.split(","))
        except ValueError:
            raise SystemExit(f"--mesh expects 'dp,tp', got {args.mesh!r}")
    started = _start_ranks(args, mesh)
    try:
        return _serve(args, mesh)
    finally:
        if started:
            from repro_torch.launch.mesh import shutdown
            shutdown()


def _start_ranks(args, mesh) -> bool:
    """Start the default process group a mesh serves on, when nobody has:
    from ``torch.distributed.run``'s environment (each rank on its own GPU
    for CUDA), or, for (1,1), as one rank in this process.  Any other mesh
    is left without ranks, and the engine refuses it.  True if a group was
    started here."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import backend_for, init_single_rank
    if mesh is None or dist.is_initialized():
        return False
    if "WORLD_SIZE" in os.environ:
        if args.device == "cuda":
            import torch
            args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(args.device)
        dist.init_process_group(backend_for(args.device))
        return True
    if mesh[0] * mesh[1] == 1:
        init_single_rank(args.device)
        return True
    return False


def _serve(args, mesh):
    import torch.distributed as dist
    lead = not dist.is_initialized() or dist.get_rank() == 0
    full = get_config(args.arch)
    served = full if args.full_width else full.smoke()
    metrics = MetricsRegistry(snapshot_min_dt=0.005) \
        if args.metrics_out or args.dashboard > 0 or args.alerts else None
    tracer = Tracer() if args.trace_out else None
    ledger = EnergyLedger() if args.attribution_out else None
    alerts = AlertEngine(metrics, default_alert_rules(SLOConfig()),
                         tracer=tracer) if args.alerts else None
    on_event = Dashboard(args.dashboard, metrics, alerts=alerts) \
        if args.dashboard > 0 and lead else None
    ecfg = EngineConfig(max_batch=args.max_batch, max_len=args.max_len,
                        governor=args.governor,
                        paged=args.paged or args.prefix_cache,
                        chunked_prefill=args.chunked,
                        prefix_cache=args.prefix_cache, mesh=mesh)
    if args.cluster:
        # the cluster forces the paged plane (the handoff moves page chains)
        backend = ServingCluster(served, n_prefill=1, n_decode=1,
                                 plant_cfg=full, ecfg=ecfg,
                                 device=args.device)
        engines = [r.engine for r in backend.replicas]
    else:
        backend = ServingEngine(served, plant_cfg=full, ecfg=ecfg,
                                device=args.device)
        engines = [backend]
    server = Server(backend, on_event=on_event, metrics=metrics, tracer=tracer,
                    ledger=ledger, alerts=alerts)
    n = 0
    for arrival, prompt, max_tokens in workload(args, served.vocab_size):
        server.submit(prompt, sampling_for(args, n, max_tokens),
                      arrival=arrival)
        n += 1
    rep = server.run()
    if not lead:
        return rep          # every rank served the same stream; rank 0 prints
    plane = "cluster(1p+1d)" if args.cluster else \
        ("engine/paged" if args.paged else "engine")
    print(f"arch={args.arch} governor={args.governor} plane={plane} "
          f"trace={args.trace} requests={n}")
    print(rep.summary())
    for row in rep.replicas:
        print(f"  {row.name:10s} {row.role:9s} "
              f"E={row.energy_j / 1e3:6.2f}kJ "
              f"(pre {row.prefill_energy_j / 1e3:.2f} / "
              f"dec {row.decode_energy_j / 1e3:.2f} / "
              f"idle {row.idle_energy_j / 1e3:.2f}) "
              f"tok {row.prefill_tokens}/{row.decode_tokens} "
              f"handoffs {row.exported + row.imported} "
              f"clock {row.freq_mhz:.0f}MHz")
    for eng in engines:
        if eng.prefix_cache is None:
            continue
        st = eng.prefix_cache.stats()
        print(f"  prefix-cache[{eng.name}]: hit_rate="
              f"{st['hit_rate'] * 100:.0f}% "
              f"({st['hits']} hits / {st['misses']} misses, "
              f"{st['hit_tokens']} prompt tokens served from cache, "
              f"{st['entries']} pages resident, "
              f"{st['evictions']} evictions)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(metrics.render_prometheus())
        lines = metrics.write_timeline_jsonl(
            args.metrics_out + ".timeline.jsonl")
        print(f"metrics: {args.metrics_out} "
              f"(+{lines} timeline snapshots)", file=sys.stderr)
    if args.trace_out:
        n_rec = tracer.write_jsonl(args.trace_out)
        tracer.write_chrome_trace(args.trace_out + ".chrome.json")
        print(f"trace: {args.trace_out} ({n_rec} records; chrome trace "
              f"next to it)", file=sys.stderr)
    if ledger is not None:
        rows = rep.replicas if rep.replicas else [dict(
            replica=server.backend.name,
            prefill_j=rep.prefill_energy_j, decode_j=rep.decode_energy_j,
            idle_j=rep.idle_energy_j)]
        verify_conservation(ledger, rows)
        top = sorted(rep.requests, key=lambda r: -r.energy_j)[:5]
        print("per-request attributed energy (top 5 by joules):")
        for r in top:
            print(f"  rid={r.rid:<4d} E={r.energy_j:8.1f}J  "
                  f"saved_vs_fmax={r.energy_saved_j:8.1f}J")
        with open(args.attribution_out, "w") as fh:
            for row in ledger.rows():
                fh.write(json.dumps(row) + "\n")
        print(f"attribution: {args.attribution_out} ({len(ledger.rows())} "
              f"rows; conservation verified)", file=sys.stderr)
    if alerts is not None:
        alerts.evaluate(server.backend.now)     # final round at drain
        audited = alerts.audit()
        fired = [a for a in alerts.log if a.fired]
        print(f"alerts: {len(fired)} firing transition(s), "
              f"{audited} audited against the timeline", file=sys.stderr)
        for a in fired:
            print(f"  [{a.severity}] {a.rule} @ t={a.t:.3f}s "
                  f"value={a.value:.4g}", file=sys.stderr)
    if rep.completed != n:
        raise RuntimeError(f"launcher burst must drain completely: "
                           f"{rep.completed}/{n} completed")
    return rep


if __name__ == "__main__":
    main()
