"""End-to-end serving driver (the paper's kind of workload): replay an
Alibaba-chat-like trace against the serving node under all three governors
and print the paper's Table-3-style comparison, then run a short burst of
*real* inference (batched requests through the actual model, on
``--device``) with the same control plane — everything driven through the
``serving.api.Server`` front door (submit → stream → cancel) and reported
as the shared typed ``ServingReport``.

    PYTHONPATH=src python -m repro_torch.examples.serve_trace_replay
        [--trace chat_5qps] [--arch qwen3-14b] [--duration 120] [--cluster]
        [--prefix-cache] [--kill-replica decode0] [--kill-frac 0.4]
        [--handoff-failures 3] [--device cuda|cpu]

``--prefix-cache`` adds a shared-system-prompt burst (a float32 model
over float32 pages) served twice — cold cache vs warm — asserting
bit-identical tokens and printing the hit rate plus the prefill joules the
cache saved on the full-size plant model.

``--cluster`` adds a disaggregated 1-prefill + 1-decode replica cluster
(paged-KV handoff, per-phase DVFS) replaying an azure_code burst against a
2x-colocated max-frequency baseline at equal replica count.

``--kill-replica`` / ``--handoff-failures`` inject deterministic faults
into that cluster run (``serving.faults``): the named replica is killed
partway through (``--kill-frac`` of the baseline makespan) and the first N
handoff imports fail transiently.  The run must still drain completely —
killed streams are recomputed on survivors, failed imports retry with
capped backoff — which is the crash-recovery smoke CI exercises.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (AlertEngine, EnergyLedger, MetricsRegistry,
                              SamplingParams, SLOConfig, Tracer,
                              read_timeline_jsonl, verify_conservation)
from repro_torch.data import get_trace
from repro_torch.launch.serve import default_alert_rules
from repro_torch.models import init_params
from repro_torch.serving import (EngineConfig, FaultPlan, HandoffFailure,
                                 ReplicaKill, Server, ServingCluster,
                                 ServingEngine)
from repro_torch.sim import ReplayConfig, replay


def replay_burst(server, trace, vocab, *, max_len=192, out_cap=48,
                 keep_arrivals=True):
    """Replay ``trace`` through any backend behind ``server`` (the same
    code path drives a single engine and a cluster — the point of the
    API).  ``keep_arrivals=False`` injects everything at t=0 (a pure
    burst: maximum pool pressure)."""
    rng = np.random.default_rng(0)
    for r in trace:
        plen = min(r.prompt_len, max_len // 2)
        server.submit(rng.integers(0, vocab, size=plen),
                      SamplingParams(max_tokens=min(r.output_len, out_cap)),
                      arrival=r.arrival if keep_arrivals else 0.0)
    return server.run()


def dense_burst(cfg, model_cfg, *, device="cuda", params=None):
    """12 requests (prompts of 16-80 tokens, 16-60 new) through one dense
    engine running ``model_cfg`` on ``device`` under GreenLLM control, its
    virtual time and energy from ``cfg``'s plant.  Streamed through the
    request-lifecycle API: tokens arrive in decode-block bursts while the
    rest of the batch is still in flight.  Returns ``(handles, report)``."""
    srv = Server(ServingEngine(model_cfg, params,
                               ecfg=EngineConfig(max_batch=8, max_len=192),
                               plant_cfg=cfg, device=device))
    rng = np.random.default_rng(0)
    handles = [srv.submit(rng.integers(0, model_cfg.vocab_size,
                                       size=int(rng.integers(16, 80))),
                          SamplingParams(
                              max_tokens=int(rng.integers(16, 60))))
               for _ in range(12)]
    first = sum(1 for _ in handles[0].tokens())   # stream one to completion
    rep = srv.run()                               # drain the rest
    print(f"streamed {first} tokens from request 0 while "
          f"{rep.n_requests - 1} others decoded")
    print(rep.summary())
    return handles, rep


def prefix_burst(cfg, model_cfg, on, *, device="cuda", params=None):
    """12 requests sharing an 80-token system prompt (tails of 4-15
    tokens, 16 new tokens each) through a paged engine running
    ``model_cfg`` over float32 pages on ``device``, with the prefix cache
    ``on`` or off.  Returns ``(engine, report)``."""
    eng = ServingEngine(model_cfg, params, plant_cfg=cfg, ecfg=EngineConfig(
        max_batch=8, max_len=192, paged=True, prefix_cache=on,
        cache_dtype="float32"), device=device)
    srv = Server(eng)
    prng = np.random.default_rng(7)
    head = prng.integers(0, model_cfg.vocab_size, size=80)
    for _ in range(12):
        tail = prng.integers(0, model_cfg.vocab_size,
                             size=int(prng.integers(4, 16)))
        srv.submit(np.concatenate([head, tail]),
                   SamplingParams(max_tokens=16))
    return eng, srv.run()


def run_cluster(cfg, model_cfg, trace, *, max_len=192, kill_replica="",
                kill_frac=0.4, handoff_failures=0, device="cuda",
                params=None):
    """Disaggregated greenllm cluster vs 2x-colocated defaultNV on the same
    azure_code-style burst of real inference on ``device`` — optionally
    with injected faults (replica kill, transient handoff-import failures),
    which the cluster must recover from without losing a single request.
    ``model_cfg`` runs (``params``, or seeded random weights); ``cfg``'s
    plant bills virtual time and energy.  Returns ``(cluster, report,
    baseline_report)``."""
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(0),
                             model_cfg)

    def build(governor, faults=None, alerts=None, **kw):
        cl = ServingCluster(
            model_cfg, params=params, plant_cfg=cfg, faults=faults,
            ecfg=EngineConfig(max_batch=8, max_len=max_len,
                              governor=governor), device=device, **kw)
        return cl, Server(cl, alerts=alerts)

    _, bsrv = build("defaultnv", n_prefill=0, n_decode=0, n_colocated=2)
    base = replay_burst(bsrv, trace, model_cfg.vocab_size, max_len=max_len)

    events = []
    if kill_replica:
        # the baseline makespan is the fault horizon: same order of
        # magnitude as the disaggregated run's own clock
        events.append(ReplicaKill(at=kill_frac * base.duration_s,
                                  replica=kill_replica))
    if handoff_failures > 0:
        events.append(HandoffFailure(at=0.0, count=handoff_failures))
    plan = FaultPlan(events) if events else None

    reg = MetricsRegistry(snapshot_min_dt=0.002)
    tr = Tracer()
    ledger = EnergyLedger()
    alerts = AlertEngine(reg, default_alert_rules(SLOConfig()), tracer=tr)
    cl, srv = build("greenllm", faults=plan, alerts=alerts,
                    n_prefill=1, n_decode=1,
                    metrics=reg, tracer=tr, ledger=ledger)
    rep = replay_burst(srv, trace, model_cfg.vocab_size, max_len=max_len)
    assert rep.completed == base.completed == len(trace), \
        "cluster must drain the burst completely (zero stalls)"
    if plan is not None:
        print(f"faults: kills={[(n, round(t, 3)) for n, t, _ in cl.kills]}  "
              f"import_retries={cl.import_retries}  "
              f"fired={[k for k, _, _ in plan.log]}")
        assert not kill_replica or cl.kills, "scheduled kill never fired"
        assert cl.import_retries >= handoff_failures, \
            "injected import failures must surface as retries"

    print(f"{'replica':12s} {'role':10s} {'E_pre J':>9s} {'E_dec J':>9s} "
          f"{'E_idle J':>9s} {'tok pre/dec':>12s} {'handoffs':>9s}")
    for row in rep.replicas:
        print(f"{row.name:12s} {row.role:10s} "
              f"{row.prefill_energy_j:9.1f} {row.decode_energy_j:9.1f} "
              f"{row.idle_energy_j:9.1f} "
              f"{row.prefill_tokens:5d}/{row.decode_tokens:5d} "
              f"{row.exported + row.imported:9d}")
    save = 100 * (1 - rep.total_energy_j / base.total_energy_j)
    print(f"completed={rep.completed}/{len(trace)}  "
          f"handoffs={rep.migrated}  preempted={rep.preempted}  "
          f"makespan={rep.duration_s:.2f}s")
    print(f"TTFT pass={rep.ttft_pass * 100:.0f}%  "
          f"TBT pass={rep.tbt_pass * 100:.0f}%  "
          f"p95 TBT={rep.p95_tbt_s * 1e3:.1f}ms")
    print(f"energy: disaggregated={rep.total_energy_j / 1e3:.2f}kJ  "
          f"colocated@fmax={base.total_energy_j / 1e3:.2f}kJ  "
          f"saving={save:.1f}%")

    # --- per-request energy attribution + counterfactual savings -----------
    # the ledger splits every metered joule across resident requests (idle
    # stays an explicit unattributed pool); conservation against the report
    # rows is *bitwise*, even across kills and handoffs
    summary = verify_conservation(ledger, rep.replicas)
    pool = sum(s["idle_pool_j"] for s in summary)
    denom = max(rep.total_energy_j + rep.energy_saved_j, 1e-9)
    print(f"attribution: conservation exact on {len(summary)} replicas  "
          f"idle_pool={pool:.1f}J (unattributed)  "
          f"saved_vs_fmax={rep.energy_saved_j:.1f}J "
          f"({100 * rep.energy_saved_j / denom:.1f}% of a max-freq run)")
    by_rid = {x["rid"]: x for x in ledger.rows()}
    for r in sorted(rep.requests, key=lambda q: -q.energy_j)[:5]:
        row = by_rid[r.rid]
        carried = (f"  carried_from={','.join(row['carried_from'])}"
                   if row["carried_from"] else "")
        print(f"  rid={r.rid:<4d} E={r.energy_j:7.2f}J  "
              f"saved={r.energy_saved_j:6.2f}J  "
              f"replicas={','.join(row['replicas'])}{carried}")
    if plan is None:
        assert rep.total_energy_j <= base.total_energy_j, \
            "per-phase DVFS must not cost energy vs the max-freq baseline"
    else:
        # with a kill the survivors recompute lost streams, so the energy
        # win is not guaranteed — conservation across the kill is (dead
        # replicas stop billing at their kill snapshot)
        assert abs(sum(r.energy_j for r in rep.replicas)
                   - rep.total_energy_j) < 1e-6 * max(rep.total_energy_j, 1)

    # --- replayable observability timeline ---------------------------------
    # every metric is queryable at any virtual-clock instant, and every
    # frequency change across the timeline has a logged decision reason
    import os
    import tempfile
    out = os.path.join(tempfile.gettempdir(),
                       "cluster_metrics.timeline.jsonl")
    n_snap = reg.write_timeline_jsonl(out)
    assert read_timeline_jsonl(out) == reg.timeline, \
        "timeline JSONL must round-trip exactly"
    mid = rep.duration_s / 2
    snap = reg.query(mid)

    def at(prefix, replica):
        return next((v for k, v in snap.items() if k.startswith(prefix)
                     and f'replica="{replica}"' in k), float("nan"))

    print(f"observability: {n_snap} snapshots -> {out}  "
          f"({len(tr)} trace records)")
    print(f"state @ t={mid:.3f}s (mid-run query):")
    for row in rep.replicas:
        e_mid = sum(v for k, v in snap.items()
                    if k.startswith("greenllm_energy_joules_total")
                    and f'replica="{row.name}"' in k)
        f_mid = at("greenllm_frequency_mhz", row.name)
        occ_mid = at("greenllm_page_occupancy", row.name)
        p99_mid = at("greenllm_tbt_p99_seconds", row.name)
        print(f"  {row.name:10s} f={f_mid:6.0f}MHz E={e_mid:8.1f}J "
              f"occ={occ_mid * 100:5.1f}% p99_tbt={p99_mid * 1e3:.1f}ms")
    audited = 0
    for row in rep.replicas:
        key = f'greenllm_frequency_mhz{{replica="{row.name}"}}'
        series = reg.series(key)
        phase = "prefill" if row.role == "prefill" else "decode"
        for (t0, v0), (t1, v1) in zip(series, series[1:]):
            if v1 == v0:
                continue
            d = tr.decision_at(t1, row.name, phase=phase)
            assert d is not None, \
                f"frequency change on {row.name} @ {t1:.4f}s has no " \
                f"logged DVFS decision"
            assert abs(d.freq_mhz - v1) < 1e-6, \
                f"{row.name} @ {t1:.4f}s: gauge {v1} != decided " \
                f"{d.freq_mhz} ({d.reason})"
            audited += 1
    reasons = sorted({d.reason for d in tr.decisions()})
    print(f"DVFS audit: {audited} frequency changes, each with a logged "
          f"reason; reasons seen: {reasons}")
    n_alert = alerts.audit()
    fired = [a for a in alerts.log if a.fired]
    print(f"alerts: {len(fired)} firing transition(s), {n_alert} audited "
          f"against the timeline"
          + (f"; fired: {sorted({a.rule for a in fired})}" if fired else ""))
    return cl, rep, base


def main(argv=None):
    """Run the example; returns what it printed as objects: the governor
    table (``governors``: name -> ``Metrics``), the reports of each burst
    (``burst``, ``paged``, and with the flags ``prefix`` as (cold, warm)
    and ``cluster`` as ``run_cluster``'s triple)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="chat_5qps")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--cluster", action="store_true",
                    help="add the disaggregated prefill/decode cluster "
                         "replay vs the colocated max-frequency baseline")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="add a shared-system-prompt burst served warm "
                         "(prefix cache on) vs cold, printing hit rate and "
                         "prefill joules saved (tokens asserted identical)")
    ap.add_argument("--kill-replica", default="",
                    help="with --cluster: kill this replica (e.g. decode0) "
                         "partway through and recover on survivors")
    ap.add_argument("--kill-frac", type=float, default=0.4,
                    help="kill time as a fraction of the baseline makespan")
    ap.add_argument("--handoff-failures", type=int, default=0,
                    help="with --cluster: fail the first N handoff imports "
                         "(retried with capped exponential backoff)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the real-execution bursts (cuda "
                         "unless the CPU is asked for)")
    args = ap.parse_args(argv)
    out = {"governors": {}}

    cfg = get_config(args.arch)
    trace = get_trace(args.trace, duration=args.duration)
    print(f"=== trace replay: {args.trace} x {args.arch} "
          f"({len(trace)} requests, {args.duration:.0f}s) ===")
    print(f"{'governor':14s} {'TTFT%':>7s} {'TBT%':>7s} {'E_pre kJ':>9s} "
          f"{'E_dec kJ':>9s} {'dE%':>7s} {'tok/s':>7s}")
    base = None
    deg = 1 if cfg.is_subquadratic else 2
    for gov in ("defaultNV", "prefillsplit", "greenllm"):
        m = replay(cfg, trace, ReplayConfig(governor=gov,
                                            latency_fit_degree=deg))
        out["governors"][gov] = m
        if base is None:
            base = m.total_energy_j
        print(f"{gov:14s} {m.ttft_pass*100:7.1f} {m.tbt_pass*100:7.1f} "
              f"{m.prefill_energy_j/1e3:9.1f} {m.decode_energy_j/1e3:9.1f} "
              f"{100*(1-m.total_energy_j/base):7.2f} "
              f"{m.throughput_tok_s:7.0f}")

    # --- real execution with the same control plane ------------------------
    print("\n=== real-execution burst (reduced model, GreenLLM control) ===")
    smoke = cfg.smoke()
    out["burst"] = dense_burst(cfg, smoke, device=args.device)[1]

    # --- paged engine on a long-prompt-heavy trace -----------------------------
    # azure_code prompts are long (code context); on half the dense K/V memory
    # the paged engine still fills every batch slot, long prompts admit through
    # chunked prefill (no eager fallback), and pool pressure preempts +
    # recomputes instead of refusing admission.
    print("\n=== paged burst: azure_code prompt/output mix, half K/V memory ===")
    code_trace = get_trace("azure_code8", duration=args.duration)
    max_len, page_size, batch = 192, 16, 8
    num_pages = (batch * max_len // page_size) // 2 + 1
    peng = ServingEngine(smoke, plant_cfg=cfg, ecfg=EngineConfig(
        max_batch=batch, max_len=max_len, paged=True, page_size=page_size,
        num_pages=num_pages), device=args.device)
    pst = replay_burst(Server(peng), code_trace[:16], smoke.vocab_size,
                       max_len=max_len, keep_arrivals=False)
    pool = peng.pager.occupancy()["pages_total"]   # page 0 is scratch
    dense_equiv = (pool * page_size) // max_len
    print(f"completed={pst.completed}  preempted={pst.preempted}  "
          f"pool={pool}p ({dense_equiv} dense-equivalent rows "
          f"for batch={batch})")
    print(f"peak occupancy={pst.page_occupancy_peak * 100:.0f}%")
    print(f"E_prefill={pst.prefill_energy_j/1e3:.2f}kJ "
          f"({pst.prefill_tokens} tok)  "
          f"E_decode={pst.decode_energy_j/1e3:.2f}kJ "
          f"({pst.decode_tokens} tok)  "
          f"p95 TBT={pst.p95_tbt_s * 1e3:.1f}ms")
    out["paged"] = pst

    # --- prefix cache: shared-system-prompt burst, warm vs cold ---------------
    # chat/RAG traffic re-prefills the same system prompt per request; with
    # --prefix-cache the paged engine serves the shared head from cached
    # pages (bit-identical tokens, asserted) and the skipped prefill work
    # shows up directly as joules on the full-size plant model
    if args.prefix_cache:
        print("\n=== prefix cache: shared 80-token system prompt, "
              "12 requests ===")
        # f32 compute over float32 caches: a hit replays the prompt through
        # chunked prefill against cached pages while the cold run one-shots
        # it — the same tokens.  Over bf16 caches a hit reads the head's
        # K/V rounded to bf16 where the cold run attends to them in f32, and
        # a near tie can flip a token (on the weights drawn on CUDA from
        # seed 0, on either device: chip_smoke.py's replay_c3 prints it)
        pc_smoke = dataclasses.replace(smoke, dtype="float32")
        ceng, crep = prefix_burst(cfg, pc_smoke, False, device=args.device)
        weng, wrep = prefix_burst(cfg, pc_smoke, True, device=args.device)
        assert [q.tokens for q in weng.requests] == \
            [q.tokens for q in ceng.requests], \
            "prefix-cache tokens must match the cold run"
        st = weng.prefix_cache.stats()
        saved_j = crep.prefill_energy_j - wrep.prefill_energy_j
        saved_tok = crep.prefill_tokens - wrep.prefill_tokens
        print(f"hit_rate={st['hit_rate'] * 100:.0f}% "
              f"({st['hits']} hits / {st['misses']} misses, "
              f"{st['hit_tokens']} prompt tokens from cache)")
        print(f"prefill: {crep.prefill_tokens} -> {wrep.prefill_tokens} "
              f"tokens ({saved_tok} skipped)  "
              f"energy: {crep.prefill_energy_j:.1f}J -> "
              f"{wrep.prefill_energy_j:.1f}J "
              f"(saved {saved_j:.1f}J, "
              f"{100 * saved_j / crep.prefill_energy_j:.0f}% of prefill)")
        assert wrep.prefill_tokens < crep.prefill_tokens, \
            "warm run must prefill fewer tokens"
        out["prefix"] = (crep, wrep)

    # --- disaggregated prefill/decode cluster on the azure_code burst ---------
    if args.cluster:
        print("\n=== disaggregated cluster: 1 prefill + 1 decode replica, "
              "paged-KV handoff, per-phase DVFS ===")
        out["cluster"] = run_cluster(
            cfg, smoke, code_trace[:16], kill_replica=args.kill_replica,
            kill_frac=args.kill_frac, handoff_failures=args.handoff_failures,
            device=args.device)
    return out


if __name__ == "__main__":
    main()
