"""Rank worker (and its spawner) for the port's mesh-serving tests: the
port of ``tests/mesh_runner.py``.

Runs the reference runner's serving trace on one mesh shape (or unsharded)
and prints rank 0's JSON digest — token sequences per request,
ServingReport energy/SLO fields, host drains, prefix hits, and the port's
per-kernel launch counts — to stdout.  A (dp, tp) mesh runs as ``dp * tp``
gloo ranks on the CPU, every rank serving the same trace; the tests compare
each mesh's digest with the unsharded engine's, bitwise.  The reference's
jit compile counts have no counterpart until the port's decode blocks
replay CUDA graphs; the launch counts count CUDA launches only, so they
read 0 on the CPU.

    PYTHONPATH=src python tests/torch_mesh_runner.py --mesh none
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 8 tests/torch_mesh_runner.py --mesh 8,1/2,4/4,2

``spawn`` starts the ranks itself (one process each, a ``FileStore`` under
a temporary directory for the rendezvous) and returns rank 0's digests;
one set of 8 ranks serves the meshes (8,1), (2,4) and (4,2) in turn, so
the ranks pay for their start-up (~5 s of imports each) once.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dense_cfg():
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="mesh-dense", arch_type="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                       d_ff=128, vocab_size=128, dtype="float32", max_seq=512)


def _moe_cfg():
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="mesh-moe", arch_type="moe", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                       d_ff=128, vocab_size=128, num_experts=4,
                       experts_per_token=2, dtype="float32", max_seq=512)


def _requests(n, vocab, seed=3, out_len=10, dup_every=3):
    """Mixed greedy / seeded-sampled requests; every ``dup_every``-th prompt
    repeats an earlier one so the prefix cache takes real hits."""
    import numpy as np
    from repro_torch.core import Request, SamplingParams
    rng = np.random.default_rng(seed)
    base = [rng.integers(1, vocab - 1, size=int(rng.integers(9, 22)))
            for _ in range(dup_every)]
    prompts, reqs = [], []
    for i in range(n):
        prompts.append(base[i % dup_every])
        sp = SamplingParams(max_tokens=out_len, temperature=0.7,
                            seed=100 + i) if i % 2 else \
            SamplingParams(max_tokens=out_len)
        reqs.append(Request(rid=i, arrival=0.0, prompt_len=len(prompts[-1]),
                            output_len=out_len, sampling=sp))
    return prompts, reqs


def _report_digest(rep):
    return {
        "completed": rep.completed, "cancelled": rep.cancelled,
        "failed": rep.failed, "shed": rep.shed, "preempted": rep.preempted,
        "migrated": rep.migrated,
        "prefill_energy_j": rep.prefill_energy_j,
        "decode_energy_j": rep.decode_energy_j,
        "idle_energy_j": rep.idle_energy_j,
        "prefill_tokens": rep.prefill_tokens,
        "decode_tokens": rep.decode_tokens,
        "duration_s": rep.duration_s,
        "ttft_pass": rep.ttft_pass, "tbt_pass": rep.tbt_pass,
    }


def run_engine(mesh, cfg, cancel=False, out_len=10, params=None):
    """Engine scenario: paged + prefix cache + chunked prefill on a pool
    tight enough to preempt, a mid-run cancel, mixed sampling."""
    from repro_torch.serving import EngineConfig, Server, ServingEngine
    ecfg = EngineConfig(max_batch=8, max_len=96, paged=True,
                        prefix_cache=True, num_pages=16, page_size=16,
                        cache_dtype="float32", governor="defaultnv",
                        mesh=mesh)
    eng = ServingEngine(cfg, params=params, ecfg=ecfg, seed=0, device="cpu")
    prompts, reqs = _requests(10, cfg.vocab_size, out_len=out_len)
    for p, r in zip(prompts, reqs):
        eng.submit(r, p)
    eng.step()                        # progress, then cancel a live request
    cancelled = None
    if cancel:
        live = [r.rid for r in eng.pending] + \
            sorted(st.req.rid for st in eng.active.values())
        assert live, "nothing left to cancel after one block"
        cancelled = live[0]
        assert eng.cancel(cancelled)
    Server(eng).run()
    rep = eng.report()
    pc = eng.prefix_cache.stats()
    return {
        "tokens": {r.rid: list(map(int, r.tokens)) for r in reqs},
        "cancelled_rid": cancelled,
        "report": _report_digest(rep),
        "host_drains": eng._host_drains,
        "prefix_hits": pc["hits"], "prefix_hit_tokens": pc["hit_tokens"],
        "buckets": list(eng.buckets), "ctx_buckets": list(eng.ctx_buckets),
        "k_blocks": list(eng._k_blocks),
    }


def run_cluster(mesh):
    """Disaggregated cluster scenario: prefill->decode handoffs on every
    request, plus a replica kill at a deterministic fraction of the healthy
    run's makespan (identical across meshes because tokens are).  Each
    decode replica serves its streams in one 64-step block that starts
    before the kill time and ends after the run's, so that kill never
    fires (in the reference's runner too); a third run at 4-step blocks
    takes the same kill mid-decode and recovers the same tokens."""
    from repro_torch.serving import (EngineConfig, FaultPlan, ReplicaKill,
                                     Server, ServingCluster)
    cfg = _dense_cfg()
    prompts, reqs = _requests(6, cfg.vocab_size, seed=11, dup_every=6)

    def once(faults=None, decode_block=64):
        ecfg = EngineConfig(max_batch=8, max_len=96, cache_dtype="float32",
                            governor="defaultnv", num_pages=32, mesh=mesh,
                            decode_block=decode_block)
        cl = ServingCluster(cfg, n_prefill=1, n_decode=2, ecfg=ecfg,
                            seed=0, faults=faults, device="cpu")
        srv = Server(cl)
        handles = [srv.submit(p, r.sampling) for p, r in zip(prompts, reqs)]
        rep = srv.run()
        toks = {i: list(map(int, h.request.tokens))
                for i, h in enumerate(handles)}
        drains = sum(r.engine._host_drains for r in cl.replicas)
        return rep, toks, drains, len(cl.kills)

    healthy_rep, healthy_toks, healthy_drains, _ = once()
    plan = FaultPlan([ReplicaKill(at=0.4 * healthy_rep.duration_s,
                                  replica="decode1")])
    faulted_rep, faulted_toks, _, _ = once(faults=plan)
    assert faulted_toks == healthy_toks, \
        "replica-kill recovery lost token-exactness"
    plan = FaultPlan([ReplicaKill(at=0.4 * healthy_rep.duration_s,
                                  replica="decode1")])
    killed_rep, killed_toks, killed_drains, kills = once(faults=plan,
                                                         decode_block=4)
    assert killed_toks == healthy_toks, \
        "replica-kill recovery lost token-exactness"
    return {
        "tokens": healthy_toks,
        "report": _report_digest(healthy_rep),
        "host_drains": healthy_drains,
        "faulted_report": _report_digest(faulted_rep),
        "killed_report": _report_digest(killed_rep),
        "killed_host_drains": killed_drains, "kills": kills,
    }


def run_roundtrip(mesh):
    """Placement on the mesh and back (tests/test_shardings.py's property
    2, on real ranks): dense and MoE params placed by the serving specs,
    and a paged serving cache tree, gathered back equal the originals
    bitwise and equal DTensor's own ``full_tensor()``; with the bytes each
    rank stores and the expert rows an MoE stack keeps here."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.shardings import (gather_replicated, place_tree,
                                              serving_param_specs,
                                              shard_serving_caches)
    from repro_torch.models import init_cache, init_params
    from repro_torch.training import pytree
    dm = make_serving_mesh(*mesh, device="cpu")
    out = {"equal": True, "equal_full_tensor": True, "bytes": 0,
           "local_bytes": 0}
    for cfg in (_dense_cfg(), _moe_cfg()):
        params = init_params(torch.Generator().manual_seed(0), cfg)
        specs, _ = serving_param_specs(cfg, dm)
        caches = init_cache(cfg, 8, 96, dtype=torch.float32, device="cpu",
                            paged_pool=(16, 16))
        for tree, stored in ((params, place_tree(params, specs, dm)),
                             (caches, shard_serving_caches(caches, dm))):
            back = gather_replicated(stored, dm)
            for x, st, b in zip(pytree.leaves(tree), pytree.leaves(stored),
                                pytree.leaves(back)):
                out["equal"] &= bool(torch.equal(x, b))
                out["equal_full_tensor"] &= bool(
                    torch.equal(st.full_tensor(), x))
                out["bytes"] += x.numel() * x.element_size()
                loc = st.to_local()
                out["local_bytes"] += loc.numel() * loc.element_size()
        if cfg.is_moe:
            up = place_tree(params, specs, dm)["stages"][0]["blocks"][0]
            out["expert_rows_here"] = int(up["moe"]["up"].to_local().shape[1])
    return out


def run_wallclock(mesh):
    """Wall-clock accounting on the mesh: every rank measures its own block
    times, so the engine bills rank 0's on every rank; each rank must end
    with the same virtual clock, energy and tokens (a rank whose clock
    drifted would schedule differently and leave the collectives out of
    step)."""
    import torch.distributed as dist
    from repro_torch.serving import EngineConfig, Server, ServingEngine
    cfg = _dense_cfg()
    eng = ServingEngine(cfg, seed=0, device="cpu", ecfg=EngineConfig(
        max_batch=8, max_len=96, paged=True, num_pages=32,
        cache_dtype="float32", governor="greenllm", use_wall_clock=True,
        mesh=mesh))
    prompts, reqs = _requests(6, cfg.vocab_size, seed=5)
    for p, r in zip(prompts, reqs):
        eng.submit(r, p)
    Server(eng).run()
    mine = (eng.vtime, eng.energy_j, [list(map(int, r.tokens)) for r in reqs])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {"completed": eng.report().completed,
            "ranks_agree": all(x == every[0] for x in every),
            "warmed": len(eng._warmed)}


def _launch_counters():
    """(module, attribute) of every port kernel's launch count."""
    from repro_torch.kernels import (chunk_attention, decode_attention,
                                     decode_attention_q8, flash_attention,
                                     paged_decode_attention, rmsnorm)
    mods = {"rmsnorm": rmsnorm, "decode_attention": decode_attention,
            "decode_attention_q8": decode_attention_q8,
            "flash_attention": flash_attention,
            "paged_decode_attention": paged_decode_attention,
            "chunk_attention": chunk_attention}
    return {f"{name}.{attr}": (mod, attr)
            for name, mod in mods.items() for attr in sorted(vars(mod))
            if attr.endswith("launches")}


def digest(mesh, scenarios=("dense", "moe", "cluster")) -> dict:
    """The JSON digest of ``scenarios`` on ``mesh`` (None: unsharded), as
    ``json`` gives it back (rids as strings), with every kernel's launches
    over these scenarios (CUDA launches only: 0 on the CPU)."""
    counters = _launch_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    out = {"mesh": "none" if mesh is None else ",".join(map(str, mesh))}
    if "dense" in scenarios:
        out["dense"] = run_engine(mesh, _dense_cfg(), cancel=True,
                                  out_len=24)
    if "moe" in scenarios:
        out["moe"] = run_engine(mesh, _moe_cfg())
    if "cluster" in scenarios:
        out["cluster"] = run_cluster(mesh)
    if "roundtrip" in scenarios:
        out["roundtrip"] = run_roundtrip(mesh)
    if "wallclock" in scenarios:
        out["wallclock"] = run_wallclock(mesh)
    out["launches"] = {n: getattr(mod, attr)
                       for n, (mod, attr) in counters.items()}
    return json.loads(json.dumps(out))


def _parse(meshes: str):
    """'8,1/2,4' -> [(8, 1), (2, 4)]."""
    return [tuple(int(v) for v in m.split(",")) for m in meshes.split("/")]


def spawn(meshes: str, scenarios: str = "dense,moe,cluster",
          timeout: float = 600.0) -> dict:
    """Run this file as one gloo rank per point of the meshes ``"dp,tp"``
    ('/'-separated, all of one size: the same ranks serve each in turn)
    and return rank 0's {mesh: digest}.  Each rank runs one torch thread;
    a rank that fails, or a run past ``timeout`` seconds, raises with every
    failed rank's stderr (and the other ranks are stopped)."""
    worlds = {dp * tp for dp, tp in _parse(meshes)}
    assert len(worlds) == 1, f"meshes of different sizes: {meshes}"
    world = worlds.pop()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory(prefix="torch_mesh_") as tmp:
        errs = [os.path.join(tmp, f"rank{r}.err") for r in range(world)]
        procs = []
        for rank in range(world):
            with open(errs[rank], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(ROOT, "tests",
                                                  "torch_mesh_runner.py"),
                     "--mesh", meshes, "--scenarios", scenarios,
                     "--rank", str(rank), "--world", str(world),
                     "--store", os.path.join(tmp, "store")],
                    stdout=subprocess.PIPE if rank == 0
                    else subprocess.DEVNULL,
                    stderr=err, text=True, env=env, cwd=ROOT))
        out = ""
        deadline = time.monotonic() + timeout
        try:
            out, _ = procs[0].communicate(timeout=timeout)
            for p in procs[1:]:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            msgs = []
            for r in failed:
                with open(errs[r]) as err:
                    msgs.append(f"-- rank {r} (rc {procs[r].returncode}):\n"
                                f"{err.read()[-4000:]}")
            raise AssertionError(f"meshes {meshes}: ranks failed:\n"
                                 + "\n".join(msgs))
    return json.loads(out.splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="none",
                    help="'none' (unsharded), 'dp,tp', or meshes of one "
                         "size separated by '/' (served in turn)")
    ap.add_argument("--scenarios", default="dense,moe,cluster")
    ap.add_argument("--rank", type=int, default=None,
                    help="this process's rank (default: torch.distributed."
                         "run's RANK)")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--store", default="",
                    help="FileStore path for the rendezvous (default: "
                         "torch.distributed.run's env://)")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    scenarios = args.scenarios.split(",")
    if args.mesh == "none":
        out = {"none": digest(None, scenarios)}
    else:
        if args.store:
            dist.init_process_group(
                "gloo", init_method=f"file://{args.store}", rank=args.rank,
                world_size=args.world)
        else:
            dist.init_process_group("gloo")
        out = {",".join(map(str, m)): digest(m, scenarios)
               for m in _parse(args.mesh)}
        dist.barrier()
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank != 0:
            return
    json.dump(out, sys.stdout)
    sys.stdout.write("\n")


if __name__ == "__main__":
    main()
