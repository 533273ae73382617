"""Rank worker (and its spawner) for the port's sharded-training tests.

Each case is one arch's smoke config (float32) trained for ``STEPS`` steps
of ``MICRO`` microbatches on one mesh under one strategy, from weights and
a batch that the test wrote to an ``.npz`` (the reference's init, through
the weight bridge), with AdamW at lr 1e-2, no warmup and eps 1e-5
(``OPT``): each update moves a param by ~1e-2 (a leaf's median change
over the two steps is 3e-3 or more), far above the params' bar of 2e-5,
which the default's first updates (3e-6 and 6e-6) are not.  eps bounds
AdamW's gain on a gradient's rounding, lr / eps where |g| ~ eps: a
partition sums a gradient in another order, and at eps 1e-8 that gain
(1e6) moved a few params by up to 7.5e-4 on (2,4); at 1e-5, by 4.5e-6.  Every rank runs every case of its world
size, a case marked ``repeat`` twice; rank 0 writes each case's metrics,
its gathered params, m and v, whether the two runs were bitwise equal and
whether the state kept its placements, to ``<out>/<case>.npz``.

    PYTHONPATH=src python tests/torch_train_mesh_runner.py --cases C.json \\
        --out DIR --rank R --world N --store FILE

``spawn`` starts the ranks (one process each, a ``FileStore`` under a
temporary directory for the rendezvous) and ``join`` waits for them; one
set of 8 ranks runs the meshes (8,1), (2,4) and (4,2) in turn.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, MICRO, BATCH, SEQ = 2, 2, 16, 32
OPT = dict(lr=1e-2, warmup_steps=0, eps=1e-5)


def case_name(arch, mesh, strategy):
    return f"{arch}__{'none' if mesh is None else 'x'.join(map(str, mesh))}" \
        f"__{strategy}"


# variants of an arch's smoke config: mixtral with 2 experts, which a
# 4-way model axis does not divide (its hidden units split instead), and
# with the scatter dispatch (its experts gathered whole on each rank)
VARIANTS = {"mixtral-8x7b-e2": ("mixtral-8x7b", dict(num_experts=2)),
            "mixtral-8x7b-scatter": ("mixtral-8x7b",
                                     dict(moe_impl="scatter")),
            "qwen2-1.5b-q8": ("qwen2-1.5b", dict(kv_quant=True))}


def smoke_cfg(arch, get_config=None):
    """``arch``'s smoke config (or a ``VARIANTS`` entry's) in float32, from
    ``get_config`` (default: the port's registry)."""
    if get_config is None:
        from repro_torch.configs import get_config
    base, kw = VARIANTS.get(arch, (arch, {}))
    return get_config(base).smoke().replace(dtype="float32", **kw)


def load_inputs(path, cfg):
    """(params, batch) as full CPU tensors from the test's ``.npz``: the
    param leaves in flatten order, then the batch."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import param_shapes
    from repro_torch.training import pytree
    data = np.load(path)
    shapes = param_shapes(cfg)
    flat = [torch.from_numpy(data[f"p{i}"].copy())
            for i in range(len(pytree.leaves(shapes)))]
    batch = {"tokens": torch.from_numpy(data["tokens"].copy())}
    if "prefix_embeds" in data:
        batch["prefix_embeds"] = torch.from_numpy(data["prefix_embeds"].copy())
    return pytree.unflatten(shapes, flat), batch


def run_case(arch, mesh, strategy, inputs):
    """Train ``STEPS`` steps; returns (per-step metrics, final state with
    every leaf whole, whether each stored leaf kept the placement of its
    spec).  ``mesh`` None: the unsharded step."""
    import torch
    from repro_torch.launch.specs import InputShape, build_train
    from repro_torch.models.sharding import placements
    from repro_torch.training import AdamWConfig, init_opt_state, pytree
    from repro_torch.training import make_train_step
    cfg = smoke_cfg(arch)
    params, batch = load_inputs(inputs, cfg)
    state = {"params": params, "opt": init_opt_state(params)}
    opt = AdamWConfig(**OPT)
    if mesh is None:
        step, args = make_train_step(cfg, opt, MICRO), (state, batch)
    else:
        from repro_torch.launch.mesh import make_debug_mesh
        dm = make_debug_mesh(model=mesh[1], data=mesh[0], device="cpu")
        built = build_train(cfg, InputShape("t", "train", SEQ, BATCH), dm,
                            num_microbatches=MICRO, strategy=strategy,
                            state=state, batch=batch, opt_cfg=opt)
        step, args = built["fn"], built["args"]
    st, b = args
    metrics = []
    for _ in range(STEPS):
        st, m = step(st, b)
        metrics.append({k: float(v) for k, v in m.items()})
    kept = True
    if mesh is not None:
        specs = built["specs"][0]
        for part, sp in (("params", specs["params"]),
                         ("m", specs["opt"]["m"]), ("v", specs["opt"]["v"])):
            tree = st["params"] if part == "params" else st["opt"][part]
            for x, s in zip(pytree.leaves(tree), pytree.leaves(sp)):
                kept &= tuple(x.placements) == tuple(placements(s, dm))
    whole = {part: [x.full_tensor() if hasattr(x, "full_tensor") else x
                    for x in pytree.leaves(tree)]
             for part, tree in (("params", st["params"]),
                                ("m", st["opt"]["m"]), ("v", st["opt"]["v"]))}
    return metrics, whole, kept


# the forwards: a prefill of FWD_B prompts of FWD_S tokens, then FWD_STEPS
# greedy decode steps, into caches of FWD_S + FWD_STEPS slots
FWD_B, FWD_S, FWD_STEPS = 8, 16, 4


def forward_tokens(cfg):
    """The forwards' prompts (FWD_B, FWD_S), seeded."""
    import numpy as np
    import torch
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (FWD_B, FWD_S))
                            .astype(np.int32))


def run_forward(arch, mesh, inputs):
    """Prefill, then FWD_STEPS greedy decode steps, each fed its own
    argmax; ``mesh`` None: the unsharded model, else params and caches
    placed by ``model_param_specs`` / ``cache_specs`` and the steps run
    with the mesh's ``ShardCtx`` (``kv_seq_sharded`` where the kv heads do
    not divide 'model', as ``build_decode`` sets it).  Returns (the
    logits of each step, whole; the tokens; the calls of the
    sequence-sharded decode; whether every cache leaf kept its
    placement)."""
    import dataclasses
    import torch
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import NOSHARD, P, placements
    from repro_torch.training import pytree
    cfg = smoke_cfg(arch)
    params, _ = load_inputs(inputs, cfg)
    tok = forward_tokens(cfg)
    L = FWD_S + FWD_STEPS
    caches = init_cache(cfg, FWD_B, L, dtype=torch.float32, device="cpu")
    shd, kept = NOSHARD, True
    if mesh is not None:
        from repro_torch.launch import shardings as SH
        from repro_torch.launch import specs as SP
        from repro_torch.launch.mesh import make_debug_mesh
        dm = make_debug_mesh(model=mesh[1], data=mesh[0], device="cpu")
        shd = dataclasses.replace(
            SH.make_shard_ctx(dm, FWD_B), kv_seq_sharded=cfg.has_attention
            and cfg.num_kv_heads % mesh[1] != 0)
        cspecs, _ = SH.cache_specs(cfg, dm, FWD_B, L)
        params = SP._place_tree(params, SH.model_param_specs(cfg, dm)[0], dm)
        caches = SP._place_tree(caches, cspecs, dm)
        b = SH.batch_axes_for(dm, FWD_B)
        tok = SP.placed(tok, SH.sanitize_spec(P(b if b else None, None),
                                              tok.shape, dm), dm)
    T.seq_sharded_calls = 0
    logits, toks = [], []
    lg, caches, _ = prefill(params, cfg, tok, caches, shd=shd)
    for i in range(FWD_STEPS + 1):
        lg = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
        logits.append(lg.detach().clone())
        nxt = lg.argmax(dim=-1).to(torch.int32)[:, None]
        toks.append(nxt[:, 0].clone())
        if i < FWD_STEPS:
            lg, caches = decode_step(params, cfg, nxt, caches, FWD_S + i,
                                     shd=shd)
    if mesh is not None:
        for x, s in zip(pytree.leaves(caches), pytree.leaves(cspecs)):
            kept &= tuple(x.placements) == tuple(placements(s, dm))
    return logits, toks, T.seq_sharded_calls, kept


def forward_name(arch, mesh):
    return "fwd__" + case_name(arch, mesh, "tp")


def save_forward(path, logits, toks, calls, kept):
    import numpy as np
    np.savez(path, calls=calls, kept=kept,
             **{f"logits{i}": x.numpy() for i, x in enumerate(logits)},
             **{f"toks{i}": x.numpy() for i, x in enumerate(toks)})


def load_forward(path):
    """(logits, tokens, seq-sharded calls, kept) as ``save_forward`` wrote
    them."""
    import numpy as np
    d = np.load(path)
    n = sum(k.startswith("logits") for k in d.files)
    return ([d[f"logits{i}"] for i in range(n)],
            [d[f"toks{i}"] for i in range(n)], int(d["calls"]),
            bool(d["kept"]))


def save_case(path, metrics, whole, kept, bitwise):
    import numpy as np
    arrs = {f"{part}{i}": x.detach().numpy()
            for part, xs in whole.items() for i, x in enumerate(xs)}
    np.savez(path, metrics=json.dumps(metrics), kept=kept, bitwise=bitwise,
             **arrs)


def run_cases(cases, out):
    """Every case (a ``repeat`` case twice); rank 0 (or the only process)
    saves each."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    for c in cases:
        mesh = None if c["mesh"] is None else tuple(c["mesh"])
        if c.get("kind") == "forward":
            logits, toks, calls, kept = run_forward(c["arch"], mesh,
                                                    c["inputs"])
            if rank == 0:
                save_forward(os.path.join(out, forward_name(c["arch"], mesh)
                                          + ".npz"), logits, toks, calls,
                             kept)
            continue
        m1, w1, kept = run_case(c["arch"], mesh, c["strategy"], c["inputs"])
        bitwise = -1                    # not repeated
        if c.get("repeat"):
            m2, w2, _ = run_case(c["arch"], mesh, c["strategy"],
                                 c["inputs"])
            bitwise = int(m1 == m2 and all(
                torch.equal(a, b) for part in w1
                for a, b in zip(w1[part], w2[part])))
        if rank == 0:
            save_case(os.path.join(out, case_name(c["arch"], mesh,
                                                  c["strategy"]) + ".npz"),
                      m1, w1, kept, bitwise)


def spawn(cases, out, world: int):
    """Start ``cases`` (all on meshes of ``world`` ranks) as ``world`` gloo
    ranks of this file, writing into ``out``; returns the handle that
    ``join`` waits on, so the caller can work meanwhile."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    tmp = tempfile.mkdtemp(prefix="torch_train_mesh_")
    cpath = os.path.join(tmp, "cases.json")
    with open(cpath, "w") as f:
        json.dump(cases, f)
    errs = [os.path.join(tmp, f"rank{r}.err") for r in range(world)]
    procs = []
    for rank in range(world):
        with open(errs[rank], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests",
                                              "torch_train_mesh_runner.py"),
                 "--cases", cpath, "--out", out, "--rank", str(rank),
                 "--world", str(world),
                 "--store", os.path.join(tmp, "store")],
                stdout=subprocess.DEVNULL, stderr=err, env=env, cwd=ROOT))
    return tmp, errs, procs


def join(handle, timeout: float = 900.0) -> None:
    """Wait for ``spawn``'s ranks; a rank that fails, or a run past
    ``timeout`` seconds, raises with every failed rank's stderr (the
    others are stopped)."""
    tmp, errs, procs = handle
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    msgs = []
    for r in failed:
        with open(errs[r]) as err:
            msgs.append(f"-- rank {r} (rc {procs[r].returncode}):\n"
                        f"{err.read()[-6000:]}")
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise AssertionError("sharded training ranks failed:\n"
                             + "\n".join(msgs))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(args.cases) as f:
        cases = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.world)
    try:
        run_cases(cases, args.out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
