"""Sharded training, and the tensor-parallel forwards, on gloo CPU ranks
against the unsharded model: the
smoke configs of qwen2-1.5b, gemma2-9b (FSDP, as the reference's lowering
test), mixtral-8x7b (experts over 'model'; with 2 experts, its hidden
units; with the scatter dispatch, experts gathered) and mamba2-370m (the SSM's channels over 'model'), float32, from the reference's init through the
weight bridge, 2 steps of 2 microbatches under ``tp`` and ``fsdp`` on the
meshes (1,1), (8,1), (2,4) and (4,2).

A partition changes the order of sums, so a sharded step equals the
unsharded one within ``tests/test_training.py``'s bars, not bitwise; the
same mesh run twice is bitwise; and at (1,1) every spec sanitizes to
replicated, so the step is the unsharded one, bit for bit.  One set of 8
rank processes (``tests/torch_train_mesh_runner.py``) runs the three
8-rank meshes in turn; (1,1) runs in this process on a world-size-1 gloo
group.

The forwards (``prefill`` then greedy ``decode_step``s with the mesh's
``ShardCtx``, params and caches placed by ``model_param_specs`` and
``cache_specs``) run in the same spawn: qwen2-1.5b (at (2,4) its 2 kv
heads do not divide 'model', so its decode is the sequence-sharded one;
at (4,2) the head split), gemma2-9b (local and full layers), mixtral-8x7b
(experts), mamba2-370m (the SSM state split over 'model') and qwen2-1.5b
with int8 K/V.  Their logits equal the unsharded model's within
``FWD_TOL`` with the same greedy tokens; at (1,1) bit for bit."""
import json
import os

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

import torch_train_mesh_runner as R

CASES = [("qwen2-1.5b", "tp"), ("qwen2-1.5b", "fsdp"), ("gemma2-9b", "fsdp"),
         ("mixtral-8x7b", "tp"), ("mixtral-8x7b", "fsdp"),
         ("mamba2-370m", "tp"), ("mamba2-370m", "fsdp")]
# on (2,4) only: mixtral-8x7b-e2 (2 experts), whose MoE FFN splits its
# hidden units there (4 model ranks do not divide its experts), and
# mixtral-8x7b-scatter, the scatter dispatch (the same on every mesh)
MORE = [("mixtral-8x7b-e2", "tp"), ("mixtral-8x7b-scatter", "tp")]
ARCHS = sorted({a for a, _ in CASES + MORE})
MESHES = [(8, 1), (2, 4), (4, 2)]
FWD_ARCHS = ["qwen2-1.5b", "gemma2-9b", "mixtral-8x7b", "mamba2-370m",
             "qwen2-1.5b-q8"]
# the logits' bar: the params bar of tests/test_training.py.  With int8
# K/V a value that a partition's rounding moves across the quantizer's
# rounding boundary moves by a whole int8 step (amax / 127); at (4,2) that
# moved qwen2's logits by 1.2e-4, so the int8 caches' bar is 1e-3
FWD_TOL = {"qwen2-1.5b-q8": 1e-3}


def _cases(mesh):
    return CASES + MORE if mesh == (2, 4) else CASES


def _write_inputs(arch, path):
    """The reference's init of ``arch``'s float32 smoke config, as the
    port's leaves (``params_from_numpy``), and a seeded batch."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    from repro_torch.models import params_from_numpy
    from repro_torch.training import pytree
    jcfg = R.smoke_cfg(arch, jget)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg)), "cpu")
    data = {f"p{i}": x.numpy() for i, x in enumerate(pytree.leaves(params))}
    rng = np.random.default_rng(7)
    data["tokens"] = rng.integers(0, jcfg.vocab_size,
                                  (R.BATCH, R.SEQ)).astype(np.int32)
    if jcfg.num_prefix_embeds:
        data["prefix_embeds"] = rng.standard_normal(
            (R.BATCH, jcfg.num_prefix_embeds, jcfg.d_model)).astype(np.float32)
    np.savez(path, **data)


def _load(path):
    d = np.load(path)
    whole = {part: [d[f"{part}{i}"] for i in range(
        sum(k.startswith(part) and k[len(part):].isdigit() for k in d.files))]
        for part in ("params", "m", "v")}
    return json.loads(str(d["metrics"])), whole, bool(d["kept"]), \
        int(d["bitwise"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(mesh, arch, strategy): (metrics, whole state, kept, bitwise)}:
    the unsharded step and (1,1) in this process, the 8-rank meshes from
    one spawn."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    inputs = {a: str(tmp / f"{a}.npz") for a in ARCHS}
    for a, path in inputs.items():
        _write_inputs(a, path)
    inputs["qwen2-1.5b-q8"] = inputs["qwen2-1.5b"]   # the same params
    # the 8 ranks run while this process runs mesh=None and (1,1)
    ranks = R.spawn([dict(arch=a, mesh=list(mesh), strategy=s,
                          inputs=inputs[a], repeat=(a, s) == CASES[0])
                     for mesh in MESHES for a, s in _cases(mesh)]
                    + [dict(kind="forward", arch=a, mesh=list(mesh),
                            inputs=inputs[a])
                       for mesh in MESHES for a in FWD_ARCHS],
                    str(tmp), 8)
    out = {}
    try:
        for a in ARCHS:
            m, w, _ = R.run_case(a, None, "tp", inputs[a])
            out[None, a, None] = (m, {k: [x.numpy() for x in v]
                                      for k, v in w.items()}, True, -1)
        for a in FWD_ARCHS:
            out["fwd", None, a] = _numpy_fwd(R.run_forward(a, None,
                                                           inputs[a]))
        from repro_torch.launch.mesh import init_single_rank, shutdown
        init_single_rank("cpu")
        try:
            for a, s in CASES + MORE:
                m, w, kept = R.run_case(a, (1, 1), s, inputs[a])
                out[(1, 1), a, s] = (m, {k: [x.numpy() for x in v]
                                         for k, v in w.items()}, kept, -1)
            for a in FWD_ARCHS:
                out["fwd", (1, 1), a] = _numpy_fwd(
                    R.run_forward(a, (1, 1), inputs[a]))
        finally:
            shutdown()
    finally:
        R.join(ranks)
    for mesh in MESHES:
        for a, s in _cases(mesh):
            out[mesh, a, s] = _load(str(tmp / (R.case_name(a, mesh, s)
                                               + ".npz")))
        for a in FWD_ARCHS:
            out["fwd", mesh, a] = R.load_forward(
                str(tmp / (R.forward_name(a, mesh) + ".npz")))
    return out


def _numpy_fwd(run):
    logits, toks, calls, kept = run
    return ([x.numpy() for x in logits], [x.numpy() for x in toks], calls,
            kept)


@pytest.mark.parametrize("mesh,arch,strategy",
                         [(m, a, s) for m in MESHES for a, s in _cases(m)],
                         ids=lambda v: f"{v[0]}x{v[1]}"
                         if isinstance(v, tuple) else v)
def test_sharded_step_matches_unsharded(runs, mesh, arch, strategy):
    """Loss and grad_norm of both steps, and every leaf of params, m and v
    after them, equal the unsharded step's within tests/test_training.py's
    bars (params 2e-5; m and v, which hold the gradients, as tightly)."""
    base_m, base_w, _, _ = runs[None, arch, None]
    got_m, got_w, _, _ = runs[mesh, arch, strategy]
    for b, g in zip(base_m, got_m):
        assert g["loss"] == pytest.approx(b["loss"], abs=2e-5)
        assert g["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
        assert g["lr"] == b["lr"]
    for part, atol in (("params", 2e-5), ("m", 2e-6), ("v", 1e-7)):
        assert len(got_w[part]) == len(base_w[part])
        for i, (b, g) in enumerate(zip(base_w[part], got_w[part])):
            np.testing.assert_allclose(g, b, atol=atol, rtol=1e-5,
                                       err_msg=f"{part} leaf {i}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_state_keeps_its_placements(runs, mesh):
    """After the steps every param is placed by its spec (param_specs or
    fsdp_param_specs), and m and v by ZeRO-1's (opt_state_specs)."""
    for a, s in _cases(mesh):
        assert runs[mesh, a, s][2], (a, s)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_same_mesh_twice_is_bitwise(runs, mesh):
    """The first case, run twice on the same mesh: metrics, params, m and
    v bit for bit."""
    a, s = CASES[0]
    assert runs[mesh, a, s][3] == 1


@pytest.mark.parametrize("arch,strategy", CASES + MORE)
def test_one_by_one_mesh_is_unsharded_bitwise(runs, arch, strategy):
    """(1,1): every spec sanitizes to replicated, so the step is the
    unsharded step bit for bit, metrics and state."""
    base_m, base_w, _, _ = runs[None, arch, None]
    got_m, got_w, kept, _ = runs[(1, 1), arch, strategy]
    assert kept
    assert got_m == base_m
    for part in base_w:
        for b, g in zip(base_w[part], got_w[part]):
            assert np.array_equal(b, g), part


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES
                                       for a in FWD_ARCHS],
                         ids=lambda v: f"{v[0]}x{v[1]}"
                         if isinstance(v, tuple) else v)
def test_sharded_forward_matches_unsharded(runs, mesh, arch):
    """The prefill's and every decode step's logits within ``FWD_TOL``
    (2e-5) of the unsharded model's, the same greedy tokens, and every
    cache leaf still placed by ``cache_specs``."""
    base_lg, base_tok, _, _ = runs["fwd", None, arch]
    lg, tok, _, kept = runs["fwd", mesh, arch]
    assert kept
    tol = FWD_TOL.get(arch, 2e-5)
    assert len(lg) == len(base_lg) == R.FWD_STEPS + 1
    for i, (a, b) in enumerate(zip(lg, base_lg)):
        np.testing.assert_allclose(a, b, atol=tol, rtol=1e-5,
                                   err_msg=f"step {i}")
    for a, b in zip(tok, base_tok):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", FWD_ARCHS)
def test_forward_one_by_one_mesh_is_unsharded_bitwise(runs, arch):
    """(1,1): every spec sanitizes to replicated, so the forwards are the
    unsharded model's bit for bit, logits and tokens."""
    base_lg, base_tok, _, _ = runs["fwd", None, arch]
    lg, tok, calls, kept = runs["fwd", (1, 1), arch]
    assert kept and calls == 0
    for a, b in zip(lg + tok, base_lg + base_tok):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sequence_sharded_decode_route(runs, mesh):
    """The decode runs the sequence-sharded route, once per attention
    layer and step, where the kv heads do not divide 'model': qwen2's 2
    at (2,4), dense and int8; nowhere else (the head split at (4,2), no
    model axis at (8,1), 4 kv heads on 4 ranks, no attention)."""
    from repro_torch.configs import get_config
    for arch in FWD_ARCHS:
        calls = runs["fwd", mesh, arch][2]
        cfg = R.smoke_cfg(arch, get_config)
        want = R.FWD_STEPS * cfg.num_layers if cfg.has_attention and \
            cfg.num_kv_heads % mesh[1] else 0
        assert calls == want, (arch, calls, want)
    if mesh == (2, 4):
        assert runs["fwd", mesh, "qwen2-1.5b"][2] > 0

