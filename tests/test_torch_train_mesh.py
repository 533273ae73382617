"""Sharded training on gloo CPU ranks against the unsharded step: the
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
group."""
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
    # the 8 ranks run while this process runs mesh=None and (1,1)
    ranks = R.spawn([dict(arch=a, mesh=list(mesh), strategy=s,
                          inputs=inputs[a], repeat=(a, s) == CASES[0])
                     for mesh in MESHES for a, s in _cases(mesh)],
                    str(tmp), 8)
    out = {}
    try:
        for a in ARCHS:
            m, w, _ = R.run_case(a, None, "tp", inputs[a])
            out[None, a, None] = (m, {k: [x.numpy() for x in v]
                                      for k, v in w.items()}, True, -1)
        from repro_torch.launch.mesh import init_single_rank, shutdown
        init_single_rank("cpu")
        try:
            for a, s in CASES + MORE:
                m, w, kept = R.run_case(a, (1, 1), s, inputs[a])
                out[(1, 1), a, s] = (m, {k: [x.numpy() for x in v]
                                         for k, v in w.items()}, kept, -1)
        finally:
            shutdown()
    finally:
        R.join(ranks)
    for mesh in MESHES:
        for a, s in _cases(mesh):
            out[mesh, a, s] = _load(str(tmp / (R.case_name(a, mesh, s)
                                               + ".npz")))
    return out


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
