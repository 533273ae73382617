"""Mesh serving in one process: the port's mirror of the in-process half of
``tests/test_mesh_serving.py`` — the degenerate (1,1) mesh on a
world-size-1 gloo group, the config and handoff validation surface — and
the loop closed to the reference: the port's unsharded scenario on the
reference's weights gives the reference runner's digest.  The multi-rank
meshes run in ``tests/test_torch_mesh_ranks_{a,b}.py``."""
import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

from repro_torch.core import Request, SamplingParams
from repro_torch.models.config import ModelConfig
from repro_torch.serving import EngineConfig, Server, ServingEngine


@pytest.fixture(scope="module")
def single_rank():
    from repro_torch.launch.mesh import init_single_rank, shutdown
    init_single_rank("cpu")
    yield
    shutdown()


def _cfg(**kw):
    base = dict(name="tm", arch_type="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                vocab_size=128, dtype="float32", max_seq=512)
    base.update(kw)
    return ModelConfig(**base)


def _trace(mesh):
    cfg = _cfg()
    ecfg = EngineConfig(max_batch=4, max_len=96, paged=True,
                        prefix_cache=True, cache_dtype="float32",
                        governor="defaultnv", mesh=mesh)
    eng = ServingEngine(cfg, ecfg=ecfg, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(6):
        sp = SamplingParams(max_tokens=8, temperature=0.6, seed=50 + i) \
            if i % 2 else SamplingParams(max_tokens=8)
        r = Request(rid=i, arrival=0.0, prompt_len=9 + i, output_len=8,
                    sampling=sp)
        eng.submit(r, rng.integers(1, cfg.vocab_size - 1, size=9 + i))
        reqs.append(r)
    Server(eng).run()
    rep = eng.report()
    return ([list(r.tokens) for r in reqs],
            rep.prefill_energy_j, rep.decode_energy_j, rep.duration_s,
            rep.ttft_pass, rep.tbt_pass, eng._host_drains)


def test_one_by_one_mesh_equals_unsharded(single_rank):
    """mesh=(1,1) must be the identity: same tokens, same energy floats,
    same drain count as mesh=None — in one process, on one gloo rank."""
    assert _trace(None) == _trace((1, 1))


def test_one_by_one_mesh_stores_every_leaf_whole(single_rank):
    """At (1,1) nothing is sharded: each stored tensor is a DTensor whose
    local tensor is the whole tensor (the params the engine was given, not
    a copy), so the gather and the write-back never copy."""
    from torch.distributed.tensor import DTensor
    from repro_torch.training import pytree
    cfg = _cfg()
    params = ServingEngine(cfg, ecfg=EngineConfig(max_len=96),
                           device="cpu").params
    eng = ServingEngine(cfg, params=params, device="cpu",
                        ecfg=EngineConfig(max_len=96, paged=True, mesh=(1, 1)))
    for x, mine in zip(pytree.leaves(params), pytree.leaves(eng.params)):
        assert isinstance(mine, DTensor)
        assert all(p.is_replicate() for p in mine.placements)
        assert mine.to_local().data_ptr() == x.data_ptr()
    for leaf in pytree.leaves(eng.caches) + [eng._tok, eng._keys,
                                             eng._active]:
        assert isinstance(leaf, DTensor) and \
            leaf.to_local().shape == leaf.shape
    g = eng._replicated(table=True)
    assert g["caches"][0][0]["kp"].data_ptr() == \
        eng.caches[0][0]["kp"].to_local().data_ptr()
    assert type(g["table"]) is torch.Tensor


def test_engine_config_rejects_bad_mesh():
    with pytest.raises(ValueError, match="pair"):
        EngineConfig(mesh=(2,))
    with pytest.raises(ValueError, match=">= 1"):
        EngineConfig(mesh=(0, 2))
    with pytest.raises(ValueError, match="max_batch"):
        EngineConfig(mesh=(3, 1), max_batch=8)
    with pytest.raises(ValueError, match="num_pages"):
        EngineConfig(mesh=(2, 1), paged=True, num_pages=7)
    with pytest.raises(ValueError, match="slot-native"):
        EngineConfig(mesh=(1, 1), slot_native=False)
    assert EngineConfig(mesh=[4, "2"]).mesh == (4, 2)  # normalized


def test_engine_rejects_indivisible_model_axes():
    """Model-dependent divisibility fails at construction with an actionable
    ValueError, before any process group is needed: a tp=2 mesh would need
    2 ranks, and this process has at most one."""
    with pytest.raises(ValueError, match="num_heads"):
        ServingEngine(_cfg(num_heads=3, num_kv_heads=3),
                      ecfg=EngineConfig(mesh=(1, 2), max_len=96),
                      device="cpu")
    with pytest.raises(ValueError, match="num_experts"):
        ServingEngine(
            _cfg(arch_type="moe", num_experts=3, experts_per_token=2),
            ecfg=EngineConfig(mesh=(1, 2), max_len=96), device="cpu")
    # divisible axes pass validation and then need their ranks
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        ServingEngine(_cfg(), ecfg=EngineConfig(mesh=(1, 2), max_len=96),
                      device="cpu")


def test_cross_mesh_handoff_rejected(single_rank):
    """An adopter whose mesh shape differs from the exporter's must refuse
    the stream outright — same contract as cfg_name/page_size mismatches."""
    from repro_torch.models import init_params
    cfg = _cfg()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    ecfg = EngineConfig(max_batch=4, max_len=96, paged=True,
                        cache_dtype="float32", governor="defaultnv")
    A = ServingEngine(cfg, params=params, ecfg=ecfg, device="cpu")
    B = ServingEngine(cfg, params=params, device="cpu",
                      ecfg=dataclasses.replace(ecfg, mesh=(1, 1)))
    r = Request(rid=0, arrival=0.0, prompt_len=9, output_len=6)
    A.submit(r, np.arange(1, 10))
    A.step(1)
    slot = next(iter(A.active))
    ho = A.export_stream(slot)
    assert ho.mesh_shape is None
    with pytest.raises(AssertionError, match="cross-mesh handoff"):
        B.import_stream(ho)
    # and the matching shape is accepted: same-mesh adoption still works
    C = ServingEngine(cfg, params=params, ecfg=ecfg, device="cpu")
    assert C.import_stream(ho)
    # a (1,1) exporter hands off to a (1,1) adopter, and the stream decodes
    # on as it would have on the unsharded pair
    D = ServingEngine(cfg, params=params, device="cpu",
                      ecfg=dataclasses.replace(ecfg, mesh=(1, 1)))
    r2 = Request(rid=1, arrival=0.0, prompt_len=9, output_len=6)
    B.submit(r2, np.arange(1, 10))
    B.step(1)
    ho2 = B.export_stream(next(iter(B.active)))
    assert ho2.mesh_shape == (1, 1)
    assert D.import_stream(ho2)
    Server(D).run()
    Server(C).run()
    assert r2.tokens == r.tokens


def test_unsharded_scenario_equals_the_reference():
    """Close the loop: the port's mesh=None dense scenario of
    ``tests/torch_mesh_runner.py``, on the reference's params converted by
    the weight bridge, gives ``tests/mesh_runner.py``'s ``run_engine(None,
    ...)`` digest — tokens, the cancelled rid, report floats, host drains,
    prefix hits and the engine's buckets — exactly."""
    import jax
    import mesh_runner as J
    import torch_mesh_runner as T
    from repro.models import init_params as jinit
    from repro_torch.models import params_from_numpy
    want = J.run_engine(None, J._dense_cfg(), cancel=True, out_len=24)
    jparams = jinit(jax.random.PRNGKey(0), J._dense_cfg())
    got = T.run_engine(None, T._dense_cfg(), cancel=True, out_len=24,
                       params=params_from_numpy(
                           jax.tree.map(np.asarray, jparams), "cpu"))
    assert got["tokens"] == want["tokens"]
    assert got == want
    assert want["report"]["preempted"] > 0 and want["prefix_hits"] > 0
