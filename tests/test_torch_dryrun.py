"""The port's dry-run on fake CPU tensors: every arch's smoke train step
traced on a fake (2,4) mesh under both strategies; qwen2-1.5b's full
config ``train_4k`` on the fake 16x16 production mesh through
``python -m repro_torch.launch.train --dry-run``, its record laid out as
the reference's (``src/repro/launch/dryrun.py``'s ``result``), its model
size and microbatches the reference's, its extrapolated costs equal to a
full-depth trace's; and the kernels' shape-only route taken by fake
tensors alone (the forward shapes' records:
``tests/test_torch_forward_dryrun.py``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _build
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import SHAPES, InputShape

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")
NONE_OR_STR = (type(None), str)
# the reference's record (src/repro/launch/dryrun.py, ``result``): keys,
# nesting and the type of each value, as json gives them back
REF_LAYOUT = {
    "arch": str, "shape": str, "mesh": str, "n_chips": int, "kind": str,
    "meta": {"microbatches": int},
    "variant": {"kv_quant": bool, "strategy": str, "moe_impl": NONE_OR_STR,
                "tag": str},
    "moe_impl": NONE_OR_STR, "lower_s": float, "compile_s": float,
    "memory": {"argument_bytes": int, "output_bytes": int,
               "temp_bytes": int, "alias_bytes": int,
               "peak_bytes_per_device": int},
    "cost": {"flops_per_device": float, "bytes_per_device": float,
             "transcendentals": float},
    "cost_extrapolated": {
        "flops": float, "flops_per_group": float, "flops_base": float,
        "bytes": float, "bytes_per_group": float, "bytes_base": float,
        "coll_bytes": float, "coll_bytes_per_group": int,
        "coll_bytes_base": int},
    "collectives": {**{op: {"count": int, "bytes": int} for op in OPS},
                    "total_bytes": int},
    "model": {"params_total": int, "params_active": int},
}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _check_layout(rec, layout, path=""):
    assert isinstance(rec, dict), path
    assert set(rec) == set(layout), (path, sorted(rec), sorted(layout))
    for k, want in layout.items():
        if isinstance(want, dict):
            _check_layout(rec[k], want, f"{path}.{k}")
        else:
            assert isinstance(rec[k], want), (f"{path}.{k}", rec[k], want)


@pytest.fixture(scope="module", autouse=True)
def cli_run(tmp_path_factory):
    """``python -m repro_torch.launch.train --arch qwen2-1.5b --dry-run
    --device cpu`` (fake CPU tensors, one thread) started in a temporary
    working directory with the module's first test: it runs while the
    other tests do, and the tests of its record come last.  Yields
    (process, directory)."""
    tmp = tmp_path_factory.mktemp("dryrun_cli")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--dry-run", "--device", "cpu"],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def cli_record(cli_run):
    """(the record the dry-run CLI wrote, its stdout)."""
    proc, tmp = cli_run
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out[-4000:]
    path = tmp / "results" / "dryrun" / "manual" / "qwen2-1.5b__train_4k.json"
    with open(path) as f:
        return json.load(f), out


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_step_traces_on_a_fake_mesh(arch, strategy):
    """Each arch's smoke train step on a fake (2,4) mesh of 8 ranks: the
    trace runs, every kernel of the path takes its shape-only route (flash
    forward, its remat recompute and backward where the model attends;
    the norms and their backward where it has RMSNorm), the gradients are
    reduce-scattered to ZeRO-1 / FSDP shards, and nothing is allocated."""
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = get_config(arch).smoke()
    with D.fake_world(8):
        mesh = make_debug_mesh(model=4, data=2, device="cpu")
        built, c, arg, out = D.trace_train(
            cfg, InputShape("t", "train", 32, 8), mesh, strategy, 1)
    calls = c.kernel_calls
    if cfg.has_attention:
        assert calls["flash_attention"] == 2 * calls["flash_attention_bwd"] \
            > 0, calls
    if cfg.norm == "rms":
        assert calls["rmsnorm_bwd"] > 0 and calls["add_rmsnorm"] > 0
    assert c.flops > 0 and c.bytes > 0 and c.peak >= arg > 0 and out > 0
    assert c.coll["reduce-scatter"]["count"] > 0
    assert built["meta"] == {"microbatches": 1}
    assert built["shd"].model_axis == (None if strategy == "fsdp"
                                       else "model")


def test_real_tensors_never_take_the_shape_only_route():
    """On real CPU tensors the training kernels' wrappers compute their
    plain versions and count no fake work; on fake tensors, of either
    device, they return outputs of the kernels' shapes and count it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    g = torch.Generator().manual_seed(0)
    x, dy, d2 = (torch.randn(6, 64, generator=g) for _ in range(3))
    w = torch.rand(64, generator=g) + 0.5
    q = torch.randn(1, 16, 4, 64, generator=g)
    k, v = (torch.randn(1, 16, 2, 64, generator=g) for _ in range(2))

    def calls():
        return (RN.rmsnorm(x, w), RN.add_rmsnorm(x.clone(), d2, w),
                RN.rmsnorm_bwd(x, w, dy, 1e-6, d2),
                FA.flash_attention(q, k, v, return_lse=True),
                FA.flash_attention_bwd(q, k, v, q, torch.zeros(1, 4, 16), q))

    before = json.dumps(_build.fake_work, sort_keys=True)
    got = calls()
    assert json.dumps(_build.fake_work, sort_keys=True) == before
    want = (RN.rmsnorm_plain(x, w), RN.add_rmsnorm_plain(x.clone(), d2, w),
            RN.rmsnorm_bwd_plain(x, w, dy, 1e-6, d2),
            FA.flash_attention_plain(q, k, v, return_lse=True),
            FA.flash_attention_bwd_plain(q, k, v, q, torch.zeros(1, 4, 16),
                                         q))
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    for device in ("cpu", "cuda"):
        n = dict(_build.fake_work["calls"])
        with FakeTensorMode():
            fq = torch.empty(2, 32, 4, 64, device=device)
            fk = torch.empty(2, 32, 2, 64, device=device)
            fx = torch.empty(8, 128, device=device)
            fw = torch.empty(128, device=device)
            out, lse = FA.flash_attention(fq, fk, fk, return_lse=True)
            dq, dk, dv = FA.flash_attention_bwd(fq, fk, fk, out, lse, fq)
            h = RN.rmsnorm(fx, fw)
            s, h2 = RN.add_rmsnorm(fx, fx, fw)
            dx, dw = RN.rmsnorm_bwd(fx, fw, fx)
        assert out.shape == fq.shape and lse.shape == (2, 4, 32)
        assert (dq.shape, dk.shape, dv.shape) == (fq.shape, fk.shape,
                                                  fk.shape)
        assert h.shape == h2.shape == dx.shape == fx.shape and s is fx
        assert dw.shape == (128,) and dw.dtype == torch.float32
        assert all(t.device.type == device for t in (out, dq, h, dx, dw))
        for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                     "add_rmsnorm", "rmsnorm_bwd"):
            assert _build.fake_work["calls"][name] == n.get(name, 0) + 1
    assert RN.launches == RN.add_launches == RN.bwd_launches == 0
    assert FA.lse_launches == FA.bwd_launches == 0


def test_causal_pairs_count_each_visible_key():
    """The shape-only route's pair count (its operations) is the plain
    count of visible (query, key) pairs, with and without a window."""
    for Sq, Sk, window in ((16, 16, 0), (16, 16, 5), (8, 24, 0), (8, 24, 30),
                           (4096, 4096, 4096), (7, 9, 3)):
        want = sum(min(i + Sk - Sq + 1, window) if window
                   else i + Sk - Sq + 1 for i in range(Sq))
        assert _build.causal_pairs(Sq, Sk, window) == want
    assert np.isclose(_build.causal_pairs(4096, 4096), 4096 * 4097 / 2)


def test_extrapolated_costs_equal_a_full_depth_trace(request):
    """``cost_extrapolated`` (depth 2 and 3, one microbatch) equals the
    counts of the full 28-layer step traced with one microbatch: the port
    counts every operator that runs, so the extrapolation is exact."""
    from repro_torch.launch.mesh import make_production_mesh
    with D.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        _, counter, _, _ = D.trace_train(get_config("qwen2-1.5b"),
                                         SHAPES["train_4k"], mesh, "tp", 1)
    full = D._cost_of(counter)
    rec, _ = request.getfixturevalue("cli_record")   # the CLI's, meanwhile
    ext = rec["cost_extrapolated"]
    assert ext["flops"] == full["flops"]
    assert ext["bytes"] == full["bytes"]
    assert ext["coll_bytes"] == full["coll_bytes"]
    assert ext["flops_per_group"] > 0 and ext["coll_bytes_per_group"] > 0


def test_train_cli_dry_run_writes_the_reference_record(cli_record):
    """The record is the reference's: its keys, nesting and value types;
    qwen2-1.5b on the 256-rank 16x16 mesh under ``tp``."""
    rec, out = cli_record
    assert "[dryrun] qwen2-1.5b x train_4k x 16x16" in out
    _check_layout(rec, REF_LAYOUT)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_chips"],
            rec["kind"]) == ("qwen2-1.5b", "train_4k", "16x16", 256, "train")
    assert rec["variant"] == {"kv_quant": False, "strategy": "tp",
                              "moe_impl": None, "tag": ""}
    mem = rec["memory"]
    assert mem["alias_bytes"] == 0 and mem["temp_bytes"] > 0
    assert mem["peak_bytes_per_device"] == mem["argument_bytes"] \
        + mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(coll[op]["bytes"] for op in OPS)
    # the ZeRO-1 gradients are reduce-scattered, the vocabulary's
    # log-sum-exp and the row-parallel products all-reduced
    assert coll["reduce-scatter"]["count"] > 0
    assert coll["all-reduce"]["count"] > 0


def test_record_model_size_and_microbatches_equal_reference(cli_record):
    """``params_total`` / ``params_active`` and ``meta.microbatches`` are
    the reference's for the same config, shape and mesh; this rank holds
    1/16 of the tensor-parallel weights plus the replicated ones, and
    ZeRO-1 shards of m and v (float32), so its arguments are far below the
    whole state's bytes."""
    from repro.configs import get_config as jget
    from repro.launch import specs as JSP
    rec, _ = cli_record
    jcfg = jget("qwen2-1.5b")
    assert rec["model"] == {"params_total": jcfg.param_count(),
                            "params_active": jcfg.param_count(
                                active_only=True)}
    mesh = _FakeMesh({"data": 16, "model": 16})
    assert rec["meta"]["microbatches"] == JSP.microbatches_for(
        jcfg, JSP.SHAPES["train_4k"], mesh) == 16
    whole = jcfg.param_count() * (2 + 4 + 4)
    assert 0 < rec["memory"]["argument_bytes"] < whole / 8
