"""The forward dry-run on fake CPU tensors: every arch's smoke prefill and
decode steps (and a batch-1 decode, ``long_500k``'s layout) traced on a
fake (2,4) mesh; qwen2-1.5b's full-config ``decode_32k`` and ``long_500k``
records through ``python -m repro_torch.launch.dryrun_all --device cpu``
(each combo a ``launch.dryrun`` CLI process), laid out as the reference's
records, with its model size and ``meta``, the caches' bytes aliased as
the reference's donated caches are, and extrapolated costs equal to a
full-depth trace's; and ``dryrun_all`` skipping what it has written."""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import SHAPES, InputShape, needs_ring_override
from test_torch_dryrun import REF_LAYOUT, _check_layout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = ("decode_32k", "long_500k")
# the smoke steps: a prefill and a decode of batch 8 (split over 'data'),
# and a decode of batch 1 (its slots over ('data', 'model'))
SMOKE = {"prefill": InputShape("prefill_s", "prefill", 32, 8),
         "decode": InputShape("decode_s", "decode", 32, 8),
         "long": InputShape("long_500k", "decode", 64, 1)}


@pytest.fixture(scope="module", autouse=True)
def dryrun_all(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun_all --mesh single --archs
    qwen2-1.5b --shapes decode_32k,long_500k --device cpu`` in a temporary
    working directory, started with the module's first test (it runs
    while the others do).  Yields (process, directory)."""
    tmp = tmp_path_factory.mktemp("dryrun_all")
    proc = subprocess.Popen(_cmd(), cwd=tmp, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _cmd():
    return [sys.executable, "-m", "repro_torch.launch.dryrun_all", "--mesh",
            "single", "--archs", "qwen2-1.5b", "--shapes", ",".join(RECORDS),
            "--device", "cpu"]


@pytest.fixture(scope="module")
def records(dryrun_all):
    """({shape: the record}, ``dryrun_all``'s stdout, its directory)."""
    proc, tmp = dryrun_all
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]
    recs = {}
    for shape in RECORDS:
        with open(tmp / "results" / "dryrun" / "16x16"
                  / f"qwen2-1.5b__{shape}.json") as f:
            recs[shape] = json.load(f)
    return recs, out, tmp


def _cache_bytes(caches):
    return sum(x.to_local().numel() * x.to_local().element_size()
               for x in torch.utils._pytree.tree_leaves(caches))


@pytest.mark.parametrize("kind", list(SMOKE))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_traces_on_a_fake_mesh(arch, kind):
    """Each arch's smoke forward step on a fake (2,4) mesh of 8 ranks: the
    trace runs, every kernel of the path takes its shape-only route (flash
    in prefill; in decode the decode kernel, or its span-partial and
    combine routes where the cache splits its slots), the caches are
    aliased (written in place), and nothing is allocated."""
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = get_config(arch).smoke()
    shape = SMOKE[kind]
    with D.fake_world(8):
        mesh = make_debug_mesh(model=4, data=2, device="cpu")
        built, c, arg, out, alias = D.trace_forward(cfg, shape, mesh)
        cache_bytes = _cache_bytes(built["args"][1])
    calls = {k: v for k, v in c.kernel_calls.items() if v}
    n_attn = sum(k in ("full", "local") for k in cfg.layer_kinds)
    seq = shape.global_batch == 1 or built["shd"].kv_seq_sharded
    if kind == "prefill":
        want = {"flash_attention": n_attn} if n_attn else {}
        assert built["meta"] == {}
    elif seq:
        want = {"decode_attention/partials": n_attn,
                "decode_attention/combine": n_attn} if n_attn else {}
    else:
        want = {"decode_attention": n_attn} if n_attn else {}
    assert {k: v for k, v in calls.items() if "attention" in k} == want
    if kind != "prefill":
        assert built["meta"] == {"long_context": kind == "long"
                                 and needs_ring_override(cfg)}
    assert built["shd"].kv_seq_sharded == (
        kind != "prefill" and cfg.has_attention and cfg.num_kv_heads % 4 != 0)
    assert c.flops > 0 and c.bytes > 0 and c.peak >= arg > 0
    assert 0 < alias == cache_bytes < out


def test_cli_records_are_the_reference_layout(records):
    """The records' keys, nesting and value types are the reference's
    (``meta`` a forward step's), qwen2-1.5b on the 256-rank 16x16 mesh;
    ``dryrun_all`` printed each combo's ``[dryrun]`` line."""
    recs, out, _ = records
    layout = dict(REF_LAYOUT, meta={"long_context": bool})
    for shape, rec in recs.items():
        assert f"[dryrun] qwen2-1.5b x {shape} x 16x16" in out
        _check_layout(rec, layout)
        assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_chips"],
                rec["kind"]) == ("qwen2-1.5b", shape, "16x16", 256, "decode")
        assert rec["variant"] == {"kv_quant": False, "strategy": "tp",
                                  "moe_impl": None, "tag": ""}


def test_records_model_size_meta_and_memory(records):
    """``params_total`` / ``params_active`` and ``meta`` are the
    reference's for the same config and shape; the caches are aliased
    (their local bytes counted in the arguments and outputs, once in the
    peak), and ``decode_32k``'s cache shard (8 rows, 2048 of 32768 slots)
    is the bulk of the aliased bytes; the sequence-sharded decode gathers
    its partials (all-gathers) and the row-parallel products all-reduce."""
    from repro.configs import get_config as jget
    from repro.launch import specs as JSP
    recs, _, _ = records
    jcfg = jget("qwen2-1.5b")
    for shape, rec in recs.items():
        assert rec["model"] == {"params_total": jcfg.param_count(),
                                "params_active": jcfg.param_count(
                                    active_only=True)}
        assert rec["meta"] == {"long_context": shape == "long_500k"
                               and JSP.needs_ring_override(jcfg)}
        mem = rec["memory"]
        assert 0 < mem["alias_bytes"] < mem["output_bytes"]
        assert mem["alias_bytes"] < mem["argument_bytes"]
        assert mem["peak_bytes_per_device"] == mem["argument_bytes"] \
            + mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
        coll = rec["collectives"]
        assert coll["all-gather"]["count"] > 0
        assert coll["all-reduce"]["count"] > 0
    cfg = get_config("qwen2-1.5b")
    kv = cfg.num_layers * 2 * 8 * 2048 * cfg.num_kv_heads * cfg.head_dim * 2
    assert recs["decode_32k"]["memory"]["alias_bytes"] == kv


def test_extrapolated_costs_equal_a_full_depth_trace(records):
    """``cost_extrapolated`` (depth 2 and 3) of ``decode_32k`` equals the
    counts of the full 28-layer step traced here: the port counts every
    operator that runs, so the extrapolation is exact."""
    from repro_torch.launch.mesh import make_production_mesh
    with D.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        counter = D.trace_forward(get_config("qwen2-1.5b"),
                                  SHAPES["decode_32k"], mesh)[1]
    full = D._cost_of(counter)
    ext = records[0]["decode_32k"]["cost_extrapolated"]
    assert ext["flops"] == full["flops"]
    assert ext["bytes"] == full["bytes"]
    assert ext["coll_bytes"] == full["coll_bytes"]
    assert ext["flops_per_group"] > 0 and ext["coll_bytes_per_group"] > 0


def test_dryrun_all_skips_written_records(records):
    """A second call of ``dryrun_all`` skips both records (and writes
    nothing)."""
    _, _, tmp = records
    r = subprocess.run(_cmd(), cwd=tmp, env=_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:]
    for shape in RECORDS:
        assert f"[skip] results/dryrun/16x16/qwen2-1.5b__{shape}.json" \
            in r.stdout
    assert "[run ]" not in r.stdout and "0 failures" in r.stdout
