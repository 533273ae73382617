"""The forward steps' specs and meta against the reference's, in one
process with no ranks: for every ``ARCH_IDS`` full config, every forward
shape (``prefill_32k``, ``decode_32k``, ``long_500k``) and both production
meshes, ``launch.specs.forward_specs`` (what ``build_prefill`` /
``build_decode`` place by) against the reference's ``build_prefill`` /
``build_decode`` on the shape-only fake mesh of ``tests/test_shardings.py``:
the batch's specs, the output specs (the logits P(b, model), the next
token P(b, None), the caches), the ``kv_seq_sharded`` flag of the decode's
``ShardCtx`` and ``meta``; and ``serving_decode_specs`` (what
``build_serving_decode`` places by) against the reference's
``build_serving_decode`` at (1,1) and (2,4).  The reference's build
functions run with ``named`` returning the spec trees and their param
specs stubbed (``tests/test_torch_train_specs.py`` holds those leaf for
leaf)."""
import pytest
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shardings as SH
from repro_torch.launch import specs as SP
from test_torch_train_specs import _FakeMesh, _port, _ref, _shapes

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
FORWARD = [n for n, s in SP.SHAPES.items() if s.kind != "train"]


def _ref_build(build, *args, **kw):
    """A reference build function's result, ``named`` giving the spec
    trees and the param specs stubbed out."""
    from unittest import mock
    from repro.launch import shardings as JSH
    with mock.patch.object(JSH, "named", lambda mesh, tree: tree), \
            mock.patch.object(JSH, "model_param_specs",
                              lambda cfg, mesh: (None, None)), \
            mock.patch.object(JSH, "serving_param_specs",
                              lambda cfg, mesh: (None, None)):
        return build(*args, **kw)


def _closure_shd(fn):
    from repro.models import ShardCtx as JShardCtx
    cells = [c.cell_contents for c in fn.__closure__ or ()]
    return next(c for c in cells if isinstance(c, JShardCtx))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_specs_equal_reference(arch, mesh):
    """Batch specs, output specs, caches' specs and shapes, the
    ``kv_seq_sharded`` flag, the batch axes and ``meta``, for each
    forward shape."""
    from repro.configs import get_config as jget
    from repro.launch import specs as JSP
    fm = _FakeMesh(MESHES[mesh])
    cfg, jcfg = get_config(arch), jget(arch)
    for name in FORWARD:
        shape, jshape = SP.SHAPES[name], JSP.SHAPES[name]
        ref = _ref_build(JSP.build_step, jcfg, jshape, fm)
        got = SP.forward_specs(cfg, shape, fm)
        _, jcspecs, jbspecs = ref["in_shardings"]
        jout, jcout = ref["out_shardings"]
        bspecs, batch = got["batch"]
        cspecs, cshapes = got["caches"]
        assert _port(bspecs) == _ref(jbspecs), name
        assert _port({"out": got["out"][0]}) == _ref({"out": jout}), name
        assert _port(got["out"][1]) == _ref(jcout) == _ref(jcspecs), name
        assert _port(cspecs) == _ref(jcspecs), name
        assert _shapes(cshapes) == _shapes(ref["args"][1]), name
        assert {k: tuple(v.shape) for k, v in batch.items()} == \
            {k: tuple(v.shape) for k, v in ref["args"][2].items()}, name
        assert got["meta"] == ref["meta"], name
        if shape.kind == "decode":
            jshd = _closure_shd(ref["fn"])
            assert got["kv_seq_sharded"] == jshd.kv_seq_sharded, name
            assert tuple(SH.make_shard_ctx(fm, shape.global_batch)
                         .batch_axes) == tuple(jshd.batch_axes), name


@pytest.mark.parametrize("mesh", [{"data": 1, "model": 1},
                                  {"data": 2, "model": 4}],
                         ids=["1x1", "2x4"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b",
                                  "recurrentgemma-9b"])
def test_serving_decode_specs_equal_reference(arch, mesh):
    """``serving_decode_specs`` (``build_serving_decode``'s): the paged
    caches' specs and shapes, the slot vectors' and page table's specs,
    the next token's and ``meta`` (pool pages, capacity axis) equal the
    reference's ``build_serving_decode``'s."""
    from repro.configs import get_config as jget
    from repro.launch import specs as JSP
    fm = _FakeMesh(mesh)
    kw = dict(max_batch=8, max_len=256, page_size=16)
    ref = _ref_build(JSP.build_serving_decode, jget(arch), fm, **kw)
    got = SP.serving_decode_specs(get_config(arch), fm, **kw)
    _, jcspecs, jbspecs = ref["in_shardings"]
    jrow, jcout = ref["out_shardings"]
    cspecs, cshapes = got["caches"]
    assert got["meta"] == ref["meta"]
    assert _port(cspecs) == _ref(jcspecs) == _ref(jcout)
    assert _shapes(cshapes) == _shapes(ref["args"][1])
    assert _port(got["batch"][0]) == _ref(jbspecs)
    assert _port({"out": got["out"][0]}) == _ref({"out": jrow})
