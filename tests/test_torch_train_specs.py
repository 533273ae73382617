"""The port's training and dry-run sharding rules against the reference's,
in one process with no ranks: ``param_specs``, ``model_param_specs``,
``fsdp_param_specs``, ``zero1_specs``, ``opt_state_specs`` and
``cache_specs`` for every ``ARCH_IDS`` full config on the production
meshes (16x16, 2x16x16) and on (2,4) and (4,2), leaf for leaf, and
``batch_axes_for`` / ``microbatches_for`` for every ``SHAPES`` entry.  The
specs are pure functions of the config and the mesh's axis sizes, so the
reference tests' shape-only fake mesh (``tests/test_shardings.py``) drives
both packages."""
import pytest
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shardings as SH
from repro_torch.launch import specs as SP
from repro_torch.models.sharding import P, ShardCtx
from repro_torch.models.transformer import param_specs

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}, "4x2": {"data": 4, "model": 2}}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _flat(tree, is_leaf, path=()):
    """{key path: leaf} of a tree of dicts, lists and tuples."""
    if is_leaf(tree):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, is_leaf, path + (k,)))
    return out


def _entry(e):
    """A spec entry with a one-axis tuple written as its axis (JAX's
    ``PartitionSpec`` normalizes ('data',) to 'data')."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _port(specs):
    return {k: tuple(map(_entry, v)) for k, v in
            _flat(specs, lambda x: isinstance(x, P)).items()}


def _ref(specs):
    from jax.sharding import PartitionSpec
    return {k: tuple(map(_entry, v)) for k, v in
            _flat(specs, lambda x: isinstance(x, PartitionSpec)).items()}


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in
            _flat(tree, lambda x: hasattr(x, "shape")).items()}


def _memo_eval_shape(eval_shape):
    """``jax.eval_shape`` memoized on the traced function's code and the
    values it closes over (the reference's spec functions trace
    ``init_params`` of one config up to four times per mesh; its shapes
    do not depend on the mesh)."""
    memo = {}

    def cached(fn, *args, **kw):
        cells = tuple(c.cell_contents for c in fn.__closure__ or ())
        key = (fn.__code__, cells) if not args and not kw else None
        if key is None:
            return eval_shape(fn, *args, **kw)
        if key not in memo:
            memo[key] = eval_shape(fn)
        return memo[key]
    return cached


@pytest.fixture(scope="module")
def ref_specs():
    """The reference's spec trees by (arch, mesh), computed once."""
    import jax
    from unittest import mock
    from repro.configs import get_config as jget
    from repro.launch import shardings as JSH
    from repro.models import ShardCtx as JShardCtx
    from repro.models import param_specs as jparam_specs
    with mock.patch.object(jax, "eval_shape",
                           _memo_eval_shape(jax.eval_shape)):
        return _ref_specs(jget, JSH, JShardCtx, jparam_specs)


def _ref_specs(jget, JSH, JShardCtx, jparam_specs):
    out = {}
    for arch in ARCH_IDS:
        cfg = jget(arch)
        for name, shape in MESHES.items():
            mesh = _FakeMesh(shape)
            mp, pshapes = JSH.model_param_specs(cfg, mesh)
            fp, _ = JSH.fsdp_param_specs(cfg, mesh)
            out[arch, name] = {
                "param": _ref(jparam_specs(cfg, JShardCtx(mesh=mesh))),
                "model": _ref(mp), "fsdp": _ref(fp),
                "shapes": _shapes(pshapes),
                "zero1": _ref(JSH.zero1_specs(mp, pshapes, mesh)),
                "opt": _ref(JSH.opt_state_specs(mp, pshapes, mesh)),
                "zero1_fsdp": _ref(JSH.zero1_specs(fp, pshapes, mesh)),
            }
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(ref_specs, arch, mesh):
    """Tensor-parallel, FSDP, ZeRO-1 and optimizer-state specs, raw and
    sanitized, leaf for leaf, over param shapes equal to the reference's."""
    cfg = get_config(arch)
    fm = _FakeMesh(MESHES[mesh])
    ref = ref_specs[arch, mesh]
    mp, pshapes = SH.model_param_specs(cfg, fm)
    fp, _ = SH.fsdp_param_specs(cfg, fm)
    assert _shapes(pshapes) == ref["shapes"]
    assert _port(param_specs(cfg, ShardCtx(mesh=fm))) == ref["param"]
    assert _port(mp) == ref["model"]
    assert _port(fp) == ref["fsdp"]
    assert _port(SH.zero1_specs(mp, pshapes, fm)) == ref["zero1"]
    assert _port(SH.zero1_specs(fp, pshapes, fm)) == ref["zero1_fsdp"]
    assert _port(SH.opt_state_specs(mp, pshapes, fm)) == ref["opt"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh):
    """``cache_specs`` at every forward shape's batch and length (and with
    int8 K/V at decode_32k's), leaf for leaf with the reference's, over
    the same cache shapes."""
    from repro.configs import get_config as jget
    from repro.launch import shardings as JSH
    fm = _FakeMesh(MESHES[mesh])
    cases = [(s.global_batch, s.seq_len, False) for s in SP.SHAPES.values()]
    cases.append((128, 32_768, True))
    for batch, max_len, q8 in cases:
        cfg, jcfg = get_config(arch), jget(arch)
        if q8:
            cfg, jcfg = cfg.replace(kv_quant=True), jcfg.replace(kv_quant=True)
        specs, shapes = SH.cache_specs(cfg, fm, batch, max_len)
        jspecs, jshapes = JSH.cache_specs(jcfg, fm, batch, max_len)
        assert _shapes(shapes) == _shapes(jshapes), (batch, max_len, q8)
        assert _port(specs) == _ref(jspecs), (batch, max_len, q8)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_axes_and_microbatches_equal_reference(mesh):
    """``batch_axes_for`` and ``microbatches_for`` (with and without an
    explicit shard count) for every ``SHAPES`` entry and every arch's
    token length."""
    from repro.configs import get_config as jget
    from repro.launch import shardings as JSH
    from repro.launch import specs as JSP
    fm = _FakeMesh(MESHES[mesh])
    assert list(SP.SHAPES) == list(JSP.SHAPES)
    for name, s in SP.SHAPES.items():
        js = JSP.SHAPES[name]
        assert (s.kind, s.seq_len, s.global_batch) == \
            (js.kind, js.seq_len, js.global_batch)
        assert SH.batch_axes_for(fm, s.global_batch) == \
            JSH.batch_axes_for(fm, js.global_batch)
        for n in (None, 1, 8, 256):
            assert SP.microbatches_for(None, s, fm, n) == \
                JSP.microbatches_for(None, js, fm, n), (name, n)
        for arch in ARCH_IDS:
            cfg, jcfg = get_config(arch), jget(arch)
            assert SP.token_seq_len(cfg, s) == JSP.token_seq_len(jcfg, js)
            assert SP.needs_ring_override(cfg) == \
                JSP.needs_ring_override(jcfg)
            got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                   for k, v in SP.input_specs(cfg, s).items()}
            want = {k: (tuple(v.shape), str(v.dtype))
                    for k, v in JSP.input_specs(jcfg, js).items()}
            assert got == want
            assert {k: tuple(map(_entry, v)) for k, v in
                    SP.batch_input_shardings(cfg, s, fm).items()} == \
                {k: tuple(map(_entry, v)) for k, v in
                 JSP.batch_input_shardings(jcfg, js, fm).items()}


def test_shard_ctx_specs_and_constraints():
    """The port's ``ShardCtx.spec`` is the reference's, axis for axis;
    ``cs`` leaves a plain tensor, and a context without a mesh, as they
    are; ``sanitized`` drops what the reference's ``cs`` drops."""
    import torch
    from repro.models import ShardCtx as JShardCtx
    fm = _FakeMesh({"data": 16, "model": 16})
    for kw in ({}, {"batch_axes": ("pod", "data")}, {"model_axis": None},
               {"batch_axes": ()}):
        dims = ("b", None, "m", None)
        assert tuple(map(_entry, ShardCtx(mesh=fm, **kw).spec(*dims))) == \
            tuple(map(_entry, JShardCtx(mesh=fm, **kw).spec(*dims)))
    x = torch.ones(3, 4)
    assert ShardCtx(mesh=fm).cs(x, "b", "m") is x
    assert ShardCtx().cs(x, "b", "m") is x
    shd = ShardCtx(mesh=fm)
    assert tuple(shd.sanitized((32, 4096, 12, 128), "b", None, "m", None)) \
        == (("data",), None, None, None)
    assert tuple(shd.sanitized((32, 4096, 16, 128), "b", None, "m", None)) \
        == (("data",), None, "model", None)
