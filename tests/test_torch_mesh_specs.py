"""The port's serving sharding rules (``repro_torch.launch.shardings``)
against the reference's (``repro.launch.shardings``), in one process with
no ranks: the specs are pure functions of the config and the mesh's axis
sizes, so the reference tests' shape-only fake mesh drives both.  The
property checks mirror ``tests/test_shardings.py``'s, and a world-size-1
gloo group holds the placement round trip."""
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

from repro_torch.launch import shardings as SH
from repro_torch.launch.shardings import P

MESHES = [(1, 1), (8, 1), (2, 4), (4, 2), (3, 1), (1, 3)]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _mesh(dp, tp):
    return _FakeMesh({"data": dp, "model": tp})


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


def _port_flat(specs):
    return {k: tuple(v) for k, v in
            _flat(specs, lambda x: isinstance(x, P)).items()}


def _ref_flat(specs):
    from jax.sharding import PartitionSpec
    return {k: tuple(v) for k, v in
            _flat(specs, lambda x: isinstance(x, PartitionSpec)).items()}


@pytest.fixture(scope="module")
def ref_caches():
    """The reference's cache shapes by arch (dense and paged), traced."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import init_cache as jinit_cache
    out = {}

    def shapes(arch):
        if arch not in out:
            cfg = jget(arch).smoke()
            out[arch] = [jax.eval_shape(
                lambda pool=pool: jinit_cache(cfg, 8, 128, dtype=jnp.float32,
                                              paged_pool=pool))
                for pool in (None, (32, 16))]
        return out[arch]
    return shapes


def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return list(ARCH_IDS)


@pytest.mark.parametrize("arch", _arch_ids())
def test_serving_specs_equal_the_reference(arch, ref_caches):
    """Every param and cache leaf's spec, by key path, equals the
    reference's on every mesh: fsdp's largest-divisible-dim rule, the
    expert axis on 'model' for MoE stacks, and the cache capacity axis on
    'data' (dense rows and pool pages alike), with indivisible axes
    dropped."""
    from repro.configs import get_config as jget
    from repro.launch import shardings as JSH
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache
    cfg, jcfg = get_config(arch).smoke(), jget(arch).smoke()
    caches = [init_cache(cfg, 8, 128, dtype=torch.float32, device="meta",
                         paged_pool=pool) for pool in (None, (32, 16))]
    for dp, tp in MESHES:
        mesh = _mesh(dp, tp)
        specs, shapes = SH.serving_param_specs(cfg, mesh)
        jspecs, jshapes = JSH.serving_param_specs(jcfg, mesh)
        mine, ref = _port_flat(specs), _ref_flat(jspecs)
        assert mine == ref, (arch, dp, tp)
        got = {k: tuple(v.shape) for k, v in _flat(
            shapes, lambda x: isinstance(x, torch.Tensor)).items()}
        want = {k: tuple(v.shape) for k, v in _flat(
            jshapes, lambda x: hasattr(x, "shape")).items()}
        assert got == want, arch
        for c, jc in zip(caches, ref_caches(arch)):
            assert _port_flat(SH.serving_cache_specs(c, mesh)) == \
                _ref_flat(JSH.serving_cache_specs(jc, mesh)), (arch, dp, tp)


def test_sanitize_spec_drops_nondivisible():
    mesh = _mesh(16, 16)
    assert SH.sanitize_spec(P("model", None), (151936, 64), mesh) \
        == P("model", None)
    assert SH.sanitize_spec(P("model", None), (50280, 64), mesh) \
        == P(None, None)
    assert SH.sanitize_spec(P(("data", "model"), None), (512, 8), mesh) \
        == P(("data", "model"), None)
    assert SH.sanitize_spec(P(("data", "model"), None), (128, 8), mesh) \
        == P(None, None)
    assert SH.sanitize_spec(P(None, "model"), (4, 12), mesh) == P(None, None)
    shapes = {"a": torch.empty(151936, 64, device="meta"),
              "b": [torch.empty(4, 12, device="meta")]}
    assert SH.sanitize_tree({"a": P("model", None), "b": [P(None, "model")]},
                            shapes, mesh) == \
        {"a": P("model", None), "b": [P(None, None)]}


def test_sanitize_spec_equals_the_reference_on_random_cases():
    from jax.sharding import PartitionSpec
    from repro.launch.shardings import sanitize_spec as jsanitize
    rng = np.random.default_rng(0)
    entries = [None, "data", "model", ("data", "model")]
    for _ in range(300):
        mesh = _mesh(int(rng.choice([1, 2, 3, 4, 8, 16])),
                     int(rng.choice([1, 2, 3, 4, 16])))
        nd = int(rng.integers(1, 4))
        spec = [entries[int(i)] for i in rng.integers(0, 4, size=nd)]
        shape = tuple(int(v) for v in rng.choice([1, 4, 12, 48, 128, 50280],
                                                 size=int(rng.integers(1, 4))))
        assert tuple(SH.sanitize_spec(P(*spec), shape, mesh)) == \
            tuple(jsanitize(PartitionSpec(*spec), shape, mesh)), \
            (spec, shape, mesh.shape)


# -- serving spec properties (tests/test_shardings.py's three) ---------------------
#
#   1. serving_param_specs partitions only divisible axes;
#   2. placing params with those specs and gathering back is the identity,
#      bit for bit (here on a world-size-1 group; on 8 gloo ranks in
#      tests/test_torch_mesh_ranks_b.py);
#   3. on a divisible 'model' axis, each MoE expert's weights land on
#      exactly one model shard.

def _case(seed: int):
    """Deterministic (cfg, fake-mesh) pair from a seed (the reference's
    ``_case``, on the port's ModelConfig)."""
    from repro_torch.models.config import ModelConfig
    rng = np.random.RandomState(seed)
    heads = int(rng.choice([2, 3, 4]))
    kv = heads if heads == 3 else int(rng.choice([1, 2, heads]))
    moe = bool(rng.randint(2))
    kw = dict(name=f"p{seed}", arch_type="moe" if moe else "dense",
              num_layers=2, d_model=int(rng.choice([32, 48, 64])),
              num_heads=heads, num_kv_heads=kv, head_dim=16,
              d_ff=int(rng.choice([96, 128])),
              vocab_size=int(rng.choice([100, 128, 160])),
              dtype="float32", max_seq=256)
    if moe:
        kw.update(num_experts=int(rng.choice([2, 3, 4])),
                  experts_per_token=2)
    cfg = ModelConfig(**kw)
    dp = int(rng.choice([1, 2, 3, 4, 8]))
    tp = int(rng.choice([1, 2, 3, 4]))
    return cfg, _mesh(dp, tp)


def _check_spec_case(seed: int):
    from repro_torch.models.moe import is_expert_leaf
    cfg, mesh = _case(seed)
    specs, shapes = SH.serving_param_specs(cfg, mesh)
    tp = mesh.shape["model"]
    expert_ok = cfg.is_moe and tp > 1 and cfg.num_experts % tp == 0
    flat_specs = _flat(specs, lambda x: isinstance(x, P))
    flat_shapes = _flat(shapes, lambda x: isinstance(x, torch.Tensor))
    assert flat_specs.keys() == flat_shapes.keys()
    n_expert = 0
    for path, spec in flat_specs.items():
        dims = tuple(flat_shapes[path].shape)
        # (1) only divisible axes are ever assigned
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            assert dims[i] % SH._axis_size(mesh, entry) == 0, \
                (seed, path, spec, dims)
        # (3) expert leaves: expert axis on 'model', nothing else sharded
        if is_expert_leaf(cfg, path, dims):
            n_expert += 1
            entries = list(spec) + [None] * (len(dims) - len(spec))
            if expert_ok:
                assert entries[1] == "model", (seed, path, spec)
                assert all(e is None for i, e in enumerate(entries)
                           if i != 1), (seed, path, spec)
    assert (n_expert > 0) == cfg.is_moe, seed


def test_serving_spec_properties_seeded():
    """Fixed-seed sweep of the spec properties."""
    for seed in range(24):
        _check_spec_case(seed)


def test_serving_spec_properties_hypothesis():
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None)
    @given(st.integers(min_value=0, max_value=50_000))
    def run(seed):
        _check_spec_case(seed)

    run()


def test_is_expert_leaf_equals_the_reference():
    """The port's key paths (dict keys and sequence indices) pick the
    leaves the reference's ``jax.tree_util`` key paths pick."""
    import jax
    from repro.configs import get_config as jget
    from repro.models.moe import is_expert_leaf as jis_expert
    from repro_torch.configs import get_config
    from repro_torch.models.moe import is_expert_leaf
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x7b", "qwen2-1.5b"):
        cfg, jcfg = get_config(arch).smoke(), jget(arch).smoke()
        shapes = _flat(SH.param_shapes(cfg),
                       lambda x: isinstance(x, torch.Tensor))
        from repro.models import init_params as jinit
        jshapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
        ref = {}
        for kp, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]:
            key = tuple(getattr(k, "key", getattr(k, "idx", None))
                        for k in kp)
            ref[key] = jis_expert(jcfg, kp, leaf.shape)
        mine = {k: is_expert_leaf(cfg, k, tuple(v.shape))
                for k, v in shapes.items()}
        assert mine == ref, arch
        assert any(mine.values()) == cfg.is_moe, arch


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class _Named:
        mesh_dim_names = ("data", "model")

        def __init__(self, dp, tp):
            self.shape = (dp, tp)

    assert SH.placements(P(("data", "model"), None), _Named(2, 4)) == \
        [Shard(0), Shard(0)]
    assert SH.placements(P(None, "model"), _Named(2, 4)) == \
        [Replicate(), Shard(1)]
    assert SH.placements(P("data", None), _Named(8, 1)) == \
        [Shard(0), Replicate()]
    # a size-1 axis never shards: (1,1) places every leaf whole
    assert SH.placements(P(("data", "model"), None), _Named(1, 1)) == \
        [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        SH.placements(P(("model", "data")), _Named(2, 4))


@pytest.fixture
def single_rank():
    from repro_torch.launch.mesh import init_single_rank, shutdown
    init_single_rank("cpu")
    yield
    shutdown()


def test_placement_round_trip_on_one_rank(single_rank):
    """(2) on a world-size-1 group: params and a paged serving cache tree
    placed by the serving specs and gathered back are the same tensors,
    bitwise, and nothing is copied (every leaf is held whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_debug_mesh, make_serving_mesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.config import ModelConfig
    mesh = make_serving_mesh(1, 1, device="cpu")
    # built once per shape over the group: the debug mesh is the same one
    assert make_debug_mesh(1, 1, device="cpu") is mesh
    assert mesh.mesh_dim_names == ("data", "model")
    for cfg in (ModelConfig(name="rt-d", arch_type="dense", num_layers=2,
                            d_model=64, num_heads=4, num_kv_heads=4,
                            head_dim=16, d_ff=128, vocab_size=128,
                            dtype="float32", max_seq=256),
                ModelConfig(name="rt-m", arch_type="moe", num_layers=2,
                            d_model=64, num_heads=4, num_kv_heads=2,
                            head_dim=16, d_ff=128, vocab_size=128,
                            num_experts=4, experts_per_token=2,
                            dtype="float32", max_seq=256)):
        params = init_params(torch.Generator().manual_seed(0), cfg)
        specs, _ = SH.serving_param_specs(cfg, mesh)
        placed = SH.place_tree(params, specs, mesh)
        caches = init_cache(cfg, 8, 128, dtype=torch.float32, device="cpu",
                            paged_pool=(32, 16))
        for tree, stored in ((params, placed),
                             (caches, SH.shard_serving_caches(caches, mesh))):
            back = SH.gather_replicated(stored, mesh)
            flat = _flat(tree, lambda x: isinstance(x, torch.Tensor))
            flat_stored = _flat(stored, lambda x: isinstance(x, DTensor))
            flat_back = _flat(back, lambda x: isinstance(x, torch.Tensor))
            assert flat.keys() == flat_back.keys() == flat_stored.keys()
            for k, x in flat.items():
                assert type(flat_back[k]) is torch.Tensor
                assert torch.equal(flat_back[k], x), (cfg.name, k)
                assert flat_back[k].data_ptr() == x.data_ptr(), k
                assert torch.equal(flat_stored[k].full_tensor(), x), k
    # no mesh: the tree itself
    assert SH.gather_replicated(params, None) is params


def test_serving_mesh_needs_its_ranks():
    """Without a default group of dp*tp ranks the mesh is refused with the
    reference's "needs n" error, reworded for ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=r"needs 8 ranks.*have 0"):
        make_serving_mesh(2, 4, device="cpu")
    with pytest.raises(RuntimeError, match=r"needs 1 rank in.*init_single"):
        make_serving_mesh(1, 1, device="cpu")
