"""The port's model against the JAX reference on the CPU, on the
reference's own weights (converted with ``params_from_numpy``):

* the weight bridge is lossless, bf16 leaves included;
* ``init_params`` builds the reference's tree, shapes and dtypes;
* on qwen2-1.5b ``.smoke()`` in float32, ``prefill_into_slot`` logits and
  cache rows agree to 1e-4, ``decode_step`` with per-row positions agrees
  to 1e-4, and 8 greedy steps give the same tokens.

1e-4: float32 throughout; the two frameworks sum matmuls and softmaxes in
different orders, which moves logits of this model by ~1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS, get_config as jget_config
import repro.models as J
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (decode_step, init_cache, init_params,
                                params_from_numpy, prefill_into_slot)
from repro_torch.serving import EngineConfig, ServingEngine
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

# the reference's entry points jitted (static config), as its engine runs
# them: the same values, a fraction of the eager dispatch time
jdecode = jax.jit(J.decode_step, static_argnums=1)
jprefill = jax.jit(J.prefill_into_slot, static_argnums=1)

TOL = 1e-4


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def test_config_copy_matches_reference():
    assert dataclasses.asdict(get_config("qwen2-1.5b")) == \
        dataclasses.asdict(jget_config("qwen2-1.5b"))


def test_params_from_numpy_round_trip_is_bitwise():
    cfg = jget_config("qwen2-1.5b").smoke()            # bf16 weights
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(3), cfg))
    tp = params_from_numpy(jp, "cpu")
    jl, tl = list(_leaves(jp)), list(_leaves(tp))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    n_bf16 = 0
    for (path, a), (_, t) in zip(jl, tl):
        if a.dtype.name == "bfloat16":
            n_bf16 += 1
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(_bits(t), a.view(np.uint16))
        else:
            assert str(t.dtype).endswith(a.dtype.name), path
            np.testing.assert_array_equal(_bits(t), a)
    assert n_bf16 > 0
    assert isinstance(tp["stages"][0]["blocks"], tuple)
    # dtype= casts the weights and keeps the float32 norm scales
    cast = params_from_numpy(jp, "cpu", dtype=torch.float32)
    assert cast["embed"]["embedding"].dtype == torch.float32
    np.testing.assert_array_equal(
        cast["embed"]["embedding"].numpy(),
        np.asarray(jp["embed"]["embedding"], np.float32))
    assert cast["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_params_matches_reference_tree(dtype):
    jcfg = jget_config("qwen2-1.5b").smoke().replace(dtype=dtype)
    cfg = get_config("qwen2-1.5b").smoke().replace(dtype=dtype)
    want = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg))
    got = init_params(torch.Generator().manual_seed(0), cfg)
    wl, gl = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, w), (_, g) in zip(wl, gl):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


@pytest.mark.parametrize("arch", [a for a in JARCH_IDS if a != "qwen2-1.5b"])
def test_other_architectures_are_refused(arch):
    """Every one of the reference's architectures is registered in its
    order, a copy of the reference's config, and accepted: the engine
    builds each smoke config on the CPU (the recurrent ones, refused until
    ROADMAP A9.6, included); none is refused any more."""
    assert ARCH_IDS == list(JARCH_IDS)
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    eng = ServingEngine(get_config(arch).smoke(), ecfg=EngineConfig(
        max_len=64, governor="defaultnv"), device="cpu")
    assert len(eng.caches) == len(eng.params["stages"])


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("qwen2-1.5b").smoke().replace(dtype="float32")
    cfg = get_config("qwen2-1.5b").smoke().replace(dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


B, MAXLEN = 3, 64
PROMPTS = {0: 21, 2: 9}          # slot -> prompt length (buckets 32, 16)


def _prefill_both(smoke):
    jcfg, cfg, jp, tp = smoke
    jc = jinit_cache(jcfg, B, MAXLEN, dtype=jnp.float32)
    tc = init_cache(cfg, B, MAXLEN, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    logits, toks = {}, {}
    for slot, L in PROMPTS.items():
        bucket = 16 if L <= 16 else 32
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :L] = rng.integers(0, cfg.vocab_size, size=L)
        jl, jc, _ = jprefill(jp, jcfg, jnp.asarray(padded), L, jc, slot)
        tl, tc, n = prefill_into_slot(tp, cfg, torch.from_numpy(padded), L,
                                      tc, slot)
        assert n == L
        logits[slot] = (np.asarray(jl), tl.numpy())
        toks[slot] = int(np.argmax(np.asarray(jl)[0]))
    return jc, tc, logits, toks


def test_prefill_into_slot_matches_reference(smoke):
    jc, tc, logits, _ = _prefill_both(smoke)
    for slot, (jl, tl) in logits.items():
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    for jd, td in zip(jc[0], tc[0]):
        for kk in ("k", "v"):
            for slot, L in PROMPTS.items():
                np.testing.assert_allclose(
                    td[kk][:, slot, :L].numpy(),
                    np.asarray(jd[kk])[:, slot, :L], atol=TOL, rtol=TOL)
            # the untouched row stays zero
            assert not td[kk][:, 1].any()


def test_decode_step_per_row_positions_matches_reference(smoke):
    jcfg, cfg, jp, tp = smoke
    jc, tc, _, toks = _prefill_both(smoke)
    pos = np.array([PROMPTS[0], 0, PROMPTS[2]], np.int32)
    jtok = np.array([toks[0], 0, toks[2]], np.int32)
    ttok = jtok.copy()
    out_j, out_t = [], []
    for step in range(8):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(jtok)[:, None], jc,
                         jnp.asarray(pos + step))
        tl, tc = decode_step(tp, cfg, torch.from_numpy(ttok)[:, None], tc,
                             torch.from_numpy(pos + step))
        if step == 0:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=TOL, rtol=TOL)
        jtok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        ttok = tl.argmax(-1).to(torch.int32).numpy()
        out_j.append(jtok)
        out_t.append(ttok)
    np.testing.assert_array_equal(np.stack(out_t), np.stack(out_j))
