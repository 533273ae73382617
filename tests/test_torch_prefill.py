"""The port's unpadded ``prefill`` (with ``_embed_inputs``) and the scalar
``sample_tokens`` against the JAX reference on the CPU, on the
reference's own weights (``params_from_numpy``), float32:

* ``prefill`` of B = 2 prompts over all 11 ``ARCH_IDS`` smoke configs,
  after seeded prefix embeddings where the config has them (musicgen's
  conditioning frames, llava's image patches, through ``prefix_proj``) and
  without: last logits within 2e-5 and ``next_pos`` equal, then the four
  teacher-forced decode steps of ``tests/test_arch_smoke.py`` at a scalar
  position, logits within 2e-5 and greedy tokens equal;
* ``cache_write_prefill`` bit for bit the reference's in float32, bf16
  and int8 (a prompt longer than the ring keeps its last positions at
  their slots), and the caches a model prefill leaves past gemma2's
  64-slot rings;
* ``sample_tokens``: greedy bit for bit, sampled draws equal on seeded
  keys (one key for the batch, ``jax.random.categorical``'s counters).

The long-context rings are held to the reference in
``tests/test_torch_long_context.py``.

2e-5: float32 throughout; the two frameworks sum matmuls in different
orders, which moves these logits by ~1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs import ARCH_IDS, get_config as jget_config
from repro.models import init_cache as jinit_cache
from repro.models import sample_tokens as jsample
from repro.models import kvcache as JKV

from repro_torch.configs import get_config
from repro_torch.core.prng import prng_key
from repro_torch.models import (decode_step, init_cache, params_from_numpy,
                                prefill, sample_tokens)
from repro_torch.models import kvcache as KV

# the reference's entry points jitted (static config), as its engine runs
# them: the same values, a fraction of the eager dispatch time
jinit_params = jax.jit(J.init_params, static_argnums=1)
jprefill = jax.jit(J.prefill, static_argnums=1)
jdecode = jax.jit(J.decode_step, static_argnums=1)
jslot = jax.jit(J.prefill_into_slot, static_argnums=1)
jchunk = jax.jit(J.prefill_chunk_into_slot, static_argnums=1)

TOL = 2e-5
B, S, TAIL = 2, 24, 4          # tests/test_arch_smoke.py's serve path
F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small models: under the suite's
    parallel workers a thread per core in every worker oversubscribes the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, **kw):
    jcfg = jget_config(arch).smoke().replace(dtype="float32", **kw)
    cfg = get_config(arch).smoke().replace(dtype="float32", **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# every arch without prefix embeddings, and with and without them for the
# two that take them
CASES = [(a, False) for a in ARCH_IDS] + [
    (a, True) for a in ARCH_IDS if jget_config(a).num_prefix_embeds]


@pytest.fixture(scope="module")
def model(request):
    jcfg, cfg = _pair(request.param)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, cfg, jp, _bridge(jp)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _prefill_both(jcfg, cfg, jp, tp, tokens, pe, jc, tc):
    jl, jc, jpos = jprefill(jp, jcfg, jnp.asarray(tokens), jc,
                           None if pe is None else jnp.asarray(pe))
    tl, tc, tpos = prefill(tp, cfg, torch.from_numpy(tokens), tc,
                           None if pe is None else torch.from_numpy(pe))
    assert tpos == jpos
    _close(tl, jl)
    return jl, jc, jpos, tl, tc, tpos


@pytest.mark.parametrize("model,with_prefix", CASES, indirect=["model"],
                         ids=[a + "-prefix" * p for a, p in CASES])
def test_prefill_and_teacher_forced_decode_match_reference(model,
                                                           with_prefix):
    """musicgen and llava also project their smoke configs' 8 seeded
    prefix frames each (the positions then run over the frames too)."""
    arch, jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    P = cfg.num_prefix_embeds if with_prefix else 0
    pe = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32) \
        if P else None
    jc = jinit_cache(jcfg, B, 64, dtype=jnp.float32)
    tc = init_cache(cfg, B, 64, dtype=F32, device="cpu")
    jl, jc, pos, tl, tc, _ = _prefill_both(jcfg, cfg, jp, tp,
                                           tokens[:, :S - TAIL], pe, jc, tc)
    assert pos == P + S - TAIL
    assert torch.equal(tl.argmax(-1), torch.from_numpy(
        np.asarray(jl).argmax(-1)))
    for i in range(TAIL):
        tok = tokens[:, S - TAIL + i:S - TAIL + i + 1]
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc, pos + i)
        tl, tc = decode_step(tp, cfg, torch.from_numpy(tok), tc, pos + i)
        _close(tl, jl)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))


def _kv_pair(rng, shape):
    k, v = rng.standard_normal(shape), rng.standard_normal(shape)
    return k.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cache_write_prefill_is_the_references(dtype):
    """(2, 40, 2, 16) K/V into fresh 64-slot buffers (slots 0..39) and
    16-slot rings (positions 24..39 at their slots p % 16): the same bits
    as the reference's, int8 values and scales included."""
    rng = np.random.default_rng(2)
    k, v = _kv_pair(rng, (2, 40, 2, 16))
    for buf in (64, 16):
        shape = (2, buf, 2, 16)
        if dtype == "int8":
            jc = {"k": jnp.zeros(shape, jnp.int8),
                  "v": jnp.zeros(shape, jnp.int8),
                  "k_s": jnp.zeros(shape[:-1] + (1,), jnp.float32),
                  "v_s": jnp.zeros(shape[:-1] + (1,), jnp.float32)}
        else:
            jc = {n: jnp.zeros(shape, jnp.dtype(dtype)) for n in "kv"}
        tc = {n: torch.from_numpy(np.array(a)) if a.dtype != jnp.bfloat16
              else torch.zeros(shape, dtype=torch.bfloat16)
              for n, a in jc.items()}
        want = JKV.cache_write_prefill(jc, jnp.asarray(k), jnp.asarray(v))
        got = KV.cache_write_prefill(tc, torch.from_numpy(k),
                                     torch.from_numpy(v))
        assert got is tc and set(got) == set(want)
        for n in want:
            np.testing.assert_array_equal(
                got[n].float().numpy(),
                np.asarray(want[n].astype(jnp.float32)), err_msg=n)


def test_prefill_past_the_rings_leaves_the_references_caches():
    """gemma2's smoke model (64-slot local rings beside full buffers) fed a
    100-token prompt in one unpadded prefill: every cache leaf of both rows
    within 2e-5 of the reference's, the rings holding positions 36..99."""
    jcfg, cfg = _pair("gemma2-9b")
    jp = jinit_params(jax.random.PRNGKey(3), jcfg)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 100)).astype(np.int32)
    jc = jinit_cache(jcfg, B, 128, dtype=jnp.float32)
    tc = init_cache(cfg, B, 128, dtype=F32, device="cpu")
    _, jc, _, _, tc, _ = _prefill_both(jcfg, cfg, jp, _bridge(jp), tokens,
                                       None, jc, tc)
    leaves = [(a, b) for js, ts in zip(jc, tc) for jd, td in zip(js, ts)
              for a, b in ((jd[n], td[n]) for n in jd)]
    assert {tuple(b.shape[2:3]) for _, b in leaves} == {(64,), (128,)}
    for want, got in leaves:
        _close(got, want)


def test_sample_tokens_is_the_references():
    """Greedy (temperature 0, or no key) is the argmax bit for bit; a
    positive temperature draws with one key over the flattened (B, V)
    counters, as ``jax.random.categorical`` does."""
    rng = np.random.default_rng(4)
    for shape in ((1, 1000), (4, 1000), (3, 151936)):
        lg = rng.standard_normal(shape).astype(np.float32) * 3
        tl = torch.from_numpy(lg)
        want = np.asarray(jsample(jnp.asarray(lg)))
        np.testing.assert_array_equal(sample_tokens(tl).numpy(), want)
        np.testing.assert_array_equal(
            sample_tokens(tl, 0.0, prng_key(1)).numpy(), want)
        np.testing.assert_array_equal(sample_tokens(tl, 0.7).numpy(), want)
        for seed, temp in ((0, 1.0), (7, 0.5), (123456, 1.7)):
            want = np.asarray(jsample(jnp.asarray(lg), temp,
                                      jax.random.PRNGKey(seed)))
            got = sample_tokens(tl, temp, prng_key(seed))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    bf = torch.from_numpy(lg).to(torch.bfloat16)
    np.testing.assert_array_equal(
        sample_tokens(bf).numpy(),
        np.asarray(jsample(jnp.asarray(lg).astype(jnp.bfloat16))))
