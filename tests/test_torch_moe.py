"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the CPU, on the same numpy-seeded inputs and the
reference's own weights, in float32:

* ``moe_einsum``, ``moe_scatter`` and ``apply_moe`` at capacity factors 8.0
  (no drops), 1.25 and 0.1 (most choices dropped), without ``valid``, with
  bucket pads (rows of different true lengths), and in routing groups
  (``moe_group`` 8 at S 32, pads in the last groups): outputs within 2e-5,
  the aux loss within 1e-6, and the keep masks (which token-choices hold a
  capacity slot) equal exactly; the port's einsum against its scatter;
* capacity drops zero the same tokens as in the reference;
* bucketed ``prefill_into_slot`` at capacity 1.25 (bucket 32, length 11)
  against the reference's ``prefill_into_slot`` and its unpadded
  ``prefill``, within 1e-5 (the reference's own test holds its two paths
  to 1e-6 and misses by 1.25e-6 to 1.40e-6: float32 rounding of padded and
  unpadded shapes, not routing);
* at capacity 1.25 routing depends on which tokens share a call: a prompt
  prefilled in two chunks gives other logits than in one shot, in both
  packages alike, and the port equals the reference on each path;
* ``dense_init`` draws a stack of expert stacks one layer slice at a time
  with the shapes, dtype and scale of a whole draw, and draws every other
  leaf whole, as before.

Tolerances: float32; the two frameworks order the router's and the
experts' matmul sums differently (~1e-7 relative).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import moe as JM
from repro.models.config import ModelConfig as JModelConfig

from repro_torch.models import (init_cache, params_from_numpy,
                                prefill_chunk_into_slot, prefill_into_slot)
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models.config import ModelConfig
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

# the reference's entry points jitted (static config), as its engine runs
# them: the same values, a fraction of the eager dispatch time
jprefill_unpadded = jax.jit(J.prefill, static_argnums=1)
jchunk = jax.jit(J.prefill_chunk_into_slot, static_argnums=1)
jprefill = jax.jit(J.prefill_into_slot, static_argnums=1)

CFG = dict(name="t", arch_type="moe", num_layers=2, d_model=64, num_heads=2,
           num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=64,
           num_experts=8, experts_per_token=2, dtype="float32", max_seq=256)
FACTORS = [8.0, 1.25, 0.1]
S, G = 32, 8
# case -> (rows, true lengths (None: no valid), moe_group)
CASES = {"no valid": (2, None, 4096), "padded": (2, [11, 27], 4096),
         "grouped padded": (1, [21], G)}


def _cfgs(cf, **kw):
    return (JModelConfig(**CFG, capacity_factor=cf, **kw),
            ModelConfig(**CFG, capacity_factor=cf, **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs(1.25)
    jp = JM.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(B, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, CFG["d_model"])).astype(np.float32)


def _jvalid(lengths):
    if lengths is None:
        return None
    return jnp.arange(S)[None, :] < jnp.asarray(lengths)[:, None]


def _jkeep(cfg, p, x, valid):
    """The reference's keep mask, from its own routing functions, in the
    order ``moe_einsum`` / ``moe_scatter`` compute it."""
    C = JM.capacity(cfg, x.shape[1])
    w, idx, _ = JM._routing(cfg, p, x)
    w, idx = JM._mask_pads(cfg, w, idx, valid)
    slot = JM._slots(cfg, idx, C)
    keep = slot < C
    if valid is not None:
        keep &= (slot < JM._dynamic_capacity(cfg, valid, C)) & valid[..., None]
    return np.asarray(keep)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_matches_reference(weights, impl, cf, case):
    """``moe_<impl>`` (no grouping) or ``apply_moe`` with ``moe_impl`` =
    impl (routing groups of 8): outputs, aux and keep masks."""
    B, lengths, group = CASES[case]
    jcfg, cfg = _cfgs(cf, moe_impl=impl, moe_group=group)
    jp, tp = weights
    x = _x(B)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    valid = _jvalid(lengths)
    if group < S:
        want, jaux = JM.apply_moe(jcfg, jp, jx, valid=valid)
        got, aux = TM.apply_moe(cfg, tp, tx, lengths)
        # the keep masks of the groups apply_moe routes
        jx, valid = jx.reshape(-1, G, x.shape[-1]), valid.reshape(-1, G)
        tx = tx.reshape(-1, G, x.shape[-1])
        lengths = [min(max(lengths[0] - j * G, 0), G) for j in range(S // G)]
    else:
        jfn = JM.moe_einsum if impl == "einsum" else JM.moe_scatter
        want, jaux = jfn(jcfg, jp, jx, valid=valid)
        got, aux = getattr(TM, f"moe_{impl}")(cfg, tp, tx, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    keep = TM._dispatch(cfg, tp, tx, lengths)[3]
    np.testing.assert_array_equal(keep.numpy(), _jkeep(jcfg, jp, jx, valid))
    if cf == 0.1:
        assert not keep.all()            # the tight case drops choices
    if lengths is not None:
        # pads hold no slot and get no output
        assert not keep.numpy()[~np.asarray(valid)].any()


@pytest.mark.parametrize("cf", FACTORS)
def test_port_einsum_equals_scatter(weights, cf):
    _, cfg = _cfgs(cf)
    tp = weights[1]
    x = torch.from_numpy(_x(2, seed=2))
    for lengths in (None, [9, 30]):
        ye, ae = TM.moe_einsum(cfg, tp, x, lengths)
        ys, as_ = TM.moe_scatter(cfg, tp, x, lengths)
        np.testing.assert_allclose(ye.numpy(), ys.numpy(), atol=1e-5)
        assert float(ae) == float(as_)


def test_capacity_drops_zero_the_same_tokens(weights):
    """At capacity 0.1 whole tokens lose every choice: their MoE output is
    zero, and they are the reference's."""
    jcfg, cfg = _cfgs(0.1)
    jp, tp = weights
    x = _x(1, seed=3)
    want, _ = JM.moe_einsum(jcfg, jp, jnp.asarray(x))
    got, _ = TM.moe_einsum(cfg, tp, torch.from_numpy(x))
    jzero = np.linalg.norm(np.asarray(want)[0], axis=-1) == 0.0
    tzero = np.linalg.norm(got.numpy()[0], axis=-1) == 0.0
    assert jzero.any() and not jzero.all()
    np.testing.assert_array_equal(tzero, jzero)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs(1.25)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _padded(toks, bucket):
    out = np.zeros((1, bucket), np.int32)
    out[0, :len(toks)] = toks
    return out


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_bucketed_prefill_at_tight_capacity_matches_reference(model, impl):
    """Bucket 32, length 11, capacity 1.25: pads take no capacity and the
    capacity is clamped to the true length's, so the port's bucketed
    prefill equals the reference's bucketed and unpadded prefill."""
    jcfg, cfg, jp, tp = model
    jcfg, cfg = jcfg.replace(moe_impl=impl), cfg.replace(moe_impl=impl)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 11)
    p = _padded(prompt, 32)
    got, _, n = prefill_into_slot(tp, cfg, torch.from_numpy(p), 11,
                                  init_cache(cfg, 2, 64, dtype=torch.float32,
                                             device="cpu"), 0)
    assert n == 11
    bucketed, _, _ = jprefill(jp, jcfg, jnp.asarray(p), 11,
                              jinit_cache(jcfg, 2, 64, dtype=jnp.float32), 0)
    unpadded, _, _ = jprefill_unpadded(
        jp, jcfg, jnp.asarray(prompt[None].astype(np.int32)),
        jinit_cache(jcfg, 1, 64, dtype=jnp.float32))
    for want in (bucketed, unpadded):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_chunked_routing_differs_from_one_shot_in_both(model):
    """A 28-token prompt at capacity 1.25: one shot routes 28 tokens with
    capacity 8, two chunks of 16 and 12 route with capacities 5 and 3
    (their own groups), so other token-choices are dropped and the final
    logits differ, in the reference and in the port alike; on each path
    the port equals the reference."""
    jcfg, cfg, jp, tp = model
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 28)
    out = {}
    for name, parts in (("one shot", [(0, 28)]),
                        ("two chunks", [(0, 16), (16, 12)])):
        jc = jinit_cache(jcfg, 1, 64, dtype=jnp.float32)
        tc = init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
        for start, m in parts:
            p = _padded(prompt[start:start + m], 32 if start == 0 else 16)
            if start == 0:
                jl, jc, _ = jprefill(jp, jcfg, jnp.asarray(p), m, jc, 0)
                tl, tc, _ = prefill_into_slot(tp, cfg, torch.from_numpy(p), m,
                                              tc, 0)
            else:
                jl, jc = jchunk(jp, jcfg, jnp.asarray(p), start, m, jc, 0)
                tl, tc = prefill_chunk_into_slot(tp, cfg, torch.from_numpy(p),
                                                 start, m, tc, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        out[name] = (np.asarray(jl), tl.numpy())
    for i in (0, 1):
        assert np.abs(out["one shot"][i] - out["two chunks"][i]).max() > 1e-3


def test_dense_init_draws_expert_stacks_slice_by_slice():
    """A (n_rep, E, d, ff) leaf: shape, dtype and scale 1/sqrt(fan_in) of
    a whole draw, each layer slice its own draw; a 3-dim leaf is drawn
    whole, bit for bit the draw before this change."""
    shape, fan_in = (3, 4, 64, 48), 64
    out = TL.dense_init(torch.Generator().manual_seed(0), shape, fan_in,
                        torch.bfloat16)
    assert tuple(out.shape) == shape and out.dtype == torch.bfloat16
    std = out.float().std().item()
    assert abs(std * math.sqrt(fan_in) - 1.0) < 0.02
    assert abs(out.float().mean().item()) < 0.01
    assert not torch.equal(out[0], out[1])
    gen = torch.Generator().manual_seed(0)
    whole = TL.dense_init(gen, shape[1:], fan_in, torch.bfloat16)
    want = (torch.randn(shape[1:], generator=torch.Generator().manual_seed(0))
            * (1.0 / math.sqrt(fan_in))).to(torch.bfloat16)
    assert torch.equal(whole, want)
    assert torch.equal(out[0], whole)
