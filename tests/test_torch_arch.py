"""The architectures beyond qwen2 in the port, against the JAX reference
on the CPU, on the reference's own weights (``params_from_numpy``), at
each config's ``.smoke()`` size in float32: the dense family (qwen3-14b,
granite-8b, chatglm3-6b, gemma2-9b), the MoE models (qwen3-moe-30b-a3b,
mixtral-8x7b; dropless at smoke size, capacity factor 8), the layer-norm
/ prefix family (musicgen-large: layer norm, sincos positions, the plain
GELU MLP, MHA; llava-next-mistral-7b's text backbone with its unused
``prefix_proj``) and the recurrent ones (mamba2-370m: SSM blocks, no MLP;
recurrentgemma-9b: rglru, rglru, local with MQA):

* ``init_params`` builds the reference's tree, shapes and dtypes: QK norms
  (qwen3), untied ``lm_head`` (qwen3, granite, chatglm3), sandwich norms
  (gemma2), MoE routers and expert stacks, layer-norm biases, plain-MLP
  biases and ``prefix_proj``; the weight bridge keeps every float32 leaf
  (norm scales and biases, QK norms, routers) float32 when it casts the
  weights;
* gemma2's scaled embedding rounds sqrt(d_model) to the activation dtype
  first, as the reference does (sqrt(3584) = 59.866 is 59.75 in bf16);
* per arch, ``prefill_into_slot`` into row 0, ``prefill_chunk_into_slot``
  of a longer prompt in chunks into row 1 of the same dense cache, then
  decode steps of both rows at their own positions: logits agree to 1e-4
  and greedy tokens are identical.  gemma2's and mixtral's smoke window is
  64, so their local layers are 64-slot rings: the chunks of the 150-token
  prompt wrap them (the dense-ring route of chunk_attention), and decode
  wraps them again; gemma2's final logits are soft-capped, its attention
  logits too; recurrentgemma's rings are 64 slots as well, and its
  recurrent rows resume chunk after chunk (row 1 never held a stream, so
  the reference's chunk mode starts it from zeros too);
* the serve CLI's ``--arch`` serves each of them (smoke size, CPU) and
  refuses an unknown id.

1e-4: float32 throughout; the two frameworks sum matmuls and softmaxes in
different orders, which moves logits of these models by ~1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import (decode_step as jdecode, init_cache as jinit_cache,
                          init_params as jinit_params,
                          prefill_chunk_into_slot as jchunk,
                          prefill_into_slot as jprefill)
from repro.models import layers as JL

from repro_torch.configs import get_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (decode_step, init_cache, init_params,
                                params_from_numpy, prefill_chunk_into_slot,
                                prefill_into_slot)
from repro_torch.models import layers as TL

ARCHS = ["qwen3-14b", "granite-8b", "chatglm3-6b", "gemma2-9b",
         "qwen3-moe-30b-a3b", "mixtral-8x7b", "musicgen-large",
         "llava-next-mistral-7b", "mamba2-370m", "recurrentgemma-9b"]
TOL = 1e-4
MAXLEN = 192
SHORT, LONG, CHUNK, STEPS = 20, 150, 32, 6


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    jcfg, cfg = jget_config(arch).smoke(), get_config(arch).smoke()
    want = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg))
    got = init_params(torch.Generator().manual_seed(0), cfg)
    wl, gl = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, w), (_, g) in zip(wl, gl):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


def test_bridge_keeps_float32_leaves_float32():
    """qwen3's QK norms are float32 beside bf16 weights; a cast to bf16
    keeps them (and every norm scale) float32, bit for bit."""
    jcfg = jget_config("qwen3-14b").smoke()             # bf16 weights
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(1), jcfg))
    tp = params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    attn = tp["stages"][0]["blocks"][0]["attn"]
    for name in ("q_norm", "k_norm"):
        assert attn[name].dtype == torch.float32, name
        np.testing.assert_array_equal(
            attn[name].numpy(), jp["stages"][0]["blocks"][0]["attn"][name])
    assert attn["q"].dtype == torch.bfloat16
    assert tp["embed"]["lm_head"].dtype == torch.bfloat16
    for path, t in _leaves(tp):
        if path[-1] in ("scale", "q_norm", "k_norm"):
            assert t.dtype == torch.float32, path


@pytest.mark.parametrize("arch,leaves", [
    ("qwen3-moe-30b-a3b", ("router",)), ("musicgen-large", ("bias",))])
def test_bridge_keeps_routers_and_norm_biases_float32(arch, leaves):
    """The MoE router and the layer norm's bias are float32 in the
    reference beside bf16 weights (``init_moe``, ``init_norm``); a cast to
    bf16 keeps them float32, bit for bit (a rounded router would move
    expert choices)."""
    jcfg = jget_config(arch).smoke()                    # bf16 weights
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(1), jcfg))
    tp = params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    seen = 0
    for (path, t), (_, j) in zip(_leaves(tp), _leaves(jp)):
        if path[-1] in leaves:
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), j)
            seen += 1
        elif j.dtype != np.float32:
            assert t.dtype == torch.bfloat16, path
    assert seen > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embed_scale_rounds_like_the_reference(dtype):
    """gemma2's full d_model (3584): sqrt(3584) = 59.866 is rounded to the
    activation dtype before the multiply, so bf16 embeddings are scaled by
    59.75 (the nearest bf16; the float32 product would round otherwise);
    the port's embeddings equal the reference's bit for bit."""
    jcfg = jget_config("gemma2-9b").replace(vocab_size=64, dtype=dtype)
    cfg = get_config("gemma2-9b").replace(vocab_size=64, dtype=dtype)
    emb = np.random.default_rng(0).standard_normal(
        (64, cfg.d_model)).astype(np.float32)
    jemb = jnp.asarray(emb).astype(jnp.dtype(dtype))
    temb = torch.from_numpy(emb).to(getattr(torch, dtype))
    toks = np.arange(0, 64, 3, dtype=np.int32)[None]
    want = JL.embed_tokens(jcfg, {"embedding": jemb}, jnp.asarray(toks))
    got = TL.embed_tokens(cfg, {"embedding": temb}, torch.from_numpy(toks))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(),
                                      (temb.float()[toks] * 59.75)
                                      .bfloat16().float().numpy())


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jget_config(arch).smoke().replace(dtype="float32")
    cfg = get_config(arch).smoke().replace(dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jinit_params(jax.random.PRNGKey(7), jcfg)
    return arch, jcfg, cfg, jp, params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _padded(toks, bucket):
    out = np.zeros((1, bucket), np.int32)
    out[0, :len(toks)] = toks
    return out


def test_prefill_chunks_and_decode_match_reference(model):
    """Row 0: a 20-token prompt in one bucket; row 1: a 150-token prompt in
    chunks of 32 (the last one padded); then decode steps of both rows at
    their own positions.  Logits of every call agree, tokens are equal."""
    arch, jcfg, cfg, jp, tp = model
    jc = jinit_cache(jcfg, 2, MAXLEN, dtype=jnp.float32)
    tc = init_cache(cfg, 2, MAXLEN, dtype=torch.float32, device="cpu")
    if cfg.window:
        # the local layers are 64-slot rings, which the long prompt wraps
        local = cfg.block_pattern.index("local")
        assert cfg.window == 64 and tc[0][local]["k"].shape[2] == 64
        if arch == "gemma2-9b":
            assert tc[0][1]["k"].shape[2] == MAXLEN
    rng = np.random.default_rng(3)
    short = rng.integers(0, cfg.vocab_size, SHORT)
    long_ = rng.integers(0, cfg.vocab_size, LONG)
    p = _padded(short, 32)
    jl, jc, _ = jprefill(jp, jcfg, jnp.asarray(p), SHORT, jc, 0)
    tl, tc, n = prefill_into_slot(tp, cfg, torch.from_numpy(p), SHORT, tc, 0)
    assert n == SHORT
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    first = [int(np.argmax(np.asarray(jl)[0]))]
    assert int(tl[0].argmax()) == first[0]
    for start in range(0, LONG, CHUNK):
        m = min(CHUNK, LONG - start)
        p = _padded(long_[start:start + m], CHUNK)
        jl, jc = jchunk(jp, jcfg, jnp.asarray(p), start, m, jc, 1)
        tl, tc = prefill_chunk_into_slot(tp, cfg, torch.from_numpy(p), start,
                                         m, tc, 1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    first.append(int(np.argmax(np.asarray(jl)[0])))
    assert int(tl[0].argmax()) == first[1]
    pos = np.array([SHORT, LONG], np.int32)
    jtok = ttok = np.array(first, np.int32)
    out_j, out_t = [], []
    for step in range(STEPS):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(jtok)[:, None], jc,
                         jnp.asarray(pos + step))
        tl, tc = decode_step(tp, cfg, torch.from_numpy(ttok)[:, None], tc,
                             torch.from_numpy(pos + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        jtok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        ttok = tl.argmax(-1).to(torch.int32).numpy()
        out_j.append(jtok)
        out_t.append(ttok)
    np.testing.assert_array_equal(np.stack(out_t), np.stack(out_j))
    if cfg.final_softcap:
        assert float(tl.abs().max()) <= cfg.final_softcap


@pytest.mark.parametrize("arch,flags", [(a, []) for a in ARCHS]
                         + [(a, ["--paged"]) for a in (
                             "gemma2-9b", "mamba2-370m",
                             "recurrentgemma-9b")])
def test_serve_cli_serves_the_arch(arch, flags, capsys):
    """``--arch`` takes the new ids: each smoke config serves the
    launcher's burst on the CPU (gemma2 and recurrentgemma at max_len 160:
    prompts past their 64-slot rings are chunked into them; with
    ``--paged`` beside a pool, or, for mamba2, with no pool at all)."""
    rep = serve_main(["--device", "cpu", "--arch", arch, "--requests", "3",
                      "--max-len", "160", *flags])
    assert rep.completed == 3
    assert f"arch={arch}" in capsys.readouterr().out


def test_serve_cli_refuses_other_archs():
    """Every reference arch is a choice of ``--arch``; an unknown id is
    refused."""
    with pytest.raises(SystemExit):
        serve_main(["--device", "cpu", "--arch", "mamba2-1.3b"])
