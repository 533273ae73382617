"""The port's recurrent mixers, their row states and the weight bridge,
against the JAX reference on the CPU in float32, inputs from a numpy seed:

* ``ssm_forward`` (Mamba2 SSD: one chunk, several chunks, a length that no
  chunk size divides evenly, resumed from a cache, with bucket pads) and
  ``ssm_decode_step``, ``rglru_forward`` at S 17, 24 and 130 (the scan's odd
  and even recursion levels, resumed, padded) and ``rglru_decode_step``:
  outputs and states within 2e-5, at the ``.smoke()`` widths of mamba2-370m
  and recurrentgemma-9b, the reference's init with its float32 parameters
  (D, dt_bias, the gated norm, the gates, the conv bias) redrawn from the
  seed so that each one moves the output;
* the port's own chunked forms equal its step-by-step decode (as
  ``tests/test_models.py`` holds the reference's), and a sequence split in
  two and resumed from the first half's state equals it in one piece;
* ``init_cache`` builds the reference's cache tree (dense, and paged:
  recurrent rows and rings stay dense beside the pool); the row helpers
  read views and write in place;
* the bridge keeps the seven float32 leaves of the two mixers float32, bit
  for bit, under a bfloat16 cast;
* decode leaves an inactive row's recurrent state bit for bit as it was,
  as the reference's ``active`` mask does;
* a stream's first chunk starts from a zero row in the port, whatever an
  earlier stream left in the row; the reference's chunk mode reads the
  row, so its logits move (ROADMAP §C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import (decode_step, init_cache as jinit_cache,
                          init_params as jinit_params,
                          prefill_chunk_into_slot, prefill_into_slot)
from repro.models import rglru as JR
from repro.models import ssm as JS

from repro_torch.configs import get_config
from repro_torch.models import (ModelConfig, init_cache, init_params,
                                params_from_numpy)
from repro_torch.models import decode_step as tdecode
from repro_torch.models import prefill_chunk_into_slot as tchunk
from repro_torch.models import prefill_into_slot as tprefill
from repro_torch.models import kvcache as KV
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = 2e-5
# the reference's entry points, one compile per shape (cfg static)
jprefill = jax.jit(prefill_into_slot, static_argnums=1)
jchunk = jax.jit(prefill_chunk_into_slot, static_argnums=1)
jdecode = jax.jit(decode_step, static_argnums=1)
F32_LEAVES = {"ssm": ("A_log", "D", "dt_bias", "norm"),
              "rglru": ("lam", "rg_w", "ig_w")}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _mixer(kind):
    """(jax cfg, port cfg, jax params, port params) of one mixer at its
    model's smoke width, the float32 parameters redrawn from a seed."""
    arch = "mamba2-370m" if kind == "ssm" else "recurrentgemma-9b"
    jcfg = jget_config(arch).smoke().replace(dtype="float32")
    cfg = get_config(arch).smoke().replace(dtype="float32")
    init = JS.init_ssm if kind == "ssm" else JR.init_rglru
    p = {k: np.array(v) for k, v in
         init(jax.random.PRNGKey(0), jcfg, jnp.float32).items()}
    rng = np.random.default_rng(11)
    p["conv_b"] = rng.normal(0, 0.1, p["conv_b"].shape).astype(np.float32)
    if kind == "ssm":
        p["D"] = rng.uniform(0.5, 1.5, p["D"].shape).astype(np.float32)
        p["dt_bias"] = (p["dt_bias"] + rng.normal(0, 0.5, p["dt_bias"].shape)
                        ).astype(np.float32)
        p["norm"] = rng.uniform(0.5, 1.5, p["norm"].shape).astype(np.float32)
    else:
        for k in ("rg_w", "ig_w"):
            p[k] = rng.normal(0, 1, p[k].shape).astype(np.float32)
    return (jcfg, cfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.fixture(scope="module", params=["ssm", "rglru"])
def mixer(request):
    kind = request.param
    jfwd, jstep, tfwd, tstep = (
        (JS.ssm_forward, JS.ssm_decode_step, TS.ssm_forward,
         TS.ssm_decode_step) if kind == "ssm" else
        (JR.rglru_forward, JR.rglru_decode_step, TR.rglru_forward,
         TR.rglru_decode_step))
    # one compile per shape instead of one per operator and shape
    jfwd = jax.jit(jfwd, static_argnums=0, static_argnames="return_state")
    jstep = jax.jit(jstep, static_argnums=0)
    return (kind,) + _mixer(kind) + (jfwd, jstep, tfwd, tstep)


# (S, resumed from a 9-token segment, real length or None)
CASES = [(17, False, None), (24, True, 19), (130, True, 127),
         (128, False, 128)]


@pytest.mark.parametrize("S,resumed,length", CASES)
def test_forward_and_decode_match_reference(mixer, S, resumed, length):
    """SSD at 17 (one chunk of 17), 24, 128 (two chunks of 64) and 130 (five
    of 26); the scan at odd and even lengths.  Then three decode steps
    from the final state."""
    kind, jcfg, cfg, jp, tp, jfwd, jstep, tfwd, tstep = mixer
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jc = tc = None
    if resumed:
        x0 = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
        _, jc = jfwd(jcfg, jp, jnp.asarray(x0), return_state=True)
        _, tc = tfwd(cfg, tp, torch.from_numpy(x0), return_state=True)
    jo, jc = jfwd(jcfg, jp, jnp.asarray(x), return_state=True, cache=jc,
                  length=length)
    to, tc = tfwd(cfg, tp, torch.from_numpy(x), return_state=True,
                  cache=tc, length=length)
    _close(to, jo)
    assert set(tc) == set(jc)
    for k in jc:
        assert tc[k].dtype == torch.float32 and tc[k].shape == jc[k].shape
        _close(tc[k], jc[k])
    for _ in range(3):
        xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, jc = jstep(jcfg, jp, jnp.asarray(xd), jc)
        to, tc = tstep(cfg, tp, torch.from_numpy(xd), tc)
        _close(to, jo)
        for k in jc:
            _close(tc[k], jc[k])


def test_pads_leave_the_state_at_the_last_real_token(mixer):
    """A 24-token bucket with 19 real tokens ends in the state (and conv
    window) of the 19 tokens alone."""
    kind, jcfg, cfg, jp, tp, jfwd, jstep, tfwd, tstep = mixer
    x = np.random.default_rng(5).standard_normal(
        (1, 24, cfg.d_model)).astype(np.float32)
    _, padded = tfwd(cfg, tp, torch.from_numpy(x), return_state=True,
                     length=19)
    _, alone = tfwd(cfg, tp, torch.from_numpy(x[:, :19]), return_state=True)
    for k in alone:
        _close(padded[k], alone[k].numpy(), 1e-5)


def _tiny(kind):
    if kind == "ssm":
        return ModelConfig(name="t", arch_type="ssm", num_layers=1,
                           d_model=64, num_heads=0, num_kv_heads=0,
                           head_dim=0, d_ff=0, vocab_size=64,
                           block_pattern=("ssm",), ssm_state=16,
                           ssm_expand=2, ssm_headdim=32, ssm_chunk=8,
                           dtype="float32")
    return ModelConfig(name="t", arch_type="hybrid", num_layers=1,
                       d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
                       d_ff=64, vocab_size=64, block_pattern=("rglru",),
                       lru_width=32, dtype="float32")


@pytest.mark.parametrize("kind", ["ssm", "rglru"])
def test_chunked_equals_sequential(kind):
    """The port's own SSD (chunk 8 over 24 tokens) and scan (17 tokens)
    equal its step-by-step decode; a sequence split at 10 and resumed from
    the first part's state equals it in one piece."""
    cfg = _tiny(kind)
    gen = torch.Generator().manual_seed(0)
    init, fwd, step, S = ((TS.init_ssm, TS.ssm_forward, TS.ssm_decode_step,
                           24) if kind == "ssm" else
                          (TR.init_rglru, TR.rglru_forward,
                           TR.rglru_decode_step, 17))
    p = init(gen, cfg, torch.float32)
    x = torch.randn((2, S, cfg.d_model), generator=gen)
    cache = KV.init_block_cache(cfg, kind, 2, 64, dtype=torch.float32,
                                device="cpu")
    outs = []
    for t in range(S):
        y, cache = step(cfg, p, x[:, t:t + 1], cache)
        outs.append(y[:, 0])
    full, st = fwd(cfg, p, x, return_state=True)
    _close(full, torch.stack(outs, 1).numpy())
    for k in st:
        _close(st[k], cache[k].numpy())
    first, c1 = fwd(cfg, p, x[:, :10], return_state=True)
    rest, c2 = fwd(cfg, p, x[:, 10:], return_state=True, cache=c1)
    _close(torch.cat([first, rest], 1), full.numpy())
    for k in st:
        _close(c2[k], st[k].numpy())


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_init_cache_matches_reference_tree(arch):
    """Dense, and paged: recurrent rows (and recurrentgemma's rings, 64
    slots at smoke size) stay dense (n_rep, B, ...) beside the pool."""
    jcfg, cfg = jget_config(arch).smoke(), get_config(arch).smoke()
    for pool in (None, (9, 16)):
        want = jax.eval_shape(lambda: jinit_cache(jcfg, 3, 128,
                                                  paged_pool=pool))
        got = init_cache(cfg, 3, 128, device="cpu", paged_pool=pool)
        wl, gl = list(_leaves(want)), list(_leaves(got))
        assert [p for p, _ in wl] == [p for p, _ in gl]
        for (path, w), (_, g) in zip(wl, gl):
            assert tuple(g.shape) == w.shape, (pool, path)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (pool, path)
    assert not any(KV.is_paged(d) for st in got for d in st
                   if "h" in d or "state" in d)


def test_state_row_helpers_work_in_place():
    cfg = get_config("recurrentgemma-9b").smoke()
    c = KV.init_rglru_cache(cfg, 3, dtype=torch.float32, device="cpu",
                            lead=(2,))
    layer = {k: v[1] for k, v in c.items()}          # a stacked layer's view
    one = {"h": torch.full((1, 256), 2.0),
           "conv": torch.full((1, 3, 256), 3.0)}
    KV.state_write_slot(layer, one, 2)
    assert float(c["h"][1, 2].min()) == float(c["h"][1, 2].max()) == 2.0
    assert float(c["conv"][1, 2].min()) == 3.0
    assert float(c["h"].abs().sum()) == 2.0 * 256
    row = KV.state_row_slot(layer, 2)
    assert row["h"].shape == (1, 256)
    assert row["h"].data_ptr() == c["h"][1, 2].data_ptr()


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_bridge_keeps_float32_leaves_float32(arch):
    """A_log, D, dt_bias and the gated norm (SSM), lam, rg_w and ig_w
    (RG-LRU) are float32 in the reference beside bf16 weights; a cast to
    bf16 keeps them float32, bit for bit."""
    jcfg = jget_config(arch).smoke()                    # bf16 weights
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(1), jcfg))
    tp = params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    kind = "ssm" if arch.startswith("mamba2") else "rglru"
    block = tp["stages"][0]["blocks"][0][kind]
    jblock = jp["stages"][0]["blocks"][0][kind]
    for name in F32_LEAVES[kind]:
        assert block[name].dtype == torch.float32, name
        np.testing.assert_array_equal(block[name].numpy(), jblock[name])
    for name in block:
        if name not in F32_LEAVES[kind]:
            assert block[name].dtype == torch.bfloat16, name
    # and a port-drawn tree has the same dtypes
    drawn = init_params(torch.Generator().manual_seed(0), get_config(arch)
                        .smoke())["stages"][0]["blocks"][0][kind]
    assert {k: v.dtype for k, v in drawn.items()} == \
        {k: v.dtype for k, v in block.items()}


@pytest.fixture(scope="module")
def hybrid():
    """recurrentgemma's smoke config in float32 (rglru, rglru, local; its
    64-slot rings) on the reference's weights."""
    jcfg = jget_config("recurrentgemma-9b").smoke().replace(dtype="float32")
    cfg = get_config("recurrentgemma-9b").smoke().replace(dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _pad(toks, bucket):
    out = np.zeros((1, bucket), np.int32)
    out[0, :len(toks)] = toks
    return out


def test_decode_freezes_inactive_rows(hybrid):
    """Three rows prefilled, then decode steps with row 1 inactive: its
    recurrent state keeps its bits; rows 0 and 2 advance as they do with
    every row active, and as the reference's do under the same mask."""
    jcfg, cfg, jp, tp = hybrid
    rng = np.random.default_rng(2)
    jc = jinit_cache(jcfg, 3, 128, dtype=jnp.float32)
    tc = init_cache(cfg, 3, 128, dtype=torch.float32, device="cpu")
    for slot, n in enumerate((20, 9, 30)):
        p = _pad(rng.integers(0, cfg.vocab_size, n), 32)
        _, jc, _ = jprefill(jp, jcfg, jnp.asarray(p), n, jc, slot)
        _, tc, _ = tprefill(tp, cfg, torch.from_numpy(p), n, tc, slot)
    full = [tuple({k: v.clone() for k, v in d.items()} for d in st)
            for st in tc]
    before = [[{k: v[:, 1].clone() for k, v in d.items() if k in ("h",
                                                                   "conv")}
               for d in st] for st in tc]
    pos = np.array([20, 9, 30], np.int32)
    active = np.array([True, False, True])
    tok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    for step in range(3):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc,
                         jnp.asarray(pos + step), active=jnp.asarray(active))
        tl, tc = tdecode(tp, cfg, torch.from_numpy(tok), tc,
                         torch.from_numpy(pos + step),
                         active=torch.from_numpy(active))
        fl, full = tdecode(tp, cfg, torch.from_numpy(tok), full,
                           torch.from_numpy(pos + step))
        _close(tl, np.asarray(jl), 1e-4)
        assert torch.equal(tl[[0, 2]], fl[[0, 2]])
    n = 0
    for si, st in enumerate(tc):
        for bi, d in enumerate(st):
            if "h" not in d:
                continue
            for k in ("h", "conv"):
                assert torch.equal(d[k][:, 1], before[si][bi][k])
                assert torch.equal(d[k][:, [0, 2]], full[si][bi][k][:, [0, 2]])
                _close(d[k], np.asarray(jc[si][bi][k]), 1e-4)
                n += 1
    assert n == 2 * 2          # two rglru blocks, two leaves each


def test_first_chunk_starts_from_a_zero_row(hybrid):
    """Row 0 holds a 50-token stream; a new stream's 40-token prompt is then
    chunked into it (32 + 8).  The port's logits equal those of the same
    chunks into a fresh cache, bit for bit; the reference's chunk mode
    resumes the first chunk from the old stream's state, so its logits
    move away from its own fresh-cache logits."""
    jcfg, cfg, jp, tp = hybrid
    rng = np.random.default_rng(4)
    old = rng.integers(0, cfg.vocab_size, 50)
    new = rng.integers(0, cfg.vocab_size, 40)

    def chunks(fn, params, c, conv):
        out = None
        for start in (0, 32):
            m = min(32, 40 - start)
            out, c = fn(params, cfg_of[fn], conv(_pad(new[start:start + m],
                                                      32)), start, m, c, 0)
        return np.asarray(out)

    cfg_of = {jchunk: jcfg, tchunk: cfg}
    to_j, to_t = jnp.asarray, torch.from_numpy
    dirty_j = jinit_cache(jcfg, 1, 128, dtype=jnp.float32)
    dirty_t = init_cache(cfg, 1, 128, dtype=torch.float32, device="cpu")
    for start in (0, 32):
        m = min(32, 50 - start)
        p = _pad(old[start:start + m], 32)
        _, dirty_j = jchunk(jp, jcfg, to_j(p), start, m, dirty_j, 0)
        _, dirty_t = tchunk(tp, cfg, to_t(p), start, m, dirty_t, 0)
    fresh_t = chunks(tchunk, tp, init_cache(cfg, 1, 128, dtype=torch.float32,
                                            device="cpu"), to_t)
    reused_t = chunks(tchunk, tp, dirty_t, to_t)
    np.testing.assert_array_equal(reused_t, fresh_t)
    fresh_j = chunks(jchunk, jp, jinit_cache(jcfg, 1, 128,
                                             dtype=jnp.float32), to_j)
    reused_j = chunks(jchunk, jp, dirty_j, to_j)
    np.testing.assert_allclose(fresh_t, fresh_j, atol=1e-4, rtol=1e-4)
    assert np.abs(reused_j - fresh_j).max() > 1e-2
