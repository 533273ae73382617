"""The port's training path against the reference on the CPU.

The kernels' autograd Functions (``FlashAttentionFn``, ``RMSNormFn``,
``AddRMSNormFn``, on the CPU their plain versions) against ``jax.grad`` of
the reference's attention and RMSNorm; ``tests/test_training.py``'s bars
in the port (the loss falls, microbatching is exact, the schedule, the
clip, checkpoints) and against the reference's step; checkpoints crossing
between the packages both ways; remat on == off; serving builds no graph;
the launcher and the example.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs import get_config as jget_config
from repro.kernels.ref import reference_attention as jref_attention
from repro.models import NOSHARD
from repro.models import layers as JL
from repro.training import (AdamWConfig as JAdamW,
                            init_opt_state as jinit_opt,
                            load_checkpoint as jload,
                            make_train_step as jmake_step,
                            save_checkpoint as jsave, schedule as jschedule)

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models import (decode_step, init_cache, init_params,
                                loss_fn, params_from_numpy,
                                prefill_into_slot)
from repro_torch.training import (AdamWConfig, adamw_update,
                                  init_opt_state, init_train_state,
                                  load_checkpoint, make_train_step,
                                  save_checkpoint, schedule)
from repro_torch.training.pytree import leaves, unflatten
from test_torch_train_arch import (STEP_CFG, assert_step_matches,
                                   port_arrays, ref_arrays)
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

KEY = jax.random.PRNGKey(0)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- the kernels' Functions against jax.grad -------------------------------------

# (B, S, Hq, KH, hd, window, softcap): MHA, GQA, MQA, window, softcap, hd
# 64 / 128 / 256, ragged S (not a multiple of any tile)
FLASH_CASES = [(2, 40, 4, 4, 64, 0, 0.0), (1, 72, 6, 2, 128, 0, 0.0),
               (1, 50, 4, 1, 256, 0, 0.0), (2, 67, 4, 2, 64, 16, 0.0),
               (1, 45, 4, 2, 128, 0, 30.0), (1, 90, 4, 1, 256, 32, 50.0)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_fn_grads_match_jax(case):
    """dq, dk, dv against ``jax.grad`` of the reference's oracle (layout
    (B, H, S, hd), jitted) and the LSE route's lse against the log-sum-exp
    of its scores, float32 at 2e-5."""
    B, S, Hq, KH, hd, window, cap = case
    rng = np.random.default_rng(S)
    q, dout = (rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, S, KH, hd)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window, softcap=cap)

    def jf(q_, k_, v_):
        out = jref_attention(*(jnp.swapaxes(t, 1, 2) for t in (q_, k_, v_)),
                             **kw)
        return jnp.sum(jnp.swapaxes(out, 1, 2) * dout)

    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(q, k, v)
    leaves_ = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = FA.FlashAttentionFn.apply(*leaves_, True, window, cap, None)
    got = torch.autograd.grad(out, leaves_, torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)
    # the log-sum-exp of the reference's masked, soft-capped scores
    kr = np.repeat(k, Hq // KH, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr).astype(np.float64) * hd ** -0.5
    if cap:
        s = np.tanh(s / cap) * cap
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = (j <= i) & ((j > i - window) if window else True)
    s = np.where(mask, s, -np.inf)
    lse_want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    _, lse = FA.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                return_lse=True, **kw)
    np.testing.assert_allclose(lse.numpy(), lse_want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 128)])
def test_norm_fns_grads_match_jax(dtype, tol, shape):
    """``RMSNormFn`` (dx, dw) and ``AddRMSNormFn`` (dx, ddelta, dw, with
    gradients on both its outputs) against ``jax.grad`` of the reference's
    ``layers.rmsnorm``; the sum written out of place."""
    rng = np.random.default_rng(len(shape))
    d = shape[-1]
    x, delta, dy, ds = (rng.standard_normal(shape).astype(np.float32)
                        for _ in range(4))
    w = (rng.standard_normal(d) + 1.0).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jdelta, jdy, jds = (jnp.asarray(t).astype(jdt)
                            for t in (x, delta, dy, ds))
    tdt = getattr(torch, dtype)
    tx, tdelta, tdy, tds = (torch.from_numpy(t).to(tdt)
                            for t in (x, delta, dy, ds))

    want = jax.jit(jax.grad(lambda a, w_: jnp.sum(
        (JL.rmsnorm(a, w_) * jdy).astype(jnp.float32)), argnums=(0, 1)))(
        jx, jnp.asarray(w))
    xl, wl = tx.clone().requires_grad_(True), \
        torch.from_numpy(w).requires_grad_(True)
    got = torch.autograd.grad(RN.RMSNormFn.apply(xl, wl, 1e-6), (xl, wl),
                              tdy)
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), _np(ww), atol=tol,
                                   rtol=tol)

    def jadd(a, b, w_):
        s = a + b
        return jnp.sum((JL.rmsnorm(s, w_) * jdy).astype(jnp.float32)) \
            + jnp.sum((s * jds).astype(jnp.float32))

    want = jax.jit(jax.grad(jadd, argnums=(0, 1, 2)))(jx, jdelta,
                                                      jnp.asarray(w))
    al, bl = tx.clone().requires_grad_(True), \
        tdelta.clone().requires_grad_(True)
    wl = torch.from_numpy(w).requires_grad_(True)
    s, h = RN.AddRMSNormFn.apply(al, bl, wl, 1e-6)
    assert torch.equal(al.detach(), tx)            # x is not overwritten
    got = torch.autograd.grad((s, h), (al, bl, wl), (tds, tdy))
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), _np(ww), atol=tol,
                                   rtol=tol)


# -- tests/test_training.py's bars, in the port ------------------------------------

def test_loss_decreases_over_steps():
    cfg = get_config("qwen2-1.5b").smoke()
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    step = make_train_step(
        cfg, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60), 1)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
    losses = []
    for _ in range(30):
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]


@pytest.fixture(scope="module")
def granite():
    jcfg = jget_config("granite-8b").smoke().replace(dtype="float32")
    cfg = get_config("granite-8b").smoke().replace(dtype="float32")
    jp = J.init_params(KEY, jcfg)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu"), tokens


def test_microbatch_grad_equals_full_batch(granite):
    """4 microbatches == 1 at 2e-5 on every leaf (granite, float32), the
    reference's bar at its default optimizer; and at lr 1e-2 (an update
    far above the tolerances) the 4-microbatch step's m, v and update
    against the 1-microbatch step's and against the reference's
    4-microbatch step on the same weights (``assert_step_matches``)."""
    jcfg, cfg, jp, tp, tokens = granite
    batch = {"tokens": torch.from_numpy(tokens)}
    s1 = {"params": tp, "opt": init_opt_state(tp)}
    o1, m1 = make_train_step(cfg, AdamWConfig(), 1)(s1, batch)
    o4, m4 = make_train_step(cfg, AdamWConfig(), 4)(s1, batch)
    for a, b in zip(leaves(o1["params"]), leaves(o4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    assert float(m4["aux"]) == 0.0 and float(m4["ce"]) == float(m4["loss"])
    p0 = [x.numpy() for x in leaves(tp)]
    o1, _ = make_train_step(cfg, AdamWConfig(**STEP_CFG), 1)(s1, batch)
    o4, m4 = make_train_step(cfg, AdamWConfig(**STEP_CFG), 4)(s1, batch)
    assert_step_matches(p0, port_arrays(o4), port_arrays(o1),
                        "4 microbatches against 1")
    jstep = jax.jit(jmake_step(jcfg, JAdamW(**STEP_CFG), NOSHARD, 4))
    jo, jm = jstep({"params": jp, "opt": jinit_opt(jp)},
                   {"tokens": jnp.asarray(tokens)})
    assert_step_matches(p0, port_arrays(o4), ref_arrays(jo),
                        "4 microbatches against the reference's")
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m4[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)


def test_schedule_matches_reference():
    for cfg in (AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100),
                AdamWConfig()):
        jcfg = JAdamW(*cfg)
        steps = np.arange(0, 101, dtype=np.int32)
        got = schedule(cfg, torch.from_numpy(steps)).numpy()
        want = np.asarray(jschedule(jcfg, jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(schedule(cfg, torch.tensor(s))) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=0.05)


def test_grad_clip_limits_update():
    """The raw norm is reported; the clipped first update moves no element
    by more than lr x (1 + decay x |p|) (AdamW's first step is about
    g / |g| per element), plus one bf16 rounding of the parameter."""
    cfg = get_config("qwen2-1.5b").smoke()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    grads = unflatten(params, [torch.full(p.shape, 1e6) for p in
                               leaves(params)])
    ocfg = AdamWConfig(grad_clip=1.0)
    new, opt, metrics = adamw_update(params, grads, init_opt_state(params),
                                     ocfg)
    assert float(metrics["grad_norm"]) > 1e6
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32
    lr = float(metrics["lr"])
    for a, b in zip(leaves(params), leaves(new)):
        pmax = float(a.float().abs().max())
        bound = lr * (1 + ocfg.weight_decay * pmax) + pmax * 2 ** -8
        assert float((a.float() - b.float()).abs().max()) <= bound * 1.01


def test_checkpoint_roundtrip_and_cross_load(tmp_path):
    """bf16 params through the port's codec bit for bit; a checkpoint
    written by either package loads in the other (the same bytes but the
    treedef string), bf16 and the optimizer's int32 step included."""
    jcfg = jget_config("qwen2-1.5b").smoke()
    jp = J.init_params(KEY, jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    state = {"params": tp, "opt": init_opt_state(tp)}
    state["opt"]["step"] += 7
    path = str(tmp_path / "port.msgpack")
    save_checkpoint(path, state)
    back = load_checkpoint(path, state)
    for a, b in zip(leaves(state), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # port -> reference
    jstate = {"params": jp, "opt": jinit_opt(jp)}
    jback = jload(path, jstate)
    for a, b in zip(leaves(state), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    assert int(jback["opt"]["step"]) == 7
    # reference -> port
    rpath = str(tmp_path / "ref.msgpack")
    jsave(rpath, jstate)
    tback = load_checkpoint(rpath, state)
    for a, b in zip(jax.tree.leaves(jstate), leaves(tback)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    assert int(tback["opt"]["step"]) == 0
    # the same bytes but the treedef string
    save_checkpoint(path, {"params": tp, "opt": init_opt_state(tp)})
    import msgpack
    with open(path, "rb") as f:
        mine = msgpack.unpackb(f.read(), raw=True)
    with open(rpath, "rb") as f:
        ref = msgpack.unpackb(f.read(), raw=True)
    assert mine[b"leaves"] == ref[b"leaves"]


# -- port-internal checks ------------------------------------------------------------

def test_remat_on_equals_off_bitwise():
    cfg = get_config("gemma2-9b").smoke().replace(dtype="float32")
    params = init_params(torch.Generator().manual_seed(2), cfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int32))
    out = []
    for remat in (True, False):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, _ = loss_fn(unflatten(params, flat), cfg, {"tokens": tokens},
                          remat=remat, ce_chunk=32)
        out.append((loss.detach(), torch.autograd.grad(loss, flat)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_serving_builds_no_graph_and_adds_in_place(monkeypatch):
    """prefill_into_slot and decode_step never reach the autograd
    Functions, their outputs carry no graph, and every fused residual add
    writes into its input (the serve wrappers, as before training)."""
    cfg = get_config("qwen3-14b").smoke()        # QK norms too
    params = init_params(torch.Generator().manual_seed(3), cfg)
    inplace = []
    orig = RN.add_rmsnorm

    def add_rmsnorm(x, delta, w, eps=1e-6):
        s, h = orig(x, delta, w, eps)
        inplace.append(s is x)
        return s, h

    def refuse(*a, **k):
        raise AssertionError("a serve path reached an autograd Function")

    monkeypatch.setattr(RN, "add_rmsnorm", add_rmsnorm)
    for fn in (RN.RMSNormFn, RN.AddRMSNormFn, FA.FlashAttentionFn):
        monkeypatch.setattr(fn, "apply", refuse)
    caches = init_cache(cfg, 2, 64, device="cpu")
    toks = torch.from_numpy(np.arange(16, dtype=np.int32)[None] % 50)
    logits, caches, pos = prefill_into_slot(params, cfg, toks, 12, caches, 1)
    assert logits.grad_fn is None and not logits.requires_grad
    logits, caches = decode_step(params, cfg, torch.tensor([[3], [4]]),
                                 caches, torch.tensor([5, 12]))
    assert logits.grad_fn is None and not logits.requires_grad
    assert inplace and all(inplace)


def test_launch_train_runs_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import main
    main(["--arch", "qwen2-1.5b", "--device", "cpu", "--steps", "2",
          "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step   0 loss" in out and "step   1 loss" in out
    # the reference's default mode reads --multi-pod and --strategy only
    # under --dry-run: it trains with them, ignoring them
    for flag in (["--multi-pod"], ["--strategy", "fsdp"]):
        main(["--arch", "qwen2-1.5b", "--device", "cpu", "--steps", "2",
              "--batch", "2", "--seq", "16", *flag])
        again = capsys.readouterr().out
        assert again == out, flag
    # --dry-run traces the full config's train_4k step as the reference's
    # does (tests/test_torch_dryrun.py runs it whole)
    calls = []
    monkeypatch.setattr(dryrun, "run_one",
                        lambda *a, **kw: calls.append((a, kw)))
    main(["--arch", "qwen2-1.5b", "--device", "cpu", "--dry-run",
          "--multi-pod", "--strategy", "fsdp"])
    assert calls == [(("qwen2-1.5b", "train_4k", True),
                      {"outdir": "results/dryrun/manual",
                       "strategy": "fsdp", "device": "cpu"})]


def test_train_small_example_checkpoint_loads_in_reference(tmp_path, capsys):
    from repro.models import ModelConfig as JModelConfig
    from repro_torch.examples import train_small
    path = str(tmp_path / "ckpt.msgpack")
    train_small.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                      "--seq", "16", "--ckpt", path])
    assert "checkpoint ->" in capsys.readouterr().out
    import dataclasses
    jcfg = JModelConfig(**dataclasses.asdict(train_small.CFG))
    like = jax.eval_shape(lambda: J.init_params(KEY, jcfg))
    loaded = jload(path, like)
    assert [x.shape for x in jax.tree.leaves(loaded)] == \
        [x.shape for x in jax.tree.leaves(like)]
    assert all(np.isfinite(np.asarray(x, np.float32)).all()
               for x in jax.tree.leaves(loaded))
