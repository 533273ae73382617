"""Training on every architecture against the reference on the CPU: the
training half of ``tests/test_arch_smoke.py`` for the port.

For each of the 11 ``ARCH_IDS``, ``.smoke()`` in float32 at S 96 (past the
smoke window of 64; prefix embeddings for llava and musicgen), the same
weights bridged from the reference: ``forward_train``'s logits and aux
loss, ``loss_fn``'s value and every gradient leaf with the cross-entropy
in chunks (``ce_chunk`` 40 < T 95, padded and masked), and one
``make_train_step`` step's params and metrics.  The reference side is one
jitted function per arch (static config).

Tolerances: logits 1e-4 (the serve paths' arch tests), loss rtol 1e-5,
gradients atol 1e-5 + rtol 1e-4 (float32 sums in another order).  The
step runs at lr 1e-2 with no warmup, so that its update (about lr x
sign(g) per element) stands far above its tolerance; ``assert_step_matches``
holds AdamW's m and v on every element and the update on every element
whose gradient is not at rounding level.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as J
from repro.configs import get_config as jget_config
from repro.models import NOSHARD
from repro.training import (AdamWConfig as JAdamW,
                            init_opt_state as jinit_opt,
                            make_train_step as jmake_step)

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import forward_train, loss_fn, params_from_numpy
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step)
from repro_torch.training.pytree import leaves, unflatten
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

S, B, CE_CHUNK = 96, 2, 40
# the step's optimizer: the first update is about lr x sign(g) = 1e-2 per
# element, ten thousand times the update's atol in ``assert_step_matches``
STEP_CFG = dict(lr=1e-2, warmup_steps=0)


def port_arrays(state):
    """(params, m, v) of a port train state: lists of numpy leaves."""
    return tuple([x.detach().float().numpy() for x in leaves(t)]
                 for t in (state["params"], state["opt"]["m"],
                           state["opt"]["v"]))


def ref_arrays(state):
    """(params, m, v) of a reference train state: lists of numpy leaves."""
    return tuple([np.asarray(x, np.float32) for x in jax.tree.leaves(t)]
                 for t in (state["params"], state["opt"]["m"],
                           state["opt"]["v"]))


def assert_step_matches(p0, got, want, what):
    """One AdamW step from params ``p0`` against another: ``got`` and
    ``want`` are (params, m, v) leaf lists.  m (0.1 g) and v (0.05 g^2
    after one step, g clipped) on every element at rtol 1e-4, atol 1e-8
    and 1e-10 (float32 gradients summed in another order); the update
    (new - p0) within 1e-6 on every element whose clipped gradient in
    ``want`` exceeds 1e-5 (|m| > 1e-6), or is zero on both sides.  Below
    that the gradient is at rounding level and Adam's g / (|g| + eps) may
    turn either way.  At least 90% of the elements are held."""
    assert len({len(p0)} | {len(x) for x in got + want}) == 1, what
    held = total = 0
    for i, (x0, p, m, v, wp, wm, wv) in enumerate(zip(p0, *got, *want)):
        msg = f"{what} leaf {i}"
        np.testing.assert_allclose(m, wm, rtol=1e-4, atol=1e-8, err_msg=msg)
        np.testing.assert_allclose(v, wv, rtol=1e-4, atol=1e-10, err_msg=msg)
        keep = (np.abs(wm) > 1e-6) | ((wm == 0) & (m == 0))
        np.testing.assert_allclose((p - x0)[keep], (wp - x0)[keep], rtol=0,
                                   atol=1e-6, err_msg=msg)
        held += int(keep.sum())
        total += keep.size
    assert held >= 0.9 * total, (what, held, total)


def _reference(jcfg):
    step = jmake_step(jcfg, JAdamW(**STEP_CFG), NOSHARD, 1)

    def run(params, batch):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: J.loss_fn(p, jcfg, batch, ce_chunk=CE_CHUNK),
            has_aux=True)(params)
        logits, aux = J.forward_train(params, jcfg, batch["tokens"],
                                      batch.get("prefix_embeds"))
        new, out = step({"params": params, "opt": jinit_opt(params)}, batch)
        return loss, metrics, grads, logits, aux, new, out

    return jax.jit(run)


@pytest.fixture(scope="module", params=ARCH_IDS)
def model(request):
    arch = request.param
    jcfg = jget_config(arch).smoke().replace(dtype="float32")
    cfg = get_config(arch).smoke().replace(dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = J.init_params(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.num_prefix_embeds:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    want = _reference(jcfg)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return arch, cfg, tp, tb, jax.tree.map(np.asarray, want)


def test_forward_train_matches_reference(model):
    arch, cfg, tp, tb, want = model
    with torch.no_grad():
        logits, aux = forward_train(tp, cfg, tb["tokens"],
                                    tb.get("prefix_embeds"))
    assert logits.shape == want[3].shape, arch
    np.testing.assert_allclose(logits.numpy(), want[3], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want[4]), rtol=1e-5,
                               atol=1e-7)


def test_loss_and_every_grad_match_reference(model):
    arch, cfg, tp, tb, want = model
    jloss, jmetrics, jgrads = want[:3]
    flat = [p.detach().requires_grad_(True) for p in leaves(tp)]
    loss, metrics = loss_fn(unflatten(tp, flat), cfg, tb, ce_chunk=CE_CHUNK)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-7)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads), arch
    for i, (g, w) in enumerate(zip(grads, jl)):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4,
                                   err_msg=f"{arch} leaf {i}")


def test_train_step_matches_reference(model):
    arch, cfg, tp, tb, want = model
    jstate, jout = want[5], want[6]
    new, out = make_train_step(cfg, AdamWConfig(**STEP_CFG), 1)(
        {"params": tp, "opt": init_opt_state(tp)}, tb)
    assert_step_matches([x.numpy() for x in leaves(tp)], port_arrays(new),
                        ref_arrays(jstate), arch)
    assert int(new["opt"]["step"]) == 1
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                               rtol=1e-5)
    for k in ("ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
