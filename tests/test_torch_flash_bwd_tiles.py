"""The arithmetic of the bf16 flash-attention backward kernel, on the CPU.

``csrc/flash_attention_bwd.cu`` runs on the tensor cores: bf16 operands,
float32 accumulation, a CTA's sum taken tile by tile in a fixed order.  P
and dS are float32 in registers; where one is the operand of a product it
is split into hi = bf16(x) and lo = bf16(x - hi) and taken twice.  The dK /
dV kernel takes one CTA per (key tile, query head, batch row) and writes
that head's float32 partial; a second launch sums a kv head's G partials in
head order and casts once.  The dQ kernel takes one CTA per (query tile,
query head, batch row) over the key tiles the forward visits.

The kernel does not run here, so ``flash_bwd_mirror`` repeats those steps
in plain torch (float32 inputs take float32 operands, as the kernel's
float32 route does) and is held against ``jax.grad`` of the reference's
attention oracle on ``tests/test_torch_kernels.py``'s cases, 2e-2 in bf16
and 2e-5 in float32, and within one bf16 rounding of the plain backward
(``BF16_ROUNDING``: atol 1e-3 + rtol 1e-2, the kernels phase's bar in
``chip_smoke.py``).  With the split turned off (one bf16 rounding of P and
dS) the mirror misses that bar, which is why the kernel splits both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import reference_attention as jref_attention

from repro_torch.kernels import flash_attention as FA

from test_torch_kernels import DTYPES, FLASH_CASES
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

BF16_ROUNDING = (1e-3, 1e-2)   # atol, rtol: one bf16 rounding apart
# the kernel's tiles: a streamed tile and a dQ CTA hold C rows, a dK / dV
# CTA BWD_KEY_ROWS[hd] keys (32 at hd 256)
C = FA.BWD_TILE


def _operand(x, bf16, split):
    """x as the A operand of a product: itself in float32, else its bf16
    terms, hi alone or hi and lo."""
    if not bf16:
        return [x]
    hi = x.to(torch.bfloat16)
    if not split:
        return [hi.float()]
    return [hi.float(), (x - hi.float()).to(torch.bfloat16).float()]


def flash_bwd_mirror(q, k, v, out, lse, dout, *, causal=True, window=0,
                     softcap=0.0, scale=None, split_p=True, split_ds=True):
    """(dq, dk, dv) in the layouts of q, k, v, by the kernel's steps: q,
    out, dout (B, Sq, Hq, hd); k, v (B, Sk, KH, hd); lse (B, Hq, Sq)."""
    bf16 = q.dtype == torch.bfloat16
    B, Sq, Hq, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = Hq // KH
    scale = hd ** -0.5 if scale is None else scale
    qf, gf, of = (t.float().transpose(1, 2) for t in (q, dout, out))
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(G, 1)
              for t in (k, v))
    D = (gf * of).sum(-1)   # the pre-pass, from the stored out

    def p_ds(q0, q1, k0, k1):
        """P and dS of queries q0 .. q1 - 1 against keys k0 .. k1 - 1."""
        s = qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)
        dp = gf[:, :, q0:q1] @ vf[:, :, k0:k1].transpose(-1, -2)
        x = s * scale
        dx = torch.full_like(x, scale)
        if softcap:
            t = torch.tanh(x / softcap)
            x, dx = t * softcap, scale * (1 - t * t)
        i = torch.arange(q0, q1)[:, None]
        j = torch.arange(k0, k1)[None, :]
        vis = (j <= i) if causal else torch.ones_like(i >= j)
        if window:
            vis = vis & (j > i - window)
        p = torch.where(vis, torch.exp(x - lse[:, :, q0:q1, None]), 0.0)
        return p, p * (dp - D[:, :, q0:q1, None]) * dx

    # dK, dV: a float32 partial per (key tile, query head), query tiles in
    # order from the first that sees the tile
    R = FA.BWD_KEY_ROWS[hd]
    dk_part = torch.zeros(B, Hq, Sk, hd)
    dv_part = torch.zeros(B, Hq, Sk, hd)
    for k0 in range(0, Sk, R):
        k1 = min(Sk, k0 + R)
        q_lo = (k0 // C) * C if causal else 0
        q_hi = min(Sq, k0 + R - 1 + window) if window else Sq
        for q0 in range(q_lo, q_hi, C):
            q1 = min(Sq, q0 + C)
            p, ds = p_ds(q0, q1, k0, k1)
            for a in _operand(p, bf16, split_p):
                dv_part[:, :, k0:k1] += a.transpose(-1, -2) @ gf[:, :, q0:q1]
            for a in _operand(ds, bf16, split_ds):
                dk_part[:, :, k0:k1] += a.transpose(-1, -2) @ qf[:, :, q0:q1]
    # a kv head's G partials summed in head order
    dk = dk_part.reshape(B, KH, G, Sk, hd)
    dv = dv_part.reshape(B, KH, G, Sk, hd)
    dk_sum, dv_sum = dk[:, :, 0], dv[:, :, 0]
    for g in range(1, G):
        dk_sum = dk_sum + dk[:, :, g]
        dv_sum = dv_sum + dv[:, :, g]

    # dQ: 64 queries per CTA, key tiles in order from the first the
    # forward visits
    dq = torch.zeros(B, Hq, Sq, hd)
    for q0 in range(0, Sq, C):
        q1 = min(Sq, q0 + C)
        k_hi = min(Sk, q1) if causal else Sk
        k_lo = max(0, q0 - window + 1) if window else 0
        for k0 in range((k_lo // C) * C, k_hi, C):
            k1 = min(Sk, k0 + C)
            _, ds = p_ds(q0, q1, k0, k1)
            for a in _operand(ds, bf16, split_ds):
                dq[:, :, q0:q1] += a @ kf[:, :, k0:k1]
    return (dq.transpose(1, 2).to(q.dtype), dk_sum.transpose(1, 2).to(k.dtype),
            dv_sum.transpose(1, 2).to(v.dtype))


def _inputs(case, dtype, B=None):
    """q, k, v, dout in the kernel's layout from a numpy seed, and out, lse
    of the forward's plain LSE route."""
    B0, Hq, KH, S, hd, window, cap = case
    rng = np.random.default_rng(sum(case[:5]))
    q, dout = (rng.standard_normal((B or B0, S, Hq, hd), np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B or B0, S, KH, hd), np.float32)
            for _ in range(2))
    td = DTYPES[dtype][1]
    q, k, v, dout = (torch.from_numpy(t).to(td) for t in (q, k, v, dout))
    kw = dict(causal=True, window=window, softcap=cap)
    out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    return (q, k, v, out, lse, dout), kw


def _bf16_share(got, want):
    """The largest share of one bf16 rounding (atol + rtol |want|) that the
    difference uses."""
    atol, rtol = BF16_ROUNDING
    w = want.float()
    return float(((got.float() - w).abs() / (atol + rtol * w.abs())).max())


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mirror_matches_jax_grad_and_plain(case, dtype):
    """The mirror against ``jax.grad`` of the reference's oracle (bf16
    inputs widened, so that the gradient is the true one of the rounded
    inputs) at the dtype's tolerance, and in bf16 within one rounding of
    the plain backward."""
    args, kw = _inputs(case, dtype)
    q, k, v, out, lse, dout = args
    got = flash_bwd_mirror(*args, **kw)
    tol = DTYPES[dtype][2]
    g = dout.float().numpy()

    def jf(q_, k_, v_):
        o = jref_attention(*(jnp.swapaxes(t, 1, 2) for t in (q_, k_, v_)),
                           **kw)
        return jnp.sum(jnp.swapaxes(o, 1, 2) * g)

    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(
        *(t.float().numpy() for t in (q, k, v)))
    for a, w in zip(got, want):
        assert a.dtype == q.dtype
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w),
                                   atol=tol, rtol=tol)
    plain = FA.flash_attention_bwd_plain(*args, **kw)
    if dtype == "bfloat16":
        for name, a, w in zip(("dq", "dk", "dv"), got, plain):
            assert _bf16_share(a, w) <= 1, name


@pytest.mark.parametrize("case", FLASH_CASES)
def test_single_rounding_misses_the_bar(case):
    """With P or dS rounded once to bf16 (no lo term) the mirror falls
    outside one bf16 rounding of the plain backward in the gradients that
    product feeds, at every case: P in dv, dS in dq and dk (2-9x the bar:
    a gradient is a sum of terms that can cancel to near 0).  So the
    kernel splits both; with both split, every gradient is inside."""
    args, kw = _inputs(case, "bfloat16")
    plain = FA.flash_attention_bwd_plain(*args, **kw)
    shares = {}
    for split_p, split_ds in ((True, True), (False, True), (True, False)):
        got = flash_bwd_mirror(*args, split_p=split_p, split_ds=split_ds,
                               **kw)
        shares[split_p, split_ds] = [_bf16_share(a, w)
                                     for a, w in zip(got, plain)]
    assert max(shares[True, True]) <= 1, shares
    assert shares[False, True][2] > 1, shares         # dv, P rounded once
    assert min(shares[True, False][:2]) > 1, shares   # dq, dk, dS once


def test_batch_row_bits_alone_equal_batched():
    """A batch row's dq, dk and dv carry the same bits computed alone as
    in a batch of 3: no sum crosses batch rows, and every sum has one
    order."""
    case = FLASH_CASES[1]
    args, kw = _inputs(case, "bfloat16", B=3)
    batched = flash_bwd_mirror(*args, **kw)
    alone = flash_bwd_mirror(*(t[:1] for t in args), **kw)
    for a, w in zip(alone, batched):
        assert torch.equal(a, w[:1])
