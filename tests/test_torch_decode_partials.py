"""The sequence-sharded decode's kernel routes on the CPU: the span-partial
route of ``decode_attention`` and ``decode_attention_q8`` over key ranges
cut at span boundaries and elsewhere, gathered in range order and folded
by the combine route, against the whole-cache decode's plain version
(float32, within 1e-6) and the reference's oracle (within the kernel
tests' 2e-5), on ``tests/test_torch_kernels.py``'s decode cases; and the
dry-run's shape-only route of every decode wrapper, which fake tensors
alone take."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as D
from repro_torch.kernels import decode_attention_q8 as Q
from repro_torch.kernels import paged_decode_attention as PD
from repro_torch.models.kvcache import quantize_kv
from test_torch_kernels import DECODE_CASES, _decode_inputs
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

# ranges a row's keys are cut into: one (the whole cache), two, and ranges
# of 64 keys (half a span)
CUTS = {"one": lambda Sk: 1, "two": lambda Sk: 2,
        "half_spans": lambda Sk: Sk // 64}
TOL = 1e-6


def _serving(case):
    """A decode case in the serving layout, float32: q (B, 1, Hq, hd), k,
    v (B, Sk, KH, hd), k_pos, q_pos."""
    qn, kn, vn, kp, qp = _decode_inputs(case, "float32")
    return (torch.from_numpy(qn)[:, None],
            torch.from_numpy(kn).transpose(1, 2),
            torch.from_numpy(vn).transpose(1, 2),
            torch.from_numpy(kp), torch.from_numpy(qp))


def _split(partial, q, kv, kp, qp, R, **kw):
    """R equal ranges' partials, stacked in range order (the gather), and
    the combine route."""
    B, _, Hq, hd = q.shape
    KH = kv[0].shape[2]
    n = kp.shape[1] // R
    parts = torch.stack([partial(q, *(t[:, r * n:(r + 1) * n] for t in kv),
                                 kp[:, r * n:(r + 1) * n], qp, **kw)
                         for r in range(R)])
    assert parts.shape == (R, D.split_geometry(n, B, KH, Hq // KH, hd)[1])
    return D.decode_combine(parts, B, KH, Hq // KH, hd, q.dtype)


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("case", DECODE_CASES)
def test_partials_and_combine_equal_the_whole_decode(case, cut):
    """Partials of R ranges + combine == ``decode_attention_plain`` on the
    whole cache within 1e-6 (float32), and the reference's oracle within
    2e-5; a row with no valid key gives zeros."""
    win = case[5]
    q, k, v, kp, qp = _serving(case)
    R = CUTS[cut](k.shape[1])
    got = _split(D.decode_attention_partials, q, (k, v), kp, qp, R,
                 window=win)
    want = D.decode_attention_plain(q, k, v, kp, qp, window=win)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    ref = jref.reference_decode_attention(
        jnp.asarray(q[:, 0].numpy()), jnp.asarray(k.transpose(1, 2).numpy()),
        jnp.asarray(v.transpose(1, 2).numpy()), jnp.asarray(kp.numpy()),
        jnp.asarray(qp.numpy()), window=win)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)
    if case[-1]:
        assert not got[1].any()


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("case", [DECODE_CASES[0], DECODE_CASES[2],
                                  DECODE_CASES[5]])
def test_int8_partials_and_combine_equal_the_whole_decode(case, cut):
    """The int8 route's partials + combine == ``decode_attention_q8_plain``
    on the whole int8 cache within 1e-6, float32 q and bf16 q alike (the
    combine casts once, at the end)."""
    win = case[5]
    q, k, v, kp, qp = _serving(case)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    R = CUTS[cut](k.shape[1])
    for qd in (q, q.to(torch.bfloat16)):
        got = _split(Q.decode_attention_q8_partials, qd, (kq, ks, vq, vs),
                     kp, qp, R, window=win)
        want = Q.decode_attention_q8_plain(qd, kq, ks, vq, vs, kp, qp,
                                           window=win)
        assert got.dtype == qd.dtype
        tol = TOL if qd.dtype == torch.float32 else 1e-2
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   atol=tol, rtol=tol)


def test_partial_layout_and_empty_spans():
    """The partials' layout is the kernel scratch's (acc then (m, l), span
    j holding keys j*SPAN ...), an empty span is (-1e30, 0), and spans
    count from the range's first key: a range of whole spans gives the
    whole cache's partials of those spans, bit for bit."""
    case = DECODE_CASES[0]
    q, k, v, kp, qp = _serving(case)
    B, _, Hq, hd = q.shape
    KH = k.shape[2]
    G = Hq // KH
    whole = D.decode_attention_partials(q, k, v, kp, qp)
    acc, ml = D.partial_views(whole, B, KH, G, hd)
    spans = acc.shape[3]
    assert spans == k.shape[1] // D.SPAN
    hi = D.decode_attention_partials(q, k[:, D.SPAN:], v[:, D.SPAN:],
                                     kp[:, D.SPAN:], qp)
    acc2, ml2 = D.partial_views(hi, B, KH, G, hd)
    assert torch.equal(acc2[0], acc[0, :, :, 1:])
    assert torch.equal(ml2[0], ml[0, :, :, 1:])
    # keys past q_pos (300) only: spans 3.. of a 512-key row are empty
    assert (ml[0, :, :, 3:, :, 0] == D.NEG_INF).all()
    assert (ml[0, :, :, 3:, :, 1] == 0).all()


def test_real_tensors_never_take_the_shape_only_route():
    """Real CPU tensors get the plain versions and count no fake work;
    fake tensors of either device get outputs of the kernels' shapes and
    dtypes, one count each, and launch nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, Sk, KH, Hq, hd, P, ps = 2, 256, 2, 8, 64, 9, 16
    q, k, v, kp, qp = _serving(DECODE_CASES[0])
    before = json.dumps(_build.fake_work, sort_keys=True)
    D.decode_combine(D.decode_attention_partials(q, k, v, kp, qp),
                     *q.shape[:1], k.shape[2], q.shape[2] // k.shape[2],
                     q.shape[3], q.dtype)
    kq, ks = quantize_kv(k)
    Q.decode_attention_q8_partials(q, kq, ks, kq, ks, kp, qp)
    assert json.dumps(_build.fake_work, sort_keys=True) == before
    launches = (D.launches, D.partial_launches, D.combine_launches,
                Q.launches, Q.partial_launches, PD.launches, PD.q8_launches)
    for device in ("cpu", "cuda"):
        n = dict(_build.fake_work["calls"])
        with FakeTensorMode():
            fq = torch.empty(B, 1, Hq, hd, device=device,
                             dtype=torch.bfloat16)
            fk = torch.empty(B, Sk, KH, hd, device=device,
                             dtype=torch.bfloat16)
            f8 = torch.empty(B, Sk, KH, hd, device=device, dtype=torch.int8)
            fs = torch.empty(B, Sk, KH, 1, device=device)
            fkp = torch.empty(B, Sk, device=device, dtype=torch.int32)
            fqp = torch.empty(B, device=device, dtype=torch.int32)
            pool = torch.empty(P, ps, KH, hd, device=device,
                               dtype=torch.bfloat16)
            pool8 = torch.empty(P, ps, KH, hd, device=device,
                                dtype=torch.int8)
            pool_s = torch.empty(P, ps, KH, 1, device=device)
            table = torch.empty(B, 4, device=device, dtype=torch.int32)
            outs = [D.decode_attention(fq, fk, fk, fkp, fqp),
                    Q.decode_attention_q8(fq, f8, fs, f8, fs, fkp, fqp),
                    PD.paged_decode_attention(fq, pool, pool, table, fqp),
                    PD.paged_decode_attention(fq, pool8, pool8, table, fqp,
                                              k_scale=pool_s,
                                              v_scale=pool_s)]
            part = D.decode_attention_partials(fq, fk, fk, fkp, fqp)
            part8 = Q.decode_attention_q8_partials(fq, f8, fs, f8, fs, fkp,
                                                   fqp)
            comb = D.decode_combine(torch.stack([part, part8]), B, KH,
                                    Hq // KH, hd, torch.bfloat16)
        n_part = D.split_geometry(Sk, B, KH, Hq // KH, hd)[1]
        assert all(o.shape == fq.shape and o.dtype == fq.dtype
                   and o.device.type == device for o in outs + [comb])
        assert part.shape == part8.shape == (n_part,)
        assert part.dtype == torch.float32
        for name in ("decode_attention", "decode_attention_q8",
                     "paged_decode_attention", "paged_decode_attention/q8",
                     "decode_attention/partials",
                     "decode_attention_q8/partials",
                     "decode_attention/combine"):
            assert _build.fake_work["calls"][name] == n.get(name, 0) + 1
    assert launches == (D.launches, D.partial_launches, D.combine_launches,
                        Q.launches, Q.partial_launches, PD.launches,
                        PD.q8_launches)


def test_shape_only_counts_are_the_bounds_units():
    """The shape-only route counts a decode as the kernels' bounds do:
    every key's K and V rows and position read once, q and q_pos read,
    the output written; 4 * hd operations per (query head, key)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, Sk, KH, Hq, hd = 8, 2048, 2, 12, 128
    f0, b0 = _build.fake_work["flops"], _build.fake_work["bytes"]
    with FakeTensorMode():
        fq = torch.empty(B, 1, Hq, hd, dtype=torch.bfloat16)
        fk = torch.empty(B, Sk, KH, hd, dtype=torch.bfloat16)
        D.decode_attention(fq, fk, fk, torch.empty(B, Sk, dtype=torch.int32),
                           torch.empty(B, dtype=torch.int32))
    assert _build.fake_work["flops"] - f0 == 4 * B * Sk * Hq * hd
    assert _build.fake_work["bytes"] - b0 == \
        B * Sk * (KH * 2 * hd * 2 + 4) + B * 4 + 2 * B * Hq * hd * 2
