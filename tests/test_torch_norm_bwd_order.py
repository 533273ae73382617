"""The order of the RMSNorm backward kernel's sums, on the CPU.

``csrc/rmsnorm.cu``'s ``rmsnorm_bwd`` takes a row with a group of
``lanes`` threads, each holding ``vpt`` 16-byte vectors (t, t + lanes, ...):
each thread sums its vectors' elements in order (sum x^2 and sum x * w * dy),
an xor butterfly adds the group's lanes (within a warp), and a group of
several warps adds its warps' sums in warp order.  dx of a row comes from
that row alone.  dw: a CTA's G groups take its contiguous rows j, j + G,
..., each thread adding dy * x_hat for its columns across its rows; the
groups are combined in group order into one float32 partial row per CTA,
and a second launch sums the partial rows per column, each warp of a
32-column strip a contiguous run of partial rows in order, then the warps
in warp order.  Every count comes from the wrapper's ``bwd_geometry``.

The kernel does not run here, so ``norm_bwd_mirror`` repeats those steps in
float32 torch (its products round apart where the card fuses them: it holds
the order, not the bits) and is held against ``jax.grad`` of the
reference's ``layers.rmsnorm`` and against the plain version: dx within
2e-2 (bf16) / 2e-5 (float32), dw within 1e-4, at ``chip_smoke.py``'s
NORM_SHAPES widths with their rows cut to CPU size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch.kernels import rmsnorm as RN
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),
          "float32": (jnp.float32, torch.float32, 2e-5)}
# NORM_SHAPES widths, rows cut: qwen2's train rows (several CTAs of 4
# one-warp groups), the QK norm's head rows (half-warp groups, 8 a CTA),
# 10008 (a group of 7 or 10 warps), gemma2's train width (3 warps), 2048
# (two-warp groups in bf16), mamba2's 1024
NORM_CASES = [(600, 1536), (2100, 128), (4, 10008), (40, 3584), (70, 2048),
              (8, 1024)]


def norm_bwd_mirror(x, w, dy, eps=1e-6, ds=None):
    """(dx like x, dw float32 (d,)) for x, dy (rows, d) by the kernel's
    steps; ``ds`` (like x) is added to dx."""
    rows, d = x.shape
    geo = RN.bwd_geometry(rows, d, x.dtype)
    L, V, G, rpc = geo.lanes, geo.vpt, geo.groups, geo.rows_per_cta
    n = 16 // x.dtype.itemsize
    nv = d // n
    xf, gf = x.float(), dy.float()
    wf = w.float()

    def lanes_view(t):   # (rows, d) -> (rows, V, L, n): vector t + i L
        pad = torch.zeros(t.shape[0], V * L * n)
        pad[:, :d] = t
        return pad.reshape(t.shape[0], V, L, n)
    xv, gv = lanes_view(xf), lanes_view(gf)
    wv = lanes_view(wf[None])[0]
    held = (torch.arange(V * L) < nv).reshape(V, L)
    ss = torch.zeros(rows, L)
    sg = torch.zeros(rows, L)
    for i in range(V):
        for j in range(n):
            e, g = xv[:, i, :, j], gv[:, i, :, j]
            ss = torch.where(held[i], ss + e * e, ss)
            sg = torch.where(held[i], sg + e * (g * wv[i, :, j]), sg)
    o = min(L, 32) // 2
    while o:
        partner = torch.arange(L) ^ o
        ss, sg = ss + ss[:, partner], sg + sg[:, partner]
        o //= 2
    tss, tsg = torch.zeros(rows), torch.zeros(rows)
    for k in range(max(1, L // 32)):   # the warps' sums in warp order
        tss, tsg = tss + ss[:, 32 * k], tsg + sg[:, 32 * k]
    inv = torch.rsqrt(tss / d + eps)[:, None]
    m = inv * tsg[:, None] / d
    xh = xf * inv
    dx = (gf * wf - xh * m) * inv
    if ds is not None:
        dx = ds.float() + dx

    # dw: per CTA, group j's rows j, j + G, ... in order, then the groups
    contrib = torch.zeros(geo.ctas * rpc, d)
    contrib[:rows] = gf * xh
    steps = rpc // G
    contrib = contrib.reshape(geo.ctas, steps, G, d)
    real = (torch.arange(geo.ctas * rpc) < rows).reshape(geo.ctas, steps, G)
    acc = torch.zeros(geo.ctas, G, d)
    for k in range(steps):
        acc = torch.where(real[:, k, :, None], acc + contrib[:, k], acc)
    part = acc[:, 0]
    for j in range(1, G):
        part = part + acc[:, j]
    # dw's sum: warp k of a strip the partial rows [k q, (k + 1) q)
    nw = geo.sum_warps
    q = -(-geo.ctas // nw)
    dw = torch.zeros(d)
    for k in range(nw):
        s = torch.zeros(d)
        for p in range(k * q, min(geo.ctas, (k + 1) * q)):
            s = s + part[p]
        dw = dw + s
    return dx.to(x.dtype), dw


def _inputs(rows, d, dtype, seed=0):
    rng = np.random.default_rng(seed + rows + d)
    x, dy, ds = (rng.standard_normal((rows, d)).astype(np.float32)
                 for _ in range(3))
    w = (rng.standard_normal(d) + 1.0).astype(np.float32)
    td = DTYPES[dtype][1]
    return (*(torch.from_numpy(t).to(td) for t in (x, dy, ds)),
            torch.from_numpy(w))


def _jax_grads(x, w, dy, ds, jdt):
    """dx (+ ds) and dw by ``jax.grad`` of the reference's rmsnorm."""
    jx, jdy, jds = (None if t is None else
                    jnp.asarray(t.float().numpy()).astype(jdt)
                    for t in (x, dy, ds))

    def f(a, w_):
        out = jnp.sum((JL.rmsnorm(a, w_) * jdy).astype(jnp.float32))
        if ds is not None:
            out = out + jnp.sum((a * jds).astype(jnp.float32))
        return out
    return jax.jit(jax.grad(f, argnums=(0, 1)))(jx, jnp.asarray(w.numpy()))


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", NORM_CASES)
def test_mirror_matches_jax_grad_and_plain(shape, dtype, with_ds):
    """The mirror's dx and dw against ``jax.grad`` of the reference's
    ``layers.rmsnorm`` and against ``rmsnorm_bwd_ref``: dx at the dtype's
    tolerance, dw (float32 column sums) within 1e-4."""
    rows, d = shape
    x, dy, ds, w = _inputs(rows, d, dtype)
    ds = ds if with_ds else None
    dx, dw = norm_bwd_mirror(x, w, dy, 1e-6, ds)
    assert dx.dtype == x.dtype and dw.dtype == torch.float32
    tol = DTYPES[dtype][2]
    jdx, jdw = _jax_grads(x, w, dy, ds, DTYPES[dtype][0])
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-4,
                               rtol=1e-4)
    pdx, pdw = RN.rmsnorm_bwd_plain(x, w, dy, 1e-6, ds)
    np.testing.assert_allclose(dx.float().numpy(), pdx.float().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(dw.numpy(), pdw.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(3, 1536), (3, 10008), (3, 128)])
def test_row_bits_alone_equal_batched(shape, dtype):
    """Row 0's dx carries the same bits computed alone as in a batch of 3:
    a row's lanes and vectors depend on its width alone, and no sum of dx
    crosses rows."""
    rows, d = shape
    x, dy, ds, w = _inputs(rows, d, dtype, seed=1)
    for extra in (None, ds):
        batched, _ = norm_bwd_mirror(x, w, dy, 1e-6, extra)
        alone, _ = norm_bwd_mirror(x[:1], w, dy[:1], 1e-6,
                                   None if extra is None else extra[:1])
        assert torch.equal(alone[0], batched[0])


GEOMETRY_ROWS = [1, 2, 3, 7, 8, 100, 600, 1023, 1024, 1025, 2100, 5120, 8192,
                 40960, 100003]
GEOMETRY_WIDTHS = [128, 1024, 1536, 2048, 3584, 4096, 5120, 10008]


def _row_owners(geo, rows):
    """Every (CTA, group, step) that takes a row, by row."""
    owners = {}
    for b in range(geo.ctas):
        r0 = b * geo.rows_per_cta
        n = min(geo.rows_per_cta, rows - r0)
        for k in range(-(-n // geo.groups)):
            for j in range(geo.groups):
                if k * geo.groups + j < n:
                    owners.setdefault(r0 + k * geo.groups + j, []).append(
                        (b, j, k))
    return owners


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_geometry_covers_rows_once_under_the_cap(dtype):
    """Every row is taken by exactly one (CTA, group); the partial rows stay
    at most BWD_MAX_PARTS (their scratch at most 256 x d float32); a row's
    lanes hold all its vectors, within one CTA's threads; the lanes and
    vectors do not depend on the row count."""
    for d in GEOMETRY_WIDTHS:
        nv = d * dtype.itemsize // 16
        by_width = set()
        for rows in GEOMETRY_ROWS:
            geo = RN.bwd_geometry(rows, d, dtype)
            owners = _row_owners(geo, rows)
            assert sorted(owners) == list(range(rows)), (rows, d, geo)
            assert all(len(o) == 1 for o in owners.values()), (rows, d)
            assert geo.ctas <= RN.BWD_MAX_PARTS
            assert geo.scratch_bytes == 4 * geo.ctas * d
            assert geo.scratch_bytes <= 4 * RN.BWD_MAX_PARTS * d
            assert geo.lanes * geo.vpt >= nv
            assert geo.vpt <= RN.BWD_VPT[dtype]
            assert geo.threads == geo.groups * geo.lanes
            assert geo.threads <= RN.BWD_MAX_THREADS
            assert (geo.lanes & (geo.lanes - 1) == 0 if geo.lanes <= 32
                    else geo.lanes % 32 == 0)
            assert geo.sum_ctas * RN.DW_STRIP >= d
            assert 1 <= geo.sum_warps <= RN.DW_WARPS
            by_width.add((geo.lanes, geo.vpt, geo.groups))
        assert len(by_width) == 1, (d, by_width)


def test_geometry_ignores_the_device(monkeypatch):
    """The geometry is the same whatever ``torch.cuda`` reports: no SM
    count, device count or availability enters it."""
    want = {(r, d, dt): RN.bwd_geometry(r, d, dt)
            for r in (8, 8192) for d in (1536, 3584)
            for dt in (torch.bfloat16, torch.float32)}

    class Props:
        multi_processor_count = 7
        name = "a card"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a, **k: Props())
    for (r, d, dt), geo in want.items():
        assert RN.bwd_geometry(r, d, dt) == geo


def test_geometry_refuses_what_the_kernel_does_not_take():
    """A width that is not a whole number of vectors, or wider than the
    kernel's threads hold, raises."""
    for dt, n in ((torch.bfloat16, 8), (torch.float32, 4)):
        widest = n * RN.BWD_VPT[dt] * RN.BWD_MAX_THREADS
        RN.bwd_geometry(16, widest, dt)
        for d in (widest + n, 1538 if n == 4 else 1540):
            with pytest.raises(ValueError):
                RN.bwd_geometry(16, d, dt)
