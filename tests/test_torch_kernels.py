"""The port's kernel modules on the CPU: each wrapper's plain version (what
it computes for CPU tensors, and what the CUDA kernel is held against on
the card) against the JAX package's Pallas kernel in interpret mode and its
jnp oracle, on the same numpy-seeded inputs.

The case lists are those of ``tests/test_kernels.py`` (MHA/GQA/MQA, sliding
window, softcap, hd 256, wrapped ring buffers) plus the serve path's
shapes: qwen2's 12:2 heads, a ragged 96-token prompt bucket and -1 holes in
the key positions.

Tolerances: float32 2e-5, the reference tests' own.  bfloat16 2e-2: the
kernels and oracles keep p in float32, but the XLA model path
(``models/attention.py``) rounds p to bfloat16 before P.V, and the two
frameworks round bf16 results at different points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models import attention as jattn
from repro.models.kvcache import ring_slot_positions as jring
from repro.models.layers import rmsnorm as jrmsnorm

from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import add_rmsnorm, rmsnorm
from repro_torch.models import attention as tattn
from repro_torch.models.kvcache import ring_slot_positions as tring
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, dtype):
    """The same numpy values as a JAX array and a torch CPU tensor."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(out, want, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _np(t):
    return t.float().numpy()


FLASH_CASES = [
    # B, Hq, KH, S, hd, window, softcap
    (2, 4, 4, 256, 64, 0, 0.0),          # MHA
    (1, 8, 2, 256, 128, 0, 0.0),         # GQA 4:1
    (1, 16, 1, 128, 128, 0, 0.0),        # MQA
    (2, 4, 2, 384, 64, 128, 0.0),        # sliding window
    (1, 2, 2, 256, 256, 0, 50.0),        # softcap + hd 256
    (1, 4, 4, 512, 64, 256, 30.0),       # window + softcap
    (1, 12, 2, 96, 128, 0, 0.0),         # qwen2 heads, ragged 96-token bucket
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_plain_matches_pallas_and_oracle(case, dtype):
    B, Hq, KH, S, hd, win, cap = case
    rng = np.random.default_rng(sum(case[:5]))
    qn = rng.standard_normal((B, Hq, S, hd), np.float32)
    kn = rng.standard_normal((B, KH, S, hd), np.float32)
    vn = rng.standard_normal((B, KH, S, hd), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    tol = DTYPES[dtype][2]
    kw = dict(causal=True, window=win, softcap=cap)
    # the port's wrapper takes (B, S, H, hd), the Pallas kernel (B, H, S, hd)
    out = flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                          vt.transpose(1, 2), **kw).transpose(1, 2)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(_np(out), pallas_flash(qj, kj, vj, interpret=True, **kw), tol)
    _close(_np(out), jref.reference_attention(qj, kj, vj, **kw), tol)
    _close(_np(tref.reference_attention(qt, kt, vt, **kw)),
           jref.reference_attention(qj, kj, vj, **kw), tol)


def test_flash_attention_plain_non_causal_matches_oracle():
    rng = np.random.default_rng(7)
    qn, kn, vn = (rng.standard_normal((1, 4, 160, 64), np.float32)
                  for _ in range(3))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "float32") for a in (qn, kn, vn))
    out = flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                          vt.transpose(1, 2), causal=False).transpose(1, 2)
    _close(_np(out), jref.reference_attention(qj, kj, vj, causal=False), 2e-5)


DECODE_CASES = [
    # B, Hq, KH, Sk, hd, window, pos, holes
    (2, 8, 2, 512, 64, 0, 300, False),
    (1, 16, 8, 256, 128, 0, 255, False),
    (2, 4, 4, 512, 64, 128, 700, False),   # ring buffer wrapped (pos >= Sk)
    (3, 8, 1, 256, 128, 0, 60, False),     # partially filled cache
    (1, 16, 16, 256, 256, 0, 100, False),  # MHA, hd 256
    (8, 12, 2, 192, 128, 0, 150, True),    # qwen2 heads, -1 holes
]


def _decode_inputs(case, dtype):
    B, Hq, KH, Sk, hd, win, pos, holes = case
    rng = np.random.default_rng(B * 1000 + Sk + pos)
    qn = rng.standard_normal((B, Hq, hd), np.float32)
    kn = rng.standard_normal((B, KH, Sk, hd), np.float32)
    vn = rng.standard_normal((B, KH, Sk, hd), np.float32)
    kp = np.broadcast_to(np.asarray(jring(Sk, pos + 1))[None], (B, Sk)).copy()
    qp = np.full((B,), pos, np.int32)
    if holes:
        kp[rng.random((B, Sk)) < 0.1] = -1
        qp = rng.integers(Sk // 2, Sk, size=B).astype(np.int32)
        kp[1] = -1            # a row with no valid key gives zeros
    return qn, kn, vn, kp.astype(np.int32), qp


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_plain_matches_pallas_and_oracle(case, dtype):
    win = case[5]
    qn, kn, vn, kp, qp = _decode_inputs(case, dtype)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    tol = DTYPES[dtype][2]
    kpj, qpj = jnp.asarray(kp), jnp.asarray(qp)
    kpt, qpt = torch.from_numpy(kp), torch.from_numpy(qp)
    # serving layout: q (B, 1, Hq, hd), cache (B, Sk, KH, hd)
    out = decode_attention(qt[:, None], kt.transpose(1, 2), vt.transpose(1, 2),
                           kpt, qpt, window=win)[:, 0]
    assert out.dtype == qt.dtype and out.shape == qt.shape
    want = jref.reference_decode_attention(qj, kj, vj, kpj, qpj, window=win)
    _close(_np(out), pallas_decode(qj, kj, vj, kpj, qpj, window=win,
                                   interpret=True, block_k=64), tol)
    _close(_np(out), want, tol)
    _close(_np(tref.reference_decode_attention(qt, kt, vt, kpt, qpt,
                                               window=win)), want, tol)
    if case[-1]:
        assert not np.any(_np(out)[1])


@pytest.mark.parametrize("case", [DECODE_CASES[2], DECODE_CASES[5]])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_per_row_position_attention(case, dtype):
    """models/attention.py::attention is the semantics the decode kernel
    must match: the port's and the reference's agree with each other and
    with the decode wrapper on per-row q positions, ring positions, holes
    and windows."""
    win = case[5]
    qn, kn, vn, kp, qp = _decode_inputs(case, dtype)
    q4, k4, v4 = qn[:, None], kn.transpose(0, 2, 1, 3), vn.transpose(0, 2, 1, 3)
    (qj, qt), (kj, kt), (vj, vt) = (_both(np.ascontiguousarray(a), dtype)
                                    for a in (q4, k4, v4))
    tol = DTYPES[dtype][2]
    kpt, qpt = torch.from_numpy(kp), torch.from_numpy(qp)
    mine = tattn.attention(qt, kt, vt, qpt[:, None], kpt, window=win)
    theirs = jattn.attention(qj, kj, vj, jnp.asarray(qp)[:, None],
                             jnp.asarray(kp), window=win)
    _close(_np(mine), theirs, tol)
    _close(_np(decode_attention(qt, kt, vt, kpt, qpt, window=win)), theirs,
           tol)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_attention_prefill_positions_match_reference(softcap):
    """Prefill semantics: positions 0..S-1 for queries and keys, causal,
    windowed, soft-capped, in query chunks (Sq a multiple of q_chunk)."""
    rng = np.random.default_rng(3)
    B, S, Hq, KH, hd = 2, 64, 4, 2, 32
    qn = rng.standard_normal((B, S, Hq, hd), np.float32)
    kn = rng.standard_normal((B, S, KH, hd), np.float32)
    vn = rng.standard_normal((B, S, KH, hd), np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "float32") for a in (qn, kn, vn))
    kw = dict(window=24, softcap=softcap)
    mine = tattn.attention(qt, kt, vt, torch.from_numpy(pos),
                           torch.from_numpy(pos), q_chunk=16, **kw)
    theirs = jattn.attention(qj, kj, vj, jnp.asarray(pos), jnp.asarray(pos),
                             q_chunk=16, **kw)
    _close(_np(mine), theirs, 2e-5)
    _close(_np(flash_attention(qt, kt, vt, causal=True, **kw)), theirs, 2e-5)


@pytest.mark.parametrize("shape", [(4, 37, 256), (2, 128, 512), (3, 64),
                                   (8, 1, 256)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_plain_matches_pallas_and_layers(shape, dtype):
    rng = np.random.default_rng(len(shape) + shape[-1])
    xn = rng.standard_normal(shape, np.float32)
    wn = rng.standard_normal((shape[-1],), np.float32) + 1.0
    xj, xt = _both(xn, dtype)
    tol = DTYPES[dtype][2]
    out = rmsnorm(xt, torch.from_numpy(wn))
    assert out.dtype == xt.dtype and out.shape == xt.shape
    _close(_np(out), pallas_rmsnorm(xj, jnp.asarray(wn), interpret=True,
                                    block_rows=64), tol)
    _close(_np(out), jrmsnorm(xj, jnp.asarray(wn)), tol)


@pytest.mark.parametrize("shape", [(8, 1536), (5, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_add_rmsnorm_plain_matches_add_then_layers_rmsnorm(shape, dtype):
    """add_rmsnorm's plain version against the reference's residual add and
    ``layers.rmsnorm``: the sum, written into x, bit for bit (both
    frameworks add in float32
    and round once to the type), the norm within the kernel tolerance
    (XLA and PyTorch take the mean of squares and the rsqrt in another
    order and differ in the last bits), and bitwise the port's own rmsnorm
    of that sum, which the CUDA kernel is held to on the card."""
    rng = np.random.default_rng(shape[-1] + 3)
    xn = rng.standard_normal(shape, np.float32)
    dn = (rng.standard_normal(shape, np.float32)
          * rng.choice([1e-3, 1.0, 30.0], size=(shape[0], 1))).astype(np.float32)
    wn = rng.standard_normal((shape[-1],), np.float32) + 1.0
    (xj, xt), (dj, dt) = _both(xn, dtype), _both(dn, dtype)
    xt = xt.clone()              # float32 from_numpy shares xn's memory
    s, h = add_rmsnorm(xt, dt, torch.from_numpy(wn))
    assert s is xt                                   # the sum, in place
    assert h.dtype == xt.dtype and h.shape == xt.shape
    sj = xj + dj
    np.testing.assert_array_equal(_np(s), np.asarray(sj, np.float32))
    _close(_np(h), jrmsnorm(sj, jnp.asarray(wn)), DTYPES[dtype][2])
    assert torch.equal(h, rmsnorm(s, torch.from_numpy(wn)))


@pytest.mark.parametrize("pos", [0, 1, 63, 64, 65, 200])
def test_ring_slot_positions_match_reference(pos):
    for buf in (16, 64):
        np.testing.assert_array_equal(tring(buf, torch.tensor(pos)).numpy(),
                                      np.asarray(jring(buf, pos)))
    vec = np.array([0, 5, 64, 130], np.int32)
    np.testing.assert_array_equal(
        tring(64, torch.from_numpy(vec) + pos).numpy(),
        np.asarray(jring(64, jnp.asarray(vec) + pos)))
