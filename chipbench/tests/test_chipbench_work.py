"""FLOP and byte counts against hand values for a tiny configuration."""
import pytest

from chipbench.harness.work import Dims, Work
from chipbench.tests import tiny

D = Dims.of(tiny.QWEN3)      # 2 layers, d 64, 4:2 heads of 16, ff 128, V 97


def test_dims_from_config():
    assert (D.layers, D.d, D.heads, D.kv_heads, D.head_dim, D.ff, D.vocab) \
        == (2, 64, 4, 2, 16, 128, 97)
    # q 64x64, k and v 64x32, o 64x64, gate / up / down 64x128
    assert D.matmul_params == 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64
                                   + 3 * 64 * 128)


def test_prefill_and_decode_flops():
    n = 5
    attn = 4 * 4 * 16 * (5 * 6 / 2) * 2          # 15 pairs, 2 layers
    assert D.prefill_attn_flops(n) == attn
    assert D.prefill_flops(n) == 2 * D.matmul_params * 5 + attn \
        + 2 * 64 * 97
    assert D.decode_flops(9) == 2 * D.matmul_params + 4 * 4 * 16 * 9 * 2 \
        + 2 * 64 * 97
    assert D.decode_kv_bytes(9) == 2 * 2 * 16 * 9 * 2 * 2


def test_work_counts_each_token_once_from_its_events():
    w = Work(D)
    w.prefill(5)                 # the first token comes from the prefill
    w.decode(5, 1, 1)            # its event: no decode work
    w.decode(5, 2, 3)            # tokens 2..4 attend 6, 7, 8 keys
    assert w.prefills == 1 and w.decode_tokens == 3
    assert w.decode_kv_bytes == pytest.approx(sum(
        D.decode_kv_bytes(k) for k in (6, 7, 8)))
    assert w.model_flops == pytest.approx(
        D.prefill_flops(5) + sum(D.decode_flops(k) for k in (6, 7, 8)))
    assert w.prefill_attn_flops == D.prefill_attn_flops(5)
