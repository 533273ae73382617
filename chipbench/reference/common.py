"""Plain float32 PyTorch for the dense GQA decoder that the Qwen2 and
Qwen3 reports describe: RMSNorm, rotary positions (θ from the config, the
rotate-half form of the published code), grouped-query causal attention,
a SwiGLU MLP, pre-norm residual blocks; optional QKV biases (Qwen2), RMS
norms of each query and key head before the rotation (Qwen3), and an output
head tied to the embedding (Qwen2-1.5B).

It imports nothing of the program.  It runs layer by layer over every
sequence it is given, each layer's weights cast to float32 once, the
attention in blocks of queries, and TF32 off, so a float32 product is a
float32 product.  ``quantized=True`` is the control: the same pass with
every linear layer's weights (per output column) and inputs (per row)
rounded to float8 e4m3, the precision below the bfloat16 it is served in.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch

FP8_MAX = 448.0            # largest finite float8 e4m3fn


@contextlib.contextmanager
def tf32_off():
    """float32 products in float32: TF32 off for matmuls and cuDNN (the
    previous settings restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (T, H, hd) by positions 0..T-1: the first and second halves
    of each head are the pairs (rotate-half)."""
    T, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().to(torch.float32)[:, None, :]
    sin = ang.sin().to(torch.float32)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over keys at or before each query, q
    (T, Hq, hd), k and v (T, KH, hd); query head h reads K/V head
    h // (Hq / KH).  Returns (T, Hq * hd)."""
    T, Hq, hd = q.shape
    g = Hq // k.shape[1]
    kh = k.repeat_interleave(g, dim=1).permute(1, 2, 0)      # (Hq, hd, T)
    vh = v.repeat_interleave(g, dim=1).permute(1, 0, 2)      # (Hq, T, hd)
    out = torch.empty(T, Hq, hd, dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    for a in range(0, T, block):
        b = min(a + block, T)
        s = torch.matmul(q[a:b].permute(1, 0, 2), kh[:, :, :b]) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(b, device=q.device)[None, :]
        s.masked_fill_(kj > qi, float("-inf"))
        out[a:b] = torch.matmul(torch.softmax(s, dim=-1),
                                vh[:, :b]).permute(1, 0, 2)
    return out.reshape(T, Hq * hd)


def dense_gqa_logits(W: Dict[str, torch.Tensor], config: Dict,
                     seqs: Sequence[torch.Tensor],
                     wanted: Sequence[Sequence[int]], *, qkv_bias: bool,
                     qk_norm: bool, tied: bool,
                     quantized: bool = False) -> List[torch.Tensor]:
    with tf32_off(), torch.no_grad():
        return _forward(W, config, seqs, wanted, qkv_bias, qk_norm, tied,
                        quantized)


def _forward(W, config, seqs, wanted, qkv_bias, qk_norm, tied, quantized):
    """float32 logits (len(wanted[i]), vocab) at positions ``wanted[i]`` of
    each token sequence ``seqs[i]`` (1-D int64, on the weights' device).

    ``W`` is the harness's layout (``WEIGHTS`` of the family file): per
    layer tensors stacked on a leading layer axis, linear weights (in,
    out)."""
    eps = config["rms_norm_eps"]
    theta = config["rope_theta"]
    H, KH = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["head_dim"]

    def weight(t):
        t = t.float()
        return fp8_round(t, 0) if quantized else t

    def lin(x, w):
        return (fp8_round(x, -1) if quantized else x) @ w

    hs = [W["embed"][s].float() for s in seqs]
    for layer in range(config["num_hidden_layers"]):
        w = {k: weight(W[k][layer]) for k in
             ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
        for i, x in enumerate(hs):
            T = x.shape[0]
            h = rms_norm(x, W["attn_norm"][layer], eps)
            q, k, v = lin(h, w["wq"]), lin(h, w["wk"]), lin(h, w["wv"])
            if qkv_bias:
                q = q + W["bq"][layer].float()
                k = k + W["bk"][layer].float()
                v = v + W["bv"][layer].float()
            q, k, v = (q.view(T, H, hd), k.view(T, KH, hd),
                       v.view(T, KH, hd))
            if qk_norm:
                q = rms_norm(q, W["q_norm"][layer], eps)
                k = rms_norm(k, W["k_norm"][layer], eps)
            a = causal_attention(rope(q, theta), rope(k, theta), v)
            x = x + lin(a, w["wo"])
            h = rms_norm(x, W["mlp_norm"][layer], eps)
            m = torch.nn.functional.silu(lin(h, w["w_gate"])) * lin(h, w["w_up"])
            hs[i] = x + lin(m, w["w_down"])
        del w
    head = weight(W["embed"].T if tied else W["lm_head"])
    out = []
    for x, pos in zip(hs, wanted):
        rows = x[torch.as_tensor(list(pos), device=x.device)]
        out.append(lin(rms_norm(rows, W["final_norm"], eps), head))
    return out
