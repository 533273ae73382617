"""Qwen3 dense models (arXiv:2505.09388; Qwen/Qwen3-14B): the common dense
GQA decoder with an RMS norm of every query and key head before the
rotation, no QKV biases, and an output head of its own.

``WEIGHTS`` is the harness's layout: linear weights (in, out), per-layer
tensors stacked on a leading layer axis.  Projections are drawn with
deviation 1/sqrt(fan-in), the input embedding with 0.1 and the output head
with 4/sqrt(hidden) (logits of deviation about 4); norm scales are 1 plus
noise of deviation 0.1, so that every scale matters.
"""
import math

from chipbench.reference.common import dense_gqa_logits


def WEIGHTS(c):
    L, d, ff, V = (c["num_hidden_layers"], c["hidden_size"],
                   c["intermediate_size"], c["vocab_size"])
    q = c["num_attention_heads"] * c["head_dim"]
    kv = c["num_key_value_heads"] * c["head_dim"]
    hd = c["head_dim"]

    def proj(name, n_in, n_out):
        return (name, (L, n_in, n_out), "normal", 1 / math.sqrt(n_in))

    return [("embed", (V, d), "normal", 0.1),
            ("lm_head", (d, V), "normal", 4 / math.sqrt(d)),
            ("final_norm", (d,), "one_plus", 0.1),
            ("attn_norm", (L, d), "one_plus", 0.1),
            ("mlp_norm", (L, d), "one_plus", 0.1),
            ("q_norm", (L, hd), "one_plus", 0.1),
            ("k_norm", (L, hd), "one_plus", 0.1),
            proj("wq", d, q), proj("wk", d, kv), proj("wv", d, kv),
            proj("wo", q, d), proj("w_gate", d, ff), proj("w_up", d, ff),
            proj("w_down", ff, d)]


def logits(W, config, seqs, wanted, quantized=False):
    return dense_gqa_logits(W, config, seqs, wanted, qkv_bias=False,
                            qk_norm=True, tied=False, quantized=quantized)
