"""Qwen2 dense models (arXiv:2407.10671; Qwen/Qwen2-1.5B): the common dense
GQA decoder with biases on the query, key and value projections and, at
1.5B, the output head tied to the input embedding.

``WEIGHTS`` is the harness's layout: linear weights (in, out), per-layer
tensors stacked on a leading layer axis.  Projections are drawn with
deviation 1/sqrt(fan-in), biases with 0.1, the tied embedding with 0.1
(logits of deviation about 4 at hidden size 1536); norm scales are 1 plus
noise of deviation 0.1, so that every scale matters.
"""
import math

from chipbench.reference.common import dense_gqa_logits


def WEIGHTS(c):
    L, d, ff, V = (c["num_hidden_layers"], c["hidden_size"],
                   c["intermediate_size"], c["vocab_size"])
    q = c["num_attention_heads"] * c["head_dim"]
    kv = c["num_key_value_heads"] * c["head_dim"]

    def proj(name, n_in, n_out):
        return (name, (L, n_in, n_out), "normal", 1 / math.sqrt(n_in))

    return [("embed", (V, d), "normal", 0.1),
            ("final_norm", (d,), "one_plus", 0.1),
            ("attn_norm", (L, d), "one_plus", 0.1),
            ("mlp_norm", (L, d), "one_plus", 0.1),
            ("bq", (L, q), "normal", 0.1), ("bk", (L, kv), "normal", 0.1),
            ("bv", (L, kv), "normal", 0.1),
            proj("wq", d, q), proj("wk", d, kv), proj("wv", d, kv),
            proj("wo", q, d), proj("w_gate", d, ff), proj("w_up", d, ff),
            proj("w_down", ff, d)]


def logits(W, config, seqs, wanted, quantized=False):
    return dense_gqa_logits(W, config, seqs, wanted, qkv_bias=True,
                            qk_norm=False, tied=True, quantized=quantized)
