"""The work that served tokens need, from the configuration's published
sizes alone: model FLOPs, the causal attention FLOPs of prefills, and the
K/V bytes a decode step reads.

Counted is what the inputs need, whatever kernel does it: a prompt's own
tokens (not the padding of its prefill bucket), a token's own context, and
nothing of a prompt recomputed after a preemption.  A multiply-add is two
FLOPs.  The keys are the Hugging Face ``config.json`` names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    kv_bytes: int = 2           # bytes of one stored K or V element (bf16)

    @classmethod
    def of(cls, config: Dict) -> "Dims":
        hd = config.get("head_dim") or \
            config["hidden_size"] // config["num_attention_heads"]
        return cls(config["num_hidden_layers"], config["hidden_size"],
                   config["num_attention_heads"],
                   config["num_key_value_heads"], hd,
                   config["intermediate_size"], config["vocab_size"])

    @property
    def matmul_params(self) -> int:
        """Weights a token multiplies through in the layers: q, k, v, o and
        the SwiGLU MLP's gate, up and down (norms and biases left out)."""
        q, kv = self.heads * self.head_dim, self.kv_heads * self.head_dim
        return self.layers * (self.d * (2 * q + 2 * kv) + 3 * self.d * self.ff)

    def attn_flops(self, pairs: float) -> float:
        """QK^T and PV over ``pairs`` (query, key) pairs in every layer."""
        return 4.0 * self.heads * self.head_dim * pairs * self.layers

    def prefill_attn_flops(self, n: int) -> float:
        """Causal attention of an n-token prompt: query i sees i + 1 keys."""
        return self.attn_flops(n * (n + 1) / 2)

    def prefill_flops(self, n: int) -> float:
        """A prompt's prefill: every token through the layers, the causal
        attention, and the logits of its last token only."""
        return (2.0 * self.matmul_params * n + self.prefill_attn_flops(n)
                + 2.0 * self.d * self.vocab)

    def decode_flops(self, keys: int) -> float:
        """One decoded token attending ``keys`` keys, with its logits."""
        return (2.0 * self.matmul_params + self.attn_flops(keys)
                + 2.0 * self.d * self.vocab)

    def decode_kv_bytes(self, keys: int) -> float:
        """K and V bytes of ``keys`` positions in every layer."""
        return 2.0 * self.kv_heads * self.head_dim * keys * self.kv_bytes \
            * self.layers


@dataclasses.dataclass
class Work:
    """Work of a set of engine rounds, from their drained events."""
    dims: Dims
    model_flops: float = 0.0
    prefill_attn_flops: float = 0.0
    decode_kv_bytes: float = 0.0
    prefills: int = 0
    decode_tokens: int = 0

    def prefill(self, prompt_len: int) -> None:
        self.prefills += 1
        self.model_flops += self.dims.prefill_flops(prompt_len)
        self.prefill_attn_flops += self.dims.prefill_attn_flops(prompt_len)

    def decode(self, prompt_len: int, first: int, n: int) -> None:
        """Output tokens ``first .. first + n - 1`` (1-based) of a request:
        token j >= 2 comes from the step whose input sits at position
        prompt_len + j - 2, which attends prompt_len + j - 1 keys."""
        for j in range(first, first + n):
            if j < 2:
                continue            # the first token is its prefill's
            keys = prompt_len + j - 1
            self.decode_tokens += 1
            self.model_flops += self.dims.decode_flops(keys)
            self.decode_kv_bytes += self.dims.decode_kv_bytes(keys)
