"""Model configuration covering every assigned architecture family.

A single ``ModelConfig`` dataclass parameterizes dense GQA transformers,
MoE (token-choice top-k), Mamba2 SSD, RG-LRU hybrids, and the audio/VLM
decoder backbones.  Layer heterogeneity (gemma2's local/global alternation,
recurrentgemma's rec,rec,attn pattern) is expressed as a *block pattern*
cycled over the depth; the transformer stacks identical pattern-groups and
scans over them (see transformer.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Block kinds -----------------------------------------------------------------
FULL_ATTN = "full"      # causal full attention
LOCAL_ATTN = "local"    # causal sliding-window attention (cfg.window)
SSM = "ssm"             # Mamba2 SSD mixer (attention-free)
RGLRU = "rglru"         # RG-LRU recurrent mixer (recurrentgemma)

VALID_KINDS = (FULL_ATTN, LOCAL_ATTN, SSM, RGLRU)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int                            # per-expert width for MoE; 0 = no MLP
    vocab_size: int

    # attention ---------------------------------------------------------------
    block_pattern: Tuple[str, ...] = (FULL_ATTN,)
    window: int = 0                      # sliding-window size for LOCAL_ATTN
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rotary_frac: float = 1.0             # fraction of head_dim rotated (chatglm: 0.5)
    pos_embedding: str = "rope"          # rope | sincos (musicgen) | none
    attn_softcap: float = 0.0            # gemma2: 50.0
    final_softcap: float = 0.0           # gemma2: 30.0
    attn_scale: Optional[float] = None   # default 1/sqrt(head_dim)

    # block/MLP ---------------------------------------------------------------
    act: str = "silu"                    # silu | gelu
    glu: bool = True                     # gated MLP (SwiGLU/GeGLU) vs plain
    norm: str = "rms"                    # rms | layer
    norm_eps: float = 1e-6
    post_block_norm: bool = False        # gemma2 sandwich norms
    embed_scale: bool = False            # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = False

    # MoE ---------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"             # einsum (GSPMD dispatch) | scatter
    moe_group: int = 4096                # tokens per routing group (caps C)
    router_aux_loss: float = 0.01

    # SSM (Mamba2 / SSD) -------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU -------------------------------------------------------------------
    lru_width: int = 0

    # modality frontend stub ----------------------------------------------------
    num_prefix_embeds: int = 0           # VLM patches / audio conditioning frames

    # int8 KV-cache quantization (beyond-paper; §Perf memory-term hillclimb):
    # K/V stored as int8 with per-(token, head) f32 scales, dequantized in
    # the attention read — halves decode HBM traffic and cache footprint.
    kv_quant: bool = False

    # cost-measurement mode: fully unroll every lax.scan so XLA's cost
    # analysis (which counts loop bodies once) sees the true per-step work;
    # used only by the dry-run's small-depth extrapolation compiles.
    unroll_scans: bool = False

    # serving ------------------------------------------------------------------
    max_seq: int = 32_768
    long_context_window: int = 8_192     # ring-buffer window used for long_500k
                                         # on full-attention archs (beyond-paper)
    dtype: str = "bfloat16"

    # ---------------------------------------------------------------------------
    def __post_init__(self):
        for k in self.block_pattern:
            assert k in VALID_KINDS, k
        assert self.num_layers >= len(self.block_pattern)

    # Stage decomposition: (pattern repeated n_rep times) + tail layers.
    @property
    def n_pattern_repeats(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        r = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:r]

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.num_layers))

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return any(k in (FULL_ATTN, LOCAL_ATTN) for k in self.block_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer attends to unbounded context (native long-context)."""
        return FULL_ATTN not in self.block_pattern

    # ---- parameter counting (for MODEL_FLOPS = 6 N D and memory budgeting) ----
    def param_count(self, active_only: bool = False) -> int:
        d, ff = self.d_model, self.d_ff
        n = 0
        n += self.vocab_size * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d                   # lm head
        for kind in self.layer_kinds:
            n += d                                      # pre-norm scale
            if kind in (FULL_ATTN, LOCAL_ATTN):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
            elif kind == SSM:
                di, st, hd = self.ssm_inner, self.ssm_state, self.ssm_headdim
                nh = self.ssm_heads
                proj_in = 2 * di + 2 * st + nh          # z,x,B,C,dt
                n += d * proj_in
                n += self.conv_width * (di + 2 * st)    # depthwise conv
                n += nh * 2                             # A_log, D
                n += di * d                             # out proj
            elif kind == RGLRU:
                w = self.lru_width or d
                n += d * w * 2                          # input + gate branch
                n += self.conv_width * w                # temporal conv
                n += w * 3                              # lambda, gates
                n += w * d                              # out proj
            if ff > 0 and kind != SSM:
                n += d                                  # mlp norm
                if self.is_moe:
                    e = self.experts_per_token if active_only else self.num_experts
                    per = (2 * d * ff + ff * d) if self.glu else 2 * d * ff
                    n += e * per + d * self.num_experts  # experts + router
                else:
                    n += (2 * d * ff + ff * d) if self.glu else 2 * d * ff
        n += d                                          # final norm
        return n

    # FLOPs per token (fwd) — used by the plant model and roofline checks.
    def flops_per_token(self, context_len: int, phase: str = "decode") -> float:
        """Approximate forward FLOPs for one token at a given KV context length.

        phase='prefill' uses the average causal context (context_len/2) for
        the attention term; phase='decode' uses the full context.
        """
        d, ff = self.d_model, self.d_ff
        fl = 0.0
        for kind in self.layer_kinds:
            if kind in (FULL_ATTN, LOCAL_ATTN):
                ctx = context_len if kind == FULL_ATTN else min(context_len, self.window or context_len)
                if phase == "prefill":
                    ctx = ctx / 2.0
                fl += 2 * d * self.q_dim + 4 * d * self.kv_dim + 2 * self.q_dim * d
                fl += 4 * self.num_heads * self.head_dim * ctx   # QK^T + PV
            elif kind == SSM:
                di, st = self.ssm_inner, self.ssm_state
                fl += 2 * d * (2 * di + 2 * st + self.ssm_heads)
                fl += 2 * di * st * 2                             # state update + out
                fl += 2 * di * d
            elif kind == RGLRU:
                w = self.lru_width or d
                fl += 2 * d * w * 2 + 2 * w * d + 10 * w
            if ff > 0 and kind != SSM:
                e = self.experts_per_token if self.is_moe else 1
                per = (6 * d * ff) if self.glu else (4 * d * ff)
                fl += e * per
                if self.is_moe:
                    fl += 2 * d * self.num_experts                # router
        fl += 2 * d * self.vocab_size                             # lm head
        return fl

    # Bytes read per decoded token (weights + KV/state) — plant memory term.
    def decode_bytes_per_token(self, context_len: int, batch: int = 1) -> float:
        itemsize = 2  # bf16
        wbytes = self.param_count(active_only=True) * itemsize
        state = 0.0
        for kind in self.layer_kinds:
            if kind == FULL_ATTN:
                state += 2 * self.kv_dim * context_len * itemsize
            elif kind == LOCAL_ATTN:
                state += 2 * self.kv_dim * min(context_len, self.window) * itemsize
            elif kind == SSM:
                state += self.ssm_heads * self.ssm_headdim * self.ssm_state * itemsize
            elif kind == RGLRU:
                state += (self.lru_width or self.d_model) * itemsize
        return wbytes / max(batch, 1) + state

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Reduced variant for CPU smoke tests (2 layers, d<=512, <=4 experts).
    def smoke(self) -> "ModelConfig":
        pat = self.block_pattern
        n_layers = max(2, len(pat))
        d = min(self.d_model, 256)
        hd = 64
        nh = max(2, d // hd)
        nkv = max(1, min(self.num_kv_heads, nh))
        kw = dict(
            num_layers=n_layers, d_model=d, num_heads=nh, num_kv_heads=nkv,
            head_dim=hd, d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 64) if self.window else 0,
            max_seq=512,
            num_prefix_embeds=min(self.num_prefix_embeds, 8),
            long_context_window=128,
        )
        if self.is_moe:
            # effectively dropless at smoke scale -> prefill/decode consistency
            kw.update(num_experts=4, experts_per_token=2, capacity_factor=8.0)
        if SSM in pat:
            kw.update(ssm_state=32, ssm_headdim=32, ssm_chunk=64)
        if RGLRU in pat:
            kw.update(lru_width=d)
        return self.replace(**kw)
