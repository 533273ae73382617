"""qwen3-14b — the paper's dense evaluation model [arXiv:2505.09388].

40L d_model=5120 40H (GQA kv=8) head_dim=128 d_ff=17408 vocab=151936, QK-norm.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", arch_type="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, qk_norm=True,
    rope_theta=1_000_000.0, max_seq=524_288,
)
