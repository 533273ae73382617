"""chatglm3-6b [dense] — RoPE 2d (half-dim rotary), GQA [arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", arch_type="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=65024, qkv_bias=True,
    rotary_frac=0.5, max_seq=524_288,
)
