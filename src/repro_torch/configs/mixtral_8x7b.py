"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, window=4096.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    block_pattern=("local",), window=4096,
    num_experts=8, experts_per_token=2, capacity_factor=1.25,
    rope_theta=1_000_000.0, max_seq=524_288,
)
