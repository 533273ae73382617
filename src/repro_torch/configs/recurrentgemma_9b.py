"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2 [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; pattern
(rglru, rglru, local) with window 2048, lru_width=4096, GeGLU; 38 = 12x3 + 2
(tail of two recurrent layers).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", arch_type="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"), window=2048, lru_width=4096,
    conv_width=4, act="gelu", embed_scale=True, tie_embeddings=True,
    pos_embedding="rope", max_seq=524_288,
)
