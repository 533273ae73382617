"""gemma2-9b [dense] — local+global alternating, logit softcap [arXiv:2408.00118].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000; head_dim=256,
window=4096 on local layers, attn softcap 50, final softcap 30, GeGLU,
sandwich (post-block) norms, scaled embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", arch_type="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    block_pattern=("local", "full"), window=4096,
    attn_softcap=50.0, final_softcap=30.0, act="gelu",
    post_block_norm=True, embed_scale=True, tie_embeddings=True,
    rope_theta=10_000.0, max_seq=524_288,
)
