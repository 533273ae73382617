"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (MHA, kv=32) d_ff=8192 vocab=2048.  The EnCodec codec and
text-conditioning frontend are stubbed: ``input_specs`` supplies precomputed
conditioning embeddings (num_prefix_embeds); the backbone decodes audio tokens.
MusicGen uses LayerNorm + GELU MLPs and sinusoidal absolute positions.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", arch_type="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    norm="layer", act="gelu", glu=False, pos_embedding="sincos",
    num_prefix_embeds=64, tie_embeddings=False,
    max_seq=524_288,
)
