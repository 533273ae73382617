"""llava-next-mistral-7b [vlm] — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The SigLIP/CLIP vision tower + projector are stubbed per the carve-out:
``input_specs`` provides 2880 precomputed anyres patch embeddings (5 tiles x
576 patches) which the backbone consumes as prefix embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", arch_type="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    num_prefix_embeds=2880, rope_theta=1_000_000.0, max_seq=524_288,
)
