"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024, attention-free, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 2048, headdim=64 -> 32 SSD heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", arch_type="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    block_pattern=("ssm",), ssm_state=128, ssm_expand=2, ssm_headdim=64,
    ssm_chunk=256, conv_width=4, tie_embeddings=True, pos_embedding="none",
    max_seq=524_288,
)
