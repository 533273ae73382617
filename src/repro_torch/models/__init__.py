from .config import ModelConfig, FULL_ATTN, LOCAL_ATTN, SSM, RGLRU
from .transformer import (init_params, params_from_numpy, init_cache,
                          prefill_into_slot, decode_step, stages_of)

__all__ = [
    "ModelConfig", "FULL_ATTN", "LOCAL_ATTN", "SSM", "RGLRU",
    "init_params", "params_from_numpy", "init_cache", "prefill_into_slot",
    "decode_step", "stages_of",
]
