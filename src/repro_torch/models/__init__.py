from .config import ModelConfig, FULL_ATTN, LOCAL_ATTN, SSM, RGLRU
from .moe import apply_moe, capacity, init_moe, moe_einsum, moe_scatter
from .transformer import (init_params, params_from_numpy, init_cache,
                          prefill, prefill_into_slot, prefill_chunk_into_slot,
                          decode_step, sample_tokens, sample_tokens_batched,
                          stages_of, forward_train, loss_fn)

__all__ = [
    "ModelConfig", "FULL_ATTN", "LOCAL_ATTN", "SSM", "RGLRU",
    "apply_moe", "capacity", "init_moe", "moe_einsum", "moe_scatter",
    "init_params", "params_from_numpy", "init_cache", "prefill",
    "prefill_into_slot", "prefill_chunk_into_slot", "decode_step",
    "sample_tokens", "sample_tokens_batched", "stages_of",
    "forward_train", "loss_fn",
]
