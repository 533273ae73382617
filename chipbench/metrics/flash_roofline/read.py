"""Prefill attention's causal FLOPs at peak bf16 over its kernels' device time, %."""
from chipbench.harness.readers import prefill_attn_roofline as read  # noqa: F401
