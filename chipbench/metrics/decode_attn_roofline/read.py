"""Decode attention's K/V bytes at peak HBM rate over its kernels' device time, %."""
from chipbench.harness.readers import decode_attn_roofline as read  # noqa: F401
