"""Decode rows per decode step over the window (scheduler)."""
from chipbench.harness.readers import rows_per_step as read  # noqa: F401
