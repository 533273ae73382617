"""Host ms to enqueue one decode step, mean serve.decode.step (model step)."""
from chipbench.harness.spans import mean_range_ms as read  # noqa: F401
