"""Share of the slice with the device idle under host bookkeeping, % (scheduler)."""
from chipbench.harness.spans import idle_share_under as read  # noqa: F401
