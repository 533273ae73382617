"""Share of the traced slice with the device idle, % (closed-loop cells)."""
from chipbench.harness.readers import idle_share as read  # noqa: F401
