"""Model FLOPs over device-busy time at peak bf16, % (closed-loop cells)."""
from chipbench.harness.readers import mfu as read  # noqa: F401
