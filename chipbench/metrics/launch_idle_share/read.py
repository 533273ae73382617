"""Share of the slice with the device idle under model launches, % (model step)."""
from chipbench.harness.spans import idle_share_under as read  # noqa: F401
