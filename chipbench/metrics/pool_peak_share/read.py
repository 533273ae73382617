"""Peak pages in use over the window, % of the pool's usable pages (KV memory)."""
from chipbench.harness.readers import pool_peak_share as read  # noqa: F401
