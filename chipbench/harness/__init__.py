"""The benchmark's general code: specs found by name, traffic, statistics,
work counts, the energy reader, the trace reduction, the driver loop and
the correctness check.  Nothing here imports JAX or the JAX package."""
