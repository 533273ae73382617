"""Mesh-sharded serving equivalence on 8 gloo CPU ranks, meshes (8,1),
(2,4) and (4,2): the port's mirror of ``tests/test_mesh_serving.py``'s
tentpole harness (``tests/test_torch_mesh_ranks_b.py`` takes (1,1) and
checks that the scenarios reach the hard paths).

One set of 8 rank processes runs ``tests/torch_mesh_runner.py``, serving
each mesh in turn, every rank serving the reference runner's scenarios —
dense and MoE engines with prefix-cache hits, a mid-run cancel,
pool-pressure preemption and mixed greedy/seeded sampling; a disaggregated
cluster with prefill->decode handoffs and a replica kill — and each mesh's
digest must equal the unsharded engine's bit for bit: tokens,
ServingReport floats, energy, host drains, prefix hits and the kernel
launch counts.  The same ranks hold the placement round trip and keep
wall-clock accounting in step.  The reference's compile-budget test has
no counterpart until the port's decode blocks replay CUDA graphs."""
import pytest
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

import torch_mesh_runner as R

MESHES = ["8,1", "2,4", "4,2"]


@pytest.fixture(scope="module")
def digests():
    """The unsharded anchor (in this process) and the 8 ranks' digests of
    every mesh."""
    out = R.spawn("/".join(MESHES), "dense,moe,cluster,roundtrip,wallclock",
                  timeout=600)
    out["none"] = R.digest(None)
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("scenario", ["dense", "moe", "cluster"])
def test_mesh_bit_identical_to_single_device(digests, mesh, scenario):
    """Tokens, report floats, drains, prefix hits, cancelled rid — the whole
    digest — must match the unsharded baseline bitwise, and so must every
    kernel's launch count."""
    base, got = digests["none"][scenario], digests[mesh][scenario]
    assert got["tokens"] == base["tokens"], f"{scenario} tokens on {mesh}"
    assert got == base, f"{scenario} digest diverged on mesh {mesh}"
    assert digests[mesh]["launches"] == digests["none"]["launches"]


@pytest.mark.parametrize("mesh", MESHES)
def test_placement_round_trip_on_eight_ranks(digests, mesh):
    """Params and a paged cache tree placed by the serving specs and
    gathered back are the originals, bitwise, as DTensor's own
    ``full_tensor()`` gives them; the ranks really store shards (rank 0
    holds at most half the bytes here), and an MoE expert stack keeps
    E / tp = 4 / tp experts on each model shard."""
    rt = digests[mesh]["roundtrip"]
    assert rt["equal"] and rt["equal_full_tensor"]
    assert 0 < rt["local_bytes"] * 2 <= rt["bytes"], rt
    tp = int(mesh.split(",")[1])
    assert rt["expert_rows_here"] == 4 // tp


@pytest.mark.parametrize("mesh", MESHES)
def test_wall_clock_accounting_agrees_across_ranks(digests, mesh):
    """With ``use_wall_clock`` each rank times its own blocks; the engine
    bills rank 0's times everywhere, so every rank ends with the same
    clock, energy and tokens, and the run completes."""
    wc = digests[mesh]["wallclock"]
    assert wc["ranks_agree"] and wc["completed"] == 6 and wc["warmed"] > 0
