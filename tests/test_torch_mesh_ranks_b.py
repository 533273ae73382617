"""Mesh-sharded serving equivalence on the (1,1) mesh, one gloo rank in
this process (``tests/test_torch_mesh_ranks_a.py`` has the harness's
account and the 8-rank meshes), and the check that the scenarios reach
the paths the equivalence is about."""
import pytest
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

import torch_mesh_runner as R


@pytest.fixture(scope="module")
def digests():
    """The unsharded anchor and the (1,1) digest, in this process."""
    from repro_torch.launch.mesh import init_single_rank, shutdown
    out = {"none": R.digest(None)}
    init_single_rank("cpu")
    try:
        out["1,1"] = R.digest((1, 1))
    finally:
        shutdown()
    return out


@pytest.mark.parametrize("scenario", ["dense", "moe", "cluster"])
def test_one_rank_mesh_bit_identical_to_single_device(digests, scenario):
    base, got = digests["none"][scenario], digests["1,1"][scenario]
    assert got["tokens"] == base["tokens"], f"{scenario} tokens on (1,1)"
    assert got == base, f"{scenario} digest diverged on mesh (1,1)"
    assert digests["1,1"]["launches"] == digests["none"]["launches"]


def test_scenarios_exercise_the_hard_paths(digests):
    """The equivalence is only as strong as the trace: assert the
    scenarios really hit preemption, cancel, prefix hits, migration and a
    recovered kill."""
    d = digests["none"]
    assert d["dense"]["report"]["preempted"] > 0
    assert d["dense"]["report"]["cancelled"] == 1
    assert d["dense"]["cancelled_rid"] is not None
    assert d["dense"]["prefix_hits"] > 0
    assert d["dense"]["prefix_hit_tokens"] > 0
    assert d["cluster"]["report"]["migrated"] > 0
    assert d["cluster"]["faulted_report"]["completed"] == \
        d["cluster"]["report"]["completed"]
    assert d["cluster"]["kills"] == 1
    assert d["cluster"]["killed_report"]["completed"] == \
        d["cluster"]["report"]["completed"]
    for scen in ("dense", "moe", "cluster"):
        assert d[scen]["host_drains"] > 0
