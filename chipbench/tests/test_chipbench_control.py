"""The control: the reference in the program's place one precision below
bfloat16 (float8 e4m3 linear layers) must come out not correct, where the
program served in bfloat16 comes out correct."""
import io
import re
import subprocess
import sys

import pytest
import torch

from chipbench.harness import check, driver, spec
from chipbench.tests import tiny

SMALL = dict(tiny.QWEN3, hidden_size=128, intermediate_size=256,
             num_attention_heads=4, num_key_value_heads=2, head_dim=32,
             vocab_size=2048, dtype="bfloat16")


def test_float8_control_reads_far_above_the_bf16_program(monkeypatch):
    """At a small size on the CPU: the bf16 program's widest gap and the
    float8 control's, on the same served positions."""
    seen = {}

    def judge(ref, W, config, finished, preempted, limits, seed, out):
        seen.update(ref=ref, W=W, config=config, finished=finished,
                    preempted=preempted)
        return real(ref, W, config, finished, preempted, limits, seed, out)
    real = check.judge
    monkeypatch.setattr(check, "judge", judge)
    cell = tiny.cell(config=SMALL,
                     check={"max_logit_gap": 1.0, "served_tokens": 120})
    res = driver.run_cell(cell, 21, 1.5, False, device="cpu",
                          energy=tiny.HostEnergy(), out=io.StringIO())
    f = seen["finished"]
    rids = check.sample(f, seen["preempted"], 21, 120)
    prog, ctrl = check.control_gaps(seen["ref"], seen["W"], SMALL,
                                    [f[r][0] for r in rids],
                                    [f[r][1] for r in rids])
    p = max(float(g.max()) for g in prog)
    c = max(float(g.max()) for g in ctrl)
    assert p == pytest.approx(res["check"]["max_logit_gap"]["value"])
    assert c > 3 * p and c > cell.check["max_logit_gap"] >= p


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["qwen3-14b.longchat-closed",
                                      "qwen2-1.5b.rag-open"])
def test_float8_control_fails_the_cell_limit_on_card(workload):
    """At the cell's own size on the card, three seeds: the control's
    widest gap is above the cell's limit, the program's at or below it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size runs only there")
    root = str(spec.ROOT)
    p = subprocess.run(
        [sys.executable, "chipbench/calibrate.py", "--workload", workload,
         "--seeds", "7001,7002,7003", "--control-seeds", "7001,7002,7003",
         "--seconds", "20"], cwd=root, capture_output=True, text=True,
        timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    limit = spec.load_cell(workload).check["max_logit_gap"]
    got = re.findall(r"program max_logit_gap (\S+) control (\S+)", p.stdout)
    print(p.stdout)
    assert len(got) == 3
    for prog, ctrl in got:
        assert float(prog) <= limit < float(ctrl)
