"""The harness end to end on the CPU at a tiny size: both loops, the
refusal without a card, the modules a run loads, and the check catching a
broken timed path."""
import io
import json
import os
import subprocess
import sys

import pytest

from chipbench.harness import driver, spec
from chipbench.tests import tiny

ROOT = str(spec.ROOT)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT])
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _run(cell, seed=11, seconds=1.5, trace=False):
    return driver.run_cell(cell, seed, seconds, trace, device="cpu",
                           energy=tiny.HostEnergy(), out=io.StringIO())


@pytest.mark.parametrize("traffic", [tiny.CLOSED, tiny.OPEN],
                         ids=["closed", "open"])
def test_tiny_cell_runs_correct(traffic):
    res = _run(tiny.cell(traffic=traffic))
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 4
    names = {m["name"] for m in tiny.cell(traffic=traffic).end_to_end}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["check"]["max_logit_gap"]["value"] <= 1e-3
    assert list(res)[-1] == "check"


def test_run_refuses_without_a_card():
    p = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         "qwen3-14b.longchat-closed", "--seed", "3000000001", "--seconds",
         "1", "--trace", "0"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_run_refuses_outside_a_checkout_of_the_program(tmp_path):
    """With only BENCHMARK.json and chipbench/ there is no program to run."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "chipbench"), tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = _env()
    env["PYTHONPATH"] = str(tmp_path)
    p = subprocess.run(
        [sys.executable, "-c", "import sys; sys.argv[1:] = ['--workload', "
         "'qwen2-1.5b.rag-open', '--seed', '5', '--seconds', '1']; "
         "sys.path.insert(0, 'chipbench'); import runpy; "
         "import torch; torch.cuda.is_available = lambda: True; "
         "torch.cuda.device_count = lambda: 1; "
         "runpy.run_path('chipbench/run.py', run_name='__main__')"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_harness_and_reference_load_no_jax():
    """A run loads no top-level jax, jaxlib, flax or repro module (the port
    is repro_torch: names compare whole), and a reference loads nothing of
    the port."""
    code = (
        "import io, sys\n"
        "from chipbench.harness import driver\n"
        "from chipbench.tests import tiny\n"
        "driver.run_cell(tiny.cell(), 1, 0.5, False, device='cpu', "
        "energy=tiny.HostEnergy(), out=io.StringIO())\n"
        "sys.path.insert(0, 'chipbench')\n"
        "import run\n"
        "print(run.loaded_forbidden())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
    code = ("import sys\n"
            "import chipbench.reference.qwen2, chipbench.reference.qwen3\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def test_forbidden_names_compare_whole():
    sys.path.insert(0, os.path.join(ROOT, "chipbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    assert run.loaded_forbidden(["repro_torch", "repro_torch.serving",
                                 "reprolib", "torch"]) == []
    assert run.loaded_forbidden(["repro_torch", "repro.core",
                                 "jax.numpy"]) == ["jax", "repro"]


def _no_cache_write(*a, **k):
    """A decode step that leaves its state (the K/V pool) unchanged."""


def _half_batch(real):
    def step(params, cfg, tok, caches, pos, **kw):
        logits, c = real(params, cfg, tok, caches, pos, **kw)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:logits.shape[0] - half]
        return logits, c
    return step


def _altered_token(real):
    def sample(sampled, logits, *a):
        tok = real(sampled, logits, *a)
        return (tok + 1) % logits.shape[-1]
    return sample


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_check_fails_a_broken_timed_path(monkeypatch, fault):
    """The whole run, with the timed path broken underneath, comes out not
    correct: a decode step that returns its state unchanged, half of the
    batch's rows left out (their logits replaced by the other half's), a
    token altered where it is produced.  (One chip: no exchange between
    chips to leave out.)"""
    import repro_torch.models.kvcache as kv
    import repro_torch.serving.engine as eng
    if fault == "state_unchanged":
        monkeypatch.setattr(kv, "paged_cache_write_decode", _no_cache_write)
    elif fault == "half_batch":
        monkeypatch.setattr(eng, "decode_step", _half_batch(eng.decode_step))
    else:
        monkeypatch.setattr(eng, "_sample_rows",
                            _altered_token(eng._sample_rows))
    # a sample of some tens of requests, so that it holds rows of both
    # halves of the 4-row batch
    res = _run(tiny.cell(check=dict(tiny.CHECK, served_tokens=150)),
               seconds=1.5)
    assert res["check"]["served_tokens"]["value"] >= 150
    assert res["check"]["max_logit_gap"]["value"] > 1e-3
    assert res["correct"] is False


def test_result_line_is_json_with_its_keys():
    res = _run(tiny.cell(traffic=tiny.OPEN), seconds=1.0)
    line = json.dumps(res)
    back = json.loads(line)
    for k in ("correct", "attempted", "failed", "metrics", "device", "check"):
        assert k in back
    assert set(back["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
