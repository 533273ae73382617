"""The port's examples (``repro_torch/examples``) against the reference's
(``examples/``).

* ``quickstart.main()`` prints what ``examples/quickstart.py`` prints: the
  fitted models, the prefill clocks and the decode controller's
  trajectory (the control plane is numpy over copied modules).
* ``serve_trace_replay`` with the cluster, the prefix cache, a killed
  decode replica and failed handoff imports, on the CPU: it drains every
  burst (the example asserts warm == cold tokens, the kill and the
  retries), and its governor table is the reference's ``replay`` on the
  same trace, bit for bit and as printed.
"""
import dataclasses
import pathlib
import runpy

import pytest

from repro.configs import get_config as jget_config
from repro.data import get_trace as jget_trace
from repro.sim import ReplayConfig as JReplayConfig
from repro.sim import replay as jreplay

from repro_torch.examples import quickstart, serve_trace_replay
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOVERNORS = ("defaultNV", "prefillsplit", "greenllm")


def test_quickstart_prints_the_reference_output(capsys):
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                   run_name="__main__")
    ref = capsys.readouterr().out
    quickstart.main()
    got = capsys.readouterr().out
    assert got == ref
    assert got.count("\n") == 9 and "load=high" in got


def _table_row(gov, m, base):
    # examples/serve_trace_replay.py's governor table row
    return (f"{gov:14s} {m.ttft_pass*100:7.1f} {m.tbt_pass*100:7.1f} "
            f"{m.prefill_energy_j/1e3:9.1f} {m.decode_energy_j/1e3:9.1f} "
            f"{100*(1-m.total_energy_j/base):7.2f} "
            f"{m.throughput_tok_s:7.0f}")


def test_serve_trace_replay_on_cpu(capsys):
    out = serve_trace_replay.main([
        "--device", "cpu", "--duration", "10", "--cluster",
        "--prefix-cache", "--kill-replica", "decode0",
        "--handoff-failures", "2"])
    text = capsys.readouterr().out

    cfg, trace = jget_config("qwen3-14b"), jget_trace("chat_5qps",
                                                      duration=10)
    ref = {g: jreplay(cfg, trace, JReplayConfig(governor=g))
           for g in GOVERNORS}
    assert list(out["governors"]) == list(GOVERNORS)
    for g in GOVERNORS:
        assert repr(dataclasses.asdict(out["governors"][g])) == \
            repr(dataclasses.asdict(ref[g])), g
    base = ref["defaultNV"].total_energy_j
    rows = [_table_row(g, ref[g], base) for g in GOVERNORS]
    lines = text.splitlines()
    at = lines.index(next(x for x in lines if x.startswith("governor ")))
    assert lines[at + 1:at + 4] == rows

    n = 12
    assert out["burst"].completed == out["burst"].n_requests == n
    assert out["paged"].completed == out["paged"].n_requests
    assert out["paged"].preempted > 0              # half the K/V memory
    cold, warm = out["prefix"]
    assert warm.prefill_tokens < cold.prefill_tokens
    assert cold.completed == warm.completed == n
    cl, rep, base_rep = out["cluster"]
    assert rep.completed == base_rep.completed == rep.n_requests
    assert [name for name, _, _ in cl.kills] == ["decode0"]
    assert cl.import_retries >= 2
    assert sum(r.energy_j for r in rep.replicas) == \
        pytest.approx(rep.total_energy_j, rel=1e-12)
    assert "hit_rate=" in text and "DVFS audit:" in text
