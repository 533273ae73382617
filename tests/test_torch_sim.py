"""The port's trace-replay simulator (``sim/engine.py``, ``sim/replay.py``)
against the reference's, bitwise.

The simulator is numpy over the copied control plane (``core/*``), the
copied traces and the copied plant, so the same trace gives the same floats
in the same order: every ``Metrics`` field of ``replay`` and every field of
the ``ServingReport`` that ``Server(simulator)`` returns equal the
reference's exactly (compared through ``repr``, which spells a float's
every bit).  The paper's claims on long traces stay with
``tests/test_system.py``: equality with the reference carries them.

* ``replay`` under the three governors on chat_5qps x qwen3-14b (its
  steps, keeping the simulators), on the MoE model (qwen3-moe-30b-a3b on
  azure_conv5), on the TPU v5e profile and on mamba2-370m with a linear
  latency fit.
* The report parity scenario of ``tests/test_api.py``: the simulator is a
  ``Backend``, and its report equals the reference's and the paper's
  ``compute_metrics`` on the same run.
* The energy meter covers the whole horizon and every request completes
  (``tests/test_sim_traces.py``), on the chat5 runs under every
  governor.
"""
import copy
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import Request as JRequest
from repro.core import SamplingParams as JSamplingParams
from repro.core import hardware as JHWMOD
from repro.data import get_trace as jget_trace
from repro.serving import Server as JServer
from repro.sim import ReplayConfig as JReplayConfig
from repro.sim import build_simulator as jbuild_simulator
from repro.sim import replay as jreplay

from repro_torch.configs import get_config
from repro_torch.core import Request, SamplingParams
from repro_torch.core import hardware as HWMOD
from repro_torch.data import get_trace
from repro_torch.serving import Backend, Server
from repro_torch.sim import (GOVERNORS, Metrics, ReplayConfig,
                             ServingSimulator, build_simulator,
                             compute_metrics, replay)
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

# case: (arch, trace, duration s, hardware profile, latency fit degree)
CASES = {
    "chat5-qwen3-14b": ("qwen3-14b", "chat_5qps", 20, "A100_SXM4_40G", 2),
    "moe-qwen3-30b": ("qwen3-moe-30b-a3b", "azure_conv5", 5,
                      "A100_SXM4_40G", 2),
    "tpu-v5e": ("qwen3-14b", "chat_3qps", 5, "TPU_V5E", 2),
    # a small model decodes ~10x more steps per virtual second
    "mamba2-370m": ("mamba2-370m", "chat_5qps", 2, "A100_SXM4_40G", 1),
}


def _bits(obj):
    """A dataclass as text that differs wherever a float's bits do."""
    return repr(dataclasses.asdict(obj))


@pytest.fixture(scope="module")
def chat5_runs():
    """The port's simulator on the chat5 case under each governor, run as
    ``replay`` runs it (``build_simulator``, ``run`` on copies of the
    trace, ``compute_metrics``), keeping the simulators for the energy and
    completion checks: ``{governor: (simulator, SimResult, Metrics)}``."""
    arch, trace, dur, hw, deg = CASES["chat5-qwen3-14b"]
    trace = get_trace(trace, duration=dur)
    out = {}
    for gov in GOVERNORS:
        rc = ReplayConfig(governor=gov, latency_fit_degree=deg)
        sim = build_simulator(get_config(arch), getattr(HWMOD, hw), rc)
        res = sim.run([copy.copy(r) for r in trace])
        out[gov] = sim, res, compute_metrics(res, rc.slo)
    return out


@pytest.mark.parametrize("gov", GOVERNORS)
@pytest.mark.parametrize("case", list(CASES))
def test_replay_is_bitwise_the_reference(case, gov, request):
    arch, trace, dur, hw, deg = CASES[case]
    ref = jreplay(jget_config(arch), jget_trace(trace, duration=dur),
                  JReplayConfig(governor=gov, latency_fit_degree=deg),
                  hw=getattr(JHWMOD, hw))
    if case == "chat5-qwen3-14b":       # replay's steps, simulator kept
        got = request.getfixturevalue("chat5_runs")[gov][2]
    else:
        got = replay(get_config(arch), get_trace(trace, duration=dur),
                     ReplayConfig(governor=gov, latency_fit_degree=deg),
                     hw=getattr(HWMOD, hw))
    assert isinstance(got, Metrics)
    assert got.n_requests == ref.n_requests > 0
    assert _bits(got) == _bits(ref)


def _parity_trace(cls):
    rng = np.random.default_rng(11)
    return [cls(rid=i, arrival=0.2 * i,
                prompt_len=int(rng.integers(64, 2000)),
                output_len=int(rng.integers(8, 40)))
            for i in range(12)]


def _serve(server_cls, sampling_cls, sim, trace):
    srv = server_cls(sim)
    for r in trace:
        srv.submit(r.prompt_len, sampling_cls(max_tokens=r.output_len),
                   arrival=r.arrival, rid=r.rid)
    return srv.run()


def test_server_report_parity_with_reference_and_compute_metrics():
    rc, jrc = ReplayConfig(governor="greenllm"), JReplayConfig(
        governor="greenllm")
    cfg, jcfg = get_config("qwen2-1.5b"), jget_config("qwen2-1.5b")
    trace = _parity_trace(Request)

    hw = HWMOD.A100_SXM4_40G
    res = build_simulator(cfg, hw, rc).run([copy.copy(r) for r in trace])
    m = compute_metrics(res, rc.slo)
    sim = build_simulator(cfg, hw, rc)
    assert isinstance(sim, ServingSimulator) and isinstance(sim, Backend)
    rep = _serve(Server, SamplingParams, sim, trace)
    jsim = jbuild_simulator(jcfg, JHWMOD.A100_SXM4_40G, jrc)
    jrep = _serve(JServer, JSamplingParams, jsim, _parity_trace(JRequest))

    assert rep.backend == "simulator"
    assert _bits(rep) == _bits(jrep)
    assert (rep.total_energy_j, rep.throughput_tok_s) == \
        (jrep.total_energy_j, jrep.throughput_tok_s)
    assert rep.n_requests == m.n_requests == len(trace)
    assert (rep.ttft_pass, rep.tbt_pass) == (m.ttft_pass, m.tbt_pass)
    assert dict(rep.p90_ttft_s) == m.p90_ttft
    assert (rep.p95_tbt_s, rep.p99_tbt_s) == (m.p95_tbt, m.p99_tbt)
    assert (rep.prefill_energy_j, rep.decode_energy_j) == \
        (m.prefill_energy_j, m.decode_energy_j)
    assert (rep.total_energy_j, rep.throughput_tok_s) == \
        (m.total_energy_j, m.throughput_tok_s)


def test_energy_meter_covers_the_horizon(chat5_runs):
    for sim, res, _ in chat5_runs.values():
        for w in sim.prefill + sim.decode:
            assert w.energy.total_j >= \
                w.plant.idle_power * res.duration * 0.99


def test_all_requests_complete(chat5_runs):
    n = len(get_trace("chat_5qps", duration=CASES["chat5-qwen3-14b"][2]))
    for _, res, _ in chat5_runs.values():
        assert len(res.requests) == n
        assert all(r.finish >= 0 for r in res.requests)
        assert all(r.tokens_emitted == r.output_len for r in res.requests)
