"""The serving engine's profiler ranges (``serve.*``, ``serving/engine.py``).

A tiny paged engine (qwen2-1.5b ``.smoke()`` in float32, a pool small
enough to preempt, admission buckets shrunk so that prompts over 16 tokens
take the chunk route) serves one burst under a CPU ``torch.profiler``: a
bucketed prefill, chunked prompts, decode blocks, a preemption and its
resume.  Every range appears and nests as the engine's docstring says, and
the ranges count what the engine counts.  With no profiler running the
same burst makes no ``record_function`` call at all, and serves the same
tokens, virtual time and energy.
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import SamplingParams
from repro_torch.serving import EngineConfig, Server, ServingEngine
from torch_threads import one_thread  # noqa: F401  (autouse fixture)

ECFG = dict(max_batch=4, max_len=96, governor="greenllm",
            cache_dtype="float32", paged=True, page_size=16, num_pages=11,
            decode_block=8)
# (arrival, prompt length, max_tokens): short prompts take the bucketed
# prefill, long ones the chunk route; together they outgrow the pool
BURST = [(0.0, 9, 40), (0.0, 12, 44), (0.0, 30, 36), (0.0, 40, 30),
         (0.01, 14, 9), (0.02, 37, 16), (0.02, 7, 11), (0.05, 45, 8)]
# the serve.* range that directly holds each range
PARENTS = {"serve.step": {None}, "serve.admit": {"serve.step"},
           "serve.prefill": {"serve.admit"}, "serve.chunk": {"serve.step"},
           "serve.pages": {"serve.step", "serve.decode"},
           "serve.decode": {"serve.step"},
           "serve.decode.step": {"serve.decode"},
           "serve.account": {"serve.step"}}


def _serve(profiled: bool):
    """Serve ``BURST``; returns the engine, the served tokens, what the
    engine counted and, when ``profiled``, the stopped profiler."""
    cfg = get_config("qwen2-1.5b").smoke().replace(dtype="float32")
    eng = ServingEngine(cfg, ecfg=EngineConfig(**ECFG),
                        plant_cfg=get_config("qwen2-1.5b"), device="cpu")
    eng.buckets = [b for b in eng.buckets if b <= 16]
    eng.chunk_len = eng.buckets[-1]
    counted = collections.Counter()
    step, admit_slot = eng.step, eng._admit_slot

    def counting_step(k=None):
        n = step(k)
        counted["steps"] += 1
        counted["decode_steps"] += n
        return n

    def counting_admit_slot(req, slot):
        counted["slot_admissions"] += 1
        return admit_slot(req, slot)

    eng.step, eng._admit_slot = counting_step, counting_admit_slot
    srv = Server(eng)
    rng = np.random.default_rng(0)
    handles = [srv.submit(rng.integers(0, cfg.vocab_size, size=n),
                          SamplingParams(max_tokens=m), arrival=t)
               for t, n, m in BURST]
    prof = None
    if profiled:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
    try:
        srv.run()
    finally:
        if prof is not None:
            prof.stop()
    counted["host_drains"] = eng._host_drains
    return eng, [list(h.request.tokens) for h in handles], counted, prof


@pytest.fixture(scope="module")
def profiled():
    return _serve(True)


@pytest.fixture(scope="module")
def bare():
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        mp.setattr(torch.profiler, "record_function", refuse)
        return _serve(False)


def _ranges(prof):
    """[(name, start_ns, end_ns, parent name)] of the serve.* ranges,
    outermost first; a range's parent is the innermost serve.* range
    that holds it (None for none)."""
    evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("serve.")),
                 key=lambda r: (r[1], -r[2]))
    out, stack = [], []
    for name, a, b in evs:
        while stack and stack[-1][2] <= a:
            stack.pop()
        if stack:
            assert b <= stack[-1][2], (name, stack[-1][0])   # nested
        out.append((name, a, b, stack[-1][0] if stack else None))
        stack.append((name, a, b))
    return out


def test_the_burst_drives_every_path(profiled):
    eng, toks, counted, _ = profiled
    assert eng._preempted > 0
    assert counted["slot_admissions"] > 0
    assert all(len(t) == m for t, (_, _, m) in zip(toks, BURST))


def test_every_range_appears_and_nests(profiled):
    ranges = _ranges(profiled[3])
    assert {r[0] for r in ranges} == set(PARENTS)
    seen = collections.defaultdict(set)
    for name, _, _, parent in ranges:
        assert parent in PARENTS[name], (name, parent)
        seen[name].add(parent)
    # page growth runs both before a block and before a chunk
    assert seen["serve.pages"] == PARENTS["serve.pages"]


def test_range_counts_equal_the_engines_counts(profiled):
    _, _, counted, prof = profiled
    n = collections.Counter(r[0] for r in _ranges(prof))
    assert n["serve.step"] == counted["steps"]
    assert n["serve.decode"] == n["serve.account"] == counted["host_drains"]
    assert n["serve.decode.step"] == counted["decode_steps"]
    assert n["serve.prefill"] == counted["slot_admissions"]


def test_no_profiler_makes_no_record_function_call(bare):
    eng, toks, counted, _ = bare
    assert eng._preempted > 0 and counted["host_drains"] > 0
    assert all(len(t) == m for t, (_, _, m) in zip(toks, BURST))


def test_profiler_leaves_tokens_time_and_energy_unchanged(profiled, bare):
    assert profiled[1] == bare[1]
    assert profiled[0].vtime == bare[0].vtime
    assert profiled[0].energy_j == bare[0].energy_j
    assert profiled[2] == bare[2]
