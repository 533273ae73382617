"""The trace reduction and the per-layer readers on hand-made events."""
import pytest

from chipbench.harness import readers, spec
from chipbench.harness.driver import Readings
from chipbench.harness.trace import Ev, Slice, merge, top
from chipbench.harness.work import Dims, Work
from chipbench.tests import tiny

MS = 1_000_000


def _slice():
    ev = [Ev("chipbench.slice", False, 0, 100 * MS, 7),
          Ev("chipbench.step", False, 1 * MS, 60 * MS, 7),
          Ev("aten::mm", False, 2 * MS, 4 * MS, 7),
          Ev("aten::item", False, 40 * MS, 59 * MS, 7),
          Ev("other thread op", False, 60 * MS, 100 * MS, 8),
          Ev("decode_kernel<bf16>", True, 3 * MS, 13 * MS),
          Ev("combine_kernel", True, 12 * MS, 15 * MS),
          Ev("flash_kernel", True, 20 * MS, 30 * MS),
          Ev("nvjet_gemm", True, 45 * MS, 58 * MS),
          Ev("late_kernel", True, 95 * MS, 120 * MS)]
    return Slice(0, 100 * MS, ev, 7)


def test_merge_intervals():
    assert merge([(5, 7), (1, 3), (2, 4), (7, 9)]) == [(1, 4), (5, 9)]


def test_busy_window_families_and_names():
    s = _slice()
    assert s.window_s == pytest.approx(0.1)
    # 3-15, 20-30, 45-58, 95-100 (clipped to the slice)
    assert s.busy_s == pytest.approx((12 + 10 + 13 + 5) / 1e3)
    assert s.family_s(["decode_kernel", "combine_kernel"]) == \
        pytest.approx(12 / 1e3)
    assert s.family_s(["flash_kernel"]) == pytest.approx(10 / 1e3)
    assert s.family_s(["nothing"]) == 0.0
    assert s.by_name()["late_kernel"] == pytest.approx(5 / 1e3)


def test_idle_gaps_named_by_innermost_host_op():
    s = _slice()
    idle = s.idle_by_host_op()
    # gaps 0-3, 15-20 and 30-45 lie inside the step span (and in no
    # operator); 58-95 only inside the slice span on this thread
    assert idle["chipbench.step"] == pytest.approx((3 + 5 + 15) / 1e3)
    assert idle["chipbench.slice"] == pytest.approx(37 / 1e3)
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)
    assert top(idle, 1) == [["chipbench.slice", pytest.approx(0.037)]]


def _readings():
    w = Work(Dims.of(tiny.QWEN3))
    w.prefill(40)
    w.decode(40, 2, 10)
    peak = {"bf16_flops": 1e9, "hbm_bytes_per_s": 1e8}
    return Readings({"decode_tokens": 30, "decode_steps": 12,
                     "pool_peak_pages": 16, "pool_usable_pages": 64},
                    w, _slice(), peak), w


def test_readers():
    r, w = _readings()
    assert readers.rows_per_step(r) == 2.5
    assert readers.pool_peak_share(r) == 25.0
    assert readers.mfu(r) == pytest.approx(
        100 * w.model_flops / (0.040 * 1e9))
    assert readers.idle_share(r) == pytest.approx(60.0)
    r.patterns = ["decode_kernel", "combine_kernel"]
    assert readers.decode_attn_roofline(r) == pytest.approx(
        100 * w.decode_kv_bytes / 1e8 / 0.012)
    r.patterns = ["flash_kernel"]
    assert readers.prefill_attn_roofline(r) == pytest.approx(
        100 * w.prefill_attn_flops / 1e9 / 0.010)


def test_readers_with_nothing_to_read_return_none():
    r, _ = _readings()
    r.patterns = ["no such kernel"]
    assert readers.decode_attn_roofline(r) is None
    assert readers.prefill_attn_roofline(r) is None
    r.counters["decode_steps"] = 0
    assert readers.rows_per_step(r) is None
    r.slice = None
    assert readers.mfu(r) is None and readers.idle_share(r) is None


def test_every_per_layer_metric_has_a_reader_and_patterns_load():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for m in bench["per_layer"]:
        read, patterns = spec.metric_reader(m["name"])
        assert callable(read)
        if m["name"].endswith("roofline"):
            assert patterns and not any(p.startswith("#") for p in patterns)
