"""BENCHMARK.json's keys, names and limits, and every file it names
found where the harness looks for it."""
import re

import pytest

from chipbench.harness import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(
        _line(w) for w in BENCH["command"])
    assert (spec.ROOT / BENCH["command"][1]).is_file()
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    # every run of 24 cells, 14 each, at run_seconds fits in 12 hours
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("chipbench/")
        config = spec.load_json(spec.ROOT / c["file"])
        assert config["name"] == c["name"]
        spec.reference_of(config["family"])
        spec.adapter_of(config["family"])
        assert not c["reduced"]


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert _line(w["why"])
        cell = spec.load_cell(w["name"])
        assert {"max_logit_gap", "served_tokens"} <= set(cell.check)
        assert cell.traffic["loop"] in ("open", "closed")
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert len(BENCH["workloads"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert m["moves"] in e2e and _line(m["layer"])
            # the metric it moves is reported in each of its cells
            moved = [x for x in BENCH["end_to_end"]
                     if x["name"] == m["moves"]][0]
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
            if m["unit"] == "%" and ("roofline" in m["name"]
                                     or "mfu" in m["name"]):
                assert m["better"] == "higher"
    assert len({m["name"] for m in BENCH[kind]}) == len(BENCH[kind])


def test_each_roofline_has_a_step_mfu_beside_it():
    """A kernel's roofline share stands beside the whole step's share of
    the peak, moving the same end-to-end metric in the same cells."""
    pl = BENCH["per_layer"]
    for m in pl:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(x["workloads"])
                       for x in pl), m["name"]
