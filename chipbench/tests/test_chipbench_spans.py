"""The readers of the engine's ``serve.*`` ranges on hand-made events."""
import re

import pytest

from chipbench.harness import readers, spec
from chipbench.harness.driver import Readings
from chipbench.harness.trace import Ev, Slice

MS = 1_000_000
SPLIT = ("sched_idle_share", "launch_idle_share")


def _ev(name, a, b, thread=7):
    return Ev(name, False, int(a * MS), int(b * MS), thread)


def _dev(a, b):
    return Ev("kernel", True, a * MS, b * MS)


def _slice(with_ranges=True):
    """A 100 ms slice on thread 7.  Device idle gaps and the innermost
    serve.* range across each one's middle: 0-5 serve.admit, 10-12
    serve.prefill, 14-28 serve.step, 34-38 serve.decode.step (an aten
    operator inside it is no range), 50-82 serve.account, 84-96 none."""
    host = [_ev("chipbench.slice", 0, 100),
            _ev("aten::mm", 35.5, 36.5)]
    if with_ranges:
        host += [_ev("serve.step", 1, 80),
                 _ev("serve.admit", 2, 20), _ev("serve.prefill", 3, 15),
                 _ev("serve.decode", 22, 60), _ev("serve.pages", 22.5, 24),
                 _ev("serve.decode.step", 25, 35),
                 _ev("serve.decode.step", 35, 45),
                 _ev("serve.account", 60, 70),
                 # past the slice's end, and on another thread
                 _ev("serve.decode.step", 95, 110),
                 _ev("serve.decode.step", 0, 100, thread=8)]
    dev = [_dev(5, 10), _dev(12, 14), _dev(28, 34), _dev(38, 50),
           _dev(82, 84), _dev(96, 120)]
    return Slice(0, 100 * MS, host + dev, 7)


def _read(name, sl, patterns=None):
    read, spans = spec.metric_reader(name)
    r = Readings({}, None, sl, None)
    r.patterns = spans if patterns is None else patterns
    return read(r)


def test_split_of_the_idle_time():
    sl = _slice()
    assert _read("sched_idle_share", sl) == pytest.approx(5 + 14 + 32)
    assert _read("launch_idle_share", sl) == pytest.approx(2 + 4)
    # the rest of the idle lies outside every serve.* range
    idle = readers.idle_share(Readings({}, None, sl, None))
    assert idle == pytest.approx(69.0)
    assert sum(_read(n, sl) for n in SPLIT) + 12 == pytest.approx(idle)


def test_decode_launch_ms_is_the_mean_step_range_wholly_in_the_slice():
    assert _read("decode_launch_ms", _slice()) == pytest.approx(10.0)


def test_range_names_match_whole():
    sl = _slice()
    # serve.decode holds the 34-38 gap only through serve.decode.step
    assert _read("launch_idle_share", sl, ["serve.decode"]) == 0.0
    assert _read("decode_launch_ms", sl, ["serve.decode"]) == \
        pytest.approx(38.0)
    assert _read("decode_launch_ms", sl, ["serve.decode.s"]) is None


@pytest.mark.parametrize("name", SPLIT + ("decode_launch_ms",))
def test_no_ranges_read_none(name):
    assert _read(name, _slice(with_ranges=False)) is None
    assert _read(name, None) is None


def test_span_files_name_the_engines_ranges():
    """The two idle shares split the engine's ranges between them, and
    every name read is a range the engine opens."""
    src = (spec.ROOT / "src/repro_torch/serving/engine.py").read_text()
    opened = set(re.findall(r'_range\("([\w.]+)"\)', src))
    sched, launch = (set(spec.metric_reader(n)[1]) for n in SPLIT)
    assert not sched & launch and sched | launch == opened
    assert set(spec.metric_reader("decode_launch_ms")[1]) <= opened
