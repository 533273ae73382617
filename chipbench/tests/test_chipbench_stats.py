"""The end-to-end metrics on hand-made event streams."""
import math

import numpy as np
import pytest

from chipbench.harness import stats
from chipbench.harness.stats import Record


@pytest.mark.parametrize("values", [[3.0], [1.0, 2.0], list(range(11)),
                                    [5.0, 1.0, 9.0, 2.0, 7.0]])
@pytest.mark.parametrize("p", [50, 90, 95])
def test_percentile_matches_numpy(values, p):
    assert stats.percentile(values, p) == pytest.approx(
        float(np.percentile(values, p)))


def test_percentile_counts_missing_as_infinite():
    assert stats.percentile([1.0] * 8 + [math.inf] * 2, 90) == math.inf
    assert stats.percentile([1.0] * 19 + [math.inf], 90) == 1.0


def test_ttft_from_due_time_tail_over_all_requests():
    recs = [Record(100, 8, sent=10.0 + i, first=10.5 + 1.5 * i)
            for i in range(10)]
    recs.append(Record(100, 8, sent=25.0, first=26.0))      # due after t1
    recs.append(Record(100, 8, sent=12.5, failed=True))      # never served
    ttft = stats.ttft_s(recs, 10.0, 20.0)
    assert len(ttft) == 11 and math.inf in ttft
    assert sorted(ttft)[:10] == pytest.approx([0.5 + 0.5 * i
                                               for i in range(10)])


def test_tpot_over_requests_finished_in_window():
    recs = [Record(10, 5, sent=0.0, first=1.0, last=3.0, tokens=5,
                   finished=3.0),
            Record(10, 3, sent=0.0, first=1.0, last=2.0, tokens=3,
                   finished=2.0),
            Record(10, 3, sent=0.0, first=1.0, last=9.0, tokens=3,
                   finished=9.0),                             # after t1
            Record(10, 1, sent=0.0, first=1.0, last=1.0, tokens=1,
                   finished=1.0)]                             # one token
    assert stats.tpot_s(recs, 0.0, 5.0) == [0.5, 0.5]


def test_window_metrics_rates_and_energy_per_token():
    recs = [Record(100, 4, sent=0.0, first=1.0, last=2.0, tokens=4,
                   finished=2.0),
            Record(300, 4, sent=0.5, first=1.5, last=3.0, tokens=4,
                   finished=3.0),
            Record(50, 4, sent=3.5, first=4.5, last=4.5, tokens=1)]
    drained = [(1.0, 1), (1.5, 1), (2.0, 3), (3.0, 3), (4.5, 1)]
    e0, e1 = 1000.0, 1205.0                  # two counter readings, J
    m = stats.window_metrics(recs, drained, 0.0, 4.0, e1 - e0)
    assert m["out_tok_s"] == pytest.approx(8 / 4.0)
    assert m["j_per_tok"] == pytest.approx(205.0 / (100 + 300 + 8))
    assert m["tpot_p90_ms"] == pytest.approx(
        1e3 * float(np.percentile([1 / 3, 0.5], 90)))
    assert m["ttft_p90_ms"] == pytest.approx(1e3 * 1.0)

