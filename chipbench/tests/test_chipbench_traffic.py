"""The traffic generator: seeded schedules, the fixed length multiset,
open and closed loops, the warm-up burst."""
from collections import Counter

import numpy as np
import pytest

from chipbench.harness import traffic as tf
from chipbench.tests import tiny

SPEC = {"loop": "open", "rate": 4.0, "clients": 8,
        "prompt": {"median": 2048, "sigma": 0.5, "min": 512, "max": 6144},
        "output": {"median": 128, "sigma": 0.6, "min": 32, "max": 512}}


def test_quantiles_are_clipped_and_sorted():
    q = tf.lognormal_quantiles(64, SPEC["prompt"])
    assert q == sorted(q) and q[0] >= 512 and q[-1] <= 6144
    assert q[31] <= 2048 <= q[32]
    gaps = tf.exponential_gaps(50, 10.0)
    assert sum(gaps) == pytest.approx(10.0)
    assert gaps == sorted(gaps)


def test_open_schedule_same_seed_same_requests():
    a = tf.Traffic(SPEC, 1000).open_schedule(2 ** 31 + 77, 10.0)
    b = tf.Traffic(SPEC, 1000).open_schedule(2 ** 31 + 77, 10.0)
    assert [(r.offset, r.max_tokens) for r in a] == \
        [(r.offset, r.max_tokens) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("rate", [None, 2.5])
def test_open_schedule_lengths_fixed_across_seeds(rate):
    t = tf.Traffic(SPEC, 1000)
    runs = [t.open_schedule(s, 10.0, rate) for s in (1, 2, 3 ** 20)]
    n = round((rate or SPEC["rate"]) * 10.0)
    for reqs in runs:
        assert len(reqs) == n
        assert reqs[0].offset == 0.0 and reqs[-1].offset < 10.0
        assert all(a.offset < b.offset for a, b in zip(reqs, reqs[1:]))
    multisets = [Counter(len(r.prompt) for r in reqs) for reqs in runs]
    outs = [Counter(r.max_tokens for r in reqs) for reqs in runs]
    # the gaps between arrivals: the same quantiles but the one after the
    # last arrival, which the window ends in
    gaps = [Counter(np.diff([r.offset for r in reqs]).round(9))
            for reqs in runs]
    assert multisets[0] == multisets[1] == multisets[2]
    assert outs[0] == outs[1] == outs[2]
    assert all(sum((gaps[0] - g).values()) <= 1 for g in gaps[1:])
    assert [len(r.prompt) for r in runs[0]] != [len(r.prompt) for r in runs[1]]


def test_closed_stream_blocks_are_permutations():
    t = tf.Traffic(dict(SPEC, loop="closed"), 1000)
    it = t.closed_stream(5)
    reqs = [next(it) for _ in range(3 * 8)]
    want = Counter(tf.lognormal_quantiles(8, SPEC["prompt"]))
    for b in range(3):
        block = reqs[8 * b: 8 * b + 8]
        assert Counter(len(r.prompt) for r in block) == want
    other = tf.Traffic(dict(SPEC, loop="closed"), 1000).closed_stream(6)
    assert [len(next(other).prompt) for _ in range(8)] != \
        [len(r.prompt) for r in reqs[:8]]


def test_token_ids_cover_the_vocabulary_uniformly():
    reqs = tf.Traffic(SPEC, 50).open_schedule(9, 10.0)
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() == 0 and ids.max() == 49
    counts = np.bincount(ids, minlength=50)
    assert counts.min() > 0.8 * counts.mean()


def test_warmup_touches_each_bucket_of_the_prompt_range():
    t = tf.Traffic(SPEC, 1000)
    buckets = [16 * 2 ** i for i in range(10)]          # 16 .. 8192
    reqs = t.warmup(3, buckets, 8, 22)
    lens = [len(r.prompt) for r in reqs]
    assert lens == [512, 1024, 2048, 4096, 6144, 512, 512, 512]
    assert all(r.max_tokens == 22 for r in reqs)


def test_unknown_loop_is_refused():
    with pytest.raises(ValueError):
        tf.Traffic(dict(tiny.OPEN, loop="burst"), 10)
