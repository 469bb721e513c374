"""The traffic generator: deterministic by seed, stratified, clipped."""
import numpy as np

from portbench import traffic

SPEC = {"burst": 48,
        "prompt": {"median": 256, "sigma": 0.8, "min": 32, "max": 768},
        "output": {"median": 96, "sigma": 0.6, "min": 32, "max": 256}}


def _take(seed, n=3):
    gen = traffic.bursts(SPEC, seed, 151936)
    return [next(gen) for _ in range(n)]


def test_same_seed_same_bursts():
    a, b = _take(2**31 + 77), _take(2**31 + 77)
    for x, y in zip(a, b):
        assert [m for _, m in x] == [m for _, m in y]
        assert all(np.array_equal(p, q) for (p, _), (q, _) in zip(x, y))


def test_other_seed_other_order_same_lengths():
    a, b = _take(5), _take(6)
    assert [len(p) for p, _ in a[0]] != [len(p) for p, _ in b[0]]
    for x, y in zip(a, b):
        assert sorted(len(p) for p, _ in x) == sorted(len(p) for p, _ in y)
        assert sorted(m for _, m in x) == sorted(m for _, m in y)


def test_every_burst_holds_the_stratified_lengths():
    want_p = traffic.lengths(SPEC["prompt"], 48)
    want_o = traffic.lengths(SPEC["output"], 48)
    for burst in _take(11, 4):
        assert sorted(len(p) for p, _ in burst) == list(want_p)
        assert sorted(m for _, m in burst) == list(want_o)
        for p, _ in burst:
            assert p.dtype == np.int32 and p.min() >= 0 and p.max() < 151936


def test_lengths_keep_their_clips_and_median():
    spec = {"median": 256, "sigma": 2.0, "min": 32, "max": 768}
    x = traffic.lengths(spec, 1000)
    assert x.min() == 32 and x.max() == 768
    assert abs(np.median(x) - 256) <= 2
    assert np.all(np.diff(x) >= 0)
