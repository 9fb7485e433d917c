"""The traffic generator: deterministic per seed, the same work in every
burst of every seed, in another order."""
import numpy as np
import pytest

import cases
from portbench import generator

MIXES = ["doc", "doc4k", "chat"]


def _mix(name):
    return cases.H.load_json(cases.ROOT / "portbench" / "traffic"
                             / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_burst(name):
    mix = _mix(name)
    for seed in (0, 2**31 + 12345, 987654321987):
        a = generator.burst(mix, seed, 3, 512)
        b = generator.burst(mix, seed, 3, 512)
        assert [s.rid for s in a] == [s.rid for s in b]
        assert all(np.array_equal(x.tokens, y.tokens) and
                   x.max_new == y.max_new for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_every_burst_carries_the_same_lengths_in_another_order(name):
    mix = _mix(name)
    ref = generator.burst(mix, 1, 0, 512)
    want_p = sorted(len(s.tokens) for s in ref)
    want_a = sorted(s.max_new for s in ref)
    orders = set()
    for seed, k in ((1, 1), (2, 0), (2**33 + 7, 5)):
        got = generator.burst(mix, seed, k, 512)
        assert sorted(len(s.tokens) for s in got) == want_p
        assert sorted(s.max_new for s in got) == want_a
        assert [s.rid for s in got] == list(range(k * mix["burst"],
                                                  (k + 1) * mix["burst"]))
        orders.add(tuple(len(s.tokens) for s in got))
    assert len(orders) == 3
    lo, hi = mix["prompt_tokens"]
    assert want_p[0] >= lo and want_p[-1] <= hi
    assert want_p == generator.quantile_lengths(lo, hi, mix["burst"])


def test_log_uniform_quantiles():
    q = generator.quantile_lengths(2048, 8192, 32)
    assert q == sorted(q) and len(q) == 32
    assert q[0] > 2048 and q[-1] < 8192
    assert abs(np.median(q) - 4096) < 100


def test_tokens_come_from_a_topic_of_the_shared_vocabulary():
    mix = _mix("chat")
    for s in generator.burst(mix, 5, 0, 512):
        assert s.tokens.dtype == np.int32
        assert s.tokens.min() >= 0 and s.tokens.max() < 512
        assert len(np.unique(s.tokens)) <= mix["topic_ids"]
    a, b = generator.burst(mix, 5, 0, 512)[:2]
    assert set(a.tokens.tolist()) != set(b.tokens.tolist())
