"""The traffic generator: seeded, the same work for every seed."""

import json
import os

import numpy as np

from conftest import ROOT
from perfbench import audio, traffic


def mix(name):
    with open(os.path.join(ROOT, "perfbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def test_the_same_seed_gives_the_same_requests():
    m = mix("stream")
    assert traffic.requests(m, 2 ** 31 + 5) == traffic.requests(m, 2 ** 31 + 5)
    assert traffic.requests(m, 2 ** 31 + 5) != traffic.requests(m, 2 ** 31 + 6)


def test_every_seed_does_the_same_work_in_another_order():
    for name, n in (("stream", None), ("serve-poisson", 120)):
        m = mix(name)
        a = traffic.requests(m, 3_000_000_017, n=n)
        b = traffic.requests(m, 12, n=n)
        assert sorted(r.src_seconds for r in a) == sorted(r.src_seconds for r in b)
        assert sorted(r.ref_seconds for r in a) == sorted(r.ref_seconds for r in b)
        if m["arrivals"] == "poisson":
            assert abs(a[-1].at - b[-1].at) < 1e-6
            assert abs(traffic.mean_rate(a) - m["rate"]) / m["rate"] < 0.05


def test_lengths_follow_the_mix():
    m = mix("stream")
    src = sorted(r.src_seconds for r in traffic.requests(m, 1))
    assert 1.0 <= src[0] and src[-1] <= 12.0
    assert abs(np.median(src) - 3.0) < 0.3
    assert all(3.0 <= r.ref_seconds <= 6.0 for r in traffic.requests(m, 1))


def test_clips_are_sixteen_bit_values_at_the_asked_rate():
    x = audio.clip(ROOT, 16000, 2.5, 3, 0.4)
    assert x.shape == (1, 40000) and x.dtype == np.float32
    assert np.array_equal(np.rint(x * 32768) / 32768, x)
    y = audio.clip(ROOT, 24000, 4.0, 2, 0.9)
    assert y.shape == (1, 96000) and np.abs(y).max() > 0.01


def test_an_order_seed_keeps_one_order_for_every_seed():
    m = dict(mix("serve-poisson"), order_seed=7)
    a, b = traffic.requests(m, 11, n=50), traffic.requests(m, 12, n=50)
    assert [r.src_seconds for r in a] == [r.src_seconds for r in b]
    assert [r.at for r in a] == [r.at for r in b]
    assert [r.src_offset for r in a] != [r.src_offset for r in b]


def test_a_burst_groups_requests_at_one_instant_at_the_same_mean_rate():
    m = dict(mix("serve-poisson"), burst={"size": 4})
    plain = traffic.requests(mix("serve-poisson"), 2 ** 31 + 9, n=120)
    burst = traffic.requests(m, 2 ** 31 + 9, n=120)
    at = [r.at for r in burst]
    assert all(len(set(at[i: i + 4])) == 1 for i in range(0, 120, 4))
    assert len(set(at)) == 30
    # the same gaps summed: the last group is due when the plain mix ends
    assert np.isclose(at[-1], plain[-1].at)
