"""The generator is seeded, reproducible, and gives every seed the same
sizes in another order."""

import json

import numpy as np

from h100bench.tests.small import HERE
from h100bench.traffic import ServeTraffic, rng, stratified


def real(name):
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def test_same_seed_same_requests():
    a, b = (ServeTraffic(real("batch"), 32768, 2**31 + 9) for _ in range(2))
    for i in (0, 5, 300):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt) and ra.max_new == rb.max_new


def test_seeds_share_sizes_block_by_block():
    m = real("batch")
    s1, s2 = ServeTraffic(m, 32768, 1), ServeTraffic(m, 32768, 2**31 + 5)
    n = m["stratum"]
    lens = [len(s1.request(i).prompt) for i in range(4 * n)]
    lens2 = [len(s2.request(i).prompt) for i in range(4 * n)]
    assert sorted(lens) == sorted(lens2) and lens != lens2
    assert min(lens) >= 256 and max(lens) <= 2048


def test_first_requests_spread_their_outputs():
    m = real("batch")
    t = ServeTraffic(m, 32768, 7)
    firsts = [t.request(i).max_new for i in range(128)]
    later = [t.request(i).max_new for i in range(128, 256)]
    assert min(firsts) < 64 <= min(later)
    assert max(later) <= 512


def test_stratified_holds_each_quantile_once_per_block():
    d = {"dist": "uniform", "min": 10, "max": 20}
    out = stratified(d, 22, 11, rng(1, "x"))
    assert sorted(out[:11]) == list(range(10, 21))


def test_warm_lengths_reach_every_padded_shape():
    assert ServeTraffic(real("batch"), 32768, 1).warm_lengths() == [256, 512, 1024, 2048]
    fixed = dict(real("batch"), prompt={"dist": "fixed", "value": 300})
    assert ServeTraffic(fixed, 32768, 1).warm_lengths() == [300]
