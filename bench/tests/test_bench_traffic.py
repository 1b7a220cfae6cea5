"""The one traffic generator: the same seed gives the same stream, every
block of ``strata`` requests holds the same lengths, and the stated
ranges and medians hold."""
import statistics

import numpy as np
import pytest

from bench_tiny import BENCH  # noqa: F401  (puts bench/ on the path)
from benchlib import registry, traffic

SEED = 2**31 + 12345


@pytest.mark.parametrize("mix", ["chat", "code"])
def test_bench_traffic_same_seed_same_stream(mix):
    t = registry.load_json("traffic", mix)
    a, b = traffic.Requests(t, SEED, 50304), traffic.Requests(t, SEED, 50304)
    for i in (0, 1, 17, 300):
        pa, na = a[i]
        pb, nb = b[i]
        assert na == nb and np.array_equal(pa, pb)
    c = traffic.Requests(t, SEED + 1, 50304)
    assert any(not np.array_equal(a[i][0], c[i][0]) for i in range(4))


@pytest.mark.parametrize("mix", ["chat", "code"])
def test_bench_traffic_blocks_hold_the_same_lengths(mix):
    t = registry.load_json("traffic", mix)
    n = t["strata"]
    for seed in (1, SEED):
        r = traffic.Requests(t, seed, 50304)
        for blk in range(3):
            got = sorted(r.lengths(blk * n + j) for j in range(n))
            assert sorted(x for x, _ in got) == sorted(r.prompt_strata)
            assert sorted(y for _, y in got) == sorted(r.output_strata)


@pytest.mark.parametrize("mix,prompt,output,lim", [("chat", 1020, 129, (1536, 512)),
                                                     ("code", 1500, 13, (1984, 64))])
def test_bench_traffic_medians_are_the_sources_cut_to_the_context(mix, prompt, output, lim):
    # the medians that Splitwise gives for the Azure 2023 trace; only the
    # 2048-token context cuts the lengths
    t = registry.load_json("traffic", mix)
    assert t["source"].startswith("Splitwise") and "2048" in t["cut"]
    assert (t["prompt"]["max"], t["output"]["max"]) == lim and sum(lim) == 2048
    r = traffic.Requests(t, SEED, 50304)
    assert abs(statistics.median(r.prompt_strata) - prompt) <= 0.01 * prompt
    assert abs(statistics.median(r.output_strata) - output) <= 0.01 * output + 0.5
    assert max(r.prompt_strata) + max(r.output_strata) <= 2048
    assert min(r.prompt_strata) > t["prompt"]["min"] and min(r.output_strata) > t["output"]["min"]
    prompt_ids, new = r[3]
    assert prompt_ids.dtype == np.int32 and prompt_ids.max() < 50304
    assert len(prompt_ids) == r.lengths(3)[0] and new == r.lengths(3)[1]
