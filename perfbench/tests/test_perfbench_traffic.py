"""The traffic generator: deterministic from the seed, within its mix."""

import json
import math
import os
from statistics import NormalDist

import numpy as np
import pytest

from conftest import BENCH
from perfbench.traffic import WARMUP, WINDOW, Mix

MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "traffic")))


def load(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return Mix.from_file(json.load(f))


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_same_seed_same_batches(name, seed):
    mix = load(name)
    for i in (0, 3):
        a, b = mix.draw(seed, i, 152064), mix.draw(seed, i, 152064)
        assert np.array_equal(a.prompts, b.prompts) and np.array_equal(a.lens, b.lens)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_batches_and_streams_differ(name):
    mix = load(name)
    a = mix.draw(5, 0, 1000)
    assert not np.array_equal(a.prompts, mix.draw(6, 0, 1000).prompts)
    assert not np.array_equal(a.prompts, mix.draw(5, 1, 1000).prompts)
    assert not np.array_equal(a.prompts, mix.draw(5, 0, 1000, stream=WARMUP).prompts)
    assert WINDOW != WARMUP


@pytest.mark.parametrize("name", MIXES)
def test_lengths_ids_and_padding(name):
    mix = load(name)
    for seed in range(20):
        b = mix.draw(seed, 0, 500)
        assert b.prompts.shape == (mix.batch, mix.bucket) and b.gen == mix.gen
        assert ((b.lens >= mix.low) & (b.lens <= mix.high)).all()
        for row, n in zip(b.prompts, b.lens):
            assert (row[:n] >= 0).all() and (row[:n] < 500).all() and not row[n:].any()


#: each distribution the generator draws, beside the mixes' files
SHAPES = {
    "uniform": dict(name="u", batch=8, prompt_len={"low": 64, "high": 256}, bucket=256,
                    gen_tokens=4),
    "lognormal": dict(name="l", batch=8, bucket=4096, gen_tokens=4,
                      prompt_len={"dist": "lognormal", "median": 1500, "sigma": 1.0,
                                  "low": 2049, "high": 4096}),
}


def _cdf(spec, x):
    """The distribution's CDF cut to [low, high + 1), worked out apart
    from the generator."""
    pl = spec["prompt_len"]
    lo, hi = pl["low"], pl["high"] + 1
    if pl.get("dist", "uniform") == "uniform":
        return (x - lo) / (hi - lo)
    f = lambda v: NormalDist().cdf((math.log(v) - math.log(pl["median"])) / pl["sigma"])
    return (f(x) - f(lo)) / (f(hi) - f(lo))


def _shapes():
    out = dict(SHAPES)
    for name in MIXES:
        with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


@pytest.mark.parametrize("name", sorted(_shapes()))
def test_every_seed_serves_the_same_lengths_and_they_cover_the_range(name):
    """Batch i holds one length from each of ``batch`` equal strata of the
    distribution's quantiles, the same for every seed (the seed shuffles
    the rows); over many batches the lengths follow the distribution."""
    spec = _shapes()[name]
    mix = Mix.from_file(spec)
    lens = []
    for i in range(200):
        want = np.sort(mix.draw(0, i, 100).lens)
        for seed in (1, 2 ** 31 + 5):
            assert np.array_equal(np.sort(mix.draw(seed, i, 100).lens), want)
        assert mix.low <= want[0] and want[-1] <= mix.high
        # one a stratum: the j-th length n = floor(x), x's quantile in [j, j + 1) / batch
        for j, n in enumerate(want):
            assert _cdf(spec, n) * mix.batch < j + 1 + 1e-9
            assert _cdf(spec, min(n + 1, mix.high + 1)) * mix.batch > j - 1e-9
        lens.extend(want)
    lens = np.array(lens)
    for p in (0.1, 0.25, 0.5, 0.75, 0.9):
        assert abs(_cdf(spec, np.quantile(lens, p) + 0.5) - p) < 0.01
    assert not np.array_equal(mix.draw(3, 0, 100).lens, mix.draw(4, 0, 100).lens)


def test_a_heavy_tail_is_denser_at_the_bucket_s_low_end():
    """The lognormal cut to (2048, 4096] puts more requests near 2048 than
    near 4096, as the code trace's tail does; a uniform mix would not."""
    mix = Mix.from_file(SHAPES["lognormal"])
    lens = np.concatenate([mix.lengths(i) for i in range(400)])
    low, high = (lens < 2560).mean(), (lens >= 3584).mean()
    assert low > 2 * high and 2700 < lens.mean() < 3000


def test_a_mix_outside_its_bucket_or_of_an_unknown_shape_is_refused():
    for bad in ({"low": 10, "high": 300}, {"dist": "zipf", "low": 1, "high": 9}):
        with pytest.raises(ValueError):
            Mix.from_file(dict(SHAPES["uniform"], prompt_len=bad))
