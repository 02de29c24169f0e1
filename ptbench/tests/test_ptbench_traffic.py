"""The request table, its prompts and the arrival schedule are the mix's,
whatever the seed; the seed orders the requests within blocks; the
weights come from the configuration's ``weight_seed``."""
import numpy as np
import pytest
import torch

import _tiny  # noqa: F401  (puts ptbench/ and src/ on the path)
from ptb import spec, traffic, weights

CELLS = [(c, m) for c in (_tiny.MOE, _tiny.DENSE) for m in ("chat", "docs")]
RATE = 1.25                 # an open mix's rate, requests a second


def _rate(kind):
    return RATE if kind == "chat" else None


@pytest.mark.parametrize("config,kind", CELLS)
def test_table_is_the_same_for_every_seed(config, kind):
    mix = spec.load_json(spec.traffic_file(kind))
    a, b = traffic.table(mix, _rate(kind)), traffic.table(mix, _rate(kind))
    assert a == b and len(a) == mix["requests"]
    for s in a:
        assert mix["prompt"]["min"] <= s.prompt_len <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= s.output_len <= mix["output"]["max"]
    dues = [s.due_s for s in a]
    if kind == "chat":
        assert all(x < y for x, y in zip(dues, dues[1:]))
        # Poisson at the cell's rate: the mean gap is about 1 / rate
        assert abs(dues[-1] / len(dues) * RATE - 1.0) < 0.15
    else:
        assert all(d is None for d in dues)


@pytest.mark.parametrize("config,kind", CELLS)
def test_seed_orders_the_same_requests(config, kind):
    """Every seed serves the same requests (sizes and prompts) in the same
    places (arrival times), each block of ``shuffle_block`` in its own
    order; the same seed gives the same order."""
    cfg = spec.load_json(spec.config_file(config))
    mix = spec.load_json(spec.traffic_file(kind))
    base = traffic.table(mix, _rate(kind))
    a = traffic.served(mix, 2**31 + 11, _rate(kind))
    b = traffic.served(mix, 2**31 + 11, _rate(kind))
    c = traffic.served(mix, 12, _rate(kind))
    assert a == b and a != c
    assert [s.due_s for s in a] == [s.due_s for s in c] == [s.due_s for s in base]
    k = mix["shuffle_block"]
    for b0 in range(0, len(base), k):
        key = lambda s: (s.index, s.prompt_len, s.output_len)
        assert sorted(map(key, a[b0:b0 + k])) == sorted(map(key, base[b0:b0 + k]))
        assert sorted(map(key, c[b0:b0 + k])) == sorted(map(key, base[b0:b0 + k]))
    V = cfg["vocab_size"]
    for s in base[:5]:
        x = traffic.prompt_tokens(mix, s, V)
        assert x.dtype == np.int32 and len(x) == s.prompt_len
        assert np.array_equal(x, traffic.prompt_tokens(mix, s, V))
        assert x.min() >= 0 and x.max() < V
    # requests draw independent streams
    assert not np.array_equal(traffic.prompt_tokens(mix, base[0], V)[:8],
                              traffic.prompt_tokens(mix, base[1], V)[:8])


def test_rate_scales_the_same_gaps():
    mix = spec.load_json(spec.traffic_file("chat"))
    a = traffic.table(mix, 1.0)
    b = traffic.table(mix, 2.0)
    assert [s.prompt_len for s in a] == [s.prompt_len for s in b]
    assert np.allclose([s.due_s / 2 for s in a], [s.due_s for s in b])
    with pytest.raises(ValueError):
        traffic.table(mix)
    # each open cell names its rate in a file of its own
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert (cell.rate_per_s is not None) == (cell.traffic["kind"] == "open")


def test_lengths_follow_the_published_statistic():
    """A mix gives its source's median or mean: the median of a lognormal
    with that mean is mean / exp(sigma^2 / 2)."""
    by_median = {"median": 1000.0, "sigma": 0.5, "min": 1, "max": 10**9}
    by_mean = {"mean": 1000.0 * np.exp(0.125), "sigma": 0.5, "min": 1, "max": 10**9}
    assert traffic.log_median(by_median) == pytest.approx(traffic.log_median(by_mean))
    x = traffic._lengths(np.random.default_rng(0), by_mean, 200_000)
    assert x.mean() == pytest.approx(by_mean["mean"], rel=0.01)


@pytest.mark.parametrize("arch", [_tiny.MOE, _tiny.DENSE])
def test_weights_come_from_the_weight_seed(arch):
    cfg = _tiny.tiny_config(arch)
    a = weights.make(cfg, torch.device("cpu"), cfg["weight_seed"])
    b = weights.make(cfg, torch.device("cpu"), cfg["weight_seed"])
    c = weights.make(cfg, torch.device("cpu"), cfg["weight_seed"] + 1)
    from repro_torch.models.model import tree_leaves

    la, lb, lc = tree_leaves(a), tree_leaves(b), tree_leaves(c)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["embed"], c["embed"])
    want = sum(torch.empty(shape, dtype=getattr(torch, dt)).nbytes
               for _, shape, dt, _ in weights.leaves(cfg))
    assert sum(x.numel() * x.element_size() for x in la) == want
