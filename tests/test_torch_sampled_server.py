"""Sampled serving in the port's ``BatchedSpecServer`` against the JAX
reference's, on the CPU in float32.

The port's counterpart of ``tests/test_sampled_serving.py``, with the same
model and settings: the reduced vicuna-7b at three layers (the reference's
params carried across by ``bridge.py``), two slots, ``max_len`` 128,
``draft_k`` 4, five expansions, fixed budgets, five rounds. The port's
threefry stream is the reference's bit for bit (``core/prng.py``), so the
stochastic streams are held EQUAL to the reference server's at the same
seeds, not only equal in law, in chain_fused (single and split rounds),
tree_fused (single), legacy, cascade_fused (its int8 level simulated on
both sides) and chunked-prefill paged chain_fused. Wall-clock cost
trackers are pinned at their priors on both sides (they shape the split
rounds' trees). A sampled build at temperature 0 emits the port's greedy
build's streams in all five modes; a greedy slot beside a stochastic one is
unchanged; a greedy build refuses a stochastic request and carries no
sampling state; a sampled single round reads nothing on the host.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core import dsia as jdsia  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.sampler import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import dsia  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402
from repro_torch.serving.sampler import SamplingParams  # noqa: E402
from torch_inputs import NoHostRead  # noqa: E402

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=3)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=3)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
STOCH = dict(temperature=0.8, top_k=20, top_p=0.9, seed=7)
GREEDY0 = dict(temperature=0.0, seed=0)
ROUNDS = 5

MODES = {
    "chain_fused-single": ("chain_fused", dict(round_mode="single")),
    "chain_fused-split": ("chain_fused", dict(round_mode="split")),
    "tree_fused-single": ("tree_fused", dict(round_mode="single")),
    "legacy": ("legacy", {}),
    "cascade_fused": ("cascade_fused", dict(int8_exec="sim")),
}
CHUNKED = ("chain_fused", dict(round_mode="single", paged=True, page_size=16, prefill_chunk=8))


def _prompts():
    rng = np.random.default_rng(0)
    return [np.array([5, 6, 7, 8] * 4, np.int32),                   # PLD-friendly
            rng.integers(4, CFG.vocab_size - 1, size=20).astype(np.int32)]


def _server(mode, kw, sampling=None, ref=False):
    """The reference's ``_server`` settings, on either side; ``sampling``
    is a dict of SamplingParams fields."""
    args = dict(max_batch=2, max_len=128, draft_k=4, tree_expansions=5, adaptive=False)
    if mode != "cascade_fused":
        args["draft_spec"] = (jdsia if ref else dsia).layer_sparsity(J_CFG if ref else CFG, 0.5)
    args.update(kw)
    params_cls = JSamplingParams if ref else SamplingParams
    samp = None if sampling is None else params_cls(**sampling)
    if ref:
        srv = JServer(J_CFG, J_PARAMS, mode=mode, sampling=samp, **args)
    else:
        srv = BatchedSpecServer(CFG, PARAMS, mode=mode, sampling=samp, device="cpu", **args)
    srv.costs.observe = lambda *a, **k: None            # wall-clock trackers at their priors
    srv.costs.observe_target = lambda *a, **k: None
    return srv


def _serve(srv, per_request=None, ref=False, rounds=ROUNDS):
    params_cls = JSamplingParams if ref else SamplingParams
    prompts = _prompts()
    for i, p in enumerate(prompts):
        if per_request is None:
            srv.add_request(i, p)
        else:
            srv.add_request(i, p, sampling=params_cls(**per_request[i]))
    gen = {i: [] for i in range(len(prompts))}
    for _ in range(rounds):
        for b, toks in srv.step().items():
            gen[b].extend(toks)
    for b, toks in srv.flush().items():
        gen[b].extend(toks)
    return gen


SEEDED = [dict(STOCH, seed=11 + i) for i in range(2)]


@pytest.mark.parametrize("name", sorted(MODES))
def test_temperature_zero_equals_greedy_build(name):
    mode, kw = MODES[name]
    assert _serve(_server(mode, kw, GREEDY0)) == _serve(_server(mode, kw))


@pytest.mark.parametrize("name", sorted(MODES) + ["chunked"])
def test_stochastic_streams_equal_reference(name):
    """Per-request seeds 11 and 12 at T 0.8, top-k 20, top-p 0.9: the port's
    stream is the reference server's, token for token (and no greedy
    stream), and its stats and final keys too."""
    mode, kw = CHUNKED if name == "chunked" else MODES[name]
    port = _server(mode, kw, STOCH)
    ref = _server(mode, kw, STOCH, ref=True)
    got, want = _serve(port, SEEDED), _serve(ref, SEEDED, ref=True)
    assert got == want
    assert got != _serve(_server(mode, kw))                  # not the greedy streams
    assert all(len(t) > 0 and all(0 <= x < CFG.vocab_size for x in t) for t in got.values())
    for k in ("tokens", "target_calls", "draft_dispatches", "rescore_dispatches"):
        assert port.stats[k] == ref.stats[k], k
    np.testing.assert_array_equal(port.dstate["key"].numpy(),
                                  np.asarray(ref.dstate["key"]).astype(np.int64))


def test_unseeded_requests_follow_the_base_key():
    """Requests without a seed take ``fold_in(base, admission count)``:
    the reference's streams, and a second build gives the same ones."""
    port = _serve(_server("tree_fused", dict(round_mode="single"), STOCH),
                  [dict(STOCH, seed=None)] * 2)
    ref = _serve(_server("tree_fused", dict(round_mode="single"), STOCH, ref=True),
                 [dict(STOCH, seed=None)] * 2, ref=True)
    assert port == ref


def test_greedy_slot_beside_a_stochastic_one_is_unchanged():
    kw = dict(round_mode="single")
    greedy = _serve(_server("chain_fused", kw))
    mixed = _serve(_server("chain_fused", kw, STOCH),
                   [GREEDY0, dict(temperature=0.9, top_k=0, top_p=0.95, seed=3)])
    assert mixed[0] == greedy[0] and len(mixed[1]) > 0


def test_greedy_build_refuses_stochastic_request_and_carries_no_sampling_state():
    srv = _server("chain_fused", dict(round_mode="single"))
    assert set(srv.dstate) == {"pending", "live", "ctx", "alpha", "hist", "hist_n", "hist_ptr"}
    assert srv.sampling is None and srv._base_key is None
    with pytest.raises(ValueError, match="sampled server build"):
        srv.add_request(0, _prompts()[0], sampling=SamplingParams(**STOCH))
    srv.add_request(0, _prompts()[0], sampling=SamplingParams(**GREEDY0))
    sampled = _server("chain_fused", dict(round_mode="single"), STOCH)
    assert set(sampled.dstate) - set(srv.dstate) == {"temp", "topk", "topp", "key"}
    assert sampled.dstate["key"].dtype == torch.int64


@pytest.mark.parametrize("mode", ["tree_fused", "chain_fused"])
def test_sampled_round_reads_nothing_on_the_host(mode):
    srv = _server(mode, dict(round_mode="single", sync_every=3), STOCH)
    for i, p in enumerate(_prompts()):
        srv.add_request(i, p, sampling=SamplingParams(**SEEDED[i]))
    keys = srv.dstate["key"].clone()
    with NoHostRead():
        for _ in range(2):
            assert srv.step() == {}
    assert not torch.equal(srv.dstate["key"], keys)       # the keys advanced in the rounds
    assert srv.flush()
