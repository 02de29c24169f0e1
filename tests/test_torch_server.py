"""The port's batched server against its own AR stream and the JAX
reference's server, on the CPU in float32.

Every stream of the port's ``BatchedSpecServer`` — ``tree_fused`` and
``chain_fused``, dense and paged — equals the port's AR stream and the JAX
reference's AR stream for its prompt (the paper's invariant, batched). With
the plan pinned (``adaptive=False`` and both servers' cost trackers held at
their priors, since they observe wall clock), a paged ``tree_fused`` run
accepts the same tokens per slot, round by round, as the reference's split
round server. Shapes follow ``tests/test_paged_serving.py``: three layers,
``max_len`` 128, pages of 16, prompts of 8 and 19 tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core.dsia import layer_sparsity as j_layer_sparsity  # noqa: E402
from repro.core.engine import SpecEngine as JEngine  # noqa: E402
from repro.core.tree import tree_seed_arrays as j_tree_seed_arrays  # noqa: E402
from repro.core.verify import greedy_accept_tree_batched as j_walk  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import SpecEngine, latency, layer_sparsity  # noqa: E402
from repro_torch.core.tree import tree_seed_arrays  # noqa: E402
from repro_torch.core.verify import greedy_accept_tree_batched  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=3)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=3)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
SPEC = layer_sparsity(CFG, 0.5)
J_SPEC = j_layer_sparsity(J_CFG, 0.5)
_rng = np.random.default_rng(3)
PROMPTS = [_rng.integers(2, CFG.vocab_size, size=n).astype(np.int32) for n in (8, 19)]
ROUNDS = 5
N_AR = 32


def _kwargs(paged, **kw):
    out = dict(max_batch=2, max_len=128, draft_k=4, tree_expansions=3, adaptive=True,
               min_obs=1, round_mode="split")
    if paged:
        out.update(paged=True, page_size=16)
    out.update(kw)
    return out


def _server(mode, paged, **kw):
    return BatchedSpecServer(CFG, PARAMS, mode=mode, draft_spec=SPEC, device="cpu",
                             **_kwargs(paged, **kw))


def _pin_costs(srv):
    srv.costs.observe = lambda *a, **k: None
    srv.costs.observe_target = lambda *a, **k: None
    return srv


def _run(srv, rounds=ROUNDS, prompts=PROMPTS):
    """Admit the prompts, step; returns (streams per slot, per-round dicts)."""
    for i, p in enumerate(prompts):
        srv.add_request(i, p)
    gen = {i: [] for i in range(len(prompts))}
    per_round = []
    for _ in range(rounds):
        out = srv.step()
        per_round.append(out)
        for b, t in out.items():
            gen[b].extend(t)
    for b, t in srv.flush().items():
        gen[b].extend(t)
    return gen, per_round


@pytest.fixture(scope="module")
def ar_streams():
    """(port AR, JAX AR) streams of N_AR tokens per prompt."""
    port, jref = [], []
    for p in PROMPTS:
        eng = SpecEngine(CFG, PARAMS, max_len=128, device="cpu")
        eng.start(p)
        port.append(eng.generate_ar(N_AR))
        jeng = JEngine(J_CFG, J_PARAMS, max_len=128)
        jeng.start(p)
        jref.append(jeng.generate_ar(N_AR))
    return port, jref


def _assert_lossless(gen, ar, rounds=ROUNDS):
    for b, stream in gen.items():
        assert len(stream) >= rounds, f"slot {b}: a round emitted no token"
        n = min(len(stream), N_AR)
        assert stream[:n] == ar[b][:n], f"slot {b} left the AR stream"


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["tree_fused", "chain_fused"])
def test_server_streams_equal_ar(ar_streams, mode, paged):
    port_ar, j_ar = ar_streams
    assert port_ar == j_ar
    srv = _server(mode, paged)
    gen, _ = _run(srv)
    _assert_lossless(gen, port_ar)
    assert srv.stats["steps"] == ROUNDS == srv.stats["target_calls"]
    assert srv.stats["tokens"] == sum(len(s) for s in gen.values())


def test_paged_tree_rounds_match_reference():
    kw = _kwargs(True, adaptive=False)
    ref = _pin_costs(JServer(J_CFG, J_PARAMS, mode="tree_fused", draft_spec=J_SPEC,
                             draft_kv="recompute", **kw))
    port = _pin_costs(BatchedSpecServer(CFG, PARAMS, mode="tree_fused", draft_spec=SPEC,
                                        device="cpu", **kw))
    j_gen, j_rounds = _run(ref)
    gen, rounds = _run(port)
    assert rounds == j_rounds
    assert gen == j_gen
    assert port.stats["draft_dispatches"] == ref.stats["draft_dispatches"] == ROUNDS
    np.testing.assert_array_equal(port.cache["page_table"].numpy(),
                                  np.asarray(ref.cache["page_table"]))
    np.testing.assert_array_equal(port.cache["pos"].numpy(), np.asarray(ref.cache["pos"]))


def test_release_and_readmission_on_reused_pages(ar_streams):
    """Released pages return to the pool; re-admitted requests land on
    reused pages in another order and reproduce their streams, round by
    round (costs pinned: the budgets must not follow the wall clock)."""
    srv = _pin_costs(_server("tree_fused", paged=True))
    first, _ = _run(srv, rounds=4)
    _assert_lossless(first, ar_streams[0], rounds=4)
    tables = srv.cache["page_table"].clone()
    for s in range(len(PROMPTS)):
        srv.release(s)
    assert len(srv._free_pages) == 2 * srv._pages_per_slot
    again, _ = _run(srv, rounds=4)
    assert not torch.equal(srv.cache["page_table"], tables)
    _assert_lossless(again, ar_streams[0], rounds=4)
    assert again == first


def test_release_shrinks_the_scanned_table(monkeypatch):
    """A released slot drops out of the live prefix: after the long request
    goes, every call bounds the paged kernel's scan (the maximum of the
    ``bound`` it reads on the device) by the short slot's length. The
    kernel always gets the whole table."""
    scans = _spy_scans(monkeypatch)
    long_prompt = np.tile(PROMPTS[1], 4)[:70]
    srv = _server("chain_fused", paged=True)
    srv.add_request(0, PROMPTS[0])
    srv.add_request(1, long_prompt)
    srv.step()
    assert set(scans) == {len(long_prompt)}
    srv.release(1)
    assert int(srv.cache["pos"][1]) == 0 and bool((srv.cache["page_table"][1] == -1).all())
    scans.clear()
    short = int(srv.cache["pos"][0])
    srv.step()
    assert scans and set(scans) == {short} and short < len(long_prompt)


def _spy_scans(monkeypatch) -> list:
    """Record the scan bound, max(bound), of every paged verify call."""
    from repro_torch.models import attention

    scans = []
    real = attention.paged_verify_attention

    def spy(q, k_pages, v_pages, page_table, *a, bound, **k):
        assert page_table.shape[1] == 128 // 16          # the whole table, always
        scans.append(int(bound.max()))
        return real(q, k_pages, v_pages, page_table, *a, bound=bound, **k)

    monkeypatch.setattr(attention, "paged_verify_attention", spy)
    return scans


def test_page_pool_budget_and_exhaustion():
    srv = _server("chain_fused", paged=True)
    full = srv._pages_per_slot
    srv.add_request(0, PROMPTS[0], max_new_tokens=4)
    assert 0 < len(srv._slot_pages[0]) < full
    srv.release(0)
    assert len(srv._free_pages) == 2 * full
    tiny = _server("chain_fused", paged=True, num_pages=1)
    with pytest.raises(RuntimeError, match="page pool"):
        tiny.add_request(0, PROMPTS[1])


UNPORTED = {
    # sampled serving is ported: what raises is a sampling that is no SamplingParams
    "sampling": (dict(sampling=object()), TypeError),
    # mesh serving is ported: what raises is a mesh that is no launch.mesh.Mesh
    "mesh": (dict(mesh=object()), TypeError),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_arguments_raise(case):
    kw = dict(mode="chain_fused", draft_spec=SPEC, device="cpu")
    extra, err = UNPORTED[case]
    kw.update(extra)
    with pytest.raises(err):
        BatchedSpecServer(CFG, PARAMS, **kw)


def test_seed_walk_and_budgets_match_reference():
    rng = np.random.default_rng(7)
    B, K, N = 3, 4, 16
    pending = rng.integers(0, 50, B)
    chains = rng.integers(0, 50, (B, K)).astype(np.int32)
    have = np.array([0, 2, 4], np.int32)
    for g, w in zip(tree_seed_arrays(pending, chains, have, N, pld_alpha=0.3),
                    j_tree_seed_arrays(pending, chains, have, N, pld_alpha=0.3)):
        np.testing.assert_array_equal(g, w)
    # random trees with duplicate siblings; argmax hits a path most of the time
    tokens = rng.integers(0, 4, (B, N)).astype(np.int32)
    parents = np.array([[-1] + [int(rng.integers(0, j)) for j in range(1, N)] for _ in range(B)],
                       np.int32)
    count = np.array([N, 9, 1], np.int32)
    nxt = rng.integers(0, 4, (B, N)).astype(np.int32)
    for g, w in zip(greedy_accept_tree_batched(tokens, parents, count, nxt),
                    j_walk(*(jax.numpy.asarray(a) for a in (tokens, parents, count, nxt)))):
        np.testing.assert_array_equal(g, np.asarray(w))
    for alpha in (0.05, 0.3, 0.6, 0.9, 0.99):
        for c in (0.05, 0.3, 0.8):
            assert latency.best_chain_length(alpha, c, 4, 1.05) == jlat.best_chain_length(alpha, c, 4, 1.05)
            assert (latency.best_tree_expansions(alpha, c, 5, 1.05)
                    == jlat.best_tree_expansions(alpha, c, 5, 1.05))
