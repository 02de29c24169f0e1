"""The port's single-dispatch serving round against the JAX reference's,
on the CPU in float32.

The round's device helpers (the Eq. 4 EMA update, the Eq. 5 budget grids,
device PLD, the tree seed and the greedy tree walk) are held against the
reference's jnp functions; one ``chain_round`` and one ``tree_round`` call
against the reference's on the same state; and the port's single-mode
``BatchedSpecServer`` against the reference's, round by round, dense and
paged, with its streams held to AR. A round must read nothing on the host
(a dispatch mode refuses the ops that would) and must update every carried
tensor in place (a captured CUDA graph reads the tensors it was captured
with). On the CPU the round runs eagerly; the card's CUDA graph is held to
the eager round by ``test_torch_on_card.py``.

Shapes follow ``tests/test_torch_server.py``: three layers, ``max_len``
128, pages of 16. The drafter keeps every layer, with a cheap cost prior,
so that drafts are accepted and the Eq. 5 budgets move. Tolerances: EMA
state 1e-6 (float32, sums of at most 20 terms), caches 1e-5 (float32
decodes of three layers); integer outputs, tokens, budgets and contexts
are exact.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core import acceptance as jacc  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core.dsia import DraftSpec as JDraftSpec  # noqa: E402
from repro.core.pld import propose_device as j_propose  # noqa: E402
from repro.core.tree import tree_seed_device as j_tree_seed  # noqa: E402
from repro.core.verify import greedy_accept_tree_batched as j_walk  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import SpecEngine, acceptance, engine, latency  # noqa: E402
from repro_torch.core.dsia import DraftSpec  # noqa: E402
from repro_torch.core.pld import PromptLookup, propose_device  # noqa: E402
from repro_torch.core.tree import tree_seed_device  # noqa: E402
from repro_torch.core.verify import greedy_accept_tree_device  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402
from torch_inputs import NoHostRead  # noqa: E402

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=3)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=3)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
# a drafter that keeps every layer at a cheap cost prior: its drafts are
# accepted, so trees grow, estimators move and budgets change
SPEC_KW = dict(name="self_draft", gates=(1, 1, 1), prior_alpha=0.6, prior_c=0.2)
SPEC, J_SPEC = DraftSpec(**SPEC_KW), JDraftSpec(**SPEC_KW)
MAX_LEN, PAGE, ROUNDS, N_AR = 128, 16, 6, 48
_rng = np.random.default_rng(3)
# slot 0 repeats a motif (PLD finds n-grams), slot 1 is random
PROMPTS = [np.tile(_rng.integers(2, CFG.vocab_size, size=5), 3).astype(np.int32),
           _rng.integers(2, CFG.vocab_size, size=19).astype(np.int32)]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _kwargs(paged, **kw):
    out = dict(max_batch=2, max_len=MAX_LEN, draft_k=4, tree_expansions=3, adaptive=True,
               min_obs=1, round_mode="single")
    if paged:
        out.update(paged=True, page_size=PAGE)
    out.update(kw)
    return out


def _port(mode, paged, **kw):
    return BatchedSpecServer(CFG, PARAMS, mode=mode, draft_spec=SPEC, device="cpu",
                             **_kwargs(paged, **kw))


def _budget(srv, mode, slot):
    return srv._slot_tree_budget(slot) if mode == "tree_fused" else srv._slot_limit(slot)


# ------------------------------------------------------------------ helpers
def test_ema_update_matches_reference():
    rng = np.random.default_rng(0)
    B, W = 5, 20
    j_state = jacc.ema_init(B, W, prior=0.4)
    state = acceptance.ema_init(B, W, prior=0.4)
    j_update = jax.jit(jacc.ema_update)
    for _ in range(45):                        # past the window: the ring wraps
        outcome = rng.integers(0, 2, B).astype(np.float32)
        valid = rng.random(B) < 0.7
        j_state = j_update(*j_state, jnp.asarray(outcome), jnp.asarray(valid))
        state = acceptance.ema_update(*state, torch.from_numpy(outcome), torch.from_numpy(valid))
        for got, want in zip(state, j_state):
            _close(got.numpy(), np.asarray(want), 1e-6)
        np.testing.assert_array_equal(state[2].numpy(), np.asarray(j_state[2]))
        np.testing.assert_array_equal(state[3].numpy(), np.asarray(j_state[3]))


def test_batched_budgets_and_tree_seed_match_reference():
    rng = np.random.default_rng(1)
    alpha = rng.random(64).astype(np.float32)
    alpha[:4] = [0.0, 1.0, 0.5, 0.999]
    for k in (1, 4, 5):
        j_chain = jax.jit(lambda a, c, k=k: jlat.best_chain_length_batched(a, c, k, 1.05))
        j_tree = jax.jit(lambda a, c, k=k: jlat.best_tree_expansions_batched(a, c, k, 1.05))
        for c in (0.05, 0.2, 0.5, 1.0):
            ct, cj = torch.tensor(c, dtype=torch.float32), jnp.float32(c)
            np.testing.assert_array_equal(
                latency.best_chain_length_batched(torch.from_numpy(alpha), ct, k, 1.05).numpy(),
                np.asarray(j_chain(jnp.asarray(alpha), cj)))
            np.testing.assert_array_equal(
                latency.best_tree_expansions_batched(torch.from_numpy(alpha), ct, k, 1.05).numpy(),
                np.asarray(j_tree(jnp.asarray(alpha), cj)))
    B, K, N = 5, 4, 16
    pending = rng.integers(0, 50, B).astype(np.int32)
    chains = rng.integers(0, 50, (B, K)).astype(np.int32)
    have = np.arange(B, dtype=np.int32)
    got = tree_seed_device(*(torch.from_numpy(a) for a in (pending, chains, have)), N, 0.3)
    want = j_tree_seed(*(jnp.asarray(a) for a in (pending, chains, have)), N, 0.3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _pld_batch(ctxs, k, L=64):
    buf = np.zeros((len(ctxs), L), np.int32)
    length = np.array([len(c) for c in ctxs], np.int32)
    for b, c in enumerate(ctxs):
        buf[b, : len(c)] = c
    got = propose_device(torch.from_numpy(buf), torch.from_numpy(length), k)
    want = jax.jit(j_propose, static_argnums=2)(jnp.asarray(buf), jnp.asarray(length), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


def test_device_pld_matches_reference_and_host():
    rng = np.random.default_rng(2)
    pld = PromptLookup(max_ngram=4)
    for vocab in (3, 5, 50):
        ctxs = [rng.integers(0, vocab, size=int(rng.integers(2, 60))) for _ in range(32)]
        chains, have = _pld_batch(ctxs, 5)
        for b, ctx in enumerate(ctxs):
            want = pld.propose(ctx, 5)
            assert list(chains[b, : have[b]]) == list(want)
    # the reference's edge lengths (tests/test_pld_device.py)
    edges = [[1], [1, 1], [1, 2], [2, 2, 2], [1, 2, 3, 1, 2, 3], [4, 5, 4, 5], [9] * 12,
             list(range(8)) + list(range(8))]
    chains, have = _pld_batch(edges, 4)
    for b, ctx in enumerate(edges):
        assert list(chains[b, : have[b]]) == list(pld.propose(np.asarray(ctx), 4))


def test_device_tree_walk_matches_reference():
    rng = np.random.default_rng(7)
    B, N = 6, 16
    walk = jax.jit(j_walk)
    for _ in range(10):
        tokens = rng.integers(0, 4, (B, N)).astype(np.int32)
        parents = np.array([[-1] + [int(rng.integers(0, j)) for j in range(1, N)]
                            for _ in range(B)], np.int32)
        count = rng.integers(1, N + 1, B).astype(np.int32)
        nxt = rng.integers(0, 4, (B, N)).astype(np.int32)
        arrays = (tokens, parents, count, nxt)
        got = greedy_accept_tree_device(*(torch.from_numpy(a) for a in arrays))
        want = walk(*(jnp.asarray(a) for a in arrays))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ rounds
def _round_state():
    """A prefilled dense B=2 cache and a carried state in which slot 0 has
    warmed up (its budget comes from alpha) and slot 1 has not."""
    cache = JM.init_cache(J_CFG, 2, MAX_LEN)
    ctx = np.zeros((2, MAX_LEN), np.int32)
    pending = np.zeros(2, np.int32)
    for b, p in enumerate(PROMPTS):
        c1 = JM.init_cache(J_CFG, 1, 32)
        last, c1 = JM.prefill(J_CFG, J_PARAMS, {"tokens": jnp.asarray(p[None])}, c1)
        cache = JM.write_slot(J_CFG, cache, c1, jnp.asarray(b, jnp.int32))
        ctx[b, : len(p)] = p
        pending[b] = int(np.argmax(np.asarray(last)[0]))
    state = dict(pending=pending, live=np.array([True, True]), ctx=ctx,
                 alpha=np.array([0.9, 0.6], np.float32),
                 hist=np.zeros((2, 20), np.float32), hist_n=np.array([3, 0], np.int32),
                 hist_ptr=np.array([3, 0], np.int32))
    state["hist"][0, :3] = 1.0
    return cache, state


@pytest.mark.parametrize("mode", ["chain_fused", "tree_fused"])
def test_one_round_matches_reference(mode):
    _one_round_matches_reference(mode, sampled=False)


@pytest.mark.parametrize("mode", ["chain_fused", "tree_fused"])
def test_one_sampled_round_matches_reference(mode):
    """``sampled=True``: slot 0 at T 0.8 / top-k 20 / top-p 0.9, slot 1 at
    temperature 0, both keys split in the round; the same tokens, state and
    advanced keys as the reference's round."""
    new = _one_round_matches_reference(mode, sampled=True)
    assert not torch.equal(new["key"], torch.from_numpy(_SAMPLED_STATE["key"]))


_SAMPLED_STATE = dict(temp=np.array([0.8, 0.0], np.float32), topk=np.array([20, 0], np.int32),
                      topp=np.array([0.9, 1.0], np.float32),
                      key=np.asarray(jax.random.split(jax.random.PRNGKey(5), 2)).astype(np.int64))


def _one_round_matches_reference(mode, sampled):
    j_cache, state = _round_state()
    cache = bridge.cache_from_jax(jax.tree.map(np.asarray, j_cache), device="cpu")
    if sampled:
        state.update(_SAMPLED_STATE)
    t_state = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    j_in = {k: jnp.asarray(v.astype(np.uint32) if k == "key" else v) for k, v in state.items()}
    c = 0.2
    kw = dict(draft_k=4, use_draft=True, adaptive=True, min_obs=1, t_min=1.05)
    if sampled:
        kw.update(sampled=True)
    if mode == "tree_fused":
        kw.update(expansions=3, top_k=2, top_p=0.3, bucket=16, pld_alpha=0.3)
        j_round, round_fn = jeng.tree_round, engine.tree_round
    else:
        j_round, round_fn = jeng.chain_round, engine.chain_round
    j_round = jax.jit(functools.partial(j_round, J_CFG, draft_kv="recompute", **kw))
    j_cache, j_state, j_out = j_round(J_PARAMS, j_cache, j_in, jnp.float32(c), jnp.ones(3))
    new, out = round_fn(CFG, PARAMS, cache, t_state, torch.tensor(c), layer_ids=[0, 1, 2], **kw)
    assert bool(out["ran"])
    if sampled:
        np.testing.assert_array_equal(new["key"].numpy(), np.asarray(j_state["key"]))
    for k in ("acc", "n_acc", "drafted", "pld_have", "budget"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(j_out[k]), err_msg=k)
    assert int(out["n_acc"].max()) > 1                 # drafts were accepted
    for k in ("pending", "ctx", "hist_n", "hist_ptr"):
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(j_state[k]), err_msg=k)
    for k in ("alpha", "hist"):
        _close(new[k].numpy(), np.asarray(j_state[k]), 1e-6)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(j_cache["pos"]))
    for n in ("k", "v"):
        _close(cache["segments"][0][0][n].numpy(), np.asarray(j_cache["segments"][0][0][n]), 1e-5)
    return new


# ------------------------------------------------------------------ servers
@pytest.fixture(scope="module")
def ar_streams():
    out = []
    for p in PROMPTS:
        eng = SpecEngine(CFG, PARAMS, max_len=MAX_LEN, device="cpu")
        eng.start(p)
        out.append(eng.generate_ar(N_AR))
    return out


def _drive(srv, rounds):
    for i, p in enumerate(PROMPTS):
        srv.add_request(i, p)
    gen = {i: [] for i in range(len(PROMPTS))}
    per_round = []
    for _ in range(rounds):
        out = srv.step()
        per_round.append(out)
        for b, t in out.items():
            gen[b].extend(t)
    for b, t in srv.flush().items():
        gen[b].extend(t)
    return gen, per_round


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["tree_fused", "chain_fused"])
def test_single_server_matches_reference(ar_streams, mode, paged):
    """Round by round: the same tokens per slot, Eq. 4 state and budget
    mirrors; after draining, ctx[:pos] is prompt + stream, and every stream
    is AR."""
    ref = JServer(J_CFG, J_PARAMS, mode=mode, draft_spec=J_SPEC, draft_kv="recompute",
                  telemetry=False, **_kwargs(paged))
    port = _port(mode, paged)
    assert port.round_mode == ref.round_mode == "single"
    for i, p in enumerate(PROMPTS):
        ref.add_request(i, p)
        port.add_request(i, p)
    gen = {i: [] for i in range(len(PROMPTS))}
    budgets = []
    for r in range(ROUNDS):
        out = port.step()
        assert out == ref.step(), f"round {r}"
        for b, t in out.items():
            gen[b].extend(t)
        np.testing.assert_array_equal(port.dstate["hist_n"].numpy(),
                                      np.asarray(ref.dstate["hist_n"]), err_msg=f"round {r}")
        _close(port.dstate["alpha"].numpy(), np.asarray(ref.dstate["alpha"]), 1e-6)
        budgets.append([_budget(port, mode, b) for b in range(2)])
        assert budgets[-1] == [_budget(ref, mode, b) for b in range(2)], f"round {r}"
    assert port.flush() == ref.flush() == {}
    assert any(b > 0 for row in budgets for b in row)
    assert sum(len(t) for t in gen.values()) > 2 * ROUNDS      # drafts were accepted
    ctx, pos = port.dstate["ctx"].numpy(), port.cache["pos"].numpy()
    for b, p in enumerate(PROMPTS):
        assert gen[b] == ar_streams[b][: len(gen[b])], f"slot {b} left the AR stream"
        assert pos[b] == len(p) + len(gen[b])
        assert list(ctx[b, : pos[b]]) == list(p) + gen[b]
    assert port.stats["draft_dispatches"] == 0
    assert port.stats["steps"] == port.stats["round_dispatches"] == ROUNDS


def test_routing_stops_drafting_on_the_device():
    """An unmeetable t_min drives every budget to 0 once a slot has
    observed an outcome: the draft runs in the first round only."""
    srv = _port("chain_fused", False, t_min=1e9)
    gen, _ = _drive(srv, 3)
    assert [srv._slot_limit(b) for b in range(2)] == [0, 0]
    assert srv.stats["draft_rounds"] == 1
    assert all(len(t) >= 3 for t in gen.values())


def test_one_dispatch_and_sync_every_counts_match_reference():
    """8 rounds at sync_every=4: one dispatch per round, two host syncs (the
    reference's test_one_dispatch_zero_syncs_per_steady_round), and the
    same tokens as the reference."""
    kw = _kwargs(False, sync_every=4)
    ref = JServer(J_CFG, J_PARAMS, mode="chain_fused", draft_spec=J_SPEC,
                  draft_kv="recompute", telemetry=False, **kw)
    port = BatchedSpecServer(CFG, PARAMS, mode="chain_fused", draft_spec=SPEC, device="cpu",
                             **kw)
    j_gen, j_rounds = _drive(ref, 8)
    gen, rounds = _drive(port, 8)
    assert gen == j_gen and rounds == j_rounds
    assert [bool(r) for r in rounds] == [False, False, False, True] * 2
    for key in ("round_dispatches", "target_calls", "draft_dispatches", "host_syncs", "tokens",
                "steps"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["round_dispatches"] == 8 and port.stats["host_syncs"] == 2


def test_auto_round_mode_is_single_and_split_still_runs():
    for mode in ("chain_fused", "tree_fused"):
        srv = BatchedSpecServer(CFG, PARAMS, mode=mode, draft_spec=SPEC, device="cpu",
                                max_batch=2, max_len=MAX_LEN)
        assert srv.round_mode == "single"
    split = _port("chain_fused", False, round_mode="split")
    assert split.round_mode == "split"
    gen, _ = _drive(split, 3)
    assert all(len(t) >= 3 for t in gen.values())


# ------------------------------------------- no host read, nothing rebound
def _carried(srv):
    leaves = []
    M.tree_map(leaves.append, srv.cache)
    return leaves + list(srv.dstate.values()) + [srv._ring, srv._ring_at]


@pytest.mark.parametrize("mode", ["tree_fused", "chain_fused"])
def test_round_reads_nothing_on_the_host_and_rebinds_nothing(mode):
    srv = _port(mode, True, sync_every=4)
    for i, p in enumerate(PROMPTS):
        srv.add_request(i, p)
    before = [(t, t.data_ptr()) for t in _carried(srv)]
    with NoHostRead():
        for _ in range(3):                     # steps before the drain: the round only
            assert srv.step() == {}
    assert srv.stats["draft_rounds"] == 0      # no drain yet: nothing was read
    srv.flush()
    srv.release(1)
    srv.add_request(1, PROMPTS[1])
    srv.step()
    after = _carried(srv)
    assert len(after) == len(before)
    for (t0, ptr), t1 in zip(before, after):
        assert t1 is t0 and t1.data_ptr() == ptr
