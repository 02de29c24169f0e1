"""The port's sampled-serving core against the JAX reference, on the CPU.

``core/prng.py`` is held bitwise against ``jax.random`` (``PRNGKey``,
batched ``split``, ``fold_in``, ``uniform`` and the rounds'
``round_uniforms``); ``serving/sampler.py``'s ``warp_probs`` equals the
reference's exactly; ``verify.sampling_probs`` is within 1e-6 (abs) of the
reference's with the same support, on per-slot parameters that include a
greedy slot, ties at the k-th value and a top-p cut exactly on a
cumulative boundary; the stochastic chain and tree walks equal the
reference's and the port's host oracles exactly on the same q and
uniforms (chain, star and mixed trees of 4 and 7 nodes), and with one-hot
q they are the greedy walks; ``cascade_rescore(sampling=...)`` and the
sampled ``cascade_rescore_verify`` give the reference's trees, paths and
keys. The first-token marginal smoke checks (20 000 trials, total
variation < 0.05) run here; their 200 000-trial versions carry the
``stat`` marker, which tier-1 deselects.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core import dsia as jdsia  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import verify as jverify  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import dsia, engine, prng, verify  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import DraftBank, sampler  # noqa: E402
from torch_inputs import warp_cases  # noqa: E402


def _j_keys(keys):
    return np.asarray(keys).astype(np.int64)


# ------------------------------------------------------------------ PRNG
@pytest.mark.parametrize("seed", [0, 7, 11, 2**31 - 1])
def test_prng_key_split_fold_in_uniform_bitwise(seed):
    key = prng.prng_key(seed)
    j_key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _j_keys(j_key))
    keys = prng.split(key, 5)                                    # (5, 2)
    j_keys = jax.random.split(j_key, 5)
    np.testing.assert_array_equal(keys.numpy(), _j_keys(j_keys))
    for n in (2, 3):
        np.testing.assert_array_equal(
            prng.split(keys, n).numpy(),
            _j_keys(jax.vmap(lambda k, n=n: jax.random.split(k, n))(j_keys)))
    for d in range(6):
        np.testing.assert_array_equal(prng.fold_in(key, d).numpy(),
                                      _j_keys(jax.random.fold_in(j_key, d)))
    for n in (1, 5, 33):
        got = prng.uniform(keys, n).numpy()
        want = np.asarray(jax.vmap(lambda k, n=n: jax.random.uniform(k, (n,)))(j_keys))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert prng.uniform(key, 1).numpy()[0] == np.asarray(jax.random.uniform(j_key))
    for n in (1, 6):
        new, u = verify.round_uniforms(keys, n)
        j_new, j_u = jverify.round_uniforms(j_keys, n)
        np.testing.assert_array_equal(new.numpy(), _j_keys(j_new))
        np.testing.assert_array_equal(u.numpy().view(np.int32), np.asarray(j_u).view(np.int32))


# ------------------------------------------------------------------ warp
def test_warp_probs_equals_reference():
    logits, temp, top_k, top_p = warp_cases()
    for b in range(len(temp)):
        for row in logits[b]:
            np.testing.assert_array_equal(
                sampler.warp_probs(row, float(temp[b]), int(top_k[b]), float(top_p[b])),
                jsampler.warp_probs(row, float(temp[b]), int(top_k[b]), float(top_p[b])))
    rng = np.random.default_rng(1)
    assert sampler.sample_token(logits[3, 0], temperature=0.8, rng=rng) == jsampler.sample_token(
        logits[3, 0], temperature=0.8, rng=np.random.default_rng(1))


def test_sampling_probs_matches_reference():
    logits, temp, top_k, top_p = warp_cases()
    got = verify.sampling_probs(*map(torch.from_numpy, (logits, temp, top_k, top_p))).numpy()
    want = np.asarray(jverify.sampling_probs(*map(jnp.asarray, (logits, temp, top_k, top_p))))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got > 0, want > 0)                 # the same support
    assert ((got[0] > 0).sum(-1) == 1).all()                         # greedy: one-hot
    np.testing.assert_array_equal(np.flatnonzero(got[1, 0] > 0), [0, 1, 2])   # lowest tied
    np.testing.assert_array_equal(np.flatnonzero(got[2, 0] > 0), np.arange(16))   # cut at 16/64
    two_d = verify.sampling_probs(*map(torch.from_numpy, (logits[:, 1], temp, top_k, top_p)))
    torch.testing.assert_close(two_d, torch.from_numpy(got[:, 1]), atol=0, rtol=0)


# ------------------------------------------------------------------ walks
V = 16


def _warped(g, sharp=1.0):
    return sampler.warp_probs(g.normal(size=V) * sharp, temperature=1.0, top_k=12,
                              top_p=0.97).astype(np.float32)


def test_chain_walk_matches_reference_and_host_oracle():
    g = np.random.default_rng(5)
    B, K = 64, 4
    q = np.stack([np.stack([_warped(g, 2.0) for _ in range(K + 1)]) for _ in range(B)])
    # drafted tokens: the target's head tokens mostly, a random one at times
    chains = np.where(g.random((B, K)) < 0.8, np.argsort(-q[:, :K], -1)[..., 0],
                      g.integers(0, V, (B, K))).astype(np.int32)
    have = g.integers(0, K + 1, B).astype(np.int32)
    u = g.random((B, K + 1)).astype(np.float32)
    got = verify.sample_accept_chain_batched(*map(torch.from_numpy, (chains, have, q, u[:, :K],
                                                                      u[:, K])))
    want = jverify.sample_accept_chain_batched(*map(jnp.asarray, (chains, have, q, u[:, :K],
                                                                  u[:, K])))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < (got[0].numpy() > 0).sum() < B                  # accepts and rejections both
    for b in range(B):
        assert verify.sample_accept_chain_host(chains[b], have[b], q[b], u[b, :K], u[b, K]) == (
            got[0][b], got[1][b])
    # one-hot q: the greedy verify's rule
    nxt = np.argmax(q, -1).astype(np.int32)
    onehot = np.eye(V, dtype=np.float32)[nxt]
    n_chain, tok = verify.sample_accept_chain_batched(
        *map(torch.from_numpy, (chains, have, onehot, u[:, :K], u[:, K])))
    ok = (chains == nxt[:, :K]) & (np.arange(K)[None] < have[:, None])
    want_n = np.cumprod(ok, 1).sum(1)
    np.testing.assert_array_equal(n_chain.numpy(), want_n)
    np.testing.assert_array_equal(tok.numpy(), nxt[np.arange(B), want_n])


def test_spec_sample_chain_matches_reference():
    """Leviathan's rule with explicit draft distributions: the same draws
    from the same numpy generator."""
    g = np.random.default_rng(6)
    for trial in range(40):
        k = int(g.integers(1, 5))
        draft = np.stack([_warped(g) for _ in range(k)]).astype(np.float64)
        target = np.stack([_warped(g) for _ in range(k + 1)]).astype(np.float64)
        tokens = np.array([g.choice(V, p=d / d.sum()) for d in draft])
        assert verify.spec_sample_chain(tokens, draft, target, np.random.default_rng(trial)) == \
            jverify.spec_sample_chain(tokens, draft, target, np.random.default_rng(trial))


TREES = {
    "chain4": [-1, 0, 1, 2],
    "star4": [-1, 0, 0, 0],
    "chain7": [-1, 0, 1, 2, 3, 4, 5],
    "star7": [-1, 0, 0, 0, 0, 0, 0],
    "mixed7": [-1, 0, 0, 1, 1, 3, 2],
}


@pytest.mark.parametrize("shape", sorted(TREES))
def test_tree_walk_matches_reference_and_host_oracle(shape):
    parents1 = np.array(TREES[shape], np.int32)
    N = len(parents1)
    g = np.random.default_rng(N + len(shape))
    B = 48
    q = np.stack([np.stack([_warped(g, 1.0 + 0.2 * i) for i in range(N)]) for _ in range(B)])
    tokens = np.zeros((B, N), np.int32)
    for b in range(B):
        for p in np.unique(parents1[1:]):
            kids = np.flatnonzero(parents1 == p)
            tokens[b, kids] = np.argsort(-q[b, p])[: len(kids)]     # distinct siblings
        if b % 4 == 3:                                               # an off-head sibling set
            tokens[b, 1:] = g.permutation(V)[: N - 1]
    parents = np.broadcast_to(parents1, (B, N)).copy()
    count = np.where(np.arange(B) % 5 == 4, max(N - 2, 1), N).astype(np.int32)
    u = g.random((B, N)).astype(np.float32)
    got = verify.sample_accept_tree_batched(*map(torch.from_numpy, (tokens, parents, count, q, u)))
    want = jverify.sample_accept_tree_batched(*map(jnp.asarray, (tokens, parents, count, q, u)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    path, n_acc, nxt = (a.numpy() for a in got)
    assert n_acc.max() >= 2
    for b in range(B):
        h_path, h_n, h_nxt = verify.sample_accept_tree_host(tokens[b], parents[b], count[b], q[b],
                                                            u[b])
        assert (h_path, h_n, h_nxt) == (list(path[b, :n_acc[b]]), n_acc[b], nxt[b])
    # one-hot q: the greedy walk
    am = np.argmax(q, -1).astype(np.int32)
    onehot = np.eye(V, dtype=np.float32)[am]
    got1 = verify.sample_accept_tree_batched(*map(torch.from_numpy, (tokens, parents, count,
                                                                      onehot, u)))
    greedy = verify.greedy_accept_tree_device(*map(torch.from_numpy, (tokens, parents, count, am)))
    for a, b in zip(got1, greedy):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ rescore
L = 4
J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=L)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=L)


@pytest.fixture(scope="module")
def rescore_case():
    """A prefilled cache of four slots, the mixing bank's LS0.4 level on
    both sides, seeded trees (slot 0 a full bucket, slot 1 not routed, slot
    3 the root alone) and per-slot sampling parameters with a greedy slot."""
    j_params = JM.init_params(J_CFG, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, j_params), device="cpu")
    B, N = 4, 16
    rng = np.random.default_rng(5)
    prompts = rng.integers(4, CFG.vocab_size - 1, size=(B, 10)).astype(np.int32)
    j_cache = JM.init_cache(J_CFG, B, 128)
    last, j_cache = JM.prefill(J_CFG, j_params, {"tokens": jnp.asarray(prompts)}, j_cache)
    cache = bridge.cache_from_jax(jax.tree.map(np.asarray, j_cache), device="cpu")
    count = np.array([N, 11, 7, 1], np.int32)
    tokens = rng.integers(2, CFG.vocab_size, size=(B, N)).astype(np.int32)
    tokens[:, 0] = np.asarray(jnp.argmax(last, -1))
    parents = np.full((B, N), -1, np.int32)
    depth = np.zeros((B, N), np.int32)
    mask = np.broadcast_to(np.eye(N, dtype=bool), (B, N, N)).copy()
    for b in range(B):
        for j in range(1, count[b]):
            p = int(rng.integers(max(0, j - 3), j))
            parents[b, j], depth[b, j] = p, depth[b, p] + 1
            mask[b, j] |= mask[b, p]
    p_acc = np.where(parents >= 0, 0.9 ** depth, 1.0).astype(np.float32)
    trees = (tokens, parents, depth, p_acc, mask, count, np.array([1, 2, 3, -1], np.int32),
             np.array([True, False, True, True]), np.array([0.8, 0.7, 0.6, 0.9], np.float32))
    samp = (np.array([0.8, 1.0, 0.0, 1.2], np.float32), np.array([20, 0, 0, 8], np.int32),
            np.array([0.9, 0.95, 1.0, 1.0], np.float32))
    hier = dsia.build_hierarchy(CFG, "mixing")
    lvl = DraftBank(CFG, params, hier, int8_exec="sim").levels[0]
    j_hier = jdsia.build_hierarchy(J_CFG, "mixing")
    from repro.serving.draft_bank import DraftBank as JDraftBank

    jl = JDraftBank(J_CFG, j_params, j_hier, int8_exec="sim").levels[0]
    return dict(params=params, j_params=j_params, cache=cache, j_cache=j_cache, trees=trees,
                samp=samp, lvl=lvl, jl=jl, N=N)


def _assert_same(got, want, names):
    for name, g, w in zip(names, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        if name == "p_acc":
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0, err_msg=name)
        elif name == "key":
            np.testing.assert_array_equal(g, _j_keys(w), err_msg=name)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


TREE_OUT = ("tokens", "parents", "depth", "p_acc", "mask", "count", "level_node", "probe_ok",
            "probe_valid")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stochastic_cascade_rescore_matches_reference(rescore_case, seed):
    c = rescore_case
    lvl, jl, N = c["lvl"], c["jl"], c["N"]
    u = np.random.default_rng(seed).random((4, N + 2)).astype(np.float32)
    got = engine.cascade_rescore(
        CFG, lvl.params, c["cache"], *map(torch.from_numpy, c["trees"]), lvl.exec_gates,
        layer_ids=lvl.layer_ids, sampling=tuple(map(torch.from_numpy, c["samp"] + (u,))))
    want = jeng.cascade_rescore(
        J_CFG, jl.params, c["j_cache"], *map(jnp.asarray, c["trees"]), jnp.asarray(jl.gates),
        sampling=tuple(map(jnp.asarray, c["samp"] + (u,))))
    _assert_same(got, want, TREE_OUT)
    assert got[5].numpy()[2] > c["trees"][5][2]                     # the routed slot grew
    np.testing.assert_array_equal(got[0].numpy()[1], c["trees"][0][1])   # not routed


def test_sampled_cascade_rescore_verify_matches_reference(rescore_case):
    c = rescore_case
    lvl, jl = c["lvl"], c["jl"]
    live = np.array([True, True, False, True])
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(9), 4))
    cache = M.tree_map(lambda a: a.clone(), c["cache"])
    got = engine.cascade_rescore_verify(
        CFG, lvl.params, c["params"], cache, *map(torch.from_numpy, c["trees"]), lvl.exec_gates,
        torch.from_numpy(live), layer_ids=lvl.layer_ids,
        sampling=tuple(map(torch.from_numpy, c["samp"] + (keys.astype(np.int64),))))
    want = jeng.cascade_rescore_verify(
        J_CFG, jl.params, c["j_params"], c["j_cache"], *map(jnp.asarray, c["trees"]),
        jnp.asarray(jl.gates), jnp.asarray(live), sampling=tuple(map(jnp.asarray,
                                                                     c["samp"] + (keys,))))
    assert len(got) == len(want) == 14
    _assert_same(got[:9] + got[10:], want[:9] + want[10:], TREE_OUT + ("path", "n_acc", "bonus",
                                                                       "key"))
    np.testing.assert_array_equal(got[9]["pos"].numpy(), np.asarray(want[9]["pos"]))
    np.testing.assert_allclose(got[9]["segments"][0][0]["k"].numpy(),
                               np.asarray(want[9]["segments"][0][0]["k"]), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ marginals
def _tv(emp, target):
    return 0.5 * float(np.abs(emp - target).sum())


def _chain_marginal(trials, q, d_tok, seed):
    """First-token marginal of the chain rule with a point-mass draft at
    ``d_tok``: equal to q in law."""
    _, u = verify.round_uniforms(prng.split(prng.prng_key(seed), trials), 2)
    qb = torch.from_numpy(np.stack([q, q]))[None].expand(trials, 2, V)
    n, nxt = verify.sample_accept_chain_batched(torch.full((trials, 1), d_tok),
                                                torch.ones(trials, dtype=torch.int32), qb,
                                                u[:, :1], u[:, 1])
    tok = np.where(n.numpy() >= 1, d_tok, nxt.numpy())
    return np.bincount(tok, minlength=V) / trials


def _tree_marginal(trials, tokens, parents, q, seed):
    """First-token marginal of the stochastic tree walk: the root row of q."""
    N = len(tokens)
    _, u = verify.round_uniforms(prng.split(prng.prng_key(seed), trials), N)
    path, n_acc, nxt = verify.sample_accept_tree_batched(
        torch.from_numpy(tokens)[None].expand(trials, N),
        torch.from_numpy(parents)[None].expand(trials, N), torch.full((trials,), N),
        torch.from_numpy(q)[None].expand(trials, N, V), u)
    path, n_acc, nxt = path.numpy(), n_acc.numpy(), nxt.numpy()
    first = np.where(n_acc >= 2, tokens[path[:, 1]], nxt)
    return np.bincount(first, minlength=V) / trials


def _chain_case(seed):
    g = np.random.default_rng(seed)
    q = _warped(g)
    return q, int(np.argsort(-q)[g.integers(0, 3)])


def _tree_case(shape, seed):
    g = np.random.default_rng(seed)
    q = np.stack([_warped(g, sharp=1.0 + 0.2 * i) for i in range(6)])
    parents = np.array([-1, 0, 0, 1, 1, 3] if shape == "tree" else [-1, 0, 0, 0, 1, 1])
    tokens = np.zeros(6, np.int64)
    for p in np.unique(parents):
        kids = np.flatnonzero(parents == p)
        tokens[kids] = np.argsort(-q[max(p, 0)])[: len(kids)]
    return tokens.astype(np.int32), parents.astype(np.int32), q


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_marginal_smoke(seed):
    q, d_tok = _chain_case(seed)
    assert _tv(_chain_marginal(20_000, q, d_tok, 100 + seed), q) < 0.05


@pytest.mark.parametrize("shape", ["tree", "cascade"])
def test_tree_marginal_smoke(shape):
    tokens, parents, q = _tree_case(shape, seed=2)
    assert _tv(_tree_marginal(20_000, tokens, parents, q, 200), q[0]) < 0.05


@pytest.mark.stat
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_marginal_full(seed):
    q, d_tok = _chain_case(seed)
    assert _tv(_chain_marginal(200_000, q, d_tok, 300 + seed), q) < 0.02


@pytest.mark.stat
@pytest.mark.parametrize("shape", ["tree", "cascade"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_marginal_full(shape, seed):
    tokens, parents, q = _tree_case(shape, seed=seed)
    assert _tv(_tree_marginal(200_000, tokens, parents, q, 400 + seed), q[0]) < 0.02
