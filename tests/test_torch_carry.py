"""Carried draft KV (``draft_kv="carry"``) in the port against the JAX
reference, on the CPU in float32.

The port's counterpart of ``tests/test_draft_kv_carry.py``. Attention with
a carried segment (dense and paged caches, every mask kind) is held against
the reference's ``decode_attention``; on a CPU tensor the tree kernel's
wrapper computes its plain version over [carried ++ new] keys, and the card
holds the kernel to that (``test_torch_on_card.py``). The carry branches of
both draft scans are held against the reference's carry and against the
port's own recompute: tree structures exactly, ``p_acc`` within 1e-5
(float32 softmax probabilities merged in another order). A single-round
server built with ``draft_kv="auto"`` resolves to carry, as the reference's
does, and its streams equal the reference's and AR's.

Shapes: the 4-layer reduced vicuna-7b; attention atol 1e-5 (float32).
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
from repro.core import engine as jeng  # noqa: E402
from repro.core.dsia import DraftSpec as JDraftSpec  # noqa: E402
from repro.core.tree import tree_seed_arrays as j_tree_seed  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import SpecEngine, engine  # noqa: E402
from repro_torch.core.dsia import DraftSpec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402

L = 4
J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=L)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=L)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
KEPT = [0, 2]                                   # the draft's layers (slice exec)
GATES = np.array([1.0 if i in KEPT else 0.0 for i in range(L)], np.float32)
MAX_LEN = 128


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("kind", ["causal", "window", "streaming"])
def test_decode_attention_with_carried_rows_matches_reference(kind):
    """T = 2 appended tokens over a cache, 6 carried rows (one at a
    position past the queries, one stale) and each other: the reference's
    carried pass and the port's tree-kernel segment give the same output."""
    B, T, N_s, H, KV, hd, S_c = 2, 2, 6, 4, 2, 32, 40
    window, sink = 12, 3
    q, kn, vn = _rand(B, T, H, hd), _rand(B, T, KV, hd, seed=1), _rand(B, T, KV, hd, seed=2)
    kc, vc = _rand(B, S_c, KV, hd, seed=3), _rand(B, S_c, KV, hd, seed=4)
    ks, vs = _rand(B, N_s, KV, hd, seed=5), _rand(B, N_s, KV, hd, seed=6)
    cache_pos = np.array([30, 7], np.int32)
    staged_pos = (cache_pos[:, None] + np.array([0, 1, 2, 2, 3, 9])[None]).astype(np.int32)
    q_pos = (cache_pos[:, None] + np.array([3, 4])[None]).astype(np.int32)
    smask = np.ones((B, T, N_s), bool)
    smask[:, :, 3] = False                       # a stale row
    smask[1, 1, 2] = False
    args = (q, kc, vc, cache_pos, kn, vn, q_pos)
    kw = dict(kind=kind, window=window, sink=sink)
    eye = np.broadcast_to(np.eye(T, dtype=bool), (B, T, T)).copy()
    want = jattn.decode_attention(*map(jnp.asarray, args), tree_mask=jnp.asarray(eye),
                                  k_staged=jnp.asarray(ks), v_staged=jnp.asarray(vs),
                                  staged_pos=jnp.asarray(staged_pos),
                                  staged_mask=jnp.asarray(smask), **kw)
    t = torch.from_numpy
    got = attn.decode_attention(*map(t, args), tree_mask=t(eye), k_staged=t(ks), v_staged=t(vs),
                                staged_pos=t(staged_pos), staged_mask=t(smask), **kw)
    _close(got, want)
    # the same over a block-paged pool holding the cache's rows
    P, n_pp = 8, S_c // 8
    perm = np.random.default_rng(7).permutation(B * n_pp).astype(np.int32)
    table = perm.reshape(B, n_pp)
    pools = []
    for c in (kc, vc):
        pool = np.zeros((B * n_pp, P, KV, hd), np.float32)
        pool[table.reshape(-1)] = c.reshape(B * n_pp, P, KV, hd)
        pools.append(t(pool))
    got_p = attn.paged_decode_attention(t(q), *pools, t(table), t(cache_pos), t(kn), t(vn),
                                        t(q_pos), tree_mask=t(eye), k_staged=t(ks),
                                        v_staged=t(vs), staged_pos=t(staged_pos),
                                        staged_mask=t(smask), **kw)
    _close(got_p, want)


def test_tree_partials_over_two_segments_equal_one_softmax():
    """The plain twin of the two-segment tree kernel merged with the cache
    partials is the one softmax over [cache ++ carried ++ new]."""
    B, KV, T, N_s, S, hd = 2, 2, 3, 5, 20, 16
    rng = np.random.default_rng(11)
    q, kc, vc = _rand(B, KV, T, hd), _rand(B, KV, S, hd, seed=1), _rand(B, KV, S, hd, seed=2)
    kn, vn = _rand(B, KV, T, hd, seed=3), _rand(B, KV, T, hd, seed=4)
    ks, vs = _rand(B, KV, N_s, hd, seed=5), _rand(B, KV, N_s, hd, seed=6)
    kv_pos = np.where(np.arange(S)[None] < np.array([[12], [20]]), np.arange(S)[None], -1)
    q_pos = np.array([[12, 13, 13], [20, 21, 22]], np.int32)
    tmask = np.broadcast_to(np.tril(np.ones((T, T), bool)), (B, T, T)).copy()
    smask = rng.random((B, T, N_s)) < 0.6
    smask[0, 0] = False                            # a row that sees no carried key
    tt = [torch.from_numpy(np.ascontiguousarray(a)) for a in
          (q, kc, vc, kv_pos.astype(np.int32), q_pos, kn, vn, tmask, ks, vs, smask)]
    q, kc, vc, kv_pos, q_pos, kn, vn, tmask, ks, vs, smask = tt
    tree = ref.tree_attention_partial(q, kn, vn, tmask, k_staged=ks, v_staged=vs,
                                      staged_mask=smask)
    got = ref.merge_partials(ref.flash_decode_partial(q, kc, vc, kv_pos, q_pos), tree)
    want = ref.ref_verify_attention(q, kc, vc, kv_pos, q_pos, kn, vn, tmask, k_staged=ks,
                                    v_staged=vs, staged_mask=smask)
    _close(got, want)


# ------------------------------------------------------------- draft scans
def _prefilled(B, length, seed):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(4, CFG.vocab_size - 1, size=(B, length)).astype(np.int32)
    j_cache = JM.init_cache(J_CFG, B, MAX_LEN)
    last, j_cache = JM.prefill(J_CFG, J_PARAMS, {"tokens": jnp.asarray(prompts)}, j_cache)
    cache = bridge.cache_from_jax(jax.tree.map(np.asarray, j_cache), device="cpu")
    return np.asarray(jnp.argmax(last, -1)).astype(np.int32), j_cache, cache, rng


def test_chain_carry_matches_reference_and_recompute():
    """PLD prefixes that must not be overwritten and a slot whose limit
    stops early: the same chains in carry and recompute, and as the
    reference's carry."""
    pending, j_cache, cache, rng = _prefilled(3, 12, seed=0)
    K = 4
    chains = rng.integers(4, CFG.vocab_size - 1, size=(3, K)).astype(np.int32)
    have, limit = np.array([0, 2, 4], np.int32), np.array([4, 4, 1], np.int32)
    fn = jax.jit(functools.partial(jeng.chain_draft_scan, J_CFG, K, draft_kv="carry"))
    j_ch, j_hv = fn(J_PARAMS, j_cache, *map(jnp.asarray, (pending, chains, have, limit)),
                    jnp.asarray(GATES))
    t = torch.from_numpy
    for draft_kv in ("carry", "recompute"):
        ch, hv = engine.chain_draft_scan(CFG, K, PARAMS, cache, *map(t, (pending, chains, have,
                                                                        limit)),
                                         layer_ids=KEPT, draft_kv=draft_kv)
        np.testing.assert_array_equal(ch.numpy(), np.asarray(j_ch), err_msg=draft_kv)
        np.testing.assert_array_equal(hv.numpy(), np.asarray(j_hv), err_msg=draft_kv)
    assert (np.asarray(j_ch) != chains).any()            # the draft wrote something


TREE_OUTS = ("tokens", "parents", "depth", "p_acc", "mask", "count", "first_neural")


@pytest.mark.parametrize("bucket", [8, 16])
def test_tree_carry_matches_reference_and_recompute(bucket):
    """The tree grown in carry equals the reference's carry and the port's
    recompute, at a bucket that fills up (8) and one that does not (16);
    drafting leaves pos alone."""
    pending, j_cache, cache, rng = _prefilled(3, 10, seed=bucket)
    pld = rng.integers(4, CFG.vocab_size - 1, size=(3, 4)).astype(np.int32)
    have = np.array([2, 0, 1], np.int32)
    seed = j_tree_seed(pending, pld, have, bucket)
    budget = (np.array([5, 5, 3], np.int32), np.full(3, 0.6, np.float32))
    fn = jax.jit(functools.partial(jeng.tree_draft_scan, J_CFG, 5, 2, draft_kv="carry"))
    want = fn(J_PARAMS, j_cache, *(jnp.asarray(a) for a in seed + budget),
              jnp.asarray(0.3, jnp.float32), jnp.asarray(1.0, jnp.float32), jnp.asarray(GATES))
    pos0 = cache["pos"].clone()
    t = torch.from_numpy
    outs = {}
    for draft_kv in ("carry", "recompute"):
        outs[draft_kv] = engine.tree_draft_scan(
            CFG, 5, 2, PARAMS, cache, *(t(np.ascontiguousarray(a)) for a in seed + budget),
            torch.tensor(0.3), torch.tensor(1.0), layer_ids=KEPT, draft_kv=draft_kv)
    for name, w, c, r in zip(TREE_OUTS, want, outs["carry"], outs["recompute"]):
        if name == "p_acc":
            _close(c, np.asarray(w))
            _close(c, r.numpy())
        else:
            np.testing.assert_array_equal(c.numpy(), np.asarray(w), err_msg=name)
            np.testing.assert_array_equal(c.numpy(), r.numpy(), err_msg=name)
    assert (outs["carry"][5].numpy() > have + 1).any()       # something grew
    assert torch.equal(cache["pos"], pos0)


# ------------------------------------------------------------- server
# a drafter that keeps every layer at a cheap cost prior: its drafts are
# accepted, so trees grow and the carried rows are read
SPEC_KW = dict(name="self_draft", gates=(1,) * L, prior_alpha=0.6, prior_c=0.2)
_prng = np.random.default_rng(3)
PROMPTS = [np.tile(_prng.integers(2, CFG.vocab_size, size=5), 3).astype(np.int32),
           _prng.integers(2, CFG.vocab_size, size=19).astype(np.int32)]
ROUNDS = 6


@pytest.mark.parametrize("mode,paged", [("tree_fused", False), ("chain_fused", True)],
                         ids=["tree_fused-dense", "chain_fused-paged"])
def test_auto_single_server_carries_and_matches_reference(mode, paged):
    """``draft_kv="auto"`` is carry on both sides; round by round the same
    tokens as the reference's carry server, and every stream is AR."""
    kw = dict(max_batch=2, max_len=MAX_LEN, draft_k=4, tree_expansions=3, adaptive=True,
              min_obs=1, round_mode="single")
    if paged:
        kw.update(paged=True, page_size=16)
    ref_srv = JServer(J_CFG, J_PARAMS, mode=mode, draft_spec=JDraftSpec(**SPEC_KW),
                      telemetry=False, **kw)
    port = BatchedSpecServer(CFG, PARAMS, mode=mode, draft_spec=DraftSpec(**SPEC_KW),
                             device="cpu", **kw)
    assert port.draft_kv == ref_srv.draft_kv == "carry"
    for i, p in enumerate(PROMPTS):
        ref_srv.add_request(i, p)
        port.add_request(i, p)
    gen = {i: [] for i in range(len(PROMPTS))}
    for r in range(ROUNDS):
        out = port.step()
        assert out == ref_srv.step(), f"round {r}"
        for b, toks in out.items():
            gen[b].extend(toks)
    assert port.stats["draft_rounds"] > 0
    assert sum(len(g) for g in gen.values()) > 2 * ROUNDS        # drafts were accepted
    for b, p in enumerate(PROMPTS):
        eng = SpecEngine(CFG, PARAMS, max_len=MAX_LEN, device="cpu")
        eng.start(p)
        assert gen[b] == eng.generate_ar(len(gen[b])), f"slot {b} left the AR stream"


def test_draft_kv_validation():
    with pytest.raises(ValueError, match="unknown draft_kv"):
        BatchedSpecServer(CFG, PARAMS, draft_kv="nope", device="cpu")
    with pytest.raises(ValueError, match="unknown draft_kv"):
        engine.chain_draft_scan(CFG, 2, PARAMS, {}, None, torch.zeros((1, 2), dtype=torch.int32),
                                None, None, draft_kv="nope")
    assert BatchedSpecServer(CFG, PARAMS, device="cpu").draft_kv == "carry"
    with pytest.raises(ValueError, match="staged_pos"):
        M.decode_step(CFG, PARAMS, M.init_cache(CFG, 1, 16, device="cpu"),
                      torch.zeros(1, 2, dtype=torch.int32), staged_kv=[])
