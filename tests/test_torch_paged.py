"""The port's block-paged KV cache against the JAX reference, on the CPU.

On a CPU tensor the paged flash-decode wrapper computes its plain version
(gather the pool through the page table, then the dense plain partials),
which these tests hold against the reference's Pallas kernel in interpret
mode and, bit for bit, against the port's dense plain version on the
gathered view. The model path (``decode_step``, ``write_slot``,
``commit_cache``) on a paged cache is held against the JAX functions on the
same paged cache, carried across by ``bridge.cache_from_jax``. The CUDA
kernel is held against the plain version by the ``cuda``-marked test at the
end and by ``chip_smoke.py``, on the card.

Tolerances: partials and verify outputs are float32 on both sides and
differ by summation order only (atol 1e-5); logits atol 1e-4 (float32,
three layers); pools and positions after a write are exact (the same rows
are copied).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_decode import flash_decode_paged_partial as j_paged_partial  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ATOL = 1e-5
J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=3)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=3)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
MAX_LEN, PAGE = 128, 16
_rng = np.random.default_rng(3)
PROMPTS = [_rng.integers(2, CFG.vocab_size, size=n).astype(np.int32) for n in (8, 19)]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _paged_inputs(B=2, KV=2, rep=2, T=4, hd=64, P=PAGE, n_pp=4, seed=0):
    """Kernel inputs over a scrambled page table: slot 0 owns n_pp pages,
    slot 1 three pages and a -1 tail, both end in a partial tail page; the
    first query row of slot 0 sees no slot. Pools are in the model's
    (NP, P, KV, hd) layout."""
    rng = np.random.default_rng(seed)
    R, S, NP = rep * T, n_pp * P, B * n_pp + 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    perm = rng.permutation(NP)
    table = np.full((B, n_pp), -1, np.int32)
    table[0] = perm[:n_pp]
    table[1, :3] = perm[n_pp:n_pp + 3]
    pos = np.array([S - 7, 2 * P + 5])[:, None]
    slots = np.arange(S)[None].repeat(B, 0)
    kv_pos = np.where(slots < pos, slots, -1).astype(np.int32)
    q_pos = np.tile(pos + np.arange(T), (1, rep)).astype(np.int32)
    q_pos[0, 0] = -1
    tm = np.tril(np.ones((T, T), bool))
    tm[3, 2] = False
    return dict(q=f(B, KV, R, hd), k_pages=f(NP, P, KV, hd), v_pages=f(NP, P, KV, hd),
                table=table, kv_pos=kv_pos, q_pos=q_pos, k_new=f(B, KV, T, hd),
                v_new=f(B, KV, T, hd), tmask=np.broadcast_to(tm, (B, T, T)).copy())


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pallas_pool(pool):
    return jnp.asarray(np.ascontiguousarray(pool.transpose(0, 2, 1, 3)))   # (NP, KV, P, hd)


KINDS = [("causal", 0, 0), ("window", 24, 0), ("streaming", 16, 4)]


@pytest.mark.parametrize("kind,window,sink", KINDS)
def test_paged_partial_plain_matches_pallas(kind, window, sink):
    x = _paged_inputs()
    kw = dict(kind=kind, window=window, sink=sink)
    got = fd.flash_decode_paged_partial(_t(x["q"]), _t(x["k_pages"]), _t(x["v_pages"]),
                                        _t(x["table"]), _t(x["kv_pos"]), _t(x["q_pos"]), **kw)
    want = j_paged_partial(jnp.asarray(x["q"]), _pallas_pool(x["k_pages"]),
                           _pallas_pool(x["v_pages"]), jnp.asarray(x["table"]),
                           jnp.asarray(x["kv_pos"]), jnp.asarray(x["q_pos"]), interpret=True, **kw)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind,window,sink", KINDS)
def test_paged_partial_bitwise_dense_on_gathered_view(kind, window, sink):
    x = _paged_inputs(seed=1)
    q, kp, vp, table, kv_pos, q_pos = (_t(x[n]) for n in ("q", "k_pages", "v_pages", "table",
                                                         "kv_pos", "q_pos"))
    kw = dict(kind=kind, window=window, sink=sink)
    got = fd.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos, **kw)
    k, v = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
    want = fd.flash_decode_partial(q, k, v, kv_pos, q_pos, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # unallocated and partial-tail slots are masked: poisoning them is inert
    poisoned = kp.clone()
    free = np.setdiff1d(np.arange(kp.shape[0]), x["table"][x["table"] >= 0])
    poisoned[torch.as_tensor(free)] = 1e4
    again = fd.flash_decode_paged_partial(q, poisoned, vp, table, kv_pos, q_pos, **kw)
    for g, w in zip(again[:2], got[:2]):
        _close(g[1].numpy(), w[1].numpy())                # slot 1 reads no free page


def test_paged_verify_attention_matches_reference():
    x = _paged_inputs(B=2, KV=2, rep=2, T=8, seed=2)
    B, KV, R, hd = x["q"].shape
    T = R // 2
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, T, 2 * KV, hd)).astype(np.float32)   # (B, T, H, hd)
    kn, vn = (rng.standard_normal((B, T, KV, hd)).astype(np.float32) for _ in range(2))
    q_pos = x["q_pos"][:, :T].copy()
    q_pos[0, 0] = x["q_pos"][0, 1] - 1
    tm = np.broadcast_to(np.tril(np.ones((T, T), bool)), (B, T, T)).copy()
    tm[:, 5, 3] = False
    got = ops.paged_verify_attention(_t(q), _t(x["k_pages"]), _t(x["v_pages"]), _t(x["table"]),
                                     _t(x["kv_pos"]), _t(q_pos), _t(kn), _t(vn), _t(tm))
    want = jops.paged_verify_attention(jnp.asarray(q), jnp.asarray(x["k_pages"]),
                                       jnp.asarray(x["v_pages"]), jnp.asarray(x["table"]),
                                       jnp.asarray(x["kv_pos"]), jnp.asarray(q_pos),
                                       jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tm),
                                       interpret=True)
    _close(got.numpy(), np.asarray(want))
    oracle = ref.ref_paged_verify_attention(
        _t(x["q"]), _t(x["k_pages"]), _t(x["v_pages"]), _t(x["table"]), _t(x["kv_pos"]),
        _t(x["q_pos"]), _t(x["k_new"]), _t(x["v_new"]), _t(x["tmask"]))
    merged = fd.flash_decode_paged_merge(
        _t(x["q"]), _t(x["k_pages"]), _t(x["v_pages"]), _t(x["table"]), _t(x["kv_pos"]),
        _t(x["q_pos"]), ref.tree_attention_partial(_t(x["q"]), _t(x["k_new"]), _t(x["v_new"]),
                                                   _t(x["tmask"])))
    _close(merged.numpy(), oracle.numpy())


# -------------------------------------------------------------- model path
@pytest.fixture(scope="module")
def prefilled():
    """JAX dense B=1 caches of both prompts, prefilled at a 32-slot bucket."""
    out = []
    for p in PROMPTS:
        c1 = JM.init_cache(J_CFG, 1, 32)
        _, c1 = JM.prefill(J_CFG, J_PARAMS, {"tokens": jnp.asarray(p[None])}, c1)
        out.append(c1)
    return out


def _j_paged_state(prefilled):
    """A JAX paged cache after admitting both prompts onto scrambled pages;
    slot 1 holds two pages (32 positions) and then -1, slot 0 owns page 0."""
    cache = JM.init_cache(J_CFG, 2, MAX_LEN, paged=True, page_size=PAGE)
    rows = np.full((2, MAX_LEN // PAGE), -1, np.int32)
    rows[0, :4] = [9, 0, 14, 5]
    rows[1, :2] = [2, 11]
    cache["page_table"] = jnp.asarray(rows)
    for b, c1 in enumerate(prefilled):
        cache = JM.write_slot(J_CFG, cache, c1, b)
    return cache


def _to_port(cache):
    return bridge.cache_from_jax(jax.tree.map(np.asarray, cache), device="cpu")


def test_paged_decode_step_matches_reference(prefilled):
    jc = _j_paged_state(prefilled)
    tc = _to_port(jc)
    rng = np.random.default_rng(5)
    T = 8
    toks = rng.integers(0, CFG.vocab_size, size=(2, T)).astype(np.int32)
    tm = np.tril(np.ones((T, T), bool))
    tm[4:, 3] = False
    depth = np.broadcast_to(np.arange(T), (2, T)).astype(np.int32)
    want, _ = JM.decode_step(J_CFG, J_PARAMS, jc, jnp.asarray(toks), tree_mask=jnp.asarray(tm),
                             q_pos=jc["pos"][:, None] + jnp.asarray(depth))
    got, _ = M.decode_step(CFG, PARAMS, tc, torch.as_tensor(toks), tree_mask=torch.as_tensor(tm),
                           q_pos=tc["pos"][:, None] + torch.as_tensor(depth))
    _close(got.numpy(), np.asarray(want), atol=1e-4)
    # the same state in a dense cache gives the same logits
    dense = M.init_cache(CFG, 2, MAX_LEN, device="cpu")
    for si, seg in enumerate(dense["segments"]):
        for u, c in enumerate(seg):
            for n in ("k", "v"):
                for r, pool in enumerate(tc["segments"][si][u][n + "_pages"]):
                    c[n][r] = ref.paged_gather(pool, tc["page_table"])
    dense["pos"] = tc["pos"].clone()
    gd, _ = M.decode_step(CFG, PARAMS, dense, torch.as_tensor(toks),
                          tree_mask=torch.as_tensor(tm),
                          q_pos=dense["pos"][:, None] + torch.as_tensor(depth))
    _close(gd.numpy(), got.numpy(), atol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
def test_write_slot_and_commit_match_reference(prefilled, paged):
    if paged:
        jc = _j_paged_state(prefilled)
        tc = M.init_cache(CFG, 2, MAX_LEN, paged=True, page_size=PAGE, device="cpu")
        tc["page_table"] = torch.as_tensor(np.array(jc["page_table"]))
    else:
        jc = JM.init_cache(J_CFG, 2, MAX_LEN)
        tc = M.init_cache(CFG, 2, MAX_LEN, device="cpu")
    for b, c1 in enumerate(prefilled):
        if not paged:
            jc = JM.write_slot(J_CFG, jc, c1, b)
        tc = M.write_slot(CFG, tc, _to_port(c1), b)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    rng = np.random.default_rng(6)
    T = 16
    KV, hd = CFG.num_kv_heads, CFG.resolved_head_dim()
    staged = [[{n: rng.standard_normal((CFG.num_layers, 2, T, KV, hd)).astype(np.float32)
                for n in ("k", "v")}]]
    path = np.zeros((2, T), np.int32)
    path[0, :5] = [0, 2, 3, 7, 8]
    path[1, :16] = np.arange(16)
    # slot 1 (pos 19) runs past its last allocated page (32 positions): the
    # rows there are dropped, never written through a clamped -1 to page 0
    n_acc = np.array([5, 16], np.int32) if paged else np.array([5, 3], np.int32)
    jc = JM.commit_cache(J_CFG, jc, jax.tree.map(jnp.asarray, staged), jnp.asarray(path),
                         jnp.asarray(n_acc))
    tc = M.commit_cache(CFG, tc, jax.tree.map(torch.as_tensor, staged), torch.as_tensor(path),
                        torch.as_tensor(n_acc))
    want = jax.tree.map(np.asarray, jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), want["pos"])
    names = ("k_pages", "v_pages") if paged else ("k", "v")
    for n in names:
        np.testing.assert_array_equal(tc["segments"][0][0][n].numpy(), want["segments"][0][0][n])
    if paged:
        np.testing.assert_array_equal(tc["page_table"].numpy(), want["page_table"])


def test_init_cache_paged_layout_matches_reference():
    want = JM.init_cache(J_CFG, 3, MAX_LEN, paged=True, page_size=PAGE, num_pages=11)
    got = M.init_cache(CFG, 3, MAX_LEN, paged=True, page_size=PAGE, num_pages=11, device="cpu")
    assert tuple(got["segments"][0][0]["k_pages"].shape) == want["segments"][0][0]["k_pages"].shape
    np.testing.assert_array_equal(got["page_table"].numpy(), np.asarray(want["page_table"]))
    assert M.pages_for(MAX_LEN, 48) == JM.pages_for(MAX_LEN, 48)
    with pytest.raises(ValueError):
        M.init_cache(CFG, 1, MAX_LEN, paged=True, page_size=48, device="cpu")
    with pytest.raises(ValueError):
        M.init_cache(CFG, 1, MAX_LEN, paged=True, page_size=PAGE, ring_window=True, device="cpu")
    with pytest.raises(NotImplementedError):
        M.prefill(CFG, PARAMS, {"tokens": torch.zeros(1, 4, dtype=torch.int32)}, got)


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    x = _paged_inputs(B=2, KV=4, rep=1, T=32, hd=128, P=16, n_pp=6)
    dt = getattr(torch, dtype)
    q, kp, vp = (_t(x[n]).to("cuda", dt) for n in ("q", "k_pages", "v_pages"))
    table, kv_pos, q_pos = (_t(x[n]).cuda() for n in ("table", "kv_pos", "q_pos"))
    got = fd.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos)
    want = ref.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos)
    for g, w in zip(got, want):
        _close((g / got[2][..., None] if g.ndim == 4 else g).cpu(),
               (w / want[2][..., None] if w.ndim == 4 else w).cpu(), atol=1e-4)
    k, v = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
    dense = fd.flash_decode_partial(q, k, v, kv_pos, q_pos)
    for g, w in zip(got, dense):
        assert torch.equal(g, w)
