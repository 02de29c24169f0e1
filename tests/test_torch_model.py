"""The port's model stack against the JAX reference, on the CPU.

Both packages get the same params (the reference's ``init_params`` carried
across by ``repro_torch.bridge``) and the same numpy inputs, in float32.
Tolerances: layer outputs atol 1e-5 and logits atol 1e-4 (float32 on both
sides, summation order differs); caches after a commit are bit-equal (the
same rows are copied).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=4)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=4)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
PROMPT = np.array([5, 6, 7, 8, 9, 5, 6, 7, 8, 9, 5, 6, 7], np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_config_copy_matches_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(J_CFG)
    assert dataclasses.asdict(get_config("vicuna-7b")) == dataclasses.asdict(j_get_config("vicuna-7b"))


def test_rms_norm_scales_by_one_plus_weight():
    x, w = _rand(2, 5, 64), _rand(64, seed=1)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-5)


def test_apply_rope_split_half():
    x = _rand(2, 7, 4, 32)
    pos = np.array([[0, 1, 2, 3, 50, 51, 900], [3, 4, 5, 6, 7, 8, 9]], np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    _close(got, jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-5)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_mlp_apply(quantize):
    p = {k: _rand(*s, seed=i) * 0.1 for i, (k, s) in
         enumerate({"w_up": (64, 128), "w_gate": (64, 128), "w_down": (128, 64)}.items())}
    x = _rand(3, 64, seed=9)
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                           "silu", True, quantize=quantize)
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             "silu", True, quantize=quantize)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind,ring", [
    ("causal", False), ("window", False), ("streaming", False), ("window", True),
])
def test_decode_attention(kind, ring):
    B, T, H, KV, hd = 2, 8, 4, 2, 32
    S_c, window, sink = (16, 16, 0) if ring else (48, 12, 3)
    q, kn, vn = _rand(B, T, H, hd), _rand(B, T, KV, hd, seed=1), _rand(B, T, KV, hd, seed=2)
    kc, vc = _rand(B, S_c, KV, hd, seed=3), _rand(B, S_c, KV, hd, seed=4)
    cache_pos = np.array([40, 29] if ring else [33, 5], np.int32)
    q_pos = (cache_pos[:, None] + np.array([0, 1, 1, 2, 2, 3, 4, 5])[None]).astype(np.int32)
    tm = np.eye(T, dtype=bool)
    parents = [-1, 0, 0, 1, 2, 3, 5, 6]
    for i in range(T):
        j = i
        while j != -1:
            tm[i, j] = True
            j = parents[j]
    tmask = np.broadcast_to(tm, (B, T, T)).copy()
    args = (q, kc, vc, cache_pos, kn, vn, q_pos)
    kw = dict(kind=kind, window=window, sink=sink, ring=ring)
    want = jattn.decode_attention(*map(jnp.asarray, args), tree_mask=jnp.asarray(tmask), **kw)
    got = attn.decode_attention(*map(torch.from_numpy, args), tree_mask=torch.from_numpy(tmask), **kw)
    _close(got, want, 1e-5)


def _prefilled(max_len=64):
    jc = JM.init_cache(J_CFG, 1, max_len)
    jl, jc = JM.prefill(J_CFG, J_PARAMS, {"tokens": jnp.asarray(PROMPT[None])}, jc)
    tc = M.init_cache(CFG, 1, max_len, device="cpu")
    tl, tc = M.prefill(CFG, PARAMS, {"tokens": torch.from_numpy(PROMPT[None])}, tc)
    return jl, jc, tl, tc


def test_prefill_logits_and_cache():
    jl, jc, tl, tc = _prefilled()
    _close(tl, jl, 1e-4)
    assert int(tc["pos"][0]) == int(jc["pos"][0]) == len(PROMPT)
    _close(tc["segments"][0][0]["k"], jc["segments"][0][0]["k"], 1e-5)


@pytest.mark.parametrize("variant", ["full", "gates", "slice", "int8"])
def test_decode_step_logits(variant):
    _, jc, _, tc = _prefilled()
    T = 8
    toks = np.array([[3, 4, 5, 6, 7, 8, 9, 10]], np.int32)
    tm = np.tril(np.ones((T, T), bool))
    tm[3, 2] = False
    q_pos = len(PROMPT) + np.array([0, 1, 2, 3, 3, 4, 5, 6], np.int32)
    kw_j = dict(tree_mask=jnp.asarray(tm), q_pos=jnp.asarray(q_pos))
    kw_t = dict(tree_mask=torch.from_numpy(tm), q_pos=torch.from_numpy(q_pos))
    j_cfg, j_params, j_cache = J_CFG, J_PARAMS, jc
    gates = np.array([1, 0, 1, 1], np.float32)
    if variant == "gates":
        kw_j["gates"], kw_t["gates"] = jnp.asarray(gates), gates
    elif variant == "slice":
        kept = np.flatnonzero(gates)                     # the reference's slice variant
        j_cfg = dataclasses.replace(J_CFG, num_layers=len(kept))
        j_params = dict(J_PARAMS, segments=[jax.tree.map(lambda a: a[kept], J_PARAMS["segments"][0])])
        j_cache = dict(jc, segments=[jax.tree.map(lambda a: a[kept], jc["segments"][0])])
        kw_t["layer_ids"] = [int(i) for i in kept]
    elif variant == "int8":
        kw_j["quantize"] = kw_t["quantize"] = "int8"
    jl, jst = JM.decode_step(j_cfg, j_params, j_cache, jnp.asarray(toks), **kw_j)
    tl, tst = M.decode_step(CFG, PARAMS, tc, torch.from_numpy(toks), **kw_t)
    _close(tl, jl, 1e-4)
    _close(tst[0][0]["v"], jst[0][0]["v"], 1e-5)


def test_commit_cache_partial_accept_leaves_rejected_rows():
    B, T, S = 2, 8, 32
    cfg = dataclasses.replace(CFG, num_layers=2)
    j_cfg = dataclasses.replace(J_CFG, num_layers=2)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    old = {n: _rand(2, B, S, KV, hd, seed=i) for i, n in enumerate(("k", "v"))}
    staged = {n: _rand(2, B, T, KV, hd, seed=5 + i) for i, n in enumerate(("k", "v"))}
    pos = np.array([10, 27], np.int32)
    path_idx = np.array([[0, 2, 5, 0, 0, 0, 0, 0], [0, 1, 3, 4, 6, 7, 0, 0]], np.int32)
    n_acc = np.array([3, 6], np.int32)                   # batch 1 runs past S: dropped rows
    jc = {"pos": jnp.asarray(pos), "segments": [[{n: jnp.asarray(a) for n, a in old.items()}]]}
    jst = [[{n: jnp.asarray(a) for n, a in staged.items()}]]
    want = JM.commit_cache(j_cfg, jc, jst, jnp.asarray(path_idx), jnp.asarray(n_acc))
    tc = {"pos": torch.from_numpy(pos.copy()),
          "segments": [[{n: torch.from_numpy(a.copy()) for n, a in old.items()}]]}
    tst = [[{n: torch.from_numpy(a) for n, a in staged.items()}]]
    got = M.commit_cache(cfg, tc, tst, torch.from_numpy(path_idx), torch.from_numpy(n_acc))
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    for n in ("k", "v"):
        g = got["segments"][0][0][n].numpy()
        np.testing.assert_array_equal(g, np.asarray(want["segments"][0][0][n]))
        np.testing.assert_array_equal(g[:, 0, 13:], old[n][:, 0, 13:])   # rejected rows untouched
        np.testing.assert_array_equal(g[:, 0, 10:13], staged[n][:, 0, [0, 2, 5]])


def _paged_cache():
    return M.init_cache(CFG, 1, 16, paged=True, page_size=16, device="cpu")


OFF_SLICE = {
    "decode_attention seq_axes": lambda: attn.decode_attention(
        *[torch.zeros(s) for s in ((1, 8, 4, 64), (1, 16, 4, 64), (1, 16, 4, 64))], 0,
        *[torch.zeros(s) for s in ((1, 8, 4, 64), (1, 8, 4, 64))], torch.arange(8),
        seq_axes=("data",)),
    "decode_attention k_staged": lambda: attn.decode_attention(
        *[torch.zeros(s) for s in ((1, 8, 4, 64), (1, 16, 4, 64), (1, 16, 4, 64))], 0,
        *[torch.zeros(s) for s in ((1, 8, 4, 64), (1, 8, 4, 64))], torch.arange(8),
        k_staged=torch.zeros(1, 4, 4, 64)),
    "decode_step staged_kv": lambda: M.decode_step(
        CFG, PARAMS, M.init_cache(CFG, 1, 16, device="cpu"), torch.zeros(1, 8, dtype=torch.int32),
        staged_kv=[]),
    "decode_step seq_axes": lambda: M.decode_step(
        CFG, PARAMS, M.init_cache(CFG, 1, 16, device="cpu"), torch.zeros(1, 8, dtype=torch.int32),
        seq_axes=("data",)),
    # a paged cache refuses carried staged KV as the dense one does
    "decode_step paged": lambda: M.decode_step(
        CFG, PARAMS, _paged_cache(), torch.zeros(1, 8, dtype=torch.int32), staged_kv=[]),
    "init_params mamba": lambda: M.init_params(
        dataclasses.replace(CFG, attention_pattern="none"), device="cpu"),
    "init_cache hybrid": lambda: M.init_cache(
        dataclasses.replace(CFG, attn_layer_period=2), 1, 16, device="cpu"),
}


@pytest.mark.parametrize("case", sorted(OFF_SLICE))
def test_off_slice_arguments_raise(case):
    with pytest.raises(NotImplementedError):
        OFF_SLICE[case]()


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_cache(CFG, 1, 16)


def test_bridge_keeps_layout_and_dtype():
    flat_j = jax.tree_util.tree_leaves_with_path(J_PARAMS)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(PARAMS))
    bf16 = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu",
                                  dtype=torch.bfloat16)
    assert bf16["segments"][0][0]["attn"]["wq"].dtype == torch.bfloat16
    assert tuple(PARAMS["segments"][0][0]["mlp"]["w_up"].shape) == J_PARAMS["segments"][0][0]["mlp"]["w_up"].shape
    jc = jax.tree.map(np.asarray, JM.init_cache(J_CFG, 2, 16))
    tc = bridge.cache_from_jax(jc, device="cpu")
    assert tc["pos"].dtype == torch.int32 and tuple(tc["segments"][0][0]["k"].shape) == jc["segments"][0][0]["k"].shape


def test_fake_quant_int8_matches_reference():
    from repro.core.engine import fake_quant_int8 as j_fake_quant_int8
    from repro_torch.core.engine import fake_quant_int8

    got = fake_quant_int8(PARAMS)
    want = j_fake_quant_int8(J_PARAMS)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
