"""The port's kernel layer against the JAX reference's oracles, on the CPU.

On a CPU tensor each wrapper computes its plain PyTorch version, which is
what these tests hold against the reference (``repro.kernels.ref`` and the
Pallas kernels in interpret mode). The hand-written CUDA kernels are held
against the same plain versions by ``test_torch_on_card.py`` and
``chip_smoke.py``, on the card.

Tolerances: attention partials and outputs are float32 on both sides and
differ by summation order only (atol 1e-5); the int8 quantizers are
bit-equal; the exact W8A8 product equals the reference oracle bit for bit
and the Pallas kernel's per-tile float32 accumulation to float32 rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_decode import flash_decode_partial as j_flash_decode_partial  # noqa: E402
from repro.kernels.int8_matmul import quantize_cols as j_qcols  # noqa: E402
from repro.kernels.int8_matmul import quantize_rows as j_qrows  # noqa: E402
from repro.kernels.tree_attention import tree_attention_partial as j_tree_partial  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import graph_cond  # noqa: E402
from repro_torch.kernels import int8_matmul as i8  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from torch_inputs import attention_inputs as _inputs  # noqa: E402
from torch_inputs import close  # noqa: E402
from torch_inputs import tensors as _t  # noqa: E402

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    close(got, want, atol)


@pytest.mark.parametrize("kind", ["causal", "window", "streaming"])
@pytest.mark.parametrize("B,KV,rep,T,S,hd", [
    (1, 2, 1, 1, 64, 32),       # MHA, T=1 (AR decode)
    (2, 2, 2, 8, 100, 64),      # GQA, ragged S
])
def test_flash_decode_partial_plain_matches_pallas(kind, B, KV, rep, T, S, hd):
    q, k, v, kv_pos, q_pos, *_ = _inputs(B, KV, rep, T, S, hd, pos=S - 7)
    kw = dict(kind=kind, window=24, sink=3)
    want = j_flash_decode_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(kv_pos), jnp.asarray(q_pos), block_s=S,
                                  interpret=True, **kw)
    got = fd.flash_decode_partial(*_t(q, k, v, kv_pos, q_pos), **kw)
    for g, w in zip(got, want):
        _close(g, w, atol=ATOL * 10 if g.ndim == 3 else ATOL)
    # the fully masked row keeps the reference's finite partials
    assert float(got[1][0, 0, 0]) == float(np.float32(ref.NEG_INF)) and float(got[2][0, 0, 0]) == S


@pytest.mark.parametrize("T,rep", [(8, 1), (16, 2)])
def test_tree_attention_partial_plain_matches_pallas(T, rep):
    q, _, _, _, _, kn, vn, tmask = _inputs(2, 2, rep, T, 8, 64, pos=0)
    tmask[1, 2] = False                                  # a fully masked tree row
    want = j_tree_partial(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                          jnp.asarray(tmask), interpret=True)
    got = ta.tree_attention_partial(*_t(q, kn, vn, tmask))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("kind", ["causal", "streaming"])
@pytest.mark.parametrize("B,T,H,KV,hd,S", [(2, 8, 4, 2, 64, 100), (1, 16, 4, 4, 32, 64)])
def test_verify_attention_matches_reference(kind, B, T, H, KV, hd, S):
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kc, vc, kn, vn = f(B, T, H, hd), f(B, S, KV, hd), f(B, S, KV, hd), f(B, T, KV, hd), f(B, T, KV, hd)
    pos = np.array([S - 9, 0][:B])                       # batch 1: empty cache, fully masked pass
    slots = np.arange(S)[None]
    kv_pos = np.where(slots < pos[:, None], slots, -1).astype(np.int32)
    q_pos = (pos[:, None] + np.arange(T)[None]).astype(np.int32)
    tm = np.tril(np.ones((T, T), bool))
    tm[3, 1] = False
    tmask = np.broadcast_to(tm, (B, T, T)).copy()
    args = (q, kc, vc, kv_pos, q_pos, kn, vn, tmask)
    kw = dict(kind=kind, window=20, sink=2)
    want = jops.verify_attention(*map(jnp.asarray, args), interpret=True, **kw)
    got = ops.verify_attention(*_t(*args), **kw)
    assert got.shape == (B, T, H, hd) and got.dtype == torch.float32
    _close(got, want)


def test_ref_verify_attention_matches_jax_oracle():
    q, k, v, kv_pos, q_pos, kn, vn, tmask = _inputs(2, 2, 2, 8, 40, 32, pos=33)
    args = (q, k, v, kv_pos, q_pos, kn, vn, tmask)
    want = jref.ref_verify_attention(*map(jnp.asarray, args), kind="window", window=16)
    got = ref.ref_verify_attention(*_t(*args), kind="window", window=16)
    _close(got, want)


@pytest.mark.parametrize("shape", [(5, 100), (64, 33), (1, 7)])
def test_quantize_rows_cols_bit_equal(shape):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, :] = 0.0                                        # an all-zero row: scale floor 1e-8
    if shape[0] > 2:
        # amax 127 makes row 1's and column 0's scale 1.0: exact round-half ties
        x[1, :4] = [127.0, 2.5, -3.5, 0.5]
        x[2, 0] = 4.5
    for fn_t, fn_j in ((i8.quantize_rows, j_qrows), (i8.quantize_cols, j_qcols)):
        q_t, s_t = fn_t(torch.from_numpy(x))
        q_j, s_j = fn_j(jnp.asarray(x))
        assert q_t.dtype == torch.int8 and tuple(s_t.shape) == s_j.shape
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_int8_matmul_plain_matches_oracles():
    rng = np.random.default_rng(3)
    M, K, N = 16, 256, 128
    x_q = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w_q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xs = rng.random((M, 1)).astype(np.float32) / 127
    ws = rng.random((1, N)).astype(np.float32) / 127
    got = i8.int8_matmul(*_t(x_q, w_q, xs, ws)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.ref_int8_matmul(*map(jnp.asarray, (x_q, w_q, xs, ws)))))
    from repro.kernels.int8_matmul import int8_matmul as j_int8_matmul
    pallas = np.asarray(j_int8_matmul(*map(jnp.asarray, (x_q, w_q, xs, ws)), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M", [1, 4, 6, 20, 64])      # chain and tree draft steps, verifies
def test_quantized_matmul_matches_pallas(M):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((M, 200)).astype(np.float32)     # ragged K and N: padded
    w = rng.standard_normal((200, 72)).astype(np.float32)
    want = np.asarray(jops.quantized_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = ops.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


DECODE_ROWS = [1, 4, 8, 16, 17, 20, 32, 40, 64, 96, 128]


@pytest.mark.parametrize("K,N", [(4096, 11008), (11008, 4096), (256, 192)])
def test_int8_plan_covers_k_and_fills_the_card(K, N):
    """The W8A8 launch plan on a 132-SM H100 whose CTA slots hold clusters
    perfectly packed: the smallest row tile that covers M, K ranges that
    take every K tile exactly once, one cluster per (row tile, strip) within
    one wave, and at the MLP shapes at least two CTAs per SM."""
    sms, k_tiles = 132, K // i8.TILE_K
    clusters = lambda bm, splits: i8.CTAS_PER_SM * sms // splits  # noqa: E731
    for M in DECODE_ROWS:
        bm, splits = i8.plan(M, K, N, clusters)
        assert bm == min([b for b in i8.ROW_TILES if b >= M] or [max(i8.ROW_TILES)])
        assert 1 <= splits <= min(i8.MAX_SPLITS, k_tiles)
        ranges = [i8.k_range(s, splits, k_tiles) for s in range(splits)]
        covered = [kt for lo, hi in ranges for kt in range(lo, hi)]
        assert covered == list(range(k_tiles))
        assert all(hi - lo >= min(i8.MIN_SPLIT_TILES, k_tiles) for lo, hi in ranges)
        items = -(-M // bm) * -(-N // i8.STRIP)
        assert items <= clusters(bm, splits)
        if K >= 4096:
            assert 2 * sms <= items * splits <= i8.CTAS_PER_SM * sms, (M, items * splits)
    # gate/up: 64 K tiles in 4 ranges; down: 172 in 12 ranges of 14-15
    assert i8.plan(32, 4096, 11008, clusters) == (32, 4)
    assert i8.plan(32, 11008, 4096, clusters) == (32, 12)
    # a card that holds fewer clusters gets fewer splits, down to none
    assert i8.plan(32, 4096, 11008, lambda bm, s: 86 if s <= 3 else 80) == (32, 3)
    assert i8.plan(32, 4096, 11008, lambda bm, s: 0) == (32, 1)


def test_int8_matmul_refuses_what_the_kernel_cannot_take():
    ok = (torch.zeros(4, 128, dtype=torch.int8), torch.zeros(128, 64, dtype=torch.int8),
          torch.ones(4, 1), torch.ones(1, 64))
    i8.int8_matmul(*ok)
    with pytest.raises(ValueError, match="multiples"):
        i8.int8_matmul(ok[0][:, :100].contiguous(), ok[1][:100], ok[2], ok[3])
    with pytest.raises(ValueError, match="at most"):
        K = i8.MAX_K + i8.TILE_K - i8.MAX_K % i8.TILE_K
        i8.int8_matmul(torch.zeros(1, K, dtype=torch.int8), torch.zeros(K, 64, dtype=torch.int8),
                       torch.ones(1, 1), ok[3])
    with pytest.raises(TypeError):
        i8.int8_matmul(ok[0].float(), *ok[1:])


def test_tree_attention_refuses_a_malformed_carried_segment():
    q, k, v, kv_pos, q_pos, kn, vn, tmask = _t(*_inputs(1, 2, 1, 4, 8, 32, pos=5))
    ks = vs = torch.zeros(1, 2, 6, 32)
    smask = torch.ones(1, 4, 6, dtype=torch.bool)
    ta.tree_attention_partial(q, kn, vn, tmask, k_staged=ks, v_staged=vs, staged_mask=smask)
    with pytest.raises(ValueError, match="together"):
        ta.tree_attention_partial(q, kn, vn, tmask, k_staged=ks, v_staged=vs)
    with pytest.raises(ValueError, match="do not match"):
        ta.tree_attention_partial(q, kn, vn, tmask, k_staged=ks, v_staged=vs,
                                  staged_mask=smask[:, :, :5].contiguous())
    with pytest.raises(TypeError):
        ta.tree_attention_partial(q, kn, vn, tmask, k_staged=ks.double(), v_staged=vs.double(),
                                  staged_mask=smask)


def test_cond_segments_run_a_gated_segment_only_when_its_predicate_holds():
    """The plain version of a conditional graph reads each predicate when
    its step is reached; the assembly takes one-element bool or int32 CUDA
    predicates only (the graphs run on the card)."""
    x, mid = torch.zeros(3), {}
    steps = [("child", lambda: mid.update(p=x.sum() > 0)),
             ("if", lambda: mid["p"], lambda: x.add_(1)),
             ("child", lambda: x.mul_(2))]
    ref.cond_segments(steps)
    assert x.tolist() == [0, 0, 0]
    x.fill_(1)
    ref.cond_segments(steps)
    assert x.tolist() == [4, 4, 4]
    for bad in ([("if", torch.tensor(True), None)], [("if", torch.ones(2, dtype=torch.bool), None)],
                [("else", None)]):
        with pytest.raises(ValueError):
            graph_cond.CondGraph(bad, "cpu")
