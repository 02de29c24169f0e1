"""The port's kernel layer against the JAX reference's oracles, on the CPU.

On a CPU tensor each wrapper computes its plain PyTorch version, which is
what these tests hold against the reference (``repro.kernels.ref`` and the
Pallas kernels in interpret mode). The hand-written CUDA kernels are held
against the same plain versions by the ``cuda``-marked tests at the end and
by ``chip_smoke.py``, on the card.

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
from repro_torch.kernels import int8_matmul as i8  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402

ATOL = 1e-5


def _inputs(B, KV, rep, T, S, hd, pos, seed=0):
    """Shared numpy inputs in the kernels' (B, KV, R, hd) layout; row 0 of
    batch 0 is fully masked (q_pos = -1)."""
    rng = np.random.default_rng(seed)
    R = rep * T
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, KV, R, hd), f(B, KV, S, hd), f(B, KV, S, hd)
    kn, vn = f(B, KV, T, hd), f(B, KV, T, hd)
    slots = np.arange(S)[None].repeat(B, 0)
    kv_pos = np.where(slots < pos, slots, -1).astype(np.int32)
    q_pos = np.tile(pos + np.arange(T), (B, rep)).astype(np.int32)
    q_pos[0, 0] = -1
    tm = np.tril(np.ones((T, T), bool))
    if T >= 4:
        tm[3, 2] = False
    tmask = np.broadcast_to(tm, (B, T, T)).copy()
    return q, k, v, kv_pos, q_pos, kn, vn, tmask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


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


def test_quantized_matmul_matches_pallas():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 200)).astype(np.float32)     # ragged K and N: padded
    w = rng.standard_normal((200, 72)).astype(np.float32)
    want = np.asarray(jops.quantized_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = ops.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_match_plain_on_card(dtype):
    dev = _card()
    q, k, v, kv_pos, q_pos, kn, vn, tmask = _t(*_inputs(2, 4, 2, 8, 300, 128, pos=250))
    dt = getattr(torch, dtype)
    q, k, v, kn, vn = (a.to(dev, dt) for a in (q, k, v, kn, vn))
    kv_pos, q_pos, tmask = kv_pos.to(dev), q_pos.to(dev), tmask.to(dev)
    tree = ta.tree_attention_partial(q, kn, vn, tmask)
    for g, w in zip(tree, ref.tree_attention_partial(q, kn, vn, tmask)):
        _close(g.cpu(), w.cpu(), atol=1e-4)
    got = fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree)
    want = ref.ref_verify_attention(q, k, v, kv_pos, q_pos, kn, vn, tmask)
    _close(got.cpu(), want.cpu(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep,T,S", [
    (1, 5, 300),       # R = 5: one padded 16-row tile; S not a multiple of the 32-slot key tile
    (1, 16, 300),      # R = 16: one full row tile
    (1, 32, 2048),     # R = 32: two m16 tiles in one CTA, the main path's verify
    (8, 8, 300),       # R = 64 (GQA rep 8): two 32-row CTAs per head
])
def test_attention_kernels_at_tile_edges_on_card(dtype, rep, T, S):
    """The tensor-core kernels at the row and key tiles' edges, with a fully
    masked cache row and a fully masked tree row, against the plain twins."""
    dev = _card()
    q, k, v, kv_pos, q_pos, kn, vn, tmask = _inputs(2, 2, rep, T, S, 128, pos=S - 21, seed=6)
    tmask[1, 1] = False                                  # a fully masked tree row
    dt = getattr(torch, dtype)
    q, k, v, kn, vn = (a.to(dev, dt) for a in _t(q, k, v, kn, vn))
    kv_pos, q_pos, tmask = (a.to(dev) for a in _t(kv_pos, q_pos, tmask))
    tree = ta.tree_attention_partial(q, kn, vn, tmask)
    want_t = ref.tree_attention_partial(q, kn, vn, tmask)
    for g, w in zip(tree, want_t):
        _close(g.cpu(), w.cpu(), atol=1e-4)
    got = fd.flash_decode_partial(q, k, v, kv_pos, q_pos)
    want = ref.flash_decode_partial(q, k, v, kv_pos, q_pos)
    _close((got[0] / got[2][..., None]).cpu(), (want[0] / want[2][..., None]).cpu(), atol=1e-4)
    _close(got[1].cpu(), want[1].cpu(), atol=1e-4)
    assert float(got[2][0, 0, 0]) == S                   # the masked row averages every slot
    merged = fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree)
    _close(merged.cpu(), ref.ref_verify_attention(q, k, v, kv_pos, q_pos, kn, vn, tmask).cpu(),
           atol=1e-4)


@pytest.mark.cuda
def test_int8_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(5)
    x_q, w_q = (torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8)).to(dev)
                for s in ((40, 256), (256, 192)))
    xs = torch.rand(40, 1, device=dev)
    ws = torch.rand(1, 192, device=dev)
    torch.testing.assert_close(i8.int8_matmul(x_q, w_q, xs, ws),
                               ref.ref_int8_matmul(x_q, w_q, xs, ws), rtol=0, atol=0)
