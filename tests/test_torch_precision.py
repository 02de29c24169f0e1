"""The arithmetic the tensor-core attention kernels rely on, on the CPU.

``csrc/attn_common.cuh`` computes both attention products with TF32
tensor-core instructions (10-bit mantissa operands, float32 sum). These
tests emulate its operand splits with torch on the CPU — TF32 rounding
(round to nearest, ties away, as ``cvt.rna.tf32.f32``) by mantissa
masking — and pin why each split is there, at the main path's head dim 128
over a 2048-slot cache plus a 32-node tree, against float64 attention:

- float32 operands: S = Q K^T and O = P V each as hi.hi + hi.lo + lo.hi
  (3xTF32), P split into TF32 hi + lo;
- bfloat16 operands are exact in TF32, so Q K^T is one pass and P V is
  P_hi.V + P_lo.V;
- one rounding of P to bfloat16 would cost more than the kernels' 1e-4
  tolerance, and scores from a single TF32 pass more than 1e-6.

Every product of two TF32 numbers is exact in float32, so a float32
matmul of the parts emulates the tensor core's products and float32 sums.
The plain twin ``ref.ref_verify_attention`` (float32) is held to the same
float64 attention.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ref  # noqa: E402

HD, S, T, ROWS = 128, 2048, 32, 32
ATOL = 1e-6


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), nearest with ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _bf16_split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from TF32 parts: hi.hi + hi.lo + lo.hi, float32 sums."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _inputs(dtype, seed=0):
    """One (batch, kv-head) of a verify: 32 query rows over a 2048-slot
    cache (all visible) and a 32-node tree (ancestor mask, one branch)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype).float()  # noqa: E731
    q, k, v = f(ROWS, HD), f(S + T, HD), f(S + T, HD)
    tm = torch.tril(torch.ones(T, T, dtype=torch.bool))
    tm[5:, 4] = False
    vis = torch.cat([torch.ones(ROWS, S, dtype=torch.bool), tm], dim=1)
    return q, k, v, vis


def _attend(q, k, v, vis, scores, pv):
    """Online-softmax attention with the kernels' masking (-1e30), from the
    given score and P.V products; normalised output (ROWS, HD)."""
    s = scores(q, k) * HD ** -0.5
    s = torch.where(vis, s, torch.full_like(s, ref.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return pv(p, v) / p.sum(-1, keepdim=True)


def _exact(q, k, v, vis):
    q, k, v = q.double(), k.double(), v.double()
    return _attend(q, k, v, vis, lambda a, b: a @ b.T, lambda p, b: p @ b)


def _err(got, want) -> float:
    return float((got.double() - want).abs().max())


def _ref_verify(q, k, v, vis):
    """The plain twin on the same data, in its (B, KV, R, hd) layout."""
    tmask = vis[:T, S:][None]
    x = lambda a: a[None, None]  # noqa: E731
    kv_pos = torch.arange(S, dtype=torch.int32)[None]
    q_pos = torch.full((1, ROWS), S, dtype=torch.int32)
    return ref.ref_verify_attention(x(q), x(k[:S]), x(v[:S]), kv_pos, q_pos, x(k[S:]),
                                    x(v[S:]), tmask)[0, 0]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11)])
    np.testing.assert_array_equal(_tf32(x).numpy(),
                                  [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)])
    hi, lo = _split(torch.tensor([np.pi], dtype=torch.float32))
    assert float(hi + lo) == pytest.approx(np.pi, rel=2 ** -21)


def test_split_tf32_float32_matches_float64():
    q, k, v, vis = _inputs(torch.float32)
    want = _exact(q, k, v, vis)
    got = _attend(q, k, v, vis, lambda a, b: _mm3(a, b.T), lambda p, b: _mm3(p, b))
    assert _err(got, want) <= ATOL
    assert _err(_ref_verify(q, k, v, vis), want) <= ATOL


def test_bfloat16_operands_take_one_score_pass():
    q, k, v, vis = _inputs(torch.bfloat16, seed=1)
    for x in (q, k, v):
        assert torch.equal(_tf32(x), x)                   # bfloat16 is exact in TF32
    want = _exact(q, k, v, vis)

    def pv(p, b):
        ph, pl = _split(p)
        return pl @ b + ph @ b

    got = _attend(q, k, v, vis, lambda a, b: a @ b.T, pv)
    assert _err(got, want) <= ATOL


def test_unsplit_operands_miss_the_tolerance():
    """Why the splits are there: a single bfloat16 rounding of P fails the
    kernels' 1e-4; a single TF32 pass for the scores costs more than 1e-6."""
    q, k, v, vis = _inputs(torch.float32, seed=2)
    want = _exact(q, k, v, vis)
    p_bf16 = _attend(q, k, v, vis, lambda a, b: _mm3(a, b.T),
                     lambda p, b: p.to(torch.bfloat16).float() @ b)
    assert _err(p_bf16, want) > 1e-4
    one_pass = _attend(q, k, v, vis, lambda a, b: _tf32(a) @ _tf32(b).T, lambda p, b: _mm3(p, b))
    assert _err(one_pass, want) > ATOL
    hi_lo = _attend(q, k, v, vis, lambda a, b: _mm3(a, b.T),
                    lambda p, b: sum(x @ b for x in _bf16_split(p)))
    assert _err(hi_lo, want) <= 1e-5                     # bfloat16 hi + lo would do, less well
