"""Inputs shared by the port's kernel tests, made with numpy from a seed.

JAX-free, so that the ``cuda``-marked tests of ``test_torch_on_card.py``
can be collected on a machine without JAX; the CPU tests that hold the
same kernels against the JAX reference import it too.
"""
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select")


def attention_inputs(B, KV, rep, T, S, hd, pos, seed=0):
    """Verify-attention inputs in the kernels' (B, KV, R, hd) layout; row 0
    of batch 0 is fully masked (q_pos = -1)."""
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


def paged_inputs(B=2, KV=2, rep=2, T=4, hd=64, P=16, n_pp=4, seed=0):
    """Paged kernel inputs over a scrambled page table: slot 0 owns n_pp
    pages, slot 1 three pages and a -1 tail, both end in a partial tail
    page; the first query row of slot 0 sees no slot. Pools are in the
    model's (NP, P, KV, hd) layout."""
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


def int8_inputs(M, K, N, seed=0):
    """W8A8 operands: int8 x (M, K) and w (K, N) over the full [-127, 127]
    range, positive float32 scales (M, 1) and (1, N)."""
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w_q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xs = rng.random((M, 1)).astype(np.float32) / 127
    ws = rng.random((1, N)).astype(np.float32) / 127
    return x_q, w_q, xs, ws


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def bounded_inputs(B, KV, T, P, n_pp, pos, hd=128, seed=0):
    """Verify inputs over a cache longer than its live prefix: a block-paged
    pool of scrambled pages (NP, P, KV, hd) and its table (B, n_pp), the
    last slot's table ending in -1 entries past its committed length;
    kv_pos (B, n_pp * P) from the per-slot committed lengths ``pos``; T
    staged rows per slot after them (R = T), the first row of slot 0 fully
    masked (q_pos = -1); the staged K/V and a tree mask with a branch."""
    rng = np.random.default_rng(seed)
    S, NP = n_pp * P, B * n_pp + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    table = rng.permutation(NP)[: B * n_pp].reshape(B, n_pp).astype(np.int32)
    table[-1, -(-pos[-1] // P):] = -1
    pos = np.asarray(pos)[:, None]
    slots = np.arange(S)[None].repeat(B, 0)
    kv_pos = np.where(slots < pos, slots, -1).astype(np.int32)
    q_pos = (pos + np.arange(T)).astype(np.int32)
    q_pos[0, 0] = -1
    tm = np.tril(np.ones((T, T), bool))
    if T >= 4:
        tm[3, 2] = False
    return dict(q=f(B, KV, T, hd), k_pages=f(NP, P, KV, hd), v_pages=f(NP, P, KV, hd),
                table=table, kv_pos=kv_pos, q_pos=q_pos, k_new=f(B, KV, T, hd),
                v_new=f(B, KV, T, hd), tmask=np.broadcast_to(tm, (B, T, T)).copy())


class NoHostRead(TorchDispatchMode):
    """Refuses every op that reads a device value on the host or sizes its
    output from data: the ops a serving round must not run."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in _HOST_READS or name.startswith("aten::unique") or name.startswith(
                "aten::_unique"):
            raise AssertionError(f"{name} ran inside a serving round")
        return func(*args, **(kwargs or {}))


def warp_cases(B=5, T=3, V=64, seed=4):
    """Inputs of ``verify.sampling_probs``: logits (B, T, V) and per-slot
    temperature, top_k and top_p (B >= 5). Slot 0 is greedy, slot 1 has
    ties at the k-th value (k=3 of five logits at 5, 3, 3, 3, 3), slot 2 a
    row of equal logits (masses exactly 1/V) cut by top-p exactly on a
    cumulative boundary (0.25: the first V/4 tokens), slot 3 top-k and
    top-p together, the others no filter."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, V)).astype(np.float32) * 2
    logits[1, :, :6] = np.array([5.0, 3.0, 3.0, 3.0, 3.0, 1.0], np.float32)
    logits[1, :, 6:] = np.minimum(logits[1, :, 6:], 0.5)
    logits[2, 0] = 0.5
    temp = np.full(B, 0.9, np.float32)
    temp[:4] = (0.0, 0.7, 1.0, 1.3)
    top_k = np.zeros(B, np.int32)
    top_k[:4] = (5, 3, 0, 10)
    top_p = np.ones(B, np.float32)
    top_p[:4] = (0.9, 1.0, 0.25, 0.6)
    return logits, temp, top_k, top_p


def moe_routing(N, K, E, d, seed=0, experts=None):
    """N token rows (N, d) float32 and K distinct experts for each (N, K)
    int64, drawn from ``experts`` (default: all E)."""
    rng = np.random.default_rng(seed)
    pool = np.arange(E) if experts is None else np.asarray(experts)
    ids = np.stack([rng.choice(pool, size=K, replace=False) for _ in range(N)]).astype(np.int64)
    return rng.standard_normal((N, d)).astype(np.float32), ids


def moe_sorted(x, ids, E):
    """The dispatch's rows, as ``repro_torch.models.moe`` builds them: the
    (token, k) rows of ``x`` sorted stably by expert, the experts' offsets
    (E + 1,) int32 and the sort order (row i of the sorted rows is flat
    (token, k) pair ``order[i]``)."""
    K = ids.shape[1]
    order = np.argsort(ids.reshape(-1), kind="stable")
    offs = np.searchsorted(ids.reshape(-1)[order], np.arange(E + 1)).astype(np.int32)
    return np.ascontiguousarray(x[order // K]), offs, order


def moe_weights(E, d, F, dtype, device, seed=0):
    """Expert weights at the reference's scales on ``device``: w_gate and
    w_up (E, d, F), w_down (E, F, d)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    return draw((E, d, F), d ** -0.5), draw((E, d, F), d ** -0.5), draw((E, F, d), F ** -0.5)
