"""Plain PyTorch versions of every kernel: the correctness contract.

Torch-eager counterparts of the reference package's ``kernels/ref.py``
oracles and of each kernel's partial function. The CPU tests hold them
against the JAX oracles; on the card each hand-written kernel is held
against them. Nothing on the main path calls them for a CUDA tensor.

Layouts (GQA rep = H // KV, R = rep * T query rows ordered r * T + t):
  q (B, KV, R, hd); k/v cache (B, KV, S, hd); staged k/v (B, KV, T, hd);
  kv_pos (B, S) int32 (-1 = invalid slot); q_pos (B, R) int32;
  tree_mask (B, T, T) bool; paged pools (NP, P, KV, hd), the model's
  layout, with page_table (B, n_pp) int32 (-1 = unallocated) and S = n_pp * P.
Masked scores are NEG_INF = -1e30, never -inf: a row with no visible slot
keeps finite partials (m = -1e30, p = 1 per slot) and never turns NaN.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30
Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def visible(q_pos: torch.Tensor, kv_pos: torch.Tensor, kind: str, window: int, sink: int) -> torch.Tensor:
    """Boolean (..., Tq, Tk) visibility of key positions to query positions
    (kv_pos -1 marks an invalid slot)."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    valid = (k >= 0) & (k <= q)
    if kind == "window":
        valid &= k > q - window
    elif kind == "streaming":
        valid &= (k < sink) | (k > q - window)
    elif kind != "causal":
        raise ValueError(f"unknown mask kind {kind!r}")
    return valid


def _partials(s: torch.Tensor, v: torch.Tensor) -> Partials:
    """Un-normalised softmax partials of masked scores s (..., R, S) over v (..., S, hd)."""
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return p @ v, m, p.sum(dim=-1)


def flash_decode_partial(
    q, k, v, kv_pos, q_pos, *, kind: str = "causal", window: int = 0, sink: int = 0,
    scale: float | None = None,
) -> Partials:
    """Plain version of kernels/flash_decode.py::flash_decode_partial:
    (acc (B,KV,R,hd), m (B,KV,R), l (B,KV,R)), float32."""
    hd = q.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    s = (q.float() * scale) @ k.float().transpose(-1, -2)             # (B,KV,R,S)
    vis = visible(q_pos, kv_pos, kind, window, sink)                 # (B,R,S)
    s = torch.where(vis[:, None], s, torch.full_like(s, NEG_INF))
    return _partials(s, v.float())


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """The dense per-slot view of a block-paged pool, after the reference's
    ``ref_paged_gather``: pool (NP, P, KV, hd) -> (B, n_pp * P, KV, hd), the
    dense cache layout. Unallocated entries (-1) read page 0; the caller's
    ``kv_pos = -1`` masks what they pull in."""
    NP, P = pool.shape[:2]
    B, n_pp = page_table.shape
    safe = page_table.clamp(0, NP - 1).long()
    return pool[safe].reshape(B, n_pp * P, *pool.shape[2:])


def flash_decode_paged_partial(
    q, k_pages, v_pages, page_table, kv_pos, q_pos, *, kind: str = "causal", window: int = 0,
    sink: int = 0, scale: float | None = None,
) -> Partials:
    """Plain version of kernels/flash_decode.py::flash_decode_paged_partial:
    the dense partials over the gathered view."""
    k = paged_gather(k_pages, page_table).transpose(1, 2)
    v = paged_gather(v_pages, page_table).transpose(1, 2)
    return flash_decode_partial(q, k, v, kv_pos, q_pos, kind=kind, window=window, sink=sink,
                                scale=scale)


def tree_attention_partial(q, k_new, v_new, mask, *, k_staged=None, v_staged=None,
                           staged_mask=None, scale: float | None = None) -> Partials:
    """Plain version of kernels/tree_attention.py::tree_attention_partial:
    row r*T + t sees the staged tokens node t's mask row allows, and, with a
    carried segment (k_staged (B,KV,N_s,hd), staged_mask (B,T,N_s)), the
    carried rows its staged_mask row allows: one softmax over [carried ++
    new]."""
    R, hd = q.shape[2], q.shape[3]
    T = k_new.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    row_node = torch.arange(R, device=q.device) % T
    k, v, vis = k_new, v_new, mask[:, row_node, :]                    # vis (B,R,T)
    if k_staged is not None:
        k, v = torch.cat([k_staged, k], dim=2), torch.cat([v_staged, v], dim=2)
        vis = torch.cat([staged_mask[:, row_node, :], vis], dim=-1)
    s = (q.float() * scale) @ k.float().transpose(-1, -2)             # (B,KV,R,N_s+T)
    s = torch.where(vis[:, None], s, torch.full_like(s, NEG_INF))
    return _partials(s, v.float())


def merge_partials(cache: Partials, tree: Partials) -> torch.Tensor:
    """The logsumexp merge of kernels/ops.py::verify_attention (lines 83-91
    of the reference): one softmax over [cache ++ staged], normalised."""
    acc_c, m_c, l_c = cache
    acc_d, m_d, l_d = tree
    m = torch.maximum(m_c, m_d)
    cc = torch.exp(m_c - m)[..., None]
    cd = torch.exp(m_d - m)[..., None]
    return (acc_c * cc + acc_d * cd) / torch.clamp_min(l_c[..., None] * cc + l_d[..., None] * cd, 1e-30)


def ref_verify_attention(
    q, k_cache, v_cache, kv_pos, q_pos, k_new, v_new, tree_mask, *,
    kind: str = "causal", window: int = 0, sink: int = 0, k_staged=None, v_staged=None,
    staged_mask=None,
) -> torch.Tensor:
    """Full softmax over [cache ++ carried ++ staged] (the carried segment
    only with ``k_staged``); returns (B, KV, R, hd) float32."""
    R, hd = q.shape[2], q.shape[3]
    T = k_new.shape[2]
    row_node = torch.arange(R, device=q.device) % T
    qf = q.float() * hd ** -0.5
    s_c = qf @ k_cache.float().transpose(-1, -2)
    s_c = torch.where(visible(q_pos, kv_pos, kind, window, sink)[:, None], s_c,
                      torch.full_like(s_c, NEG_INF))
    k, v, vis = k_new, v_new, tree_mask[:, row_node, :]
    if k_staged is not None:
        k, v = torch.cat([k_staged, k], dim=2), torch.cat([v_staged, v], dim=2)
        vis = torch.cat([staged_mask[:, row_node, :], vis], dim=-1)
    s_d = qf @ k.float().transpose(-1, -2)
    s_d = torch.where(vis[:, None], s_d, torch.full_like(s_d, NEG_INF))
    p = torch.softmax(torch.cat([s_c, s_d], dim=-1), dim=-1)
    return p @ torch.cat([v_cache, v], dim=2).float()


def ref_paged_verify_attention(
    q, k_pages, v_pages, page_table, kv_pos, q_pos, k_new, v_new, tree_mask, *,
    kind: str = "causal", window: int = 0, sink: int = 0, **staged,
) -> torch.Tensor:
    """Paged oracle, after the reference's ``ref_paged_verify_attention``:
    gather the pool to the dense view, then the dense oracle (``staged``:
    its carried-segment arguments)."""
    k = paged_gather(k_pages, page_table).transpose(1, 2)
    v = paged_gather(v_pages, page_table).transpose(1, 2)
    return ref_verify_attention(q, k, v, kv_pos, q_pos, k_new, v_new, tree_mask, kind=kind,
                                window=window, sink=sink, **staged)


def cond_segments(steps) -> None:
    """Plain version of kernels/graph_cond.py::CondGraph: the segments run
    in order, eagerly; an ("if", pred, fn) step runs ``fn`` when ``pred``
    (a tensor, or a function returning the tensor an earlier segment made),
    read on the host when the step is reached, is non-zero."""
    for step in steps:
        if step[0] == "if":
            pred = step[1]() if callable(step[1]) else step[1]
            if bool(pred):
                step[2]()
        else:
            step[1]()


def ref_int8_matmul(x_q, w_q, x_scale, w_scale) -> torch.Tensor:
    """Exact integer product, then the scale epilogue: (M, N) float32.
    float64 holds every int8 x int8 sum over K < 2^39 exactly, and float64
    products run on every device (integer matmul does not)."""
    acc = (x_q.double() @ w_q.double()).float()
    return acc * x_scale * w_scale


def _expert_act(x: torch.Tensor, act: str) -> torch.Tensor:
    """The expert activation by name: "silu", "gelu" (the tanh
    approximation, ``jax.nn.gelu``'s default) or "none"."""
    if act == "silu":
        return torch.nn.functional.silu(x)
    if act == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if act == "none":
        return x
    raise ValueError(f"unknown expert activation {act!r}")


def ref_moe_grouped(x_s, w, offs, *, act: str = "none", w_mul=None) -> torch.Tensor:
    """Plain version of kernels/moe_grouped.py::moe_grouped: the rows
    ``[offs[e], offs[e+1])`` of ``x_s`` (P, K), sorted by expert, times
    expert e's ``w[e]`` (K, N), one ``torch.matmul`` per expert with rows
    (the explicit rule of ``tests/test_moe.py::
    test_dropless_equals_explicit_topk``): ``act(x w[e]) * (x w_mul[e])``
    with ``w_mul``, else ``act(x w[e])``, in float32, rounded once to the
    rows' type. Reads the offsets on the host."""
    out = torch.zeros((x_s.shape[0], w.shape[2]), dtype=x_s.dtype, device=x_s.device)
    o = offs.tolist()  # port: noqa-PORT001: the plain version runs for CPU tensors only
    for e in range(w.shape[0]):
        a, b = o[e], o[e + 1]
        if a == b:
            continue
        xe = x_s[a:b].float()
        y = _expert_act(torch.matmul(xe, w[e].float()), act)
        if w_mul is not None:
            y = y * torch.matmul(xe, w_mul[e].float())
        out[a:b] = y.to(out.dtype)
    return out
