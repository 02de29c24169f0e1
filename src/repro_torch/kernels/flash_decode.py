"""Flash-decode attention over a committed KV cache (``csrc/flash_decode.cu``).

Counterpart of the reference's ``kernels/flash_decode.py::flash_decode_partial``
and ``::flash_decode_paged_partial``: split-KV online-softmax partials of
R = rep * T query rows per (batch, kv-head), with visibility
``0 <= kv_pos <= q_pos`` plus the window or sink-or-window test. The
``*_merge`` functions also fold in the staged-tree partials and normalise
(the verify merge), in the kernel's combine pass.

Layouts: q (B, KV, R, hd) contiguous; kv_pos (B, S) and q_pos (B, R) int32.
Dense: k/v (B, KV, S, hd) with hd contiguous and any other strides (the
model passes the (B, S, KV, hd) cache transposed, as a view). Paged: pools
k_pages/v_pages (NP, P, KV, hd), the model's layout, with hd contiguous and
any other strides, and page_table (B, n_pp) int32; slot s of row b is row
s % P of page page_table[b, s // P] (-1, unallocated, reads page 0 and must
be masked by kv_pos), so S = n_pp * P.

The split of S across CTAs is a function of the live length L only, in
whole 32-slot key tiles, the same for both kernels. L is S, or, given
``bound`` (a (B,) int32 tensor of committed lengths, the cache's ``pos``),
max(1, max(bound)) read on the device: slots at or past it are masked for
every row, and the kernels scan [0, L) only. A call over the whole cache
with its bound runs the tiles of a call over the cache cut to L on the
host, paged or dense, so the two give bitwise-equal results; and it reads
no device value on the host, so it can be captured in a CUDA graph. The
plain versions scan all S slots (a masked slot adds exactly zero to a row
that sees any slot).

On a CPU tensor every function computes the plain version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0          # dense kernel launches (split + combine count as one)
paged_launches = 0    # paged kernel launches (split + combine count as one)

KINDS = {"causal": 0, "window": 1, "streaming": 2}
HEAD_DIMS = (64, 128, 288)   # the head dims the CUDA kernels instantiate
KEY_TILE = 32         # key slots per staged tile (attn_common.cuh: KT)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "fd_split": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                 _I, _I, _I, _F, _I, _I, _P, _I, _P],
    "fd_paged_split": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _I, _I, _I, _F, _I, _I, _P, _I, _P],
    "fd_combine": [_P, _P, _P, _L, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
}


def flash_decode_partial(
    q, k, v, kv_pos, q_pos, *, kind: str = "causal", window: int = 0, sink: int = 0,
    scale: Optional[float] = None, bound: Optional[torch.Tensor] = None,
) -> ref.Partials:
    """Un-normalised partials (acc (B,KV,R,hd), m (B,KV,R), l (B,KV,R)), float32."""
    _check(q, k, v, kv_pos, q_pos, None, kind, bound)
    if q.device.type == "cpu":
        return ref.flash_decode_partial(q, k, v, kv_pos, q_pos, kind=kind, window=window,
                                        sink=sink, scale=scale)
    return _dense(q, k, v, kv_pos, q_pos, None, kind, window, sink, scale, bound)


def flash_decode_merge(
    q, k, v, kv_pos, q_pos, tree: ref.Partials, *, kind: str = "causal", window: int = 0,
    sink: int = 0, scale: Optional[float] = None, bound: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cache partials merged with the staged-tree partials ``tree`` by
    logsumexp and normalised: (B, KV, R, hd) float32."""
    _check(q, k, v, kv_pos, q_pos, tree, kind, bound)
    if q.device.type == "cpu":
        cache = ref.flash_decode_partial(q, k, v, kv_pos, q_pos, kind=kind, window=window,
                                         sink=sink, scale=scale)
        return ref.merge_partials(cache, tree)
    return _dense(q, k, v, kv_pos, q_pos, tree, kind, window, sink, scale, bound)


def flash_decode_paged_partial(
    q, k_pages, v_pages, page_table, kv_pos, q_pos, *, kind: str = "causal", window: int = 0,
    sink: int = 0, scale: Optional[float] = None, bound: Optional[torch.Tensor] = None,
) -> ref.Partials:
    """Partials over a block-paged cache: (acc (B,KV,R,hd), m, l), float32."""
    _check_paged(q, k_pages, v_pages, page_table, kv_pos, q_pos, None, kind, bound)
    if q.device.type == "cpu":
        return ref.flash_decode_paged_partial(q, k_pages, v_pages, page_table, kv_pos, q_pos,
                                              kind=kind, window=window, sink=sink, scale=scale)
    return _paged(q, k_pages, v_pages, page_table, kv_pos, q_pos, None, kind, window, sink,
                  scale, bound)


def flash_decode_paged_merge(
    q, k_pages, v_pages, page_table, kv_pos, q_pos, tree: ref.Partials, *,
    kind: str = "causal", window: int = 0, sink: int = 0, scale: Optional[float] = None,
    bound: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged cache partials merged with the staged-tree partials and
    normalised: (B, KV, R, hd) float32."""
    _check_paged(q, k_pages, v_pages, page_table, kv_pos, q_pos, tree, kind, bound)
    if q.device.type == "cpu":
        cache = ref.flash_decode_paged_partial(q, k_pages, v_pages, page_table, kv_pos, q_pos,
                                               kind=kind, window=window, sink=sink, scale=scale)
        return ref.merge_partials(cache, tree)
    return _paged(q, k_pages, v_pages, page_table, kv_pos, q_pos, tree, kind, window, sink,
                  scale, bound)


def _check_common(q, k, v, kv_pos, q_pos, tree, kind, bound, others=()) -> None:
    """The input contract both kernels share, checked on every device so
    that the CPU tests hold the callers to it too."""
    if bound is not None:
        if bound.dtype != torch.int32 or bound.ndim != 1 or not bound.is_contiguous():
            raise ValueError("flash_decode: bound must be a contiguous 1-D int32 tensor")
        others = (*others, bound)
    tensors = [q, k, v, kv_pos, q_pos, *others, *(tree or ())]
    if q.device.type not in ("cpu", "cuda") or any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all tensors must be on one CPU or CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if kv_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("flash_decode: kv_pos and q_pos must be int32")
    check_head_dim("flash_decode", q)
    if kind not in KINDS:
        raise ValueError(f"unknown mask kind {kind!r}")
    if not (q.is_contiguous() and kv_pos.is_contiguous() and q_pos.is_contiguous()):
        raise ValueError("flash_decode: q, kv_pos and q_pos must be contiguous")
    if k.stride(-1) != 1 or v.stride() != k.stride():
        raise ValueError("flash_decode: k/v need a contiguous head dim and equal strides")
    check_aligned("flash_decode", q, k, v)
    if tree is not None:
        acc_d, m_d, l_d = tree
        if (acc_d.shape != q.shape or m_d.shape != q.shape[:3] or l_d.shape != q.shape[:3]
                or any(t.dtype != torch.float32 or not t.is_contiguous() for t in tree)):
            raise ValueError("flash_decode: tree partials must be contiguous float32 "
                             "(B, KV, R, hd) and (B, KV, R)")


def check_head_dim(what: str, q) -> None:
    """On the card, the head dim must be one the kernels instantiate."""
    if q.device.type == "cuda" and q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: the CUDA kernel takes a head_dim in {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")


def check_aligned(what: str, *tensors) -> None:
    """The kernels stage rows by 16-byte copies: every stride but the last
    must be a multiple of 16 bytes, and on the card the data 16-byte
    aligned."""
    for t in tensors:
        if any(s * t.element_size() % 16 for s in t.stride()[:-1]) or (
                t.device.type == "cuda" and t.data_ptr() % 16):
            raise ValueError(f"{what}: q/k/v rows must start on 16-byte boundaries "
                             f"(strides {t.stride()}, {t.dtype})")


def _check(q, k, v, kv_pos, q_pos, tree, kind, bound) -> None:
    _check_common(q, k, v, kv_pos, q_pos, tree, kind, bound)
    B, KV, R, hd = q.shape
    S = k.shape[2]
    if k.shape != (B, KV, S, hd) or v.shape != k.shape or S < 1:
        raise ValueError(f"flash_decode: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if kv_pos.shape != (B, S) or q_pos.shape != (B, R):
        raise ValueError("flash_decode: kv_pos must be (B, S) and q_pos (B, R)")


def _check_paged(q, k_pages, v_pages, table, kv_pos, q_pos, tree, kind, bound) -> None:
    """The paged kernel's contract."""
    _check_common(q, k_pages, v_pages, kv_pos, q_pos, tree, kind, bound, (table,))
    B, KV, R, hd = q.shape
    NP, P = k_pages.shape[:2]
    if k_pages.shape != (NP, P, KV, hd) or v_pages.shape != k_pages.shape or NP < 1:
        raise ValueError(f"flash_decode_paged: pools {tuple(k_pages.shape)} are not "
                         f"(NP, P, KV, hd) for q {tuple(q.shape)}")
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[0] != B or table.shape[1] < 1:
        raise ValueError("flash_decode_paged: page_table must be (B, n_pp) int32")
    if not table.is_contiguous():
        raise ValueError("flash_decode_paged: page_table must be contiguous")
    S = table.shape[1] * P
    if kv_pos.shape != (B, S) or q_pos.shape != (B, R):
        raise ValueError(f"flash_decode_paged: kv_pos must be (B, n_pp * P) = {(B, S)} and "
                         "q_pos (B, R)")


def rows_per_cta(R: int, hd: int) -> int:
    """Query rows of one CTA's tile: one 16-row tensor-core tile for
    R <= 16 or hd > 128, two otherwise (attn_common.cuh: row_tiles)."""
    return 16 if R <= 16 or hd > 128 else 32


def ctas_per_sm(hd: int, dtype) -> int:
    """Split CTAs resident on one SM: two, but one at hd 288 in float32,
    whose ring and split Q take 183 KB of shared memory
    (``flash_decode.cu``, design)."""
    return 1 if hd > 128 and dtype == torch.float32 else 2


def _split_plan(q, B: int, KV: int, R: int, S: int):
    """(n_grid, cap) for the kernels' own plan (``live_plan`` in the
    source): the live length's key tiles go to max(1, min(tiles, cap))
    splits, cap being the split count whose grid fills the card's resident
    CTAs in one wave (a second, partial wave would leave SMs idle at the
    tail); n_grid, the grid's split dimension, is the most splits any live
    length up to S asks for."""
    hd = q.shape[-1]
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    cap = ctas_per_sm(hd, q.dtype) * n_sm // (B * KV * -(-R // rows_per_cta(R, hd)))
    return max(1, min(-(-S // KEY_TILE), cap)), cap


def _partials(q, n_split):
    f32 = dict(device=q.device, dtype=torch.float32)
    B, KV, R, hd = q.shape
    return (torch.empty((n_split, B, KV, R, hd), **f32), torch.empty((n_split, B, KV, R), **f32),
            torch.empty((n_split, B, KV, R), **f32))


def _combine(lib, q, parts, S, cap, bound, tree, stream):
    """The second pass: combine the splits that ran (and merge ``tree`` if
    given)."""
    B, KV, R, hd = q.shape
    f32 = dict(device=q.device, dtype=torch.float32)
    out = torch.empty((B, KV, R, hd), **f32)
    P, nul = _build.ptr, ctypes.c_void_p(None)
    if tree is None:
        out_m, out_l = torch.empty((B, KV, R), **f32), torch.empty((B, KV, R), **f32)
        d_args, o_args = (nul, nul, nul), (P(out_m), P(out_l))
    else:
        d_args, o_args = tuple(P(t) for t in tree), (nul, nul)
    acc_p, m_p, l_p = parts
    _build.check(lib.fd_combine(P(acc_p), P(m_p), P(l_p), B * KV * R, hd, S, cap,
                                *_bound_args(bound), *d_args, P(out), *o_args, stream),
                 "flash_decode combine")
    return out if tree is not None else (out, out_m, out_l)


def _bound_args(bound):
    return (ctypes.c_void_p(None), 0) if bound is None else (_build.ptr(bound), bound.numel())


def _dense(q, k, v, kv_pos, q_pos, tree, kind, window, sink, scale, bound):
    global launches
    B, KV, R, hd = q.shape
    S = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    n_grid, cap = _split_plan(q, B, KV, R, S)
    parts = _partials(q, n_grid)
    lib = _build.load("flash_decode", _SIGNATURES)
    stream = _build.stream_ptr(q.device)
    P = _build.ptr
    sb, sg, ss, _ = k.stride()
    _build.check(lib.fd_split(
        _DTYPES[q.dtype], P(q), P(k), P(v), P(kv_pos), P(q_pos), *(P(t) for t in parts),
        B, KV, R, S, hd, sb, sg, ss, KINDS[kind], window, sink, scale, n_grid, cap,
        *_bound_args(bound), stream), "flash_decode split")
    out = _combine(lib, q, parts, S, cap, bound, tree, stream)
    launches += 1
    return out


def _paged(q, k_pages, v_pages, table, kv_pos, q_pos, tree, kind, window, sink, scale, bound):
    global paged_launches
    B, KV, R, hd = q.shape
    NP, P_sz = k_pages.shape[:2]
    n_pp = table.shape[1]
    S = n_pp * P_sz
    scale = hd ** -0.5 if scale is None else scale
    n_grid, cap = _split_plan(q, B, KV, R, S)
    parts = _partials(q, n_grid)
    lib = _build.load("flash_decode", _SIGNATURES)
    stream = _build.stream_ptr(q.device)
    P = _build.ptr
    sp, sr, sg, _ = k_pages.stride()
    _build.check(lib.fd_paged_split(
        _DTYPES[q.dtype], P(q), P(k_pages), P(v_pages), P(table), P(kv_pos), P(q_pos),
        *(P(t) for t in parts), B, KV, R, n_pp, P_sz, NP, hd, sp, sr, sg, KINDS[kind], window,
        sink, scale, n_grid, cap, *_bound_args(bound), stream), "flash_decode paged split")
    out = _combine(lib, q, parts, S, cap, bound, tree, stream)
    paged_launches += 1
    return out
