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

The split of S across CTAs is a function of the live length only (``live``,
by default S), the same for both kernels: a paged call whose table spans
more slots than ``live`` runs the same chunks as a dense call over the
first ``live`` slots, so the two give bitwise-equal merged outputs.

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
CUDA_HEAD_DIM = 128   # the one head dim the CUDA kernels instantiate (vicuna-7b)
_ROWS = 32            # query rows per CTA (attn_common.cuh: ROWS)
_CH = 32              # key slots per chunk (attn_common.cuh: CH)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "fd_split": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                 _I, _I, _I, _F, _I, _I, _P],
    "fd_paged_split": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _I, _I, _I, _F, _I, _I, _P],
    "fd_combine": [_P, _P, _P, _I, _L, _I, _P, _P, _P, _P, _P, _P, _P],
}


def flash_decode_partial(
    q, k, v, kv_pos, q_pos, *, kind: str = "causal", window: int = 0, sink: int = 0,
    scale: Optional[float] = None,
) -> ref.Partials:
    """Un-normalised partials (acc (B,KV,R,hd), m (B,KV,R), l (B,KV,R)), float32."""
    _check(q, k, v, kv_pos, q_pos, None, kind)
    if q.device.type == "cpu":
        return ref.flash_decode_partial(q, k, v, kv_pos, q_pos, kind=kind, window=window,
                                        sink=sink, scale=scale)
    return _dense(q, k, v, kv_pos, q_pos, None, kind, window, sink, scale)


def flash_decode_merge(
    q, k, v, kv_pos, q_pos, tree: ref.Partials, *, kind: str = "causal", window: int = 0,
    sink: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """Cache partials merged with the staged-tree partials ``tree`` by
    logsumexp and normalised: (B, KV, R, hd) float32."""
    _check(q, k, v, kv_pos, q_pos, tree, kind)
    if q.device.type == "cpu":
        cache = ref.flash_decode_partial(q, k, v, kv_pos, q_pos, kind=kind, window=window,
                                         sink=sink, scale=scale)
        return ref.merge_partials(cache, tree)
    return _dense(q, k, v, kv_pos, q_pos, tree, kind, window, sink, scale)


def flash_decode_paged_partial(
    q, k_pages, v_pages, page_table, kv_pos, q_pos, *, kind: str = "causal", window: int = 0,
    sink: int = 0, scale: Optional[float] = None, live: Optional[int] = None,
) -> ref.Partials:
    """Partials over a block-paged cache: (acc (B,KV,R,hd), m, l), float32."""
    live = _check_paged(q, k_pages, v_pages, page_table, kv_pos, q_pos, None, kind, live)
    if q.device.type == "cpu":
        return ref.flash_decode_paged_partial(q, k_pages, v_pages, page_table, kv_pos, q_pos,
                                              kind=kind, window=window, sink=sink, scale=scale)
    return _paged(q, k_pages, v_pages, page_table, kv_pos, q_pos, None, kind, window, sink,
                  scale, live)


def flash_decode_paged_merge(
    q, k_pages, v_pages, page_table, kv_pos, q_pos, tree: ref.Partials, *,
    kind: str = "causal", window: int = 0, sink: int = 0, scale: Optional[float] = None,
    live: Optional[int] = None,
) -> torch.Tensor:
    """Paged cache partials merged with the staged-tree partials and
    normalised: (B, KV, R, hd) float32."""
    live = _check_paged(q, k_pages, v_pages, page_table, kv_pos, q_pos, tree, kind, live)
    if q.device.type == "cpu":
        cache = ref.flash_decode_paged_partial(q, k_pages, v_pages, page_table, kv_pos, q_pos,
                                               kind=kind, window=window, sink=sink, scale=scale)
        return ref.merge_partials(cache, tree)
    return _paged(q, k_pages, v_pages, page_table, kv_pos, q_pos, tree, kind, window, sink,
                  scale, live)


def _check_common(q, k, v, kv_pos, q_pos, tree, kind, others=()) -> None:
    """The input contract both kernels share, checked on every device so
    that the CPU tests hold the callers to it too."""
    tensors = [q, k, v, kv_pos, q_pos, *others, *(tree or ())]
    if q.device.type not in ("cpu", "cuda") or any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all tensors must be on one CPU or CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if kv_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("flash_decode: kv_pos and q_pos must be int32")
    if q.device.type == "cuda" and q.shape[-1] != CUDA_HEAD_DIM:
        raise ValueError(f"flash_decode: the CUDA kernel takes head_dim {CUDA_HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    if kind not in KINDS:
        raise ValueError(f"unknown mask kind {kind!r}")
    if not (q.is_contiguous() and kv_pos.is_contiguous() and q_pos.is_contiguous()):
        raise ValueError("flash_decode: q, kv_pos and q_pos must be contiguous")
    if k.stride(-1) != 1 or v.stride() != k.stride():
        raise ValueError("flash_decode: k/v need a contiguous head dim and equal strides")
    if tree is not None:
        acc_d, m_d, l_d = tree
        if (acc_d.shape != q.shape or m_d.shape != q.shape[:3] or l_d.shape != q.shape[:3]
                or any(t.dtype != torch.float32 or not t.is_contiguous() for t in tree)):
            raise ValueError("flash_decode: tree partials must be contiguous float32 "
                             "(B, KV, R, hd) and (B, KV, R)")


def _check(q, k, v, kv_pos, q_pos, tree, kind) -> None:
    _check_common(q, k, v, kv_pos, q_pos, tree, kind)
    B, KV, R, hd = q.shape
    S = k.shape[2]
    if k.shape != (B, KV, S, hd) or v.shape != k.shape or S < 1:
        raise ValueError(f"flash_decode: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if kv_pos.shape != (B, S) or q_pos.shape != (B, R):
        raise ValueError("flash_decode: kv_pos must be (B, S) and q_pos (B, R)")


def _check_paged(q, k_pages, v_pages, table, kv_pos, q_pos, tree, kind, live) -> int:
    """The paged kernel's contract; returns the live length (default S)."""
    _check_common(q, k_pages, v_pages, kv_pos, q_pos, tree, kind, (table,))
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
    live = S if live is None else int(live)
    if not 1 <= live <= S:
        raise ValueError(f"flash_decode_paged: live {live} outside [1, {S}]")
    return live


def _split_plan(device, B: int, KV: int, R: int, live: int, S: int):
    """(n_split, split_len): split ``live`` slots so that the grid holds
    about two CTAs per SM, then cover all S slots with splits of that
    length (the extra slots of a paged table are masked for every row)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    base = B * KV * -(-R // _ROWS)
    n_chunks = -(-live // _CH)
    n_split = max(1, min(n_chunks, -(-2 * n_sm // base)))
    split_len = -(-n_chunks // n_split) * _CH
    return -(-S // split_len), split_len


def _partials(q, n_split):
    f32 = dict(device=q.device, dtype=torch.float32)
    B, KV, R, hd = q.shape
    return (torch.empty((n_split, B, KV, R, hd), **f32), torch.empty((n_split, B, KV, R), **f32),
            torch.empty((n_split, B, KV, R), **f32))


def _combine(lib, q, parts, n_split, tree, stream):
    """The second pass: combine the splits (and merge ``tree`` if given)."""
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
    _build.check(lib.fd_combine(P(acc_p), P(m_p), P(l_p), n_split, B * KV * R, hd, *d_args,
                                P(out), *o_args, stream), "flash_decode combine")
    return out if tree is not None else (out, out_m, out_l)


def _dense(q, k, v, kv_pos, q_pos, tree, kind, window, sink, scale):
    global launches
    B, KV, R, hd = q.shape
    S = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    n_split, split_len = _split_plan(q.device, B, KV, R, S, S)
    parts = _partials(q, n_split)
    lib = _build.load("flash_decode", _SIGNATURES)
    stream = _build.stream_ptr(q.device)
    P = _build.ptr
    sb, sg, ss, _ = k.stride()
    _build.check(lib.fd_split(
        _DTYPES[q.dtype], P(q), P(k), P(v), P(kv_pos), P(q_pos), *(P(t) for t in parts),
        B, KV, R, S, hd, sb, sg, ss, KINDS[kind], window, sink, scale, n_split, split_len,
        stream), "flash_decode split")
    out = _combine(lib, q, parts, n_split, tree, stream)
    launches += 1
    return out


def _paged(q, k_pages, v_pages, table, kv_pos, q_pos, tree, kind, window, sink, scale, live):
    global paged_launches
    B, KV, R, hd = q.shape
    NP, P_sz = k_pages.shape[:2]
    n_pp = table.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    n_split, split_len = _split_plan(q.device, B, KV, R, live, n_pp * P_sz)
    parts = _partials(q, n_split)
    lib = _build.load("flash_decode", _SIGNATURES)
    stream = _build.stream_ptr(q.device)
    P = _build.ptr
    sp, sr, sg, _ = k_pages.stride()
    _build.check(lib.fd_paged_split(
        _DTYPES[q.dtype], P(q), P(k_pages), P(v_pages), P(table), P(kv_pos), P(q_pos),
        *(P(t) for t in parts), B, KV, R, n_pp, P_sz, NP, hd, sp, sr, sg, KINDS[kind], window,
        sink, scale, n_split, split_len, stream), "flash_decode paged split")
    out = _combine(lib, q, parts, n_split, tree, stream)
    paged_launches += 1
    return out
