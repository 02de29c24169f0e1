"""Flash-decode attention over a committed KV cache (``csrc/flash_decode.cu``).

Counterpart of the reference's ``kernels/flash_decode.py::flash_decode_partial``:
split-KV online-softmax partials of R = rep * T query rows per (batch,
kv-head), with visibility ``0 <= kv_pos <= q_pos`` plus the window or
sink-or-window test. ``flash_decode_merge`` also folds in the staged-tree
partials and normalises (the verify merge), in the kernel's combine pass.

Layouts: q (B, KV, R, hd) contiguous; k/v (B, KV, S, hd) with hd contiguous
and any other strides (the model passes the (B, S, KV, hd) cache
transposed, as a view); kv_pos (B, S) and q_pos (B, R) int32.

On a CPU tensor both functions compute the plain version
(``kernels/ref.py``); on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches (split + combine count as one)

KINDS = {"causal": 0, "window": 1, "streaming": 2}
CUDA_HEAD_DIM = 128   # the one head dim the CUDA kernels instantiate (vicuna-7b)
_ROWS = 32            # query rows per CTA (attn_common.cuh: ROWS)
_CH = 32              # key slots per chunk (attn_common.cuh: CH)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "fd_split": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                 _I, _I, _I, _F, _I, _I, _P],
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
    return _launch(q, k, v, kv_pos, q_pos, None, kind, window, sink, scale)


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
    return _launch(q, k, v, kv_pos, q_pos, tree, kind, window, sink, scale)


def _check(q, k, v, kv_pos, q_pos, tree, kind) -> None:
    """The kernel's input contract, checked on every device so that the CPU
    tests hold the callers to it too."""
    tensors = [q, k, v, kv_pos, q_pos, *(tree or ())]
    if q.device.type not in ("cpu", "cuda") or any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all tensors must be on one CPU or CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if kv_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("flash_decode: kv_pos and q_pos must be int32")
    B, KV, R, hd = q.shape
    S = k.shape[2]
    if k.shape != (B, KV, S, hd) or v.shape != k.shape or S < 1:
        raise ValueError(f"flash_decode: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if kv_pos.shape != (B, S) or q_pos.shape != (B, R):
        raise ValueError("flash_decode: kv_pos must be (B, S) and q_pos (B, R)")
    if q.device.type == "cuda" and hd != CUDA_HEAD_DIM:
        raise ValueError(f"flash_decode: the CUDA kernel takes head_dim {CUDA_HEAD_DIM}, got {hd}")
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


def _launch(q, k, v, kv_pos, q_pos, tree, kind, window, sink, scale):
    global launches
    B, KV, R, hd = q.shape
    S = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    # split S so that the grid holds about two CTAs per SM
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    base = B * KV * -(-R // _ROWS)
    n_chunks = -(-S // _CH)
    n_split = max(1, min(n_chunks, -(-2 * n_sm // base)))
    split_len = -(-n_chunks // n_split) * _CH
    n_split = -(-S // split_len)

    f32 = dict(device=q.device, dtype=torch.float32)
    acc_p = torch.empty((n_split, B, KV, R, hd), **f32)
    m_p = torch.empty((n_split, B, KV, R), **f32)
    l_p = torch.empty((n_split, B, KV, R), **f32)
    out = torch.empty((B, KV, R, hd), **f32)
    out_m = out_l = None
    if tree is None:
        out_m = torch.empty((B, KV, R), **f32)
        out_l = torch.empty((B, KV, R), **f32)

    lib = _build.load("flash_decode", _SIGNATURES)
    stream = _build.stream_ptr(q.device)
    P = _build.ptr
    sb, sg, ss, _ = k.stride()
    _build.check(lib.fd_split(
        _DTYPES[q.dtype], P(q), P(k), P(v), P(kv_pos), P(q_pos), P(acc_p), P(m_p), P(l_p),
        B, KV, R, S, hd, sb, sg, ss, KINDS[kind], window, sink, scale, n_split, split_len,
        stream), "flash_decode split")
    nul = ctypes.c_void_p(None)
    acc_d, m_d, l_d = (P(t) for t in tree) if tree is not None else (nul, nul, nul)
    _build.check(lib.fd_combine(
        P(acc_p), P(m_p), P(l_p), n_split, B * KV * R, hd, acc_d, m_d, l_d, P(out),
        P(out_m) if out_m is not None else nul, P(out_l) if out_l is not None else nul,
        stream), "flash_decode combine")
    launches += 1
    if tree is None:
        return out, out_m, out_l
    return out
