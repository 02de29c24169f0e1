"""Tree-masked attention over the staged draft tokens (``csrc/tree_attention.cu``).

Counterpart of the reference's ``kernels/tree_attention.py::tree_attention_partial``:
the T staged tokens attend over each other under the (B, T, T)
ancestor-or-self mask (positional validity folded in), tiled over the rep
GQA rows (row r*T + t is tree node t). Returns un-normalised partials that
``flash_decode.flash_decode_merge`` merges with the cache partials.

Layouts: q (B, KV, R, hd) contiguous; k_new/v_new (B, KV, T, hd) with hd
contiguous and any other strides; mask (B, T, T) bool, contiguous.

A second key segment (``draft_kv="carry"``): k_staged/v_staged (B, KV, N_s,
hd), the rows a draft scan carries, with hd contiguous and their own
strides, and staged_mask (B, T, N_s) bool, contiguous, with positional
validity folded in. One launch then returns the partials over [carried ++
new] keys, which the flash-decode combine merges with the cache's.

On a CPU tensor this computes the plain version (``kernels/ref.py``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_decode import check_aligned, check_head_dim

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "tree_attn": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _L, _L, _L, _L, _L, _L, _F, _P],
}


def tree_attention_partial(
    q, k_new, v_new, mask, *, k_staged=None, v_staged=None, staged_mask=None,
    scale: Optional[float] = None,
) -> ref.Partials:
    """(acc (B,KV,R,hd), m (B,KV,R), l (B,KV,R)) float32 partials over the
    new keys, and over the carried ones first when ``k_staged`` is given."""
    _check(q, k_new, v_new, mask, k_staged, v_staged, staged_mask)
    if q.device.type == "cpu":
        return ref.tree_attention_partial(q, k_new, v_new, mask, k_staged=k_staged,
                                          v_staged=v_staged, staged_mask=staged_mask, scale=scale)
    global launches
    B, KV, R, hd = q.shape
    T = k_new.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    f32 = dict(device=q.device, dtype=torch.float32)
    acc = torch.empty((B, KV, R, hd), **f32)
    m = torch.empty((B, KV, R), **f32)
    l = torch.empty((B, KV, R), **f32)
    lib = _build.load("tree_attention", _SIGNATURES)
    P, nul = _build.ptr, ctypes.c_void_p(None)
    sb, sg, st, _ = k_new.stride()
    if k_staged is None:
        seg2, n_s, (ssb, ssg, sst) = (nul, nul, nul), 0, (0, 0, 0)
    else:
        seg2, n_s = (P(k_staged), P(v_staged), P(staged_mask)), k_staged.shape[2]
        ssb, ssg, sst, _ = k_staged.stride()
    _build.check(lib.tree_attn(
        _DTYPES[q.dtype], P(q), P(k_new), P(v_new), P(mask), *seg2, P(acc), P(m), P(l),
        B, KV, R, T, n_s, hd, sb, sg, st, ssb, ssg, sst, scale, _build.stream_ptr(q.device)),
        "tree_attention")
    launches += 1
    return acc, m, l


def _check(q, k, v, mask, k_staged=None, v_staged=None, staged_mask=None) -> None:
    """The kernel's input contract, checked on every device."""
    seg2 = (k_staged, v_staged, staged_mask)
    if any(t is None for t in seg2) and any(t is not None for t in seg2):
        raise ValueError("tree_attention: k_staged, v_staged and staged_mask come together")
    seg2 = () if k_staged is None else seg2
    if q.device.type not in ("cpu", "cuda") or any(t.device != q.device for t in (k, v, mask, *seg2)):
        raise ValueError("tree_attention: all tensors must be on one CPU or CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, *seg2[:2])):
        raise TypeError(f"tree_attention: q/k/v (and k/v_staged) must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if mask.dtype != torch.bool or (seg2 and staged_mask.dtype != torch.bool):
        raise TypeError("tree_attention: masks must be bool")
    B, KV, R, hd = q.shape
    T = k.shape[2]
    if k.shape != (B, KV, T, hd) or v.shape != k.shape or mask.shape != (B, T, T) or R % T:
        raise ValueError(f"tree_attention: k {tuple(k.shape)} / mask {tuple(mask.shape)} "
                         f"do not match q {tuple(q.shape)}")
    check_head_dim("tree_attention", q)
    if not (q.is_contiguous() and mask.is_contiguous()):
        raise ValueError("tree_attention: q and mask must be contiguous")
    if k.stride(-1) != 1 or v.stride() != k.stride():
        raise ValueError("tree_attention: k/v need a contiguous head dim and equal strides")
    check_aligned("tree_attention", q, k, v)
    if seg2:
        N_s = k_staged.shape[2]
        if (k_staged.shape != (B, KV, N_s, hd) or v_staged.shape != k_staged.shape or N_s < 1
                or staged_mask.shape != (B, T, N_s)):
            raise ValueError(f"tree_attention: k_staged {tuple(k_staged.shape)} / staged_mask "
                             f"{tuple(staged_mask.shape)} do not match q {tuple(q.shape)} and "
                             f"T={T}")
        if not staged_mask.is_contiguous():
            raise ValueError("tree_attention: staged_mask must be contiguous")
        if k_staged.stride(-1) != 1 or v_staged.stride() != k_staged.stride():
            raise ValueError("tree_attention: k/v_staged need a contiguous head dim and equal "
                             "strides")
        check_aligned("tree_attention", k_staged, v_staged)
