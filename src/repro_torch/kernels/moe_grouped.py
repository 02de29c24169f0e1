"""Grouped expert GEMM of the dropless MoE dispatch (``csrc/moe_grouped.cu``).

Not the counterpart of a Pallas kernel: the reference runs the dispatch's
expert products as ``jax.lax.ragged_dot`` (``src/repro/models/moe.py::
_dropless_ragged``), an XLA op. ``moe_grouped`` computes, for each expert e,
the rows ``[offs[e], offs[e+1])`` of ``x_s`` (the (token, expert) rows
sorted by expert) times ``w[e]``: ``act(x w[e]) * (x w_mul[e])`` (the gated
up projection: ``w`` the gate, ``w_mul`` the up weight) or ``act(x w[e])``
(2-matrix experts, and the down projection with ``act="none"``). One launch
covers every expert; the offsets stay on the device, so a captured round
holds it, and each output element is reduced in one fixed order whatever
the row count: the product is batch-invariant.

A launch is cut by ``_plan(K, N, E, dtype)``, a pure function of the
shapes and the type, never of the row count or the offsets: bfloat16 runs
the tensor-core kernel (``wgmma`` over TMA-fed tiles, 128 output columns a
CTA) with a ring of ``STAGES``; float32 the SIMT kernel, whose tiles and
ring are fixed in its source. Each kernel keeps its own launch count:
``launches`` the float32 kernel's, ``bf16_launches`` the bfloat16 one's.

On CPU tensors it computes the plain version (``kernels/ref.py::
ref_moe_grouped``, one matmul per expert, the offsets read on the host); on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0            # the float32 SIMT kernel's
bf16_launches = 0       # the bfloat16 tensor-core kernel's

ACTS = {"none": 0, "silu": 1, "gelu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"moe_grouped": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]}

STAGES = 4              # the tensor-core kernel's ring: 64 k a stage


def _plan(K: int, N: int, E: int, dtype: torch.dtype) -> int:
    """The ring depth of a (K, N) expert product over E experts: ``STAGES``
    in bfloat16, 0 in float32 (the SIMT kernel takes none). It reads the
    shapes and the type alone, so every output element is reduced the same
    way whatever rows are batched."""
    if dtype == torch.float32:
        return 0
    if dtype != torch.bfloat16:
        raise TypeError(f"moe_grouped: no plan for {dtype}")
    return STAGES


def moe_grouped(x_s: torch.Tensor, w: torch.Tensor, offs: torch.Tensor, *, act: str = "none",
                w_mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_s (P, K) rows sorted by expert, w (and w_mul) (E, K, N) of the same
    type (float32 or bfloat16), offs (E + 1,) int32 with offs[0] = 0 and
    offs[E] = P: (P, N) in the rows' type, accumulated in float32."""
    _check(x_s, w, offs, act, w_mul)
    if x_s.device.type == "cpu":
        return ref.ref_moe_grouped(x_s, w, offs, act=act, w_mul=w_mul)
    return _launch(x_s, w, offs, act, w_mul)


def _launch(x_s, w, offs, act: str, w_mul) -> torch.Tensor:
    global launches, bf16_launches
    P, K = x_s.shape
    E, _, N = w.shape
    out = torch.empty((P, N), dtype=x_s.dtype, device=x_s.device)
    if P == 0:
        return out
    stages = _plan(K, N, E, x_s.dtype)
    lib = _build.load("moe_grouped", _SIGNATURES)
    mul = None if w_mul is None else _build.ptr(w_mul)
    _build.check(lib.moe_grouped(_build.ptr(x_s), _build.ptr(w), mul, _build.ptr(offs),
                                 _build.ptr(out), P, K, N, E, _DTYPES[x_s.dtype],
                                 int(w_mul is not None), ACTS[act], stages,
                                 _build.stream_ptr(x_s.device)),
                 "moe_grouped")
    if x_s.dtype == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return out


def _check(x_s, w, offs, act: str, w_mul) -> None:
    """The kernel's input contract, checked on every device."""
    tensors = [x_s, w, offs] + ([] if w_mul is None else [w_mul])
    if x_s.device.type not in ("cpu", "cuda") or any(t.device != x_s.device for t in tensors):
        raise ValueError("moe_grouped: all tensors must be on one CPU or CUDA device")
    if x_s.dtype not in _DTYPES or w.dtype != x_s.dtype or (w_mul is not None
                                                            and w_mul.dtype != x_s.dtype):
        raise TypeError(f"moe_grouped: rows and weights must share one type of "
                        f"{sorted(map(str, _DTYPES))}, not {x_s.dtype} / {w.dtype}")
    if offs.dtype != torch.int32:
        raise TypeError("moe_grouped: offs must be int32")
    if act not in ACTS or (w_mul is not None and act == "none"):
        raise ValueError(f"moe_grouped: act {act!r} (one of {sorted(ACTS)}; a gated product "
                         "needs an activation)")
    if (x_s.ndim != 2 or w.ndim != 3 or w.shape[1] != x_s.shape[1] or offs.shape != (w.shape[0] + 1,)
            or (w_mul is not None and w_mul.shape != w.shape)):
        raise ValueError(f"moe_grouped: shapes x {tuple(x_s.shape)} w {tuple(w.shape)} offs "
                         f"{tuple(offs.shape)} do not match")
    if x_s.shape[1] % 8 or w.shape[2] % 8:
        raise ValueError("moe_grouped: K and N must be multiples of 8 (16-byte rows)")
    if not all(t.is_contiguous() for t in tensors) or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("moe_grouped: operands must be contiguous and 16-byte aligned")
