"""W8A8 dynamic-quantized matmul (``csrc/int8_matmul.cu``).

Counterpart of the reference's ``kernels/int8_matmul.py``: activations get
per-row symmetric int8, weights per-column int8 (``quantize_rows`` /
``quantize_cols``, plain torch, bit-equal to the reference's jnp: the same
float32 division and round-half-to-even), and ``int8_matmul`` runs the
int8 x int8 -> int32 product with the ``x_scale * w_scale`` epilogue.

On CPU tensors ``int8_matmul`` computes the plain version
(``kernels/ref.py::ref_int8_matmul``); on CUDA tensors it launches the
kernel or raises. The kernel sums in int32 over the whole K and so equals
the exact product; the reference kernel's per-tile float32 accumulation
differs from both by float32 rounding only.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0

TILE_K = 64           # int8_matmul.cu: BK
TILE_N = 64           # int8_matmul.cu: BN
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"int8_mm": [_P, _P, _P, _P, _P, _I, _I, _I, _P]}


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (x_int8 (M, K), scale (M, 1) float32)."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def quantize_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8: (w_int8 (K, N), scale (1, N) float32)."""
    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(dim=0, keepdim=True), 1e-8) / 127.0
    return torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8), scale


def int8_matmul(x_q, w_q, x_scale, w_scale) -> torch.Tensor:
    """x_q (M, K) int8 @ w_q (K, N) int8, scaled by x_scale (M, 1) and
    w_scale (1, N): (M, N) float32. K and N must be multiples of 64."""
    _check(x_q, w_q, x_scale, w_scale)
    if x_q.device.type == "cpu":
        return ref.ref_int8_matmul(x_q, w_q, x_scale, w_scale)
    global launches
    M, K = x_q.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), device=x_q.device, dtype=torch.float32)
    lib = _build.load("int8_matmul", _SIGNATURES)
    P = _build.ptr
    _build.check(lib.int8_mm(P(x_q), P(w_q), P(x_scale), P(w_scale), P(out), M, N, K,
                             _build.stream_ptr(x_q.device)), "int8_matmul")
    launches += 1
    return out


def _check(x_q, w_q, xs, ws) -> None:
    """The kernel's input contract, checked on every device."""
    tensors = (x_q, w_q, xs, ws)
    if x_q.device.type not in ("cpu", "cuda") or any(t.device != x_q.device for t in tensors):
        raise ValueError("int8_matmul: all tensors must be on one CPU or CUDA device")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("int8_matmul: x_q and w_q must be int8")
    if xs.dtype != torch.float32 or ws.dtype != torch.float32:
        raise TypeError("int8_matmul: scales must be float32")
    M, K = x_q.shape
    if w_q.ndim != 2 or w_q.shape[0] != K or xs.shape != (M, 1) or ws.shape != (1, w_q.shape[1]):
        raise ValueError(f"int8_matmul: shapes x {tuple(x_q.shape)} w {tuple(w_q.shape)} "
                         f"xs {tuple(xs.shape)} ws {tuple(ws.shape)} do not match")
    if K % TILE_K or w_q.shape[1] % TILE_N:
        raise ValueError(f"int8_matmul: K and N must be multiples of {TILE_K}/{TILE_N}")
    if not all(t.is_contiguous() for t in tensors) or x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul: operands must be contiguous and 16-byte aligned")
