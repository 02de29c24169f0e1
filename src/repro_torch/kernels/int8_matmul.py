"""W8A8 dynamic-quantized matmul (``csrc/int8_matmul.cu``).

Counterpart of the reference's ``kernels/int8_matmul.py``: activations get
per-row symmetric int8, weights per-column int8 (``quantize_rows`` /
``quantize_cols``, plain torch, bit-equal to the reference's jnp: the same
float32 division and round-half-to-even), and ``int8_matmul`` runs the
int8 x int8 -> int32 product with the ``x_scale * w_scale`` epilogue.

On CPU tensors ``int8_matmul`` computes the plain version
(``kernels/ref.py::ref_int8_matmul``); on CUDA tensors it launches the
kernel or raises. The kernel splits K across CTAs (``plan``, ``k_range``)
and adds the int32 partial sums exactly, so it equals the exact product bit
for bit; the reference kernel's per-tile float32 accumulation differs from
both by float32 rounding only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0

TILE_K = 64           # int8_matmul.cu: BK, the K granularity
TILE_N = 64           # the N granularity (a 128-column strip may end half way)
STRIP = 128           # int8_matmul.cu: BN, the columns of one CTA
ROW_TILES = (16, 32, 64)
CTAS_PER_SM = 3       # int8_matmul.cu: CTAS_PER_SM, resident CTAs per SM
MAX_SPLITS = 16       # int8_matmul.cu: MAX_SPLITS, the largest cluster
MIN_SPLIT_TILES = 2   # K tiles a split takes at least, where K allows
MAX_K = 133_000       # 127 * 127 * K < 2**31: the int32 sums cannot overflow
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"int8_mm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
               "int8_mm_max_clusters": [_I, _I, ctypes.POINTER(ctypes.c_int)]}


def plan(M: int, K: int, N: int, clusters: Callable[[int, int], int]) -> Tuple[int, int]:
    """(row tile, split count) of a launch: the smallest row tile that covers
    M (64 and several tiles above it), and the most K splits, up to
    ``MAX_SPLITS`` and with at least ``MIN_SPLIT_TILES`` K tiles each, for
    which one wave holds every (row tile, strip) cluster. ``clusters(bm,
    splits)`` is how many clusters of ``splits`` CTAs the card holds."""
    bm = next((b for b in ROW_TILES if M <= b), ROW_TILES[-1])
    items = -(-M // bm) * -(-N // STRIP)
    most = min(MAX_SPLITS, (K // TILE_K) // MIN_SPLIT_TILES)
    fits = [s for s in range(2, most + 1) if items <= clusters(bm, s)]
    return bm, max(fits, default=1)


def k_range(split: int, splits: int, k_tiles: int) -> Tuple[int, int]:
    """K tiles [begin, end) of split ``split`` (the kernel's own formula)."""
    return split * k_tiles // splits, (split + 1) * k_tiles // splits


@functools.lru_cache(maxsize=256)
def card_plan(M: int, K: int, N: int, index: int) -> Tuple[int, int]:
    """``plan`` with the clusters that CUDA device ``index`` reports it holds."""
    return plan(M, K, N, functools.partial(_card_clusters, index))


@functools.lru_cache(maxsize=None)
def _card_clusters(index: int, bm: int, splits: int) -> int:
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        lib = _build.load("int8_matmul", _SIGNATURES)
        _build.check(lib.int8_mm_max_clusters(bm, splits, ctypes.byref(count)), "int8_matmul")
    return count.value


def quantize_rows(x: torch.Tensor, reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (x_int8 (M, K), scale (M, 1) float32).
    ``reduce`` maps the rows' abs-max to the whole row's where K is
    sharded (a MAX over the shards), so the scale is the unsharded one."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax if reduce is None else reduce(amax), 1e-8) / 127.0
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def quantize_cols(w: torch.Tensor, reduce=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8: (w_int8 (K, N), scale (1, N) float32);
    ``reduce`` as in ``quantize_rows``, for a weight sharded on K."""
    w32 = w.float()
    amax = w32.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp_min(amax if reduce is None else reduce(amax), 1e-8) / 127.0
    return torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8), scale


def int8_matmul(x_q, w_q, x_scale, w_scale) -> torch.Tensor:
    """x_q (M, K) int8 @ w_q (K, N) int8, scaled by x_scale (M, 1) and
    w_scale (1, N): (M, N) float32. K and N must be multiples of 64."""
    _check(x_q, w_q, x_scale, w_scale)
    if x_q.device.type == "cpu":
        return ref.ref_int8_matmul(x_q, w_q, x_scale, w_scale)
    bm, splits = card_plan(*x_q.shape, w_q.shape[1], x_q.device.index)
    return _launch(x_q, w_q, x_scale, w_scale, bm, splits)


def _launch(x_q, w_q, x_scale, w_scale, bm: int, splits: int) -> torch.Tensor:
    """Launch the kernel with row tile ``bm`` and ``splits`` K ranges (one
    cluster per row tile and strip) on checked CUDA operands."""
    global launches
    M, K = x_q.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), device=x_q.device, dtype=torch.float32)
    lib = _build.load("int8_matmul", _SIGNATURES)
    P = _build.ptr
    _build.check(lib.int8_mm(P(x_q), P(w_q), P(x_scale), P(w_scale), P(out), M, N, K, bm, splits,
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
    if K % TILE_K or w_q.shape[1] % TILE_N or K > MAX_K:
        raise ValueError(f"int8_matmul: K and N must be multiples of {TILE_K}/{TILE_N}, "
                         f"K at most {MAX_K}")
    if not all(t.is_contiguous() for t in tensors) or x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul: operands must be contiguous and 16-byte aligned")
