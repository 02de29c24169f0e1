"""Layout wrappers around the kernels: the verify attention and the W8A8 matmul.

``verify_attention`` is the verification hot spot: the flash-decode
partials over the committed cache merged with the staged-tree partials by
logsumexp — one softmax over [cache ++ tree], as the reference's
``kernels/ops.py::verify_attention`` and ``ref.ref_verify_attention``
compute it. On the card the merge runs inside the flash-decode combine
pass. ``paged_verify_attention`` is its block-paged twin: the cache
partials come from the paged kernel, which reads the pool through the page
table in place. The reference's 128-lane head-dim padding and its pool
transpose to the Pallas layout are TPU artifacts and are not carried over.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode import flash_decode_merge, flash_decode_paged_merge
from repro_torch.kernels.int8_matmul import TILE_K, TILE_N, int8_matmul, quantize_cols, quantize_rows
from repro_torch.kernels.tree_attention import tree_attention_partial


def _rows(q: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, T, H, hd) -> (B, KV, rep * T, hd), rows ordered r * T + t per
    (batch, kv-head), contiguous."""
    B, T, H, hd = q.shape
    rep = H // KV
    return q.reshape(B, T, KV, rep, hd).permute(0, 2, 3, 1, 4).reshape(B, KV, rep * T, hd).contiguous()


def _unrows(out: torch.Tensor, T: int) -> torch.Tensor:
    B, KV, R, hd = out.shape
    rep = R // T
    return out.reshape(B, KV, rep, T, hd).permute(0, 3, 1, 2, 4).reshape(B, T, KV * rep, hd)


def verify_attention(
    q: torch.Tensor,         # (B, T, H, hd) staged queries
    k_cache: torch.Tensor,   # (B, S, KV, hd)
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,    # (B, S) int32 (-1 invalid)
    q_pos: torch.Tensor,     # (B, T) int32
    k_new: torch.Tensor,     # (B, T, KV, hd)
    v_new: torch.Tensor,
    tree_mask: torch.Tensor,  # (B, T, T) bool (incl. positional validity)
    *,
    kind: str = "causal",
    window: int = 0,
    sink: int = 0,
) -> torch.Tensor:
    """Returns (B, T, H, hd) float32."""
    T, hd = q.shape[1], q.shape[3]
    KV = k_cache.shape[2]
    # the caches are read through transposed views, never copied
    qr = _rows(q, KV)
    qp_rows = q_pos.repeat(1, qr.shape[2] // T)                # (B, rep*T)
    scale = hd ** -0.5
    tree = tree_attention_partial(qr, k_new.transpose(1, 2), v_new.transpose(1, 2),
                                  tree_mask.contiguous(), scale=scale)
    out = flash_decode_merge(qr, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                             kv_pos.contiguous(), qp_rows, tree, kind=kind, window=window,
                             sink=sink, scale=scale)
    return _unrows(out, T)


def paged_verify_attention(
    q: torch.Tensor,           # (B, T, H, hd) staged queries
    k_pages: torch.Tensor,     # (NP, P, KV, hd) shared pool, model layout
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, n_pp) int32 (-1 unallocated)
    kv_pos: torch.Tensor,      # (B, n_pp * P) int32 (-1 invalid)
    q_pos: torch.Tensor,       # (B, T) int32
    k_new: torch.Tensor,       # (B, T, KV, hd)
    v_new: torch.Tensor,
    tree_mask: torch.Tensor,   # (B, T, T) bool (incl. positional validity)
    *,
    kind: str = "causal",
    window: int = 0,
    sink: int = 0,
    live: Optional[int] = None,
) -> torch.Tensor:
    """Block-paged twin of ``verify_attention``: the same tree partials and
    merge, the cache partials from the paged kernel. ``live`` (default: the
    table's span) is the live length the kernel splits by. Returns
    (B, T, H, hd) float32."""
    T, hd = q.shape[1], q.shape[3]
    qr = _rows(q, k_pages.shape[2])
    qp_rows = q_pos.repeat(1, qr.shape[2] // T)
    scale = hd ** -0.5
    tree = tree_attention_partial(qr, k_new.transpose(1, 2), v_new.transpose(1, 2),
                                  tree_mask.contiguous(), scale=scale)
    out = flash_decode_paged_merge(qr, k_pages, v_pages, page_table.contiguous(),
                                   kv_pos.contiguous(), qp_rows, tree, kind=kind,
                                   window=window, sink=sink, scale=scale, live=live)
    return _unrows(out, T)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """W8A8 dynamic-quantized x (M, K) @ w (K, N) -> (M, N) float32. K and
    N are zero-padded to the kernel's tile (a no-op at the model widths)."""
    M0, K0 = x.shape
    N0 = w.shape[1]
    x_q, xs = quantize_rows(x)
    w_q, ws = quantize_cols(w)
    pk, pn = -K0 % TILE_K, -N0 % TILE_N
    if pk or pn:
        x_q = F.pad(x_q, (0, pk))
        w_q = F.pad(w_q, (0, pn, 0, pk))
        ws = F.pad(ws, (0, pn), value=1.0)
    return int8_matmul(x_q, w_q, xs, ws)[:, :N0]
