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

``quantized_matmul`` is the W8A8 product of the ActivationQuant DSIA. It
takes a float weight, quantized on every call as the reference does, or a
``QuantWeight`` that ``prequantize`` made once (a cascade level's MLP
weights, quantized when its draft bank is built): then only the activation
rows are quantized per call. ``quantize_cols`` is deterministic, so both
give the same product bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode import (
    flash_decode_merge,
    flash_decode_paged_merge,
    flash_decode_partial,
)
from repro_torch.kernels.int8_matmul import TILE_K, TILE_N, int8_matmul, quantize_cols, quantize_rows
from repro_torch.kernels.ref import merge_partials
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


def _staged_partials(qr, k_new, v_new, tree_mask, k_staged, v_staged, staged_vis, scale):
    """The tree kernel's partials over [carried ++ new] staged rows (the
    carried segment only when ``k_staged`` is given), read through
    transposed views."""
    seg2 = {}
    if k_staged is not None:
        seg2 = dict(k_staged=k_staged.transpose(1, 2), v_staged=v_staged.transpose(1, 2),
                    staged_mask=staged_vis.contiguous())
    return tree_attention_partial(qr, k_new.transpose(1, 2), v_new.transpose(1, 2),
                                  tree_mask.contiguous(), scale=scale, **seg2)


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
    bound: Optional[torch.Tensor] = None,
    k_staged: Optional[torch.Tensor] = None,    # (B, N_s, KV, hd) carried draft KV
    v_staged: Optional[torch.Tensor] = None,
    staged_vis: Optional[torch.Tensor] = None,  # (B, T, N_s) bool (incl. positional validity)
    seq_axes: Optional[tuple] = None,           # the cache is this rank's sequence slice
) -> torch.Tensor:
    """Returns (B, T, H, hd) float32. ``bound`` (B,) int32, the committed
    lengths: the kernel scans the cache up to their maximum, read on the
    device (``kernels/flash_decode.py``); None scans all S slots. With
    ``k_staged``, the carried rows join the staged tokens in the tree
    kernel's one launch (one softmax over [cache ++ carried ++ staged]).

    ``seq_axes`` (context parallelism on the active mesh): the cache is
    one sequence slice a rank; the flash-decode kernel's partials over it
    (``flash_decode_partial``) are combined across the ranks of
    ``seq_axes`` by logsumexp, then merged with the tree partials."""
    T, hd = q.shape[1], q.shape[3]
    KV = k_cache.shape[2]
    # the caches are read through transposed views, never copied
    qr = _rows(q, KV)
    qp_rows = q_pos.repeat(1, qr.shape[2] // T)                # (B, rep*T)
    scale = hd ** -0.5
    tree = _staged_partials(qr, k_new, v_new, tree_mask, k_staged, v_staged, staged_vis, scale)
    if seq_axes:
        part = flash_decode_partial(qr, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                                    kv_pos.contiguous(), qp_rows, kind=kind, window=window,
                                    sink=sink, scale=scale, bound=bound)
        from repro_torch.models import shard_utils as SU   # models import this module
        return _unrows(merge_partials(SU.lse_combine(*part, seq_axes), tree), T)
    out = flash_decode_merge(qr, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                             kv_pos.contiguous(), qp_rows, tree, kind=kind, window=window,
                             sink=sink, scale=scale, bound=bound)
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
    bound: Optional[torch.Tensor] = None,
    k_staged: Optional[torch.Tensor] = None,
    v_staged: Optional[torch.Tensor] = None,
    staged_vis: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Block-paged twin of ``verify_attention``: the same tree partials
    (carried segment included) and merge, the cache partials from the paged
    kernel, scanning the table's span up to ``bound``'s maximum as
    ``verify_attention`` does. Returns (B, T, H, hd) float32."""
    T, hd = q.shape[1], q.shape[3]
    qr = _rows(q, k_pages.shape[2])
    qp_rows = q_pos.repeat(1, qr.shape[2] // T)
    scale = hd ** -0.5
    tree = _staged_partials(qr, k_new, v_new, tree_mask, k_staged, v_staged, staged_vis, scale)
    out = flash_decode_paged_merge(qr, k_pages, v_pages, page_table.contiguous(),
                                   kv_pos.contiguous(), qp_rows, tree, kind=kind,
                                   window=window, sink=sink, scale=scale, bound=bound)
    return _unrows(out, T)


@dataclasses.dataclass(frozen=True)
class QuantWeight:
    """A (K, N) weight quantized once for the W8A8 kernel: ``w_q`` (K', N')
    int8 per-column symmetric and ``ws`` (1, N') float32 column scales, zero-
    and one-padded to the kernel's tile; ``n`` is the unpadded N."""
    w_q: torch.Tensor
    ws: torch.Tensor
    n: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.w_q, self.ws))


def _group_max(k_axes):
    """The MAX over the mesh axes ``k_axes`` (None: no reduction)."""
    if k_axes is None:
        return None
    from repro_torch.models import shard_utils as SU   # models import this module
    return lambda a: SU.all_max(a, k_axes)


def prequantize(w: torch.Tensor, *, k_axes=None) -> QuantWeight:
    """``quantized_matmul``'s weight half, once: per-column int8 and its
    scales, padded to the kernel's tile. ``k_axes``: the mesh axes K is
    sharded on (a row-parallel weight): each column's scale is then the
    whole column's, a MAX over those ranks, so the int8 shard is the
    unsharded weight's rows bit for bit."""
    K0, N0 = w.shape
    w_q, ws = quantize_cols(w, _group_max(k_axes))
    pk, pn = -K0 % TILE_K, -N0 % TILE_N
    if pk or pn:
        w_q = F.pad(w_q, (0, pn, 0, pk))
        ws = F.pad(ws, (0, pn), value=1.0)
    return QuantWeight(w_q.contiguous(), ws.contiguous(), N0)


def quantized_matmul(x: torch.Tensor, w: Union[torch.Tensor, QuantWeight], *,
                     k_axes=None) -> torch.Tensor:
    """W8A8 dynamic-quantized x (M, K) @ w (K, N) -> (M, N) float32: x per
    row, w per column (every call for a float ``w``; a ``QuantWeight`` was
    quantized once). K and N are zero-padded to the kernel's tile (a no-op
    at the model widths). ``k_axes``: K is sharded on those mesh axes (a
    row-parallel product, ``prequantize``): the row scales are the whole
    rows' (a MAX over the ranks) and the result is this rank's partial
    product, for the caller's sum."""
    qw = w if isinstance(w, QuantWeight) else prequantize(w, k_axes=k_axes)
    x_q, xs = quantize_rows(x, _group_max(k_axes))
    pk = qw.w_q.shape[0] - x.shape[1]
    if pk:
        x_q = F.pad(x_q, (0, pk))
    return int8_matmul(x_q, qw.w_q, xs, qw.ws)[:, :qw.n]
