"""GQA attention: the prefill path and the cache + staged-draft decode path.

Layouts (the reference's):
  q/k/v activations: (B, S, H, hd) / (B, S, KV, hd)
  KV cache:          (B, S_cache, KV, hd)
  paged KV cache:    pool (NP, P, KV, hd) + page table (B, n_pp)

Mask kinds:
  causal     — kv_pos <= q_pos
  window     — causal and kv_pos > q_pos - window
  streaming  — causal and (kv_pos < sink or kv_pos > q_pos - window)  [StreamingLLM]

Masked scores are NEG_INF = -1e30, never -inf, and every denominator is
clamped to max(l, 1e-30): a row with no visible key stays finite.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ops import paged_verify_attention, verify_attention
from repro_torch.kernels.ref import NEG_INF, visible
from repro_torch.models import shard_utils as SU


def blockwise_attention(
    q: torch.Tensor,           # (B, Tq, H, hd)
    k: torch.Tensor,           # (B, Tk, KV, hd)
    v: torch.Tensor,           # (B, Tk, KV, hd)
    q_pos: torch.Tensor,       # (Tq,) int32
    kv_pos: torch.Tensor,      # (Tk,) int32
    *,
    kind: str = "causal",
    window: int = 0,
    sink: int = 0,
    chunk_q: int = 512,
) -> torch.Tensor:
    """Causal/window attention for prefill, plain torch (the reference runs
    it as jnp outside any kernel); query chunks bound the score memory.
    Mirrors the reference's numerics: q scaled in its own dtype, scores and
    sums in float32, probabilities rounded to the input dtype before the
    value product. Returns (B, Tq, H, hd)."""
    B, Tq, H, hd = q.shape
    rep = H // k.shape[2]
    scale = hd ** -0.5
    kx = k.repeat_interleave(rep, dim=2).float()            # KV is the major factor of H
    vx = v.repeat_interleave(rep, dim=2).float()
    outs = []
    for i in range(0, Tq, chunk_q):
        qi = (q[:, i:i + chunk_q] * scale).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qi, kx)
        msk = visible(q_pos[i:i + chunk_q], kv_pos, kind, window, sink)
        s = torch.where(msk, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.clamp_min(p.sum(dim=-1), 1e-30)             # (B, H, cq)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), vx)
        outs.append(o / l.transpose(1, 2)[..., None])
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(
    q: torch.Tensor,           # (B, T, H, hd) — T = draft bucket
    k_cache: torch.Tensor,     # (B, S_c, KV, hd)
    v_cache: torch.Tensor,     # (B, S_c, KV, hd)
    cache_pos,                 # (B,) int32: committed tokens per sequence
    k_new: torch.Tensor,       # (B, T, KV, hd) staged draft keys (not committed)
    v_new: torch.Tensor,       # (B, T, KV, hd)
    q_pos: torch.Tensor,       # (B, T) or (T,) absolute positions of the draft tokens
    *,
    tree_mask: Optional[torch.Tensor] = None,   # (T, T) or (B, T, T) bool mask
    kind: str = "causal",
    window: int = 0,
    sink: int = 0,
    ring: bool = False,        # cache is a ring buffer of size S_c (= window)
    seq_axes=None,
    k_staged=None,
    v_staged=None,
    staged_pos=None,
    staged_mask=None,
) -> torch.Tensor:
    """Attention of T staged tokens over [committed cache ++ staged draft].

    Returns (B, T, H, hd) in q's dtype. The cache is read-only here; the
    tree mask gives intra-draft visibility (None means chain). Both passes
    and their merge go through ``kernels.ops.verify_attention``: the
    flash-decode and tree-attention kernels on the card, their plain
    versions on the CPU. A linear cache is scanned up to the longest
    committed prefix, ``max(cache_pos)``, which the kernel reads on the
    device; a ring is scanned whole.

    Carried staged KV (``draft_kv="carry"``): ``k_staged``/``v_staged``
    (B, N_s, KV, hd) are the draft rows of earlier steps, at positions
    ``staged_pos`` (B, N_s), visible to query t where ``staged_mask`` (B,
    T, N_s) and the mask kind allow; they join the T new keys in the tree
    kernel's launch.

    ``seq_axes`` (context parallelism): on a mesh that has those axes, the
    cache holds this rank's slice of the slots, ``[i * S_c, (i + 1) *
    S_c)`` for its index i along them; each slot's ``kv_pos`` is its global
    position, the flash-decode kernel runs over the slice (up to the slice
    of the longest committed prefix), the slices' partials are combined
    across the ranks by logsumexp (``shard_utils.lse_combine``, the
    reference's l.340-350), and the staged-tree partials are merged once,
    after that combine. The queries and staged rows are the same on every
    rank. Without a mesh ``seq_axes`` is a no-op, as in the reference.
    """
    n_seq, idx = SU.seq_shard(seq_axes)
    off = idx * k_cache.shape[1]
    kv_pos, q_pos, vis, bound = _positions(q, k_cache.shape[1], cache_pos, q_pos, tree_mask,
                                           ring, kind, window, sink, offset=off)
    staged = _staged(q_pos, k_staged, v_staged, staged_pos, staged_mask, kind, window, sink)
    if n_seq:
        local = torch.clamp(bound - off, 0, k_cache.shape[1]).to(torch.int32).contiguous()
        out = verify_attention(q, k_cache, v_cache, kv_pos, q_pos, k_new, v_new, vis, kind=kind,
                               window=window, sink=sink, bound=local, seq_axes=tuple(seq_axes),
                               **staged)
        return out.to(q.dtype)
    out = verify_attention(q, k_cache, v_cache, kv_pos, q_pos, k_new, v_new, vis, kind=kind,
                           window=window, sink=sink, bound=None if ring else bound, **staged)
    return out.to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,           # (B, T, H, hd)
    k_pages: torch.Tensor,     # (NP, P, KV, hd) shared pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, n_pp) int32, -1 = unallocated
    cache_pos,                 # (B,) int32: committed tokens per sequence
    k_new: torch.Tensor,       # (B, T, KV, hd)
    v_new: torch.Tensor,
    q_pos: torch.Tensor,       # (B, T) or (T,)
    *,
    tree_mask: Optional[torch.Tensor] = None,
    kind: str = "causal",
    window: int = 0,
    sink: int = 0,
    k_staged=None,
    v_staged=None,
    staged_pos=None,
    staged_mask=None,
) -> torch.Tensor:
    """``decode_attention`` over a block-paged cache: slot s of row b is row
    s % P of pool page page_table[b, s // P], valid iff s < cache_pos[b].
    The pool is read through the table by the paged kernel, never gathered
    (the reference gathers a dense view with ``jnp.take``; the output is the
    same), up to the longest committed prefix as in ``decode_attention``;
    carried staged KV as there. Returns (B, T, H, hd) in q's dtype."""
    S = page_table.shape[1] * k_pages.shape[1]
    kv_pos, q_pos, vis, bound = _positions(q, S, cache_pos, q_pos, tree_mask, False, kind,
                                           window, sink)
    staged = _staged(q_pos, k_staged, v_staged, staged_pos, staged_mask, kind, window, sink)
    out = paged_verify_attention(q, k_pages, v_pages, page_table, kv_pos, q_pos, k_new, v_new,
                                 vis, kind=kind, window=window, sink=sink, bound=bound, **staged)
    return out.to(q.dtype)


def _staged(q_pos, k_staged, v_staged, staged_pos, staged_mask, kind, window, sink) -> dict:
    """The carried segment's arguments of ``kernels.ops.verify_attention``:
    the rows and their (B, T, N_s) visibility, the mask kind's positional
    test and'ed with ``staged_mask`` (the reference's carried pass); {}
    without carried rows."""
    given = [a is not None for a in (k_staged, v_staged, staged_pos, staged_mask)]
    if not any(given):
        return {}
    if not all(given):
        raise ValueError("k_staged requires v_staged, staged_pos and staged_mask")
    svis = visible(q_pos, staged_pos.to(torch.int32), kind, window, sink) & staged_mask
    return dict(k_staged=k_staged, v_staged=v_staged, staged_vis=svis)


def _positions(q, S_c: int, cache_pos, q_pos, tree_mask, ring: bool, kind, window, sink,
               offset: int = 0):
    """(kv_pos (B, S_c), q_pos (B, T), vis (B, T, T), cache_pos (B,)):
    int32/bool, contiguous. kv_pos is each cache slot's position (-1
    invalid), the slots being ``offset + j`` (a sequence slice); vis is the
    staged tokens' positional validity and'ed with the tree mask."""
    B, T = q.shape[:2]
    dev = q.device
    cache_pos = torch.as_tensor(cache_pos, dtype=torch.int32, device=dev).broadcast_to((B,))
    q_pos = q_pos.to(torch.int32)
    if q_pos.ndim == 1:
        q_pos = q_pos[None].expand(B, T)

    slots = torch.arange(S_c, dtype=torch.int32, device=dev)[None]
    if offset:
        slots = slots + offset
    if ring:
        last = cache_pos[:, None] - 1
        p = last - torch.remainder(last - slots, S_c)   # most recent position in slot j
        kv_pos = torch.where((p >= 0) & (p <= last), p, -1)
    else:
        kv_pos = torch.where(slots < cache_pos[:, None], slots, -1)

    vis = visible(q_pos, q_pos, kind, window, sink)      # (B, T, T) positional validity
    if tree_mask is not None:
        vis = vis & (tree_mask if tree_mask.ndim == 3 else tree_mask[None])
    return (kv_pos.to(torch.int32).contiguous(), q_pos.contiguous(), vis.contiguous(),
            cache_pos.contiguous())
