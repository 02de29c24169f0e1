"""Decoder assembly, attention-only subset: layout, init, prefill, decode, commit.

Layouts are the reference's (``src/repro/models/model.py``), so that params
and caches convert one-to-one (``repro_torch.bridge``):
  - params are stacked per segment of repeated units: ``params["segments"]``
    is a list over segments of a list over the unit's layers of dicts whose
    leaves carry a leading ``repeats`` axis;
  - the KV cache is ``{"pos": (B,) int32, "segments": [[{"k", "v"}]]}`` with
    ``k``/``v`` of shape ``(R, B, S, KV, hd)``; a block-paged cache holds
    one shared pool per layer, ``k_pages``/``v_pages`` of shape
    ``(R, NP, P, KV, hd)``, and a top-level ``page_table`` (B, max_len // P)
    int32 (-1 = unallocated): position t of slot b lives at row t % P of
    page ``page_table[b, t // P]``.
Layers run one at a time over views of those stacks (PyTorch runs eagerly:
there is no scan to lower).

Cache semantics: stage-then-commit. ``decode_step`` never writes the cache;
it returns logits plus per-layer staged K/V, and ``commit_cache`` writes
the accepted path afterwards. Unlike the reference, whose arrays are
immutable, ``prefill``, ``write_slot`` and ``commit_cache`` update the
cache tensors in place (a 32-layer vicuna-7b cache is gigabytes) and return
the cache dict with its new ``pos``. Paged caches are written by
``write_slot`` (admission: a dense B=1 prefill cache scattered through the
slot's table row) and ``commit_cache``, never by ``prefill``.

DSIA layer gating: every entry point takes ``gates``, a (num_layers,) 0/1
vector; a gated-off layer adds nothing to the residual stream. The engine's
``slice`` execution passes ``layer_ids`` instead: only those layers of a
homogeneous stack run, over views of the target's params and cache.

Off the port so far (they raise): MoE and SSM blocks, codebook and image
inputs, context-parallel ``seq_axes`` and carried staged KV.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config.base import AttentionKind, BlockKind, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_rope, embed_tokens, mlp_apply, rms_norm, unembed

Cache = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


# ===================================================================== layout
@dataclasses.dataclass(frozen=True)
class LayerSpec:
    block: BlockKind
    attn: AttentionKind
    is_moe: bool
    has_mlp: bool


@dataclasses.dataclass(frozen=True)
class Segment:
    start: int
    repeats: int
    unit: Tuple[LayerSpec, ...]


def _layer_spec(cfg: ModelConfig, i: int) -> LayerSpec:
    return LayerSpec(
        block=cfg.block_kind(i),
        attn=cfg.attention_kind(i),
        is_moe=cfg.is_moe_layer(i) and cfg.has_mlp(i),
        has_mlp=cfg.has_mlp(i),
    )


def layout(cfg: ModelConfig) -> List[Segment]:
    """Partition layers into segments of repeated units."""
    specs = [_layer_spec(cfg, i) for i in range(cfg.num_layers)]
    n = cfg.num_layers
    for u in range(1, n + 1):
        if all(specs[i] == specs[i % u] for i in range(n - n % u)):
            reps = n // u
            segs = [Segment(0, reps, tuple(specs[:u]))]
            if n % u:
                segs.append(Segment(reps * u, 1, tuple(specs[reps * u:])))
            return segs
    return [Segment(0, 1, tuple(specs))]


def _check_stack(cfg: ModelConfig) -> None:
    """This slice ports the attention-only dense text stack."""
    for i in range(cfg.num_layers):
        if cfg.block_kind(i) is not BlockKind.ATTENTION:
            raise NotImplementedError(f"layer {i}: SSM (mamba) blocks are not ported yet")
        if cfg.is_moe_layer(i):
            raise NotImplementedError(f"layer {i}: MoE blocks are not ported yet")
    if cfg.num_codebooks or cfg.num_image_tokens:
        raise NotImplementedError("codebook and image inputs are not ported yet")


# ======================================================================= init
def _normal(gen, shape, scale, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random params in the reference's layout, shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from the reference's ``jax.random`` draws; the bridge
    carries the reference's own params across when they must agree)."""
    _check_stack(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, V, H, KV = cfg.d_model, cfg.padded_vocab, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim()
    params: dict = {
        "embed": _normal(gen, (V, d), d ** -0.5, dtype, dev),
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (d, V), d ** -0.5, dtype, dev)
    segs = []
    for seg in layout(cfg):
        R = seg.repeats
        unit = []
        for spec in seg.unit:
            p = {
                "norm1": torch.zeros((R, d), dtype=dtype, device=dev),
                "attn": {
                    "wq": _normal(gen, (R, d, H, hd), d ** -0.5, dtype, dev),
                    "wk": _normal(gen, (R, d, KV, hd), d ** -0.5, dtype, dev),
                    "wv": _normal(gen, (R, d, KV, hd), d ** -0.5, dtype, dev),
                    "wo": _normal(gen, (R, H, hd, d), (H * hd) ** -0.5, dtype, dev),
                },
            }
            if spec.has_mlp:
                p["norm2"] = torch.zeros((R, d), dtype=dtype, device=dev)
                p["mlp"] = {
                    "w_up": _normal(gen, (R, d, cfg.d_ff), d ** -0.5, dtype, dev),
                    "w_down": _normal(gen, (R, cfg.d_ff, d), cfg.d_ff ** -0.5, dtype, dev),
                }
                if cfg.mlp_gated:
                    p["mlp"]["w_gate"] = _normal(gen, (R, d, cfg.d_ff), d ** -0.5, dtype, dev)
            unit.append(p)
        segs.append(unit)
    params["segments"] = segs
    return params


# ====================================================================== cache
def pages_for(max_len: int, page_size: int) -> int:
    """Pages spanning ``max_len`` tokens (the page-table width per slot)."""
    return -(-max_len // page_size)


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    *,
    ring_window: bool = False,
    dtype=None,
    paged: bool = False,
    page_size: int = 64,
    num_pages: Optional[int] = None,
    device="cuda",
) -> Cache:
    """Allocate a committed cache. ``ring_window`` stores only
    ``sliding_window`` slots (a ring buffer) for sliding layers.

    ``paged=True`` allocates one shared pool of ``num_pages`` pages of
    ``page_size`` tokens per layer (default: ``batch * max_len / page_size``,
    the dense capacity) and a page table of -1; ``max_len`` must be a
    multiple of ``page_size``, and ring caches page nothing."""
    _check_stack(cfg)
    if paged:
        if ring_window:
            raise ValueError("paged caches do not support ring_window")
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} must be a multiple of page_size={page_size}")
        if num_pages is None:
            num_pages = batch * pages_for(max_len, page_size)
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim()
    segs = []
    for seg in layout(cfg):
        unit_caches = []
        for spec in seg.unit:
            if paged:
                shape = (seg.repeats, num_pages, page_size, cfg.num_kv_heads, hd)
                names = ("k_pages", "v_pages")
            else:
                S_c = (min(cfg.sliding_window, max_len)
                       if (ring_window and spec.attn is AttentionKind.SLIDING) else max_len)
                shape = (seg.repeats, batch, S_c, cfg.num_kv_heads, hd)
                names = ("k", "v")
            unit_caches.append({n: torch.zeros(shape, dtype=dtype, device=dev) for n in names})
        segs.append(unit_caches)
    out = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev), "segments": segs}
    if paged:
        out["page_table"] = torch.full((batch, pages_for(max_len, page_size)), -1,
                                       dtype=torch.int32, device=dev)
    return out


# ================================================================ layer bodies
def _attn_layer(
    cfg: ModelConfig,
    p: dict,
    spec: LayerSpec,
    h: torch.Tensor,                 # (B, T, d)
    q_pos: torch.Tensor,             # (T,) or (B, T)
    mode: str,
    layer_cache: Optional[dict],
    tree_mask: Optional[torch.Tensor],
    attn_override: Optional[dict],
) -> Tuple[torch.Tensor, dict]:
    """Returns (residual delta before the gate, staged {"k", "v"})."""
    B, T, d = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    x = rms_norm(h, p["norm1"], cfg.norm_eps)
    a = p["attn"]
    q = (x @ a["wq"].reshape(d, H * hd)).reshape(B, T, H, hd)
    k = (x @ a["wk"].reshape(d, KV * hd)).reshape(B, T, KV, hd)
    v = (x @ a["wv"].reshape(d, KV * hd)).reshape(B, T, KV, hd)
    rope_pos = q_pos[None, :] if q_pos.ndim == 1 else q_pos
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)

    kind = {AttentionKind.FULL: "causal", AttentionKind.SLIDING: "window"}[spec.attn]
    window, sink = cfg.sliding_window, 0
    if attn_override is not None and spec.attn is AttentionKind.FULL:
        # efficient-attention DSIA applies to full-attention layers only
        kind = attn_override["kind"]
        window = attn_override["window"]
        sink = attn_override.get("sink", 0)

    if mode == "prefill":
        o = attn_lib.blockwise_attention(q, k, v, q_pos, q_pos, kind=kind, window=window,
                                         sink=sink)
    elif "k_pages" in layer_cache:
        # the table holds the live pages only (see _run_stack); the paged
        # kernel reads the pool through it in place
        o = attn_lib.paged_decode_attention(
            q, layer_cache["k_pages"], layer_cache["v_pages"], layer_cache["_table"],
            layer_cache["_pos"], k, v, q_pos, tree_mask=tree_mask, kind=kind, window=window,
            sink=sink, live=layer_cache["_live"],
        )
    else:
        k_c, v_c = layer_cache["k"], layer_cache["v"]
        ring = spec.attn is AttentionKind.SLIDING and k_c.shape[1] <= window
        if not ring:
            # read only the live prefix: slots at or past pos are invalid for
            # every row (kv_pos = -1), and every query row sees at least
            # itself, so they add exactly zero to its softmax
            k_c, v_c = k_c[:, : layer_cache["_live"]], v_c[:, : layer_cache["_live"]]
        o = attn_lib.decode_attention(
            q, k_c, v_c, layer_cache["_pos"], k, v, q_pos,
            tree_mask=tree_mask, kind=kind, window=window, sink=sink, ring=ring,
        )
    out = o.reshape(B, T, H * hd) @ a["wo"].reshape(H * hd, d)
    return out, {"k": k, "v": v}


def _host_gates(gates, n: int) -> List[float]:
    if gates is None:
        return [1.0] * n
    g = torch.as_tensor(gates).detach().cpu().reshape(-1).tolist()
    if len(g) != n:
        raise ValueError(f"gates has {len(g)} entries for {n} layers")
    return [float(x) for x in g]


def _gated(delta: torch.Tensor, gate: float) -> torch.Tensor:
    # delta * 1 == delta exactly, so the multiply is skipped for open gates
    return delta if gate == 1.0 else delta * gate


def _run_stack(
    cfg: ModelConfig,
    params: dict,
    h: torch.Tensor,
    *,
    mode: str,
    cache: Cache,
    gates,
    q_pos: torch.Tensor,
    tree_mask: Optional[torch.Tensor],
    attn_override: Optional[dict] = None,
    quantize: Optional[str] = None,
    layer_ids: Optional[Sequence[int]] = None,
):
    """Returns (hidden, staged segments: [[{"k","v"}: (R_run, B, T, KV, hd)]])."""
    _check_stack(cfg)
    segs = layout(cfg)
    g_host = _host_gates(gates, cfg.num_layers)
    if layer_ids is not None and (len(segs) != 1 or len(segs[0].unit) != 1):
        raise ValueError("layer_ids requires a homogeneous layer stack")
    # longest committed prefix over the batch (one host read per call)
    live = max(int(cache["pos"].max()), 1) if mode == "decode" else 0
    table = cache.get("page_table")
    if table is not None and mode == "decode":
        # a paged cache reads the pages that hold the live prefix
        page_size = cache["segments"][0][0]["k_pages"].shape[2]
        table = table[:, : -(-live // page_size)].contiguous()
    staged_segments = []
    for si, seg in enumerate(segs):
        p_seg, c_seg = params["segments"][si], cache["segments"][si]
        U = len(seg.unit)
        staged = [{"k": [], "v": []} for _ in seg.unit]
        repeats = range(seg.repeats) if layer_ids is None else layer_ids
        for r in repeats:
            for u, spec in enumerate(seg.unit):
                p_l = tree_map(lambda a, r=r: a[r], p_seg[u])          # views
                lc = {n: a[r] for n, a in c_seg[u].items()}
                lc.update(_pos=cache["pos"], _live=live, _table=table)
                gate = g_host[seg.start + r * U + u]
                delta, st = _attn_layer(cfg, p_l, spec, h, q_pos, mode, lc, tree_mask,
                                        attn_override)
                h = h + _gated(delta, gate)
                if spec.has_mlp:
                    x = rms_norm(h, p_l["norm2"], cfg.norm_eps)
                    y = mlp_apply(p_l["mlp"], x, cfg.act, cfg.mlp_gated, quantize=quantize)
                    h = h + _gated(y, gate)
                staged[u]["k"].append(st["k"])
                staged[u]["v"].append(st["v"])
        staged_segments.append([{n: torch.stack(s[n]) for n in ("k", "v")} for s in staged])
    return h, staged_segments


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return embed_tokens(params["embed"], tokens.long())


def _head(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = unembed(h, head)
    if cfg.padded_vocab != cfg.vocab_size:
        ids = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(ids < cfg.vocab_size, logits, torch.full_like(logits, -1e30))
    return logits


# =============================================================== entry points
def prefill(
    cfg: ModelConfig,
    params: dict,
    batch: Dict[str, torch.Tensor],
    cache: Cache,
    *,
    gates=None,
) -> Tuple[torch.Tensor, Cache]:
    """Process the prompt and write it into ``cache`` (in place). Returns
    (last-token logits (B, V) float32, cache)."""
    if "page_table" in cache:
        raise NotImplementedError(
            "prefill writes a dense cache; paged serving prefills a dense B=1 cache "
            "and scatters it with write_slot"
        )
    tokens = batch["tokens"]
    h = _embed(params, tokens)
    B, S, _ = h.shape
    q_pos = torch.arange(S, dtype=torch.int32, device=h.device)
    h, staged = _run_stack(cfg, params, h, mode="prefill", cache=cache, gates=gates,
                           q_pos=q_pos, tree_mask=None)
    _write_prefill(cfg, cache, staged, S)
    logits = _head(cfg, params, h[:, -1:])
    return logits[:, 0], cache


def _write_prefill(cfg: ModelConfig, cache: Cache, staged, S: int) -> None:
    for si, seg in enumerate(layout(cfg)):
        for u in range(len(seg.unit)):
            c, st = cache["segments"][si][u], staged[si][u]
            S_c = c["k"].shape[2]
            for name in ("k", "v"):
                src = st[name].to(c[name].dtype)                   # (R, B, S, KV, hd)
                if S_c >= S:
                    c[name][:, :, :S] = src
                else:
                    # ring: keep the last S_c tokens arranged by pos % S_c
                    last = S - 1
                    slots = torch.arange(S_c, device=src.device)
                    c[name].copy_(src[:, :, last - torch.remainder(last - slots, S_c)])
    cache["pos"] = torch.full_like(cache["pos"], S)


def decode_step(
    cfg: ModelConfig,
    params: dict,
    cache: Cache,
    tokens: torch.Tensor,             # (B, T)
    *,
    gates=None,
    tree_mask: Optional[torch.Tensor] = None,   # (T, T) or (B, T, T) ancestor-or-self
    q_pos: Optional[torch.Tensor] = None,       # (T,) or (B, T) absolute positions
    attn_override: Optional[dict] = None,       # efficient-attention DSIA
    quantize: Optional[str] = None,             # "int8": W8A8 MLP matmuls (DSIA)
    layer_ids: Optional[Sequence[int]] = None,  # slice exec: run only these layers
    seq_axes=None,
    staged_kv=None,
    staged_pos=None,
    staged_mask=None,
) -> Tuple[torch.Tensor, Any]:
    """Stage-only decode of T tokens against a frozen cache.

    Returns (logits (B, T, V) float32, staged) — commit with ``commit_cache``.
    ``quantize="int8"`` runs the dense-MLP matmuls through the W8A8 kernel.
    Context-parallel ``seq_axes`` and the carried-draft-KV arguments
    (``staged_kv``/``staged_pos``/``staged_mask``) are later slices.
    """
    if seq_axes:
        raise NotImplementedError("decode_step: seq_axes is not ported yet")
    if any(a is not None for a in (staged_kv, staged_pos, staged_mask)):
        raise NotImplementedError("decode_step: carried staged KV is not ported yet")
    tokens = torch.as_tensor(tokens, device=cache["pos"].device)
    h = _embed(params, tokens)
    B, T = tokens.shape[:2]
    if q_pos is None:
        q_pos = cache["pos"][:, None] + torch.arange(T, dtype=torch.int32, device=h.device)[None]
    elif q_pos.ndim == 1:
        q_pos = q_pos[None].expand(B, T)
    h, staged = _run_stack(cfg, params, h, mode="decode", cache=cache, gates=gates,
                           q_pos=q_pos, tree_mask=tree_mask, attn_override=attn_override,
                           quantize=quantize, layer_ids=layer_ids)
    return _head(cfg, params, h), staged


def commit_cache(
    cfg: ModelConfig,
    cache: Cache,
    staged,
    path_idx,                          # (T,) or (B, T) indices into the staged T dim
    n_accept,                          # scalar or (B,) accepted count (<= T)
) -> Cache:
    """Write the accepted draft path into the cache (in place) and advance pos.

    The reference scatters with ``mode="drop"`` and a unique out-of-bounds
    destination per rejected row. Torch's ``index_put_`` has no drop mode
    (out-of-bounds indices raise on the CPU and are undefined on CUDA), so
    only the live rows — accepted and in bounds — are gathered and written:
    rejected rows and the rest of the cache are left untouched. On a paged
    cache a row is live only if its page is allocated: a -1 page is never
    written through (clamped, it would land on page 0, which another slot
    may own).
    """
    _check_stack(cfg)
    base = cache["pos"]
    B, dev = base.shape[0], base.device
    path_idx = torch.as_tensor(path_idx, device=dev).long()
    if path_idx.ndim == 1:
        path_idx = path_idx[None].expand(B, path_idx.shape[0])
    T = path_idx.shape[1]
    n_acc = torch.as_tensor(n_accept, dtype=torch.int32, device=dev).broadcast_to((B,))
    step = torch.arange(T, dtype=torch.int32, device=dev)
    live = step[None] < n_acc[:, None]                       # (B, T)
    dest = (base[:, None] + step[None]).long()
    for si, seg in enumerate(layout(cfg)):
        for u, spec in enumerate(seg.unit):
            c, st = cache["segments"][si][u], staged[si][u]
            if "k_pages" in c:
                b_i, t_i, pages, rows = _page_rows(cache["page_table"], c["k_pages"].shape[2],
                                                   dest, live)
                src = path_idx[b_i, t_i]
                for name in ("k", "v"):
                    pool = c[name + "_pages"]
                    pool[:, pages, rows] = st[name][:, b_i, src].to(pool.dtype)
                continue
            S_c = c["k"].shape[2]
            ring = S_c <= cfg.sliding_window and spec.attn is AttentionKind.SLIDING
            d = torch.remainder(dest, S_c) if ring else dest
            b_i, t_i = (live & (d < S_c)).nonzero(as_tuple=True)
            rows, src = d[b_i, t_i], path_idx[b_i, t_i]
            for name in ("k", "v"):
                c[name][:, b_i, rows] = st[name][:, b_i, src].to(c[name].dtype)
    out = dict(cache)
    out["pos"] = base + n_acc
    return out


def _page_rows(table: torch.Tensor, page_size: int, dest: torch.Tensor, live: torch.Tensor):
    """Where positions ``dest`` (B, T) of each slot live in a paged pool:
    (b_i, t_i, page, row) over the entries that are ``live`` and whose
    page is allocated — the only ones a write may touch."""
    n_pp = table.shape[1]
    logical = torch.div(dest, page_size, rounding_mode="floor")
    page = torch.gather(table, 1, logical.clamp(0, n_pp - 1))
    b_i, t_i = (live & (logical < n_pp) & (page >= 0)).nonzero(as_tuple=True)
    return b_i, t_i, page[b_i, t_i].long(), torch.remainder(dest, page_size)[b_i, t_i]


def write_slot(cfg: ModelConfig, cache: Cache, c1: Cache, slot: int) -> Cache:
    """Write a freshly prefilled dense B=1 cache ``c1`` into batch slot
    ``slot`` of ``cache`` (in place) and set the slot's ``pos``.

    ``c1`` may be shorter than the batched cache (admission sizes it to the
    prompt's bucket): its rows land at the front of the slot, and rows past
    ``c1["pos"]`` are never read (kv_pos masking). On a paged cache the rows
    go through ``page_table[slot]``, which the caller sets first; rows whose
    page is unallocated are not written.
    """
    _check_stack(cfg)
    dev = cache["pos"].device
    for si, seg in enumerate(layout(cfg)):
        for u in range(len(seg.unit)):
            dst, src = cache["segments"][si][u], c1["segments"][si][u]
            S_src = src["k"].shape[2]
            if "k_pages" in dst:
                rows = torch.arange(S_src, device=dev)[None]
                _, t_i, pages, offs = _page_rows(cache["page_table"][slot][None],
                                                 dst["k_pages"].shape[2], rows,
                                                 torch.ones_like(rows, dtype=torch.bool))
                for name in ("k", "v"):
                    pool = dst[name + "_pages"]
                    pool[:, pages, offs] = src[name][:, 0, t_i].to(pool.dtype)
                continue
            if S_src > dst["k"].shape[2]:
                raise NotImplementedError(
                    f"prefill cache seq {S_src} exceeds batched cache seq "
                    f"{dst['k'].shape[2]} (ring slots cannot take longer buckets)")
            for name in ("k", "v"):
                dst[name][:, slot, :S_src] = src[name][:, 0].to(dst[name].dtype)
    out = dict(cache)
    out["pos"] = cache["pos"].clone()
    out["pos"][slot] = c1["pos"][0]
    return out
