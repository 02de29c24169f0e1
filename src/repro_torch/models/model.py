"""Decoder assembly, attention-only subset: layout, init, prefill, decode, commit.

Layouts are the reference's (``src/repro/models/model.py``), so that params
and caches convert one-to-one (``repro_torch.bridge``):
  - params are stacked per segment of repeated units: ``params["segments"]``
    is a list over segments of a list over the unit's layers of dicts whose
    leaves carry a leading ``repeats`` axis;
  - the KV cache is ``{"pos": (B,) int32, "segments": [[{"k", "v"}]]}`` with
    ``k``/``v`` of shape ``(R, B, S, KV, hd)``.
Layers run one at a time over views of those stacks (PyTorch runs eagerly:
there is no scan to lower).

Cache semantics: stage-then-commit. ``decode_step`` never writes the cache;
it returns logits plus per-layer staged K/V, and ``commit_cache`` writes
the accepted path afterwards. Unlike the reference, whose arrays are
immutable, ``prefill`` and ``commit_cache`` update the cache tensors in
place (a 32-layer vicuna-7b cache is gigabytes) and return the cache dict
with its new ``pos``.

DSIA layer gating: every entry point takes ``gates``, a (num_layers,) 0/1
vector; a gated-off layer adds nothing to the residual stream. The engine's
``slice`` execution passes ``layer_ids`` instead: only those layers of a
homogeneous stack run, over views of the target's params and cache.

Off this slice (they raise): paged caches, MoE and SSM blocks, codebook
and image inputs, context-parallel ``seq_axes`` and carried staged KV.
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


def _check_dense(cache: Cache) -> None:
    if "page_table" in cache:
        raise NotImplementedError("paged KV caches are not ported yet")


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
def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    *,
    ring_window: bool = False,
    dtype=None,
    paged: bool = False,
    device="cuda",
) -> Cache:
    """Allocate a dense committed cache. ``ring_window`` stores only
    ``sliding_window`` slots (a ring buffer) for sliding layers."""
    if paged:
        raise NotImplementedError("paged KV caches are not ported yet")
    _check_stack(cfg)
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim()
    segs = []
    for seg in layout(cfg):
        unit_caches = []
        for spec in seg.unit:
            S_c = (min(cfg.sliding_window, max_len)
                   if (ring_window and spec.attn is AttentionKind.SLIDING) else max_len)
            shape = (seg.repeats, batch, S_c, cfg.num_kv_heads, hd)
            unit_caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                                "v": torch.zeros(shape, dtype=dtype, device=dev)})
        segs.append(unit_caches)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev), "segments": segs}


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
    staged_segments = []
    for si, seg in enumerate(segs):
        p_seg, c_seg = params["segments"][si], cache["segments"][si]
        U = len(seg.unit)
        staged = [{"k": [], "v": []} for _ in seg.unit]
        repeats = range(seg.repeats) if layer_ids is None else layer_ids
        for r in repeats:
            for u, spec in enumerate(seg.unit):
                p_l = tree_map(lambda a, r=r: a[r], p_seg[u])          # views
                lc = {"k": c_seg[u]["k"][r], "v": c_seg[u]["v"][r], "_pos": cache["pos"],
                      "_live": live}
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
    _check_dense(cache)
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
    _check_dense(cache)
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
    rejected rows and the rest of the cache are left untouched.
    """
    _check_dense(cache)
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
