"""Decoder assembly: layout, init, training forward, prefill, decode,
commit, over attention and Mamba-2 blocks.

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
    page ``page_table[b, t // P]``;
  - a Mamba-2 layer's cache is its per-slot state ``{"ssm", "conv_x",
    "conv_B", "conv_C"}`` (``models/ssm.py``), each ``(R, B, ...)``; it
    stays dense in a paged cache (the reference's ``init_cache``).
Layers run one at a time over views of those stacks (PyTorch runs eagerly:
there is no scan to lower). ``forward_train`` takes its views with one
``torch.unbind`` per stacked leaf, whose backward writes the stack's
gradient once; ``remat=True`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint``).

Cache semantics: stage-then-commit. ``decode_step`` never writes the cache;
it returns logits plus per-layer staged K/V (a Mamba-2 layer: its state
after each of the T tokens), and ``commit_cache`` writes the accepted path
afterwards (a Mamba-2 layer: the state after the accepted prefix, so the
T tokens must be a chain). Unlike the reference, whose arrays are
immutable, ``prefill``, ``write_slot`` and ``commit_cache`` update the
cache tensors, ``pos`` included, in place (a 32-layer vicuna-7b cache is
gigabytes, and a captured CUDA graph reads the tensors it was captured
with) and return the same cache dict. Paged caches are written by
``write_slot`` (admission: a dense B=1 prefill cache scattered through the
slot's table row) and ``commit_cache``, never by ``prefill``.

``decode_step`` and ``commit_cache`` read no device value on the host: the
attention kernels read the live prefix (``max(pos)``) on the device, and
the commit is a scatter of fixed shape. A serving round made of them can
be captured as one CUDA graph.

DSIA layer gating: every entry point takes ``gates``, a (num_layers,) 0/1
vector; a gated-off layer adds nothing to the residual stream. The engine's
``slice`` execution passes ``layer_ids`` instead: only those layers of a
homogeneous stack run, over views of the target's params and cache.

Carried staged KV (``decode_step(staged_kv=...)``, the engine's
``draft_kv="carry"``): the T new tokens attend over [committed cache ++
carried rows ++ themselves]; the returned staged rows are the new ones.

MoE layers (``models/moe.py``) serve through the dropless dispatch and
train through the grouped-capacity one, whose auxiliary losses
``forward_train`` sums over the layers; Mamba-2 blocks (``models/ssm.py``)
run the chunked scan in prefill and training (over a fresh zero state) and
the per-token recurrence in decode.

Inputs: text tokens (B, S); a codebook stack (``num_codebooks``, musicgen)
takes (B, S, nc) codes, sums the nc codebook embeddings a position and
returns (..., nc, V) logits from nc heads; an image stack
(``num_image_tokens``, llava) splices ``batch["image_embeds"]`` (B, Ti, d)
into the first Ti positions where ``batch["image_mask"]`` is 1, in
``prefill`` and ``forward_train``.

On a mesh (``models.shard_utils.use_mesh``) every entry point runs on this
rank's shards (``init_params(mesh=)``, ``init_cache(mesh=)``,
``bridge.params_from_jax(mesh=)``; ``launch.sharding``'s spec trees): the
vocabulary, attention heads by ``attention_policy``, the MLP's and the
experts' d_ff and a Mamba-2 block's d_inner over ``model``, the slots over
the data axes where the batch divides them. The row-parallel products
(``wo``, ``w_down``, ``out_proj``) and the embedding are summed over
``model``, the logits gathered. Under the ``q`` and ``none`` policies a
dense cache is sequence-sharded over ``model`` (``cache_seq_axes``): each
rank holds a contiguous slice of the slots, and decode attention combines
the slices' partials across ranks (context parallelism). Without a mesh
none of this runs: ``seq_axes`` is then a no-op, as in the reference.
The active mesh is the one authority for the collectives: ``prefill``,
``decode_step`` and ``forward_train`` refuse params whose vocabulary rows
were cut for another ``model`` axis (``_check_placement``).
``forward_train`` on a mesh (sharded training) also takes layer-stack
leaves cut further over ``data`` (FSDP, ``launch.sharding.train_specs``):
each layer gathers its own at entry, inside its ``remat`` region, and the
collectives carry gradients (``models.shard_utils``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch import resolve_device
from repro_torch.config.base import AttentionKind, BlockKind, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import shard_utils as SU
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    Init,
    apply_rope,
    embed_tokens,
    mlp_apply,
    mlp_init,
    rms_norm,
    unembed,
)

Cache = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of nested dicts/lists/tuples (named
    tuples too)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensor leaves of nested dicts/lists/tuples, in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves``, in
    ``tree_leaves``' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


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


def has_mamba(cfg: ModelConfig) -> bool:
    """Whether any layer of the stack is a Mamba-2 block (whose per-step
    states follow one chain of tokens: no trees, no carried draft KV)."""
    return any(cfg.block_kind(i) is BlockKind.MAMBA for i in range(cfg.num_layers))



# ======================================================================= init
DRAW_CHUNK = 1 << 26            # elements drawn at once: a 256 MiB float32 temporary at most


def _layer_init(cfg: ModelConfig, spec: LayerSpec, dtype: torch.dtype) -> dict:
    """The leaves of one layer (the reference's ``_layer_init``)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    p: dict = {"norm1": Init((d,), None, dtype)}
    if spec.block is BlockKind.ATTENTION:
        p["attn"] = {
            "wq": Init((d, H, hd), d ** -0.5, dtype),
            "wk": Init((d, KV, hd), d ** -0.5, dtype),
            "wv": Init((d, KV, hd), d ** -0.5, dtype),
            "wo": Init((H, hd, d), (H * hd) ** -0.5, dtype),
        }
    else:
        p["mamba"] = ssm_lib.ssm_init(d, cfg.ssm, dtype)
    if spec.has_mlp:
        p["norm2"] = Init((d,), None, dtype)
        if spec.is_moe:
            p["moe"] = moe_lib.moe_init(d, cfg.moe, cfg.mlp_gated, dtype)
        else:
            p["mlp"] = mlp_init(d, cfg.d_ff, cfg.mlp_gated, dtype)
    return p


def _draw(t: torch.Tensor, init: Init, gen) -> None:
    """Fill ``t`` in place: a standard normal times ``init.scale``, zeros, or
    the leaf's fixed value. float32 is drawn straight into ``t``; another
    type through a float32 temporary of at most ``DRAW_CHUNK`` elements."""
    if init.fixed is not None:
        t.copy_(init.fixed(t.numel(), t.device).view(t.shape))
        return
    if init.scale is None:
        t.zero_()
        return
    for part in t.view(-1).split(DRAW_CHUNK):
        if part.dtype == torch.float32:
            part.normal_(generator=gen).mul_(init.scale)
        else:
            part.copy_(torch.randn(part.shape, generator=gen, device=part.device).mul_(init.scale))


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda", mesh=None,
                specs=None) -> dict:
    """Random params in the reference's layout, shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from the reference's ``jax.random`` draws; the bridge
    carries the reference's own params across when they must agree).
    Every stacked leaf is allocated first and drawn in place, one layer at
    a time, so the draw's peak memory is the params plus at most one
    ``DRAW_CHUNK`` temporary (none in float32). ``device="meta"`` gives the
    names and shapes alone, allocating nothing.

    ``mesh``: this rank's shards (``launch.sharding.param_specs``, or the
    spec tree ``specs``: training's is ``launch.sharding.train_specs``) of
    the very params an unsharded call draws: each layer's leaf is drawn
    whole into a temporary, in the same order, and its local slice kept."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    d, V, nc = cfg.d_model, cfg.padded_vocab, cfg.num_codebooks
    if mesh is None:
        specs = None
    else:
        from repro_torch.launch import sharding as SH
        specs = SH.param_specs(cfg, mesh) if specs is None else specs

    def local(shape, spec):
        return shape if spec is None else SH.local_shape(shape, spec, mesh)

    def draw(t, init, spec):
        """Draw ``init`` whole and keep this rank's part in ``t``."""
        if spec is None or not any(spec):
            _draw(t, init, gen)
            return
        full = torch.empty(init.shape, dtype=init.dtype, device=dev)
        _draw(full, init, gen)
        t.copy_(full[SH.local_slices(init.shape, spec, mesh, mesh.coords)])

    # a codebook stack has one embedding table and one head a codebook
    top = {"embed": Init((nc, V, d) if nc else (V, d), d ** -0.5, dtype),
           "final_norm": Init((d,), None, dtype)}
    if not cfg.tie_embeddings:
        top["lm_head"] = Init((nc, d, V) if nc else (d, V), d ** -0.5, dtype)
    params: dict = {}
    for name, init in top.items():
        spec = None if specs is None else specs[name]
        params[name] = torch.empty(local(init.shape, spec), dtype=init.dtype, device=dev)
        if gen is not None:
            draw(params[name], init, spec)
    segs = []
    for si, seg in enumerate(layout(cfg)):
        R = seg.repeats
        inits = [_layer_init(cfg, spec, dtype) for spec in seg.unit]
        lspecs = ([tree_map(lambda _: None, p) for p in inits] if specs is None
                  else specs["segments"][si])
        unit = [_alloc_stack(p, sp, R, local, dev) for p, sp in zip(inits, lspecs)]
        if gen is not None:
            for r in range(R):
                for p, init, sp in zip(unit, inits, lspecs):
                    for t, i, spec in _zip_leaves(p, init, sp):
                        draw(t[r], i, None if spec is None else spec[1:])   # no repeats dim
        segs.append(unit)
    params["segments"] = segs
    return params


def _zip_leaves(params: dict, inits: dict, specs) -> list:
    """(tensor, Init, spec) triples of one layer's trees, matched by key, in
    ``tree_leaves``' order (the draw order)."""
    if isinstance(params, dict):
        return [x for k in params for x in _zip_leaves(params[k], inits[k], specs[k])]
    return [(params, inits, specs)]


def _alloc_stack(inits: dict, specs, R: int, local, dev) -> dict:
    """Empty stacked leaves (R, *shape) of one layer's ``Init`` tree, each
    at its local shape under ``specs`` (a spec tree with the repeats dim,
    or a tree of None)."""
    if isinstance(inits, dict):
        return {k: _alloc_stack(v, specs[k], R, local, dev) for k, v in inits.items()}
    shape = (R, *inits.shape)
    return torch.empty(local(shape, specs), dtype=inits.dtype, device=dev)


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
    mesh=None,
) -> Cache:
    """Allocate a committed cache. ``ring_window`` stores only
    ``sliding_window`` slots (a ring buffer) for sliding layers.

    ``paged=True`` allocates one shared pool of ``num_pages`` pages of
    ``page_size`` tokens per attention layer (default: ``batch * max_len /
    page_size``, the dense capacity) and a page table of -1; ``max_len``
    must be a multiple of ``page_size``, and ring caches page nothing.
    A Mamba-2 layer holds its per-slot state (the SSM state float32, the
    conv tails in ``dtype``), dense either way.

    ``mesh``: this rank's shard of the cache of ``batch`` slots
    (``launch.sharding.cache_specs`` with ``global_batch=batch``): KV heads
    or sequence slots over ``model`` by the attention policy, the slots
    over the data axes where ``batch`` divides them. Ring caches are not
    sharded (they raise on a mesh)."""
    if paged:
        if ring_window:
            raise ValueError("paged caches do not support ring_window")
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} must be a multiple of page_size={page_size}")
        if num_pages is None:
            num_pages = batch * pages_for(max_len, page_size)
    if mesh is not None and ring_window:
        raise ValueError("init_cache: a ring cache (ring_window) is not sharded on a mesh")
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim()
    specs = None
    if mesh is not None:
        from repro_torch.launch import sharding as SH
        specs = SH.cache_specs(cfg, mesh, global_batch=batch, paged=paged)

    def local(shape, spec):
        return shape if specs is None else SH.local_shape(shape, spec, mesh)

    segs = []
    for si, seg in enumerate(layout(cfg)):
        unit_caches = []
        for u, spec in enumerate(seg.unit):
            if spec.block is BlockKind.MAMBA:
                # per-slot states, dense in a paged cache too
                st = ssm_lib.init_state(cfg.d_model, cfg.ssm, batch, dtype, torch.device("meta"))
                unit_caches.append({
                    n: torch.zeros(local((seg.repeats, *a.shape),
                                         None if specs is None else specs["segments"][si][u][n]),
                                   dtype=a.dtype, device=dev)
                    for n, a in st.items()})
                continue
            if paged:
                shape = (seg.repeats, num_pages, page_size, cfg.num_kv_heads, hd)
                names = ("k_pages", "v_pages")
            else:
                S_c = (min(cfg.sliding_window, max_len)
                       if (ring_window and spec.attn is AttentionKind.SLIDING) else max_len)
                shape = (seg.repeats, batch, S_c, cfg.num_kv_heads, hd)
                names = ("k", "v")
            unit_caches.append({
                n: torch.zeros(local(shape, None if specs is None else specs["segments"][si][u][n]),
                               dtype=dtype, device=dev)
                for n in names})
        segs.append(unit_caches)
    out = {"pos": torch.zeros(local((batch,), None if specs is None else specs["pos"]),
                              dtype=torch.int32, device=dev), "segments": segs}
    if paged:
        shape = (batch, pages_for(max_len, page_size))
        out["page_table"] = torch.full(local(shape, None if specs is None else specs["page_table"]),
                                       -1, dtype=torch.int32, device=dev)
    return out


def cache_seq_axes(cfg: ModelConfig, cache: Cache):
    """The mesh axes a dense cache's sequence dim is sharded on under the
    active mesh (``launch.sharding.cache_seq_axes``), or None: off-mesh, and
    for a paged pool, which shards on KV heads only."""
    mesh = SU.active_mesh()
    if mesh is None or "page_table" in cache:
        return None
    from repro_torch.launch import sharding as SH
    return SH.cache_seq_axes(cfg, mesh)


def _seq_offset(seq_axes, S_local: int) -> int:
    """The first global slot of this rank's sequence slice."""
    return SU.seq_shard(seq_axes)[1] * S_local


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
    staged_buf: Optional[dict] = None,       # {"k", "v"} (B, N_s, KV, hd) carried rows
    staged_pos: Optional[torch.Tensor] = None,
    staged_mask: Optional[torch.Tensor] = None,
    seq_axes=None,                   # mesh axes of a dense cache's sequence slices
) -> Tuple[torch.Tensor, dict]:
    """Returns (residual delta before the gate, staged {"k", "v"}). On a
    mesh the heads are this rank's (``attention_policy``): under ``q`` the
    queries are gathered to every head (K/V are replicated), attention runs
    over all of them and this rank keeps its own heads' output for ``wo``;
    the row-parallel ``wo`` product is summed over ``model``. In a training
    graph the replicated inputs of this rank's heads (``x``; under ``q``
    also K and V) sum their gradients over ``model``
    (``shard_utils.enter_shards``)."""
    B, T, d = h.shape
    hd = cfg.resolved_head_dim()
    a = p["attn"]
    H, KV = a["wq"].shape[1], a["wk"].shape[1]           # this rank's heads
    policy = (SU.attention_head_policy(cfg.num_heads, cfg.num_kv_heads)
              if SU.tensor_parallel() else None)
    x = rms_norm(h, p["norm1"], cfg.norm_eps)
    xs = SU.enter_shards(x) if policy in ("kv", "q") else x
    xkv = xs if policy == "kv" else x
    q = (xs @ a["wq"].reshape(d, H * hd)).reshape(B, T, H, hd)
    k = (xkv @ a["wk"].reshape(d, KV * hd)).reshape(B, T, KV, hd)
    v = (xkv @ a["wv"].reshape(d, KV * hd)).reshape(B, T, KV, hd)
    rope_pos = q_pos[None, :] if q_pos.ndim == 1 else q_pos
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)
    if policy == "q":
        q = SU.gather(q, 2)
        # the replicated K/V feed this rank's heads alone
        k, v = SU.enter_shards(k), SU.enter_shards(v)

    kind = {AttentionKind.FULL: "causal", AttentionKind.SLIDING: "window"}[spec.attn]
    window, sink = cfg.sliding_window, 0
    if attn_override is not None and spec.attn is AttentionKind.FULL:
        # efficient-attention DSIA applies to full-attention layers only
        kind = attn_override["kind"]
        window = attn_override["window"]
        sink = attn_override.get("sink", 0)

    carried = {}
    if staged_buf is not None:
        carried = dict(k_staged=staged_buf["k"], v_staged=staged_buf["v"],
                       staged_pos=staged_pos, staged_mask=staged_mask)
    if mode in ("train", "prefill"):
        o = attn_lib.blockwise_attention(q, k, v, q_pos, q_pos, kind=kind, window=window,
                                         sink=sink)
    elif "k_pages" in layer_cache:
        # the paged kernel reads the pool through the table in place
        o = attn_lib.paged_decode_attention(
            q, layer_cache["k_pages"], layer_cache["v_pages"], layer_cache["_table"],
            layer_cache["_pos"], k, v, q_pos, tree_mask=tree_mask, kind=kind, window=window,
            sink=sink, **carried,
        )
    else:
        k_c, v_c = layer_cache["k"], layer_cache["v"]
        ring = (not seq_axes and spec.attn is AttentionKind.SLIDING and k_c.shape[1] <= window)
        o = attn_lib.decode_attention(
            q, k_c, v_c, layer_cache["_pos"], k, v, q_pos,
            tree_mask=tree_mask, kind=kind, window=window, sink=sink, ring=ring,
            seq_axes=seq_axes, **carried,
        )
    if policy == "q":
        o = o[:, :, SU.model_index() * H:(SU.model_index() + 1) * H]
    out = o.reshape(B, T, H * hd) @ a["wo"].reshape(H * hd, d)
    if policy in ("kv", "q"):
        out = SU.all_sum(out)
    return out, {"k": k, "v": v}


def _host_gates(gates, n: int) -> List[float]:
    """The gate vector as host floats. Gates given on the host (a sequence,
    numpy array or CPU tensor) are read without a device sync, so a
    captured CUDA graph may run mask exec; a CUDA tensor is copied back,
    which capture refuses."""
    if gates is None:
        return [1.0] * n
    g = torch.as_tensor(gates).detach()
    g = g.cpu().reshape(-1).tolist()  # port: noqa-PORT001: host gates (a CUDA vector fails capture)
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
    staged_kv=None,
    staged_pos: Optional[torch.Tensor] = None,
    staged_mask: Optional[torch.Tensor] = None,
    remat: bool = False,
    seq_axes=None,
    fsdp=None,
):
    """Returns (hidden, staged segments: [[{leaf: (R_run, B, T, ...)}]],
    moe_aux), the staged leaves ``"k"``, ``"v"`` (B, T, KV, hd) of an
    attention layer or the per-step states of a Mamba-2 layer
    (``ssm_lib.STATE_LEAVES``). ``staged_kv`` has the structure of a
    previous call's staged segments (one entry per layer run, in run
    order). ``mode="train"`` takes no cache and stages nothing (the staged
    segments are empty); its ``moe_aux`` is the float32 sum of every MoE
    layer's load-balance and router-z losses (0 without MoE layers, and
    in the other modes). ``fsdp`` (training on a mesh): per segment and
    unit, a tree of the dim each stacked leaf is cut on over ``data``, or
    None (``launch.sharding.data_dims``)."""
    segs = layout(cfg)
    g_host = _host_gates(gates, cfg.num_layers)
    if layer_ids is not None and (len(segs) != 1 or len(segs[0].unit) != 1):
        raise ValueError("layer_ids requires a homogeneous layer stack")
    train = mode == "train"
    table = None if train else cache.get("page_table")
    staged_segments = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for si, seg in enumerate(segs):
        p_seg = params["segments"][si]
        U = len(seg.unit)
        staged = [{} for _ in seg.unit]
        # one unbind per leaf: its backward writes the stack's gradient once,
        # where a backward per ``a[r]`` would zero-fill the whole stack per layer
        views = [_unstack(p_seg[u], seg.repeats) for u in range(U)] if train else None
        repeats = range(seg.repeats) if layer_ids is None else layer_ids
        for i, r in enumerate(repeats):
            for u, spec in enumerate(seg.unit):
                gate = g_host[seg.start + r * U + u]
                if train:
                    body = _layer_fn(cfg, views[u][r], spec, gate, q_pos, "train",
                                     fsdp=None if fsdp is None else fsdp[si][u])
                    if not remat:
                        h, _, a = body(h)
                    elif fsdp is None:
                        h, _, a = checkpoint(body, h, use_reentrant=False)
                    else:
                        # on a mesh the backward replays every collective of
                        # the layer (none stops early), on every rank alike
                        with set_checkpoint_early_stop(False):
                            h, _, a = checkpoint(body, h, use_reentrant=False)
                    if a is not None:
                        aux = aux + a
                    continue
                lc = {n: a[r] for n, a in cache["segments"][si][u].items()}
                lc.update(_pos=cache["pos"], _table=table)
                buf = None
                if staged_kv is not None:
                    buf = {n: staged_kv[si][u][n][i] for n in ("k", "v")}
                p_l = tree_map(lambda a, r=r: a[r], p_seg[u])          # views
                h, st, _ = _layer_fn(cfg, p_l, spec, gate, q_pos, mode, lc, tree_mask,
                                     attn_override, buf, staged_pos, staged_mask, quantize,
                                     seq_axes)(h)
                for n, a in st.items():
                    staged[u].setdefault(n, []).append(a)
        if not train:
            staged_segments.append([{n: torch.stack(v) for n, v in s.items()} for s in staged])
    return h, staged_segments, aux


def _unstack(tree: dict, n: int) -> List[dict]:
    """The ``n`` per-layer views of a unit's stacked params, one
    ``torch.unbind`` per leaf."""
    per = {k: (_unstack(v, n) if isinstance(v, dict) else torch.unbind(v)) for k, v in tree.items()}
    return [{k: v[r] for k, v in per.items()} for r in range(n)]


def _layer_fn(cfg, p_l, spec, gate, q_pos, mode, lc=None, tree_mask=None, attn_override=None,
              buf=None, staged_pos=None, staged_mask=None, quantize=None, seq_axes=None,
              fsdp=None):
    """One layer (attention or Mamba-2, then the MLP) as a function of the
    residual stream: returns (the new stream, the layer's staged K/V or
    per-step states, its MoE auxiliary loss: a float32 0-d tensor in
    ``mode="train"`` on an MoE layer, else None). On a mesh the MLP's (or
    the experts') d_ff is this rank's, and its output is summed over
    ``model``. ``fsdp``: the layer's leaves cut over ``data`` (a tree of
    stacked dims or None) are gathered first, inside the function, so that
    a recomputing backward gathers them again instead of keeping them."""
    def body(h):
        p = p_l if fsdp is None else _gather_fsdp(p_l, fsdp)
        if spec.block is BlockKind.MAMBA:
            x = rms_norm(h, p["norm1"], cfg.norm_eps)
            delta, st = ssm_lib.mamba_forward(p["mamba"], x, cfg.d_model, cfg.ssm, lc,
                                              mode=mode)
        else:
            delta, st = _attn_layer(cfg, p, spec, h, q_pos, mode, lc, tree_mask, attn_override,
                                    buf, staged_pos, staged_mask, seq_axes)
        h = h + _gated(delta, gate)
        aux = None
        if spec.has_mlp:
            x = rms_norm(h, p["norm2"], cfg.norm_eps)
            if spec.is_moe:
                # training: the grouped-capacity dispatch and its aux losses;
                # serving: the dropless dispatch. The expert products stay in
                # the model's type: ActivationQuant quantizes the dense MLP
                # only, as the reference does (its _mlp_layer, l.397-417)
                train = mode == "train"
                if train:
                    moe_mode = "train"
                elif mode == "prefill" and not cfg.moe.prefill_dropless:
                    moe_mode = "infer_grouped"
                else:
                    moe_mode = "infer"
                y, a = moe_lib.moe_apply(p["moe"], x, cfg.moe, cfg.act, cfg.mlp_gated,
                                         mode=moe_mode, with_aux=train)
                if train:
                    aux = a["load_balance"] + a["router_z"]
            else:
                y = mlp_apply(p["mlp"], SU.enter_shards(x), cfg.act, cfg.mlp_gated,
                              quantize=quantize)
            h = h + _gated(SU.model_sum(y), gate)
        return h, st, aux
    return body


def _gather_fsdp(tree, dims):
    """One layer's leaves with those cut over ``data`` gathered whole
    (``dims``: the stacked dim of each cut, None where a leaf is not)."""
    if isinstance(tree, dict):
        return {k: _gather_fsdp(v, dims[k]) for k, v in tree.items()}
    return tree if dims is None else SU.gather(tree, dims - 1, "data", grad_sum=True)


def _check_placement(cfg: ModelConfig, embed: torch.Tensor) -> None:
    """Refuse params cut for another ``model`` axis than the active mesh's
    (or cut for a mesh where none is active): the embedding is always
    vocab-sharded (``launch.sharding.param_specs``), so its local rows
    times the axis size must be the padded vocabulary. Otherwise the
    row-parallel sums and the vocabulary gather would be skipped or run
    over shards they do not fit, and the logits would be silently wrong."""
    n = SU.model_axis_size()
    rows = embed.shape[-2]
    if rows * n != cfg.padded_vocab:
        raise ValueError(
            f"params hold {rows} of {cfg.padded_vocab} vocabulary rows, which does not fit "
            f"the active model axis of size {n}: run params cut by init_params(mesh=) or "
            "bridge.params_from_jax(mesh=) inside shard_utils.use_mesh(mesh) of that mesh, "
            "and unsharded params outside it")


def _embed(cfg: ModelConfig, params: dict, batch: Dict[str, Any]) -> torch.Tensor:
    """The input embeddings (B, S, d) of ``batch["tokens"]``: (B, S) text
    tokens, or (B, S, nc) codes whose nc codebook embeddings are summed.
    On an image stack, ``batch["image_embeds"]`` (B, Ti, d), where given,
    replaces the first Ti positions where ``batch["image_mask"]`` (B, S) is
    1, with the reference's arithmetic (``e * (1 - mask) + img * mask``)."""
    embed = params["embed"]
    _check_placement(cfg, embed)
    tokens = torch.as_tensor(batch["tokens"], device=embed.device).long()
    tp = SU.tensor_parallel()
    inside = None
    if tp:
        # this rank's vocabulary rows: a masked lookup, then the sum over model
        Vl = embed.shape[-2]
        tokens = tokens - SU.model_index() * Vl
        inside = ((tokens >= 0) & (tokens < Vl))[..., None]
        tokens = tokens.clamp(0, Vl - 1)

    def look(table, tok, ok):
        out = embed_tokens(table, tok)
        return out if ok is None else torch.where(ok, out, 0)

    if cfg.num_codebooks:
        e = look(embed[0], tokens[..., 0], None if inside is None else inside[..., 0, :])
        for c in range(1, cfg.num_codebooks):
            e = e + look(embed[c], tokens[..., c], None if inside is None else inside[..., c, :])
    else:
        e = look(embed, tokens, inside)
    if tp:
        e = SU.all_sum(e)
    if cfg.num_image_tokens and "image_embeds" in batch:
        mask = torch.as_tensor(batch["image_mask"], device=e.device)[..., None].to(e.dtype)
        img = torch.as_tensor(batch["image_embeds"], device=e.device).to(e.dtype)
        B, S, d = e.shape
        img_full = torch.cat([img, img.new_zeros((B, S - img.shape[1], d))], dim=1)
        e = e * (1 - mask) + img_full * mask
    return e


def _head(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Logits in float32: (..., V), or (..., nc, V) on a codebook stack, the
    padded vocabulary masked to -1e30. On a mesh each rank computes its
    vocabulary columns, gathered over ``model`` (in a training graph the
    gather's backward keeps this rank's columns and ``h`` sums its
    gradient over ``model``)."""
    h = SU.enter_shards(rms_norm(h, params["final_norm"], cfg.norm_eps))
    if cfg.num_codebooks:
        heads = params["embed"].transpose(1, 2) if cfg.tie_embeddings else params["lm_head"]
        logits = torch.einsum("btd,cdv->btcv", h.float(), heads.float())
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = unembed(h, head)
    if SU.tensor_parallel():
        logits = SU.gather(logits, -1)         # this rank's vocabulary columns
    if cfg.padded_vocab != cfg.vocab_size:
        ids = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(ids < cfg.vocab_size, logits, torch.full_like(logits, -1e30))
    return logits


# =============================================================== entry points
def forward_train(
    cfg: ModelConfig,
    params: dict,
    batch: Dict[str, torch.Tensor],
    *,
    gates=None,
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full causal forward over ``batch`` (``_embed``: tokens (B, S) or
    (B, S, nc), image embeddings where given), differentiable, writing no
    cache. Returns (logits (B, S, [nc,] V) float32, moe_aux): the float32
    sum over the MoE layers of their load-balance and router-z losses (0 on
    a stack without MoE layers). MoE layers dispatch through the grouped
    capacity (``moe_apply(mode="train")``), Mamba-2 blocks run the chunked
    scan over a fresh zero state. ``remat=True`` recomputes each layer's
    activations in the backward pass.

    On a mesh (sharded training) ``batch`` holds this rank's rows of the
    data axes and ``params`` this rank's shards: ``launch.sharding``'s
    ``param_specs``, optionally cut further over ``data``
    (``fsdp_upgrade``), which the leaves' shapes tell
    (``launch.sharding.placed_specs``). A layer's leaves cut over ``data``
    are gathered at its entry, inside the ``remat`` region; the
    collectives carry gradients (``models.shard_utils``), and the MoE
    capacity and auxiliary losses are those of the global batch. A leaf
    cut over ``data`` gets its slice of the global gradient (the gather's
    backward sums the ranks' gradients and cuts it); a leaf replicated over
    ``data`` gets this rank's part (``training.train_step.loss_and_grads``
    sums those)."""
    fsdp = None
    mesh = SU.active_mesh()
    if mesh is not None:
        from repro_torch.launch import sharding as SH
        fsdp = SH.data_dims(cfg, params, mesh)
    h = _embed(cfg, params, batch)
    q_pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    h, _, aux = _run_stack(cfg, params, h, mode="train", cache=None, gates=gates, q_pos=q_pos,
                           tree_mask=None, remat=remat, fsdp=fsdp)
    return _head(cfg, params, h), aux


def prefill(
    cfg: ModelConfig,
    params: dict,
    batch: Dict[str, torch.Tensor],
    cache: Cache,
    *,
    gates=None,
) -> Tuple[torch.Tensor, Cache]:
    """Process the prompt (``_embed``: tokens, and image embeddings where
    given) and write it into ``cache`` (in place). Returns (last-token
    logits (B, [nc,] V) float32, cache)."""
    if "page_table" in cache:
        raise NotImplementedError(
            "prefill writes a dense cache; paged serving prefills a dense B=1 cache "
            "and scatters it with write_slot"
        )
    h = _embed(cfg, params, batch)
    B, S, _ = h.shape
    q_pos = torch.arange(S, dtype=torch.int32, device=h.device)
    h, staged, _ = _run_stack(cfg, params, h, mode="prefill", cache=cache, gates=gates,
                              q_pos=q_pos, tree_mask=None)
    _write_prefill(cfg, cache, staged, S, cache_seq_axes(cfg, cache))
    logits = _head(cfg, params, h[:, -1:])
    return logits[:, 0], cache


def _write_prefill(cfg: ModelConfig, cache: Cache, staged, S: int, seq_axes=None) -> None:
    for si, seg in enumerate(layout(cfg)):
        for u, spec in enumerate(seg.unit):
            c, st = cache["segments"][si][u], staged[si][u]
            if spec.block is BlockKind.MAMBA:
                # the final states carry a length-1 step axis: (R, B, 1, ...)
                for name in ssm_lib.STATE_LEAVES:
                    c[name].copy_(st[name][:, :, 0])
                continue
            S_c = c["k"].shape[2]
            if seq_axes:
                # this rank's sequence slice of the prompt's rows
                off = _seq_offset(seq_axes, S_c)
                n = max(0, min(S, off + S_c) - off)
                for name in ("k", "v"):
                    c[name][:, :, :n] = st[name][:, :, off:off + n].to(c[name].dtype)
                continue
            for name in ("k", "v"):
                src = st[name].to(c[name].dtype)                   # (R, B, S, KV, hd)
                if S_c >= S:
                    c[name][:, :, :S] = src
                else:
                    # ring: keep the last S_c tokens arranged by pos % S_c
                    last = S - 1
                    slots = torch.arange(S_c, device=src.device)
                    c[name].copy_(src[:, :, last - torch.remainder(last - slots, S_c)])
    cache["pos"].fill_(S)


def decode_step(
    cfg: ModelConfig,
    params: dict,
    cache: Cache,
    tokens: torch.Tensor,             # (B, T), or (B, T, nc) codes
    *,
    gates=None,
    tree_mask: Optional[torch.Tensor] = None,   # (T, T) or (B, T, T) ancestor-or-self
    q_pos: Optional[torch.Tensor] = None,       # (T,) or (B, T) absolute positions
    attn_override: Optional[dict] = None,       # efficient-attention DSIA
    quantize: Optional[str] = None,             # "int8": W8A8 MLP matmuls (DSIA)
    layer_ids: Optional[Sequence[int]] = None,  # slice exec: run only these layers
    seq_axes=None,
    staged_kv=None,                   # carried draft KV, a previous call's staged
    staged_pos=None,                  # (B, N_s) positions of the carried rows
    staged_mask=None,                 # (B, T, N_s) bool: which carried rows each token sees
) -> Tuple[torch.Tensor, Any]:
    """Stage-only decode of T tokens against a frozen cache.

    Returns (logits (B, T, [nc,] V) float32, staged) — commit with
    ``commit_cache``; a codebook step is one position of the cache.
    ``quantize="int8"`` runs the dense-MLP matmuls through the W8A8 kernel.
    With ``staged_kv`` (the structure a previous call returned as staged,
    per layer (R_run, B, N_s, KV, hd); its layers in the same run order),
    the T tokens also attend over the carried rows (the reference's
    incremental drafting); the returned staged holds the new rows only.

    ``seq_axes``: the mesh axes the dense cache's sequence dim is sharded
    on. On a mesh the cache's layout fixes them (``cache_seq_axes``: the
    ``q`` and ``none`` policies shard it over ``model``), each rank runs the
    flash-decode kernel over its slice and the partials are combined across
    ranks; given, they must name that layout. Without a mesh ``seq_axes``
    is a no-op, as in the reference.
    """
    layout_axes = cache_seq_axes(cfg, cache)
    if seq_axes and SU.active_mesh() is not None and tuple(seq_axes) != tuple(layout_axes or ()):
        raise ValueError(f"decode_step: seq_axes {tuple(seq_axes)} do not name the cache's "
                         f"sequence sharding {layout_axes} on this mesh")
    given = [a is not None for a in (staged_kv, staged_pos, staged_mask)]
    if any(given) and not all(given):
        raise ValueError("decode_step: staged_kv requires staged_pos and staged_mask")
    tokens = torch.as_tensor(tokens, device=cache["pos"].device)
    h = _embed(cfg, params, {"tokens": tokens})
    B, T = tokens.shape[:2]
    if q_pos is None:
        q_pos = cache["pos"][:, None] + torch.arange(T, dtype=torch.int32, device=h.device)[None]
    elif q_pos.ndim == 1:
        q_pos = q_pos[None].expand(B, T)
    h, staged, _ = _run_stack(cfg, params, h, mode="decode", cache=cache, gates=gates,
                              q_pos=q_pos, tree_mask=tree_mask, attn_override=attn_override,
                              quantize=quantize, layer_ids=layer_ids, staged_kv=staged_kv,
                              staged_pos=staged_pos, staged_mask=staged_mask,
                              seq_axes=layout_axes)
    return _head(cfg, params, h), staged


def commit_cache(
    cfg: ModelConfig,
    cache: Cache,
    staged,
    path_idx,                          # (T,) or (B, T) indices into the staged T dim
    n_accept,                          # scalar or (B,) accepted count (<= T)
) -> Cache:
    """Write the accepted draft path into the cache and advance pos, in
    place; returns ``cache``.

    The reference scatters with ``mode="drop"`` and a unique out-of-bounds
    destination per rejected row. Torch has no drop mode, so this is a
    scatter of fixed shape (no host read): every (slot, step) entry writes
    one row (``_scatter_rows``). An entry is live if it is accepted and in
    bounds and, on a paged cache, its page is allocated: a -1 page is never
    written through (clamped, it would land on page 0, which another slot
    may own). Rejected rows and the rest of the cache keep their values.

    A Mamba-2 layer takes its staged state at step ``n_accept - 1`` of each
    slot (so the T staged tokens must be a chain, and ``path_idx`` is not
    read), and keeps its state where ``n_accept`` is 0: a gather and a
    ``where`` of fixed shape, as the reference's l.895-905.

    On a sequence-sharded cache (a mesh) each rank writes the rows that
    fall in its slice.
    """
    seq_axes = cache_seq_axes(cfg, cache)
    base = cache["pos"]
    B, dev = base.shape[0], base.device
    path_idx = torch.as_tensor(path_idx, device=dev).long()
    if path_idx.ndim == 1:
        path_idx = path_idx[None].expand(B, path_idx.shape[0])
    T = path_idx.shape[1]
    n_acc = torch.as_tensor(n_accept, dtype=torch.int32, device=dev).broadcast_to((B,))
    step = torch.arange(T, dtype=torch.int32, device=dev)
    accepted = step[None] < n_acc[:, None]                   # (B, T)
    dest = (base[:, None] + step[None]).long()
    b_i = torch.arange(B, device=dev)[:, None].expand(B, T)
    last = torch.clamp(n_acc.long() - 1, 0, T - 1)             # (B,)
    keep = n_acc == 0
    for si, seg in enumerate(layout(cfg)):
        for u, spec in enumerate(seg.unit):
            c, st = cache["segments"][si][u], staged[si][u]
            if spec.block is BlockKind.MAMBA:
                for name in ssm_lib.STATE_LEAVES:
                    a, old = st[name], c[name]                  # (R, B, T, ...), (R, B, ...)
                    new = a[:, torch.arange(B, device=dev), last]
                    k = keep.view((1, B) + (1,) * (old.ndim - 2))
                    old.copy_(torch.where(k, old, new.to(old.dtype)))
                continue
            if "k_pages" in c:
                rows, ok = _page_rows(cache["page_table"], c["k_pages"].shape[2], b_i, dest)
                ok &= accepted
                names = ("k_pages", "v_pages")
            else:
                S_c = c["k"].shape[2]
                if seq_axes:
                    # this rank's slice of the slots: [off, off + S_c)
                    off = _seq_offset(seq_axes, S_c)
                    rows = b_i * S_c + torch.remainder(dest - off, S_c)
                    ok = accepted & (dest >= off) & (dest < off + S_c)
                else:
                    ring = S_c <= cfg.sliding_window and spec.attn is AttentionKind.SLIDING
                    d = torch.remainder(dest, S_c)
                    rows, ok = b_i * S_c + d, accepted & (ring | (dest < S_c))
                names = ("k", "v")
            for name in names:
                src = st[name[0]][:, b_i, path_idx]               # (R, B, T, KV, hd)
                _scatter_rows(c[name], rows.reshape(-1), ok.reshape(-1), src.flatten(1, 2))
    base += n_acc
    return cache


def _page_rows(table: torch.Tensor, page_size: int, b_i: torch.Tensor, dest: torch.Tensor):
    """Where positions ``dest`` of slots ``b_i`` live in a paged pool: the
    flat row ``page * P + dest % P`` of the pool's (NP * P) rows, and
    whether the position's page is allocated (the only rows a write may
    touch)."""
    n_pp = table.shape[1]
    logical = torch.div(dest, page_size, rounding_mode="floor")
    page = table[b_i, logical.clamp(0, n_pp - 1)].long()
    ok = (logical < n_pp) & (page >= 0)
    return page * page_size + torch.remainder(dest, page_size), ok


def _scatter_rows(buf: torch.Tensor, rows: torch.Tensor, ok: torch.Tensor,
                  src: torch.Tensor) -> None:
    """Write ``src[:, i]`` to row ``rows[i]`` of ``buf`` (R, B or NP, S or P,
    KV, hd), in place, for the entries where ``ok`` holds, with one
    scatter of fixed shape. The other entries write the anchor: the first
    live entry's row and value or, with no live entry, row 0 and its own
    value. Duplicate writes of one value leave no order to matter (the
    order of a scatter's duplicate writes is undefined on the card), and
    live rows are distinct."""
    flat = buf.view(buf.shape[0], -1, *buf.shape[3:])            # (R, rows, KV, hd)
    first = ok.to(torch.uint8).argmax().view(1)                # 0 with no live entry
    any_ok = ok.any()
    anchor = torch.where(any_ok, rows.index_select(0, first), 0)
    anchor_val = torch.where(any_ok, src.index_select(1, first).to(buf.dtype),
                             flat.index_select(1, anchor))
    flat.index_copy_(1, torch.where(ok, rows, anchor),
                     torch.where(ok[None, :, None, None], src.to(buf.dtype), anchor_val))


def decode_commit_token(
    cfg: ModelConfig,
    params: dict,
    cache: Cache,
    token,                            # (B,) one token per sequence
    *,
    gates=None,
    attn_override: Optional[dict] = None,
) -> Tuple[torch.Tensor, Cache]:
    """Decode one token per sequence and commit its K/V at once, advancing
    ``pos`` by one: ``decode_step`` then ``commit_cache``, in place. Unlike
    ``decode_step`` this writes the cache (the reference's scan-friendly
    draft step). Returns (logits (B, V) float32, cache)."""
    token = torch.as_tensor(token, device=cache["pos"].device)
    logits, staged = decode_step(cfg, params, cache, token[:, None], gates=gates,
                                 attn_override=attn_override)
    B, dev = token.shape[0], token.device
    commit_cache(cfg, cache, staged, torch.zeros((B, 1), dtype=torch.int32, device=dev),
                 torch.ones((B,), dtype=torch.int32, device=dev))
    return logits[:, 0], cache


def write_slot(cfg: ModelConfig, cache: Cache, c1: Cache, slot: int) -> Cache:
    """Write a freshly prefilled dense B=1 cache ``c1`` into batch slot
    ``slot`` of ``cache`` and set the slot's ``pos``, in place; returns
    ``cache``.

    ``c1`` may be shorter than the batched cache (admission sizes it to the
    prompt's bucket): its rows land at the front of the slot, and rows past
    ``c1["pos"]`` are never read (kv_pos masking). On a paged cache the rows
    go through ``page_table[slot]``, which the caller sets first; rows whose
    page is unallocated are not written. A Mamba-2 layer's state is copied
    into the slot as it is (it is per slot, dense in a paged cache too).
    """
    dev = cache["pos"].device
    seq_axes = cache_seq_axes(cfg, c1)     # the B=1 cache is dense
    dst_axes = cache_seq_axes(cfg, cache)
    for si, seg in enumerate(layout(cfg)):
        for u, spec in enumerate(seg.unit):
            dst, src = cache["segments"][si][u], c1["segments"][si][u]
            if spec.block is BlockKind.MAMBA:
                for name in ssm_lib.STATE_LEAVES:
                    dst[name][:, slot] = src[name][:, 0].to(dst[name].dtype)
                continue
            rows_src = {n: src[n][:, 0] for n in ("k", "v")}          # (R, S_src, KV, hd)
            if seq_axes:
                # the prompt's rows of every sequence slice (a sum into zeros)
                rows_src = {n: SU.gather(r, 1, seq_axes) for n, r in rows_src.items()}
            S_src = rows_src["k"].shape[1]
            if "k_pages" in dst:
                t = torch.arange(S_src, device=dev)
                rows, ok = _page_rows(cache["page_table"], dst["k_pages"].shape[2],
                                      torch.full_like(t, slot), t)
                for name in ("k", "v"):
                    _scatter_rows(dst[name + "_pages"], rows, ok, rows_src[name])
                continue
            S_dst = dst["k"].shape[2]
            if dst_axes:
                # this rank's slice of the slot's rows
                off = _seq_offset(dst_axes, S_dst)
                n = max(0, min(S_src, off + S_dst) - off)
                for name in ("k", "v"):
                    dst[name][:, slot, :n] = rows_src[name][:, off:off + n].to(dst[name].dtype)
                continue
            if S_src > S_dst:
                raise NotImplementedError(
                    f"prefill cache seq {S_src} exceeds batched cache seq "
                    f"{S_dst} (ring slots cannot take longer buckets)")
            for name in ("k", "v"):
                dst[name][:, slot, :S_src] = rows_src[name].to(dst[name].dtype)
    cache["pos"][slot] = c1["pos"][0]
    return cache
