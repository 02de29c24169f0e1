"""Sharding rules: spec trees for params / optimizer / cache / batch, the
port of the reference's ``src/repro/launch/sharding.py``, with the same
rules and the same trees. A spec is a tuple with one entry per dimension:
None (replicated), an axis name, or a tuple of axis names (the reference's
``PartitionSpec``, whose entries compare equal as a tuple); a spec may be
shorter than its leaf (the rest replicated), as ``P()`` is.

Rules, resolved per architecture:
  - embeddings / lm_head:   vocab -> model
  - attention q/k/v/o:      heads -> model when divisible, else replicated
                            (``attention_policy``)
  - dense MLP:              d_ff -> model
  - MoE experts:            expert d_ff -> model
  - Mamba:                  d_inner -> model when its heads divide it
  - activations:            batch -> (pod, data); long-context batch=1 decode
                            shards the cache sequence dim -> data
  - optimizer moments:      the spec of their param

``local_shard`` cuts a full tree into one rank's shards and
``local_shape`` gives a leaf's shape on one rank; ``mesh`` is any object
with ``shape`` (axis -> size) and ``axis_names``, a ``launch.mesh.Mesh``
or a shape-only stand-in.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import AttentionKind, BlockKind, ModelConfig
from repro_torch.models import model as M
from repro_torch.training.optimizer import AdamWState

Spec = Tuple


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def map_specs(fn, *trees):
    """``fn`` over the specs of ``trees[0]`` and the matching leaves of the
    others (nested dicts / lists / named tuples)."""
    t = trees[0]
    if is_spec(t):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: map_specs(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        vals = [map_specs(fn, *xs) for xs in zip(*trees)]
        return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
    raise TypeError(f"not a spec tree node: {type(t).__name__}")


def attention_policy(cfg: ModelConfig, model_size: int) -> str:
    """Head-sharding policy ladder:

      kv   — KV heads divide the model axis: shard K/V/cache + Q on heads
      q    — only Q heads divide: shard Q heads, replicate K/V over model
      none — neither divides: attention replicated over model, the model
             axis works only in the MLP. Never shard head_dim.
    """
    if cfg.num_kv_heads and cfg.num_kv_heads % model_size == 0:
        return "kv"
    if cfg.num_heads and cfg.num_heads % model_size == 0:
        return "q"
    return "none"


def attn_param_specs(cfg: ModelConfig, mesh) -> dict:
    pol = attention_policy(cfg, _axis_size(mesh, "model"))
    qh = "model" if pol in ("kv", "q") else None
    kh = "model" if pol == "kv" else None
    return {"wq": (None, qh, None), "wk": (None, kh, None), "wv": (None, kh, None),
            "wo": (qh, None, None)}


def mamba_policy(cfg: ModelConfig, model_size: int) -> bool:
    """Shard d_inner (z/x/conv/heads) iff its head count divides the model axis."""
    s = cfg.ssm
    return s is not None and s.num_heads(cfg.d_model) % model_size == 0


def mamba_param_specs(cfg: ModelConfig, mesh) -> dict:
    din = "model" if mamba_policy(cfg, _axis_size(mesh, "model")) else None
    return {
        "w_z": (None, din), "w_x": (None, din), "w_B": (), "w_C": (), "w_dt": (),
        "conv_x": (None, din), "conv_B": (), "conv_C": (), "A_log": (), "D": (),
        "dt_bias": (), "norm_w": (din,),
        "out_proj": (din, None),     # contracts the sharded d_inner: one sum
    }


def layer_param_specs(cfg: ModelConfig, spec: M.LayerSpec, mesh) -> dict:
    out: dict = {"norm1": ()}
    if spec.block is BlockKind.ATTENTION:
        out["attn"] = attn_param_specs(cfg, mesh)
    else:
        out["mamba"] = mamba_param_specs(cfg, mesh)
    if spec.has_mlp:
        out["norm2"] = ()
        if spec.is_moe:
            moe = {"w_router": (), "w_up": (None, None, "model"),
                   "w_down": (None, "model", None)}
            if cfg.mlp_gated:
                moe["w_gate"] = (None, None, "model")
            if cfg.moe.num_shared_experts:
                sh = {"w_up": (None, "model"), "w_down": ("model", None)}
                if cfg.mlp_gated:
                    sh["w_gate"] = (None, "model")
                moe["shared"] = sh
                moe["w_shared_gate"] = ()
            out["moe"] = moe
        else:
            mlp = {"w_up": (None, "model"), "w_down": ("model", None)}
            if cfg.mlp_gated:
                mlp["w_gate"] = (None, "model")
            out["mlp"] = mlp
    return out


def param_specs(cfg: ModelConfig, mesh) -> dict:
    """The spec tree congruent with ``models.model.init_params(cfg)``;
    stacked segment leaves carry a leading repeats dim (None)."""
    segs = []
    for seg in M.layout(cfg):
        segs.append([map_specs(lambda p: (None,) + p, layer_param_specs(cfg, s, mesh))
                     for s in seg.unit])
    out = {
        "embed": (None, "model", None) if cfg.num_codebooks else ("model", None),
        "final_norm": (),
        "segments": segs,
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = (None, None, "model") if cfg.num_codebooks else (None, "model")
    return out


def _dp_axes(mesh) -> tuple:
    """The batch-parallel mesh axes, always as a tuple."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _dp(mesh):
    """Batch-parallel axes as a spec entry: the compound tuple on pod
    meshes, the bare axis name otherwise."""
    axes = _dp_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def dp_size(mesh) -> int:
    """Total batch-parallel way count of ``mesh``."""
    n = 1
    for a in _dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def cache_seq_axes(cfg: ModelConfig, mesh, *, shard_seq: bool = False):
    """Mesh axes carrying the cache sequence dim (context parallelism):
    policy kv keeps seq local (KV heads carry 'model'); policies q/none put
    'model' on seq, whose split-KV partials ``models.attention`` combines
    across ranks. Long-context batch=1 (``shard_seq``) adds the data axes."""
    pol = attention_policy(cfg, _axis_size(mesh, "model"))
    axes = ()
    if shard_seq:
        axes += _dp_axes(mesh)
    if pol != "kv":
        axes += ("model",)
    return axes or None


def seq_shard_count(cfg: ModelConfig, mesh, *, shard_seq: bool = False) -> int:
    axes = cache_seq_axes(cfg, mesh, shard_seq=shard_seq)
    if not axes:
        return 0
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return total


def _entry(axes):
    """A tuple of axis names as one spec entry: None, the name, or the
    tuple (a ``PartitionSpec`` entry of one name is that name)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def batch_axis(mesh, global_batch: int):
    """The data-parallel batch axis as a spec entry, or None when
    ``global_batch`` cannot shard evenly over it."""
    d = dp_size(mesh)
    ok = global_batch % d == 0 and global_batch >= d
    return _dp(mesh) if ok else None


def cache_specs(cfg: ModelConfig, mesh, *, shard_seq: bool = False, ring_window: bool = False,
                global_batch: Optional[int] = None, paged: bool = False) -> dict:
    """Cache spec tree. ``shard_seq``: context parallelism for batch=1
    long-context decode. ``global_batch`` (when given) gates the batch axis
    on even divisibility. ``paged``: one shared pool per attention layer
    that shards only on its KV-head dim and replicates across the data
    axes; the per-slot ``page_table`` is leading-batch."""
    n = _axis_size(mesh, "model")
    pol = attention_policy(cfg, n)
    kh = "model" if pol == "kv" else None
    batch_ax = None if shard_seq else (
        _dp(mesh) if global_batch is None else batch_axis(mesh, global_batch))
    seq_ax = _entry(cache_seq_axes(cfg, mesh, shard_seq=shard_seq))
    segs = []
    for seg in M.layout(cfg):
        unit = []
        for spec in seg.unit:
            if spec.block is BlockKind.ATTENTION:
                if paged:
                    unit.append({"k_pages": (None, None, None, kh, None),
                                 "v_pages": (None, None, None, kh, None)})
                    continue
                ring = ring_window and spec.attn is AttentionKind.SLIDING
                s = (None, batch_ax, None if ring else seq_ax, kh, None)
                unit.append({"k": s, "v": s})
            else:
                din = "model" if mamba_policy(cfg, n) else None
                unit.append({"ssm": (None, batch_ax, din, None, None),
                             "conv_x": (None, batch_ax, None, din),
                             "conv_B": (None, batch_ax, None, None),
                             "conv_C": (None, batch_ax, None, None)})
        segs.append(unit)
    out = {"pos": (batch_ax,), "segments": segs}
    if paged:
        out["page_table"] = (batch_ax, None)
    return out


def batch_specs(cfg: ModelConfig, mesh, *, global_batch: int) -> dict:
    bax = batch_axis(mesh, global_batch)
    out = {"tokens": (bax, None, None) if cfg.num_codebooks else (bax, None)}
    if cfg.num_image_tokens:
        out["image_embeds"] = (bax, None, None)
        out["image_mask"] = (bax, None)
    return out


def round_state_specs(mesh, *, global_batch: int, sampled: bool = False,
                      prefill: bool = False) -> dict:
    """Specs of the batched server's carried round state (``dstate``):
    every array is per-slot and shards on its leading batch dim."""
    bax = batch_axis(mesh, global_batch)
    out = {"pending": (bax,), "live": (bax,), "ctx": (bax, None), "alpha": (bax,),
           "hist": (bax, None), "hist_n": (bax,), "hist_ptr": (bax,)}
    if sampled:
        out.update({"temp": (bax,), "topk": (bax,), "topp": (bax,), "key": (bax, None)})
    if prefill:
        out.update({"pf_done": (bax,), "pf_len": (bax,)})
    return out


def telemetry_specs(schema: dict, mesh, *, global_batch: int) -> dict:
    """Specs of the device telemetry buffer (``serving.telemetry
    .telemetry_schema``): per-slot tallies shard their leading batch dim;
    the per-(level, slot) cascade rows carry batch on their second dim."""
    bax = batch_axis(mesh, global_batch)
    out = {}
    for k, (shape, _) in schema.items():
        if k.startswith("casc_"):
            out[k] = (None, bax)
        else:
            out[k] = (bax,) + (None,) * (len(shape) - 1)
    return out


def staged_specs(cfg: ModelConfig, mesh, *, shard_seq: bool = False) -> list:
    """Specs of ``decode_step``'s staged outputs (the cache's layout with
    the T dim unsharded; Mamba-2 staged states carry a per-step dim)."""
    n = _axis_size(mesh, "model")
    kh = "model" if attention_policy(cfg, n) == "kv" else None
    batch_ax = None if shard_seq else _dp(mesh)
    segs = []
    for seg in M.layout(cfg):
        unit = []
        for spec in seg.unit:
            if spec.block is BlockKind.ATTENTION:
                s = (None, batch_ax, None, kh, None)
                unit.append({"k": s, "v": s})
            else:
                din = "model" if mamba_policy(cfg, n) else None
                unit.append({"ssm": (None, batch_ax, None, din, None, None),
                             "conv_x": (None, batch_ax, None, None, din),
                             "conv_B": (None, batch_ax, None, None, None),
                             "conv_C": (None, batch_ax, None, None, None)})
        segs.append(unit)
    return segs


def opt_specs(pspecs: Any) -> AdamWState:
    """AdamW moments shard like their params."""
    return AdamWState(step=(), mu=pspecs, nu=pspecs)


def fsdp_upgrade(pspecs: Any, pshapes: Any, mesh, *, min_dim: int = 512) -> Any:
    """Additionally shard layer-stack weights over 'data' on their first
    free dim of at least ``min_dim`` that 'data' divides (FSDP-style 2D
    weight sharding). Only ``segments`` weights are upgraded: embed and
    lm_head stay vocab-sharded. ``pshapes`` holds each leaf's shape (a
    tensor, e.g. of ``init_params(device="meta")``, or a tuple)."""
    data = _axis_size(mesh, "data")

    def upgrade(spec, shape):
        shape = tuple(shape.shape) if hasattr(shape, "shape") else tuple(shape)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        for i, (ax, n) in enumerate(zip(dims, shape)):
            if ax is None and n >= min_dim and n % data == 0:
                dims[i] = "data"
                break
        return tuple(dims)

    out = dict(pspecs)
    out["segments"] = map_specs(upgrade, pspecs["segments"], pshapes["segments"])
    return out


def train_specs(cfg: ModelConfig, mesh, *, min_dim: int = 512) -> dict:
    """The training placement of the reference's ``build_train``
    (``launch/dryrun.py``): ``param_specs`` with ``fsdp_upgrade`` at
    ``min_dim`` (the AdamW moments take the same tree, ``opt_specs``)."""
    return fsdp_upgrade(param_specs(cfg, mesh), full_shapes(cfg), mesh, min_dim=min_dim)


@functools.lru_cache(maxsize=32)
def full_shapes(cfg: ModelConfig) -> dict:
    """The unsharded leaves of ``cfg`` as meta tensors (no memory)."""
    return M.init_params(cfg, device="meta")


def placed_specs(cfg: ModelConfig, params, mesh) -> dict:
    """The spec tree ``params``, this rank's shards, were cut by, read from
    their shapes: ``param_specs``, with ``"data"`` on the dim of a
    layer-stack leaf cut further over ``data`` (``fsdp_upgrade`` at any
    ``min_dim``; ``train_specs``). Raises ValueError where a leaf fits
    neither, or where a leaf outside the layer stacks is cut over ``data``."""
    D = _axis_size(mesh, "data")

    def place(spec, full, t, stacked):
        want, got = local_shape(full.shape, spec, mesh), tuple(t.shape)
        if got == want:
            return spec
        cut = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
        dims = list(spec) + [None] * (len(got) - len(spec))
        if (stacked and len(got) == len(want) and len(cut) == 1 and D > 1
                and dims[cut[0]] is None and want[cut[0]] == got[cut[0]] * D):
            dims[cut[0]] = "data"
            return tuple(dims)
        raise ValueError(f"a leaf of shape {got} fits neither its spec {spec} on mesh "
                         f"{dict(mesh.shape)} (local shape {want}) nor that spec cut once more "
                         "over 'data'")

    tp, full = param_specs(cfg, mesh), full_shapes(cfg)
    out = {k: place(tp[k], full[k], params[k], False) for k in tp if k != "segments"}
    out["segments"] = map_specs(lambda sp, f, t: place(sp, f, t, True), tp["segments"],
                                full["segments"], params["segments"])
    return out


def data_dims(cfg: ModelConfig, params, mesh) -> list:
    """Per segment and unit, a tree of the dim each stacked leaf of
    ``params`` is cut on over ``data`` (``placed_specs``), or None. The
    repeats dim is never one (a layer's view would lack it)."""
    def dim(spec):
        d = next((i for i, e in enumerate(spec) if "data" in _entry_axes(e)), None)
        if d == 0:
            raise ValueError("a layer stack cut over 'data' on its repeats dim: "
                             "raise fsdp_upgrade's min_dim above the layer count")
        return d

    return map_specs(dim, placed_specs(cfg, params, mesh)["segments"])


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a leaf of ``spec`` is sharded on, in the mesh's axis
    order ("pod", "data", "model")."""
    named = {a for e in spec for a in _entry_axes(e)}
    return tuple(a for a in ("pod", "data", "model") if a in named)


def specs_by_key(specs) -> Dict[str, Spec]:
    """{checkpoint key: spec} of a spec tree, with the key strings of
    ``training.checkpoint.map_with_path`` (``['embed']``, ``[0]``,
    ``.mu``), so that a tree in another key order finds its specs."""
    from repro_torch.training.checkpoint import map_with_path

    out: Dict[str, Spec] = {}
    map_with_path(out.__setitem__, specs, is_leaf=is_spec)
    return out


# -------------------------------------------------------------- local shards
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_factors(spec: Spec, mesh) -> list:
    """Per spec entry, the number of shards (the product of its axes' sizes)."""
    out = []
    for e in spec:
        n = 1
        for a in _entry_axes(e):
            n *= mesh.shape[a]
        out.append(n)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A leaf's shape on one rank; every sharded dim must divide evenly."""
    shape = list(shape)
    for d, n in enumerate(shard_factors(spec, mesh)):
        if shape[d] % n:
            raise ValueError(f"sharding: dim {d} of {tuple(shape)} does not split {n} ways "
                             f"(spec {spec})")
        shape[d] //= n
    return tuple(shape)


def _coord_index(entry, mesh, coords: Dict[str, int]) -> int:
    i = 0
    for a in _entry_axes(entry):
        i = i * mesh.shape[a] + coords[a]
    return i


def local_slices(shape: Sequence[int], spec: Spec, mesh, coords: Dict[str, int]) -> tuple:
    """The slice of each dim that rank ``coords`` holds."""
    loc = local_shape(shape, spec, mesh)
    out = []
    for d in range(len(shape)):
        if d < len(spec) and _entry_axes(spec[d]):
            i = _coord_index(spec[d], mesh, coords)
            out.append(slice(i * loc[d], (i + 1) * loc[d]))
        else:
            out.append(slice(None))
    return tuple(out)


def local_shard(tree, specs, mesh, coords: Optional[Dict[str, int]] = None):
    """The shards of a full tree (tensors or numpy arrays) that rank
    ``coords`` (default: ``mesh.coords``) holds, as contiguous copies."""
    coords = mesh.coords if coords is None else coords

    def cut(spec, a):
        part = a[local_slices(a.shape, spec, mesh, coords)]
        return part.contiguous() if isinstance(part, torch.Tensor) else part.copy()

    return map_specs(cut, specs, tree)
