"""Checkpoints in the reference's on-disk format
(``src/repro/training/checkpoint.py``), written and read without JAX.

A checkpoint is a directory: ``params.npz``, an optional ``opt.npz`` and
``meta.json`` (``{"step": n}``). A leaf's key is its path in the
reference's tree as ``jax.tree_util`` prints it, joined by "/": a dict key
``['embed']``, a list index ``[0]``, a named-tuple field ``.mu``; so
``['segments']/[0]/[0]/['attn']/['wq']`` and ``.mu/['embed']``. A checkpoint
written by either package loads into the other. bfloat16 leaves are stored
as the reference's numpy stores them without a bfloat16 type: their raw
two bytes, ``<V2``.
"""
from __future__ import annotations

import contextlib
import json
import os
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.moe import keeps_float32


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = "", *,
                  is_leaf: Callable[[Any], bool] = lambda x: False):
    """``fn(key, leaf)`` for every leaf of nested dicts, lists and named
    tuples (and every node ``is_leaf`` takes for one), with the
    reference's key string; returns the tree of results."""
    def sub(key):
        return f"{path}/{key}" if path else key

    def down(v, key):
        return map_with_path(fn, v, sub(key), is_leaf=is_leaf)

    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: down(v, f"[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(down(getattr(tree, f), f".{f}") for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(down(v, f"[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def _write_npz(file: Optional[str], tree, fetch: Callable = lambda key, leaf: leaf) -> None:
    """``np.savez``'s format, one leaf in host memory at a time; each leaf
    is ``fetch(key, leaf)``. ``file`` None writes nothing but still fetches
    every leaf, in the same order (a mesh rank other than 0)."""
    with contextlib.ExitStack() as stack:
        zf = None if file is None else stack.enter_context(
            zipfile.ZipFile(file, "w", zipfile.ZIP_STORED, allowZip64=True))

        def put(key, leaf):
            a = fetch(key, leaf).detach()
            if zf is None:
                return
            a = a.cpu()
            a = a.view(torch.int16).numpy().view("V2") if a.dtype == torch.bfloat16 else a.numpy()
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)

        map_with_path(put, tree)


def save_checkpoint(path: str, params: Any, opt_state: Any = None, step: int = 0, *,
                    mesh=None, cfg=None) -> None:
    """Write ``params`` (and ``opt_state``, an ``AdamWState``) and ``step``
    into the directory ``path``, in the reference's format.

    ``mesh``: every rank calls this with its shards of the model ``cfg``;
    their spec tree is read from their shapes
    (``launch.sharding.placed_specs``; the moments take the same), each
    leaf is gathered whole over the axes it is sharded on, one leaf at a
    time, and rank 0 writes the full tree."""
    if mesh is None:
        os.makedirs(path, exist_ok=True)
        _write_npz(os.path.join(path, "params.npz"), params)
        if opt_state is not None:
            _write_npz(os.path.join(path, "opt.npz"), opt_state)
    else:
        from repro_torch.launch import sharding as SH
        from repro_torch.models import shard_utils as SU

        if cfg is None:
            raise ValueError("save_checkpoint(mesh=) needs the model's cfg to place the shards")
        lead = mesh.rank == 0
        if lead:
            os.makedirs(path, exist_ok=True)
        specs = SH.placed_specs(cfg, params, mesh)
        by_key = SH.specs_by_key(specs)
        by_key.update(SH.specs_by_key(SH.opt_specs(specs)))

        def whole(key, leaf):
            for dim, entry in enumerate(by_key[key]):
                if entry is not None:
                    leaf = SU.gather(leaf, dim, entry)
            return leaf

        with SU.use_mesh(mesh):
            for name, tree in (("params", params), ("opt", opt_state)):
                if tree is not None:
                    _write_npz(os.path.join(path, f"{name}.npz") if lead else None, tree, whole)
        if not lead:
            return
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": int(step)}, f)


def read_npz(file: str, template, device: torch.device, dtype: Optional[torch.dtype] = None,
             cut: Callable = lambda key, t: t):
    """The tree of ``template`` with every leaf read from ``file`` onto
    ``device`` (float leaves as ``dtype`` when given, except those the
    reference keeps in float32: ``models.moe.keeps_float32``). The template
    gives only names and shapes (meta tensors will do). ``cut(key, leaf)``
    takes each leaf's part on the host before it moves."""
    with np.load(file, allow_pickle=False) as data:
        def read(key, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            a = data[key]
            t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if a.dtype == np.dtype("V2")
                 else torch.from_numpy(a))
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {key}: checkpoint shape {tuple(t.shape)}, "
                                 f"expected {tuple(leaf.shape)}")
            cast = dtype and t.is_floating_point() and not keeps_float32(key)
            return cut(key, t).contiguous().to(device=device, dtype=dtype if cast else None)

        return map_with_path(read, template)


def load_checkpoint(path: str, params_template: Any, opt_template: Any = None, *,
                    device="cuda", mesh=None, specs=None):
    """Restore into the structure and shapes of the templates, on ``device``.
    Returns (params, [opt_state,] step). ``mesh``: this rank's shards of
    the full tree, cut by ``specs`` (the params' spec tree, e.g.
    ``launch.sharding.train_specs``; the moments take the same); the
    templates hold the full shapes."""
    dev = resolve_device(device)
    cut = lambda key, t: t  # noqa: E731
    if mesh is not None:
        from repro_torch.launch import sharding as SH

        by_key = SH.specs_by_key(specs)
        by_key.update(SH.specs_by_key(SH.opt_specs(specs)))
        cut = lambda key, t: t[SH.local_slices(t.shape, by_key[key], mesh, mesh.coords)]  # noqa: E731
    out = [read_npz(os.path.join(path, "params.npz"), params_template, dev, cut=cut)]
    if opt_template is not None:
        out.append(read_npz(os.path.join(path, "opt.npz"), opt_template, dev, cut=cut))
    with open(os.path.join(path, "meta.json")) as f:
        out.append(json.load(f)["step"])
    return tuple(out)
