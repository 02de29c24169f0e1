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

import json
import os
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.moe import keeps_float32


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(key, leaf)`` for every leaf of nested dicts, lists and named
    tuples, with the reference's key string; returns the tree of results."""
    def sub(key):
        return f"{path}/{key}" if path else key

    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, sub(f"[{k!r}]")) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), sub(f".{f}")) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, sub(f"[{i}]")) for i, v in enumerate(tree))
    return fn(path, tree)


def _write_npz(file: str, tree) -> None:
    """``np.savez``'s format, one leaf in host memory at a time."""
    with zipfile.ZipFile(file, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        def put(key, leaf):
            a = leaf.detach().cpu()
            a = a.view(torch.int16).numpy().view("V2") if a.dtype == torch.bfloat16 else a.numpy()
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)

        map_with_path(put, tree)


def save_checkpoint(path: str, params: Any, opt_state: Any = None, step: int = 0) -> None:
    """Write ``params`` (and ``opt_state``, an ``AdamWState``) and ``step``
    into the directory ``path``, in the reference's format."""
    os.makedirs(path, exist_ok=True)
    _write_npz(os.path.join(path, "params.npz"), params)
    if opt_state is not None:
        _write_npz(os.path.join(path, "opt.npz"), opt_state)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": int(step)}, f)


def read_npz(file: str, template, device: torch.device, dtype: Optional[torch.dtype] = None):
    """The tree of ``template`` with every leaf read from ``file`` onto
    ``device`` (float leaves as ``dtype`` when given, except those the
    reference keeps in float32: ``models.moe.keeps_float32``). The template
    gives only names and shapes (meta tensors will do)."""
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
            return t.to(device=device, dtype=dtype if cast else None)

        return map_with_path(read, template)


def load_checkpoint(path: str, params_template: Any, opt_template: Any = None, *,
                    device="cuda"):
    """Restore into the structure and shapes of the templates, on ``device``.
    Returns (params, [opt_state,] step)."""
    dev = resolve_device(device)
    out = [read_npz(os.path.join(path, "params.npz"), params_template, dev)]
    if opt_template is not None:
        out.append(read_npz(os.path.join(path, "opt.npz"), opt_template, dev))
    with open(os.path.join(path, "meta.json")) as f:
        out.append(json.load(f)["step"])
    return tuple(out)
