"""Carry the reference package's params and caches into the port.

Both packages keep the same layouts (see ``models/model.py``), so a
conversion is a dtype and device move of every leaf. The inputs are nested
dicts/lists of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)`` of
the reference's ``init_params``; this module imports neither JAX nor the
reference package. bfloat16 leaves (numpy's ``ml_dtypes.bfloat16``) pass
through float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import tree_map


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        t = t.to(dtype or (torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32))
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_jax(params, *, device="cuda", dtype: Optional[torch.dtype] = None) -> dict:
    """Reference params (nested numpy) -> port params on ``device``; float
    leaves become ``dtype`` (default: the leaf's own float type)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev, dtype), params)


def cache_from_jax(cache, *, device="cuda") -> dict:
    """Reference dense cache (nested numpy) -> port cache on ``device``."""
    if "page_table" in cache:
        raise NotImplementedError("paged KV caches are not ported yet")
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev, None), cache)
