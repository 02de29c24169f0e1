"""Carry the reference package's params and caches into the port.

Both packages keep the same layouts (see ``models/model.py``), so a
conversion is a dtype and device move of every leaf. The inputs are nested
dicts/lists of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)`` of
the reference's ``init_params``, or a checkpoint directory in the
reference's format (``params_from_checkpoint``); this module imports
neither JAX nor the reference package. bfloat16 leaves (numpy's
``ml_dtypes.bfloat16``) pass through float32, which holds every bfloat16
value exactly. A leaf the reference keeps in float32 whatever the model's
type (the MoE router, ``models.moe.FLOAT32_LEAVES``; a Mamba-2 block's
``A_log``, ``D`` and ``dt_bias``, ``models.ssm.FLOAT32_LEAVES``) stays
float32 when ``dtype`` asks for another type.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.models.model import init_params, tree_map
from repro_torch.models.moe import keeps_float32
from repro_torch.training.checkpoint import map_with_path, read_npz


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        t = t.to(dtype or (torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32))
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_jax(params, *, device="cuda", dtype: Optional[torch.dtype] = None, cfg=None,
                    mesh=None, specs=None) -> dict:
    """Reference params (nested numpy) -> port params on ``device``; float
    leaves become ``dtype`` (default: the leaf's own float type), except
    those the reference keeps in float32. ``mesh`` (with ``cfg``): this
    rank's shards, cut by ``specs`` (default ``launch.sharding.param_specs``;
    training's tree is ``launch.sharding.train_specs``)."""
    dev = resolve_device(device)
    if mesh is not None:
        params = _local(params, "param_specs", cfg, mesh, specs)
    return map_with_path(lambda key, a: _leaf(a, dev, None if keeps_float32(key) else dtype),
                         params)


def opt_state_from_jax(state, *, device="cuda", cfg=None, mesh=None, specs=None):
    """The reference's ``AdamWState`` (step, mu, nu; numpy leaves) -> the
    port's on ``device``: the moments float32, cut on ``mesh`` by
    ``launch.sharding.opt_specs`` of ``specs`` as ``params_from_jax`` cuts
    their params."""
    from repro_torch.training.optimizer import AdamWState

    dev = resolve_device(device)
    mu, nu = (params_from_jax(t, device=dev, cfg=cfg, mesh=mesh, specs=specs)
              for t in (state.mu, state.nu))
    return AdamWState(step=torch.as_tensor(np.asarray(state.step), dtype=torch.int32, device=dev),
                      mu=mu, nu=nu)


def cache_from_jax(cache, *, device="cuda", cfg=None, mesh=None) -> dict:
    """Reference cache (nested numpy), dense or paged (``k_pages``,
    ``v_pages``, ``page_table``: the same layout in both packages) -> port
    cache on ``device``. ``mesh`` (with ``cfg``): this rank's shard
    (``launch.sharding.cache_specs`` at the cache's own batch)."""
    dev = resolve_device(device)
    if mesh is not None:
        cache = _local(cache, "cache_specs", cfg, mesh)
    return tree_map(lambda a: _leaf(a, dev, None), cache)


def _local(tree, specs: str, cfg, mesh, spec_tree=None):
    """The numpy tree cut to this rank's shards under ``spec_tree``, or
    the spec tree ``specs`` names."""
    from repro_torch.launch import sharding as SH

    if spec_tree is not None:
        return SH.local_shard(tree, spec_tree, mesh)
    if cfg is None:
        raise ValueError("bridge: a mesh needs the model's cfg for its spec trees")
    if specs == "param_specs":
        spec_tree = SH.param_specs(cfg, mesh)
    else:
        spec_tree = SH.cache_specs(cfg, mesh, global_batch=int(np.shape(tree["pos"])[0]),
                                   paged="page_table" in tree)
    return SH.local_shard(tree, spec_tree, mesh)


def params_from_checkpoint(path: str, cfg: ModelConfig, *, device="cuda",
                           dtype: Optional[torch.dtype] = None) -> dict:
    """The params of a checkpoint directory in the reference's format
    (``params.npz``, written by either package's ``save_checkpoint``) in the
    port's layout on ``device``, float leaves as ``dtype`` (default: as
    stored). ``cfg`` gives the names and shapes; no params are drawn."""
    dev = resolve_device(device)
    return read_npz(os.path.join(path, "params.npz"), init_params(cfg, device="meta"), dev, dtype)
