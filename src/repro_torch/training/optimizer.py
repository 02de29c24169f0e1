"""AdamW with decoupled weight decay and the cosine schedule, the
reference's rule (``src/repro/training/optimizer.py``) on the port's
nested-dict trees.

The rule: a global-norm clip over every gradient; ``b2 = 0.95``; bias
corrections at ``step + 1``; ``(m / bc1) / (sqrt(v / bc2) + eps)``; and
decay ``lr * wd * p`` only for leaves with ``ndim >= 2``. In the stacked
layout the per-layer norms are (L, d) leaves, so they ARE decayed, and
``final_norm`` (d,) is not.

Unlike the reference, whose arrays are immutable, ``adamw_update`` writes
the params and the moments in place (float32 params, gradients and two
moments are 16 bytes a parameter; a second copy of three of them would
not fit a full-width model on one card) and returns the same trees.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.models import shard_utils as SU
from repro_torch.models.model import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32, the updates taken
    mu: Any
    nu: Any


def adamw_init(params: Any) -> AdamWState:
    """Zero moments (float32) beside ``params``, on their device."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_lr(step, *, peak: float = 3e-4, warmup: int = 100, total: int = 10_000,
              floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor * peak`` at ``total``; float32, on ``step``'s device."""
    s = torch.as_tensor(step).float()
    warm = peak * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)


def global_norm(grads: Sequence[torch.Tensor], axes: Optional[Sequence[tuple]] = None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, float32. ``axes`` (on a
    mesh): per gradient, the mesh axes its leaf is sharded on
    (``launch.sharding.spec_axes``). A leaf's sum of squares is then summed
    over those axes (one all-reduce of the leaves' sums for each set of
    axes) and counted once over the axes it is replicated on; the leaves'
    totals are added in leaf order, as the one-device sum adds them."""
    if axes is None:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))
    sq = torch.stack([g.float().square().sum() for g in grads])
    for key in dict.fromkeys(a for a in axes if a):
        mask = torch.tensor([a == key for a in axes], device=sq.device)
        sq = torch.where(mask, SU.all_sum(torch.where(mask, sq, 0.0), key), sq)
    return torch.sqrt(sum(sq.unbind()))


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Any,
    state: AdamWState,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    grad_norm: Optional[torch.Tensor] = None,
) -> Tuple[Any, AdamWState]:
    """One AdamW update of ``params`` by ``grads`` (trees of one structure),
    in place. Returns (params, the state at ``step + 1``). ``grad_norm``:
    the gradients' global norm where the caller has it (on a mesh, over
    the shards: ``global_norm(axes=)``); the update is elementwise, so on
    a mesh it runs on each rank's shards as they are."""
    p_l, g_l, m_l, v_l = (tree_leaves(t) for t in (params, grads, state.mu, state.nu))
    if grad_norm is None:
        grad_norm = global_norm(g_l)
    scale = torch.clamp(grad_clip / torch.clamp(grad_norm, min=1e-9), max=1.0)
    step = state.step + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(p_l, g_l, m_l, v_l):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if p.ndim >= 2:
            update = update + weight_decay * p.float()
        p.copy_(p.float() - lr * update)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
