"""Train step: next-token cross entropy and the AdamW update, the
reference's (``src/repro/training/train_step.py``) on the port's model.

On a mesh (``models.shard_utils.use_mesh``; sharded training) every
function here runs on this rank's shards and its rows of the data axes,
and computes what the reference's GSPMD step computes unsharded: the
cross entropy is the global batch's mean, the MoE losses the global
batch's, and the gradients, summed over the data axes, are the global
loss's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import shard_utils as SU
from repro_torch.training.optimizer import AdamWState, adamw_update, cosine_lr, global_norm


def loss_fn(
    cfg: ModelConfig,
    params: Any,
    batch: Dict[str, Any],
    *,
    remat: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (the shift by one is inside) plus the MoE
    auxiliary loss (0 on a stack without MoE layers). ``batch["tokens"]``
    is (B, S), or (B, S, nc) on a codebook stack, whose per-position NLL is
    the mean over the codebooks; an optional ``loss_mask`` (B, S-1) weights
    the targets. Returns (loss, {"ce", "moe_aux", "loss"}).

    On a mesh with data axes ``batch`` is this rank's rows (as many on
    every rank): the returned loss is this rank's share, its rows' NLL over
    the global target count (the mask's sum all-reduced) plus the global
    aux, whose gradients summed over the data axes are the global loss's;
    the metrics are the global values, on every rank."""
    logits, aux = M.forward_train(cfg, params, batch, remat=remat)
    tokens = torch.as_tensor(batch["tokens"], device=logits.device).long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, ..., None])[..., 0]
    if cfg.num_codebooks:
        nll = nll.mean(dim=-1)                       # (B, S-1, nc) -> (B, S-1)
    dp = SU.data_axis()
    mask = batch.get("loss_mask")
    if mask is None:
        ce = nll.mean()
        if dp:
            ce = ce * (1.0 / SU.data_size())
    else:
        m = torch.as_tensor(mask, device=nll.device).float()
        count = m.sum() if not dp else SU.all_sum(m.sum(), dp)
        ce = (nll * m).sum() / torch.clamp(count, min=1.0)
    total = ce + aux
    if not dp:
        return total, {"ce": ce, "moe_aux": aux, "loss": total}
    ce_all = SU.all_sum(ce.detach().clone(), dp)
    return total, {"ce": ce_all, "moe_aux": aux.detach(), "loss": ce_all + aux.detach()}


def loss_and_grads(
    cfg: ModelConfig,
    params: Any,
    batch: Dict[str, Any],
    *,
    remat: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
    """``loss_fn`` and the gradient of every leaf of ``params`` (in
    ``tree_leaves`` order). On a mesh with data axes each leaf's gradient
    is summed over the data axes it is replicated on (in place, one
    all-reduce a leaf); a leaf cut over ``data`` got its slice of the sum
    over ``data`` from its gather's backward (``forward_train``)."""
    leaves = [p.detach().requires_grad_() for p in M.tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, M.tree_unflatten(params, leaves), batch, remat=remat)
        grads = list(torch.autograd.grad(loss, leaves))
    dp = SU.data_axis()
    if dp:
        for i, axes in enumerate(_leaf_axes(cfg, params)):
            rest = tuple(a for a in dp if a not in axes)
            if rest:
                grads[i] = SU.all_sum(grads[i], rest)
    return loss, metrics, grads


def make_train_step(
    cfg: ModelConfig,
    *,
    peak_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    remat: bool = True,
):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of ``loss_fn``, the cosine learning rate at the
    state's step and one AdamW update, which writes ``params`` and the
    moments in place. ``metrics``: ce, moe_aux, loss, lr and grad_norm
    (before the clip), 0-d tensors on the params' device.

    Under an active mesh (``shard_utils.use_mesh``) the step trains this
    rank's shards (``init_params(mesh=, specs=launch.sharding.train_specs(
    ...))``; the moments ``adamw_init`` makes beside them take their specs)
    on its rows of the data axes; the gradient norm and the clip are the
    global ones (``global_norm(axes=)``), the metrics the global values on
    every rank."""

    def train_step(params, opt_state: AdamWState, batch):
        _, metrics, grads = loss_and_grads(cfg, params, batch, remat=remat)
        lr = cosine_lr(opt_state.step, peak=peak_lr, warmup=warmup, total=total_steps)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lr"] = lr
        axes = None if SU.active_mesh() is None else _leaf_axes(cfg, params)
        metrics["grad_norm"] = global_norm(grads, axes)
        params, opt_state = adamw_update(params, M.tree_unflatten(params, grads), opt_state, lr=lr,
                                         grad_norm=metrics["grad_norm"])
        return params, opt_state, metrics

    return train_step


def _leaf_axes(cfg: ModelConfig, params) -> List[Tuple[str, ...]]:
    """The mesh axes each leaf of ``params`` (this rank's shards) is
    sharded on, in ``tree_leaves`` order (``launch.sharding.placed_specs``)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.training.checkpoint import map_with_path

    by_key = SH.specs_by_key(SH.placed_specs(cfg, params, SU.active_mesh()))
    out: List[Tuple[str, ...]] = []
    map_with_path(lambda k, _: out.append(SH.spec_axes(by_key[k])), params)
    return out
