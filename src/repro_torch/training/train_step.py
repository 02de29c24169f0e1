"""Train step: next-token cross entropy and the AdamW update, the
reference's (``src/repro/training/train_step.py``) on the port's model."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import model as M
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
    the targets. Returns (loss, {"ce", "moe_aux", "loss"})."""
    logits, aux = M.forward_train(cfg, params, batch, remat=remat)
    tokens = torch.as_tensor(batch["tokens"], device=logits.device).long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, ..., None])[..., 0]
    if cfg.num_codebooks:
        nll = nll.mean(dim=-1)                       # (B, S-1, nc) -> (B, S-1)
    mask = batch.get("loss_mask")
    if mask is None:
        ce = nll.mean()
    else:
        m = torch.as_tensor(mask, device=nll.device).float()
        ce = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    total = ce + aux
    return total, {"ce": ce, "moe_aux": aux, "loss": total}


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
    (before the clip), 0-d tensors on the params' device."""

    def train_step(params, opt_state: AdamWState, batch):
        leaves = [p.detach().requires_grad_() for p in M.tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, M.tree_unflatten(params, leaves), batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
        lr = cosine_lr(opt_state.step, peak=peak_lr, warmup=warmup, total=total_steps)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lr"] = lr
        metrics["grad_norm"] = global_norm(grads)
        params, opt_state = adamw_update(params, M.tree_unflatten(params, grads), opt_state, lr=lr)
        return params, opt_state, metrics

    return train_step
