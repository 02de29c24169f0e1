"""Primitive layers: norms, RoPE, MLPs, embeddings — plain functions on tensors."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import QuantWeight, quantized_matmul
from repro_torch.models import shard_utils as SU


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm scaled by ``(1 + weight)``: the reference stores the norm
    weight as an offset from one (zero-initialised)."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (..., S, H, head_dim) by per-token integer ``positions`` (..., S):
    the split-half rotation, angles in float32."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    ang = positions.float()[..., None] * inv                 # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Init:
    """How one parameter leaf is drawn: a standard normal times ``scale``,
    or zeros when ``scale`` is None (``models.model.init_params`` draws it);
    a leaf with ``fixed`` takes ``fixed(numel, device)``, a deterministic
    value, instead."""

    shape: Tuple[int, ...]
    scale: Optional[float]
    dtype: torch.dtype
    fixed: Optional[Callable[[int, torch.device], torch.Tensor]] = None


# ----------------------------------------------------------------------- MLP
def mlp_init(d_model: int, d_ff: int, gated: bool, dtype: torch.dtype) -> dict:
    """The leaves of the reference's ``layers.mlp_init``: names, shapes and
    scales."""
    p = {"w_up": Init((d_model, d_ff), d_model ** -0.5, dtype),
         "w_down": Init((d_ff, d_model), d_ff ** -0.5, dtype)}
    if gated:
        p["w_gate"] = Init((d_model, d_ff), d_model ** -0.5, dtype)
    return p


def _mm(x: torch.Tensor, w, quantize, k_axes=None) -> torch.Tensor:
    """(..., d) @ (d, f), optionally through the W8A8 kernel
    (``quantize="int8"``: dynamic per-row activation / per-column weight
    int8, the ActivationQuant DSIA's execution). A ``QuantWeight`` (the
    weight quantized once) takes only ``quantize="int8"``. ``k_axes``: the
    mesh axes d is sharded on (``kernels.ops.quantized_matmul``)."""
    if quantize is None and not isinstance(w, QuantWeight):
        return x @ w
    if quantize != "int8":
        raise ValueError(f"unsupported quantize mode {quantize!r} for this weight")
    out = quantized_matmul(x.reshape(-1, x.shape[-1]), w, k_axes=k_axes)
    return out.reshape(*x.shape[:-1], out.shape[-1]).to(x.dtype)


def mlp_apply(params: dict, x: torch.Tensor, act: str, gated: bool, quantize=None) -> torch.Tensor:
    """SwiGLU/GeGLU (gated) or plain 2-matrix MLP. ``quantize`` routes the
    projections through the W8A8 kernel. On a mesh d_ff is this rank's and
    the result is its partial sum (the caller sums it over ``model``)."""
    fn = F.silu if act == "silu" else _gelu_tanh
    k_axes = "model" if SU.tensor_parallel() else None
    if gated:
        g = fn(_mm(x, params["w_gate"], quantize))
        u = _mm(x, params["w_up"], quantize)
        return _mm(g * u, params["w_down"], quantize, k_axes)
    h = fn(_mm(x, params["w_up"], quantize))
    return _mm(h, params["w_down"], quantize, k_axes)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


# ----------------------------------------------------------------- embeddings
def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embedding[tokens]


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (d, V) -> logits in float32."""
    return x.float() @ head.float()
