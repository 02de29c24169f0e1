"""Dynamically Switchable Inference Acceleration (DSIA) strategies (§4.1);
a copy of the reference's host module.

A DSIA strategy turns the target model into a cheaper *virtual* draft model
at runtime, with no training. Each strategy produces a ``DraftSpec`` the
engine can execute:

  - LayerSparsity   (SWIFT-style)      -> layer gate vector
  - EarlyExit       (Kangaroo-style)   -> prefix gate vector
  - ActivationQuant (QSpec-style)      -> int8 weight quantization flag
  - StreamingAttention (TriForce/MagicDec-style) -> attention override
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DraftSpec:
    name: str
    kind: str = "neural"                 # neural | retrieval
    gates: Optional[Tuple[int, ...]] = None   # per-layer 0/1 (None = all on)
    quantize: Optional[str] = None       # "int8" | None
    attn_override: Optional[Tuple[str, int, int]] = None  # (kind, window, sink)
    prior_alpha: float = 0.5             # cold-start acceptance prior (App. D)
    prior_c: float = 0.5                 # cold-start cost-coefficient prior

    def gates_array(self, num_layers: int) -> np.ndarray:
        if self.gates is None:
            return np.ones((num_layers,), np.float32)
        if len(self.gates) != num_layers:
            raise ValueError(f"{self.name}: {len(self.gates)} gates for {num_layers} layers")
        return np.asarray(self.gates, np.float32)

    def unsupported_by_gates_only(self) -> Tuple[str, ...]:
        """Spec fields that a gates-only drafting path cannot honor (the
        batched server's chain_fused and tree_fused modes)."""
        bad = []
        if self.quantize is not None:
            bad.append(f"quantize={self.quantize!r}")
        if self.attn_override is not None:
            bad.append(f"attn_override={self.attn_override!r}")
        return tuple(bad)


def layer_sparsity(cfg: ModelConfig, sparsity: float, name: Optional[str] = None) -> DraftSpec:
    """Skip ``sparsity`` fraction of layers, evenly interleaved, keeping the
    first and last layers."""
    L = cfg.num_layers
    n_skip = int(round(L * sparsity))
    n_skip = min(n_skip, max(L - 2, 0))
    gates = np.ones(L, np.int32)
    if n_skip > 0 and L > 2:
        cand = np.linspace(1, L - 2, n_skip)
        idx = np.unique(np.round(cand).astype(int))
        i = 1
        while len(idx) < n_skip and i < L - 1:   # fill collisions
            if i not in idx:
                idx = np.sort(np.append(idx, i))
            i += 1
        gates[idx[:n_skip]] = 0
    frac = 1.0 - gates.mean()
    return DraftSpec(
        name=name or f"LS{sparsity:.1f}",
        gates=tuple(int(g) for g in gates),
        prior_alpha=max(0.05, 0.95 - 1.1 * frac),
        prior_c=max(0.05, 1.0 - frac),
    )


def early_exit(cfg: ModelConfig, fraction: float, name: Optional[str] = None) -> DraftSpec:
    """Exit after the first ``fraction`` of layers (Kangaroo's shallow net)."""
    L = cfg.num_layers
    e = max(1, int(round(L * fraction)))
    gates = np.zeros(L, np.int32)
    gates[:e] = 1
    return DraftSpec(
        name=name or f"EE{fraction:.2f}",
        gates=tuple(int(g) for g in gates),
        prior_alpha=max(0.05, 0.9 * fraction),
        prior_c=max(0.05, fraction),
    )


def activation_quant(cfg: ModelConfig, bits: int = 8, base: Optional[DraftSpec] = None) -> DraftSpec:
    """QSpec-style quantized drafting (the engine fake-quantizes weights)."""
    name = f"{base.name}+Q{bits}" if base else f"Q{bits}"
    return DraftSpec(
        name=name,
        gates=base.gates if base else None,
        quantize=f"int{bits}",
        prior_alpha=(base.prior_alpha if base else 0.9) * 0.95,
        prior_c=(base.prior_c if base else 1.0) * 0.55,
    )


def streaming_attention(
    cfg: ModelConfig, window: int = 512, sink: int = 4, base: Optional[DraftSpec] = None
) -> DraftSpec:
    """StreamingLLM-style efficient attention for drafting (long-context)."""
    name = f"{base.name}+SA{window}" if base else f"SA{window}"
    return DraftSpec(
        name=name,
        gates=base.gates if base else None,
        attn_override=("streaming", window, sink),
        prior_alpha=(base.prior_alpha if base else 0.9) * 0.95,
        prior_c=(base.prior_c if base else 1.0) * 0.7,
    )


PLD_SPEC = DraftSpec(name="PLD", kind="retrieval", prior_alpha=0.3, prior_c=0.01)


def build_hierarchy(
    cfg: ModelConfig,
    mode: str = "scaling",
    sparsities: Tuple[float, ...] = (0.4, 0.6),
) -> List[DraftSpec]:
    """Draft-model hierarchy per §4.1 (decreasing cost, decreasing alpha),
    bottomed by PLD. mode='scaling' is the paper's main configuration."""
    if mode == "scaling":
        drafts = [layer_sparsity(cfg, s) for s in sparsities]
    elif mode == "mixing":
        ls = layer_sparsity(cfg, sparsities[0])
        drafts = [ls, activation_quant(cfg, 8, base=layer_sparsity(cfg, sparsities[-1]))]
    elif mode == "replacing":
        drafts = [streaming_attention(cfg), activation_quant(cfg, 8)]
    elif mode == "early_exit":
        drafts = [early_exit(cfg, 0.5), early_exit(cfg, 0.25)]
    else:
        raise ValueError(f"unknown hierarchy mode {mode!r}")
    return drafts + [PLD_SPEC]
