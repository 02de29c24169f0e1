"""Core config dataclasses and the architecture registry.

A standalone copy of the reference package's ``config/base.py``: the port
imports nothing of the JAX package, so the fields, ``reduced()`` and the
layer-pattern rules are repeated here verbatim (tests build the same config
in both packages and compare like with like).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional


class AttentionKind(str, enum.Enum):
    FULL = "full"
    SLIDING = "sliding"          # sliding-window attention
    NONE = "none"                # attention-free (SSM) layer


class BlockKind(str, enum.Enum):
    """Per-layer mixer kind."""

    ATTENTION = "attention"
    MAMBA = "mamba"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    moe_layer_period: int = 1
    moe_layer_offset: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    exec_groups: int = 1
    infer_capacity_factor: float = 2.0
    prefill_dropless: bool = True

    def is_moe_layer(self, layer_idx: int) -> bool:
        return layer_idx % self.moe_layer_period == self.moe_layer_offset


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) hyperparameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A decoder architecture. One instance per ``--arch`` id."""

    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    source: str                      # citation (paper / model card)

    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32000
    head_dim: int = 0                # 0 -> d_model // num_heads

    attention_pattern: str = "full"  # "full" | "sliding" | "local_global:<n_local>" | "none"
    sliding_window: int = 4096
    rope_theta: float = 10_000.0
    max_position: int = 1 << 20

    attn_layer_period: int = 1
    attn_layer_offset: int = 0

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    num_image_tokens: int = 0
    num_codebooks: int = 0

    norm_eps: float = 1e-5
    act: str = "silu"                # silu (SwiGLU) | gelu
    mlp_gated: bool = True
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ layout
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (logits of padded ids are
        masked); kept so params and logits have the reference's shapes."""
        return ((self.vocab_size + 255) // 256) * 256

    def block_kind(self, layer_idx: int) -> BlockKind:
        if self.attention_pattern == "none":
            return BlockKind.MAMBA
        if self.attn_layer_period == 1:
            return BlockKind.ATTENTION
        if layer_idx % self.attn_layer_period == self.attn_layer_offset:
            return BlockKind.ATTENTION
        return BlockKind.MAMBA

    def attention_kind(self, layer_idx: int) -> AttentionKind:
        if self.block_kind(layer_idx) is not BlockKind.ATTENTION:
            return AttentionKind.NONE
        pat = self.attention_pattern
        if pat == "full":
            return AttentionKind.FULL
        if pat == "sliding":
            return AttentionKind.SLIDING
        if pat.startswith("local_global:"):
            n_local = int(pat.split(":")[1])
            return (
                AttentionKind.FULL
                if layer_idx % (n_local + 1) == n_local
                else AttentionKind.SLIDING
            )
        raise ValueError(f"unknown attention_pattern: {pat}")

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return self.moe.is_moe_layer(layer_idx)

    def has_mlp(self, layer_idx: int) -> bool:
        """Pure-SSM blocks (mamba2) have no separate MLP."""
        if self.family == "ssm":
            return False
        return self.d_ff > 0 or self.is_moe_layer(layer_idx)

    # ------------------------------------------------------------------ reduced
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 experts, small vocab."""
        d = min(self.d_model, 256)
        nh = max(1, min(self.num_heads, 4))
        nkv = max(1, min(self.num_kv_heads, nh))
        while nh % nkv:
            nkv -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 128),
                d_ff_shared=min(self.moe.d_ff_shared, 128) if self.moe.d_ff_shared else 0,
            )
        ssm = None
        if self.ssm is not None or self.family in ("ssm", "hybrid"):
            base = self.ssm or SSMConfig()
            ssm = dataclasses.replace(base, d_state=32, head_dim=32, chunk_size=32)
        n_layers = 2
        if self.attn_layer_period > 1 or self.attention_pattern.startswith("local_global"):
            n_layers = 4
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=64,
            moe=moe,
            ssm=ssm,
            num_image_tokens=min(self.num_image_tokens, 16) if self.num_image_tokens else 0,
            max_position=1 << 14,
            dtype="float32",
            attn_layer_period=min(self.attn_layer_period, 2),
            attn_layer_offset=min(self.attn_layer_offset, 1),
            attention_pattern=(
                "local_global:1"
                if self.attention_pattern.startswith("local_global")
                else self.attention_pattern
            ),
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


# ----------------------------------------------------------------------- registry
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_config(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populate registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
