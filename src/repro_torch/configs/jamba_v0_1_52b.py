"""Jamba-v0.1 (52B) — hybrid Mamba+attention with MoE. [arXiv:2403.19887]

Attn:Mamba 1:7 interleave (1 attention layer per 8-layer block), MoE every
other layer with 16 experts top-2.
"""
from repro_torch.config.base import ModelConfig, MoEConfig, SSMConfig, register_config


@register_config("jamba-v0.1-52b")
def jamba_v0_1_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="[arXiv:2403.19887] Jamba: A Hybrid Transformer-Mamba Language Model",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,            # GQA kv=8
        d_ff=14336,
        vocab_size=65536,
        attention_pattern="full",
        rope_theta=10_000.0,
        attn_layer_period=8,       # 1:7 attn:mamba
        attn_layer_offset=4,       # attention sits mid-block, per the paper
        moe=MoEConfig(
            num_experts=16,
            top_k=2,
            d_ff_expert=14336,
            moe_layer_period=2,    # every other layer is MoE
            moe_layer_offset=1,
        ),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    )
