"""Qwen1.5-MoE-A2.7B — fine-grained MoE with shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 60 routed experts top-4 + 4 shared experts,
per-expert FFN dim 1408 (shared block = 4x1408 = 5632).
"""
from repro_torch.config.base import ModelConfig, MoEConfig, register_config


@register_config("qwen2-moe-a2.7b")
def qwen2_moe_a2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        source="[hf:Qwen/Qwen1.5-MoE-A2.7B]",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,                 # per-expert dim (config d_ff)
        vocab_size=151936,
        attention_pattern="full",
        rope_theta=1_000_000.0,
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            d_ff_expert=1408,
            num_shared_experts=4,
            d_ff_shared=5632,      # 4 shared experts fused: 4 * 1408
        ),
    )
