"""Mixtral-8x22B — sparse MoE with sliding-window attention. [arXiv:2401.04088]"""
from repro_torch.config.base import ModelConfig, MoEConfig, register_config


@register_config("mixtral-8x22b")
def mixtral_8x22b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        source="[arXiv:2401.04088] Mixtral of Experts",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,            # GQA kv=8
        d_ff=16384,
        vocab_size=32768,
        attention_pattern="sliding",
        sliding_window=4096,       # SWA per the Mixtral report
        rope_theta=1_000_000.0,
        moe=MoEConfig(
            num_experts=8,
            top_k=2,
            d_ff_expert=16384,
        ),
    )
