"""StarCoder2-3B — dense code model, GQA + RoPE. [arXiv:2402.19173]"""
from repro_torch.config.base import ModelConfig, register_config


@register_config("starcoder2-3b")
def starcoder2_3b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        source="[arXiv:2402.19173] StarCoder 2 and The Stack v2",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,            # GQA kv=2
        d_ff=12288,
        vocab_size=49152,
        attention_pattern="full",
        rope_theta=100_000.0,
        act="gelu",
        mlp_gated=False,
    )
