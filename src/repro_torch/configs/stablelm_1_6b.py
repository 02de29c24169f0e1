"""StableLM-2-1.6B — dense decoder. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.config.base import ModelConfig, register_config


@register_config("stablelm-1.6b")
def stablelm_1_6b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        source="[hf:stabilityai/stablelm-2-1_6b]",
        num_layers=24,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,           # MHA (kv=32)
        d_ff=5632,
        vocab_size=100352,
        attention_pattern="full",
        rope_theta=10_000.0,
    )
