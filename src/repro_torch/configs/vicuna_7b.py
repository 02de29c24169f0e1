"""Vicuna-7B-v1.3 (Llama-7B class) — the paper's own evaluation target."""
from repro_torch.config.base import ModelConfig, register_config


@register_config("vicuna-7b")
def vicuna_7b() -> ModelConfig:
    return ModelConfig(
        name="vicuna-7b",
        family="dense",
        source="[lmsys Vicuna-7B-v1.3 / arXiv:2302.13971 Llama] paper's eval target",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,           # Llama-1 class: MHA
        d_ff=11008,
        vocab_size=32000,
        attention_pattern="full",
        rope_theta=10_000.0,
    )
