"""Gemma-3-1B — 5:1 local:global attention, 128k context, huge vocab.

[hf:google/gemma-3-1b-pt] — local layers use a 1024-token sliding window,
every 6th layer is global full attention.
"""
from repro_torch.config.base import ModelConfig, register_config


@register_config("gemma3-1b")
def gemma3_1b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        source="[hf:google/gemma-3-1b-pt]",
        num_layers=26,
        d_model=1152,
        num_heads=4,
        num_kv_heads=1,            # MQA (kv=1)
        d_ff=6912,
        vocab_size=262144,
        attention_pattern="local_global:5",   # 5 sliding : 1 full
        sliding_window=1024,
        rope_theta=1_000_000.0,
        max_position=131_072,
        act="gelu",
        tie_embeddings=True,
    )
