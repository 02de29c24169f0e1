"""MusicGen-medium — decoder-only LM over EnCodec tokens. [arXiv:2306.05284]

4 codebooks; the EnCodec codec is not part of the model: the backbone takes
(B, S, 4) code indices, sums the 4 codebook embeddings a step and predicts
4 heads.
"""
from repro_torch.config.base import ModelConfig, register_config


@register_config("musicgen-medium")
def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        source="[arXiv:2306.05284] Simple and Controllable Music Generation (MusicGen)",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,           # MHA (kv=24)
        d_ff=6144,
        vocab_size=2048,           # EnCodec codebook size
        attention_pattern="full",
        num_codebooks=4,
        act="gelu",
        mlp_gated=False,
    )
