"""LLaVA-NeXT (Mistral-7B backbone) — VLM; the vision tower is not part of
the model. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

anyres tiling gives up to 2880 patch-embedding tokens (5 tiles x 576); the
caller passes precomputed patch embeddings (``image_embeds``, with an
``image_mask``), which the backbone splices in front of the text.
"""
from repro_torch.config.base import ModelConfig, register_config


@register_config("llava-next-mistral-7b")
def llava_next_mistral_7b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        source="[hf:llava-hf/llava-v1.6-mistral-7b-hf] LLaVA-NeXT, Mistral-7B backbone",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,            # GQA kv=8
        d_ff=14336,
        vocab_size=32000,
        attention_pattern="full",
        rope_theta=1_000_000.0,
        num_image_tokens=2880,     # anyres: 4 tiles + base image, 576 tokens each
    )
