"""Mamba2-130m — pure SSM with state-space duality (SSD). [arXiv:2405.21060]"""
from repro_torch.config.base import ModelConfig, SSMConfig, register_config


@register_config("mamba2-130m")
def mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        source="[arXiv:2405.21060] Transformers are SSMs (Mamba-2)",
        num_layers=24,
        d_model=768,
        num_heads=0,               # attention-free
        num_kv_heads=0,
        d_ff=0,                    # Mamba2 block has no separate MLP
        vocab_size=50280,
        attention_pattern="none",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
        tie_embeddings=True,
    )
