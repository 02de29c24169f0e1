"""InternLM2-20B — dense decoder with GQA. [arXiv:2403.17297]"""
from repro_torch.config.base import ModelConfig, register_config


@register_config("internlm2-20b")
def internlm2_20b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        source="[arXiv:2403.17297] InternLM2 Technical Report",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,            # GQA kv=8
        d_ff=16384,
        vocab_size=92544,
        attention_pattern="full",
        rope_theta=1_000_000.0,
    )
