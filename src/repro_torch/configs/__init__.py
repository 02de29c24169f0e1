"""Architecture registry of the port: importing this package registers
every config of the reference's: the paper's own target, the four dense
models of the reference's pool, the two MoE models (``models/moe.py``),
the two Mamba-2 stacks (``models/ssm.py``: the pure SSM and the hybrid),
the codebook stack (musicgen-medium) and the image stack
(llava-next-mistral-7b)."""
from repro_torch.configs import (  # noqa: F401
    gemma3_1b,
    internlm2_20b,
    jamba_v0_1_52b,
    llava_next_mistral_7b,
    mamba2_130m,
    mixtral_8x22b,
    musicgen_medium,
    qwen2_moe_a2_7b,
    stablelm_1_6b,
    starcoder2_3b,
    vicuna_7b,
)
