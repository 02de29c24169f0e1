"""Architecture registry of the port: importing this package registers the
configs whose stacks the port runs: the paper's own target, the four dense
models of the reference's pool and the two MoE models (``models/moe.py``).
The SSM, codebook and image configs come with their stacks."""
from repro_torch.configs import (  # noqa: F401
    gemma3_1b,
    internlm2_20b,
    mixtral_8x22b,
    qwen2_moe_a2_7b,
    stablelm_1_6b,
    starcoder2_3b,
    vicuna_7b,
)
