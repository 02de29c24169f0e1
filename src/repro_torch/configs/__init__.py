"""Architecture registry of the port: importing this package registers the
attention-only configs, the paper's own target and the four dense models of
the reference's pool. The MoE, SSM, codebook and image configs come with
their stacks."""
from repro_torch.configs import (  # noqa: F401
    gemma3_1b,
    internlm2_20b,
    stablelm_1_6b,
    starcoder2_3b,
    vicuna_7b,
)
