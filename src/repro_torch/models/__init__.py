"""Model stack of the port (attention-only dense subset)."""
from repro_torch.models.model import (
    commit_cache,
    decode_step,
    init_cache,
    init_params,
    layout,
    prefill,
)

__all__ = ["commit_cache", "decode_step", "init_cache", "init_params", "layout", "prefill"]
