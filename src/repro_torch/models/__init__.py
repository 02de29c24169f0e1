"""Model stack of the port (attention-only dense subset, dense or paged KV cache)."""
from repro_torch.models.model import (
    commit_cache,
    decode_step,
    init_cache,
    init_params,
    layout,
    pages_for,
    prefill,
    write_slot,
)

__all__ = ["commit_cache", "decode_step", "init_cache", "init_params", "layout", "pages_for",
           "prefill", "write_slot"]
