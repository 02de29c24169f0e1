"""Model stack of the port: attention and Mamba-2 blocks, dense or MoE MLPs, dense or paged caches."""
from repro_torch.models.model import (
    commit_cache,
    decode_commit_token,
    decode_step,
    forward_train,
    init_cache,
    init_params,
    layout,
    pages_for,
    prefill,
    write_slot,
)

__all__ = ["commit_cache", "decode_commit_token", "decode_step", "forward_train", "init_cache",
           "init_params", "layout", "pages_for", "prefill", "write_slot"]
