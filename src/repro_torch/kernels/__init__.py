"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch versions."""
from typing import Dict

from repro_torch.kernels import flash_decode, graph_cond, int8_matmul, moe_grouped, tree_attention
from repro_torch.kernels.ops import paged_verify_attention, quantized_matmul, verify_attention

__all__ = ["launch_counts", "paged_verify_attention", "quantized_matmul", "verify_attention"]


def launch_counts() -> Dict[str, int]:
    """Each kernel's launch count so far, as its wrapper keeps it (a wrapper
    called while a CUDA graph is captured counts the launch it puts in the
    graph; replays are counted by whoever replays)."""
    return {"flash_decode": flash_decode.launches,
            "flash_decode_paged": flash_decode.paged_launches,
            "tree_attention": tree_attention.launches,
            "int8_matmul": int8_matmul.launches,
            "set_cond": graph_cond.launches,
            "moe_grouped": moe_grouped.launches,
            "moe_grouped_bf16": moe_grouped.bf16_launches}
