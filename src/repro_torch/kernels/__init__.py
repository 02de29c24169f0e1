"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch versions."""
from repro_torch.kernels.ops import paged_verify_attention, quantized_matmul, verify_attention

__all__ = ["paged_verify_attention", "quantized_matmul", "verify_attention"]
