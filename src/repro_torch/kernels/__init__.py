"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch versions."""
from repro_torch.kernels.ops import quantized_matmul, verify_attention

__all__ = ["quantized_matmul", "verify_attention"]
