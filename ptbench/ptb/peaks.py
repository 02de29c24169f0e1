"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): the yardstick's table,
copied from the program's ``analysis/roofline.py`` so that no later change
to the program moves it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12,
               "fp8": 1979e12, "int8": 1979e12}


def peak_flops(dtype: str) -> float:
    return FLOPS_PER_S[dtype]
