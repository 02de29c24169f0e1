"""PyTorch/CUDA port of the CAS-Spec reproduction, for NVIDIA Hopper.

Mirrors the reference package's module names (``config``, ``kernels``,
``models``, ``core``). Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``; there is no silent fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no card is present instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "versions on the CPU"
        )
    return dev
