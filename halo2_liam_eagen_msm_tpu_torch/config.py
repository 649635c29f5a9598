"""Configuration of the port.

There is no backend switch: an op on a CUDA tensor launches the hand-written
kernel, an op on a CPU tensor runs the plain PyTorch version (ops/cuda_ff.py).
Entry points that build tensors from host data take an explicit `device`
and default to the card."""

from __future__ import annotations

import torch

# Debug-time sanity checks (on-curve, digit ranges).
SANITY_CHECKS = False


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device.  Asking for the card where there is none
    raises: nothing gives way to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
