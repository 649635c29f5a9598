"""Configuration of the port.

There is no backend switch: an op on a CUDA tensor launches the hand-written
kernel, an op on a CPU tensor runs the plain PyTorch version (ops/cuda_ff.py).
Entry points that build tensors from host data take an explicit `device`
and default to the card."""

from __future__ import annotations

import torch

# Debug-time sanity checks (on-curve, digit ranges).
SANITY_CHECKS = False

# Route large-window MSM reorders through the radix reorder (ops/radix.py:
# per-tile coarse rank and shuffle, a fine counting sort per partition, a
# ragged compaction) instead of sort + gather.  Wired, bit-exact and tested
# (tests/test_torch_radix.py, chip_smoke.py), but DEFAULT OFF, as in the JAX
# package: the classic route is the default, and PERF.md records what the
# card gives for each route.
RADIX_MSM = False


def use_radix_msm() -> bool:
    return RADIX_MSM


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
