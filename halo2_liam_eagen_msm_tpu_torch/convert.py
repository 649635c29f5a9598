"""State carried between numpy and torch: points, scalars and constants.

The numpy side is the layout of limbs.py, (..., 16) uint32 arrays of 16-bit
limbs (the JAX package's layout too), so a test can feed both packages the
same arrays and compare limb for limb.  The torch side stores the same
words as int32: torch has no uint32 arithmetic on the CPU.  Limb values are
below 2^16; packed rows (ops/msm._pack_pair) use all 32 bits and keep
their bit pattern across the cast."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import resolve_device
from .fields import N_LIMBS


class JPoint(NamedTuple):
    """Jacobian point: affine = (x/z^2, y/z^3); identity iff z == 0."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def limbs_from_numpy(a, device="cuda") -> torch.Tensor:
    """(..., 16) uint32 numpy limbs -> int32 tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    if a.shape[-1] != N_LIMBS:
        raise ValueError(f"expected (..., {N_LIMBS}) limbs, got {a.shape}")
    return torch.from_numpy(a.view(np.int32).copy()).to(resolve_device(device))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> (..., 16) uint32 numpy array (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def jpoint_from_numpy(x, y, z, device="cuda") -> JPoint:
    return JPoint(limbs_from_numpy(x, device), limbs_from_numpy(y, device),
                  limbs_from_numpy(z, device))


def jpoint_to_numpy(p: JPoint):
    return limbs_to_numpy(p.x), limbs_to_numpy(p.y), limbs_to_numpy(p.z)
