"""State carried between numpy and torch: points, scalars and constants.

The numpy side is the layout of limbs.py, (..., 16) uint32 arrays of 16-bit
limbs (the JAX package's layout too), so a test can feed both packages the
same arrays and compare limb for limb.  The torch side stores the same
words as int32: torch has no uint32 arithmetic on the CPU.  Limb values are
below 2^16; packed rows (ops/msm._pack_pair) use all 32 bits and keep
their bit pattern across the cast.

The carry stage's state crosses the same way: the (N, d) uint8 digits of
negbase.negbase_decompose_batch become the (d, N) int32 msb-first rounds both
packages consume (digits_to_rounds), and a (d,) batch of carries is a JPoint
of (d, 16) limb arrays (jpoint_from_numpy / jpoint_to_numpy).

The divisor's state crosses as (a, b) coefficient arrays (RF, rf_*) and as
output points beside them (Level, level_*).  The JAX package's limb-major
arrays are (16, nb, 8, 128) blocks padded to a multiple of 1024 elements;
the port's are (16, E) (lm_from_numpy)."""

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


class RF(NamedTuple):
    """Batched regular function a(x) + y*b(x): coefficient tensors
    (..., La, 16) and (..., Lb, 16)."""
    a: torch.Tensor
    b: torch.Tensor


class Level(NamedTuple):
    """One merge-tree level: M propagations (output point + witness)."""
    out: JPoint     # coords (..., M, 16)
    wtns: RF        # (..., M, La, 16), (..., M, Lb, 16)


def rf_from_numpy(a, b, device="cuda") -> RF:
    return RF(limbs_from_numpy(a, device), limbs_from_numpy(b, device))


def rf_to_numpy(rf: RF):
    return limbs_to_numpy(rf.a), limbs_to_numpy(rf.b)


def level_from_numpy(out_xyz, ab, device="cuda") -> Level:
    """((x, y, z), (a, b)) numpy arrays -> Level on `device`."""
    return Level(jpoint_from_numpy(*out_xyz, device), rf_from_numpy(*ab, device))


def level_to_numpy(lv: Level):
    """Level -> ((x, y, z), (a, b)) numpy arrays."""
    return jpoint_to_numpy(lv.out), rf_to_numpy(lv.wtns)


def lm_from_numpy(x_lm, e: int, device="cuda") -> torch.Tensor:
    """The JAX package's limb-major (16, nb, 8, 128) uint32 array of e
    elements -> the port's (16, e) int32 tensor (padding dropped)."""
    x = np.asarray(x_lm, dtype=np.uint32)
    if x.shape[0] != N_LIMBS:
        raise ValueError(f"expected ({N_LIMBS}, nb, 8, 128) limbs, got {x.shape}")
    flat = np.ascontiguousarray(x.reshape(N_LIMBS, -1)[:, :e])
    return torch.from_numpy(flat.view(np.int32).copy()).to(resolve_device(device))


def digits_to_rounds(digits, device="cuda") -> torch.Tensor:
    """(N, d) uint8 little-endian negbase digits (numpy) -> (d, N) int32
    tensor on `device`, most significant round first.  The bytes cross to the
    device as they are and widen there."""
    digits = np.asarray(digits)
    if digits.ndim != 2 or digits.dtype != np.uint8:
        raise ValueError("expected (N, d) uint8 digits")
    rounds = np.ascontiguousarray(digits[:, ::-1].T)
    return torch.from_numpy(rounds).to(resolve_device(device)).to(torch.int32)
