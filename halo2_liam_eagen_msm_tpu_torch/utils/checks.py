"""Debug-time sanity checks (the intent of the reference's default-on
`sanity-check` cargo feature).  Enable with config.SANITY_CHECKS = True;
the checks run on the host on fetched values and fail fast."""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..convert import JPoint
from ..ops.ec import EC
from . import pyref


def enabled() -> bool:
    return config.SANITY_CHECKS


def check_on_curve(E: EC, pts: JPoint, what: str = "points") -> None:
    """All non-identity points satisfy the curve equation."""
    if not enabled():
        return
    for i, pt in enumerate(E.points_to_ints(pts)):
        if pt is not None and not pyref.on_curve(pt, E.curve):
            raise AssertionError(f"{what}[{i}] off-curve")


def check_digit_range(digits, base: int) -> None:
    """All negbase digits lie in [0, base)."""
    if not enabled():
        return
    d = digits.cpu().numpy() if isinstance(digits, torch.Tensor) else np.asarray(digits)
    if not ((d >= 0) & (d < base)).all():
        raise AssertionError("digit out of range")
