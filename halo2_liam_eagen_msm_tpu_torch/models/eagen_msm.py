"""The flagship 'model': the Liam Eagen MSM argument witness pipeline as a
configured unit, the counterpart of the JAX package's models/eagen_msm.py.

A config (curve, base, point count), a forward step on the tensors' device
(digit rounds -> carry + witness polynomials of every round, all rounds
batched through one merge tree), and the host-side scalar decomposition.
The class holds no weights.  Reference entry point: compute_lhs_witness."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import argument as A
from ..convert import RF, JPoint
from ..divisor import compute_divisor_witness_partial
from ..fields import CurveSpec, PALLAS
from ..limbs import ints_to_limbs
from ..negbase import negbase_decompose_batch


@dataclasses.dataclass(frozen=True)
class EagenConfig:
    curve: CurveSpec = PALLAS
    base: int = 5
    num_pts: int = 8

    @property
    def num_digits(self) -> int:
        return A.num_digits_for(self.curve, self.base)

    @property
    def slots(self) -> int:
        """Points per digit round: base carry slots + one per input + closer."""
        return self.base + self.num_pts + 1


class EagenMSMWitness:
    """End-to-end witness computer for a fixed configuration."""

    def __init__(self, cfg: EagenConfig):
        self.cfg = cfg

    def decompose(self, scalars) -> np.ndarray:
        """Host: scalars -> (d, N) int32 msb-first digit rounds (numpy)."""
        digits = negbase_decompose_batch(ints_to_limbs(scalars), self.cfg.base,
                                         self.cfg.num_digits)
        return digits[:, ::-1].T.astype(np.int32)

    def forward(self, digits, pts: JPoint):
        """digits (d, N) int32 tensor + pts (N,) on one device -> (carry,
        witness RF with leading dim d, LSB round first as the reference
        returns it).  Round assembly and carries (_rounds_and_carries), then
        every round's merge tree at once; an odd slot count is padded with an
        identity."""
        cfg = self.cfg
        round_pts, carry = A._rounds_and_carries(cfg.curve, cfg.base, digits, pts)
        wtns, _ = compute_divisor_witness_partial(cfg.curve, round_pts)
        return carry, RF(wtns.a.flip(0), wtns.b.flip(0))

    def __call__(self, scalars, pts: JPoint):
        digits = torch.from_numpy(self.decompose(scalars)).to(pts.x.device)
        return self.forward(digits, pts)
