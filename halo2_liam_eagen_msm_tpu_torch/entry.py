"""The port's twin of the repository's __graft_entry__.entry(): the model's
forward step with example arguments, on the card unless asked otherwise."""

from __future__ import annotations

import random

import torch

from . import argument as A
from .config import resolve_device
from .convert import JPoint
from .models.eagen_msm import EagenConfig, EagenMSMWitness
from .ops.ec import ec
from .utils import pyref


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship model (digit
    rounds -> carry + witness) at 4 points and the first 8 digit rounds, the
    inputs made from the same seed as the JAX package's entry.  fn returns
    (carry.x, wtns.a, wtns.b)."""
    dev = resolve_device(device)
    rng = random.Random(0xE7)
    cfg = EagenConfig(num_pts=4)
    model = EagenMSMWitness(cfg)
    E = ec(cfg.curve)
    pts = E.points_from_ints(pyref.random_points(rng, cfg.curve, cfg.num_pts), dev)
    scalars = [A.gen_random_coeff(rng, cfg.curve.scalar_field) for _ in range(cfg.num_pts)]
    # reduced round depth: each digit round is an independent batched witness
    digits = torch.from_numpy(model.decompose(scalars)[:8]).to(dev)

    def fn(digits, px, py, pz):
        carry, wtns = model.forward(digits, JPoint(px, py, pz))
        return carry.x, wtns.a, wtns.b

    return fn, (digits, pts.x, pts.y, pts.z)
