"""What the job kinds share: the inputs on the program's device, in the
program's types."""

from __future__ import annotations

import time

import torch

import inputs
from halo2_liam_eagen_msm_tpu_torch.convert import JPoint
from reference.divisor import DivisorCheck


def host(p):
    """A tuple of tensors -> a tuple of NumPy arrays."""
    return tuple(c.cpu().numpy() for c in p)


def device_points(ctx, n: int) -> JPoint:
    """The configuration's n points on the device: affine, Z = 1."""
    t = time.perf_counter()
    x, y = inputs.point_limbs(ctx.curve, ctx.seed, n)
    ctx.log(f"set-up: {n} points made in {time.perf_counter() - t:.3f} s")
    one = inputs.mont_limbs([1], ctx.curve.p)
    x, y = (torch.from_numpy(a).to(ctx.device) for a in (x, y))
    return JPoint(x, y, torch.from_numpy(one).to(ctx.device).expand(n, -1).contiguous())


def scalar_digits(ctx, n: int, base: int, d: int):
    """The pool's scalar words (NumPy) and their digit rounds on the device."""
    t = time.perf_counter()
    words = inputs.scalar_pool(ctx.seed, ctx.mix["pool"], n)
    digits = [inputs.negbase_digits(w, base, d, ctx.device) for w in words]
    ctx.log(f"set-up: {len(words)} scalar vectors decomposed in {time.perf_counter() - t:.3f} s")
    return words, digits


def divisor_check(ctx, A, B, base: int, n: int) -> DivisorCheck:
    """The reference's check of whole witnesses, on a line drawn from the
    seed."""
    g = inputs.rng_for(ctx.seed, "line")
    r1, r2 = (int.from_bytes(g.bytes(40), "little") % ctx.curve.q for _ in range(2))
    return DivisorCheck(ctx.curve, A, B, base, n, r1, r2)
