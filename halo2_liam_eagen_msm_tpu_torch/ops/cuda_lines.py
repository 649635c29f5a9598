"""The merge head's CUDA kernel, affine_lines, with its plain version.

mont_mul's and mont_addsub's work at the shape of divisor.merge_head and
divisor.seeds, in one launch a level (source in csrc/lines.cuh, CUDA C++ for
sm_90a, built into the one library of ops/cuda_ff.py):

  kernel           replaces                          what it computes
  affine_lines     pallas_ff.mont_mul (:515) and     from three points a slot
                   mont_addsub (:541), at the JAX    and their inverted Z: the
                   divisor.merge_head / seeds'       affine normalisation, the
                   affine normalisation              line through the first two
                   (ec.to_affine) and                (through the first and the
                   linefunc_affine                   third where it vanishes),
                                                     the masks; a slot on two
                                                     lanes
  affine_lines_v1  the same; its first design, one   the same
                   thread a slot, kept for one A/B
                   (no path launches it)

divisor.py takes affine_lines for a CUDA tensor and the plain version for a
CPU one.  _lines writes the computation on field ops passed in; on the plain
products and subtractions of ops/cuda_ff.py it is the plain version.  Every
value is fully reduced, so kernels and plain version agree limb for limb.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields import FieldSpec, N_LIMBS
from . import cuda_ff as CF
from .ff import FF, ff

HEAD_ROWS = 7    # lx, ly, lz, the negated ys of a.out and b.out, the two roots
SEEDS_ROWS = 3   # lx, ly, lz


def _lines_launch(name: str, spec: FieldSpec, head: bool, x, y, zinv):
    CF._check_cuda(name, x, y, zinv)
    lead, (xf, yf, zf) = CF._flatten(x, y, zinv)
    if lead[:1] != (3,):
        raise ValueError(f"{name}: three points a slot, got {tuple(lead)}")
    n = xf.shape[0] // 3
    rows = HEAD_ROWS if head else SEEDS_ROWS
    out = torch.empty((rows * n, N_LIMBS), dtype=torch.int32, device=xf.device)
    flags = torch.empty(2 * n, dtype=torch.bool, device=xf.device) if head else None
    if n:
        CF._launch(name, xf.device, ctypes.byref(CF._field_params(spec)),
                   xf.data_ptr(), yf.data_ptr(), zf.data_ptr(), out.data_ptr(),
                   flags.data_ptr() if head else None, n, int(head))
    return (out.reshape((rows,) + lead[1:] + (N_LIMBS,)),
            flags.reshape((2,) + lead[1:]) if head else None)


def affine_lines(spec: FieldSpec, head: bool, x, y, zinv):
    """x, y, zinv: (3, ..., 16), the three points of each slot stacked (head:
    a.out, b.out, a.out + b.out; seeds: p1, p2, -(p1 + p2)) and their inverted
    Z (0 for the identity).  One kernel launch, a slot on two lanes.  Returns
    (rows, flags): head rows (7, ..., 16) = lx, ly, lz, nay, nby, root_a,
    root_b and flags (2, ...) bool = deg, bypass; seeds rows (3, ..., 16) =
    lx, ly, lz and flags None."""
    return _lines_launch("affine_lines", spec, head, x, y, zinv)


def affine_lines_v1(spec: FieldSpec, head: bool, x, y, zinv):
    """affine_lines by its first design, one thread a slot: the same
    arguments and results.  Kept for one A/B; no path calls it."""
    return _lines_launch("affine_lines_v1", spec, head, x, y, zinv)


# ---------------------------------------------------------------------------
# the algorithm, on any field ops; the plain version and the replaced route
# ---------------------------------------------------------------------------

def line(mul, sub, one, x1, y1, id1, x2, y2, id2):
    """Cross product (lx, ly, lz) of two canonical projective points, (x, y,
    1) or (0, 1, 0) for the identity, on the field ops `mul` and `sub`: the
    line lx X + ly Y + lz through them (divisor.linefunc_affine)."""
    zero = torch.zeros_like(x1)
    ax, ay, az = FF.select(id1, zero, x1), FF.select(id1, one, y1), FF.select(id1, zero, one)
    bx, by, bz = FF.select(id2, zero, x2), FF.select(id2, one, y2), FF.select(id2, zero, one)
    return (sub(mul(ay, bz), mul(az, by)), sub(mul(az, bx), mul(ax, bz)),
            sub(mul(ax, by), mul(ay, bx)))


def _lines(spec: FieldSpec, head: bool, x, y, zinv, mul, sub):
    """affine_lines on the field ops `mul` and `sub`: EC.to_affine's four
    products on the three points at once, the negations, the line through
    the first two, the line through the first and the third, the selects."""
    one = ff(spec).one(x.device).expand(x.shape[1:])
    zero = torch.zeros_like(one)
    zinv2 = mul(zinv, zinv)
    ax, ay = mul(x, zinv2), mul(y, mul(zinv, zinv2))
    ident = FF.is_zero(zinv)
    if head:
        # the lines go through -a.out and -b.out; bypass: either is O
        ny = sub(torch.zeros_like(ay[:2]), ay[:2])
        first, second = (ax[0], ny[0], ident[0]), (ax[1], ny[1], ident[1])
        mask, c_id = ident[0] | ident[1], ident[2]
    else:
        # where p1 is O, the line through (p2, -p2), and c = p2 + (-p2) = O;
        # mask: both O
        id1 = ident[0]
        first = (FF.select(id1, ax[1], ax[0]), FF.select(id1, ay[1], ay[0]), id1 & ident[1])
        second = (ax[1], FF.select(id1, sub(zero, ay[1]), ay[1]), ident[1])
        mask, c_id = id1 & ident[1], ident[2] | id1
    lx, ly, lz = line(mul, sub, one, *first, *second)
    deg = FF.is_zero(lx) & FF.is_zero(ly) & FF.is_zero(lz)
    if head:
        deg = deg & ~mask
    # a vanishing cross product (equal points, the tangent case): the line
    # through the first point and the third
    lx2, ly2, lz2 = line(mul, sub, one, *first, ax[2], ay[2], c_id)
    lx, ly, lz = FF.select(deg, lx2, lx), FF.select(deg, ly2, ly), FF.select(deg, lz2, lz)
    lx, ly, lz = FF.select(mask, zero, lx), FF.select(mask, zero, ly), FF.select(mask, one, lz)
    if not head:
        return torch.stack([lx, ly, lz]), None
    roots = FF.select(mask, one, ax[0]), FF.select(mask, one, ax[1])
    return torch.stack([lx, ly, lz, ny[0], ny[1], *roots]), torch.stack([deg, mask])


def affine_lines_plain(spec: FieldSpec, head: bool, x, y, zinv):
    """Plain version of affine_lines: _lines on the plain products and
    subtractions."""
    return _lines(spec, head, x, y, zinv, lambda a, b: CF.mont_mul_plain(spec, a, b),
                  lambda a, b: CF.mont_addsub_plain(spec, True, a, b))
