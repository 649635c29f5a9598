"""Batched Jacobian-coordinate elliptic curve ops.

Counterpart of the JAX package's ops/ec.py.

  * points are structure-of-arrays (X, Y, Z) limb tensors, batched over
    leading axes
  * the group law is branchless-complete: the doubling / identity / inverse
    cases are computed in parallel and mask-selected
  * identity is encoded as Z == 0

Routing is by the tensor: on a CUDA tensor `double`, `double_n`, `add`,
`add_fast`, `add_mixed`, `add_mixed_fast` and `madd_xyzz_fast` launch their
kernels (ops/cuda_ff.py); on a CPU tensor they run the kernels' plain
versions.

All supported curves (Pallas, Vesta, Grumpkin) have a = 0.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..convert import JPoint, limbs_from_numpy, limbs_to_numpy
from ..fields import CurveSpec, N_LIMBS
from ..limbs import ints_to_mont_limbs, mont_limbs_to_ints
from ..utils import pyref
from . import cuda_ff
from .ff import FF, ff

__all__ = ["EC", "JPoint", "SUM_G", "ec"]

_OFFSET_CACHE: dict = {}

# Block width of the grouped reductions on the card: a scan brings n points
# down to SUM_G lanes, then a log-depth scan finishes at that one width.
SUM_G = 2048

_OFFSET_SCALAR = 0x0EA6E4B11DC0FFEE


def _cat(parts, dim=0) -> JPoint:
    return JPoint(*(torch.cat([p[k] for p in parts], dim=dim) for k in range(3)))


class EC:
    def __init__(self, curve: CurveSpec):
        self.curve = curve
        self.f: FF = ff(curve.field)

    # ------------------------------------------------------------- structure
    def identity(self, shape=(), device="cuda") -> JPoint:
        one = self.f.one(device).expand(tuple(shape) + (N_LIMBS,))
        return JPoint(one, one, torch.zeros_like(one))

    def generator(self, shape=(), device="cuda") -> JPoint:
        f = self.f
        full = tuple(shape) + (N_LIMBS,)
        return JPoint(f.const(self.curve.gen_x, device).expand(full),
                      f.const(self.curve.gen_y, device).expand(full),
                      f.one(device).expand(full))

    def is_identity(self, p: JPoint):
        return self.f.is_zero(p.z)

    def select(self, mask, p: JPoint, q: JPoint) -> JPoint:
        s = self.f.select
        return JPoint(s(mask, p.x, q.x), s(mask, p.y, q.y), s(mask, p.z, q.z))

    def neg(self, p: JPoint) -> JPoint:
        return JPoint(p.x, self.f.neg(p.y), p.z)

    def eq(self, p: JPoint, q: JPoint):
        """Projective equality (identity-aware)."""
        f = self.f
        z1z1, z2z2 = f.sqr(p.z), f.sqr(q.z)
        x_eq = f.eq(f.mul(p.x, z2z2), f.mul(q.x, z1z1))
        y_eq = f.eq(f.mul(p.y, f.mul(q.z, z2z2)), f.mul(q.y, f.mul(p.z, z1z1)))
        id1, id2 = self.is_identity(p), self.is_identity(q)
        return torch.where(id1 | id2, id1 == id2, x_eq & y_eq)

    # ------------------------------------------------------------- group law
    def double(self, p: JPoint) -> JPoint:
        """dbl-2009-l (a = 0).  Identity-safe: Z3 = 2YZ = 0 when Z = 0."""
        return self.double_n(p, 1)

    def double_n(self, p: JPoint, k: int) -> JPoint:
        """p doubled k >= 0 times (dbl-2009-l each time): one kernel launch on
        the card, whatever k."""
        fn = cuda_ff.ec_double if p.x.is_cuda else cuda_ff.ec_double_plain
        return JPoint(*fn(self.curve, p.x, p.y, p.z, k))

    def add(self, p: JPoint, q: JPoint) -> JPoint:
        """Branchless complete addition (add-2007-bl + mask dispatch)."""
        fn = cuda_ff.ec_add if p.x.is_cuda else cuda_ff.ec_add_plain
        return JPoint(*fn(self.curve, p.x, p.y, p.z, q.x, q.y, q.z))

    def add_fast(self, p: JPoint, q: JPoint):
        """Generic Jacobian add with NO doubling path: returns (JPoint, exc).
        Identity operands pass through exactly; P + (-P) yields a valid z = 0
        identity; only a true doubling collision (p == q, both non-identity)
        is flagged for safe recomputation."""
        fn = cuda_ff.ec_add_fast if p.x.is_cuda else cuda_ff.ec_add_fast_plain
        x, y, z, exc = fn(self.curve, p.x, p.y, p.z, q.x, q.y, q.z)
        return JPoint(x, y, z), exc

    def add_mixed(self, p: JPoint, qx, qy, q_is_identity) -> JPoint:
        """p + affine(qx, qy), complete (madd-2007-bl + mask dispatch).
        q_is_identity: (...,) bool mask for affine identity slots."""
        fn = cuda_ff.ec_add_mixed if p.x.is_cuda else cuda_ff.ec_add_mixed_plain
        return JPoint(*fn(self.curve, p.x, p.y, p.z, qx, qy, q_is_identity))

    def add_mixed_fast(self, p: JPoint, qx, qy):
        """Generic mixed add with NO doubling / identity-carry handling:
        returns (JPoint, exc) where exc (bool (...,)) flags slots whose exact
        result needed an exceptional path (identity carry, or carry == +-Q);
        the caller recomputes flagged work with `add_mixed`.  The affine
        identity is encoded as qy == 0 (to_affine's convention; no point of
        these prime-order curves has y = 0): such slots pass the carry
        through exactly and are not flagged.  3 squarings + 8 products."""
        fn = cuda_ff.ec_add_mixed_fast if p.x.is_cuda else cuda_ff.ec_add_mixed_fast_plain
        x, y, z, exc = fn(self.curve, p.x, p.y, p.z, qx, qy)
        return JPoint(x, y, z), exc

    # ------------------------------------------------------------- XYZZ form
    # x = X/ZZ, y = Y/ZZZ with ZZ^3 = ZZZ^2; identity encoded ZZ = ZZZ = 0.
    # Carried by the MSM's blinded prefix scan: the cached ZZ/ZZZ make the
    # z^2/z^3 of every mixed add free.

    def madd_xyzz_fast(self, x, y, zz, zzz, qx, qy):
        """XYZZ + affine fast add: returns (x3, y3, zz3, zzz3, exc).  The
        affine identity is encoded as qy == 0 and passes through unflagged;
        an identity carry or carry == +-Q is flagged."""
        fn = cuda_ff.ec_madd_xyzz_fast if x.is_cuda else cuda_ff.ec_madd_xyzz_fast_plain
        return fn(self.curve, x, y, zz, zzz, qx, qy)

    def xyzz_offset(self, shape=(), device="cuda"):
        """The blinding point T in XYZZ form (affine, so ZZ = ZZZ = 1)."""
        t = self.offset_point(shape, device=device)
        return t.x, t.y, t.z, t.z

    def xyzz_to_jacobian(self, x, y, zz, zzz) -> JPoint:
        """(X, Y, ZZ, ZZZ) -> Jacobian (X*ZZ^2, Y*ZZZ^2, ZZZ): exact for the
        identity too (all-zero maps to all-zero = Jacobian identity)."""
        f = self.f
        return JPoint(f.mul(x, f.sqr(zz)), f.mul(y, f.sqr(zzz)), zzz)

    def offset_point_ints(self, mult: int = 1):
        """Host (x, y) ints of [mult]T, T = [0x0EA6E4B11DC0FFEE]*G: the fixed
        nothing-up-my-sleeve blinding point that seeds the MSM's prefix-scan
        carries, so that the exception-free adds are exact for every input
        not aligned with it.  Computed on the host once."""
        key = (self.curve.name, mult)
        pt = _OFFSET_CACHE.get(key)
        if pt is None:
            base = _OFFSET_CACHE.get((self.curve.name, 1))
            if base is None:
                k = _OFFSET_SCALAR % self.curve.scalar_field.p
                base = pyref.ec_mul((self.curve.gen_x, self.curve.gen_y), k, self.curve)
                _OFFSET_CACHE[(self.curve.name, 1)] = base
            pt = base if mult == 1 else pyref.ec_mul(base, mult, self.curve)
            _OFFSET_CACHE[key] = pt
        return pt

    def offset_point(self, shape=(), mult: int = 1, device="cuda") -> JPoint:
        """[mult]T as a Jacobian point with z = 1 (mult = k cancels
        accumulated blinding, e.g. the copies a blinded suffix sum carries)."""
        f = self.f
        x, y = self.offset_point_ints(mult)
        full = tuple(shape) + (N_LIMBS,)
        return JPoint(f.const(x, device).expand(full), f.const(y, device).expand(full),
                      f.one(device).expand(full))

    # ----------------------------------------------------------- conversions
    def to_affine(self, p: JPoint):
        """Batched Jacobian -> affine via Montgomery-trick inversion.
        Identity maps to (0, 0) with its mask returned."""
        f = self.f
        zinv = f.batch_inv(p.z.reshape(-1, N_LIMBS), axis=0).reshape(p.z.shape)
        zinv2 = f.sqr(zinv)
        x = f.mul(p.x, zinv2)
        y = f.mul(p.y, f.mul(zinv, zinv2))
        ident = self.is_identity(p)
        x = f.select(ident, torch.zeros_like(x), x)
        y = f.select(ident, torch.zeros_like(y), y)
        return x, y, ident

    def from_affine(self, x, y, is_ident=None) -> JPoint:
        z = self.f.one(x.device).expand(x.shape)
        if is_ident is not None:
            z = self.f.select(is_ident, torch.zeros_like(z), z)
        return JPoint(x, y, z)

    def projective_coords(self, p: JPoint):
        """Jacobian -> homogeneous projective (X*Z, Y, Z^3): the coordinate
        change of the reference's linefunc."""
        f = self.f
        return f.mul(p.x, p.z), p.y, f.mul(p.z, f.sqr(p.z))

    # ------------------------------------------------------------ arithmetic
    def scalar_mul_small(self, p: JPoint, k: int) -> JPoint:
        """p * k for a small static k >= 0 (double-and-add over the bits of
        k; the carry stage's carry * base), each run of doublings between two
        adds one double_n.  k = 0 gives the identity."""
        if k < 0:
            raise ValueError("scalar_mul_small: k must be non-negative")
        if k == 0:
            return self.identity(tuple(p.z.shape[:-1]), p.z.device)
        acc, run = p, 0
        for bit in bin(k)[3:]:
            run += 1
            if bit == "1":
                acc = self.add(self.double_n(acc, run), p)
                run = 0
        return self.double_n(acc, run) if run else acc

    def sum(self, p: JPoint, axis: int = 0) -> JPoint:
        """Reduce a batch of points along `axis` of the limb tensors (0 is the
        first axis, -2 the last point axis; other leading axes ride along).  On the card: a scan of full-width complete adds down to
        SUM_G lanes, then a log-depth scan at that width (few launches, each
        wide).  On the CPU: rounds of 64-step scans (work-optimal)."""
        x, y, z = (c.movedim(axis, 0) for c in p)
        n = x.shape[0]
        batch = tuple(x.shape[1:-1])
        dev = x.device

        def scan_to(pt: JPoint, n, groups, w) -> JPoint:
            """Fold n points into w lanes by `groups` sequential adds
            (element i goes to lane i % w)."""
            pad = groups * w - n
            if pad:
                pt = _cat([pt, self.identity((pad,) + batch, dev)])
            rows = [c.reshape((groups, w) + batch + (N_LIMBS,)) for c in pt]
            acc = self.identity((w,) + batch, dev)
            for i in range(groups):
                acc = self.add(acc, JPoint(*(r[i] for r in rows)))
            return acc

        pt = JPoint(x, y, z)
        if dev.type == "cuda":
            if n > 2 * SUM_G:
                pt = scan_to(pt, n, -(-n // SUM_G), SUM_G)
                n = SUM_G
            # inclusive Hillis-Steele scan at fixed width n; the total lands
            # in the last slot
            d = 1
            while d < n:
                shifted = _cat([self.identity((d,) + batch, dev),
                                JPoint(*(c[:-d] for c in pt))])
                pt = self.add(pt, shifted)
                d *= 2
            return JPoint(*(c[n - 1] for c in pt))
        while n > 1:
            groups = min(64, n)
            w = -(-n // groups)
            pt = scan_to(pt, n, groups, w)
            n = w
        return JPoint(*(c[0] for c in pt))

    # ------------------------------------------------------------ host utils
    def points_from_ints(self, coords, device="cuda") -> JPoint:
        """[(x, y) or None] (None = identity) -> batched JPoint on `device`."""
        spec = self.curve.field
        xs = [c[0] if c else 0 for c in coords]
        ys = [c[1] if c else 0 for c in coords]
        x = limbs_from_numpy(ints_to_mont_limbs(xs, spec), device)
        y = limbs_from_numpy(ints_to_mont_limbs(ys, spec), device)
        idm = torch.from_numpy(np.array([c is None for c in coords], dtype=bool))
        return self.from_affine(x, y, idm.to(x.device))

    def points_to_ints(self, p: JPoint):
        """Batched JPoint -> [(x, y) or None].  Pure host math after the
        device fetch."""
        spec = self.curve.field
        pp = spec.p
        xs, ys, zs = (mont_limbs_to_ints(limbs_to_numpy(c).reshape(-1, N_LIMBS), spec)
                      for c in p)
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(None)
                continue
            zi = pow(z, pp - 2, pp)
            zi2 = zi * zi % pp
            out.append((x * zi2 % pp, y * zi2 * zi % pp))
        return out


@lru_cache(maxsize=None)
def ec(curve: CurveSpec) -> EC:
    return EC(curve)
