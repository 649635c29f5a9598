"""Host-side exact divisor-witness oracle (Python ints).

The port's own copy of the JAX package's ref_divisor.py, on the port's host
Poly (ops/poly.py) and pyref.  It mirrors the reference's Propagation engine
(regular_functions_utils.rs:305-480) under the canonical affine line
normalization (see divisor.py's docstring), with the same pairing order
(consecutive pairs, the odd tail passing through, recursion on the halved
list).  Used to check the merge tree coefficient for coefficient."""

from __future__ import annotations

from ..fields import CurveSpec
from ..ops.poly import Poly
from . import pyref


def _coords(pt):
    return (0, 1, 0) if pt is None else (pt[0], pt[1], 1)


def linefunc_ints(curve: CurveSpec, a, b):
    """Canonical affine cross-product line through a, b (degenerate case via
    c = -(a+b), reference :284-303)."""
    p = curve.field.p
    ax, ay, az = _coords(a)
    bx, by, bz = _coords(b)
    lx = (ay * bz - az * by) % p
    ly = (az * bx - ax * bz) % p
    lz = (ax * by - ay * bx) % p
    if lx or ly or lz:
        return (lx, ly, lz)
    c = pyref.ec_neg(pyref.ec_add(a, b, curve), curve)
    cx, cy, cz = _coords(c)
    return (
        (ay * cz - az * cy) % p,
        (az * cx - ax * cz) % p,
        (ax * cy - ay * cx) % p,
    )


class HostRF:
    """a(x) + y*b(x) with exact Vec-like lengths (reference RegularFunction)."""

    def __init__(self, a: Poly, b: Poly):
        self.a = a
        self.b = b

    @classmethod
    def from_const(cls, curve, x):
        return cls(Poly(curve.field, [x]), Poly(curve.field, []))

    @classmethod
    def from_line(cls, curve, lx, ly, lz):
        return cls(Poly(curve.field, [lz, lx]), Poly(curve.field, [ly]))

    def ev(self, curve, pt):
        x, y = pt
        p = curve.field.p
        return (self.a.ev(x) + self.b.ev(x) * y) % p

    def mul(self, curve, other):
        subst = Poly(curve.field, [curve.b, curve.a, 0, 1])
        a = self.a * other.a + self.b * other.b * subst
        b = self.a * other.b + self.b * other.a
        return HostRF(a, b)


class HostProp:
    def __init__(self, output, wtns: HostRF):
        self.output = output
        self.wtns = wtns

    @classmethod
    def empty(cls, curve):
        return cls(None, HostRF(Poly(curve.field, [1]), Poly(curve.field, [])))

    @classmethod
    def from_point(cls, curve, pt):
        if pt is None:
            return cls.empty(curve)
        return cls(
            pyref.ec_neg(pt, curve),
            HostRF.from_line(curve, *linefunc_ints(curve, pt, pyref.ec_neg(pt, curve))),
        )

    @classmethod
    def from_pair(cls, curve, p1, p2):
        if p1 is None:
            return cls.from_point(curve, p2)
        return cls(
            pyref.ec_neg(pyref.ec_add(p1, p2, curve), curve),
            HostRF.from_line(curve, *linefunc_ints(curve, p1, p2)),
        )

    @classmethod
    def merge(cls, curve, a, b):
        output = pyref.ec_add(a.output, b.output, curve)
        if a.output is None or b.output is None:
            return cls(output, a.wtns.mul(curve, b.wtns))
        na = pyref.ec_neg(a.output, curve)
        nb = pyref.ec_neg(b.output, curve)
        line = HostRF.from_line(curve, *linefunc_ints(curve, na, nb))
        num = a.wtns.mul(curve, b.wtns.mul(curve, line))
        ax = a.output[0]
        bx = b.output[0]
        return cls(
            output,
            HostRF(
                num.a.kate_div(ax).kate_div(bx),
                num.b.kate_div(ax).kate_div(bx),
            ),
        )


def divisor_witness_host(curve: CurveSpec, pts):
    """(HostRF, output) for a list of None/(x, y) points — reference
    compute_divisor_witness_partial with this framework's canonicalization."""
    if not pts:
        return HostRF.from_const(curve, 1), None
    pts = list(pts)
    if len(pts) % 2:
        # canonical spec (matches the TPU path): odd lists are identity-padded
        # and seeded as pairs; same divisor as the reference's from_point tail,
        # different (documented) scalar normalization of the final line
        pts.append(None)
    props = []
    i = 0
    while i < len(pts) - 1:
        props.append(HostProp.from_pair(curve, pts[i], pts[i + 1]))
        i += 2
    while len(props) > 1:
        nxt = []
        j = 0
        while j + 1 < len(props):
            nxt.append(HostProp.merge(curve, props[j], props[j + 1]))
            j += 2
        if j < len(props):
            nxt.append(props[j])
        props = nxt
    return props[0].wtns, props[0].output
