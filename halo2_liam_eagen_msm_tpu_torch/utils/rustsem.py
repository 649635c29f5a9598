"""Exact-integer replica of the REFERENCE's divisor-witness semantics,
including halo2curves' Jacobian Z-coordinate chains.

The port's own copy of the JAX package's rustsem.py.  The canonical witness
(divisor.py) normalizes points to affine before building line functions, so
its coefficients are a deterministic function of the input points.  The
reference instead feeds RAW Jacobian-derived projective coordinates
(x*z, y, z^3) into the line cross products (regular_functions_utils.rs:
284-303, 426-431), so its coefficients depend on the exact Z values
halo2curves' add/double formulas produce along the merge tree.  This module
tracks those Z chains, so that the frozen "Rust-semantics" golden vectors
(data/golden_divisor_*.json) can be recomputed and checked without running
the Rust crate.

Z-value provenance (PSE halo2curves `new_curve_impl`, incomplete Jacobian
formulas — EFD add-2007-bl and dbl-2009-l):

    add:    h = u2 - u1,  z3 = ((z1+z2)^2 - z1^2 - z2^2) * h = 2*z1*z2*h
    double: z3 = 2*y1*z1
    neg:    (x, -y, z)  (Z preserved)

Any formula variant computing the same VALUES (e.g. 2*z1*z2*h computed as
two multiplications) yields identical chains — only the output values
matter, and every classical incomplete Jacobian formula family produces
exactly these.  Identity operands are excluded from golden inputs so the
identity-representation convention never enters the chain.

Relation to the canonical witness: every line function here differs from
the affine-normalized one by a nonzero scalar (the cross product is
1-homogeneous in each argument's coordinate triple), kate_div is linear,
and merge multiplies lines — so the final witness equals the canonical
witness times ONE nonzero field constant, which the tests check.

All arithmetic is host Python ints mod p (bit-exact; no device code).
"""

from __future__ import annotations

import json
import os

from ..fields import CurveSpec

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def load_golden(name: str):
    """The frozen vector data/golden_divisor_<name>.json ("pallas" or
    "grumpkin"): (affine input points, a coefficients, b coefficients)."""
    with open(os.path.join(DATA, f"golden_divisor_{name}.json")) as f:
        rec = json.load(f)
    pts = [(int(x, 16), int(y, 16)) for x, y in rec["points"]]
    return pts, [int(c, 16) for c in rec["wtns_a"]], [int(c, 16) for c in rec["wtns_b"]]


# ---------------------------------------------------------------------------
# halo2curves-semantics Jacobian arithmetic (Z chains tracked exactly)
# ---------------------------------------------------------------------------

def jac_is_identity(pt) -> bool:
    return pt[2] == 0


def jac_neg(pt, p: int):
    x, y, z = pt
    return (x, (-y) % p, z)


def jac_double(pt, p: int):
    """dbl-2009-l value chain (z3 = 2*y1*z1)."""
    x, y, z = pt
    if z == 0:
        return pt
    a = x * x % p
    b = y * y % p
    c = b * b % p
    d = 2 * ((x + b) * (x + b) - a - c) % p
    e = 3 * a % p
    f = e * e % p
    x3 = (f - 2 * d) % p
    y3 = (e * (d - x3) - 8 * c) % p
    z3 = 2 * y * z % p
    return (x3, y3, z3)


def jac_add(p1, p2, p: int):
    """add-2007-bl value chain (z3 = 2*z1*z2*h), with halo2curves' identity
    and doubling branches (u1==u2: double if s1==s2 else identity)."""
    if jac_is_identity(p1):
        return p2
    if jac_is_identity(p2):
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = z1 * z1 % p
    z2z2 = z2 * z2 % p
    u1 = x1 * z2z2 % p
    u2 = x2 * z1z1 % p
    s1 = y1 * z2 % p * z2z2 % p
    s2 = y2 * z1 % p * z1z1 % p
    if u1 == u2:
        if s1 == s2:
            return jac_double(p1, p)
        return (0, 1, 0)
    h = (u2 - u1) % p
    i = 4 * h * h % p
    j = h * i % p
    r = 2 * (s2 - s1) % p
    v = u1 * i % p
    x3 = (r * r - j - 2 * v) % p
    y3 = (r * (v - x3) - 2 * s1 * j) % p
    z3 = 2 * z1 % p * z2 % p * h % p
    return (x3, y3, z3)


def projective_coords(pt, p: int):
    """Reference projective_coords (:426-431): Jacobian (x, y, z) ->
    (x*z, y, z^3)."""
    x, y, z = pt
    zsq = z * z % p
    return (x * z % p, y, z * zsq % p)


def jac_affine_x(pt, p: int):
    x, _, z = pt
    zinv = pow(z, p - 2, p)
    return x * zinv % p * zinv % p


# ---------------------------------------------------------------------------
# exact polynomial / regular-function algebra (reference :26-273)
# ---------------------------------------------------------------------------

def poly_mul(a, b, p):
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            out[i + j] = (out[i + j] + ai * bj) % p
    return out


def poly_add(a, b, p):
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % p
            for i in range(n)]


def _kate_div(poly, b, p):
    """Synthetic division by (x - b), remainder dropped (reference :45-47):
    q[i-1] = p[i] + b*q[i] descending."""
    n = len(poly)
    if n <= 1:
        return []
    q = [0] * (n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (poly[i] + acc * b) % p
        q[i - 1] = acc
    return q


class RustRF:
    """a(x) + y*b(x) as exact int coefficient lists."""

    def __init__(self, a, b):
        self.a = list(a)
        self.b = list(b)

    @staticmethod
    def from_line(lx, ly, lz):
        return RustRF([lz, lx], [ly])

    def mul(self, other, curve: CurveSpec):
        p = curve.field.p
        subst = [curve.b % p, curve.a % p, 0, 1]  # x^3 + A x + B
        a = poly_add(
            poly_mul(self.a, other.a, p),
            poly_mul(poly_mul(self.b, other.b, p), subst, p),
            p,
        )
        b = poly_add(poly_mul(self.a, other.b, p),
                     poly_mul(self.b, other.a, p), p)
        return RustRF(a, b)

    def ev(self, x, y, p):
        ra = 0
        for c in reversed(self.a):
            ra = (ra * x + c) % p
        rb = 0
        for c in reversed(self.b):
            rb = (rb * x + c) % p
        return (ra + y * rb) % p


def _coords(pt, p: int, canonical: bool):
    """Line-argument coordinate triple: the reference's Z-carrying
    (x*z, y, z^3), or the framework's canonical affine (x, y, 1) /
    (0, 1, 0) (divisor.py docstring)."""
    if not canonical:
        return projective_coords(pt, p)
    if jac_is_identity(pt):
        return (0, 1, 0)
    x, y, z = pt
    zinv = pow(z, p - 2, p)
    zi2 = zinv * zinv % p
    return (x * zi2 % p, y * zi2 % p * zinv % p, 1)


def linefunc(a, b, curve: CurveSpec, canonical: bool = False) -> RustRF:
    """Reference linefunc (:284-303) on Z-carrying Jacobian points
    (canonical=True: the framework's affine-normalized convention)."""
    p = curve.field.p
    ax, ay, az = _coords(a, p, canonical)
    bx, by, bz = _coords(b, p, canonical)
    lz = (ax * by - ay * bx) % p
    lx = (ay * bz - az * by) % p
    ly = (az * bx - ax * bz) % p
    if lx or ly or lz:
        return RustRF.from_line(lx, ly, lz)
    c = jac_neg(jac_add(a, b, p), p)
    cx, cy, cz = _coords(c, p, canonical)
    return RustRF.from_line(
        (ay * cz - az * cy) % p, (az * cx - ax * cz) % p,
        (ax * cy - ay * cx) % p)


class RustProp:
    def __init__(self, output, wtns: RustRF):
        self.output = output
        self.wtns = wtns

    @staticmethod
    def from_point(pt, curve, canonical=False):
        p = curve.field.p
        if jac_is_identity(pt):
            return RustProp((0, 1, 0), RustRF([1], []))
        npt = jac_neg(pt, p)
        return RustProp(npt, linefunc(pt, npt, curve, canonical))

    @staticmethod
    def from_pair(p1, p2, curve, canonical=False):
        p = curve.field.p
        if jac_is_identity(p1):
            return RustProp.from_point(p2, curve, canonical)
        out = jac_neg(jac_add(p1, p2, p), p)
        return RustProp(out, linefunc(p1, p2, curve, canonical))

    @staticmethod
    def merge(a: "RustProp", b: "RustProp", curve, canonical=False):
        """Reference merge (:333-360)."""
        p = curve.field.p
        output = jac_add(a.output, b.output, p)
        if jac_is_identity(a.output) or jac_is_identity(b.output):
            return RustProp(output, a.wtns.mul(b.wtns, curve))
        num = a.wtns.mul(
            b.wtns.mul(
                linefunc(jac_neg(a.output, p), jac_neg(b.output, p), curve,
                         canonical),
                curve),
            curve)
        ax = jac_affine_x(a.output, p)
        bx = jac_affine_x(b.output, p)
        wa = _kate_div(_kate_div(num.a, ax, p), bx, p)
        wb = _kate_div(_kate_div(num.b, ax, p), bx, p)
        return RustProp(output, RustRF(wa, wb))


def compute_divisor_witness_partial(pts, curve: CurveSpec,
                                    canonical: bool = False):
    """Reference compute_divisor_witness_partial (:453-467): from_pair seeds
    over consecutive pairs (+ from_point odd tail), then group_merge's
    (0,1)(2,3)... positional pairing until one propagation remains.
    pts: list of Jacobian int triples.  canonical=True swaps in the
    framework's affine-normalized line convention (divisor.py), making this
    a host oracle for the canonical witness too.
    Returns (RustRF, output point)."""
    assert pts, "empty point list"
    props = []
    i = 0
    while i < len(pts) - 1:
        props.append(RustProp.from_pair(pts[i], pts[i + 1], curve, canonical))
        i += 2
    if i == len(pts) - 1:
        props.append(RustProp.from_point(pts[i], curve, canonical))
    while len(props) > 1:
        nxt = []
        j = 0
        while j + 1 < len(props):
            nxt.append(RustProp.merge(props[j], props[j + 1], curve,
                                      canonical))
            j += 2
        if j < len(props):
            nxt.append(props[j])
        props = nxt
    return props[0].wtns, props[0].output
