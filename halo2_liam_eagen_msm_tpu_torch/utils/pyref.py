"""Exact Python-int reference implementations (test oracles).

Every layer of the port is held against an independent slower oracle; this
module is that oracle for the field, curve and MSM layers.

Points are `None` (identity) or (x, y) affine int tuples.
"""

from __future__ import annotations

from ..fields import CurveSpec, FieldSpec


# ----------------------------------------------------------------- field ops
def finv(x: int, p: int) -> int:
    return pow(x, p - 2, p)


def sqrt_tonelli(a: int, f: FieldSpec):
    """Deterministic Tonelli-Shanks sqrt; returns None if a is a non-residue.
    The root is the canonical Tonelli-Shanks output for the field's
    generator-derived non-residue."""
    p = f.p
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if f.s == 1:
        return pow(a, (p + 1) // 4, p)
    s, t = f.s, f.t_odd
    c = pow(f.generator, t, p)
    x = pow(a, (t + 1) // 2, p)
    b = pow(a, t, p)
    m = s
    while b != 1:
        i, t2 = 0, b
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        e = pow(c, 1 << (m - i - 1), p)
        x = x * e % p
        c = e * e % p
        b = b * c % p
        m = i
    return x


# ------------------------------------------------------------------- EC ops
def ec_neg(pt, c: CurveSpec):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % c.field.p)


def ec_add(p1, p2, c: CurveSpec):
    p = c.field.p
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        # double
        lam = (3 * x1 * x1 + c.a) * finv(2 * y1, p) % p
    else:
        lam = (y2 - y1) * finv(x2 - x1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def ec_mul(pt, k: int, c: CurveSpec):
    k %= c.scalar_field.p
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = ec_add(acc, add, c)
        add = ec_add(add, add, c)
        k >>= 1
    return acc


def ec_msm(scalars, pts, c: CurveSpec):
    """Naive MSM oracle: sum_i s_i * P_i by double-and-add."""
    acc = None
    for s, pt in zip(scalars, pts):
        acc = ec_add(acc, ec_mul(pt, s, c), c)
    return acc


def on_curve(pt, c: CurveSpec) -> bool:
    if pt is None:
        return True
    x, y = pt
    p = c.field.p
    return (y * y - (x * x * x + c.a * x + c.b)) % p == 0


def random_point(rng, c: CurveSpec):
    """Deterministic try-and-increment point generation from a seeded
    `random.Random`."""
    p = c.field.p
    while True:
        x = rng.randrange(p)
        rhs = (x * x * x + c.a * x + c.b) % p
        y = sqrt_tonelli(rhs, c.field)
        if y is not None:
            if y % 2 == 1:
                y = p - y
            return (x, y)


def random_points(rng, c: CurveSpec, n: int):
    return [random_point(rng, c) for _ in range(n)]


def root_on_domain_points(rng, c: CurveSpec):
    """128 points whose first 64 sum to -Q, Q = (w^j, y) with w a 128th root
    of unity (the first j with a point on the curve): at the merge tree's
    top level (NTT size 128) the root x(a.out) = w^j is an evaluation point,
    so the fused level's denominator has a zero (divisor's exact fallback;
    in parallel.mesh's a2a witness, the replicated rerun)."""
    f = c.field
    w = f.omega_pow(f.s - 7)
    for j in range(1, 128):
        x = pow(w, j, f.p)
        y = sqrt_tonelli((x * x * x + c.a * x + c.b) % f.p, f)
        if y is not None:
            break
    first = random_points(rng, c, 63)
    last = ec_neg(ec_add(ec_msm([1] * 63, first, c), (x, y), c), c)
    return first + [last] + random_points(rng, c, 64)
