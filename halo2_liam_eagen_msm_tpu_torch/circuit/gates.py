"""Gate algebra and challenge postprocessing.

The reference's gates (config.rs:232-568) are plonkish polynomial identities
over three advice columns (a, b, c in phases 1..3), fixed selector columns and
three challenges.  Here each gate is a plain function over a row-indexed view
(with rotations) returning the constraint value — evaluated over the whole
grid by checker.py, playing MockProver's role without a SNARK stack.

The challenge->point postprocessing functions (to_curve_x, y_from_x, slope;
config.rs:166-187) exist on both the witness side and the gate side — the
property the reference's challenge_postprocessing_test establishes for the
fork's Expression::Postprocess / Value::apply pair
(the reference's testing_stuff/challenge_postprocessing_test.rs).
"""

from __future__ import annotations

from ..fields import CurveSpec, FieldSpec
from ..negbase import digit_by_id
from ..utils.pyref import sqrt_tonelli


# ------------------------------------------------------ sqrt_alt + postproc

def sqrt_alt(spec: FieldSpec, x: int):
    """(is_square, y): y = sqrt(x) if x is a QR, else sqrt(x * w) where w is
    the field's 2^s root of unity (a non-residue since (p-1)/2^s is odd).
    Deterministic stand-in for halo2curves' sqrt_alt (used at config.rs:172,181)."""
    x %= spec.p
    y = sqrt_tonelli(x, spec)
    if y is not None:
        return True, y
    y = sqrt_tonelli(x * spec.root_of_unity % spec.p, spec)
    assert y is not None
    return False, y


def curve_rhs(curve: CurveSpec, x: int) -> int:
    """x^3 + a*x + b."""
    p = curve.field.p
    return (x * x % p * x + curve.a * x + curve.b) % p


def to_curve_x(curve: CurveSpec, ch: int) -> int:
    """First x >= ch (incrementing) whose curve RHS is square
    (config.rs:166-175: the loop retries sqrt_alt until flag)."""
    x = ch % curve.field.p
    while True:
        flag, _ = sqrt_alt(curve.field, curve_rhs(curve, x))
        if flag:
            return x
        x = (x + 1) % curve.field.p


def y_from_x(curve: CurveSpec, x: int) -> int:
    """config.rs:177-182."""
    flag, y = sqrt_alt(curve.field, curve_rhs(curve, x))
    assert flag, "x not on curve"
    return y


def slope(curve: CurveSpec, x: int, y: int) -> int:
    """Tangent slope at an affine point (config.rs:184-187)."""
    p = curve.field.p
    return (3 * x * x + curve.a) * pow(2 * y % p, p - 2, p) % p


def derive_point(curve: CurveSpec, ch: int):
    """challenge -> (Ax, Ay, t, f): the challenge point, tangent slope and
    line constant f = t*Ax - Ay used by the rhs-main gate (config.rs:513-521)."""
    ax = to_curve_x(curve, ch)
    ay = y_from_x(curve, ax)
    t = slope(curve, ax, ay)
    f = (t * ax - ay) % curve.field.p
    return ax, ay, t, f


# ----------------------------------------------------------------- gates
# Each gate takes (view, row) where view gives column values with rotation:
# view(col, rot) -> int at (row + rot) mod 2^k.  Challenges/params arrive via
# closure.  Returns the gate value (must be 0 when satisfied and selected).

def gate_arith(p, view):
    """arithmetic gate (config.rs:232-244):
    s_arith[-1] * (b[0] + c[-3]*c[-2] + c[-1]*CONST[0] - c[0])"""
    s = view("s_arith", -1)
    g = (
        view("b", 0)
        + view("c", -3) * view("c", -2)
        + view("c", -1) * view("table", 0)
        - view("c", 0)
    ) % p
    return s * g % p


def gate_poly_rlc(p, view, r: int, poly_fan_in: int, batch_size: int, c_skip: int):
    """polynomials random-linear-combination gate (config.rs:246-283):
    three variants (init / full fan-in / truncated) under s1/s2/s3poly."""
    powers = [1, r % p]
    for i in range(1, poly_fan_in):
        powers.append(powers[i] * powers[1] % p)
    a_rots = []
    for i in range(poly_fan_in):
        k = i * c_skip - batch_size + c_skip
        a_rots.append(view("a", k))
    acc = sum(powers[i] * a_rots[i] for i in range(poly_fan_in)) % p
    acc_trunc = sum(powers[i] * a_rots[i] for i in range(poly_fan_in - 1)) % p
    c0 = view("c", 0)
    cn1 = view("c", -1)
    g1 = (acc - c0) % p
    g2 = (cn1 * powers[poly_fan_in] + acc - c0) % p
    g3 = (cn1 * powers[poly_fan_in] + acc_trunc - c0) % p
    return (
        view("s1poly", 0) * g1 + view("s2poly", 0) * g2 + view("s3poly", 0) * g3
    ) % p


def gate_b(p, view, base: int, num_limbs: int, logtable: int):
    """b gate (config.rs:332-357): scalar-from-buckets, bucket-from-limbs and
    limb-integrity sub-gates under s1sc/s2sc/s3sc."""
    b0 = view("b", 0)
    b_primary = [view("b", i) for i in range(1, num_limbs + 1)]
    b_secondary = [view("b", i * (num_limbs + 1)) for i in range(1, base)]
    g_sc = (sum(b_secondary[i] * digit_by_id(i) for i in range(base - 1)) - b0) % p
    g_int = (sum(b_secondary) - b0) % p
    g_bucket = (
        sum(
            b_primary[i] * pow(base, i * logtable, p)
            for i in range(num_limbs)
        )
        - b0
    ) % p
    return (
        view("s1sc", 0) * g_sc
        + view("s2sc", 0) * g_bucket
        + view("s3sc", 0) * g_int
    ) % p


def gate_lookup(p, view, v: int, b_skip: int, c_skip: int):
    """custom log-derivative lookup (config.rs:402-437): rhs running sums over
    the B1 region, lhs per-table-entry sums, tied by challenge v."""
    c0 = view("c", 0)
    c1 = view("c", 1)
    cn1 = view("c", -1)
    cnb = view("c", -(1 + b_skip))
    cnc = view("c", -(1 + c_skip))
    b0 = view("b", 0)
    b1 = view("b", 1)
    t = view("table", 0)
    rhs1 = ((c1 - c0) * (v - b1) - 1) % p
    rhs2 = ((c1 - cn1) * (v - b1) - 1) % p
    rhs3 = ((c1 - cnb) * (v - b1) - 1) % p
    lhs1 = ((c0 - cn1) * (v - t) + b0) % p
    lhs2 = ((c0 - cnc) * (v - t) + b0) % p
    return (
        view("s4sc", 0) * rhs1
        + view("s2sc", 0) * rhs2
        + (view("s1sc", 0) - view("s0sc", 0)) * rhs3
        + view("s1t", 0) * lhs1
        + view("s2t", 0) * lhs2
    ) % p


def gate_rhs_main(p, view, ax: int, ay: int, t: int, f: int,
                  sc_box_size: int, b_skip: int, num_limbs: int, base: int):
    """rhs main gate (config.rs:504-538): evaluates Eagen's argument RHS at
    the challenge-derived point A with tangent slope t, walking the c column
    across scalar boxes.  Challenge postprocessing (ax, ay, t, f) comes from
    derive_point — the witness side of Expression::Postprocess."""
    c0 = view("c", 0)
    b0 = view("b", 0)
    cn_noskip = view("c", -sc_box_size)
    cn_skip = view("c", -(sc_box_size + b_skip))
    ptx = view("table", 0)
    pty = view("table", 1)
    g_noskip = ((c0 - cn_noskip) * (f + pty - t * ptx) + b0 * (ax - ptx)) % p
    g_skip = ((c0 - cn_skip) * (f + pty - t * ptx) + b0 * (ax - ptx)) % p
    s_noskip_prep = view("s2sc", 0)
    s_skip = sum(
        view("s0sc", -(i * (num_limbs + 1))) for i in range(1, base)
    ) % p
    s_noskip = (s_noskip_prep - s_skip) % p
    return (s_noskip * g_noskip + s_skip * g_skip) % p


def gate_copy_from_b(p, view):
    """copy gate (config.rs:562-568)."""
    return view("s_copy_from_b", 0) * (view("c", 0) - view("b", 0)) % p
