"""Regular functions and divisor witnesses: the core of the Eagen argument.

Counterpart of the JAX package's divisor.py: the merge tree, and the naive
line arrangement beside it as a second oracle (host replica and device
version, at the end of this module):

  * a regular function a(x) + y*b(x) is a pair of coefficient tensors
    (..., M, La, 16) / (..., M, Lb, 16), batched over the merge tree's
    population M and any leading dims (the argument's digit rounds)
  * the merge recursion is level-synchronous: each level merges all
    consecutive pairs at once; polynomial lengths double per level and are
    trimmed to their semantic lengths (La_k = 2^k + 1, Lb_k = 2^k)
  * identity points, degenerate lines and zero outputs are masks; absent
    points are identity-padded slots
  * lines are built from affine-normalized points, so witness coefficients
    are a deterministic function of the input points (the canonical
    convention of the JAX package and its host oracle)

Levels whose incoming a-poly is shorter than FUSE_MIN_LA take the
coefficient route (naive products, kate division).  Longer ones take the
fused evaluation-domain tail: four forward transforms, the whole numerator
pointwise, the two divisions by (x - root) as one batch inversion, two
inverse transforms.  On every device that is the limb-major tail
(_merge_tail_fused_lm) over ops/cuda_ntt.py: the kernels for a CUDA tensor,
their plain versions for a CPU one.  The element-major _merge_tail_fused
(the JAX package's CPU route) stays beside it as the second route the tests
hold it against.  A level whose inputs break the pointwise division (a
degenerate line, a 2-torsion output, a root on the evaluation domain) is
found with one host-side flag and redone by exact coefficient division, so
every level is bit-identical to the coefficient route.

LEVEL_COUNTS counts the levels by the route they took, so that a caller can
show which routes a run went through.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .convert import JPoint, Level, RF, limbs_from_numpy, limbs_to_numpy
from .fields import CurveSpec, N_LIMBS
from .limbs import mont_limbs_to_ints
from .ops import cuda_ff as CF
from .ops import cuda_lines as CL
from .ops import cuda_ntt as CN
from .ops import poly as P
from .ops.ec import EC, ec
from .ops.ff import ff
from .ops.ntt import _bitrev_perm, _mont_powers, intt_dit, ntt_dif, twiddle_flat
from .utils import pyref


# Minimum incoming a-poly length for the fused evaluation-domain merge: the
# big product's operands reach the NTT length of ops/poly.mul_auto exactly
# when la >= 32.
FUSE_MIN_LA = 32

LEVEL_COUNTS = {"coefficient": 0, "fused": 0, "fallback": 0}


def reset_level_counts() -> None:
    for key in LEVEL_COUNTS:
        LEVEL_COUNTS[key] = 0


# ---------------------------------------------------------------------------
# regular-function algebra (batched)
# ---------------------------------------------------------------------------

_SUBST: dict = {}


def _subst_poly(curve: CurveSpec, device) -> torch.Tensor:
    """x^3 + A x + B as a (4, 16) Montgomery coefficient tensor on `device`."""
    key = (curve.name, str(torch.device(device)))
    t = _SUBST.get(key)
    if t is None:
        k = ff(curve.field)
        t = _SUBST[key] = torch.stack([k.const(c, device) for c in (curve.b, curve.a, 0, 1)])
    return t


def rf_mul(curve: CurveSpec, f: RF, g: RF) -> RF:
    """(a1 + y b1)(a2 + y b2) with y^2 = x^3 + A x + B substituted."""
    spec = curve.field
    a = P.mul_auto(spec, f.a, g.a)
    bb = P.mul_auto(spec, f.b, g.b)
    subst = _subst_poly(curve, bb.device).expand(bb.shape[:-2] + (4, N_LIMBS))
    a_out = P.add_padded(spec, a, P.mul_naive(spec, bb, subst))
    b_out = P.add_padded(spec, P.mul_auto(spec, f.a, g.b), P.mul_auto(spec, f.b, g.a))
    return RF(a_out, b_out)


def rf_eval(curve: CurveSpec, f: RF, x, y):
    """Evaluate at affine (x, y): a(x) + y b(x)."""
    k = ff(curve.field)
    return k.add(P.eval_poly(curve.field, f.a, x),
                 k.mul(P.eval_poly(curve.field, f.b, x), y))


def linefunc_affine(curve: CurveSpec, x1, y1, id1, x2, y2, id2):
    """Line through two canonical projective points (x, y, 1), or (0, 1, 0)
    for the identity: cross-product coefficients (lx, ly, lz) of the line
    lx*X + ly*Y + lz."""
    k = ff(curve.field)
    return CL.line(k.mul, k.sub, k.one(x1.device).expand(x1.shape), x1, y1, id1, x2, y2, id2)


def _line_rf(lx, ly, lz) -> RF:
    """Line to regular function: a-poly [lz, lx], b-poly [ly]."""
    return RF(torch.stack([lz, lx], dim=-2), ly[..., None, :])


# ---------------------------------------------------------------------------
# seeds and merges
# ---------------------------------------------------------------------------

def _eval_domain_consts(curve: CurveSpec, logn: int, device):
    """Evaluation-domain constants of the fused merge at NTT size 2^logn:
    W[i] = w^rev(i) and S[i] = W[i]^3 + A W[i] + B (the y^2 substitution),
    (n, 16) Montgomery limb tensors on `device` in BIT-REVERSED order, the
    order ntt_dif's spectrum comes in.  W is a running product on the host in
    the Montgomery domain; S is computed from it on the device (fully
    reduced, so the same limbs as the host's integers would give)."""
    spec = curve.field
    if logn > spec.s:
        raise ValueError(f"size 2^{logn} exceeds the 2-adicity of {spec.name}")
    powers = _mont_powers(spec, spec.omega_pow(spec.s - logn), 1 << logn)
    W = limbs_from_numpy(powers[_bitrev_perm(logn)], device)
    k = ff(spec)
    S = k.add(k.mul(k.sqr(W), W), k.const(curve.b, device).expand(W.shape))
    if curve.a:
        S = k.add(S, k.mul(W, k.const(curve.a, device).expand(W.shape)))
    return W, S


_FUSED_DEV: dict = {}


def _fused_consts_dev(curve: CurveSpec, logn: int, device):
    """Device constants of the fused merge at NTT size 2^logn, built once
    per (curve, logn, device): (W, S) as (n, 16) int32 and the limb-major
    forward and inverse twiddle tables (16, n - 1)."""
    key = (curve.name, logn, str(torch.device(device)))
    c = _FUSED_DEV.get(key)
    if c is None:
        c = _FUSED_DEV[key] = (*_eval_domain_consts(curve, logn, device),
                               CN.tables(curve.field, logn, False, device),
                               CN.tables(curve.field, logn, True, device))
    return c


def _multi_affine(E: EC, pts_list):
    """Affine-normalize several point batches of one shape with ONE shared
    batch inversion (EC.to_affine on them stacked): [(x, y, is_identity)],
    identities as (0, 0)."""
    x, y, ident = E.to_affine(JPoint(*(torch.stack(c) for c in zip(*pts_list))))
    return [(x[i], y[i], ident[i]) for i in range(len(pts_list))]


def _take_pts(p: JPoint, sl) -> JPoint:
    return JPoint(p.x[..., sl, :], p.y[..., sl, :], p.z[..., sl, :])


def _take_level(lv: Level, sl) -> Level:
    return Level(_take_pts(lv.out, sl),
                 RF(lv.wtns.a[..., sl, :, :], lv.wtns.b[..., sl, :, :]))


def _pad_poly(arr, n: int):
    cur = arr.shape[-2]
    if cur == n:
        return arr
    return torch.nn.functional.pad(arr, (0, 0, 0, n - cur))


def _head_lines(curve: CurveSpec, head: bool, pts):
    """The lines of merge_head (head) or seeds from the three points of each
    slot (JPoints of one shape): their Z inverted by one batch inversion,
    then the affine normalisation, the lines and the masks in one
    affine_lines launch on the card (ops/cuda_lines.py), its plain version
    on the CPU.  Returns affine_lines' (rows, flags)."""
    x, y, z = (torch.stack(c) for c in zip(*pts))
    zinv = ff(curve.field).batch_inv(z.reshape(-1, N_LIMBS), axis=0).reshape(z.shape)
    fn = CL.affine_lines if CF._use_kernel(x) else CL.affine_lines_plain
    return fn(curve.field, head, x, y, zinv)


def seeds(curve: CurveSpec, pts: JPoint) -> Level:
    """Seed level from N points (N even): consecutive pairs (p1, p2)

      p1 != id             -> line(p1, p2), output -(p1 + p2)
      p1 == id, p2 != id   -> line(p2, -p2), output -p2
      both id              -> witness 1, output id

    so the output is -(p1 + p2) in every case.  Where the line's points are
    equal (the tangent case p1 == p2) it is the line through p1 and the
    output.  The three points of a slot are normalised with one batch
    inversion (_head_lines)."""
    E = ec(curve)
    p1 = _take_pts(pts, slice(0, None, 2))
    p2 = _take_pts(pts, slice(1, None, 2))
    out = E.neg(E.add(p1, p2))
    (lx, ly, lz), _ = _head_lines(curve, False, [p1, p2, out])
    return Level(out, _line_rf(lx, ly, lz))


def fused_logn(la: int, lb: int) -> int:
    """NTT size exponent the fused merge uses for input lengths (la, lb)."""
    return (la + lb + 2 - 1).bit_length()


def merge_head(curve: CurveSpec, a_out: JPoint, b_out: JPoint):
    """The point/line/root computation every merge route shares: from the
    two subtree outputs, the merged output, the bypass mask (either output
    the identity), the degenerate-line flag, the (masked) line coefficients
    of line(-a.out, -b.out) (through c = a.out + b.out where -a.out ==
    -b.out; the constant 1 on bypass slots), the outputs' negated y and the
    division roots (the affine x of the outputs, 1 on bypass slots).  The
    three points are normalised with one batch inversion (_head_lines)."""
    out = ec(curve).add(a_out, b_out)
    (lx, ly, lz, nay, nby, root_a, root_b), (deg, bypass) = _head_lines(
        curve, True, [a_out, b_out, out])
    return out, bypass, deg, (lx, ly, lz), (nay, nby), (root_a, root_b)


def merge_pairs(curve: CurveSpec, a: Level, b: Level, consts=None, tail=None) -> Level:
    """Batched merge of propagations: for each slot
      output = a.out + b.out
      witness = a.wtns * b.wtns * line(-a.out, -b.out) / (x - ax)(x - bx)
    with the division skipped (and the line set to 1) where either output is
    the identity.

    tail: optional override of the numerator/division computation (same
    signature as _merge_tail_fused), taken at every level when given."""
    k = ff(curve.field)
    spec = curve.field

    out, bypass, deg, line, neg_ys, roots = merge_head(curve, a.out, b.out)

    if tail is not None:
        return tail(curve, a, b, out, bypass, deg, line, neg_ys, roots, consts)
    if a.wtns.a.shape[-2] >= FUSE_MIN_LA:
        return _merge_tail_fused_lm(curve, a, b, out, bypass, deg, line, neg_ys, roots, consts)

    LEVEL_COUNTS["coefficient"] += 1
    root_a, root_b = roots
    num = rf_mul(curve, a.wtns, rf_mul(curve, b.wtns, _line_rf(*line)))
    qa = P.kate_div2(spec, num.a, root_a, root_b)
    qb = P.kate_div2(spec, num.b, root_a, root_b)
    return Level(out, RF(k.select(bypass[..., None], num.a, qa),
                         k.select(bypass[..., None], num.b, qb)))


def _unsafe(k, bypass, deg, neg_ys, den_zero) -> bool:
    """The one host-side flag of a fused level: a degenerate line, a
    2-torsion output or a zero denominator breaks the pointwise division."""
    nay, nby = neg_ys
    torsion = ~bypass & (k.is_zero(nay) | k.is_zero(nby))
    return bool((deg.any() | torsion.any() | den_zero).item())


def _div_coeff(spec, num_a, num_b, bypass, roots):
    """Exact coefficient-domain division of a level's numerators (the
    fallback): both kate divisions in one walk each (kate_div2), bypass
    slots undivided."""
    k = ff(spec)
    root_a, root_b = roots
    qa = P.kate_div2(spec, num_a, root_a, root_b)
    qb = P.kate_div2(spec, num_b, root_a, root_b)
    return k.select(bypass[..., None], num_a, qa), k.select(bypass[..., None], num_b, qb)


def _merge_tail_fused_lm(curve, a, b, out, bypass, deg, line, neg_ys, roots, consts=None):
    """The fused tail on limb-major (16, E) data through ops/cuda_ntt: one
    layout transpose per operand at entry and one per result at exit; every
    transform and pointwise op in between is one of the five kernels (or its
    plain version on the CPU).  The inverse transforms' 1/n is folded into
    the denominator before its batch inversion (dinv = 1/(n den)).  Same
    math and same results as _merge_tail_fused."""
    k = ff(curve.field)
    spec = curve.field
    lx, ly, lz = line

    la, lb = a.wtns.a.shape[-2], a.wtns.b.shape[-2]
    out_len_a, out_len_b = la + lb + 2, la + lb + 1
    logn = fused_logn(la, lb)
    n = 1 << logn
    dev = a.wtns.a.device
    W, S, tw_f, tw_i = consts if consts is not None else _fused_consts_dev(curve, logn, dev)
    LEVEL_COUNTS["fused"] += 1

    lead = a.wtns.a.shape[:-2]            # (..., m2)
    pairs = int(np.prod(lead))

    def fwd(arr):
        return CN.ntt_dif_lm(spec, CN.to_lm(_pad_poly(arr, n)), logn, tw_f)

    fa1, fb1, fa2, fb2 = fwd(a.wtns.a), fwd(a.wtns.b), fwd(b.wtns.a), fwd(b.wtns.b)
    S_lm, W_lm = CN.bcast_table_lm(S, pairs), CN.bcast_table_lm(W, pairs)
    lx_lm, ly_lm, lz_lm = (CN.bcast_pairs_lm(v, n) for v in (lx, ly, lz))
    ra_lm, rb_lm = (CN.bcast_pairs_lm(r, n) for r in roots)

    def mul(x, y):
        return CN.lm_mul(spec, x, y)

    def add(x, y):
        return CN.lm_add(spec, x, y)

    # (a1 + y b1)(a2 + y b2) = P + y Q with y^2 -> S, times the line
    # (lz + lx x) + y ly
    pv = add(mul(fa1, fa2), mul(mul(fb1, fb2), S_lm))
    qv = add(mul(fa1, fb2), mul(fb1, fa2))
    del fa1, fb1, fa2, fb2
    lv = add(lz_lm, mul(lx_lm, W_lm))
    num_a_v = add(mul(pv, lv), mul(mul(qv, S_lm), ly_lm))
    num_b_v = add(mul(pv, ly_lm), mul(qv, lv))
    del pv, qv, lv, S_lm, lx_lm, lz_lm, ly_lm

    den = mul(CN.lm_sub(spec, W_lm, ra_lm), CN.lm_sub(spec, W_lm, rb_lm))
    del W_lm, ra_lm, rb_lm
    # bypass slots: den = one, so the quotient is intt(num) / n, the
    # element-major tail's bypass result
    byp = bypass.reshape(-1).repeat_interleave(n)
    den = torch.where(byp[None, :], k.one(dev)[:, None], den)
    # fold the inverse transforms' 1/n into the batch inversion
    den = CN.lm_mul_const(spec, den, (n << 256) % spec.p)

    den_zero = (den == 0).all(dim=0).any()
    if _unsafe(k, bypass, deg, neg_ys, den_zero):
        LEVEL_COUNTS["fallback"] += 1
        tw_em = twiddle_flat(spec, logn, True, dev)
        num_a = intt_dit(spec, CN.from_lm(num_a_v, lead + (n,)), tws=tw_em)
        num_b = intt_dit(spec, CN.from_lm(num_b_v, lead + (n,)), tws=tw_em)
        wa, wb = _div_coeff(spec, num_a, num_b, bypass, roots)
    else:
        dinv = CN.to_lm(k.batch_inv(CN.from_lm(den, (pairs * n,)), axis=0))
        del den
        wa = CN.from_lm(CN.intt_dit_lm(spec, mul(num_a_v, dinv), logn, tw_i), lead + (n,))
        wb = CN.from_lm(CN.intt_dit_lm(spec, mul(num_b_v, dinv), logn, tw_i), lead + (n,))
    return Level(out, RF(wa[..., :out_len_a, :], wb[..., :out_len_b, :]))


def _merge_tail_fused(curve, a, b, out, bypass, deg, line, neg_ys, roots, consts=None):
    """The fused tail on element-major (..., n, 16) data through ops/ff and
    ops/ntt: 4 forward transforms, the numerator a.wtns * b.wtns * line
    pointwise (the y^2 substitution is the value vector S), the two kate
    divisions by (x - root) pointwise, 2 inverse transforms.  The numerator
    is exactly divisible by (x - ax)(x - bx) unless an output is 2-torsion,
    the two roots coincide (the degenerate-line flag) or a root is an
    evaluation point; those levels are redone by exact coefficient division,
    so the result is bit-identical to the coefficient route."""
    k = ff(curve.field)
    spec = curve.field
    lx, ly, lz = line
    root_a, root_b = roots

    la, lb = a.wtns.a.shape[-2], a.wtns.b.shape[-2]
    out_len_a, out_len_b = la + lb + 2, la + lb + 1
    logn = fused_logn(la, lb)
    n = 1 << logn
    dev = a.wtns.a.device
    W, S = (consts if consts is not None else _fused_consts_dev(curve, logn, dev))[:2]
    tw_f, tw_i = twiddle_flat(spec, logn, False, dev), twiddle_flat(spec, logn, True, dev)
    LEVEL_COUNTS["fused"] += 1

    # the spectra stay in ntt_dif's bit-reversed order: everything below is
    # pointwise
    fa1, fb1, fa2, fb2 = (ntt_dif(spec, _pad_poly(x, n), tws=tw_f)
                          for x in (a.wtns.a, a.wtns.b, b.wtns.a, b.wtns.b))
    pv = k.add(k.mul(fa1, fa2), k.mul(k.mul(fb1, fb2), S))
    qv = k.add(k.mul(fa1, fb2), k.mul(fb1, fa2))
    lv = k.add(lz[..., None, :], k.mul(lx[..., None, :], W))
    lyv = ly[..., None, :]
    num_a_v = k.add(k.mul(pv, lv), k.mul(k.mul(qv, S), lyv))
    num_b_v = k.add(k.mul(pv, lyv), k.mul(qv, lv))

    den = k.mul(k.sub(W, root_a[..., None, :]), k.sub(W, root_b[..., None, :]))
    den = torch.where(bypass[..., None, None], k.one(dev), den)

    if _unsafe(k, bypass, deg, neg_ys, k.is_zero(den).any()):
        LEVEL_COUNTS["fallback"] += 1
        num_a = intt_dit(spec, num_a_v, tws=tw_i)[..., :out_len_a, :]
        num_b = intt_dit(spec, num_b_v, tws=tw_i)[..., :out_len_b, :]
        return Level(out, RF(*_div_coeff(spec, num_a, num_b, bypass, roots)))
    dinv = k.batch_inv(den, axis=-2)
    wa = intt_dit(spec, k.mul(num_a_v, dinv), tws=tw_i)
    wb = intt_dit(spec, k.mul(num_b_v, dinv), tws=tw_i)
    return Level(out, RF(wa[..., :out_len_a, :], wb[..., :out_len_b, :]))


def merge_level(curve: CurveSpec, a_sem: int, b_sem: int, lv: Level,
                consts=None, tail=None) -> Level:
    """One level: merge consecutive pairs; an odd last entry passes through
    (padded).  a_sem / b_sem: the level's semantic output lengths; everything
    beyond is provably zero and trimmed.  consts: optional _fused_consts_dev
    tuple of the fused route; tail: optional merge-tail override."""
    m = lv.out.x.shape[-2]
    m2 = m // 2
    a = _take_level(lv, slice(0, 2 * m2, 2))
    b = _take_level(lv, slice(1, 2 * m2, 2))
    merged = merge_pairs(curve, a, b, consts, tail=tail)
    merged = Level(merged.out, RF(merged.wtns.a[..., :a_sem, :], merged.wtns.b[..., :b_sem, :]))
    if m % 2:
        last = _take_level(lv, slice(2 * m2, m))
        la, lb = merged.wtns.a.shape[-2], merged.wtns.b.shape[-2]
        merged = Level(
            JPoint(*(torch.cat([mc, tc], dim=-2) for mc, tc in zip(merged.out, last.out))),
            RF(torch.cat([merged.wtns.a, _pad_poly(last.wtns.a, la)], dim=-3),
               torch.cat([merged.wtns.b, _pad_poly(last.wtns.b, lb)], dim=-3)))
    return merged


def compute_divisor_witness_partial(curve: CurveSpec, pts: JPoint):
    """The reference's compute_divisor_witness_partial, batched: returns
    (RF witness, output point) with output = -(sum of pts).  pts: JPoint of
    (..., N, 16) coordinates; an odd N is identity-padded.  The witness
    vanishes at every non-identity input and at the output."""
    n = pts.x.shape[-2]
    if n == 0:
        raise ValueError("empty point list")
    if n % 2:
        idp = ec(curve).identity(pts.x.shape[:-2] + (1,), pts.x.device)
        pts = JPoint(*(torch.cat([c, i], dim=-2) for c, i in zip(pts, idp)))
    lv = seeds(curve, pts)
    b_sem = 1  # seeds: a-len 2, b-len 1
    while lv.out.x.shape[-2] > 1:
        b_sem *= 2
        la, lb = lv.wtns.a.shape[-2], lv.wtns.b.shape[-2]
        consts = (_fused_consts_dev(curve, fused_logn(la, lb), pts.x.device)
                  if la >= FUSE_MIN_LA else None)
        lv = merge_level(curve, b_sem + 1, b_sem, lv, consts)
    out = JPoint(*(c[..., 0, :] for c in lv.out))
    return RF(lv.wtns.a[..., 0, :, :], lv.wtns.b[..., 0, :, :]), out


def compute_divisor_witness(curve: CurveSpec, pts: JPoint) -> RF:
    """The reference's compute_divisor_witness: raises unless the points sum
    to the identity."""
    wtns, out = compute_divisor_witness_partial(curve, pts)
    if not bool(ec(curve).is_identity(out).all()):
        raise AssertionError("points do not sum to the identity")
    return wtns


# ---------------------------------------------------------------------------
# naive line-arrangement witness (second oracle)
# ---------------------------------------------------------------------------

class Arrangement(NamedTuple):
    """Lists of numerator (pos) and denominator (neg) lines, each a host-side
    list of (lx, ly, lz) canonical int triples."""
    pos: list
    neg: list


def compute_divisor_witness_naive_host(curve: CurveSpec, pts_ints) -> Arrangement:
    """Host replica of the reference's compute_divisor_witness_naive, in
    Python ints: rounds of pairwise addition over pos/neg stacks (popped from
    the end, as the reference does), accumulating line functions, until each
    side holds at most one point; then the reference's final assertions.
    The product of the pos lines over the product of the neg lines has the
    divisor sum [P_i] - n[O], as the merge tree's witness does."""

    def line_ints(a, b):
        # the canonical affine cross product of linefunc_affine
        p = curve.field.p

        def coords(pt):
            return (0, 1, 0) if pt is None else (pt[0], pt[1], 1)

        ax, ay, az = coords(a)
        bx, by, bz = coords(b)
        lx = (ay * bz - az * by) % p
        ly = (az * bx - ax * bz) % p
        lz = (ax * by - ay * bx) % p
        if lx or ly or lz:
            return (lx, ly, lz)
        c = pyref.ec_neg(pyref.ec_add(a, b, curve), curve)
        cx, cy, cz = coords(c)
        return ((ay * cz - az * cy) % p, (az * cx - ax * cz) % p, (ax * cy - ay * cx) % p)

    pos = list(pts_ints)
    neg = []
    ret_pos, ret_neg = [], []
    tmp = []
    while len(pos) > 1 or len(neg) > 1:
        while len(pos) > 1:
            inc1 = pos.pop()
            if inc1 is not None:
                tmp.append((inc1, pos.pop()))
        # the reference drains tmp with pop(): REVERSED pair order, both for
        # the emitted lines and for the sums pushed onto the other stack
        for (x, y) in reversed(tmp):
            q = pyref.ec_add(x, y, curve)
            ret_pos.append(line_ints(x, y))
            neg.append(pyref.ec_neg(q, curve))
        tmp = []
        while len(neg) > 1:
            inc1 = neg.pop()
            if inc1 is not None:
                tmp.append((inc1, neg.pop()))
        for (x, y) in reversed(tmp):
            q = pyref.ec_add(x, y, curve)
            ret_neg.append(line_ints(x, y))
            pos.append(pyref.ec_neg(q, curve))
        tmp = []
    if len(pos) == 1 and len(neg) == 1:
        closes = pos[0] == neg[0]
    else:  # one point left on one side, or none
        closes = (pos + neg + [None])[0] is None
    if not closes:
        raise AssertionError("points do not sum to the identity")
    return Arrangement(ret_pos, ret_neg)


def _line_pairs(curve: CurveSpec, E: EC, pa: JPoint, pb: JPoint, neg_q: JPoint):
    """Canonical lines through the pairs (pa[j], pb[j]) with the host
    replica's semantics: the cross product on affine coordinates, and where
    it vanishes (pa == pb) the line through pa and c = -(pa + pb) = neg_q.
    The three batches are normalized by one batch inversion."""
    k = ff(curve.field)
    (ax, ay, aid), (bx, by, bid), (cx, cy, cid) = _multi_affine(E, [pa, pb, neg_q])
    lx, ly, lz = linefunc_affine(curve, ax, ay, aid, bx, by, bid)
    deg = k.is_zero(lx) & k.is_zero(ly) & k.is_zero(lz)
    lx2, ly2, lz2 = linefunc_affine(curve, ax, ay, aid, cx, cy, cid)
    return k.select(deg, lx2, lx), k.select(deg, ly2, ly), k.select(deg, lz2, lz)


def _pop_roles(is_id):
    """The reference's pop loop over one stack, vectorized: walking from the
    TOP, an identity in the inc1 slot is dropped, any other element pairs
    with the next one below (an identity partner is consumed too), and the
    walk stops with one element left (the bottom one is never an inc1).

    The walk is a two-state machine (expecting inc1 = 0, expecting a
    partner = 1): an identity sets the state to 0, any other element flips
    it.  So the state before element i of the top-down stream is the parity
    of the elements since the last identity before i: one running maximum of
    identity positions, no sequential loop.

    is_id: (cnt,) bool in BOTTOM-up stack order.  Returns (inc1, partner,
    kept) bool masks in stack order; kept marks the bottom element when the
    walk leaves it."""
    cnt = is_id.shape[0]
    dev = is_id.device
    id_r = is_id.flip(0)                                  # top-down stream
    idx = torch.arange(cnt, device=dev)
    last_id = torch.cummax(torch.where(id_r, idx, -1), dim=0).values
    before = torch.cat([torch.full((1,), -1, dtype=idx.dtype, device=dev), last_id[:-1]])
    state = (idx - 1 - before) % 2                        # before element i
    bottom = idx == cnt - 1
    inc1 = (state == 0) & ~id_r & ~bottom
    partner = state == 1
    kept = bottom & (state == 0)
    return inc1.flip(0), partner.flip(0), kept.flip(0)


def _naive_round(curve: CurveSpec, stack: JPoint):
    """One pairing round over ONE side's stack (bottom at index 0), with the
    reference's pop semantics: returns (kept stack (0 or 1 points), -q sums
    in emission order, lines (lx, ly, lz, npair)).  The reference drains its
    pairs in reverse pop order, which is the inc1s in ascending stack order;
    each inc1's partner is the element below it."""
    E = ec(curve)
    empty = _take_pts(stack, slice(0, 0))
    if stack.x.shape[0] <= 1:
        return stack, empty, (*empty, 0)
    inc1, _, kept = _pop_roles(E.is_identity(stack))
    ia = inc1.nonzero().flatten()
    npair = int(ia.shape[0])
    rest = _take_pts(stack, kept.nonzero().flatten())
    if npair == 0:
        return rest, empty, (*empty, 0)
    pa, pb = _take_pts(stack, ia), _take_pts(stack, ia - 1)
    neg_q = E.neg(E.add(pa, pb))
    return rest, neg_q, (*_line_pairs(curve, E, pa, pb, neg_q), npair)


def compute_divisor_witness_naive_device(curve: CurveSpec, pts: JPoint):
    """The reference's compute_divisor_witness_naive on the device: rounds of
    pairwise addition over pos/neg stacks, one canonical line per pair; the
    production-size second oracle the host replica cannot reach.  Pop order,
    identity drops and the reversed drain are those of the reference, so the
    lines equal compute_divisor_witness_naive_host's at any size.  Each round
    works on the live stack only and the loop stops once both stacks hold at
    most one point.

    pts: (N,) JPoint.  Returns (pos_lines, neg_lines): per processing round
    (lx, ly, lz, count) with (count, 16) line tensors; flatten with
    naive_device_lines_to_ints."""
    pos = pts
    neg = _take_pts(pts, slice(0, 0))
    pos_lines, neg_lines = [], []

    def push(side: JPoint, sums: JPoint) -> JPoint:
        return JPoint(*(torch.cat([c, q]) for c, q in zip(side, sums)))

    while pos.x.shape[0] > 1 or neg.x.shape[0] > 1:
        pos, sums, lines = _naive_round(curve, pos)
        neg = push(neg, sums)
        pos_lines.append(lines)
        neg, sums, lines = _naive_round(curve, neg)
        pos = push(pos, sums)
        neg_lines.append(lines)
    return pos_lines, neg_lines


def naive_device_lines_to_ints(curve: CurveSpec, lines):
    """Flatten per-round line tensors to host int triples in the host
    replica's emission order."""
    out = []
    for lx, ly, lz, cnt in lines:
        if cnt == 0:
            continue
        xs, ys, zs = (mont_limbs_to_ints(limbs_to_numpy(v), curve.field) for v in (lx, ly, lz))
        out.extend(zip(xs, ys, zs))
    return out


def lines_product(curve: CurveSpec, lines, x, y):
    """The product over the lines of a naive arrangement side (per-round
    (lx, ly, lz, count) tensors) of lx*x + ly*y + lz at the affine points
    (x, y) (k, 16): a (k, 16) tensor, by a tree of products (no inversion).
    pos over neg is the arrangement's rational function."""
    k = ff(curve.field)
    lx, ly, lz = (torch.cat([ln[i] for ln in lines]) for i in range(3))
    v = k.add(k.add(k.mul(lx[:, None], x[None]), k.mul(ly[:, None], y[None])),
              lz[:, None].expand(-1, x.shape[0], -1))
    one = k.one(x.device).expand(1, *x.shape)
    if v.shape[0] == 0:
        return one[0]
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.cat([v, one])
        v = k.mul(v[0::2], v[1::2])
    return v[0]
