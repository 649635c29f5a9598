"""The divisor merge tree of the PyTorch port: limb for limb against the JAX
package (one call, the seeds), coefficient for coefficient against the host-int
oracle at the sizes test_divisor.py uses (n <= 12, the coefficient route) and
where the fused tail runs (128 to 257 points, odd sizes), the limb-major tail
against the element-major one, the three exact fallbacks of a fused level,
and merge_head and seeds (through affine_lines' plain version) against the
composition they replaced.

All on the CPU, on the plain versions.  Integer arithmetic: tolerance zero."""

import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu import divisor as jax_divisor
from halo2_liam_eagen_msm_tpu import fields as JF
from halo2_liam_eagen_msm_tpu.ops import ec as jax_ec
from halo2_liam_eagen_msm_tpu.utils import ref_divisor
from halo2_liam_eagen_msm_tpu_torch import divisor as D
from halo2_liam_eagen_msm_tpu_torch.convert import (
    JPoint, level_from_numpy, level_to_numpy, limbs_to_numpy, rf_to_numpy)
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_mont_limbs
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.ops.ff import ff
from halo2_liam_eagen_msm_tpu_torch.ops.poly import Poly
from halo2_liam_eagen_msm_tpu_torch.utils import pyref

torch.set_num_threads(1)

CURVE = PALLAS


def closing_points(rng, n):
    """n random points plus the negated sum: the total is the identity."""
    pts = pyref.random_points(rng, CURVE, n)
    s = None
    for p in pts:
        s = pyref.ec_add(s, p, CURVE)
    return pts + [pyref.ec_neg(s, CURVE)]


def witness(pts):
    return D.compute_divisor_witness_partial(CURVE, ec(CURVE).points_from_ints(pts, "cpu"))


def _trim(coeffs):
    while coeffs and coeffs[-1] == 0:
        coeffs = coeffs[:-1]
    return coeffs


def assert_equals_host_oracle(wtns, out, pts):
    """Coefficient for coefficient against ref_divisor.divisor_witness_host
    (the oracle keeps the reference's exact vector lengths, which may end in
    zeros; the witness is zero beyond them); the same output point."""
    hrf, hout = ref_divisor.divisor_witness_host(CURVE, pts)
    a = Poly.from_device(CURVE.field, wtns.a).coeffs
    b = Poly.from_device(CURVE.field, wtns.b).coeffs
    assert _trim(a) == _trim(hrf.a.coeffs)
    assert _trim(b) == _trim(hrf.b.coeffs)
    assert ec(CURVE).points_to_ints(JPoint(*(c[None] for c in out)))[0] == hout


def test_witness_equals_jax_package(rng):
    """One JAX call at n = 2, the seeds (lines through a pair, the identity
    case, the degenerate tangent case), batched over three point lists: the
    same witness limbs, padding included, and the same output points as the
    JAX package.  Each merge level costs the JAX package about 40 s of
    compilation on the CPU; the merge levels at the sizes of test_divisor.py
    are held against the host oracle below, as that test holds the JAX
    package."""
    lists = [closing_points(rng, 1), pyref.random_points(rng, CURVE, 2),
             pyref.random_points(rng, CURVE, 2)]
    lists[1][0] = None
    lists[2][1] = lists[2][0]
    E, JE = ec(CURVE), jax_ec.ec(JF.PALLAS)
    mine = D.compute_divisor_witness_partial(CURVE, JPoint(*(
        torch.stack(c) for c in zip(*(E.points_from_ints(p, "cpu") for p in lists)))))
    jpts = [JE.points_from_ints(p) for p in lists]
    theirs = jax_divisor.compute_divisor_witness_partial(JF.PALLAS, type(jpts[0])(
        *(np.stack([np.asarray(c) for c in cs]) for cs in zip(*jpts))))
    (wa, wb), out = rf_to_numpy(mine[0]), mine[1]
    (ja, jb), jout = theirs
    assert np.array_equal(wa, np.asarray(ja)) and np.array_equal(wb, np.asarray(jb))
    for c, jc in zip(out, jout):
        assert np.array_equal(limbs_to_numpy(c), np.asarray(jc))


@pytest.mark.parametrize("logn", [1, 7, 9])
def test_eval_domain_consts_equal_jax(logn):
    """W = w^rev(i) and S = W^3 + A W + B, limb for limb the JAX package's
    host tables (numpy there, no compilation)."""
    W, S = D._eval_domain_consts(CURVE, logn, "cpu")
    jW, jS = jax_divisor._eval_domain_consts(JF.PALLAS, logn)
    assert np.array_equal(limbs_to_numpy(W), jW) and np.array_equal(limbs_to_numpy(S), jS)


@pytest.mark.parametrize("n", [2, 4, 6, 7, 12])
def test_small_witness_equals_host_oracle(rng, n):
    """The coefficient route at test_divisor.py's sizes, odd ones padded."""
    pts = closing_points(rng, n - 1)
    wtns, out = witness(pts)
    assert_equals_host_oracle(wtns, out, pts)


@pytest.mark.parametrize("n", [128, 130, 257])
def test_fused_witness_equals_host_oracle(rng, n):
    """Where the fused tail runs (the limb-major plain versions), odd sizes
    and a non-closing list (257) included."""
    pts = closing_points(rng, n - 1) if n != 257 else pyref.random_points(rng, CURVE, n)
    D.reset_level_counts()
    wtns, out = witness(pts)
    assert D.LEVEL_COUNTS["fused"] >= 1 and D.LEVEL_COUNTS["fallback"] == 0
    assert_equals_host_oracle(wtns, out, pts)


@pytest.mark.parametrize("n", [128, 256, 512])
def test_lm_route_equals_element_major_route(rng, n, monkeypatch):
    """At 128, 256 and 512 points (pairs x n no multiple of 1024, where the
    JAX package's limb-major tail cannot run) the port's witness equals the
    one the element-major tail gives, the JAX package's CPU route."""
    pts = closing_points(rng, n - 1)
    lm, lm_out = witness(pts)
    monkeypatch.setattr(D, "_merge_tail_fused_lm", D._merge_tail_fused)
    em, em_out = witness(pts)
    assert torch.equal(lm.a, em.a) and torch.equal(lm.b, em.b)
    assert all(torch.equal(x, y) for x, y in zip(lm_out, em_out))


def test_lm_tail_equals_em_tail_on_one_level(rng):
    """One fused level (two pairs, incoming a-polys 33 long, NTT size 128):
    merge_pairs through either tail gives the same level."""
    pts = ec(CURVE).points_from_ints(pyref.random_points(rng, CURVE, 256), "cpu")
    lv, b_sem = D.seeds(CURVE, pts), 1
    for _ in range(5):
        b_sem *= 2
        lv = D.merge_level(CURVE, b_sem + 1, b_sem, lv)
    assert lv.wtns.a.shape[-2] == 33 >= D.FUSE_MIN_LA and lv.out.x.shape[0] == 4
    lv = level_from_numpy(*level_to_numpy(lv), device="cpu")   # the state crosses as numpy
    a, b = D._take_level(lv, slice(0, 4, 2)), D._take_level(lv, slice(1, 4, 2))
    got = D.merge_pairs(CURVE, a, b, tail=D._merge_tail_fused_lm)
    want = D.merge_pairs(CURVE, a, b, tail=D._merge_tail_fused)
    assert torch.equal(got.wtns.a, want.wtns.a) and torch.equal(got.wtns.b, want.wtns.b)
    assert all(torch.equal(x, y) for x, y in zip(got.out, want.out))


def _identity_laden_points(rng):
    """128 points, the first 64 P, id, -P, id for 16 points P (their sum
    the identity, so a.out is the identity at the fused level: the bypass),
    the other 64 random with identities and a P, -P pair among them."""
    first = []
    for p in pyref.random_points(rng, CURVE, 16):
        first += [p, None, pyref.ec_neg(p, CURVE), None]
    second = pyref.random_points(rng, CURVE, 64)
    second[5] = second[40] = None
    second[11] = pyref.ec_neg(second[10], CURVE)
    return first + second


@pytest.mark.parametrize("case", ["degenerate_line", "root_on_domain", "identity_laden"])
def test_fused_level_fallbacks_exact(rng, case):
    """The exceptional inputs of a fused level: equal halves (degenerate
    line), a root on the evaluation domain (zero denominator) and
    identity-laden input with P, -P (bypass).  The first two redo the level
    by exact coefficient division; all three equal the host oracle."""
    if case == "degenerate_line":
        half = pyref.random_points(rng, CURVE, 64)
        pts = half + half
    elif case == "root_on_domain":
        pts = pyref.root_on_domain_points(rng, CURVE)
    else:
        pts = _identity_laden_points(rng)
    D.reset_level_counts()
    wtns, out = witness(pts)
    assert D.LEVEL_COUNTS["fused"] == 1
    assert D.LEVEL_COUNTS["fallback"] == (0 if case == "identity_laden" else 1)
    assert_equals_host_oracle(wtns, out, pts)


# ---------------------------------------------------------------------------
# merge_head and seeds through affine_lines, against the composition they
# replaced: EC.to_affine of the three points stacked, linefunc_affine twice,
# the selects (as the port wrote them before affine_lines)
# ---------------------------------------------------------------------------

def _composed_head(curve, a_out, b_out):
    E, k = ec(curve), ff(curve.field)
    out = E.add(a_out, b_out)
    bypass = E.is_identity(a_out) | E.is_identity(b_out)
    na, nb = E.neg(a_out), E.neg(b_out)
    (nax, nay, naid), (nbx, nby, nbid), (cx, cy, cid) = D._multi_affine(E, [na, nb, out])
    lx, ly, lz = D.linefunc_affine(curve, nax, nay, naid, nbx, nby, nbid)
    deg = k.is_zero(lx) & k.is_zero(ly) & k.is_zero(lz) & ~bypass
    lx2, ly2, lz2 = D.linefunc_affine(curve, nax, nay, naid, cx, cy, cid)
    lx, ly, lz = k.select(deg, lx2, lx), k.select(deg, ly2, ly), k.select(deg, lz2, lz)
    one = k.one(lx.device).expand(lx.shape)
    zero = torch.zeros_like(lx)
    lx, ly, lz = k.select(bypass, zero, lx), k.select(bypass, zero, ly), k.select(bypass, one, lz)
    roots = k.select(bypass, one, nax), k.select(bypass, one, nbx)
    return out, bypass, deg, (lx, ly, lz), (nay, nby), roots


def _composed_seeds(curve, pts):
    E, k = ec(curve), ff(curve.field)
    p1, p2 = D._take_pts(pts, slice(0, None, 2)), D._take_pts(pts, slice(1, None, 2))
    id1, id2 = E.is_identity(p1), E.is_identity(p2)
    out = E.neg(E.add(p1, p2))
    left = E.select(id1, p2, p1)
    right = E.select(id1, E.neg(p2), p2)
    cpt = E.neg(E.add(left, right))
    (lxa, lya, ida), (lxb, lyb, idb), (cx, cy, cid) = D._multi_affine(E, [left, right, cpt])
    lx, ly, lz = D.linefunc_affine(curve, lxa, lya, ida, lxb, lyb, idb)
    deg = k.is_zero(lx) & k.is_zero(ly) & k.is_zero(lz)
    lx2, ly2, lz2 = D.linefunc_affine(curve, lxa, lya, ida, cx, cy, cid)
    lx, ly, lz = k.select(deg, lx2, lx), k.select(deg, ly2, ly), k.select(deg, lz2, lz)
    both = id1 & id2
    zero = torch.zeros_like(lx)
    lx, ly = k.select(both, zero, lx), k.select(both, zero, ly)
    lz = k.select(both, k.one(lz.device).expand(lz.shape), lz)
    return out, (lx, ly, lz)


def _adversarial_slots(rng, nprng, n=24):
    """Two Jacobian batches of n points, each point with a random
    representative (Z != 1), and the adversarial slots first: p identity, q
    identity, both, q == p (the tangent case), q == -p."""
    E = ec(CURVE)
    spec = CURVE.field
    hp, hq = pyref.random_points(rng, CURVE, n), pyref.random_points(rng, CURVE, n)
    hp[0] = hq[1] = hp[2] = hq[2] = None
    hq[3] = hp[3]
    hq[4] = pyref.ec_neg(hp[4], CURVE)
    mul = lambda u, v: CF.mont_mul_plain(spec, u, v)

    def jacobian(pts):
        p = E.points_from_ints(pts, "cpu")
        lam = ints_to_mont_limbs([int(v) % spec.p or 1 for v in nprng.integers(1, 1 << 62, n)],
                                 spec)
        lam = torch.from_numpy(lam.view("int32").copy())
        l2 = mul(lam, lam)
        z = torch.where(E.is_identity(p)[:, None], p.z, lam)
        return JPoint(mul(p.x, l2), mul(p.y, mul(l2, lam)), z)
    return jacobian(hp), jacobian(hq)


@pytest.mark.parametrize("fn", ["merge_head", "seeds"])
def test_head_lines_equal_composition(rng, nprng, fn):
    """merge_head and seeds through the plain affine_lines (the route a CPU
    tensor takes) equal the composition they replaced, limb for limb and
    mask for mask, on the adversarial slots and random ones."""
    p, q = _adversarial_slots(rng, nprng)
    if fn == "merge_head":
        got, want = D.merge_head(CURVE, p, q), _composed_head(CURVE, p, q)
        assert got[1][:5].tolist() == [True, True, True, False, False]
        assert bool(got[2][3]) and int(got[2].sum()) == 1   # the tangent slot
    else:
        pts = JPoint(*(torch.stack([a, b], dim=1).reshape(-1, 16) for a, b in zip(p, q)))
        lv = D.seeds(CURVE, pts)
        got = (lv.out, (lv.wtns.a[..., 1, :], lv.wtns.b[..., 0, :], lv.wtns.a[..., 0, :]))
        want = _composed_seeds(CURVE, pts)
    flat = lambda t: [x for v in t for x in (v if isinstance(v, tuple) else (v,))]
    assert all(torch.equal(g, w) for g, w in zip(flat(got), flat(want), strict=True))
