"""Curve layer of the PyTorch port against the JAX package (jnp path, the
reference the JAX package's own CPU tests use: its curve kernels are too
large for interpret mode) and against the exact Python-int oracle.

Formulas that follow the same steps give the same Jacobian representative,
so the comparison is limb for limb, flags included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu import fields as JF
from halo2_liam_eagen_msm_tpu.ops.ec import JPoint as JaxPoint
from halo2_liam_eagen_msm_tpu.ops.ec import ec as jax_ec
from halo2_liam_eagen_msm_tpu_torch.convert import (
    JPoint, jpoint_from_numpy, jpoint_to_numpy, limbs_from_numpy, limbs_to_numpy)
from halo2_liam_eagen_msm_tpu_torch.fields import GRUMPKIN, PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_mont_limbs, mont_limbs_to_ints
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops import msm as M
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.utils import pyref

torch.set_num_threads(1)

CURVES = [PALLAS, GRUMPKIN]


def _edge_pairs(rng, curve, n=16):
    """Two host point lists with the edge lanes: identity operands, both
    identity, P + P, P + (-P)."""
    p1 = pyref.random_points(rng, curve, n)
    p2 = pyref.random_points(rng, curve, n)
    p1[0] = None
    p2[1] = None
    p1[2] = None
    p2[2] = None
    p2[3] = p1[3]
    p2[4] = pyref.ec_neg(p1[4], curve)
    return p1, p2


def _jacobian_numpy(rng, curve, pts):
    """Host points -> numpy (x, y, z) Montgomery limbs with a random
    Jacobian representative per lane (identity: z = 0)."""
    p = curve.field.p
    xs, ys, zs = [], [], []
    for pt in pts:
        lam = rng.randrange(1, p)
        if pt is None:
            xs.append(lam); ys.append(lam); zs.append(0)
        else:
            xs.append(pt[0] * lam * lam % p)
            ys.append(pt[1] * lam ** 3 % p)
            zs.append(lam)
    return tuple(ints_to_mont_limbs(v, curve.field) for v in (xs, ys, zs))


def _both(arrs):
    return ([limbs_from_numpy(a, "cpu") for a in arrs], [jnp.asarray(a) for a in arrs])


def _same(got, want):
    for g, w in zip(got, want):
        g = limbs_to_numpy(g) if g.dtype == torch.int32 else g.numpy()
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_add_fast_double_vs_jax_and_pyref(curve, rng):
    E, JE = ec(curve), jax_ec(JF.CURVES[curve.name])
    p1, p2 = _edge_pairs(rng, curve)
    (ta, ja) = _both(_jacobian_numpy(rng, curve, p1))
    (tb, jb) = _both(_jacobian_numpy(rng, curve, p2))
    want = [pyref.ec_add(a, b, curve) for a, b in zip(p1, p2)]

    got = CF.ec_add_plain(curve, *ta, *tb)
    _same(got, JE.add(JaxPoint(*ja), JaxPoint(*jb)))
    assert E.points_to_ints(JPoint(*got)) == want
    assert E.points_to_ints(E.add(JPoint(*ta), JPoint(*tb))) == want

    *gf, exc = CF.ec_add_fast_plain(curve, *ta, *tb)
    jf, jexc = JE.add_fast(JaxPoint(*ja), JaxPoint(*jb))
    _same(gf + [exc], list(jf) + [jexc])
    assert exc.tolist() == [i == 3 for i in range(len(p1))]  # only P + P flags
    fast = E.points_to_ints(JPoint(*gf))
    assert [f for i, f in enumerate(fast) if i != 3] == \
        [w for i, w in enumerate(want) if i != 3]

    gd = CF.ec_double_plain(curve, *ta)
    _same(gd, JE.double(JaxPoint(*ja)))
    assert E.points_to_ints(JPoint(*gd)) == [pyref.ec_add(a, a, curve) for a in p1]

    assert E.points_to_ints(E.neg(JPoint(*ta))) == [pyref.ec_neg(a, curve) for a in p1]
    assert E.eq(JPoint(*ta), E.points_from_ints(p1, "cpu")).all()
    assert E.eq(JPoint(*ta), JPoint(*tb)).tolist() == [i in (2, 3) for i in range(len(p1))]


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_mixed_adds_vs_jax_and_pyref(curve, rng):
    E, JE = ec(curve), jax_ec(JF.CURVES[curve.name])
    p1, p2 = _edge_pairs(rng, curve, 12)
    (ta, ja) = _both(_jacobian_numpy(rng, curve, p1))
    q = E.points_from_ints(p2, "cpu")
    qx, qy, qid = E.to_affine(q)
    jq = JE.points_from_ints(p2)
    jqx, jqy, jqid = JE.to_affine(jq)
    _same([qx, qy, qid], [jqx, jqy, jqid])
    want = [pyref.ec_add(a, b, curve) for a, b in zip(p1, p2)]

    got = E.add_mixed(JPoint(*ta), qx, qy, qid)
    _same(got, JE.add_mixed(JaxPoint(*ja), jqx, jqy, jqid))
    assert E.points_to_ints(got) == want

    # XYZZ step: carry in XYZZ form (zz = z^2, zzz = z^3; identity all zero)
    f = E.f
    zz = f.sqr(ta[2])
    zzz = f.mul(zz, ta[2])
    carry = (ta[0], ta[1], zz, zzz)
    jcarry = tuple(jnp.asarray(limbs_to_numpy(c)) for c in carry)
    *g4, exc = E.madd_xyzz_fast(*carry, qx, qy)
    *j4, jexc = JE.madd_xyzz_fast(*jcarry, jqx, jqy)
    _same(g4 + [exc], j4 + [jexc])
    # flagged: identity carry with a real q (lane 0), carry == +-q (lanes 3, 4)
    assert exc.tolist() == [i in (0, 3, 4) for i in range(len(p1))]
    back = E.points_to_ints(E.xyzz_to_jacobian(*g4))
    assert [b for i, b in enumerate(back) if i not in (0, 3, 4)] == \
        [w for i, w in enumerate(want) if i not in (0, 3, 4)]


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_add_mixed_fast_and_projective_coords_vs_jax_and_pyref(curve, rng):
    """B = 37 lanes, the planted ones first: identity carry (flagged), qy == 0
    with an ordinary and with an identity carry (passed through, unflagged),
    carry == Q and carry == -Q in a Jacobian representative with Z != 1
    (flagged); random carries with Z != 1 elsewhere.  Flagged lanes hold the
    generic formula's values, limb for limb those of the JAX package."""
    E, JE = ec(curve), jax_ec(JF.CURVES[curve.name])
    p1, p2 = _edge_pairs(rng, curve, 37)
    (ta, ja) = _both(_jacobian_numpy(rng, curve, p1))
    qx, qy, _ = E.to_affine(E.points_from_ints(p2, "cpu"))
    jqx, jqy = jnp.asarray(limbs_to_numpy(qx)), jnp.asarray(limbs_to_numpy(qy))

    got, exc = E.add_mixed_fast(JPoint(*ta), qx, qy)
    jgot, jexc = JE.add_mixed_fast(JaxPoint(*ja), jqx, jqy)
    _same(list(got) + [exc], list(jgot) + [jexc])
    assert exc.tolist() == [i in (0, 3, 4) for i in range(len(p1))]
    want = [pyref.ec_add(a, b, curve) for a, b in zip(p1, p2)]
    fast = E.points_to_ints(got)
    assert [f for i, f in enumerate(fast) if i not in (0, 3, 4)] == \
        [w for i, w in enumerate(want) if i not in (0, 3, 4)]
    for i in (1, 2):  # qy == 0: the carry itself, limb for limb
        assert all(torch.equal(g[i], t[i]) for g, t in zip(got, ta))

    proj = E.projective_coords(JPoint(*ta))
    _same(proj, JE.projective_coords(JaxPoint(*ja)))
    pp = curve.field.p
    X, Y, Z = (list(mont_limbs_to_ints(limbs_to_numpy(c), curve.field)) for c in ta)
    assert [list(mont_limbs_to_ints(limbs_to_numpy(c), curve.field)) for c in proj] == \
        [[x * z % pp for x, z in zip(X, Z)], Y, [z ** 3 % pp for z in Z]]


@pytest.fixture(scope="module")
def jax_double_n():
    """The JAX package's msm._double_n on the Pallas curve, jitted with k
    traced: one compile for every k."""
    import jax
    from halo2_liam_eagen_msm_tpu.ops import msm as jax_msm

    JE = jax_ec(JF.PALLAS)
    return jax.jit(lambda p, k: jax_msm._double_n(JE, p, k))


@pytest.mark.parametrize("k", [0, 1, 2, 15])
def test_double_n_vs_jax_and_pyref(k, rng, jax_double_n):
    """msm._double_n and EC.double_n (the plain version of the k-doubling
    kernel) against the JAX package's msm._double_n limb for limb, and
    against [2^k]P on Python ints: random points in random Jacobian
    representatives, identities (z = 0, any x and y) among them."""
    curve = PALLAS
    E = ec(curve)
    pts = pyref.random_points(rng, curve, 6)
    pts[0] = pts[3] = None
    t, j = _both(_jacobian_numpy(rng, curve, pts))
    got = M._double_n(E, JPoint(*t), k)
    _same(got, jax_double_n(JaxPoint(*j), k))
    assert all(torch.equal(a, b) for a, b in zip(got, E.double_n(JPoint(*t), k)))
    assert E.points_to_ints(got) == [pyref.ec_mul(p, 1 << k, curve) for p in pts]


@pytest.mark.parametrize("k", [0, 1, 2, 5, 7])
def test_scalar_mul_small_vs_pyref(k, rng):
    curve = PALLAS
    E = ec(curve)
    pts = pyref.random_points(rng, curve, 4)
    pts[1] = None  # an identity lane
    got = E.scalar_mul_small(E.points_from_ints(pts, "cpu"), k)
    assert tuple(got.x.shape) == (4, 16)
    assert E.points_to_ints(got) == [pyref.ec_mul(p, k, curve) for p in pts]
    with pytest.raises(ValueError):
        E.scalar_mul_small(got, -1)


@pytest.mark.parametrize("k", [5, 8, 10, 11])
def test_scalar_mul_small_runs_of_doublings(k, rng, monkeypatch):
    """scalar_mul_small doubles by one double_n a run of doublings between
    two adds (base 5: one run of 2), and equals [k]P on Python ints."""
    curve = PALLAS
    E = ec(curve)
    runs = []
    real = E.double_n

    def double_n(p, n):
        runs.append(n)
        return real(p, n)

    monkeypatch.setattr(E, "double_n", double_n)
    pts = pyref.random_points(rng, curve, 3)
    pts[2] = None
    got = E.scalar_mul_small(E.points_from_ints(pts, "cpu"), k)
    assert runs == {5: [2], 8: [3], 10: [2, 1], 11: [2, 1]}[k]
    assert E.points_to_ints(got) == [pyref.ec_mul(p, k, curve) for p in pts]


def test_constants_conversions_sum(rng):
    curve = PALLAS
    E, JE = ec(curve), jax_ec(JF.PALLAS)
    # the blinding point: the exception flags depend on it
    assert E.offset_point_ints() == JE.offset_point_ints()
    assert E.offset_point_ints(7) == pyref.ec_mul(E.offset_point_ints(), 7, curve)
    _same(E.offset_point((2,), device="cpu"), JE.offset_point((2,)))
    _same(E.identity((3,), "cpu"), JE.identity((3,)))
    _same(E.generator((), "cpu"), JE.generator(()))
    assert E.is_identity(E.identity((3,), "cpu")).all()

    pts = pyref.random_points(rng, curve, 70)
    pts[1] = None
    batch = E.points_from_ints(pts, "cpu")
    _same(batch, JE.points_from_ints(pts))
    assert E.points_to_ints(batch) == pts
    x, y, z = jpoint_to_numpy(batch)
    assert E.points_to_ints(jpoint_from_numpy(x, y, z, "cpu")) == pts
    total = E.sum(batch)
    assert E.points_to_ints(JPoint(*(c[None] for c in total)))[0] == \
        pyref.ec_msm([1] * 70, pts, curve)
