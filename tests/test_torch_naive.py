"""The naive line arrangement of the port (divisor.py: the host replica and
the device version) against the JAX package's host replica (pure Python, no
XLA compile) and a Python walk of the reference's pop loop; and the ratio
identity that ties it to the merge tree: both have the divisor
sum [P_i] - n[O], so the merge tree's f equals c * (prod pos / prod neg).

Exact: line triples compare as Python ints, field values limb for limb."""

import random

import pytest
import torch

from halo2_liam_eagen_msm_tpu import divisor as JD
from halo2_liam_eagen_msm_tpu import fields as JF
from halo2_liam_eagen_msm_tpu_torch import divisor as D
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.utils import pyref

torch.set_num_threads(1)

CURVE = PALLAS


def _closing(rng, n):
    """n points summing to the identity (n - 1 random and their negated
    sum), then identities and P, -P pairs planted from n = 7 up."""
    base = pyref.random_points(rng, CURVE, n - 1)
    pts = base + [pyref.ec_neg(pyref.ec_msm([1] * len(base), base, CURVE), CURVE)
                  if base else None]
    if n >= 7:
        extra = pyref.random_points(rng, CURVE, 2)
        pts.insert(2, None)
        pts.insert(n // 2, None)
        pts += [extra[0], pyref.ec_neg(extra[0], CURVE)]  # adjacent P, -P
        pts.insert(1, pyref.ec_neg(extra[1], CURVE))
        pts.insert(4, extra[1])
    return pts


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33])
def test_naive_host_and_device_vs_jax_host(n, rng):
    pts = _closing(rng, n)
    arr = D.compute_divisor_witness_naive_host(CURVE, pts)
    want = JD.compute_divisor_witness_naive_host(JF.PALLAS, pts)
    assert (arr.pos, arr.neg) == (want.pos, want.neg)
    pos, neg = D.compute_divisor_witness_naive_device(
        CURVE, ec(CURVE).points_from_ints(pts, "cpu"))
    assert D.naive_device_lines_to_ints(CURVE, pos) == want.pos
    assert D.naive_device_lines_to_ints(CURVE, neg) == want.neg
    assert all(cnt == lx.shape[0] for lx, _, _, cnt in pos + neg)


def _walk(is_id):
    """The reference's loop over one stack (bottom first), element by
    element: (inc1, partner, kept) index sets."""
    stack = list(range(len(is_id)))
    inc1, partner = set(), set()
    while len(stack) > 1:
        top = stack.pop()
        if not is_id[top]:
            inc1.add(top)
            partner.add(stack.pop())
    return inc1, partner, set(stack)


def test_pop_roles_vs_python_walk():
    r = random.Random(0x909)
    cases = [[], [False], [True], [True, True], [False, True], [True, False],
             [False, False, False]]
    cases += [[r.random() < q for _ in range(r.randrange(2, 40))]
              for q in (0.1, 0.5, 0.9) for _ in range(20)]
    for is_id in cases:
        got = D._pop_roles(torch.tensor(is_id, dtype=torch.bool))
        want = _walk(is_id)
        assert [set(m.nonzero().flatten().tolist()) for m in got] == list(want), is_id


@pytest.mark.parametrize("n", [16, 64])
def test_ratio_identity_with_merge_tree(n, rng):
    """f(R1) P(R2) N(R1) == f(R2) P(R1) N(R2) at two random points R1, R2, with
    f the merge tree's witness and P, N the products of the pos and neg line
    values; every factor non-zero."""
    E = ec(CURVE)
    k = E.f
    pts = _closing(rng, n)
    dev_pts = E.points_from_ints(pts, "cpu")
    wtns, out = D.compute_divisor_witness_partial(CURVE, dev_pts)
    assert bool(E.is_identity(out))
    pos, neg = D.compute_divisor_witness_naive_device(CURVE, dev_pts)
    x, y, _ = E.to_affine(E.points_from_ints(pyref.random_points(rng, CURVE, 2), "cpu"))
    f = D.rf_eval(CURVE, wtns, x, y)
    P = D.lines_product(CURVE, pos, x, y)
    N = D.lines_product(CURVE, neg, x, y)
    assert not bool((k.is_zero(f) | k.is_zero(P) | k.is_zero(N)).any())
    lhs = k.mul(k.mul(f[0], P[1]), N[0])
    rhs = k.mul(k.mul(f[1], P[0]), N[1])
    assert torch.equal(lhs, rhs)
    # and the check has teeth: another point list's witness fails it
    other, _ = D.compute_divisor_witness_partial(
        CURVE, E.points_from_ints(_closing(random.Random(n), n), "cpu"))
    g = D.rf_eval(CURVE, other, x, y)
    assert not torch.equal(k.mul(k.mul(g[0], P[1]), N[0]), k.mul(k.mul(g[1], P[0]), N[1]))


def test_naive_host_raises_when_points_do_not_close(rng):
    pts = pyref.random_points(rng, CURVE, 5)
    with pytest.raises(AssertionError, match="do not sum to the identity"):
        D.compute_divisor_witness_naive_host(CURVE, pts)
    with pytest.raises(AssertionError):
        JD.compute_divisor_witness_naive_host(JF.PALLAS, pts)
