"""The argument in the PyTorch port.  The carry stage: against the JAX
package on the same numpy points and digits (n = 8, base 5, all 56 rounds),
against the exact Python-int oracle and the host recurrence (n = 128, the
fast flavor), and the slotted round lists.  The witness entry points
(n = 8, base 5, all 56 rounds): every streamed round against the host-int
divisor oracle on the round's slots built by the host recurrence, and the
batched compute_lhs_witness against the streamed rounds, reversed.

All on the CPU, on the plain versions.  Integer arithmetic: points are
compared as affine integers, tolerance zero."""

import math
import random

import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu_torch import argument as A
from halo2_liam_eagen_msm_tpu_torch.convert import (
    JPoint, digits_to_rounds, jpoint_from_numpy, jpoint_to_numpy)
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_limbs, limbs_to_int
from halo2_liam_eagen_msm_tpu_torch.negbase import negbase_decompose_batch
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.ops.poly import Poly
from halo2_liam_eagen_msm_tpu_torch.utils import pyref

torch.set_num_threads(1)

CURVE = PALLAS
BASE = 5


def _case(rng, n, distinct=None):
    """Seeded points (tiled from `distinct`), scalars below sqrt(q) with a
    zero among them, and their (d, N) msb-first digit rounds (numpy)."""
    distinct = distinct or n
    pts = (pyref.random_points(rng, CURVE, distinct) * (n // distinct))[:n]
    scalars = [A.gen_random_coeff(rng, CURVE.scalar_field) for _ in range(n)]
    scalars[0] = 0
    d = A.num_digits_for(CURVE, BASE)
    digits = negbase_decompose_batch(ints_to_limbs(scalars), BASE, d)
    return pts, scalars, digits


def _check_recurrence(p_prev, p_new, rounds, pts):
    """carry' = -base * carry + S_k on the host, S_k from the oracle."""
    q = CURVE.scalar_field.p
    carry = None
    for k, row in enumerate(rounds.tolist()):
        assert p_prev[k] == carry, f"carry_prev mismatch at round {k}"
        s_k = pyref.ec_msm(row, pts, CURVE)
        carry = pyref.ec_msm([(-BASE) % q, 1], [carry, s_k], CURVE)
        assert p_new[k] == carry, f"carry_new mismatch at round {k}"
    return carry


def test_helpers(rng):
    assert A.logb_ceil(0, 5) == 0
    assert A.logb_ceil(1, 5) == 1
    assert A.logb_ceil(24, 5) == 2
    assert A.logb_ceil(25, 5) == 3
    assert A.order(CURVE.scalar_field) == CURVE.scalar_field.p
    assert A.num_digits_for(CURVE, 5) == 56
    twin = random.Random(0xEA6E4)
    s = A.gen_random_coeff(rng, CURVE.scalar_field)
    assert s == twin.randrange(math.isqrt(CURVE.scalar_field.p))
    x = (1 << 64) - 3
    felt = A.felt_from_u64(CURVE.field, x, "cpu")
    assert felt.dtype == torch.int32 and tuple(felt.shape) == (16,)
    assert limbs_to_int(felt.numpy()) == x
    with pytest.raises(ValueError):
        A.felt_from_u64(CURVE.field, 1 << 64, "cpu")


@pytest.mark.medium
def test_carries_vs_jax_package_all_rounds(rng):
    """The slice as a whole: the same numpy points and digits through the JAX
    package's round_sums and _carry_scan and through the port's
    _carries_only, at n = 8, base 5, all 56 rounds; carry_prev, carry_new and
    the final carry equal as affine integers, and the carries cross between
    the packages as (d, 16) numpy arrays."""
    import jax.numpy as jnp

    from halo2_liam_eagen_msm_tpu import argument as jax_argument
    from halo2_liam_eagen_msm_tpu import fields as JF
    from halo2_liam_eagen_msm_tpu.ops import ec as jax_ec_mod
    from halo2_liam_eagen_msm_tpu.ops import msm as jax_msm

    pts, scalars, digits = _case(rng, 8)
    E = ec(CURVE)
    x, y, z = jpoint_to_numpy(E.points_from_ints(pts, "cpu"))
    rounds = digits_to_rounds(digits, "cpu")

    prev, new, final = A._carries_only(CURVE, BASE, rounds, jpoint_from_numpy(x, y, z, "cpu"))
    got = E.points_to_ints(JPoint(*(c[None] for c in final)))[0]
    assert got == pyref.ec_msm(scalars, pts, CURVE)

    jpts = jax_ec_mod.JPoint(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    s = jax_msm.round_sums(JF.PALLAS, BASE, jnp.asarray(rounds.numpy()), jpts)
    jprev, jnew, jfinal = jax_argument._carry_scan(JF.PALLAS, BASE, s.x, s.y, s.z)
    # the JAX package's (d,) carries, as numpy, into the port's JPoint
    for mine, theirs in ((prev, jprev), (new, jnew)):
        theirs = jpoint_from_numpy(*(np.asarray(c) for c in theirs), "cpu")
        assert E.points_to_ints(mine) == E.points_to_ints(theirs)
    jfin = jpoint_from_numpy(*(np.asarray(c)[None] for c in jfinal), "cpu")
    assert E.points_to_ints(jfin)[0] == got


def test_carries_only_fast_flavor_oracle(rng):
    """n = 128 puts every round on the blinded fast flavor, all 56 rounds
    with the all-zero spare top round: the final carry equals the MSM oracle
    and every round's carry satisfies the host recurrence."""
    pts, scalars, digits = _case(rng, 128, distinct=16)
    E = ec(CURVE)
    rounds = digits_to_rounds(digits, "cpu")
    prev, new, final = A._carries_only(CURVE, BASE, rounds, E.points_from_ints(pts, "cpu"))
    got = E.points_to_ints(JPoint(*(c[None] for c in final)))[0]
    assert got == pyref.ec_msm(scalars, pts, CURVE)
    assert _check_recurrence(E.points_to_ints(prev), E.points_to_ints(new),
                             rounds, pts) == got


def test_precompute_multiplicities(rng):
    E = ec(CURVE)
    pts = pyref.random_points(rng, CURVE, 5)
    pts[2] = None
    batch = E.points_from_ints(pts, "cpu")
    pre = A.precompute_multiplicities(E, batch, BASE)
    assert tuple(pre.x.shape) == (BASE - 1, 5, 16)
    for m in range(BASE - 1):
        assert E.points_to_ints(A._at(pre, m)) == [pyref.ec_mul(p, m + 1, CURVE) for p in pts]
    assert tuple(A.precompute_multiplicities(E, batch, 2).x.shape) == (1, 5, 16)


def test_rounds_and_carries_slots_and_one_round(rng):
    """_rounds_and_carries (gather and batched sums) gives the carries of
    _carries_only (one window a round); its slot tensor is [base x
    (-carry_prev)] + digit slots + [-carry_new]; _one_round_slots equals its
    row k."""
    n = 8
    pts, scalars, digits = _case(rng, n)
    E = ec(CURVE)
    rounds = digits_to_rounds(digits, "cpu")
    batch = E.points_from_ints(pts, "cpu")
    d = rounds.shape[0]

    round_pts, final = A._rounds_and_carries(CURVE, BASE, rounds, batch)
    assert tuple(round_pts.x.shape) == (d, BASE + n + 1, 16)
    prev, new, final2 = A._carries_only(CURVE, BASE, rounds, batch)
    got = E.points_to_ints(JPoint(*(c[None] for c in final)))[0]
    assert got == E.points_to_ints(JPoint(*(c[None] for c in final2)))[0]
    assert got == pyref.ec_msm(scalars, pts, CURVE)

    p_prev, p_new = E.points_to_ints(prev), E.points_to_ints(new)
    slots = [E.points_to_ints(A._at(round_pts, k)) for k in range(d)]
    for k, row in enumerate(rounds.tolist()):
        want = [pyref.ec_neg(p_prev[k], CURVE)] * BASE \
            + [pyref.ec_mul(p, dig, CURVE) for p, dig in zip(pts, row)] \
            + [pyref.ec_neg(p_new[k], CURVE)]
        assert slots[k] == want, f"round {k}"
        # every round's points sum to zero by construction
        acc = None
        for p in slots[k]:
            acc = pyref.ec_add(acc, p, CURVE)
        assert acc is None

    precomp = A.precompute_multiplicities(E, batch, BASE)
    for k in (0, 1, d // 2, d - 1):
        one = A._one_round_slots(CURVE, BASE, rounds[k], precomp,
                                 A._at(prev, k), A._at(new, k))
        assert tuple(one.x.shape) == (BASE + n + 1, 16)
        assert E.points_to_ints(one) == slots[k]


@pytest.fixture(scope="module")
def streamed():
    """The port's compute_lhs_witness_streamed at n = 8, base 5 (the shapes
    of test_argument.py::test_streamed_matches_batched), run once: the host
    points and scalars, the rounds handed to the callback and the carry."""
    rng = random.Random(0x57AE)
    pts = pyref.random_points(rng, CURVE, 8)
    pts[3] = None
    scalars = [A.gen_random_coeff(rng, CURVE.scalar_field) for _ in range(8)]
    scalars[0] = 0
    rounds = {}

    def on_round(k, wtns_k, out_k):
        rounds[k] = (wtns_k, out_k)

    E = ec(CURVE)
    final = A.compute_lhs_witness_streamed(CURVE, scalars, E.points_from_ints(pts, "cpu"),
                                           BASE, on_round)
    return pts, scalars, rounds, final


def test_streamed_witness_rounds_equal_host_oracle(streamed):
    """Every round, msb-first, equals ref_divisor.divisor_witness_host (the
    JAX package's host oracle) on the round's slots [base x (-carry_prev)] +
    digit multiples + [-carry_new] from the host recurrence, coefficient for
    coefficient, and closes to the identity; the final carry is the MSM."""
    from halo2_liam_eagen_msm_tpu.utils import ref_divisor

    pts, scalars, rounds, final = streamed
    E = ec(CURVE)
    q = CURVE.scalar_field.p
    d = A.num_digits_for(CURVE, BASE)
    digits = digits_to_rounds(negbase_decompose_batch(ints_to_limbs(scalars), BASE, d), "cpu")
    assert sorted(rounds) == list(range(d))
    carry = None
    for k, row in enumerate(digits.tolist()):
        s_k = pyref.ec_msm(row, [p for p in pts], CURVE)
        new = pyref.ec_msm([(-BASE) % q, 1], [carry, s_k], CURVE)
        slots = [pyref.ec_neg(carry, CURVE)] * BASE \
            + [pyref.ec_mul(p, dig, CURVE) for p, dig in zip(pts, row)] + [pyref.ec_neg(new, CURVE)]
        carry = new
        wtns, out = rounds[k]
        hrf, hout = ref_divisor.divisor_witness_host(CURVE, slots)
        assert hout is None and bool(E.is_identity(JPoint(*(c[None] for c in out)))[0])
        for mine, theirs in ((wtns.a, hrf.a), (wtns.b, hrf.b)):
            got = Poly.from_device(CURVE.field, mine).coeffs
            want = theirs.coeffs + [0] * (len(got) - len(theirs.coeffs))
            assert got == want[:len(got)] and not any(want[len(got):]), f"round {k}"
    assert E.points_to_ints(JPoint(*(c[None] for c in final)))[0] == carry
    assert carry == pyref.ec_msm(scalars, pts, CURVE)


def test_lhs_witness_is_streamed_rounds_reversed(streamed):
    """compute_lhs_witness (all rounds through one batched merge tree) gives
    the streamed rounds in reverse order (LSB round first, as the
    reference returns them), limb for limb, and the same carry."""
    pts, scalars, rounds, final = streamed
    E = ec(CURVE)
    carry, wtns, round_pts = A.compute_lhs_witness(CURVE, scalars,
                                                   E.points_from_ints(pts, "cpu"), BASE)
    d = len(rounds)
    assert tuple(wtns.a.shape[:1]) == (d,) and tuple(round_pts.x.shape[:2]) == (d, BASE + 9)
    for k in range(d):
        assert torch.equal(wtns.a[d - 1 - k], rounds[k][0].a), f"round {k}"
        assert torch.equal(wtns.b[d - 1 - k], rounds[k][0].b), f"round {k}"
    assert E.points_to_ints(JPoint(*(c[None] for c in carry))) == \
        E.points_to_ints(JPoint(*(c[None] for c in final)))
    with pytest.raises(ValueError):
        A.compute_lhs_witness(CURVE, scalars[:-1], E.points_from_ints(pts, "cpu"), BASE)
