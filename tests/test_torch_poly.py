"""The polynomial layer of the PyTorch port (and the field layer's lazy sums
under it): every function against the exact Python-int Poly of both packages,
kate division (by one root and by two in one walk) on both sides of its n <=
64 switch and at b = 0, products on
both sides of the naive/NTT threshold, and one jitted JAX call at
test_poly.py's shapes.

All on the CPU.  Integer arithmetic: tolerance zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu import fields as JF
from halo2_liam_eagen_msm_tpu.ops import poly as jax_poly
from halo2_liam_eagen_msm_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS_FP
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_mont_limbs, mont_limbs_to_ints
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_poly as CP
from halo2_liam_eagen_msm_tpu_torch.ops import poly as P
from halo2_liam_eagen_msm_tpu_torch.ops.ff import ff
from halo2_liam_eagen_msm_tpu_torch.ops.poly import Poly

torch.set_num_threads(1)

SPEC = PALLAS_FP


def rand_poly(rng, n):
    return Poly(SPEC, [rng.randrange(SPEC.p) for _ in range(n)])


def dev(p: Poly, pad=None):
    return p.to_device(pad, device="cpu")


def back(arr, length=None):
    return Poly.from_device(SPEC, arr, length)


def elem(x: int):
    return limbs_from_numpy(ints_to_mont_limbs([x], SPEC)[0], "cpu")


def test_host_poly_equals_jax_poly(rng):
    """The port's own Poly copy: the reference's poly_test identities and
    every operation equal to the JAX package's Poly, Karatsuba included."""
    p, q = rand_poly(rng, 100), rand_poly(rng, 57)
    jp, jq = jax_poly.Poly(JF.PALLAS_FP, p.coeffs), jax_poly.Poly(JF.PALLAS_FP, q.coeffs)
    t = rng.randrange(SPEC.p)
    assert (p + q).coeffs == (jp + jq).coeffs
    assert (p * q).coeffs == (jp * jq).coeffs
    kp = p.mul_karatsuba(q)
    assert kp.coeffs == jp.mul_karatsuba(jq).coeffs   # lengths included
    assert kp.ev(t) == p.ev(t) * q.ev(t) % SPEC.p
    assert p.kate_div(t).coeffs == jp.kate_div(t).coeffs
    assert p.scale(t).coeffs == jp.scale(t).coeffs
    assert (p >> 3).coeffs == (jp >> 3).coeffs
    assert p.ev(t) == jp.ev(t)
    assert (p * q).ev(t) == p.ev(t) * q.ev(t) % SPEC.p
    p2 = p + Poly(SPEC, [-p.ev(t)])
    t2 = rng.randrange(SPEC.p)
    assert p2.ev(t2) == p.kate_div(t).ev(t2) * (t2 - t) % SPEC.p
    assert len(Poly(SPEC, [0] * 5).kate_div(t)) == 4


def test_field_lazy_sums(rng):
    """ff.mul_small, reduce_columns, sum, dot and pow_fixed against ints."""
    k = ff(SPEC)
    xs = [rng.randrange(SPEC.p) for _ in range(9000)]
    xs[:2] = [SPEC.p - 1, SPEC.p - 1]
    a = limbs_from_numpy(ints_to_mont_limbs(xs, SPEC), "cpu")
    ints = lambda t: mont_limbs_to_ints(limbs_to_numpy(t), SPEC)
    assert ints(k.sum(a, axis=0)) == [sum(xs) % SPEC.p]        # three chunks of 4096
    ys = xs[::-1]
    b = limbs_from_numpy(ints_to_mont_limbs(ys, SPEC), "cpu")
    assert ints(k.dot(a[:300], b[:300], axis=0)) == [
        sum(x * y for x, y in zip(xs[:300], ys[:300])) % SPEC.p]
    assert ints(k.mul_small(a[:5], 13)) == [x * 13 % SPEC.p for x in xs[:5]]
    assert ints(k.mul_small(a[:5], 0)) == [0] * 5
    assert ints(k.pow_fixed(a[:5], 65537)) == [pow(x, 65537, SPEC.p) for x in xs[:5]]
    assert ints(k.pow_fixed(a[:5], 0)) == [1] * 5
    # 17 lazy columns: 2^40 in column 3 and a top limb, total below 2^271
    cols = torch.zeros(2, 17, dtype=torch.int64)
    cols[0, 3] = 1 << 40
    cols[1, 16] = 0xFFFF
    cols[1, 0] = 12345
    want = [(v * pow(1 << 256, SPEC.p - 2, SPEC.p)) % SPEC.p
            for v in ((1 << 40) << 48, (0xFFFF << 256) + 12345)]
    assert ints(k.reduce_columns(cols)) == want


def test_inv_routes_agree(rng):
    """FF.inv on the CPU (exact host powers) equals the Fermat power a^(p-2)
    on the field's own products, zero included."""
    k = ff(SPEC)
    xs = [rng.randrange(SPEC.p) for _ in range(6)] + [0, 1]
    a = limbs_from_numpy(ints_to_mont_limbs(xs, SPEC), "cpu")
    assert torch.equal(k.inv(a), k.pow_fixed(a, SPEC.p - 2))


def test_eval_and_powers(rng):
    p = rand_poly(rng, 200)
    xs = [rng.randrange(SPEC.p) for _ in range(4)] + [0]
    x = limbs_from_numpy(ints_to_mont_limbs(xs, SPEC), "cpu")
    got = mont_limbs_to_ints(limbs_to_numpy(P.eval_poly(SPEC, dev(p)[None], x)), SPEC)
    assert got == [p.ev(v) for v in xs]
    pw = mont_limbs_to_ints(limbs_to_numpy(P.powers(SPEC, x[:1], 7)), SPEC)
    assert pw == [pow(xs[0], j, SPEC.p) for j in range(7)]


@pytest.mark.parametrize("n", [5, 64, 65, 77])
def test_kate_div(rng, n):
    """Both forms (sequential to n = 64, suffix sums above), b random and
    b = 0 (the shift), batched over two polynomials."""
    ps = [rand_poly(rng, n) for _ in range(2)]
    bs = [rng.randrange(SPEC.p), 0]
    coeffs = torch.stack([dev(p) for p in ps])
    b = torch.stack([elem(v) for v in bs])
    got = P.kate_div(SPEC, coeffs, b)
    assert tuple(got.shape) == (2, n, 16)
    for i in range(2):
        assert back(got[i], n - 1).coeffs == ps[i].kate_div(bs[i]).coeffs
        assert back(got[i]).coeffs[n - 1] == 0
    assert back(got[1], n - 1).coeffs == ps[1].coeffs[1:]


@pytest.mark.parametrize("la, lb", [(1, 1), (3, 8), (31, 31), (7, 100), (32, 32), (40, 40),
                                    (33, 120)])
def test_mul_naive_fft_auto(rng, la, lb):
    p, q = rand_poly(rng, la), rand_poly(rng, lb)
    want = (p * q).coeffs
    assert back(P.mul_naive(SPEC, dev(p), dev(q)), la + lb - 1).coeffs == want
    assert back(P.mul_fft(SPEC, dev(p), dev(q)), la + lb - 1).coeffs == want
    assert back(P.mul_auto(SPEC, dev(p), dev(q)), la + lb - 1).coeffs == want


@pytest.mark.parametrize("la, lb", [(1, 1), (3, 8), (17, 33), (31, 31), (7, 100)])
def test_poly_mul_naive_plain(rng, la, lb):
    """The plain version of poly_mul_naive equals P.mul_naive and the host
    Poly, batched over three pairs, both orders of the operands, and with the
    second operand shared by all pairs (a broadcast view, as rf_mul passes
    the substitution polynomial)."""
    ps = [rand_poly(rng, la) for _ in range(3)]
    qs = [rand_poly(rng, lb) for _ in range(3)]
    ps[1] = Poly(SPEC, [0] * la)
    a, b = torch.stack([dev(x) for x in ps]), torch.stack([dev(x) for x in qs])
    for x, y, want in ((a, b, [p * q for p, q in zip(ps, qs)]),
                       (b, a, [q * p for p, q in zip(ps, qs)]),
                       (a, b[:1].expand(3, lb, 16), [p * qs[0] for p in ps])):
        got = CP.poly_mul_naive_plain(SPEC, x, y)
        assert torch.equal(got, P.mul_naive(SPEC, x, y))
        assert [back(g).coeffs for g in got] == [w.coeffs for w in want]


@pytest.mark.parametrize("n", [2, 5, 33, 64])
def test_kate_div_plain(rng, n):
    """The plain version of kate_div equals P.kate_div and the host Poly, over
    four pairs: b random, b = 0 (the shift), a zero polynomial; and with one
    b for all pairs."""
    ps = [rand_poly(rng, n) for _ in range(4)]
    ps[3] = Poly(SPEC, [0] * n)
    bs = [rng.randrange(SPEC.p), 0, rng.randrange(SPEC.p), 7]
    coeffs, b = torch.stack([dev(p) for p in ps]), torch.stack([elem(v) for v in bs])
    for bb, vals in ((b, bs), (b[2], [bs[2]] * 4)):
        got = CP.kate_div_plain(SPEC, coeffs, bb)
        assert torch.equal(got, P.kate_div(SPEC, coeffs, bb))
        assert [back(g).coeffs for g in got] == [p.kate_div(v).coeffs + [0]
                                                for p, v in zip(ps, vals)]


@pytest.mark.parametrize("n", [2, 5, 35, 64, 77])
def test_kate_div2_plain(rng, n):
    """Both divisions of a coefficient level in one walk: the plain version of
    kate_div2 equals kate_div_plain twice and the host Poly.kate_div twice,
    over six pairs (ra = 0, rb = 0, ra = rb, a zero polynomial, raw p - 1
    everywhere), and with one pair of roots for all pairs; P.kate_div2 equals
    it to n = 64 and composes P.kate_div twice above (n = 77)."""
    p = SPEC.p
    ps = [rand_poly(rng, n) for _ in range(6)]
    ps[3] = Poly(SPEC, [0] * n)
    ps[5] = Poly(SPEC, [p - 1] * n)
    ras = [rng.randrange(p), 0, rng.randrange(p), 7, 5, p - 1]
    rbs = [rng.randrange(p), rng.randrange(p), 0, 11, 5, p - 1]
    coeffs = torch.stack([dev(x) for x in ps])
    ra, rb = torch.stack([elem(v) for v in ras]), torch.stack([elem(v) for v in rbs])
    for a, b, va, vb in ((ra, rb, ras, rbs), (ra[0], rb[0], [ras[0]] * 6, [rbs[0]] * 6)):
        want = [x.kate_div(u).kate_div(v).coeffs + [0] * 2 for x, u, v in zip(ps, va, vb)]
        got = P.kate_div2(SPEC, coeffs, a, b)
        assert [back(g).coeffs for g in got] == want
        if n <= 64:
            plain = CP.kate_div2_plain(SPEC, coeffs, a, b)
            assert torch.equal(plain, got)
            assert torch.equal(plain, CP.kate_div_plain(SPEC, CP.kate_div_plain(SPEC, coeffs, a), b))


def test_add_scale_shr_batched(rng):
    p, q = rand_poly(rng, 10), rand_poly(rng, 25)
    sc = rng.randrange(SPEC.p)
    assert back(P.add_padded(SPEC, dev(p), dev(q)), 25).coeffs == (p + q).coeffs
    assert back(P.scale(SPEC, dev(p), elem(sc)), 10).coeffs == p.scale(sc).coeffs
    assert back(P.shr(SPEC, dev(p), 4), 14).coeffs == (p >> 4).coeffs
    ps = [rand_poly(rng, 9) for _ in range(6)]
    qs = [rand_poly(rng, 12) for _ in range(6)]
    got = P.mul_naive(SPEC, torch.stack([dev(x) for x in ps]), torch.stack([dev(x) for x in qs]))
    for i in range(6):
        assert back(got[i], 20).coeffs == (ps[i] * qs[i]).coeffs


def test_device_functions_equal_jax(rng):
    """One jitted JAX call at test_poly.py's shapes (kate division at 77,
    b random and b = 0; a batched 6 x (9, 12) naive product; an evaluation
    of a 200-term polynomial at 4 points) and kate division at 33 (the JAX
    package's lax.scan route, b random and b = 0), then the same compiled
    call once more on its quotients at 33 by the roots the other way round (a
    coefficient level's two divisions): the same limbs as the port, the two
    divisions as P.kate_div2 and its plain version."""
    p77, p200 = rand_poly(rng, 77), rand_poly(rng, 200)
    ps = np.stack([ints_to_mont_limbs(rand_poly(rng, 9).coeffs, SPEC) for _ in range(6)])
    qs = np.stack([ints_to_mont_limbs(rand_poly(rng, 12).coeffs, SPEC) for _ in range(6)])
    b = ints_to_mont_limbs([rng.randrange(SPEC.p), 0], SPEC)
    x4 = ints_to_mont_limbs([rng.randrange(SPEC.p) for _ in range(4)], SPEC)
    c77 = ints_to_mont_limbs(p77.coeffs, SPEC)
    c200 = ints_to_mont_limbs(p200.coeffs, SPEC)
    c33 = np.stack([ints_to_mont_limbs(rand_poly(rng, 33).coeffs, SPEC) for _ in range(2)])

    def jax_all(c77, b, ps, qs, c200, x4, c33):
        return (jax_poly.kate_div(JF.PALLAS_FP, c77[None], b),
                jax_poly.mul_naive(JF.PALLAS_FP, ps, qs),
                jax_poly.eval_poly(JF.PALLAS_FP, c200[None], x4),
                jax_poly.kate_div(JF.PALLAS_FP, c33, b))

    jitted = jax.jit(jax_all)
    want = jitted(*(jnp.asarray(v) for v in (c77, b, ps, qs, c200, x4, c33)))
    # the second division: the same compiled call on the first's quotients
    # and the roots the other way round
    want = (*want, jitted(*(jnp.asarray(v) for v in (c77, b[::-1].copy(), ps, qs, c200, x4)),
                          want[3])[3])
    t = lambda v: limbs_from_numpy(v, "cpu")
    got = (P.kate_div(SPEC, t(c77)[None], t(b)), P.mul_naive(SPEC, t(ps), t(qs)),
           P.eval_poly(SPEC, t(c200)[None], t(x4)), P.kate_div(SPEC, t(c33), t(b)),
           P.kate_div2(SPEC, t(c33), t(b), t(b[::-1].copy())))
    for g, w in zip(got, want):
        assert np.array_equal(limbs_to_numpy(g), np.asarray(w))
    assert torch.equal(got[-1], CP.kate_div2_plain(SPEC, t(c33), t(b), t(b[::-1].copy())))
