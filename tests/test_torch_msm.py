"""MSM layer of the PyTorch port: the blocked scans, the fused scan's plain
version, best_multiexp and round_sums against the exact Python-int oracle,
and best_multiexp against the JAX package on the same inputs.

All on the CPU, on the plain versions.  Integer arithmetic: every comparison
is exact.  Points are compared as affine integers where the add order may
differ between the two packages."""

import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu_torch.convert import (
    JPoint, jpoint_from_numpy, limbs_from_numpy, limbs_to_numpy)
from halo2_liam_eagen_msm_tpu_torch.fields import GRUMPKIN, N_LIMBS, PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_limbs, ints_to_mont_limbs
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops import msm as M
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.utils import pyref

torch.set_num_threads(1)


def _running_sums(pts, curve, start=None):
    acc = start
    out = []
    for p in pts:
        acc = pyref.ec_add(acc, p, curve)
        out.append(acc)
    return out


def _affine_rows(E, pts):
    """Host points (None = identity) -> packed sorted-order rows."""
    ax, ay, _ = E.to_affine(E.points_from_ints(pts, "cpu"))
    return ax, ay, M._pack_pair(ax, ay)


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 64, 70])
def test_prefix_scan_points(rng, n):
    curve = PALLAS
    E = ec(curve)
    pts = pyref.random_points(rng, curve, n)
    pts[min(1, n - 1)] = None  # identity in the stream
    batch = E.points_from_ints(pts, "cpu")
    want = _running_sums(pts, curve)
    assert E.points_to_ints(M.prefix_scan_points(E, batch)) == want
    rev = M.prefix_scan_points(E, batch, reverse=True)
    assert E.points_to_ints(rev) == _running_sums(pts[::-1], curve)[::-1]


@pytest.mark.parametrize("n", [3, 64, 70])
def test_prefix_scan_points_fast(rng, n):
    """Blinded scan: every prefix carries exactly one T, no flag."""
    curve = PALLAS
    E = ec(curve)
    pts = pyref.random_points(rng, curve, n)
    pts[min(1, n - 1)] = None
    got, exc = M.prefix_scan_points_fast(E, E.points_from_ints(pts, "cpu"))
    assert not bool(exc)
    assert E.points_to_ints(got) == _running_sums(pts, curve, E.offset_point_ints())
    total, exc = M.sum_points_fast(E, E.points_from_ints(pts, "cpu"))
    assert not bool(exc)
    assert E.points_to_ints(JPoint(*(c[None] for c in total)))[0] == \
        pyref.ec_msm([1] * n, pts, curve)


def test_prefix_scan_parts_decompositions(rng):
    """inclusive_prefix[i] == offsets[i // w] + inner[i] at every i, for the
    Jacobian and the affine (mixed-add) scans, with identity slots and a
    repeated point (doubling) in the stream."""
    curve = PALLAS
    E = ec(curve)
    n = 70
    pts = pyref.random_points(rng, curve, n)
    pts[1] = None
    pts[n - 1] = pts[0]
    batch = E.points_from_ints(pts, "cpu")
    want = _running_sums(pts, curve)
    idx = torch.arange(n)
    inner, offsets, w = M.prefix_scan_parts(E, batch)
    full = E.add(M._take(offsets, idx // w), M._take(inner, idx))
    assert E.points_to_ints(full) == want
    ax, ay, aident = E.to_affine(batch)
    inner, offsets, w = M.prefix_scan_parts_affine(E, ax, ay, aident)
    full = E.add(M._take(offsets, idx // w), M._take(inner, idx))
    assert E.points_to_ints(full) == want


def test_safe_scan_plain_vs_stepwise_and_jax(rng):
    """The safe scan's plain version (cuda_ff.ec_add_mixed_scan_plain, which
    prefix_scan_parts_affine runs on the CPU) at n = 70 with an identity slot
    and a repeated point: inner prefixes and lane totals limb for limb equal
    to a stepwise loop of EC.add_mixed over the scan's columns, and to the
    JAX package's prefix_scan_parts_affine (the same w, the same inner
    prefixes; offsets as affine points, their scans' add orders differ)."""
    import jax
    from halo2_liam_eagen_msm_tpu import fields as JF
    from halo2_liam_eagen_msm_tpu.ops import msm as jax_msm
    from halo2_liam_eagen_msm_tpu.ops.ec import ec as jax_ec

    curve = PALLAS
    E = ec(curve)
    n = 70
    pts = pyref.random_points(rng, curve, n)
    pts[1] = None
    pts[n - 1] = pts[0]
    ax, ay, aident = E.to_affine(E.points_from_ints(pts, "cpu"))
    inner, offsets, w = M.prefix_scan_parts_affine(E, ax, ay, aident)

    g = -(-n // w)
    pad = g * w - n
    zeros = torch.zeros((pad, N_LIMBS), dtype=ax.dtype)
    px, py = torch.cat([ax, zeros]), torch.cat([ay, zeros])
    pid = torch.cat([aident, torch.ones(pad, dtype=torch.bool)])
    cols = [c.reshape((g, w) + c.shape[1:]) for c in (px, py, pid)]
    carry, steps = E.identity((g,), "cpu"), []
    for t in range(w):
        carry = E.add_mixed(carry, *(c[:, t] for c in cols))
        steps.append(carry)
    stepwise = [torch.stack([s[k] for s in steps], dim=1).reshape(g * w, N_LIMBS)
                for k in range(3)]
    assert all(torch.equal(a, b) for a, b in zip(inner, stepwise))
    _, totals = CF.ec_add_mixed_scan_plain(curve, *E.identity((g,), "cpu"), px, py, pid, w)
    assert all(torch.equal(a, b) for a, b in zip(totals, carry))

    JE = jax_ec(JF.PALLAS)
    jinner, joffsets, jw = jax.jit(lambda a, b, c: jax_msm.prefix_scan_parts_affine(
        JE, a, b, c))(jax.numpy.asarray(limbs_to_numpy(ax)), jax.numpy.asarray(limbs_to_numpy(ay)),
                      jax.numpy.asarray(aident.numpy()))
    assert int(jw) == w
    assert all(np.array_equal(limbs_to_numpy(a), np.asarray(b)) for a, b in zip(inner, jinner))
    assert E.points_to_ints(offsets) == E.points_to_ints(JPoint(
        *(limbs_from_numpy(np.asarray(c), "cpu") for c in joffsets)))
    idx = torch.arange(n)
    full = E.add(M._take(offsets, idx // w), M._take(inner, idx))
    assert E.points_to_ints(full) == _running_sums(pts, curve)


def test_fast_scan_plain_vs_stepwise_and_jax(rng):
    """The blinded stepwise scan's plain version
    (cuda_ff.ec_madd_xyzz_fast_scan_plain, which
    prefix_scan_parts_affine_fast runs on the CPU) at n = 70 with an
    identity slot and a repeated point: inner prefixes, lane totals and
    flags limb for limb equal to a stepwise loop of EC.madd_xyzz_fast over
    the scan's columns, and to the JAX package's
    prefix_scan_parts_affine_fast (the same w, inner prefixes and flag;
    offsets as affine points)."""
    import jax
    from halo2_liam_eagen_msm_tpu import fields as JF
    from halo2_liam_eagen_msm_tpu.ops import msm as jax_msm
    from halo2_liam_eagen_msm_tpu.ops.ec import ec as jax_ec

    curve = PALLAS
    E = ec(curve)
    n = 70
    pts = pyref.random_points(rng, curve, n)
    pts[1] = None
    pts[n - 1] = pts[0]
    ax, ay, _ = E.to_affine(E.points_from_ints(pts, "cpu"))
    inner, offsets, w, exc = M.prefix_scan_parts_affine_fast(E, ax, ay)
    assert not bool(exc)

    g = -(-n // w)
    zeros = torch.zeros((g * w - n, N_LIMBS), dtype=ax.dtype)
    px, py = torch.cat([ax, zeros]), torch.cat([ay, zeros])
    cols = [c.reshape(g, w, N_LIMBS) for c in (px, py)]
    carry, flags, steps = E.xyzz_offset((g,), "cpu"), torch.zeros(g, dtype=torch.bool), []
    for t in range(w):
        *carry, e = E.madd_xyzz_fast(*carry, cols[0][:, t], cols[1][:, t])
        flags = flags | e
        steps.append(carry)
    stepwise = [torch.stack([s[k] for s in steps], dim=1).reshape(g * w, N_LIMBS)
                for k in range(4)]
    assert all(torch.equal(a, b) for a, b in zip(inner, stepwise))
    _, totals, exc_v = CF.ec_madd_xyzz_fast_scan_plain(curve, *E.xyzz_offset((g,), "cpu"),
                                                       px, py, w)
    assert all(torch.equal(a, b) for a, b in zip(totals, carry))
    assert exc_v.dtype == torch.bool and torch.equal(exc_v, flags)

    JE = jax_ec(JF.PALLAS)
    jinner, joffsets, jw, jexc = jax.jit(lambda a, b: jax_msm.prefix_scan_parts_affine_fast(
        JE, a, b))(jax.numpy.asarray(limbs_to_numpy(ax)), jax.numpy.asarray(limbs_to_numpy(ay)))
    assert int(jw) == w and bool(jexc) == bool(exc)
    assert all(np.array_equal(limbs_to_numpy(a), np.asarray(b)) for a, b in zip(inner, jinner))
    assert E.points_to_ints(offsets) == E.points_to_ints(JPoint(
        *(limbs_from_numpy(np.asarray(c), "cpu") for c in joffsets)))


def test_fused_scan_plain_vs_affine_fast_and_pyref(rng):
    """fused_madd_scan_xyzz_plain (the packed, limb-major contract the CUDA
    kernel follows) against the step-by-step blinded scan and against running
    sums from the oracle; zero rows in the stream; -T at the head of a lane
    flags that lane only."""
    curve = PALLAS
    E = ec(curve)
    w, g = 4, 6
    n = w * g
    pts = pyref.random_points(rng, curve, n)
    pts[2] = pts[7] = None
    ax, ay, rows = _affine_rows(E, pts)
    assert torch.equal(torch.cat(M._unpack_pair(rows), dim=-1), torch.cat([ax, ay], dim=-1))

    inner, offsets, w_out, exc = M.prefix_scan_parts_packed_fast(E, rows, w=w)
    assert w_out == w and not bool(exc)
    assert inner[0].shape == (w, N_LIMBS, g)
    idx = torch.arange(n)
    at = tuple(cc[idx % w, :, idx // w] for cc in inner)
    full = E.add(M._take(offsets, idx // w), E.xyzz_to_jacobian(*at))
    want = _running_sums(pts, curve, E.offset_point_ints())  # one T each
    assert E.points_to_ints(full) == want

    inner2, offsets2, w2, exc2 = M.prefix_scan_parts_affine_fast(E, ax, ay)
    assert not bool(exc2)
    at2 = tuple(M._rows(cc, idx) for cc in inner2)
    full2 = E.add(M._take(offsets2, idx // w2), E.xyzz_to_jacobian(*at2))
    assert E.points_to_ints(full2) == want

    # lane totals of the kernel contract: (g, 16) rows, still blinded
    t_limbs = tuple(tuple(int(v) for v in ints_to_mont_limbs([c], curve.field)[0])
                    for c in E.offset_point_ints())
    _, totals, flags = CF.fused_madd_scan_xyzz_plain(curve, t_limbs, rows, w)
    lane_tot = E.points_to_ints(E.xyzz_to_jacobian(*totals))
    T = E.offset_point_ints()
    assert lane_tot == [_running_sums(pts[l * w:(l + 1) * w], curve, T)[-1] for l in range(g)]
    assert not flags.any()

    pts[3 * w] = pyref.ec_neg(T, curve)
    _, _, rows = _affine_rows(E, pts)
    _, _, flags = CF.fused_madd_scan_xyzz_plain(curve, t_limbs, rows, w)
    assert flags.tolist() == [l == 3 for l in range(g)]


def test_window_digits_and_bounds(nprng):
    sc = nprng.integers(0, 1 << 16, size=(50, 16), dtype=np.uint32)
    vals = [sum(int(v) << (16 * k) for k, v in enumerate(row)) for row in sc]
    t = limbs_from_numpy(sc, "cpu")
    for c in (1, 5, 13, 16):
        nw = -(-256 // c)
        d = M.window_digits(t, c, nw)
        assert d.shape == (nw, 50) and d.dtype == torch.int32
        want = [[(v >> (w * c)) & ((1 << c) - 1) for v in vals] for w in range(nw)]
        assert d.tolist() == want
    d = M.window_digits(t, 5, 3)  # batched histogram: one row per window
    hi = M.bucket_bounds_hist(d, 5)
    for w in range(3):
        row = d[w].tolist()
        assert hi[w].tolist() == [sum(1 for v in row if v <= b) - 1 for b in range(32)]


# ---------------------------------------------------------------------------
# best_multiexp
# ---------------------------------------------------------------------------

def test_pick_window():
    assert M.pick_window(2) == 1
    assert M.pick_window(1 << 16) == 11
    assert M.pick_window(1 << 20) == 15


def _jax_msm_256(scalars, pts):
    """The JAX package's MSM of the same scalars and points (Pallas), at the
    one static signature both JAX-comparing cases share, n = 256, c = 4,
    full-width scalars, so that the JAX graph is traced and compiled once a
    process; shorter inputs are padded with identity points and zero scalars,
    which add nothing to the sum."""
    from halo2_liam_eagen_msm_tpu import fields as JF
    from halo2_liam_eagen_msm_tpu.ops import msm as jax_msm

    pad = 256 - len(pts)
    return jax_msm.msm_ints(JF.PALLAS, list(scalars) + [0] * pad,
                            list(pts) + [None] * pad, c=4)


def _small_case(rng, curve):
    q = curve.scalar_field.p
    n = 16
    pts = pyref.random_points(rng, curve, n)
    scalars = [rng.randrange(q) for _ in range(n)]
    # edges: zero scalar, one scalar, q-1, identity point
    scalars[0] = 0
    scalars[1] = 1
    scalars[2] = q - 1
    pts[3] = None
    return scalars, pts


@pytest.mark.medium
def test_msm_small_vs_jax_and_pyref(rng):
    """The slice as a whole: the same points and scalars through the JAX
    package's MSM and the port's best_multiexp (n = 16, c = 8, full-width
    scalars, Pallas, from numpy limb arrays), equal as affine integers, and
    equal to the oracle.  (The JAX package's own small-n safe path is held
    against the port in test_torch_argument.py.)"""
    curve = PALLAS
    scalars, pts = _small_case(rng, curve)
    spec = curve.field
    xs = ints_to_mont_limbs([p[0] if p else 0 for p in pts], spec)
    ys = ints_to_mont_limbs([p[1] if p else 0 for p in pts], spec)
    zs = ints_to_mont_limbs([1 if p else 0 for p in pts], spec)
    sc = ints_to_limbs(scalars)

    E = ec(curve)
    res = M.best_multiexp(curve, limbs_from_numpy(sc, "cpu"),
                          jpoint_from_numpy(xs, ys, zs, "cpu"), c=8)
    got = E.points_to_ints(JPoint(*(c[None] for c in res)))[0]
    assert got == pyref.ec_msm(scalars, pts, curve)
    assert got == _jax_msm_256(scalars, pts)


@pytest.mark.medium
def test_msm_small_grumpkin(rng):
    scalars, pts = _small_case(rng, GRUMPKIN)
    assert M.msm_ints(GRUMPKIN, scalars, pts, c=8, device="cpu") == \
        pyref.ec_msm(scalars, pts, GRUMPKIN)


def test_msm_single_and_tiny(rng):
    curve = PALLAS
    pts = pyref.random_points(rng, curve, 1)
    s = [rng.randrange(1 << 64)]
    assert M.msm_ints(curve, s, pts, c=4, max_scalar_bits=64, device="cpu") == \
        pyref.ec_msm(s, pts, curve)
    # all-zero scalars -> identity
    assert M.msm_ints(curve, [0, 0], pyref.random_points(rng, curve, 2), c=4,
                      max_scalar_bits=64, device="cpu") is None


def test_msm_fast_flavor_edges(rng):
    """n >= 64 so the blinded fast flavor runs: odd n, duplicate points,
    zero / one / maximal scalars, an identity point; no exception flag."""
    curve = PALLAS
    n = 67
    pts = pyref.random_points(rng, curve, n)
    scalars = [rng.randrange(1 << 16) for _ in range(n)]
    scalars[0], scalars[1], scalars[2] = 0, 1, (1 << 16) - 1
    pts[3] = None
    pts[10] = pts[11] = pts[12]
    E = ec(curve)
    s = M.scalars_to_limbs(scalars, curve, "cpu")
    p = E.points_from_ints(pts, "cpu")
    res, exc = M._best_multiexp(curve, 4, 16, "fast", s, p)
    assert not bool(exc)
    want = pyref.ec_msm(scalars, pts, curve)
    assert E.points_to_ints(JPoint(*(c[None] for c in res)))[0] == want
    assert M.msm_ints(curve, scalars, pts, c=4, max_scalar_bits=16, device="cpu") == want
    # all-zero scalars on the fast flavor: every bucket empty
    assert M.msm_ints(curve, [0] * n, pts, c=4, max_scalar_bits=16, device="cpu") is None


def test_msm_adversarial_input_falls_back(rng):
    """The first sorted point is -T: the blinded scan's first step is
    T + (-T), the fast flavor flags it, and best_multiexp's safe rerun still
    gives the exact sum."""
    curve = PALLAS
    E = ec(curve)
    n = 64
    pts = pyref.random_points(rng, curve, n)
    pts[0] = pyref.ec_neg(E.offset_point_ints(), curve)
    scalars = [1] + [rng.randrange(2, 16) for _ in range(n - 1)]
    s = M.scalars_to_limbs(scalars, curve, "cpu")
    p = E.points_from_ints(pts, "cpu")
    _, exc = M._best_multiexp(curve, 4, 4, "fast", s, p)
    assert bool(exc)
    res = M.best_multiexp(curve, s, p, c=4, max_scalar_bits=4)
    assert E.points_to_ints(JPoint(*(c[None] for c in res)))[0] == \
        pyref.ec_msm(scalars, pts, curve)


@pytest.mark.medium
def test_msm_larger_batch_vs_jax_and_pyref(rng):
    """n = 256, c = 4, 64-bit scalars (the fast flavor), duplicate points:
    port == JAX package == oracle, as affine integers."""
    curve = PALLAS
    n = 256
    pts = pyref.random_points(rng, curve, n)
    scalars = [rng.randrange(1 << 64) for _ in range(n)]
    pts[10] = pts[11] = pts[12]
    got = M.msm_ints(curve, scalars, pts, c=4, max_scalar_bits=64, device="cpu")
    assert got == pyref.ec_msm(scalars, pts, curve)
    assert got == _jax_msm_256(scalars, pts)


# ---------------------------------------------------------------------------
# round_sums (the argument's carry stage: one window a round)
# ---------------------------------------------------------------------------

def _round_digits(rng, d, n, base=5):
    return np.array([[rng.randrange(base) for _ in range(n)] for _ in range(d)],
                    dtype=np.int32)


def _round_oracle(digits, pts, curve):
    return [pyref.ec_msm(row, pts, curve) for row in digits.tolist()]


def test_round_sums_safe_path(rng):
    """n = 8 < 64: every round takes the complete-add path; an all-zero and
    an all-max round among them."""
    curve = PALLAS
    E = ec(curve)
    n, base, d = 8, 5, 6
    pts = pyref.random_points(rng, curve, n)
    digits = _round_digits(rng, d, n)
    digits[0, :] = 0
    digits[1, :] = base - 1
    got = M.round_sums(curve, base, torch.from_numpy(digits), E.points_from_ints(pts, "cpu"))
    assert tuple(got.x.shape) == (d, N_LIMBS)
    assert E.points_to_ints(got) == _round_oracle(digits, pts, curve)


def test_round_sums_fast_flavor(rng):
    """n = 70: the blinded fast flavor on an odd n with an identity point, a
    repeated point and an all-zero round (every bucket empty); no round is
    flagged and every round is exact."""
    curve = PALLAS
    E = ec(curve)
    n, base, d = 70, 5, 4
    pts = pyref.random_points(rng, curve, n)
    pts[3] = None
    pts[10] = pts[11] = pts[12]
    digits = _round_digits(rng, d, n)
    digits[0, :] = 0
    dt = torch.from_numpy(digits)
    batch = E.points_from_ints(pts, "cpu")
    want = _round_oracle(digits, pts, curve)
    sums, excs = M._round_sums(curve, base, "fast", dt, batch)
    assert excs.dtype == torch.bool and not excs.any()
    assert E.points_to_ints(sums) == want
    assert E.points_to_ints(M.round_sums(curve, base, dt, batch)) == want
    assert E.points_to_ints(M._round_sums(curve, base, "safe", dt, batch)) == want


def test_round_sums_flags_one_round_and_recomputes_it(rng):
    """Point 0 is -T.  In round 2 it has digit 1 and every other digit is in
    [2, 5), so it sorts first and the blinded scan opens with T + (-T): the
    fast flavor flags exactly that round, and round_sums recomputes it with
    complete adds and is exact in every round.  In the other rounds -T has
    digit 4 behind an odd number of smaller digits, so it opens no lane."""
    curve = PALLAS
    E = ec(curve)
    n, base, d, flagged = 64, 5, 4, 2
    pts = pyref.random_points(rng, curve, n)
    pts[0] = pyref.ec_neg(E.offset_point_ints(), curve)
    digits = _round_digits(rng, d, n)
    digits[:, 0] = base - 1
    for k in range(d):
        if (digits[k] < base - 1).sum() % 2 == 0:
            digits[k, 1] = 0 if digits[k, 1] == base - 1 else base - 1
    digits[flagged] = [1] + [rng.randrange(2, base) for _ in range(n - 1)]
    dt = torch.from_numpy(digits)
    batch = E.points_from_ints(pts, "cpu")
    _, excs = M._round_sums(curve, base, "fast", dt, batch)
    assert excs.tolist() == [k == flagged for k in range(d)]
    assert E.points_to_ints(M.round_sums(curve, base, dt, batch)) == \
        _round_oracle(digits, pts, curve)


def test_cuda_entry_points_raise_without_a_card():
    """Entry points default to the card and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        M.msm_ints(PALLAS, [1], [(PALLAS.gen_x, PALLAS.gen_y)])
    with pytest.raises(RuntimeError, match="cuda"):
        ec(PALLAS).points_from_ints([None])
