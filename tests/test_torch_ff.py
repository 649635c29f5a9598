"""Field layer of the PyTorch port against the JAX package and exact ints.

Everything is integer arithmetic: the tolerance is exact equality, limb for
limb.  Inputs come from a seeded `random.Random` and reach both packages as
the same numpy limb arrays (convert.py)."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu.ops import pallas_ff as PF
from halo2_liam_eagen_msm_tpu.ops.ff import ff as jax_ff
from halo2_liam_eagen_msm_tpu_torch import fields as TF
from halo2_liam_eagen_msm_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from halo2_liam_eagen_msm_tpu_torch.limbs import (
    ints_to_limbs, ints_to_mont_limbs, limbs_to_ints, mont_limbs_to_ints)
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops.ff import ff

torch.set_num_threads(1)

SPECS = list(TF.FIELDS.values())


def _pairs(rng, spec, n):
    xs = [rng.randrange(spec.p) for _ in range(n)]
    ys = [rng.randrange(spec.p) for _ in range(n)]
    xs[:4] = [0, spec.p - 1, 1, 0]
    ys[:4] = [spec.p - 1, spec.p - 1, spec.p - 1, 0]
    return xs, ys


def _jax_spec(spec):
    from halo2_liam_eagen_msm_tpu import fields as JF
    return JF.FIELDS[spec.name]


def test_specs_match_the_jax_package():
    from halo2_liam_eagen_msm_tpu import fields as JF
    for name, spec in TF.FIELDS.items():
        assert (spec.p, spec.generator, spec.s) == \
            (JF.FIELDS[name].p, JF.FIELDS[name].generator, JF.FIELDS[name].s)
    for name, c in TF.CURVES.items():
        j = JF.CURVES[name]
        assert (c.a, c.b, c.gen_x, c.gen_y, c.field.name, c.scalar_field.name) == \
            (j.a, j.b, j.gen_x, j.gen_y, j.field.name, j.scalar_field.name)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("n", [67, 4100], ids=["small", "large"])
def test_plain_field_ops_vs_ints(spec, n, rng):
    """Both forms of the plain product (outer product up to 2048 rows,
    shifted multiply-accumulates above) and add/sub, for every field."""
    xs, ys = _pairs(rng, spec, n)
    a = limbs_from_numpy(ints_to_mont_limbs(xs, spec), "cpu")
    b = limbs_from_numpy(ints_to_mont_limbs(ys, spec), "cpu")
    p = spec.p
    got = mont_limbs_to_ints(limbs_to_numpy(CF.mont_mul_plain(spec, a, b)), spec)
    assert got == [x * y % p for x, y in zip(xs, ys)]
    got = mont_limbs_to_ints(limbs_to_numpy(CF.mont_addsub_plain(spec, False, a, b)), spec)
    assert got == [(x + y) % p for x, y in zip(xs, ys)]
    got = mont_limbs_to_ints(limbs_to_numpy(CF.mont_addsub_plain(spec, True, a, b)), spec)
    assert got == [(x - y) % p for x, y in zip(xs, ys)]


def test_plain_vs_pallas_interpret(rng):
    """mont_mul_plain / mont_addsub_plain against the TPU kernels run in
    interpret mode at one block, limb for limb."""
    spec = TF.PALLAS_FP
    xs, ys = _pairs(rng, spec, 1024)
    an = ints_to_mont_limbs(xs, spec)
    bn = ints_to_mont_limbs(ys, spec)
    a, b = limbs_from_numpy(an, "cpu"), limbs_from_numpy(bn, "cpu")
    ja, jb = jnp.asarray(an), jnp.asarray(bn)
    js = _jax_spec(spec)
    assert np.array_equal(limbs_to_numpy(CF.mont_mul_plain(spec, a, b)),
                          np.asarray(PF.mont_mul(js, ja, jb)))
    assert np.array_equal(limbs_to_numpy(CF.mont_addsub_plain(spec, False, a, b)),
                          np.asarray(PF.mont_addsub(js, False, ja, jb)))
    assert np.array_equal(limbs_to_numpy(CF.mont_addsub_plain(spec, True, a, b)),
                          np.asarray(PF.mont_addsub(js, True, ja, jb)))


@pytest.mark.parametrize("spec", [TF.PALLAS_FP, TF.BN254_FR], ids=lambda s: s.name)
def test_ff_vs_jax_jnp_path(spec, rng):
    """FF.mul/add/sub/neg of the port against the JAX package's jnp path."""
    xs, ys = _pairs(rng, spec, 64)
    an = ints_to_mont_limbs(xs, spec)
    bn = ints_to_mont_limbs(ys, spec)
    a, b = limbs_from_numpy(an, "cpu"), limbs_from_numpy(bn, "cpu")
    k, jk = ff(spec), jax_ff(_jax_spec(spec))
    ja, jb = jnp.asarray(an), jnp.asarray(bn)
    for name in ("mul", "add", "sub"):
        got = limbs_to_numpy(getattr(k, name)(a, b))
        assert np.array_equal(got, np.asarray(getattr(jk, name)(ja, jb))), name
    assert np.array_equal(limbs_to_numpy(k.neg(a)), np.asarray(jk.neg(ja)))
    assert np.array_equal(limbs_to_numpy(k.double(a)), np.asarray(jk.double(ja)))
    assert np.array_equal(limbs_to_numpy(k.one("cpu")), jk.one)
    assert np.array_equal(limbs_to_numpy(k.const(12345, "cpu")), jk.const(12345))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mont_roundtrip_select_eq(spec, rng):
    k = ff(spec)
    xs = [rng.randrange(spec.p) for _ in range(16)]
    raw = limbs_from_numpy(ints_to_limbs(xs), "cpu")
    m = k.to_mont(raw)
    assert mont_limbs_to_ints(limbs_to_numpy(m), spec) == xs
    assert limbs_to_ints(limbs_to_numpy(k.from_mont(m))) == xs
    mask = torch.tensor([i % 2 == 0 for i in range(16)])
    sel = k.select(mask, m, raw)
    assert torch.equal(sel[0], m[0]) and torch.equal(sel[1], raw[1])
    assert k.eq(m, m).all() and not k.eq(m, k.add(m, k.one("cpu"))).any()
    assert k.is_zero(torch.zeros(3, 16, dtype=torch.int32)).all()
    assert not k.is_zero(m).any()


def test_inv(rng):
    spec = TF.PALLAS_FP
    k = ff(spec)
    xs = [rng.randrange(spec.p) for _ in range(16)]
    xs[0], xs[1] = 1, 0  # inv(0) == 0
    a = limbs_from_numpy(ints_to_mont_limbs(xs, spec), "cpu")
    got = mont_limbs_to_ints(limbs_to_numpy(k.inv(a)), spec)
    assert got == [pow(x, spec.p - 2, spec.p) for x in xs]


@pytest.mark.parametrize("n", [33, 700], ids=["fermat", "chains"])
def test_batch_inv(n, rng):
    """Zeros map to zeros, below and above the 512-element switch to the
    64-step product chains."""
    spec = TF.PALLAS_FP
    k = ff(spec)
    xs = [rng.randrange(spec.p) for _ in range(n)]
    xs[5] = xs[n - 1] = 0
    a = limbs_from_numpy(ints_to_mont_limbs(xs, spec), "cpu")
    got = mont_limbs_to_ints(limbs_to_numpy(k.batch_inv(a)), spec)
    assert got == [pow(x, spec.p - 2, spec.p) if x else 0 for x in xs]


# batch_inv_plain, the plain version of the batch_inv kernel, at the sizes of
# test_batch_inv and a ragged 130 (zeros at both ends of each), chains of one
# row and of 64 (33 rows: one chain; 700: eleven, four of them a row short;
# 130: three, the last two rows long)
_INV_SIZES = (33, 700, 130)


@functools.lru_cache(maxsize=None)
def _inv_rows(spec):
    """The rows of every size, in one (sum of sizes, 16) numpy array, and the
    JAX package's FF.batch_inv of all of them in one call (every output is
    the unique inverse, so one call serves every size)."""
    rng = random.Random(0x1D5 + len(spec.name))
    parts = []
    for n in _INV_SIZES:
        xs = [rng.randrange(spec.p) for _ in range(n)]
        xs[0] = xs[n // 2] = xs[n - 1] = 0
        parts.append(ints_to_mont_limbs(xs, spec))
    rows = np.concatenate(parts)
    return rows, np.asarray(jax.jit(jax_ff(_jax_spec(spec)).batch_inv)(jnp.asarray(rows)))


@pytest.mark.parametrize("spec", [TF.PALLAS_FP, TF.BN254_FR], ids=lambda s: s.name)
@pytest.mark.parametrize("n", _INV_SIZES)
@pytest.mark.parametrize("chain", [1, 64])
def test_batch_inv_plain_vs_host_and_jax(spec, n, chain):
    rows, want = _inv_rows(spec)
    off = sum(_INV_SIZES[:_INV_SIZES.index(n)])
    a = limbs_from_numpy(rows[off:off + n], "cpu")
    got = CF.batch_inv_plain(spec, a, chain=chain)
    assert torch.equal(got, ff(spec)._inv_host(a))
    assert np.array_equal(limbs_to_numpy(got), want[off:off + n])


@pytest.mark.parametrize("spec", [TF.PALLAS_FP, TF.BN254_FR], ids=lambda s: s.name)
def test_pow_schedule(spec, rng):
    """The walk of the kernel's power: a^e by its windows equals the exact
    power, and p - 2 takes fewer products than square-and-multiply."""
    xs = [rng.randrange(spec.p) for _ in range(5)] + [0, 1]
    a = limbs_from_numpy(ints_to_mont_limbs(xs, spec), "cpu")
    for e in (1, 2, 3, 16, 0xF1, 0x8000_0001, spec.p - 2):
        got = mont_limbs_to_ints(limbs_to_numpy(CF._pow_plain(spec, a, e)), spec)
        assert got == [pow(x, e, spec.p) for x in xs], hex(e)
    e = spec.p - 2
    square_and_multiply = e.bit_length() - 1 + bin(e).count("1") - 1
    assert CF.pow_products(e) < square_and_multiply
    steps, tail = CF.pow_schedule(16)
    assert steps == [(0, 0)] and tail == 4


def test_batch_inv_chain_lengths():
    assert [CF.batch_inv_chain(n) for n in (1, 16383, 1 << 16, 1 << 20, 1 << 21, 1 << 23)] == \
        [1, 1, 4, 64, 64, 64]
    assert CF.batch_inv_products(33, 64, 3) == 3 * 32 + CF.pow_products(3)


@pytest.mark.parametrize("n", [33, 1 << 16, 1 << 21])
def test_batch_inv_bound_counts_the_function(n):
    """chip_smoke.py's bound for batch_inv counts what inverting n rows needs
    (the Montgomery trick's 3 (n - 1) products and one power, one row read
    and one written), not the products of the kernel's chains, so it is the
    same for every chain length."""
    import chip_smoke

    spec = chip_smoke.SPEC
    assert chip_smoke.inv_muls(n) * n == 3 * (n - 1) + CF.pow_products(spec.p - 2)
    assert CF.batch_inv_products(n, CF.batch_inv_chain(n), spec.p - 2) >= \
        chip_smoke.inv_muls(n) * n
    b_ms, by = chip_smoke.bound_ms("batch_inv", n, muls=chip_smoke.inv_muls(n))
    t_bytes = 2 * n * 4 * TF.N_LIMBS / chip_smoke.HBM_BYTES_PER_S * 1e3
    t_ops = chip_smoke.inv_muls(n) * n * chip_smoke.MUL_OPS / chip_smoke.INT32_OPS_PER_S * 1e3
    assert b_ms == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")
    if n == 1 << 21:
        assert by == "bytes" and b_ms == pytest.approx(0.0801, abs=1e-4)


def test_ec_add_mixed_bound_counts_the_doublings_taken():
    """chip_smoke.py's bound for ec_add_mixed counts madd-2007-bl's 11
    products and 7 adds at every step and the doubling's 7 and 14 only at
    the steps whose carry equals the row it meets: mixed_doublings counts
    those steps of a planted safe scan (q == carry in lane 3, q == -carry in
    lane 4, affine identities) as running sums on Python ints do."""
    import chip_smoke
    from halo2_liam_eagen_msm_tpu_torch.utils import pyref

    curve = chip_smoke.CURVE
    base = pyref.random_points(random.Random(0xBE7C), curve, 4)
    g, w = 8, 6
    carries, qx, qy, mask, host = chip_smoke.safe_scan_inputs(
        np.random.default_rng(3), base, g, w, "cpu")
    inner, _ = CF.ec_add_mixed_scan_plain(curve, *carries, qx, qy, mask, w)
    before = [torch.cat([c[:, None], i.reshape(g, w, TF.N_LIMBS)[:, :-1]], dim=1).reshape(
        g * w, TF.N_LIMBS) for c, i in zip(carries, inner)]
    want = 0
    for j in range(g):
        acc = None
        for q in host[j * w:(j + 1) * w]:
            want += acc is not None and acc == q
            acc = pyref.ec_add(acc, q, curve)
    doublings = chip_smoke.mixed_doublings(*before, qx, qy)
    assert doublings == want > 0
    rows = g * w
    b_ms, by = chip_smoke.mixed_bound(rows, doublings, 0)
    ops = (11 * rows + 7 * doublings) * chip_smoke.MUL_OPS + \
        (7 * rows + 14 * doublings) * chip_smoke.ADD_OPS
    assert by == "operations"
    assert b_ms == pytest.approx(ops / chip_smoke.INT32_OPS_PER_S * 1e3, rel=1e-12)


@pytest.mark.parametrize("g, w", [(64, 1), (64, 2), (2048, 32)])
def test_ec_madd_xyzz_bound_counts_the_scan(g, w):
    """chip_smoke.py's bound for ec_madd_xyzz_fast's scan of g carries by w
    steps: madd-2008-s's 10 products and 7 adds a step; 2 rows in and 4 out
    a step, a carry's 4 rows in, 4 totals out where w > 1 (w = 1 writes its
    totals as the inner prefixes) and one flag byte."""
    import chip_smoke

    b_ms, by = chip_smoke.xyzz_bound(g, w)
    row = 4 * TF.N_LIMBS
    t_bytes = (g * w * 6 * row + g * ((8 if w > 1 else 4) * row + 1)) / \
        chip_smoke.HBM_BYTES_PER_S * 1e3
    t_ops = g * w * (10 * chip_smoke.MUL_OPS + 7 * chip_smoke.ADD_OPS) / \
        chip_smoke.INT32_OPS_PER_S * 1e3
    assert b_ms == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


@pytest.mark.parametrize("chain", [1, 4, 64])
def test_batch_inv_plain_chains_on_the_host(chain, rng):
    """batch_inv_plain on a (2, 300) batch with zeros, at chain lengths 1 (a
    power a row), 4 (150 chains) and 64 (ten chains, the last ragged), equals
    the exact host inverse row for row."""
    spec = TF.PALLAS_FP
    xs = [rng.randrange(spec.p) for _ in range(600)]
    xs[0] = xs[299] = xs[599] = 0
    a = limbs_from_numpy(ints_to_mont_limbs(xs, spec), "cpu").reshape(2, 300, TF.N_LIMBS)
    got = CF.batch_inv_plain(spec, a, chain=chain)
    assert got.shape == a.shape
    assert torch.equal(got, ff(spec)._inv_host(a))
