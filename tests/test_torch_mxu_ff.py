"""The port's ops/mxu_ff.py (the product by a constant as matrix products)
against the JAX package's module and the port's own FF.mul.

Integer arithmetic throughout: the tolerance is exact equality, limb for
limb.  The inputs are tests/test_mxu_ff.py's, drawn the same way from the
same seed (64 random values plus 0, 1 and p - 1, times three random
constants and 0, 1, p - 1; a (5, 8) table with 0 and 1 among its rows), and
reach both packages as the same numpy limb arrays.  The JAX module runs
eagerly (one dispatch an op); its results are computed once for the file, at
the JAX test's shapes only."""

import random

import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu.fields import PALLAS as JAX_PALLAS
from halo2_liam_eagen_msm_tpu.ops import mxu_ff as JM
from halo2_liam_eagen_msm_tpu_torch.fields import GRUMPKIN, N_LIMBS, PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_mont_limbs
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops import mxu_ff as MX
from halo2_liam_eagen_msm_tpu_torch.ops.ff import ff

torch.set_num_threads(1)

SPEC = PALLAS.field
N_CONSTS = 6


def _limb_int(limbs) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(limbs))


def _inputs(spec):
    """tests/test_mxu_ff.py's values, constants and table, from its seed."""
    rng = random.Random(0xEA6E4)
    vals = [rng.randrange(spec.p) for _ in range(64)] + [0, 1, spec.p - 1]
    consts = [rng.randrange(spec.p) for _ in range(3)] + [0, 1, spec.p - 1]
    return vals, consts


def _table_inputs(spec):
    rng = random.Random(0xEA6E4)
    n_pos, batch = 8, 5
    vals = [rng.randrange(spec.p) for _ in range(n_pos * batch)]
    tvals = [rng.randrange(spec.p) for _ in range(n_pos - 2)] + [0, 1]
    a = ints_to_mont_limbs(vals, spec).reshape(batch, n_pos, N_LIMBS)
    return a, ints_to_mont_limbs(tvals, spec)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX module's planes, prod_cols_const (a * c, as mul_const's first
    step), mul_const for each constant and mul_table, on the JAX test's
    inputs."""
    import jax.numpy as jnp

    vals, consts = _inputs(SPEC)
    a = ints_to_mont_limbs(vals, SPEC)
    c_ints = [_limb_int(ints_to_mont_limbs([c], SPEC)[0]) for c in consts]
    aj = jnp.asarray(a)
    ta, tt = _table_inputs(SPEC)
    return {
        "a": a, "c": c_ints,
        "planes": np.asarray(JM.planes(aj).astype(jnp.float32)),
        "cols": [np.asarray(JM.prod_cols_const(aj, c)) for c in c_ints],
        "mul_const": [np.asarray(JM.mul_const(JAX_PALLAS.field, aj, c)) for c in c_ints],
        "table": (ta, tt, np.asarray(JM.mul_table(JAX_PALLAS.field, jnp.asarray(ta), tt))),
    }


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def test_planes_and_toeplitz_equal_jax(jax_results):
    """The byte planes (float32 here, bf16 there: bytes are exact in both)
    and the Toeplitz matrices of the six constants, at 64 and 32 output bytes
    (a * c and T_lo * mu's shapes)."""
    got = MX.planes(_t(jax_results["a"]))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), jax_results["planes"])
    for c in jax_results["c"]:
        for out_bytes in (64, 32):
            want = np.asarray(JM._toeplitz(c, out_bytes)).astype(np.float32)
            assert np.array_equal(MX._toeplitz(c, out_bytes), want)


def test_prod_cols_const_equals_jax(jax_results):
    """The 16-bit column sums of a * c, int64 here, uint32 there."""
    a = _t(jax_results["a"])
    for c, want in zip(jax_results["c"], jax_results["cols"]):
        got = MX.prod_cols_const(a, c)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("k", range(N_CONSTS))
def test_mul_const_equals_jax(k, jax_results):
    """mul_const by constant k of the JAX test's six (three random, 0, 1,
    p - 1), limb for limb; the plain version is what a CPU tensor takes."""
    a = _t(jax_results["a"])
    before = dict(CF.LAUNCHES)
    got = MX.mul_const(SPEC, a, jax_results["c"][k])
    assert CF.LAUNCHES == before  # a CPU tensor launches nothing
    assert got.dtype == torch.int32 and got.shape == a.shape
    assert np.array_equal(got.numpy(), jax_results["mul_const"][k].astype(np.int32))


def test_mul_table_equals_jax(jax_results):
    ta, tt, want = jax_results["table"]
    got = MX.mul_table(SPEC, _t(ta), _t(tt))
    assert got.shape == (5, 8, N_LIMBS)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert torch.equal(MX.mul_table(SPEC, _t(ta), tt), got)  # a numpy table


@pytest.mark.parametrize("curve", [PALLAS, GRUMPKIN], ids=lambda c: c.name)
def test_mul_const_and_table_equal_ff_mul(curve):
    """mul_const and mul_table against the port's FF.mul with the constant
    broadcast (mont_mul's plain version on the CPU), on both curves' base
    fields."""
    spec = curve.field
    F = ff(spec)
    vals, consts = _inputs(spec)
    a = _t(ints_to_mont_limbs(vals, spec))
    for c in consts:
        c_limbs = _t(ints_to_mont_limbs([c], spec))[0]
        want = F.mul(a, c_limbs.expand(a.shape))
        assert torch.equal(MX.mul_const(spec, a, _limb_int(c_limbs)), want)
    ta, tt = (_t(x) for x in _table_inputs(spec))
    assert torch.equal(MX.mul_table(spec, ta, tt), F.mul(ta, tt.expand(ta.shape)))


def test_column_bounds_at_all_ones():
    """All-0xFFFF limbs times the all-0xFF constant (every byte 255): the
    16-bit columns equal the exact convolution, and the largest stays below
    2^29.1, so the high halves' sum of two such columns, plus the carries
    and 2^256 - p's limbs, stays below 2^31: one fold of _normalize takes
    any such column below 2^16 - 1 + 2^15 < 2^17 - 1, which is what the
    plain version's folds = 1 rest on."""
    a = torch.full((2, N_LIMBS), 0xFFFF, dtype=torch.int32)
    c = (1 << 256) - 1
    got = MX.prod_cols_const(a, c)
    byte_cols = [sum(255 * 255 for k in range(32) if 0 <= m - k < 32) for m in range(64)]
    want = [byte_cols[2 * j] + (byte_cols[2 * j + 1] << 8) for j in range(32)]
    assert got.tolist() == [want, want]
    top = int(got.max())
    assert top < 2 ** 29.1
    hi = 2 * top + 2 * (1 << 16) + (1 << 16)
    assert hi < 1 << 31
    assert (1 << 16) - 1 + (hi >> 16) < (1 << 17) - 1
    # and at those columns the carry network is exact: the limbs of their value
    C = CF._plain_consts(SPEC, "cpu")
    limbs, carry = CF._normalize(C, got[:, :16], folds=1)
    value = sum(w << (16 * j) for j, w in enumerate(want[:16]))
    assert _limb_int(limbs[0].tolist()) + (int(carry[0]) << 256) == value % (1 << 272)


def test_kernel_wrappers_refuse_cpu_tensors():
    """mxu_mul_const and mxu_mul_table launch the kernel or raise: on a CPU
    tensor they raise before any launch (the routing of mul_const and
    mul_table sends CPU tensors to the plain versions)."""
    a = _t(ints_to_mont_limbs([1, 2, 3], SPEC))
    before = dict(CF.LAUNCHES)
    with pytest.raises(ValueError):
        MX.mxu_mul_const(SPEC, a, 5)
    with pytest.raises(ValueError):
        MX.mxu_mul_table(SPEC, a[None], a)
    assert CF.LAUNCHES == before


def test_chip_smoke_bound_counts_a_row_in_and_out():
    """chip_smoke.py's bound for the kernel: 64 bytes in and 64 out a row
    (and a table row a position), 0.0401 ms at 2^20 rows at 3.35 TB/s, above
    its tensor-core and carry operations."""
    import chip_smoke

    n = 1 << 20
    b_ms, by = chip_smoke.mxu_bound("mxu_mul_const", n)
    assert by == "bytes" and b_ms == pytest.approx(n * 128 / 3.35e12 * 1e3, rel=1e-12)
    assert round(b_ms, 4) == 0.0401
    b_ms, by = chip_smoke.mxu_bound("mxu_mul_table", n, 1024 * 64)
    assert by == "bytes" and b_ms == pytest.approx((n * 128 + 1024 * 64) / 3.35e12 * 1e3)
    assert n * chip_smoke.MXU_TC_OPS / chip_smoke.INT8_TC_OPS_PER_S * 1e3 < b_ms / 5
