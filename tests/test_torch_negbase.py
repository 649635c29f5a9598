"""The port's own negbase module against the JAX package's (both are numpy
and Python ints only): byte-equal digit streams on the same seeded scalars,
and the layout in which the digits cross to the device.  Exact comparisons."""

import math

import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu import negbase as jax_negbase
from halo2_liam_eagen_msm_tpu_torch import negbase as NB
from halo2_liam_eagen_msm_tpu_torch.argument import num_digits_for
from halo2_liam_eagen_msm_tpu_torch.convert import digits_to_rounds
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_limbs

torch.set_num_threads(1)


def _scalars(rng, n=200):
    """Seeded scalars below sqrt(q) + 2 with the extremes of the digit
    budget."""
    sq_p = math.isqrt(PALLAS.scalar_field.p) + 2
    return [sq_p - 1, sq_p // 2, 2**127, 1, 0] + [rng.randrange(sq_p) for _ in range(n)]


@pytest.mark.parametrize("base", [2, 3, 5, 16])
def test_decompose_batch_vs_jax_package_and_recompose(rng, base):
    scalars = _scalars(rng)
    d = num_digits_for(PALLAS, base)
    mags = ints_to_limbs(scalars)
    got = NB.negbase_decompose_batch(mags, base, d)
    want = jax_negbase.negbase_decompose_batch(mags, base, d)
    assert got.dtype == np.uint8 and got.shape == (len(scalars), d)
    assert got.tobytes() == want.tobytes()
    for s, row in zip(scalars, got):
        assert NB.negbase_recompose(row.tolist(), base) == s
        digits = NB.negbase_decompose(s, base)
        assert digits == jax_negbase.negbase_decompose(s, base)
        assert row.tolist() == digits + [0] * (d - len(digits))


def test_decompose_batch_rejects_a_short_budget():
    with pytest.raises(ValueError, match="num_digits"):
        NB.negbase_decompose_batch(ints_to_limbs([5**6]), 5, 3)


def test_decompose_negative_and_tables(rng):
    for x in (-1, -5, -(2**100) + 3, 7):
        digits = NB.negbase_decompose(x, 5)
        assert digits == jax_negbase.negbase_decompose(x, 5)
        assert NB.negbase_recompose(digits, 5) == x
    f = PALLAS.scalar_field
    for table_id in range(20):
        assert NB.table_entry_by_id(5, table_id, f) == \
            jax_negbase.table_entry_by_id(5, table_id, f)
        assert NB.id_by_digit(NB.digit_by_id(table_id)) == table_id
    assert NB.id_by_digit(0) is None
    sc = rng.randrange(2**100)
    got = NB.prepare_scalar_witness(sc, 5, 56, 4)
    want = jax_negbase.prepare_scalar_witness(sc, 5, 56, 4)
    assert [[(e.kind, e.value, e.integrity) for e in row] for row in got] == \
        [[(e.kind, e.value, e.integrity) for e in row] for row in want]
    with pytest.raises(ValueError):
        NB.range_check(1 << 127)


def test_digits_to_rounds_layout(rng):
    """(N, d) little-endian uint8 digits -> (d, N) int32, msb round first:
    the layout both packages' carry stages consume."""
    scalars = _scalars(rng, 11)
    d = num_digits_for(PALLAS, 5)
    digits = NB.negbase_decompose_batch(ints_to_limbs(scalars), 5, d)
    rounds = digits_to_rounds(digits, "cpu")
    assert rounds.dtype == torch.int32 and tuple(rounds.shape) == (d, len(scalars))
    assert np.array_equal(rounds.numpy(), digits[:, ::-1].T.astype(np.int32))
    assert not rounds[0].any()  # the spare most-significant round is all zeros
    with pytest.raises(ValueError):
        digits_to_rounds(digits.astype(np.int32), "cpu")
