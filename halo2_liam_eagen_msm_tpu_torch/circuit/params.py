"""Circuit parameters and layout arithmetic.

Replicates the reference's Params/ParamsExt/params_check exactly
(the reference's config.rs:39-57, :585-603) and the old generation's
compile-time invariants (config.rs.bac:34-39, :346-354) as checkable
functions.  The circuit layer is built as a constraint-data generator +
out-of-circuit checker (SURVEY.md §7 step 9): the reference's L5 does not
compile at HEAD and its synthesize is unfinished, so the layout formulas and
gate algebra are treated as the spec.
"""

from __future__ import annotations

import dataclasses
import logging
import math

from ..fields import CurveSpec
from ..argument import logb_ceil, order

log = logging.getLogger(__name__)


def div_ceil(a: int, b: int) -> int:
    return (a + b - 1) // b


@dataclasses.dataclass(frozen=True)
class Params:
    """config.rs:585-592."""
    num_pts: int          # number of points
    base: int             # base of decomposition
    logtable: int         # log-size of the lookup table
    poly_fan_in: int      # elements per linear-combination step
    batch_offset: int     # rows intentionally left empty per batch
    pts: tuple            # fixed-base MSM points ((x, y) ints or None)


@dataclasses.dataclass(frozen=True)
class ParamsExt:
    """config.rs:595-603."""
    num_digits: int
    num_limbs: int
    batch_size: int
    sc_box_size: int
    sc_in_batch: int
    b_skip: int
    c_skip: int


def params_check(curve: CurveSpec, params: Params) -> ParamsExt:
    """Exact replica of params_check (config.rs:39-57), including the
    <70% batch-fill warning (:54 — the reference's one 'production' log)."""
    assert len(params.pts) == params.num_pts, "incorrect amount of points"
    num_digits = logb_ceil(order(curve.field), params.base ** 2)
    num_limbs = div_ceil(num_digits, params.logtable)
    sc_box_size = (num_limbs + 1) * params.base
    batch_size = params.batch_offset + num_digits
    c_skip = div_ceil(batch_size, params.poly_fan_in)
    sc_in_batch = (batch_size - c_skip) // sc_box_size
    b_skip = batch_size - sc_in_batch * sc_box_size

    fit_percentage = (100 * sc_in_batch * sc_box_size) // batch_size
    assert sc_in_batch > 0, "Must fit at least 1 scalar box."
    if fit_percentage < 70:
        log.warning(
            "only %d%% of each batch are populated in column b. It is possible "
            "to increase batch_offset or poly_fan_in to improve this.",
            fit_percentage,
        )
    return ParamsExt(
        num_digits=num_digits,
        num_limbs=num_limbs,
        batch_size=batch_size,
        sc_box_size=sc_box_size,
        sc_in_batch=sc_in_batch,
        b_skip=b_skip,
        c_skip=c_skip,
    )


# -- old-generation constants and their invariants (config.rs.bac) ----------

OLD_NUM_LIMBS = 4
OLD_BASE = 5
OLD_SKIP = 2
OLD_LOGTABLESIZE = 15
OLD_POLY_ROTATION = 13
OLD_BATCH_SIZE = 26


def old_const_assertions(curve: CurveSpec) -> None:
    """config.rs.bac:346-354 — the layout invariants of the first-generation
    design, kept as a regression anchor for the layout formulas."""
    assert OLD_NUM_LIMBS > 1
    assert OLD_BASE ** (OLD_LOGTABLESIZE * 2 * OLD_NUM_LIMBS) > order(
        curve.scalar_field
    )
    assert OLD_BATCH_SIZE == (OLD_NUM_LIMBS + 2) * (OLD_BASE - 1) + OLD_SKIP
    assert OLD_BATCH_SIZE % OLD_POLY_ROTATION == 0
    poly_rots_in_1_batch = OLD_BATCH_SIZE // OLD_POLY_ROTATION
    assert poly_rots_in_1_batch >= OLD_SKIP
