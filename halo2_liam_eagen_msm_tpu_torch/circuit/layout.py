"""Fixed-column layout generation: selector vectors and lookup tables.

Mirrors the reference's Expansion/Chunk/ExpansionTable machinery and its
population logic in LiamMSMConfig::configure (config.rs:60-135, :286-326,
:359-501, :542-560) as plain integer arrays.  Two deliberate deviations from
the (non-compiling) reference, documented per SURVEY.md §4:

  * config.rs:498 contains `batch_offset == 0` (a no-op comparison) where a
    reset was clearly intended; we implement the intended reset so table rows
    stay inside batches — flagged below
  * selectors are plain 0/1 integer vectors, not halo2 fixed columns
"""

from __future__ import annotations

import dataclasses

from ..fields import CurveSpec
from ..negbase import table_entry_by_id
from ..utils import pyref
from .params import Params, ParamsExt, div_ceil, params_check


@dataclasses.dataclass
class Expansion:
    """A fixed column that knows how to populate itself (config.rs:95-122):
    a sparse map row -> value, with mutually-exclusive updates."""

    data: dict

    def __init__(self):
        self.data = {}

    def push(self, row: int, value: int) -> None:
        assert row not in self.data, f"row {row} set twice"
        self.data[row] = value

    def update(self, values, start: int = 0) -> None:
        """Chunk update (config.rs:60-110): None entries are skipped."""
        for i, v in enumerate(values):
            if v is not None:
                self.push(start + i, v)

    def dense(self, nrows: int):
        return [self.data.get(i, 0) for i in range(nrows)]


@dataclasses.dataclass
class Layout:
    """All fixed data for one parameterization."""
    params: Params
    ext: ParamsExt
    s1poly: Expansion
    s2poly: Expansion
    s3poly: Expansion
    s0sc: Expansion
    s1sc: Expansion
    s2sc: Expansion
    s3sc: Expansion
    s4sc: Expansion
    s1t: Expansion
    s2t: Expansion
    table: Expansion        # lookup values + point multiplicity coords
    table_map: list         # table_id -> row (ExpansionTable.map)
    nrows: int


def build_layout(curve: CurveSpec, params: Params) -> Layout:
    """configure()'s fixed-data population (config.rs:191-573), minus the
    plonk registration."""
    ext = params_check(curve, params)
    p = curve.field.p
    num_pts, base = params.num_pts, params.base
    num_digits, num_limbs = ext.num_digits, ext.num_limbs
    batch_size, sc_box_size = ext.batch_size, ext.sc_box_size
    sc_in_batch, c_skip = ext.sc_in_batch, ext.c_skip

    s1poly, s2poly, s3poly = Expansion(), Expansion(), Expansion()
    s0sc, s1sc, s2sc, s3sc, s4sc = (Expansion() for _ in range(5))
    s1t, s2t = Expansion(), Expansion()
    table = Expansion()
    table_map = []

    total = batch_size * (num_pts + base + 1)

    # poly selectors (config.rs:286-326)
    s1poly.update(
        [1 if i % batch_size == batch_size - c_skip else 0 for i in range(total)]
    )
    s2poly.update(
        [
            1
            if (i % batch_size > batch_size - c_skip)
            and (i % batch_size + params.poly_fan_in * c_skip < num_digits)
            else 0
            for i in range(total)
        ]
    )
    s3poly.update(
        [
            1
            if (i % batch_size > batch_size - c_skip)
            and (i % batch_size + params.poly_fan_in * c_skip >= num_digits)
            else 0
            for i in range(total)
        ]
    )

    # scalar selectors (config.rs:359-394): bound covers the B1 region
    bound = (num_pts // sc_in_batch) * batch_size + (num_pts % sc_in_batch) * sc_box_size

    def sc_sel(pred):
        out = []
        for i in range(bound):
            j = i % batch_size
            if j >= sc_box_size * sc_in_batch:
                out.append(0)
                continue
            out.append(1 if pred(j % sc_box_size) else 0)
        return out

    s1sc.update(sc_sel(lambda i: i == 0))
    s2sc.update(sc_sel(lambda i: i > 0 and i % (num_limbs + 1) == 0))
    s3sc.update(sc_sel(lambda i: 0 < i < num_limbs + 1))
    s0sc.update([1 if i % batch_size == 0 else 0 for i in range(bound)])
    # s4sc — third documented deviation: the reference writes
    # `i%(num_limbs+1)>0 && i%base>0` (config.rs:459), which only
    # approximates its own gate comment ("active on all cells corresponding
    # to limbs / integrities", config.rs:415) when num_limbs+1 == base, and
    # even then fires one row before each bucket, demanding the BUCKET value
    # be lookup-able.  The intended chain semantics: fire at row j when both
    # j and j+1 are limb/integrity cells (scalar and bucket rows are bridged
    # by the rhs_2/rhs_3 variants).
    s4sc.update(sc_sel(
        lambda i: i % (num_limbs + 1) != 0
        and (i + 1) % (num_limbs + 1) != 0
        and i + 1 < sc_box_size
    ))

    # lookup table placement (config.rs:466-501): one empty buffer batch, then
    # fill non-skip rows of remaining batches, overflowing past A1 if needed
    table_init_batch = div_ceil(num_pts, sc_in_batch) + 1
    tablesize = 1 << params.logtable
    curr_batch = table_init_batch
    batch_offset = 0
    global_offset = 0
    for tid in range(tablesize):
        row = curr_batch * batch_size + batch_offset + global_offset
        table_map.append(row)
        table.push(row, table_entry_by_id(base, tid, curve.field))
        if row % batch_size == 0 and global_offset == 0:
            s2t.push(row, 1)
        else:
            s1t.push(row, 1)
        if row >= batch_size * (num_pts + base + 1):
            global_offset += 1
        else:
            if batch_offset == batch_size - c_skip:
                # reference config.rs:498 has `batch_offset == 0` (no-op
                # comparison); the intended reset is implemented here
                batch_offset = 0
                curr_batch += 1
            else:
                batch_offset += 1

    # point-multiplicity coordinates into the table column (config.rs:542-560).
    # Deviation (documented): the reference writes rows at
    # i*batch_size + j*sc_box_size (+...) — with sc_in_batch scalars per batch
    # that collides with the lookup region above (the WIP circuit never ran).
    # The intended placement puts scalar i's rows in batch i//sc_in_batch at
    # box i%sc_in_batch, aligning with the B1 scalar boxes the b-gate reads.
    for i in range(num_pts):
        pt = params.pts[i]
        mults = []
        acc = pt
        for _ in range(1, base):
            mults.append(acc)
            acc = pyref.ec_add(acc, pt, curve)
        box_row = (i // sc_in_batch) * batch_size + (i % sc_in_batch) * sc_box_size
        for k in range(1, base):
            row = box_row + k * (num_limbs + 1)
            x, y = mults[k - 1]
            table.push(row, x)
            table.push(row + 1, y)

    nrows = max(
        total,
        (max(table.data) + 1) if table.data else 0,
    )
    return Layout(
        params=params, ext=ext,
        s1poly=s1poly, s2poly=s2poly, s3poly=s3poly,
        s0sc=s0sc, s1sc=s1sc, s2sc=s2sc, s3sc=s3sc, s4sc=s4sc,
        s1t=s1t, s2t=s2t, table=table, table_map=table_map, nrows=nrows,
    )
