"""Witness-column generation for the circuit layer.

The reference's `synthesize` is unfinished (config.rs:635-683 unconditionally
returns Err(Error::Synthesis) — the WIP frontier per SURVEY.md §2.7), so this
module is new design following the layout spec (layout.md, layout.md.bac),
made exactly consistent with the gates AND the lookup table as written:

  * the lookup table maps bit-pattern ids to sum_{k in bits} (-base)^(k+1)
    (table_entry_by_id's trailing-multiply Horner, negbase_utils.rs:58-77) —
    so limb cells MUST carry values of that exact form to be lookup-able;
  * the bucket-from-limbs gate multiplies limb cells by base^(j*logtable)
    (POSITIVE base, config.rs:350), which reconstructs (-base)*bucket_d
    from such cells when logtable is even;
  * therefore the whole b-column system is uniformly scaled by (-base):
    scalar row = (-base)*sc, bucket rows = (-base)*bucket_d, limb cells =
    table entries of the per-limb digit-position sets, integrity rows =
    per-limb union sums (also table entries, since digit position sets are
    disjoint).  All three b-gate identities close exactly, and every limb and
    integrity cell is range-checked by the lookup.

Requires even logtable (documented; the odd-logtable variant needs per-limb
sign columns the reference never specified).
"""

from __future__ import annotations

from ..fields import CurveSpec
from ..negbase import id_by_digit, negbase_decompose, table_entry_by_id


def scalar_box_column(curve: CurveSpec, sc: int, base: int, num_digits: int,
                      logtable: int) -> list[int]:
    """One B1 scalar box for column b (layout.md.bac:59-81):
        [(-base)*sc, integrity[0..NL-1], (bucket', limbs[0..NL-1]) x (base-1)]
    """
    assert logtable % 2 == 0, "even logtable required (see module docstring)"
    p = curve.field.p
    digits = negbase_decompose(sc, base)
    assert len(digits) <= num_digits
    num_limbs = (num_digits + logtable - 1) // logtable

    # per-digit, per-limb position sets -> table-entry-form cell values
    cells = [[0] * num_limbs for _ in range(base - 1)]
    ids = [[0] * num_limbs for _ in range(base - 1)]
    for i, d in enumerate(digits):
        idx = id_by_digit(d)
        if idx is None:
            continue
        j = i // logtable
        k = i % logtable
        cells[idx][j] = (cells[idx][j] + pow(-base, k + 1, p)) % p
        ids[idx][j] |= 1 << k
    # buckets scaled by (-base)
    buckets = [0] * (base - 1)
    for d in range(base - 1):
        for j in range(num_limbs):
            buckets[d] = (buckets[d] + pow(base, j * logtable, p) * cells[d][j]) % p
    integ = [sum(cells[d][j] for d in range(base - 1)) % p for j in range(num_limbs)]

    col = [(-base) * sc % p] + integ
    for d in range(base - 1):
        col.append(buckets[d])
        col.extend(cells[d])
    return col


def box_lookup_ids(sc: int, base: int, num_digits: int, logtable: int):
    """The table ids each limb/integrity cell of the box must hit."""
    digits = negbase_decompose(sc, base)
    num_limbs = (num_digits + logtable - 1) // logtable
    ids = [[0] * num_limbs for _ in range(base - 1)]
    for i, d in enumerate(digits):
        idx = id_by_digit(d)
        if idx is None:
            continue
        ids[idx][i // logtable] |= 1 << (i % logtable)
    union = [0] * num_limbs
    for d in range(base - 1):
        for j in range(num_limbs):
            union[j] |= ids[d][j]
    return ids, union


def lookup_columns(curve: CurveSpec, looked_cells: list[int], table: list[int],
                   v: int):
    """Log-derivative lookup witness (layout.md.bac:131-151): running sum
    over looked-up cells with increments 1/(v - cell), and per-table
    multiplicities with the lhs running sum adding m_t/(v - t).
    Returns (rhs running sums, multiplicities, lhs running sums); the final
    sums agree — the lookup identity the gates enforce."""
    p = curve.field.p
    rhs = []
    acc = 0
    for cell in looked_cells:
        acc = (acc + pow(v - cell, p - 2, p)) % p
        rhs.append(acc)
    mult = {}
    for cell in looked_cells:
        mult[cell] = mult.get(cell, 0) + 1
    mults = [mult.get(t, 0) for t in table]
    lhs = []
    acc2 = 0
    for m, t in zip(mults, table):
        acc2 = (acc2 + m * pow(v - t, p - 2, p)) % p
        lhs.append(acc2)
    assert acc == acc2, "lookup identity must close"
    return rhs, mults, lhs
