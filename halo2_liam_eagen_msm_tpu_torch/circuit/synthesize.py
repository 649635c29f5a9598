"""Full-instance assembly — the completion of the reference's unfinished
`synthesize` (the reference's config.rs:635-683 unconditionally returns
Err(Error::Synthesis); SURVEY.md §2.7 calls it the WIP frontier).

Builds every column of a LiamMSM instance over one grid and forward-solves
the c column from the gate equations themselves:

  b column  — B1 scalar boxes (witness.scalar_box_column) at the box rows the
              layout's selectors address; lookup-table rows carry NEGATED
              multiplicities of the cells the rhs lookup gates cover (so the
              log-derivative identity closes by construction).
  a column  — the per-round Eagen witness polynomial coefficients (host
              argument pipeline), streamed batch-by-batch: batch k holds
              round k's RegularFunction a||b coefficient vector.  The
              reference never finalized this placement (synthesize is
              unfinished); the stream layout is ours and documented here.
  c column  — SOLVED cell by cell from the active gates:
                * poly RLC accumulators in each batch tail (config.rs:246-283)
                * log-derivative lookup running sums threading through the
                  scalar boxes, bridged across bucket rows and box/batch
                  boundaries by the b_skip/c_skip rotations (config.rs:402-437)
                * the rhs-main evaluation walk over bucket rows at the
                  challenge-derived point (config.rs:504-538)
                * copy-from-b rows at box scalar rows (config.rs:562-568)
                * a 3-row arithmetic region exercising the arith gate
                  (config.rs:232-244)
              Every gate is LINEAR in its latest-row c cell, so each cell is
              solved from two trial evaluations; cells constrained twice are
              cross-checked, cells never constrained default to 0.

The solver doubles as a layout-consistency check: it asserts that no two
gates demand different values for the same cell — precisely what the
reference's selector algebra promises but (being non-compiling) never
demonstrated.
"""

from __future__ import annotations

import dataclasses

from ..fields import CurveSpec
from ..negbase import negbase_decompose
from ..utils import pyref
from ..utils.ref_divisor import divisor_witness_host
from . import gates as G
from .checker import Grid
from .layout import Layout, build_layout
from .params import Params
from .witness import scalar_box_column


# ---------------------------------------------------------------------------
# host-side argument witness (rounds of RegularFunction coefficients)
# ---------------------------------------------------------------------------

def host_round_slots(curve: CurveSpec, scalars, pts, base: int,
                     num_digits: int):
    """The point lists of compute_lhs_witness's digit rounds
    (the reference's argument_witness_calc.rs:108-130) on host ints:
    returns (carry_point, [per-round list of None/(x, y) points]), most-
    significant round first: base copies of -carry_prev, the points of the
    nonzero digits, and -carry_new."""
    digits = []
    for sc in scalars:
        d = negbase_decompose(sc, base)
        d = d + [0] * (num_digits - len(d))
        digits.append(list(reversed(d)))  # most-significant first
    mults = []
    for pt in pts:
        row, acc = [], pt
        for _ in range(base - 1):
            row.append(acc)
            acc = pyref.ec_add(acc, pt, curve)
        mults.append(row)
    carry = None
    slots = []
    for i in range(num_digits):
        tmp = []
        if carry is not None:
            for _ in range(base):
                tmp.append(pyref.ec_neg(carry, curve))
            carry = pyref.ec_mul(pyref.ec_neg(carry, curve), base, curve)
        for j, sc_digits in enumerate(digits):
            d = sc_digits[i]
            if d != 0:
                tmp.append(mults[j][d - 1])
                carry = (mults[j][d - 1] if carry is None
                         else pyref.ec_add(carry, mults[j][d - 1], curve))
        if carry is not None:
            tmp.append(pyref.ec_neg(carry, curve))
        slots.append(tmp)
    return carry, slots


def host_round_polys(curve: CurveSpec, scalars, pts, base: int,
                     num_digits: int):
    """The digit-round loop of compute_lhs_witness
    (the reference's argument_witness_calc.rs:108-130) on host ints:
    returns (carry_point, [per-round (a_coeffs, b_coeffs)]) most-significant
    round first, exactly the reference's post-reversal order (:132): each
    round's witness is that of its host_round_slots list."""
    carry, slots = host_round_slots(curve, scalars, pts, base, num_digits)
    rounds = []
    for tmp in slots:
        wtns, out = divisor_witness_host(curve, tmp)
        assert out is None, "divisor output must be the identity"
        rounds.append((list(wtns.a.coeffs), list(wtns.b.coeffs)))
    return carry, rounds


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Assembly:
    grid: Grid
    layout: Layout
    gates: dict           # name -> gate callable (p, view)
    solved_rows: dict     # name -> rows where the gate actively constrained c
    arith_rows: list
    point: tuple          # (ax, ay, t, f) challenge point


def _box_rows(layout: Layout):
    """Row of each scalar box's first cell, box index order."""
    ext, par = layout.ext, layout.params
    return [
        (i // ext.sc_in_batch) * ext.batch_size
        + (i % ext.sc_in_batch) * ext.sc_box_size
        for i in range(par.num_pts)
    ]


def assemble(curve: CurveSpec, params: Params, scalars, v: int, ch: int,
             r: int) -> Assembly:
    """Build all columns for `scalars` under challenges (v, ch, r)."""
    layout = build_layout(curve, params)
    ext = layout.ext
    p = curve.field.p
    nrows = layout.nrows + 8  # room for the arith region
    num_limbs, base = ext.num_limbs, params.base

    # ---- b column: scalar boxes + lookup multiplicities ----
    b = [0] * nrows
    for i, row in enumerate(_box_rows(layout)):
        col = scalar_box_column(curve, scalars[i], base, ext.num_digits,
                                params.logtable)
        for k, val in enumerate(col):
            b[row + k] = val

    # ---- a column: witness polynomial coefficient stream ----
    carry, rounds = host_round_polys(curve, scalars,
                                     [pt for pt in params.pts],
                                     base, ext.num_digits)
    a = [0] * nrows
    for k, (ca, cb) in enumerate(rounds):
        rowbase = k * ext.batch_size
        stream = list(ca) + list(cb)
        for j, coeff in enumerate(stream[:ext.batch_size]):
            if rowbase + j < nrows:
                a[rowbase + j] = coeff % p

    # ---- fixed columns ----
    grid = Grid(nrows, p)
    grid.set_col("a", a)
    grid.set_col("b", b)
    for name in ("s1poly", "s2poly", "s3poly", "s0sc", "s1sc", "s2sc",
                 "s3sc", "s4sc", "s1t", "s2t"):
        grid.set_col(name, getattr(layout, name).dense(nrows))
    grid.set_col("table", layout.table.dense(nrows))

    # copy-from-b at every box scalar row (c is otherwise unconstrained
    # there: the lookup chains bridge across scalar rows by construction)
    s_copy = [0] * nrows
    for row in _box_rows(layout):
        s_copy[row] = 1
    grid.set_col("s_copy_from_b", s_copy)

    # a 3-row arithmetic region at the tail: c[i] = b[i] + c[i-3]*c[i-2]
    # + c[i-1]*table[i] over live values (exercises config.rs:232-244)
    arith_rows = [nrows - 3, nrows - 2, nrows - 1]
    s_arith = [0] * nrows
    for row in arith_rows:
        s_arith[(row - 1) % nrows] = 1  # gate reads s_arith at rotation -1
    grid.set_col("s_arith", s_arith)
    bcol = grid.cols["b"]
    for row, sc in zip(arith_rows, scalars[:3]):
        bcol[row] = sc % p

    # ---- challenge point ----
    ax, ay, t, f = G.derive_point(curve, ch)

    # ---- lookup multiplicities from the rhs gates' actual coverage ----
    s4 = grid.cols["s4sc"]; s2 = grid.cols["s2sc"]
    s1 = grid.cols["s1sc"]; s0 = grid.cols["s0sc"]
    covered = []
    for row in range(nrows):
        if s4[row] or s2[row] or (s1[row] and not s0[row]):
            covered.append(grid.cols["b"][(row + 1) % nrows])
    mult: dict[int, int] = {}
    for cell in covered:
        mult[cell] = mult.get(cell, 0) + 1
    # every covered cell must be a table entry (witness.py's guarantee)
    entries = {grid.cols["table"][row] for row in layout.table_map}
    for cell in covered:
        assert cell in entries, f"looked-up cell {cell} not in table"
    bcol = grid.cols["b"]
    for row in layout.table_map:
        bcol[row] = (-mult.get(grid.cols["table"][row], 0)) % p

    # ---- gate set (closures over challenges/params) ----
    gate_fns = {
        "arith": G.gate_arith,
        "poly_rlc": lambda pp, vw: G.gate_poly_rlc(
            pp, vw, r, params.poly_fan_in, ext.batch_size, ext.c_skip),
        "b": lambda pp, vw: G.gate_b(pp, vw, base, num_limbs,
                                     params.logtable),
        "lookup": lambda pp, vw: G.gate_lookup(pp, vw, v, ext.b_skip,
                                               ext.c_skip),
        "rhs_main": lambda pp, vw: G.gate_rhs_main(
            pp, vw, ax, ay, t, f, ext.sc_box_size, ext.b_skip,
            num_limbs, base),
        "copy_from_b": G.gate_copy_from_b,
    }

    # ---- forward-solve the c column ----
    # (gate name, active predicate at row, unknown-cell rotation)
    c = [0] * nrows
    grid.cols["c"] = c
    solved: dict[int, str] = {}
    solved_rows: dict[str, list] = {k: [] for k in gate_fns}

    sp = {nm: grid.cols[nm] for nm in
          ("s1poly", "s2poly", "s3poly", "s0sc", "s1sc", "s2sc", "s4sc",
           "s1t", "s2t", "s_copy_from_b", "s_arith")}

    def skip_sel(row):
        val = 0
        for i in range(1, base):
            val += sp["s0sc"][(row - i * (num_limbs + 1)) % nrows]
        return val

    def active(row):
        """Gates constraining a c cell at `row`, with the unknown's rot."""
        out = []
        if sp["s1poly"][row] or sp["s2poly"][row] or sp["s3poly"][row]:
            out.append(("poly_rlc", 0))
        if sp["s4sc"][row] or sp["s2sc"][row] or (
                sp["s1sc"][row] and not sp["s0sc"][row]):
            out.append(("lookup", 1))
        if sp["s1t"][row] or sp["s2t"][row]:
            out.append(("lookup", 0))
        if sp["s2sc"][row] or skip_sel(row):
            out.append(("rhs_main", 0))
        if sp["s_copy_from_b"][row]:
            out.append(("copy_from_b", 0))
        if sp["s_arith"][(row - 1) % nrows]:
            out.append(("arith", 0))
        return out

    for row in range(nrows):
        for name, rot in active(row):
            cell = (row + rot) % nrows
            gate = gate_fns[name]
            view = grid.view(row)
            if cell in solved:
                g = gate(p, view) % p
                assert g == 0, (
                    f"gate '{name}' at row {row} conflicts with the value of "
                    f"c[{cell}] solved by '{solved[cell]}'")
                continue
            # gate is linear in c[cell]: g = k*x + b0
            keep = c[cell]
            c[cell] = 0
            b0 = gate(p, view) % p
            c[cell] = 1
            k = (gate(p, view) - b0) % p
            if k == 0:
                c[cell] = keep
                assert b0 == 0, f"gate '{name}' unsatisfiable at row {row}"
                continue
            c[cell] = (-b0) * pow(k, p - 2, p) % p
            solved[cell] = name
            solved_rows[name].append(row)

    # lookup-only identity: the final rhs chain totals equal the final lhs
    # totals when multiplicities count exactly the covered cells — checked
    # in tests via the reference recomputation (not assumed here).
    return Assembly(grid=grid, layout=layout, gates=gate_fns,
                    solved_rows=solved_rows, arith_rows=arith_rows,
                    point=(ax, ay, t, f))
