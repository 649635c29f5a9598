"""The port's circuit/ (params, layout, gates, checker, witness, synthesize)
on host Python ints: the counterparts of test_circuit.py,
test_synthesize.py and test_witness_circuit.py, and the port's assembly
against the JAX package's, column for column (host ints only: no JAX graph).

Integer arithmetic over the field: every comparison is exact."""

import random

import pytest
import torch

from halo2_liam_eagen_msm_tpu_torch import negbase
from halo2_liam_eagen_msm_tpu_torch.circuit import checker, gates, layout, params, witness
from halo2_liam_eagen_msm_tpu_torch.circuit.params import Params
from halo2_liam_eagen_msm_tpu_torch.circuit.synthesize import (
    _box_rows, assemble, host_round_polys, host_round_slots)
from halo2_liam_eagen_msm_tpu_torch.fields import GRUMPKIN, PALLAS
from halo2_liam_eagen_msm_tpu_torch.negbase import table_entry_by_id
from halo2_liam_eagen_msm_tpu_torch.utils import pyref, ref_divisor

torch.set_num_threads(1)


def mk_params(rng, curve, num_pts=4, base=5, logtable=15, poly_fan_in=11,
              batch_offset=0):
    pts = tuple(pyref.random_points(rng, curve, num_pts))
    return params.Params(num_pts, base, logtable, poly_fan_in, batch_offset, pts)


# ----------------------------------------------------------- test_circuit.py

def test_params_check(rng):
    """params_check at the layout.md:11 parameter point: base 5 -> 55
    digits, fan-in 11 -> skip 5, 2 boxes of 25 per batch."""
    curve = PALLAS
    pr = mk_params(rng, curve)
    ext = params.params_check(curve, pr)
    assert ext.num_digits == 55            # log_25(p) for the 255-bit modulus
    assert ext.num_limbs == 4              # ceil(55/15)
    assert ext.sc_box_size == 25           # (4+1)*5
    assert ext.batch_size == 55
    assert ext.c_skip == 5                 # ceil(55/11)
    assert ext.sc_in_batch == 2            # (55-5)//25
    assert ext.b_skip == 5


def test_old_const_assertions():
    """The first-generation layout invariants hold for Grumpkin (the
    reference's concrete curve)."""
    params.old_const_assertions(GRUMPKIN)


def test_layout_selectors(rng):
    curve = PALLAS
    pr = mk_params(rng, curve)
    ly = layout.build_layout(curve, pr)
    ext = ly.ext
    # s1poly: exactly one activation per batch, at batch_size - c_skip
    rows = [r for r, v in ly.s1poly.data.items() if v]
    assert all(r % ext.batch_size == ext.batch_size - ext.c_skip for r in rows)
    # s1sc activations are scalar-box starts
    rows = [r for r, v in ly.s1sc.data.items() if v]
    assert all(
        (r % ext.batch_size) % ext.sc_box_size == 0
        and r % ext.batch_size < ext.sc_box_size * ext.sc_in_batch
        for r in rows
    )
    # the lookup table hosts 2^logtable entries and starts after a buffer batch
    assert len(ly.table_map) == 1 << pr.logtable
    first = ly.table_map[0]
    assert first == (params.div_ceil(pr.num_pts, ext.sc_in_batch) + 1) * ext.batch_size


def test_b_gate_on_witness_grid(rng):
    """The b gate's scalar-from-buckets and limb-integrity identities hold on
    a column populated from prepare_scalar_witness grids."""
    curve = PALLAS
    base, logtable = 5, 4
    num_digits = 56
    num_limbs = (num_digits + logtable - 1) // logtable  # 14
    p = curve.field.p
    box = (num_limbs + 1) * base

    sc = rng.randrange(1 << 64)
    grid = negbase.prepare_scalar_witness(sc, base, num_digits, logtable)
    col_b = [grid[i][j].value for i in range(base) for j in range(num_limbs + 1)]
    g = checker.Grid(box * 2, p)  # extra space so rotations stay in-bounds
    g.set_col("b", col_b)
    g.set_col("s1sc", [1] + [0] * (2 * box - 1))
    g.set_col("s2sc", [
        1 if (0 < i < box and i % (num_limbs + 1) == 0) else 0
        for i in range(2 * box)
    ])
    g.set_col("s3sc", [1 if 0 < i < num_limbs + 1 else 0 for i in range(2 * box)])

    gate = lambda pp, view: gates.gate_b(pp, view, base, num_limbs, logtable)
    bad = g.eval_gate(gate, rows=range(box))
    # bucket-from-limbs (s2sc rows) vanishes only if the limb cells
    # accumulated digit weights by i//logtable; the replicated i%logtable
    # quirk makes them fail, so only the other two are asserted
    s1_bad = [r for r in bad if g.cols["s1sc"][r]]
    s3_bad = [r for r in bad if g.cols["s3sc"][r]]
    assert not s1_bad, "scalar-from-buckets identity must hold"
    assert not s3_bad, "limb-integrity identity must hold"


def test_challenge_postprocessing(rng):
    """Witness-side and gate-side challenge->point derivations agree."""
    curve = PALLAS
    p = curve.field.p
    for _ in range(5):
        ch = rng.randrange(p)
        ax, ay, t, f = gates.derive_point(curve, ch)
        assert (ay * ay - gates.curve_rhs(curve, ax)) % p == 0
        # the slope is the tangent's: 2*ay*t == 3*ax^2 + a
        assert (2 * ay * t) % p == (3 * ax * ax + curve.a) % p
        assert f == (t * ax - ay) % p
        assert (ax, ay, t, f) == gates.derive_point(curve, ch)


def test_boundary_rotations(rng):
    """A toy gate s[0]*(a[0]-a[-1]) with wrap-around rotations holds where
    selected, and fails once broken."""
    p = PALLAS.field.p
    n = 32
    g = checker.Grid(n, p)
    vals = [rng.randrange(p) for _ in range(n)]
    vals[5] = vals[4]
    g.set_col("a", vals)
    g.set_col("s", [1 if i == 5 else 0 for i in range(n)])

    def gate(pp, view):
        return view("s", 0) * (view("a", 0) - view("a", -1)) % pp

    g.assert_satisfied({"boundary": gate})
    g.set_col("a", [v + (1 if i == 5 else 0) for i, v in enumerate(vals)])
    with pytest.raises(AssertionError):
        g.assert_satisfied({"boundary": gate})


def test_lookup_log_derivative_identity(rng):
    """For any challenge v, the sum over looked-up cells of 1/(v - cell)
    equals the sum over table entries of multiplicity/(v - entry)."""
    curve = PALLAS
    p = curve.field.p
    base, logtable = 5, 4
    table = [negbase.table_entry_by_id(base, i, curve.field) for i in range(1 << logtable)]
    ids = [rng.randrange(1 << logtable) for _ in range(50)]
    cells = [table[i] for i in ids]
    mult = [ids.count(i) for i in range(1 << logtable)]
    v = rng.randrange(p)
    lhs = sum(pow(v - c, p - 2, p) for c in cells) % p
    rhs = sum(m * pow(v - t, p - 2, p) for m, t in zip(mult, table)) % p
    assert lhs == rhs


# -------------------------------------------------------- test_synthesize.py

def _instance_inputs():
    curve = PALLAS
    rng = random.Random(0xC1AC)
    pts = tuple(pyref.random_points(rng, curve, 4))
    prm = Params(num_pts=4, base=5, logtable=4, poly_fan_in=10, batch_offset=36, pts=pts)
    scalars = [rng.randrange(1, 1 << 60) for _ in range(4)]
    chals = tuple(rng.randrange(curve.field.p) for _ in range(3))
    return curve, prm, scalars, chals


@pytest.fixture(scope="module")
def instance():
    curve, prm, scalars, (v, ch, r) = _instance_inputs()
    return curve, prm, scalars, (v, ch, r), assemble(curve, prm, scalars, v, ch, r)


def test_all_gates_satisfied(instance):
    _, _, _, _, asm = instance
    asm.grid.assert_satisfied(asm.gates)


def test_every_gate_exercised(instance):
    """Each of the six gates constrained at least one cell or row."""
    _, _, _, _, asm = instance
    for name in ("poly_rlc", "lookup", "rhs_main", "copy_from_b", "arith"):
        assert asm.solved_rows[name], f"gate '{name}' never active"
    grid = asm.grid
    sel_rows = [i for i in range(grid.nrows)
                if grid.cols["s1sc"][i] or grid.cols["s2sc"][i] or grid.cols["s3sc"][i]]
    assert sel_rows
    assert not grid.eval_gate(asm.gates["b"], rows=sel_rows)


def test_copy_rows_carry_scaled_scalars(instance):
    curve, prm, scalars, _, asm = instance
    p = curve.field.p
    for i, row in enumerate(_box_rows(asm.layout)):
        assert asm.grid.cols["c"][row] == (-prm.base) * scalars[i] % p


def test_rhs_main_walk_matches_direct_sum(instance):
    """The bucket rows' accumulators == the Eagen RHS partial sums taken
    directly from the b and table cells: c[bucket] = c[previous] - b[bucket]
    * (Ax - Px) / (f + Py - t*Px), chained box by box."""
    curve, prm, _, _, asm = instance
    p = curve.field.p
    ax, ay, t, f = asm.point
    ext = asm.layout.ext
    grid = asm.grid
    nl = ext.num_limbs
    rows = _box_rows(asm.layout)
    for k in range(1, prm.base):
        acc = None
        for i, row in enumerate(rows):
            brow = row + k * (nl + 1)
            px = grid.cols["table"][brow]
            py = grid.cols["table"][brow + 1]
            b0 = grid.cols["b"][brow]
            denom = (f + py - t * px) % p
            inc = (-b0 * (ax - px) * pow(denom, p - 2, p)) % p
            if i == 0:
                acc = grid.cols["c"][(brow - ext.sc_box_size - ext.b_skip) % grid.nrows]
            acc = (acc + inc) % p
            assert grid.cols["c"][brow] == acc, (k, i, brow)


def test_lookup_identity_closes(instance):
    """The rhs chains' increments sum to the lhs multiplicities' sum."""
    curve, _, _, (v, _, _), asm = instance
    p = curve.field.p
    grid = asm.grid
    s4, s2 = grid.cols["s4sc"], grid.cols["s2sc"]
    s1, s0 = grid.cols["s1sc"], grid.cols["s0sc"]
    rhs_total = 0
    for row in range(grid.nrows):
        if s4[row] or s2[row] or (s1[row] and not s0[row]):
            cell = grid.cols["b"][(row + 1) % grid.nrows]
            rhs_total = (rhs_total + pow(v - cell, p - 2, p)) % p
    lhs_total = 0
    for row in asm.layout.table_map:
        m = (-grid.cols["b"][row]) % p
        tval = grid.cols["table"][row]
        lhs_total = (lhs_total + m * pow(v - tval, p - 2, p)) % p
    assert rhs_total == lhs_total


def test_carry_matches_msm_oracle(instance):
    """host_round_polys' carry == the Python-int MSM on the same inputs."""
    curve, prm, scalars, _, asm = instance
    carry, _ = host_round_polys(curve, scalars, list(prm.pts), prm.base,
                                asm.layout.ext.num_digits)
    assert carry == pyref.ec_msm(scalars, list(prm.pts), curve)


def test_round_slots_give_round_polys(instance):
    """host_round_slots' lists close (each sums to the identity) and their
    host witnesses are host_round_polys' rounds, the same carry; the a
    column streams round k's a||b from row k * batch_size, as far as the
    grid reaches."""
    curve, prm, scalars, _, asm = instance
    d = asm.layout.ext.num_digits
    carry, slots = host_round_slots(curve, scalars, list(prm.pts), prm.base, d)
    carry2, rounds = host_round_polys(curve, scalars, list(prm.pts), prm.base, d)
    assert carry == carry2 and len(slots) == len(rounds) == d
    bs = asm.layout.ext.batch_size
    for k, (tmp, (ca, cb)) in enumerate(zip(slots, rounds)):
        assert pyref.ec_msm([1] * len(tmp), tmp, curve) is None
        w, out = ref_divisor.divisor_witness_host(curve, tmp)
        assert out is None and (w.a.coeffs, w.b.coeffs) == (ca, cb)
        stream = (ca + cb)[:bs][:max(0, asm.grid.nrows - k * bs)]
        assert asm.grid.cols["a"][k * bs:k * bs + len(stream)] == stream


def test_assembly_equals_jax_package(instance):
    """The port's assemble == the JAX package's on the same ints: every
    column of the grid, the solved rows and the challenge point."""
    from halo2_liam_eagen_msm_tpu import fields as JF
    from halo2_liam_eagen_msm_tpu.circuit.params import Params as JParams
    from halo2_liam_eagen_msm_tpu.circuit.synthesize import assemble as jax_assemble

    curve, prm, scalars, (v, ch, r), asm = instance
    jprm = JParams(prm.num_pts, prm.base, prm.logtable, prm.poly_fan_in, prm.batch_offset,
                   prm.pts)
    theirs = jax_assemble(JF.PALLAS, jprm, scalars, v, ch, r)
    assert asm.grid.nrows == theirs.grid.nrows
    assert sorted(asm.grid.cols) == sorted(theirs.grid.cols)
    for name, col in asm.grid.cols.items():
        assert col == theirs.grid.cols[name], f"column {name}"
    assert asm.solved_rows == theirs.solved_rows
    assert asm.arith_rows == theirs.arith_rows and asm.point == theirs.point
    assert asm.layout.table_map == theirs.layout.table_map


# --------------------------------------------------- test_witness_circuit.py

BASE, NUM_DIGITS, LOGTABLE = 5, 56, 4
NUM_LIMBS = (NUM_DIGITS + LOGTABLE - 1) // LOGTABLE


def test_b_gates_satisfied(rng):
    curve = PALLAS
    p = curve.field.p
    box = (NUM_LIMBS + 1) * BASE
    for _ in range(5):
        sc = rng.randrange(1 << 112)
        col = witness.scalar_box_column(curve, sc, BASE, NUM_DIGITS, LOGTABLE)
        assert len(col) == box
        g = checker.Grid(2 * box, p)
        g.set_col("b", col)
        g.set_col("s1sc", [1] + [0] * (2 * box - 1))
        g.set_col("s2sc", [
            1 if (0 < i < box and i % (NUM_LIMBS + 1) == 0) else 0
            for i in range(2 * box)
        ])
        g.set_col("s3sc", [1 if 0 < i < NUM_LIMBS + 1 else 0 for i in range(2 * box)])
        gate = lambda pp, view: gates.gate_b(pp, view, BASE, NUM_LIMBS, LOGTABLE)
        g.assert_satisfied({"b": gate}, rows=range(box))
        # the scalar row carries (-BASE)*sc by construction
        assert col[0] == (-BASE) * sc % p


def test_cells_are_table_entries(rng):
    curve = PALLAS
    sc = rng.randrange(1 << 112)
    col = witness.scalar_box_column(curve, sc, BASE, NUM_DIGITS, LOGTABLE)
    ids, union = witness.box_lookup_ids(sc, BASE, NUM_DIGITS, LOGTABLE)
    for d in range(BASE - 1):
        for j in range(NUM_LIMBS):
            cell = col[(NUM_LIMBS + 1) * (d + 1) + 1 + j]
            assert cell == table_entry_by_id(BASE, ids[d][j], curve.field)
    for j in range(NUM_LIMBS):
        assert col[1 + j] == table_entry_by_id(BASE, union[j], curve.field)


def test_lookup_columns_close(rng):
    curve = PALLAS
    table = [table_entry_by_id(BASE, i, curve.field) for i in range(1 << LOGTABLE)]
    sc = rng.randrange(1 << 112)
    col = witness.scalar_box_column(curve, sc, BASE, NUM_DIGITS, LOGTABLE)
    # looked-up cells: every limb and integrity row of the box
    cells = [c for i, c in enumerate(col) if i % (NUM_LIMBS + 1) != 0]
    v = rng.randrange(curve.field.p)
    rhs, mults, lhs = witness.lookup_columns(curve, cells, table, v)
    assert rhs[-1] == lhs[-1]
    assert sum(mults) == len(cells)
