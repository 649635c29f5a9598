"""The benchmark's yardstick on the CPU: the harness's inputs and the plain
reference against the port and its oracles, and what they import.

    python -m pytest benchmark/test_benchmark_reference.py -q"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bounds
import harness
import inputs
from reference import divisor as RD
from reference.check import Counts, Decoder, Expected, limb_ints
from reference.curve import Curve

HERE = Path(__file__).resolve().parent
CFG = harness.Bench(HERE.parent).config("pallas_2e16")
C = Curve.from_config(CFG)


def test_curve_constants_are_the_ports():
    from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
    assert (C.p, C.q, C.a, C.b) == (PALLAS.field.p, PALLAS.scalar_field.p, PALLAS.a, PALLAS.b)
    assert C.g == (PALLAS.gen_x, PALLAS.gen_y) and C.on_curve(C.g)


def test_curve_against_the_ports_oracle():
    from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
    from halo2_liam_eagen_msm_tpu_torch.utils import pyref
    A, B = inputs.line_points(C, 11)
    for k in (0, 1, 2, 5, 2**20 + 3, C.q - 1):
        assert C.mul(A, k) == pyref.ec_mul(A, k, PALLAS)
    assert C.add(A, B) == pyref.ec_add(A, B, PALLAS)
    assert C.add(A, A) == pyref.ec_add(A, A, PALLAS)
    assert C.add(A, C.neg(A)) is None


def test_line_of_points():
    A, B = inputs.line_points(C, 2**31 + 5)
    xs, ys = C.affine_line(A, B, 300)
    for j in (0, 1, 2, 3, 127, 128, 129, 255, 256, 299):
        assert (xs[j], ys[j]) == C.add(A, C.mul(B, j))
    assert len(set(xs)) == 300


@pytest.mark.parametrize("base", [2, 5])
def test_negbase_against_the_port(base):
    from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_limbs
    from halo2_liam_eagen_msm_tpu_torch.negbase import negbase_decompose_batch
    w = inputs.scalar_pool(2**31 + 99, 1, 2048)[0]
    w[0] = 0
    w[1] = [1, 0, 0, 0]
    w[2] = [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF]
    d = 56 if base == 5 else 130
    mine = inputs.negbase_digits(w, base, d).numpy()
    port = negbase_decompose_batch(ints_to_limbs(inputs.words_to_ints(w)), base, d)
    assert np.array_equal(mine, port[:, ::-1].T)


def test_pow_products_is_the_ports():
    from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff
    for e in (C.p - 2, C.q - 2, 5, 2**20 + 7):
        assert bounds.pow_products(e) == cuda_ff.pow_products(e)


def test_expected_carries_against_the_ports_oracle():
    """The reference's closed forms against pyref on 12 points: the final
    carry is the MSM, and the carry recurrence ends there."""
    from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
    from halo2_liam_eagen_msm_tpu_torch.utils import pyref
    A, B = inputs.line_points(C, 3)
    xs, ys = C.affine_line(A, B, 12)
    w = inputs.scalar_pool(3, 1, 12)[0]
    digits = inputs.negbase_digits(w, 5, 56).numpy()
    exp = Expected(C, A, B, 5, w, digits)
    assert exp.msm == pyref.ec_msm(inputs.words_to_ints(w), list(zip(xs, ys)), PALLAS)
    assert exp.final == exp.msm
    k = 30
    s_k = None
    for j in range(12):
        s_k = C.add(s_k, C.mul((xs[j], ys[j]), int(digits[k, j])))
    assert exp.new[k] == C.add(C.mul(C.neg(exp.prev[k]), 5), s_k)


def _slot_lists(seed: int):
    """Lists of points summing to the identity, with the cases the tree
    meets: identities, tangents (a repeated point), opposite points, odd
    lengths."""
    rng = np.random.default_rng(seed)
    for n in (3, 4, 5, 8, 9, 13, 16):
        pts = [None if rng.random() < 0.2 else C.mul(C.g, int(rng.integers(1, 60)))
               for _ in range(n)]
        if pts[0] is not None:
            pts[1] = pts[0]
            pts[3 % n] = C.neg(pts[0]) if n % 2 else pts[3 % n]
        s = None
        for q in pts:
            s = C.add(s, q)
        yield pts + [C.neg(s)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_divisor_scale_and_weil_against_the_ports_oracle(seed):
    """The reference's scale (the product of the tree's lines' leading
    coefficients) is the leading coefficient of the port's host oracle's
    witness, and Weil's identity holds for it, with the sign (-1)^m."""
    from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
    from halo2_liam_eagen_msm_tpu_torch.utils.ref_divisor import divisor_witness_host
    check = RD.DivisorCheck(C, C.g, C.g, 5, 0, 11 + seed, 97 + seed)
    lam, mu = check.line
    for pts in _slot_lists(seed):
        w, out = divisor_witness_host(PALLAS, pts)
        a, b = [c % C.p for c in w.a.coeffs], [c % C.p for c in w.b.coeffs]
        m = sum(q is not None for q in pts)
        lead = a[m // 2] if m % 2 == 0 else b[(m - 3) // 2]
        root, lc = RD.tree(C, pts + [None] * (len(pts) % 2), True)
        assert out is None and root is None and lc == lead
        prod = 1
        for q in pts:
            if q is not None:
                prod = prod * (q[1] - lam * q[0] - mu) % C.p
        lhs = 1
        for (x, y), va, vb in zip(check.qs, check.evals(inputs.mont_limbs(a, C.p)),
                                  check.evals(inputs.mont_limbs(b, C.p))):
            lhs = lhs * (va + y * vb) % C.p
        r3 = pow((1 << 256) % C.p, 3, C.p)
        assert lhs == (-1) ** m * r3 * pow(lead, 3, C.p) * prod % C.p


def test_divisor_evals_against_horner():
    rng = np.random.default_rng(5)
    check = RD.DivisorCheck(C, C.g, C.g, 5, 0, 3, 4)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % C.p for _ in range(300)] + [0, 0]
    got = check.evals(inputs.mont_limbs(coeffs, C.p))
    r = (1 << 256) % C.p
    for (x, _), v in zip(check.qs, got):
        assert v == sum(c * r * pow(x, i, C.p) for i, c in enumerate(coeffs)) % C.p


@pytest.mark.parametrize("parallel,n", [(False, 122), (False, 126), (True, 126)])
def test_divisor_blocks_are_the_whole_tree(monkeypatch, parallel, n):
    """The reference split into blocks of slots (in worker processes, or
    not) gives the sum, scale and product of l of one tree over every slot
    of a round."""
    if parallel:
        monkeypatch.setattr(RD, "PARALLEL_MIN_SLOTS", 0)
    base = 5
    A, B = inputs.line_points(C, 21)
    w = inputs.scalar_pool(21, 1, n)[0]
    exp = Expected(C, A, B, base, w, inputs.negbase_digits(w, base, 56).numpy())
    check = RD.DivisorCheck(C, A, B, base, n, 5, 6)
    lam, mu = check.line
    rounds = [(exp, k) for k in (0, 1, 30, 55)]
    for (e, k), got in zip(rounds, check.reference(rounds)):
        pts = [e.slot(k, s) for s in range(base + n + 1)]
        prod = 1
        for q in pts:
            if q is not None:
                prod = prod * (q[1] - lam * q[0] - mu) % C.p
        assert got == (*RD.tree(C, pts + [None] * (len(pts) % 2), True), prod)


def test_decoder_counts_non_canonical_limbs():
    c = Counts()
    dec = Decoder(C, c)
    vals = inputs.mont_limbs([0, 1, C.p - 1], C.p)
    assert dec.ints(vals) == [0, 1, C.p - 1] and c["limbs_noncanonical"] == 0
    bad = vals.copy()
    bad[0, 0] = 1 << 16
    dec.ints(bad)
    assert c["limbs_noncanonical"] == 1
    p_limbs = np.frombuffer(C.p.to_bytes(32, "little"), dtype="<u2").astype(np.int32)
    dec.ints(p_limbs.reshape(1, 16))
    assert c["limbs_noncanonical"] == 2
    assert limb_ints(p_limbs)[0] == [C.p]


def test_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "import reference.check, reference.curve; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'halo2_liam_eagen_msm_tpu', 'halo2_liam_eagen_msm_tpu_torch', 'torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code, str(HERE)], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"halo2_liam_eagen_msm_tpu_torch": 0,
                                         "halo2_liam_eagen_msm_tpu_torch.ops": 0,
                                         "jaxlib_like": 0, "numpy": 0})
    assert harness.forbidden_modules() == []
    sys.modules.update({"jax.numpy": 0, "halo2_liam_eagen_msm_tpu.ops": 0, "flax": 0})
    assert harness.forbidden_modules() == ["flax", "halo2_liam_eagen_msm_tpu", "jax"]
