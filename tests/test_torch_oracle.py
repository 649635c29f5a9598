"""The port's host oracles: its own C++ oracle (oracle/, built with g++ into
build/), its copy of ref_divisor and its field constants.

- the counterparts of test_oracle.py: the C++ oracle against Python ints and
  the port's pyref and ref_divisor (field ops, MSM on two curves, divisor
  witnesses with identities);
- the C++ oracle against the port's own field, curve and merge-tree code on
  the CPU (plain versions): mont_mul, mont_addsub, FF.inv, best_multiexp and
  compute_divisor_witness_partial;
- the port's ref_divisor against the JAX package's at one small shape (host
  ints, no JAX graph);
- the port's roots of unity against the four committed fft_precomp tables;
- the build: at first use into build/, never into the JAX package.

Integer arithmetic: every comparison is exact."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from halo2_liam_eagen_msm_tpu_torch import divisor as D
from halo2_liam_eagen_msm_tpu_torch.convert import JPoint, limbs_from_numpy, limbs_to_numpy
from halo2_liam_eagen_msm_tpu_torch.fields import FIELDS, GRUMPKIN, PALLAS, PALLAS_FP, R
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_mont_limbs, mont_limbs_to_ints
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.ops.ff import ff
from halo2_liam_eagen_msm_tpu_torch.ops.msm import msm_ints
from halo2_liam_eagen_msm_tpu_torch.ops.poly import Poly
from halo2_liam_eagen_msm_tpu_torch.utils import pyref, ref_divisor

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DATA = os.path.join(ROOT, "halo2_liam_eagen_msm_tpu", "data")


@pytest.fixture(scope="module")
def orc():
    from halo2_liam_eagen_msm_tpu_torch import oracle

    oracle.build()
    return oracle


def closing_points(rng, curve, n, sprinkle_after=False):
    """n points, the identity at position 1, and their negated sum; with
    sprinkle_after, the identity is planted after the sum is taken, so the
    list no longer closes."""
    pts = pyref.random_points(rng, curve, n)
    if not sprinkle_after:
        pts[1] = None
    s = None
    for p in pts:
        s = pyref.ec_add(s, p, curve)
    pts = pts + [pyref.ec_neg(s, curve)]
    pts[1] = None
    return pts


def test_ff_ops(orc, rng):
    spec = PALLAS_FP
    xs = [rng.randrange(spec.p) for _ in range(64)]
    ys = [rng.randrange(spec.p) for _ in range(64)]
    xs[:2] = [0, spec.p - 1]
    ys[:2] = [spec.p - 1, spec.p - 1]
    assert orc.ff_mul(spec, xs, ys) == [x * y % spec.p for x, y in zip(xs, ys)]
    assert orc.ff_add(spec, xs, ys) == [(x + y) % spec.p for x, y in zip(xs, ys)]
    assert orc.ff_inv(spec, xs) == [
        pow(x, spec.p - 2, spec.p) if x else 0 for x in xs
    ]


@pytest.mark.parametrize("curve", [PALLAS, GRUMPKIN], ids=lambda c: c.name)
def test_msm_agrees(orc, curve, rng):
    n = 8
    pts = pyref.random_points(rng, curve, n)
    pts[3] = None
    sc = [rng.randrange(curve.scalar_field.p) for _ in range(n)]
    sc[0] = 0
    assert orc.ec_msm(curve, sc, pts) == pyref.ec_msm(sc, pts, curve)


def test_divisor_witness_agrees(orc, rng):
    """C++ witness coefficients == the port's host oracle, with an identity
    planted in a closing list (the output is then not the identity)."""
    curve = PALLAS
    for n in (4, 7, 10):
        pts = closing_points(rng, curve, n - 1, sprinkle_after=True)
        ca, cb, cout = orc.divisor_witness(curve, pts)
        hrf, hout = ref_divisor.divisor_witness_host(curve, pts)
        assert cout == hout
        assert ca == hrf.a.coeffs, f"a coeffs n={n}"
        assert cb == hrf.b.coeffs, f"b coeffs n={n}"


def test_field_kernels_plain_equal_oracle(orc, rng):
    """mont_mul, mont_addsub (add and subtract) and FF.inv on CPU tensors
    (the kernels' plain versions) == the C++ oracle, as canonical ints; 0, 1
    and p - 1 among the values."""
    spec = PALLAS_FP
    p = spec.p
    xs = [0, 1, p - 1, p - 1, 1] + [rng.randrange(p) for _ in range(59)]
    ys = [p - 1, p - 1, p - 1, 1, 0] + [rng.randrange(p) for _ in range(59)]
    a = limbs_from_numpy(ints_to_mont_limbs(xs, spec), "cpu")
    b = limbs_from_numpy(ints_to_mont_limbs(ys, spec), "cpu")

    def ints(t):
        return mont_limbs_to_ints(limbs_to_numpy(t), spec)
    assert ints(CF.mont_mul_plain(spec, a, b)) == orc.ff_mul(spec, xs, ys)
    assert ints(CF.mont_addsub_plain(spec, False, a, b)) == orc.ff_add(spec, xs, ys)
    assert ints(CF.mont_addsub_plain(spec, True, a, b)) == orc.ff_add(
        spec, xs, [(-y) % p for y in ys])
    assert ints(ff(spec).inv(a)) == orc.ff_inv(spec, xs)


@pytest.mark.parametrize("curve", [PALLAS, GRUMPKIN], ids=lambda c: c.name)
def test_best_multiexp_equals_oracle(orc, curve, rng):
    """The port's best_multiexp on the CPU, full-width scalars (0, 1 and
    q - 1 among them), an identity and a repeated point == the C++ MSM."""
    n = 16
    pts = pyref.random_points(rng, curve, n)
    pts[5], pts[9] = None, pts[8]
    q = curve.scalar_field.p
    sc = [rng.randrange(q) for _ in range(n)]
    sc[:3] = [0, 1, q - 1]
    assert msm_ints(curve, sc, pts, c=4, device="cpu") == orc.ec_msm(curve, sc, pts)


@pytest.mark.parametrize("n", [4, 9, 33])
def test_merge_tree_equals_oracle(orc, rng, n):
    """The port's merge tree on the CPU == the C++ divisor witness,
    coefficient for coefficient (the tree pads its vectors with zeros)."""
    curve = PALLAS
    pts = closing_points(rng, curve, n - 1)
    wtns, out = D.compute_divisor_witness_partial(curve, ec(curve).points_from_ints(pts, "cpu"))
    ca, cb, cout = orc.divisor_witness(curve, pts)
    a = Poly.from_device(curve.field, wtns.a).coeffs
    b = Poly.from_device(curve.field, wtns.b).coeffs
    assert a[:len(ca)] == ca and not any(a[len(ca):])
    assert b[:len(cb)] == cb and not any(b[len(cb):])
    assert cout is None and bool(ec(curve).is_identity(JPoint(*(c[None] for c in out)))[0])


def test_ref_divisor_equals_jax_package(rng):
    """The port's copy of ref_divisor == the JAX package's, on host ints
    (its Poly is host code: no JAX graph is built)."""
    from halo2_liam_eagen_msm_tpu import fields as JF
    from halo2_liam_eagen_msm_tpu.utils import ref_divisor as jax_ref

    pts = closing_points(rng, PALLAS, 6)
    mine, mout = ref_divisor.divisor_witness_host(PALLAS, pts)
    theirs, tout = jax_ref.divisor_witness_host(JF.PALLAS, pts)
    assert mine.a.coeffs == theirs.a.coeffs and mine.b.coeffs == theirs.b.coeffs
    assert mout == tout
    assert ref_divisor.linefunc_ints(PALLAS, pts[0], pts[0]) == \
        jax_ref.linefunc_ints(JF.PALLAS, pts[0], pts[0])


@pytest.mark.parametrize("name", ["pallas_fp", "vesta_fp", "bn254_fr", "bn254_fq"])
def test_roots_of_unity_equal_fft_precomp(name):
    """root_of_unity, omega_pow, omega_pow_inv and half_pow of the port's
    FieldSpec == the committed fft_precomp table, as ints and as Montgomery
    bytes."""
    with open(os.path.join(JAX_DATA, f"{name}_fft_precomp.json")) as fh:
        data = json.load(fh)
    spec = FIELDS[name]
    p = spec.p
    assert int(data["modulus"], 16) == p and data["two_adicity"] == spec.s
    assert int(data["root_of_unity"], 16) == spec.root_of_unity
    for key, fn in (("omega_pow", spec.omega_pow), ("omega_pow_inv", spec.omega_pow_inv),
                    ("half_pow", spec.half_pow)):
        assert len(data[key]) > 0
        for i, (v, mont_bytes) in enumerate(zip(data[key], data[key + "_mont_bytes"])):
            assert int(v, 16) == fn(i), f"{key}[{i}]"
            mont = fn(i) * R % p
            assert mont_bytes == [(mont >> (8 * k)) & 0xFF for k in range(32)], f"{key}[{i}]"


def test_build_at_first_use_into_build_dir(orc):
    """Importing the oracle builds nothing; build() writes the library into
    the checkout's build/, not into the JAX package."""
    probe = ("import sys, subprocess\n"
             "calls = []\n"
             "real = subprocess.run\n"
             "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
             "import halo2_liam_eagen_msm_tpu_torch.oracle as o\n"
             "print('CALLS', len(calls), o.BUILD_INFO)\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0 and "CALLS 0 {}" in proc.stdout, proc.stdout + proc.stderr
    path = orc.build()
    assert path.parent == Path(ROOT, "build")
    assert path.name.startswith("liboracle_") and path.exists()
    assert orc.BUILD_INFO["path"] == str(path)
