"""The port's copy of the frozen Rust-semantics divisor vectors
(data/golden_divisor_*.json) and of utils/rustsem.py, the counterparts of
test_rustsem.py.

The reference's witness coefficients depend on halo2curves' internal
Jacobian Z values (linefunc consumes (x*z, y, z^3) projective coordinates);
rustsem replicates that Z chain exactly and the golden files freeze its
output on a fixed input set.  Checks: the port's data files are the JAX
package's byte for byte; recompute == frozen; the divisor property; the
Rust-semantics witness equals the canonical affine-normalized witness times
ONE nonzero field constant; the canonical replica equals the port's merge
tree (on the CPU, n = 4) limb for limb.  Host ints: every comparison is
exact."""

import os
import random

import pytest
import torch

from halo2_liam_eagen_msm_tpu_torch import divisor as D
from halo2_liam_eagen_msm_tpu_torch.convert import limbs_to_numpy
from halo2_liam_eagen_msm_tpu_torch.fields import GRUMPKIN, PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import mont_limbs_to_ints
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.utils import pyref, rustsem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "halo2_liam_eagen_msm_tpu_torch", "data")
JAX_DATA = os.path.join(ROOT, "halo2_liam_eagen_msm_tpu", "data")

CURVES = {"grumpkin": GRUMPKIN, "pallas": PALLAS}


@pytest.mark.parametrize("name", ["grumpkin", "pallas"])
def test_golden_files_are_the_jax_packages(name):
    fname = f"golden_divisor_{name}.json"
    with open(os.path.join(DATA, fname), "rb") as a, open(os.path.join(JAX_DATA, fname), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["grumpkin", "pallas"])
def test_golden_divisor_frozen(name):
    curve = CURVES[name]
    pts, wa, wb = rustsem.load_golden(name)
    jac = [(x, y, 1) for (x, y) in pts]
    wtns, out = rustsem.compute_divisor_witness_partial(jac, curve)
    assert rustsem.jac_is_identity(out)
    assert wtns.a == wa and wtns.b == wb, \
        "Z-chain witness diverged from the frozen golden vector"


@pytest.mark.parametrize("name", ["grumpkin", "pallas"])
def test_golden_divisor_property(name):
    curve = CURVES[name]
    p = curve.field.p
    pts, wa, wb = rustsem.load_golden(name)
    w = rustsem.RustRF(wa, wb)
    for (x, y) in pts:
        assert w.ev(x, y, p) == 0
    # ... and does NOT vanish at an unrelated point (nontrivial witness)
    q = pyref.random_point(random.Random(1), curve)
    assert w.ev(q[0], q[1], p) != 0


@pytest.mark.parametrize("name", ["grumpkin", "pallas"])
def test_rustsem_vs_canonical_proportional(name):
    """Rust-semantics coefficients == canonical affine-normalized
    coefficients x one nonzero constant (the whole difference between the
    two conventions)."""
    curve = CURVES[name]
    p = curve.field.p
    pts, wa, wb = rustsem.load_golden(name)
    jac = [(x, y, 1) for (x, y) in pts]
    canon, out = rustsem.compute_divisor_witness_partial(jac, curve, canonical=True)
    assert rustsem.jac_is_identity(out)
    assert len(canon.a) == len(wa) and len(canon.b) == len(wb)
    # the constant from the first nonzero canonical a-coefficient
    i0 = next(i for i, c in enumerate(canon.a) if c != 0)
    k = wa[i0] * pow(canon.a[i0], p - 2, p) % p
    assert k != 0
    assert all(wa[i] == k * canon.a[i] % p for i in range(len(wa)))
    assert all(wb[i] == k * canon.b[i] % p for i in range(len(wb)))


def test_canonical_rustsem_matches_device_tree(rng):
    """The canonical-mode host replica BIT-matches the port's merge tree
    (compute_divisor_witness_partial on CPU tensors, n = 4)."""
    curve = PALLAS
    E = ec(curve)
    n = 4
    pts_ints = pyref.random_points(rng, curve, n - 1)
    pts_ints.append(pyref.ec_neg(pyref.ec_msm([1] * (n - 1), pts_ints, curve), curve))
    wtns, out = rustsem.compute_divisor_witness_partial(
        [(x, y, 1) for (x, y) in pts_ints], curve, canonical=True)
    assert rustsem.jac_is_identity(out)

    dw, dout = D.compute_divisor_witness_partial(curve, E.points_from_ints(pts_ints, "cpu"))
    spec = curve.field
    da = mont_limbs_to_ints(limbs_to_numpy(dw.a), spec)
    db = mont_limbs_to_ints(limbs_to_numpy(dw.b), spec)
    # the tree's vectors are padded to the level's semantic length; the host
    # lists drop trailing zeros the same way the reference's Polynomial does
    assert da[:len(wtns.a)] == wtns.a and all(c == 0 for c in da[len(wtns.a):])
    assert db[:len(wtns.b)] == wtns.b and all(c == 0 for c in db[len(wtns.b):])
