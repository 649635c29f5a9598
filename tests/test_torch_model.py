"""The port's model (models/eagen_msm.py), its entry point (entry.py) and
the debug utilities (utils/checks.py, utils/profiling.py) on the CPU.

The model against the port's own compute_lhs_witness (limb for limb) and
the Python-int oracle (affine carry); the entry point against the JAX
package's _forward_jit at the JAX entry's shapes (limb for limb: that one
XLA:CPU compile takes minutes, so the test is marked slow)."""

import json
import random

import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu_torch import argument as A
from halo2_liam_eagen_msm_tpu_torch import config
from halo2_liam_eagen_msm_tpu_torch.convert import JPoint, limbs_to_numpy
from halo2_liam_eagen_msm_tpu_torch.entry import entry
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
from halo2_liam_eagen_msm_tpu_torch.models.eagen_msm import EagenConfig, EagenMSMWitness
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.utils import checks, profiling, pyref

torch.set_num_threads(1)

CURVE = PALLAS


def test_model_vs_compute_lhs_witness_and_oracle(rng):
    cfg = EagenConfig(num_pts=5)  # 11 slots a round: the identity pad runs
    assert (cfg.num_digits, cfg.slots) == (A.num_digits_for(CURVE, 5), 11)
    E = ec(CURVE)
    host = pyref.random_points(rng, CURVE, cfg.num_pts)
    pts = E.points_from_ints(host, "cpu")
    scalars = [A.gen_random_coeff(rng, CURVE.scalar_field) for _ in range(cfg.num_pts)]
    scalars[1] = 0
    model = EagenMSMWitness(cfg)
    digits = model.decompose(scalars)
    assert digits.shape == (cfg.num_digits, cfg.num_pts) and digits.dtype == np.int32
    carry, wtns = model(scalars, pts)
    assert E.points_to_ints(JPoint(*(c[None] for c in carry)))[0] == \
        pyref.ec_msm(scalars, host, CURVE)
    want_carry, want, _ = A.compute_lhs_witness(CURVE, scalars, pts, cfg.base)
    assert torch.equal(carry.x, want_carry.x) and torch.equal(carry.z, want_carry.z)
    assert torch.equal(wtns.a, want.a) and torch.equal(wtns.b, want.b)
    # 12 slots after the pad: 6 seeds and three levels, so lengths 9 and 8
    assert tuple(wtns.a.shape) == (cfg.num_digits, 9, 16)
    assert tuple(wtns.b.shape) == (cfg.num_digits, 8, 16)


def test_entry_on_cpu_runs_the_model():
    fn, args = entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    cx, wa, wb = fn(*args)
    assert tuple(cx.shape) == (16,) and wa.shape[0] == wb.shape[0] == 8
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError):
            entry()


@pytest.mark.slow
def test_entry_vs_jax_forward():
    """entry("cpu")'s fn against the JAX package's entry() fn on the same
    seeded inputs (compared first), limb for limb.  The JAX call compiles
    the whole forward graph on XLA:CPU: about 330 s cold."""
    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    fn, args = entry("cpu")
    for j, t in zip(jargs, args):
        assert np.array_equal(np.asarray(j).astype(np.int64),
                              t.numpy().astype(np.int64) & 0xFFFFFFFF)
    for j, t in zip(jfn(*jargs), fn(*args)):
        assert np.array_equal(np.asarray(j), limbs_to_numpy(t))


def test_checks_on_and_off(monkeypatch, rng):
    E = ec(CURVE)
    good = E.points_from_ints(pyref.random_points(rng, CURVE, 3) + [None], "cpu")
    bad = JPoint(good.x.clone(), good.y.clone(), good.z)
    bad.y[0] = good.y[1]  # off the curve
    digits = torch.tensor([[0, 4], [5, 1]], dtype=torch.int32)
    monkeypatch.setattr(config, "SANITY_CHECKS", False)
    assert not checks.enabled()
    checks.check_on_curve(E, bad)
    checks.check_digit_range(digits, 5)
    monkeypatch.setattr(config, "SANITY_CHECKS", True)
    assert checks.enabled()
    checks.check_on_curve(E, good)
    checks.check_digit_range(digits.clamp(max=4).numpy(), 5)
    with pytest.raises(AssertionError, match=r"points\[0\] off-curve"):
        checks.check_on_curve(E, bad)
    with pytest.raises(AssertionError, match="digit out of range"):
        checks.check_digit_range(digits, 5)


def test_profiling_on_cpu(tmp_path):
    calls = []
    best, times = profiling.benchmark(lambda k: calls.append(k), 7, reps=3, warmup=2,
                                      sync=lambda: None)
    assert calls == [7] * 5 and len(times) == 3 and best == min(times) >= 0
    line = json.loads(profiling.metric_line("points_per_s", 1234.56, "points/s", 1000.0))
    assert line == {"metric": "points_per_s", "value": 1234.6, "unit": "points/s",
                    "vs_baseline": 1.2346}
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
