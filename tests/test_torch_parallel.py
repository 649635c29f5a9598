"""parallel/ of the PyTorch port on the CPU: one world of 8 gloo ranks
(parallel/launch.run_world) runs the counterparts of test_parallel.py's nine
tests at their shapes and seeds, the collectives and the a2a witness's
replicated rerun; the parent holds what the ranks return against the JAX
package's host oracles (utils.pyref, utils.ref_divisor), the port's
single-device functions bit for bit and, for the transform pair, the JAX
ntt_dif.  Then entry.dryrun_multichip on 4 ranks, and run_world's failure
and deadline.

No JAX at the top of this module: every rank imports it to find its
function, and the ranks import torch, numpy and the port only.  Integer
arithmetic: tolerance zero."""

import multiprocessing
import random
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from halo2_liam_eagen_msm_tpu_torch import argument as A
from halo2_liam_eagen_msm_tpu_torch import divisor as D
from halo2_liam_eagen_msm_tpu_torch.convert import JPoint, digits_to_rounds
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_limbs, ints_to_mont_limbs
from halo2_liam_eagen_msm_tpu_torch.negbase import negbase_decompose_batch
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.ops.msm import scalars_to_limbs
from halo2_liam_eagen_msm_tpu_torch.ops.ntt import intt_dit, ntt_dif
from halo2_liam_eagen_msm_tpu_torch.parallel import comm
from halo2_liam_eagen_msm_tpu_torch.parallel import dist_ntt as DN
from halo2_liam_eagen_msm_tpu_torch.parallel import mesh as PM
from halo2_liam_eagen_msm_tpu_torch.parallel.launch import RankError, resolve_backend, run_world
from halo2_liam_eagen_msm_tpu_torch.utils import pyref

torch.set_num_threads(1)

CURVE = PALLAS
SPEC = PALLAS.field
SEED = 0xEA6E4   # tests/conftest.py's rng fixture, which test_parallel.py uses
WORLD = 8


def _rng():
    return random.Random(SEED)


def _closing(rng, n):
    """test_parallel.py's closing list: n - 1 random points and their negated sum."""
    pts = pyref.random_points(rng, CURVE, n - 1)
    return pts + [pyref.ec_neg(pyref.ec_msm([1] * (n - 1), pts, CURVE), CURVE)]


def _mont(vals, dev):
    return torch.from_numpy(ints_to_mont_limbs(vals, SPEC).view(np.int32).copy()).to(dev)


def _rounds(scalars, base, dev):
    d = A.num_digits_for(CURVE, base)
    return digits_to_rounds(negbase_decompose_batch(ints_to_limbs(scalars), base, d), dev)


def _model_input(rank: int, shape):
    """A rank's seeded int32 tensor for the collectives' cases."""
    return torch.from_numpy(np.random.default_rng(100 + rank).integers(
        0, 1 << 30, size=shape, dtype=np.int32))


PERM = [(0, 3), (3, 0), (5, 6), (2, 2)]   # ranks 1, 4, 5, 7 receive nothing


def _world(rank, dev):
    """Every case of the module on one rank; returns {case: result}."""
    E = ec(CURVE)
    m8 = PM.make_mesh(8, device=dev)
    m4 = PM.make_mesh(4, device=dev)
    m2 = PM.make_mesh_2d(2, 4, device=dev)
    m1 = PM.make_mesh(1, device=dev)
    out = {}

    def affine(p):
        return E.points_to_ints(JPoint(*(c[None] for c in p)))[0]

    def rf(w, o):
        return (w.a, w.b, torch.stack(tuple(o)))

    # the collectives
    out["all_gather_dim0"] = comm.all_gather(_model_input(rank, (3, 2)), m8, "data")
    out["all_gather_dim1"] = comm.all_gather(_model_input(rank, (2, 3)), m2, "ici", dim=1)
    out["all_to_all_dim0"] = comm.all_to_all(_model_input(rank, (8, 2)), m8, "data", dim=0)
    out["all_to_all_dim1"] = comm.all_to_all(_model_input(rank, (3, 16, 2)), m8, "data", dim=1)
    out["ppermute"] = comm.ppermute(_model_input(rank, (2, 5)), m8, "data", PERM)
    out["psum"] = comm.psum(_model_input(rank, (4,)).to(torch.int64), m8, "data")

    # test_sharded_msm
    rng = _rng()
    pts_i = pyref.random_points(rng, CURVE, 16)
    sc = [rng.randrange(1 << 32) for _ in range(16)]
    out["sharded_msm"] = affine(PM.sharded_msm(CURVE, scalars_to_limbs(sc, CURVE, dev),
                                               E.points_from_ints(pts_i, dev), m8, c=4,
                                               max_scalar_bits=32))
    # test_points_sharded_witness
    pts32 = E.points_from_ints(_closing(_rng(), 32), dev)
    out["points_sharded"] = rf(*PM.points_sharded_divisor_witness(CURVE, m8, pts32))
    # test_round_sharded_witness: base 5, 4 points, 56 rounds, 7 a rank
    rng = _rng()
    pts4 = E.points_from_ints(pyref.random_points(rng, CURVE, 4), dev)
    round_pts, carry = A._rounds_and_carries(
        CURVE, 5, _rounds([rng.randrange(1 << 32) for _ in range(4)], 5, dev), pts4)
    w, o = PM.sharded_divisor_witness(CURVE, m8, round_pts)
    out["round_sharded"] = rf(w, o) + (affine(carry),)
    out["round_pts"] = torch.stack(tuple(round_pts)) if rank == 0 else None
    # test_dist_ntt_pair: D = 8, n = 64
    rng = _rng()
    a = _mont([rng.randrange(SPEC.p) for _ in range(64)], dev)
    dc = DN.dist_consts(SPEC, 6, 3)
    spect = DN.fwd_from_replicated(SPEC, a, m8, "data", 8, dc)
    out["dist_ntt_pair"] = (spect, DN.inv_to_replicated(SPEC, spect, m8, "data", 8, dc))
    # test_sharded_msm_2d
    rng = _rng()
    pts_i = pyref.random_points(rng, CURVE, 16)
    sc = [rng.randrange(1 << 32) for _ in range(16)]
    out["sharded_msm_2d"] = affine(PM.sharded_msm_2d(CURVE, scalars_to_limbs(sc, CURVE, dev),
                                                     E.points_from_ints(pts_i, dev), m2, c=4,
                                                     max_scalar_bits=32))
    # test_hierarchical_witness: base 3, 4 points, two rounds (one a dcn row)
    rng = _rng()
    pts4 = E.points_from_ints(pyref.random_points(rng, CURVE, 4), dev)
    rp, _ = A._rounds_and_carries(
        CURVE, 3, _rounds([rng.randrange(1 << 16) for _ in range(4)], 3, dev)[:2], pts4)
    out["hierarchical"] = rf(*PM.hierarchical_divisor_witness(CURVE, m2, rp))

    if m4 is not None:
        # test_points_sharded_witness_a2a / _coeff_sharded: D = 4, 32 points
        for name, cs in (("a2a", False), ("a2a_coeff_sharded", True)):
            w, o = PM.points_sharded_divisor_witness_a2a(CURVE, m4, pts32, dist_min_la=4,
                                                         coeff_sharded=cs)
            out[name] = rf(w, o) + (PM.reruns, m4.sent["all_to_all"])
        # test_contiguous_shard_transform_primitives: D = 4, n = 16
        rng = _rng()
        full = _mont([rng.randrange(SPEC.p) for _ in range(16)], dev)
        ac = full[4 * rank:4 * rank + 4]
        dc = DN.dist_consts(SPEC, 4, 2)
        sp = DN.fwd_from_contiguous(SPEC, ac, m4, "data", 4, dc)
        out["contiguous_primitives"] = (sp, DN.inv_to_contiguous(SPEC, sp, m4, "data", 4, dc),
                                        DN.reshard_double(ac, m4, "data", 4))
        # the replicated rerun: a root on the evaluation domain at the top level
        reruns = PM.reruns
        w, o = PM.points_sharded_divisor_witness_a2a(
            CURVE, m4, E.points_from_ints(pyref.root_on_domain_points(_rng(), CURVE), dev))
        out["a2a_rerun"] = rf(w, o) + (PM.reruns - reruns,)
    if m1 is not None:   # D = 1: the one shard is the lower half
        out["reshard_d1"] = DN.reshard_double(full, m1, "data", 1)
    return out


@pytest.fixture(scope="module")
def world():
    t0 = time.time()
    res = run_world(_world, WORLD, "gloo", "cpu", timeout_s=240)
    print(f"world of {WORLD} gloo ranks: {time.time() - t0:.1f} s")
    return res


def _single_device_tree(pts_ints):
    return D.compute_divisor_witness_partial(CURVE, ec(CURVE).points_from_ints(pts_ints, "cpu"))


def _jax_curve():
    from halo2_liam_eagen_msm_tpu.fields import PALLAS as JAX_PALLAS
    return JAX_PALLAS


def _assert_host(wa, wb, out, pts_ints):
    """One tree's (La, 16) and (Lb, 16) witness rows and (3, 16) output
    point, numpy from a rank, against the JAX package's host oracle
    (ref_divisor.divisor_witness_host) coefficient for coefficient."""
    from halo2_liam_eagen_msm_tpu.ops.poly import Poly
    from halo2_liam_eagen_msm_tpu.utils import ref_divisor

    hrf, hout = ref_divisor.divisor_witness_host(_jax_curve(), pts_ints)
    spec = _jax_curve().field
    assert ec(CURVE).points_to_ints(JPoint(*(torch.from_numpy(c[None]) for c in out))) == [hout]
    assert Poly.from_device(spec, wa.view(np.uint32), len(hrf.a)).coeffs == hrf.a.coeffs
    assert Poly.from_device(spec, wb.view(np.uint32), len(hrf.b)).coeffs == hrf.b.coeffs


def _round_ints(rp: JPoint, r: int):
    """Round r's slot list of a (d, S) round tensor as host points."""
    return ec(CURVE).points_to_ints(JPoint(*(c[r] for c in rp)))


def _assert_tree(got, pts_ints):
    """(a, b, out) numpy from a rank against the port's single-device tree
    bit for bit and the JAX package's host oracle coefficient for
    coefficient, the output point too."""
    wa, wb, out = got
    w, o = D.compute_divisor_witness_partial(CURVE, ec(CURVE).points_from_ints(pts_ints, "cpu"))
    assert np.array_equal(wa, w.a.numpy()) and np.array_equal(wb, w.b.numpy())
    assert np.array_equal(out, torch.stack(tuple(o)).numpy())
    _assert_host(wa, wb, out, pts_ints)


def _same_on_ranks(world, key, ranks=range(WORLD)):
    first = world[ranks[0]][key]
    for r in ranks:
        got = world[r][key]
        if isinstance(first, tuple):
            assert all(np.array_equal(x, y) for x, y in zip(got, first)), (key, r)
        else:
            assert np.array_equal(got, first) if isinstance(first, np.ndarray) else got == first
    return first


# ---------------------------------------------------------------------------
# the collectives against a numpy model
# ---------------------------------------------------------------------------

def _model(case, rank):
    x = {r: _model_input(r, shape).numpy() for r, shape in
         ((r, {"all_gather_dim0": (3, 2), "all_gather_dim1": (2, 3), "all_to_all_dim0": (8, 2),
               "all_to_all_dim1": (3, 16, 2), "ppermute": (2, 5), "psum": (4,)}[case])
          for r in range(WORLD))}
    if case == "all_gather_dim0":
        return np.stack([x[r] for r in range(WORLD)])
    if case == "all_gather_dim1":                   # the ici row of `rank`
        row = range(rank // 4 * 4, rank // 4 * 4 + 4)
        return np.stack([x[r] for r in row], axis=1)
    if case == "all_to_all_dim0":                   # chunk `rank` of every source
        return np.concatenate([x[r][rank:rank + 1] for r in range(WORLD)], axis=0)
    if case == "all_to_all_dim1":
        return np.concatenate([x[r][:, 2 * rank:2 * rank + 2] for r in range(WORLD)], axis=1)
    if case == "ppermute":
        src = {dst: s for s, dst in PERM}
        return x[src[rank]] if rank in src else np.zeros_like(x[rank])
    return sum(x[r].astype(np.int64) for r in range(WORLD))


@pytest.mark.parametrize("case", ["all_gather_dim0", "all_gather_dim1", "all_to_all_dim0",
                                  "all_to_all_dim1", "ppermute", "psum"])
def test_collective_matches_numpy_model(world, case):
    for rank in range(WORLD):
        assert np.array_equal(world[rank][case], _model(case, rank)), rank


# ---------------------------------------------------------------------------
# the counterparts of test_parallel.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sharded_msm", "sharded_msm_2d"])
def test_sharded_msm_equals_host_pippenger(world, case):
    from halo2_liam_eagen_msm_tpu.utils import pyref as jax_pyref

    rng = _rng()
    pts_i = jax_pyref.random_points(rng, _jax_curve(), 16)
    sc = [rng.randrange(1 << 32) for _ in range(16)]
    assert _same_on_ranks(world, case) == jax_pyref.ec_msm(sc, pts_i, _jax_curve())


@pytest.mark.parametrize("case,ranks", [("points_sharded", range(8)), ("a2a", range(4)),
                                        ("a2a_coeff_sharded", range(4))])
def test_points_sharded_tree_bit_identical(world, case, ranks):
    """One round's tree with the point axis split (8 ranks; the a2a top on
    4, where the top two levels' NTT sizes 16 and 32 reach D^2): equal to
    the single-device tree and the host oracle; the a2a flavors ran their
    all_to_alls and no rerun."""
    got = _same_on_ranks(world, case, ranks)
    assert not got[2][2].any()                                 # the identity
    _assert_tree(got[:3], _closing(_rng(), 32))
    if case != "points_sharded":
        assert got[3] == 0 and all(world[r][case][4] > 0 for r in ranks)


def test_round_sharded_witness(world):
    """56 rounds of 4 points (base 5), 7 a rank: every round closes, the
    shards equal the single-device batched tree of rank 0's round tensor
    bit for bit, each round's witness the host oracle of its slot list
    coefficient for coefficient, and the carry the oracle."""
    from halo2_liam_eagen_msm_tpu.utils import pyref as jax_pyref

    rng = _rng()
    pts_i = jax_pyref.random_points(rng, _jax_curve(), 4)
    sc = [rng.randrange(1 << 32) for _ in range(4)]
    rp = torch.from_numpy(world[0]["round_pts"])
    w, o = D.compute_divisor_witness_partial(CURVE, JPoint(rp[0], rp[1], rp[2]))
    wa = np.concatenate([world[r]["round_sharded"][0] for r in range(WORLD)])
    wb = np.concatenate([world[r]["round_sharded"][1] for r in range(WORLD)])
    outs = np.concatenate([world[r]["round_sharded"][2] for r in range(WORLD)], axis=1)
    assert np.array_equal(wa, w.a.numpy()) and np.array_equal(wb, w.b.numpy())
    assert np.array_equal(outs, torch.stack(tuple(o)).numpy()) and not outs[2].any()
    for r in range(rp.shape[1]):
        _assert_host(wa[r], wb[r], outs[:, r], _round_ints(JPoint(rp[0], rp[1], rp[2]), r))
    want = jax_pyref.ec_msm(sc, pts_i, _jax_curve())
    assert all(world[r]["round_sharded"][3] == want for r in range(WORLD))


def test_hierarchical_witness(world):
    """Rounds over dcn x points over ici: each dcn row's round equals the
    single-device (2, 8) batched tree bit for bit, the same on every rank of
    the row, and the host oracle of its slot list coefficient for
    coefficient."""
    rng = _rng()
    pts_i = pyref.random_points(rng, CURVE, 4)
    rp, _ = A._rounds_and_carries(
        CURVE, 3, _rounds([rng.randrange(1 << 16) for _ in range(4)], 3, "cpu")[:2],
        ec(CURVE).points_from_ints(pts_i, "cpu"))
    w, o = D.compute_divisor_witness_partial(CURVE, rp)
    for rank in range(WORLD):
        i = rank // 4
        wa, wb, out = world[rank]["hierarchical"]
        assert np.array_equal(wa, w.a[i:i + 1].numpy()) and np.array_equal(wb, w.b[i:i + 1].numpy())
        assert np.array_equal(out, torch.stack(tuple(o))[:, i:i + 1].numpy()) and not out[2].any()
        _assert_host(wa[0], wb[0], out[:, 0], _round_ints(rp, i))


def test_dist_ntt_pair(world):
    """The all_to_all-sharded ntt_dif / intt_dit over 8 ranks: the shards of
    the spectrum equal the port's ntt_dif and the JAX ntt_dif, and the
    inverse gives the coefficients back on every rank."""
    import jax
    from halo2_liam_eagen_msm_tpu.ops import ntt as jax_ntt

    rng = _rng()
    a = _mont([rng.randrange(SPEC.p) for _ in range(64)], "cpu")
    spect = np.concatenate([world[r]["dist_ntt_pair"][0] for r in range(WORLD)])
    want = ntt_dif(SPEC, a)
    assert np.array_equal(spect, want.numpy())
    jax_spect = jax.jit(lambda x: jax_ntt.ntt_dif(_jax_curve().field, x))(a.numpy().view(np.uint32))
    assert np.array_equal(spect.view(np.uint32), np.asarray(jax_spect))
    for rank in range(WORLD):
        back = world[rank]["dist_ntt_pair"][1]
        assert np.array_equal(back, a.numpy())
        assert np.array_equal(back, intt_dit(SPEC, want).numpy())


def test_contiguous_shard_transform_primitives(world):
    """fwd_from_contiguous / inv_to_contiguous and reshard_double on 4
    ranks at n = 16 = D^2, the shards assembled in rank order: the spectrum
    equals the port's and the JAX ntt_dif; reshard_double on one rank too
    (where the JAX module's pairs, range(D // 2), are none)."""
    import jax
    from halo2_liam_eagen_msm_tpu.ops import ntt as jax_ntt

    rng = _rng()
    a = _mont([rng.randrange(SPEC.p) for _ in range(16)], "cpu")
    sp, back, resh = (np.concatenate([world[r]["contiguous_primitives"][i] for r in range(4)])
                      for i in range(3))
    assert np.array_equal(sp, ntt_dif(SPEC, a).numpy())
    jax_spect = jax.jit(lambda x: jax_ntt.ntt_dif(_jax_curve().field, x))(a.numpy().view(np.uint32))
    assert np.array_equal(sp.view(np.uint32), np.asarray(jax_spect))
    assert np.array_equal(back, a.numpy())
    assert np.array_equal(resh, np.concatenate([a.numpy(), np.zeros_like(a.numpy())]))
    assert np.array_equal(world[0]["reshard_d1"], resh)


def test_a2a_unsafe_rerun_taken_by_every_rank(world):
    """A root on the evaluation domain at the distributed top level: one
    rank's rows hold the zero denominator, the summed flag sends all four
    ranks to the replicated rerun together, and the result is exact."""
    got = _same_on_ranks(world, "a2a_rerun", range(4))
    assert all(world[r]["a2a_rerun"][3] == 1 for r in range(4))
    _assert_tree(got[:3], pyref.root_on_domain_points(_rng(), CURVE))


# ---------------------------------------------------------------------------
# the dryrun and run_world's own failure modes
# ---------------------------------------------------------------------------

def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    from halo2_liam_eagen_msm_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu", backend="gloo", timeout_s=240)
    text = capsys.readouterr().out
    assert "backend gloo" in text and "dryrun_multichip OK" in text


def _fail_one(rank, dev):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()     # rank 0 waits for a peer that never comes


def _sleep_one(rank, dev):
    if rank == 1:
        time.sleep(600)
    return rank


def test_run_world_raises_on_a_failed_rank():
    t0 = time.time()
    with pytest.raises(RankError, match="fails on purpose"):
        run_world(_fail_one, 2, "gloo", "cpu", timeout_s=120)
    assert time.time() - t0 < 60 and not multiprocessing.active_children()


def test_run_world_raises_past_its_deadline():
    t0 = time.time()
    with pytest.raises(TimeoutError):
        run_world(_sleep_one, 2, "gloo", "cpu", timeout_s=3)
    assert time.time() - t0 < 20 and not multiprocessing.active_children()


@pytest.mark.parametrize("world_size,device,cards,want", [
    (1, "cuda", 1, "nccl"), (4, "cuda", 1, "gloo"), (4, "cuda", 4, "nccl"), (4, "cpu", 0, "gloo")])
def test_default_backend(monkeypatch, world_size, device, cards, want):
    """NCCL where every rank has a card of its own, else gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert resolve_backend(None, world_size, device) == want
    assert resolve_backend("gloo", world_size, device) == "gloo"


def test_run_world_defaults_to_the_card(monkeypatch):
    """run_world's device defaults to the card; without one it raises in
    the parent, before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_world(_sleep_one, 2)
    assert not multiprocessing.active_children()
