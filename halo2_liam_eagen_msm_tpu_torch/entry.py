"""The port's twins of the repository's __graft_entry__ entry points: entry(),
the model's forward step with example arguments, and dryrun_multichip(), the
sharded step on n ranks at tiny shapes; on the card unless asked otherwise."""

from __future__ import annotations

import random
import time

import torch

from . import argument as A
from .config import resolve_device
from .convert import JPoint, digits_to_rounds
from .fields import PALLAS
from .limbs import ints_to_limbs
from .models.eagen_msm import EagenConfig, EagenMSMWitness
from .negbase import negbase_decompose_batch
from .ops import cuda_ff
from .ops.ec import ec
from .ops.msm import scalars_to_limbs
from .ops.poly import Poly
from .parallel import comm
from .parallel import mesh as PM
from .parallel.launch import resolve_backend, run_world
from .utils import pyref, ref_divisor


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship model (digit
    rounds -> carry + witness) at 4 points and the first 8 digit rounds, the
    inputs made from the same seed as the JAX package's entry.  fn returns
    (carry.x, wtns.a, wtns.b)."""
    dev = resolve_device(device)
    rng = random.Random(0xE7)
    cfg = EagenConfig(num_pts=4)
    model = EagenMSMWitness(cfg)
    E = ec(cfg.curve)
    pts = E.points_from_ints(pyref.random_points(rng, cfg.curve, cfg.num_pts), dev)
    scalars = [A.gen_random_coeff(rng, cfg.curve.scalar_field) for _ in range(cfg.num_pts)]
    # reduced round depth: each digit round is an independent batched witness
    digits = torch.from_numpy(model.decompose(scalars)[:8]).to(dev)

    def fn(digits, px, py, pz):
        carry, wtns = model.forward(digits, JPoint(px, py, pz))
        return carry.x, wtns.a, wtns.b

    return fn, (digits, pts.x, pts.y, pts.z)


def dryrun_multichip(n_devices: int, device="cuda", backend: str | None = None,
                     timeout_s: float = 600.0) -> None:
    """The full sharded step on n_devices ranks at tiny shapes, the twin of
    __graft_entry__.dryrun_multichip with every part executed: the 1-D
    sharded MSM, the round-sharded witness, the points-sharded tree, the
    a2a top of the tree (both flavors) and the 2-D mesh (hierarchical
    witness and sharded_msm_2d), each held against the host oracles
    (utils/pyref, utils/ref_divisor) by rank 0, which prints an OK line
    after each part.  The ranks run through parallel/launch.run_world,
    whose default backend (launch.resolve_backend) is NCCL where every rank
    has a card of its own, else gloo (ranks sharing a card, or the CPU).
    Raises on any mismatch, rank failure or timeout."""
    dev = resolve_device(device)
    backend = resolve_backend(backend, n_devices, dev)
    if dev.type == "cuda":
        cuda_ff.build_library()   # once, before the ranks load it
    print(f"dryrun_multichip: {n_devices} ranks, backend {backend}, device {dev}", flush=True)
    t0 = time.time()
    run_world(_dryrun_rank, n_devices, backend, dev, args=(t0,), timeout_s=timeout_s)
    print(f"dryrun_multichip OK [{time.time() - t0:.0f}s]: {n_devices} ranks ({backend}): "
          "sharded MSM == host Pippenger; round-sharded witness, points-sharded tree, "
          "a2a top (both flavors) and the 2-D mesh's witness bit-exact against the host "
          "oracle; 2-D MSM == host Pippenger", flush=True)


def _dryrun_rank(rank: int, dev, t0: float) -> None:
    """One rank of dryrun_multichip: every rank computes, rank 0 checks."""
    n_devices = torch.distributed.get_world_size()
    curve = PALLAS
    E = ec(curve)

    def ok(msg: str) -> None:
        if rank == 0:
            print(f"dryrun part OK [{time.time() - t0:.0f}s]: {msg}", flush=True)

    def check(cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(f"dryrun_multichip: {what}")

    def matches_host(wa, wb, host_pts) -> bool:
        hrf, hout = ref_divisor.divisor_witness_host(curve, host_pts)
        return (hout is None
                and Poly.from_device(curve.field, wa, len(hrf.a.coeffs)).coeffs == hrf.a.coeffs
                and Poly.from_device(curve.field, wb, len(hrf.b.coeffs)).coeffs == hrf.b.coeffs)

    def one(p: JPoint):
        return E.points_to_ints(JPoint(*(c[None] for c in p)))[0]

    mesh = PM.make_mesh(n_devices, device=dev)
    axis = mesh.axis_names[0]
    rng = random.Random(0xD1)
    n = n_devices                       # one point a rank
    pts_ints = pyref.random_points(rng, curve, n)
    pts = E.points_from_ints(pts_ints, dev)
    scalars = [1 + rng.randrange(3) for _ in range(n)]

    # 1) the sharded MSM: one 2-bit window
    sc = scalars_to_limbs(scalars, curve, dev)
    res = PM.sharded_msm(curve, sc, pts, mesh, c=2, max_scalar_bits=2)
    if rank == 0:
        check(one(res) == pyref.ec_msm(scalars, pts_ints, curve), "sharded MSM mismatch")
    ok(f"1/5 sharded MSM (D={n_devices}, all_gather reduce) == host Pippenger")

    # 2) round-sharded witnesses: the last D digit rounds of 4 points, base 3
    base = 3
    div_scalars = [rng.randrange(1 << 8) for _ in range(min(n, 4))]
    div_pts = JPoint(*(c[:len(div_scalars)] for c in pts))
    digits = negbase_decompose_batch(ints_to_limbs(div_scalars), base,
                                     A.num_digits_for(curve, base))
    rounds = digits_to_rounds(digits, dev)[-n_devices:]
    round_pts, _ = A._rounds_and_carries(curve, base, rounds, div_pts)
    wtns, outs = PM.sharded_divisor_witness(curve, mesh, round_pts)
    wa, wb = comm.gather_shards(wtns.a, mesh, axis), comm.gather_shards(wtns.b, mesh, axis)
    oz = comm.gather_shards(outs.z, mesh, axis)
    d_rounds, s_slots = round_pts.x.shape[0], round_pts.x.shape[1]
    if rank == 0:
        check(bool(E.f.is_zero(oz).all()), "sharded witness rounds must close")
        flat = E.points_to_ints(round_pts)
        for r in range(d_rounds):
            check(matches_host(wa[r], wb[r], flat[r * s_slots:(r + 1) * s_slots]),
                  f"round-sharded witness round {r}")
    ok(f"2/5 round-sharded witness ({d_rounds} rounds x {s_slots} slots) bit-exact vs "
       "host oracle")

    # 3) one round's tree with the point axis sharded
    np_pts = 2 * n_devices
    ps_ints = pyref.random_points(rng, curve, np_pts - 1)
    ps_ints.append(pyref.ec_neg(pyref.ec_msm([1] * (np_pts - 1), ps_ints, curve), curve))
    ps = E.points_from_ints(ps_ints, dev)
    w_sh, out_sh = PM.points_sharded_divisor_witness(curve, mesh, ps)
    if rank == 0:
        check(bool(E.is_identity(out_sh)) and matches_host(w_sh.a, w_sh.b, ps_ints),
              "points-sharded tree")
    ok(f"3/5 points-sharded single-round tree ({np_pts} pts, D={n_devices}) bit-exact vs "
       "host oracle")

    # 4) the a2a top of the tree, executed in both flavors: 8 points a rank,
    # the transforms sharded from a-length 4 (the top levels reach n >= D^2)
    na = 8 * n_devices
    a2_ints = pyref.random_points(rng, curve, na - 1)
    a2_ints.append(pyref.ec_neg(pyref.ec_msm([1] * (na - 1), a2_ints, curve), curve))
    a2 = E.points_from_ints(a2_ints, dev)
    for coeff_sharded in (False, True):
        before = mesh.sent["all_to_all"]
        w2, o2 = PM.points_sharded_divisor_witness_a2a(curve, mesh, a2, dist_min_la=4,
                                                       coeff_sharded=coeff_sharded)
        check(n_devices == 1 or mesh.sent["all_to_all"] > before,
              "the a2a top ran no all_to_all")
        check(PM.reruns == 0, "the a2a top took the replicated rerun on honest points")
        if rank == 0:
            check(bool(E.is_identity(o2)) and matches_host(w2.a, w2.b, a2_ints),
                  f"a2a top (coeff_sharded={coeff_sharded})")
    ok(f"4/5 a2a-sharded top of the tree ({na} pts, D={n_devices}, both flavors) bit-exact "
       "vs host oracle")

    # 5) the (dcn, ici) mesh: part 3's points as every round, and part 1's MSM
    n_dcn = 2 if n_devices % 2 == 0 else 1
    n_ici = n_devices // n_dcn
    mesh2 = PM.make_mesh_2d(n_dcn, n_ici, device=dev)
    h_rp = JPoint(*(torch.stack([c] * n_dcn) for c in ps))
    hw, houts = PM.hierarchical_divisor_witness(curve, mesh2, h_rp)
    hw_a, hw_b = (comm.gather_shards(t, mesh2, "dcn") for t in hw)
    res2 = PM.sharded_msm_2d(curve, sc, pts, mesh2, c=2, max_scalar_bits=2)
    if rank == 0:
        check(bool(E.is_identity(houts).all()), "hierarchical witness rounds must close")
        for r in range(n_dcn):
            check(matches_host(hw_a[r], hw_b[r], ps_ints), f"hierarchical witness round {r}")
        check(one(res2) == pyref.ec_msm(scalars, pts_ints, curve), "2-D sharded MSM mismatch")
    ok(f"5/5 ({n_dcn},{n_ici}) hierarchical witness bit-exact vs host oracle; 2-D MSM == "
       "host Pippenger")
