"""Sharding of the MSM witness pipeline over ranks (torch.distributed).

Counterpart of the JAX package's parallel/mesh.py.  Where the JAX functions
run a shard_map over a device mesh, these run on every rank of a Mesh
(parallel/comm.py) with the same signatures: every rank passes the same
whole inputs and computes on its own contiguous shard; a result that JAX
returns replicated (out_specs=P()) every rank returns, one that JAX returns
sharded each rank returns its own part of (comm.gather_shards rebuilds it).

  * MSM: points and scalars sharded on the axis; each rank runs the local
    Pippenger on its shard, and the partial results are gathered and summed
    (reducing per-rank results is cheaper than reducing bucket tables, and
    the same sum)
  * round-sharded witness: the argument's digit rounds are independent;
    each rank runs the merge tree of its rounds (no polynomial crosses ranks)
  * points-sharded witness: one round's tree with the point axis split;
    local trees down to one propagation a rank, one gather, the top
    log2(D) levels replicated (or, in the a2a flavor, with their transforms
    sharded: parallel/dist_ntt.py)
  * 2-D (dcn, ici) meshes: rounds over dcn, points over ici

The local work is the single-device code (ops/msm.best_multiexp,
divisor.seeds / merge_level), so on a CUDA device it runs the kernels.
"""

from __future__ import annotations

import torch

from .. import divisor as DV
from ..convert import RF, JPoint, Level
from ..fields import CurveSpec
from ..ops.ec import ec
from ..ops.msm import best_multiexp, pick_window
from . import dist_ntt
from .comm import Mesh, all_gather, axis_index, make_mesh, make_mesh_2d, psum

# replicated reruns of points_sharded_divisor_witness_a2a in this process
reruns = 0

__all__ = ["make_mesh", "sharded_msm", "shard_rounds", "sharded_divisor_witness",
           "make_mesh_2d", "sharded_msm_2d", "hierarchical_divisor_witness",
           "points_sharded_divisor_witness", "points_sharded_divisor_witness_a2a"]


def _rows(p: JPoint, sl) -> JPoint:
    return JPoint(*(c[sl] for c in p))


def _gather_sum(curve: CurveSpec, r: JPoint, mesh: Mesh, axis: str) -> JPoint:
    """Sum over the axis of one point a rank: one gather of the (3, 16)
    coordinates, then EC.sum of the D points in axis order."""
    g = all_gather(torch.stack(tuple(r)), mesh, axis)          # (D, 3, 16)
    return ec(curve).sum(JPoint(g[:, 0], g[:, 1], g[:, 2]), axis=0)


def sharded_msm(curve: CurveSpec, scalars, pts: JPoint, mesh: Mesh, c: int | None = None,
                max_scalar_bits: int | None = None) -> JPoint:
    """MSM with points and scalars partitioned over the mesh's axis.  N must
    be divisible by the mesh size (pad with zero scalars upstream)."""
    n = scalars.shape[0]
    D = mesh.size
    assert n % D == 0, "pad inputs to a multiple of the mesh size"
    axis = mesh.axis_names[0]
    if c is None:
        c = pick_window(n // D)
    i, L = axis_index(mesh, axis), n // D
    sl = slice(i * L, (i + 1) * L)
    r = best_multiexp(curve, scalars[sl], _rows(pts, sl), c, max_scalar_bits)
    return _gather_sum(curve, r, mesh, axis)


def shard_rounds(mesh: Mesh, round_pts: JPoint) -> JPoint:
    """This rank's contiguous rounds of a (d, S) round-batched point tensor
    sharded over the mesh's axis; d is padded to a multiple of the mesh size
    with identity rounds (all-zero coordinates: their witness is the
    constant 1, an exact no-op)."""
    D = mesh.size
    d = round_pts.x.shape[0]
    pad = (-d) % D
    if pad:
        round_pts = JPoint(*(torch.cat([c, c.new_zeros((pad,) + c.shape[1:])])
                             for c in round_pts))
    per = (d + pad) // D
    i = axis_index(mesh, mesh.axis_names[0])
    return _rows(round_pts, slice(i * per, (i + 1) * per))


def sharded_divisor_witness(curve: CurveSpec, mesh: Mesh, round_pts: JPoint):
    """Round-sharded batched divisor witnesses: this rank's rounds through
    the single-device level engine.  Returns this rank's (RF witness
    (d/D, La, 16), out JPoint (d/D, 16)); comm.gather_shards rebuilds the
    whole."""
    return DV.compute_divisor_witness_partial(curve, shard_rounds(mesh, round_pts))


def sharded_msm_2d(curve: CurveSpec, scalars, pts: JPoint, mesh: Mesh, c: int | None = None,
                   max_scalar_bits: int | None = None) -> JPoint:
    """MSM over a (dcn, ici) mesh with a hierarchical reduction: points and
    scalars sharded over both axes (flat index dcn * n_ici + ici), the
    partial results summed within each ici row first, then one point a row
    crosses the dcn axis."""
    n = scalars.shape[0]
    D = mesh.size
    assert n % D == 0, "pad inputs to a multiple of the mesh size"
    dcn, ici = mesh.axis_names
    if c is None:
        c = pick_window(n // D)
    i, L = axis_index(mesh, dcn) * mesh.shape[1] + axis_index(mesh, ici), n // D
    sl = slice(i * L, (i + 1) * L)
    r = best_multiexp(curve, scalars[sl], _rows(pts, sl), c, max_scalar_bits)
    s = _gather_sum(curve, r, mesh, ici)       # stage 1: within the row
    return _gather_sum(curve, s, mesh, dcn)    # stage 2: one partial a row


def _local_tree(curve: CurveSpec, pts: JPoint):
    """The level engine over a power-of-two point list (..., S, 16) down to
    population 1: (Level, b_sem)."""
    lv = DV.seeds(curve, pts)
    b_sem = 1
    while lv.out.x.shape[-2] > 1:
        b_sem *= 2
        lv = DV.merge_level(curve, b_sem + 1, b_sem, lv)
    return lv, b_sem


def _gather_top(lv: Level, mesh: Mesh, axis: str) -> Level:
    """Gather each rank's population-1 propagation over the axis into a
    population of D (leading round axes ride along): a-poly, b-poly and the
    output point packed into one tensor, one all_gather."""
    a, b = lv.wtns.a[..., 0, :, :], lv.wtns.b[..., 0, :, :]
    la, lb = a.shape[-2], b.shape[-2]
    packed = torch.cat([a, b] + [c[..., 0, None, :] for c in lv.out], dim=-2)
    g = all_gather(packed, mesh, axis, dim=-3)
    return Level(JPoint(*(g[..., la + lb + i, :] for i in range(3))),
                 RF(g[..., :la, :], g[..., la:la + lb, :]))


def _replicated_top(curve: CurveSpec, top: Level, bs: int) -> Level:
    while top.out.x.shape[-2] > 1:
        bs *= 2
        top = DV.merge_level(curve, bs + 1, bs, top)
    return top


def _pop1(top: Level):
    """A population-1 Level -> (RF witness, output JPoint), the population
    axis dropped."""
    return (RF(top.wtns.a[..., 0, :, :], top.wtns.b[..., 0, :, :]),
            JPoint(*(c[..., 0, :] for c in top.out)))


def hierarchical_divisor_witness(curve: CurveSpec, mesh: Mesh, round_pts: JPoint):
    """The argument's (d, S) round tensor over a (dcn, ici) mesh: rounds
    sharded over dcn (no traffic between rounds), each round's point axis
    sharded over its row's ici ranks.  Local trees run to one propagation
    per (round, rank), the n_ici propagations of a round are gathered over
    ici, and the top log2(n_ici) levels run replicated within the row:
    bit-identical to the single-device (d, S) tree.

    round_pts: (d, S) with d % n_dcn == 0 and S % (2 n_ici) == 0, S / n_ici
    a power of two.  Returns this rank's (RF witness (d/n_dcn, La, 16), out
    JPoint (d/n_dcn, 16)): rounds sharded over dcn, replicated over ici."""
    dcn, ici = mesh.axis_names
    n_dcn, n_ici = mesh.shape
    d, s = round_pts.x.shape[0], round_pts.x.shape[1]
    assert d % n_dcn == 0, "pad the round axis to a multiple of n_dcn"
    assert s % (2 * n_ici) == 0, "pad the point list to a multiple of 2*n_ici"
    # bit-identity with the single-device tree needs every local chunk to
    # pair off evenly at every level: a non-power-of-two local size would
    # diverge from the global positional pairing at the odd tails
    assert (s // n_ici) & (s // n_ici - 1) == 0, \
        "local point count must be a power of two for bit-identical pairing"
    assert n_ici & (n_ici - 1) == 0, "n_ici must be a power of two"
    i, j = axis_index(mesh, dcn), axis_index(mesh, ici)
    dl, sl = d // n_dcn, s // n_ici
    local = JPoint(*(c[i * dl:(i + 1) * dl, j * sl:(j + 1) * sl] for c in round_pts))
    lv, b_sem = _local_tree(curve, local)
    top = _gather_top(lv, mesh, ici)
    return _pop1(_replicated_top(curve, top, b_sem))


def _points_shard(mesh: Mesh, pts: JPoint):
    D = mesh.size
    s = pts.x.shape[0]
    assert s % (2 * D) == 0, "pad the point list to a multiple of 2*mesh"
    s_local = s // D
    # see hierarchical_divisor_witness: bit-identical positional pairing
    # needs power-of-two local chunks and a power-of-two rank count
    assert s_local & (s_local - 1) == 0, \
        "local point count must be a power of two for bit-identical pairing"
    assert D & (D - 1) == 0, "mesh size must be a power of two"
    d = axis_index(mesh, mesh.axis_names[0])
    return _rows(pts, slice(d * s_local, (d + 1) * s_local))


def points_sharded_divisor_witness(curve: CurveSpec, mesh: Mesh, pts: JPoint):
    """One round's merge tree with the point axis sharded over the mesh:
    each rank runs the local tree over its contiguous S/D points down to one
    propagation, the D propagations are gathered (a-poly, b-poly and output
    point a rank: the only traffic), and the top log2(D) levels run
    replicated.  The chunks are contiguous and the pairing positional, so
    the coefficients equal compute_divisor_witness_partial's bit for bit.

    pts: (S,) JPoint, S divisible by 2 * mesh size, S / D a power of two.
    Returns (RF witness, output JPoint) on every rank."""
    lv, b_sem = _local_tree(curve, _points_shard(mesh, pts))
    top = _gather_top(lv, mesh, mesh.axis_names[0])
    return _pop1(_replicated_top(curve, top, b_sem))


def points_sharded_divisor_witness_a2a(curve: CurveSpec, mesh: Mesh, pts: JPoint,
                                       dist_min_la: int | None = None,
                                       coeff_sharded: bool = False):
    """points_sharded_divisor_witness with the top levels' fused-merge
    transforms sharded over the mesh by all_to_all: each level above the
    gather whose NTT size n satisfies n >= D^2 and whose a-length reaches
    dist_min_la (default divisor.FUSE_MIN_LA) runs the distributed tail
    (dist_ntt.make_sharded_tail), the smaller ones run replicated.
    Coefficients equal the single-device tree's bit for bit.

    Exceptional merge inputs (a degenerate line, a 2-torsion output, a root
    on an evaluation point) cannot take the exact coefficient fallback
    under the sharded axis.  Every rank's flags are summed over the mesh
    (psum), so all ranks read the same value and, where it is set, all
    rerun the round on the replicated path together (the module's `reruns`
    counts it): exact for every input.

    coeff_sharded=True keeps the level coefficients sharded between levels
    (dist_ntt.run_sharded_top_tree): one final gather a round in place of
    two a level.  Still bit-identical.

    pts: (S,) JPoint, S divisible by 2 * mesh size, S / D a power of two.
    Returns (RF witness, output JPoint) on every rank."""
    if dist_min_la is None:
        dist_min_la = DV.FUSE_MIN_LA
    axis = mesh.axis_names[0]
    D = mesh.size
    lv, b_sem = _local_tree(curve, _points_shard(mesh, pts))
    top = _gather_top(lv, mesh, axis)
    flags: list = []
    if coeff_sharded:
        top = dist_ntt.run_sharded_top_tree(curve, mesh, axis, D, top, b_sem, dist_min_la, flags)
    else:
        tail = dist_ntt.make_sharded_tail(curve, mesh, axis, D, flags)
        bs = b_sem
        while top.out.x.shape[-2] > 1:
            bs *= 2
            la, lb = top.wtns.a.shape[-2], top.wtns.b.shape[-2]
            sharded = la >= dist_min_la and (1 << DV.fused_logn(la, lb)) >= D * D
            top = DV.merge_level(curve, bs + 1, bs, top, tail=tail if sharded else None)
    local = torch.stack(flags).any() if flags else torch.zeros((), dtype=torch.bool,
                                                                  device=mesh.device)
    if bool(psum(local.to(torch.int32).reshape(1), mesh, axis).item()):
        # exceptional inputs: the exact replicated path, on every rank
        global reruns
        reruns += 1
        return points_sharded_divisor_witness(curve, mesh, pts)
    return _pop1(top)
