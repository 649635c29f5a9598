"""All-to-all-sharded NTT pair and the distributed fused merge tail.

Counterpart of the JAX package's parallel/dist_ntt.py, the same math on
torch.distributed (parallel/comm.py) and the port's field layer: on a CUDA
tensor every product, add and inversion below is a kernel launch (ops/ff.py),
on a CPU tensor its plain version.

The merge tree's top levels have few propagations with long polynomials.
This module shards the transforms themselves, bit-identically to the
single-device ntt_dif / intt_dit pair:

  The radix-2 butterfly network is positional: element i never moves, so
  splitting stages across ranks preserves exact values.  With n = D * L
  rows contiguously sharded (rank d owns rows [d*L, (d+1)*L)):

    * the log2(D) stages with half-span m/2 >= L ("top stages") pair rows on
      different ranks.  In the all_to_all-transposed layout (rank d holds rows
      dd*L + d*(L/D) + ll for all dd) every top-stage butterfly is local
      along the dd axis.
    * stages with m <= L are local to contiguous L-blocks and, because
      (d*L + l) mod (m/2) = l mod (m/2), they are exactly the single-device
      size-L transform of the block (w_{2^s} does not depend on n).

  forward (ntt_dif: natural coefficients -> bit-reversed spectrum):
      transposed slice -> log2(D) top DIF stages -> one all_to_all to
      contiguous -> local size-L ntt_dif
  inverse (intt_dit: bit-reversed spectrum -> natural coefficients):
      local size-L intt_dit stages -> one all_to_all to transposed ->
      log2(D) top DIT stages -> 1/n scale -> all_gather and reorder (or one
      more all_to_all back to contiguous shards)

Every function takes the mesh and the axis the transform is sharded over,
with D ranks on it and n >= D^2 (so L % D == 0).  The tails below are the
element-major route of the JAX module; they do not count in
divisor.LEVEL_COUNTS.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import divisor as DV
from ..convert import RF, JPoint, Level, limbs_from_numpy
from ..fields import FieldSpec, N_LIMBS
from ..ops.ff import ff
from ..ops.ntt import _twiddles, intt_dit, ntt_dif
from .comm import Mesh, all_gather, all_to_all, axis_index, axis_size, ppermute


@lru_cache(maxsize=None)
def dist_consts(spec: FieldSpec, logn: int, logd: int):
    """Host-side twiddle tables of the top stages of the 2^logd-way
    distributed pair at size 2^logn: (top_f, top_i), numpy uint32.
    top_f[j] / top_i[j] is the whole (m/2, 16) stage table for m = 2^(logL
    + 1 + j), of which a rank moves only its own rows to its device
    (_top_tw).  The local size-L transforms take ops/ntt's cached tables."""
    logL = logn - logd
    tf = _twiddles(spec, logn, False)
    ti = _twiddles(spec, logn, True)
    return (tuple(tf[s - 1] for s in range(logL + 1, logn + 1)),
            tuple(ti[s - 1] for s in range(logL + 1, logn + 1)))


_TOP_TW_DEV: dict = {}


def _top_tw(spec: FieldSpec, consts, inverse: bool, j: int, L: int, LD: int, d: int,
            device) -> torch.Tensor:
    """(md/2, LD, 16) twiddles of top stage j (md = 2^(j+1)) in the
    transposed layout: rows r*L + d*LD + ll of the whole stage table (the
    twiddle index of a butterfly is its lower row mod m/2 = (dd mod md/2)*L
    + d*LD + ll).  Uploaded once per (field, stage, shape, rank, device)."""
    key = (spec.name, inverse, j, L, LD, d, str(torch.device(device)))
    t = _TOP_TW_DEV.get(key)
    if t is None:
        tab = consts[1 if inverse else 0][j]
        t = _TOP_TW_DEV[key] = limbs_from_numpy(
            np.stack([tab[r * L + d * LD: r * L + d * LD + LD] for r in range(1 << j)]), device)
    return t


def _check(mesh: Mesh, axis: str, D: int, L: int) -> None:
    if axis_size(mesh, axis) != D:
        raise ValueError(f"axis {axis!r} has {axis_size(mesh, axis)} ranks, not {D}")
    if L % D:
        raise ValueError("need n >= D^2 for the transposed layout")


def _fwd_from_transposed(spec: FieldSpec, x, mesh: Mesh, axis: str, D: int, consts, lead):
    """Shared forward tail: x (lead..., D, LD, 16) in the transposed layout
    (x[dd, ll] = row dd*L + d*LD + ll of the natural coefficients) -> this
    rank's contiguous (lead..., L, 16) spectrum shard."""
    k = ff(spec)
    top_f = consts[0]
    LD = x.shape[-2]
    L = LD * D
    d = axis_index(mesh, axis)
    for j in range(len(top_f) - 1, -1, -1):    # top DIF stages, m = n .. 2L
        md = 1 << (j + 1)
        tw = _top_tw(spec, consts, False, j, L, LD, d, x.device)
        x = x.reshape(lead + (D // md, 2, md // 2, LD, N_LIMBS))
        x0, x1 = x[..., 0, :, :, :], x[..., 1, :, :, :]
        x = torch.stack([k.add(x0, x1), k.mul(tw, k.sub(x0, x1))], dim=-4)
    x = x.reshape(lead + (D, LD, N_LIMBS))
    # to contiguous: rank d receives chunk d of every dd -> rows [d*L, (d+1)*L)
    x = all_to_all(x, mesh, axis, dim=len(lead)).reshape(lead + (L, N_LIMBS))
    return ntt_dif(spec, x)


def fwd_from_replicated(spec: FieldSpec, a, mesh: Mesh, axis: str, D: int, consts):
    """a: (..., n, 16) replicated natural coefficients.  Returns this rank's
    (..., L, 16) contiguous shard (rows [d*L, (d+1)*L)) of ntt_dif(a),
    bit-identically."""
    if D == 1:
        return ntt_dif(spec, a)
    n = a.shape[-2]
    L = n // D
    _check(mesh, axis, D, L)
    LD = L // D
    lead = a.shape[:-2]
    d = axis_index(mesh, axis)
    # transposed slice of the replicated input: x[dd, ll] = a[dd*L + d*LD + ll]
    x = a.reshape(lead + (D, D, LD, N_LIMBS))[..., d, :, :]
    return _fwd_from_transposed(spec, x, mesh, axis, D, consts, lead)


def fwd_from_contiguous(spec: FieldSpec, xc, mesh: Mesh, axis: str, D: int, consts):
    """xc: (..., L, 16) contiguous shard (rows [d*L, (d+1)*L)) of an n = D*L
    natural-coefficient array.  Returns this rank's contiguous spectrum
    shard, bit-identical to fwd_from_replicated on the assembled array: one
    all_to_all more (contiguous -> transposed), no all_gather."""
    if D == 1:
        return ntt_dif(spec, xc)
    L = xc.shape[-2]
    _check(mesh, axis, D, L)
    LD = L // D
    lead = xc.shape[:-2]
    # my chunk j (global rows d*L + j*LD + ll) goes to rank j; received[dd] =
    # rank dd's chunk d = rows dd*L + d*LD + ll: the transposed layout
    x = all_to_all(xc.reshape(lead + (D, LD, N_LIMBS)), mesh, axis, dim=len(lead))
    return _fwd_from_transposed(spec, x, mesh, axis, D, consts, lead)


def _inv_to_transposed(spec: FieldSpec, xloc, mesh: Mesh, axis: str, D: int, consts,
                       scale: bool):
    """Shared inverse head: xloc (..., L, 16) contiguous spectrum shard ->
    (lead..., D, LD, 16) natural coefficients in the transposed layout."""
    k = ff(spec)
    top_i = consts[1]
    L = xloc.shape[-2]
    _check(mesh, axis, D, L)
    n, LD = L * D, L // D
    lead = xloc.shape[:-2]
    d = axis_index(mesh, axis)
    x = intt_dit(spec, xloc, scale=False)
    x = all_to_all(x.reshape(lead + (D, LD, N_LIMBS)), mesh, axis, dim=len(lead))
    for j in range(len(top_i)):                 # top DIT stages, m = 2L .. n
        md = 1 << (j + 1)
        tw = _top_tw(spec, consts, True, j, L, LD, d, x.device)
        x = x.reshape(lead + (D // md, 2, md // 2, LD, N_LIMBS))
        even, odd = x[..., 0, :, :, :], x[..., 1, :, :, :]
        t = k.mul(tw, odd)
        x = torch.stack([k.add(even, t), k.sub(even, t)], dim=-4)
    x = x.reshape(lead + (D, LD, N_LIMBS))
    if scale:
        x = k.mul(x, k.const(pow(n, spec.p - 2, spec.p), x.device).expand(x.shape))
    return x


def inv_to_replicated(spec: FieldSpec, xloc, mesh: Mesh, axis: str, D: int, consts,
                      scale: bool = True):
    """xloc: (..., L, 16) contiguous shard of a bit-reversed spectrum.
    Returns the (..., n, 16) natural coefficients on every rank,
    bit-identical to intt_dit on the assembled spectrum."""
    if D == 1:
        return intt_dit(spec, xloc, scale=scale)
    lead = xloc.shape[:-2]
    x = _inv_to_transposed(spec, xloc, mesh, axis, D, consts, scale)
    # row i = dd*L + c*LD + ll: order the axes (dd, c, ll)
    g = all_gather(x, mesh, axis).movedim(0, -3)     # (lead..., dd, c, LD, 16)
    return g.reshape(lead + (-1, N_LIMBS))


def inv_to_contiguous(spec: FieldSpec, xloc, mesh: Mesh, axis: str, D: int, consts,
                      scale: bool = True):
    """xloc: (..., L, 16) contiguous shard of a bit-reversed spectrum.
    Returns this rank's (..., L, 16) contiguous shard of the natural
    coefficients: one all_to_all in place of inv_to_replicated's gather."""
    if D == 1:
        return intt_dit(spec, xloc, scale=scale)
    lead = xloc.shape[:-2]
    x = _inv_to_transposed(spec, xloc, mesh, axis, D, consts, scale)
    # chunk dd to rank dd; received[j] = rank j's chunk d = rows d*L + j*LD + ll
    x = all_to_all(x, mesh, axis, dim=len(lead))
    return x.reshape(lead + (-1, N_LIMBS))


def reshard_double(x, mesh: Mesh, axis: str, D: int):
    """Contiguous coefficient shards at array size n -> contiguous shards at
    size 2n (zero extension): rank t's new shard (2*Lc rows) is [old shard
    2t ; old shard 2t+1], zeros where that shard is past the old array.  Two
    ppermutes of one shard each.  (With D = 1 the one old shard is the lower
    half; the JAX module's pairs, range(D // 2), would zero it.)

    x: (..., Lc, 16) rows [d*Lc, (d+1)*Lc) of the size-n array."""
    lo = ppermute(x, mesh, axis, [(2 * t, t) for t in range((D + 1) // 2)])
    hi = ppermute(x, mesh, axis, [(2 * t + 1, t) for t in range(D // 2)])
    return torch.cat([lo, hi], dim=-2)


def _domain(curve, logn: int, L: int, d: int, device):
    """This rank's rows [d*L, (d+1)*L) of the evaluation domain W and of the
    y^2 values S at size 2^logn (divisor's cached constants)."""
    W, S = DV._fused_consts_dev(curve, logn, device)[:2]
    return W[d * L:(d + 1) * L], S[d * L:(d + 1) * L]


def _eval_domain_tail(k, spectra, W, S, bypass, deg, line, neg_ys, roots):
    """The fused tail's pointwise algebra on this rank's evaluation rows:
    (num_a * dinv, num_b * dinv, unsafe).  unsafe is this rank's 0-d bool:
    a degenerate line, a 2-torsion output or a zero denominator in its rows;
    the caller reduces it over the ranks."""
    fa1, fb1, fa2, fb2 = spectra
    lx, ly, lz = line
    nay, nby = neg_ys
    root_a, root_b = roots
    pv = k.add(k.mul(fa1, fa2), k.mul(k.mul(fb1, fb2), S))
    qv = k.add(k.mul(fa1, fb2), k.mul(fb1, fa2))
    lv = k.add(lz[..., None, :], k.mul(lx[..., None, :], W))
    lyv = ly[..., None, :]
    num_a_v = k.add(k.mul(pv, lv), k.mul(k.mul(qv, S), lyv))
    num_b_v = k.add(k.mul(pv, lyv), k.mul(qv, lv))
    den = k.mul(k.sub(W, root_a[..., None, :]), k.sub(W, root_b[..., None, :]))
    den = torch.where(bypass[..., None, None], k.one(den.device), den)
    torsion = ~bypass & (k.is_zero(nay) | k.is_zero(nby))
    unsafe = deg.any() | torsion.any() | k.is_zero(den).any()
    dinv = k.batch_inv(den, axis=-2)
    return k.mul(num_a_v, dinv), k.mul(num_b_v, dinv), unsafe


def make_sharded_tail(curve, mesh: Mesh, axis: str, D: int, unsafe_out: list):
    """Distributed twin of divisor._merge_tail_fused, for the `tail` hook of
    divisor.merge_level / merge_pairs: the 4 forward transforms, the
    pointwise algebra and the 2 inverse transforms run sharded over the
    evaluation axis; inputs and outputs stay replicated.

    Exceptional inputs (degenerate line, 2-torsion output, a root on an
    evaluation point) cannot be fixed up here: the exact coefficient
    division is a scan over the sharded axis.  Each level appends this
    rank's flag to unsafe_out; the caller reduces the flags over the ranks
    and reruns on the replicated path if any is set."""
    spec = curve.field
    k = ff(spec)
    logd = D.bit_length() - 1

    def tail(curve_, a, b, out, bypass, deg, line, neg_ys, roots, _consts):
        la, lb = a.wtns.a.shape[-2], a.wtns.b.shape[-2]
        logn = DV.fused_logn(la, lb)
        n = 1 << logn
        dc = dist_consts(spec, logn, logd)
        W, S = _domain(curve_, logn, n // D, axis_index(mesh, axis), a.wtns.a.device)
        spectra = [fwd_from_replicated(spec, DV._pad_poly(arr, n), mesh, axis, D, dc)
                   for arr in (a.wtns.a, a.wtns.b, b.wtns.a, b.wtns.b)]
        qa, qb, unsafe = _eval_domain_tail(k, spectra, W, S, bypass, deg, line, neg_ys, roots)
        unsafe_out.append(unsafe)
        wa = inv_to_replicated(spec, qa, mesh, axis, D, dc)
        wb = inv_to_replicated(spec, qb, mesh, axis, D, dc)
        return Level(out, RF(wa[..., :la + lb + 2, :], wb[..., :la + lb + 1, :]))

    return tail


# ---------------------------------------------------------------------------
# the sharded-coefficient top of the tree
# ---------------------------------------------------------------------------

def sharded_merge_level_coeffs(curve, mesh: Mesh, axis: str, D: int, out_pts: JPoint,
                               wa_sh, wb_sh, la: int, lb: int, a_sem: int, b_sem: int,
                               unsafe_out: list):
    """One merge level with coefficient-sharded witness in and out: only the
    (small) output points are replicated between levels.  Per level the
    transforms' all_to_alls and, where the NTT size doubles, the
    two-ppermute reshard, all moving n/D rows a rank.

    out_pts: replicated (m, 16) JPoint of the population (m even).
    wa_sh / wb_sh: (m, Lc, 16) contiguous shards of each propagation's
    zero-extended size-(D*Lc) coefficient array.  la / lb: the inputs'
    semantic lengths; a_sem / b_sem: the level's output lengths (rows past
    them are zero for honest inputs, so nothing is trimmed).

    Returns (out_pts', wa_sh', wb_sh', n), the outputs sharded at this
    level's NTT size n; appends this rank's unsafe flag as
    make_sharded_tail does."""
    spec = curve.field
    k = ff(spec)
    a_out = JPoint(*(c[0::2] for c in out_pts))
    b_out = JPoint(*(c[1::2] for c in out_pts))
    out, bypass, deg, line, neg_ys, roots = DV.merge_head(curve, a_out, b_out)

    logn = DV.fused_logn(la, lb)
    n = 1 << logn
    n_prev = D * wa_sh.shape[-2]
    assert n in (n_prev, 2 * n_prev), (n, n_prev)
    assert a_sem >= 1 and la + lb + 2 <= n and a_sem <= la + lb + 2
    dc = dist_consts(spec, logn, D.bit_length() - 1)
    W, S = _domain(curve, logn, n // D, axis_index(mesh, axis), wa_sh.device)

    def halves(arr):
        a_half, b_half = arr[0::2], arr[1::2]
        if n == 2 * n_prev:
            a_half = reshard_double(a_half, mesh, axis, D)
            b_half = reshard_double(b_half, mesh, axis, D)
        return a_half, b_half

    wa_a, wa_b = halves(wa_sh)   # a-side and b-side a-polys, (m/2, L, 16)
    wb_a, wb_b = halves(wb_sh)
    spectra = [fwd_from_contiguous(spec, arr, mesh, axis, D, dc)
               for arr in (wa_a, wb_a, wa_b, wb_b)]
    qa, qb, unsafe = _eval_domain_tail(k, spectra, W, S, bypass, deg, line, neg_ys, roots)
    unsafe_out.append(unsafe)
    return (out, inv_to_contiguous(spec, qa, mesh, axis, D, dc),
            inv_to_contiguous(spec, qb, mesh, axis, D, dc), n)


def run_sharded_top_tree(curve, mesh: Mesh, axis: str, D: int, top: Level, bs: int,
                         min_la: int, unsafe_out: list) -> Level:
    """Run a replicated Level `top` (population a power of two) to
    population 1 with the coefficients sharded between levels.  Levels too
    small to shard (la < min_la or NTT size < D^2) run the replicated
    merge_level; at the switch the replicated coefficients are sliced into
    contiguous shards (no collective), and only the final witness is
    gathered back.  Which route a level takes depends on shapes alone, so
    every rank takes the same.

    bs: the entering b_sem.  Returns a replicated Level at population 1,
    the witness trimmed to its semantic lengths; bit-identical to the
    replicated tree for honest inputs, exceptional ones flag unsafe_out."""
    while top.out.x.shape[-2] > 1:
        la, lb = top.wtns.a.shape[-2], top.wtns.b.shape[-2]
        if la >= min_la and (1 << DV.fused_logn(la, lb)) >= D * D:
            break
        bs *= 2
        top = DV.merge_level(curve, bs + 1, bs, top)
    if top.out.x.shape[-2] == 1:
        return top

    la, lb = top.wtns.a.shape[-2], top.wtns.b.shape[-2]
    n = 1 << DV.fused_logn(la, lb)
    L = n // D
    d = axis_index(mesh, axis)
    wa_sh = DV._pad_poly(top.wtns.a, n)[..., d * L:(d + 1) * L, :]
    wb_sh = DV._pad_poly(top.wtns.b, n)[..., d * L:(d + 1) * L, :]
    out_pts = top.out
    while out_pts.x.shape[-2] > 1:
        bs *= 2
        out_pts, wa_sh, wb_sh, n = sharded_merge_level_coeffs(
            curve, mesh, axis, D, out_pts, wa_sh, wb_sh, la, lb, bs + 1, bs, unsafe_out)
        la, lb = bs + 1, bs

    # population 1: one gather of the witness
    wa = all_gather(wa_sh, mesh, axis).movedim(0, -3).reshape(wa_sh.shape[:-2] + (n, N_LIMBS))
    wb = all_gather(wb_sh, mesh, axis).movedim(0, -3).reshape(wb_sh.shape[:-2] + (n, N_LIMBS))
    return Level(out_pts, RF(wa[..., :la, :], wb[..., :lb, :]))
