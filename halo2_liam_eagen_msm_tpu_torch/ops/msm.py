"""Pippenger multi-scalar multiplication (best_multiexp) and the per-round
digit sums of the Eagen argument's carry stage (round_sums).

Counterpart of the JAX package's ops/msm.py.

Sort-first bucket method with no scatter of points:

  for each c-bit window:
    1. bucket id per point (bit extraction from the scalar limbs)
    2. stable sort of the point indices by bucket id; one gather of the
       packed (x, y) rows into sorted order
    3. ONE unsegmented inclusive prefix scan of the sorted points, blinded:
       every lane's carry starts at the fixed offset point T, so the scan can
       use the exception-free XYZZ + affine add; exceptions are flagged
    4. bucket sums = prefix[range_end] - prefix[range_start - 1], with range
       boundaries from a histogram of the bucket ids (subtraction is free:
       negate y), queried at O(2^c) positions only
    5. triangle reduction: suffix scan of the bucket table, then total sum
       (sum_b b*B_b = sum_k suffix_k)
  window fold: result = sum_w 2^(cw) G_w by c doublings per window

If any flag is set (inputs aligned with T), the whole MSM is recomputed with
complete adds (the "safe" flavor), so the result is exact for every input.
round_sums keeps the flags per round and recomputes only the flagged rounds.

With config.RADIX_MSM on, step 2 of a large window (see _radix_ok) is the
radix reorder of ops/radix.py instead: a bucket-contiguous stream with zero
rows between the coarse partitions, scanned like the sorted rows; the rows
it spills take the classic sort and gather and their own scan, and the two
bucket tables are added before the triangle.  A window that overflows the
reorder's spill rows sets the flag, so the safe flavor, which always takes
the classic route, redoes the MSM.  Where the scalars' bit bound leaves the
top window fewer than c bits, it gets its own narrower width c_top there
(split_top in _best_multiexp).

Point arrays are (..., N, 16) per coordinate: every scan here runs along the
last point axis and lets leading axes ride along.  On the CPU the windows of
one MSM run together on such a leading axis (eager PyTorch pays per op, not
per element, at test sizes); on the card they run one after another.  There a
window of at least FUSED_SCAN_MIN_ROWS points goes through the fused scan
kernel (cuda_ff.fused_madd_scan_xyzz); a smaller one takes the stepwise
blinded scan (prefix_scan_parts_affine_fast), whose w steps are one launch of
cuda_ff.ec_madd_xyzz_fast_scan, as the JAX package does for windows that are
no multiple of its fused scan's unit.
"""

from __future__ import annotations

import math

import torch

from .. import config
from ..convert import limbs_from_numpy
from ..fields import CurveSpec, LIMB_BITS, N_LIMBS
from ..limbs import ints_to_limbs, ints_to_mont_limbs
from . import cuda_ff
from . import radix as RX
from .ec import EC, JPoint, SUM_G, ec


# Card windows below this many points take the stepwise blinded scan (one
# launch of ec_madd_xyzz_fast's scan of w = _pick_block_width steps, four
# lanes a carry, then the offsets scan over n/w lanes), larger ones the fused
# scan kernel, which pads to SCAN_W rows a lane and so has only n/64 threads,
# each walking 64 dependent steps.  The JAX package draws the line at its
# fused scan's unit of 64 * 1024 rows.  Here chip_smoke.py times one window by
# both routes at 2^6 to 2^16 points.  On the device's busy time the stepwise
# route is the cheaper one at every size timed; on the wall clock, which the
# host paces, neither leads across the sizes.  So the line is not a measured
# crossover: it keeps the stepwise route alive, at sizes where no prover's
# traffic lies, as the route to widen once a window's launches no longer wait
# on the host and the device's time is what counts.
FUSED_SCAN_MIN_ROWS = 1 << 8

# The radix reorder (config.RADIX_MSM) takes windows of at least
# RADIX_MIN_ROWS points, a multiple of RADIX_TILE, which is also its tile
# height T: the JAX package's thresholds.  The tests lower both to take the
# route at a few hundred points.
RADIX_MIN_ROWS = 1 << 17
RADIX_TILE = 4096


def _radix_ok(n: int, c: int, flavor: str) -> bool:
    """Whether a window of n points at width c takes the radix reorder: the
    route is on, the flavor is not the safe one, and the shape suits it (its
    coarse split needs c >= 8)."""
    return (config.use_radix_msm() and flavor != "safe" and n >= RADIX_MIN_ROWS
            and n % RADIX_TILE == 0 and c >= 8)

# ---------------------------------------------------------------------------
# generic blocked scans over point arrays
# ---------------------------------------------------------------------------

def _rows(a, idx):
    """a (..., N, 16), idx (..., Q) integer positions along N (leading axes
    broadcast) -> (..., Q, 16)."""
    if idx.dim() == 1:
        return a.index_select(-2, idx)
    lead = torch.broadcast_shapes(a.shape[:-2], idx.shape[:-1])
    a = a.expand(lead + a.shape[-2:])
    idx = idx.expand(lead + idx.shape[-1:])
    return torch.gather(a, -2, idx[..., None].expand(idx.shape + (N_LIMBS,)))


def _take(p: JPoint, idx) -> JPoint:
    return JPoint(*(_rows(c, idx) for c in p))


def _slice(p: JPoint, sl) -> JPoint:
    return JPoint(*(c[..., sl, :] for c in p))


def _cat(parts) -> JPoint:
    return JPoint(*(torch.cat([p[k] for p in parts], dim=-2) for k in range(3)))


def _lead(p: JPoint):
    return tuple(p.x.shape[:-2])


def _pick_block_width(n: int, on_card: bool) -> int:
    """Sequential steps per block for the blocked scans.  On the card few wide
    steps win, while each step stays wide: keep g = n/w >= 2048 lanes.  On
    the CPU a ~sqrt split balances the two scan levels."""
    if on_card:
        return max(2, min(64, n // SUM_G))
    g = max(1, min(1 << ((int(math.isqrt(n - 1)) + 1).bit_length() - 1), 4096))
    # w >= 2 guarantees the block count g strictly shrinks, terminating the
    # parts -> block-totals-prefix recursion
    return max(2, -(-n // g))


def _pow2_pad(n: int) -> int:
    """Padding that takes n up to the next power of two (0 if already)."""
    return (1 << max(n - 1, 1).bit_length()) - n if n & (n - 1) else 0


def _pad_pts(E: EC, p: JPoint, pad: int) -> JPoint:
    if not pad:
        return p
    return _cat([p, E.identity(_lead(p) + (pad,), p.x.device)])


def _to_cols(arr, g, w):
    """(..., g*w, 16) -> (w, ..., g, 16): block j = elements [j*w, (j+1)*w)."""
    return arr.reshape(arr.shape[:-2] + (g, w, N_LIMBS)).movedim(-2, 0)


def _from_cols(steps, g, w):
    """w tensors (..., g, 16), one per step -> (..., g*w, 16)."""
    out = torch.stack(steps, dim=-2)
    return out.reshape(out.shape[:-3] + (g * w, N_LIMBS))


def _offsets_from_totals(E: EC, totals: JPoint) -> JPoint:
    """Exclusive prefix of the block totals: offsets[j] = sum of blocks < j."""
    tot_prefix = prefix_scan_points(E, totals)
    ident = E.identity(_lead(totals) + (1,), totals.x.device)
    return _cat([ident, _slice(tot_prefix, slice(None, -1))])


def prefix_scan_parts(E: EC, p: JPoint):
    """Blocked inclusive prefix-sum DECOMPOSITION of a (..., N) JPoint array:
    returns (inner: JPoint (..., g*w), offsets: JPoint (..., g), w) with

        inclusive_prefix[i] = offsets[i // w] + inner[i]      (i < N)

    The full prefix array is never materialized: Pippenger only queries
    O(2^c) boundary positions per window."""
    n = p.x.shape[-2]
    w = _pick_block_width(n, p.x.is_cuda)
    g = -(-n // w)
    p = _pad_pts(E, p, g * w - n)
    cols = [_to_cols(c, g, w) for c in p]
    carry = E.identity(_lead(p) + (g,), p.x.device)
    steps = []
    for t in range(w):
        carry = E.add(carry, JPoint(*(c[t] for c in cols)))
        steps.append(carry)
    inner = JPoint(*(_from_cols([s[k] for s in steps], g, w) for k in range(3)))
    if g == 1:
        return inner, E.identity(_lead(p) + (1,), p.x.device), w
    return inner, _offsets_from_totals(E, carry), w


def prefix_scan_parts_affine(E: EC, ax, ay, aident):
    """prefix_scan_parts for AFFINE inputs (x, y, identity mask): the inner
    scan uses complete mixed additions, all w steps in one kernel launch on
    the card (cuda_ff.ec_add_mixed_scan), the loop of its plain version on
    the CPU."""
    n = ax.shape[-2]
    lead = tuple(ax.shape[:-2])
    w = _pick_block_width(n, ax.is_cuda)
    g = -(-n // w)
    pad = g * w - n
    if pad:
        zeros = torch.zeros(lead + (pad, N_LIMBS), dtype=ax.dtype, device=ax.device)
        ax = torch.cat([ax, zeros], dim=-2)
        ay = torch.cat([ay, zeros], dim=-2)
        aident = torch.cat([aident, torch.ones(lead + (pad,), dtype=torch.bool,
                                               device=ax.device)], dim=-1)
    scan = cuda_ff.ec_add_mixed_scan if ax.is_cuda else cuda_ff.ec_add_mixed_scan_plain
    inner, totals = scan(E.curve, *E.identity(lead + (g,), ax.device), ax, ay, aident, w)
    inner, carry = JPoint(*inner), JPoint(*totals)
    if g == 1:
        return inner, E.identity(lead + (1,), ax.device), w
    return inner, _offsets_from_totals(E, carry), w


def _unblind_totals(E: EC, tx, ty, tzz, tzzz) -> JPoint:
    """XYZZ lane totals, each carrying one T -> true Jacobian block totals
    (complete adds, only g elements)."""
    totals_t = E.xyzz_to_jacobian(tx, ty, tzz, tzzz)
    t = E.offset_point(tuple(tx.shape[:-1]), device=tx.device)
    return E.add(totals_t, E.neg(t))


def prefix_scan_parts_affine_fast(E: EC, ax, ay):
    """Offset-blinded fast variant of prefix_scan_parts_affine: every block
    carry is seeded at the fixed blinding point T (EC.offset_point), so the
    inner scan can use the exception-free XYZZ mixed add (2 sqr + 8 mul),
    all w steps in one kernel launch on the card
    (cuda_ff.ec_madd_xyzz_fast_scan), the loop of its plain version on the
    CPU.
    Exceptional slots (identity carry / carry == +-Q) cannot occur unless
    inputs are aligned with T; they are detected and reported so the caller
    can fall back to the safe scan.  The affine identity is encoded as
    ay == 0.

    Returns (inner, offsets, w, exc):
        inner    XYZZ 4-tuple of (..., g*w, 16) tensors,
        offsets  Jacobian JPoint (..., g),
    with offsets[i // w] + inner[i] = T + true_inclusive_prefix[i] (exactly
    one T regardless of position: block totals are un-blinded before the
    offsets recursion), and exc a (...,) bool."""
    n = ax.shape[-2]
    lead = tuple(ax.shape[:-2])
    w = _pick_block_width(n, ax.is_cuda)
    g = -(-n // w)
    pad = g * w - n
    if pad:
        zeros = torch.zeros(lead + (pad, N_LIMBS), dtype=ax.dtype, device=ax.device)
        ax = torch.cat([ax, zeros], dim=-2)
        ay = torch.cat([ay, zeros], dim=-2)
    scan = cuda_ff.ec_madd_xyzz_fast_scan if ax.is_cuda \
        else cuda_ff.ec_madd_xyzz_fast_scan_plain
    inner, totals, exc_v = scan(E.curve, *E.xyzz_offset(lead + (g,), ax.device), ax, ay, w)
    exc = exc_v.any(dim=-1)
    if g == 1:
        return inner, E.identity(lead + (1,), ax.device), w, exc
    return inner, _offsets_from_totals(E, _unblind_totals(E, *totals)), w, exc


def prefix_scan_parts_packed_fast(E: EC, pay_sorted, w: int = cuda_ff.SCAN_W):
    """Fused-kernel variant of prefix_scan_parts_affine_fast consuming the
    PACKED sorted rows (N, 16) directly: the whole w-step blinded scan is ONE
    kernel launch with the XYZZ carry in registers
    (cuda_ff.fused_madd_scan_xyzz).  N must be a multiple of w.

    Returns (inner, offsets, w, exc) where inner is the XYZZ 4-tuple in
    (w, 16, g) layout (element i lives at [i % w, :, i // w]) and offsets/exc
    follow prefix_scan_parts_affine_fast's contract."""
    xi, yi = E.offset_point_ints()
    t_limbs = tuple(tuple(int(v) for v in ints_to_mont_limbs([c], E.curve.field)[0])
                    for c in (xi, yi))
    scan = cuda_ff.fused_madd_scan_xyzz if pay_sorted.is_cuda \
        else cuda_ff.fused_madd_scan_xyzz_plain
    inner, totals, exc_v = scan(E.curve, t_limbs, pay_sorted, w)
    exc = exc_v.any()
    if totals[0].shape[0] == 1:
        return inner, E.identity((1,), pay_sorted.device), w, exc
    return inner, _offsets_from_totals(E, _unblind_totals(E, *totals)), w, exc


def _flip(p: JPoint) -> JPoint:
    return JPoint(*(torch.flip(c, dims=(-2,)) for c in p))


def _repeat(p: JPoint, w: int) -> JPoint:
    return JPoint(*(torch.repeat_interleave(c, w, dim=-2) for c in p))


def prefix_scan_points_fast(E: EC, p: JPoint, reverse: bool = False):
    """Blinded fast variant of prefix_scan_points: blocked scan over
    exception-flagging generic adds (EC.add_fast), block carries seeded at T.
    Returns (prefix, exc) where every materialized prefix value carries
    EXACTLY ONE T (block totals are un-blinded before the offsets recursion)
    and exc is a (...,) bool ORing all flags.  Identity inputs pass through
    exactly (empty-bucket slots)."""
    n = p.x.shape[-2]
    lead = _lead(p)
    dev = p.x.device
    if n == 1:
        # single value: true prefix, NOT blinded
        return p, torch.zeros(lead, dtype=torch.bool, device=dev)
    if reverse:
        out, exc = prefix_scan_points_fast(E, _flip(p), reverse=False)
        return _flip(out), exc
    w = _pick_block_width(n, p.x.is_cuda)
    g = -(-n // w)
    p = _pad_pts(E, p, g * w - n)
    cols = [_to_cols(c, g, w) for c in p]
    carry = E.offset_point(lead + (g,), device=dev)
    exc_v = torch.zeros(lead + (g,), dtype=torch.bool, device=dev)
    steps = []
    for t in range(w):
        carry, e = E.add_fast(carry, JPoint(*(c[t] for c in cols)))
        exc_v = exc_v | e
        steps.append(carry)
    exc = exc_v.any(dim=-1)
    inner = JPoint(*(_from_cols([s[k] for s in steps], g, w) for k in range(3)))
    if g == 1:
        return _slice(inner, slice(0, n)), exc
    totals = E.add(carry, E.neg(E.offset_point(lead + (g,), device=dev)))  # safe un-blind
    offsets = _offsets_from_totals(E, totals)
    full, e2 = E.add_fast(_repeat(offsets, w), inner)
    return _slice(full, slice(0, n)), exc | e2.any(dim=-1)


def sum_points_fast(E: EC, p: JPoint):
    """Log-halving batch sum over exception-flagging fast adds.  Returns
    (point, exc).  Identity slots pass through; only doubling collisions
    flag."""
    n = p.x.shape[-2]
    exc = torch.zeros(_lead(p), dtype=torch.bool, device=p.x.device)
    while n > 1:
        half = n // 2
        s, e = E.add_fast(_slice(p, slice(0, half)), _slice(p, slice(half, 2 * half)))
        exc = exc | e.any(dim=-1)
        p = _cat([s, _slice(p, slice(2 * half, None))]) if n % 2 else s
        n = half + n % 2
    return JPoint(*(c[..., 0, :] for c in p)), exc


def prefix_scan_points(E: EC, p: JPoint, reverse: bool = False) -> JPoint:
    """Inclusive prefix (or suffix) sums of a (..., N) JPoint array under EC
    addition, materialized.  On the card, sizes up to 4096 use a Hillis-Steele
    log-depth scan: log2(N) full-width batched adds (N log N adds in all, but
    about 12 launches; launch latency dominates the small compute there).
    Larger arrays use the blocked parts decomposition (~2.1N adds).  On the
    CPU, up to 64 points are one sequential scan."""
    n = p.x.shape[-2]
    if n == 1:
        return p
    if reverse:
        return _flip(prefix_scan_points(E, _flip(p), reverse=False))
    lead = _lead(p)
    dev = p.x.device
    if not p.x.is_cuda and n <= 64:
        carry = E.identity(lead, dev)
        steps = []
        for t in range(n):
            carry = E.add(carry, JPoint(*(c[..., t, :] for c in p)))
            steps.append(carry)
        return JPoint(*(torch.stack([s[k] for s in steps], dim=-2) for k in range(3)))
    if p.x.is_cuda and n <= (1 << 12):
        d = 1
        while d < n:
            shifted = _cat([E.identity(lead + (d,), dev), _slice(p, slice(None, -d))])
            p = E.add(p, shifted)
            d *= 2
        return p
    inner, offsets, w = prefix_scan_parts(E, p)
    if offsets.x.shape[-2] == 1:
        return _slice(inner, slice(0, n))
    full = E.add(_repeat(offsets, w), inner)
    return _slice(full, slice(0, n))


# ---------------------------------------------------------------------------
# Pippenger
# ---------------------------------------------------------------------------

def _pack_pair(ax, ay):
    """(N, 16) x/y 16-bit-limb tensors -> (N, 16) packed rows (two limbs per
    word, x in words 0..7, y in words 8..15): one 64-byte row per point for
    the sorted-order gather, and exactly the 8 x 32-bit limbs the scan kernel
    computes on.  The affine identity (0, 0) stays all-zero.  A word with
    bit 31 set is a negative int32; only its bit pattern matters."""
    def pack(v):
        return v[..., 0::2] | (v[..., 1::2] << LIMB_BITS)
    return torch.cat([pack(ax), pack(ay)], dim=-1)


_unpack_pair = cuda_ff.unpack_rows


def window_digits(scalars, c: int, num_windows: int):
    """Extract c-bit windows from (N, 16) scalar limb tensors (canonical, not
    Montgomery).  Returns (num_windows, N) int32 bucket ids.

    A c-bit window (c <= 16) spans at most two 16-bit limbs, so each window
    is two shifts + an or + a mask."""
    if c > LIMB_BITS:
        raise ValueError(f"window width {c} exceeds {LIMB_BITS}")
    total_bits = N_LIMBS * LIMB_BITS
    mask = (1 << c) - 1
    out = []
    for w in range(num_windows):
        lo_bit = w * c
        limb, off = divmod(lo_bit, LIMB_BITS)
        if lo_bit >= total_bits:
            out.append(torch.zeros_like(scalars[:, 0]))
            continue
        acc = scalars[:, limb] >> off
        if off + c > LIMB_BITS and limb + 1 < N_LIMBS:
            acc = acc | (scalars[:, limb + 1] << (LIMB_BITS - off))
        out.append(acc & mask)
    return torch.stack(out)


def bucket_bounds_hist(digits_w, c: int):
    """hi[b] = (#digits <= b) - 1 for b in [0, 2^c): the right boundary of
    every bucket's run in the sorted order, from a histogram and a cumulative
    sum.  digits_w: (..., N); returns (..., 2^c) int64."""
    nb = 1 << c
    lead = tuple(digits_w.shape[:-1])
    flat = digits_w.reshape(-1, digits_w.shape[-1]).to(torch.int64)
    rows = flat.shape[0]
    flat = flat + torch.arange(rows, device=flat.device)[:, None] * nb
    counts = torch.bincount(flat.reshape(-1), minlength=rows * nb)
    return counts.reshape(lead + (nb,)).cumsum(-1) - 1


def pick_window(n: int) -> int:
    """Window size heuristic.  Per-window cost is ~N mixed adds for the
    sorted prefix scan plus ~6*2^c adds for boundary queries + bucket
    reduction, so the optimum sits near log2(N) - 5 (flat within +-1)."""
    if n < 4:
        return 1
    return min(max(int(math.log2(n)) - 5, 1), 16)


def best_multiexp(
    curve: CurveSpec,
    scalars,
    pts: JPoint,
    c: int | None = None,
    max_scalar_bits: int | None = None,
) -> JPoint:
    """MSM sum_i s_i * P_i.

    scalars: (N, 16) int32 canonical (NOT Montgomery) scalar-field limbs;
    pts: (N,) batched JPoint on the same device.  Returns a single JPoint.
    Result-compatible with pyref.ec_msm.

    max_scalar_bits: promise that all scalars fit that many bits; cuts the
    window count proportionally.

    Runs the blinded fast flavor and checks its exception flag on the host;
    only if it is set (inputs aligned with the blinding point, never honest
    ones) the MSM is redone with complete adds."""
    n = scalars.shape[0]
    if c is None:
        c = pick_window(n)
    bits = max_scalar_bits or curve.scalar_field.p.bit_length()
    res, exc = _best_multiexp(curve, c, bits, "fast", scalars, pts)
    if bool(exc):
        return _best_multiexp(curve, c, bits, "safe", scalars, pts)
    return res


def _make_one_window(E: EC, c: int, flavor: str, pay, n: int):
    """Build the per-window bucket-sum closure shared by best_multiexp and
    round_sums (each round of the Eagen argument's carry stage IS one
    Pippenger window: S_k = sum_j d_kj * P_j with d_kj < base <= 2^c).

    pay: (N, 16) packed affine rows (_pack_pair); returns one_window(keys)
    mapping (..., N) int32 keys in [0, 2^c) to sum_b b * B_b: a point for the
    "safe" flavor, (point, exc) for "fast"."""
    dev = pay.device

    def window_from_scan_safe(hi, inner, offsets, w):
        """Bucket sums + triangle reduction from a prefix-scan decomposition,
        all complete (safe) adds.  hi[b] (right boundary of bucket b's sorted
        run; -1 if empty prefix) serves both ends of every range: for integer
        keys the left boundary of bucket b is the right boundary of b-1."""

        def pref_at(idx):
            # prefix[i] = offsets[i // w] + inner[i], queried at O(2^c)
            # boundary positions only (the full array is never built)
            safe = idx.clamp(min=0)
            pt = E.add(_take(offsets, safe // w), _take(inner, safe))
            return E.select(idx >= 0, pt, E.identity(tuple(idx.shape), dev))

        pref = pref_at(hi)  # (2^c,) prefix sums at bucket right boundaries
        bucket = E.add(_slice(pref, slice(1, None)),
                       E.neg(_slice(pref, slice(0, -1))))  # b = 1 .. 2^c-1
        bucket = _pad_pts(E, bucket, _pow2_pad(bucket.x.shape[-2]))
        sfx = prefix_scan_points(E, bucket, reverse=True)
        return E.sum(sfx, axis=-2)

    def bucket_diffs_fast(hi, inner_at, offsets, w):
        """Bucket sums (b = 1 .. 2^c-1) from a BLINDED scan decomposition
        (every prefix carries exactly one T; the empty prefix IS T, so
        bucket differences are TRUE values).  `inner_at(idx)` gives the XYZZ
        4-tuple of inner prefixes at positions idx; only the O(2^c) queried
        values are converted to Jacobian.  Returns (bucket, exc)."""

        def pref_at(idx):
            safe = idx.clamp(min=0)
            iq = E.xyzz_to_jacobian(*inner_at(safe))
            pt, e = E.add_fast(_take(offsets, safe // w), iq)
            basep = E.offset_point(tuple(idx.shape), device=dev)
            return E.select(idx >= 0, pt, basep), e.any(dim=-1)

        pref, e1 = pref_at(hi)
        bucket, e2 = E.add_fast(_slice(pref, slice(1, None)),
                                E.neg(_slice(pref, slice(0, -1))))
        return bucket, e1 | e2.any(dim=-1)

    def triangle_fast(bucket):
        """sum_b b * B_b via the suffix-scan triangle, re-blinded fast scans;
        the accumulated copies of T are cancelled with one precomputed
        [nb]T.  Returns (point, exc)."""
        nb = bucket.x.shape[-2]  # 2^c - 1
        lead = _lead(bucket)
        if nb > 64:
            # pad to 2^c: identity slots pass through add_fast unflagged and
            # carry exactly one T each, so the [nb]T un-blind below stays
            # exact with nb = the PADDED count
            bucket = _pad_pts(E, bucket, _pow2_pad(nb))
            nb = bucket.x.shape[-2]
        if nb <= 64:
            # small windows: the complete-add triangle is as cheap as the
            # blinded one at this size and immune to the T+T collisions an
            # ALL-EMPTY bucket table produces systematically (every suffix
            # equals T and the blinded sum doubles)
            sfx = prefix_scan_points(E, bucket, reverse=True)
            return E.sum(sfx, axis=-2), torch.zeros(lead, dtype=torch.bool, device=dev)
        sfx, e3 = prefix_scan_points_fast(E, bucket, reverse=True)
        # the final sum uses COMPLETE adds: runs of empty top buckets (any
        # window whose digits don't fill c bits, e.g. the most-significant
        # window of a full-width MSM) make long runs of sfx equal exactly T,
        # and a blinded sum would pair equal values into systematic doubling
        # exceptions
        s = E.sum(sfx, axis=-2)
        s = E.add(s, E.neg(E.offset_point(lead, mult=nb, device=dev)))  # safe un-blind
        return s, e3

    def scan_packed_padded(rows, n_rows):
        """Blinded fused-kernel scan over packed rows, zero-padded to the
        kernel's unit of SCAN_W rows (zero rows are affine identities and
        pass through); returns (inner_at, offsets, w, exc)."""
        pad = -n_rows % cuda_ff.SCAN_W
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
        inner, offsets, w, exc = prefix_scan_parts_packed_fast(E, rows)

        def inner_at(safe):
            return tuple(cc[safe % w, :, safe // w] for cc in inner)

        return inner_at, offsets, w, exc

    def scan_rows(rows):
        """Blinded scan of (..., m, 16) packed rows in bucket order: on the
        card the fused scan kernel from FUSED_SCAN_MIN_ROWS rows on, else the
        stepwise affine scan (leading axes ride along).  Returns (inner_at,
        offsets, w, exc)."""
        m = rows.shape[-2]
        if rows.is_cuda and m >= FUSED_SCAN_MIN_ROWS:
            return scan_packed_padded(rows, m)
        sx, sy = _unpack_pair(rows)
        inner, offsets, w, exc = prefix_scan_parts_affine_fast(E, sx, sy)

        def inner_at(safe):
            return tuple(_rows(cc, safe) for cc in inner)

        return inner_at, offsets, w, exc

    plan = RX.make_plan(n, c, RADIX_TILE) if _radix_ok(n, c, flavor) else None

    def radix_window_sum(keys_in):
        """One window through the radix reorder: the main stream's bucket
        sums plus the spilled rows' (both tables hold true values; empty
        buckets are identities and pass add_fast unflagged), then the
        triangle.  The main stream always takes the fused scan, as in the JAX
        package (its kernel on the card, its plain version on the CPU).
        Returns (point, exc)."""
        sorted_pay, hi_r, spill_pay, spill_keys, overflow = RX.radix_window(plan, keys_in, pay)
        inner_at, offsets, w, exc = scan_packed_padded(sorted_pay, plan.n_ext)
        bucket_m, e_m = bucket_diffs_fast(hi_r.long(), inner_at, offsets, w)

        srows = spill_pay[torch.sort(spill_keys, stable=True).indices]
        sin_at, soff, sw, s_exc = scan_rows(srows)
        bucket_s, e_s = bucket_diffs_fast(bucket_bounds_hist(spill_keys, c), sin_at, soff, sw)

        bucket, e_c = E.add_fast(bucket_m, bucket_s)
        fast, e_t = triangle_fast(bucket)
        return fast, overflow | exc | e_m | s_exc | e_s | e_c.any() | e_t

    def one_window(keys_in):
        def classic_rows_hi():
            order = torch.sort(keys_in, dim=-1, stable=True).indices
            return pay[order], bucket_bounds_hist(keys_in, c)

        def safe_path():
            rows, hi = classic_rows_hi()
            sx, sy = _unpack_pair(rows)
            # affine identity (0, 0) <=> all-zero y row (prime-order curves)
            sid = (sy == 0).all(dim=-1)
            inner_s, offsets_s, ws = prefix_scan_parts_affine(E, sx, sy, sid)
            return window_from_scan_safe(hi, inner_s, offsets_s, ws)

        # the blinded fast path is a throughput feature; at tiny N the safe
        # path alone is cheaper
        if flavor == "safe" or n < 64:
            res = safe_path()
            if flavor == "safe":
                return res
            return res, torch.zeros(tuple(keys_in.shape[:-1]), dtype=torch.bool,
                                    device=dev)

        if plan is not None:
            if keys_in.dim() == 1:
                return radix_window_sum(keys_in)
            # the CPU's batch of windows: the reorder takes one at a time
            outs = [radix_window_sum(k) for k in keys_in]
            return (JPoint(*(torch.stack([o[0][i] for o in outs]) for i in range(3))),
                    torch.stack([o[1] for o in outs]))

        rows, hi = classic_rows_hi()
        inner_at, offsets, w, exc = scan_rows(rows)
        bucket, e1 = bucket_diffs_fast(hi, inner_at, offsets, w)
        fast, e2 = triangle_fast(bucket)
        return fast, exc | e1 | e2

    return one_window


# windows of one MSM that run together on a leading axis on the CPU: as many
# as keep windows * max(n, 2^c) rows at or below this
_CPU_WINDOW_ROWS = 1 << 16


def _run_windows(one_window, digits, n: int, c: int, flavor: str):
    """Run one_window over the (W, N) keys: one window after another on the
    card, several on a leading axis on the CPU.  Returns ((W,) JPoint of
    window sums, (W,) bool flags for the "fast" flavor, else None)."""
    num_windows = digits.shape[0]
    if digits.is_cuda:
        batches = [digits[i] for i in range(num_windows)]
    else:
        wb = max(1, _CPU_WINDOW_ROWS // max(n, 1 << c))
        batches = [digits[i:i + wb] for i in range(0, num_windows, wb)]
    outs = [one_window(keys) for keys in batches]
    excs = None
    if flavor == "fast":
        excs = torch.cat([e.reshape(-1) for _, e in outs])
        outs = [pt for pt, _ in outs]
    sums = JPoint(*(torch.cat([o[k].reshape(-1, N_LIMBS) for o in outs])
                    for k in range(3)))  # (W, 16) each
    return sums, excs


def _best_multiexp(curve: CurveSpec, c: int, total_bits: int, flavor: str,
                   scalars, pts: JPoint):
    """flavor:
      "fast": blinded fast path only; returns (point, exc_any).  The caller
              checks exc_any on the host and reruns "safe" if it is set
      "safe": complete-add path only; returns the exact point
    """
    E = ec(curve)
    n = scalars.shape[0]
    dev = scalars.device
    num_windows = -(-total_bits // c)
    digits = window_digits(scalars, c, num_windows)  # (W, N) int32

    # normalize the input points ONCE (shared batch inversion): every window's
    # dominant scan then runs on mixed (XYZZ + affine) additions, and the
    # per-window sorted-order gather moves ONE 64-byte packed row per point
    ax, ay, _ = E.to_affine(pts)
    pay = _pack_pair(ax, ay)  # (N, 16) int32

    # the top window spans only the leftover bits c_top; on the radix route
    # its keys would crowd a fraction of the coarse partitions, so it gets its
    # own width there (elsewhere a second width costs more than it saves),
    # when the route takes that width too: the JAX package's predicate.  At
    # the default bound of 255 bits and c = 15 there is no split, and as the
    # Pallas q lies just above 2^254 the top window's keys fall below 2^14,
    # in half the coarse partitions: at 2^20 points every tile overflows and
    # the MSM ends in the safe redo.  Scalars known to fit 254 bits say so
    # with max_scalar_bits, and the top window is split off at 14.
    c_top = total_bits - (num_windows - 1) * c  # in (0, c]
    split_top = (c_top < c and num_windows > 1 and _radix_ok(n, c, flavor)
                 and _radix_ok(n, c_top, flavor))
    window_sums, excs = _run_windows(_make_one_window(E, c, flavor, pay, n),
                                     digits[:-1] if split_top else digits, n, c, flavor)
    if split_top:
        top, e_top = _make_one_window(E, c_top, flavor, pay, n)(digits[-1])
        window_sums = JPoint(*(torch.cat([a, b[None]]) for a, b in zip(window_sums, top)))
        excs = torch.cat([excs, e_top.reshape(1)])

    acc = E.identity((), dev)
    for i in range(num_windows):
        acc = _double_n(E, acc, c)
        acc = E.add(acc, JPoint(*(cc[num_windows - 1 - i] for cc in window_sums)))
    if flavor == "fast":
        return acc, excs.any()
    return acc


# ---------------------------------------------------------------------------
# per-round digit sums of the argument's carry stage
# ---------------------------------------------------------------------------

def _round_sums(curve: CurveSpec, base: int, flavor: str, digits, pts: JPoint):
    """One Pippenger window a round: S_k = sum_j digits[k, j] * P_j.

    digits: (d, N) int32 in [0, base); pts: (N,).  Returns ((d,) JPoint,
    PER-ROUND flags (d,) bool) for "fast", the (d,) JPoint for "safe"."""
    E = ec(curve)
    n = pts.x.shape[-2]
    c = max(1, (base - 1).bit_length())
    ax, ay, _ = E.to_affine(pts)
    pay = _pack_pair(ax, ay)
    sums, excs = _run_windows(_make_one_window(E, c, flavor, pay, n),
                              digits, n, c, flavor)
    if flavor == "fast":
        return sums, excs
    return sums


def round_sums(curve: CurveSpec, base: int, digits, pts: JPoint) -> JPoint:
    """Per-round digit-weighted sums for the Eagen argument's carry
    recurrence: the blinded fast flavor with its flags checked on the host
    (the contract of best_multiexp: exact for every input).  Only the FLAGGED
    rounds are recomputed in the safe flavor and written over the fast
    results.

    digits: (d, N) int32 in [0, base), pts: (N,) on the same device.
    Returns a (d,) JPoint batch."""
    sums, excs = _round_sums(curve, base, "fast", digits, pts)
    idx = excs.nonzero().flatten()
    if idx.numel():
        safe = _round_sums(curve, base, "safe", digits[idx], pts)
        sums = JPoint(*(s.index_copy(0, idx, v) for s, v in zip(sums, safe)))
    return sums


def _double_n(E: EC, p: JPoint, k: int) -> JPoint:
    """p doubled k times: one ec_double launch on the card (the JAX
    package's fori_loop of E.double)."""
    return E.double_n(p, k)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def scalars_to_limbs(scalars, curve: CurveSpec, device="cuda"):
    """List of ints (scalar field) -> (N, 16) int32 canonical limb tensor."""
    q = curve.scalar_field.p
    return limbs_from_numpy(ints_to_limbs([s % q for s in scalars]), device)


def msm_ints(curve: CurveSpec, scalars, pts_ints, c: int | None = None,
             max_scalar_bits: int | None = None, device="cuda"):
    """Convenience: host ints/points -> MSM -> affine int point or None."""
    E = ec(curve)
    s = scalars_to_limbs(scalars, curve, device)
    p = E.points_from_ints(pts_ints, device)
    res = best_multiexp(curve, s, p, c, max_scalar_bits)
    return E.points_to_ints(JPoint(res.x[None], res.y[None], res.z[None]))[0]
