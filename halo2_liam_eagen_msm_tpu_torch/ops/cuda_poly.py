"""The coefficient levels' CUDA kernels, with their plain versions.

mont_mul's work at the two heaviest shapes of the divisor merge tree's
coefficient levels (divisor.merge_pairs below FUSE_MIN_LA), each in one
launch (sources in csrc/poly.cuh, CUDA C++ for sm_90a, built into the one
library of ops/cuda_ff.py):

  kernel           replaces (at this shape)            what it computes
  poly_mul_naive   pallas_ff.mont_mul (:515), at the   the schoolbook product of
                   JAX ops/poly.mul_naive's outer      (..., La, 16) x (..., Lb,
                   product and column sums             16), La + Lb - 1 terms
                                                       (lazy sums, two balanced
                                                       outputs a thread, from
                                                       three products a
                                                       diagonal)
  kate_div         pallas_ff.mont_mul and mont_addsub  synthetic division by
                   (:515, :541), at the JAX ops/poly   (x - b), remainder
                   .kate_div scan's body (n <= 64)     dropped, same length n
  kate_div2        the same, at the two scans of a     the quotient by (x - ra)
                   coefficient level (JAX divisor.py   (x - rb), remainders
                   :342-343, :452-453, :533-534)       dropped, same length n:
                                                       kate_div twice in one
                                                       walk (two lanes a pair)

ops/poly.py takes them for a CUDA tensor and the plain versions for a CPU
one; the merge tree divides by kate_div2, and kate_div launched twice is its
first design's route, kept for one A/B.  poly_mul_naive has two
instantiations: the lazy sums where a diagonal has three products or more,
and its first design (a thread an output, a full reduction a product) where
no diagonal has more than two.  The plain versions are today's algorithms on
the plain products and adds of ops/cuda_ff.py, device-agnostic: the outer
product, its int64 anti-diagonal sums and one reduction a coefficient; the
Horner chain of n - 1 products and adds, and the two chains side by side.
Every result is fully reduced, so kernel and plain version agree limb for
limb.
"""

from __future__ import annotations

import ctypes
import math
import random

import torch

from ..fields import FieldSpec, N_LIMBS
from . import cuda_ff as CF

PMUL_MAX_THREADS = 256        # threads a block of poly_mul_naive at most (csrc/poly.cuh)
PMUL_SMEM = 48 * 1024         # shared memory a block may stage (the default cap)
STAGED_ROW_BYTES = 32         # a row repacked to 8 words of 32 bits
MAX_SHORT_TERMS = 1 << 13     # the shorter operand of a schoolbook product


def shared_operand(t, lead) -> bool:
    """Whether operand t (..., L, 16) is one for all pairs of the leading
    shape `lead`: every leading dim broadcast (stride 0) or of size 1."""
    full = t.expand(lead + tuple(t.shape[-2:]))
    return all(s == 0 or d == 1 for s, d in zip(full.stride()[:-2], lead))


def _pair_rows(t, lead):
    """An operand as (contiguous rows, rows from one pair's operand to the
    next's): one shared by all pairs is passed once with stride 0 (not
    copied per pair)."""
    length = t.shape[-2]
    full = t.expand(lead + (length, N_LIMBS))
    if shared_operand(t, lead):
        rows, stride = full[(0,) * len(lead)].contiguous(), 0
    else:
        rows, stride = full.contiguous(), length
    if rows.data_ptr() % 16:
        raise ValueError("limb rows must be 16-byte aligned")
    return rows, stride


def _mul_naive_group(pairs: int, la: int, lb: int, a_stride: int, b_stride: int,
                     per_thread: int):
    """(pairs a block, threads a block, staged) of a poly_mul_naive design
    whose threads take `per_thread` output coefficients each: as many pairs
    as give every thread of PMUL_MAX_THREADS its outputs and the block's
    shared memory stages, the block their threads rounded up to whole warps;
    where one pair's rows do not fit, one pair a block with the rows read
    from device memory."""
    per_pair = -(-(la + lb - 1) // per_thread)
    group = max(1, min(pairs, PMUL_MAX_THREADS // per_pair))

    def staged_bytes(g):
        return STAGED_ROW_BYTES * ((g * la if a_stride else la) + (g * lb if b_stride else lb))

    while group > 1 and staged_bytes(group) > PMUL_SMEM:
        group -= 1
    threads = min(PMUL_MAX_THREADS, -(-group * per_pair // 32) * 32)
    return group, threads, staged_bytes(group) <= PMUL_SMEM


def poly_mul_naive(spec: FieldSpec, a, b):
    """(..., La, 16) x (..., Lb, 16) -> (..., La + Lb - 1, 16) schoolbook
    product, one kernel launch: lazy sums and outputs k and k + ceil(nout /
    2) a thread, or, where no diagonal has more than two products, the first
    design (an output a thread, a reduction a product); leading dims
    broadcast, an operand shared by all pairs is read once.  Requires
    min(La, Lb) <= 2^13, as mul_naive, and p > 2^247."""
    name = "poly_mul_naive"
    CF._check_cuda(name, a, b)
    la, lb = a.shape[-2], b.shape[-2]
    lazy = min(la, lb) > 2
    if min(la, lb) > MAX_SHORT_TERMS or min(la, lb) < 1:
        raise ValueError(f"{name}: the shorter operand must have 1 to 2^13 terms")
    if not 1 << 247 < spec.p:
        raise ValueError(f"{name}: the lazy reduction needs p > 2^247")
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    pairs = math.prod(lead)
    out = torch.empty(lead + (la + lb - 1, N_LIMBS), dtype=torch.int32, device=a.device)
    if pairs == 0:
        return out
    af, a_stride = _pair_rows(a, lead)
    bf, b_stride = _pair_rows(b, lead)
    group, threads, staged = _mul_naive_group(pairs, la, lb, a_stride, b_stride,
                                              2 if lazy else 1)
    CF._launch(name, a.device, ctypes.byref(CF._field_params(spec)),
               af.data_ptr(), bf.data_ptr(), out.data_ptr(), pairs, la, lb,
               a_stride, b_stride, group, threads, int(staged), int(lazy))
    return out


def kate_div(spec: FieldSpec, coeffs, b):
    """Synthetic division of (..., n, 16) coefficients by (x - b), b (..., 16),
    the remainder dropped, one kernel launch (a thread a pair's chain):
    returns (..., n, 16) with the last row zero."""
    CF._check_cuda("kate_div", coeffs, b)
    n = coeffs.shape[-2]
    lead = torch.broadcast_shapes(coeffs.shape[:-2], b.shape[:-1])
    pairs = math.prod(lead)
    cf = coeffs.expand(lead + (n, N_LIMBS)).contiguous()
    if cf.data_ptr() % 16:
        raise ValueError("limb rows must be 16-byte aligned")
    bf, b_stride = _pair_rows(b[..., None, :], lead)
    out = torch.empty_like(cf)
    if pairs and n:
        CF._launch("kate_div", coeffs.device, ctypes.byref(CF._field_params(spec)),
                   cf.data_ptr(), bf.data_ptr(), out.data_ptr(), pairs, n, b_stride)
    return out


def kate_div2(spec: FieldSpec, coeffs, ra, rb):
    """The quotient of (..., n, 16) coefficients by (x - ra)(x - rb), ra and
    rb (..., 16), the remainders dropped: kate_div(kate_div(coeffs, ra), rb)
    limb for limb, one kernel launch (two lanes a pair, both recurrences in
    one walk); returns (..., n, 16) with the last rows zero."""
    CF._check_cuda("kate_div2", coeffs, ra, rb)
    n = coeffs.shape[-2]
    lead = torch.broadcast_shapes(coeffs.shape[:-2], ra.shape[:-1], rb.shape[:-1])
    pairs = math.prod(lead)
    cf = coeffs.expand(lead + (n, N_LIMBS)).contiguous()
    if cf.data_ptr() % 16:
        raise ValueError("limb rows must be 16-byte aligned")
    raf, ra_stride = _pair_rows(ra[..., None, :], lead)
    rbf, rb_stride = _pair_rows(rb[..., None, :], lead)
    out = torch.empty_like(cf)
    if pairs and n:
        CF._launch("kate_div2", coeffs.device, ctypes.byref(CF._field_params(spec)),
                   cf.data_ptr(), raf.data_ptr(), rbf.data_ptr(), out.data_ptr(), pairs, n,
                   ra_stride, rb_stride)
    return out


# ---------------------------------------------------------------------------
# the algorithms, on any field ops; the plain versions
# ---------------------------------------------------------------------------

def _schoolbook(a, b, mul, reduce_columns):
    """The schoolbook product by one batched product of all La x Lb
    coefficient pairs, then exact int64 anti-diagonal sums and one reduction
    an output coefficient (min(La, Lb) <= 2^13 keeps each column below 2^29)."""
    if a.shape[-2] > b.shape[-2]:
        a, b = b, a  # keep the anti-diagonal row axis (and sum count) short
    la, lb = a.shape[-2], b.shape[-2]
    outer = mul(a[..., :, None, :], b[..., None, :, :])    # (..., La, Lb, 16)
    # pad the j axis to la + lb and re-view rows at width la + lb - 1: element
    # (i, j) lands at (i, i + j); the spill hits only zero padding
    lead = outer.shape[:-3]
    nout = la + lb - 1
    padded = torch.nn.functional.pad(outer, (0, 0, 0, la))
    flat = padded.reshape(lead + (la * (lb + la), N_LIMBS))[..., : la * nout, :]
    cols = flat.reshape(lead + (la, nout, N_LIMBS)).sum(-3, dtype=torch.int64)
    return reduce_columns(cols)


def _horner(coeffs, b, mul, add):
    """Synthetic division by (x - b) as the Horner chain q_{n-1} = 0,
    q_{k-1} = c_k + b q_k: n - 1 products and adds over all pairs at once."""
    n = coeffs.shape[-2]
    lead = torch.broadcast_shapes(coeffs.shape[:-2], b.shape[:-1])
    acc = torch.zeros(lead + (N_LIMBS,), dtype=coeffs.dtype, device=coeffs.device)
    q = [acc]                      # q_{n-1} = 0, the dropped slot
    for j in range(n - 1, 0, -1):
        acc = add(coeffs[..., j, :], mul(b, acc))
        q.append(acc)
    return torch.stack(q[::-1], dim=-2)


def _horner2(coeffs, ra, rb, mul, add):
    """The quotient by (x - ra)(x - rb) as the two Horner chains in one walk:
    q1_{k-1} = c_k + ra q1_k and q2_{k-1} = q1_k + rb q2_k from q1_{n-1} =
    q2_{n-1} = 0; 2 (n - 1) products and adds over all pairs at once."""
    n = coeffs.shape[-2]
    lead = torch.broadcast_shapes(coeffs.shape[:-2], ra.shape[:-1], rb.shape[:-1])
    q1 = q2 = torch.zeros(lead + (N_LIMBS,), dtype=coeffs.dtype, device=coeffs.device)
    q = [q2]                       # q2_{n-1} = 0, the dropped slot
    for j in range(n - 1, 0, -1):
        q1, q2 = add(coeffs[..., j, :], mul(ra, q1)), add(q1, mul(rb, q2))
        q.append(q2)
    return torch.stack(q[::-1], dim=-2)


def poly_mul_naive_plain(spec: FieldSpec, a, b):
    """Plain version of poly_mul_naive: _schoolbook on the plain products and
    the plain reduction."""
    return _schoolbook(a, b, lambda x, y: CF.mont_mul_plain(spec, x, y),
                       lambda cols: CF.reduce_columns_plain(spec, cols))


def kate_div_plain(spec: FieldSpec, coeffs, b):
    """Plain version of kate_div: _horner on the plain products and adds."""
    return _horner(coeffs, b, lambda x, y: CF.mont_mul_plain(spec, x, y),
                   lambda x, y: CF.mont_addsub_plain(spec, False, x, y))


def kate_div2_plain(spec: FieldSpec, coeffs, ra, rb):
    """Plain version of kate_div2: _horner2 on the plain products and adds."""
    return _horner2(coeffs, ra, rb, lambda x, y: CF.mont_mul_plain(spec, x, y),
                    lambda x, y: CF.mont_addsub_plain(spec, False, x, y))


def reduction_edges(spec: FieldSpec, k: int, seed: int = 0):
    """Raw operand values (a, b), k terms each, whose diagonal k - 1 (the sum
    T of a[i] b[k - 1 - i], k products) has its REDC r = (T + m p) / R where
    poly_mul_naive's lazy reduction (csrc/poly.cuh acc_reduce) is hardest to
    get right: with W = 2^224, p_hi = p // W and F = floor((r // W) / (p_hi +
    1)), r in the window [(F + 1) p, (F + 1) (p_hi + 1) W), where r - F p >=
    p; r // W = F (p_hi + 1) exactly, where the quotient's floating-point
    estimate may fall below F; and the window's top end: every such r up to F
    = 32 that k products of reduced values reach.  T = r R - m p for a random
    m in [0, R) (REDC's own m: T = -m p mod R), written as (p - 1) Y + z with
    a = (1, p - 1, ..., p - 1), b[k - 1] = z and b[0 .. k - 2] summing to Y."""
    p, big_r, w = spec.p, 1 << 256, 1 << 224
    top = (p // w + 1) * w
    t_max = (p - 2) + (k - 1) * (p - 1) ** 2
    targets = ({f * p + w for f in range(2, 33)} | {f * top for f in range(1, 33)}
               | {f * top + w - 1 for f in range(2, 33)} | {f * top - 1 for f in range(2, 33)})
    rnd = random.Random(seed)
    out = []
    for r in sorted(targets):
        m_lo = max(0, -(-(r * big_r - t_max) // p))
        if m_lo >= big_r:
            continue
        t = r * big_r - rnd.randrange(m_lo, big_r) * p
        y, z = divmod(t, p - 1)
        ys = [min(p - 1, max(0, y - (p - 1) * j)) for j in range(k - 1)]
        out.append(([1] + [p - 1] * (k - 1), ys[::-1] + [z]))
    return out
