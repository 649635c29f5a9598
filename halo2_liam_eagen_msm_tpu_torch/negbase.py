"""Negbase scalar decomposition and circuit-witness preparation (host, numpy
and Python ints only).

The port's own copy of the JAX package's negbase.py: the digit streams are
byte-identical for identical inputs.  The batch path vectorises the
long-division recurrence over numpy limb arrays.

A scalar x is decomposed in radix -base with digits in [0, base):
    x = sum_i d_i * (-base)^i
via the recurrence  d = x mod base;  x = -((x - d) / base).
"""

from __future__ import annotations

import numpy as np

from .fields import FieldSpec, LIMB_BITS, LIMB_MASK, N_LIMBS


def range_check(x: int) -> None:
    """|x| < 2^127 (declared but unused upstream; kept for parity)."""
    if not -(1 << 127) < x < (1 << 127):
        raise ValueError("scalar out of the range |x| < 2^127")


def negbase_decompose(x: int, base: int) -> list[int]:
    """Little-endian digits of x in radix -base, digits in [0, base).
    Empty list for x == 0."""
    if base < 2:
        raise ValueError("base must be at least 2")
    acc = []
    while x != 0:
        digit = x % base  # Python % is already non-negative for base > 0
        acc.append(digit)
        x = -((x - digit) // base)
    return acc


def negbase_recompose(digits, base: int) -> int:
    """Fold digits back: acc = acc*(-base) + d, msb-first."""
    acc = 0
    for d in reversed(list(digits)):
        acc = acc * (-base) + d
    return acc


# ---------------------------------------------------------------------------
# Vectorized batch decomposition over limb arrays (host, numpy).
# ---------------------------------------------------------------------------

def _divmod_small(mag: np.ndarray, base: int):
    """Vectorized divmod of (N, N_LIMBS) uint32 little-endian magnitudes by a
    small positive int.  Returns (quotient limbs, remainder (N,))."""
    n = mag.shape[0]
    q = np.zeros_like(mag)
    rem = np.zeros(n, dtype=np.uint64)
    for i in range(N_LIMBS - 1, -1, -1):
        cur = (rem << LIMB_BITS) | mag[:, i].astype(np.uint64)
        q[:, i] = (cur // base).astype(np.uint32)
        rem = cur % base
    return q, rem


def _add_one(mag: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """mag[mask] += 1 with carry ripple (vectorized)."""
    out = mag.copy()
    carry = mask.astype(np.uint32)
    for i in range(N_LIMBS):
        v = out[:, i] + carry
        out[:, i] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return out


def negbase_decompose_batch(mags: np.ndarray, base: int, num_digits: int) -> np.ndarray:
    """Decompose a batch of non-negative scalars given as (N, N_LIMBS) uint32
    little-endian limb arrays.  Returns (N, num_digits) uint8 digits,
    little-endian digit order, zero-padded: identical to running
    `negbase_decompose` per scalar and padding.  Raises if some scalar needs
    more than num_digits digits.

    Sign tracking: starting non-negative, the recurrence alternates the sign
    of x; we track |x| and the sign bit instead of signed bignums:
      sign +: d = r,               |x'| = q          (q, r = divmod(|x|, base))
      sign -: d = (base - r) % b,  |x'| = q + (r>0)
    """
    n = mags.shape[0]
    mag = mags.astype(np.uint32).copy()
    neg = np.zeros(n, dtype=bool)  # sign of x (False = non-negative)
    digits = np.zeros((n, num_digits), dtype=np.uint8)
    for k in range(num_digits):
        q, r = _divmod_small(mag, base)
        r = r.astype(np.uint32)
        d_neg = np.where(r > 0, base - r, 0).astype(np.uint32)
        digits[:, k] = np.where(neg, d_neg, r).astype(np.uint8)
        mag = _add_one(q, neg & (r > 0))
        nonzero = mag.any(axis=1)
        neg = (~neg) & nonzero  # sign flips each step; zero has no sign
    if mag.any():
        raise ValueError("num_digits too small for some scalar")
    return digits


# ---------------------------------------------------------------------------
# Digit / lookup-table indexing.
# ---------------------------------------------------------------------------

def id_by_digit(digit: int):
    """digit 0 -> None; digit d -> id d-1."""
    if digit == 0:
        return None
    return digit - 1


def digit_by_id(table_id: int) -> int:
    """id -> digit id+1."""
    return table_id + 1


def table_entry_by_id(base: int, table_id: int, f: FieldSpec) -> int:
    """Lookup-table entry for id: the binary expansion of id, read msb-first,
    Horner-folded with multiplier (-base), including a trailing multiply, so
    e.g. id=1 -> -base."""
    if table_id == 0:
        return 0
    b = (-base) % f.p
    acc = 0
    for bit in bin(table_id)[2:]:
        if bit == "1":
            acc = (acc + 1) % f.p
        acc = (acc * b) % f.p
    return acc


# ---------------------------------------------------------------------------
# Circuit scalar-witness grid.
# ---------------------------------------------------------------------------

class Entry:
    """Tagged grid cell: Scalar(value) | Bucket(value) | Limb(value, integrity)."""

    __slots__ = ("kind", "value", "integrity")

    def __init__(self, kind: str, value, integrity=None):
        self.kind = kind
        self.value = value
        self.integrity = integrity

    def __eq__(self, other):
        return (
            self.kind == other.kind
            and self.value == other.value
            and self.integrity == other.integrity
        )

    def __repr__(self):
        if self.kind == "limb":
            return f"Limb({self.value}, {self.integrity})"
        return f"{self.kind.capitalize()}({self.value})"


def prepare_scalar_witness(sc: int, base: int, num_digits: int, logtable: int):
    """Build the per-scalar witness grid: (base) rows x (num_limbs+1) cols of
    Entry.  Row 0 col 0 = the scalar; rows d>0 col 0 = bucket sums
    sum (-base)^i over positions with digit d; limb cells accumulate
    (-base)^(i % logtable) / 2^(i % logtable) keyed by i % logtable + 1.

    NOTE (quirk replicated on purpose, as the JAX package does): limb cells
    are indexed by `i % logtable + 1` where `i / logtable + 1` was likely
    intended upstream, and accumulate `(-base)^(i % logtable)` rather than a
    per-limb digit weight.  The function has no caller and no test upstream.
    """
    digits = negbase_decompose(sc, base)
    if len(digits) > num_digits:
        raise ValueError("num_digits too small for the scalar")
    num_limbs = (num_digits + logtable - 1) // logtable

    acc = [[(0, 0) for _ in range(num_limbs + 1)] for _ in range(base)]
    for i, d in enumerate(digits):
        idx = id_by_digit(d)
        if idx is None:
            continue
        j = i % logtable + 1
        acc[idx + 1][0] = (acc[idx + 1][0][0] + (-base) ** i, acc[idx + 1][0][1])
        acc[idx + 1][j] = (
            acc[idx + 1][j][0] + (-base) ** (i % logtable),
            acc[idx + 1][j][1] + 2 ** (i % logtable),
        )
        acc[0][j] = (
            acc[0][j][0] + (-base) ** (i % logtable),
            acc[0][j][1] + 2 ** (i % logtable),
        )

    out = []
    for i in range(base):
        row = []
        for j in range(num_limbs + 1):
            if i == 0 and j == 0:
                row.append(Entry("scalar", sc))
            elif j == 0:
                row.append(Entry("bucket", acc[i][j][0]))
            else:
                row.append(Entry("limb", acc[i][j][0], acc[i][j][1]))
        out.append(row)
    return out
