"""The plain reference of the benchmark and the comparison that decides
`correct`: Python ints and NumPy only.

What the program's timed path produced reaches this module as NumPy limb
arrays, (..., 16) int32 of 16-bit limbs in Montgomery form (x 2^256 mod p),
points as Jacobian (X, Y, Z) with Z == 0 the identity.  Everything the
program derived is worked out again here from the seed's inputs: the points
P_j = A + j B, the scalars, and the digits the harness made from them.

  * carries: the round sums S_k = sum_j d_kj P_j = (sum_j d_kj) A +
    (sum_j j d_kj) B, folded by carry' = -base carry + S_k from the
    identity; the last carry must equal sum_j s_j P_j = (sum s) A +
    (sum j s) B, which ties the digits to the scalars
  * round slots: base copies of -carry_prev, d_kj P_j (the identity where
    d_kj = 0), -carry_new
  * a round's witness a(x) + y b(x): with m the round's non-identity slots
    summing to the identity, its pole at O has order m exactly (a's degree
    at most m / 2, b's at most (m - 3) / 2, and the term of order m not
    zero); its divisor is sum [slot] - m [O] over every slot, by Weil
    reciprocity against a line drawn from the seed, and its leading
    coefficient is the one the program's canonical lines give
    (reference/divisor.py)
  * every limb read lies in [0, 2^16) and every value below p (the
    program's outputs are fully reduced)

Every count below has the limit 0: the comparison is exact."""

from __future__ import annotations

import numpy as np

from .curve import R_BITS, Curve

LIMB_BITS = 16
LIMITS = {"carries_wrong": 0, "msm_wrong": 0, "slots_wrong": 0, "rounds_open": 0,
          "witness_degree_wrong": 0, "witness_divisor_wrong": 0, "witness_scale_wrong": 0,
          "limbs_noncanonical": 0}


def limb_ints(arr) -> tuple:
    """(..., 16) int32 limbs -> (flat list of ints, count of limbs outside
    [0, 2^16))."""
    a = np.asarray(arr).reshape(-1, 16).astype(np.int64)
    bad = int(((a < 0) | (a >> LIMB_BITS != 0)).sum())
    buf = np.ascontiguousarray((a & 0xFFFF).astype("<u2")).tobytes()
    return [int.from_bytes(buf[i:i + 32], "little") for i in range(0, len(buf), 32)], bad


class Counts(dict):
    """The numbers compared, each against its limit in LIMITS."""

    def __init__(self):
        super().__init__({k: 0 for k in LIMITS})

    def add(self, key: str, n: int) -> None:
        self[key] += int(n)

    def merge(self, other: "Counts") -> None:
        for k, v in other.items():
            self[k] += v

    @property
    def correct(self) -> bool:
        return all(self[k] <= LIMITS[k] for k in LIMITS)


class Decoder:
    """Montgomery limbs -> canonical ints, counting non-canonical values."""

    def __init__(self, curve: Curve, counts: Counts):
        self.p = curve.p
        self.rinv = pow(1 << R_BITS, -1, curve.p)
        self.counts = counts

    def mont_ints(self, arr) -> list:
        """Montgomery values as they are (x R mod p), range-checked."""
        vals, bad = limb_ints(arr)
        self.counts.add("limbs_noncanonical", bad + sum(v >= self.p for v in vals))
        return vals

    def ints(self, arr) -> list:
        return [v * self.rinv % self.p for v in self.mont_ints(arr)]

    def points(self, x, y, z) -> list:
        """Jacobian limb arrays (n, 16) -> affine int pairs or None."""
        p = self.p
        out = []
        for X, Y, Z in zip(self.ints(x), self.ints(y), self.ints(z)):
            if Z == 0:
                out.append(None)
                continue
            zi = pow(Z, -1, p)
            zi2 = zi * zi % p
            out.append((X * zi2 % p, Y * zi2 * zi % p))
        return out


class Expected:
    """The reference of one scalar vector: its carries and slot points.

    words: (N, 4) uint32 words of the scalars; digits: (d, N) digit rounds,
    most significant first, as handed to the program."""

    def __init__(self, curve: Curve, A, B, base: int, words, digits):
        self.curve, self.A, self.B, self.base = curve, A, B, base
        digits = np.asarray(digits).astype(np.int64)
        self.digits = digits
        n = digits.shape[1]
        idx = np.arange(n, dtype=np.int64)
        self.n = n
        self.nnz = (digits != 0).sum(axis=1).tolist()
        prev, new = [], []
        carry = None
        for k in range(digits.shape[0]):
            s_k = curve.lin(int(digits[k].sum()), A, int(digits[k] @ idx), B)
            prev.append(carry)
            carry = curve.add(curve.mul(curve.neg(carry), base), s_k)
            new.append(carry)
        self.prev, self.new, self.final = prev, new, carry
        halves = np.asarray(words, dtype=np.uint64)
        halves = np.stack([(halves >> np.uint64(16 * h)) & np.uint64(0xFFFF)
                           for h in (0, 1)], axis=-1).reshape(n, -1).astype(np.int64)
        sum_s = sum(int(halves[:, i].sum()) << (16 * i) for i in range(halves.shape[1]))
        sum_js = sum(int(idx @ halves[:, i]) << (16 * i) for i in range(halves.shape[1]))
        self.msm = curve.lin(sum_s, A, sum_js, B)

    def slot(self, k: int, s: int):
        """The reference point of slot s of round k."""
        if s < self.base:
            return self.curve.neg(self.prev[k])
        if s == self.base + self.n:
            return self.curve.neg(self.new[k])
        j = s - self.base
        d = int(self.digits[k, j])
        return self.curve.lin(d, self.A, d * j, self.B) if d else None

    def pole_order(self, k: int) -> int:
        """Non-identity slots of round k."""
        return (self.base * (self.prev[k] is not None) + self.nnz[k]
                + (self.new[k] is not None))


def check_carries(dec: Decoder, exp: Expected, prev, new, final, counts: Counts) -> None:
    """prev / new: (x, y, z) limb arrays (d, 16); final: (x, y, z) (16,)."""
    got_prev, got_new = dec.points(*prev), dec.points(*new)
    counts.add("carries_wrong", sum(g != w for g, w in zip(got_prev, exp.prev))
               + sum(g != w for g, w in zip(got_new, exp.new))
               + abs(len(got_prev) - len(exp.prev)) + abs(len(got_new) - len(exp.new)))
    got_final = dec.points(*(np.asarray(c).reshape(1, 16) for c in final))[0]
    counts.add("msm_wrong", (got_final != exp.msm) + (exp.final != exp.msm))


def check_closing(dec: Decoder, outs, counts: Counts) -> None:
    """outs: (x, y, z) limb arrays (r, 16) of rounds' closing points, each of
    which must be the identity."""
    counts.add("rounds_open", sum(pt is not None for pt in dec.points(*outs)))


def check_slots(dec: Decoder, exp: Expected, k: int, idx, got, counts: Counts,
                key: str = "slots_wrong") -> None:
    """got: (x, y, z) limb arrays (len(idx), 16), the program's slots idx of
    round k; a slot that differs counts under `key`."""
    for s, pt in zip(idx, dec.points(*got)):
        counts.add(key, pt != exp.slot(k, int(s)))


def noncanonical_rows(arr, p: int) -> int:
    """Rows of a (..., 16) limb array with a limb outside [0, 2^16) or a
    value of p or more, counted in bulk: by the top limb, and limb by limb
    only where the top limb is p's."""
    a = np.asarray(arr).reshape(-1, 16)
    p_limbs = np.array([(p >> (LIMB_BITS * i)) & 0xFFFF for i in range(16)], dtype=np.int64)
    out_of_range = ((a < 0) | (a > 0xFFFF)).any(axis=1)
    at_or_above = a[:, 15] > p_limbs[15]
    tie = np.flatnonzero(a[:, 15] == p_limbs[15])
    if tie.size:
        d = a[tie].astype(np.int64) - p_limbs
        nz = d != 0
        top = 15 - np.argmax(nz[:, ::-1], axis=1)
        at_or_above[tie] = ~nz.any(axis=1) | (d[np.arange(tie.size), top] > 0)
    return int((out_of_range | at_or_above).sum())


def degree(a) -> int:
    nz = np.flatnonzero(np.asarray(a).any(axis=1))
    return int(nz[-1]) if nz.size else -1


def check_witness_shape(dec: Decoder, exp: Expected, k: int, a, b, counts: Counts) -> None:
    """a, b: (La, 16), (Lb, 16) limb arrays of round k's witness: fully
    reduced, and of pole order m exactly at O."""
    m = exp.pole_order(k)
    deg_a, deg_b = degree(a), degree(b)
    top_a, top_b = m // 2, (m - 3) // 2 if m >= 3 else -1
    lead = deg_a == top_a if m % 2 == 0 else deg_b == top_b
    counts.add("witness_degree_wrong", int(not (lead and deg_a <= top_a and deg_b <= top_b)))
    counts.add("limbs_noncanonical", noncanonical_rows(a, dec.p) + noncanonical_rows(b, dec.p))
