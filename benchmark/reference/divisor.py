"""A round's witness against its divisor over every slot, and its scale:
Python ints and NumPy.

The witness f = a(x) + y b(x) of a round whose m non-identity slots P_i sum
to the identity has the divisor sum [P_i] - m [O].  For the line
l = y - lam x - mu through Q1, Q2 and Q3 = -(Q1 + Q2), Weil reciprocity
for f and l, both normalised at O, reads

    f(Q1) f(Q2) f(Q3) = (-1)^m c^3 prod_i l(P_i)

where c is f's leading coefficient (of x^(m/2) in a for m even, of
x^((m-3)/2) in b for m odd).  The line is drawn from the seed, so a witness
whose divisor differs from sum [P_i] - m [O] at any slot (a wrong line at
one merge node, a tangent at the repeated carry slots without its
multiplicity) fails it, but with a chance of about m / p.

The identity is blind to the scale.  The scale is the program's stated
convention (canonical affine lines, the divisor's docstring and the
reference crate's Propagation engine): the merge tree joins consecutive
pairs, level by level, an odd last entry passing through; a join of the
subtree sums s_a, s_b multiplies the witness by the line through them and
divides it by monic verticals, so c is the product over the tree's joins
of each line's leading coefficient.  The line through s_a and s_b is the
cross product of (x, y, 1) and (x', y', 1), (0, 1, 0) for the identity,
through s_a and -(s_a + s_b) where that vanishes (s_a == s_b); its leading
coefficient is its y coefficient, x' - x where both are points with x !=
x', else its x coefficient, else its constant.  Seeds (the first level,
pairs of slots): the identity with a point p takes the line through p and
-p; two identities the witness 1.  Higher joins with an identity side take
no line.  The reference builds the tree's sums from the slots to find c.

The slots are d P_j for the points P_j = A + j B and digits d below the
base, and the carry slots.  From 2^12 slots up the work is split into
dyadic blocks of slots, one a worker process (spawned, joined before the
check returns): a block is a subtree of the merge tree."""

from __future__ import annotations

import os
from multiprocessing import get_context

import numpy as np

from .curve import R_BITS, Curve

PARALLEL_MIN_SLOTS = 1 << 12
BLOCKS_LOG = 3     # about 2^BLOCKS_LOG full blocks of slots


def batch_inv(vals, p: int):
    """The inverses of nonzero ints mod p by one Montgomery trick, and
    their product."""
    pref = [0] * len(vals)
    acc = 1
    for i, v in enumerate(vals):
        pref[i] = acc
        acc = acc * v % p
    total = acc
    inv = pow(acc, -1, p)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv * pref[i] % p
        inv = inv * vals[i] % p
    return out, total


def line_lc(curve: Curve, a, b) -> int:
    """The leading coefficient at O of the canonical line through a and b."""
    p = curve.p
    ax, ay, az = (0, 1, 0) if a is None else (a[0], a[1], 1)
    bx, by, bz = (0, 1, 0) if b is None else (b[0], b[1], 1)
    lx, ly, lz = (ay * bz - az * by) % p, (az * bx - ax * bz) % p, (ax * by - ay * bx) % p
    if not (lx or ly or lz):
        c = curve.neg(curve.add(a, b))
        cx, cy, cz = (0, 1, 0) if c is None else (c[0], c[1], 1)
        lx, ly, lz = (ay * cz - az * cy) % p, (az * cx - ax * cz) % p, (ax * cy - ay * cx) % p
    return ly or lx or lz


def join_level(curve: Curve, ents: list, seed: bool):
    """One level of the merge tree on its entries' sums (None: the
    identity): consecutive pairs joined, an odd last entry passing through.
    Returns (the sums a level up, the product of the joins' lines' leading
    coefficients)."""
    p = curve.p
    half = len(ents) // 2
    out = [None] * half
    lc = 1
    idx, dens = [], []
    for i in range(half):
        a, b = ents[2 * i], ents[2 * i + 1]
        if a is not None and b is not None and a[0] != b[0]:
            idx.append(i)
            dens.append((b[0] - a[0]) % p)
            continue
        out[i] = curve.add(a, b)
        if seed and a is None:
            lc = lc * (1 if b is None else line_lc(curve, b, curve.neg(b))) % p
        elif seed or (a is not None and b is not None):
            lc = lc * line_lc(curve, a, b) % p
    if dens:
        invs, total = batch_inv(dens, p)
        lc = lc * total % p
        for i, inv in zip(idx, invs):
            (ax, ay), (bx, by) = ents[2 * i], ents[2 * i + 1]
            lam = (by - ay) * inv % p
            x3 = (lam * lam - ax - bx) % p
            out[i] = (x3, (lam * (ax - x3) - ay) % p)
    if len(ents) % 2:
        out.append(ents[-1])
    return out, lc


def tree(curve: Curve, ents: list, seed: bool):
    """(the sum of the entries, the product of every join's leading
    coefficient) of the merge tree on ents (of even length where seed)."""
    lc = 1
    while len(ents) > 1 or seed:
        ents, f = join_level(curve, ents, seed)
        lc = lc * f % curve.p
        seed = False
    return (ents[0] if ents else None), lc


def _chord(curve: Curve, ps, qs):
    """ps[i] + qs[i] for affine points with distinct x, in bulk."""
    p = curve.p
    invs, _ = batch_inv([(q[0] - a[0]) % p for a, q in zip(ps, qs)], p)
    out = []
    for (ax, ay), (bx, by), inv in zip(ps, qs, invs):
        lam = (by - ay) * inv % p
        x3 = (lam * lam - ax - bx) % p
        out.append((x3, (lam * (ax - x3) - ay) % p))
    return out


def _double(curve: Curve, ps):
    p = curve.p
    invs, _ = batch_inv([2 * y % p for _, y in ps], p)
    out = []
    for (x, y), inv in zip(ps, invs):
        lam = (3 * x * x + curve.a) * inv % p
        x3 = (lam * lam - 2 * x) % p
        out.append((x3, (lam * (x - x3) - y) % p))
    return out


def _block(args):
    """A block of slots [s0, s1) of every round asked for: (the block's
    sum, the product of its joins' leading coefficients, the product of l
    over its non-identity slots), a round each.  rounds: (digits of the
    block's points, {slot: point} of its carry slots) a round."""
    curve, A, B, base, n, s0, s1, line, rounds = args
    p = curve.p
    lam, mu = line
    j0, j1 = max(s0 - base, 0), min(s1 - base, n)
    mults = [[]]
    if j1 > j0:
        xs, ys = curve.affine_line(curve.add(A, curve.mul(B, j0)), B, j1 - j0)
        one = list(zip(xs, ys))
        mults.append(one)
        for d in range(2, base):
            mults.append(_double(curve, one) if d == 2 else _chord(curve, mults[-1], one))
    ells = [[(y - lam * x - mu) % p for x, y in m] for m in mults]
    off = j0 + base - s0
    out = []
    for digits, special in rounds:
        pts = [None] * (s1 - s0)
        prod = 1
        for s, pt in special.items():
            pts[s - s0] = pt
            if pt is not None:
                prod = prod * ((pt[1] - lam * pt[0] - mu) % p) % p
        for i, d in enumerate(digits.tolist()):
            if d:
                pts[off + i] = mults[d][i]
                prod = prod * ells[d][i] % p
        if len(pts) % 2:
            pts.append(None)
        root, lc = tree(curve, pts, True)
        out.append((root, lc, prod))
    return out


class DivisorCheck:
    """The witnesses of rounds against their slots: a line drawn from the
    seed (r1 G and r2 G on it), the reference points P_j = A + j B."""

    def __init__(self, curve: Curve, A, B, base: int, n: int, r1: int, r2: int):
        self.curve, self.A, self.B, self.base, self.n = curve, A, B, base, n
        p = curve.p
        q1, q2 = curve.mul(curve.g, r1), curve.mul(curve.g, r2)
        lam = (q2[1] - q1[1]) * pow(q2[0] - q1[0], -1, p) % p
        self.line = (lam, (q1[1] - lam * q1[0]) % p)
        self.qs = [q1, q2, curve.neg(curve.add(q1, q2))]
        self._pw = np.zeros((0, 16 * len(self.qs)))

    def _powers(self, length: int) -> np.ndarray:
        """(length, 48) float64: the 16-bit limbs of x_t^i mod p, i <
        length, for the three points' x side by side."""
        if self._pw.shape[0] < length:
            p = self.curve.p
            cols = []
            for x, _ in self.qs:
                acc, vals = 1, []
                for _ in range(length):
                    vals.append(acc)
                    acc = acc * x % p
                buf = b"".join(v.to_bytes(R_BITS // 8, "little") for v in vals)
                cols.append(np.frombuffer(buf, dtype="<u2").reshape(length, 16))
            self._pw = np.concatenate(cols, axis=1).astype(np.float64)
        return self._pw[:length]

    def evals(self, coeffs) -> list:
        """The polynomial of (L, 16) limb rows at the three points' x, mod
        p.  Limb products summed in float64: each sum of L products of two
        16-bit limbs stays below 2^53 for L <= 2^21, so it is exact."""
        c = np.asarray(coeffs).reshape(-1, 16)
        nz = np.flatnonzero(c.any(axis=1))
        c = (c[:int(nz[-1]) + 1 if nz.size else 0] & 0xFFFF).astype(np.float64)
        if c.shape[0] > 1 << 21:
            raise ValueError("a polynomial too long for exact float64 sums")
        m = np.rint(c.T @ self._powers(c.shape[0])).astype(np.int64)
        out = []
        for t in range(len(self.qs)):
            blk = m[:, 16 * t:16 * (t + 1)]
            cols = [int(np.trace(blk[:, ::-1], offset=15 - k)) for k in range(31)]
            out.append(sum(v << (16 * k) for k, v in enumerate(cols)) % self.curve.p)
        return out

    def _slices(self, exp, k: int, s0: int, s1: int):
        base, n = self.base, self.n
        j0, j1 = max(s0 - base, 0), min(s1 - base, n)
        digits = exp.digits[k, j0:j1].astype(np.int8) if j1 > j0 else np.zeros(0, np.int8)
        special = {s: self.curve.neg(exp.prev[k]) for s in range(s0, min(s1, base))}
        if s0 <= base + n < s1:
            special[base + n] = self.curve.neg(exp.new[k])
        return digits, special

    def _tasks(self, rounds) -> list:
        """One task a block of slots: dyadic blocks of 2^(b - 1 - BLOCKS_LOG)
        slots for b the bit length of the slot count, the rest a block of
        its own (a subtree of the merge tree too)."""
        slots = self.n + self.base + 1
        size = 1 << max(slots.bit_length() - 1 - BLOCKS_LOG, 1)
        edges = list(range(0, slots, size)) + [slots]
        return [(self.curve, self.A, self.B, self.base, self.n, s0, s1, self.line,
                 [self._slices(e, k, s0, s1) for e, k in rounds])
                for s0, s1 in zip(edges[:-1], edges[1:])]

    def _joined(self, parts, r: int):
        p = self.curve.p
        root, lc = tree(self.curve, [part[r][0] for part in parts], False)
        prod = 1
        for part in parts:
            lc = lc * part[r][1] % p
            prod = prod * part[r][2] % p
        return root, lc, prod

    def _run(self, rounds, between=lambda: None):
        """The blocks of every round, in worker processes from
        PARALLEL_MIN_SLOTS slots up; between() runs in this process
        meanwhile.  Returns (between()'s value, (the slots' sum, the scale
        c, the product of l over the slots) a round)."""
        tasks = self._tasks(rounds)
        workers = min(len(tasks), os.cpu_count() or 1, 8)
        if self.n + self.base + 1 < PARALLEL_MIN_SLOTS or workers < 2:
            mid = between()
            parts = [_block(t) for t in tasks]
        else:
            with get_context("spawn").Pool(workers) as pool:
                pending = pool.map_async(_block, tasks, chunksize=1)
                mid = between()
                parts = pending.get()
                pool.close()
                pool.join()
        return mid, [self._joined(parts, r) for r in range(len(rounds))]

    def reference(self, rounds) -> list:
        """(the slots' sum, the scale c, the product of l over the slots) of
        each (Expected, round) in rounds."""
        return self._run(rounds)[1]

    def _read(self, exp, k: int, a, b):
        """(the leading coefficient, f(Q1) f(Q2) f(Q3)) of round k's witness
        as read (Montgomery form)."""
        p = self.curve.p
        m = exp.pole_order(k)
        rows, at = (a, m // 2) if m % 2 == 0 else (b, (m - 3) // 2)
        rows = np.asarray(rows).reshape(-1, 16)
        lead = 0
        if 0 <= at < rows.shape[0]:
            lead = int.from_bytes((rows[at] & 0xFFFF).astype("<u2").tobytes(), "little") % p
        lhs = 1
        for (_, y), va, vb in zip(self.qs, self.evals(a), self.evals(b)):
            lhs = lhs * ((va + y * vb) % p) % p
        return lead, lhs

    def check(self, items) -> None:
        """items: (Expected, round k, a, b, Counts) with a, b the program's
        (La, 16), (Lb, 16) limb arrays of round k's witness (Montgomery
        form: every value read is R = 2^256 times the value).  Counts, in
        the item's Counts, witness_divisor_wrong (Weil's identity fails, or
        the reference's own slots do not close) and witness_scale_wrong (the
        leading coefficient is not the convention's).  The program's
        witnesses are read here while the workers build the reference."""
        if not items:
            return
        p = self.curve.p
        r_mont = (1 << R_BITS) % p
        read, refs = self._run([(e, k) for e, k, _, _, _ in items],
                               lambda: [self._read(e, k, a, b) for e, k, a, b, _ in items])
        for (exp, k, _, _, counts), (lead, lhs), (root, lc, prod) in zip(items, read, refs):
            m = exp.pole_order(k)
            counts.add("witness_scale_wrong", lead != lc * r_mont % p)
            rhs = (-1) ** m * pow(lead, 3, p) * prod % p
            counts.add("witness_divisor_wrong", int(lhs != rhs) + int(root is not None))
