"""The benchmark's inputs, made from the seed: points, scalars, digits.

Points are distinct and fixed for a run, as a structured reference string
is: P_j = A + j B for j < N, with A = a G and B = b G for a, b drawn from
the seed.  Their digit-weighted sums then have cheap closed forms (a sum of
digits times A plus a sum of index-weighted digits times B), which is what
lets the reference check every carry of a 2^20-point job.  Distinct
partial sums of adjacent ranges never collide (the B coefficients of two
disjoint index ranges with equal digit sums differ), so the merge tree sees
the degenerate cases real bases give it (the repeated carry slots) and no
others.

Scalars are uniform below 2^127 (below sqrt(q) for the curves configured:
their q exceed 2^254), as four 32-bit words a scalar, a pool of vectors a
run.  The harness decomposes them here in radix -base with its own
vectorised copy of the recurrence d = x mod base, x = -((x - d) / base),
in bulk on the device."""

from __future__ import annotations

import os
from multiprocessing import get_context

import numpy as np

from reference.curve import R_BITS, Curve

WORDS = 4  # 32-bit words a scalar: scalars lie below 2^127


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own for each use of the seed."""
    s = seed % (1 << 128)
    return np.random.default_rng([s & (2**64 - 1), s >> 64,
                                  int.from_bytes(stream.encode(), "little")])


def line_points(curve: Curve, seed: int):
    """(A, B) affine, A = a G and B = b G, a and b drawn from the seed."""
    g = rng_for(seed, "points")
    a, b = (int.from_bytes(g.bytes(40), "little") % curve.q for _ in range(2))
    return curve.mul(curve.g, a), curve.mul(curve.g, b)


def mont_limbs(values, p: int) -> np.ndarray:
    """Ints -> (len, 16) int32 array of the 16-bit limbs of x 2^256 mod p
    (the program's Montgomery layout)."""
    r = (1 << R_BITS) % p
    buf = b"".join(((x * r) % p).to_bytes(R_BITS // 8, "little") for x in values)
    return np.frombuffer(buf, dtype="<u2").reshape(len(values), -1).astype(np.int32)


def _line_block(args):
    """A worker's block of the line: (x, y) Montgomery limb arrays."""
    curve, start, step, n = args
    xs, ys = curve.affine_line(start, step, n)
    return mont_limbs(xs, curve.p), mont_limbs(ys, curve.p)


PARALLEL_MIN_POINTS = 1 << 18


def point_limbs(curve: Curve, seed: int, n: int):
    """The n points as two (n, 16) int32 Montgomery limb arrays (x, y) of
    affine coordinates (the program's Jacobian points take Z = 1).  From
    PARALLEL_MIN_POINTS up, in blocks, one a worker process (spawned, and
    joined before this returns), block w starting at A + (w size) B."""
    A, B = line_points(curve, seed)
    workers = min(8, os.cpu_count() or 1)
    if n < PARALLEL_MIN_POINTS or workers < 2:
        return _line_block((curve, A, B, n))
    size = -(-n // workers)
    blocks = [(curve, curve.add(A, curve.mul(B, w * size)), B, min(size, n - w * size))
              for w in range(workers) if w * size < n]
    with get_context("spawn").Pool(len(blocks)) as pool:
        parts = pool.map(_line_block, blocks)
        pool.close()
        pool.join()
    return tuple(np.concatenate([part[i] for part in parts]) for i in range(2))


def scalar_pool(seed: int, pool: int, n: int) -> np.ndarray:
    """(pool, n, WORDS) uint64 arrays of 32-bit words, little-endian, each
    scalar uniform below 2^127."""
    w = rng_for(seed, "scalars").integers(0, 1 << 32, size=(pool, n, WORDS), dtype=np.uint64)
    w[..., WORDS - 1] &= 0x7FFFFFFF
    return w


def negbase_digits(words, base: int, num_digits: int, device="cpu"):
    """(n, WORDS) 32-bit words (numpy) -> (num_digits, n) int32 tensor of
    the digits in radix -base on `device`, most significant round first
    (the program's layout of digit rounds).  Tracks |x| and its sign: for
    x >= 0, d = r and |x'| = q; for x < 0, d = (base - r) % base and |x'| =
    q + (r > 0), where (q, r) = divmod(|x|, base); the sign flips each step,
    and zero has none.  int64 arithmetic on 32-bit words, in bulk on the
    device.  Raises if a scalar needs more digits."""
    import torch

    w = torch.from_numpy(np.ascontiguousarray(words.astype(np.int64))).to(device)
    mag = [w[:, i].contiguous() for i in range(w.shape[1])]
    n = w.shape[0]
    neg = torch.zeros(n, dtype=torch.bool, device=device)
    digits = torch.empty((num_digits, n), dtype=torch.int32, device=device)
    for k in range(num_digits):
        rem = torch.zeros(n, dtype=torch.int64, device=device)
        for i in range(len(mag) - 1, -1, -1):
            cur = (rem << 32) | mag[i]
            q = torch.div(cur, base, rounding_mode="floor")
            rem = cur - q * base
            mag[i] = q
        up = neg & (rem > 0)
        digits[num_digits - 1 - k] = torch.where(up, base - rem, rem).to(torch.int32)
        carry = up.to(torch.int64)
        for i in range(len(mag)):
            v = mag[i] + carry
            mag[i] = v & 0xFFFFFFFF
            carry = v >> 32
        nonzero = torch.stack(mag).ne(0).any(dim=0)
        neg = ~neg & nonzero
    if bool(torch.stack(mag).ne(0).any()):
        raise ValueError("num_digits too small for some scalar")
    return digits


def words_to_ints(words: np.ndarray) -> list:
    """(n, WORDS) word arrays -> Python ints."""
    buf = np.ascontiguousarray(words.astype("<u4")).tobytes()
    w = 4 * words.shape[1]
    return [int.from_bytes(buf[i:i + w], "little") for i in range(0, len(buf), w)]
