"""Host-side conversions between Python ints and the limb representation.

Representation: numpy arrays of shape (..., N_LIMBS) with dtype uint32, each
limb holding LIMB_BITS = 16 bits, little-endian limb order.  Field elements
are stored in Montgomery form (a*R mod p, R = 2^256) on the compute path; the
functions here convert between canonical integers and (Montgomery) limb
arrays.  convert.py moves such arrays onto a torch device.
"""

from __future__ import annotations

import numpy as np

from .fields import FieldSpec, LIMB_BITS, LIMB_MASK, N_LIMBS, R, R_BITS


def int_to_limbs(x: int) -> np.ndarray:
    """Single int (< 2^256) -> (N_LIMBS,) uint32 array, little-endian."""
    if not 0 <= x < R:
        raise ValueError("limb value out of range [0, 2^256)")
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(N_LIMBS)], dtype=np.uint32
    )


def limbs_to_int(a: np.ndarray) -> int:
    """(N_LIMBS,) array -> int."""
    a = np.asarray(a, dtype=np.uint64)
    return sum(int(a[i]) << (LIMB_BITS * i) for i in range(N_LIMBS))


def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of ints -> (len, N_LIMBS) uint32 array (through one bytes
    buffer: a few seconds for 2^21 ints)."""
    xs = [int(x) for x in xs]
    try:
        buf = b"".join(x.to_bytes(R_BITS // 8, "little") for x in xs)
    except OverflowError:
        raise ValueError("limb value out of range [0, 2^256)") from None
    return np.frombuffer(buf, dtype="<u2").reshape(len(xs), N_LIMBS).astype(np.uint32)


def limbs_to_ints(a: np.ndarray) -> list[int]:
    """(..., N_LIMBS) array -> flat list of ints (leading dims flattened)."""
    buf = np.ascontiguousarray(np.asarray(a).reshape(-1, N_LIMBS), dtype="<u2").tobytes()
    w = R_BITS // 8
    return [int.from_bytes(buf[i:i + w], "little") for i in range(0, len(buf), w)]


# -- Montgomery-domain helpers (host side, exact) ---------------------------

def to_mont_int(x: int, f: FieldSpec) -> int:
    return (x * R) % f.p


def from_mont_int(x: int, f: FieldSpec) -> int:
    return (x * pow(R, f.p - 2, f.p)) % f.p


def int_to_mont_limbs(x: int, f: FieldSpec) -> np.ndarray:
    return int_to_limbs(to_mont_int(x % f.p, f))


def ints_to_mont_limbs(xs, f: FieldSpec) -> np.ndarray:
    return ints_to_limbs([to_mont_int(x % f.p, f) for x in xs])


def mont_limbs_to_int(a: np.ndarray, f: FieldSpec) -> int:
    return from_mont_int(limbs_to_int(a), f)


def mont_limbs_to_ints(a: np.ndarray, f: FieldSpec) -> list[int]:
    rinv = pow(R, f.p - 2, f.p)
    return [(v * rinv) % f.p for v in limbs_to_ints(a)]
