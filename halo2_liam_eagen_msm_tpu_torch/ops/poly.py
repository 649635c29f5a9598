"""Polynomial algebra over prime fields, batched.

Counterpart of the JAX package's ops/poly.py:

  * coefficients live in (..., L, 16) Montgomery limb tensors with a static
    (padded) length L; semantic lengths are tracked by the caller, trailing
    zeros never change results
  * evaluation is powers of x (a log-depth prefix product) and one lazily
    reduced dot product
  * kate division (synthetic division by (x - b), remainder dropped): the
    sequential Horner chain for n <= 64, otherwise suffix sums of c_j b^j
    scaled by inverse powers; kate_div2 divides by (x - ra)(x - rb), the
    two Horner chains in one walk for n <= 64
  * short products are the schoolbook product; long products use the NTT;
    the dispatch is the reference's len < 32 rule

Every op takes its device from its tensors.  The schoolbook product and the
Horner chains (the divisor's coefficient levels) are one kernel launch each
on a CUDA tensor (ops/cuda_poly.py) and their plain versions on a CPU one;
the rest runs through ops/ff.py and ops/ntt.py.  `Poly` is the host-side
exact-length polynomial (Python ints) of the tests and the oracles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import limbs_from_numpy, limbs_to_numpy
from ..fields import FieldSpec, N_LIMBS
from ..limbs import ints_to_mont_limbs, mont_limbs_to_ints
from . import cuda_ff
from . import cuda_poly as CP
from .ff import ff
from .ntt import intt_dit, ntt_dif

NAIVE_THRESHOLD = 32


def _prefix(op, x):
    """Inclusive prefix of an associative op along axis -2 (Hillis-Steele:
    log2(n) full-width steps)."""
    n = x.shape[-2]
    d = 1
    while d < n:
        x = torch.cat([x[..., :d, :], op(x[..., d:, :], x[..., :-d, :])], dim=-2)
        d *= 2
    return x


def _suffix(op, x):
    """Inclusive suffix of an associative op along axis -2."""
    return _prefix(op, x.flip(-2)).flip(-2)


def powers(spec: FieldSpec, x, n: int):
    """(..., n, 16): [1, x, x^2, ..., x^(n-1)] by a log-depth prefix product."""
    k = ff(spec)
    one = k.one(x.device).expand(x.shape[:-1] + (1, N_LIMBS))
    reps = x[..., None, :].expand(x.shape[:-1] + (n - 1, N_LIMBS))
    return _prefix(k.mul, torch.cat([one, reps], dim=-2))


def eval_poly(spec: FieldSpec, coeffs, x):
    """Evaluate (..., L, 16) coefficient tensors at x (..., 16); the same
    value as Horner's rule."""
    pw = powers(spec, x, coeffs.shape[-2])
    return ff(spec).dot(coeffs, pw, axis=-2)


def _zeros_row(a):
    return torch.zeros_like(a[..., :1, :])


def kate_div(spec: FieldSpec, coeffs, b):
    """Synthetic division by (x - b), dropping the remainder:
    q_k = sum_{j>k} c_j b^(j-1-k).  Returns a tensor of the SAME static
    length with the last coefficient zero; callers track semantic lengths.
    n <= 64: the sequential recurrence q_{k-1} = c_k + b q_k (b = 0 included),
    one kate_div launch on the card.  Longer: q_k = (suffix_sum_{j>k} c_j
    b^j) * b^(-k-1), and for b == 0 the quotient is the shift, mask-selected."""
    k = ff(spec)
    n = coeffs.shape[-2]
    if n <= 1:
        return torch.zeros_like(coeffs)
    if n <= 64:
        if cuda_ff._use_kernel(coeffs):
            return CP.kate_div(spec, coeffs, b)
        return CP.kate_div_plain(spec, coeffs, b)
    b_is_zero = k.is_zero(b)
    safe_b = k.select(b_is_zero, k.one(b.device).expand(b.shape), b)
    b_inv = k.inv(safe_b)
    d = k.mul(coeffs, powers(spec, safe_b, n))               # c_j b^j
    suf = _suffix(k.add, d)                                   # S_k = sum_{j >= k} d_j
    s_next = torch.cat([suf[..., 1:, :], _zeros_row(suf)], dim=-2)
    q = k.mul(k.mul(s_next, powers(spec, b_inv, n)), b_inv[..., None, :])
    shifted = torch.cat([coeffs[..., 1:, :], _zeros_row(coeffs)], dim=-2)
    return k.select(b_is_zero[..., None], shifted, q)


def kate_div2(spec: FieldSpec, coeffs, ra, rb):
    """Division by (x - ra)(x - rb), dropping the remainders: kate_div(
    kate_div(coeffs, ra), rb), the same static length with the last
    coefficients zero.  n <= 64: both recurrences in one walk, one kate_div2
    launch on the card (its plain version on the CPU); longer: kate_div
    twice (the suffix sums)."""
    n = coeffs.shape[-2]
    if n <= 1:
        return torch.zeros_like(coeffs)
    if n <= 64:
        if cuda_ff._use_kernel(coeffs):
            return CP.kate_div2(spec, coeffs, ra, rb)
        return CP.kate_div2_plain(spec, coeffs, ra, rb)
    return kate_div(spec, kate_div(spec, coeffs, ra), rb)


def mul_naive(spec: FieldSpec, a, b):
    """Schoolbook product of (..., La, 16) x (..., Lb, 16) -> (..., La+Lb-1,
    16), min(La, Lb) <= 2^13: one poly_mul_naive launch on the card; on the
    CPU one batched Montgomery product for all La*Lb coefficient pairs, then
    exact int64 anti-diagonal sums and one reduction per output coefficient."""
    if min(a.shape[-2], b.shape[-2]) > CP.MAX_SHORT_TERMS:
        raise ValueError("mul_naive: the shorter operand must have at most 2^13 terms")
    if cuda_ff._use_kernel(a):
        return CP.poly_mul_naive(spec, a, b)
    return CP.poly_mul_naive_plain(spec, a, b)


def _pad_to(a, n: int):
    la = a.shape[-2]
    if la == n:
        return a
    return torch.nn.functional.pad(a, (0, 0, 0, n - la))


def mul_fft(spec: FieldSpec, a, b, out_len: int | None = None):
    """NTT product: both padded to the next power of two >= La+Lb-1, the
    pointwise product in the shared bit-reversed order, back to natural
    coefficients (no bit-reversal gather)."""
    k = ff(spec)
    length = a.shape[-2] + b.shape[-2] - 1
    n = 1 << (length - 1).bit_length()
    fa = ntt_dif(spec, _pad_to(a, n))
    fb = ntt_dif(spec, _pad_to(b, n))
    res = intt_dit(spec, k.mul(fa, fb))
    return res[..., : (out_len or length), :]


def mul_auto(spec: FieldSpec, a, b):
    """Naive if either operand is shorter than 32, else NTT."""
    if a.shape[-2] < NAIVE_THRESHOLD or b.shape[-2] < NAIVE_THRESHOLD:
        return mul_naive(spec, a, b)
    return mul_fft(spec, a, b)


def add_padded(spec: FieldSpec, a, b):
    """Coefficient-wise sum, result length max(La, Lb)."""
    n = max(a.shape[-2], b.shape[-2])
    return ff(spec).add(_pad_to(a, n), _pad_to(b, n))


def scale(spec: FieldSpec, a, sc):
    return ff(spec).mul(a, sc[..., None, :])


def shr(spec: FieldSpec, a, k_shift: int):
    """Multiply by x^k: prepend k zero coefficients."""
    return torch.nn.functional.pad(a, (0, 0, k_shift, 0))


# ---------------------------------------------------------------------------
# Host-facing exact-length polynomial (oracle / small-scale convenience).
# ---------------------------------------------------------------------------

class Poly:
    """Exact-length polynomial over `spec` with the reference's Polynomial
    semantics (lengths included), for tests and host-side orchestration.
    Coefficients are canonical Python ints."""

    def __init__(self, spec: FieldSpec, coeffs):
        self.spec = spec
        self.coeffs = [c % spec.p for c in coeffs]

    def __len__(self):
        return len(self.coeffs)

    def __eq__(self, other):
        return self.spec is other.spec and self.coeffs == other.coeffs

    def ev(self, x: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % self.spec.p
        return acc

    def kate_div(self, b: int) -> "Poly":
        """Drops the remainder and one coefficient."""
        n = len(self.coeffs)
        if n == 0:
            return Poly(self.spec, [])
        q = [0] * (n - 1)
        acc = 0
        for j in range(n - 1, 0, -1):
            acc = (acc * b + self.coeffs[j]) % self.spec.p
            q[j - 1] = acc
        return Poly(self.spec, q)

    def scale(self, sc: int) -> "Poly":
        return Poly(self.spec, [c * sc % self.spec.p for c in self.coeffs])

    def __add__(self, other: "Poly") -> "Poly":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [0] * (n - len(self.coeffs))
        b = other.coeffs + [0] * (n - len(other.coeffs))
        return Poly(self.spec, [(x + y) % self.spec.p for x, y in zip(a, b)])

    def __rshift__(self, k: int) -> "Poly":
        return Poly(self.spec, [0] * k + self.coeffs)

    def mul_naive(self, other: "Poly") -> "Poly":
        la, lb = len(self.coeffs), len(other.coeffs)
        out = [0] * (la + lb - 1)
        for i, x in enumerate(self.coeffs):
            for j, y in enumerate(other.coeffs):
                out[i + j] = (out[i + j] + x * y) % self.spec.p
        return Poly(self.spec, out)

    def mul_karatsuba(self, other: "Poly") -> "Poly":
        """Karatsuba split-multiply (kept for parity with the reference)."""
        a, b = self.coeffs, other.coeffs
        if len(a) <= 1 or len(b) <= 1:
            return self.mul_naive(other)
        d = max(len(a), len(b)) // 2
        a_l, a_r = Poly(self.spec, a[:d]), Poly(self.spec, a[d:])
        b_l, b_r = Poly(self.spec, b[:d]), Poly(self.spec, b[d:])
        m0 = a_l.mul_karatsuba(b_l)
        m2 = a_r.mul_karatsuba(b_r)
        m1 = (a_l + a_r).mul_karatsuba(b_l + b_r) + (m0 + m2).scale(-1)
        return m0 + (m1 >> d) + (m2 >> (2 * d))

    def __mul__(self, other: "Poly") -> "Poly":
        return self.mul_naive(other)

    # -- device bridging ----------------------------------------------------
    def to_device(self, pad_len: int | None = None, device="cuda"):
        n = pad_len or len(self.coeffs)
        cs = self.coeffs + [0] * (n - len(self.coeffs))
        return limbs_from_numpy(ints_to_mont_limbs(cs, self.spec), device)

    @classmethod
    def from_device(cls, spec: FieldSpec, arr, length: int | None = None):
        if isinstance(arr, torch.Tensor):
            arr = limbs_to_numpy(arr)
        ints = mont_limbs_to_ints(np.asarray(arr).reshape(-1, N_LIMBS), spec)
        if length is not None:
            ints = ints[:length]
        return cls(spec, ints)
