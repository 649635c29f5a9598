"""Batched prime-field arithmetic: 16 x 16-bit limbs, Montgomery form.

Counterpart of the JAX package's ops/ff.py.

  * a field element is a (..., 16) int32 tensor, little-endian 16-bit limbs
  * Montgomery domain with R = 2^256 throughout, values fully reduced
  * all ops broadcast over arbitrary leading axes

Routing is by the tensor: an op on a CUDA tensor launches the hand-written
kernel (ops/cuda_ff.py), an op on a CPU tensor runs the kernel's plain PyTorch
version.  Constants are made on the device of the tensor they meet.

The lazy sums of reduce_columns, sum and dot (the polynomial layer's
dot-product sums; the schoolbook product's anti-diagonal sums are one
poly_mul_naive launch on the card) are plain PyTorch: the column sums of
16-bit limbs are taken exactly in int64 (the JAX package keeps them in
uint32, which bounds how many it may add; int64 leaves room for 2^46 a
column), then carried into limbs on the tensor's device and reduced by two
Montgomery products.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..convert import limbs_from_numpy, limbs_to_numpy
from ..fields import FieldSpec, N_LIMBS
from ..limbs import int_to_limbs, int_to_mont_limbs, ints_to_limbs, limbs_to_ints
from . import cuda_ff

_SUM_CHUNK = 4096  # rows added lazily before one reduction (as the JAX package)


class FF:
    """Field-arithmetic namespace bound to one FieldSpec; get instances via
    `ff(spec)` (cached)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self._consts: dict = {}

    # ------------------------------------------------------------------ utils
    def _limb_const(self, key, limbs, device) -> torch.Tensor:
        k = (key, str(device))
        t = self._consts.get(k)
        if t is None:
            t = torch.tensor([int(v) for v in limbs], dtype=torch.int32, device=device)
            self._consts[k] = t
        return t

    def const(self, x: int, device) -> torch.Tensor:
        """Canonical int -> (16,) Montgomery limb constant on `device`."""
        return self._limb_const(("c", x), int_to_mont_limbs(x, self.spec), device)

    def one(self, device) -> torch.Tensor:
        """1 in Montgomery form."""
        return self._limb_const("one", int_to_limbs(self.spec.r_mod_p), device)

    @staticmethod
    def select(mask, x, y):
        """mask: (...,) bool; x, y: (..., 16).  Returns where(mask, x, y)."""
        return torch.where(mask[..., None], x, y)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=-1)

    @staticmethod
    def eq(a, b):
        return (a == b).all(dim=-1)

    # --------------------------------------------------------------- add/sub
    def add(self, a, b):
        """(a + b) mod p."""
        if a.is_cuda:
            return cuda_ff.mont_addsub(self.spec, False, a, b)
        return cuda_ff.mont_addsub_plain(self.spec, False, a, b)

    def sub(self, a, b):
        """(a - b) mod p."""
        if a.is_cuda:
            return cuda_ff.mont_addsub(self.spec, True, a, b)
        return cuda_ff.mont_addsub_plain(self.spec, True, a, b)

    def neg(self, a):
        """-a mod p (maps 0 -> 0)."""
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    # ---------------------------------------------------------------- mul
    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p (R = 2^256)."""
        if a.is_cuda:
            return cuda_ff.mont_mul(self.spec, a, b)
        return cuda_ff.mont_mul_plain(self.spec, a, b)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small(self, a, k: int):
        """a * k for a small static k >= 0 via double-and-add."""
        if k < 0:
            raise ValueError("mul_small: k must be non-negative")
        if k == 0:
            return torch.zeros_like(a)
        acc = a
        for bit in bin(k)[3:]:
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, a)
        return acc

    # --------------------------------------------------- lazy sums/reductions
    def reduce_columns(self, cols):
        """Reduce lazy column sums of Montgomery residues to a fully reduced
        element: cols (..., K <= 17) integer tensor, every column below
        2^46 and the total value below 2^271 (both exact in int64); see
        cuda_ff.reduce_columns_with, here on this namespace's products and
        adds."""
        return cuda_ff.reduce_columns_with(self.spec, cols, self.mul, self.add)

    def sum(self, a, axis: int = -2):
        """Sum field elements along `axis`: lazy int64 column sums over chunks
        of 4096 rows, one reduction per chunk, until one row is left."""
        a = a.movedim(axis, -2)
        n = a.shape[-2]
        if n == 0:
            return torch.zeros(a.shape[:-2] + (N_LIMBS,), dtype=a.dtype, device=a.device)
        while n > 1:
            c = min(n, _SUM_CHUNK)
            pad = (-n) % c
            if pad:
                a = torch.nn.functional.pad(a, (0, 0, 0, pad))
            g = (n + pad) // c
            cols = a.reshape(a.shape[:-2] + (g, c, N_LIMBS)).sum(-2, dtype=torch.int64)
            a = self.reduce_columns(cols)
            n = g
        return a[..., 0, :]

    def dot(self, a, b, axis: int = -2):
        """sum(mul(a, b)) along `axis`."""
        return self.sum(self.mul(a, b), axis=axis)

    # ------------------------------------------------------- mont conversions
    def to_mont(self, a_raw):
        """Canonical limbs -> Montgomery limbs."""
        r2 = self._limb_const("r2", int_to_limbs(self.spec.r2_mod_p), a_raw.device)
        return self.mul(a_raw, r2)

    def from_mont(self, a):
        """Montgomery limbs -> canonical limbs."""
        return self.mul(a, self._limb_const("raw1", int_to_limbs(1), a.device))

    # ------------------------------------------------------------ pow / inv
    def pow_fixed(self, a, e: int):
        """a^e for a static exponent e >= 0 (square-and-multiply)."""
        if e < 0:
            raise ValueError("pow_fixed: e must be non-negative")
        if e == 0:
            return self.one(a.device).expand(a.shape)
        acc = a
        for bit in bin(e)[3:]:
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """a^(p-2): Fermat inversion, inv(0) = 0.  On the card one launch of
        the batch_inv kernel, as batch_inv takes (every output is the unique
        inverse, so the kernel's chains change no limb); on the CPU, where
        each product costs tens of small tensor ops, the same power is taken
        exactly with Python ints (_inv_host)."""
        if a.is_cuda:
            return cuda_ff.batch_inv(self.spec, a)
        return self._inv_host(a)

    def _inv_host(self, a):
        """inv on the host: (a R)^-1 R^2 = a^-1 R mod p, element by element."""
        p, r2 = self.spec.p, self.spec.r2_mod_p
        vals = limbs_to_ints(limbs_to_numpy(a))
        out = ints_to_limbs([pow(x, p - 2, p) * r2 % p for x in vals])
        return limbs_from_numpy(out.reshape(tuple(a.shape)), a.device)

    def batch_inv(self, a, axis: int = 0):
        """Montgomery-trick batch inversion along `axis`; zeros map to zeros.

        On the card one launch of the batch_inv kernel, whose threads each
        run the trick over a chain of rows (every output is the unique
        inverse, so the grouping, and `axis`, change no limb).  On the CPU
        the product chains of _batch_inv_chains with the totals inverted on
        the host."""
        if a.is_cuda:
            return cuda_ff.batch_inv(self.spec, a)
        return self._batch_inv_chains(a, axis)

    def _batch_inv_chains(self, a, axis: int):
        """The batch is folded into `groups` = 64 steps of W parallel product
        chains (each step one full-width product), and the W chain totals are
        inverted on the host (_inv_host).  Batches of up to 512 skip the
        chains."""
        a = a.movedim(axis, 0)
        zmask = self.is_zero(a)
        one = self.one(a.device)
        safe = self.select(zmask, one.expand(a.shape), a)
        lead = safe.shape[:-1]
        flat = safe.reshape(-1, N_LIMBS)
        n = flat.shape[0]

        if n <= 512:
            out = self._inv_host(safe)
        else:
            groups = 64
            w = -(-n // groups)
            pad = groups * w - n
            m = torch.cat([flat, one.expand(pad, N_LIMBS)]).reshape(groups, w, N_LIMBS)
            init = one.expand(w, N_LIMBS)
            pre_ex, suf_ex = [None] * groups, [None] * groups
            carry = init
            for i in range(groups):          # exclusive prefix products
                pre_ex[i] = carry
                carry = self.mul(carry, m[i])
            totals = carry
            carry = init
            for i in reversed(range(groups)):  # exclusive suffix products
                suf_ex[i] = carry
                carry = self.mul(carry, m[i])
            tot_inv = self._inv_host(totals)
            inv_flat = self.mul(self.mul(torch.stack(pre_ex), torch.stack(suf_ex)),
                                tot_inv[None])
            out = inv_flat.reshape(groups * w, N_LIMBS)[:n].reshape(lead + (N_LIMBS,))

        out = self.select(zmask, torch.zeros_like(out), out)
        return out.movedim(0, axis)


@lru_cache(maxsize=None)
def ff(spec: FieldSpec) -> FF:
    return FF(spec)
