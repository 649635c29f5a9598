"""Batched prime-field arithmetic: 16 x 16-bit limbs, Montgomery form.

Counterpart of the JAX package's ops/ff.py, as far as the MSM needs it.

  * a field element is a (..., 16) int32 tensor, little-endian 16-bit limbs
  * Montgomery domain with R = 2^256 throughout, values fully reduced
  * all ops broadcast over arbitrary leading axes

Routing is by the tensor: an op on a CUDA tensor launches the hand-written
kernel (ops/cuda_ff.py), an op on a CPU tensor runs the kernel's plain PyTorch
version.  Constants are made on the device of the tensor they meet.

mul_small, reduce_columns, sum, dot and pow_fixed belong to the NTT and
polynomial layers and are not ported yet.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..fields import FieldSpec, N_LIMBS
from ..limbs import int_to_limbs, int_to_mont_limbs
from . import cuda_ff


class FF:
    """Field-arithmetic namespace bound to one FieldSpec; get instances via
    `ff(spec)` (cached)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self._consts: dict = {}
        e = spec.p - 2
        self._inv_bits = [(e >> i) & 1 for i in range(e.bit_length())][::-1]

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

    # ------------------------------------------------------- mont conversions
    def to_mont(self, a_raw):
        """Canonical limbs -> Montgomery limbs."""
        r2 = self._limb_const("r2", int_to_limbs(self.spec.r2_mod_p), a_raw.device)
        return self.mul(a_raw, r2)

    def from_mont(self, a):
        """Montgomery limbs -> canonical limbs."""
        return self.mul(a, self._limb_const("raw1", int_to_limbs(1), a.device))

    # ---------------------------------------------------------------- inv
    def inv(self, a):
        """a^(p-2): Fermat inversion, inv(0) = 0.  Square-and-multiply over
        the static bits of p - 2 (the leading bit is 1: start from a)."""
        acc = a
        for bit in self._inv_bits[1:]:
            acc = self.sqr(acc)
            if bit:
                acc = self.mul(acc, a)
        return acc

    def batch_inv(self, a, axis: int = 0):
        """Montgomery-trick batch inversion along `axis`; zeros map to zeros.

        The batch is folded into `groups` = 64 steps of W parallel product
        chains (each step one full-width product), and the W chain totals are
        Fermat-inverted in parallel.  Batches of up to 512 skip the chains."""
        a = a.movedim(axis, 0)
        zmask = self.is_zero(a)
        one = self.one(a.device)
        safe = self.select(zmask, one.expand(a.shape), a)
        lead = safe.shape[:-1]
        flat = safe.reshape(-1, N_LIMBS)
        n = flat.shape[0]

        if n <= 512:
            out = self.inv(safe)
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
            tot_inv = self.inv(totals)
            inv_flat = self.mul(self.mul(torch.stack(pre_ex), torch.stack(suf_ex)),
                                tot_inv[None])
            out = inv_flat.reshape(groups * w, N_LIMBS)[:n].reshape(lead + (N_LIMBS,))

        out = self.select(zmask, torch.zeros_like(out), out)
        return out.movedim(0, axis)


@lru_cache(maxsize=None)
def ff(spec: FieldSpec) -> FF:
    return FF(spec)
