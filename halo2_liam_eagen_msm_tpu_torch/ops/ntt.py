"""Number-theoretic transform over the field layer (element-major).

Counterpart of the JAX package's ops/ntt.py, the same butterfly network on
(..., N, 16) Montgomery limb tensors, N a power of two:

  * ntt: natural order in and out (one bit-reversal gather first), with the
    optional 1/N scale of the inverse
  * ntt_dif / intt_dit: the gather-free pair; ntt_dif gives the spectrum in
    bit-reversed order, intt_dit takes it back to natural coefficients
  * each stage is one butterfly over the whole array (reshape to
    (..., N/m, 2, m/2, 16)) through ops/ff.py, so on the card it runs on the
    field kernels (mont_mul, mont_addsub) and on the CPU on their plain
    versions

The host twiddle tables are byte-identical to the JAX package's: stage s
(m = 2^s) needs w_m^j, j < m/2.  They are built by running products instead
of one modular power each (2^20 powers take tens of seconds in Python):
the top stage's w_n^j in the Montgomery domain, (w_n^(j-1) R) * w_n mod p,
and every lower stage is a strided view of it, since w_m = w_n^(n/m).  The
limb-major transforms of ops/cuda_ntt.py read the same flat table.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import FieldSpec, N_LIMBS
from ..limbs import ints_to_limbs
from .ff import ff


@lru_cache(maxsize=None)
def _bitrev_perm(logn: int) -> np.ndarray:
    n = 1 << logn
    idx = np.arange(n, dtype=np.int64)
    perm = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        perm |= ((idx >> b) & 1) << (logn - 1 - b)
    return perm.astype(np.int32)


def _mont_powers(spec: FieldSpec, w: int, count: int) -> np.ndarray:
    """(count, 16) Montgomery limbs of w^0 .. w^(count-1): a running product
    kept in the Montgomery domain (x R * w = (x w) R), one modular product a
    power."""
    p = spec.p
    out = []
    x = spec.r_mod_p
    for _ in range(count):
        out.append(x)
        x = x * w % p
    return ints_to_limbs(out)


@lru_cache(maxsize=None)
def _top_stage(spec: FieldSpec, logn: int, inverse: bool) -> np.ndarray:
    """Montgomery limbs of w_n^j, j < n/2, n = 2^logn (w_n inverted for the
    inverse transform)."""
    if logn > spec.s:
        raise ValueError(f"size 2^{logn} exceeds the 2-adicity of {spec.name}")
    w_n = spec.omega_pow_inv(spec.s - logn) if inverse else spec.omega_pow(spec.s - logn)
    return _mont_powers(spec, w_n, 1 << (logn - 1))


def _twiddles(spec: FieldSpec, logn: int, inverse: bool):
    """Per-stage twiddle tables: stage s (m = 2^s) holds w_m^j, j < m/2, as
    (m/2, 16) uint32 arrays, s = 1 .. logn."""
    if logn == 0:
        return []
    top = _top_stage(spec, logn, inverse)
    n = 1 << logn
    return [top[: n // 2: n >> s] for s in range(1, logn + 1)]


@lru_cache(maxsize=None)
def _twiddle_flat_host(spec: FieldSpec, logn: int, inverse: bool) -> np.ndarray:
    """All stages' twiddles in one (n-1, 16) uint32 array: stage s (m = 2^s)
    at rows [2^(s-1)-1, 2^s-1)."""
    if logn == 0:
        return np.zeros((0, N_LIMBS), dtype=np.uint32)
    return np.ascontiguousarray(np.concatenate(_twiddles(spec, logn, inverse), axis=0))


_TW_DEV: dict = {}


def twiddle_flat(spec: FieldSpec, logn: int, inverse: bool, device) -> torch.Tensor:
    """Device copy of _twiddle_flat_host as (n-1, 16) int32, uploaded once
    per (field, size, direction, device)."""
    key = (spec.name, logn, inverse, str(torch.device(device)))
    t = _TW_DEV.get(key)
    if t is None:
        host = _twiddle_flat_host(spec, logn, inverse)
        t = _TW_DEV[key] = torch.from_numpy(host.view(np.int32).copy()).to(device)
    return t


def _stage_tw(tws_flat, s: int):
    return tws_flat[(1 << (s - 1)) - 1:(1 << s) - 1]


def _log2(n: int) -> int:
    logn = n.bit_length() - 1
    if n <= 0 or 1 << logn != n:
        raise ValueError(f"transform length {n} is not a power of two")
    return logn


def ntt(spec: FieldSpec, a, inverse: bool = False, scale: bool = False):
    """DFT of a (..., N, 16) over the 2^logn-th roots of unity: natural order
    in, natural order out.  With scale=True on the inverse transform the 1/N
    factor is applied."""
    k = ff(spec)
    n = a.shape[-2]
    logn = _log2(n)
    if logn == 0:
        return a
    perm = torch.from_numpy(_bitrev_perm(logn).astype(np.int64)).to(a.device)
    a = a.index_select(-2, perm)
    tws = twiddle_flat(spec, logn, inverse, a.device)
    lead = a.shape[:-2]
    for s in range(1, logn + 1):
        m = 1 << s
        a = a.reshape(lead + (n // m, 2, m // 2, N_LIMBS))
        even = a[..., 0, :, :]
        odd = a[..., 1, :, :]
        t = k.mul(_stage_tw(tws, s), odd)
        a = torch.stack([k.add(even, t), k.sub(even, t)], dim=-3)
    a = a.reshape(lead + (n, N_LIMBS))
    if scale:
        inv_n = k.const(pow(n, spec.p - 2, spec.p), a.device)
        a = k.mul(a, inv_n.expand(a.shape))
    return a


def ntt_dif(spec: FieldSpec, a, tws=None):
    """Forward transform, natural coefficients in -> bit-reversed spectrum.
    tws: optional (n-1, 16) flat twiddle tensor (twiddle_flat)."""
    k = ff(spec)
    n = a.shape[-2]
    logn = _log2(n)
    if logn == 0:
        return a
    if tws is None:
        tws = twiddle_flat(spec, logn, False, a.device)
    lead = a.shape[:-2]
    for s in range(logn, 0, -1):  # m = n, n/2, ..., 2
        m = 1 << s
        a = a.reshape(lead + (n // m, 2, m // 2, N_LIMBS))
        x0 = a[..., 0, :, :]
        x1 = a[..., 1, :, :]
        a = torch.stack([k.add(x0, x1), k.mul(_stage_tw(tws, s), k.sub(x0, x1))], dim=-3)
    return a.reshape(lead + (n, N_LIMBS))


def intt_dit(spec: FieldSpec, a, scale: bool = True, tws=None):
    """Inverse transform, bit-reversed spectrum in -> natural coefficients.
    tws: optional (n-1, 16) flat twiddle tensor (see ntt_dif)."""
    k = ff(spec)
    n = a.shape[-2]
    logn = _log2(n)
    if logn == 0:
        return a
    if tws is None:
        tws = twiddle_flat(spec, logn, True, a.device)
    lead = a.shape[:-2]
    for s in range(1, logn + 1):  # m = 2, 4, ..., n
        m = 1 << s
        a = a.reshape(lead + (n // m, 2, m // 2, N_LIMBS))
        even = a[..., 0, :, :]
        odd = a[..., 1, :, :]
        t = k.mul(_stage_tw(tws, s), odd)
        a = torch.stack([k.add(even, t), k.sub(even, t)], dim=-3)
    a = a.reshape(lead + (n, N_LIMBS))
    if scale:
        inv_n = k.const(pow(n, spec.p - 2, spec.p), a.device)
        a = k.mul(a, inv_n.expand(a.shape))
    return a
