"""Montgomery multiplication by a shared constant as matrix products.

Counterpart of the JAX package's ops/mxu_ff.py (a jnp module with no Pallas
kernel), with the same public names and shapes.  A batch multiplied by one
constant c is a linear map on its limbs, so the product can run where the
card's matrix units are:

  * a 254-bit element is 32 byte planes (its 16 limbs, lo and hi byte each);
  * its product by c is the byte convolution planes(a) @ T, T the 32 x 64
    Toeplitz matrix T[k, k + l] = byte_l(c); a byte column sums at most 32
    products of two bytes, below 2^21;
  * pairs of byte columns make 16-bit columns below 2^29.1, which the
    port's carry networks take (cuda_ff._normalize, _norm_sub_p);
  * a Montgomery product by c takes three such products, all by constants:
    t = a c, m = (t mod R) mu mod R (mu = -p^-1 mod R), u = m p.

No path calls it, in either package: it exists to measure whether taking the
field product off the integer pipes pays (PERF.md).

Routing is by the tensor, as everywhere in the port: mul_const and mul_table
launch the tensor-core kernel (csrc/mxu.cuh: mxu_mul_const, mxu_mul_table,
mma.sync on u8 bytes with s32 sums, the carries in registers) for a CUDA
tensor, and their plain versions for a CPU tensor.  A kernel that does not
build or launch raises; nothing falls back.

The plain versions follow the JAX module step for step with float32 matrix
products: a byte (at most 255) and a product of two (at most 65,025) are
exact in float32, and so is every column sum below 2^21 < 2^24, in any
order of summation.  TF32 keeps 10 bits of mantissa, so even with TF32
matrix products on the card the bytes stay exact.  (Never a bf16 result: a
product of two bf16 tensors returns bf16, which rounds sums to 8 bits.)
Tensors are (..., 16) int32 16-bit limbs in Montgomery form, fully reduced;
the column tensors between the steps are int64.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..fields import FieldSpec, N_LIMBS, R
from . import cuda_ff as CF

N_BYTES = 2 * N_LIMBS  # 32 byte planes


def _bytes_of(x: int, n: int = N_BYTES) -> np.ndarray:
    return np.array([(x >> (8 * i)) & 0xFF for i in range(n)], np.float32)


@lru_cache(maxsize=None)
def _toeplitz(c: int, out_bytes: int = 2 * N_BYTES) -> np.ndarray:
    """(32, out_bytes) float32 Toeplitz matrix of c's bytes:
    (planes @ T)[m] = sum_{k+l=m} byte_k(a) * byte_l(c)."""
    cb = _bytes_of(c)
    T = np.zeros((N_BYTES, out_bytes), np.float32)
    for k in range(N_BYTES):
        for l in range(N_BYTES):
            if k + l < out_bytes:
                T[k, k + l] = cb[l]
    T.flags.writeable = False
    return T


def planes(a):
    """(..., 16) integer 16-bit limbs -> (..., 32) float32 byte planes
    (interleaved lo/hi; exact: bytes <= 255)."""
    lo = (a & 0xFF).to(torch.float32)
    hi = ((a >> 8) & 0xFF).to(torch.float32)
    return torch.stack([lo, hi], dim=-1).reshape(a.shape[:-1] + (N_BYTES,))


def _to_cols16(y, n_cols: int):
    """(..., 2*n_cols) float32 byte columns (< 2^21, exact integers) ->
    (..., n_cols) int64 16-bit columns (< 2^21 + 2^29 < 2^29.1)."""
    y = y.to(torch.int64).reshape(y.shape[:-1] + (n_cols, 2))
    return y[..., 0] + (y[..., 1] << 8)


def prod_cols_const(a, c: int, out_cols: int = 2 * N_LIMBS):
    """The 16-bit column sums of a * c (int64, each below 2^29.1) by one
    float32 matrix product: the counterpart of the JAX module's."""
    T = torch.from_numpy(_toeplitz(c, 2 * out_cols).copy()).to(a.device)
    return _to_cols16(planes(a) @ T, out_cols)


def _mu(spec: FieldSpec) -> int:
    return (-pow(spec.p, -1, R)) % R


def _reduce(spec: FieldSpec, t):
    """The Montgomery reduction of t's (..., 32) 16-bit columns by two more
    constant products: (t + m p) / R mod p, m = (t mod R) mu mod R.

    Every column that meets a carry network here is below 2^31 (t's below
    2^29.1, t_lo + u's low half below 2^29.2, the high halves' sum below
    2^30.1, plus 2^256 - p's limbs in _norm_sub_p), and one fold of
    _normalize leaves a column below 2^32 under 2^16 - 1 + 2^16 = 2^17 - 1,
    which is all its carry step needs: so one fold each."""
    n = N_LIMBS
    C = CF._plain_consts(spec, t.device)
    t_lo, t_lo_carry = CF._normalize(C, t[..., :n], folds=1)
    # m = low16(T_lo * mu): only byte columns 0..31 needed
    m, _ = CF._normalize(C, prod_cols_const(t_lo, _mu(spec), out_cols=n), folds=1)
    u = prod_cols_const(m, spec.p)                 # (..., 32) cols of m*p
    # the low halves cancel exactly: the carry out of (T_lo + U_lo) into column n
    _, lo_carry = CF._normalize(C, t_lo + u[..., :n], folds=1)
    hi = t[..., n:] + u[..., n:]                   # < 2^30.1
    hi[..., 0] += lo_carry + t_lo_carry
    return CF._norm_sub_p(C, hi, folds=1)


def mul_const_plain(spec: FieldSpec, a, c: int):
    """Plain version of mul_const: three float32 Toeplitz products and the
    carry networks, on any device."""
    return _reduce(spec, prod_cols_const(a, c))


def _table_tensor(table, n_pos: int, device):
    tb = table if torch.is_tensor(table) else torch.from_numpy(np.asarray(table, np.int64))
    if tuple(tb.shape) != (n_pos, N_LIMBS):
        raise ValueError(f"mul_table: a ({n_pos}, {N_LIMBS}) table is needed, got "
                         f"{tuple(tb.shape)}")
    return tb.to(device=device, dtype=torch.int32)


def mul_table_plain(spec: FieldSpec, a, table):
    """Plain version of mul_table: one batched float32 product, (n_pos, B,
    32) x (n_pos, 32, 64), then mul_const's reduction."""
    n_pos = a.shape[-2]
    lead = a.shape[:-2]
    cb = planes(_table_tensor(table, n_pos, a.device))           # (n_pos, 32)
    rhs = torch.zeros((n_pos, N_BYTES, 2 * N_BYTES), dtype=torch.float32, device=a.device)
    for k in range(N_BYTES):
        rhs[:, k, k:k + N_BYTES] = cb
    pl = planes(a).reshape((-1, n_pos, N_BYTES)).transpose(0, 1)  # (n_pos, B, 32)
    y = torch.matmul(pl, rhs).transpose(0, 1).reshape(lead + (n_pos, 2 * N_BYTES))
    return _reduce(spec, _to_cols16(y, 2 * N_LIMBS))


# ---------------------------------------------------------------------------
# the kernel (csrc/mxu.cuh), for CUDA tensors
# ---------------------------------------------------------------------------

class _MxuParams(ctypes.Structure):
    """Mirror of `struct MxuParams` in csrc/mxu.cuh."""
    _fields_ = [("c", ctypes.c_uint32 * 8), ("mu", ctypes.c_uint32 * 8),
                ("rp", ctypes.c_uint32 * 8)]


def _mxu_params(spec: FieldSpec, c: int) -> _MxuParams:
    return _MxuParams(CF._words32(c), CF._words32(_mu(spec)), CF._words32(R - spec.p))


def mxu_mul_const(spec: FieldSpec, a, c: int):
    """(..., 16) rows times the constant c (its Montgomery-form integer): one
    launch of mxu_mul_const."""
    CF._check_cuda("mxu_mul_const", a)
    lead, (af,) = CF._flatten(a)
    out = torch.empty_like(af)
    CF._launch("mxu_mul_const", af.device, ctypes.byref(CF._field_params(spec)),
               ctypes.byref(_mxu_params(spec, c)), af.data_ptr(), out.data_ptr(), af.shape[0])
    return out.reshape(lead + (N_LIMBS,))


def mxu_mul_table(spec: FieldSpec, a, table):
    """(..., n_pos, 16) rows times the (n_pos, 16) table, position by
    position: one launch of mxu_mul_table."""
    if a.dim() < 2:
        raise ValueError(f"mxu_mul_table: (..., n_pos, 16) rows are needed, got {tuple(a.shape)}")
    n_pos = a.shape[-2]
    CF._check_cuda("mxu_mul_table", a)
    _, (tb,) = CF._flatten(_table_tensor(table, n_pos, a.device))
    _, (af,) = CF._flatten(a)  # rows in order: lead-major, n_pos a lead index
    out = torch.empty_like(af)
    CF._launch("mxu_mul_table", af.device, ctypes.byref(CF._field_params(spec)),
               ctypes.byref(_mxu_params(spec, 0)), tb.data_ptr(), af.data_ptr(),
               out.data_ptr(), af.shape[0] // max(n_pos, 1), n_pos)
    return out.reshape(a.shape)


def mul_const(spec: FieldSpec, a, c: int):
    """Montgomery product a * c * R^-1 mod p, c the constant's Montgomery-form
    integer (as the second operand of FF.mul): the kernel for a CUDA tensor,
    the plain version for a CPU tensor.  Equal to FF.mul(a, const(c)) limb
    for limb."""
    if not CF._use_kernel(a):
        return mul_const_plain(spec, a, c)
    return mxu_mul_const(spec, a, c)


def mul_table(spec: FieldSpec, a, table):
    """Batched per-position constant multiply: a (..., n_pos, 16) times the
    per-position constants table (n_pos, 16), the NTT twiddle stage's shape,
    the table shared across the leading axes.  Equal to FF.mul(a,
    broadcast(table)) limb for limb."""
    if not CF._use_kernel(a):
        return mul_table_plain(spec, a, table)
    return mxu_mul_table(spec, a, table)
