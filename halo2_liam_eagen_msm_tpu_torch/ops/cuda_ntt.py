"""The divisor merge tree's limb-major kernels, with their plain versions.

The counterpart of the JAX package's ops/pallas_ntt.py.  Five kernels (CUDA
C++ for sm_90a, csrc/ntt.cuh, built and launched through ops/cuda_ff.py's
library, launcher and LAUNCHES) carry the fused evaluation-domain tail of
divisor.merge_pairs:

  kernel         replaces (ops/pallas_ntt.py)   what it computes
  lm_mul         lm_mul                         pointwise a*b*R^-1
  lm_addsub      lm_addsub                      pointwise (a +- b) mod p
  lm_mul_const   lm_mul_const                   pointwise product by a
                                                constant passed by value
  stage_big      _stage_big                     one radix-2 stage, s >= 1024
  stages_small   _stages_small                  every stage with s <= 512
                                                in one launch

Layout: an array of E field elements is a (16, E) int32 tensor, limb i of
element e at [i, e] (structure of arrays; to_lm / from_lm convert from and
to the (..., 16) rows of the rest of the port).  Unlike the TPU's
(16, nb, 8, 128) there is no padding to 1024 elements, so a batch of
transforms only needs E to be a multiple of the transform size n (and of
1024 when n >= 1024): 128-, 256- and 512-point witnesses run too.

A transform of a (pairs, n) batch runs over the flat order e = pair * n + j
with the butterfly network of ops/ntt.ntt_dif / intt_dit, so the results are
bit-identical to the element-major transforms; the twiddles are that
module's flat table, limb-major (16, n - 1).

Routing is by the tensor, in the wrappers themselves: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs `<name>_plain`, the same function
on the same tensors in int64 through ops/cuda_ff's plain field versions.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..fields import FieldSpec, N_LIMBS
from . import cuda_ff as CF
from .ntt import _twiddle_flat_host

BLOCK = 1024  # stages of half-size >= BLOCK are stage_big launches, the rest one stages_small


def _check_lm(name: str, *tensors) -> None:
    CF._check_device(name, *tensors)
    shape = tensors[0].shape
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: limb tensors are int32, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != N_LIMBS or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous ({N_LIMBS}, E) tensors of one "
                             f"shape, got {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def to_lm(x):
    """(..., 16) rows -> (16, E) limb-major, leading axes flattened into E in
    order."""
    return x.reshape(-1, N_LIMBS).t().contiguous()


def from_lm(y, shape):
    """Inverse of to_lm: (16, E) -> tuple(shape) + (16,) rows."""
    return y.t().reshape(tuple(shape) + (N_LIMBS,)).contiguous()


def bcast_pairs_lm(v, n: int):
    """Per-pair values v (..., 16) -> (16, pairs * n): each pair's value over
    its n consecutive elements (the line and root terms of the fused merge)."""
    vt = v.reshape(-1, N_LIMBS).t()
    return vt[:, :, None].expand(N_LIMBS, vt.shape[1], n).reshape(N_LIMBS, -1).contiguous()


def bcast_table_lm(tab, m2: int):
    """Evaluation-domain table (n, 16) -> (16, m2 * n), tiled over m2 pairs."""
    t = tab.t()
    return t[:, None, :].expand(N_LIMBS, m2, t.shape[1]).reshape(N_LIMBS, -1).contiguous()


# ---------------------------------------------------------------------------
# twiddle tables (host, cached per (field, logn, direction); device copies
# cached per device too)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def tables_host(spec: FieldSpec, logn: int, inverse: bool):
    """Host tables of a 2^logn transform: (big, tile, flat_lm).  big: the
    stage_big half-sizes s >= BLOCK in execution order (forward n/2 ... 1024,
    inverse 1024 ... n/2); tile: stages_small's tile, min(n, 1024) (it runs
    every s < tile); flat_lm: ops/ntt._twiddle_flat_host limb-major,
    (16, n - 1) uint32."""
    n = 1 << logn
    big = []
    s = n // 2
    while s >= BLOCK:
        big.append(s)
        s //= 2
    if inverse:
        big.reverse()
    flat_lm = np.ascontiguousarray(_twiddle_flat_host(spec, logn, inverse).T)
    return tuple(big), min(n, BLOCK), flat_lm


_TABLES_DEV: dict = {}


def tables(spec: FieldSpec, logn: int, inverse: bool, device) -> torch.Tensor:
    """The (16, n - 1) int32 limb-major twiddle table on `device`, uploaded
    once."""
    key = (spec.name, logn, inverse, str(torch.device(device)))
    t = _TABLES_DEV.get(key)
    if t is None:
        host = tables_host(spec, logn, inverse)[2]
        t = _TABLES_DEV[key] = torch.from_numpy(host.view(np.int32).copy()).to(device)
    return t


# ---------------------------------------------------------------------------
# the five kernels (a CUDA tensor launches, a CPU tensor takes the plain version)
# ---------------------------------------------------------------------------

def lm_mul(spec: FieldSpec, a, b):
    """Pointwise Montgomery product of two (16, E) tensors."""
    if not CF._use_kernel(a):
        return lm_mul_plain(spec, a, b)
    _check_lm("lm_mul", a, b)
    out = torch.empty_like(a)
    CF._launch("lm_mul", a.device, ctypes.byref(CF._field_params(spec)),
               a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1])
    return out


def lm_addsub(spec: FieldSpec, is_sub: bool, a, b):
    """Pointwise (a +- b) mod p of two (16, E) tensors."""
    if not CF._use_kernel(a):
        return lm_addsub_plain(spec, is_sub, a, b)
    _check_lm("lm_addsub", a, b)
    out = torch.empty_like(a)
    CF._launch("lm_addsub", a.device, ctypes.byref(CF._field_params(spec)),
               int(bool(is_sub)), a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1])
    return out


def lm_add(spec: FieldSpec, a, b):
    return lm_addsub(spec, False, a, b)


def lm_sub(spec: FieldSpec, a, b):
    return lm_addsub(spec, True, a, b)


def lm_mul_const(spec: FieldSpec, a, c: int):
    """Pointwise product by a constant: c is the constant's Montgomery-form
    integer value (below p); the kernel takes it by value."""
    if not 0 <= c < spec.p:
        raise ValueError("lm_mul_const: c must be a reduced field element")
    if not CF._use_kernel(a):
        return lm_mul_const_plain(spec, a, c)
    _check_lm("lm_mul_const", a)
    out = torch.empty_like(a)
    CF._launch("lm_mul_const", a.device, ctypes.byref(CF._field_params(spec)),
               CF._words32(c), a.data_ptr(), out.data_ptr(), a.shape[1])
    return out


def _check_stage(name: str, x, width: int, tw) -> None:
    """E a multiple of the power of two `width`; a twiddle table that holds
    the stages below width (columns up to width - 2)."""
    e = x.shape[1]
    if width < 2 or width & (width - 1) or e % width:
        raise ValueError(f"{name}: {e} elements are no multiple of the power of two {width}")
    if tw.dim() != 2 or tw.shape[0] != N_LIMBS or tw.shape[1] < width - 1:
        raise ValueError(f"{name}: a (16, >= {width - 1}) twiddle table is needed, "
                         f"got {tuple(tw.shape)}")


def stage_big(spec: FieldSpec, x, s: int, inverse: bool, tw):
    """One butterfly stage of half-size s over (16, E), E a multiple of 2s:
    forward DIF (x0 + x1, tw (x0 - x1)), inverse DIT (x0 + tw x1, x0 - tw x1),
    twiddle index e & (s - 1).  tw: the transform's (16, n - 1) table."""
    _check_stage("stage_big", x, 2 * s, tw)
    if not CF._use_kernel(x):
        return stage_big_plain(spec, x, s, inverse, tw)
    _check_lm("stage_big", x)
    _check_lm("stage_big", tw)
    out = torch.empty_like(x)
    CF._launch("stage_big", x.device, ctypes.byref(CF._field_params(spec)),
               int(bool(inverse)), x.data_ptr(), out.data_ptr(), tw.data_ptr(),
               tw.shape[1], s, x.shape[1])
    return out


def stages_small(spec: FieldSpec, x, tile: int, inverse: bool, tw):
    """Every stage of half-size s < tile in one launch (forward tile/2 ... 1,
    inverse 1 ... tile/2) over (16, E), E a multiple of tile, tile = min(n,
    1024) a power of two.  tw: the transform's (16, n - 1) table."""
    _check_stage("stages_small", x, tile, tw)
    if tile > BLOCK:
        raise ValueError(f"stages_small: tile {tile} above {BLOCK}")
    if not CF._use_kernel(x):
        return stages_small_plain(spec, x, tile, inverse, tw)
    _check_lm("stages_small", x)
    _check_lm("stages_small", tw)
    out = torch.empty_like(x)
    CF._launch("stages_small", x.device, ctypes.byref(CF._field_params(spec)),
               int(bool(inverse)), x.data_ptr(), out.data_ptr(), tw.data_ptr(),
               tw.shape[1], tile, x.shape[1])
    return out


def stages_small_r1(spec: FieldSpec, x, tile: int, inverse: bool, tw):
    """Test-only: stages_small's stages by the 1-bit window (R = 1) at any
    tile, one launch of csrc/ntt.cuh's stages_small_r1_probe_launch.  The
    path's launcher takes R = 1 at a tile of 2 alone: from a tile of 8 up it
    hung on the card when it was tried (PERF.md section 7).  No path calls
    it and it counts no launch; its plain version is stages_small_plain.
    A CPU tensor is refused (there is nothing to fall back to: this exists
    to run the kernel)."""
    _check_stage("stages_small_r1", x, tile, tw)
    if tile > BLOCK:
        raise ValueError(f"stages_small_r1: tile {tile} above {BLOCK}")
    if not CF._use_kernel(x):
        raise ValueError("stages_small_r1: the probe runs the kernel, on a CUDA tensor")
    _check_lm("stages_small_r1", x)
    _check_lm("stages_small_r1", tw)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream if x.is_cuda else None
    rc = CF._lib().stages_small_r1_probe_launch(
        ctypes.byref(CF._field_params(spec)), int(bool(inverse)), x.data_ptr(), out.data_ptr(),
        tw.data_ptr(), tw.shape[1], tile, x.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"stages_small_r1: kernel launch failed with CUDA error {rc}")
    return out


# ---------------------------------------------------------------------------
# plain versions (any device; int64 arithmetic through ops/cuda_ff)
# ---------------------------------------------------------------------------

def lm_mul_plain(spec: FieldSpec, a, b):
    return CF.mont_mul_plain(spec, a.t(), b.t()).t().contiguous()


def lm_addsub_plain(spec: FieldSpec, is_sub: bool, a, b):
    return CF.mont_addsub_plain(spec, is_sub, a.t(), b.t()).t().contiguous()


def lm_mul_const_plain(spec: FieldSpec, a, c: int):
    cv = torch.tensor([(c >> (16 * i)) & 0xFFFF for i in range(N_LIMBS)],
                      dtype=torch.int32, device=a.device)
    return CF.mont_mul_plain(spec, a.t(), cv).t().contiguous()


def _stage_plain(spec: FieldSpec, x, s: int, inverse: bool, tw):
    """One butterfly stage of half-size s on (16, E) limb-major data."""
    e = x.shape[1]
    v = x.reshape(N_LIMBS, e // (2 * s), 2, s).permute(1, 2, 3, 0)  # (blocks, 2, s, 16)
    x0, x1 = v[:, 0], v[:, 1]
    t = tw[:, s - 1: 2 * s - 1].t()                                  # (s, 16)
    if not inverse:
        y0 = CF.mont_addsub_plain(spec, False, x0, x1)
        y1 = CF.mont_mul_plain(spec, t, CF.mont_addsub_plain(spec, True, x0, x1))
    else:
        tx = CF.mont_mul_plain(spec, t, x1)
        y0 = CF.mont_addsub_plain(spec, False, x0, tx)
        y1 = CF.mont_addsub_plain(spec, True, x0, tx)
    return torch.stack([y0, y1], dim=1).permute(3, 0, 1, 2).reshape(N_LIMBS, e).contiguous()


def stage_big_plain(spec: FieldSpec, x, s: int, inverse: bool, tw):
    return _stage_plain(spec, x, s, inverse, tw)


def stages_small_plain(spec: FieldSpec, x, tile: int, inverse: bool, tw):
    s = 1 if inverse else tile // 2
    while 1 <= s <= tile // 2:
        x = _stage_plain(spec, x, s, inverse, tw)
        s = 2 * s if inverse else s // 2
    return x


# ---------------------------------------------------------------------------
# whole transforms (bit-identical to ops/ntt.ntt_dif / intt_dit)
# ---------------------------------------------------------------------------

def ntt_dif_lm(spec: FieldSpec, x_lm, logn: int, tw=None):
    """Forward DIF on (16, E) data, E a multiple of n = 2^logn (and of 1024
    for n >= 1024): the batch's transforms in flat order e = b * n + j,
    natural coefficients in, bit-reversed spectra out.  tw: optional device
    table (tables())."""
    if logn == 0:
        return x_lm
    big, tile, _ = tables_host(spec, logn, False)
    if tw is None:
        tw = tables(spec, logn, False, x_lm.device)
    for s in big:
        x_lm = stage_big(spec, x_lm, s, False, tw)
    return stages_small(spec, x_lm, tile, False, tw)


def intt_dit_lm(spec: FieldSpec, x_lm, logn: int, tw=None):
    """Inverse DIT on (16, E) data, bit-reversed spectra in, natural
    coefficients out, with NO 1/n scale (the fused merge folds it into the
    denominator's inversion)."""
    if logn == 0:
        return x_lm
    big, tile, _ = tables_host(spec, logn, True)
    if tw is None:
        tw = tables(spec, logn, True, x_lm.device)
    x_lm = stages_small(spec, x_lm, tile, True, tw)
    for s in big:
        x_lm = stage_big(spec, x_lm, s, True, tw)
    return x_lm
