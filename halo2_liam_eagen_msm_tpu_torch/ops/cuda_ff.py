"""CUDA kernels for field and curve arithmetic, with their plain versions.

The counterpart of the JAX package's ops/pallas_ff.py.  Ten kernels carry the
field and curve layers: the MSM, the argument's carry stage and the curve
layer's entry points (sources under ops/csrc/, CUDA C++ for sm_90a):

  kernel                  replaces (ops/pallas_ff.py)   what it computes
  mont_mul                mont_mul                      a*b*R^-1 mod p
  batch_inv               mont_mul, at the shape of     a^-1 R mod p (0 -> 0):
                          the batch inversions          a whole Montgomery-
                          (ops/ff.py batch_inv, inv)    trick inversion
  mont_addsub             mont_addsub                   (a +- b) mod p
  ec_add                  ec_add                        complete Jacobian add
  ec_add_fast             ec_add_fast                   generic add + flag
  ec_double               ec_double                     k Jacobian doublings
  fused_madd_scan_xyzz    fused_madd_scan_xyzz          one window's blinded
                                                        XYZZ prefix scan
  ec_madd_xyzz_fast       ec_madd_xyzz_fast             w steps of XYZZ + affine
                                                        adds with a flag a
                                                        carry: the stepwise
                                                        blinded scan (w = 1:
                                                        one step)
  ec_add_mixed            ec_add_mixed                  w steps of complete
                                                        Jacobian + affine adds:
                                                        the safe scan of a
                                                        window (w = 1: one add)
  ec_add_mixed_fast       ec_add_mixed_fast             Jacobian + affine add
                                                        with a flag

On this card mont_mul and mont_addsub are bound by bytes (192 bytes moved for
at most 136 multiply-adds of 32 bits), and the curve kernels sit at the
crossover of bytes and integer operations; so each does its whole formula in
registers on 8 limbs of 32 bits and touches device memory once per input and
output.  See ops/csrc/ff.cuh for the limb repacking.  mont_addsub spreads a
row over four lanes, ec_add, ec_add_fast and ec_double a point over four,
ec_madd_xyzz_fast a carry over four, ec_add_mixed a carry over two;
ec_double keeps its point on chip through k doublings, ec_madd_xyzz_fast and
ec_add_mixed their carries through w steps.  ec_add_mixed_fast is one
thread a point, its rows read in place.  batch_inv runs a chain of products
a thread and is bound by the latency of its power (see csrc/kernels.cu).
Every flag a wrapper returns is a bool tensor the kernel wrote itself (a byte
0 or 1 a flag).

Tensors are (..., 16) int32, little-endian 16-bit limbs in Montgomery form
(R = 2^256), fully reduced to [0, p); a kernel reads the same buffer as
uint32.  The library is built with nvcc at first use into build/ at the root
of the checkout and loaded with ctypes.

Beside every kernel stands its plain PyTorch version, `<name>_plain`: the same
function on the same tensors, device-agnostic, in int64 arithmetic.  The
callers (ops/ff.py, ops/ec.py, ops/msm.py) take the kernel for a CUDA tensor
and the plain version for a CPU tensor.

LAUNCHES counts kernel launches by name: a wrapper adds one exactly where it
launches its kernel.  The same library, counters and launcher carry the five
kernels of the divisor merge tree (csrc/ntt.cuh), whose wrappers and plain
versions are in ops/cuda_ntt.py, the four of the MSM's radix reorder
(csrc/radix.cuh), whose wrappers and plain versions are in ops/cuda_radix.py,
the coefficient levels' three (csrc/poly.cuh: mont_mul's work at the
schoolbook product and the Horner division, by one root or by two in one
walk), whose wrappers and plain versions are in ops/cuda_poly.py, and the
merge head's affine_lines (csrc/lines.cuh: mont_mul's and mont_addsub's work
at the affine normalisation and the lines of divisor.merge_head and
divisor.seeds) with its first design affine_lines_v1, whose wrappers and
plain version are in ops/cuda_lines.py; and mxu_mul_const /
mxu_mul_table (csrc/mxu.cuh: the product by a constant, or by a table row
a position, on the tensor cores), whose wrappers and plain versions are in
ops/mxu_ff.py and which no path launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..fields import CurveSpec, FieldSpec, LIMB_BITS, LIMB_MASK, N_LIMBS, R

KERNELS = ("mont_mul", "batch_inv", "mont_addsub", "ec_add", "ec_add_fast",
           "ec_double", "fused_madd_scan_xyzz", "ec_madd_xyzz_fast", "ec_add_mixed",
           "ec_add_mixed_fast",
           # the divisor merge tree's five, in csrc/ntt.cuh (ops/cuda_ntt.py)
           "lm_mul", "lm_addsub", "lm_mul_const", "stage_big", "stages_small",
           # the radix reorder's four, in csrc/radix.cuh (ops/cuda_radix.py)
           "radix_rank", "radix_shuffle", "radix_pass_b", "radix_compact",
           # the coefficient levels', in csrc/poly.cuh (ops/cuda_poly.py):
           # kate_div2 both divisions of a level, kate_div one (twice: the
           # first design's route, kept for one A/B)
           "poly_mul_naive", "kate_div", "kate_div2",
           # the merge head's, in csrc/lines.cuh (ops/cuda_lines.py), and its
           # first design, kept for one A/B (no path launches it)
           "affine_lines", "affine_lines_v1",
           # the product by a constant on the tensor cores, in csrc/mxu.cuh
           # (ops/mxu_ff.py; no path launches them)
           "mxu_mul_const", "mxu_mul_table")
LAUNCHES = {name: 0 for name in KERNELS}

SCAN_W = 64  # sequential madd steps per lane of the fused scan
# batch_inv gives a thread a chain of L rows, L = n // BATCH_INV_CHAINS between
# 1 and BATCH_INV_MAX_L: at least 16,384 chains where the batch has them (about
# four warps an SM sub-partition, enough to keep it issuing: 4 rows a chain
# ran faster than 2 at 2^16 rows on the H100, 64 faster than 128 at 2^21) and
# a narrow batch is one row a thread
BATCH_INV_CHAINS = 16384
BATCH_INV_MAX_L = 64
POW_WINDOW = 4  # bits of a window of the power (csrc/ff.cuh fe_pow)

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_INFO: dict = {}  # filled by the first build: path, seconds, ptxas log
_LIB = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

class _FieldParams(ctypes.Structure):
    """Mirror of `struct FieldParams` in csrc/ff.cuh."""
    _fields_ = [("p", ctypes.c_uint32 * 8), ("one", ctypes.c_uint32 * 8),
                ("n0", ctypes.c_uint32)]


def _words32(x: int):
    return (ctypes.c_uint32 * 8)(*[(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)])


_PARAMS: dict = {}


def _field_params(spec: FieldSpec) -> _FieldParams:
    fp = _PARAMS.get(spec.name)
    if fp is None:
        if spec.p >= 1 << 255:
            raise ValueError(f"{spec.name}: the kernels need p < 2^255")
        fp = _FieldParams(_words32(spec.p), _words32(spec.r_mod_p), spec.n0inv32)
        _PARAMS[spec.name] = fp
    return fp


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library() -> Path:
    """Compile csrc/kernels.cu into build/ (once per content of csrc/) and
    return the library's path."""
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.read_bytes())
    out = _BUILD_DIR / f"libhalo2_msm_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp)] + \
            [str(s) for s in sources if s.suffix == ".cu"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, ptxas=proc.stderr)
    BUILD_INFO.setdefault("seconds", 0.0)
    BUILD_INFO["path"] = str(out)
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fpp = ctypes.POINTER(_FieldParams)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        sigs = {
            "mont_mul_launch": [fpp, vp, vp, vp, i64, vp],
            "batch_inv_launch": [fpp, u32p, vp, vp, i64, ci, vp],
            "mont_addsub_launch": [fpp, ci, vp, vp, vp, i64, vp],
            "ec_add_launch": [fpp] + [vp] * 9 + [i64, vp],
            "ec_add_fast_launch": [fpp] + [vp] * 10 + [i64, vp],
            "ec_double_launch": [fpp] + [vp] * 6 + [i64, ci, vp],
            "fused_madd_scan_xyzz_launch":
                [fpp, u32p, u32p, vp, ci, i64] + [vp] * 9 + [vp],
            "ec_madd_xyzz_fast_launch": [fpp] + [vp] * 6 + [ci, i64] + [vp] * 9 + [vp],
            "ec_add_mixed_launch": [fpp] + [vp] * 6 + [ci, i64] + [vp] * 6 + [vp],
            "ec_add_mixed_fast_launch": [fpp] + [vp] * 9 + [i64, vp],
            "lm_mul_launch": [fpp, vp, vp, vp, i64, vp],
            "lm_addsub_launch": [fpp, ci, vp, vp, vp, i64, vp],
            "lm_mul_const_launch": [fpp, u32p, vp, vp, i64, vp],
            "stage_big_launch": [fpp, ci, vp, vp, vp, i64, i64, i64, vp],
            "stages_small_launch": [fpp, ci, vp, vp, vp, i64, ci, i64, vp],
            "stages_small_r1_probe_launch": [fpp, ci, vp, vp, vp, i64, ci, i64, vp],
            "radix_rank_launch": [vp, vp, vp, vp, i64] + [ci] * 6 + [vp],
            "radix_shuffle_launch": [vp, vp, vp, vp, i64, ci, ci, vp],
            "radix_pass_b_launch": [vp, vp, vp, ci, i64, i64, ci, vp],
            "radix_compact_launch": [vp, vp, vp, ci, i64, i64, vp],
            "poly_mul_naive_launch":
                [fpp, vp, vp, vp, i64, ci, ci, i64, i64, ci, ci, ci, ci, vp],
            "kate_div_launch": [fpp, vp, vp, vp, i64, ci, i64, vp],
            "kate_div2_launch": [fpp, vp, vp, vp, vp, i64, ci, i64, i64, vp],
            "affine_lines_launch": [fpp] + [vp] * 5 + [i64, ci, vp],
            "affine_lines_v1_launch": [fpp] + [vp] * 5 + [i64, ci, vp],
            "mxu_mul_const_launch": [fpp, ctypes.c_void_p, vp, vp, i64, vp],
            "mxu_mul_table_launch": [fpp, ctypes.c_void_p, vp, vp, vp, i64, i64, vp],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _use_kernel(t: torch.Tensor) -> bool:
    """The routing rule of every wrapper: a CUDA tensor launches the kernel,
    a CPU tensor takes the plain version."""
    return t.is_cuda


def _check_device(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA device")


def _check_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA device")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: limb tensors are int32, got {t.dtype}")
        if t.shape[-1] != N_LIMBS:
            raise ValueError(f"{name}: last axis must be {N_LIMBS}, got {tuple(t.shape)}")


def _flatten(*arrs):
    """Broadcast leading dims and flatten to contiguous (B, 16) rows."""
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in arrs))
    flat = tuple(a.expand(lead + (N_LIMBS,)).reshape(-1, N_LIMBS).contiguous()
                 for a in arrs)
    for f in flat:
        if f.data_ptr() % 16:
            raise ValueError("limb rows must be 16-byte aligned")
    return lead, flat


def _launch(name: str, dev: torch.device, *args) -> None:
    """Enqueue kernel `name` on the current stream of `dev`; raise if the
    launch was refused."""
    fn = getattr(_lib(), name + "_launch")
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def mont_mul(spec: FieldSpec, a, b):
    """(..., 16) x (..., 16) Montgomery product, one kernel launch."""
    _check_cuda("mont_mul", a, b)
    lead, (af, bf) = _flatten(a, b)
    out = torch.empty_like(af)
    _launch("mont_mul", af.device, ctypes.byref(_field_params(spec)),
            *_ptrs((af, bf, out)), af.shape[0])
    return out.reshape(lead + (N_LIMBS,))


def batch_inv_chain(n: int) -> int:
    """The chain length L that batch_inv takes for n rows."""
    return max(1, min(BATCH_INV_MAX_L, n // BATCH_INV_CHAINS))


def batch_inv(spec: FieldSpec, a, chain: int | None = None):
    """(..., 16) -> a^-1 R mod p element by element (zeros map to zeros), one
    kernel launch: a thread runs the Montgomery trick over a chain of
    `chain` rows (default batch_inv_chain(n)); chain = 1 is one Fermat
    inversion a thread.  Every output is the unique inverse, so the chain
    length does not change a limb."""
    _check_cuda("batch_inv", a)
    lead, (af,) = _flatten(a)
    n = af.shape[0]
    chain = chain or batch_inv_chain(n)
    out = torch.empty_like(af)
    _launch("batch_inv", af.device, ctypes.byref(_field_params(spec)), _words32(spec.p - 2),
            af.data_ptr(), out.data_ptr(), n, chain)
    return out.reshape(lead + (N_LIMBS,))


def mont_addsub(spec: FieldSpec, is_sub: bool, a, b):
    """(..., 16) +/- (..., 16) mod p, one kernel launch (four lanes a row)."""
    _check_cuda("mont_addsub", a, b)
    lead, (af, bf) = _flatten(a, b)
    out = torch.empty_like(af)
    _launch("mont_addsub", af.device, ctypes.byref(_field_params(spec)),
            int(bool(is_sub)), *_ptrs((af, bf, out)), af.shape[0])
    return out.reshape(lead + (N_LIMBS,))


def _require_a_zero(curve: CurveSpec) -> None:
    if curve.a != 0:
        raise NotImplementedError(
            f"{curve.name}: the curve kernels implement a = 0 only")


def ec_add(curve: CurveSpec, x1, y1, z1, x2, y2, z2):
    """Batched complete Jacobian addition, one kernel launch (four lanes a
    point)."""
    _require_a_zero(curve)
    _check_cuda("ec_add", x1, y1, z1, x2, y2, z2)
    lead, flat = _flatten(x1, y1, z1, x2, y2, z2)
    outs = tuple(torch.empty_like(flat[0]) for _ in range(3))
    _launch("ec_add", flat[0].device, ctypes.byref(_field_params(curve.field)),
            *_ptrs(flat + outs), flat[0].shape[0])
    return tuple(o.reshape(lead + (N_LIMBS,)) for o in outs)


def ec_add_fast(curve: CurveSpec, x1, y1, z1, x2, y2, z2):
    """Batched generic Jacobian addition without a doubling path, one kernel
    launch (four lanes a point): returns (x3, y3, z3, exc) with exc a (...,)
    bool tensor."""
    _check_cuda("ec_add_fast", x1, y1, z1, x2, y2, z2)
    lead, flat = _flatten(x1, y1, z1, x2, y2, z2)
    outs = tuple(torch.empty_like(flat[0]) for _ in range(3))
    # a flag byte 0 or 1 is a bool's own storage: no conversion launch follows
    exc = torch.empty(flat[0].shape[0], dtype=torch.bool, device=flat[0].device)
    _launch("ec_add_fast", flat[0].device, ctypes.byref(_field_params(curve.field)),
            *_ptrs(flat + outs), exc.data_ptr(), flat[0].shape[0])
    return tuple(o.reshape(lead + (N_LIMBS,)) for o in outs) + (exc.reshape(lead),)


def ec_double(curve: CurveSpec, x1, y1, z1, k: int = 1):
    """Batched Jacobian doubling (a = 0), k >= 0 times over, one kernel launch
    (four lanes a point, the point on chip between its doublings); k = 0
    copies the points."""
    _require_a_zero(curve)
    if k < 0:
        raise ValueError(f"ec_double: k = {k} < 0")
    _check_cuda("ec_double", x1, y1, z1)
    lead, flat = _flatten(x1, y1, z1)
    outs = tuple(torch.empty_like(flat[0]) for _ in range(3))
    _launch("ec_double", flat[0].device, ctypes.byref(_field_params(curve.field)),
            *_ptrs(flat + outs), flat[0].shape[0], k)
    return tuple(o.reshape(lead + (N_LIMBS,)) for o in outs)


def ec_madd_xyzz_fast(curve: CurveSpec, x1, y1, zz1, zzz1, qx, qy):
    """Batched XYZZ + affine addition without exceptional paths: the scan
    kernel's one step (w = 1), one kernel launch (four lanes a carry).
    Returns (x3, y3, zz3, zzz3, exc) with exc a (...,) bool tensor (identity
    carry or carry == +-Q; the affine identity qy == 0 passes the carry
    through unflagged)."""
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in (x1, y1, zz1, zzz1, qx, qy)))
    rows = (a.expand(lead + (N_LIMBS,)) for a in (x1, y1, zz1, zzz1, qx, qy))
    inner, _, exc = ec_madd_xyzz_fast_scan(curve, *rows, 1)
    return inner + (exc,)


def ec_madd_xyzz_fast_scan(curve: CurveSpec, x1, y1, zz1, zzz1, qx, qy, w: int):
    """The blinded stepwise prefix scan in one kernel launch (four lanes a
    carry, the carries on chip between the steps): the counterpart of the
    JAX package's jax.lax.scan of E.madd_xyzz_fast in
    msm.prefix_scan_parts_affine_fast.

    x1, y1, zz1, zzz1: (..., g, 16) XYZZ carries to start from; qx, qy:
    (..., g*w, 16) affine rows (qy == 0 the affine identity), carry j's steps
    at rows j*w .. j*w + w - 1.  Returns (inner, totals, exc): inner the
    XYZZ 4-tuple of (..., g*w, 16) tensors with inner[j*w + t] = carry j
    after step t, totals the 4-tuple of (..., g, 16) final carries (inner
    itself where w = 1), exc a (..., g) bool tensor, a carry's flags ORed
    over its steps."""
    kernel = "ec_madd_xyzz_fast"
    _check_cuda(kernel, x1, y1, zz1, zzz1, qx, qy)
    if w <= 0:
        raise ValueError(f"{kernel}: w = {w} <= 0")
    lead, carry = _flatten(x1, y1, zz1, zzz1)
    rows_lead, rows = _flatten(qx, qy)
    n_carry, n_rows = carry[0].shape[0], rows[0].shape[0]
    if n_rows != n_carry * w or rows_lead[:-1] != lead[:-1]:
        raise ValueError(f"{kernel}: {tuple(rows_lead)} rows are not w = {w} a carry of "
                         f"{tuple(lead)}")
    inner = tuple(torch.empty_like(rows[0]) for _ in range(4))
    # the kernel writes no totals where they are the inner prefixes (null)
    totals = inner if w == 1 else tuple(torch.empty_like(carry[0]) for _ in range(4))
    # a flag byte 0 or 1 is a bool's own storage: no conversion launch follows
    exc = torch.empty(n_carry, dtype=torch.bool, device=carry[0].device)
    _launch(kernel, carry[0].device, ctypes.byref(_field_params(curve.field)),
            *_ptrs(carry + rows), w, n_carry, *_ptrs(inner),
            *(_ptrs(totals) if w > 1 else (None,) * 4), exc.data_ptr())
    return (tuple(o.reshape(rows_lead + (N_LIMBS,)) for o in inner),
            tuple(o.reshape(lead + (N_LIMBS,)) for o in totals), exc.reshape(lead))


def _mixed_mask(name: str, q_is_identity, like, shape):
    """The identity mask as one contiguous byte an element (a bool's own
    storage) of the given leading shape."""
    if q_is_identity.dtype != torch.bool or q_is_identity.device != like.device:
        raise TypeError(f"{name}: q_is_identity must be a bool tensor on the device of "
                        "the points")
    return q_is_identity.expand(shape).reshape(-1).contiguous()


def ec_add_mixed(curve: CurveSpec, x1, y1, z1, qx, qy, q_is_identity):
    """Batched complete Jacobian + affine addition: the scan kernel's one
    step (w = 1), one kernel launch (two lanes a point).  q_is_identity:
    (...,) bool mask of the affine identity slots; the kernel reads it as
    one byte an element."""
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in (x1, y1, z1, qx, qy)))
    rows = (a.expand(lead + (N_LIMBS,)) for a in (x1, y1, z1, qx, qy))
    return ec_add_mixed_scan(curve, *rows, q_is_identity, 1)[0]


def ec_add_mixed_scan(curve: CurveSpec, x1, y1, z1, qx, qy, q_is_identity, w: int):
    """The safe flavor's blocked prefix scan in one kernel launch (two lanes
    a carry, the carries on chip between the steps): the counterpart of the
    JAX package's jax.lax.scan of E.add_mixed.

    x1, y1, z1: (..., g, 16) carries to start from; qx, qy: (..., g*w, 16)
    affine rows and q_is_identity (..., g*w) bool, carry j's steps at rows
    j*w .. j*w + w - 1 (the scan's column layout as the rows lie).  Returns
    (inner, totals): inner the 3-tuple of (..., g*w, 16) tensors with
    inner[j*w + t] = carry j after step t, totals the 3-tuple of (..., g, 16)
    final carries (inner itself where w = 1)."""
    kernel = "ec_add_mixed"
    _require_a_zero(curve)
    _check_cuda(kernel, x1, y1, z1, qx, qy)
    if w <= 0:
        raise ValueError(f"{kernel}: w = {w} <= 0")
    lead, carry = _flatten(x1, y1, z1)
    rows_lead, rows = _flatten(qx, qy)
    n_carry, n_rows = carry[0].shape[0], rows[0].shape[0]
    if n_rows != n_carry * w or rows_lead[:-1] != lead[:-1]:
        raise ValueError(f"{kernel}: {tuple(rows_lead)} rows are not w = {w} a carry of "
                         f"{tuple(lead)}")
    mask = _mixed_mask(kernel, q_is_identity, x1, rows_lead)
    inner = tuple(torch.empty_like(rows[0]) for _ in range(3))
    # the kernel writes no totals where they are the inner prefixes (null)
    totals = inner if w == 1 else tuple(torch.empty_like(carry[0]) for _ in range(3))
    _launch(kernel, carry[0].device, ctypes.byref(_field_params(curve.field)),
            *_ptrs(carry + rows), mask.data_ptr(), w, n_carry, *_ptrs(inner),
            *(_ptrs(totals) if w > 1 else (None,) * 3))
    return (tuple(o.reshape(rows_lead + (N_LIMBS,)) for o in inner),
            tuple(o.reshape(lead + (N_LIMBS,)) for o in totals))


def ec_add_mixed_fast(curve: CurveSpec, x1, y1, z1, qx, qy):
    """Batched Jacobian + affine addition without exceptional paths, one
    kernel launch (a thread a point): returns (x3, y3, z3, exc) with exc a
    (...,) bool tensor (identity carry or carry == +-Q; the affine identity
    qy == 0 passes the carry through unflagged).  A flagged lane holds the
    generic formula's values, as the reference's does."""
    _check_cuda("ec_add_mixed_fast", x1, y1, z1, qx, qy)
    lead, flat = _flatten(x1, y1, z1, qx, qy)
    outs = tuple(torch.empty_like(flat[0]) for _ in range(3))
    # a flag byte 0 or 1 is a bool's own storage: no conversion launch follows
    exc = torch.empty(flat[0].shape[0], dtype=torch.bool, device=flat[0].device)
    _launch("ec_add_mixed_fast", flat[0].device, ctypes.byref(_field_params(curve.field)),
            *_ptrs(flat + outs), exc.data_ptr(), flat[0].shape[0])
    return tuple(o.reshape(lead + (N_LIMBS,)) for o in outs) + (exc.reshape(lead),)


def _limbs_to_int(limbs) -> int:
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


def fused_madd_scan_xyzz(curve: CurveSpec, t_limbs, rows, w: int = SCAN_W):
    """One window's whole blinded prefix scan in one kernel launch (two
    lanes a carry).

    rows: (g*w, 16) int32 packed affine rows in sorted order (ops/msm.
    _pack_pair: x in words 0..7, y in words 8..15, two 16-bit limbs a word;
    an all-zero row is the affine identity).  Lane l owns rows l*w .. l*w+w-1.
    t_limbs: ((x limbs), (y limbs)), the blinding point T's Montgomery limbs.

    Returns (inner, totals, exc): inner is the XYZZ 4-tuple of (w, 16, g)
    tensors with inner[t, :, l] = T + the inclusive prefix of lane l after
    step t; totals the 4-tuple of (g, 16) final lane carries (still blinded);
    exc a (g,) bool tensor of per-lane exception flags (identity carry or
    carry == +-Q at some step; an affine identity passes unflagged)."""
    kernel = "fused_madd_scan_xyzz"
    _check_cuda(kernel, rows)
    if rows.dim() != 2 or not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError(f"{kernel}: rows must be a contiguous, 16-byte aligned "
                         "(N, 16) tensor")
    n = rows.shape[0]
    if w <= 0 or n % w:
        raise ValueError(f"{kernel}: {n} rows are no multiple of w = {w}")
    g = n // w
    dev = rows.device
    inner = tuple(torch.empty((w, N_LIMBS, g), dtype=torch.int32, device=dev)
                  for _ in range(4))
    totals = tuple(torch.empty((g, N_LIMBS), dtype=torch.int32, device=dev)
                   for _ in range(4))
    # a flag byte 0 or 1 is a bool's own storage: no conversion launch follows
    exc = torch.empty(g, dtype=torch.bool, device=dev)
    tx, ty = (_words32(_limbs_to_int(c)) for c in t_limbs)
    _launch(kernel, dev, ctypes.byref(_field_params(curve.field)),
            tx, ty, rows.data_ptr(), w, g, *_ptrs(inner + totals), exc.data_ptr())
    return inner, totals, exc


# ---------------------------------------------------------------------------
# plain PyTorch versions (any device; int64 arithmetic on 16-bit limbs)
# ---------------------------------------------------------------------------

_MASK = LIMB_MASK
_PLAIN_CONSTS: dict = {}
_MUL_CHUNK = 1 << 18  # rows per pass of mont_mul_plain on the card (memory bound)
_OUTER_MAX_ROWS = 2048  # batches up to this take the outer-product form of a*b


class _PlainConsts:
    """Per-(field, device) constant tensors of the plain versions."""

    def __init__(self, spec: FieldSpec, device):
        def limbs(x):
            return [(x >> (LIMB_BITS * i)) & _MASK for i in range(N_LIMBS)]

        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=device)

        n = N_LIMBS
        p, mu = limbs(spec.p), limbs((-pow(spec.p, -1, R)) % R)
        self.p = i64(p)
        self.r_minus_p = i64(limbs(R - spec.p))
        self.r_minus_p_hi = i64([0] * n + limbs(R - spec.p))  # at the high half
        self.one = torch.tensor(limbs(spec.r_mod_p), dtype=torch.int32, device=device)
        # Toeplitz forms of the two constant products of the reduction:
        # (x @ mu_lo)[k] = sum_{i+j=k} x_i mu_j for k < n (the product mod R),
        # (x @ p_full)[k] = sum_{i+j=k} x_i p_j for k < 2n.
        self.mu_lo = i64([[mu[k - i] if k >= i else 0 for k in range(n)]
                          for i in range(n)])
        self.p_full = i64([[p[k - i] if 0 <= k - i < n else 0 for k in range(2 * n)]
                           for i in range(n)])
        self.weights = i64([1 << k for k in range(2 * n + 1)])  # bit k of a carry word
        # (2^256 R) mod p: the Montgomery factor of reduce_columns' top limb
        self.c256 = torch.tensor(limbs((R * spec.r_mod_p) % spec.p), dtype=torch.int32,
                                 device=device)


def _plain_consts(spec: FieldSpec, device) -> _PlainConsts:
    key = (spec.name, str(device))
    c = _PLAIN_CONSTS.get(key)
    if c is None:
        c = _PLAIN_CONSTS[key] = _PlainConsts(spec, device)
    return c


def _shift_up(v, d: int = 1):
    """Shift columns toward higher limb index by d (zero fill)."""
    return torch.nn.functional.pad(v, (d, 0))[..., : v.shape[-1]]


def _const_product(x, mat):
    """x (..., n) int64 times a constant (n, k) Toeplitz matrix.  The CPU has
    an int64 matmul; the card does not, so there it is a broadcast sum."""
    if x.is_cuda:
        return (x[..., :, None] * mat).sum(-2)
    return x @ mat


def _normalize(C: _PlainConsts, cols, folds: int):
    """Propagate carries: cols (..., K <= 32) nonnegative int64 column sums
    -> (16-bit limbs (..., K), carry out (...,)).  `folds` rounds of
    v = (v & mask) + shift(v >> 16) bring every column below 2^17 - 1 (each
    round takes 16 bits off the bound; the caller states how many its bound
    needs); what is left is a 0/1 ripple, resolved for all columns at once by
    one integer addition of the generate and propagate bit-words."""
    k = cols.shape[-1]
    v = torch.nn.functional.pad(cols, (0, 1))  # room for the carry out
    for _ in range(folds):
        v = (v & _MASK) + _shift_up(v >> LIMB_BITS)
    w = C.weights[: k + 1]
    gen = ((v >> LIMB_BITS) * w).sum(-1)
    prop = (((v & _MASK) == _MASK).to(torch.int64) * w).sum(-1)
    carry_in = ((gen | prop) + gen) ^ prop  # bit j: the carry into column j
    out = (v + ((carry_in[..., None] >> torch.arange(k + 1, device=v.device)) & 1)) & _MASK
    return out[..., :k], out[..., k]


def _norm_sub_p(C: _PlainConsts, cols, folds: int):
    """Normalize columns of a value < 2p and reduce it mod p with one carry
    network: the value and the value + (2^256 - p) are normalized side by
    side, and the carry out of the second says whether the value was >= p."""
    stacked = torch.stack([cols, cols + C.r_minus_p], dim=-2)
    norm, carry = _normalize(C, stacked, folds)
    ge = carry[..., 1] == 1
    return torch.where(ge[..., None], norm[..., 1, :], norm[..., 0, :]).to(torch.int32)


def _prod_cols(a, b):
    """Column sums t[k] = sum_{i+j=k} a_i b_j of the schoolbook product, as
    (..., 32) int64 (each < 2^36).  Small batches take the outer product and
    sum its anti-diagonals (few ops: padding each row of the (n, n) product to
    width 2n+1 and re-viewing it as rows of width 2n aligns (i, j) with
    (i, i+j)); large batches take n shifted multiply-accumulates (16 times
    less memory traffic)."""
    n = N_LIMBS
    if a.numel() <= _OUTER_MAX_ROWS * n:
        outer = a[..., :, None] * b[..., None, :]
        flat = torch.nn.functional.pad(outer, (0, n + 1)).flatten(-2)[..., : 2 * n * n]
        return flat.reshape(flat.shape[:-1] + (n, 2 * n)).sum(-2)
    t = torch.zeros(a.shape[:-1] + (2 * n,), dtype=torch.int64, device=a.device)
    for i in range(n):
        t[..., i:i + n].addcmul_(a[..., i:i + 1], b)
    return t


def _mont_mul_rows(C: _PlainConsts, a, b):
    n = N_LIMBS
    t = _prod_cols(a.to(torch.int64), b.to(torch.int64))       # T = a*b, cols < 2^36
    m_cols = _const_product(t[..., :n], C.mu_lo)                # (T mod R)*mu mod R, < 2^56
    m, _ = _normalize(C, m_cols, folds=3)
    s = t + _const_product(m, C.p_full)                         # T + m*p, cols < 2^37
    # (T + m*p)/R < 2p sits in the high half; the low half is an exact
    # multiple of R whose carry the same network propagates.  Beside it goes
    # the value + (2^256 - p): its carry out says whether to subtract p.
    norm, carry = _normalize(C, torch.stack([s, s + C.r_minus_p_hi], dim=-2), folds=2)
    ge = carry[..., 1] == 1
    return torch.where(ge[..., None], norm[..., 1, n:], norm[..., 0, n:]).to(torch.int32)


def mont_mul_plain(spec: FieldSpec, a, b):
    """Plain version of mont_mul: a*b*R^-1 mod p, full-word Montgomery
    (T = a*b; m = (T mod R)*mu mod R; (T + m*p)/R; one conditional
    subtraction), vectorised over the batch."""
    C = _plain_consts(spec, a.device)
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(lead + (N_LIMBS,))
    b = b.expand(lead + (N_LIMBS,))
    if not a.is_cuda or a.numel() <= _MUL_CHUNK * N_LIMBS:
        return _mont_mul_rows(C, a, b)
    af, bf = a.reshape(-1, N_LIMBS), b.reshape(-1, N_LIMBS)
    out = torch.cat([_mont_mul_rows(C, af[i:i + _MUL_CHUNK], bf[i:i + _MUL_CHUNK])
                     for i in range(0, af.shape[0], _MUL_CHUNK)])
    return out.reshape(lead + (N_LIMBS,))


def mont_addsub_plain(spec: FieldSpec, is_sub: bool, a, b):
    """Plain version of mont_addsub: (a +- b) mod p."""
    C = _plain_consts(spec, a.device)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    if not is_sub:
        return _norm_sub_p(C, a + b, folds=1)
    # lane 0 = a - b + 2^256 (carry out <=> a >= b), lane 1 = lane 0 + p
    lane0 = a + (_MASK - b)
    lane0[..., 0] += 1
    norm, carry = _normalize(C, torch.stack([lane0, lane0 + C.p], dim=-2), folds=1)
    a_ge_b = carry[..., 0] == 1
    return torch.where(a_ge_b[..., None], norm[..., 0, :], norm[..., 1, :]).to(torch.int32)


def reduce_columns_with(spec: FieldSpec, cols, mul, add):
    """Reduce lazy column sums of Montgomery residues to a fully reduced
    element with the field ops `mul` and `add` (the kernels' wrappers or the
    plain versions): cols (..., K <= 17) integer tensor, every column below
    2^46 and the total value below 2^271 (both exact in int64).  The columns
    are carried into 17 limbs; the low 16 are reduced by a Montgomery product
    with R mod p (lo * R * R^-1 = lo), the top limb by one with (2^256 * R)
    mod p (top * 2^256), and the two are added."""
    k = cols.shape[-1]
    if k > N_LIMBS + 1:
        raise ValueError(f"reduce_columns: at most {N_LIMBS + 1} columns, got {k}")
    cols = torch.nn.functional.pad(cols.to(torch.int64), (0, N_LIMBS + 1 - k))
    C = _plain_consts(spec, cols.device)
    limbs, _ = _normalize(C, cols, folds=3)
    limbs = limbs.to(torch.int32)
    lo = mul(limbs[..., :N_LIMBS], C.one.expand(limbs.shape[:-1] + (N_LIMBS,)))
    top = torch.nn.functional.pad(limbs[..., N_LIMBS:], (0, N_LIMBS - 1))
    return add(lo, mul(top, C.c256.expand(top.shape)))


def reduce_columns_plain(spec: FieldSpec, cols):
    """reduce_columns on the plain versions of mont_mul and mont_addsub."""
    return reduce_columns_with(spec, cols, lambda a, b: mont_mul_plain(spec, a, b),
                               lambda a, b: mont_addsub_plain(spec, False, a, b))


def pow_schedule(e: int):
    """The walk of csrc/ff.cuh fe_pow for the exponent e > 0: left-to-right
    sliding windows of up to POW_WINDOW bits over the odd powers a, a^3, ...
    Returns ([(squarings before the window, odd-power index)], squarings
    after the last window); the first window takes no squarings (it starts
    the power)."""
    steps, pending, i = [], 0, e.bit_length() - 1
    while i >= 0:
        if not (e >> i) & 1:
            pending += 1
            i -= 1
            continue
        j = max(i - (POW_WINDOW - 1), 0)
        while not (e >> j) & 1:
            j += 1
        v = (e >> j) & ((1 << (i - j + 1)) - 1)
        steps.append((pending + i - j + 1 if steps else 0, v >> 1))
        pending, i = 0, j - 1
    return steps, pending


def pow_products(e: int) -> int:
    """Field products of fe_pow for the exponent e: the table of odd powers
    (a^2 and 2^(POW_WINDOW-1) - 1 more), the squarings and one product a
    window after the first."""
    steps, tail = pow_schedule(e)
    return (1 << (POW_WINDOW - 1)) + sum(s for s, _ in steps) + len(steps) - 1 + tail


def _pow_plain(spec: FieldSpec, a, e: int):
    """a^e by the walk of pow_schedule on plain products."""
    odd = [a]
    a2 = mont_mul_plain(spec, a, a)
    for _ in range(1, 1 << (POW_WINDOW - 1)):
        odd.append(mont_mul_plain(spec, odd[-1], a2))
    steps, tail = pow_schedule(e)
    acc = None
    for squarings, k in steps:
        for _ in range(squarings):
            acc = mont_mul_plain(spec, acc, acc)
        acc = odd[k] if acc is None else mont_mul_plain(spec, acc, odd[k])
    for _ in range(tail):
        acc = mont_mul_plain(spec, acc, acc)
    return acc


def batch_inv_products(n: int, chain: int, e: int) -> int:
    """Field products batch_inv does on n rows in chains of `chain`: three
    a row but the first of each chain, and one power a chain."""
    chains = -(-n // chain)
    return 3 * (n - chains) + chains * pow_products(e)


def batch_inv_plain(spec: FieldSpec, a, chain: int | None = None):
    """Plain version of batch_inv, the kernel's algorithm on plain products
    in its order: chain c holds rows c, c + C, ... (C = ceil(n / L) chains,
    the ragged ones padded with ones); the exclusive prefixes forward, the
    total's power p - 2, then back: out[i] = prefix[i] * inverse, inverse *=
    row i.  A zero row counts as one and gives zero."""
    lead = a.shape[:-1]
    flat = a.reshape(-1, N_LIMBS)
    n = flat.shape[0]
    if n == 0:
        return a.clone()
    chain = chain or batch_inv_chain(n)
    chains = -(-n // chain)
    one = _plain_consts(spec, a.device).one
    zero = _is_zero(flat)
    rows = torch.cat([_sel(zero, one.expand(flat.shape), flat),
                      one.expand(chain * chains - n, N_LIMBS)]).reshape(chain, chains, N_LIMBS)
    acc, prefix = rows[0], [None]
    for i in range(1, chain):
        prefix.append(acc)
        acc = mont_mul_plain(spec, acc, rows[i])
    inv = _pow_plain(spec, acc, spec.p - 2)
    out = [None] * chain
    for i in range(chain - 1, 0, -1):
        out[i] = mont_mul_plain(spec, prefix[i], inv)
        inv = mont_mul_plain(spec, inv, rows[i])
    out[0] = inv
    res = torch.stack(out).reshape(chain * chains, N_LIMBS)[:n]
    return _sel(zero, torch.zeros_like(res), res).reshape(lead + (N_LIMBS,))


class _PlainField:
    """The field ops of the plain curve formulas, bound to one field."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def mul(self, a, b):
        return mont_mul_plain(self.spec, a, b)

    def sqr(self, a):
        return mont_mul_plain(self.spec, a, a)

    def add(self, a, b):
        return mont_addsub_plain(self.spec, False, a, b)

    def sub(self, a, b):
        return mont_addsub_plain(self.spec, True, a, b)

    def double(self, a):
        return mont_addsub_plain(self.spec, False, a, a)

    def one(self, like):
        return _plain_consts(self.spec, like.device).one.expand(like.shape)


def _is_zero(a):
    return (a == 0).all(dim=-1)


def _sel(mask, a, b):
    return torch.where(mask[..., None], a, b)


def ec_double_plain(curve: CurveSpec, x1, y1, z1, k: int = 1):
    """Plain version of ec_double: dbl-2009-l with a = 0, identity-safe, k
    times over (k = 0 gives the points back)."""
    _require_a_zero(curve)
    if k < 0:
        raise ValueError(f"ec_double: k = {k} < 0")
    f = _PlainField(curve.field)
    x1, y1, z1 = _broadcast_rows(x1, y1, z1)
    for _ in range(k):
        A = f.sqr(x1)
        B = f.sqr(y1)
        C = f.sqr(B)
        t = f.sqr(f.add(x1, B))
        D = f.double(f.sub(f.sub(t, A), C))
        E = f.add(f.double(A), A)
        F = f.sqr(E)
        x3 = f.sub(F, f.double(D))
        y3 = f.sub(f.mul(E, f.sub(D, x3)), f.double(f.double(f.double(C))))
        x1, y1, z1 = x3, y3, f.double(f.mul(y1, z1))
    return x1, y1, z1


def _add_core_plain(f: _PlainField, x1, y1, z1, x2, y2, z2):
    """add-2007-bl body shared by the complete and the fast add: returns
    (x3, y3, z3, h == 0, r == 0)."""
    z1z1, z2z2 = f.sqr(z1), f.sqr(z2)
    u1 = f.mul(x1, z2z2)
    u2 = f.mul(x2, z1z1)
    s1 = f.mul(y1, f.mul(z2, z2z2))
    s2 = f.mul(y2, f.mul(z1, z1z1))
    h = f.sub(u2, u1)
    r = f.sub(s2, s1)
    hh = f.sqr(h)
    hhh = f.mul(h, hh)
    v = f.mul(u1, hh)
    x3 = f.sub(f.sub(f.sqr(r), hhh), f.double(v))
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(s1, hhh))
    z3 = f.mul(f.mul(z1, z2), h)
    return x3, y3, z3, _is_zero(h), _is_zero(r)


def _dispatch_complete(f, gen, dbl, p, q, h0, r0, id1, id2):
    """The mask dispatch of the complete adds: doubling, inverse and identity
    cases override the generic sum, in this order."""
    one = f.one(gen[0])
    ident = (one, one, torch.zeros_like(one))
    out = gen
    for mask, val in ((h0 & r0, dbl), (h0 & ~r0, ident), (id2 & ~id1, p),
                      (id1 & ~id2, q), (id1 & id2, ident)):
        out = tuple(_sel(mask, v, o) for v, o in zip(val, out))
    return out


def _broadcast_rows(*arrs):
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in arrs))
    return tuple(a.expand(lead + (N_LIMBS,)) for a in arrs)


def ec_add_plain(curve: CurveSpec, x1, y1, z1, x2, y2, z2):
    """Plain version of ec_add: branchless complete Jacobian addition."""
    f = _PlainField(curve.field)
    x1, y1, z1, x2, y2, z2 = _broadcast_rows(x1, y1, z1, x2, y2, z2)
    x3, y3, z3, h0, r0 = _add_core_plain(f, x1, y1, z1, x2, y2, z2)
    dbl = ec_double_plain(curve, x1, y1, z1)
    return _dispatch_complete(f, (x3, y3, z3), dbl, (x1, y1, z1), (x2, y2, z2),
                              h0, r0, _is_zero(z1), _is_zero(z2))


def ec_add_fast_plain(curve: CurveSpec, x1, y1, z1, x2, y2, z2):
    """Plain version of ec_add_fast: generic Jacobian add, no doubling path.
    Identity operands pass through; P + (-P) gives a valid z = 0 identity;
    only a true doubling (both non-identity, h == 0, r == 0) is flagged."""
    f = _PlainField(curve.field)
    x1, y1, z1, x2, y2, z2 = _broadcast_rows(x1, y1, z1, x2, y2, z2)
    x3, y3, z3, h0, r0 = _add_core_plain(f, x1, y1, z1, x2, y2, z2)
    id1, id2 = _is_zero(z1), _is_zero(z2)
    exc = ~id1 & ~id2 & h0 & r0
    out = tuple(_sel(id2, p, _sel(id1, q, g))
                for p, q, g in zip((x1, y1, z1), (x2, y2, z2), (x3, y3, z3)))
    return out + (exc,)


def _madd_core_plain(f: _PlainField, x1, y1, z1, qx, qy):
    """madd-2007-bl body (Z2 = 1) shared by the complete and the fast mixed
    add: returns (x3, y3, z3, h == 0, r == 0)."""
    z1z1 = f.sqr(z1)
    u2 = f.mul(qx, z1z1)
    s2 = f.mul(qy, f.mul(z1, z1z1))
    h = f.sub(u2, x1)
    r = f.sub(s2, y1)
    hh = f.sqr(h)
    hhh = f.mul(h, hh)
    v = f.mul(x1, hh)
    x3 = f.sub(f.sub(f.sqr(r), hhh), f.double(v))
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(y1, hhh))
    z3 = f.mul(z1, h)
    return x3, y3, z3, _is_zero(h), _is_zero(r)


def ec_add_mixed_plain(curve: CurveSpec, x1, y1, z1, qx, qy, q_is_identity):
    """Plain version of ec_add_mixed: complete Jacobian + affine addition
    (madd-2007-bl with mask dispatch); q_is_identity: (...,) bool."""
    f = _PlainField(curve.field)
    x1, y1, z1, qx, qy = _broadcast_rows(x1, y1, z1, qx, qy)
    x3, y3, z3, h0, r0 = _madd_core_plain(f, x1, y1, z1, qx, qy)
    dbl = ec_double_plain(curve, x1, y1, z1)
    id2 = q_is_identity.expand(x1.shape[:-1])
    return _dispatch_complete(f, (x3, y3, z3), dbl, (x1, y1, z1),
                              (qx, qy, f.one(qx)), h0, r0, _is_zero(z1), id2)


def ec_add_mixed_scan_plain(curve: CurveSpec, x1, y1, z1, qx, qy, q_is_identity, w: int):
    """Plain version of ec_add_mixed_scan: a Python loop of w
    ec_add_mixed_plain steps over all carries (the stepwise safe scan);
    same arguments and results."""
    if w <= 0:
        raise ValueError(f"ec_add_mixed: w = {w} <= 0")
    lead = x1.shape[:-1]
    g = lead[-1]
    if qx.shape[:-1] != lead[:-1] + (g * w,):
        raise ValueError(f"ec_add_mixed: {tuple(qx.shape[:-1])} rows are not w = {w} a "
                         f"carry of {tuple(lead)}")
    qx, qy = (c.reshape(lead + (w, N_LIMBS)) for c in (qx, qy))
    mask = q_is_identity.reshape(lead + (w,))
    carry = (x1, y1, z1)
    steps = []
    for t in range(w):
        carry = ec_add_mixed_plain(curve, *carry, qx[..., t, :], qy[..., t, :], mask[..., t])
        steps.append(carry)
    inner = tuple(torch.stack([s[k] for s in steps], dim=-2).reshape(
        lead[:-1] + (g * w, N_LIMBS)) for k in range(3))
    return inner, carry


def ec_add_mixed_fast_plain(curve: CurveSpec, x1, y1, z1, qx, qy):
    """Plain version of ec_add_mixed_fast: the generic madd-2007-bl sum with
    no exceptional path; returns (x3, y3, z3, exc).  The affine identity
    (qy == 0) passes the carry through unflagged; an identity carry or
    carry == +-Q (h == 0) is flagged and keeps the generic values."""
    f = _PlainField(curve.field)
    x1, y1, z1, qx, qy = _broadcast_rows(x1, y1, z1, qx, qy)
    x3, y3, z3, h0, _ = _madd_core_plain(f, x1, y1, z1, qx, qy)
    id1, id2 = _is_zero(z1), _is_zero(qy)
    exc = ~id2 & (id1 | h0)
    return _sel(id2, x1, x3), _sel(id2, y1, y3), _sel(id2, z1, z3), exc


def ec_madd_xyzz_fast_plain(curve: CurveSpec, x1, y1, zz1, zzz1, qx, qy):
    """Plain version of ec_madd_xyzz_fast: XYZZ + affine addition
    (madd-2008-s) without exceptional paths: returns (x3, y3, zz3, zzz3,
    exc).  The affine identity (qy == 0) passes the carry through unflagged;
    an identity carry or carry == +-Q is flagged."""
    f = _PlainField(curve.field)
    x1, y1, zz1, zzz1, qx, qy = _broadcast_rows(x1, y1, zz1, zzz1, qx, qy)
    u2 = f.mul(qx, zz1)
    s2 = f.mul(qy, zzz1)
    pp = f.sub(u2, x1)
    r = f.sub(s2, y1)
    ppsq = f.sqr(pp)
    ppp = f.mul(pp, ppsq)
    q = f.mul(x1, ppsq)
    x3 = f.sub(f.sub(f.sqr(r), ppp), f.double(q))
    y3 = f.sub(f.mul(r, f.sub(q, x3)), f.mul(y1, ppp))
    zz3 = f.mul(zz1, ppsq)
    zzz3 = f.mul(zzz1, ppp)
    id1 = _is_zero(zz1)
    id2 = _is_zero(qy)
    exc = ~id2 & (id1 | _is_zero(pp))
    return (_sel(id2, x1, x3), _sel(id2, y1, y3), _sel(id2, zz1, zz3),
            _sel(id2, zzz1, zzz3), exc)


def ec_madd_xyzz_fast_scan_plain(curve: CurveSpec, x1, y1, zz1, zzz1, qx, qy, w: int):
    """Plain version of ec_madd_xyzz_fast_scan: a Python loop of w
    ec_madd_xyzz_fast_plain steps over all carries, the flags ORed (the
    stepwise blinded scan); same arguments and results."""
    if w <= 0:
        raise ValueError(f"ec_madd_xyzz_fast: w = {w} <= 0")
    carry = _broadcast_rows(x1, y1, zz1, zzz1)
    lead = carry[0].shape[:-1]
    g = lead[-1]
    if qx.shape[:-1] != lead[:-1] + (g * w,) or qy.shape != qx.shape:
        raise ValueError(f"ec_madd_xyzz_fast: {tuple(qx.shape[:-1])} rows are not w = {w} a "
                         f"carry of {tuple(lead)}")
    qx, qy = (c.reshape(lead + (w, N_LIMBS)) for c in (qx, qy))
    exc = torch.zeros(lead, dtype=torch.bool, device=x1.device)
    steps = []
    for t in range(w):
        *carry, e = ec_madd_xyzz_fast_plain(curve, *carry, qx[..., t, :], qy[..., t, :])
        exc = exc | e
        steps.append(carry)
    inner = tuple(torch.stack([s[k] for s in steps], dim=-2).reshape(
        lead[:-1] + (g * w, N_LIMBS)) for k in range(4))
    return inner, tuple(carry), exc


def unpack_rows(rows):
    """(..., 16) packed rows (two 16-bit limbs a word, x in words 0..7, y in
    words 8..15) -> (x, y) (..., 16) limb tensors.  The right shift of an
    int32 is arithmetic, hence the mask after it."""
    def unpack(v):
        return torch.stack([v & _MASK, (v >> LIMB_BITS) & _MASK], dim=-1) \
            .reshape(v.shape[:-1] + (N_LIMBS,))
    return unpack(rows[..., :8]), unpack(rows[..., 8:16])


def fused_madd_scan_xyzz_plain(curve: CurveSpec, t_limbs, rows, w: int = SCAN_W):
    """Plain version of fused_madd_scan_xyzz: a Python loop of w
    ec_madd_xyzz_fast_plain steps over all lanes; same arguments and results."""
    n = rows.shape[0]
    if w <= 0 or n % w:
        raise ValueError(f"fused_madd_scan_xyzz: {n} rows are no multiple of w = {w}")
    g = n // w
    qx, qy = unpack_rows(rows.reshape(g, w, N_LIMBS))
    dev = rows.device
    one = _plain_consts(curve.field, dev).one
    tx, ty = (torch.tensor(list(c), dtype=torch.int32, device=dev) for c in t_limbs)
    carry = tuple(c.expand(g, N_LIMBS) for c in (tx, ty, one, one))
    exc = torch.zeros(g, dtype=torch.bool, device=dev)
    steps = []
    for t in range(w):
        *carry, e = ec_madd_xyzz_fast_plain(curve, *carry, qx[:, t], qy[:, t])
        exc = exc | e
        steps.append(carry)
    inner = tuple(torch.stack([s[k] for s in steps]).permute(0, 2, 1).contiguous()
                  for k in range(4))
    return inner, tuple(c.contiguous() for c in carry), exc
