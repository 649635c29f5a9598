"""ctypes bindings for the port's C++ CPU oracle (oracle/oracle.cpp).

An independent 4x64-bit Montgomery implementation of the field / curve /
polynomial / divisor semantics: the bit-level cross-check of the port's
kernels and plain versions.  build() compiles oracle.cpp with g++ into the
checkout's build/ directory at first use (never at import), under a name
keyed on the source and the flags, so an edited source builds anew."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..fields import CurveSpec, FieldSpec

_SRC = Path(__file__).resolve().parent / "oracle.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

BUILD_INFO: dict = {}  # filled by build(): path, seconds (0.0 where it was built before)


def build() -> Path:
    """Compile oracle.cpp into build/ (once per content of the source) and
    return the library's path.  The compiler writes a name of its own
    process and the result is renamed into place, so that processes building
    at once never load a half-written library.  Raises if g++ is missing or
    fails."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    out = _BUILD_DIR / f"liboracle_{h.hexdigest()[:16]}.so"
    seconds = 0.0
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the oracle cannot be built")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
        seconds = time.perf_counter() - t0
    BUILD_INFO.update(path=str(out), seconds=seconds)
    return out


@lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    l = ctypes.CDLL(str(build()))
    vp, ci, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    sigs = {  # name: (restype, argtypes), as oracle.cpp's extern "C" block declares them
        "oracle_field_ctx": (None, [vp, vp]),
        "oracle_curve_ctx": (None, [vp, vp, vp, vp]),
        "oracle_sizeof_field_ctx": (ci, []),
        "oracle_sizeof_curve_ctx": (ci, []),
        "oracle_ff_mul": (None, [vp, ci, vp, vp, vp]),
        "oracle_ff_add": (None, [vp, ci, vp, vp, vp]),
        "oracle_ff_inv": (None, [vp, ci, vp, vp]),
        "oracle_ec_msm": (None, [vp, ci, vp, vp, vp, vp, vp, vp, ip]),
        "oracle_divisor_witness": (ci, [vp, ci, vp, vp, vp, ci, vp, vp, ip, ip, vp, vp, ip]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(l, name)
        fn.restype, fn.argtypes = restype, argtypes
    return l


def _limbs64(x: int) -> np.ndarray:
    return np.array([(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)], dtype=np.uint64)


def _ints64(xs) -> np.ndarray:
    out = np.zeros((len(xs), 4), dtype=np.uint64)
    for i, x in enumerate(xs):
        for j in range(4):
            out[i, j] = (x >> (64 * j)) & ((1 << 64) - 1)
    return out


def _from64(a: np.ndarray) -> list[int]:
    a = a.reshape(-1, 4)
    return [int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128 | int(r[3]) << 192 for r in a]


@lru_cache(maxsize=None)
def field_ctx(spec: FieldSpec):
    l = lib()
    buf = ctypes.create_string_buffer(l.oracle_sizeof_field_ctx())
    p = _limbs64(spec.p)
    l.oracle_field_ctx(p.ctypes.data_as(ctypes.c_void_p), buf)
    return buf


@lru_cache(maxsize=None)
def curve_ctx(curve: CurveSpec):
    l = lib()
    buf = ctypes.create_string_buffer(l.oracle_sizeof_curve_ctx())
    p = _limbs64(curve.field.p)
    a = _limbs64(curve.a % curve.field.p)
    b = _limbs64(curve.b % curve.field.p)
    l.oracle_curve_ctx(
        p.ctypes.data_as(ctypes.c_void_p),
        a.ctypes.data_as(ctypes.c_void_p),
        b.ctypes.data_as(ctypes.c_void_p),
        buf,
    )
    return buf


def _vp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def ff_mul(spec: FieldSpec, xs, ys) -> list[int]:
    l = lib()
    a, b = _ints64(xs), _ints64(ys)
    out = np.zeros_like(a)
    l.oracle_ff_mul(field_ctx(spec), len(xs), _vp(a), _vp(b), _vp(out))
    return _from64(out)


def ff_add(spec: FieldSpec, xs, ys) -> list[int]:
    l = lib()
    a, b = _ints64(xs), _ints64(ys)
    out = np.zeros_like(a)
    l.oracle_ff_add(field_ctx(spec), len(xs), _vp(a), _vp(b), _vp(out))
    return _from64(out)


def ff_inv(spec: FieldSpec, xs) -> list[int]:
    """Inverses, 0 for 0."""
    l = lib()
    a = _ints64(xs)
    out = np.zeros_like(a)
    l.oracle_ff_inv(field_ctx(spec), len(xs), _vp(a), _vp(out))
    return _from64(out)


def _pts_arrays(pts):
    xs = _ints64([p[0] if p else 0 for p in pts])
    ys = _ints64([p[1] if p else 0 for p in pts])
    inf = np.array([1 if p is None else 0 for p in pts], dtype=np.int32)
    return xs, ys, inf


def ec_msm(curve: CurveSpec, scalars, pts):
    """MSM oracle (double-and-add); returns affine (x, y) or None."""
    l = lib()
    xs, ys, inf = _pts_arrays(pts)
    sc = _ints64([s % curve.scalar_field.p for s in scalars])
    ox = np.zeros(4, dtype=np.uint64)
    oy = np.zeros(4, dtype=np.uint64)
    oinf = ctypes.c_int(0)
    l.oracle_ec_msm(
        curve_ctx(curve), len(pts), _vp(sc), _vp(xs), _vp(ys), _vp(inf),
        _vp(ox), _vp(oy), ctypes.byref(oinf),
    )
    if oinf.value:
        return None
    return (_from64(ox)[0], _from64(oy)[0])


def divisor_witness(curve: CurveSpec, pts):
    """(a_coeffs, b_coeffs, output point or None): the divisor witness of a
    list of None/(x, y) points, computed independently in C++."""
    l = lib()
    xs, ys, inf = _pts_arrays(pts)
    cap = len(pts) + 4
    oa = np.zeros((cap, 4), dtype=np.uint64)
    ob = np.zeros((cap, 4), dtype=np.uint64)
    la = ctypes.c_int(0)
    lb = ctypes.c_int(0)
    ox = np.zeros(4, dtype=np.uint64)
    oy = np.zeros(4, dtype=np.uint64)
    oinf = ctypes.c_int(0)
    rc = l.oracle_divisor_witness(
        curve_ctx(curve), len(pts), _vp(xs), _vp(ys), _vp(inf), cap,
        _vp(oa), _vp(ob), ctypes.byref(la), ctypes.byref(lb),
        _vp(ox), _vp(oy), ctypes.byref(oinf),
    )
    if rc != 0:
        raise RuntimeError("oracle_divisor_witness: the output capacity is too small")
    a = _from64(oa)[: la.value]
    b = _from64(ob)[: lb.value]
    out = None if oinf.value else (_from64(ox)[0], _from64(oy)[0])
    return a, b, out
