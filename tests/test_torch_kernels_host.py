"""The CUDA sources of the port, rehearsed without a card: csrc/kernels.cu
compiles for the host with g++ behind a small shim (thread and block indices
as loop variables, `kernel<<<grid, block, 0, stream>>>(...)` rewritten into
that loop), the result is loaded in place of the nvcc library, and every
kernel's wrapper is held against its plain PyTorch version on CPU tensors.

This checks the arithmetic of the device functions, the C interface and the
wrappers' pointer plumbing; that the sources compile with nvcc and run on
the card is chip_smoke.py's business.  Integer arithmetic: torch.equal."""

import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from halo2_liam_eagen_msm_tpu_torch.convert import JPoint
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_mont_limbs
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops import msm as M
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.utils import pyref

torch.set_num_threads(1)

CURVE = PALLAS
SPEC = PALLAS.field
B = 37  # ragged: not a multiple of the block of 128 threads

_SHIM = """
#include <stdint.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct uint4 { uint32_t x, y, z, w; };
struct idx3 { unsigned int x; };
static idx3 blockIdx, blockDim, threadIdx;
typedef void* cudaStream_t;
static inline int cudaGetLastError() { return 0; }
"""
_LAUNCH = re.compile(
    r"(\w+)<<<(grid_for\([^)]*\)),\s*(\w+),\s*0,\s*\(cudaStream_t\)\s*stream>>>\(", re.S)


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the CUDA sources for the host")
    csrc = Path(CF.__file__).resolve().parent / "csrc"
    src = (csrc / "kernels.cu").read_text().replace("#include <cuda_runtime.h>", _SHIM)
    src, n = _LAUNCH.subn(
        r"for (blockDim.x = \3, blockIdx.x = 0; blockIdx.x < \2; blockIdx.x++) "
        r"for (threadIdx.x = 0; threadIdx.x < \3; threadIdx.x++) \1(", src)
    assert n == len(CF.KERNELS), "every launcher launches one kernel"
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "kernels_host.cpp").write_text(src)
    lib = out / "libkernels_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{csrc}",
                    "-o", str(lib), str(out / "kernels_host.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
    return lib


@pytest.fixture
def host_kernels(host_library, monkeypatch):
    """The wrappers of ops/cuda_ff.py on CPU tensors, bound to the host
    build."""
    def launch(name, dev, *args):
        rc = getattr(CF._lib(), name + "_launch")(*args, None)
        CF.LAUNCHES[name] += 1
        assert rc == 0

    monkeypatch.setattr(CF, "build_library", lambda: host_library)
    monkeypatch.setattr(CF, "_LIB", None)
    monkeypatch.setattr(CF, "_check_cuda", lambda name, *tensors: None)
    monkeypatch.setattr(CF, "_launch", launch)
    return CF


def _field(nprng, b):
    vals = [int(v) for v in nprng.integers(0, 1 << 62, size=b)]
    vals = [(v * v * v * 0x9E3779B97F4A7C15 + 1) % SPEC.p for v in vals]
    vals[:4] = [0, SPEC.p - 1, 1, 0]
    return torch.from_numpy(ints_to_mont_limbs(vals, SPEC).view("int32").copy())


def _jacobian(rng, nprng, pts):
    """Host points -> Jacobian limbs with a random representative a lane."""
    E = ec(CURVE)
    p = E.points_from_ints(pts, "cpu")
    lam = _field(nprng, len(pts))
    lam[:, 0] |= 1
    mul = lambda u, v: CF.mont_mul_plain(SPEC, u, v)
    l2 = mul(lam, lam)
    z = torch.where(E.is_identity(p)[:, None], p.z, lam)
    return JPoint(mul(p.x, l2), mul(p.y, mul(l2, lam)), z)


def _edge_points(rng):
    """Two host lists with the edge lanes: p identity, q identity, both,
    q == p, q == -p."""
    p = pyref.random_points(rng, CURVE, B)
    q = pyref.random_points(rng, CURVE, B)
    p[0] = q[1] = p[2] = q[2] = None
    q[3] = p[3]
    q[4] = pyref.ec_neg(p[4], CURVE)
    return p, q


def _case(name, rng, nprng):
    """(kernel call, plain call, arguments) for kernel `name`."""
    E = ec(CURVE)
    if name == "mont_mul":
        return (lambda a, b: (CF.mont_mul(SPEC, a, b),),
                lambda a, b: (CF.mont_mul_plain(SPEC, a, b),),
                (_field(nprng, B), _field(nprng, B)))
    if name == "mont_addsub":
        def both(fn):
            return lambda a, b: (fn(SPEC, False, a, b), fn(SPEC, True, a, b))
        return both(CF.mont_addsub), both(CF.mont_addsub_plain), \
            (_field(nprng, B), _field(nprng, B))
    hp, hq = _edge_points(rng)
    p = _jacobian(rng, nprng, hp)
    if name in ("ec_add", "ec_add_fast", "ec_double"):
        args = tuple(p) if name == "ec_double" else (*p, *_jacobian(rng, nprng, hq))
        kernel, plain = getattr(CF, name), getattr(CF, name + "_plain")
        return (lambda *a: kernel(CURVE, *a)), (lambda *a: plain(CURVE, *a)), args
    qx, qy, qid = E.to_affine(E.points_from_ints(hq, "cpu"))
    if name == "ec_add_mixed":
        return (lambda *a: CF.ec_add_mixed(CURVE, *a),
                lambda *a: CF.ec_add_mixed_plain(CURVE, *a), (*p, qx, qy, qid))
    if name == "ec_madd_xyzz_fast":
        zz = CF.mont_mul_plain(SPEC, p.z, p.z)
        args = (p.x, p.y, zz, CF.mont_mul_plain(SPEC, zz, p.z), qx, qy)
        return (lambda *a: CF.ec_madd_xyzz_fast(CURVE, *a),
                lambda *a: CF.ec_madd_xyzz_fast_plain(CURVE, *a), args)
    assert name == "fused_madd_scan_xyzz"
    w, g = 4, 9
    pts = pyref.random_points(rng, CURVE, 8) * 5
    pts = pts[:w * g]
    pts[2] = pts[7] = None                                 # zero rows
    pts[5 * w] = pyref.ec_neg(E.offset_point_ints(), CURVE)  # flags lane 5
    ax, ay, _ = E.to_affine(E.points_from_ints(pts, "cpu"))
    t_limbs = tuple(tuple(int(v) for v in ints_to_mont_limbs([c], SPEC)[0])
                    for c in E.offset_point_ints())
    return (lambda rows: CF.fused_madd_scan_xyzz(CURVE, t_limbs, rows, w),
            lambda rows: CF.fused_madd_scan_xyzz_plain(CURVE, t_limbs, rows, w),
            (M._pack_pair(ax, ay).contiguous(),))


def _flat(out):
    flat = []
    for o in out:
        flat.extend(o if isinstance(o, tuple) else [o])
    return flat


@pytest.mark.parametrize("name", CF.KERNELS)
def test_kernel_source_on_host_equals_plain(name, host_kernels, rng, nprng):
    kernel, plain, args = _case(name, rng, nprng)
    before = CF.LAUNCHES[name]
    got = _flat(kernel(*args))
    want = _flat(plain(*args))
    assert CF.LAUNCHES[name] > before
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    if name == "ec_madd_xyzz_fast":
        # identity carry, carry == Q, carry == -Q; qy == 0 passes unflagged
        assert got[4].nonzero().flatten().tolist() == [0, 3, 4]
    if name == "fused_madd_scan_xyzz":
        assert got[8].nonzero().flatten().tolist() == [5]
