"""The port stands alone: importing it pulls in neither jax nor the JAX
package, and none of its sources names them."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "halo2_liam_eagen_msm_tpu_torch"
JAX_PKG = "halo2_liam_eagen_msm_tpu"

_PROBE = f"""
import sys
import {PKG}
import {PKG}.ops.msm
import {PKG}.ops.cuda_ff
import {PKG}.convert
import {PKG}.argument
import {PKG}.negbase
import {PKG}.divisor
import {PKG}.ops.ntt
import {PKG}.ops.poly
import {PKG}.ops.cuda_ntt
import {PKG}.ops.radix
import {PKG}.ops.cuda_radix
import {PKG}.models.eagen_msm
import {PKG}.entry
import {PKG}.utils.checks
import {PKG}.utils.profiling
import {PKG}.oracle
import {PKG}.utils.ref_divisor
import {PKG}.utils.rustsem
import {PKG}.circuit.synthesize
import {PKG}.parallel.comm
import {PKG}.parallel.launch
import {PKG}.parallel.mesh
import {PKG}.parallel.dist_ntt
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "{JAX_PKG}" or m.startswith("{JAX_PKG}."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_import_leaves_jax_out():
    """In a fresh interpreter (this process has jax loaded by conftest)."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, PKG)):
        out += [os.path.join(d, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return out


def test_sources_name_no_jax_import():
    pat = re.compile(
        r"import\s+jax|from\s+jax|" + JAX_PKG + r"\.|" + JAX_PKG + r"\s+import")
    srcs = _port_sources()
    assert len(srcs) > 10
    for path in srcs:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                assert not pat.search(line), f"{path}:{i}: {line.strip()}"


def test_no_global_device_fallback():
    """Entry points resolve 'cuda' or raise; nothing rewrites the device to
    the CPU where there is no card."""
    import pytest
    import torch

    from halo2_liam_eagen_msm_tpu_torch.config import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
