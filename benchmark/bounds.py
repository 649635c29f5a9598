"""The least time a kernel launch could take on one H100, counted at the
launch's own shape: the larger of its bytes over the HBM bandwidth and its
int32 operations over the int32 rate.  Each input row is read once and each
output row written once; a field product counts 136 multiply-adds (two
operations each), a field add or subtraction 8 operations.

A copy of the bound helpers the repository's card script (chip_smoke.py)
uses, so that the yardstick stays as it is when the program changes.  The
card's figures are NVIDIA's data sheet for the SXM part at 700 W: 3.35 TB/s
of HBM, and half of the 67 TFLOP/s float32 rate for int32 operations.

`launch_bound_ms(name, args)` reads a launch's shape from the arguments the
program hands its launcher (after the kernel's name and device) for the
kernels in COVERED; for any other kernel it returns None."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
MUL_OPS = 2 * 136   # one field product, as operations
ADD_OPS = 8         # one field add/sub/double
N_LIMBS = 16
ROW_BYTES = 4 * N_LIMBS
POW_WINDOW = 4      # bits of a window of the field power (fe_pow)

# kernel -> (field products, field adds, rows read + written) an element;
# per stage for stages_small; batch_inv's products come from its rows
KERNEL_TABLE = {
    "mont_mul": (1, 0, 3),
    "batch_inv": (None, 0, 2),
    "mont_addsub": (0, 1, 3),
    "ec_add": (23, 21, 9),
    "ec_add_fast": (16, 7, 9),
    "lm_mul": (1, 0, 3),
    "lm_addsub": (0, 1, 3),
    "lm_mul_const": (1, 0, 2),
    "stage_big": (0.5, 1, 2),       # + the stage's s twiddle rows
    "stages_small": (0.5, 1, 2),    # products, adds per stage; + tile - 1 twiddle rows
}
COVERED = tuple(KERNEL_TABLE)


def bound_ms(name: str, elems: int, extra_bytes: int = 0, stages: int = 1, muls=None):
    table_muls, adds, rows = KERNEL_TABLE[name]
    muls = table_muls if muls is None else muls
    t_bytes = (elems * rows * ROW_BYTES + extra_bytes) / HBM_BYTES_PER_S
    t_ops = stages * elems * (muls * MUL_OPS + adds * ADD_OPS) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3


def pow_products(e: int) -> int:
    """Field products of the kernels' field power for the exponent e:
    left-to-right sliding windows of up to POW_WINDOW bits over the odd
    powers; the table of odd powers (a^2 and 2^(POW_WINDOW-1) - 1 more), the
    squarings, and one product a window after the first."""
    steps, pending, i = [], 0, e.bit_length() - 1
    while i >= 0:
        if not (e >> i) & 1:
            pending += 1
            i -= 1
            continue
        j = max(i - (POW_WINDOW - 1), 0)
        while not (e >> j) & 1:
            j += 1
        steps.append(pending + i - j + 1 if steps else 0)
        pending, i = 0, j - 1
    return (1 << (POW_WINDOW - 1)) + sum(steps) + len(steps) - 1 + pending


def inv_muls(n: int, p: int) -> float:
    """Field products a row that inverting n rows needs, whatever the
    grouping: the Montgomery trick's 3 (n - 1) and one power of p - 2."""
    return (3 * (n - 1) + pow_products(p - 2)) / n


def launch_bound_ms(name: str, args, p: int):
    """The bound of one launch of `name` from its launcher's arguments, or
    None for a kernel outside COVERED.  The element count is the launcher's
    last argument; stage_big and stages_small take the half-size s or the
    tile before it, batch_inv its rows before the chain length."""
    if name not in KERNEL_TABLE:
        return None
    if name == "stage_big":
        s, e = int(args[-2]), int(args[-1])
        return bound_ms(name, e, extra_bytes=s * ROW_BYTES)
    if name == "stages_small":
        tile, e = int(args[-2]), int(args[-1])
        return bound_ms(name, e, extra_bytes=(tile - 1) * ROW_BYTES,
                        stages=tile.bit_length() - 1)
    if name == "batch_inv":
        n = int(args[-2])
        return bound_ms(name, n, muls=inv_muls(n, p))
    return bound_ms(name, int(args[-1]))
