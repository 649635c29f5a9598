"""Radix reorder of one Pippenger window: a bucket-contiguous stream of the
window's packed point rows without a sort and gather of the whole window.

The counterpart of the JAX package's ops/radix.py, with its names, plan and
outputs.  The route is off by default (config.RADIX_MSM); ops/msm.py takes it
for windows of at least RADIX_MIN_ROWS points when it is on.

Key = bucket id in [0, 2^c), split c = cb coarse bits | fb fine bits.
Pipeline (kernels in ops/cuda_radix.py, CUDA C++ in csrc/radix.cuh):

  rank, shuffle  per tile of T rows: the valid rows (payload not all zero;
                 identities are dropped, they add nothing to a bucket) go to
                 S slot rows of their coarse partition, rows past S to the
                 tile's SP spill rows; past SP the window overflows
  transpose      (tile, partition) slots -> partition-major (plain PyTorch)
  pass B         per partition: stable counting sort by fine id
  compact        partition p's rows at base4[p], the running sum of the
                 partitions' valid rows rounded up to GHOST rows; the zero
                 rows between partitions are identities for the scan

The spilled rows (a few a tile for uniform keys, S being twice the mean
occupancy) go the classic way, by sort and gather, in the caller; an overflow flags the window, and the caller
redoes the MSM in the safe flavor, which takes the classic route.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import cuda_radix as CR


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


GHOST = 64  # alignment of the partitions' bases, in rows (the TPU's 1024-element DMA unit)


@dataclass(frozen=True)
class RadixPlan:
    n: int            # points (multiple of T)
    c: int            # window bits
    T: int            # tile rows
    n_tiles: int
    cb: int           # coarse bits
    fb: int           # fine bits (c = cb + fb)
    P: int            # 2^cb coarse partitions
    S: int            # slot rows per (tile, partition)
    SP: int           # spill capacity rows per tile
    OUT_ROWS: int     # tile image rows (P*S + SP padded to SH)
    SH: int           # the TPU's shuffle strip height (kept: it sets OUT_ROWS)
    R: int            # n_tiles * S rows per partition entering pass B
    R_pad: int        # R padded to SHB and the ghost unit
    SHB: int          # the TPU's pass-B strip height (kept: it sets R_pad)
    FB_COLS: int      # the TPU's lanes of fine columns (>= 2^fb + 1, mult of 128)
    n_ext: int        # output stream rows: n + ghost padding per partition


def make_plan(n: int, c: int, T: int | None = None) -> RadixPlan:
    """Shapes for the two-pass reorder, the JAX package's rules exactly.
    T = 4096 keeps the mean slot occupancy at T/P = 8; smaller n shrinks T."""
    if T is None:
        T = min(4096, n)
    assert n % T == 0 and T % 256 == 0, (n, T)
    n_tiles = n // T
    cb = max(1, min(9, c - 1, T.bit_length() - 1 - 2))
    fb = c - cb
    P = 1 << cb
    mean = T // P
    # slot capacity mean + max(8, mean) (2x padding): with P * n_tiles * W
    # (tile, partition, window) cells an MSM, a tighter capacity would
    # overflow somewhere in nearly every run
    S = mean + max(8, mean)
    SP = max(128, T // 32)
    raw = P * S + SP
    SH = 512 if raw >= 512 else raw
    OUT_ROWS = _cdiv(raw, SH) * SH
    R = n_tiles * S
    # ghost-align first, then the strip height as a divisor of R_pad
    R_pad = _cdiv(R, GHOST) * GHOST
    SHB = 512 if R_pad >= 512 else R_pad
    R_pad = _cdiv(R_pad, SHB) * SHB
    FB_COLS = _cdiv((1 << fb) + 1, 128) * 128
    n_ext = n + GHOST * P
    return RadixPlan(n, c, T, n_tiles, cb, fb, P, S, SP, OUT_ROWS, SH,
                     R, R_pad, SHB, FB_COLS, n_ext)


def partition_major(plan: RadixPlan, tiles):
    """(n_tiles, OUT_ROWS, 20) tile images -> (P, R, 20): each partition's
    slot rows, tile after tile (contiguous chunks of S rows)."""
    return (tiles[:, :plan.P * plan.S]
            .reshape(plan.n_tiles, plan.P, plan.S, CR.IMG_COLS)
            .transpose(0, 1)
            .reshape(plan.P, plan.R, CR.IMG_COLS))


def ghost_bases(plan: RadixPlan, cnt):
    """Per-(tile, partition) valid-row counts (n_tiles, P) -> (base4 (P,)
    int32, the first row of each partition in the compacted stream: the
    running sum of its slot rows rounded up to GHOST; spills (n_tiles,), the
    rows each tile spilled)."""
    slot_cnt = cnt.clamp(max=plan.S)
    pc4 = (slot_cnt.sum(dim=0) + GHOST - 1) // GHOST * GHOST  # ghost-aligned extents
    return (pc4.cumsum(0) - pc4).to(torch.int32), cnt.sum(dim=1) - slot_cnt.sum(dim=1)


def radix_window(plan: RadixPlan, keys, pay):
    """One window's bucket-contiguous reorder.

    keys: (n,) int32 bucket ids in [0, 2^c); pay: (n, 16) int32 packed rows
    (ops/msm._pack_pair; the identity is all-zero).  On a CUDA tensor the four
    kernels run, on a CPU tensor their plain versions.

    Returns (sorted_pay, hi, spill_pay, spill_keys, overflow):
      sorted_pay (n_ext, 16) int32: valid points in bucket order (by key, then
               tile-major) with < GHOST zero rows after each partition and
               zeros after the last one; zero rows are identities
      hi       (2^c,) int32: hi[b] = position of bucket b's last row (-1 or
               a row before the bucket's partition if it is empty), the
               convention of ops/msm.bucket_bounds_hist
      spill_pay (n_tiles*SP, 16) int32, spill_keys (n_tiles*SP,) int32:
               the spilled rows (all-zero with key 0 where empty)
      overflow () bool: some tile spilled more than SP rows; the outputs are
               then incomplete and the caller must take the classic route
    """
    dst, cnt = CR.rank(plan, keys, pay)
    tiles = CR.shuffle(plan, keys, dst, pay)
    base4, spill_per_tile = ghost_bases(plan, cnt)
    overflow = (spill_per_tile > plan.SP).any()
    parts, fc = CR.pass_b(plan, partition_major(plan, tiles))
    # the compaction writes zeros past the last partition's rows, so the
    # stream needs no mask: rows from the last base on are its valid rows,
    # then its zero tail, then zeros
    sorted_pay = CR.compact(plan, parts, base4)

    # hi[b = (p, f)] = base4[p] + (valid rows of p with fine id <= f) - 1
    nf = 1 << plan.fb
    within = fc[:, :nf].cumsum(dim=1)
    hi = (base4[:, None] + within - 1).reshape(-1).to(torch.int32)

    slots = plan.P * plan.S
    spill = tiles[:, slots:slots + plan.SP].reshape(-1, CR.IMG_COLS)
    return sorted_pay, hi, spill[:, :16], spill[:, 16], overflow
