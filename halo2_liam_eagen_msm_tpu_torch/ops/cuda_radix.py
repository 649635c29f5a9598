"""The radix reorder's four kernels, with their plain versions.

The counterpart of the JAX package's kernels in ops/radix.py.  Four kernels
(CUDA C++ for sm_90a, csrc/radix.cuh, built and launched through
ops/cuda_ff.py's library, launcher and LAUNCHES) carry ops/radix.radix_window:

  kernel          replaces (ops/radix.py)   what it computes
  radix_rank      _rank_kernel              per tile: stable rank of each
                                            valid row in its coarse partition,
                                            per-partition counts, each row's
                                            place in the tile image
  radix_shuffle   _shuffle_kernel           per tile: rows and keys moved to
                                            those places, zeros elsewhere
  radix_pass_b    _pass_b_kernel            per partition: stable counting
                                            sort by fine id, zero tail
  radix_compact   _compact_kernel           the partitions' row blocks at
                                            their 64-row aligned bases

radix_rank and radix_pass_b rank rows by warp votes and a scan of per-warp
counts.

Every function takes the window's RadixPlan (ops/radix.make_plan) for its
shapes.  Tensors are int32: keys (n,) in [0, 2^c); packed payload rows (n,
16) as ops/msm._pack_pair makes them (all 32 bits used; the all-zero row is
the affine identity and marks "no point"); image rows (.., 20): payload, key,
three zero words.

Routing is by the tensor, in the wrappers themselves: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs `<name>_plain`, the same function
written from its contract with stable sorts, index copies and cumulative
sums.
"""

from __future__ import annotations

import torch

from . import cuda_ff as CF

MAX_OUT_ROWS = 8704  # RADIX_MAX_OUT_ROWS of csrc/radix.cuh: the shuffle's shared table
MAX_FB = 6           # pass B's fine ids fit 2^MAX_FB + 1 bins (the TPU's FB_COLS == 128)
IMG_COLS = 20        # an image row: 16 payload words, the key, three zero words


def _check(name: str, *tensors) -> None:
    """One CUDA device, int32, contiguous, 16-byte aligned: the kernels read
    rows as 16-byte vectors."""
    CF._check_device(name, *tensors)
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: tensors are int32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned, "
                             f"got a {tuple(t.shape)} tensor with strides {t.stride()}")


def _check_window(name: str, plan, keys, pay) -> None:
    if keys.shape != (plan.n,) or pay.shape != (plan.n, 16):
        raise ValueError(f"{name}: expected keys ({plan.n},) and payload ({plan.n}, 16), "
                         f"got {tuple(keys.shape)} and {tuple(pay.shape)}")


# ---------------------------------------------------------------------------
# the four kernels (a CUDA tensor launches, a CPU tensor takes the plain version)
# ---------------------------------------------------------------------------

def rank(plan, keys, pay):
    """keys (n,), pay (n, 16) -> (dst (n,), cnt (n_tiles, P)).

    dst[i]: the place of row i in its tile's image: partition * S + rank for
    the first S valid rows of a (tile, partition), P * S + spill rank for the
    next ones while the tile's SP spill rows last, OUT_ROWS (dropped) for a
    row of no point, a key past 2^c (the caller flags those) and spills past
    SP.  cnt: valid rows of each (tile, partition), spilled ones included."""
    _check_window("radix_rank", plan, keys, pay)
    if not CF._use_kernel(keys):
        return rank_plain(plan, keys, pay)
    _check("radix_rank", keys, pay)
    dst = torch.empty_like(keys)
    cnt = torch.empty((plan.n_tiles, plan.P), dtype=torch.int32, device=keys.device)
    CF._launch("radix_rank", keys.device, keys.data_ptr(), pay.data_ptr(), dst.data_ptr(),
               cnt.data_ptr(), plan.n_tiles, plan.T, plan.fb, plan.P, plan.S, plan.SP,
               plan.OUT_ROWS)
    return dst, cnt


def shuffle(plan, keys, dst, pay):
    """keys (n,), dst (n,) from rank, pay (n, 16) -> tiles (n_tiles,
    OUT_ROWS, 20): image row dst[i] of row i's tile holds (pay[i], keys[i],
    0, 0, 0) where 0 <= dst[i] < OUT_ROWS; rows no source lands on are zero."""
    _check_window("radix_shuffle", plan, keys, pay)
    if dst.shape != keys.shape:
        raise ValueError(f"radix_shuffle: dst {tuple(dst.shape)} != keys {tuple(keys.shape)}")
    if not CF._use_kernel(keys):
        return shuffle_plain(plan, keys, dst, pay)
    _check("radix_shuffle", keys, dst, pay)
    if plan.OUT_ROWS > MAX_OUT_ROWS:
        raise ValueError(f"radix_shuffle: {plan.OUT_ROWS} image rows exceed {MAX_OUT_ROWS}")
    tiles = torch.empty((plan.n_tiles, plan.OUT_ROWS, IMG_COLS), dtype=torch.int32,
                        device=keys.device)
    CF._launch("radix_shuffle", keys.device, keys.data_ptr(), dst.data_ptr(), pay.data_ptr(),
               tiles.data_ptr(), plan.n_tiles, plan.T, plan.OUT_ROWS)
    return tiles


def pass_b(plan, main):
    """main (P, R, 20), each partition's slot rows -> (parts (P, R_pad, 16),
    fc (P, 2^fb + 1)).  parts[p]: the rows with a point, stably sorted by fine
    id (key & (2^fb - 1)), then zeros; fc[p, f]: rows of fine id f, and in the
    last column the rows of no point.  The kernel keeps its first pass's fine
    ids in shared memory where R <= RADIX_PASS_B_STASH of csrc/radix.cuh,
    else it reads the rows' key words again."""
    kernel = "radix_pass_b"
    if plan.fb > MAX_FB:
        raise ValueError(f"{kernel}: fb = {plan.fb} > {MAX_FB} (2^fb + 1 fine ids "
                         "must fit the pass's 65 bins, as the TPU's FB_COLS == 128)")
    if main.shape != (plan.P, plan.R, IMG_COLS):
        raise ValueError(f"{kernel}: expected ({plan.P}, {plan.R}, {IMG_COLS}), "
                         f"got {tuple(main.shape)}")
    if not CF._use_kernel(main):
        return pass_b_plain(plan, main)
    _check(kernel, main)
    parts = torch.empty((plan.P, plan.R_pad, 16), dtype=torch.int32, device=main.device)
    fc = torch.empty((plan.P, (1 << plan.fb) + 1), dtype=torch.int32, device=main.device)
    CF._launch(kernel, main.device, main.data_ptr(), parts.data_ptr(), fc.data_ptr(), plan.P,
               plan.R, plan.R_pad, plan.fb)
    return parts, fc


def compact(plan, parts, base4):
    """parts (P, R_pad, 16), base4 (P,) non-decreasing with base4[0] = 0 ->
    (n_ext, 16): partition p's R_pad rows copied to row base4[p], in order of
    p, so that a later partition overwrites an earlier one's rows; rows no
    partition reaches are zero."""
    if parts.shape != (plan.P, plan.R_pad, 16) or base4.shape != (plan.P,):
        raise ValueError(f"radix_compact: expected ({plan.P}, {plan.R_pad}, 16) and "
                         f"({plan.P},), got {tuple(parts.shape)} and {tuple(base4.shape)}")
    if not CF._use_kernel(parts):
        return compact_plain(plan, parts, base4)
    _check("radix_compact", parts, base4)
    out = torch.empty((plan.n_ext, 16), dtype=torch.int32, device=parts.device)
    CF._launch("radix_compact", parts.device, parts.data_ptr(), base4.data_ptr(),
               out.data_ptr(), plan.P, plan.R_pad, plan.n_ext)
    return out


# ---------------------------------------------------------------------------
# plain versions (any device), written from the contracts above
# ---------------------------------------------------------------------------

def _group_ranks(groups, n_groups: int):
    """Stable rank of each element among the earlier elements of its group,
    and the size of every group (groups: (m,) int64 in [0, n_groups))."""
    order = torch.sort(groups, stable=True).indices
    sizes = torch.bincount(groups, minlength=n_groups)
    first = sizes.cumsum(0) - sizes
    pos = torch.empty_like(order)
    pos[order] = torch.arange(groups.shape[0], device=groups.device)
    return pos - first[groups], sizes


def rank_plain(plan, keys, pay):
    n_tiles, T, P, S = plan.n_tiles, plan.T, plan.P, plan.S
    coarse = (keys.to(torch.int64) >> plan.fb).view(n_tiles, T)
    valid = (pay != 0).any(dim=-1).view(n_tiles, T) & (coarse >= 0) & (coarse < P)
    tile = torch.arange(n_tiles, device=keys.device)[:, None]
    # group = (tile, partition); rows of no point get the extra group P
    groups = tile * (P + 1) + torch.where(valid, coarse, P)
    rk, sizes = _group_ranks(groups.reshape(-1), n_tiles * (P + 1))
    rk = rk.view(n_tiles, T)
    spill = valid & (rk >= S)
    sp_rank = spill.to(torch.int64).cumsum(dim=1) - 1
    dst = torch.where(spill, P * S + sp_rank, coarse * S + rk)
    dropped = ~valid | (spill & (sp_rank >= plan.SP))
    dst = torch.where(dropped, plan.OUT_ROWS, dst)
    cnt = sizes.view(n_tiles, P + 1)[:, :P]
    return dst.reshape(-1).to(torch.int32), cnt.to(torch.int32).contiguous()


def shuffle_plain(plan, keys, dst, pay):
    n, T, rows = plan.n, plan.T, plan.OUT_ROWS
    src = torch.cat([pay, keys[:, None], pay.new_zeros((n, IMG_COLS - 17))], dim=1)
    kept = ((dst >= 0) & (dst < rows)).nonzero().flatten()
    tile = torch.div(kept, T, rounding_mode="floor")
    flat = tile * rows + dst[kept].to(torch.int64)
    img = pay.new_zeros((plan.n_tiles * rows, IMG_COLS))
    img.index_copy_(0, flat, src[kept])
    return img.view(plan.n_tiles, rows, IMG_COLS)


def pass_b_plain(plan, main):
    nf = 1 << plan.fb
    valid = (main[..., :16] != 0).any(dim=-1)
    fine = torch.where(valid, main[..., 16].to(torch.int64) & (nf - 1), nf)  # (P, R)
    order = torch.sort(fine, dim=1, stable=True).indices
    parts = main.new_zeros((plan.P, plan.R_pad, 16))
    parts[:, :plan.R] = torch.gather(main[..., :16], 1, order[..., None].expand(-1, -1, 16))
    part = torch.arange(plan.P, device=main.device)[:, None]
    fc = torch.bincount((part * (nf + 1) + fine).reshape(-1), minlength=plan.P * (nf + 1))
    return parts, fc.view(plan.P, nf + 1).to(torch.int32)


def compact_plain(plan, parts, base4):
    out = parts.new_zeros((plan.n_ext + plan.R_pad, 16))
    for p, b in enumerate(base4.tolist()):  # in order: p + 1 overwrites p's tail
        out[b:b + plan.R_pad] = parts[p]
    return out[:plan.n_ext]
