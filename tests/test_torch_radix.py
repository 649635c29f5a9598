"""Radix reorder of the PyTorch port (ops/radix.py, ops/cuda_radix.py) and the
radix route of best_multiexp, on the CPU through the plain versions.

- the plan equals the JAX package's make_plan field for field;
- radix_window equals the JAX package's radix_window (its Pallas kernels in
  interpret mode, as tests/test_radix.py runs them) bit for bit in all five
  outputs, on the same numpy inputs, and the slot-exact numpy model of
  tools/validate_radix.py;
- each plain kernel equals a direct reading of its contract;
- best_multiexp with config.RADIX_MSM on, its thresholds lowered so that
  windows of 256-1024 points take the route, equals the Python-int oracle
  and the classic route, with spilled rows, with an overflow (exact through
  the safe redo) and with the top window split off; the top window's width
  follows the JAX package's predicate.

Integer data: every comparison is exact.  Points are compared as affine
integers."""

import random

import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu.ops import radix as JRX
from halo2_liam_eagen_msm_tpu_torch import config
from halo2_liam_eagen_msm_tpu_torch.convert import JPoint
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_radix as CR
from halo2_liam_eagen_msm_tpu_torch.ops import msm as M
from halo2_liam_eagen_msm_tpu_torch.ops import radix as RX
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.utils import pyref
from tools.validate_radix import numpy_model

torch.set_num_threads(1)

PLAN_CASES = [  # tests/test_radix.py::test_plan_invariants
    (512, 8, None), (1024, 10, 512), (4096, 12, None),
    (1 << 13, 15, None), (1 << 17, 15, None), (1 << 20, 15, None),
    (1 << 20, 16, None), (1 << 18, 9, None),
]


@pytest.mark.parametrize("n,c,T", PLAN_CASES)
def test_make_plan_equals_jax(n, c, T):
    assert RX.make_plan(n, c, T).__dict__ == JRX.make_plan(n, c, T).__dict__
    assert RX.GHOST == JRX.GHOST


def _inputs(n, c, seed, ident_frac=0.02, skew=None, crowd=0):
    """Keys and uint32 payload as tests/test_radix.py makes them; `crowd`
    rows of every tile of 512 moved into coarse partition 5."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << c, size=n).astype(np.int32)
    if skew == "low":
        keys = (keys % 7).astype(np.int32)
    pay = rng.integers(1, 1 << 32, size=(n, 16), dtype=np.uint32)
    pay[rng.random(n) < ident_frac] = 0
    keys[rng.random(n) < ident_frac] = 0
    if crowd:
        fb = RX.make_plan(n, c, 512).fb
        for t0 in range(0, n, 512):
            rows = t0 + rng.choice(512, size=crowd, replace=False)
            keys[rows] = (5 << fb) + rng.integers(0, 1 << fb, size=crowd)
    return keys, pay


@pytest.mark.parametrize("n,c,T,seed,skew,crowd", [
    (512, 8, None, 5, None, 0),      # one tile
    (1024, 10, 512, 9, None, 0),     # two tiles: the transpose, the compaction
    (1024, 10, 512, 13, "low", 0),   # crowded into few partitions: overflow
    (1024, 10, 512, 21, None, 40),   # 40 rows a tile in one partition: spills, no overflow
])
def test_radix_window_equals_jax_and_model(n, c, T, seed, skew, crowd):
    import jax.numpy as jnp

    keys, pay = _inputs(n, c, seed, skew=skew, crowd=crowd)
    plan = RX.make_plan(n, c, T)
    got = RX.radix_window(plan, torch.from_numpy(keys), torch.from_numpy(pay.view(np.int32)))
    sorted_pay, hi, spill_pay, spill_keys = (g.numpy() for g in got[:4])
    sorted_pay, spill_pay = sorted_pay.view(np.uint32), spill_pay.view(np.uint32)
    overflow = bool(got[4])

    want = JRX.radix_window(JRX.make_plan(n, c, T), jnp.asarray(keys), jnp.asarray(pay))
    assert sorted_pay.shape == (plan.n_ext, 16) and hi.shape == (1 << c,)
    assert np.array_equal(sorted_pay, np.asarray(want[0]))
    assert np.array_equal(hi, np.asarray(want[1]))
    assert np.array_equal(spill_pay, np.asarray(want[2]))
    assert np.array_equal(spill_keys, np.asarray(want[3]))
    assert overflow == bool(want[4])

    m_main, m_hi, m_spill, m_spill_keys, m_overflow = numpy_model(plan, keys, pay)
    nvalid = m_main.shape[0]
    assert overflow == m_overflow == (skew == "low")
    assert np.array_equal(sorted_pay[:nvalid], m_main) and not sorted_pay[nvalid:].any()
    assert np.array_equal(hi, m_hi)
    assert np.array_equal(spill_pay, m_spill) and np.array_equal(spill_keys, m_spill_keys)
    if crowd:
        spilled = int(spill_pay.any(axis=1).sum())
        assert 0 < spilled <= plan.n_tiles * plan.SP


# ---------------------------------------------------------------------------
# each plain kernel against a direct reading of its contract
# ---------------------------------------------------------------------------

SMALL = RX.make_plan(512, 8, 256)  # P = 64, S = 12, SP = 128, two tiles


def _small_window(seed=3):
    """Tile 0 overflows (200 rows in one partition), tile 1 spills some;
    two keys past 2^c, which rank drops."""
    rng = np.random.default_rng(seed)
    keys, pay = _inputs(512, 8, seed, ident_frac=0.05)
    keys[rng.choice(256, size=200, replace=False)] = 9 << SMALL.fb
    keys[256 + rng.choice(256, size=30, replace=False)] = (17 << SMALL.fb) + 1
    keys[[7, 300]] = [1 << 8, (1 << 9) + 5]
    pay[[7, 300], 0] = 1
    return torch.from_numpy(keys), torch.from_numpy(pay.view(np.int32))


def test_rank_plain_contract():
    p = SMALL
    keys, pay = _small_window()
    dst, cnt = CR.rank(p, keys, pay)
    want_dst, want_cnt = [], []
    for t in range(p.n_tiles):
        seen, spills = [0] * p.P, 0
        for i in range(t * p.T, (t + 1) * p.T):
            part = int(keys[i]) >> p.fb
            if not bool(pay[i].any()) or part >= p.P:
                want_dst.append(p.OUT_ROWS)
                continue
            r = seen[part]
            seen[part] += 1
            if r < p.S:
                want_dst.append(part * p.S + r)
            else:
                want_dst.append(p.P * p.S + spills if spills < p.SP else p.OUT_ROWS)
                spills += 1
        want_cnt.append(seen)
    assert dst.dtype == cnt.dtype == torch.int32
    assert dst.tolist() == want_dst and cnt.tolist() == want_cnt
    assert want_dst[:256].count(p.OUT_ROWS) > 12  # tile 0 dropped spills past SP


def test_shuffle_plain_contract():
    p = SMALL
    keys, pay = _small_window()
    dst, _ = CR.rank(p, keys, pay)
    tiles = CR.shuffle(p, keys, dst, pay)
    want = torch.zeros((p.n_tiles, p.OUT_ROWS, 20), dtype=torch.int32)
    for i in range(p.n):
        if int(dst[i]) < p.OUT_ROWS:
            want[i // p.T, int(dst[i]), :16] = pay[i]
            want[i // p.T, int(dst[i]), 16] = keys[i]
    assert torch.equal(tiles, want)


def test_pass_b_plain_contract():
    p = SMALL
    rng = np.random.default_rng(4)
    main = torch.from_numpy(rng.integers(-1 << 31, 1 << 31, size=(p.P, p.R, 20),
                                         dtype=np.int64).astype(np.int32))
    main[..., 16] = torch.from_numpy(rng.integers(0, 1 << p.c, size=(p.P, p.R)).astype(np.int32))
    main[torch.from_numpy(rng.random((p.P, p.R)) < 0.3), :16] = 0  # rows of no point
    parts, fc = CR.pass_b(p, main)
    nf = 1 << p.fb
    for q in range(p.P):
        rows = [(int(main[q, j, 16]) & (nf - 1), j) for j in range(p.R) if bool(main[q, j, :16].any())]
        order = [j for _, j in sorted(rows, key=lambda fj: fj[0])]  # stable by fine id
        assert torch.equal(parts[q, :len(order)], main[q, order, :16])
        assert not parts[q, len(order):].any()
        counts = [sum(1 for f, _ in rows if f == k) for k in range(nf)] + [p.R - len(rows)]
        assert fc[q].tolist() == counts


def test_compact_plain_contract():
    """Gather reading of the ordered copies: row r comes from the LAST p with
    base4[p] <= r, at r - base4[p] if below R_pad; equal bases (an empty
    partition) let the later partition win; rows past the end are zero."""
    p = SMALL
    rng = np.random.default_rng(6)
    parts = torch.from_numpy(rng.integers(1, 1 << 30, size=(p.P, p.R_pad, 16)).astype(np.int32))
    ext = rng.choice([0, 64], size=p.P)
    ext[[3, 4, 10]] = 0  # partitions 3, 4 and 10 share their base with the next one
    base4 = torch.from_numpy((np.cumsum(ext) - ext).astype(np.int32))
    out = CR.compact(p, parts, base4)
    assert out.shape == (p.n_ext, 16)
    b = base4.tolist()
    for r in range(p.n_ext):
        q = max(k for k in range(p.P) if b[k] <= r)
        want = parts[q, r - b[q]] if r - b[q] < p.R_pad else torch.zeros(16, dtype=torch.int32)
        assert torch.equal(out[r], want), r


def test_wrappers_check_shapes():
    p = SMALL
    keys, pay = _small_window()
    with pytest.raises(ValueError):
        CR.rank(p, keys[:-1], pay)
    with pytest.raises(ValueError):
        CR.pass_b(RX.make_plan(4096, 16, 4096), torch.zeros((1, 1, 20), dtype=torch.int32))


# ---------------------------------------------------------------------------
# best_multiexp through the radix route
# ---------------------------------------------------------------------------

@pytest.fixture
def radix_route(monkeypatch):
    """RADIX_MSM on; returns set_tile(T), which lowers the route's thresholds
    to windows of T points, and the record of every radix_window call."""
    calls = []
    real = RX.radix_window

    def recorded(plan, keys, pay):
        out = real(plan, keys, pay)
        calls.append((plan, int(out[2].any(dim=1).sum()), bool(out[4])))
        return out

    def set_tile(T):
        monkeypatch.setattr(M, "RADIX_MIN_ROWS", T)
        monkeypatch.setattr(M, "RADIX_TILE", T)

    monkeypatch.setattr(config, "RADIX_MSM", True)
    monkeypatch.setattr(RX, "radix_window", recorded)
    return set_tile, calls


def _tiled_points(n, seed):
    """n points tiled from 64 random base points, every 97th the identity."""
    base = pyref.random_points(random.Random(seed), PALLAS, 64)
    host = [None if i % 97 == 5 else base[i % 64] for i in range(n)]
    return base, host, ec(PALLAS).points_from_ints(host, "cpu")


def _oracle(base, host, scalars):
    """sum_i s_i P_i as a 64-point MSM over the base points."""
    q = PALLAS.scalar_field.p
    folded = [0] * len(base)
    for i, (s, pt) in enumerate(zip(scalars, host)):
        if pt is not None:
            folded[i % len(base)] = (folded[i % len(base)] + s) % q
    return pyref.ec_msm(folded, base, PALLAS)


def _msm(scalars, pts, c, bits):
    res = M.best_multiexp(PALLAS, M.scalars_to_limbs(scalars, PALLAS, "cpu"), pts, c, bits)
    return ec(PALLAS).points_to_ints(JPoint(*(t[None] for t in res)))[0]


def test_radix_msm_equals_oracle_and_classic(radix_route):
    """1024 points, T = 512, c = 8, 8-bit scalars (one window, two tiles).
    40 rows of every tile are crowded into coarse partition 5, so rows spill
    into the classic side path."""
    set_tile, calls = radix_route
    set_tile(512)
    base, host, pts = _tiled_points(1024, 11)
    rng = random.Random(12)
    scalars = [rng.randrange(1 << 8) for _ in range(1024)]
    fb = RX.make_plan(1024, 8, 512).fb
    for t0 in (0, 512):
        for i in rng.sample(range(t0, t0 + 512), 40):
            scalars[i] = (5 << fb) | rng.randrange(1 << fb)
    got = _msm(scalars, pts, 8, 8)
    assert [(p.c, p.T) for p, _, _ in calls] == [(8, 512)]
    assert calls[0][1] > 0 and not calls[0][2]  # rows spilled, no overflow
    assert got == _oracle(base, host, scalars)
    config.RADIX_MSM = False
    assert _msm(scalars, pts, 8, 8) == got
    assert len(calls) == 1  # the classic route did not reorder


def test_radix_msm_overflow_redoes_safe(radix_route):
    """Scalars below 7, one window of c = 8 at T = 256: every valid row of a
    tile lies in coarse partitions 0 and 1, the tile overflows its 128 spill
    rows, the flag is set, and the safe flavor (classic route) gives the
    exact result."""
    set_tile, calls = radix_route
    set_tile(256)
    base, host, pts = _tiled_points(256, 13)
    rng = random.Random(14)
    scalars = [rng.randrange(7) for _ in range(256)]
    got = _msm(scalars, pts, 8, 3)
    assert len(calls) == 1 and calls[0][2]
    assert got == _oracle(base, host, scalars)


def test_radix_msm_split_top(radix_route):
    """c = 9 and 17-bit scalars: two windows, the top one split off at its
    own width c_top = 8, each through the route."""
    set_tile, calls = radix_route
    set_tile(256)
    base, host, pts = _tiled_points(256, 15)
    rng = random.Random(16)
    scalars = [rng.randrange(1 << 17) for _ in range(256)]
    got = _msm(scalars, pts, 9, 17)
    assert [p.c for p, _, _ in calls] == [9, 8]
    assert not any(ov for *_, ov in calls)
    assert got == _oracle(base, host, scalars)


@pytest.mark.parametrize("c,bits,route,widths", [
    (15, 255, True, [15] * 17),         # Pallas's 255-bit bound: c_top = 15, no split
    (15, 254, True, [15] * 16 + [14]),  # scalars promised below 2^254: split at 14
    (15, 254, False, [15] * 17),        # the classic route never splits
    (15, 245, True, [15] * 17),         # c_top = 5 is below the route's 8 bits
    (16, 255, True, [16] * 15 + [15]),
])
def test_split_top_follows_jax_predicate(radix_route, monkeypatch, c, bits, route, widths):
    """The top window's width is the JAX package's: c_top = total_bits -
    (num_windows - 1) * c, split off only where it is narrower than c and
    the route takes both widths (ops/msm.py of the JAX package, split_top).
    The windows are stubbed out, each recording its width, and so is the
    fold's point arithmetic."""
    set_tile, _ = radix_route
    set_tile(256)
    monkeypatch.setattr(config, "RADIX_MSM", route)
    E = ec(PALLAS)
    monkeypatch.setattr(E, "double", lambda p: p)
    monkeypatch.setattr(E, "add", lambda p, q: p)
    made = []

    def window_stub(E_, c_, flavor, pay, n):
        def one_window(keys):
            lead = tuple(keys.shape[:-1])
            made.extend([c_] * (keys[..., 0].numel()))
            return E.identity(lead, "cpu"), torch.zeros(lead, dtype=torch.bool)
        return one_window

    monkeypatch.setattr(M, "_make_one_window", window_stub)
    _, _, pts = _tiled_points(256, 17)
    sc = M.scalars_to_limbs([(1 << 200) + i for i in range(256)], PALLAS, "cpu")
    M._best_multiexp(PALLAS, c, bits, "fast", sc, pts)
    num_windows = -(-bits // c)
    c_top = bits - (num_windows - 1) * c  # the JAX package's formula
    assert made == widths
    assert (made[-1] < c) == (c_top < c and route and c_top >= 8)


def test_radix_route_default_off():
    assert config.RADIX_MSM is False and not config.use_radix_msm()
    assert not M._radix_ok(1 << 20, 15, "fast")


@pytest.mark.parametrize("keys,overflows", [("uniform 12-bit", False), ("below 4", True)])
def test_top_window_crowding_at_2_17(monkeypatch, keys, overflows):
    """At 2^17 points pick_window gives c = 12, and 254-bit scalars leave
    the top window c_top = 254 - 21 * 12 = 2 bits, narrower than the 8 the
    route takes, so it is not split off and runs at c = 12 with keys below
    4.  Those keys all fall in coarse partition 0 (cb = 9, fb = 3) and every
    tile overflows its spill rows; uniform 12-bit keys do not overflow.  The
    plain radix_window on make_plan(2^17, 12); no JAX call."""
    n = 1 << 17
    c = M.pick_window(n)
    bits = 254
    num_windows = -(-bits // c)
    c_top = bits - (num_windows - 1) * c
    monkeypatch.setattr(config, "RADIX_MSM", True)
    assert (c, num_windows, c_top) == (12, 22, 2)
    assert M._radix_ok(n, c, "fast") and not M._radix_ok(n, c_top, "fast")
    plan = RX.make_plan(n, c, M.RADIX_TILE)
    assert (plan.cb, plan.fb) == (9, 3)
    rng = np.random.default_rng(0x217)
    top = 4 if keys == "below 4" else 1 << c
    k = torch.from_numpy(rng.integers(0, top, size=n).astype(np.int32))
    pay = torch.from_numpy(rng.integers(0, 1 << 32, size=(n, 16), dtype=np.uint32).view(np.int32))
    *_, ov = RX.radix_window(plan, k, pay)
    assert bool(ov) == overflows
