"""The carry stage of Liam Eagen's MSM argument (eprint 2022/596, pp. 8-9).

Counterpart of the JAX package's argument.py: the host helpers, the carry
recurrence over the d digit rounds, the per-round slotted point lists, and
the two witness entry points on top of the divisor merge tree
(compute_lhs_witness, all rounds batched, and compute_lhs_witness_streamed,
one round at a time, the production-scale path).

Semantics preserved exactly (digit streams, carry recurrence, per-round point
multisets, final carry == MSM result):

  * scalars below sqrt(p) are decomposed in radix -base into d digits
    (negbase.negbase_decompose_batch); round k, msb first, sums the points
    weighted by their k-th digits: S_k = sum_j digits[k, j] * P_j
  * the carry folds the rounds: carry' = -base * carry + S_k, from the
    identity; the final carry equals sum_j s_j * P_j
  * a round's point list has FIXED SLOTS: base slots of -carry_prev, N digit
    slots, one closing slot -carry_new, with identity where a digit is zero

Entry points take the device from their tensors.
"""

from __future__ import annotations

import math

import torch

from .convert import RF, JPoint, digits_to_rounds, limbs_from_numpy
from .divisor import compute_divisor_witness_partial
from .fields import CurveSpec, FieldSpec
from .limbs import ints_to_limbs
from .negbase import negbase_decompose_batch
from .ops.ec import EC, ec
from .ops.msm import round_sums


# ---------------------------------------------------------------- host utils

def order(spec: FieldSpec) -> int:
    """Field modulus."""
    return spec.p


def logb_ceil(x: int, base: int) -> int:
    """Count of base-divisions to reach 0."""
    i = 0
    while x > 0:
        x //= base
        i += 1
    return i


def num_digits_for(curve: CurveSpec, base: int) -> int:
    """d = logb_ceil(sqrt(p) + 2, base) + 1."""
    sq_p = math.isqrt(order(curve.scalar_field)) + 2
    return logb_ceil(sq_p, base) + 1


def gen_random_coeff(rng, spec: FieldSpec) -> int:
    """Random scalar < sqrt(p) from a `random.Random`."""
    return rng.randrange(math.isqrt(spec.p))


def felt_from_u64(spec: FieldSpec, x: int, device="cuda"):
    """u64 -> (16,) canonical field element limbs on `device`."""
    if not 0 <= x < (1 << 64):
        raise ValueError("felt_from_u64: x must fit 64 bits")
    return limbs_from_numpy(ints_to_limbs([x % spec.p])[0], device)


# ------------------------------------------------------------- device pieces

def _stack(parts) -> JPoint:
    return JPoint(*(torch.stack([p[k] for p in parts]) for k in range(3)))


def _at(p: JPoint, k) -> JPoint:
    return JPoint(*(c[k] for c in p))


def precompute_multiplicities(E: EC, pts: JPoint, base: int) -> JPoint:
    """Multiplicities 1*P .. (base-1)*P per point by repeated addition.
    pts: (N,) -> (base-1, N) stacked JPoint."""
    mults = [pts]
    for _ in range(base - 2):
        mults.append(E.add(mults[-1], pts))
    return _stack(mults)


def _select_digit_points(precomp: JPoint, digits) -> JPoint:
    """Digit-selected points: slot (.., j) holds digits[.., j] * P_j, the
    identity (z = 0) where the digit is zero.  precomp: (base-1, N);
    digits: (..., N)."""
    idx = (digits.to(torch.int64) - 1).clamp(0, precomp.x.shape[0] - 1)
    cols = torch.arange(digits.shape[-1], device=digits.device)
    x, y, z = (c[idx, cols] for c in precomp)
    return JPoint(x, y, torch.where((digits == 0)[..., None], torch.zeros_like(z), z))


def _carry_scan(curve: CurveSpec, base: int, sx, sy, sz):
    """Fold the (d,) round sums through carry' = -carry*base + S_i.  Cheap:
    d ~ 56 points, one after another.  Returns (carry_prev (d,), carry_new
    (d,), final)."""
    E = ec(curve)
    carry = E.identity((), sx.device)
    prev, new = [], []
    for k in range(sx.shape[0]):
        prev.append(carry)
        carry = E.add(E.scalar_mul_small(E.neg(carry), base),
                      JPoint(sx[k], sy[k], sz[k]))
        new.append(carry)
    return _stack(prev), _stack(new), carry


def _carries_only(curve: CurveSpec, base: int, digits, pts: JPoint):
    """Carry recurrence WITHOUT materializing the (d, S) slot tensor: the
    production-scale path.  Each per-round digit sum is ONE Pippenger window
    (ops/msm.round_sums: sort + blinded prefix scan + bucket differences)
    instead of an N-point complete-add tree.
    Returns (carry_prev (d,), carry_new (d,), final)."""
    s_round = round_sums(curve, base, digits, pts)
    return _carry_scan(curve, base, *s_round)


def _slots(base: int, carry_prev: JPoint, sel: JPoint, carry_new: JPoint,
           E: EC) -> JPoint:
    """[base x (-carry_prev)] + digit slots + [-carry_new] along the slot axis
    (-2).  Where carry_prev is the identity its slots are identities too:
    -identity IS the identity."""
    neg_prev, neg_new = E.neg(carry_prev), E.neg(carry_new)
    return JPoint(*(
        torch.cat([p.unsqueeze(-2).expand(p.shape[:-1] + (base, p.shape[-1])), s,
                   n.unsqueeze(-2)], dim=-2)
        for p, s, n in zip(neg_prev, sel, neg_new)))


def _rounds_and_carries(curve: CurveSpec, base: int, digits, pts: JPoint):
    """Given digits (d, N) int32 (msb-first rounds) and pts (N,), build the
    per-round slotted point tensors (d, S), S = base + N + 1, and the carry
    sequence, with the round sums taken by gather and batched point sums (an
    independent second way to the carries at small N).

    Returns (round_pts: JPoint (d, S), final_carry: JPoint)."""
    E = ec(curve)
    sel = _select_digit_points(precompute_multiplicities(E, pts, base), digits)
    s_round = E.sum(sel, axis=1)  # (d,) JPoint
    carry_prev, carry_new, final = _carry_scan(curve, base, *s_round)
    return _slots(base, carry_prev, sel, carry_new, E), final


def _one_round_slots(curve: CurveSpec, base: int, digits_k, precomp: JPoint,
                     carry_prev: JPoint, carry_new: JPoint) -> JPoint:
    """One round's slotted point list (S,): the streaming counterpart of
    _rounds_and_carries' assembly, identical slot semantics.  precomp:
    (base-1, N) multiplicity table, computed once by the caller."""
    return _slots(base, carry_prev, _select_digit_points(precomp, digits_k),
                  carry_new, ec(curve))


# ------------------------------------------------------------- entry points

def _msb_rounds(curve: CurveSpec, scalars, n: int, base: int, device):
    """Range-check the scalars and decompose them: (d, N) int32 msb-first
    digit rounds on `device`."""
    if len(scalars) != n:
        raise ValueError(f"incompatible amount of coefficients: {len(scalars)} for {n} points")
    sq_p = math.isqrt(order(curve.scalar_field)) + 2
    if any(not 0 <= s < sq_p for s in scalars):
        raise ValueError("scalar out of range [0, sqrt(q) + 2)")
    d = num_digits_for(curve, base)
    return digits_to_rounds(negbase_decompose_batch(ints_to_limbs(scalars), base, d), device)


def compute_lhs_witness_streamed(curve: CurveSpec, scalars, pts: JPoint, base: int,
                                 round_callback):
    """The production-scale compute_lhs_witness: the d digit rounds are
    computed ONE AT A TIME (peak memory is one round's merge tree), each
    handed to round_callback(k, wtns_k, out_k), msb-first (the reference's
    order before its final reversal).  The carries come from the carry stage
    (_carries_only); round k's slots from _one_round_slots.  Returns the
    final carry (= sum_i s_i P_i).  pts: (N,) JPoint; the device is theirs."""
    E = ec(curve)
    rounds = _msb_rounds(curve, scalars, pts.x.shape[0], base, pts.x.device)
    carry_prev, carry_new, final = _carries_only(curve, base, rounds, pts)
    precomp = precompute_multiplicities(E, pts, base)
    for k in range(rounds.shape[0]):
        rp = _one_round_slots(curve, base, rounds[k], precomp,
                              _at(carry_prev, k), _at(carry_new, k))
        wtns_k, out_k = compute_divisor_witness_partial(curve, rp)
        round_callback(k, wtns_k, out_k)
    return final


def compute_lhs_witness(curve: CurveSpec, scalars, pts: JPoint, base: int):
    """The core function: per digit round, the regular function witnessing
    the LHS of Eagen's argument, all rounds batched through one merge tree.
    scalars: host ints in [0, sqrt(q) + 2); pts: (N,) JPoint.

    Returns (carry, witness, round_pts): witness is an RF with leading dim d,
    LSB round first as the reference returns it (round_pts stays msb-first);
    raises if a round does not close to the identity."""
    rounds = _msb_rounds(curve, scalars, pts.x.shape[0], base, pts.x.device)
    round_pts, carry = _rounds_and_carries(curve, base, rounds, pts)
    wtns, outs = compute_divisor_witness_partial(curve, round_pts)
    if not bool(ec(curve).is_identity(outs).all()):
        raise AssertionError("divisor round does not close to the identity")
    return carry, RF(wtns.a.flip(0), wtns.b.flip(0)), round_pts
