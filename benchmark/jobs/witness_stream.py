"""One job: the streamed witness of one scalar vector, from its digits.

The carry stage (argument._carries_only: ops/msm.round_sums, then the carry
scan), the multiplicity table (precompute_multiplicities, once a job), then
for each of the d digit rounds its slots (argument._one_round_slots) and its
merge tree (divisor.compute_divisor_witness_partial), each round ending in a
synchronise, as compute_lhs_witness_streamed hands rounds to its callback.
The digits are set-up (the harness decomposes the pool in bulk), so this is
compute_lhs_witness_streamed after its host decomposition.

Kept for the check: every job's carries and final carry, every round's
closing point, the slots the mix samples in every round (the carry slots
among them), and the whole witness of the rounds drawn from the seed."""

from __future__ import annotations

import time

import numpy as np
import torch

import inputs
from jobkit import device_points, divisor_check, host, scalar_digits
from reference.check import Counts, Decoder, Expected, check_carries, check_closing, \
    check_slots, check_witness_shape
from halo2_liam_eagen_msm_tpu_torch import argument as A
from halo2_liam_eagen_msm_tpu_torch import divisor as D
from halo2_liam_eagen_msm_tpu_torch import fields
from halo2_liam_eagen_msm_tpu_torch.convert import JPoint
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec


class Job:
    def __init__(self, ctx):
        cfg, mix = ctx.cfg, ctx.mix
        self.ctx = ctx
        self.curve = getattr(fields, cfg["curve"]["name"].upper())
        self.n, self.base = cfg["num_points"], cfg["base"]
        self.d = A.num_digits_for(self.curve, self.base)
        if self.d != cfg["digit_rounds"]:
            raise ValueError(f"the program takes {self.d} digit rounds, the configuration "
                             f"states {cfg['digit_rounds']}")
        self.E = ec(self.curve)
        self.pts = device_points(ctx, self.n)
        self.words, self.digits = scalar_digits(ctx, self.n, self.base, self.d)
        # what the check samples, drawn from the seed
        g = inputs.rng_for(ctx.seed, "sample")
        s_last = self.base + self.n
        self.slot_idx = np.unique(np.concatenate([
            [0, self.base - 1, s_last],
            g.integers(self.base, s_last, size=mix["slots_per_round"])]))
        self.slot_idx_dev = torch.from_numpy(self.slot_idx).to(ctx.device)
        # the whole witness of rounds drawn from the seed, job 0's first and
        # last among them
        pairs = [(0, 0), (0, self.d - 1)] + [
            divmod(int(r), self.d) for r in g.permutation(mix["witness_jobs"] * self.d)]
        self.witness_at = set(list(dict.fromkeys(pairs))[:mix["witness_rounds"]])
        self.kept = {}
        tr = ctx.tracer
        tr.wrap(A, "_carries_only", "carry_stage")
        tr.wrap(A, "precompute_multiplicities", "precompute")
        tr.wrap(A, "_one_round_slots", "round_slots")
        tr.wrap(D, "compute_divisor_witness_partial", "tree")

    def _job(self, digits, on_round, rounds=None):
        curve, base = self.curve, self.base
        prev, new, final = A._carries_only(curve, base, digits, self.pts)
        precomp = A.precompute_multiplicities(self.E, self.pts, base)
        self.ctx.sync()
        t = time.perf_counter()
        for k in (range(self.d) if rounds is None else rounds):
            rp = A._one_round_slots(curve, base, digits[k], precomp,
                                    JPoint(*(c[k] for c in prev)),
                                    JPoint(*(c[k] for c in new)))
            wtns, out = D.compute_divisor_witness_partial(curve, rp)
            self.ctx.sync()
            t2 = time.perf_counter()
            on_round(k, t2 - t, rp, wtns, out)
            t = t2
        return prev, new, final

    def warm(self) -> None:
        """One carry stage and one round with the gather of its sampled
        slots: every kernel built and loaded, every table of the tree's
        levels made."""
        self._job(self.digits[0], lambda k, secs, rp, wtns, out: self._slots(rp),
                  rounds=[self.d // 2])

    def _slots(self, rp) -> JPoint:
        return JPoint(*(c.index_select(0, self.slot_idx_dev) for c in rp))

    def run(self, i: int, rec) -> None:
        outs, slots, wits = [], [], {}

        def on_round(k, secs, rp, wtns, out):
            rec["rounds"].append(secs)
            outs.append(out)
            slots.append(self._slots(rp))
            if (i, k) in self.witness_at:
                wits[k] = wtns

        carries = self._job(self.digits[i % len(self.digits)], on_round)
        self.kept[i] = (carries, outs, slots, wits)

    def release(self) -> None:
        """Move what was kept to the host and drop the program's state."""
        for i, (carries, outs, slots, wits) in list(self.kept.items()):
            prev, new, final = carries
            self.kept[i] = ((host(prev), host(new), host(final)),
                            host(JPoint(*(torch.stack(c) for c in zip(*outs)))),
                            [host(s) for s in slots],
                            {k: (w.a.cpu().numpy(), w.b.cpu().numpy()) for k, w in wits.items()})
        self.digits_host = [d.cpu().numpy() for d in self.digits]
        self.pts = self.digits = self.slot_idx_dev = None

    def check(self, jobs: int):
        A_, B_ = inputs.line_points(self.ctx.curve, self.ctx.seed)
        expected, per_job, witnesses = {}, [], []
        for i in range(jobs):
            c = Counts()
            dec = Decoder(self.ctx.curve, c)
            e = i % len(self.words)
            if e not in expected:
                expected[e] = Expected(self.ctx.curve, A_, B_, self.base, self.words[e],
                                       self.digits_host[e])
            exp = expected[e]
            carries, outs, slots, wits = self.kept[i]
            check_carries(dec, exp, *carries, c)
            check_closing(dec, outs, c)
            for k, got in enumerate(slots):
                check_slots(dec, exp, k, self.slot_idx, got, c)
            for k, (a, b) in wits.items():
                check_witness_shape(dec, exp, k, a, b, c)
                witnesses.append((exp, k, a, b, c))
            per_job.append(c)
        t = time.perf_counter()
        divisor_check(self.ctx, A_, B_, self.base, self.n).check(witnesses)
        self.ctx.log(f"check: {len(witnesses)} witnesses against their divisors in "
                     f"{time.perf_counter() - t:.3f} s")
        counts = Counts()
        for c in per_job:
            counts.merge(c)
        return counts, sum(not c.correct for c in per_job)
