"""One job: the model's forward step, every digit round of one scalar
vector through one merge tree.

EagenMSMWitness(EagenConfig(curve, base, N)).forward(digits, points),
ending in a synchronise: the round assembly and carries
(argument._rounds_and_carries: the digit-selected points, their sums by
EC.sum, the carry scan, the slots) and then every round's tree at once
(divisor.compute_divisor_witness_partial on (d, S) slots).  The digits are
set-up, as in the streamed job.

Kept for the check: every job's final carry and every round's closing
point; for the jobs drawn from the seed, every round's slots (the carries
are the first base slots and the last, negated) and every round's witness."""

from __future__ import annotations

import time

import numpy as np
import torch

import inputs
from jobkit import device_points, divisor_check, host, scalar_digits
from reference.check import Counts, Decoder, Expected, check_closing, check_slots, \
    check_witness_shape
from halo2_liam_eagen_msm_tpu_torch import argument as A
from halo2_liam_eagen_msm_tpu_torch import fields
from halo2_liam_eagen_msm_tpu_torch.convert import JPoint
from halo2_liam_eagen_msm_tpu_torch.models import eagen_msm as M


class Job:
    def __init__(self, ctx):
        cfg, mix = ctx.cfg, ctx.mix
        self.ctx = ctx
        curve = getattr(fields, cfg["curve"]["name"].upper())
        self.n, self.base = cfg["num_points"], cfg["base"]
        self.model = M.EagenMSMWitness(M.EagenConfig(curve, self.base, self.n))
        self.d = self.model.cfg.num_digits
        if self.d != cfg["digit_rounds"]:
            raise ValueError(f"the program takes {self.d} digit rounds, the configuration "
                             f"states {cfg['digit_rounds']}")
        self.pts = device_points(ctx, self.n)
        self.words, self.digits = scalar_digits(ctx, self.n, self.base, self.d)
        g = inputs.rng_for(ctx.seed, "sample")
        s_last = self.base + self.n
        self.checked_jobs = set(g.choice(mix["witness_jobs"], size=mix["jobs_checked"],
                                         replace=False).tolist())
        self.slot_idx = np.unique(np.concatenate([
            np.arange(self.base), [s_last],
            g.integers(self.base, s_last, size=mix["slots_per_round"])]))
        self.slot_idx_dev = torch.from_numpy(self.slot_idx).to(ctx.device)
        self.kept, self._pending = {}, {}
        tr = ctx.tracer
        tr.wrap(A, "_rounds_and_carries", "carry_stage", capture=self._keep("slots"))
        tr.wrap(M, "compute_divisor_witness_partial", "tree", capture=self._keep("tree"))

    def _keep(self, what):
        def capture(out):
            self._pending[what] = out
        return capture

    def warm(self) -> None:
        """One forward step and the gather of a checked job's slots: every
        kernel built and loaded, every level's tables made."""
        self.model.forward(self.digits[0], self.pts)
        self._slots()
        self._pending = {}

    def _slots(self) -> JPoint:
        return JPoint(*(c.index_select(1, self.slot_idx_dev)
                        for c in self._pending["slots"][0]))

    def run(self, i: int, rec) -> None:
        carry, wtns = self.model.forward(self.digits[i % len(self.digits)], self.pts)
        outs = self._pending["tree"][1]
        if i in self.checked_jobs:
            self.kept[i] = (carry, outs, self._slots(), wtns)
        else:
            self.kept[i] = (carry, outs, None, None)
        self._pending = {}

    def release(self) -> None:
        for i, (carry, outs, slots, wtns) in list(self.kept.items()):
            self.kept[i] = (host(carry), host(outs),
                            None if slots is None else host(slots),
                            None if wtns is None else (wtns.a.cpu().numpy(),
                                                       wtns.b.cpu().numpy()))
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
            carry, outs, slots, wtns = self.kept[i]
            final = dec.points(*(np.asarray(v).reshape(1, 16) for v in carry))[0]
            c.add("msm_wrong", (final != exp.msm) + (exp.final != exp.msm))
            check_closing(dec, outs, c)
            if slots is not None:
                carry_pos = [j for j, s in enumerate(self.slot_idx)
                             if s < self.base or s == self.base + self.n]
                other = [j for j in range(len(self.slot_idx)) if j not in carry_pos]
                for k in range(self.d):
                    for pos, key in ((carry_pos, "carries_wrong"), (other, "slots_wrong")):
                        check_slots(dec, exp, k, self.slot_idx[pos],
                                    tuple(v[k, pos] for v in slots), c, key)
                    # the witness comes least significant round first
                    a, b = wtns[0][self.d - 1 - k], wtns[1][self.d - 1 - k]
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
