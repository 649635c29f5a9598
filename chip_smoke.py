#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and the sources of this checkout; exits non-zero
without a card, and on any failed build, failed launch or mismatch.  It

  1. prints the card's name and power limit (nvidia-smi),
  2. builds the kernel library from halo2_liam_eagen_msm_tpu_torch/ops/csrc/,
  3. holds each of the ten field and curve kernels against its plain
     PyTorch version on the card: torch.equal on every output (integer
     arithmetic, tolerance zero), on seeded inputs with edge lanes, at a
     ragged size and at the shape its path gives it, and times both there
     (ec_madd_xyzz_fast's scan at (g, w) = (ragged, 1), (2048, 32), (64, 1)
     and the stepwise scan's of the widest window below
     FUSED_SCAN_MIN_ROWS, (64, 2), the only shape a card path launches it
     with, and against running sums on Python ints too;
     batch_inv at 2^21 rows, the lm tail's width at the top level, and at
     the ragged size against FF._inv_host too; ec_double one doubling,
     ec_add_mixed one step),
  4. drives the MSM path: best_multiexp on the Pallas curve at 2^20 points
     with full-width scalars (64 random base points tiled, as the headline
     benchmark makes them), checks the result against the exact Python-int
     oracle, and checks that each of its six kernels was launched in that run,
  5. drives the carry stage of the argument at the same 2^20 points: scalars
     below sqrt(q), base 5, 56 digit rounds decomposed on the host, then
     argument._carries_only on the card; the final carry must equal the
     Python-int oracle and the port's own best_multiexp, every round's carry
     must satisfy the host recurrence, and no round may be flagged,
  6. drives the exception fallback on the card: round_sums with -T placed
     so that exactly one round is flagged and recomputed with complete adds,
     exact in every round, at 2^14 points (the fused scan flags) and at half
     of ops/msm.FUSED_SCAN_MIN_ROWS (the stepwise scan flags), so that
     ec_madd_xyzz_fast and ec_add_mixed are both launched, the scan's kernel
     once a round's window and ec_add_mixed once for the recomputed round's
     window scan; then best_multiexp at n = 16 (safe flavor) against the
     oracle,
  6b. drives best_multiexp's safe flavor on the MSM phase's 2^logn inputs:
     the oracle's result, one ec_add_mixed launch (the window's whole scan)
     and one ec_double launch (c doublings) a window; seconds of three runs
     and the device's busy time of one,
  7. times one window by the fused and the stepwise scan at 2^6 to 2^16
     points, on the host clock and as the device's busy time (torch.profiler),
     and requires equal window sums and one launch of each route's scan
     kernel a window,
  8. holds the divisor merge tree's five limb-major kernels (ops/csrc/ntt.cuh)
     against their plain versions at a ragged size and at the shapes one
     round gives them, runs a 2^21 transform forward and back (n x back), and
     the limb-major forward transform against the element-major one,
  8a. holds stages_small's 1-bit window (R = 1; the path takes it at a tile
     of 2 alone) against the plain stages at every tile from 2 to 1024,
     forward and inverse, one launch each through the test-only launcher, in
     a child process under a time limit (utils/probe_stages_small_r1): a
     hang, a fault or a mismatch fails the run,
  8b. holds the product by a constant on the tensor cores (ops/mxu_ff.py,
     csrc/mxu.cuh; no path calls it) against its plain version limb for
     limb: mxu_mul_const at 2^logn rows and at a ragged 5,003, by a random
     constant and by 0, 1 and p - 1 (Montgomery forms), the rows 0, 1 and
     p - 1 among the inputs, and 64 rows against FF.mul (mont_mul) by the
     constant broadcast; mxu_mul_table at the NTT stage's shape (2^(logn -
     logn / 2) rows at each of 2^(logn / 2) positions) and at a ragged
     (5, 8), the table holding 0 and 1; and times, in turns, the kernel,
     mont_mul by the constant materialised as rows and by the broadcast
     view (_flatten's copy inside the time) and lm_mul_const at E = 2^logn
     (the constant by value, limb-major), each beside its bound, the plain
     version on the host clock,
  9. drives one full-width round of the argument's witness: round 28 of the
     carry stage's 2^20 points (1,048,582 slots, 20 merge levels, 15 of them
     fused) through compute_divisor_witness_partial on the card; the output
     must be the identity, the witness must vanish at 64 sampled slots (on
     the card, and at two of them by Python-int Horner on the host), no level
     may take the coefficient fallback, each of the five kernels must have
     been launched as counted, poly_mul_naive ten times and kate_div2 twice
     a coefficient level (kate_div not at all), affine_lines once a level
     (the seeds and every merge) and mont_mul not at all,
  9b. tallies the launches of mont_mul and mont_addsub by B (rows a launch)
     and caller (the nearest frame outside the field layer), of ec_add and
     ec_add_fast by B, of ec_double by (B, doublings k), of batch_inv by
     (rows, chain length),
     of poly_mul_naive, kate_div and kate_div2 by shape, of affine_lines by
     (B, mode),
     of stages_small by (E, tile, direction, transform size) and of
     fused_madd_scan_xyzz by (g, W) over one MSM, one carry stage and one
     round (one ec_double launch a window of the MSM and a round of the
     carry stage: checked), and reads the device's busy time and device
     events (kernels, copies, fills) of one MSM and one carry stage; holds
     mont_mul, mont_addsub and ec_add_fast against
     their plain
     versions bit for bit, with edge lanes (the carry edges of a row;
     identities, P + P, P + (-P)), at every B the tally gives them
     (mont_addsub and ec_add_fast at the kernel phase's shape and the ragged
     size too) and times them there; holds ec_double (four lanes a point, k
     doublings a launch) against its plain version and the Python-int oracle
     at every (B, k) the tally gives it and at B = 1, k = 1, 2 and 15, and
     times it there; holds ec_add_mixed's window scan (two lanes a carry, w
     steps a launch) against its plain version (the loop of w plain steps)
     at a safe 2^logn window's scan (g = 2^logn / 64 lanes, w = 64 steps:
     identity carries at every lane's head, q == carry, q == -carry and
     affine identities planted) and at one step of it, first lanes against
     the Python-int oracle, and times it there; holds ec_madd_xyzz_fast's
     scan (four lanes a carry, w steps a launch) at (g, w) = (64, 2), the
     fallback's, and (2048, 32), a 2^16 window's, against its plain version,
     flags included, and times it in turns with the fused scan's
     kernel at the same (g, w) (two lanes a carry, the same formula: lines
     `A/B ec_madd_xyzz_fast at g = ...`); holds poly_mul_naive at every shape the tally
     gives it against its plain version and the Python-int Poly, with edge
     pairs (raw p - 1 everywhere, zero terms), and times it there; holds
     kate_div2 at every shape the tally gives it against its plain version,
     against its first design's route (kate_div launched twice) and the
     Python-int Poly, with edge pairs (raw p - 1 everywhere, ra = 0, rb =
     0, ra = rb, zero terms), and times the two in turns there, at one pair
     too (one chain's latency; lines `A/B kate_div2 at ...`); holds
     affine_lines (two lanes a slot) against its plain version and its
     first design (affine_lines_v1) at every width the tally gives it, head
     and seeds, on the round's own inputs and the edge slots of curve_inputs
     (identities, P = P, P = -P), and times the two in turns there (lines
     `A/B affine_lines at ...`); then
     holds the kernels redesigned before against their plain versions bit
     for bit and times them at every shape the tally gives them: ec_add at
     every B (and 2048), stages_small forward and inverse at every (E,
     tile) (and the fused levels' (n, E) = (2^7, 2^20), (2^9, 2^20), (2^10,
     2^20), (2^21, 2^21)), batch_inv at every (rows, chain length) (and n =
     33, 512, 700, 2^16 and 2^21 rows), zeros planted, against
     FF._inv_host too, the fused scan at every g the tally gives it (and g =
     256 and 4096); and ranks the sixteen kernels that rule 2 covers by
     launches x (device ms - bound) over the main path (one MSM, one carry
     stage and 56 rounds like the tallied one; ec_add_mixed, radix_rank,
     radix_pass_b and the first designs kate_div and affine_lines_v1 with
     no launch there, and their loss on their own paths on
     lines of their own: ec_add_mixed's over phase 6b's safe MSM, the radix
     kernels' over a radix-route MSM after phase 13),
  9c. holds poly_mul_naive, kate_div2 and kate_div against their plain
     versions at a ragged shape and at the round's shape of the most
     products (kate_div2's), and affine_lines and affine_lines_v1 at a
     ragged width and the widest of the round (the records of the JSON
     line),
 10. drives one round of the witness at a cut width, 2^10 points, on the card
     and on the CPU (plain versions): the carries' final carry equal to the
     Python-int oracle, round 28 closing on both and equal limb for limb,
 11. drives the exact fallback of a fused level on the card (128 points whose
     two halves are equal: a degenerate line) against the CPU result,
 12. holds the radix reorder's four kernels (ops/csrc/radix.cuh) against their
     plain versions (torch.equal) at a ragged plan (three tiles of 768 rows,
     the first overflowing its spill rows, the second spilling some) and at
     the plan of a 2^20, c = 15 window, and times shuffle and compact there
     beside the one PyTorch call that does the shuffle's scatter
     (index_copy_) and the compaction's gather (index_select); then holds
     radix_rank and radix_pass_b (warp-vote ranks) against the plain
     versions at those plans and at the 2^20 plan of the split top window
     (c = 14) and the 2^17, c = 12 plan on uniform keys and on phase 15's
     keys (every row in coarse partition 0), and times them at each, with
     their shares of the bound; radix_pass_b also at R on both sides of its
     stash's limit (its fine ids kept in shared memory, then read again
     from the rows),
 13. drives the radix route of the MSM (config.RADIX_MSM): best_multiexp at
     2^20 Pallas points (2^17 with a smaller --logn: the route's least),
     full-width scalars below q (all below 2^254, so max_scalar_bits = 254),
     against the Python-int oracle and the classic route, each radix kernel
     launched once a window; seconds, device busy time, peak memory and
     launches of both routes, the spilled rows of every window.  What the route must do follows the predicate that both
     packages share: at 2^20, c = 15, the top window is split off at 14
     bits, and no window overflows and the flag stays clear; at 2^17, c =
     12, the top window's 2 bits are too narrow to split off, it runs at c
     = 12 with keys below 4, every tile overflows, and the flag must be set
     and the safe redo exact.  Then once at the default bound of 255 bits,
     where the top window is not split off, overflows every tile, and the
     safe redo gives the exact result,
 14. times one 2^20, c = 15 window by both routes, the reorder alone (radix
     reorder against sort + gather + histogram) and the whole window, on the host clock and as the
     device's busy time; one reorder launches each radix kernel once,
 15. drives the radix route's overflow on the card: 2^17 points, scalars
     below 7 (one window, c = 12, every row in coarse partition 0): every tile
     overflows, each radix kernel is launched once, the flag is set, and the
     safe redo is exact,
 16. drives the curve layer's entry point EC.add_mixed_fast (kernel 9) on 2^20
     lanes: carries from EC.scalar_mul_small, affine points, an identity
     carry, an affine identity and carry == +-Q planted; exactly those flagged
     that should be, unflagged lanes equal to EC.add_mixed (complete) as
     affine points, 64 sampled lanes equal to the Python-int oracle, and
     EC.projective_coords there equal to the Python-int change of
     coordinates; the call is one launch of ec_add_mixed_fast and no PyTorch
     op around it launches a kernel (no flag conversion), its flags the bool
     tensor the kernel wrote,
 17. drives the naive line arrangement (compute_divisor_witness_naive_device)
     on the round phase's 1,048,582 slots and holds it against the round's
     merge-tree witness f by the ratio check: both have the divisor
     sum [P_i] - n[O], so f(R1) P(R2) N(R1) == f(R2) P(R1) N(R2) at two random
     points, P and N the products of the pos and neg line values (a tree of
     mont_mul, no inversion); then at 2^12 points the card's lines equal the
     host replica's,
 18. drives BASELINE config 4 whole: compute_lhs_witness_streamed at the
     carry phase's 2^20 points and scalars, base 5, all 56 rounds: the final
     carry equal to the carry phase's and the oracle, every round closing,
     round 28 equal to the round phase's witness limb for limb; seconds whole,
     a round, of the host decomposition; peak; the device's busy time over
     three rounds,
 19. drives the model: EagenMSMWitness at 2^16 points with all 56 rounds
     batched through one merge tree (carry against the oracle, every round's
     slots summing to the identity, the first and last round's witness equal
     to a single-round computation), and entry()'s fn on the card against the
     same fn on the CPU,
 20. holds the port's host oracles against the card: the C++ oracle
     (oracle/, built with g++ into build/; its seconds printed) against
     FF.mul, FF.add and FF.inv (one launch each of mont_mul, mont_addsub and
     batch_inv) on 2^16 seeded values with 0, 1 and p - 1 among them, as
     canonical ints; against best_multiexp at 2^12 distinct points (an
     identity among them) with full-width scalars (0, 1 and q - 1 among
     them); the merge tree at 2^12
     closing points with identities sprinkled in against the C++ witness and
     the port's ref_divisor, coefficient for coefficient; and the tree on
     the golden vectors' points (data/golden_divisor_*.json; Pallas and
     Grumpkin, 12 points each) against the golden witness times one nonzero
     scalar (the coefficient convention's), after rustsem has reproduced the
     golden witness exactly,
 21. drives the circuit: Params of 64 Pallas points (base 5) that
     params_check accepts, synthesize.assemble on scalars of 55 random digits
     in base -5 (below sqrt(q); every round has points), the checker
     finding every gate vanishing on every row; every round's slot
     list (host_round_slots) through the merge tree on the card, its a||b
     coefficients equal to that round's stream in the a column; the carry
     equal to best_multiexp on the card on the same points and scalars;
     seconds of the assembly and of the card's rounds,
 22. drives the sharded paths (parallel/) through launch.run_world, the
     kernel library built here first so that the ranks only load it, each
     result held against its single-device counterpart or oracle: (a) one
     NCCL rank on cuda:0 (tensors never leave the card): sharded_msm at
     2^logn against the Python-int oracle, points_sharded_divisor_witness_a2a
     at 2^12 closing points, both flavors, against the single-device tree;
     (b) four gloo ranks, every one on cuda:0, the collectives' payloads
     staged through host memory: sharded_msm and sharded_msm_2d (2 x 2) at
     2^logn on phase 4's inputs against the oracle; sharded_divisor_witness
     on rounds 0, 27, 28 and 55 of phase 5's carry stage, one a rank, every
     round closing and round 28's witness equal to phase 9's bit for bit;
     points_sharded_divisor_witness and _a2a (both flavors) on 2^logn
     closing points against the single-device tree, no rerun taken;
     hierarchical_divisor_witness (2 x 2) on two rounds of 2^16 points
     padded to 2^17 slots against the single-device tree; the a2a witness on
     points with a root on the evaluation domain, every rank taking the
     replicated rerun, exact; each part's D, backend, sizes, seconds, bytes
     sent a rank by collective kind and peak memory printed.  Four ranks
     time-share one card: the seconds say nothing about scaling,
 23. prints one JSON line describing the kernels (with phase 9b's shapes
     and the rule-2 ranking; phase 8b's two, which no path launches, and the
     first designs kept for one A/B (kate_div, affine_lines_v1), with no
     launch on any path, which is checked) and, last, one JSON line {"ok":
     true, "device": {...}}.

Phases 16-19 run after the radix phases, on the round's (phase 9) slots and
witness and the carry stage's inputs, which are kept alive until then.
--logn 16 makes the MSM, the carry stage and the rounds smaller: a quick
run of every phase.

Each kernel's bound is the least time the card could take for the same work:
the larger of bytes moved (each input read once, each output written once)
over 3.35 TB/s, and 32-bit integer operations over 33.5 TOP/s.  The card's
data sheet states no int32 rate; an SM has 64 int32 lanes beside its 128
float32 lanes, so the rate is taken as half the 67 TFLOP/s float32 figure
(one multiply-add = 2 operations).  A field product counts 136 multiply-adds
(8x8 for a*b, 8x8 for m*p, 8 for m), a field add/sub 8 word additions.
A butterfly stage counts half a product and one add/sub an element, and its
twiddles (s rows for a stage of half-size s) once.  batch_inv counts what
any batch inversion of this run's n rows needs, whatever the kernel's chain
length: the Montgomery trick's 3 (n - 1) products and one power of p - 2
(cuda_ff.pow_products), one row read and one written.  poly_mul_naive counts
La Lb products and La Lb - (La + Lb - 1) adds a pair, kate_div n - 1 of each,
kate_div2 2 (n - 1) of each; each input row once (a shared operand once for
all pairs; kate_div2's two roots a pair) and each output row once.
affine_lines counts 10 products and 5 subtractions a slot (two normalisations, two negations and a line, whose products by a Z of 0
or 1 are selects) and 6 products and 3 subtractions more a degenerate slot
(the third point and the second line), its 9 input rows and 7 (head) or 3
(seeds) output rows and 2 flag bytes a slot.  The radix kernels move data and count: their bound is
their bytes alone, from this run's inputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import random
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from halo2_liam_eagen_msm_tpu_torch import argument as A
from halo2_liam_eagen_msm_tpu_torch import config
from halo2_liam_eagen_msm_tpu_torch import divisor as D
from halo2_liam_eagen_msm_tpu_torch import oracle
from halo2_liam_eagen_msm_tpu_torch.circuit.params import Params, params_check
from halo2_liam_eagen_msm_tpu_torch.circuit.synthesize import (
    assemble, host_round_polys, host_round_slots)
from halo2_liam_eagen_msm_tpu_torch.convert import (
    RF, JPoint, digits_to_rounds, limbs_from_numpy, limbs_to_numpy)
from halo2_liam_eagen_msm_tpu_torch.fields import GRUMPKIN, LIMB_BITS, N_LIMBS, PALLAS
from halo2_liam_eagen_msm_tpu_torch.entry import entry
from halo2_liam_eagen_msm_tpu_torch.limbs import (
    ints_to_limbs, ints_to_mont_limbs, limbs_to_ints, mont_limbs_to_ints)
from halo2_liam_eagen_msm_tpu_torch.models.eagen_msm import EagenConfig, EagenMSMWitness
from halo2_liam_eagen_msm_tpu_torch.negbase import negbase_decompose_batch, negbase_recompose
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_lines as CL
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ntt as CN
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_poly as CP
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_radix as CR
from halo2_liam_eagen_msm_tpu_torch.ops import msm as M
from halo2_liam_eagen_msm_tpu_torch.ops import mxu_ff as MX
from halo2_liam_eagen_msm_tpu_torch.ops import ntt as NTT
from halo2_liam_eagen_msm_tpu_torch.ops import poly as P
from halo2_liam_eagen_msm_tpu_torch.ops import radix as RX
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.ops.ff import ff
from halo2_liam_eagen_msm_tpu_torch.ops.poly import Poly as PolyInts
from halo2_liam_eagen_msm_tpu_torch.parallel import mesh as PM
from halo2_liam_eagen_msm_tpu_torch.parallel.launch import run_world
from halo2_liam_eagen_msm_tpu_torch.utils import probe_stages_small_r1 as R1
from halo2_liam_eagen_msm_tpu_torch.utils import pyref, ref_divisor, rustsem

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
MUL_OPS = 2 * 136   # one field product, as operations
ADD_OPS = 8         # one field add/sub/double
ROW_BYTES = 4 * N_LIMBS
SPIN_CYCLES_PER_S = 2.0e9  # upper estimate of the card's clock, for the spin kernel

CSRC = "halo2_liam_eagen_msm_tpu_torch/ops/csrc/"
PALLAS_FF = "halo2_liam_eagen_msm_tpu/ops/pallas_ff.py"
PALLAS_NTT = "halo2_liam_eagen_msm_tpu/ops/pallas_ntt.py"
RADIX_PY = "halo2_liam_eagen_msm_tpu/ops/radix.py"
MXU_FF = "halo2_liam_eagen_msm_tpu/ops/mxu_ff.py"
# kernel -> (source, TPU kernel's file, line of its function, field products,
#            field adds, rows read + written per element; per stage for
#            stages_small; the radix kernels' bytes come as extra bytes)
KERNEL_TABLE = {
    "mont_mul": ("kernels.cu", PALLAS_FF, 515, 1, 0, 3),
    "batch_inv": ("kernels.cu", PALLAS_FF, 515, None, 0, 2),  # products: from the run
    "mont_addsub": ("kernels.cu", PALLAS_FF, 541, 0, 1, 3),
    "ec_add": ("kernels.cu", PALLAS_FF, 568, 23, 21, 9),
    "ec_add_fast": ("kernels.cu", PALLAS_FF, 630, 16, 7, 9),
    "ec_double": ("kernels.cu", PALLAS_FF, 832, 7, 14, 6),             # a doubling: k stages
    "fused_madd_scan_xyzz": ("kernels.cu", PALLAS_FF, 740, 10, 7, 5),  # per packed row: 1 in, 4 out
    # a step: 2 in, 4 out; a carry's 4 in (+ 4 totals out where w > 1, + 1 flag
    # byte): xyzz_bound
    "ec_madd_xyzz_fast": ("kernels.cu", PALLAS_FF, 699, 10, 7, 6),
    # a step: 2 in, 3 out (+ 1 mask byte); a lane's carry 3 in (+ 3 totals out);
    # madd-2007-bl's products and adds, the doubling's where the data takes it
    # (mixed_bound)
    "ec_add_mixed": ("kernels.cu", PALLAS_FF, 599, 11, 7, 5),
    "ec_add_mixed_fast": ("kernels.cu", PALLAS_FF, 664, 11, 7, 8),     # 5 in, 3 out (+ 1 flag byte)
    "lm_mul": ("ntt.cuh", PALLAS_NTT, 121, 1, 0, 3),
    "lm_addsub": ("ntt.cuh", PALLAS_NTT, 136, 0, 1, 3),
    "lm_mul_const": ("ntt.cuh", PALLAS_NTT, 152, 1, 0, 2),
    "stage_big": ("ntt.cuh", PALLAS_NTT, 186, 0.5, 1, 2),      # + the stage's s twiddle rows
    "stages_small": ("ntt.cuh", PALLAS_NTT, 255, 0.5, 1, 2),   # products, adds per stage
    "radix_rank": ("radix.cuh", RADIX_PY, 235, 0, 0, 0),
    "radix_shuffle": ("radix.cuh", RADIX_PY, 270, 0, 0, 0),
    "radix_pass_b": ("radix.cuh", RADIX_PY, 363, 0, 0, 0),
    "radix_compact": ("radix.cuh", RADIX_PY, 421, 0, 0, 0),
    # mont_mul (and mont_addsub) at the coefficient levels' shapes: products,
    # adds and rows from the shape (mul_naive_bound, kate_div_bound)
    "poly_mul_naive": ("poly.cuh", PALLAS_FF, 515, None, None, 0),
    "kate_div": ("poly.cuh", PALLAS_FF, 515, None, None, 0),
    "kate_div2": ("poly.cuh", PALLAS_FF, 515, None, None, 0),
    # and at the merge head's: products from the run's slots (lines_bound)
    "affine_lines": ("lines.cuh", PALLAS_FF, 515, None, None, 0),
    "affine_lines_v1": ("lines.cuh", PALLAS_FF, 515, None, None, 0),
    # the product by a constant on the tensor cores (no TPU kernel: the JAX
    # module's mul_const and mul_table); a row in and one out (mul_table: and
    # its position's table row once), no field product or add on the int32
    # pipes: its operations are tensor-core ones and the carries' (mxu_bound)
    "mxu_mul_const": ("mxu.cuh", MXU_FF, 89, 0, 0, 2),
    "mxu_mul_table": ("mxu.cuh", MXU_FF, 114, 0, 0, 2),
}
MSM_KERNELS = ("mont_mul", "batch_inv", "mont_addsub", "ec_add", "ec_add_fast",
               "ec_double", "fused_madd_scan_xyzz")
PR6_ROUND_MONT_MUL = 16154  # a round's mont_mul launches before batch_inv
FALLBACK_KERNELS = ("ec_madd_xyzz_fast", "ec_add_mixed")
ROUND_KERNELS = ("lm_mul", "lm_addsub", "lm_mul_const", "stage_big", "stages_small")
# the coefficient levels' two, and their launches a coefficient level (rf_mul
# twice: five schoolbook products each; kate_div2 once for a, once for b)
POLY_KERNELS = ("poly_mul_naive", "kate_div2")
POLY_PER_LEVEL = {"poly_mul_naive": 10, "kate_div2": 2}
RADIX_KERNELS = ("radix_rank", "radix_shuffle", "radix_pass_b", "radix_compact")
OFF_PATH = ("mxu_mul_const", "mxu_mul_table")  # kernels no path launches (phase 8b's)
# first designs kept for one A/B, launched by no path: kate_div (twice, the
# route kate_div2 replaced; poly.kate_div keeps it for other callers) and
# affine_lines_v1
FIRST_DESIGNS = ("kate_div", "affine_lines_v1")
R1_TIMEOUT_S = 180  # phase 8a's child process, start-up included
ROUND_K = 28  # the round of the carry stage the round phase takes (= d // 2)
BASE = 5  # radix of the argument's digit rounds
CURVE = PALLAS
SPEC = PALLAS.field


class Failure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)
    print(f"  ok   {what}", flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(dev, fn, reps: int):
    """(device ms, call ms) of fn(), each a mean over `reps` calls after one
    warm-up.  Call ms is the host clock around back-to-back calls, so it
    includes the wrapper's own work.  Device ms is taken with CUDA events
    while a spin kernel holds the card busy until every call is enqueued, so
    the launches run back to back and the host's pace drops out.  Off the
    card (a rehearsal) both are the host clock."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    call_ms = (time.perf_counter() - t0) * 1e3 / reps
    if dev.type != "cuda":
        return call_ms, call_ms
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin for about twice as long as the host needs to enqueue the calls
    torch.cuda._sleep(int(2 * reps * call_ms * 1e-3 * SPIN_CYCLES_PER_S) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps, call_ms


def bound_ms(name: str, elems: int, extra_bytes: int = 0, stages: int = 1, muls=None,
             adds=None):
    *_, table_muls, table_adds, rows = KERNEL_TABLE[name]
    muls = table_muls if muls is None else muls
    adds = table_adds if adds is None else adds
    t_bytes = (elems * rows * ROW_BYTES + extra_bytes) / HBM_BYTES_PER_S
    t_ops = stages * elems * (muls * MUL_OPS + adds * ADD_OPS) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mixed_doublings(x1, y1, z1, qx, qy) -> int:
    """Rows at which ec_add_mixed computes the doubling of its carry (x1, y1,
    z1) besides the sum: h == 0 and r == 0 of madd-2007-bl (qx Z1^2 == X1 and
    qy Z1^3 == Y1), by the plain field ops."""
    def mul(a, b):
        return CF.mont_mul_plain(SPEC, a, b)

    def is_zero(a):
        return (a == 0).all(dim=-1)

    zz = mul(z1, z1)
    h0 = is_zero(CF.mont_addsub_plain(SPEC, True, mul(qx, zz), x1))
    r0 = is_zero(CF.mont_addsub_plain(SPEC, True, mul(qy, mul(z1, zz)), y1))
    return int((h0 & r0).sum())


def mixed_bound(rows: int, doublings: int, extra_bytes: int):
    """bound_ms of ec_add_mixed over rows steps: madd-2007-bl's products and
    adds at every step, and ec_double's at the steps where this run's data
    takes the doubling (doublings of them, from mixed_doublings)."""
    muls, adds = KERNEL_TABLE["ec_add_mixed"][3:5]
    d_muls, d_adds = KERNEL_TABLE["ec_double"][3:5]
    return bound_ms("ec_add_mixed", rows, extra_bytes, muls=muls + d_muls * doublings / rows,
                    adds=adds + d_adds * doublings / rows)


def xyzz_bound(g: int, w: int):
    """bound_ms of ec_madd_xyzz_fast's scan of g carries by w steps:
    madd-2008-s's 10 products and 7 adds a step, 2 rows in and 4 out a step,
    and a carry's 4 rows in, 4 totals out (where w > 1) and its flag byte."""
    return bound_ms("ec_madd_xyzz_fast", g * w, g * ((4 + (4 if w > 1 else 0)) * ROW_BYTES + 1))


def inv_muls(n: int) -> float:
    """Field products a row that inverting n rows needs, whatever the
    grouping: the Montgomery trick's 3 (n - 1) and one power of p - 2."""
    return (3 * (n - 1) + CF.pow_products(SPEC.p - 2)) / n


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------

def random_field(nprng, b: int, dev):
    """b random reduced field elements as limbs (below 2^254 < p)."""
    a = nprng.integers(0, 1 << 16, size=(b, N_LIMBS), dtype=np.uint32)
    a[:, 15] &= 0x3FFF
    return limbs_from_numpy(a, dev)


def zero_laced(nprng, b: int, dev):
    """b random reduced field elements, zero at rows 0, b // 2 and b - 1."""
    a = random_field(nprng, b, dev)
    a[[0, b // 2, b - 1]] = 0
    return a


def field_inputs(nprng, b: int, dev):
    a, c = random_field(nprng, b, dev), random_field(nprng, b, dev)
    edge_a = ints_to_mont_limbs([0, SPEC.p - 1, 1, 0], SPEC)
    edge_c = ints_to_mont_limbs([SPEC.p - 1, SPEC.p - 1, SPEC.p - 1, 0], SPEC)
    k = min(b, 4)
    a[:k] = limbs_from_numpy(edge_a[:k], dev)
    c[:k] = limbs_from_numpy(edge_c[:k], dev)
    return a, c


def random_points(nprng, base_pts, b: int, dev):
    """b valid points: base points drawn at random, each with its own random
    Jacobian representative (x l^2, y l^3, l).  Returns (points, the index of
    each lane's base point)."""
    bx = limbs_from_numpy(ints_to_mont_limbs([p[0] for p in base_pts], SPEC), dev)
    by = limbs_from_numpy(ints_to_mont_limbs([p[1] for p in base_pts], SPEC), dev)
    idx = torch.from_numpy(nprng.integers(0, len(base_pts), size=b)).to(dev)
    lam = random_field(nprng, b, dev)
    lam[:, 0] |= 1  # never zero
    mul = lambda u, v: CF.mont_mul_plain(SPEC, u, v)
    l2 = mul(lam, lam)
    return JPoint(mul(bx[idx], l2), mul(by[idx], mul(l2, lam)), lam), idx


def curve_inputs(nprng, base_pts, b: int, dev):
    """Two batches of b points with the edge lanes 0..4: p identity, q
    identity, both identity, q == p (doubling), q == -p (inverse).  Returns
    (p, q, host points of p, host points of q) with the host lists covering
    the first min(b, 64) lanes."""
    (p, ip), (q, iq) = random_points(nprng, base_pts, b, dev), \
        random_points(nprng, base_pts, b, dev)
    p = JPoint(*(c.clone() for c in p))
    q = JPoint(*(c.clone() for c in q))
    k = min(b, 64)
    hp = [base_pts[i] for i in ip[:k].tolist()]
    hq = [base_pts[i] for i in iq[:k].tolist()]
    if b >= 5:
        p.z[0] = 0
        q.z[1] = 0
        p.z[2] = 0
        q.z[2] = 0
        for c_p, c_q in zip(p, q):
            c_q[3] = c_p[3]
            c_q[4] = c_p[4]
        q.y[4] = CF.mont_addsub_plain(SPEC, True, torch.zeros_like(q.y[4]), q.y[4])
        hp[0] = None
        hq[1] = None
        hp[2] = hq[2] = None
        hq[3] = hp[3]
        hq[4] = pyref.ec_neg(hp[4], CURVE)
    return p, q, hp, hq


def mixed_inputs(nprng, base_pts, b: int, dev):
    """A batch of b Jacobian points p and b affine points q with the edge
    lanes 0..4: p identity, q identity, both identity, q == p, q == -p; in
    every other lane q is another base point than p's.
    Returns (p, qx, qy, q identity mask, host points of p, host points of q),
    the host lists covering the first min(b, 64) lanes.  An affine identity
    is the all-zero row, as EC.to_affine makes it."""
    p, ip = random_points(nprng, base_pts, b, dev)
    p = JPoint(*(c.clone() for c in p))
    ip_host = ip.cpu().numpy()
    iq = (ip_host + nprng.integers(1, len(base_pts), size=b)) % len(base_pts)
    neg = np.zeros(b, dtype=bool)
    mask = np.zeros(b, dtype=bool)
    if b >= 5:
        iq[3], iq[4], neg[4] = ip_host[3], ip_host[4], True
        mask[1] = mask[2] = True
    bx = limbs_from_numpy(ints_to_mont_limbs([q[0] for q in base_pts], SPEC), dev)
    by = limbs_from_numpy(ints_to_mont_limbs([q[1] for q in base_pts], SPEC), dev)
    iq_t = torch.from_numpy(iq).to(dev)
    qx, qy = bx[iq_t], by[iq_t]
    neg_t = torch.from_numpy(neg).to(dev)
    qy = torch.where(neg_t[:, None],
                     CF.mont_addsub_plain(SPEC, True, torch.zeros_like(qy), qy), qy)
    mask_t = torch.from_numpy(mask).to(dev)
    qx = torch.where(mask_t[:, None], torch.zeros_like(qx), qx)
    qy = torch.where(mask_t[:, None], torch.zeros_like(qy), qy)
    if b >= 5:
        p.z[0] = 0
        p.z[2] = 0
    k = min(b, 64)
    hp = [base_pts[i] for i in ip_host[:k].tolist()]
    hq = [pyref.ec_neg(base_pts[i], CURVE) if n else base_pts[i]
          for i, n in zip(iq[:k].tolist(), neg[:k].tolist())]
    if b >= 5:
        hp[0] = hp[2] = None
        hq[1] = hq[2] = None
    return p, qx, qy, mask_t, hp, hq


def xyzz_scan_inputs(nprng, base_pts, g: int, w: int, dev):
    """A blinded stepwise scan's inputs: g XYZZ carries (zz = z^2, zzz = z^3
    of mixed_inputs' Jacobian points; the identity all zero in zz, zzz) and
    g*w affine rows, carry j's at rows j*w .. j*w + w - 1.  Step 0 holds
    mixed_inputs' edges: an identity carry (lane 0), an affine identity
    (lanes 1 and 2; lane 2's carry the identity too), q == carry (lane 3),
    q == -carry (lane 4); every row of lane 2 is an affine identity, so it
    stays the identity, unflagged.  The other rows are base points drawn at
    random, 5 % of them affine identities (qx = qy = 0).  Returns ((x, y,
    zz, zzz, qx, qy), host carries, host rows), the host lists covering the
    first min(g, 64) lanes."""
    p, qx0, qy0, _, hp, hq0 = mixed_inputs(nprng, base_pts, g, dev)
    zz = CF.mont_mul_plain(SPEC, p.z, p.z)
    zzz = CF.mont_mul_plain(SPEC, zz, p.z)
    n = g * w
    bx = limbs_from_numpy(ints_to_mont_limbs([q[0] for q in base_pts], SPEC), dev)
    by = limbs_from_numpy(ints_to_mont_limbs([q[1] for q in base_pts], SPEC), dev)
    idx = nprng.integers(0, len(base_pts), size=n)
    ident = nprng.random(n) < 0.05
    if g >= 5:
        ident[2 * w:3 * w] = True
    it = torch.from_numpy(idx).to(dev)
    mask = torch.from_numpy(ident).to(dev)[:, None]
    qx = torch.where(mask, torch.zeros_like(bx[it]), bx[it])
    qy = torch.where(mask, torch.zeros_like(by[it]), by[it])
    qx.view(g, w, N_LIMBS)[:, 0] = qx0
    qy.view(g, w, N_LIMBS)[:, 0] = qy0
    host = [hq0[i // w] if i % w == 0 else None if ident[i] else base_pts[idx[i]]
            for i in range(len(hp) * w)]
    return (p.x, p.y, zz, zzz, qx, qy), hp, host


def scan_t_limbs():
    """The blinding point T's Montgomery limbs, as the fused scan takes them."""
    return tuple(tuple(int(v) for v in ints_to_mont_limbs([c], SPEC)[0])
                 for c in ec(CURVE).offset_point_ints())


def scan_rows(nprng, base_pts, g: int, w: int, dev):
    """g*w packed affine rows: tiled base points with zero rows (affine
    identities) in the stream, and lane 5 starting with -T, which must flag
    that lane and no other."""
    E = ec(CURVE)
    pts = list(base_pts) + [pyref.ec_neg(E.offset_point_ints(), CURVE)]
    ax = limbs_from_numpy(ints_to_mont_limbs([p[0] for p in pts], SPEC), dev)
    ay = limbs_from_numpy(ints_to_mont_limbs([p[1] for p in pts], SPEC), dev)
    table = torch.cat([M._pack_pair(ax, ay), torch.zeros_like(ax[:1])])  # last: zero row
    n = g * w
    idx = nprng.integers(0, len(base_pts), size=n)
    idx[nprng.random(n) < 0.05] = len(pts)      # zero rows
    idx[5 * w] = len(base_pts)                  # -T at the head of lane 5
    return table[torch.from_numpy(idx).to(dev)].contiguous()


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def outputs_equal(got, want) -> int:
    """Largest absolute difference over all outputs (0 means identical)."""
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise Failure(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.equal(g, w):
            worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return worst


def flatten_outs(out):
    flat = []
    for o in out:
        flat.extend(o if isinstance(o, tuple) else [o])
    return flat


def check_kernel(dev, name, kernel, plain, make_inputs, sizes, reps, elems_of=None,
                 extra_bytes_of=None, host_check=None, stages_of=None, shape_of=str,
                 muls_of=None, bound_of=None):
    """Compare kernel and plain version at every size; time both at the last
    (the main-path shape).  bound_of(size), where given, is the bound (ms,
    by) in place of bound_ms's from the table.  Returns the kernel's record
    for the JSON line."""
    print(f"kernel {name}", flush=True)
    worst = 0
    for size in sizes:
        args = make_inputs(size)
        got = flatten_outs(kernel(*args))
        sync(dev)
        plain_ms = float("inf")
        for _ in range(2):  # the first call also pays for PyTorch's own start-up
            t0 = time.perf_counter()
            want = flatten_outs(plain(*args))
            sync(dev)
            plain_ms = min(plain_ms, (time.perf_counter() - t0) * 1e3)
        err = outputs_equal(got, want)
        worst = max(worst, err)
        require(err == 0, f"{name} equals {name}_plain at size {size} "
                          f"({len(got)} outputs, max abs diff {err})")
        if host_check is not None:
            host_check(size, args, got)
    ms, call_ms = time_ms(dev, lambda: kernel(*args), reps)
    elems = elems_of(size) if elems_of else size
    extra = extra_bytes_of(size) if extra_bytes_of else 0
    b_ms, b_by = bound_of(size) if bound_of else bound_ms(
        name, elems, extra, stages_of(size) if stages_of else 1, muls_of(size) if muls_of else None)
    src, tpu_file, line = KERNEL_TABLE[name][:3]
    rec = {"name": name, "route": "cuda", "source": CSRC + src,
           "replaces": f"{tpu_file}:{line}", "launches": 0, "max_abs_err": worst,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "shape": shape_of(size), "call_ms": call_ms}
    print(f"  time {name} at {size}: kernel {ms:.4f} ms on the device, {call_ms:.4f} ms "
          f"a call on the host, plain {plain_ms:.1f} ms, bound {b_ms:.5f} ms ({b_by})",
          flush=True)
    return rec


def check_kernels(dev, base_pts, ragged: int, shapes: dict, scan_small_g: int, reps: int):
    nprng = np.random.default_rng(0xC0FFEE)
    E = ec(CURVE)
    recs = []

    recs.append(check_kernel(
        dev, "mont_mul",
        lambda a, b: (CF.mont_mul(SPEC, a, b),),
        lambda a, b: (CF.mont_mul_plain(SPEC, a, b),),
        lambda b: field_inputs(nprng, b, dev), [ragged, shapes["mont_mul"]], reps))

    def inv_vs_host(size, args, got):
        if size == ragged:
            require(torch.equal(got[0].cpu(), ff(SPEC)._inv_host(args[0].cpu())),
                    f"batch_inv equals FF._inv_host (Python-int powers) at size {size}")

    recs.append(check_kernel(
        dev, "batch_inv", lambda a: (CF.batch_inv(SPEC, a),),
        lambda a: (CF.batch_inv_plain(SPEC, a),),
        lambda b: (zero_laced(nprng, b, dev),), [ragged, shapes["batch_inv"]], max(1, reps // 5),
        host_check=inv_vs_host,
        muls_of=inv_muls,
        shape_of=lambda b: f"n = {b}, L = {CF.batch_inv_chain(b)}"))

    def addsub(fn):
        return lambda a, b: (fn(SPEC, False, a, b), fn(SPEC, True, a, b))
    rec = check_kernel(
        dev, "mont_addsub", addsub(CF.mont_addsub), addsub(CF.mont_addsub_plain),
        lambda b: field_inputs(nprng, b, dev), [ragged, shapes["mont_addsub"]], reps)
    for key in ("ms", "call_ms", "plain_ms"):  # the timed call launches twice (add, sub)
        rec[key] /= 2
    recs.append(rec)

    host = {}

    def two_points(b):
        p, q, hp, hq = curve_inputs(nprng, base_pts, b, dev)
        host["p"], host["q"] = hp, hq
        return (*p, *q)

    def vs_pyref_add(size, args, got):
        if len(got) == 4:
            add_fast_oracle(got, host["p"], host["q"], f"ec_add_fast at size {size}")
            return
        k = len(host["p"])
        pts = E.points_to_ints(JPoint(*(c[:k] for c in got[:3])))
        want = [pyref.ec_add(a, b, CURVE) for a, b in zip(host["p"], host["q"])]
        require(pts == want, f"first {k} lanes equal the Python-int oracle at size {size}")

    recs.append(check_kernel(
        dev, "ec_add", lambda *a: CF.ec_add(CURVE, *a), lambda *a: CF.ec_add_plain(CURVE, *a),
        two_points, [ragged, shapes["ec_add"]], reps, host_check=vs_pyref_add))
    recs.append(check_kernel(
        dev, "ec_add_fast", lambda *a: CF.ec_add_fast(CURVE, *a),
        lambda *a: CF.ec_add_fast_plain(CURVE, *a),
        two_points, [ragged, shapes["ec_add_fast"]], reps,
        extra_bytes_of=lambda b: b, host_check=vs_pyref_add))

    def one_point(b):
        p, _, hp, _ = curve_inputs(nprng, base_pts, b, dev)
        host["p"] = hp
        return tuple(p)

    def vs_pyref_double(size, args, got):
        k = len(host["p"])
        pts = E.points_to_ints(JPoint(*(c[:k] for c in got)))
        require(pts == [pyref.ec_add(a, a, CURVE) for a in host["p"]],
                f"first {k} lanes equal the Python-int oracle at size {size}")

    recs.append(check_kernel(
        dev, "ec_double", lambda *a: CF.ec_double(CURVE, *a),
        lambda *a: CF.ec_double_plain(CURVE, *a),
        one_point, [ragged, shapes["ec_double"]], reps, host_check=vs_pyref_double))

    def mixed(b):
        p, qx, qy, mask, hp, hq = mixed_inputs(nprng, base_pts, b, dev)
        host["p"], host["q"], host["args"] = hp, hq, (*p, qx, qy)
        return (*p, qx, qy, mask)

    def vs_pyref_mixed(size, args, got):
        k = len(host["p"])
        pts = E.points_to_ints(JPoint(*(c[:k] for c in got)))
        require(pts == [pyref.ec_add(a, b, CURVE) for a, b in zip(host["p"], host["q"])],
                f"first {k} lanes (p identity, q identity, both, q == p, q == -p "
                f"among them) equal the Python-int oracle at size {size}")

    recs.append(check_kernel(
        dev, "ec_add_mixed", lambda *a: CF.ec_add_mixed(CURVE, *a),
        lambda *a: CF.ec_add_mixed_plain(CURVE, *a),
        mixed, [ragged, shapes["ec_add_mixed"]], reps,
        host_check=vs_pyref_mixed, bound_of=lambda b: mixed_bound(
            b, mixed_doublings(*host["args"]), b * (1 + 3 * ROW_BYTES))))

    def mixed_fast_flags(size, args, got):
        k = len(host["p"])
        require(got[3].nonzero().flatten().tolist() == [0, 3, 4],
                f"ec_add_mixed_fast flags the identity carry (lane 0), carry == Q (lane 3) "
                f"and carry == -Q (lane 4) and nothing else at size {size}; qy == 0 with "
                f"an ordinary and with an identity carry (lanes 1, 2) passes unflagged")
        require(all(torch.equal(g[1:3], a[1:3]) for g, a in zip(got[:3], args[:3])),
                f"lanes 1 and 2 (qy == 0) hold the carry itself, limb for limb, at size {size}")
        require(got[3].dtype == torch.bool,
                f"the flags are the bool tensor the kernel wrote at size {size}")
        pts = E.points_to_ints(JPoint(*(c[:k] for c in got[:3])))
        want = [pyref.ec_add(a, b, CURVE) for a, b in zip(host["p"], host["q"])]
        keep = [i for i in range(k) if i not in (0, 3, 4)]
        require([pts[i] for i in keep] == [want[i] for i in keep],
                f"unflagged lanes among the first {k} equal the Python-int oracle "
                f"at size {size}")

    recs.append(check_kernel(
        dev, "ec_add_mixed_fast", lambda *a: CF.ec_add_mixed_fast(CURVE, *a),
        lambda *a: CF.ec_add_mixed_fast_plain(CURVE, *a),
        lambda b: mixed(b)[:5], [ragged, shapes["ec_add_mixed_fast"]], reps,
        extra_bytes_of=lambda b: b, host_check=mixed_fast_flags))

    def xyzz_scan(size):
        g, w = size
        args, host["p"], host["q"] = xyzz_scan_inputs(nprng, base_pts, g, w, dev)
        return (*args, w)

    def xyzz_flags(size, args, got):
        (g, w), k = size, len(host["p"])
        inner, exc = got[:4], got[8]
        require(exc.dtype == torch.bool and exc.nonzero().flatten().tolist() == [0, 3, 4],
                f"ec_madd_xyzz_fast's scan flags the identity carry (lane 0), carry == Q "
                f"(lane 3) and carry == -Q (lane 4) and nothing else at g = {g}, w = {w}; "
                f"qy == 0 (lanes 1, 2) passes unflagged; the flags are a bool tensor")
        pts = E.points_to_ints(E.xyzz_to_jacobian(*(c[:k * w] for c in inner)))
        want = []
        for j in range(k):
            acc = host["p"][j]
            for t in range(w):
                acc = pyref.ec_add(acc, host["q"][j * w + t], CURVE)
                want.append(acc)
        keep = [i for i in range(k * w) if i // w not in (0, 3, 4)]
        require([pts[i] for i in keep] == [want[i] for i in keep],
                f"the inner prefixes of the unflagged lanes among the first {k} equal running "
                f"sums on Python ints at g = {g}, w = {w}")

    recs.append(check_kernel(
        dev, "ec_madd_xyzz_fast", lambda *a: CF.ec_madd_xyzz_fast_scan(CURVE, *a),
        lambda *a: CF.ec_madd_xyzz_fast_scan_plain(CURVE, *a),
        xyzz_scan, [(ragged, 1), (2048, 32), (shapes["ec_madd_xyzz_fast"][0], 1),
                    shapes["ec_madd_xyzz_fast"]], reps,
        bound_of=lambda s: xyzz_bound(*s), host_check=xyzz_flags,
        shape_of=lambda s: f"g = {s[0]}, w = {s[1]}"))

    w = CF.SCAN_W
    t_limbs = scan_t_limbs()

    def scan_flags(g, args, got):
        flags = got[8].nonzero().flatten().tolist()
        require(flags == [5], f"the scan flags lane 5 (first row -T) and no other at g = {g}")

    recs.append(check_kernel(
        dev, "fused_madd_scan_xyzz",
        lambda rows: CF.fused_madd_scan_xyzz(CURVE, t_limbs, rows, w),
        lambda rows: CF.fused_madd_scan_xyzz_plain(CURVE, t_limbs, rows, w),
        lambda g: (scan_rows(nprng, base_pts, g, w, dev),),
        [scan_small_g, shapes["fused_madd_scan_xyzz"]], max(1, reps // 10),
        elems_of=lambda g: g * w, extra_bytes_of=lambda g: g * (4 * ROW_BYTES + 1),
        host_check=scan_flags))
    return recs


# ---------------------------------------------------------------------------
# phase 4: the MSM path
# ---------------------------------------------------------------------------

def one_point(res: JPoint):
    """A single JPoint -> its affine ints (or None)."""
    return ec(CURVE).points_to_ints(JPoint(*(c[None] for c in res)))[0]


def tiled_msm_oracle(sc, base_pts):
    """The exact MSM of (n, 16) numpy scalar limbs over points tiled from
    base_pts: sum_i s_i P_i = sum_j (sum_{i = j mod 64} s_i mod q) B_j, a
    64-point MSM in Python ints."""
    distinct = len(base_pts)
    q = CURVE.scalar_field.p
    limb_sums = sc.astype(np.int64).reshape(-1, distinct, N_LIMBS).sum(axis=0)
    folded = [sum(int(v) << (16 * k) for k, v in enumerate(row)) % q for row in limb_sums]
    return pyref.ec_msm(folded, base_pts, CURVE)


def tiled_points(dev, base_pts, n: int) -> JPoint:
    """n points tiled from base_pts, affine (z = 1)."""
    reps = n // len(base_pts)
    xs = ints_to_mont_limbs([p[0] for p in base_pts], SPEC)
    ys = ints_to_mont_limbs([p[1] for p in base_pts], SPEC)
    return JPoint(limbs_from_numpy(np.tile(xs, (reps, 1)), dev),
                  limbs_from_numpy(np.tile(ys, (reps, 1)), dev),
                  limbs_from_numpy(np.tile(ints_to_mont_limbs([1], SPEC), (n, 1)), dev))


def msm_inputs(dev, base_pts, logn: int):
    """The headline MSM's inputs at 2^logn: points tiled from base_pts and
    full-width random scalars (below 2^254 < q).  Returns (scalar limbs on
    the host, scalars, points)."""
    n = 1 << logn
    nprng = np.random.default_rng(0xBE7C)
    sc = nprng.integers(0, 1 << 16, size=(n, N_LIMBS), dtype=np.uint32)
    sc[:, 15] &= 0x3FFF
    return sc, limbs_from_numpy(sc, dev), tiled_points(dev, base_pts, n)


def main_path(dev, base_pts, logn: int):
    """best_multiexp at 2^logn Pallas points, full-width scalars, against the
    exact oracle.  Returns (best seconds of three timed runs, launch counts of
    the first of them, the inputs)."""
    n = 1 << logn
    print(f"main path: best_multiexp, Pallas, n = 2^{logn}, 255-bit scalars, "
          f"c = {M.pick_window(n)}", flush=True)
    sc, scalars, pts = msm_inputs(dev, base_pts, logn)
    want = tiled_msm_oracle(sc, base_pts)

    c = M.pick_window(n)
    bits = CURVE.scalar_field.p.bit_length()
    # warm-up through the fast flavor itself, to read its exception flag
    res, exc = M._best_multiexp(CURVE, c, bits, "fast", scalars, pts)
    require(not bool(exc), "the fast flavor's exception flag is clear")
    require(one_point(res) == want, "warm-up result equals the Python-int oracle (affine)")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CF.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    res = M.best_multiexp(CURVE, scalars, pts)
    sync(dev)
    runs = [time.perf_counter() - t0]
    counts = dict(CF.LAUNCHES)
    if dev.type == "cuda":
        print(f"  peak device memory of one MSM: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB", flush=True)
    require(one_point(res) == want, "timed result equals the Python-int oracle (affine)")
    for name in MSM_KERNELS:
        require(counts[name] > 0, f"{name} was launched on the MSM path ({counts[name]} times)")
    for _ in range(2):  # the path is paced by the host: show the spread
        t0 = time.perf_counter()
        M.best_multiexp(CURVE, scalars, pts)
        sync(dev)
        runs.append(time.perf_counter() - t0)
    seconds = min(runs)
    print("  best_multiexp: runs of " + ", ".join(f"{r:.4f}" for r in runs)
          + f" s; best {seconds:.4f} s, {n / seconds:.1f} points/s", flush=True)
    return seconds, counts, (scalars, pts)


def profile_call(dev, what: str, fn) -> None:
    """Optional (--profile): device time by kernel over one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    print(f"profile of {what}", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), flush=True)


# the functions whose device time a round's profile attributes: span -> (the
# module that holds the function, the name its callers look it up by)
ROUND_SPANS = {"mul_naive": (P, "mul_naive"), "kate_div": (P, "kate_div2"),
               "lm tail": (D, "_merge_tail_fused_lm"), "head lines": (D, "_head_lines")}


def kernel_class(name: str) -> str:
    """A device event's class for the round's split: the port's kernel by
    name, else what PyTorch's kernel does (copy, reduce, fill, cat, other
    elementwise), memcpy or memset."""
    for k in sorted(CF.KERNELS, key=len, reverse=True):
        if k + "_kernel" in name:
            return k
    low = name.lower()
    for key, cls in (("memcpy", "memcpy"), ("memset", "memset"), ("copy", "copy"),
                     ("reduce", "reduce"), ("fill", "fill"), ("catarray", "cat")):
        if key in low:
            return cls
    return "other elementwise"


def profile_round(dev, fn) -> dict:
    """--profile of one round: the table of profile_call, with each function
    of ROUND_SPANS wrapped in a torch.profiler.record_function span for this
    call only; then every device event (kernel, copy, set) of the trace is
    attributed to the span whose range on the device timeline holds it and
    summed by kernel_class, so that the copies and the int64 sums are put
    on the schoolbook products, the Horner divisions or the lm tail.
    Returns {span or "rest": {class: device ms}} and prints it with each
    span's timeline (the sum of its ranges, idle gaps included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    real = {span: (mod, name, getattr(mod, name)) for span, (mod, name) in ROUND_SPANS.items()}

    def spanned(span, f):
        def g(*a, **kw):
            with record_function(span):
                return f(*a, **kw)
        return g

    for span, (mod, name, f) in real.items():
        setattr(mod, name, spanned(span, f))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync(dev)
    finally:
        for span, (mod, name, f) in real.items():
            setattr(mod, name, f)
    print("profile of one round", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), flush=True)

    on_device = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    ranges = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in on_device if ev.name in real)
    split = {span: {} for span in list(real) + ["rest"]}
    timeline = {span: 0.0 for span in real}
    for start, end, span in ranges:
        timeline[span] += (end - start) / 1e3
    for ev in on_device:
        if ev.name in real or getattr(ev, "is_user_annotation", False):
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        span = next((s for start, end, s in ranges if start <= t0 and t1 <= end), "rest")
        cls = kernel_class(ev.name)
        split[span][cls] = split[span].get(cls, 0.0) + (t1 - t0) / 1e3
    for span, acc in split.items():
        top = sorted(acc.items(), key=lambda kv: -kv[1])
        line = f"{timeline[span]:.3f} ms of timeline, " if span in timeline else ""
        print(f"  round profile split: {span}: {line}{sum(acc.values()):.3f} ms of device "
              f"time; " + ", ".join(f"{cls} {ms:.3f}" for cls, ms in top), flush=True)
    return split


def device_busy_ms(dev, fn) -> float:
    """device_profile's busy time of one call of fn."""
    return device_profile(dev, fn)[0]


# set once the profiler has traced no device time twice in a row in this run:
# device_profile then traces a call once before it times it with CUDA events
PROFILER_EMPTY_TWICE = False


def device_profile(dev, fn):
    """The device's busy time over one call of fn, the sum of the times of
    every kernel and copy it ran there, as torch.profiler traces them (the
    "Self CUDA time total" of its table), and the number of those device
    events (kernels, copies and fills), the profiler's own buffer requests
    left out.  A trace with no device event in it is taken once more (the
    profiler has returned one on the card for a call that ran kernels, and
    twice in a row in one run); where the second is empty too, the call is
    timed with CUDA events instead: its span on the device from before its
    first launch to after its last, idle gaps included, so no less than its
    busy time, and its events go uncounted (None).  Once that has happened,
    later calls are traced once before they fall back.  Returns (ms, number
    of events or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    global PROFILER_EMPTY_TWICE
    for _ in range(1 if PROFILER_EMPTY_TWICE else 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync(dev)
        busy_us, events = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
                own = getattr(ev, "self_device_time_total", None)
                busy_us += own if own is not None else ev.self_cuda_time_total
                if not ev.key.startswith("Activity Buffer"):
                    events += ev.count
        if busy_us > 0:
            return busy_us / 1e3, events
        print("  the profiler traced no device time for this call", flush=True)
    PROFILER_EMPTY_TWICE = True
    print("  timing the call with CUDA events instead "
          "(its span on the device, idle gaps included; device events not counted)", flush=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync(dev)
    start.record()
    fn()
    end.record()
    sync(dev)
    return start.elapsed_time(end), None


# ---------------------------------------------------------------------------
# phase 5: the carry stage
# ---------------------------------------------------------------------------

def base_digit_sums(digits, distinct: int):
    """(d, n) digits over points tiled from `distinct` base points -> (d,
    distinct) Python-int digit sums per base point, summed on the device."""
    d, n = digits.shape
    return digits.reshape(d, n // distinct, distinct).sum(dim=1, dtype=torch.int64).tolist()


def carry_path(dev, base_pts, pts: JPoint, logn: int, profile: bool):
    """argument._carries_only at 2^logn Pallas points, scalars below sqrt(q),
    base 5, all digit rounds.  Returns (best seconds of three timed runs,
    launch counts of the first of them, the number of rounds, (digits,
    carry_prev, carry_new), (scalar limbs, the final carry's affine point))."""
    n = 1 << logn
    distinct = len(base_pts)
    q = CURVE.scalar_field.p
    d = A.num_digits_for(CURVE, BASE)
    print(f"carry stage: _carries_only, Pallas, n = 2^{logn}, base {BASE}, "
          f"{d} rounds", flush=True)
    nprng = np.random.default_rng(0xCA77)
    sc = np.zeros((n, N_LIMBS), dtype=np.uint32)
    sc[:, :8] = nprng.integers(0, 1 << 16, size=(n, 8), dtype=np.uint32)
    sc[:, 7] &= 0x3FFF  # below 2^126 < sqrt(q)
    t0 = time.perf_counter()
    digits_host = negbase_decompose_batch(sc, BASE, d)
    decompose_s = time.perf_counter() - t0
    digits = digits_to_rounds(digits_host, dev)
    print(f"  host: negbase_decompose_batch of {n} scalars into {d} digits: "
          f"{decompose_s:.3f} s; digits on the device: "
          f"{digits.numel() * digits.element_size() / 2**20:.0f} MiB", flush=True)

    want = tiled_msm_oracle(sc, base_pts)

    # warm-up through the fast flavor itself, to read its per-round flags
    _, excs = M._round_sums(CURVE, BASE, "fast", digits, pts)
    require(not bool(excs.any()), f"no round of {d} is flagged by the fast flavor")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CF.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    carry_prev, carry_new, final = A._carries_only(CURVE, BASE, digits, pts)
    sync(dev)
    runs = [time.perf_counter() - t0]
    counts = dict(CF.LAUNCHES)
    if dev.type == "cuda":
        print(f"  peak device memory of one carry stage: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB", flush=True)
    print("  launches: " + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    for name in MSM_KERNELS:
        require(counts[name] > 0,
                f"{name} was launched on the carry path ({counts[name]} times)")

    got = one_point(final)
    require(got == want, "the final carry equals the Python-int oracle (affine)")
    msm = M.best_multiexp(CURVE, limbs_from_numpy(sc, dev), pts, max_scalar_bits=128)
    require(one_point(msm) == got, "the final carry equals the port's best_multiexp")

    E = ec(CURVE)
    p_prev, p_new = E.points_to_ints(carry_prev), E.points_to_ints(carry_new)
    sums = base_digit_sums(digits, distinct)
    carry, ok = None, True
    for k in range(d):
        ok = ok and p_prev[k] == carry
        s_k = pyref.ec_msm(sums[k], base_pts, CURVE)
        carry = pyref.ec_msm([(-BASE) % q, 1], [carry, s_k], CURVE)
        ok = ok and p_new[k] == carry
    require(ok and carry == got,
            f"carry_prev[k] and carry_new[k] satisfy carry' = -{BASE} carry + S_k "
            f"on the host for all {d} rounds")

    for _ in range(2):  # the path is paced by the host: show the spread
        t0 = time.perf_counter()
        A._carries_only(CURVE, BASE, digits, pts)
        sync(dev)
        runs.append(time.perf_counter() - t0)
    seconds = min(runs)
    print("  _carries_only: runs of " + ", ".join(f"{r:.4f}" for r in runs)
          + f" s; best {seconds:.4f} s, {seconds / d * 1e3:.2f} ms a round", flush=True)
    if profile:
        profile_call(dev, "_carries_only",
                     lambda: A._carries_only(CURVE, BASE, digits, pts))
    return seconds, counts, d, (digits, carry_prev, carry_new), (sc, got)


# ---------------------------------------------------------------------------
# phase 6: the exception fallback on the card
# ---------------------------------------------------------------------------

def adversarial_rounds(nprng, n: int, rounds: int, flagged: int):
    """(rounds, n) base-5 digits for a point list whose point 0 is -T.  In
    round `flagged` point 0 has digit 1 and every other digit is in [2, 5),
    so -T sorts first and the blinded scan opens with T + (-T).  In the other
    rounds point 0 has digit 4 and an odd number of points sort before it, so
    it never opens a lane (lane widths are even) and nothing is flagged."""
    digits = nprng.integers(0, BASE, size=(rounds, n)).astype(np.int32)
    digits[:, 0] = BASE - 1
    for k in range(rounds):
        if (digits[k] < BASE - 1).sum() % 2 == 0:
            digits[k, 1] = 0 if digits[k, 1] == BASE - 1 else BASE - 1
    digits[flagged] = nprng.integers(2, BASE, size=n)
    digits[flagged, 0] = 1
    return digits


def fallback_path(dev, base_pts, logn: int):
    """round_sums at 2^logn points with one round that the fast flavor must
    flag, then best_multiexp at n = 16 (safe flavor).  Returns the launch
    counts of the round_sums call."""
    n = 1 << logn
    distinct = len(base_pts)
    rounds, flagged = 4, 2
    print(f"fallback: round_sums, n = 2^{logn}, {rounds} rounds, point 0 = -T "
          f"sorted first in round {flagged}", flush=True)
    route = "stepwise" if n < M.FUSED_SCAN_MIN_ROWS else "fused"
    print(f"  the fast flavor takes the {route} scan at this size", flush=True)
    E = ec(CURVE)
    neg_t = pyref.ec_neg(E.offset_point_ints(), CURVE)
    tiled = E.points_from_ints([neg_t] + list(base_pts[1:]), dev)
    pts = JPoint(*(c.repeat(n // distinct, 1) for c in tiled))
    first = E.points_from_ints([base_pts[0]], dev)
    for c, f in zip(pts, first):
        c[distinct::distinct] = f[0]     # only point 0 is -T
    nprng = np.random.default_rng(0xADE5)
    digits_host = adversarial_rounds(nprng, n, rounds, flagged)
    digits = torch.from_numpy(digits_host).to(dev)

    _, excs = M._round_sums(CURVE, BASE, "fast", digits, pts)
    require(excs.tolist() == [k == flagged for k in range(rounds)],
            f"the fast flavor flags round {flagged} and no other")

    CF.reset_launch_counts()
    got = E.points_to_ints(M.round_sums(CURVE, BASE, digits, pts))
    counts = dict(CF.LAUNCHES)
    rest = digits.clone()
    rest[:, 0] = 0
    sums = base_digit_sums(rest, distinct)
    want = [pyref.ec_add(pyref.ec_msm(sums[k], base_pts, CURVE),
                         pyref.ec_mul(neg_t, int(digits_host[k, 0]), CURVE), CURVE)
            for k in range(rounds)]
    require(got == want, f"round_sums equals the Python-int oracle in all {rounds} rounds")
    require(counts["ec_add_mixed"] == 1 and counts[
        "ec_madd_xyzz_fast" if route == "stepwise" else "fused_madd_scan_xyzz"] == rounds,
            f"round_sums launched ec_add_mixed once (the recomputed round's window scan: "
            f"{counts['ec_add_mixed']} times) and the {route} scan's kernel once a round's "
            f"window ({rounds} rounds: {counts['ec_madd_xyzz_fast']} ec_madd_xyzz_fast, "
            f"{counts['fused_madd_scan_xyzz']} fused_madd_scan_xyzz launches)")

    rng = random.Random(0x5AFE)
    q = CURVE.scalar_field.p
    scalars = [rng.randrange(q) for _ in range(16)]
    small = list(base_pts[:16])
    small[3] = None
    before = CF.LAUNCHES["ec_add_mixed"]
    res = M.msm_ints(CURVE, scalars, small, c=4, device=dev)
    require(res == pyref.ec_msm(scalars, small, CURVE)
            and CF.LAUNCHES["ec_add_mixed"] > before,
            "best_multiexp at n = 16 (safe flavor, on the card) equals the oracle")
    return counts


# ---------------------------------------------------------------------------
# phase 6b: the safe flavor of the MSM
# ---------------------------------------------------------------------------

def safe_msm_path(dev, base_pts, logn: int):
    """best_multiexp's safe flavor (the complete-add redo that follows a
    flagged fast flavor) on the MSM phase's 2^logn inputs: equal to the
    Python-int oracle, one ec_add_mixed launch (the window's scan) and one
    ec_double launch (c doublings) a window; three timed runs after a
    warm-up (host clock, each ending in a synchronise), the launches of the
    first, the device's busy time of one more.  Returns a dict."""
    n = 1 << logn
    c = M.pick_window(n)
    bits = CURVE.scalar_field.p.bit_length()
    windows = -(-bits // c)
    w = M._pick_block_width(n, True)
    print(f"safe flavor: best_multiexp, Pallas, n = 2^{logn}, c = {c}, {windows} windows, "
          f"scans of g = {-(-n // w)} lanes x w = {w} steps", flush=True)
    sc, scalars, pts = msm_inputs(dev, base_pts, logn)
    want = tiled_msm_oracle(sc, base_pts)
    safe = lambda: M._best_multiexp(CURVE, c, bits, "safe", scalars, pts)
    require(one_point(safe()) == want, "warm-up result equals the Python-int oracle (affine)")
    CF.reset_launch_counts()
    runs = []
    for i in range(3):
        sync(dev)
        t0 = time.perf_counter()
        res = safe()
        sync(dev)
        runs.append(time.perf_counter() - t0)
        if i == 0:
            counts = dict(CF.LAUNCHES)
    require(one_point(res) == want, "the safe flavor's result equals the Python-int oracle")
    require(counts["ec_add_mixed"] == windows and counts["ec_double"] == windows,
            f"one ec_add_mixed launch (a scan of {w} steps) and one ec_double launch ({c} "
            f"doublings) a window: {counts['ec_add_mixed']} and {counts['ec_double']} for "
            f"{windows} windows")
    busy = device_busy_ms(dev, safe)
    out = dict(seconds=min(runs), runs=runs, busy_ms=busy, counts=counts, windows=windows,
               launches=sum(counts.values()))
    print(f"  safe flavor: runs " + ", ".join(f"{t:.4f}" for t in runs) + f" s; device busy "
          f"{busy:.2f} ms; {out['launches']} kernel launches of the port's", flush=True)
    return out


def safe_rule2(recs: list, safe: dict) -> dict:
    """ec_add_mixed in the rule-2 ranking on its own path: launches x (ms -
    bound) over one safe MSM (phase 6b's launches), at the window scan's time
    from phase 9b."""
    scan = recs[0]
    launches = safe["counts"]["ec_add_mixed"]
    loss = launches * (scan["ms"] - scan["bound_ms"])
    print(f"  rule-2 ranking, safe flavor: ec_add_mixed: 0 launches on the main path; "
          f"{launches} launches a safe MSM ({scan['shape']}), launches x (ms - bound) = "
          f"{loss:.3f} ms a safe MSM, share of the bound by time "
          f"{scan['bound_ms'] / scan['ms']:.3f}", flush=True)
    return {"launches_safe_msm": launches, "gap_ms_safe_msm": loss,
            "bound_share_by_time_safe_msm": scan["bound_ms"] / scan["ms"]}


# ---------------------------------------------------------------------------
# phase 7: one window by the fused and by the stepwise scan
# ---------------------------------------------------------------------------

def time_window_routes(dev, base_pts, logns, reps: int = 5):
    """Time one carry-stage window (base-5 digits) by both scan routes at each
    size; the routes must give the same window sum.  The route follows
    ops/msm.FUSED_SCAN_MIN_ROWS, which is set for the measurement and put back.
    Returns [(n, fused ms, stepwise ms, fused device ms, stepwise device ms)]:
    the first pair the best of `reps` host-clock times of a call ending in a
    synchronise, the second the device's busy time over one such call (the
    sum of its kernels' and copies' times; a window waits for the host in
    bincount, so CUDA events around it would read the host's pace again)."""
    print("one window by both scan routes (host clock: best of "
          f"{reps} after a warm-up; device: busy time of one call)", flush=True)
    E = ec(CURVE)
    tiled = E.points_from_ints(list(base_pts), dev)
    nprng = np.random.default_rng(0x2077)
    c = max(1, (BASE - 1).bit_length())
    out = []
    kept = M.FUSED_SCAN_MIN_ROWS
    try:
        for logn in logns:
            n = 1 << logn
            pts = JPoint(*(cc.repeat(n // len(base_pts), 1) for cc in tiled))
            ax, ay, _ = E.to_affine(pts)
            window = M._make_one_window(E, c, "fast", M._pack_pair(ax, ay), n)
            keys = torch.from_numpy(nprng.integers(0, BASE, size=n).astype(np.int32)).to(dev)
            ms, dev_ms, sums = {}, {}, {}
            for route, bound in (("fused", 0), ("stepwise", 1 << 62)):
                M.FUSED_SCAN_MIN_ROWS = bound
                CF.reset_launch_counts()
                res, exc = window(keys)
                sync(dev)
                used = CF.LAUNCHES["fused_madd_scan_xyzz" if route == "fused"
                                   else "ec_madd_xyzz_fast"]
                if used != 1 or bool(exc):
                    raise Failure(f"the {route} route did not run clean at n = {n} in one "
                                  f"launch of its scan ({used} launches)")
                sums[route] = one_point(res)
                best = float("inf")
                for _ in range(reps):
                    t0 = time.perf_counter()
                    window(keys)
                    sync(dev)
                    best = min(best, time.perf_counter() - t0)
                ms[route] = best * 1e3
                dev_ms[route] = device_busy_ms(dev, lambda: window(keys))
            require(sums["fused"] == sums["stepwise"],
                    f"n = 2^{logn}: both routes give the same window sum; fused "
                    f"{ms['fused']:.3f} ms ({dev_ms['fused']:.3f} on the device), stepwise "
                    f"{ms['stepwise']:.3f} ms ({dev_ms['stepwise']:.3f} on the device)")
            out.append((n, ms["fused"], ms["stepwise"], dev_ms["fused"], dev_ms["stepwise"]))
    finally:
        M.FUSED_SCAN_MIN_ROWS = kept
    return out



# ---------------------------------------------------------------------------
# phase 8: the merge tree's limb-major kernels
# ---------------------------------------------------------------------------

def lm_inputs(nprng, e: int, dev, edges):
    """(16, e) random reduced elements; the first lanes hold `edges`, given
    as raw limb values (0, 1, the Montgomery forms of p - 1 and of 1)."""
    x = nprng.integers(0, 1 << 16, size=(e, N_LIMBS), dtype=np.uint32)
    x[:, 15] &= 0x3FFF
    k = min(e, len(edges))
    x[:k] = np.stack([np.array([(v >> (16 * i)) & 0xFFFF for i in range(N_LIMBS)],
                               dtype=np.uint32) for v in edges[:k]])
    return CN.to_lm(limbs_from_numpy(x, dev))


def mont(v: int) -> int:
    return (v << 256) % SPEC.p


EDGES_A = (0, 1, mont(SPEC.p - 1), mont(1), mont(SPEC.p - 1), 0)
EDGES_B = (mont(SPEC.p - 1), mont(1), 1, 0, mont(SPEC.p - 1), mont(1))


def check_ntt_kernels(dev, ragged: int, reps: int, top_logn: int):
    """The five kernels of csrc/ntt.cuh against their plain versions at a
    ragged size and at the shapes one round gives them (the last size of
    each is the one timed): at 2^20 points the top level is one pair at
    n = 2^top_logn = 2^21 and the lowest fused level 8,192 pairs at n = 128.
    Then a 2^top_logn transform forward and back, and the limb-major forward
    transform against the element-major one."""
    nprng = np.random.default_rng(0x1177)
    recs = []
    top = 1 << top_logn

    def pair(e):
        return lm_inputs(nprng, e, dev, EDGES_A), lm_inputs(nprng, e, dev, EDGES_B)

    recs.append(check_kernel(
        dev, "lm_mul", lambda a, b: (CN.lm_mul(SPEC, a, b),),
        lambda a, b: (CN.lm_mul_plain(SPEC, a, b),), pair, [ragged, top], reps))

    def addsub(fn):
        return lambda a, b: (fn(SPEC, False, a, b), fn(SPEC, True, a, b))
    rec = check_kernel(dev, "lm_addsub", addsub(CN.lm_addsub), addsub(CN.lm_addsub_plain),
                       pair, [ragged, top], reps)
    for key in ("ms", "call_ms", "plain_ms"):  # the timed call launches twice (add, sub)
        rec[key] /= 2
    recs.append(rec)

    n_mont = (top << 256) % SPEC.p  # the folded n of the top level
    recs.append(check_kernel(
        dev, "lm_mul_const", lambda a: (CN.lm_mul_const(SPEC, a, n_mont),),
        lambda a: (CN.lm_mul_const_plain(SPEC, a, n_mont),),
        lambda e: (lm_inputs(nprng, e, dev, EDGES_A),), [ragged, top], reps))

    def stage_inputs(size):
        """size (n, w, E): E elements of transforms of size n; w is the
        stage's half-size for stage_big, the tile for stages_small."""
        n, w, e = size
        logn = n.bit_length() - 1
        return (lm_inputs(nprng, e, dev, EDGES_A), CN.tables(SPEC, logn, False, dev),
                CN.tables(SPEC, logn, True, dev), w)

    def both_dirs(fn):
        return lambda x, tf, ti, w: (fn(SPEC, x, w, False, tf), fn(SPEC, x, w, True, ti))

    for kernel, sizes, extra, stages in (
            ("stage_big", [(1 << 11, 1024, 3 << 11), (top, 1024, top), (top, top // 2, top)],
             lambda size: size[1] * ROW_BYTES, None),
            ("stages_small", [(2, 2, 3 * 128), (128, 128, 3 * 128), (128, 128, top // 2),
                              (top, 1024, top)],
             lambda size: (size[1] - 1) * ROW_BYTES,
             lambda size: size[1].bit_length() - 1)):
        rec = check_kernel(
            dev, kernel, both_dirs(getattr(CN, kernel)), both_dirs(getattr(CN, kernel + "_plain")),
            stage_inputs, sizes, max(1, reps // 5), elems_of=lambda size: size[2],
            extra_bytes_of=extra, stages_of=stages,
            shape_of=lambda size: f"n = {size[0]}, {'s' if stages is None else 'tile'} = "
                                  f"{size[1]}, E = {size[2]}")
        for key in ("ms", "call_ms", "plain_ms"):  # forward and inverse each call
            rec[key] /= 2
        recs.append(rec)

    print("transforms", flush=True)
    x = lm_inputs(nprng, top, dev, EDGES_A)
    back = CN.intt_dit_lm(SPEC, CN.ntt_dif_lm(SPEC, x, top_logn), top_logn)
    require(torch.equal(back, CN.lm_mul_const_plain(SPEC, x, n_mont)),
            f"intt_dit_lm(ntt_dif_lm(x)) == n x at n = 2^{top_logn}")
    em = CN.from_lm(lm_inputs(nprng, 8 << 12, dev, EDGES_A), (8, 1 << 12))
    require(torch.equal(CN.from_lm(CN.ntt_dif_lm(SPEC, CN.to_lm(em), 12), (8, 1 << 12)),
                        NTT.ntt_dif(SPEC, em)),
            "ntt_dif_lm equals the element-major ntt_dif (mont_mul, mont_addsub) on 8 "
            "transforms at n = 2^12")
    return recs


# ---------------------------------------------------------------------------
# phase 8a: stages_small's 1-bit window at every tile, in a child process
# ---------------------------------------------------------------------------

def r1_phase() -> list:
    """stages_small's R = 1 instantiation against the plain stages at every
    tile from 2 to 1024, forward and inverse, one launch each through the
    test-only launcher, in one child process that the probe kills past
    R1_TIMEOUT_S (utils/probe_stages_small_r1): a hang fails the run here,
    within the limit, as a mismatch or a fault does."""
    print(f"stages_small R = 1: tiles {R1.TILES[0]} .. {R1.TILES[-1]}, forward and inverse, "
          f"a child process under {R1_TIMEOUT_S} s", flush=True)
    t0 = time.perf_counter()
    recs = R1.probe(R1.TILES, R1_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    for r in recs:
        print(f"  R = 1 at tile {r['tile']}, {'inverse' if r['inverse'] else 'forward'}: "
              f"{r['outcome']} ({r['detail']})", flush=True)
    require(all(r["outcome"] == "matched" for r in recs),
            f"stages_small's R = 1 window equals the plain stages at every tile from "
            f"{R1.TILES[0]} to {R1.TILES[-1]}, both ways ({len(recs)} launches, {seconds:.1f} s)")
    return recs


# ---------------------------------------------------------------------------
# phase 8b: the product by a constant on the tensor cores (ops/mxu_ff.py)
# ---------------------------------------------------------------------------

INT8_TC_OPS_PER_S = 1.979e15  # the data sheet's dense int8 tensor-core rate
# u8 multiply-adds a row of the three products (a c: 32 x 64, t_lo mu: 32 x
# 32, m p: 32 x 64), as operations
MXU_TC_OPS = 2 * 32 * (64 + 32 + 64)
# the carry network a row on the int32 pipes: five carry chains of 16 columns
# (t_lo, m, the low halves' carry, the >= p test, the result) at 3 operations
# a column, and 80 pairs of byte columns combined at 2
MXU_INT_OPS = 5 * 16 * 3 + 80 * 2


def mxu_bound(name: str, rows: int, extra_bytes: int = 0):
    """bound_ms of the tensor-core product: a row in and a row out (and
    extra_bytes), against its tensor-core operations at the int8 rate and
    its carry network at the int32 rate."""
    t_bytes = (rows * KERNEL_TABLE[name][5] * ROW_BYTES + extra_bytes) / HBM_BYTES_PER_S
    t_ops = max(rows * MXU_TC_OPS / INT8_TC_OPS_PER_S, rows * MXU_INT_OPS / INT32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mxu_rows(nprng, b: int, dev):
    """b random reduced rows, the Montgomery forms of 0, 1 and p - 1 first."""
    a = random_field(nprng, b, dev)
    k = min(b, 3)
    a[:k] = limbs_from_numpy(ints_to_mont_limbs([0, 1, SPEC.p - 1][:k], SPEC), dev)
    return a


def mxu_phase(dev, logn: int, reps: int):
    """Phase 8b.  mxu_mul_const and mxu_mul_table (csrc/mxu.cuh) against
    their plain versions limb for limb, and timed in turns beside mont_mul
    and lm_mul_const at the same rows.  Returns their two records for the
    kernels line (launches 0: no path calls them)."""
    nprng = np.random.default_rng(0x3A7)
    n = 1 << logn
    n_pos = 1 << (logn // 2)
    batch = n // n_pos
    c_rand = mont(int(nprng.integers(1, 1 << 62)) ** 4 % SPEC.p)
    consts = {"random": c_rand, "0": 0, "1": mont(1), "p - 1": mont(SPEC.p - 1)}
    worst = {"mxu_mul_const": 0, "mxu_mul_table": 0}

    def held(name, got, want, what):
        err = outputs_equal([got], [want])
        worst[name] = max(worst[name], err)
        require(err == 0 and got.dtype == torch.int32,
                f"{name} equals its plain version {what} (max abs diff {err})")

    print("kernel mxu_mul_const, mxu_mul_table", flush=True)
    for b in (5003, n):
        a = mxu_rows(nprng, b, dev)
        for label, c in consts.items():
            held("mxu_mul_const", MX.mul_const(SPEC, a, c), MX.mul_const_plain(SPEC, a, c),
                 f"at B = {b}, c = {label} (rows 0, 1, p - 1 among them)")
    c_row = limbs_from_numpy(ints_to_limbs([c_rand]), dev)[0]  # the constant's limbs
    spot = a[:64]
    require(torch.equal(MX.mul_const(SPEC, spot, c_rand), ff(SPEC).mul(spot, c_row.expand(64, 16))),
            "mxu_mul_const equals FF.mul (mont_mul) by the constant broadcast on 64 rows")
    tables = {}
    for lead, pos in ((5, 8), (batch, n_pos)):
        table = random_field(nprng, pos, dev)
        table[1] = 0
        table[-1] = limbs_from_numpy(ints_to_mont_limbs([1], SPEC), dev)[0]
        at = mxu_rows(nprng, lead * pos, dev).reshape(lead, pos, N_LIMBS)
        tables[(lead, pos)] = (at, table)
        held("mxu_mul_table", MX.mul_table(SPEC, at, table), MX.mul_table_plain(SPEC, at, table),
             f"at ({lead}, {pos}), the table's rows 1 and {pos - 1} 0 and 1")

    # timing at n rows: the kernel, mont_mul by the constant as rows (made
    # outside the time) and by the broadcast view (_flatten's copy of it
    # inside the time), lm_mul_const (the constant by value, limb-major)
    a_lm = CN.to_lm(a)
    c_rows = c_row.expand(n, N_LIMBS).contiguous()
    c_view = c_row.expand(n, N_LIMBS)
    at, table = tables[(batch, n_pos)]
    fns = {"mxu_mul_const": lambda: MX.mul_const(SPEC, a, c_rand),
           "mxu_mul_table": lambda: MX.mul_table(SPEC, at, table),
           "mont_mul": lambda: ff(SPEC).mul(a, c_rows),
           "mont_mul, broadcast view": lambda: ff(SPEC).mul(a, c_view),
           "lm_mul_const": lambda: CN.lm_mul_const(SPEC, a_lm, c_rand)}
    ms, call = turns(dev, fns, reps)
    plain_ms = {}
    for name, fn in (("mxu_mul_const", lambda: MX.mul_const_plain(SPEC, a, c_rand)),
                     ("mxu_mul_table", lambda: MX.mul_table_plain(SPEC, at, table))):
        plain_ms[name] = float("inf")
        for _ in range(2):  # the first call also pays for PyTorch's own start-up
            t0 = time.perf_counter()
            fn()
            sync(dev)
            plain_ms[name] = min(plain_ms[name], (time.perf_counter() - t0) * 1e3)
    bounds = {"mxu_mul_const": mxu_bound("mxu_mul_const", n),
              "mxu_mul_table": mxu_bound("mxu_mul_table", n, n_pos * ROW_BYTES),
              "mont_mul": bound_ms("mont_mul", n),
              "mont_mul, broadcast view": bound_ms("mont_mul", n),
              "lm_mul_const": bound_ms("lm_mul_const", n)}
    for label in fns:
        b_ms, b_by = bounds[label]
        print(f"  time {label} at {n} rows: {ms[label]:.4f} ms on the device, "
              f"{call[label]:.4f} ms a call on the host, bound {b_ms:.5f} ms ({b_by}), share "
              f"{b_ms / ms[label]:.3f}", flush=True)
    recs = []
    for name, shape in (("mxu_mul_const", f"B = {n}"),
                        ("mxu_mul_table", f"({batch}, {n_pos}): {batch} rows at {n_pos} "
                                          f"positions")):
        b_ms, b_by = bounds[name]
        recs.append({"name": name, "route": "cuda", "source": CSRC + "mxu.cuh",
                     "replaces": f"{MXU_FF}:{KERNEL_TABLE[name][2]}", "launches": 0,
                     "max_abs_err": worst[name], "ms": ms[name], "plain_ms": plain_ms[name],
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "shape": shape,
                     "call_ms": call[name], "mont_mul_ms": ms["mont_mul"],
                     "mont_mul_broadcast_view_ms": ms["mont_mul, broadcast view"],
                     "lm_mul_const_ms": ms["lm_mul_const"],
                     "mxu_mul_const_ms": ms["mxu_mul_const"]})
        print(f"  time {name} at {shape}: kernel {ms[name]:.4f} ms on the device, plain "
              f"{plain_ms[name]:.1f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
    return recs


# ---------------------------------------------------------------------------
# phase 9: one full-width round of the witness
# ---------------------------------------------------------------------------

def fused_logns(slots: int):
    """The NTT sizes (log2) of the fused levels of a merge tree over `slots`
    points, in level order, and the number of levels."""
    m = (slots + 1) // 2
    la, lb, b_sem, levels, out = 2, 1, 1, 0, []
    while m > 1:
        b_sem *= 2
        if la >= D.FUSE_MIN_LA:
            out.append(D.fused_logn(la, lb))
        la, lb = b_sem + 1, b_sem
        m = (m + 1) // 2
        levels += 1
    return out, levels


def expected_round_launches(logns):
    f = len(logns)
    return {"lm_mul": 14 * f, "lm_addsub": 7 * f, "lm_mul_const": f,
            "stages_small": 6 * f, "stage_big": 6 * sum(max(0, l - 10) for l in logns)}


def horner(coeffs, x: int) -> int:
    p = SPEC.p
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def round_path(dev, pts: JPoint, carry_state, profile: bool):
    """One round of the witness at full width: round ROUND_K of the carry
    stage's points through _one_round_slots and
    compute_divisor_witness_partial.  Returns a dict of what it measured."""
    digits, carry_prev, carry_new = carry_state
    n = pts.x.shape[0]
    slots = BASE + n + 1
    k = ROUND_K
    E = ec(CURVE)
    logns, levels = fused_logns(slots)
    print(f"round: compute_divisor_witness_partial, round {k}, n = {n}, {slots} slots, "
          f"{levels} levels, {len(logns)} fused (NTT 2^{logns[0]} .. 2^{logns[-1]})", flush=True)
    t0 = time.perf_counter()
    for logn in logns:
        D._fused_consts_dev(CURVE, logn, dev)
    sync(dev)
    setup_s = time.perf_counter() - t0
    print(f"  host set-up: evaluation-domain constants and twiddle tables of the "
          f"{len(logns)} fused sizes, built and uploaded: {setup_s:.3f} s", flush=True)
    precomp = A.precompute_multiplicities(E, pts, BASE)

    def one_round():
        rp = A._one_round_slots(CURVE, BASE, digits[k], precomp,
                                A._at(carry_prev, k), A._at(carry_new, k))
        return rp, D.compute_divisor_witness_partial(CURVE, rp)

    one_round()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for i in range(2):
        CF.reset_launch_counts()
        D.reset_level_counts()
        t0 = time.perf_counter()
        rp, (w, out) = one_round()
        sync(dev)
        runs.append(time.perf_counter() - t0)
        if i == 0:
            counts, level_counts = dict(CF.LAUNCHES), dict(D.LEVEL_COUNTS)
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    print("  one round: runs of " + ", ".join(f"{r:.4f}" for r in runs) + " s", flush=True)
    print(f"  peak device memory of one round: {peak / 2**20:.0f} MiB", flush=True)
    print(f"  levels by route: {level_counts}", flush=True)
    want = expected_round_launches(logns)
    print("  launches: " + ", ".join(f"{name} {counts[name]} (expected {want[name]})"
                                     for name in ROUND_KERNELS)
          + "; " + ", ".join(f"{name} {counts[name]}" for name in CF.KERNELS
                             if name not in ROUND_KERNELS), flush=True)
    require(level_counts == {"coefficient": levels - len(logns), "fused": len(logns),
                             "fallback": 0},
            f"{len(logns)} levels took the fused tail, none the coefficient fallback")
    for name in ROUND_KERNELS:
        require(counts[name] == want[name] > 0,
                f"{name} was launched {counts[name]} times in the round, as counted")
    coefficient = levels - len(logns)
    for name in POLY_KERNELS:
        require(counts[name] == POLY_PER_LEVEL[name] * coefficient > 0,
                f"{name} was launched {counts[name]} times in the round, "
                f"{POLY_PER_LEVEL[name]} a coefficient level")
    require(counts["batch_inv"] > 0 and counts["mont_mul"] < PR6_ROUND_MONT_MUL,
            f"the round's inversions went through batch_inv ({counts['batch_inv']} launches): "
            f"mont_mul {counts['mont_mul']} launches, below the {PR6_ROUND_MONT_MUL} of the "
            f"chains of launches")
    require(counts["kate_div"] == 0 and counts["affine_lines_v1"] == 0,
            f"the first designs kate_div and affine_lines_v1 were not launched "
            f"({counts['kate_div']}, {counts['affine_lines_v1']})")
    require(counts["affine_lines"] == levels + 1 and counts["mont_mul"] == 0,
            f"affine_lines was launched once a level ({counts['affine_lines']} for the seeds "
            f"and {levels} merges), mont_mul not at all ({counts['mont_mul']})")

    require(bool(E.is_identity(JPoint(*(c[None] for c in out)))[0]),
            "the round's output is the identity (its slots sum to zero)")
    require(tuple(w.a.shape) == (n + 1, N_LIMBS) and tuple(w.b.shape) == (n, N_LIMBS),
            f"witness shapes {tuple(w.a.shape)}, {tuple(w.b.shape)}")

    # 64 sampled non-identity slots: a carry slot, the closing slot, 62 digit slots
    nprng = np.random.default_rng(0x5107)
    nz = (digits[k] != 0).nonzero().flatten().cpu().numpy()
    pick = [0, slots - 1] + [BASE + int(j) for j in nprng.choice(nz, 62, replace=False)]
    sel = JPoint(*(c[torch.tensor(pick, device=dev)] for c in rp))
    ax, ay, aid = E.to_affine(sel)
    require(not bool(aid.any()), "the 64 sampled slots are not the identity")
    vals = torch.cat([D.rf_eval(CURVE, w, ax[i:i + 8], ay[i:i + 8]) for i in range(0, 64, 8)])
    require(bool((vals == 0).all()),
            "the witness vanishes at the 64 sampled slots (rf_eval on the device; a "
            "carry slot and the closing slot among them)")
    host_pts = E.points_to_ints(JPoint(*(c[:2] for c in sel)))
    a_ints = mont_limbs_to_ints(limbs_to_numpy(w.a), SPEC)
    b_ints = mont_limbs_to_ints(limbs_to_numpy(w.b), SPEC)
    require(all((horner(a_ints, x) + y * horner(b_ints, x)) % SPEC.p == 0 for x, y in host_pts),
            "it vanishes at the carry slot and the closing slot by Python-int Horner too")
    del out, vals, a_ints, b_ints
    busy = device_busy_ms(dev, one_round) if dev.type == "cuda" else 0.0
    print(f"  device busy in one round: {busy:.3f} ms", flush=True)
    if profile:
        profile_round(dev, one_round)
    return {"n": n, "slots": slots, "levels": levels, "fused": len(logns), "runs": runs,
            "seconds": min(runs), "setup_s": setup_s, "peak": peak, "busy_ms": busy,
            "counts": counts, "rp": rp, "w": w, "carry_state": carry_state}


# ---------------------------------------------------------------------------
# phase 9b: launches by width over the main path, the redesigned kernels at
# the path's shapes, and mont_addsub and ec_add_fast against their first
# designs
# ---------------------------------------------------------------------------

def width_of(*rows) -> int:
    """Rows a wrapper's launch takes: the broadcast leading shape's size."""
    return math.prod(torch.broadcast_shapes(*(r.shape[:-1] for r in rows)))


_FIELD_LAYER = ("/ops/ff.py", "/ops/cuda_ff.py", "/ops/cuda_poly.py", "/ops/cuda_lines.py",
                "/chip_smoke.py")


def caller_of() -> str:
    """The nearest frame outside the field layer (ops/ff.py, the wrappers,
    the algorithms of ops/cuda_poly.py and ops/cuda_lines.py) and this
    script: "divisor.py:_head_lines" for the products and subtractions of
    the composed head, "ops/poly.py:add_padded" for a sum of coefficients."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if not path.endswith(_FIELD_LAYER):
            return f"{path.split('halo2_liam_eagen_msm_tpu_torch/', 1)[-1]}:{f.f_code.co_name}"
        f = f.f_back
    return "this script"


def mul_naive_key(a, b):
    """(pairs, La, Lb, a shared, b shared) of a poly_mul_naive launch (a
    shared operand is read once for all pairs)."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return (math.prod(lead), a.shape[-2], b.shape[-2], CP.shared_operand(a, lead),
            CP.shared_operand(b, lead))


# the kernels whose launches are tallied: name -> (the module of its wrapper,
# its tally key from the wrapper's arguments)
TALLY_KEYS = {
    "mont_mul": (CF, lambda spec, a, b: (width_of(a, b), caller_of())),
    "mont_addsub": (CF, lambda spec, is_sub, a, b: (width_of(a, b), caller_of())),
    "ec_add": (CF, lambda curve, *rows: width_of(*rows)),
    "ec_add_fast": (CF, lambda curve, *rows: width_of(*rows)),
    "ec_double": (CF, lambda curve, x1, y1, z1, k=1: (width_of(x1, y1, z1), k)),
    "batch_inv": (CF, lambda spec, a, chain=None:
                  (width_of(a), chain or CF.batch_inv_chain(width_of(a)))),
    "poly_mul_naive": (CP, lambda spec, a, b: mul_naive_key(a, b)),
    "kate_div": (CP, lambda spec, c, b: (width_of(c[..., 0, :], b), c.shape[-2])),
    "kate_div2": (CP, lambda spec, c, ra, rb: (width_of(c[..., 0, :], ra, rb), c.shape[-2])),
    "affine_lines": (CL, lambda spec, head, x, y, zinv:
                     (width_of(x[0], y[0], zinv[0]), "head" if head else "seeds")),
    "stages_small": (CN, lambda spec, x, tile, inverse, tw:
                     (x.shape[-1], tile, bool(inverse), tw.shape[-1] + 1)),
    "fused_madd_scan_xyzz": (CF, lambda curve, t_limbs, rows, w=CF.SCAN_W:
                             (rows.shape[0] // w, w)),
}
BY_CALLER = ("mont_mul", "mont_addsub")
TALLY_FORMAT = {"ec_double": "(B, k)", "batch_inv": "(rows, L)", "poly_mul_naive": "(pairs, La, Lb, a shared, b shared)",
                "stages_small": "(E, tile, inverse, n)", "fused_madd_scan_xyzz": "(g, W)",
                "kate_div": "(pairs, n)", "kate_div2": "(pairs, n)", "affine_lines": "(B, mode)"}


class Tally:
    """Counts the launches of the TALLY_KEYS wrappers by key while it is
    entered (the wrappers are wrapped for that time only): .counts[name] is
    {key: launches}."""

    def __enter__(self):
        self.counts = {name: {} for name in TALLY_KEYS}
        self.real = {name: getattr(mod, name) for name, (mod, _) in TALLY_KEYS.items()}
        for name, (mod, key_of) in TALLY_KEYS.items():
            setattr(mod, name, self._counting(name, key_of))
        return self

    def _counting(self, name, key_of):
        def fn(*args, **kwargs):
            key = key_of(*args, **kwargs)
            self.counts[name][key] = self.counts[name].get(key, 0) + 1
            return self.real[name](*args, **kwargs)
        return fn

    def __exit__(self, *exc):
        for name, (mod, _) in TALLY_KEYS.items():
            setattr(mod, name, self.real[name])
        return False


def by_caller(t: dict) -> dict:
    """{(B, caller): launches} -> {caller: {B: launches}}, the busiest first."""
    out = {}
    for (b, c), n in sorted(t.items()):
        out.setdefault(c, {})[b] = n
    return dict(sorted(out.items(), key=lambda kv: -sum(kv[1].values())))


def print_tally(name: str, by_phase: dict) -> None:
    if name in BY_CALLER:
        for phase, t in by_phase.items():
            print(f"{name} launches by caller and B, {phase}: " + "; ".join(
                f"{c} {sum(w.values())} (" + ", ".join(f"B = {b}: {n}" for b, n in w.items()) + ")"
                for c, w in by_caller(t).items()), flush=True)
        return
    what = TALLY_FORMAT.get(name, "B")
    fmt = (lambda key: f"B = {key}") if what == "B" else str
    print(f"{name} launches by {what}: " + "; ".join(
        f"{phase}: " + ", ".join(f"{fmt(key)}: {c}" for key, c in t.items())
        for phase, t in by_phase.items()), flush=True)


def round_k(pts: JPoint, rnd):
    """Round ROUND_K of the carry stage's points through _one_round_slots and
    compute_divisor_witness_partial, as a function of no arguments that
    returns the (witness, output) pair; the carry state is rnd's."""
    digits, carry_prev, carry_new = rnd["carry_state"]
    precomp = A.precompute_multiplicities(ec(CURVE), pts, BASE)
    k = ROUND_K

    def one_round():
        rp = A._one_round_slots(CURVE, BASE, digits[k], precomp,
                                A._at(carry_prev, k), A._at(carry_new, k))
        return D.compute_divisor_witness_partial(CURVE, rp)
    return one_round


def launch_tally(dev, base_pts, logn: int, pts: JPoint, rnd):
    """The launches of the TALLY_KEYS kernels by key (mont_mul and
    mont_addsub by B, rows a launch, and caller; the curve kernels by B;
    batch_inv by (rows, chain length); the coefficient levels' two by shape)
    over one MSM (the main path's inputs), one carry stage and one round
    (the round phase's); then the device's busy time of one MSM and one
    carry stage.  Returns ({kernel: {phase: {key: launches}}}, {phase: busy
    ms})."""
    _, scalars, _ = msm_inputs(dev, base_pts, logn)
    digits = rnd["carry_state"][0]
    phases = (("msm", lambda: M.best_multiexp(CURVE, scalars, pts)),
              ("carry stage", lambda: A._carries_only(CURVE, BASE, digits, pts)),
              ("round", round_k(pts, rnd)))
    out = {name: {} for name in TALLY_KEYS}
    for phase, fn in phases:
        with Tally() as tally:
            fn()
            sync(dev)
        for name, t in tally.counts.items():
            out[name][phase] = dict(sorted(t.items()))
    for name, by_phase in out.items():
        print_tally(name, by_phase)
    c = M.pick_window(1 << logn)
    windows = -(-CURVE.scalar_field.p.bit_length() // c)
    rounds = digits.shape[0]
    require(out["ec_double"]["msm"] == {(1, c): windows}
            and out["ec_double"]["carry stage"] == {(1, 2): rounds},
            f"ec_double: one launch of {c} doublings a window of the MSM ({windows}) and one "
            f"of 2 a round of the carry stage ({rounds}: carry * {BASE}); "
            f"{out['ec_double']['msm']}, {out['ec_double']['carry stage']}")
    busy, events = {}, {}
    for phase, fn in phases[:2]:
        busy[phase], events[phase] = device_profile(dev, fn)
    print(f"device busy: one MSM {busy['msm']:.3f} ms in {events['msm']} device events "
          f"(kernels, copies, fills), one carry stage {busy['carry stage']:.3f} ms in "
          f"{events['carry stage']}", flush=True)
    busy["events"] = events
    return out, busy


def key_launches(tally_of: dict, rounds: int) -> dict:
    """Launches by tally key on the main path, one MSM + one carry stage +
    `rounds` rounds like the tallied one (config 4 is the carry stage and
    its rounds)."""
    out = {}
    for phase, t in tally_of.items():
        for key, c in t.items():
            out[key] = out.get(key, 0) + c * (rounds if phase == "round" else 1)
    return dict(sorted(out.items()))


def path_launches(tally_of: dict, rounds: int) -> dict:
    """key_launches by width, widths of no rows left out; mont_mul's and
    mont_addsub's callers summed."""
    out = {}
    for key, c in key_launches(tally_of, rounds).items():
        b = key[0] if isinstance(key, tuple) else key
        if b:  # an empty launch enqueues nothing
            out[b] = out.get(b, 0) + c
    return dict(sorted(out.items()))


def addsub_edges():
    """Pairs (a, b) of reduced ints at the carry edges of a row: 0, 1 and
    p - 1 on both sides; a + b = p exactly; a - b = 0; a < b; words of all
    ones up to each 64-bit boundary, so that a carry or a borrow crosses every
    quarter of the row."""
    p = SPEC.p
    pairs = [(0, 0), (0, 1), (1, 0), (1, 1), (p - 1, p - 1), (p - 1, 1), (1, p - 1),
             (0, p - 1), (p - 1, 0)]
    pairs += [(x, p - x) for x in (1 << 64, 1 << 128, 1 << 192, 12345)]
    pairs += [(x, x) for x in (7, 1 << 64, (1 << 192) - 1)]
    pairs += [(5, 7), (1 << 64, (1 << 64) + 1)]
    for k in (1, 2, 3):
        pairs += [((1 << 64 * k) - 1, 1), (1 << 64 * k, 1), (1, (1 << 64 * k) - 1)]
    return pairs + [(p - 1, (1 << 192) - 1)]


def mont_addsub_by_width(dev, widths, launches: dict, reps: int):
    """mont_addsub (four lanes a row) against the plain version, add and
    subtract, at each width: random rows with the carry edges of
    addsub_edges in the first lanes, bit for bit, and the edge lanes against
    exact ints; device ms at each (a call adds and subtracts, so half of it
    is one launch)."""
    nprng = np.random.default_rng(0xAB4)
    edges = addsub_edges()
    ea = limbs_from_numpy(ints_to_limbs([x for x, _ in edges]), dev)
    eb = limbs_from_numpy(ints_to_limbs([y for _, y in edges]), dev)
    out = []
    for b in widths:
        a, c = random_field(nprng, b, dev), random_field(nprng, b, dev)
        k = min(b, len(edges))
        a[:k], c[:k] = ea[:k], eb[:k]
        both = lambda fn: (fn(SPEC, False, a, c), fn(SPEC, True, a, c))
        new, plain = both(CF.mont_addsub), both(CF.mont_addsub_plain)
        want = [limbs_to_ints(limbs_to_numpy(v[:k])) for v in new]
        exact = want == [[(x + y) % SPEC.p for x, y in edges[:k]],
                         [(x - y) % SPEC.p for x, y in edges[:k]]]
        require(outputs_equal(new, plain) == 0 and exact,
                f"mont_addsub == mont_addsub_plain at B = {b}, add and subtract; the first "
                f"{k} lanes (the carry edges) equal exact ints")
        ms = time_ms(dev, lambda: both(CF.mont_addsub), reps)[0] / 2
        b_ms, b_by = bound_ms("mont_addsub", b)
        out.append({"shape": f"B = {b}", "b": b, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                    "launches": launches.get(b, 0)})
        print(f"  mont_addsub at B = {b} ({launches.get(b, 0)} launches on the path): {ms:.4f} "
              f"ms on the device, bound {b_ms:.6f} ms ({b_by})", flush=True)
    return out


def mont_mul_by_width(dev, widths, launches: dict, reps: int):
    """mont_mul against its plain version at each width (random rows with the
    edge rows of field_inputs first), bit for bit; device ms at each."""
    nprng = np.random.default_rng(0xAB6)
    out = []
    for b in widths:
        a, c = field_inputs(nprng, b, dev)
        require(torch.equal(CF.mont_mul(SPEC, a, c), CF.mont_mul_plain(SPEC, a, c)),
                f"mont_mul == mont_mul_plain at B = {b}")
        ms = time_ms(dev, lambda: CF.mont_mul(SPEC, a, c), reps)[0]
        b_ms, b_by = bound_ms("mont_mul", b)
        out.append({"shape": f"B = {b}", "b": b, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                    "launches": launches.get(b, 0)})
        print(f"  mont_mul at B = {b} ({launches.get(b, 0)} launches on the path): {ms:.4f} ms "
              f"on the device, bound {b_ms:.6f} ms ({b_by})", flush=True)
    return out


def add_fast_oracle(got, hp, hq, what: str) -> None:
    """ec_add_fast's first lanes (those of curve_inputs' host lists) against
    the Python-int oracle: the doubling lanes flagged and nothing else (lane 3
    is one where there are five lanes), every other lane the sum."""
    k = len(hp)
    pts = ec(CURVE).points_to_ints(JPoint(*(c[:k] for c in got[:3])))
    want = [pyref.ec_add(a, b, CURVE) for a, b in zip(hp, hq)]
    doubling = [a is not None and a == b for a, b in zip(hp, hq)]
    require(got[3][:k].tolist() == doubling and (k < 5 or doubling[3]) and all(
        g == w for g, w, d in zip(pts, want, doubling) if not d),
        f"{what}: the first {k} lanes (p identity, q identity, both, P + P flagged, "
        f"P + (-P) among them) equal the Python-int oracle")


def ec_add_fast_by_width(dev, base_pts, widths, launches: dict, reps: int):
    """ec_add_fast (four lanes a point) against the plain version at each
    width, with the edge lanes of curve_inputs and the first 64 lanes
    against the Python-int oracle; device ms at each."""
    nprng = np.random.default_rng(0xAB5)
    out = []
    for b in widths:
        p, q, hp, hq = curve_inputs(nprng, base_pts, b, dev)
        args = (*p, *q)
        new = CF.ec_add_fast(CURVE, *args)
        require(outputs_equal(new, CF.ec_add_fast_plain(CURVE, *args)) == 0,
                f"ec_add_fast == ec_add_fast_plain at B = {b} (4 outputs)")
        add_fast_oracle(new, hp, hq, f"ec_add_fast at B = {b}")
        ms = time_ms(dev, lambda: CF.ec_add_fast(CURVE, *args), reps)[0]
        b_ms, b_by = bound_ms("ec_add_fast", b, b)
        out.append({"shape": f"B = {b}", "b": b, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                    "launches": launches.get(b, 0)})
        print(f"  ec_add_fast at B = {b} ({launches.get(b, 0)} launches on the path): {ms:.4f} "
              f"ms on the device, bound {b_ms:.6f} ms ({b_by})", flush=True)
    return out


def by_width(dev, base_pts, name: str, widths, launches: dict, reps: int):
    """ec_add against its plain version at each width, with the edge lanes
    of curve_inputs and the first 64 lanes against the Python-int oracle;
    device ms at each width."""
    nprng = np.random.default_rng(0xAB0)
    kernel, plain = getattr(CF, name), getattr(CF, name + "_plain")
    out = []
    for b in widths:
        p, q, hp, hq = curve_inputs(nprng, base_pts, b, dev)
        args = (*p, *q)
        got = kernel(CURVE, *args)
        k = len(hp)
        pts = ec(CURVE).points_to_ints(JPoint(*(c[:k] for c in got)))
        want = [pyref.ec_add(u, v, CURVE) for u, v in zip(hp, hq)]
        require(outputs_equal(got, plain(CURVE, *args)) == 0 and pts == want,
                f"{name} == {name}_plain at B = {b}, the first {k} lanes (edge lanes among "
                f"them) equal to the Python-int oracle")
        ms = time_ms(dev, lambda: kernel(CURVE, *args), reps)[0]
        b_ms, b_by = bound_ms(name, b)
        out.append({"shape": f"B = {b}", "b": b, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                    "launches": launches.get(b, 0)})
        print(f"  {name} at B = {b} ({launches.get(b, 0)} launches on the path): {ms:.4f} ms on "
              f"the device, bound {b_ms:.6f} ms ({b_by})", flush=True)
    return out


def turns(dev, fns: dict, reps: int):
    """Device ms and host ms a call (time_ms) of each function of fns
    ({label: fn}), timed in turns (the labels in order, then reversed) and
    averaged over the two turns.  Returns ({label: device ms}, {label: host
    ms a call})."""
    runs = {label: [] for label in fns}
    for label in [*fns, *reversed(fns)]:
        runs[label].append(time_ms(dev, fns[label], reps))
    return ({label: sum(d for d, _ in r) / len(r) for label, r in runs.items()},
            {label: sum(c for _, c in r) / len(r) for label, r in runs.items()})


# (B, k) ec_double is timed at besides the tally's: the Horner fold's c = 15,
# the carry stage's 2, one doubling
EC_DOUBLE_FIXED = ((1, 1), (1, 2), (1, 15))
# (g, w) of the stepwise scan of a 2^16-point window (time_window_routes'
# widest), where ec_madd_xyzz_fast is timed besides the fallback's shape
XYZZ_WIDE = (2048, 32)


def ec_double_by_key(dev, base_pts, keys, launches: dict, reps: int):
    """ec_double (four lanes a point, k doublings a launch) at each (B, k) of
    keys against its plain version and [2^k]P on Python ints (the first 64
    lanes, the edge lanes of curve_inputs among them), bit for bit; one
    launch timed.  Returns the records."""
    nprng = np.random.default_rng(0xAB0D)
    E = ec(CURVE)
    out = []
    for b, k in keys:
        p, _, hp, _ = curve_inputs(nprng, base_pts, b, dev)
        new = CF.ec_double(CURVE, *p, k=k)
        pts = E.points_to_ints(JPoint(*(c[:len(hp)] for c in new)))
        require(outputs_equal(new, CF.ec_double_plain(CURVE, *p, k=k)) == 0
                and pts == [pyref.ec_mul(u, 1 << k, CURVE) for u in hp],
                f"ec_double (k = {k}) == ec_double_plain at B = {b}; the first {len(hp)} "
                f"lanes (edge lanes among them) equal [2^{k}]P on Python ints")
        ms, call = time_ms(dev, lambda p=p, k=k: CF.ec_double(CURVE, *p, k=k), reps)
        b_ms, b_by = bound_ms("ec_double", b, stages=k)
        key = (b, k)
        out.append({"shape": f"B = {b}, k = {k}", "b": b, "k": k, "ms": ms, "call_ms": call,
                    "bound_ms": b_ms, "bound_by": b_by, "launches": launches.get(key, 0)})
        print(f"  ec_double at B = {b}, k = {k} ({launches.get(key, 0)} launches on the path): "
              f"{ms:.4f} ms a launch on the device; bound {b_ms:.7f} ms ({b_by}); host "
              f"{call:.4f} ms a call", flush=True)
    return out


def safe_scan_inputs(nprng, base_pts, g: int, w: int, dev):
    """A safe window's scan: g identity carries (every lane opens on the
    identity, as the path's do) and g*w affine rows of base points, 5 % of
    them affine identities; lane 3's second row equals its first (a
    doubling at step 1), lane 4's second is the negation of its first (the
    identity carry at step 2), lane 5 opens on an affine identity.  Returns
    (carries, qx, qy, mask, the first min(g, 8) lanes' rows as host
    points)."""
    n = g * w
    bx = limbs_from_numpy(ints_to_mont_limbs([p[0] for p in base_pts], SPEC), dev)
    by = limbs_from_numpy(ints_to_mont_limbs([p[1] for p in base_pts], SPEC), dev)
    idx = nprng.integers(0, len(base_pts), size=n)
    ident = nprng.random(n) < 0.05
    neg = np.zeros(n, dtype=bool)
    if g > 5 and w > 1:
        idx[3 * w + 1], idx[4 * w + 1] = idx[3 * w], idx[4 * w]
        ident[3 * w:3 * w + 2] = ident[4 * w:4 * w + 2] = False
        neg[4 * w + 1] = ident[5 * w] = True
    it = torch.from_numpy(idx).to(dev)
    qx, qy = bx[it], by[it]
    neg_t = torch.from_numpy(neg).to(dev)
    qy = torch.where(neg_t[:, None],
                     CF.mont_addsub_plain(SPEC, True, torch.zeros_like(qy), qy), qy)
    mask = torch.from_numpy(ident).to(dev)
    qx = torch.where(mask[:, None], torch.zeros_like(qx), qx)
    qy = torch.where(mask[:, None], torch.zeros_like(qy), qy)
    host = [None if ident[i] else pyref.ec_neg(base_pts[idx[i]], CURVE) if neg[i]
            else base_pts[idx[i]] for i in range(min(g, 8) * w)]
    carries = tuple(c.contiguous() for c in ec(CURVE).identity((g,), dev))
    return carries, qx, qy, mask, host


def ec_add_mixed_by_shape(dev, base_pts, logn: int, reps: int):
    """ec_add_mixed (two lanes a carry) at the shapes of a safe 2^logn
    window: its whole scan (g = 2^logn / w lanes of w = _pick_block_width
    steps, one launch; safe_scan_inputs) against the plain version's loop
    and the first 8 lanes' running sums on Python ints; and one step at B =
    g (mixed_inputs' edge lanes) against its plain version and the
    Python-int oracle.  Timed at each.  Returns the records."""
    nprng = np.random.default_rng(0xAB8)
    n = 1 << logn
    w = M._pick_block_width(n, True)
    g = -(-n // w)
    E = ec(CURVE)
    carries, qx, qy, mask, host = safe_scan_inputs(nprng, base_pts, g, w, dev)
    inner, totals = CF.ec_add_mixed_scan(CURVE, *carries, qx, qy, mask, w)
    sync(dev)
    t0 = time.perf_counter()
    want = CF.ec_add_mixed_scan_plain(CURVE, *carries, qx, qy, mask, w)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    lanes = len(host) // w
    got = E.points_to_ints(JPoint(*(c[:lanes * w] for c in inner)))
    running = []
    for j in range(lanes):
        acc = None
        for t in range(w):
            acc = pyref.ec_add(acc, host[j * w + t], CURVE)
            running.append(acc)
    require(outputs_equal(inner + totals, want[0] + want[1]) == 0 and got == running,
            f"ec_add_mixed's scan == ec_add_mixed_scan_plain (inner prefixes and totals) at "
            f"g = {g}, w = {w}; the first {lanes} lanes (q == carry, q == -carry, affine "
            f"identities among them) equal running sums on Python ints")
    ms, call = time_ms(dev, lambda: CF.ec_add_mixed_scan(CURVE, *carries, qx, qy, mask, w),
                       max(1, reps // 5))
    before = [torch.cat([c[:, None], i.reshape(g, w, N_LIMBS)[:, :-1]], dim=1).reshape(
        g * w, N_LIMBS) for c, i in zip(carries, inner)]
    doublings = mixed_doublings(*before, qx, qy)
    b_ms, b_by = mixed_bound(g * w, doublings, g * w + 6 * g * ROW_BYTES)
    recs = [{"shape": f"g = {g}, w = {w} (a window's scan)", "g": g, "w": w, "ms": ms,
             "call_ms": call, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "launches": 0, "doublings": doublings}]
    print(f"  ec_add_mixed, a safe window's scan, g = {g}, w = {w}: {ms:.4f} ms (one launch) "
          f"on the device; bound {b_ms:.5f} ms ({b_by}; {doublings} of the {g * w} steps take "
          f"the doubling); host {call:.4f} ms a call; plain {plain_ms:.1f} ms", flush=True)

    p, sx, sy, smask, hp, hq = mixed_inputs(nprng, base_pts, g, dev)
    args = (*p, sx, sy, smask)
    new = CF.ec_add_mixed(CURVE, *args)
    sync(dev)
    t0 = time.perf_counter()
    want = CF.ec_add_mixed_plain(CURVE, *args)
    sync(dev)
    step_plain_ms = (time.perf_counter() - t0) * 1e3
    k = len(hp)
    pts = E.points_to_ints(JPoint(*(c[:k] for c in new)))
    require(outputs_equal(new, want) == 0
            and pts == [pyref.ec_add(a, b, CURVE) for a, b in zip(hp, hq)],
            f"ec_add_mixed (one step) == ec_add_mixed_plain at B = {g}, the first {k} lanes "
            f"(edge lanes among them) equal to the Python-int oracle")
    ms1, call1 = time_ms(dev, lambda: CF.ec_add_mixed(CURVE, *args), reps)
    s_ms, s_by = mixed_bound(g, mixed_doublings(*args[:5]), g * (1 + 3 * ROW_BYTES))
    recs.append({"shape": f"B = {g}, w = 1 (a step)", "g": g, "w": 1, "ms": ms1,
                 "call_ms": call1, "plain_ms": step_plain_ms, "bound_ms": s_ms,
                 "bound_by": s_by, "launches": 0})
    print(f"  ec_add_mixed, one step at B = {g}: {ms1:.4f} ms on the device; bound {s_ms:.5f} "
          f"ms ({s_by}); host {call1:.4f} ms a call; plain {step_plain_ms:.1f} ms", flush=True)
    return recs


def xyzz_scan_ab(dev, base_pts, keys, reps: int):
    """ec_madd_xyzz_fast's scan (four lanes a carry, w steps a launch) at each
    (g, w) of keys (xyzz_scan_inputs' edges) against its plain version, limb
    for limb and flag for flag; timed in turns with one launch of the fused
    scan's kernel at the same (g, w) (two lanes a carry, the same formula
    from T on the same rows, packed).  Returns the records."""
    nprng = np.random.default_rng(0xAB7)
    t_limbs = scan_t_limbs()
    out = []
    for g, w in keys:
        args, _, _ = xyzz_scan_inputs(nprng, base_pts, g, w, dev)
        new = flatten_outs(CF.ec_madd_xyzz_fast_scan(CURVE, *args, w))
        sync(dev)
        t0 = time.perf_counter()
        want = flatten_outs(CF.ec_madd_xyzz_fast_scan_plain(CURVE, *args, w))
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        require(outputs_equal(new, want) == 0 and new[8].nonzero().flatten().tolist() == [0, 3, 4],
                f"ec_madd_xyzz_fast's scan == ec_madd_xyzz_fast_scan_plain at g = {g}, w = {w} "
                f"(inner, totals, flags), lanes 0, 3 and 4 flagged and no other")
        rows = M._pack_pair(args[4], args[5]).contiguous()
        ms, call = turns(dev, {
            "four lanes": lambda args=args, w=w: CF.ec_madd_xyzz_fast_scan(CURVE, *args, w),
            "two lanes": lambda rows=rows, w=w: CF.fused_madd_scan_xyzz(CURVE, t_limbs, rows, w)},
            reps)
        b_ms, b_by = xyzz_bound(g, w)
        out.append({"shape": f"g = {g}, w = {w}", "g": g, "w": w, "ms": ms["four lanes"],
                    "two_lane_ms": ms["two lanes"], "call_ms": call["four lanes"],
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "launches": 0})
        print(f"  A/B ec_madd_xyzz_fast at g = {g}, w = {w}: {ms['four lanes']:.4f} ms (one "
              f"launch, four lanes a carry) on the device; two lanes a carry "
              f"(fused_madd_scan_xyzz at the same g, w) {ms['two lanes']:.4f} ms; bound "
              f"{b_ms:.6f} ms ({b_by}); host {call['four lanes']:.4f} ms a call; plain "
              f"{plain_ms:.1f} ms", flush=True)
    return out


# (log2 n, E) of the fused levels of a 2^20 round, timed at every --logn
STAGES_SMALL_FIXED = ((7, 1 << 20), (9, 1 << 20), (10, 1 << 20), (21, 1 << 21))
# the fixed sizes batch_inv is timed at besides the tally's, and the most rows
# of a tallied shape held against FF._inv_host (about 120 us a row)
BATCH_INV_FIXED = (33, 512, 700, 1 << 16)
BATCH_INV_HOST_ROWS = 2048


def stages_small_by_shape(dev, keys, launches: dict, reps: int):
    """stages_small (register-blocked) against its plain version at each
    (E, tile, inverse, n) of keys (the tally's and the fused levels' of a
    2^20 round); device ms at each."""
    nprng = np.random.default_rng(0xAB1)
    out = []
    for key in keys:
        e, tile, inverse, n = key
        x = lm_inputs(nprng, e, dev, EDGES_A)
        tw = CN.tables(SPEC, n.bit_length() - 1, inverse, dev)
        shape = f"n = {n}, tile = {tile}, E = {e}, {'inverse' if inverse else 'forward'}"
        require(torch.equal(CN.stages_small(SPEC, x, tile, inverse, tw),
                            CN.stages_small_plain(SPEC, x, tile, inverse, tw)),
                f"stages_small == stages_small_plain at {shape}")
        ms = time_ms(dev, lambda: CN.stages_small(SPEC, x, tile, inverse, tw), reps)[0]
        b_ms, b_by = bound_ms("stages_small", e, (tile - 1) * ROW_BYTES, tile.bit_length() - 1)
        out.append({"shape": shape, "key": list(key), "ms": ms, "bound_ms": b_ms,
                    "bound_by": b_by, "launches": launches.get(key, 0)})
        print(f"  stages_small at {shape} ({launches.get(key, 0)} launches on the path): "
              f"{ms:.4f} ms on the device, bound {b_ms:.5f} ms ({b_by})", flush=True)
    return out


def batch_inv_by_size(dev, keys, fixed, launches: dict, reps: int):
    """batch_inv (one launch an inversion) against its plain version at each
    (rows, chain length) of keys, zeros at rows 0, n // 2 and n - 1, and
    against FF._inv_host: the keys of `fixed` up to 2^16 rows on every row,
    above on every 32nd row and the last; the tally's other shapes on at
    most BATCH_INV_HOST_ROWS rows, evenly spread, and the last; device ms at
    each."""
    nprng = np.random.default_rng(0xAB2)
    out = []
    for n, L in keys:
        a = zero_laced(nprng, n, dev)
        new = CF.batch_inv(SPEC, a, chain=L)
        rows = torch.arange(n, device=dev)
        step = (1 if n <= 1 << 16 else 32) if (n, L) in fixed else -(-n // BATCH_INV_HOST_ROWS)
        if step > 1:
            rows = torch.cat([rows[::step], rows[-1:]])
        host = ff(SPEC)._inv_host(a[rows].cpu())
        require(torch.equal(new, CF.batch_inv_plain(SPEC, a, chain=L))
                and torch.equal(new[rows].cpu(), host),
                f"batch_inv (L = {L}) == batch_inv_plain at n = {n}, zeros at rows 0, "
                f"{n // 2} and {n - 1}; == FF._inv_host at {rows.numel()} rows")
        ms = time_ms(dev, lambda: CF.batch_inv(SPEC, a, chain=L), reps)[0]
        b_ms, b_by = bound_ms("batch_inv", n, muls=inv_muls(n))
        out.append({"shape": f"n = {n}, L = {L}", "key": [n, L], "ms": ms, "bound_ms": b_ms,
                    "bound_by": b_by, "launches": launches.get((n, L), 0)})
        print(f"  batch_inv at n = {n} (L = {L}, {launches.get((n, L), 0)} launches on the "
              f"path): {ms:.4f} ms on the device, bound {b_ms:.5f} ms ({b_by})", flush=True)
    return out


def fused_scan_by_g(dev, base_pts, gs, launches: dict, reps: int):
    """fused_madd_scan_xyzz (two lanes a carry) against its plain version at
    g carries of 64 rows, with zero rows and lane 5 opening with -T (the only
    flagged lane); device ms at each."""
    nprng = np.random.default_rng(0xAB3)
    w = CF.SCAN_W
    t_limbs = scan_t_limbs()
    out = []
    for g in gs:
        rows = scan_rows(nprng, base_pts, g, w, dev)
        new = flatten_outs(CF.fused_madd_scan_xyzz(CURVE, t_limbs, rows, w))
        plain = flatten_outs(CF.fused_madd_scan_xyzz_plain(CURVE, t_limbs, rows, w))
        require(outputs_equal(new, plain) == 0 and new[8].nonzero().flatten().tolist() == [5],
                f"fused_madd_scan_xyzz == fused_madd_scan_xyzz_plain at W = {w}, g = {g} "
                f"(9 outputs), lane 5 flagged and no other")
        ms = time_ms(dev, lambda: CF.fused_madd_scan_xyzz(CURVE, t_limbs, rows, w), reps)[0]
        b_ms, b_by = bound_ms("fused_madd_scan_xyzz", g * w, g * (4 * ROW_BYTES + 1))
        out.append({"shape": f"W = {w}, g = {g}", "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                    "launches": launches.get((g, w), 0)})
        print(f"  fused_madd_scan_xyzz at W = {w}, g = {g} ({launches.get((g, w), 0)} launches "
              f"on the path): {ms:.4f} ms on the device, bound {b_ms:.5f} ms ({b_by})",
              flush=True)
    return out


RULE2_KERNELS = ("mont_mul", "mont_addsub", "ec_add_fast", "ec_double", "poly_mul_naive",
                 "kate_div2", "kate_div", "affine_lines", "affine_lines_v1", "stages_small",
                 "batch_inv", "fused_madd_scan_xyzz", "ec_add", "ec_add_mixed", "radix_rank",
                 "radix_pass_b")


def rule2_ranking(ab: dict) -> dict:
    """Launches x (device ms - bound) over the main path, summed over the
    shapes timed, for the kernels of RULE2_KERNELS, and two shares of the
    bound that the rule (a kernel at half its bound or more is left alone)
    may read: by launch, the mean over launches of bound / ms; by time, the
    sum of launches x bound over the sum of launches x ms."""
    out = {}
    for name in RULE2_KERNELS:
        recs = ab[name]
        launches = sum(r["launches"] for r in recs)
        out[name] = {
            "launches": launches,
            "gap_ms": sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in recs),
            "bound_share_by_launch":
                sum(r["launches"] * r["bound_ms"] / r["ms"] for r in recs) / max(launches, 1),
            "bound_share_by_time": sum(r["launches"] * r["bound_ms"] for r in recs) /
                max(sum(r["launches"] * r["ms"] for r in recs), 1e-12)}
    for name, r in sorted(out.items(), key=lambda kv: -kv[1]["gap_ms"]):
        print(f"  rule-2 ranking: {name}: {r['launches']} launches on the main path, launches x "
              f"(ms - bound) = {r['gap_ms']:.3f} ms, share of the bound by launch "
              f"{r['bound_share_by_launch']:.3f}, by time {r['bound_share_by_time']:.3f}",
              flush=True)
    return out


def ab_phase(dev, base_pts, tally, lines_in: dict, logn: int, ragged: int, row_shapes: dict,
             radix_recs: dict, reps: int):
    """Phase 9b.  mont_mul, mont_addsub and ec_add_fast against their plain
    versions at every width the tally gives them (mont_addsub and
    ec_add_fast at their kernel-phase shape and the ragged size too),
    ec_double at every width the tally gives it; poly_mul_naive at every
    shape the tally gives it against its plain version (poly_by_shape);
    kate_div2 at every shape against its plain version and its first
    design's route, kate_div launched twice, timed in turns with it
    (kate_div_ab); affine_lines at every width against its plain version
    and its first design, the two timed in turns (affine_lines_by_width).
    Then the kernels redesigned before against their plain versions at every shape the tally gives them: ec_add at
    every width (and 2048), stages_small at every (E, tile, direction, n)
    (and the fused levels' shapes of a 2^20 round), batch_inv at every
    (rows, chain length) (and n = 33, 512, 700, 2^16 and 2^(logn + 1)), the
    fused scan at every g (and 256 and 4096).  ec_double at every (B, k) of
    the tally and EC_DOUBLE_FIXED (ec_double_by_key), ec_add_mixed at a safe
    window's shapes (ec_add_mixed_by_shape) and ec_madd_xyzz_fast's scan
    against its plain version, timed beside the fused scan's kernel
    (xyzz_scan_ab).  Last, the rule-2 ranking of
    the sixteen (the first designs kate_div and affine_lines_v1 among them,
    with no launch) over the main path (one MSM, one carry stage and 56 rounds
    like the tallied one): ec_add_mixed, radix_rank and radix_pass_b with no
    launch there (the safe flavor is a fallback, the radix route is off),
    the radix kernels at phase 12's full plan (radix_recs).  Returns
    ({kernel: per-shape records}, the ranking)."""
    rounds = A.num_digits_for(CURVE, BASE)
    on_path = {name: path_launches(tally[name], rounds)
               for name in ("mont_mul", "mont_addsub", "ec_add", "ec_add_fast")}
    by_key = {name: key_launches(tally[name], rounds)
              for name in ("stages_small", "batch_inv", "fused_madd_scan_xyzz", "ec_double")}
    for name in ("mont_mul", "mont_addsub", "ec_add_fast", "ec_add"):
        total = sum(on_path[name].values())
        tenth = [b for b, c in on_path[name].items() if 10 * c >= total]
        print(f"{name}: {total} launches on the main path at {len(on_path[name])} widths; a "
              f"tenth or more at B = {tenth}, the widest B = {max(on_path[name])}", flush=True)
    out = {
        "mont_mul": mont_mul_by_width(dev, sorted(on_path["mont_mul"]), on_path["mont_mul"], reps),
        "mont_addsub": mont_addsub_by_width(
            dev, sorted(set(on_path["mont_addsub"]) | {row_shapes["mont_addsub"], ragged}),
            on_path["mont_addsub"], reps),
        "ec_add_fast": ec_add_fast_by_width(
            dev, base_pts,
            sorted(set(on_path["ec_add_fast"]) | {row_shapes["ec_add_fast"], ragged}),
            on_path["ec_add_fast"], reps),
        "ec_double": ec_double_by_key(dev, base_pts,
                                      sorted(set(EC_DOUBLE_FIXED) | set(by_key["ec_double"])),
                                      by_key["ec_double"], reps),
        "ec_add_mixed": ec_add_mixed_by_shape(dev, base_pts, logn, reps),
    }
    out["ec_madd_xyzz_fast"] = xyzz_scan_ab(
        dev, base_pts, [row_shapes["ec_madd_xyzz_fast"], XYZZ_WIDE], reps)
    out["poly_mul_naive"] = poly_by_shape(dev, "poly_mul_naive",
                                          tally["poly_mul_naive"]["round"], rounds, reps)
    out["kate_div2"], out["kate_div"] = kate_div_ab(dev, tally["kate_div2"]["round"], rounds,
                                                    reps)
    out["affine_lines"], out["affine_lines_v1"] = affine_lines_by_width(
        dev, base_pts, lines_in, tally["affine_lines"]["round"], rounds, reps)
    g = max(1, (1 << logn) // CF.SCAN_W)
    small = {(e, min(1 << ln, CN.BLOCK), inverse, 1 << ln)
             for ln, e in STAGES_SMALL_FIXED for inverse in (False, True)}
    inv_fixed = {(n, CF.batch_inv_chain(n)) for n in BATCH_INV_FIXED + (1 << (logn + 1),)}
    out.update({
        "ec_add": by_width(dev, base_pts, "ec_add", sorted(set(on_path["ec_add"]) | {2048}),
                           on_path["ec_add"], reps),
        "stages_small": stages_small_by_shape(dev, sorted(small | set(by_key["stages_small"])),
                                              by_key["stages_small"], max(1, reps // 5)),
        "batch_inv": batch_inv_by_size(
            dev, sorted(inv_fixed | {k for k in by_key["batch_inv"] if k[0]}), inv_fixed,
            by_key["batch_inv"], max(1, reps // 5)),
        "fused_madd_scan_xyzz": fused_scan_by_g(
            dev, base_pts, sorted({256, 4096, g} | {k[0] for k in by_key["fused_madd_scan_xyzz"]}),
            by_key["fused_madd_scan_xyzz"], max(1, reps // 10)),
    })
    for name, rec in radix_recs.items():
        out[name] = [{"shape": rec["shape"], "launches": 0, "ms": rec["ms"],
                      "bound_ms": rec["bound_ms"]}]
    return out, rule2_ranking(out)


def radix_rule2(radix_recs: dict, plans: dict, radix: dict) -> dict:
    """radix_rank and radix_pass_b in the rule-2 ranking on their own path:
    launches x (ms - bound) over one radix-route MSM (phase 13's launch
    counts), each window at its plan's time from phase 12 (the top window at
    its split width where it is split off)."""
    out = {}
    for name, rec in radix_recs.items():
        rows = {r["plan"]: r for r in rec["radix_ab"]}
        launches = radix["radix"]["counts"][name]
        per_plan = {plans["full"]: launches}
        if radix["split"]:
            per_plan = {plans["full"]: launches - 1, plans["top"]: 1}
        loss = sum(k * (rows[key]["ms"] - rows[key]["bound_ms"]) for key, k in per_plan.items())
        bound = sum(k * rows[key]["bound_ms"] for key, k in per_plan.items())
        share = bound / sum(k * rows[key]["ms"] for key, k in per_plan.items())
        out[name] = {"launches_radix_msm": launches, "gap_ms_radix_msm": loss,
                     "bound_share_by_time_radix_msm": share}
        print(f"  rule-2 ranking, radix route: {name}: 0 launches on the main path (the route "
              f"is off); {launches} launches a radix-route MSM ({per_plan}), launches x (ms - "
              f"bound) = {loss:.3f} ms a radix-route MSM, share of the bound by time "
              f"{share:.3f}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9c: the coefficient levels' two kernels and the merge head's at a
# ragged shape and the round's heaviest, against their plain versions
# ---------------------------------------------------------------------------

PMUL_TERM_MADDS = 64     # a term of a lazy sum: its 512-bit product, 8 x 8 words
PMUL_OUTPUT_MADDS = 72   # an output: REDC's 8 x 8 word products and its 8 m words


def mul_naive_bound(key):
    """poly_mul_naive's bound at (pairs, La, Lb, a shared, b shared): the
    function needs La Lb 512-bit products summed lazily into their column
    and one reduction a column (La + Lb - 1 a pair), in word multiply-adds
    as a fraction of a field product's (MUL_OPS); each input row read once
    (a shared operand once for all pairs), La + Lb - 1 rows written a pair."""
    pairs, la, lb, sa, sb = key
    nout = la + lb - 1
    rows = (la if sa else pairs * la) + (lb if sb else pairs * lb) + pairs * nout
    madds = PMUL_TERM_MADDS * la * lb + PMUL_OUTPUT_MADDS * nout
    return bound_ms("poly_mul_naive", pairs, rows * ROW_BYTES, muls=madds / (MUL_OPS / 2),
                    adds=0)


def kate_div_bound(key):
    """kate_div's bound at (pairs, n): n - 1 products and adds a pair; n
    coefficient rows and one root read, n rows written a pair."""
    pairs, n = key
    return bound_ms("kate_div", pairs, pairs * (2 * n + 1) * ROW_BYTES, muls=n - 1, adds=n - 1)


def kate_div2_bound(key):
    """kate_div2's bound at (pairs, n): 2 (n - 1) products and adds a pair;
    n coefficient rows and two roots read, n rows written a pair."""
    pairs, n = key
    return bound_ms("kate_div2", pairs, pairs * (2 * n + 2) * ROW_BYTES, muls=2 * (n - 1),
                    adds=2 * (n - 1))


def raw_rows(vals, dev):
    """Python ints -> (len, 16) limbs taken as they are (no Montgomery form)."""
    return limbs_from_numpy(ints_to_limbs(vals), dev)


def mul_naive_inputs(nprng, key, dev):
    """Operands of a poly_mul_naive shape: random rows, a shared operand as
    one row of terms expanded over the pairs (as rf_mul passes it); raw
    limbs of p - 1 in every term of pair 0 (the longest anti-diagonal sums
    min(La, Lb) such products) and zero terms in pair 1 of each operand of
    its own; where both are the pairs' own and a diagonal has K = min(La, Lb)
    >= 3 products, pairs from 2 on with diagonal K - 1 built so that the
    lazy sum's reduction is at its edges (cuda_poly.reduction_edges)."""
    pairs, la, lb, sa, sb = key

    def operand(length, shared):
        if shared:
            return random_field(nprng, length, dev)[None].expand(pairs, length, N_LIMBS)
        t = random_field(nprng, pairs * length, dev).reshape(pairs, length, N_LIMBS)
        t[0] = raw_rows([SPEC.p - 1], dev)
        if pairs > 1:
            t[1, ::2] = 0
        return t
    a, b = operand(la, sa), operand(lb, sb)
    k = min(la, lb)
    if not (sa or sb) and k >= 3:
        for g, (xe, ye) in enumerate(CP.reduction_edges(SPEC, k)[:pairs - 2], start=2):
            a[g, :k], b[g, :k] = raw_rows(xe, dev), raw_rows(ye, dev)
    return a, b


def kate_div_inputs(nprng, key, dev):
    """(coefficients, roots) of a kate_div shape: random rows; pair 0 all raw
    p - 1 (root too), pair 1 the root 0 (the shift), pair 2 zero
    coefficients."""
    pairs, n = key
    c = random_field(nprng, pairs * n, dev).reshape(pairs, n, N_LIMBS)
    b = random_field(nprng, pairs, dev)
    c[0], b[0] = raw_rows([SPEC.p - 1], dev), raw_rows([SPEC.p - 1], dev)[0]
    if pairs > 2:
        b[1] = 0
        c[2, ::3] = 0
    return c, b


def kate_div2_inputs(nprng, key, dev):
    """(coefficients, ra, rb) of a kate_div2 shape: kate_div_inputs' pairs
    with ra their root (pair 0 all raw p - 1, pair 1 ra = 0, pair 2 zero
    coefficients), rb random but for raw p - 1 in pair 0, rb = 0 in pair 2
    and rb = ra in pair 3."""
    c, ra = kate_div_inputs(nprng, key, dev)
    rb = random_field(nprng, key[0], dev)
    rb[0] = raw_rows([SPEC.p - 1], dev)[0]
    if key[0] > 3:
        rb[2] = 0
        rb[3] = ra[3]
    return c, ra, rb


def kate_div2_v1(c, ra, rb):
    """kate_div2's first design's route: kate_div launched twice."""
    return CP.kate_div(SPEC, CP.kate_div(SPEC, c, ra), rb)


POLY_CALLS = {
    # name: (kernel, plain version, inputs, bound)
    "poly_mul_naive": (lambda a, b: CP.poly_mul_naive(SPEC, a, b),
                       lambda a, b: CP.poly_mul_naive_plain(SPEC, a, b),
                       mul_naive_inputs, mul_naive_bound),
    "kate_div2": (lambda c, ra, rb: CP.kate_div2(SPEC, c, ra, rb),
                  lambda c, ra, rb: CP.kate_div2_plain(SPEC, c, ra, rb),
                  kate_div2_inputs, kate_div2_bound),
    "kate_div": (lambda c, b: CP.kate_div(SPEC, c, b),
                 lambda c, b: CP.kate_div_plain(SPEC, c, b),
                 kate_div_inputs, kate_div_bound),
}


def poly_vs_ints(name: str, args, got, pairs: int = 3) -> bool:
    """The first pairs of a poly kernel's output against Python-int Poly."""
    def ints(t):
        return mont_limbs_to_ints(limbs_to_numpy(t), SPEC)
    for i in range(min(pairs, got.shape[0])):
        if name == "poly_mul_naive":
            want = PolyInts(SPEC, ints(args[0][i])).mul_naive(PolyInts(SPEC, ints(args[1][i])))
            if ints(got[i]) != want.coeffs:
                return False
            continue
        c = PolyInts(SPEC, ints(args[0][i]))
        for r in args[1:]:
            c = c.kate_div(ints(r[i:i + 1])[0])
        if ints(got[i]) != c.coeffs + [0] * min(got.shape[1], len(args) - 1):
            return False
    return True


def check_poly_kernels(dev, row_keys: dict, ragged_keys: dict, reps: int):
    """poly_mul_naive, kate_div2 and kate_div against their plain versions
    at a ragged shape and at the shape of the most launches on the path
    (kate_div's: kate_div2's), with the edge pairs of their inputs, the
    first pairs against Python-int Poly too, kate_div2 against kate_div
    launched twice; timed at the latter.  Returns their records for the JSON
    line."""
    nprng = np.random.default_rng(0xC0EF)
    recs = []
    for name, (kernel, plain, inputs, bound) in POLY_CALLS.items():
        def host(key, args, got, name=name):
            require(poly_vs_ints(name, args, got[0], pairs=4),
                    f"{name}: the first four pairs (raw p - 1 everywhere, zero terms or a "
                    f"root 0) equal the Python-int Poly at {key}")
            if name == "kate_div2":
                require(torch.equal(got[0], kate_div2_v1(*args)),
                        f"kate_div2 equals kate_div launched twice at {key}")
        recs.append(check_kernel(
            dev, name, lambda *a, k=kernel: (k(*a),), lambda *a, p=plain: (p(*a),),
            lambda key, f=inputs: f(nprng, key, dev), [ragged_keys[name], row_keys[name]],
            reps, host_check=host, bound_of=bound))
    return recs


def poly_by_shape(dev, name: str, round_tally: dict, rounds: int, reps: int):
    """`name` at every shape one round gives it: equal to its plain version,
    limb for limb, the first three pairs to Python-int Poly; device ms.
    Launches on the main path: a round's x `rounds`."""
    nprng = np.random.default_rng(0xAB7)
    kernel, plain, inputs, bound = POLY_CALLS[name]
    out = []
    for key, count in round_tally.items():
        args = inputs(nprng, key, dev)
        new = kernel(*args)
        require(torch.equal(new, plain(*args)) and poly_vs_ints(name, args, new),
                f"{name} == {name}_plain at {key}, edge pairs included; the first pairs "
                f"equal the Python-int Poly")
        reps_here = max(1, reps // 10)
        rec = {"shape": str(key), "key": list(key)}
        rec["ms"], rec["call_ms"] = time_ms(dev, lambda: kernel(*args), reps_here)
        b_ms, b_by = bound(key)
        rec.update(bound_ms=b_ms, bound_by=b_by, launches=count * rounds)
        out.append(rec)
        print(f"  {name} at {key} ({count} a round): {rec['ms']:.4f} ms on the device; "
              f"{rec['call_ms']:.4f} ms a call on the host; bound {b_ms:.5f} ms ({b_by})",
              flush=True)
    return out


def kate_div_ab(dev, round_tally: dict, rounds: int, reps: int):
    """kate_div2 at every shape one round gives it: equal to its plain
    version and to its first design's route (kate_div launched twice), limb
    for limb, edge pairs included, the first four pairs to Python-int Poly;
    device ms of kate_div2, of the route and of one kate_div launch, in
    turns, and of kate_div2 and the route at one pair (one chain's latency).
    Launches on the main path: a round's x `rounds` (kate_div: none).
    Returns (kate_div2's records, kate_div's)."""
    nprng = np.random.default_rng(0xAB9)
    new_recs, old_recs = [], []
    for key, count in round_tally.items():
        c, ra, rb = kate_div2_inputs(nprng, key, dev)
        new = CP.kate_div2(SPEC, c, ra, rb)
        require(torch.equal(new, CP.kate_div2_plain(SPEC, c, ra, rb))
                and torch.equal(new, kate_div2_v1(c, ra, rb))
                and poly_vs_ints("kate_div2", (c, ra, rb), new, pairs=4),
                f"kate_div2 == kate_div2_plain == kate_div launched twice at {key}, edge pairs "
                f"included (raw p - 1, ra = 0, rb = 0, ra = rb); the first pairs equal the "
                f"Python-int Poly")
        reps_here = max(1, reps // 10)
        ms, call = turns(dev, {"v2": lambda: CP.kate_div2(SPEC, c, ra, rb),
                               "v1": lambda: kate_div2_v1(c, ra, rb),
                               "one": lambda: CP.kate_div(SPEC, c, ra)}, reps_here)
        one = (c[:1], ra[:1], rb[:1])
        chain, _ = turns(dev, {"v2": lambda: CP.kate_div2(SPEC, *one),
                               "v1": lambda: kate_div2_v1(*one)}, reps_here)
        b2, by2 = kate_div2_bound(key)
        b1, by1 = kate_div_bound(key)
        new_recs.append({"shape": str(key), "key": list(key), "ms": ms["v2"],
                         "call_ms": call["v2"], "v1_ms": ms["v1"], "v1_call_ms": call["v1"],
                         "bound_ms": b2, "bound_by": by2, "v1_bound_ms": 2 * b1,
                         "launches": count * rounds, "chain_ms": chain["v2"],
                         "v1_chain_ms": chain["v1"]})
        old_recs.append({"shape": str(key), "key": list(key), "ms": ms["one"],
                         "call_ms": call["one"], "bound_ms": b1, "bound_by": by1, "launches": 0,
                         "route_ms": ms["v1"]})
        print(f"  A/B kate_div2 at {key} ({count} a round): v2 {ms['v2']:.4f} ms, v1 (kate_div "
              f"twice) {ms['v1']:.4f} ms ({ms['v1'] / ms['v2']:.2f}x), one kate_div "
              f"{ms['one']:.4f} ms on the device; bound {b2:.5f} ms ({by2}), v1's "
              f"{2 * b1:.5f} ms; one pair: v2 {chain['v2']:.4f}, v1 {chain['v1']:.4f} ms; "
              f"host ms a call: v2 {call['v2']:.4f}, v1 {call['v1']:.4f}", flush=True)
    return new_recs, old_recs


def lines_inputs(nprng, base_pts, b: int, dev):
    """affine_lines' inputs at b slots, {head: (x, y, zinv)}: the two
    batches of curve_inputs (edge slots 0..4: p identity, q identity, both,
    q == p, q == -p) as (p, q, p + q) for the head and (p, q, -(p + q)) for
    the seeds, the three Z inverted at once."""
    p, q, _, _ = curve_inputs(nprng, base_pts, b, dev)
    out = JPoint(*CF.ec_add(CURVE, *p, *q))
    neg = JPoint(out.x, CF.mont_addsub(SPEC, True, torch.zeros_like(out.y), out.y), out.z)
    ins = {}
    for head, third in ((True, out), (False, neg)):
        x, y, z = (torch.stack(c) for c in zip(p, q, third))
        ins[head] = (x, y, CF.batch_inv(SPEC, z))
    return ins


def capture_lines_inputs(pts: JPoint, rnd):
    """The inputs of every affine_lines launch of round ROUND_K, by (B,
    mode), cloned: the data the path gives the kernel."""
    real, out = CL.affine_lines, {}

    def recording(spec, head, x, y, zinv):
        key = (width_of(x[0], y[0], zinv[0]), "head" if head else "seeds")
        out[key] = (head, x.clone(), y.clone(), zinv.clone())
        return real(spec, head, x, y, zinv)
    CL.affine_lines = recording
    try:
        round_k(pts, rnd)()
    finally:
        CL.affine_lines = real
    return out


def lines_outputs(fn, head: bool, args):
    """affine_lines' outputs as a flat list (the seeds have no flags)."""
    return [o for o in fn(SPEC, head, *args) if o is not None]


def lines_deg(head: bool, x, y, zinv) -> int:
    """The degenerate slots of affine_lines' inputs, whose third point the
    function needs and whose second line it takes, from the plain version:
    those the head flags (equal points, neither the identity; on the seeds'
    inputs, p1 == p2).  A bypass slot's line is the constant, whatever its
    points (in the seeds two identities give a vanishing line too)."""
    return int(CL.affine_lines_plain(SPEC, True, x, y, zinv)[1][0].sum())


def lines_bound(b: int, head: bool, n_deg: int, name: str = "affine_lines"):
    """affine_lines' bound at b slots: 10 products and 5 subtractions a slot
    and 6 products and 3 subtractions more a degenerate one; the first two
    points' 6 rows read a slot and the third's 3 a degenerate one, 7 (head)
    or 3 (seeds) rows and 2 flag bytes (head) written a slot."""
    rows = 6 + (CL.HEAD_ROWS if head else CL.SEEDS_ROWS)
    extra = (b * rows + 3 * n_deg) * ROW_BYTES + (2 * b if head else 0)
    return bound_ms(name, b, extra, muls=10 + 6 * n_deg / b, adds=5 + 3 * n_deg / b)


def affine_lines_by_width(dev, base_pts, lines_in: dict, round_tally: dict, rounds: int,
                          reps: int):
    """affine_lines at every (B, mode) one round gives it: on the round's own
    inputs (lines_in) and on lines_inputs' slots, head and seeds, equal to
    the plain version and to its first design (affine_lines_v1), outputs
    and flags, the tangent slot 3 flagged degenerate in the head; device ms
    of the two in turns on the round's inputs; host ms a call.  Launches
    on the main path: a round's x `rounds` (affine_lines_v1: none).  Returns (affine_lines' records,
    affine_lines_v1's)."""
    nprng = np.random.default_rng(0xAB8)
    out, v1_out = [], []
    for (b, mode), count in round_tally.items():
        head, *args = lines_in[(b, mode)]
        cases = [(head, args, "the round's")]
        cases += [(h, a, "edge") for h, a in lines_inputs(nprng, base_pts, b, dev).items()]
        for h, a, what in cases:
            got = lines_outputs(CL.affine_lines, h, a)
            err = max(outputs_equal(got, lines_outputs(fn, h, a))
                      for fn in (CL.affine_lines_plain, CL.affine_lines_v1))
            require(err == 0 and (what != "edge" or b < 5 or not h or bool(got[1][0, 3])),
                    f"affine_lines == affine_lines_plain == affine_lines_v1 "
                    f"at B = {b}, {'head' if h else 'seeds'}, on {what} slots"
                    + (" (identities, P = P flagged, P = -P)" if what == "edge" else ""))
        ms, call = turns(dev, {"v2": lambda: CL.affine_lines(SPEC, head, *args),
                               "v1": lambda: CL.affine_lines_v1(SPEC, head, *args)},
                         max(1, reps // 2))
        n_deg = lines_deg(head, *args)
        b_ms, b_by = lines_bound(b, head, n_deg)
        out.append({"shape": f"B = {b}, {mode}", "b": b, "ms": ms["v2"], "call_ms": call["v2"],
                    "v1_ms": ms["v1"], "v1_call_ms": call["v1"],
                    "bound_ms": b_ms, "bound_by": b_by, "launches": count * rounds,
                    "degenerate_slots": n_deg})
        v1_out.append({"shape": f"B = {b}, {mode}", "b": b, "ms": ms["v1"],
                       "call_ms": call["v1"], "bound_ms": b_ms, "bound_by": b_by,
                       "launches": 0})
        print(f"  A/B affine_lines at B = {b}, {mode} ({count} a round, {n_deg} degenerate): "
              f"two lanes {ms['v2']:.4f} ms, v1 (a thread a "
              f"slot) {ms['v1']:.4f} ms ({ms['v1'] / ms['v2']:.2f}x) on the device; bound "
              f"{b_ms:.6f} ms ({b_by}); host ms a call: two lanes {call['v2']:.4f}, v1 "
              f"{call['v1']:.4f}", flush=True)
    return out, v1_out


def check_lines_kernel(dev, base_pts, lines_in: dict, keys, reps: int,
                       name: str = "affine_lines"):
    """affine_lines (or its first design, name affine_lines_v1) against its
    plain version at each (B, mode) of keys: a ragged width on
    lines_inputs' slots, then the widest of the round on the round's own
    inputs, timed there; affine_lines against affine_lines_v1 too.  Returns
    its record for the JSON line."""
    nprng = np.random.default_rng(0xC0F0)
    inputs = {}
    fn = getattr(CL, name)

    def make_inputs(key):
        if key in lines_in:
            inputs[key] = lines_in[key]
        else:
            head = key[1] == "head"
            inputs[key] = (head, *lines_inputs(nprng, base_pts, key[0], dev)[head])
        return inputs[key]

    def against_v1(key, args, got):
        if name == "affine_lines":
            require(outputs_equal(got, lines_outputs(CL.affine_lines_v1, args[0], args[1:])) == 0,
                    f"affine_lines equals affine_lines_v1 at {key}")

    return check_kernel(
        dev, name, lambda head, *a: lines_outputs(fn, head, a),
        lambda head, *a: lines_outputs(CL.affine_lines_plain, head, a), make_inputs, keys,
        reps, host_check=against_v1,
        bound_of=lambda key: lines_bound(key[0], inputs[key][0], lines_deg(*inputs[key]), name))


# ---------------------------------------------------------------------------
# phase 10: one round at a cut width, on the card and on the CPU
# ---------------------------------------------------------------------------

def cpu_round_path(dev, base_pts, logn: int):
    """Round ROUND_K of 2^logn points (base points tiled, scalars below
    sqrt(q)) through _one_round_slots and compute_divisor_witness_partial on
    the card and on the CPU (plain versions): both close, equal limb for limb.
    The carries come from _carries_only on the card; its final carry must
    equal the Python-int oracle."""
    n = 1 << logn
    E = ec(CURVE)
    print(f"one round on the card and on the CPU: n = 2^{logn}, round {ROUND_K}", flush=True)
    pts = tiled_points(dev, base_pts, n)
    rng = random.Random(0x57AE)
    scalars = [A.gen_random_coeff(rng, CURVE.scalar_field) for _ in range(n)]
    scalars[0] = 0
    rounds = A._msb_rounds(CURVE, scalars, n, BASE, dev)
    cp, cn, final = A._carries_only(CURVE, BASE, rounds, pts)
    require(one_point(final) == tiled_msm_oracle(ints_to_limbs(scalars), base_pts),
            "the final carry equals the Python-int oracle")
    cpu = torch.device("cpu")
    on_cpu = lambda pt: JPoint(*(c.to(cpu) for c in pt))
    wtns = {}
    for where, conv in ((dev, lambda pt: pt), (cpu, on_cpu)):
        rp = A._one_round_slots(CURVE, BASE, rounds[ROUND_K].to(where),
                                A.precompute_multiplicities(E, conv(pts), BASE),
                                conv(A._at(cp, ROUND_K)), conv(A._at(cn, ROUND_K)))
        t0 = time.perf_counter()
        w, out = D.compute_divisor_witness_partial(CURVE, rp)
        sync(dev)
        wtns[where.type] = (w, time.perf_counter() - t0)
        require(bool(E.is_identity(JPoint(*(c[None] for c in out)))[0]),
                f"round {ROUND_K} closes on the {where.type}")
    (w, card_s), (w_cpu, cpu_s) = wtns["cuda" if dev.type == "cuda" else "cpu"], wtns["cpu"]
    require(torch.equal(w.a.cpu(), w_cpu.a) and torch.equal(w.b.cpu(), w_cpu.b),
            f"round {ROUND_K}'s witness on the card ({card_s:.3f} s) equals the CPU's "
            f"({cpu_s:.1f} s), limb for limb")


# ---------------------------------------------------------------------------
# phase 11: the exact fallback of a fused level on the card
# ---------------------------------------------------------------------------

def divisor_fallback_path(dev):
    """128 points whose two 64-point halves are equal: the top level (fused,
    incoming a-poly 33 long) sees a.out == b.out, a degenerate line, and is
    redone by intt_dit + kate_div.  The witness must equal the CPU's."""
    E = ec(CURVE)
    half = pyref.random_points(random.Random(0xDE6), CURVE, 64)
    pts = half + half
    print("divisor fallback: 128 points, two equal halves (degenerate line at the fused "
          "top level)", flush=True)
    D.reset_level_counts()
    w, out = D.compute_divisor_witness_partial(CURVE, E.points_from_ints(pts, dev))
    levels = dict(D.LEVEL_COUNTS)
    require(levels == {"coefficient": 5, "fused": 1, "fallback": 1},
            f"the fused level took the exact fallback on the card ({levels})")
    w_cpu, out_cpu = D.compute_divisor_witness_partial(CURVE, E.points_from_ints(pts, "cpu"))
    require(torch.equal(w.a.cpu(), w_cpu.a) and torch.equal(w.b.cpu(), w_cpu.b)
            and one_point(out) == one_point(out_cpu),
            "the witness and the output equal the CPU's, limb for limb")

# ---------------------------------------------------------------------------
# phase 12: the radix reorder's four kernels
# ---------------------------------------------------------------------------

def radix_inputs(nprng, dev, n: int, c: int, T, crowd=(), keys_below=None):
    """One window's keys (uniform in [0, 2^c), or in [0, keys_below)) and
    packed rows (random words, 1 % all-zero rows of no point); crowd[t] rows
    of tile t moved into coarse partition 9.  Returns (plan, keys, payload)."""
    plan = RX.make_plan(n, c, T)
    keys = nprng.integers(0, keys_below or 1 << c, size=n).astype(np.int32)
    pay = nprng.integers(0, 1 << 32, size=(n, 16), dtype=np.uint32).view(np.int32)
    pay[nprng.random(n) < 0.01] = 0
    for t, k in enumerate(crowd):
        rows = t * plan.T + nprng.choice(plan.T, size=k, replace=False)
        keys[rows] = (9 << plan.fb) + nprng.integers(0, 1 << plan.fb, size=k)
    return plan, torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)


def radix_bytes(name: str, d: dict) -> int:
    """Bytes a radix kernel must move on one plan's inputs: each input read
    once (the shuffle's and the compaction's payload rows where they land),
    each output written once, the image's and the stream's zero rows
    included (the kernels write them)."""
    p = d["plan"]
    if name.startswith("radix_rank"):
        return p.n * (4 + ROW_BYTES + 4) + p.n_tiles * p.P * 4
    if name == "radix_shuffle":
        return p.n * 4 + d["landed"] * (ROW_BYTES + 4) + p.n_tiles * p.OUT_ROWS * 80
    if name.startswith("radix_pass_b"):
        # the payload and the key of each slot row (the image's zero
        # columns 17-19 are never read)
        return (p.P * p.R * (ROW_BYTES + 4) + p.P * p.R_pad * ROW_BYTES
                + p.P * ((1 << p.fb) + 1) * 4)
    gathered = min(p.n_ext, int(d["base4"][-1]) + p.R_pad)
    return p.P * 4 + (gathered + p.n_ext) * ROW_BYTES


# the two kernels redesigned by warp votes: name -> (the kernel, its plain
# version, their inputs from a plan's state)
RADIX_AB = {
    "radix_rank": (CR.rank, CR.rank_plain, lambda d: (d["keys"], d["pay"])),
    "radix_pass_b": (CR.pass_b, CR.pass_b_plain, lambda d: (d["main"],)),
}


def radix_ab(dev, st: dict, full: str, reps: int):
    """radix_rank and radix_pass_b against their plain versions, torch.equal,
    on every plan of st, and timed there (CUDA events while a spin kernel
    holds the queue), each with its share of the bound.  Returns the JSON
    records of the two kernels (at the full plan, every plan under
    "radix_ab")."""
    recs = []
    for name, (kernel, plain, args_of) in RADIX_AB.items():
        print(f"kernel {name}", flush=True)
        rows = []
        for key, d in st.items():
            p, args = d["plan"], args_of(d)
            want = flatten_outs(plain(p, *args))
            sync(dev)
            t0 = time.perf_counter()
            plain(p, *args)
            sync(dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = outputs_equal(flatten_outs(kernel(p, *args)), want)
            require(err == 0, f"{name} equals {name}_plain at {key} (max abs diff {err})")
            dev_ms, call_ms = time_ms(dev, lambda: kernel(p, *args), reps)
            b_ms = radix_bytes(name, d) / HBM_BYTES_PER_S * 1e3
            rows.append({"plan": key, "bound_ms": b_ms, "plain_ms": plain_ms,
                         "max_abs_err": err, "ms": dev_ms, "call_ms": call_ms,
                         "share": b_ms / dev_ms})
            print(f"  {name} at {key}: {dev_ms:.4f} ms on the device, bound {b_ms:.5f} ms "
                  f"(bytes); share of the bound {b_ms / dev_ms:.3f}; plain {plain_ms:.1f} ms",
                  flush=True)
        top = next(r for r in rows if r["plan"] == full)
        src, tpu_file, line = KERNEL_TABLE[name][:3]
        recs.append({"name": name, "route": "cuda", "source": CSRC + src,
                     "replaces": f"{tpu_file}:{line}", "launches": 0,
                     "max_abs_err": max(r["max_abs_err"] for r in rows),
                     "ms": top["ms"], "plain_ms": top["plain_ms"],
                     "bound_ms": top["bound_ms"], "bound_by": "bytes", "library_ms": None,
                     "shape": full, "call_ms": top["call_ms"], "radix_ab": rows})
    return recs


def check_radix_kernels(dev, logn: int, reps: int):
    """The four kernels of csrc/radix.cuh against their plain versions at a
    ragged plan and at the plan of one 2^L window (L = max(logn, 17), c =
    pick_window), shuffle and compact timed there.  Each kernel's inputs come
    from the kernels before it.  Then radix_rank and radix_pass_b (radix_ab)
    at those plans and at: the split top
    window's width at 2^L (max_scalar_bits = 254), and 2^17, c = 12 on
    uniform keys and on keys below 7 (phase 15's: every row in coarse
    partition 0, every tile overflowing).  Returns (the JSON records, the
    plans' keys by name)."""
    nprng = np.random.default_rng(0x4AD1)
    big = max(logn, 17)
    n = 1 << big
    c = M.pick_window(n)
    _, c_top, split = top_window(n, c, CURVE.scalar_field.p.bit_length() - 1)
    full = f"2^{big}, c = {c}"
    cases = {"ragged": radix_inputs(nprng, dev, 3 * 768, 10, 768, crowd=(400, 60)),
             full: radix_inputs(nprng, dev, n, c, M.RADIX_TILE)}
    if split:
        cases[f"2^{big}, c = {c_top}"] = radix_inputs(nprng, dev, n, c_top, M.RADIX_TILE)
    c17 = M.pick_window(1 << 17)
    cases[f"2^17, c = {c17}"] = radix_inputs(nprng, dev, 1 << 17, c17, M.RADIX_TILE)
    cases[f"2^17, c = {c17}, one partition"] = radix_inputs(
        nprng, dev, 1 << 17, c17, M.RADIX_TILE, keys_below=7)
    st = {}
    for key, (plan, keys, pay) in cases.items():
        dst, cnt = CR.rank(plan, keys, pay)
        tiles = CR.shuffle(plan, keys, dst, pay)
        base4, spills = RX.ghost_bases(plan, cnt)
        main = RX.partition_major(plan, tiles)
        parts, _ = CR.pass_b(plan, main)
        st[key] = dict(plan=plan, keys=keys, pay=pay, dst=dst, main=main, parts=parts,
                       base4=base4, spills=spills, landed=int((dst < plan.OUT_ROWS).sum()))
        print(f"  radix plan {key}: n = {plan.n}, c = {plan.c}, T = {plan.T}, P = {plan.P}, "
              f"fb = {plan.fb}, S = {plan.S}, SP = {plan.SP}, OUT_ROWS = {plan.OUT_ROWS}, "
              f"R = {plan.R}, R_pad = {plan.R_pad}, n_ext = {plan.n_ext}; spills a tile: "
              f"{spills.tolist()[:8]}", flush=True)
    spills, sp = st["ragged"]["spills"], st["ragged"]["plan"].SP
    require(int(spills[0]) > sp and 0 < int(spills[1]) <= sp,
            "the ragged plan's tile 0 overflows its spill rows and tile 1 spills within them")
    one = st[f"2^17, c = {c17}, one partition"]
    require(bool((one["spills"] > one["plan"].SP).all()),
            "keys below 7 at 2^17: every row in coarse partition 0, every tile overflows")

    def shape(key):
        p = st[key]["plan"]
        return f"n = {p.n}, c = {p.c}, T = {p.T}, P = {p.P}"

    calls = {
        "radix_shuffle": (lambda d: (d["keys"], d["dst"], d["pay"]),
                          lambda p, k, t, y: (CR.shuffle(p, k, t, y),),
                          lambda p, k, t, y: (CR.shuffle_plain(p, k, t, y),)),
        "radix_compact": (lambda d: (d["parts"], d["base4"]),
                          lambda p, a, b: (CR.compact(p, a, b),),
                          lambda p, a, b: (CR.compact_plain(p, a, b),)),
    }
    recs = []
    for name, (args_of, kernel, plain) in calls.items():
        recs.append(check_kernel(
            dev, name, kernel, plain, lambda key: (st[key]["plan"], *args_of(st[key])),
            ["ragged", full], reps, elems_of=lambda key: 0,
            extra_bytes_of=lambda key, name=name: radix_bytes(name, st[key]), shape_of=shape))

    # the one PyTorch call for the same data movement, and its result.  The
    # shuffle's is timed with the zero fill of the image (the kernel writes
    # every image row), not with the build of its flat indices and source
    # rows (the key column appended), which the kernel does in place
    d = st[full]
    p = d["plan"]
    kept = (d["dst"] < p.OUT_ROWS).nonzero().flatten()
    flat = torch.div(kept, p.T, rounding_mode="floor") * p.OUT_ROWS + d["dst"][kept]
    src = torch.cat([d["pay"], d["keys"][:, None], d["pay"].new_zeros((p.n, 3))], dim=1)[kept]
    img = d["pay"].new_empty((p.n_tiles * p.OUT_ROWS, 20))
    lib_shuffle = lambda: img.zero_().index_copy_(0, flat, src)
    lib_shuffle()
    require(torch.equal(img.view(p.n_tiles, p.OUT_ROWS, 20),
                        CR.shuffle(p, d["keys"], d["dst"], d["pay"])),
            "index_copy_ into a zeroed image equals radix_shuffle at the full plan")
    r = torch.arange(p.n_ext, device=dev)
    part = torch.searchsorted(d["base4"].to(torch.int64), r, right=True) - 1
    off = r - d["base4"].to(torch.int64)[part]
    rowmap = torch.where(off < p.R_pad, part * p.R_pad + off, p.P * p.R_pad)
    table = torch.cat([d["parts"].reshape(-1, 16), d["parts"].new_zeros((1, 16))])
    lib_compact = lambda: table.index_select(0, rowmap)
    require(torch.equal(lib_compact(), CR.compact(p, d["parts"], d["base4"])),
            "index_select through the row map equals radix_compact at the full plan")
    for rec, lib in zip(recs, (lib_shuffle, lib_compact)):
        rec["library_ms"] = time_ms(dev, lib, reps)[0]
        print(f"  time {rec['name']}: one PyTorch call {rec['library_ms']:.4f} ms on "
              f"the device", flush=True)
    recs += radix_ab(dev, st, full, reps)
    next(r for r in recs if r["name"] == "radix_pass_b")["stash_limit"] = pass_b_routes(
        dev, st[full]["plan"], reps)
    return recs, {"full": full, "top": f"2^{big}, c = {c_top}" if split else None}


def pass_b_stash_rows() -> int:
    """RADIX_PASS_B_STASH of csrc/radix.cuh: the R up to which radix_pass_b
    keeps its first pass's fine ids in shared memory."""
    src = (CF._CSRC / "radix.cuh").read_text()
    return int(re.search(r"#define RADIX_PASS_B_STASH (\d+)", src).group(1))


def pass_b_routes(dev, full, reps: int):
    """radix_pass_b on both sides of its stash's limit L (pass_b_stash_rows):
    the full plan's P and fb with R = L (fine ids kept in shared memory) and
    R = L + 256 (read again from the rows), image rows as a window's (each
    S-row slot block begins with its valid rows, about half of them).  Each
    against pass_b_plain (torch.equal) and timed, with its time a row and
    share of the bound.  Returns the two records."""
    gen = torch.Generator(device=dev).manual_seed(0x5A5B)
    limit = pass_b_stash_rows()
    out = []
    for R in (limit, limit + 256):
        R_pad = -(-R // 512) * 512
        plan = dataclasses.replace(full, R=R, R_pad=R_pad)
        main = torch.randint(-1 << 31, 1 << 31, (plan.P, R, 20), generator=gen, device=dev,
                             dtype=torch.int32)
        main[..., 17:] = 0
        fill = torch.randint(0, plan.S + 1, (plan.P, R // plan.S, 1), generator=gen,
                             device=dev)
        slot = torch.arange(plan.S, device=dev)
        main[(slot >= fill).reshape(plan.P, R)] = 0
        err = outputs_equal(flatten_outs(CR.pass_b(plan, main)),
                            flatten_outs(CR.pass_b_plain(plan, main)))
        route = "stash" if R <= limit else "re-read"
        require(err == 0, f"radix_pass_b ({route}) equals radix_pass_b_plain at P = {plan.P}, "
                          f"R = {R}, fb = {plan.fb}")
        dev_ms, _ = time_ms(dev, lambda: CR.pass_b(plan, main), reps)
        b_ms = radix_bytes("radix_pass_b", {"plan": plan}) / HBM_BYTES_PER_S * 1e3
        rec = {"R": R, "route": route, "ms": dev_ms, "ns_a_row": dev_ms * 1e6 / (plan.P * R),
               "bound_ms": b_ms, "share": b_ms / dev_ms}
        out.append(rec)
        print(f"  radix_pass_b at P = {plan.P}, R = {R} ({route}): {dev_ms:.4f} ms on the "
              f"device, {rec['ns_a_row']:.5f} ns a row, bound {b_ms:.4f} ms, share "
              f"{rec['share']:.3f}", flush=True)
        del main
    return out


# ---------------------------------------------------------------------------
# phase 13: the radix route of the MSM
# ---------------------------------------------------------------------------

def timed_msms(dev, scalars, pts, bits: int, runs: int = 3):
    """Three timed best_multiexp calls after a warm-up (host clock, each
    ending in a synchronise), the launch counts and peak memory of the first,
    and the device's busy time of one more.  Returns a dict."""
    M.best_multiexp(CURVE, scalars, pts, max_scalar_bits=bits)
    torch.cuda.reset_peak_memory_stats(dev)
    CF.reset_launch_counts()
    times = []
    for i in range(runs):
        sync(dev)
        t0 = time.perf_counter()
        res = M.best_multiexp(CURVE, scalars, pts, max_scalar_bits=bits)
        sync(dev)
        times.append(time.perf_counter() - t0)
        if i == 0:
            counts = dict(CF.LAUNCHES)
            peak = torch.cuda.max_memory_allocated(dev)
    busy = device_busy_ms(dev, lambda: M.best_multiexp(CURVE, scalars, pts,
                                                       max_scalar_bits=bits))
    return dict(res=one_point(res), runs=times, counts=counts, peak=peak, busy_ms=busy,
                launches=sum(counts.values()))


def top_window(n: int, c: int, bits: int):
    """(windows, c_top, split): the top window's width c_top = bits - (W -
    1) c, and whether best_multiexp splits it off at that width on the radix
    route, by the predicate both packages share (ops/msm._best_multiexp:
    narrower than c, more than one window, and the route taking both
    widths)."""
    num_windows = -(-bits // c)
    c_top = bits - (num_windows - 1) * c
    try:
        config.RADIX_MSM = True
        split = (c_top < c and num_windows > 1 and M._radix_ok(n, c, "fast")
                 and M._radix_ok(n, c_top, "fast"))
    finally:
        config.RADIX_MSM = False
    return num_windows, c_top, split


def radix_msm_path(dev, base_pts, logn: int):
    """best_multiexp with config.RADIX_MSM on at 2^logn (the main path's
    inputs) against the oracle and the classic route, timed beside it.  The
    scalars are random below q, which lies just above 2^254: all of them fit
    254 bits (checked), and max_scalar_bits = 254.  What the route must do
    follows the shared predicate (top_window): where the top window is
    split off (2^20: c = 15, c_top = 14), no window overflows and the flag
    is clear; where it is not (2^17: c = 12, c_top = 2), the top window runs
    at c with keys below 2^c_top, and where they crowd its tiles past their
    spill rows (every tile at 2^17) the flag must be set and the safe redo
    exact.  Then one call at the default bound of 255 bits, where c_top = c
    at 2^20 and c_top = 3 at 2^17: the top window is not split off, its
    keys crowd a fraction of the coarse partitions, every tile overflows,
    and the MSM ends in the safe redo, exact."""
    n = 1 << logn
    c = M.pick_window(n)
    full_bits = CURVE.scalar_field.p.bit_length()
    bits = full_bits - 1
    num_windows, c_top, split = top_window(n, c, bits)
    print(f"radix route: best_multiexp, Pallas, n = 2^{logn}, c = {c}, {num_windows} "
          f"windows, max_scalar_bits = {bits}: c_top = {c_top}, "
          + ("split off" if split else f"not split off (the top window runs at c = {c})"),
          flush=True)
    sc, scalars, pts = msm_inputs(dev, base_pts, logn)
    require(bool((sc[:, N_LIMBS - 1] >> (bits - LIMB_BITS * (N_LIMBS - 1)) == 0).all()),
            f"every scalar fits {bits} bits")
    want = tiled_msm_oracle(sc, base_pts)
    E = ec(CURVE)
    ax, ay, _ = E.to_affine(pts)
    pay = M._pack_pair(ax, ay)
    digits = M.window_digits(scalars, c, num_windows)
    # the top window at the width it runs at: overflowing where its keys
    # crowd the tiles past their spill rows (only where it is not split off)
    plan = RX.make_plan(n, c, M.RADIX_TILE)
    top_spills = RX.ghost_bases(plan, CR.rank(plan, digits[-1], pay)[1])[1]
    top_overflows = not split and bool((top_spills > plan.SP).all())
    require(split or top_overflows or not bool((top_spills > plan.SP).any()),
            f"the top window at c = {c}: every tile or none overflows")
    out = {}
    try:
        config.RADIX_MSM = True
        res, exc = M._best_multiexp(CURVE, c, bits, "fast", scalars, pts)
        require(bool(exc) == top_overflows,
                "the radix route's fast flavor " + ("flags the top window's overflow"
                                                    if top_overflows else "runs with its flag clear"))
        out["radix"] = timed_msms(dev, scalars, pts, bits)
    finally:
        config.RADIX_MSM = False
    out["classic"] = timed_msms(dev, scalars, pts, bits)
    r, k = out["radix"], out["classic"]
    require(r["res"] == k["res"] == want and (top_overflows or one_point(res) == want),
            "the radix route's result equals the Python-int oracle and the classic route's")
    if top_overflows:
        require(r["counts"]["ec_add_mixed"] > 0,
                "the radix route ended in the safe redo (ec_add_mixed launched), exact")
    for name in RADIX_KERNELS:
        require(r["counts"][name] == num_windows,
                f"{name} was launched once a window on the radix route ({r['counts'][name]})")
    for route in ("radix", "classic"):
        o = out[route]
        print(f"  {route}: runs " + ", ".join(f"{t:.4f}" for t in o["runs"])
              + f" s; device busy {o['busy_ms']:.2f} ms; peak {o['peak'] / 2**20:.0f} MiB; "
              f"{o['launches']} kernel launches of the port's", flush=True)
    out.update(windows=num_windows, split=split)

    # spilled rows of every window at the width it runs at, and the top
    # window at c (the default bound)
    spilled = []
    for w in range(num_windows):
        top = w == num_windows - 1
        wplan = RX.make_plan(n, c_top if top and split else c, M.RADIX_TILE)
        _, _, sp_pay, _, ov = RX.radix_window(wplan, digits[w], pay)
        require(bool(ov) == (top and top_overflows),
                f"window {w} " + ("overflows" if top and top_overflows else "does not overflow"))
        spilled.append(int(sp_pay.any(dim=1).sum()))
    out.update(spilled=spilled, top_at_c=(int(top_spills.float().mean()),
                                          int((top_spills > plan.SP).sum()), plan.n_tiles))
    print(f"  spilled rows a window (of {n}): {spilled}; the top window at c = {c} "
          f"spills {out['top_at_c'][0]} rows a tile on average (SP = {plan.SP}) and "
          f"overflows {out['top_at_c'][1]} of {plan.n_tiles} tiles", flush=True)

    # the default bound: the top window is not split off, its keys crowd
    # every tile past its spill rows, the fast flavor flags the overflow and
    # best_multiexp redoes the MSM in the safe flavor
    nw_full, c_top_full, split_full = top_window(n, c, full_bits)
    full_spills = RX.ghost_bases(plan, CR.rank(
        plan, M.window_digits(scalars, c, nw_full)[-1], pay)[1])[1]
    require(not split_full and bool((full_spills > plan.SP).all()),
            f"at {full_bits} bits the top window (c_top = {c_top_full}) is not split off and "
            f"overflows all {plan.n_tiles} tiles at c = {c}")
    try:
        config.RADIX_MSM = True
        CF.reset_launch_counts()
        _, exc = M._best_multiexp(CURVE, c, full_bits, "fast", scalars, pts)
        require(bool(exc), f"at {full_bits} bits the radix route's fast flavor flags")
        CF.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        res = M.best_multiexp(CURVE, scalars, pts)
        sync(dev)
        seconds = time.perf_counter() - t0
    finally:
        config.RADIX_MSM = False
    require(one_point(res) == want and CF.LAUNCHES["ec_add_mixed"] > 0,
            f"at {full_bits} bits the radix route ends in the safe redo (ec_add_mixed "
            f"launched), equal to the Python-int oracle")
    out["overflowing"] = dict(seconds=seconds, launches=sum(CF.LAUNCHES.values()))
    print(f"  radix route at {full_bits} bits: {seconds:.4f} s with the safe redo, "
          f"{out['overflowing']['launches']} kernel launches of the port's", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: one window by both routes
# ---------------------------------------------------------------------------

def radix_window_routes(dev, base_pts, logn: int, reps: int = 5):
    """One c = pick_window window of the main path's inputs (window 0) by both
    routes: the reorder alone and the whole window, host clock (best of `reps`
    after a warm-up, each ending in a synchronise) and device busy time of
    one call.  The window sums must be equal, and one radix_window must
    launch each radix kernel once."""
    n = 1 << logn
    c = M.pick_window(n)
    print(f"one window by both routes at n = 2^{logn}, c = {c}", flush=True)
    _, scalars, pts = msm_inputs(dev, base_pts, logn)
    E = ec(CURVE)
    ax, ay, _ = E.to_affine(pts)
    pay = M._pack_pair(ax, ay)
    keys = M.window_digits(scalars, c, 1)[0]
    plan = RX.make_plan(n, c, M.RADIX_TILE)
    windows = {}
    for route in ("radix", "classic"):
        config.RADIX_MSM = route == "radix"
        try:
            windows[route] = M._make_one_window(E, c, "fast", pay, n)
        finally:
            config.RADIX_MSM = False
    CF.reset_launch_counts()
    RX.radix_window(plan, keys, pay)
    require(all(CF.LAUNCHES[k] == 1 for k in RADIX_KERNELS),
            "one radix_window launched each of the four radix kernels once")
    fns = {
        ("reorder", "radix"): lambda: RX.radix_window(plan, keys, pay),
        ("reorder", "classic"): lambda: (pay[torch.sort(keys, stable=True).indices],
                                         M.bucket_bounds_hist(keys, c)),
        ("window", "radix"): lambda: windows["radix"](keys),
        ("window", "classic"): lambda: windows["classic"](keys),
    }
    sums = {}
    for route in ("radix", "classic"):
        pt, exc = windows[route](keys)
        require(not bool(exc), f"the {route} window runs with its flag clear")
        sums[route] = one_point(pt)
    require(sums["radix"] == sums["classic"], "both routes give the same window sum")
    out = {}
    for key, fn in fns.items():
        fn()
        best = float("inf")
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            best = min(best, time.perf_counter() - t0)
        out[key] = (best * 1e3, device_busy_ms(dev, fn))
        print(f"  {key[0]} by the {key[1]} route: {out[key][0]:.3f} ms on the host clock, "
              f"{out[key][1]:.3f} ms device busy", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the radix route's overflow on the card
# ---------------------------------------------------------------------------

def radix_overflow_path(dev, base_pts, logn: int = 17):
    """2^logn points, scalars below 7, max_scalar_bits = 3: one window of
    c = pick_window, all keys in coarse partition 0, so every tile spills
    past SP; the fast flavor flags and best_multiexp redoes the MSM in the
    safe flavor (classic route), exact."""
    n = 1 << logn
    c = M.pick_window(n)
    print(f"radix overflow: n = 2^{logn}, scalars below 7, c = {c}", flush=True)
    nprng = np.random.default_rng(0x0F10)
    sc = np.zeros((n, N_LIMBS), dtype=np.uint32)
    sc[:, 0] = nprng.integers(0, 7, size=n)
    scalars = limbs_from_numpy(sc, dev)
    pts = tiled_points(dev, base_pts, n)
    want = tiled_msm_oracle(sc, base_pts)
    plan = RX.make_plan(n, c, M.RADIX_TILE)
    E = ec(CURVE)
    ax, ay, _ = E.to_affine(pts)
    spills = RX.ghost_bases(plan, CR.rank(plan, M.window_digits(scalars, c, 1)[0],
                                          M._pack_pair(ax, ay))[1])[1]
    require(bool((spills > plan.SP).all()),
            f"all {plan.n_tiles} tiles overflow ({int(spills.min())} or more spills, SP = "
            f"{plan.SP})")
    try:
        config.RADIX_MSM = True
        CF.reset_launch_counts()
        _, exc = M._best_multiexp(CURVE, c, 3, "fast", scalars, pts)
        require(all(CF.LAUNCHES[k] == 1 for k in RADIX_KERNELS),
                "the four radix kernels were launched once on the overflowing window")
        require(bool(exc), "the radix route's fast flavor flags the overflow")
        CF.reset_launch_counts()
        res = M.best_multiexp(CURVE, scalars, pts, max_scalar_bits=3)
        require(one_point(res) == want and CF.LAUNCHES["ec_add_mixed"] > 0,
                "best_multiexp redoes it in the safe flavor (ec_add_mixed launched) and "
                "equals the Python-int oracle")
    finally:
        config.RADIX_MSM = False

# ---------------------------------------------------------------------------
# phase 16: the curve layer's entry point EC.add_mixed_fast at full width
# ---------------------------------------------------------------------------

class AtenOps(TorchDispatchMode):
    """The names of the aten ops run inside the mode (a kernel of the port,
    launched through ctypes, is none of them)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


# aten ops that launch no kernel: allocation and views
NO_KERNEL_OPS = ("aten.empty", "aten.view", "aten._unsafe_view", "aten.reshape", "aten.expand",
                 "aten.alias", "aten.detach", "aten.as_strided", "aten.slice", "aten.select",
                 "aten.unsqueeze", "aten.squeeze")


def add_mixed_fast_path(dev, base_pts, logn: int):
    """EC.add_mixed_fast on 2^logn lanes: the carries 3 B_i made by
    EC.scalar_mul_small from the tiled base points (Jacobian, Z != 1), the
    affine points B_(i+7); lane 0 carries the identity, lane 1 adds the
    affine identity (qy == 0), lanes 2 and 3 add the carry's own affine point
    and its negative.  Unflagged lanes must equal EC.add_mixed (complete) as
    affine points; 64 sampled lanes the Python-int oracle, and
    EC.projective_coords there the Python-int change of coordinates.
    Returns (launch counts of the EC.add_mixed_fast call, its seconds)."""
    n = 1 << logn
    E = ec(CURVE)
    k = E.f
    print(f"curve entry point: EC.add_mixed_fast, n = 2^{logn} lanes", flush=True)
    base = tiled_points(dev, base_pts, n)
    carry = JPoint(*(c.clone() for c in E.scalar_mul_small(base, 3)))
    carry.z[0] = 0
    shifted = [base_pts[(i + 7) % len(base_pts)] for i in range(len(base_pts))]
    q = tiled_points(dev, shifted, n)
    qx, qy = q.x.clone(), q.y.clone()
    qx[1], qy[1] = 0, 0
    cx, cy, _ = E.to_affine(JPoint(*(c[2:4] for c in carry)))
    qx[2:4] = cx
    qy[2], qy[3] = cy[0], k.neg(cy[1])

    CF.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    res, exc = E.add_mixed_fast(carry, qx, qy)
    sync(dev)
    seconds = time.perf_counter() - t0
    counts = dict(CF.LAUNCHES)
    require(counts["ec_add_mixed_fast"] == 1 and sum(counts.values()) == 1,
            f"EC.add_mixed_fast is one launch of ec_add_mixed_fast on the card "
            f"({seconds * 1e3:.3f} ms on the host clock)")
    with AtenOps() as ops:
        E.add_mixed_fast(carry, qx, qy)
    computing = sorted({op for op in ops.names if not op.startswith(NO_KERNEL_OPS)})
    require(not computing and exc.dtype == torch.bool,
            f"and no PyTorch op around it launches a kernel (ops: "
            f"{sorted(set(ops.names))}); its flags are the bool tensor the kernel wrote")
    require(exc.nonzero().flatten().tolist() == [0, 2, 3],
            "it flags exactly the identity carry (lane 0), carry == Q (lane 2) and "
            "carry == -Q (lane 3); qy == 0 (lane 1) passes unflagged")
    ref = E.add_mixed(carry, qx, qy, k.is_zero(qy))
    keep = ~exc
    fast_aff, ref_aff = E.to_affine(res), E.to_affine(ref)
    require(all(torch.equal(f[keep], r[keep]) for f, r in zip(fast_aff, ref_aff)),
            f"on all {int(keep.sum())} unflagged lanes it equals EC.add_mixed (complete, "
            f"kernel 8) as affine points")

    nprng = np.random.default_rng(0xAF5)
    pick = [1] + sorted(int(i) for i in nprng.choice(np.arange(4, n), 63, replace=False))
    idx = torch.tensor(pick, device=dev)
    take = lambda pt: JPoint(*(c[idx] for c in pt))
    d = len(base_pts)
    host_carry = [pyref.ec_mul(base_pts[i % d], 3, CURVE) for i in pick]
    host_q = [None if i == 1 else shifted[i % d] for i in pick]
    require(E.points_to_ints(take(res)) ==
            [pyref.ec_add(a, b, CURVE) for a, b in zip(host_carry, host_q)],
            "64 sampled lanes (lane 1 among them) equal the Python-int oracle")
    pp = SPEC.p
    X, Y, Z = (mont_limbs_to_ints(limbs_to_numpy(c[idx]), SPEC) for c in carry)
    got = [mont_limbs_to_ints(limbs_to_numpy(c), SPEC) for c in E.projective_coords(take(carry))]
    want = [[x * z % pp for x, z in zip(X, Z)], Y, [z ** 3 % pp for z in Z]]
    back = [(px * pow(pz, -1, pp) % pp, py * pow(pz, -1, pp) % pp) for px, py, pz in zip(*got)]
    require(got == want and back == host_carry,
            "EC.projective_coords on those 64 lanes equals (X Z, Y, Z^3) in Python ints, "
            "and (X/Z, Y/Z) gives the carry's affine point")
    return counts, seconds


# ---------------------------------------------------------------------------
# phase 17: the naive line arrangement at full width
# ---------------------------------------------------------------------------

def closing_list(rng, n: int):
    """About n host points summing to the identity, with identities and
    P, -P pairs (adjacent and apart) planted."""
    base = pyref.random_points(rng, CURVE, n - 8)
    pts = base + [pyref.ec_neg(pyref.ec_msm([1] * len(base), base, CURVE), CURVE)]
    extra = pyref.random_points(rng, CURVE, 3)
    for at in (2, n // 3, n // 2):
        pts.insert(at, None)
    pts += [extra[0], pyref.ec_neg(extra[0], CURVE)]
    pts.insert(5, extra[1])
    pts.insert(n // 4, pyref.ec_neg(extra[1], CURVE))
    pts.insert(n // 5, extra[2])
    pts.insert(n // 5 + 1, pyref.ec_neg(extra[2], CURVE))
    return pts


def naive_path(dev, rnd):
    """compute_divisor_witness_naive_device on the round phase's slots; the
    ratio check against the round's merge-tree witness f: both have the
    divisor sum [P_i] - n[O], so f = c * P / N with P, N the products of the
    pos and neg line values, and f(R1) P(R2) N(R1) == f(R2) P(R1) N(R2) at two
    random points (products by a tree of mont_mul, no inversion).  Then at
    2^12 points the lines equal the host replica's.  Returns a dict."""
    rp, w = rnd["rp"], rnd["w"]
    E = ec(CURVE)
    k = E.f
    slots = rp.x.shape[0]
    print(f"naive arrangement: compute_divisor_witness_naive_device, round {ROUND_K}'s "
          f"{slots} slots", flush=True)
    CF.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    pos, neg = D.compute_divisor_witness_naive_device(CURVE, rp)
    sync(dev)
    seconds = time.perf_counter() - t0
    counts = dict(CF.LAUNCHES)
    n_pos, n_neg = sum(ln[3] for ln in pos), sum(ln[3] for ln in neg)
    print(f"  {seconds:.3f} s; {len(pos)} pos and {len(neg)} neg rounds; {n_pos} pos lines, "
          f"{n_neg} neg lines; launches: "
          + ", ".join(f"{name} {v}" for name, v in counts.items() if v), flush=True)
    for name in ("ec_add", "mont_mul", "mont_addsub"):
        require(counts[name] > 0, f"{name} was launched by the naive arrangement ({counts[name]})")

    r = pyref.random_points(random.Random(0x2A710), CURVE, 2)
    x, y, _ = E.to_affine(E.points_from_ints(r, dev))
    t0 = time.perf_counter()
    f = D.rf_eval(CURVE, w, x, y)
    P = D.lines_product(CURVE, pos, x, y)
    N = D.lines_product(CURVE, neg, x, y)
    lhs = k.mul(k.mul(f[0], P[1]), N[0])
    rhs = k.mul(k.mul(f[1], P[0]), N[1])
    sync(dev)
    ratio_s = time.perf_counter() - t0
    require(not bool((k.is_zero(f) | k.is_zero(P) | k.is_zero(N)).any()),
            "f, P and N are non-zero at R1 and R2")
    require(torch.equal(lhs, rhs),
            f"ratio check: f(R1) P(R2) N(R1) == f(R2) P(R1) N(R2) over {n_pos} pos and "
            f"{n_neg} neg lines ({ratio_s:.3f} s): the merge tree's witness and the naive "
            f"arrangement have the same divisor")
    del pos, neg

    pts = closing_list(random.Random(0x4A1), 1 << 12)
    arr = D.compute_divisor_witness_naive_host(CURVE, pts)
    dpos, dneg = D.compute_divisor_witness_naive_device(CURVE, E.points_from_ints(pts, dev))
    require(D.naive_device_lines_to_ints(CURVE, dpos) == arr.pos
            and D.naive_device_lines_to_ints(CURVE, dneg) == arr.neg,
            f"at {len(pts)} points (identities, P/-P pairs) the card's {len(arr.pos)} pos and "
            f"{len(arr.neg)} neg lines equal the host replica's, in order")
    return {"seconds": seconds, "n_pos": n_pos, "n_neg": n_neg, "counts": counts,
            "ratio_s": ratio_s}


# ---------------------------------------------------------------------------
# phase 18: the model and the entry point
# ---------------------------------------------------------------------------

def model_path(dev, base_pts, logn: int):
    """EagenMSMWitness at 2^logn points, all rounds batched through one merge
    tree: the carry against the tiled Python-int oracle, every round's slots
    summing to the identity, the first and the last round's witness against
    compute_divisor_witness_partial of _one_round_slots for that round (the
    carries from _carries_only); then entry()'s fn on the card against the
    same fn on the CPU.  Returns a dict."""
    n = 1 << logn
    cfg = EagenConfig(num_pts=n)
    d = cfg.num_digits
    E = ec(CURVE)
    print(f"model: EagenMSMWitness, n = 2^{logn}, {d} rounds batched, {cfg.slots} slots "
          f"a round", flush=True)
    nprng = np.random.default_rng(0x30DE)
    sc = np.zeros((n, N_LIMBS), dtype=np.uint32)
    sc[:, :8] = nprng.integers(0, 1 << 16, size=(n, 8), dtype=np.uint32)
    sc[:, 7] &= 0x3FFF  # below 2^126 < sqrt(q)
    scalars = limbs_to_ints(sc)
    pts = tiled_points(dev, base_pts, n)
    model = EagenMSMWitness(cfg)
    t0 = time.perf_counter()
    digits = torch.from_numpy(model.decompose(scalars)).to(dev)
    decompose_s = time.perf_counter() - t0
    model.forward(digits, pts)  # warm-up: tables and constants of every level size
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    CF.reset_launch_counts()
    t0 = time.perf_counter()
    carry, wtns = model.forward(digits, pts)
    sync(dev)
    seconds = time.perf_counter() - t0
    counts = dict(CF.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  decompose {decompose_s:.3f} s on the host; forward {seconds:.3f} s; peak "
          f"{peak / 2**20:.0f} MiB; witness {tuple(wtns.a.shape)}, {tuple(wtns.b.shape)}",
          flush=True)
    require(one_point(carry) == tiled_msm_oracle(sc, base_pts),
            "the model's carry equals the Python-int oracle")
    round_pts, _ = A._rounds_and_carries(CURVE, BASE, digits, pts)
    require(bool(E.is_identity(E.sum(round_pts, axis=1)).all()),
            f"every one of the {d} rounds' slot lists sums to the identity")
    del round_pts
    cp, cn, _ = A._carries_only(CURVE, BASE, digits, pts)
    precomp = A.precompute_multiplicities(E, pts, BASE)
    for kk in (0, d - 1):
        rp = A._one_round_slots(CURVE, BASE, digits[kk], precomp, A._at(cp, kk), A._at(cn, kk))
        w1, out1 = D.compute_divisor_witness_partial(CURVE, rp)
        require(bool(E.is_identity(JPoint(*(c[None] for c in out1)))[0])
                and torch.equal(w1.a, wtns.a[d - 1 - kk]) and torch.equal(w1.b, wtns.b[d - 1 - kk]),
                f"round {kk} (msb first) closes and its witness equals the model's, limb "
                f"for limb")
    del cp, cn, precomp, w1
    busy = device_busy_ms(dev, lambda: model.forward(digits, pts))
    print(f"  device busy in one forward: {busy:.3f} ms", flush=True)
    del carry, wtns

    fn, args = entry("cuda")
    fn_cpu, args_cpu = entry("cpu")
    require(all(a.device.type == dev.type and torch.equal(a.cpu(), b)
                for a, b in zip(args, args_cpu)),
            "entry(): the example arguments lie on the card and equal the CPU's")
    got, want = fn(*args), fn_cpu(*args_cpu)
    require(torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2]),
            f"entry(): the witness fn returns on the card (wtns.a {tuple(want[1].shape)}, "
            f"wtns.b {tuple(want[2].shape)}) equals the CPU's (plain versions), limb for limb")
    # The carry's Jacobian representative follows the order of EC.sum's adds,
    # which differs by device in both packages (a log-depth scan at one width
    # on the card, rounds of 64-step scans on the CPU), so the carry is
    # compared as a point; fn's carry.x is that carry's X.
    small = EagenMSMWitness(EagenConfig(num_pts=4))
    carry_card, _ = small.forward(args[0], JPoint(*args[1:]))
    carry_cpu, _ = small.forward(args_cpu[0], JPoint(*args_cpu[1:]))
    require(torch.equal(got[0], carry_card.x) and torch.equal(want[0], carry_cpu.x)
            and one_point(carry_card) == one_point(carry_cpu),
            f"entry(): the carry on the card equals the CPU's as an affine point (carry.x "
            f"limb for limb: {torch.equal(got[0].cpu(), want[0])})")
    return {"n": n, "rounds": d, "seconds": seconds, "decompose_s": decompose_s, "peak": peak,
            "busy_ms": busy, "counts": counts}


# ---------------------------------------------------------------------------
# phase 19: config 4 whole
# ---------------------------------------------------------------------------

def config4_path(dev, base_pts, pts: JPoint, carry_out, rnd):
    """compute_lhs_witness_streamed at the carry phase's points and scalars
    (base 5, every round): the final carry against the carry phase's result
    and the tiled oracle, every round closing, round ROUND_K's witness against
    the round phase's limb for limb.  The callback keeps no witness but that
    one.  The host decomposition inside the call is timed apart
    (argument._msb_rounds wrapped for the run).  Then the device's busy time
    of three rounds.  Returns a dict."""
    sc, want = carry_out
    n = pts.x.shape[0]
    E = ec(CURVE)
    d = A.num_digits_for(CURVE, BASE)
    print(f"config 4: compute_lhs_witness_streamed, n = {n}, base {BASE}, {d} rounds",
          flush=True)
    scalars = limbs_to_ints(sc)
    marks, closes, kept = {}, [], {}
    msb_rounds, carries_only = A._msb_rounds, A._carries_only

    def timed(key, fn):
        def wrapped(*a):
            marks[key + "_start"] = time.perf_counter()
            out = fn(*a)
            sync(dev)
            marks[key] = time.perf_counter()
            return out
        return wrapped

    def on_round(k, wtns_k, out_k):
        closes.append(bool(E.is_identity(JPoint(*(c[None] for c in out_k)))[0]))
        marks[k] = time.perf_counter()
        if k == ROUND_K:
            kept["a"], kept["b"] = wtns_k.a, wtns_k.b

    torch.cuda.reset_peak_memory_stats(dev)
    CF.reset_launch_counts()
    D.reset_level_counts()
    A._msb_rounds, A._carries_only = timed("msb", msb_rounds), timed("carries", carries_only)
    try:
        t0 = time.perf_counter()
        final = A.compute_lhs_witness_streamed(CURVE, scalars, pts, BASE, on_round)
        sync(dev)
        seconds = time.perf_counter() - t0
    finally:
        A._msb_rounds, A._carries_only = msb_rounds, carries_only
    counts = dict(CF.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    decompose_s = marks["msb"] - marks["msb_start"]
    carries_s = marks["carries"] - marks["carries_start"]
    per_round = [marks[0] - marks["carries"]] + [marks[k] - marks[k - 1] for k in range(1, d)]
    srt = sorted(per_round)
    print(f"  {seconds:.3f} s whole: host decomposition (_msb_rounds) {decompose_s:.3f} s, "
          f"carry stage {carries_s:.3f} s, {d} rounds {sum(per_round):.3f} s (a round: min "
          f"{srt[0]:.3f}, median {srt[d // 2]:.3f}, max {srt[-1]:.3f} s); peak "
          f"{peak / 2**20:.0f} MiB; levels by route {dict(D.LEVEL_COUNTS)}", flush=True)
    require(one_point(final) == want == tiled_msm_oracle(sc, base_pts),
            "the final carry equals the carry phase's result and the Python-int oracle")
    require(len(closes) == d and all(closes), f"all {d} rounds close to the identity")
    require(torch.equal(kept["a"], rnd["w"].a) and torch.equal(kept["b"], rnd["w"].b),
            f"round {ROUND_K}'s witness equals the round phase's, limb for limb")
    del kept

    digits, carry_prev, carry_new = rnd["carry_state"]
    precomp = A.precompute_multiplicities(E, pts, BASE)

    def three_rounds():
        for k in (0, ROUND_K, d - 1):
            rp = A._one_round_slots(CURVE, BASE, digits[k], precomp,
                                    A._at(carry_prev, k), A._at(carry_new, k))
            D.compute_divisor_witness_partial(CURVE, rp)

    busy = device_busy_ms(dev, three_rounds)
    print(f"  device busy in three rounds (0, {ROUND_K}, {d - 1}): {busy:.3f} ms", flush=True)
    return {"n": n, "rounds": d, "seconds": seconds, "decompose_s": decompose_s,
            "carries_s": carries_s, "per_round": per_round, "peak": peak, "busy3_ms": busy,
            "counts": counts}


# ---------------------------------------------------------------------------
# phase 20: the port's host oracles against the card
# ---------------------------------------------------------------------------

ORACLE_FF_N = 1 << 16     # field values held against the C++ oracle
ORACLE_MSM_N = 1 << 12    # points of the MSM held against it (double-and-add)
ORACLE_TREE_N = 1 << 12   # closing points of the merge tree held against it
TREE_KERNELS = ("batch_inv", "affine_lines", "poly_mul_naive", "kate_div2") + ROUND_KERNELS


def distinct_points(rng, curve, n: int):
    """A random point's first n multiples: n distinct points, one Python-int
    addition each."""
    g = pyref.random_point(rng, curve)
    pts, acc = [], g
    for _ in range(n):
        pts.append(acc)
        acc = pyref.ec_add(acc, g, curve)
    return pts


def coeff_ints(curve, t) -> list:
    """A (L, 16) tensor of Montgomery coefficient rows -> canonical ints."""
    return PolyInts.from_device(curve.field, t).coeffs


def equals_padded(got: list, want: list) -> bool:
    """A coefficient vector of the merge tree (padded with zeros to its
    level's length) against an exact-length one."""
    return got[:len(want)] == want and not any(got[len(want):])


def oracle_path(dev):
    """The port's C++ oracle (and its Python-int ones) against the card: the
    field kernels, best_multiexp, the merge tree, and the tree on the golden
    vectors.  Returns a dict of sizes and seconds."""
    t_phase = time.perf_counter()
    out = {}
    path = oracle.build()
    out["build_s"] = oracle.BUILD_INFO["seconds"]
    print(f"host oracles: g++ build of the C++ oracle in {out['build_s']:.2f} s ({path.name})",
          flush=True)
    rng = random.Random(0x0AC1)
    p = SPEC.p
    E = ec(CURVE)

    # field: mont_mul, mont_addsub and FF.inv (one batch_inv launch)
    n = ORACLE_FF_N
    edges = [0, 1, p - 1]
    xs = [x for x in edges for _ in edges] + [rng.randrange(p) for _ in range(n - 9)]
    ys = [y for _ in edges for y in edges] + [rng.randrange(p) for _ in range(n - 9)]
    a = limbs_from_numpy(ints_to_mont_limbs(xs, SPEC), dev)
    b = limbs_from_numpy(ints_to_mont_limbs(ys, SPEC), dev)
    F = ff(SPEC)
    CF.reset_launch_counts()
    got = [F.mul(a, b), F.add(a, b), F.inv(a)]
    sync(dev)
    counts = dict(CF.LAUNCHES)
    got = [mont_limbs_to_ints(limbs_to_numpy(t), SPEC) for t in got]
    want = [oracle.ff_mul(SPEC, xs, ys), oracle.ff_add(SPEC, xs, ys), oracle.ff_inv(SPEC, xs)]
    require(got == want, f"FF.mul, FF.add and FF.inv on {n} values (0, 1 and p - 1 among "
                         f"them) equal the C++ oracle's ff_mul, ff_add and ff_inv")
    require(counts["mont_mul"] == counts["mont_addsub"] == counts["batch_inv"] == 1
            and sum(counts.values()) == 3,
            "they launched mont_mul, mont_addsub and batch_inv once each, nothing else")

    # the MSM: full-width scalars, an identity among the points
    n = ORACLE_MSM_N
    pts = distinct_points(rng, CURVE, n)
    pts[7] = None
    q = CURVE.scalar_field.p
    sc = [0, 1, q - 1] + [rng.randrange(q) for _ in range(n - 3)]
    t0 = time.perf_counter()
    want = oracle.ec_msm(CURVE, sc, pts)
    out["msm_cpp_s"] = time.perf_counter() - t0
    M.msm_ints(CURVE, sc, pts, device=dev)
    sync(dev)
    CF.reset_launch_counts()
    t0 = time.perf_counter()
    got = M.msm_ints(CURVE, sc, pts, device=dev)
    out["msm_card_s"] = time.perf_counter() - t0
    require(all(CF.LAUNCHES[k] > 0 for k in MSM_KERNELS),
            "best_multiexp launched " + ", ".join(f"{k} {CF.LAUNCHES[k]}" for k in MSM_KERNELS))
    require(got == want,
            f"best_multiexp on the card at {n} points (full-width scalars, 0, 1 and q - 1 "
            f"among them, an identity among the points; {out['msm_card_s']:.3f} s) equals "
            f"the C++ oracle's ec_msm ({out['msm_cpp_s']:.2f} s)")

    # the merge tree: closing points, identities sprinkled in
    n = ORACLE_TREE_N
    pts = distinct_points(rng, CURVE, n - 1)
    for i in range(3, n - 1, 97):
        pts[i] = None
    s = None
    for pt in pts:
        s = pyref.ec_add(s, pt, CURVE)
    pts.append(pyref.ec_neg(s, CURVE))
    t0 = time.perf_counter()
    ca, cb, cout = oracle.divisor_witness(CURVE, pts)
    out["tree_cpp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hrf, hout = ref_divisor.divisor_witness_host(CURVE, pts)
    out["tree_py_s"] = time.perf_counter() - t0
    rp = E.points_from_ints(pts, dev)
    D.compute_divisor_witness_partial(CURVE, rp)
    sync(dev)
    CF.reset_launch_counts()
    D.reset_level_counts()
    t0 = time.perf_counter()
    w, wout = D.compute_divisor_witness_partial(CURVE, rp)
    sync(dev)
    out["tree_card_s"] = time.perf_counter() - t0
    counts, levels = dict(CF.LAUNCHES), dict(D.LEVEL_COUNTS)
    wa, wb = coeff_ints(CURVE, w.a), coeff_ints(CURVE, w.b)
    require(cout is None and hout is None and one_point(wout) is None
            and ca == hrf.a.coeffs and cb == hrf.b.coeffs
            and equals_padded(wa, ca) and equals_padded(wb, cb),
            f"the merge tree on the card at {n} closing points ({len(range(3, n - 1, 97))} "
            f"identities; levels {levels}; {out['tree_card_s']:.3f} s) equals the C++ "
            f"oracle's divisor_witness ({out['tree_cpp_s']:.2f} s) and ref_divisor's "
            f"({out['tree_py_s']:.2f} s), {len(ca)} + {len(cb)} coefficients")
    require(all(counts[k] > 0 for k in TREE_KERNELS),
            "the tree launched " + ", ".join(f"{k} {counts[k]}" for k in TREE_KERNELS))

    # the golden vectors: rustsem reproduces them; the tree equals them up
    # to the one scalar between the two line conventions
    for name, curve in (("pallas", PALLAS), ("grumpkin", GRUMPKIN)):
        gpts, ga, gb = rustsem.load_golden(name)
        rw, rout = rustsem.compute_divisor_witness_partial([(x, y, 1) for x, y in gpts], curve)
        require(rustsem.jac_is_identity(rout) and rw.a == ga and rw.b == gb,
                f"rustsem reproduces data/golden_divisor_{name}.json exactly")
        w, wout = D.compute_divisor_witness_partial(curve, ec(curve).points_from_ints(gpts, dev))
        wa, wb = coeff_ints(curve, w.a), coeff_ints(curve, w.b)
        cp = curve.field.p
        i0 = next(i for i, c in enumerate(wa) if c)
        k = ga[i0] * pow(wa[i0], cp - 2, cp) % cp
        require(k != 0 and equals_padded(wa, [c * pow(k, cp - 2, cp) % cp for c in ga])
                and equals_padded(wb, [c * pow(k, cp - 2, cp) % cp for c in gb])
                and ec(curve).points_to_ints(JPoint(*(c[None] for c in wout)))[0] is None,
                f"the merge tree on the card on the {len(gpts)} golden {name} points equals the "
                f"golden witness times one nonzero scalar ({len(ga)} + {len(gb)} coefficients)")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 21: the circuit, its rounds through the card's merge tree
# ---------------------------------------------------------------------------

CIRCUIT_POINTS = 64


def circuit_path(dev):
    """synthesize.assemble on CIRCUIT_POINTS Pallas points (base 5), every
    gate vanishing on every row; every round's slot list through the merge
    tree on the card, equal to the round's stream in the a column; the
    carry equal to best_multiexp on the card.  Returns a dict of sizes and
    seconds."""
    t_phase = time.perf_counter()
    rng = random.Random(0xC1C)
    n = CIRCUIT_POINTS
    pts = tuple(distinct_points(rng, CURVE, n))
    prm = Params(num_pts=n, base=BASE, logtable=4, poly_fan_in=10, batch_offset=36, pts=pts)
    ext = params_check(CURVE, prm)
    d = ext.num_digits
    # scalars of d random digits in [0, base), the top one nonzero: every
    # round has points, and each scalar fits the d digits the layout holds
    scalars = [negbase_recompose([rng.randrange(BASE) for _ in range(d - 1)]
                                 + [rng.randrange(1, BASE)], BASE) for _ in range(n)]
    v, ch, r = (rng.randrange(SPEC.p) for _ in range(3))
    print(f"circuit: {n} Pallas points, base {BASE}, logtable {prm.logtable}, poly_fan_in "
          f"{prm.poly_fan_in}, batch_offset {prm.batch_offset}: {ext}", flush=True)
    t0 = time.perf_counter()
    asm = assemble(CURVE, prm, scalars, v, ch, r)
    out = {"n": n, "rows": asm.grid.nrows, "assemble_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    bad = {name: asm.grid.eval_gate(g) for name, g in asm.gates.items()}
    out["check_s"] = time.perf_counter() - t0
    require(not any(bad.values()),
            f"synthesize.assemble ({out['assemble_s']:.2f} s, {asm.grid.nrows} rows) and every "
            f"gate of the checker vanishing on every row ({out['check_s']:.2f} s): "
            + ", ".join(f"{name} fails at {len(b)} rows" for name, b in bad.items()))

    carry, slots = host_round_slots(CURVE, scalars, list(pts), BASE, d)
    carry2, rounds = host_round_polys(CURVE, scalars, list(pts), BASE, d)
    E = ec(CURVE)
    bs = ext.batch_size
    acol = asm.grid.cols["a"]
    out["card_rounds_s"] = 0.0
    ok = []
    CF.reset_launch_counts()
    for k, (tmp, (ca, cb)) in enumerate(zip(slots, rounds)):
        rp = E.points_from_ints(tmp, dev)
        sync(dev)
        t0 = time.perf_counter()
        w, wout = D.compute_divisor_witness_partial(CURVE, rp)
        sync(dev)
        out["card_rounds_s"] += time.perf_counter() - t0
        wa, wb = coeff_ints(CURVE, w.a), coeff_ints(CURVE, w.b)
        stream = (wa[:len(ca)] + wb[:len(cb)])[:bs][:max(0, asm.grid.nrows - k * bs)]
        ok.append(one_point(wout) is None and equals_padded(wa, ca) and equals_padded(wb, cb)
                  and len(stream) > 0 and acol[k * bs:k * bs + len(stream)] == stream)
    out["rounds"] = len(slots)
    counts = dict(CF.LAUNCHES)
    require(counts["poly_mul_naive"] > 0 and counts["affine_lines"] > 0,
            "the rounds launched poly_mul_naive and affine_lines")
    require(all(ok) and carry == carry2,
            f"all {len(slots)} rounds' slot lists ({min(map(len, slots))}-"
            f"{max(map(len, slots))} points) through the merge tree on the card "
            f"({out['card_rounds_s']:.3f} s): each round's a||b equals its stream in the a "
            f"column")
    got = M.msm_ints(CURVE, scalars, list(pts), device=dev)
    require(got == carry, "the circuit's carry equals best_multiexp on the card on the same "
                          "points and scalars")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 22: the sharded paths (parallel/) on ranks that share the card
# ---------------------------------------------------------------------------

SHARDED_D = 4                          # gloo ranks, every one on cuda:0
SHARDED_ROUNDS = (0, 27, ROUND_K, 55)  # carry-stage rounds, one a rank
HIER_LOGN = 16                         # points of the hierarchical witness's rounds (phase 19's)
NCCL_TREE_LOGN = 12                    # closing points of the NCCL run's a2a witness
CLOSING_SEED, HIER_SEED, UNSAFE_SEED = 0xC105, 0x41E2, 0x0A2A


def witness_sha(w) -> str:
    """SHA-256 of a witness's a and b coefficient rows, with their shapes."""
    h = hashlib.sha256()
    for t in (w.a, w.b):
        h.update(str(tuple(t.shape)).encode())
        h.update(limbs_to_numpy(t).tobytes())
    return h.hexdigest()


def closing_digit_points(dev, base_pts, logn: int, seed: int) -> JPoint:
    """2^logn points tiled from base_pts, each times a seeded digit in [0,
    BASE) (the identity at 0), the last slot replaced by the negated sum of
    the others (a 64-point MSM of the digit sums on the host): a closing
    list whose sub-sums are random combinations of the base points, so no
    level meets an exceptional input but with negligible probability."""
    n = 1 << logn
    E = ec(CURVE)
    digits = np.random.default_rng(seed).integers(0, BASE, size=n).astype(np.int32)
    precomp = A.precompute_multiplicities(E, tiled_points(dev, base_pts, n), BASE)
    sel = A._select_digit_points(precomp, torch.from_numpy(digits).to(dev))
    sums = np.bincount(np.arange(n - 1) % len(base_pts), weights=digits[:-1],
                       minlength=len(base_pts)).astype(np.int64)
    last = E.points_from_ints(
        [pyref.ec_neg(pyref.ec_msm([int(s) for s in sums], base_pts, CURVE), CURVE)], dev)
    for c, l in zip(sel, last):
        c[-1] = l[0]
    return sel


def hier_rounds(dev, base_pts, logn: int, seed: int) -> JPoint:
    """Two rounds of seeded base-BASE digits over 2^logn tiled points
    (argument._rounds_and_carries: BASE carry slots, the digit slots, the
    closing slot), identity-padded to the next power of two of slots."""
    n = 1 << logn
    digits = np.random.default_rng(seed).integers(0, BASE, size=(2, n)).astype(np.int32)
    rp, _ = A._rounds_and_carries(CURVE, BASE, torch.from_numpy(digits).to(dev),
                                  tiled_points(dev, base_pts, n))
    s = rp.x.shape[1]
    idp = ec(CURVE).identity((2, (1 << (s - 1).bit_length()) - s), dev)
    return JPoint(*(torch.cat([c, i], dim=1) for c, i in zip(rp, idp)))


def sharded_round_inputs(carry_state) -> dict:
    """The carry stage's digit rows and carries (Jacobian limbs, as the round
    phase used them) of SHARDED_ROUNDS, for the ranks to rebuild the rounds."""
    digits, carry_prev, carry_new = carry_state
    idx = torch.tensor(SHARDED_ROUNDS, device=digits.device)
    return {"digits": digits[idx].to(torch.uint8).cpu().numpy(),
            "prev": torch.stack(tuple(c[idx] for c in carry_prev)).cpu().numpy(),
            "new": torch.stack(tuple(c[idx] for c in carry_new)).cpu().numpy()}


def _timed_part(dev, mesh, fn) -> dict:
    """fn() between two barriers of the world: its seconds (the slowest
    rank's), the bytes this rank sent by collective kind and its peak."""
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    sent0 = dict(mesh.sent)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    res = fn()
    sync(dev)
    torch.distributed.barrier()
    res["seconds"] = time.perf_counter() - t0
    res["sent"] = {k: mesh.sent[k] - sent0[k] for k in mesh.sent}
    res["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20 if on_card else 0.0
    return res


def _tree_res(mesh, w, out) -> dict:
    return {"sha": witness_sha(w), "closes": bool(ec(CURVE).is_identity(out).all()),
            "reruns": PM.reruns}


def nccl_rank(rank, dev, inp) -> dict:
    """Phase 22 (a), the one NCCL rank: sharded_msm at 2^logn and the a2a
    witness at 2^NCCL_TREE_LOGN closing points, both flavors."""
    mesh = PM.make_mesh(1, device=dev)
    _, scalars, pts = msm_inputs(dev, inp["base_pts"], inp["logn"])
    out = {"msm": _timed_part(dev, mesh, lambda: {
        "point": one_point(PM.sharded_msm(CURVE, scalars, pts, mesh))})}
    del scalars, pts
    cp = closing_digit_points(dev, inp["base_pts"], NCCL_TREE_LOGN, CLOSING_SEED)
    for name, cs in (("a2a", False), ("a2a_coeff_sharded", True)):
        out[name] = _timed_part(dev, mesh, lambda cs=cs: _tree_res(
            mesh, *PM.points_sharded_divisor_witness_a2a(CURVE, mesh, cp, coeff_sharded=cs)))
    return out


def gloo_rank(rank, dev, inp) -> dict:
    """Phase 22 (b), one of SHARDED_D gloo ranks on cuda:0: parts 1-5 in
    turn, each timed between barriers; inputs are rebuilt here from the
    phases' seeds (the carry stage's rounds from their digit rows and
    carries), outside the timed region."""
    base_pts, logn = inp["base_pts"], inp["logn"]
    E = ec(CURVE)
    m1 = PM.make_mesh(SHARDED_D, device=dev)
    m2 = PM.make_mesh_2d(2, SHARDED_D // 2, device=dev)
    out = {}
    t0 = time.perf_counter()
    for lg in range(6, logn + 2):     # the merge tree's host tables, built once
        D._fused_consts_dev(CURVE, lg, dev)
    out["setup_s"] = time.perf_counter() - t0

    _, scalars, pts = msm_inputs(dev, base_pts, logn)
    out["msm"] = _timed_part(dev, m1, lambda: {
        "point": one_point(PM.sharded_msm(CURVE, scalars, pts, m1))})
    out["msm_2d"] = _timed_part(dev, m2, lambda: {
        "point": one_point(PM.sharded_msm_2d(CURVE, scalars, pts, m2))})
    del scalars

    precomp = A.precompute_multiplicities(E, pts, BASE)
    digits = torch.from_numpy(inp["digits"]).to(dev).to(torch.int32)
    prev, new = (torch.from_numpy(inp[k]).to(dev) for k in ("prev", "new"))
    rp = [A._one_round_slots(CURVE, BASE, digits[i], precomp, JPoint(*prev[:, i]),
                             JPoint(*new[:, i])) for i in range(len(SHARDED_ROUNDS))]
    rounds = JPoint(*(torch.stack(c) for c in zip(*rp)))
    del precomp, rp, pts

    def round_part():
        w, o = PM.sharded_divisor_witness(CURVE, m1, rounds)
        return {"sha": witness_sha(RF(w.a[0], w.b[0])), "closes": bool(E.is_identity(o).all()),
                "round": SHARDED_ROUNDS[rank]}
    out["rounds"] = _timed_part(dev, m1, round_part)
    del rounds

    cp = closing_digit_points(dev, base_pts, logn, CLOSING_SEED)
    out["points"] = _timed_part(dev, m1, lambda: _tree_res(
        m1, *PM.points_sharded_divisor_witness(CURVE, m1, cp)))
    for name, cs in (("a2a", False), ("a2a_coeff_sharded", True)):
        out[name] = _timed_part(dev, m1, lambda cs=cs: _tree_res(
            m1, *PM.points_sharded_divisor_witness_a2a(CURVE, m1, cp, coeff_sharded=cs)))
    del cp

    hr = hier_rounds(dev, base_pts, min(HIER_LOGN, logn), HIER_SEED)

    def hier_part():
        w, o = PM.hierarchical_divisor_witness(CURVE, m2, hr)
        return {"sha": witness_sha(RF(w.a[0], w.b[0])), "closes": bool(E.is_identity(o).all()),
                "row": rank // (SHARDED_D // 2)}
    out["hierarchical"] = _timed_part(dev, m2, hier_part)

    up = E.points_from_ints(
        pyref.root_on_domain_points(random.Random(UNSAFE_SEED), CURVE), dev)
    before = PM.reruns
    out["unsafe"] = _timed_part(dev, m1, lambda: _tree_res(
        m1, *PM.points_sharded_divisor_witness_a2a(CURVE, m1, up)))
    out["unsafe"]["reruns"] -= before
    return out


def _part_line(what: str, d: int, backend: str, sizes: str, res: list, card: str) -> None:
    sent = {k: max(r["sent"][k] for r in res) for k in res[0]["sent"]}
    print(f"sharded: part = {what}, D = {d}, backend = {backend}, {sizes}, seconds = "
          f"{max(r['seconds'] for r in res)}, sent_bytes_max_rank = {sent}, peak_mib_max_rank "
          f"= {max(r['peak_mib'] for r in res)}, card = {card}", flush=True)


def sharded_path(dev, base_pts, logn: int, rounds_in: dict, w28_sha: str, card: str) -> dict:
    """Phase 22: parallel/ on the card, through launch.run_world.  (a) one
    NCCL rank; (b) SHARDED_D gloo ranks time-sharing cuda:0, their
    collectives staged through host memory.  Every result is held against
    its single-device counterpart or oracle, computed here first."""
    t_phase = time.perf_counter()
    E = ec(CURVE)
    n = 1 << logn
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sc, _, _ = msm_inputs(dev, base_pts, logn)
    want_msm = tiled_msm_oracle(sc, base_pts)
    del sc
    want = {}
    for name, lg in (("nccl", NCCL_TREE_LOGN), ("points", logn)):
        w, o = D.compute_divisor_witness_partial(
            CURVE, closing_digit_points(dev, base_pts, lg, CLOSING_SEED))
        require(bool(E.is_identity(JPoint(*(c[None] for c in o)))[0]),
                f"the 2^{lg} closing points close on the single device")
        want[name] = witness_sha(w)
    hier_logn = min(HIER_LOGN, logn)
    hr = hier_rounds(dev, base_pts, hier_logn, HIER_SEED)
    w, o = D.compute_divisor_witness_partial(CURVE, hr)
    want["hier"] = [witness_sha(RF(w.a[i], w.b[i])) for i in range(2)]
    hier_slots = hr.x.shape[1]
    del hr, w, o
    up_ints = pyref.root_on_domain_points(random.Random(UNSAFE_SEED), CURVE)
    w, o = D.compute_divisor_witness_partial(CURVE, E.points_from_ints(up_ints, dev))
    want["unsafe"] = witness_sha(w)
    hrf, hout = ref_divisor.divisor_witness_host(CURVE, up_ints)
    require(equals_padded(coeff_ints(CURVE, w.a), hrf.a.coeffs)
            and equals_padded(coeff_ints(CURVE, w.b), hrf.b.coeffs) and one_point(o) == hout,
            "the single-device tree of the root-on-domain points equals ref_divisor")
    print(f"  references on the single device: {time.perf_counter() - t_phase:.1f} s", flush=True)

    inp = {"base_pts": base_pts, "logn": logn}
    t0 = time.perf_counter()
    a = run_world(nccl_rank, 1, "nccl", dev, args=(inp,), timeout_s=240)[0]
    a_s = time.perf_counter() - t0
    require(a["msm"]["point"] == want_msm,
            f"(a) NCCL, D = 1: sharded_msm at 2^{logn} equals the Python-int oracle")
    for name in ("a2a", "a2a_coeff_sharded"):
        require(a[name]["sha"] == want["nccl"] and a[name]["closes"] and a[name]["reruns"] == 0,
                f"(a) NCCL, D = 1: points_sharded_divisor_witness_{name} at 2^{NCCL_TREE_LOGN} "
                f"closing points equals the single-device tree")
    _part_line("msm", 1, "nccl", f"n = {n}", [a["msm"]], card)
    for name in ("a2a", "a2a_coeff_sharded"):
        _part_line(name, 1, "nccl", f"points = {1 << NCCL_TREE_LOGN}", [a[name]], card)
    print(f"  (a) the NCCL world: {a_s:.1f} s with its start", flush=True)

    t0 = time.perf_counter()
    b = run_world(gloo_rank, SHARDED_D, "gloo", dev, args=(dict(inp, **rounds_in),),
                  timeout_s=420)
    b_s = time.perf_counter() - t0
    print(f"  (b) the gloo world: {b_s:.1f} s with its start; the ranks' host tables "
          f"{max(r['setup_s'] for r in b):.1f} s", flush=True)
    for name in ("msm", "msm_2d"):
        require(all(r[name]["point"] == want_msm for r in b),
                f"(b) gloo, D = {SHARDED_D}: sharded_{name} at 2^{logn} on every rank equals "
                f"the Python-int oracle")
    require(all(r["rounds"]["closes"] for r in b)
            and [r["rounds"]["round"] for r in b] == list(SHARDED_ROUNDS)
            and b[SHARDED_ROUNDS.index(ROUND_K)]["rounds"]["sha"] == w28_sha,
            f"(b) sharded_divisor_witness on rounds {SHARDED_ROUNDS} ({BASE + n + 1} slots "
            f"each), one a rank: every round closes and round {ROUND_K}'s witness equals the "
            f"round phase's bit for bit")
    for name in ("points", "a2a", "a2a_coeff_sharded"):
        require(all(r[name]["sha"] == want["points"] and r[name]["closes"]
                    and r[name]["reruns"] == 0 for r in b),
                f"(b) points_sharded_divisor_witness{'' if name == 'points' else '_' + name} at "
                f"2^{logn} closing points equals the single-device tree on every rank, no rerun")
    require(all(r["hierarchical"]["sha"] == want["hier"][r["hierarchical"]["row"]]
                and r["hierarchical"]["closes"] for r in b),
            f"(b) hierarchical_divisor_witness on a 2x{SHARDED_D // 2} mesh: two rounds of "
            f"2^{hier_logn} points padded to {hier_slots} slots equal the single-device tree")
    require(all(r["unsafe"]["reruns"] == 1 and r["unsafe"]["sha"] == want["unsafe"]
                for r in b),
            "(b) the a2a witness on the root-on-domain points: every rank took the replicated "
            "rerun, and the result equals the single-device tree and ref_divisor")
    sizes = {"msm": f"n = {n}", "msm_2d": f"n = {n}, mesh = 2x{SHARDED_D // 2}",
             "rounds": f"rounds = {len(SHARDED_ROUNDS)}, slots = {BASE + n + 1}",
             "points": f"points = {n}", "a2a": f"points = {n}",
             "a2a_coeff_sharded": f"points = {n}",
             "hierarchical": f"rounds = 2, slots = {hier_slots}, mesh = 2x{SHARDED_D // 2}",
             "unsafe": "points = 128"}
    for name, what in sizes.items():
        _part_line(name, SHARDED_D, "gloo", what, [r[name] for r in b], card)
    seconds = time.perf_counter() - t_phase
    print(f"  the sharded phase: {seconds:.1f} s", flush=True)
    return {"phase_s": seconds, "nccl_s": a_s, "gloo_s": b_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--logn", type=int, default=20,
                    help="log2 of the MSM, carry-stage and round size")
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler tables of one MSM, one carry stage "
                         "and one round")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    CF.build_library()
    print(f"build: {CF.BUILD_INFO['path']} in {CF.BUILD_INFO['seconds']:.1f} s", flush=True)
    entry = ""
    for ln in CF.BUILD_INFO.get("ptxas", "").splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln or "spill" in ln:
            print(f"  ptxas {entry}: {ln.split(':', 1)[-1].strip()}", flush=True)

    base_pts = pyref.random_points(random.Random(0xBE7C), CURVE, 64)
    n = 1 << args.logn
    g = max(1, n // CF.SCAN_W)
    nb = 1 << M.pick_window(n)
    # ec_madd_xyzz_fast runs only in card windows below FUSED_SCAN_MIN_ROWS
    # points: its shape is the (carries, steps) of the stepwise scan of the
    # widest of them, the one the fallback phase drives.  ec_add_mixed: one
    # step of a safe window at n.
    step_logn = (M.FUSED_SCAN_MIN_ROWS // 2).bit_length() - 1
    step_w = M._pick_block_width(1 << step_logn, True)
    step_lanes = (1 << step_logn) // step_w
    # ec_add_fast: a step of a window's triangle scan, nb buckets in blocks
    # of _pick_block_width steps (2048 lanes at c = 15)
    shapes = {"mont_mul": n, "batch_inv": 2 * n, "mont_addsub": nb, "ec_add": min(g, 2048),
              "ec_add_fast": nb // M._pick_block_width(nb, True), "ec_double": 1,
              "fused_madd_scan_xyzz": g, "ec_madd_xyzz_fast": (step_lanes, step_w), "ec_add_mixed": g,
              "ec_add_mixed_fast": n}
    ragged = 5000
    recs = check_kernels(dev, base_pts, ragged=ragged, shapes=shapes,
                         scan_small_g=2050, reps=50)
    recs += check_ntt_kernels(dev, ragged=5000, reps=50, top_logn=args.logn + 1)
    r1_phase()
    recs += mxu_phase(dev, args.logn, reps=50)
    radix_recs, radix_plans = check_radix_kernels(dev, args.logn, reps=50)
    recs += radix_recs

    seconds, msm_counts, (scalars, pts) = main_path(dev, base_pts, args.logn)
    if args.profile:
        profile_call(dev, "best_multiexp", lambda: M.best_multiexp(CURVE, scalars, pts))
    del scalars
    carry_s, carry_counts, rounds, carry_state, carry_out = carry_path(
        dev, base_pts, pts, args.logn, args.profile)
    rnd = round_path(dev, pts, carry_state, args.profile)
    sharded_in, w28_sha = sharded_round_inputs(carry_state), witness_sha(rnd["w"])
    del carry_state
    tally, busy = launch_tally(dev, base_pts, args.logn, pts, rnd)
    lines_in = capture_lines_inputs(pts, rnd)
    radix_by_name = {rec["name"]: rec for rec in radix_recs if rec["name"] in RADIX_AB}
    ab, ranking = ab_phase(dev, base_pts, tally, lines_in, args.logn, ragged, shapes,
                           radix_by_name, reps=50)
    # the coefficient levels' kernels: their records at the shape of the most
    # products in a round (kate_div, on no path now, at kate_div2's) and at
    # a ragged one; the merge head's and its first design's at a ragged
    # width and the widest of the round
    work = {"poly_mul_naive": lambda key: key[0] * key[1] * key[2],
            "kate_div2": lambda key: key[0] * (key[1] - 1)}
    row_keys = {name: max(tally[name]["round"].items(),
                          key=lambda kv, name=name: (kv[1] * work[name](kv[0]), kv[0]))[0]
                for name in POLY_KERNELS}
    row_keys["kate_div"] = row_keys["kate_div2"]
    recs += check_poly_kernels(dev, row_keys, {"poly_mul_naive": (5003, 9, 17, False, False),
                                               "kate_div2": (5003, 33), "kate_div": (5003, 33)},
                               reps=50)
    for name in ("affine_lines", "affine_lines_v1"):
        recs.append(check_lines_kernel(dev, base_pts, lines_in,
                                       [(5003, "head"), max(tally["affine_lines"]["round"])],
                                       reps=50, name=name))
    del lines_in
    # at 2^14 the fused scan flags and the safe flavor redoes the round at a
    # real width; at half of FUSED_SCAN_MIN_ROWS the stepwise scan runs
    fallback_counts = {name: 0 for name in CF.KERNELS}
    for logn in (min(14, args.logn), step_logn):
        for name, count in fallback_path(dev, base_pts, logn).items():
            fallback_counts[name] += count
    for name in FALLBACK_KERNELS:
        require(fallback_counts[name] > 0,
                f"{name} was launched by the fallback's round_sums "
                f"({fallback_counts[name]} times)")
    for r in ab["ec_madd_xyzz_fast"]:  # the stepwise round_sums runs at the first shape
        if (r["g"], r["w"]) == shapes["ec_madd_xyzz_fast"]:
            r["launches"] = fallback_counts["ec_madd_xyzz_fast"]
    safe = safe_msm_path(dev, base_pts, args.logn)
    ranking["ec_add_mixed"].update(safe_rule2(ab["ec_add_mixed"], safe))
    routes = time_window_routes(dev, base_pts, (6, 7, 8, 10, 12, 14, 16))
    cpu_round_path(dev, base_pts, min(10, args.logn))
    divisor_fallback_path(dev)
    # the radix route takes windows of at least 2^17 points
    radix_logn = max(args.logn, 17)
    radix = radix_msm_path(dev, base_pts, radix_logn)
    radix_counts = radix["radix"]["counts"]
    for name, r in radix_rule2(radix_by_name, radix_plans, radix).items():
        ranking[name].update(r)
    window_routes = radix_window_routes(dev, base_pts, radix_logn)
    radix_overflow_path(dev, base_pts)
    # the paths of this slice last, on the round phase's slots and witness and
    # the carry phase's inputs, kept until here
    amf_counts, amf_s = add_mixed_fast_path(dev, base_pts, args.logn)
    naive = naive_path(dev, rnd)
    del rnd["rp"]
    cfg4 = config4_path(dev, base_pts, pts, carry_out, rnd)
    del pts, rnd["w"], rnd["carry_state"]
    model = model_path(dev, base_pts, min(16, args.logn))
    oracles = oracle_path(dev)
    circuit = circuit_path(dev)
    sharded = sharded_path(dev, base_pts, args.logn, sharded_in, w28_sha, card)

    by_name = {rec["name"]: rec for rec in recs}
    for name in ab:
        by_name[name]["ab"] = ab[name]  # every shape of phase 9b
    for name in RULE2_KERNELS:
        by_name[name]["rule2"] = ranking[name]
    by_phase = {"launches_msm": msm_counts, "launches_carry": carry_counts,
                "launches_fallback": fallback_counts, "launches_round": rnd["counts"],
                "launches_radix_msm": radix_counts, "launches_add_mixed_fast": amf_counts,
                "launches_naive": naive["counts"], "launches_model": model["counts"],
                "launches_config4": cfg4["counts"], "launches_safe_msm": safe["counts"]}
    for rec in recs:
        name = rec["name"]
        rec["launches"] = (fallback_counts if name in FALLBACK_KERNELS else
                           rnd["counts"] if name in ROUND_KERNELS + POLY_KERNELS
                           + ("affine_lines",) + FIRST_DESIGNS else
                           radix_counts if name in RADIX_KERNELS else
                           amf_counts if name == "ec_add_mixed_fast" else msm_counts).get(name, 0)
        for key, counts in by_phase.items():
            rec[key] = counts.get(name, 0)
        print(f"  {name}: launches {rec['launches_msm']} (MSM), {rec['launches_carry']} "
              f"(carry stage), {rec['launches_fallback']} (fallback round_sums), "
              f"{rec['launches_round']} (one round), {rec['launches_radix_msm']} (radix-route "
              f"MSM), {rec['launches_add_mixed_fast']} (EC.add_mixed_fast), "
              f"{rec['launches_naive']} (naive arrangement), {rec['launches_model']} (model "
              f"forward), {rec['launches_config4']} (config 4), {rec['launches_safe_msm']} "
              f"(safe MSM); {rec['ms']} ms each on the device at shape {rec['shape']}",
              flush=True)
        if name in OFF_PATH + FIRST_DESIGNS:
            require(all(rec[key] == 0 for key in by_phase),
                    f"{name}, a kernel of no path, was launched on no path")
        else:
            require(rec["launches"] > 0, f"{name} was launched on the path that runs it")

    print(f"msm: n = {n}, seconds = {seconds}, points_per_s = {n / seconds}, card = {card}",
          flush=True)
    print(f"carries: n = {n}, base = {BASE}, rounds = {rounds}, seconds = {carry_s}, "
          f"card = {card}", flush=True)
    print(f"device busy: msm_ms = {busy['msm']}, carry_stage_ms = {busy['carry stage']}, "
          f"msm_device_events = {busy['events']['msm']}, carry_stage_device_events = "
          f"{busy['events']['carry stage']}, "
          f"card = {card}", flush=True)
    for rn, fused_ms, step_ms, fused_dev, step_dev in routes:
        print(f"window routes: n = {rn}, fused_ms = {fused_ms}, stepwise_ms = {step_ms}, "
              f"fused_device_ms = {fused_dev}, stepwise_device_ms = {step_dev}, "
              f"FUSED_SCAN_MIN_ROWS = {M.FUSED_SCAN_MIN_ROWS}, card = {card}", flush=True)
    print(f"round: n = {rnd['n']}, slots = {rnd['slots']}, levels = {rnd['levels']}, "
          f"fused_levels = {rnd['fused']}, seconds = {rnd['seconds']}, "
          f"runs = {rnd['runs']}, device_busy_ms = {rnd['busy_ms']}, "
          f"peak_mib = {rnd['peak'] / 2**20}, setup_s = {rnd['setup_s']}, card = {card}",
          flush=True)
    print(f"add_mixed_fast: n = {n}, seconds = {amf_s}, card = {card}", flush=True)
    print(f"safe msm: n = {n}, windows = {safe['windows']}, seconds = {safe['seconds']}, "
          f"runs = {safe['runs']}, device_busy_ms = {safe['busy_ms']}, launches = "
          f"{safe['launches']}, ec_add_mixed = {safe['counts']['ec_add_mixed']}, ec_double = "
          f"{safe['counts']['ec_double']}, card = {card}", flush=True)
    print(f"naive: slots = {rnd['slots']}, seconds = {naive['seconds']}, pos_lines = "
          f"{naive['n_pos']}, neg_lines = {naive['n_neg']}, ratio_check_s = {naive['ratio_s']}, "
          f"card = {card}", flush=True)
    print(f"model: n = {model['n']}, rounds = {model['rounds']}, seconds = {model['seconds']}, "
          f"decompose_s = {model['decompose_s']}, device_busy_ms = {model['busy_ms']}, "
          f"peak_mib = {model['peak'] / 2**20}, card = {card}", flush=True)
    pr = sorted(cfg4["per_round"])
    print(f"config4: n = {cfg4['n']}, base = {BASE}, rounds = {cfg4['rounds']}, seconds = "
          f"{cfg4['seconds']}, decompose_s = {cfg4['decompose_s']}, carries_s = "
          f"{cfg4['carries_s']}, round_s_min = {pr[0]}, round_s_median = {pr[len(pr) // 2]}, "
          f"round_s_max = {pr[-1]}, device_busy_3_rounds_ms = {cfg4['busy3_ms']}, "
          f"peak_mib = {cfg4['peak'] / 2**20}, card = {card}", flush=True)
    for route in ("radix", "classic"):
        o = radix[route]
        print(f"msm route: route = {route}, n = {1 << radix_logn}, runs = {o['runs']}, "
              f"device_busy_ms = {o['busy_ms']}, peak_mib = {o['peak'] / 2**20}, "
              f"launches = {o['launches']}, card = {card}", flush=True)
    print(f"msm route: route = radix at {CURVE.scalar_field.p.bit_length()} bits (safe redo), "
          f"n = {1 << radix_logn}, seconds = {radix['overflowing']['seconds']}, "
          f"launches = {radix['overflowing']['launches']}, card = {card}", flush=True)
    print(f"radix spills: spilled_rows_by_window = {radix['spilled']}, "
          f"top_window_at_c = (mean spills a tile, overflowing tiles, tiles) "
          f"{radix['top_at_c']}, card = {card}", flush=True)
    for (what, route), (wall_ms, busy_ms) in window_routes.items():
        print(f"window route: part = {what}, route = {route}, n = {1 << radix_logn}, "
              f"wall_ms = {wall_ms}, device_busy_ms = {busy_ms}, card = {card}", flush=True)
    print(f"host oracles: phase_s = {oracles['phase_s']}, oracle_build_s = {oracles['build_s']}, ff_values = {ORACLE_FF_N}, "
          f"msm_points = {ORACLE_MSM_N}, msm_card_s = {oracles['msm_card_s']}, msm_cpp_s = "
          f"{oracles['msm_cpp_s']}, tree_points = {ORACLE_TREE_N}, tree_card_s = "
          f"{oracles['tree_card_s']}, tree_cpp_s = {oracles['tree_cpp_s']}, tree_py_s = "
          f"{oracles['tree_py_s']}, card = {card}", flush=True)
    print(f"circuit: phase_s = {circuit['phase_s']}, n = {circuit['n']}, rows = {circuit['rows']}, rounds = {circuit['rounds']}, "
          f"assemble_s = {circuit['assemble_s']}, check_s = {circuit['check_s']}, "
          f"card_rounds_s = {circuit['card_rounds_s']}, card = {card}", flush=True)
    print(f"sharded: phase_s = {sharded['phase_s']}, nccl_world_s = {sharded['nccl_s']}, "
          f"gloo_world_s = {sharded['gloo_s']}, card = {card}", flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
