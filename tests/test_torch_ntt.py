"""The NTT layer of the PyTorch port: host twiddle tables byte for byte
against the JAX package's, the element-major transforms against the JAX
package's (one jitted call), the limb-major transforms (the plain versions of
stage_big / stages_small) against the element-major ones, sampled outputs
against a Python-int DFT, and the pointwise limb-major ops against ops/ff.

All on the CPU.  Integer arithmetic: tolerance zero (torch.equal)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_liam_eagen_msm_tpu import fields as JF
from halo2_liam_eagen_msm_tpu.ops import ntt as jax_ntt
from halo2_liam_eagen_msm_tpu.ops import pallas_ntt as jax_pallas_ntt
from halo2_liam_eagen_msm_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy, lm_from_numpy
from halo2_liam_eagen_msm_tpu_torch.fields import BN254_FR, PALLAS_FP
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_mont_limbs, mont_limbs_to_ints
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ntt as CN
from halo2_liam_eagen_msm_tpu_torch.ops import ntt as N
from halo2_liam_eagen_msm_tpu_torch.ops.ff import ff

torch.set_num_threads(1)

SPEC = PALLAS_FP


def _elems(rng, count, spec=SPEC):
    xs = [rng.randrange(spec.p) for _ in range(count)]
    xs[:3] = [0, 1, spec.p - 1][:count]
    return xs, ints_to_mont_limbs(xs, spec)


@pytest.mark.parametrize("logn", range(1, 13))
def test_twiddle_flat_host_equals_jax(logn):
    """The running-product tables are byte-identical to the JAX package's
    pow() tables, both directions, two fields."""
    for spec, jspec in ((PALLAS_FP, JF.PALLAS_FP), (BN254_FR, JF.BN254_FR)):
        for inverse in (False, True):
            mine = N._twiddle_flat_host(spec, logn, inverse)
            theirs = jax_ntt._twiddle_flat_host(jspec, logn, inverse)
            assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
            assert mine.tobytes() == theirs.tobytes()
    assert (N._bitrev_perm(logn) == jax_ntt._bitrev_perm(logn)).all()


def test_transforms_equal_jax(rng):
    """ntt, ntt_dif and intt_dit (and the inverse ntt with its 1/n scale up
    to n = 8) equal the JAX package's on one shared batch of three transforms
    at test_ntt.py's sizes, log n in {0, 1, 3, 6}, in one jitted JAX call."""
    lengths = (1, 2, 8, 64)
    arrs = [_elems(rng, 3 * n)[1].reshape(3, n, 16) for n in lengths]

    def jax_all(xs):
        out = []
        for x in xs:
            out += [jax_ntt.ntt(JF.PALLAS_FP, x), jax_ntt.ntt_dif(JF.PALLAS_FP, x),
                    jax_ntt.intt_dit(JF.PALLAS_FP, x)]
            if x.shape[-2] <= 8:
                out.append(jax_ntt.ntt(JF.PALLAS_FP, x, True, True))
        return out

    want = jax.jit(jax_all)([jnp.asarray(a) for a in arrs])
    got = []
    for a in arrs:
        x = limbs_from_numpy(a, "cpu")
        got += [N.ntt(SPEC, x), N.ntt_dif(SPEC, x), N.intt_dit(SPEC, x)]
        if x.shape[-2] <= 8:
            got.append(N.ntt(SPEC, x, True, True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(limbs_to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("logn, batch", [(7, 3), (10, 1), (11, 2), (12, 1)])
def test_lm_transforms_equal_element_major(rng, logn, batch):
    """ntt_dif_lm / intt_dit_lm (stages_small, and stage_big from log n = 11
    on) equal ntt_dif / intt_dit without the scale, at E = batch * n
    elements: 3 * 128 is no multiple of 1024."""
    n = 1 << logn
    x = limbs_from_numpy(_elems(rng, batch * n)[1].reshape(batch, n, 16), "cpu")
    spec_em = N.ntt_dif(SPEC, x)
    spec_lm = CN.ntt_dif_lm(SPEC, CN.to_lm(x), logn)
    assert torch.equal(CN.from_lm(spec_lm, (batch, n)), spec_em)
    back = CN.intt_dit_lm(SPEC, spec_lm, logn)
    assert torch.equal(CN.from_lm(back, (batch, n)), N.intt_dit(SPEC, spec_em, scale=False))
    # n x back, the 1/n the fused merge folds into its inversion
    assert torch.equal(back, CN.lm_mul_const(SPEC, CN.to_lm(x), (n << 256) % SPEC.p))


def test_lm_dft_samples(rng):
    """At log n = 11, 16 sampled outputs of ntt_dif_lm (bit-reversed order)
    equal the Python-int DFT sum_j x_j w^(j k), k = rev(i)."""
    logn, n = 11, 1 << 11
    xs, limbs = _elems(rng, n)
    got = mont_limbs_to_ints(limbs_to_numpy(CN.from_lm(
        CN.ntt_dif_lm(SPEC, CN.to_lm(limbs_from_numpy(limbs, "cpu")), logn), (n,))), SPEC)
    w = SPEC.omega_pow(SPEC.s - logn)
    rev = N._bitrev_perm(logn)
    for i in random.Random(11).sample(range(n), 16):
        k = int(rev[i])
        wk = pow(w, k, SPEC.p)
        acc, pw = 0, 1
        for x in xs:
            acc = (acc + x * pw) % SPEC.p
            pw = pw * wk % SPEC.p
        assert got[i] == acc, f"output {i} (frequency {k})"


@pytest.mark.parametrize("name", ["lm_mul", "lm_addsub", "lm_mul_const"])
def test_lm_pointwise_equals_ff(rng, name):
    """The pointwise limb-major ops equal ops/ff on transposed data."""
    k = ff(SPEC)
    a = limbs_from_numpy(_elems(rng, 37)[1], "cpu")
    b = limbs_from_numpy(_elems(rng, 37)[1][::-1], "cpu")
    la, lb = CN.to_lm(a), CN.to_lm(b)
    if name == "lm_mul":
        pairs = [(CN.lm_mul(SPEC, la, lb), k.mul(a, b))]
    elif name == "lm_addsub":
        pairs = [(CN.lm_add(SPEC, la, lb), k.add(a, b)), (CN.lm_sub(SPEC, la, lb), k.sub(a, b))]
    else:
        c = rng.randrange(SPEC.p)
        pairs = [(CN.lm_mul_const(SPEC, la, (c << 256) % SPEC.p), k.mul(a, k.const(c, "cpu")))]
    for got, want in pairs:
        assert tuple(got.shape) == (16, 37)
        assert torch.equal(CN.from_lm(got, (37,)), want)


def test_lm_layout_matches_jax(rng):
    """to_lm / from_lm, and lm_from_numpy of the JAX package's padded
    (16, nb, 8, 128) blocks, at E = 3 * 128 + 5 (ragged); the broadcasts of
    the fused merge's per-pair and table terms."""
    e = 3 * 128 + 5
    x = _elems(rng, e)[1]
    mine = CN.to_lm(limbs_from_numpy(x, "cpu"))
    theirs = np.asarray(jax_pallas_ntt.to_lm(jnp.asarray(x)))
    assert theirs.shape == (16, 1, 8, 128)
    assert torch.equal(lm_from_numpy(theirs, e, "cpu"), mine)
    assert torch.equal(CN.from_lm(mine, (e,)), limbs_from_numpy(x, "cpu"))
    v = limbs_from_numpy(x[:6], "cpu").reshape(2, 3, 16)
    pairs = CN.bcast_pairs_lm(v, 4)
    assert torch.equal(CN.from_lm(pairs, (6, 4)), v.reshape(6, 1, 16).expand(6, 4, 16))
    tab = CN.bcast_table_lm(v.reshape(6, 16), 2)
    assert torch.equal(CN.from_lm(tab, (2, 6)), v.reshape(1, 6, 16).expand(2, 6, 16))
