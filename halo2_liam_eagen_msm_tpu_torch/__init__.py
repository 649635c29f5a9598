"""halo2_liam_eagen_msm_tpu_torch: the PyTorch/CUDA port of the witness
pipeline for Liam Eagen's MSM argument (eprint 2022/596), for one NVIDIA
Hopper card.

Module names follow the JAX package so that a reader finds the counterpart:

  fields.py, limbs.py   field/curve specs and host int <-> limb conversions
  config.py             debug switches and the device resolver
  convert.py            numpy limb arrays and digits <-> torch tensors
  negbase.py            radix -base scalar decomposition (host, numpy)
  argument.py           the argument: carry stage (round sums -> carries) and
                        the witness entry points (compute_lhs_witness[_streamed])
  divisor.py            the divisor merge tree (compute_divisor_witness_partial)
  ops/cuda_ff.py        the hand-written CUDA kernels (ops/csrc/), their
                        wrappers, launch counters and plain PyTorch versions
  ops/cuda_ntt.py       the merge tree's limb-major kernels (ops/csrc/ntt.cuh):
                        wrappers, plain versions, layout helpers, transforms
  ops/ff.py, ops/ec.py  field and curve layers (kernel on a CUDA tensor,
                        plain version on a CPU tensor)
  ops/ntt.py, ops/poly.py  element-major NTT and polynomial algebra
  ops/msm.py            Pippenger best_multiexp and round_sums
  utils/pyref.py        exact Python-int oracles

The package imports torch and numpy only.
"""

from . import fields, limbs

__version__ = "0.1.0"
