"""The circuit layer: layout, gates, an out-of-circuit checker and the
witness columns of a LiamMSM instance, on host Python ints.

The port's own copy of the JAX package's circuit/, on the port's argument
helpers (logb_ceil, order), negbase, pyref and ref_divisor.  Nothing here
runs on a device: parameters, points and witnesses are Python ints."""

from . import checker, gates, layout, params
