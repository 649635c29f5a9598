"""The benchmark's plain reference: Python ints and NumPy, nothing of the
program, JAX or the JAX package (curve.py: the group law; check.py: the
expected carries, slots and witnesses, and the comparison)."""
