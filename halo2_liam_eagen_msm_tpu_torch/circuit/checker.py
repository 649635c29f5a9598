"""Out-of-circuit constraint checker — the MockProver analog.

The reference validates circuit fragments with halo2's MockProver over a 2^k
grid (the reference's testing_stuff/*, SURVEY.md §4.4).  This checker
plays that role without a SNARK stack: columns are plain int lists over a
grid with wrap-around rotations (MockProver semantics), gates are functions
from gates.py, and `assert_satisfied` demands every gate vanish on every row.
"""

from __future__ import annotations

from typing import Callable


class Grid:
    def __init__(self, nrows: int, p: int):
        self.nrows = nrows
        self.p = p
        self.cols: dict[str, list[int]] = {}

    def set_col(self, name: str, values, default: int = 0):
        v = list(values)[: self.nrows]
        v += [default] * (self.nrows - len(v))
        self.cols[name] = [x % self.p for x in v]

    def view(self, row: int) -> Callable[[str, int], int]:
        def v(col: str, rot: int) -> int:
            return self.cols[col][(row + rot) % self.nrows]

        return v

    def eval_gate(self, gate: Callable, rows=None) -> list[int]:
        """Rows where the gate does NOT vanish."""
        bad = []
        for row in rows if rows is not None else range(self.nrows):
            if gate(self.p, self.view(row)) % self.p != 0:
                bad.append(row)
        return bad

    def assert_satisfied(self, gates: dict[str, Callable], rows=None) -> None:
        for name, g in gates.items():
            bad = self.eval_gate(g, rows)
            assert not bad, f"gate '{name}' fails at rows {bad[:10]}"
