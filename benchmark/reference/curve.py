"""Short-Weierstrass curve arithmetic on Python ints: the benchmark's plain
reference for the group law.

Affine points are (x, y) int pairs, the identity is None.  Jacobian triples
(X, Y, Z) stand for (X / Z^2, Y / Z^3); Z == 0 is the identity.  Only the
curves the configurations name (a = 0 or not) are needed; nothing here is
fast, everything is exact."""

from __future__ import annotations

import dataclasses

R_BITS = 256  # the Montgomery radix of the limb layout the program reads: 2^256


@dataclasses.dataclass(frozen=True)
class Curve:
    """y^2 = x^3 + a x + b over F_p, a group of prime order q, generator g."""
    name: str
    p: int
    q: int
    a: int
    b: int
    g: tuple

    @classmethod
    def from_config(cls, cfg: dict) -> "Curve":
        c = cfg["curve"]
        return cls(c["name"], int(c["p"], 16), int(c["q"], 16), int(c["a"]), int(c["b"]),
                   (int(c["gx"], 16), int(c["gy"], 16)))

    # ----------------------------------------------------------------- affine
    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def neg(self, pt):
        return None if pt is None else (pt[0], (-pt[1]) % self.p)

    def add(self, p1, p2):
        p = self.p
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    def mul(self, pt, k: int):
        """k * pt for any integer k (reduced mod q), by Jacobian
        double-and-add and one inversion."""
        k %= self.q
        if pt is None or k == 0:
            return None
        acc = (1, 1, 0)
        for bit in bin(k)[2:]:
            acc = self.jdouble(acc)
            if bit == "1":
                acc = self.jadd_affine(acc, pt)
        return self.to_affine(acc)

    def lin(self, alpha: int, pa, beta: int, pb):
        """alpha * pa + beta * pb."""
        return self.add(self.mul(pa, alpha), self.mul(pb, beta))

    # --------------------------------------------------------------- Jacobian
    def jdouble(self, pt):
        p = self.p
        x, y, z = pt
        if z == 0 or y == 0:
            return (1, 1, 0)
        yy = y * y % p
        s = 4 * x * yy % p
        m = (3 * x * x + self.a * pow(z, 4, p)) % p
        x3 = (m * m - 2 * s) % p
        y3 = (m * (s - x3) - 8 * yy * yy) % p
        return (x3, y3, 2 * y * z % p)

    def jadd_affine(self, pt, q):
        """Jacobian + affine, complete for every input."""
        p = self.p
        if q is None:
            return pt
        x1, y1, z1 = pt
        if z1 == 0:
            return (q[0], q[1], 1)
        z1z1 = z1 * z1 % p
        u2 = q[0] * z1z1 % p
        s2 = q[1] * z1 * z1z1 % p
        h = (u2 - x1) % p
        r = (s2 - y1) % p
        if h == 0:
            return self.jdouble(pt) if r == 0 else (1, 1, 0)
        hh = h * h % p
        hhh = h * hh % p
        v = x1 * hh % p
        x3 = (r * r - hhh - 2 * v) % p
        y3 = (r * (v - x3) - y1 * hhh) % p
        return (x3, y3, z1 * h % p)

    def to_affine(self, pt):
        x, y, z = pt
        if z % self.p == 0:
            return None
        p = self.p
        zi = pow(z, -1, p)
        zi2 = zi * zi % p
        return (x * zi2 % p, y * zi2 * zi % p)

    def affine_line(self, A, B, n: int):
        """A + j B for j < n as affine (x, y) int pairs, level by level: the
        points of [2^k, 2^(k+1)) are those of [0, 2^k) plus 2^k B, their
        chords' denominators inverted by one Montgomery trick a level.  Raises
        where a chord is degenerate (x_j == x(2^k B)), which distinct points
        below the order of B never give."""
        p = self.p
        xs, ys = [A[0]], [A[1]]
        step = B
        while len(xs) < n:
            m = min(len(xs), n - len(xs))
            cx, cy = step
            dens = [(x - cx) % p for x in xs[:m]]
            pref = [1] * (m + 1)
            for i, d in enumerate(dens):
                if d == 0:
                    raise ValueError("a degenerate chord in the line of points")
                pref[i + 1] = pref[i] * d % p
            inv = pow(pref[m], -1, p)
            for i in range(m - 1, -1, -1):
                di = inv * pref[i] % p
                inv = inv * dens[i] % p
                lam = (ys[i] - cy) * di % p
                x3 = (lam * lam - xs[i] - cx) % p
                xs.append(x3)
                ys.append((lam * (cx - x3) - cy) % p)
            # the level was appended last index first: put it in index order
            xs[-m:] = xs[-m:][::-1]
            ys[-m:] = ys[-m:][::-1]
            step = self.add(step, step)
        return xs[:n], ys[:n]
