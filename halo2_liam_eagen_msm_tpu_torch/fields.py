"""Field and curve specifications for the curve cycles used by the Liam Eagen
MSM argument.

The primary target is the Pallas/Vesta cycle; Grumpkin/BN254 is kept for
cross-checks.  All host-side math here uses Python ints (exact).  The device
representation is defined in limbs.py / ops/ff.py: 16 limbs x 16 bits,
Montgomery form with R = 2^256.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

# ----------------------------------------------------------------------------
# Limb layout (shared by host conversions, tensors and CUDA kernels).
# ----------------------------------------------------------------------------
LIMB_BITS = 16
N_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * N_LIMBS  # 256
R = 1 << R_BITS


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field with the constants needed for Montgomery arithmetic."""

    name: str
    p: int                # modulus
    generator: int        # multiplicative generator
    s: int                # 2-adicity: p - 1 = 2^s * t with t odd

    @property
    def r_mod_p(self) -> int:
        return R % self.p

    @property
    def r2_mod_p(self) -> int:
        """R^2 mod p, used to enter the Montgomery domain."""
        return (R * R) % self.p

    @property
    def n0inv(self) -> int:
        """-p^-1 mod 2^LIMB_BITS, the 16-bit Montgomery reduction constant."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @property
    def n0inv32(self) -> int:
        """-p^-1 mod 2^32: the word-serial reduction constant of the CUDA
        kernels, which repack to 8 limbs of 32 bits."""
        return (-pow(self.p, -1, 1 << 32)) % (1 << 32)

    @property
    def t_odd(self) -> int:
        """Odd part of p-1 (for Tonelli-Shanks)."""
        return (self.p - 1) >> self.s

    # -- roots of unity for the NTT (host ints; device tables in ops/ntt.py) --
    @property
    def root_of_unity(self) -> int:
        """g^((p-1)/2^s): a primitive 2^s-th root of unity."""
        return pow(self.generator, (self.p - 1) >> self.s, self.p)

    @property
    def root_of_unity_inv(self) -> int:
        return pow(self.root_of_unity, self.p - 2, self.p)

    @property
    def two_inv(self) -> int:
        return pow(2, self.p - 2, self.p)

    @lru_cache(maxsize=None)
    def omega_pow(self, exp2: int) -> int:
        """root_of_unity^(2^exp2): a primitive 2^(s - exp2)-th root of unity."""
        return pow(self.root_of_unity, 1 << exp2, self.p)

    @lru_cache(maxsize=None)
    def omega_pow_inv(self, exp2: int) -> int:
        return pow(self.root_of_unity_inv, 1 << exp2, self.p)

    @lru_cache(maxsize=None)
    def half_pow(self, exp: int) -> int:
        return pow(self.two_inv, exp, self.p)


# ----------------------------------------------------------------------------
# The concrete fields.
# ----------------------------------------------------------------------------

# Pallas base field (= Vesta scalar field).  2-adicity 32, generator 5.
PALLAS_FP = FieldSpec(
    name="pallas_fp",
    p=0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
    generator=5,
    s=32,
)

# Vesta base field (= Pallas scalar field).  2-adicity 32, generator 5.
VESTA_FP = FieldSpec(
    name="vesta_fp",
    p=0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
    generator=5,
    s=32,
)

# bn254 scalar field Fr (= Grumpkin base field).  2-adicity 28, generator 7.
BN254_FR = FieldSpec(
    name="bn254_fr",
    p=0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
    generator=7,
    s=28,
)

# bn254 base field Fq (= Grumpkin scalar field).  q = 3 mod 4 so 2-adicity 1.
BN254_FQ = FieldSpec(
    name="bn254_fq",
    p=0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
    generator=3,
    s=1,
)

FIELDS = {f.name: f for f in (PALLAS_FP, VESTA_FP, BN254_FR, BN254_FQ)}


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    """Short-Weierstrass curve y^2 = x^3 + a*x + b over `field`, with scalar
    field `scalar_field`."""

    name: str
    field: FieldSpec          # base field (coordinates live here)
    scalar_field: FieldSpec   # scalar field (MSM coefficients live here)
    a: int
    b: int
    gen_x: int
    gen_y: int


# Pallas: y^2 = x^3 + 5 over PALLAS_FP, generator (-1, 2).
PALLAS = CurveSpec(
    name="pallas",
    field=PALLAS_FP,
    scalar_field=VESTA_FP,
    a=0,
    b=5,
    gen_x=PALLAS_FP.p - 1,
    gen_y=2,
)

# Vesta: y^2 = x^3 + 5 over VESTA_FP, generator (-1, 2).
VESTA = CurveSpec(
    name="vesta",
    field=VESTA_FP,
    scalar_field=PALLAS_FP,
    a=0,
    b=5,
    gen_x=VESTA_FP.p - 1,
    gen_y=2,
)

# Grumpkin: y^2 = x^3 - 17 over BN254_FR, generator (1, sqrt(-16)).
GRUMPKIN = CurveSpec(
    name="grumpkin",
    field=BN254_FR,
    scalar_field=BN254_FQ,
    a=0,
    b=BN254_FR.p - 17,
    gen_x=1,
    gen_y=0x02CF135E7506A45D632D270D45F1181294833FC48D823F272C,
)

CURVES = {c.name: c for c in (PALLAS, VESTA, GRUMPKIN)}
