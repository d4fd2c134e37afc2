"""Prime-field specifications and host-side big-integer <-> limb-plane codecs.

This is the replacement for the role `ark-ff`'s ``MontBackend`` plays
underneath the reference sponge (see the reference's ``src/test.rs:5-11`` where the
test field is declared, and SURVEY.md section 2.2).  The reference stores a field
element as 4 x 64-bit Montgomery limbs and runs scalar CPU arithmetic; here a field
element *batch* is stored as a structure-of-arrays plane of ``NLIMBS`` x ``LIMB_BITS``-bit
limbs in ``int32`` (shape ``(..., NLIMBS, B)``: limb axis second to last, batch axis
last), in Montgomery form with ``R = 2**(LIMB_BITS * NLIMBS)``.

Why 12-bit limbs: with limbs bounded by ``2**12`` (a *redundant*, not strictly
canonical bound), every schoolbook partial product is ``<= 2**24`` and every column sum
across ``2*NLIMBS`` terms plus the Montgomery-reduction additions stays ``< 2**31``, so
the whole multiply runs in plain 32-bit integer ops with **no** hi/lo product
splitting and only three data-independent carry passes at the end.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

LIMB_BITS = 12
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field in the limb-plane representation.

    Mirrors the capability of ark-ff's compile-time field configs
    (``/root/reference/src/test.rs:5-11``); all members are Python ints / tuples so
    the spec is hashable and can be closed over by jitted functions as a static.
    """

    name: str
    modulus: int
    generator: int
    limb_bits: int = LIMB_BITS
    nlimbs: int = field(init=False)
    unsigned_accum: bool = field(init=False)

    def __post_init__(self):
        # R = 2^(limb_bits*nlimbs) must exceed every redundant device value:
        # the lazy-MDS column sums are bounded by ~4.2p (docs/DESIGN.md §3), so we
        # size for >= 16p of headroom (modulus bits + 4).  For the two shipped
        # 255/254-bit fields at 12-bit limbs this lands on the same 22-limb
        # layout the native codec and all frozen vectors assume; small *test*
        # fields (used to run the unrolled kernel bodies cheaply in CI) get
        # proportionally few limbs.
        nlimbs = -(-(self.modulus.bit_length() + 4) // self.limb_bits)
        object.__setattr__(self, "nlimbs", nlimbs)
        # 32-bit no-overflow proof obligation for the limb arithmetic (see module
        # doc): one schoolbook column plus the Montgomery-reduction additions
        # must fit a 32-bit accumulator.  Enforced for EVERY FieldSpec —
        # user-defined large-modulus fields must fail loudly, not wrap
        # silently.  Two budgets exist (docs/DESIGN.md §7, "The 13-bit plan"):
        #   * signed int32 (< 2^31): the 12-bit plan; kernels run plain int32.
        #   * unsigned uint32 (< 2^32): the 13-bit plan (L 22 -> 20 for the
        #     255-bit fields); kernels must compute in uint32 (logical
        #     shifts).
        # The product bound uses the quasi-canonical limb ceiling (+256,
        # conservative) so the relaxed-norm kernel's redundant limbs are
        # covered by the same obligation.
        prod = ((1 << self.limb_bits) + 256) * ((1 << self.limb_bits) - 1)
        bound = (nlimbs + nlimbs - 1) * prod
        if bound < 2 ** 31:
            object.__setattr__(self, "unsigned_accum", False)
        elif bound < 2 ** 32:
            object.__setattr__(self, "unsigned_accum", True)
        else:
            raise ValueError(
                f"modulus too large for the 32-bit limb design: {nlimbs} limbs "
                f"of {self.limb_bits} bits overflow the column accumulator"
            )

    @property
    def limb_mask(self) -> int:
        return (1 << self.limb_bits) - 1

    # ---- derived Montgomery constants (python ints, computed once) ----

    @property
    def modulus_bit_size(self) -> int:
        """Same as ark-ff ``MODULUS_BIT_SIZE`` (bits of the modulus)."""
        return self.modulus.bit_length()

    @property
    def r(self) -> int:
        """Montgomery radix R = 2^(limb_bits * nlimbs)."""
        return 1 << (self.limb_bits * self.nlimbs)

    @property
    def r_mod_p(self) -> int:
        return self.r % self.modulus

    @property
    def r2_mod_p(self) -> int:
        return (self.r * self.r) % self.modulus

    @property
    def n0inv(self) -> int:
        """-p^{-1} mod 2^limb_bits (per-limb Montgomery factor)."""
        base = 1 << self.limb_bits
        return (-pow(self.modulus, -1, base)) % base

    # ---- host-side codecs (numpy; not on the hot path) ----

    def int_to_limbs(self, x: int) -> np.ndarray:
        """Canonical integer -> (nlimbs,) int32 limb vector (little-endian limbs)."""
        if not 0 <= x < self.r:
            raise ValueError(f"value out of range for limb encoding: {x}")
        mask = self.limb_mask
        out = np.empty(self.nlimbs, dtype=np.int32)
        for i in range(self.nlimbs):
            out[i] = x & mask
            x >>= self.limb_bits
        return out

    def limbs_to_int(self, limbs: np.ndarray) -> int:
        """(nlimbs,) limb vector (possibly redundant) -> integer."""
        acc = 0
        for i in reversed(range(self.nlimbs)):
            acc = (acc << self.limb_bits) + int(limbs[i])
        return acc

    def int_to_mont_limbs(self, x: int) -> np.ndarray:
        """Canonical integer mod p -> Montgomery-form limb vector."""
        return self.int_to_limbs((x % self.modulus) * self.r_mod_p % self.modulus)

    def mont_limbs_to_int(self, limbs: np.ndarray) -> int:
        """Montgomery-form limb vector -> canonical integer mod p."""
        r_inv = pow(self.r, -1, self.modulus)
        return self.limbs_to_int(limbs) * r_inv % self.modulus

    # ---- batch host codecs: (B,) python ints <-> (nlimbs, B) planes ----

    def ints_to_mont_plane(self, xs) -> np.ndarray:
        """Sequence of ints -> (nlimbs, B) int32 Montgomery limb plane.

        Uses the native C++ codec (csrc/host_codec.cc) when available — one
        word-CIOS multiply per element instead of python bigints — and falls
        back to pure python otherwise.
        """
        xs = list(xs)
        # The native tier is fixed to the 22-limb/256-bit layout; gate before
        # building the 32-byte buffer (a >256-bit field would overflow it).
        if len(xs) >= 8 and self.nlimbs == 22:
            from .utils.native import encode_mont_plane_native

            buf = b"".join(
                (int(x) % self.modulus).to_bytes(32, "little") for x in xs
            )
            out = encode_mont_plane_native(self, buf, len(xs))
            if out is not None:
                return out
        cols = [self.int_to_mont_limbs(int(x)) for x in xs]
        return np.stack(cols, axis=-1).astype(np.int32)

    def mont_plane_to_ints(self, plane: np.ndarray) -> list:
        """(nlimbs, B) Montgomery limb plane -> list of canonical ints."""
        plane = np.asarray(plane)
        if plane.shape[-1] >= 8:
            from .utils.native import decode_mont_plane_native

            raw = decode_mont_plane_native(self, plane)
            if raw is not None:
                return [
                    int.from_bytes(raw[i * 32 : (i + 1) * 32], "little")
                    for i in range(plane.shape[-1])
                ]
        return [self.mont_limbs_to_int(plane[:, b]) for b in range(plane.shape[-1])]

    # ---- byte/bit codecs matching ark-ff semantics ----

    @property
    def num_canonical_bytes(self) -> int:
        """Bytes of a canonical serialization (ark-serialize compressed Fp width)."""
        return (self.modulus_bit_size + 7) // 8

    def to_bytes_le(self, x: int) -> bytes:
        """Canonical LE bytes, same width as ark-ff ``into_bigint().to_bytes_le()``.

        ark-ff emits ``8 * NUM_LIMBS`` bytes for its 64-bit limb bigint; for the
        255-bit fields here that is 32 bytes (cf. squeeze_bytes usage at
        /root/reference/src/poseidon/mod.rs:264).
        """
        nbytes = 8 * ((self.modulus_bit_size + 63) // 64)
        return int(x % self.modulus).to_bytes(nbytes, "little")

    def from_le_bytes_mod_order(self, data: bytes) -> int:
        """ark-ff ``from_le_bytes_mod_order`` (/root/reference/src/lib.rs:96)."""
        return int.from_bytes(data, "little") % self.modulus


# The two fields the framework ships with (SURVEY.md north star: BLS12-381 Fr and
# BN254 Fr).  Modulus for the first matches /root/reference/src/test.rs:6.
BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    modulus=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
)

# 13-bit-limb layout of the SAME field (docs/DESIGN.md §7, "The 13-bit plan"): L drops 22 -> 20
# (~17% fewer schoolbook products per modmul), at the price of unsigned
# uint32 column accumulation (the worst REDC column exceeds 2^31) and a
# 2-way MDS accumulation split at t = 3.  Same name on purpose — parameter
# tables, oracle, and vectors key on the field's mathematical identity;
# only the device limb plane differs.  A/B measured in bench/limb13_probe.py.
BLS12_381_FR_L13 = FieldSpec(
    name="bls12_381_fr",
    modulus=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
    limb_bits=13,
)

BN254_FR = FieldSpec(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
)

# BLS12-377 scalar field (ark-bls12-377 Fr): the third widely-used arkworks
# SNARK field; 253 bits, same 22-limb plane layout (and native codec) as the
# other two.
BLS12_377_FR = FieldSpec(
    name="bls12_377_fr",
    modulus=8444461749428370424248824938781546531375899335154063827935233455917409239041,
    generator=22,
)

# Goldilocks (2^64 - 2^32 + 1): the dominant small field of modern ZK systems
# (plonky2/3, miden, risc0).  6 x 12-bit limbs instead of 22 — every Montgomery
# reduction costs (6/22)^2 ~ 13x less than the 255-bit fields, so Poseidon over
# Goldilocks is the throughput-per-byte champion of the framework.  64-bit
# elements need a wider capacity for 128-bit sponge security (capacity 4 = 256
# capacity bits; see poseidon.params._DEFAULT_CAPACITY).
GOLDILOCKS_FR = FieldSpec(
    name="goldilocks_fr",
    modulus=(1 << 64) - (1 << 32) + 1,
    generator=7,
)

# BabyBear (15 * 2^27 + 1, 31 bits): the plonky3 / risc0 / sp1 field.  THREE
# 12-bit limbs per element — each Montgomery reduction costs (3/22)^2 ~ 54x
# less than the 255-bit fields.  Default sponge geometry rate 8 / capacity 8
# (248 capacity bits; the plonky3-family standard for ~128-bit security).
BABYBEAR_FR = FieldSpec(
    name="babybear_fr",
    modulus=(15 << 27) + 1,
    generator=31,
)

# Mersenne31 (2^31 - 1): plonky3's other flagship small field (circle STARKs).
# Same 3 x 12-bit limb plane as BabyBear.  The generic Montgomery machinery
# applies unchanged (p is odd); the special shift-add Mersenne reduction is a
# host-side nicety this batched limb design doesn't need.  x^5 S-box
# (gcd(5, p-1) = 1; 7 divides p-1 so BabyBear's alpha=7 would NOT permute);
# generator 7 is a primitive root (p-1 = 2 * 3^2 * 7 * 11 * 31 * 151 * 331).
MERSENNE31_FR = FieldSpec(
    name="mersenne31_fr",
    modulus=(1 << 31) - 1,
    generator=7,
)

# KoalaBear (2^31 - 2^24 + 1): the third plonky3 31-bit field.  Same
# 3 x 12-bit limb plane as BabyBear/Mersenne31.  p - 1 = 2^24 * 127, so the
# cubic S-box permutes (gcd(3, p-1) = 1 — the cheapest S-box of any shipped
# field); generator 3 is a primitive root (3^((p-1)/2) != 1, 3^((p-1)/127) != 1).
KOALABEAR_FR = FieldSpec(
    name="koalabear_fr",
    modulus=(1 << 31) - (1 << 24) + 1,
    generator=3,
)

_FIELDS = {
    f.name: f
    for f in (
        BLS12_381_FR,
        BN254_FR,
        BLS12_377_FR,
        GOLDILOCKS_FR,
        BABYBEAR_FR,
        MERSENNE31_FR,
        KOALABEAR_FR,
    )
}


def get_field(name: str) -> FieldSpec:
    return _FIELDS[name]


# The int32 no-overflow proof obligation is enforced for every FieldSpec in
# __post_init__ (see above); nothing further to assert here.
