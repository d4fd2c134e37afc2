"""Deterministic Poseidon parameter generation (Grain LFSR + Cauchy MDS).

Host-side, run-once machinery — the equivalent of the reference's
src/poseidon/grain_lfsr.rs and src/poseidon/traits.rs.  Behavior is bit-exact with the reference:
the golden vectors from ``grain_lfsr.rs:197-213`` and ``traits.rs:163-358`` are
checked in ``tests/test_params.py``.
"""

from __future__ import annotations

import functools

from ..fields import FieldSpec
from .config import PoseidonConfig


class PoseidonGrainLFSR:
    """80-bit Grain LFSR seeded from the field/sponge descriptor.

    Seed layout and update taps follow /root/reference/src/poseidon/grain_lfsr.rs:
    b0-b1 field type, b2-b5 sbox kind, b6-17 prime bits, b18-29 state width t,
    b30-39 R_F, b40-49 R_P, b50-79 ones (``:15-84``); taps {62,51,38,23,13,0}
    (``:163-168``); 160 warm-up clocks (``:176-188``); the output filter discards
    bit-pairs until the first bit of a pair is 1 and emits the second
    (``:86-106``).
    """

    # Tap positions relative to the head: {62, 51, 38, 23, 13, 0}
    # (grain_lfsr.rs:163-168), encoded as a mask over the shifting 80-bit window.
    _TAP_MASK = (1 << 62) | (1 << 51) | (1 << 38) | (1 << 23) | (1 << 13) | 1

    def __init__(
        self,
        is_sbox_an_inverse: bool,
        prime_num_bits: int,
        state_len: int,
        num_full_rounds: int,
        num_partial_rounds: int,
    ):
        self.prime_num_bits = prime_num_bits
        bits = [False] * 80  # bits[i] == reference state[(head + i) % 80]

        bits[1] = True
        bits[5] = bool(is_sbox_an_inverse)

        def fill(lo: int, hi: int, value: int):
            cur = value
            for i in range(hi, lo - 1, -1):
                bits[i] = (cur & 1) == 1
                cur >>= 1

        fill(6, 17, prime_num_bits)
        fill(18, 29, state_len)
        fill(30, 39, num_full_rounds)
        fill(40, 49, num_partial_rounds)
        for i in range(50, 80):
            bits[i] = True

        # Pack into an int: bit i of ``window`` is the state bit at head-relative
        # offset i.  The reference's write-at-head + advance-head is then exactly
        # "shift right, insert new bit at offset 79".
        self.window = sum(1 << i for i, b in enumerate(bits) if b)
        for _ in range(160):
            self._update()

    def _update(self) -> int:
        w = self.window
        new_bit = (w & self._TAP_MASK).bit_count() & 1
        self.window = (w >> 1) | (new_bit << 79)
        return new_bit

    def get_bits(self, num_bits: int) -> list:
        res = []
        update = self._update
        for _ in range(num_bits):
            new_bit = update()
            while not new_bit:
                update()  # discard the second bit of the pair
                new_bit = update()
            res.append(update())
        return res

    def _next_int_msb(self) -> int:
        """prime_num_bits filtered bits, interpreted MSB-first (bits reversed to
        little-endian before bigint construction in the reference,
        grain_lfsr.rs:119-123 — equivalent to reading the stream MSB-first)."""
        acc = 0
        for bit in self.get_bits(self.prime_num_bits):
            acc = (acc << 1) | int(bit)
        return acc

    def get_field_elements_rejection_sampling(self, fs: FieldSpec, num_elems: int):
        """Per-element rejection sampling below p (grain_lfsr.rs:108-133)."""
        assert fs.modulus_bit_size == self.prime_num_bits
        res = []
        for _ in range(num_elems):
            while True:
                candidate = self._next_int_msb()
                if candidate < fs.modulus:
                    res.append(candidate)
                    break
        return res

    def get_field_elements_mod_p(self, fs: FieldSpec, num_elems: int):
        """Draw n bits and reduce mod p (grain_lfsr.rs:135-159).

        The reference chunks the MSB-first bit vector's *reversal* into LE bytes and
        calls from_le_bytes_mod_order — numerically just ``value mod p``.
        """
        assert fs.modulus_bit_size == self.prime_num_bits
        return [self._next_int_msb() % fs.modulus for _ in range(num_elems)]


def find_poseidon_ark_and_mds(
    fs: FieldSpec,
    rate: int,
    full_rounds: int,
    partial_rounds: int,
    skip_matrices: int,
    capacity: int = 1,
):
    """ARK constants via rejection sampling + Cauchy MDS matrix.

    Mirrors /root/reference/src/poseidon/traits.rs:105-146: one LFSR seeded with
    (false, prime_bits, rate+capacity, R_F, R_P); (R_F+R_P) rows of t rejection
    samples; ``skip_matrices`` discarded draws of 2*t mod-p elements; then
    mds[i][j] = (x_i + y_j)^{-1}.  The reference fixes capacity = 1
    (traits.rs:96); small fields (e.g. Goldilocks) need capacity > 1 for
    128-bit sponge security, which only changes the seeded state width t.
    """
    t = rate + capacity
    lfsr = PoseidonGrainLFSR(False, fs.modulus_bit_size, t, full_rounds, partial_rounds)

    ark = tuple(
        tuple(lfsr.get_field_elements_rejection_sampling(fs, t))
        for _ in range(full_rounds + partial_rounds)
    )

    for _ in range(skip_matrices):
        lfsr.get_field_elements_mod_p(fs, 2 * t)

    xs = lfsr.get_field_elements_mod_p(fs, t)
    ys = lfsr.get_field_elements_mod_p(fs, t)
    p = fs.modulus
    mds = tuple(
        tuple(pow((x + y) % p, -1, p) for y in ys) for x in xs
    )
    return ark, mds


# Default parameter tables: (rate, alpha, full_rounds, partial_rounds, skip_matrices)
# for rates 2..8.  Values for BLS12-381 Fr come from the reference's test field
# instantiation (/root/reference/src/test.rs:13-32).  The reference only ships
# tables for its test field; any other field can supply its own table or call
# find_poseidon_ark_and_mds directly.
_BLS12_381_FR_CONSTRAINTS = (
    (2, 17, 8, 31, 0),
    (3, 5, 8, 56, 0),
    (4, 5, 8, 56, 0),
    (5, 5, 8, 57, 0),
    (6, 5, 8, 57, 0),
    (7, 5, 8, 57, 0),
    (8, 5, 8, 57, 0),
)
_BLS12_381_FR_WEIGHTS = (
    (2, 257, 8, 13, 0),
    (3, 257, 8, 13, 0),
    (4, 257, 8, 13, 0),
    (5, 257, 8, 13, 0),
    (6, 257, 8, 13, 0),
    (7, 257, 8, 13, 0),
    (8, 257, 8, 13, 0),
)

# BLS12-377 Fr: gcd(5, p-1) = 5, so the x^5 S-box is NOT a permutation over
# this field; the constraints table uses alpha = 17 (coprime) for every rate,
# keeping the alpha=5 tables' R_P — conservative, since a higher-degree S-box
# only strengthens the algebraic security margin at equal round counts.
_BLS12_377_FR_CONSTRAINTS = tuple(
    (rate, 17, rf, rp, skip) for rate, _a, rf, rp, skip in _BLS12_381_FR_CONSTRAINTS
)

# Goldilocks (64-bit): x^7 S-box (gcd(7, p-1) = 1); round numbers follow the
# t=12 128-bit-security instance used across plonky2-family systems
# (R_F=8, R_P=22), applied to both shipped widths; the wider t only
# strengthens the bound at equal rounds.  Capacity is 4 elements (256 capacity
# bits) rather than the reference's fixed 1 — see _DEFAULT_CAPACITY.
_GOLDILOCKS_CONSTRAINTS = (
    (4, 7, 8, 22, 0),
    (8, 7, 8, 22, 0),
)

# BabyBear (31-bit): x^7 S-box (p - 1 = 2^27 * 3 * 5, so 3 and 5 divide it
# but 7 does not); round numbers follow the plonky3-family t=16 instance
# (R_F=8, R_P=13).  Capacity 8 elements = 248 capacity bits.
_BABYBEAR_CONSTRAINTS = (
    (8, 7, 8, 13, 0),
)

# Mersenne31 (2^31 - 1): x^5 S-box (gcd(5, p-1) = 1; 7 | p-1 rules out x^7);
# round numbers follow the plonky3-family t=16 alpha=5 instance (R_F=8,
# R_P=14).  Capacity 8 elements = 248 capacity bits, as for BabyBear.
_MERSENNE31_CONSTRAINTS = (
    (8, 5, 8, 14, 0),
)

# KoalaBear (2^31 - 2^24 + 1): x^3 S-box (p - 1 = 2^24 * 127, so gcd(3, p-1)
# = 1 — the cheapest permuting exponent of any shipped field); the lower
# S-box degree buys its speed back in partial rounds: round numbers follow
# the plonky3-family t=16 alpha=3 instance (R_F=8, R_P=20).  Capacity 8
# elements = 248 capacity bits, as for the other 31-bit fields.
_KOALABEAR_CONSTRAINTS = (
    (8, 3, 8, 20, 0),
)

_DEFAULT_TABLES = {
    "bls12_381_fr": {False: _BLS12_381_FR_CONSTRAINTS, True: _BLS12_381_FR_WEIGHTS},
    # The BLS tables target any ~255-bit prime via the Grain seed, so reuse them as
    # sensible defaults for BN254 Fr (capability parity: the reference lets any
    # field declare tables via PoseidonDefaultConfig, traits.rs:43-56).
    "bn254_fr": {False: _BLS12_381_FR_CONSTRAINTS, True: _BLS12_381_FR_WEIGHTS},
    "bls12_377_fr": {False: _BLS12_377_FR_CONSTRAINTS, True: _BLS12_381_FR_WEIGHTS},
    "goldilocks_fr": {False: _GOLDILOCKS_CONSTRAINTS, True: _GOLDILOCKS_CONSTRAINTS},
    "babybear_fr": {False: _BABYBEAR_CONSTRAINTS, True: _BABYBEAR_CONSTRAINTS},
    "mersenne31_fr": {False: _MERSENNE31_CONSTRAINTS, True: _MERSENNE31_CONSTRAINTS},
    "koalabear_fr": {False: _KOALABEAR_CONSTRAINTS, True: _KOALABEAR_CONSTRAINTS},
}

# Sponge capacity in state elements.  The reference hardcodes 1
# (traits.rs:96), which gives ~p/2 bits of capacity — fine for 255-bit
# fields, far too small for 64-bit ones: 128-bit sponge security needs
# >= 256 capacity bits = 4 Goldilocks elements.
_DEFAULT_CAPACITY = {
    "goldilocks_fr": 4,
    "babybear_fr": 8,
    "mersenne31_fr": 8,
    "koalabear_fr": 8,
}


def register_default_table(
    fs: FieldSpec,
    table,
    capacity: int = 1,
    optimized_for_weights_table=None,
) -> None:
    """Register default Poseidon parameter tables for a user-supplied field.

    Mirrors the reference's extensibility contract: ANY field may implement
    ``PoseidonDefaultConfig`` and gain ``get_default_poseidon_parameters``
    ergonomics (/root/reference/src/poseidon/traits.rs:43-66) — here a host
    registry call instead of a trait impl, so downstream fields never edit
    this module.

    ``table``: iterable of ``(rate, alpha, full_rounds, partial_rounds,
    skip_matrices)`` rows (the reference's ``PoseidonDefaultConfigEntry``
    shape, traits.rs:7-40).  ``capacity``: sponge capacity in state elements
    (the reference hardcodes 1, traits.rs:96; small fields need more — see
    ``_DEFAULT_CAPACITY``).  ``optimized_for_weights_table`` defaults to
    ``table`` (the reference keeps two tables; most added fields ship one).

    Re-registering a field name overwrites its tables (idempotent setup);
    registering one of the built-in fields is allowed and overrides it.
    """
    def _validated(t):
        rows = tuple(tuple(int(v) for v in row) for row in t)
        for row in rows:
            if len(row) != 5:
                raise ValueError(
                    "table rows must be (rate, alpha, full_rounds, partial_rounds,"
                    f" skip_matrices); got {row}"
                )
        return rows

    rows = _validated(table)
    weights = (
        rows
        if optimized_for_weights_table is None
        else _validated(optimized_for_weights_table)
    )
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    _DEFAULT_TABLES[fs.name] = {False: rows, True: weights}
    _DEFAULT_CAPACITY[fs.name] = capacity


@functools.lru_cache(maxsize=None)
def poseidon_test_fixture() -> PoseidonConfig:
    """The reference's hardcoded test parameter set (tests.rs:120-820).

    BLS12-381 Fr, alpha=17, rate=2, capacity=1, R_F=8, R_P=29 — NOT reproducible
    from the Grain LFSR (verified); the constants are transcribed as data in
    ``vectors/poseidon_bls381_fr_test_fixture.json``.
    """
    import json
    import pathlib

    from ..fields import BLS12_381_FR

    path = (
        pathlib.Path(__file__).resolve().parent.parent.parent
        / "vectors"
        / "poseidon_bls381_fr_test_fixture.json"
    )
    data = json.loads(path.read_text())
    return PoseidonConfig(
        field=BLS12_381_FR,
        full_rounds=data["full_rounds"],
        partial_rounds=data["partial_rounds"],
        alpha=data["alpha"],
        ark=tuple(tuple(int(v) for v in row) for row in data["ark"]),
        mds=tuple(tuple(int(v) for v in row) for row in data["mds"]),
        rate=data["rate"],
        capacity=data["capacity"],
    )


def get_default_poseidon_parameters(
    fs: FieldSpec, rate: int, optimized_for_weights: bool = False
) -> PoseidonConfig:
    """Default Poseidon parameters for ``rate`` 2..8 with capacity fixed to 1.

    Mirrors get_default_poseidon_parameters_internal
    (/root/reference/src/poseidon/traits.rs:69-102); raises KeyError/ValueError for
    unknown fields or rates (the reference returns None).
    """
    table = _DEFAULT_TABLES[fs.name][bool(optimized_for_weights)]
    capacity = _DEFAULT_CAPACITY.get(fs.name, 1)
    for rate_, alpha, full_rounds, partial_rounds, skip_matrices in table:
        if rate_ == rate:
            ark, mds = find_poseidon_ark_and_mds(
                fs, rate, full_rounds, partial_rounds, skip_matrices, capacity
            )
            return PoseidonConfig(
                field=fs,
                full_rounds=full_rounds,
                partial_rounds=partial_rounds,
                alpha=alpha,
                ark=ark,
                mds=mds,
                rate=rate,
                capacity=capacity,
            )
    raise ValueError(f"no default Poseidon parameters for rate={rate}")
