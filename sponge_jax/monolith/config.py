"""Monolith configuration (frozen, hashable — same shape discipline as
``PoseidonConfig``, /root/reference/src/poseidon/mod.rs:24-42).

Monolith (Grassi et al., ePrint 2023/1025) is the lookup-era permutation for
fields of the special shapes ``p = 2^n - 1`` (Monolith-31 over Mersenne31)
and ``p = 2^n - 2^m + 1`` with chunk-aligned ``m`` (Monolith-64 over
Goldilocks).  One round (of R, typically 6):

    Bars:     the leading ``u`` state elements are decomposed into bit
              chunks (8,8,...,rem); each chunk passes through a chi-like
              bitwise S-box; chunks recompose.  Range-preserving because the
              S-box fixes the all-zero and all-one chunks (see
              ``check_bar_field``).
    Bricks:   x_i <- x_i + x_{i-1}^2  (squarings only, a type-2 Feistel).
    Concrete: state <- M . state for an MDS matrix M, then add the round
              constants (the LAST round's constants are zero).

The permutation opens with one extra Concrete.  The reference crate ships
only Poseidon; Monolith is an additive family behind the exact same duplex
machinery (``batched_permute`` hook + ``OraclePoseidonSponge`` duplex state
machine, cf. poseidon2/config.py, rescue/config.py).

Device angle: Bars are pure int32 bitwise ops, Bricks are t-1 batched
squarings, and the Goldilocks Concrete is a power-of-two circulant — a
multiplication-free linear layer on limb planes (static shifts + adds).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..fields import FieldSpec


def bar_m(fs: FieldSpec) -> int:
    """m of p = 2^n - 2^m + 1 (the Bar chunk boundary the lemma in
    ``check_bar_field`` needs); 0 when p is not of that shape.  The single
    source of the boundary for ``bar_chunks``, the host runtime, and the
    native ``bar_u64`` mirror."""
    d = (1 << fs.modulus_bit_size) + 1 - fs.modulus
    return d.bit_length() - 1 if d > 0 and d & (d - 1) == 0 else 0


def bar_chunks(fs: FieldSpec) -> tuple:
    """Chunk widths (little-endian) of the Bar decomposition: 8-bit chunks
    with an extra boundary at ``m`` (p = 2^n - 2^m + 1) when m is not
    byte-aligned — the range-preservation lemma of ``check_bar_field`` only
    needs SOME boundary at m, not byte chunks (Monolith-31 over Mersenne31:
    8,8,8,7; -64 over Goldilocks: 8 x 8; BabyBear's m = 27 splits the top
    byte: 8,8,8,3,4).  The C++ host runtime's ``bar_u64`` mirrors this loop
    exactly (csrc/poseidon_host.cc)."""
    n = fs.modulus_bit_size
    m = bar_m(fs)
    chunks = []
    bit = 0
    while bit < n:
        nxt = (bit // 8 + 1) * 8
        if nxt >= n:
            nxt = n
        if m > 1 and bit < m < nxt:
            nxt = m
        chunks.append(nxt - bit)
        bit = nxt
    return tuple(chunks)


def chunk_sbox(y: int, k: int) -> int:
    """The chi-like k-bit S-box: even k uses the 3-rotation AND (the 2-term
    chi is not invertible for even sizes), odd k the 2-rotation form; both
    close with a 1-bit rotation.  Fixes 0 and the all-ones chunk — the
    property ``check_bar_field`` relies on."""
    mask = (1 << k) - 1

    def rot(v: int, r: int) -> int:
        r %= k
        return ((v << r) | (v >> (k - r))) & mask

    nb = (~y) & mask
    if k % 2 == 0:
        z = y ^ (rot(nb, 1) & rot(y, 2) & rot(y, 3))
    else:
        z = y ^ (rot(nb, 1) & rot(y, 2))
    return rot(z, 1)


@functools.lru_cache(maxsize=None)
def _check_chunk_sbox(k: int) -> None:
    """Exhaustively verify the k-bit S-box is a bijection fixing 0 and 2^k-1
    (k <= 8, so at most 256 entries)."""
    table = [chunk_sbox(y, k) for y in range(1 << k)]
    if len(set(table)) != 1 << k:
        raise ValueError(f"{k}-bit bar S-box is not a bijection")
    if table[0] != 0 or table[-1] != (1 << k) - 1:
        raise ValueError(f"{k}-bit bar S-box does not fix 0 / all-ones")


@functools.lru_cache(maxsize=None)
def check_bar_field(fs: FieldSpec) -> None:
    """Bars map [0, p) onto [0, p) iff the invalid strings [p, 2^n) map onto
    themselves.  With p = 2^n - 2^m + 1, a string is invalid iff its top
    n - m bits are all ones AND its low m bits are nonzero; since each chunk
    S-box fixes the all-zero and all-one chunks, both predicates are
    preserved chunk-wise whenever m lands on a chunk boundary.  m = 1
    (p = 2^n - 1) also qualifies: the single invalid string (all ones) is a
    fixed point.  Everything else is rejected."""
    n = fs.modulus_bit_size
    d = (1 << n) + 1 - fs.modulus  # = 2^m for the supported shapes
    if d & (d - 1):
        raise ValueError(
            f"{fs.name} is not bar-safe: p must be 2^n - 2^m + 1 (got "
            f"2^{n} + 1 - p = {d}, not a power of two)"
        )
    m = d.bit_length() - 1
    boundaries = {0}
    acc = 0
    for c in bar_chunks(fs):
        acc += c
        boundaries.add(acc)
    if m != 1 and m not in boundaries:
        raise ValueError(
            f"{fs.name} is not bar-safe: m = {m} is not a bar chunk boundary "
            f"(chunks {bar_chunks(fs)})"
        )
    for k in set(bar_chunks(fs)):
        _check_chunk_sbox(k)


def bar_int(fs: FieldSpec, x: int) -> int:
    """Scalar Bar: decompose the canonical value into chunks, S-box each,
    recompose (the oracle-tier reference for the batched limb-plane Bar)."""
    out, bit = 0, 0
    for k in bar_chunks(fs):
        out |= chunk_sbox((x >> bit) & ((1 << k) - 1), k) << bit
        bit += k
    return out


@dataclass(frozen=True)
class MonolithConfig:
    """Parameters of the Monolith permutation + duplex sponge geometry.

    ``rc`` is indexed ``rc[round][state_element]``; the paper's schedule adds
    constants at the end of every round except the last, so the last row
    must be all zeros.  ``concrete`` is the dense (t, t) MDS matrix; when
    every entry is a power of two and the matrix is circulant the device
    tier runs the multiplication-free shift path automatically.
    """

    field: FieldSpec
    rounds: int
    bars: int  # u: leading state elements through Bar each round
    rc: tuple  # tuple[tuple[int, ...], ...], shape (rounds, t)
    concrete: tuple  # tuple[tuple[int, ...], ...], shape (t, t)
    rate: int
    capacity: int = 1

    def __post_init__(self):
        t = self.rate + self.capacity
        check_bar_field(self.field)
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")
        if not 1 <= self.bars <= t:
            raise ValueError(f"bars must be in [1, t]; got {self.bars}")
        if len(self.rc) != self.rounds:
            raise ValueError("rc must have rounds rows")
        for row in self.rc:
            if len(row) != t:
                raise ValueError("each rc row must have t entries")
        if any(v != 0 for v in self.rc[-1]):
            raise ValueError("the last rc row must be all zeros (paper schedule)")
        if len(self.concrete) != t or any(len(row) != t for row in self.concrete):
            raise ValueError("concrete must be t x t")

    @property
    def t(self) -> int:
        """State width (rate + capacity)."""
        return self.rate + self.capacity

    def pow2_circulant_exponents(self) -> tuple | None:
        """(t, t) exponent tuple when ``concrete`` is a circulant of powers
        of two (a special case of the scaled device path); None otherwise."""
        t = self.t
        first = self.concrete[0]
        for i in range(t):
            for j in range(t):
                if self.concrete[i][j] != first[(j - i) % t]:
                    return None
        exps = []
        for v in first:
            if v <= 0 or v & (v - 1):
                return None
            exps.append(v.bit_length() - 1)
        return tuple(tuple(exps[(j - i) % t] for j in range(t)) for i in range(t))

    def concrete_small_entries(self) -> tuple | None:
        """The (t, t) matrix itself when every entry is small enough for the
        multiplication-free scaled device path (each entry decomposes into at
        most two <=12-bit limb digits, i.e. < 2^24); None otherwise (dense
        Montgomery path).  Both the power-of-two circulants and the verified
        small-integer circulants qualify."""
        if all(0 < v < (1 << 24) for row in self.concrete for v in row):
            return self.concrete
        return None

    def batched_permute(self, state, backend: str = "auto"):
        """Permutation dispatch hook used by the shared duplex sponge
        (``poseidon.permutation.batched_permute`` delegates here for
        non-Poseidon configs)."""
        from .permutation import batched_monolith_permute

        return batched_monolith_permute(self, state, backend)

    def oracle_sponge(self):
        """Scalar python-int duplex sponge over this permutation (test oracle)."""
        from .oracle import OracleMonolithSponge

        return OracleMonolithSponge(self)
