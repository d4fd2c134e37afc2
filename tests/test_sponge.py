"""Batched device sponge ≡ scalar oracle sponge, plus reference golden vectors.

Covers SURVEY.md §4 categories 1 (golden vectors), 3 (encoding injectivity),
4 (API equivalence) and 5 (kernel ≡ oracle consistency), including the duplex
quirk paths flagged in SURVEY.md §2.1/§3.2.
"""

import numpy as np
import pytest

from sponge_jax import (
    BLS12_381_FR,
    BN254_FR,
    FULL,
    Batched,
    PoseidonSponge,
    Truncated,
    get_default_poseidon_parameters,
)
from sponge_jax.absorb import Fp, U8
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

FR = BLS12_381_FR
CFG = get_default_poseidon_parameters(FR, 2, False)
RNG = np.random.default_rng(7)


def rand_fr(n):
    return [int(RNG.integers(0, 2 ** 63)) ** 4 % FR.modulus for _ in range(n)]


GOLDEN_SQUEEZE = [
    40442793463571304028337753002242186710310163897048962278675457993207843616876,
    2664374461699898000291153145224099287711224021716202960480903840045233645301,
    50191078828066923662070228256530692951801504043422844038937334196346054068797,
]


def test_golden_vector_oracle():
    """poseidon/mod.rs:376-399 through the oracle sponge."""
    s = OraclePoseidonSponge(CFG)
    s.absorb([Fp(0, FR), Fp(1, FR), Fp(2, FR)])
    assert s.squeeze_native_field_elements(3) == GOLDEN_SQUEEZE


def test_golden_vector_device():
    """Same golden vector through the batched device sponge, every lane."""
    s = PoseidonSponge(CFG, batch_size=4)
    s.absorb([Fp(0, FR), Fp(1, FR), Fp(2, FR)])
    lanes = s.squeeze_native_field_elements(3)
    for lane in lanes:
        assert lane == GOLDEN_SQUEEZE


def _random_transcript(num_steps, rng):
    """A random absorb/squeeze schedule exercising all duplex transitions."""
    steps = []
    for _ in range(num_steps):
        kind = rng.choice(["absorb", "squeeze"])
        n = int(rng.integers(1, 8))
        steps.append((kind, n))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_vs_oracle_random_transcripts(seed):
    """Interleaved absorbs/squeezes with per-lane values; includes the
    no-permute-when-remaining==rate quirk path and mode flips."""
    rng = np.random.default_rng(seed)
    B = 3
    dev = PoseidonSponge(CFG, batch_size=B)
    oracles = [OraclePoseidonSponge(CFG) for _ in range(B)]

    for kind, n in _random_transcript(12, rng):
        if kind == "absorb":
            lanes_vals = [rand_fr(n) for _ in range(B)]
            dev.absorb(Batched([[Fp(v, FR) for v in vals] for vals in lanes_vals]))
            for o, vals in zip(oracles, lanes_vals):
                o.absorb_field_elements(vals)
        else:
            got = dev.squeeze_native_field_elements(n)
            want = [o.squeeze_native_field_elements(n) for o in oracles]
            assert got == want, f"squeeze({n}) diverged"
    # Modes/indices stay in lockstep with the oracle once pending lazy
    # absorbs are flushed (into_state flushes; bookkeeping is deferred
    # until dispatch in the lazy default).
    dev.into_state()
    assert all(dev.mode == o.mode and dev.index == o.index for o in oracles)


def test_squeeze_quirk_path():
    """rate_start_index > 0 with remaining == rate: permute skipped, stale state
    re-read (mod.rs:174-177)."""
    dev = PoseidonSponge(CFG, batch_size=1)
    o = OraclePoseidonSponge(CFG)
    vals = rand_fr(2)
    dev.absorb([Fp(v, FR) for v in vals])
    o.absorb_field_elements(vals)
    # First squeeze 1 (index=1), then squeeze rate+? crossing with remaining==rate.
    assert dev.squeeze_native_field_elements(1) == [
        o.squeeze_native_field_elements(1)
    ]
    assert dev.squeeze_native_field_elements(3) == [
        o.squeeze_native_field_elements(3)
    ]


def test_squeeze_bytes_and_bits_parity():
    dev = PoseidonSponge(CFG, batch_size=2)
    o = OraclePoseidonSponge(CFG)
    vals = rand_fr(3)
    dev.absorb([Fp(v, FR) for v in vals])
    o.absorb_field_elements(vals)
    assert dev.squeeze_bytes(77) == [o.squeeze_bytes(77)] * 2

    dev2 = PoseidonSponge(CFG, batch_size=2)
    o2 = OraclePoseidonSponge(CFG)
    dev2.absorb([Fp(v, FR) for v in vals])
    o2.absorb_field_elements(vals)
    assert dev2.squeeze_bits(300) == [o2.squeeze_bits(300)] * 2


def test_squeeze_cast_native_equivalence():
    """squeeze_native_field_elements ≡ squeeze_field_elements::<native>
    (poseidon/tests.rs:72-85)."""
    elem = rand_fr(1)[0]
    s1 = OraclePoseidonSponge(CFG)
    s1.absorb(Fp(elem, FR))
    s2 = s1.clone()
    assert s1.squeeze_native_field_elements(5) == s2.squeeze_field_elements(FR, 5)


def test_nonnative_squeeze_oracle_vs_device():
    """BLS12-381 Fr sponge squeezing BN254 Fr elements (lib.rs:61-100 path)."""
    vals = rand_fr(2)
    dev = PoseidonSponge(CFG, batch_size=2)
    o = OraclePoseidonSponge(CFG)
    dev.absorb([Fp(v, FR) for v in vals])
    o.absorb_field_elements(vals)
    want = o.squeeze_field_elements(BN254_FR, 3)
    got = dev.squeeze_field_elements(BN254_FR, 3)
    assert got == [want] * 2
    assert all(v < BN254_FR.modulus for v in want)


def test_truncated_size_quirk():
    """Truncated(n) never truncates (lib.rs:45-52) but bounds-checks."""
    vals = rand_fr(1)
    s1 = OraclePoseidonSponge(CFG)
    s1.absorb_field_elements(vals)
    s2 = s1.clone()
    trunc = s2.squeeze_native_field_elements_with_sizes([FULL, Truncated(100)])
    # The quirk: a Truncated element still spans the full MODULUS_BIT_SIZE-1 bits
    # (not 100) — with overwhelming probability its bit length exceeds 100.
    assert trunc[1].bit_length() > 100
    with pytest.raises(ValueError):
        s1.squeeze_native_field_elements_with_sizes([Truncated(FR.modulus_bit_size + 1)])


def test_fork_domain_separation():
    s = OraclePoseidonSponge(CFG)
    s.absorb_field_elements(rand_fr(2))
    f1 = s.fork(b"domain-a")
    f2 = s.fork(b"domain-b")
    f3 = s.fork(b"domain-a")
    a = f1.squeeze_native_field_elements(2)
    b = f2.squeeze_native_field_elements(2)
    c = f3.squeeze_native_field_elements(2)
    assert a != b and a == c
    # device fork matches oracle fork
    dev2 = PoseidonSponge(CFG, batch_size=1)
    o = OraclePoseidonSponge(CFG)
    vals = rand_fr(2)
    dev2.absorb([Fp(v, FR) for v in vals])
    o.absorb_field_elements(vals)
    assert dev2.fork(b"xyz").squeeze_native_field_elements(2) == [
        o.fork(b"xyz").squeeze_native_field_elements(2)
    ]


def test_state_roundtrip():
    """SpongeExt save/restore (lib.rs:188-195) preserves the transcript."""
    vals = rand_fr(3)
    dev = PoseidonSponge(CFG, batch_size=2)
    dev.absorb([Fp(v, FR) for v in vals])
    dev.squeeze_native_field_elements(1)
    st = dev.into_state()
    resumed = PoseidonSponge.from_state(st, CFG)
    assert resumed.squeeze_native_field_elements(
        2
    ) == dev.squeeze_native_field_elements(2)

    o = OraclePoseidonSponge(CFG)
    o.absorb_field_elements(vals)
    o.squeeze_native_field_elements(1)
    o2 = OraclePoseidonSponge.from_state(o.into_state(), CFG)
    assert o2.squeeze_native_field_elements(2) == o.squeeze_native_field_elements(2)


def test_absorb_empty_is_noop():
    """Absorbing an encoding-empty value leaves the sponge untouched
    (mod.rs:234-236)."""
    dev = PoseidonSponge(CFG, batch_size=1)
    vals = rand_fr(1)
    dev.absorb([Fp(v, FR) for v in vals])
    before_mode, before_index = dev.mode, dev.index
    dev.absorb(Fp(5, BN254_FR))  # single nonnative Fp: silent no-op encoding
    assert (dev.mode, dev.index) == (before_mode, before_index)


def test_absorb_after_squeeze_flip():
    """Squeezing then absorbing always permutes first (mod.rs:247-252)."""
    dev = PoseidonSponge(CFG, batch_size=1)
    o = OraclePoseidonSponge(CFG)
    for step_vals in [rand_fr(2), rand_fr(1)]:
        dev.absorb([Fp(v, FR) for v in step_vals])
        o.absorb_field_elements(step_vals)
        assert dev.squeeze_native_field_elements(1) == [
            o.squeeze_native_field_elements(1)
        ]


def test_absorb_stream_matches_monolithic():
    """absorb_stream over chunked planes/codec values == one-shot absorbs
    (the duplex machine is inherently streaming; this pins the wrapper)."""
    import numpy as np

    from conftest import TINY_FR, tiny_poseidon_config
    from sponge_jax import Fp, PoseidonSponge
    from sponge_jax.sponge import encode_ints_plane

    cfg = tiny_poseidon_config()
    B = 2
    vals = [[(7 * i + b) % TINY_FR.modulus for b in range(B)] for i in range(9)]

    streamed = PoseidonSponge(cfg, batch_size=B)
    # Mixed stream: two pre-encoded planes + one codec value broadcast.
    n = streamed.absorb_stream(
        iter(
            [
                encode_ints_plane(TINY_FR, vals[:5]),
                encode_ints_plane(TINY_FR, vals[5:]),
                Fp(11, TINY_FR),
            ]
        )
    )
    assert n == 3

    oneshot = PoseidonSponge(cfg, batch_size=B)
    oneshot.absorb_element_plane(encode_ints_plane(TINY_FR, vals))
    oneshot.absorb(Fp(11, TINY_FR))

    assert streamed.squeeze_native_field_elements(3) == \
        oneshot.squeeze_native_field_elements(3)
