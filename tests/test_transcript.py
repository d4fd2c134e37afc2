"""Compiled transcript executor ≡ interactive sponge, bit-exactly."""

import numpy as np
import pytest

import jax.numpy as jnp

from sponge_jax import BLS12_381_FR, get_default_poseidon_parameters
from sponge_jax.poseidon.oracle import OraclePoseidonSponge
from sponge_jax.transcript import Absorb, SqueezeNative, compile_transcript, transcript_shape

FR = BLS12_381_FR
CFG = get_default_poseidon_parameters(FR, 2, False)
RNG = np.random.default_rng(53)


def rand_fr(n):
    return [int(RNG.integers(0, 2 ** 63)) ** 4 % FR.modulus for _ in range(n)]


SCHEDULES = [
    [Absorb(3), SqueezeNative(3)],
    [Absorb(1), SqueezeNative(1), Absorb(2), SqueezeNative(2)],
    [Absorb(5), SqueezeNative(1), SqueezeNative(4), Absorb(1), SqueezeNative(2)],
    [Absorb(2), SqueezeNative(1), SqueezeNative(3)],  # crosses the quirk path
]


@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: str(transcript_shape(s)))
def test_compiled_transcript_matches_oracle(schedule):
    total_a, total_q = transcript_shape(schedule)
    B = 3
    lanes = [rand_fr(total_a) for _ in range(B)]
    grid = np.asarray(lanes, dtype=object).T  # (total_a, B)
    elems = jnp.asarray(
        np.stack([FR.ints_to_mont_plane(row) for row in grid], axis=0)
    )
    fn = compile_transcript(CFG, schedule)
    out = np.asarray(fn(elems))
    assert out.shape[0] == total_q

    for b in range(B):
        o = OraclePoseidonSponge(CFG)
        want = []
        pos = 0
        for step in schedule:
            if isinstance(step, Absorb):
                o.absorb_field_elements(lanes[b][pos : pos + step.num_elements])
                pos += step.num_elements
            else:
                want.extend(o.squeeze_native_field_elements(step.num_elements))
        got = [FR.limbs_to_int(out[i, :, b]) for i in range(total_q)]
        assert got == want, b


def test_compiled_transcript_rejects_undersized_plane():
    """jnp slicing clamps silently; the executor must instead validate the
    static input shape against the schedule's absorbed total."""
    schedule = [Absorb(3), SqueezeNative(1)]
    fn = compile_transcript(CFG, schedule)
    elems = jnp.asarray(np.zeros((2, FR.nlimbs, 4), dtype=np.int32))
    with pytest.raises(ValueError, match="absorbs 3"):
        fn(elems)


def test_compiled_transcript_matches_oracle_tiny_field():
    """Fast-lane variant of the compiled-transcript parity test: the same
    schedule machinery (mode flips + multi-chunk squeeze, incl. the quirk
    path) over the tiny CI field, so the default lane keeps compiled
    transcript coverage while the L=22 BLS variants live in the slow lane."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from conftest import tiny_poseidon_config

    cfg = tiny_poseidon_config()
    fs = cfg.field
    schedule = [Absorb(2), SqueezeNative(1), SqueezeNative(3), Absorb(1), SqueezeNative(2)]
    total_a, total_q = transcript_shape(schedule)
    B = 4
    rng = np.random.default_rng(9)
    lanes = [
        [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=total_a)]
        for _ in range(B)
    ]
    grid = np.asarray(lanes, dtype=object).T
    elems = jnp.asarray(np.stack([fs.ints_to_mont_plane(row) for row in grid], axis=0))
    out = np.asarray(compile_transcript(cfg, schedule)(elems))
    for b in range(B):
        o = cfg.oracle_sponge()
        want = []
        pos = 0
        for step in schedule:
            if isinstance(step, Absorb):
                o.absorb_field_elements(lanes[b][pos : pos + step.num_elements])
                pos += step.num_elements
            else:
                want.extend(o.squeeze_native_field_elements(step.num_elements))
        got = [fs.limbs_to_int(out[i, :, b]) for i in range(total_q)]
        assert got == want, b
