"""BLS12-377 Fr: field codecs, default params, and sponge oracle ≡ device.

The third shipped arkworks field (ark-bls12-377 Fr, 253 bits).  The reference
lets any PrimeField declare default Poseidon tables (traits.rs:43-56); here the
constraints table uses alpha=17 because gcd(5, p-1) = 5 makes x^5 a non-bijection
over this field.
"""

import math

import numpy as np

from sponge_jax import (
    BLS12_377_FR,
    PoseidonSponge,
    get_default_poseidon_parameters,
)
from sponge_jax.absorb import Fp, U64
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

FR = BLS12_377_FR


def test_field_roundtrips():
    rng = np.random.default_rng(1)
    for _ in range(20):
        x = int(rng.integers(0, 2 ** 62)) ** 4 % FR.modulus
        assert FR.mont_limbs_to_int(FR.int_to_mont_limbs(x)) == x
    # native batch codec path (n >= 8 triggers the C++ tier at 22 limbs)
    xs = [int(rng.integers(0, 2 ** 62)) ** 4 % FR.modulus for _ in range(16)]
    plane = FR.ints_to_mont_plane(xs)
    assert FR.mont_plane_to_ints(plane) == xs


def test_default_params_alpha_coprime():
    """Every default table row must give a bijective S-box over this field."""
    for rate in range(2, 9):
        cfg = get_default_poseidon_parameters(FR, rate, False)
        assert math.gcd(cfg.alpha, FR.modulus - 1) == 1
        assert cfg.capacity == 1 and cfg.rate == rate
        # Grain derivation is deterministic
        cfg2 = get_default_poseidon_parameters(FR, rate, False)
        assert cfg.ark == cfg2.ark and cfg.mds == cfg2.mds


def test_sponge_device_vs_oracle():
    cfg = get_default_poseidon_parameters(FR, 2, False)
    rng = np.random.default_rng(3)
    vals = [int(rng.integers(0, 2 ** 62)) ** 4 % FR.modulus for _ in range(5)]

    dev = PoseidonSponge(cfg, batch_size=2)
    oracle = OraclePoseidonSponge(cfg)
    items = [Fp(v, FR) for v in vals] + [U64(99)]
    dev.absorb(items)
    oracle.absorb(items)
    lanes = dev.squeeze_native_field_elements(4)
    want = oracle.squeeze_native_field_elements(4)
    for lane in lanes:
        assert lane == want
    assert dev.squeeze_bytes(17) == [oracle.squeeze_bytes(17)] * 2
