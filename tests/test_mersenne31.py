"""Mersenne31 (2^31 - 1): plonky3's circle-STARK field.

Same 3 x 12-bit limb plane as BabyBear, but alpha=5 (7 divides p-1 here, the
mirror image of BabyBear where 5 divides p-1) and rate 8 / capacity 8 (t=16).
The Mersenne modulus is the extreme low end of the Montgomery R/p headroom
range the value-bound gates were hardened for (R/p = 2^36/(2^31-1) = 32).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from sponge_jax import (
    MERSENNE31_FR as M31,
    OraclePoseidon2Sponge,
    get_default_poseidon_parameters,
    get_default_poseidon2_parameters,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

CFG = get_default_poseidon_parameters(M31, 8)
CFG2 = get_default_poseidon2_parameters(M31, 8)


def rand_m31(n, seed=31):
    rng = np.random.default_rng(seed)
    return [int(v) % M31.modulus for v in rng.integers(0, 1 << 62, size=n)]


def test_field_geometry():
    assert M31.nlimbs == 3 and M31.modulus == (1 << 31) - 1
    assert CFG.t == 16 and CFG.capacity == 8 and CFG.alpha == 5
    assert CFG.full_rounds == 8 and CFG.partial_rounds == 14
    assert CFG2.t == 16  # 4 | 16: block-circulant external matrix
    # alpha must be a permutation exponent; 7 (BabyBear's choice) is not here.
    from math import gcd

    assert gcd(5, M31.modulus - 1) == 1 and gcd(7, M31.modulus - 1) == 7
    # generator 7 is a primitive root: p-1 = 2 * 3^2 * 7 * 11 * 31 * 151 * 331
    p = M31.modulus
    assert all(
        pow(M31.generator, (p - 1) // q, p) != 1
        for q in (2, 3, 7, 11, 31, 151, 331)
    )


def test_oracle_golden_regression():
    s = OraclePoseidonSponge(CFG)
    s.absorb_field_elements(list(range(8)))
    assert s.squeeze_native_field_elements(3) == [
        1778168036, 839514075, 1803166962,
    ]
    s2 = OraclePoseidon2Sponge(CFG2)
    s2.absorb_field_elements(list(range(8)))
    assert s2.squeeze_native_field_elements(3) == [
        2136852812, 2074433829, 1891198149,
    ]


def test_xla_tiers_vs_oracle():
    from sponge_jax.poseidon.permutation import permute_jit
    from sponge_jax.poseidon2.permutation import poseidon2_permute_jit

    B = 4
    vals = [rand_m31(B, seed=3 + i) for i in range(16)]
    state = jnp.asarray(
        np.stack([M31.ints_to_mont_plane(row) for row in vals], axis=0)
    )
    for cfg, fn, oracle_cls in (
        (CFG, permute_jit(CFG), OraclePoseidonSponge),
        (CFG2, poseidon2_permute_jit(CFG2), OraclePoseidon2Sponge),
    ):
        out = np.asarray(fn(state))
        for b in range(B):
            o = oracle_cls(cfg)
            o.state = [vals[i][b] for i in range(16)]
            o.permute()
            got = [M31.mont_plane_to_ints(out[i][:, b : b + 1])[0] for i in range(16)]
            assert got == o.state, b


def test_kernel_bodies():
    """Both families' XLA tiers at L=3, t=16, alpha=5 on a 128-lane batch."""
    from conftest import check_permutation_vs_oracle

    check_permutation_vs_oracle(CFG, B=128, stride=29)
    check_permutation_vs_oracle(CFG2, B=128, stride=29)


def test_host_runtime_mersenne31():
    from sponge_jax.poseidon.host import host_available, host_permute_states

    if not host_available(CFG):
        pytest.skip("no C++ toolchain")
    for cfg, oracle_cls in ((CFG, OraclePoseidonSponge), (CFG2, OraclePoseidon2Sponge)):
        states = rand_m31(2 * 16, seed=77)
        got = host_permute_states(cfg, states)
        for b in range(2):
            o = oracle_cls(cfg)
            o.state = states[b * 16 : (b + 1) * 16]
            o.permute()
            assert got[b * 16 : (b + 1) * 16] == o.state, (cfg.alpha, b)


def test_sponge_device_vs_oracle():
    """Full duplex sponge over M31 on the batched device path."""
    from sponge_jax import Batched
    from sponge_jax.absorb import Fp
    from sponge_jax.sponge import PoseidonSponge

    B = 3
    lanes = [rand_m31(10, seed=100 + b) for b in range(B)]
    dev = PoseidonSponge(CFG, batch_size=B)
    dev.absorb(Batched([[Fp(v, M31) for v in vals] for vals in lanes]))
    got = dev.squeeze_native_field_elements(5)
    for b in range(B):
        o = OraclePoseidonSponge(CFG)
        o.absorb_field_elements(lanes[b])
        assert got[b] == o.squeeze_native_field_elements(5), b
