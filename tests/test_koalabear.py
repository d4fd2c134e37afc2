"""KoalaBear (2^31 - 2^24 + 1): the third plonky3 31-bit field.

Same 3 x 12-bit limb plane as BabyBear/Mersenne31, but p - 1 = 2^24 * 127,
so the CUBIC S-box permutes (gcd(3, p-1) = 1) — the cheapest S-box of any
shipped field (2 Montgomery muls per S-box); the lower degree buys its speed
back in partial rounds (R_P = 20 vs BabyBear's 13 / M31's 14, the
plonky3-family t=16 alpha=3 instance).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from sponge_jax import (
    KOALABEAR_FR as KB,
    OraclePoseidon2Sponge,
    get_default_poseidon_parameters,
    get_default_poseidon2_parameters,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

CFG = get_default_poseidon_parameters(KB, 8)
CFG2 = get_default_poseidon2_parameters(KB, 8)


def rand_kb(n, seed=127):
    rng = np.random.default_rng(seed)
    return [int(v) % KB.modulus for v in rng.integers(0, 1 << 62, size=n)]


def test_field_geometry():
    assert KB.nlimbs == 3 and KB.modulus == (1 << 31) - (1 << 24) + 1
    assert CFG.t == 16 and CFG.capacity == 8 and CFG.alpha == 3
    assert CFG.full_rounds == 8 and CFG.partial_rounds == 20
    assert CFG2.t == 16  # 4 | 16: block-circulant external matrix
    from math import gcd

    p = KB.modulus
    assert gcd(3, p - 1) == 1  # x^3 permutes: p - 1 = 2^24 * 127
    assert (p - 1) == (1 << 24) * 127
    # generator 3 is a primitive root
    assert all(pow(KB.generator, (p - 1) // q, p) != 1 for q in (2, 127))


def test_oracle_golden_regression():
    s = OraclePoseidonSponge(CFG)
    s.absorb_field_elements(list(range(8)))
    assert s.squeeze_native_field_elements(3) == [
        1459663806, 1816421379, 827551705,
    ]
    s2 = OraclePoseidon2Sponge(CFG2)
    s2.absorb_field_elements(list(range(8)))
    assert s2.squeeze_native_field_elements(3) == [
        1516657146, 1095843776, 483496760,
    ]


def test_xla_tiers_vs_oracle():
    from sponge_jax.poseidon.permutation import permute_jit
    from sponge_jax.poseidon2.permutation import poseidon2_permute_jit

    B = 4
    vals = [rand_kb(B, seed=3 + i) for i in range(16)]
    state = jnp.asarray(
        np.stack([KB.ints_to_mont_plane(row) for row in vals], axis=0)
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
            got = [KB.mont_plane_to_ints(out[i][:, b : b + 1])[0] for i in range(16)]
            assert got == o.state, b


def test_kernel_bodies():
    """Both families' XLA tiers at L=3, t=16, alpha=3 on a 128-lane batch."""
    from conftest import check_permutation_vs_oracle

    check_permutation_vs_oracle(CFG, B=128, stride=29)
    check_permutation_vs_oracle(CFG2, B=128, stride=29)


def test_host_runtime_koalabear():
    from sponge_jax.poseidon.host import host_available, host_permute_states

    if not host_available(CFG):
        pytest.skip("no C++ toolchain")
    for cfg, oracle_cls in ((CFG, OraclePoseidonSponge), (CFG2, OraclePoseidon2Sponge)):
        states = rand_kb(2 * 16, seed=77)
        got = host_permute_states(cfg, states)
        for b in range(2):
            o = oracle_cls(cfg)
            o.state = states[b * 16 : (b + 1) * 16]
            o.permute()
            assert got[b * 16 : (b + 1) * 16] == o.state, (cfg.alpha, b)


def test_sponge_device_vs_oracle():
    """Full duplex sponge over KoalaBear on the batched device path."""
    from sponge_jax import Batched
    from sponge_jax.absorb import Fp
    from sponge_jax.sponge import PoseidonSponge

    B = 3
    lanes = [rand_kb(10, seed=100 + b) for b in range(B)]
    dev = PoseidonSponge(CFG, batch_size=B)
    dev.absorb(Batched([[Fp(v, KB) for v in vals] for vals in lanes]))
    got = dev.squeeze_native_field_elements(5)
    for b in range(B):
        o = OraclePoseidonSponge(CFG)
        o.absorb_field_elements(lanes[b])
        assert got[b] == o.squeeze_native_field_elements(5), b
