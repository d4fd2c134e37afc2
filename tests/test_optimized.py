"""Optimized (sparse-MDS) partial-round schedule: exact equivalence tests.

The decomposition is an algebraic identity — outputs must be bit-identical to
the naive partial-round chain for every config.  The native host runtime
runs this schedule (tests/test_host_runtime.py checks it end to end).
"""

import numpy as np
import pytest

from sponge_jax import BLS12_381_FR, BN254_FR, get_default_poseidon_parameters
from sponge_jax.poseidon.oracle import OraclePoseidonSponge
from sponge_jax.poseidon.optimized import (
    eval_partial_chain_optimized,
    optimized_partial_layers,
)

RNG = np.random.default_rng(61)


def naive_partial_chain(cfg, state):
    o = OraclePoseidonSponge(cfg)
    st = list(state)
    half = cfg.full_rounds // 2
    for r in range(half, half + cfg.partial_rounds):
        o._apply_ark(st, r)
        o._apply_sbox(st, False)
        o._apply_mds(st)
    return tuple(st)


@pytest.mark.parametrize(
    "fs,rate,weights",
    [
        (BLS12_381_FR, 2, False),
        (BLS12_381_FR, 3, False),
        (BLS12_381_FR, 8, False),
        (BLS12_381_FR, 2, True),
        (BLS12_381_FR, 4, False),
        (BLS12_381_FR, 5, True),
        (BN254_FR, 2, False),
        (BN254_FR, 3, False),
        (BN254_FR, 4, False),
    ],
    ids=lambda v: getattr(v, "name", str(v)),
)
def test_host_derivation_exact(fs, rate, weights):
    cfg = get_default_poseidon_parameters(fs, rate, weights)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        state = tuple(
            int(rng.integers(0, 2 ** 63)) ** 4 % fs.modulus for _ in range(cfg.t)
        )
        assert eval_partial_chain_optimized(cfg, state) == naive_partial_chain(
            cfg, state
        )


def test_sparse_factor_shapes():
    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, False)
    layers = optimized_partial_layers(cfg)
    k, t = cfg.partial_rounds, cfg.t
    assert len(layers.sparse) == k - 1
    assert len(layers.constants) == k - 1
    assert all(len(sp.row0) == t and len(sp.col0) == t - 1 for sp in layers.sparse)
    assert len(layers.dense) == t
