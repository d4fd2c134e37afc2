"""BabyBear (15 * 2^27 + 1, 31 bits): the plonky3 / risc0 / sp1 field.

THREE 12-bit limbs per element; rate 8 / capacity 8 (t = 16).  Exercises the
framework's widest shipped state and smallest limb plane — including the
Poseidon XLA tier's static value-bound check (R/p = 34 here: the t=16 MDS
sum fixpoint sits at ~30p, just under R) and the Poseidon2 rho-folding.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from sponge_jax import (
    BABYBEAR_FR as BB,
    OraclePoseidon2Sponge,
    get_default_poseidon_parameters,
    get_default_poseidon2_parameters,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

CFG = get_default_poseidon_parameters(BB, 8)
CFG2 = get_default_poseidon2_parameters(BB, 8)


def rand_bb(n, seed=31):
    rng = np.random.default_rng(seed)
    return [int(v) % BB.modulus for v in rng.integers(0, 1 << 62, size=n)]


def test_field_geometry():
    assert BB.nlimbs == 3 and BB.modulus == (15 << 27) + 1
    assert CFG.t == 16 and CFG.capacity == 8 and CFG.alpha == 7
    assert CFG.full_rounds == 8 and CFG.partial_rounds == 13
    assert CFG2.t == 16  # 4 | 16: block-circulant external matrix


def test_oracle_golden_regression():
    s = OraclePoseidonSponge(CFG)
    s.absorb_field_elements(list(range(8)))
    assert s.squeeze_native_field_elements(3) == [
        1986692234, 1773299556, 1481612512,
    ]
    s2 = OraclePoseidon2Sponge(CFG2)
    s2.absorb_field_elements(list(range(8)))
    assert s2.squeeze_native_field_elements(3) == [
        2519418, 501228935, 991129364,
    ]


def test_xla_tiers_vs_oracle():
    from sponge_jax.poseidon.permutation import permute_jit
    from sponge_jax.poseidon2.permutation import poseidon2_permute_jit

    B = 4
    vals = [rand_bb(B, seed=3 + i) for i in range(16)]
    state = jnp.asarray(
        np.stack([BB.ints_to_mont_plane(row) for row in vals], axis=0)
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
            got = [BB.mont_plane_to_ints(out[i][:, b : b + 1])[0] for i in range(16)]
            assert got == o.state, b


def test_kernel_bodies():
    """Both families' XLA tiers at L=3, t=16 on a 128-lane batch."""
    from conftest import check_permutation_vs_oracle

    check_permutation_vs_oracle(CFG, B=128, stride=31)
    check_permutation_vs_oracle(CFG2, B=128, stride=31)


def test_host_runtime_babybear():
    from sponge_jax.poseidon.host import host_available, host_permute_states

    if not host_available(CFG):
        pytest.skip("no C++ toolchain")
    for cfg, oracle_cls in ((CFG, OraclePoseidonSponge), (CFG2, OraclePoseidon2Sponge)):
        states = rand_bb(2 * 16, seed=77)
        got = host_permute_states(cfg, states)
        for b in range(2):
            o = oracle_cls(cfg)
            o.state = states[b * 16 : (b + 1) * 16]
            o.permute()
            assert got[b * 16 : (b + 1) * 16] == o.state, (cfg.alpha, b)


def test_wide_digest_merkle_babybear():
    """BabyBear Merkle nodes are 8-element digests (248 bits)."""
    from sponge_jax.hash import default_digest_elems, merkle_root_wide

    d = default_digest_elems(CFG)
    assert d == 9  # ceil(256/31) — one more element than capacity-8's 248 bits
    # 8-element digests (the plonky3 convention) also work: 2d = 16 = 2*rate,
    # i.e. two permutations per compression via the duplex chunking.
    d = 8
    N = 4
    digs = [rand_bb(d, seed=400 + i) for i in range(N)]
    leaves = jnp.asarray(
        np.stack(
            [BB.ints_to_mont_plane([digs[n][k] for n in range(N)]) for k in range(d)],
            axis=0,
        )
    )
    root = merkle_root_wide(CFG, leaves)

    def compress(a, b):
        o = OraclePoseidonSponge(CFG)
        o.absorb_field_elements(a + b)
        return o.squeeze_native_field_elements(d)

    want = compress(compress(digs[0], digs[1]), compress(digs[2], digs[3]))
    got = [BB.mont_limbs_to_int(np.asarray(root[k])) for k in range(d)]
    assert got == want
