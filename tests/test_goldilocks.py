"""Goldilocks (2^64 - 2^32 + 1) support: the dominant small ZK field.

Additive capability (the reference ships no small fields).  6-limb planes
make the device tiers cheap enough to compile in default CI, and the
capacity-4 sponge geometry (256 capacity bits for 128-bit security)
exercises the duplex machinery's capacity > 1 paths for the first time —
the reference hardcodes capacity = 1 (traits.rs:96).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from sponge_jax import (
    GOLDILOCKS_FR as GL,
    Fp,
    Batched,
    OraclePoseidon2Sponge,
    PoseidonSponge,
    get_default_poseidon_parameters,
    get_default_poseidon2_parameters,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

CFG = get_default_poseidon_parameters(GL, 8)
CFG2 = get_default_poseidon2_parameters(GL, 8)


def rand_gl(n, seed=64):
    rng = np.random.default_rng(seed)
    return [int(v) % GL.modulus for v in rng.integers(0, 1 << 62, size=n)]


def test_field_geometry():
    assert GL.nlimbs == 6 and GL.modulus == (1 << 64) - (1 << 32) + 1
    assert CFG.t == 12 and CFG.capacity == 4 and CFG.alpha == 7
    assert CFG.full_rounds == 8 and CFG.partial_rounds == 22
    assert CFG2.t == 12 and CFG2.capacity == 4
    assert get_default_poseidon_parameters(GL, 4).t == 8


def test_oracle_golden_regression():
    """Frozen end-to-end vectors for both families (self-generated
    deterministic Grain instances over the Goldilocks seed)."""
    s = OraclePoseidonSponge(CFG)
    s.absorb_field_elements(list(range(8)))
    assert s.squeeze_native_field_elements(3) == [
        4693291320119453852, 16644555527746814005, 10764572620958058423,
    ]
    s2 = OraclePoseidon2Sponge(CFG2)
    s2.absorb_field_elements(list(range(8)))
    assert s2.squeeze_native_field_elements(3) == [
        15152787486668847983, 7475383762122992677, 6125801589477566891,
    ]


def test_xla_tier_vs_oracle_both_families():
    from sponge_jax.poseidon.permutation import permute_jit
    from sponge_jax.poseidon2.permutation import poseidon2_permute_jit

    B = 4
    vals = [rand_gl(B, seed=9 + i) for i in range(12)]
    state = jnp.asarray(
        np.stack([GL.ints_to_mont_plane(row) for row in vals], axis=0)
    )
    for cfg, fn, oracle_cls in (
        (CFG, permute_jit(CFG), OraclePoseidonSponge),
        (CFG2, poseidon2_permute_jit(CFG2), OraclePoseidon2Sponge),
    ):
        out = np.asarray(fn(state))
        for b in range(B):
            o = oracle_cls(cfg)
            o.state = [vals[i][b] for i in range(12)]
            o.permute()
            got = [GL.mont_plane_to_ints(out[i][:, b : b + 1])[0] for i in range(12)]
            assert got == o.state, (cfg.alpha, b)


def test_cios_kernel_body_goldilocks():
    """The Poseidon XLA tier at L=6, t=12 on a 128-lane batch."""
    from conftest import check_permutation_vs_oracle

    check_permutation_vs_oracle(CFG, B=128, stride=31)


@pytest.mark.parametrize("cfg,oracle_cls", [(CFG, OraclePoseidonSponge),
                                            (CFG2, OraclePoseidon2Sponge)],
                         ids=["poseidon", "poseidon2"])
def test_capacity4_duplex_sponge_vs_oracle(cfg, oracle_cls):
    """First capacity > 1 coverage of the shared duplex machinery: rate
    chunking, mode flips, byte/bit squeezes all offset by capacity = 4."""
    B = 2
    dev = PoseidonSponge(cfg, batch_size=B)
    oracles = [oracle_cls(cfg) for _ in range(B)]
    lanes = [rand_gl(11, seed=100 + b) for b in range(B)]  # 11 > rate: chunking
    dev.absorb(Batched(lanes=[[Fp(v, GL) for v in lane] for lane in lanes]))
    for o, lane in zip(oracles, lanes):
        o.absorb_field_elements(lane)
    got = dev.squeeze_native_field_elements(10)  # > rate: multi-chunk squeeze
    for b in range(B):
        assert got[b] == oracles[b].squeeze_native_field_elements(10), b
    dev.absorb(Batched(lanes=[[Fp(b, GL)] for b in range(B)]))
    for b, o in enumerate(oracles):
        o.absorb_field_elements([b])
    got_bytes = dev.squeeze_bytes(20)  # usable = 7 bytes/elem over 64-bit field
    got_bits = dev.squeeze_bits(9)
    for b in range(B):
        assert got_bytes[b] == bytes(oracles[b].squeeze_bytes(20)), b
        assert got_bits[b] == oracles[b].squeeze_bits(9), b


def test_host_runtime_goldilocks():
    from sponge_jax.poseidon.host import host_available, host_permute_states

    if not host_available(CFG):
        pytest.skip("no C++ toolchain")
    for cfg, oracle_cls in ((CFG, OraclePoseidonSponge), (CFG2, OraclePoseidon2Sponge)):
        states = rand_gl(2 * 12, seed=7)
        got = host_permute_states(cfg, states)
        for b in range(2):
            o = oracle_cls(cfg)
            o.state = states[b * 12 : (b + 1) * 12]
            o.permute()
            assert got[b * 12 : (b + 1) * 12] == o.state, (cfg.alpha, b)


def test_merkle_and_transcript_goldilocks():
    from sponge_jax.hash import merkle_root
    from sponge_jax.transcript import Absorb, SqueezeNative, compile_transcript

    leaves_int = rand_gl(8, seed=5)
    root = GL.mont_limbs_to_int(
        np.asarray(merkle_root(CFG, jnp.asarray(GL.ints_to_mont_plane(leaves_int))))
    )

    def compress2(cfg, left, right):
        o = OraclePoseidonSponge(cfg)
        o.absorb_field_elements([left, right])
        return o.squeeze_native_field_elements(1)[0]

    lvl = leaves_int
    while len(lvl) > 1:
        lvl = [compress2(CFG, lvl[i], lvl[i + 1]) for i in range(0, len(lvl), 2)]
    assert root == lvl[0]

    steps = [Absorb(3), SqueezeNative(2)]
    vals = [rand_gl(2, seed=50 + k) for k in range(3)]
    plane = jnp.asarray(
        np.stack([GL.ints_to_mont_plane(row) for row in vals], axis=0)
    )
    out = np.asarray(compile_transcript(CFG2, steps)(plane))
    for b in range(2):
        o = OraclePoseidon2Sponge(CFG2)
        o.absorb_field_elements([vals[k][b] for k in range(3)])
        want = o.squeeze_native_field_elements(2)
        got = [GL.limbs_to_int(out[k][:, b]) for k in range(2)]
        assert got == want, b


def test_wide_digest_merkle():
    """4-element (256-bit) digests over Goldilocks: tree, root, batched
    open/verify — all vs an oracle chain (absorb 8, squeeze 4 per node)."""
    from sponge_jax.hash import (
        default_digest_elems,
        merkle_open_batch_wide,
        merkle_root_wide,
        merkle_tree_wide,
        merkle_verify_batch_wide,
    )

    d = default_digest_elems(CFG)
    assert d == 4
    N = 8
    leaf_digests = [rand_gl(d, seed=200 + i) for i in range(N)]  # [N][d]
    leaves = jnp.asarray(
        np.stack(
            [GL.ints_to_mont_plane([leaf_digests[n][k] for n in range(N)])
             for k in range(d)],
            axis=0,
        )
    )  # (d, L, N)

    levels = merkle_tree_wide(CFG, leaves)
    root = merkle_root_wide(CFG, leaves)
    assert np.array_equal(np.asarray(levels[-1][..., 0]), np.asarray(root))

    def compress(a, b):  # oracle: absorb 2d, squeeze d
        o = OraclePoseidonSponge(CFG)
        o.absorb_field_elements(a + b)
        return o.squeeze_native_field_elements(d)

    lvl = leaf_digests
    while len(lvl) > 1:
        lvl = [compress(lvl[i], lvl[i + 1]) for i in range(0, len(lvl), 2)]
    root_ints = [GL.mont_limbs_to_int(np.asarray(root[k])) for k in range(d)]
    assert root_ints == lvl[0]

    # Batched open + verify; tampered leaves must fail.
    idx = [0, 3, 5, 6]
    paths = merkle_open_batch_wide(levels, idx)
    opened = jnp.stack([leaves[..., i] for i in idx], axis=-1)  # (d, L, K)
    ok = merkle_verify_batch_wide(CFG, root, opened, paths, idx)
    assert bool(np.asarray(ok).all())
    bad = opened.at[0, 0, 1].add(1)
    ok2 = np.asarray(merkle_verify_batch_wide(CFG, root, bad, paths, idx))
    assert ok2[0] and not ok2[1] and ok2[2] and ok2[3]


def test_wide_digest_d1_matches_narrow():
    """d = 1 wide tree == the narrow Merkle functions (structural identity)."""
    from sponge_jax.hash import merkle_root, merkle_root_wide

    leaves_int = rand_gl(8, seed=77)
    narrow = merkle_root(CFG, jnp.asarray(GL.ints_to_mont_plane(leaves_int)))
    wide = merkle_root_wide(
        CFG, jnp.asarray(GL.ints_to_mont_plane(leaves_int))[None]
    )
    assert np.array_equal(np.asarray(narrow), np.asarray(wide[0]))


def test_sharded_wide_merkle_matches_single_device():
    """Wide-digest Merkle sharded over the 8-device CPU mesh == single-device,
    crossing the reshard-at-narrow cutover (N = 32 digests, D = 8)."""
    from sponge_jax.hash import merkle_root_wide
    from sponge_jax.parallel import make_mesh, sharded_merkle_root_wide

    d = 4
    N = 32
    vals = [rand_gl(N, seed=300 + k) for k in range(d)]
    leaves = jnp.asarray(
        np.stack([GL.ints_to_mont_plane(row) for row in vals], axis=0)
    )  # (d, L, N)
    single = merkle_root_wide(CFG, leaves, backend="xla")
    mesh = make_mesh()
    sharded = sharded_merkle_root_wide(CFG, leaves, mesh, backend="xla")
    from sponge_jax.ops import montgomery as mont

    a = np.asarray(mont.from_mont(GL, single[..., None]))
    b = np.asarray(mont.from_mont(GL, sharded[..., None]))
    assert np.array_equal(a, b)
