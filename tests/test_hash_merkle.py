"""Fixed-shape hashing + Merkle reduction ≡ oracle sponge semantics, and the
sharded (8 virtual device) paths ≡ single-device results."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sponge_jax import BLS12_381_FR, get_default_poseidon_parameters
from sponge_jax.hash import compress_pairs, hash_elements, merkle_root
from sponge_jax.ops import montgomery as mont
from sponge_jax.parallel import make_mesh, sharded_merkle_root, sharded_permute_fn, sharded_state
from sponge_jax.poseidon.oracle import OraclePoseidonSponge
from sponge_jax.poseidon.params import poseidon_test_fixture
from sponge_jax.poseidon.permutation import permute_jit

FR = BLS12_381_FR
CFG = get_default_poseidon_parameters(FR, 2, False)
RNG = np.random.default_rng(11)


def rand_fr(n):
    return [int(RNG.integers(0, 2 ** 63)) ** 4 % FR.modulus for _ in range(n)]


def oracle_compress(l, r):
    o = OraclePoseidonSponge(CFG)
    o.absorb_field_elements([l, r])
    return o.squeeze_native_field_elements(1)[0]


def test_compress_pairs_matches_oracle():
    B = 8
    ls, rs = rand_fr(B), rand_fr(B)
    left = jnp.asarray(FR.ints_to_mont_plane(ls))
    right = jnp.asarray(FR.ints_to_mont_plane(rs))
    out = compress_pairs(CFG, left, right)
    got = FR.mont_plane_to_ints(np.asarray(out))
    assert got == [oracle_compress(l, r) for l, r in zip(ls, rs)]


@pytest.mark.parametrize("k,n", [(1, 1), (2, 1), (3, 2), (5, 2), (7, 1)])
def test_hash_elements_matches_oracle(k, n):
    B = 4
    grid = [rand_fr(B) for _ in range(k)]
    elems = jnp.asarray(
        np.stack([FR.ints_to_mont_plane(row) for row in grid], axis=0)
    )
    out = hash_elements(CFG, elems, num_outputs=n)
    for b in range(B):
        o = OraclePoseidonSponge(CFG)
        o.absorb_field_elements([grid[i][b] for i in range(k)])
        want = o.squeeze_native_field_elements(n)
        got = [FR.mont_limbs_to_int(np.asarray(out)[j, :, b]) for j in range(n)]
        assert got == want, (k, n, b)


def test_merkle_root_matches_oracle():
    N = 16
    vals = rand_fr(N)
    leaves = jnp.asarray(FR.ints_to_mont_plane(vals))
    root = merkle_root(CFG, leaves)

    level = list(vals)
    while len(level) > 1:
        level = [
            oracle_compress(level[i], level[i + 1]) for i in range(0, len(level), 2)
        ]
    assert FR.mont_limbs_to_int(np.asarray(root)) == level[0]


def test_sharded_merkle_matches_single_device():
    mesh = make_mesh(8)
    N = 128
    vals = rand_fr(N)
    leaves = jnp.asarray(FR.ints_to_mont_plane(vals))
    root_single = merkle_root(CFG, leaves)
    root_sharded = sharded_merkle_root(CFG, leaves, mesh)
    assert FR.mont_limbs_to_int(np.asarray(root_sharded)) == FR.mont_limbs_to_int(
        np.asarray(root_single)
    )


def test_sharded_permute_matches_local():
    mesh = make_mesh(8)
    B = 32
    vals = [rand_fr(B) for _ in range(CFG.t)]
    plane = np.stack([FR.ints_to_mont_plane(row) for row in vals], axis=0)
    state = jax.device_put(jnp.asarray(plane), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, None, "data")))
    out_sharded = np.asarray(sharded_permute_fn(CFG, mesh)(state))
    out_local = np.asarray(permute_jit(CFG)(jnp.asarray(plane)))
    assert np.array_equal(out_sharded, out_local)


def test_fixture_golden_consistency():
    """The transcribed tests.rs fixture drives the oracle sponge and a device
    compress identically (cross-tier agreement on a second parameter set)."""
    cfg = poseidon_test_fixture()
    assert (cfg.alpha, cfg.full_rounds, cfg.partial_rounds) == (17, 8, 29)
    l, r = rand_fr(2)
    o = OraclePoseidonSponge(cfg)
    o.absorb_field_elements([l, r])
    want = o.squeeze_native_field_elements(1)[0]
    left = jnp.asarray(FR.ints_to_mont_plane([l] * 8))
    right = jnp.asarray(FR.ints_to_mont_plane([r] * 8))
    out = compress_pairs(cfg, left, right)
    assert FR.mont_plane_to_ints(np.asarray(out)) == [want] * 8


def test_merkle_chunked_matches_unchunked():
    """The fixed-shape chunking path (wide levels sliced, narrow levels padded)
    must not change the root."""
    N = 64
    vals = rand_fr(N)
    leaves = jnp.asarray(FR.ints_to_mont_plane(vals))
    r1 = merkle_root(CFG, leaves)
    r2 = merkle_root(CFG, leaves, chunk=8)
    assert np.array_equal(np.asarray(r1), np.asarray(r2))


def test_merkle_open_verify():
    """Authentication paths verify against the root and reject tampering."""
    from sponge_jax.hash import merkle_open, merkle_tree, merkle_verify

    N = 16
    vals = rand_fr(N)
    leaves = jnp.asarray(FR.ints_to_mont_plane(vals))
    levels = merkle_tree(CFG, leaves)
    root = levels[-1][:, 0]
    assert FR.mont_limbs_to_int(np.asarray(root)) == FR.mont_limbs_to_int(
        np.asarray(merkle_root(CFG, leaves))
    )
    for idx in (0, 7, 15):
        path = merkle_open(levels, idx)
        assert merkle_verify(CFG, root, leaves[:, idx], path, idx)
        # wrong index fails
        assert not merkle_verify(CFG, root, leaves[:, idx], path, idx ^ 1)
    # tampered leaf fails
    bad = jnp.asarray(FR.ints_to_mont_plane([vals[3] + 1]))[:, 0]
    assert not merkle_verify(CFG, root, bad, merkle_open(levels, 3), 3)


def test_hash_elements_long_squeeze():
    """num_outputs > rate goes through multi-chunk squeezes."""
    from sponge_jax.hash import hash_elements

    B = 2
    grid = [rand_fr(B) for _ in range(3)]
    elems = jnp.asarray(
        np.stack([FR.ints_to_mont_plane(row) for row in grid], axis=0)
    )
    out = np.asarray(hash_elements(CFG, elems, num_outputs=5))
    for b in range(B):
        o = OraclePoseidonSponge(CFG)
        o.absorb_field_elements([grid[i][b] for i in range(3)])
        want = o.squeeze_native_field_elements(5)
        got = [FR.mont_limbs_to_int(out[j, :, b]) for j in range(5)]
        assert got == want


def test_merkle_open_verify_batch():
    """Batched open/verify in one fused program each == scalar path helpers,
    with tamper and wrong-index rejection."""
    from sponge_jax.hash import (
        merkle_open,
        merkle_open_batch,
        merkle_tree,
        merkle_verify,
        merkle_verify_batch,
    )

    N = 64
    vals = rand_fr(N)
    leaves = jnp.asarray(FR.ints_to_mont_plane(vals))
    levels = merkle_tree(CFG, leaves)
    root = levels[-1][:, 0]

    indices = [0, 1, 5, 31, 32, 62, 63]
    paths = merkle_open_batch(levels, indices)
    assert paths.shape == (6, FR.nlimbs, len(indices))

    # Batch gather == scalar opens.
    for k, idx in enumerate(indices):
        scalar_path = merkle_open(levels, idx)
        for d in range(6):
            assert np.array_equal(np.asarray(paths[d, :, k]), np.asarray(scalar_path[d]))

    batch_leaves = jnp.take(leaves, jnp.asarray(indices), axis=1)
    ok = np.asarray(merkle_verify_batch(CFG, root, batch_leaves, paths, indices))
    assert ok.tolist() == [True] * len(indices)

    # Tampered sibling at one lane fails only that lane.
    bad = np.asarray(paths).copy()
    bad[2, 0, 3] = (bad[2, 0, 3] + 1) % (1 << 12)
    ok = np.asarray(
        merkle_verify_batch(CFG, root, batch_leaves, jnp.asarray(bad), indices)
    )
    assert ok.tolist() == [True, True, True, False, True, True, True]

    # Wrong index (direction flip) fails.
    wrong = list(indices)
    wrong[0] = 1
    ok = np.asarray(merkle_verify_batch(CFG, root, batch_leaves, paths, wrong))
    assert not ok[0]

    # Out-of-range index raises.
    with pytest.raises(IndexError):
        merkle_open_batch(levels, [N])
    with pytest.raises(IndexError):
        merkle_verify_batch(CFG, root, batch_leaves, paths, [1 << 6])

    # Scalar wrapper (one fused program) still agrees.
    assert merkle_verify(CFG, root, leaves[:, 5], merkle_open(levels, 5), 5)
    assert not merkle_verify(CFG, root, leaves[:, 5], merkle_open(levels, 5), 4)


def test_jive_compression_vs_oracle():
    """Jive_2 (ePrint 2022/840 §4): digest = feed-forward sum of inputs and
    permuted outputs over the two blocks — checked against a python-int
    replay of the oracle permutation, for Anemoi t=2 (the paper's width),
    Griffin t=8 over Goldilocks (d=4 wide digests), and Poseidon2 t=2 (the
    fastest 255-bit 2-to-1 compressor, BENCHMARKS.md)."""
    from sponge_jax import (
        GOLDILOCKS_FR,
        get_default_anemoi_parameters,
        get_default_griffin_parameters,
    )
    from sponge_jax.hash import jive_compress_pairs, merkle_root_jive
    from sponge_jax.poseidon2 import generate_poseidon2_parameters

    rng = np.random.default_rng(44)
    for cfg in (
        get_default_anemoi_parameters(BLS12_381_FR, 1),
        get_default_griffin_parameters(GOLDILOCKS_FR, 4),
        # the Poseidon2 paper's t=2 255-bit instance (alpha=5, R_F=8, R_P=56)
        generate_poseidon2_parameters(BLS12_381_FR, 1, 5, 8, 56),
    ):
        fs = cfg.field
        d = cfg.t // 2
        B = 4
        lvals = [[int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=B)]
                 for _ in range(d)]
        rvals = [[int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=B)]
                 for _ in range(d)]
        left = jnp.asarray(np.stack([fs.ints_to_mont_plane(r) for r in lvals]))
        right = jnp.asarray(np.stack([fs.ints_to_mont_plane(r) for r in rvals]))
        out = np.asarray(jive_compress_pairs(cfg, left, right))
        for b in range(B):
            o = cfg.oracle_sponge()
            x = [lvals[j][b] for j in range(d)] + [rvals[j][b] for j in range(d)]
            o.state = list(x)
            o.permute()
            for j in range(d):
                want = (x[j] + x[d + j] + o.state[j] + o.state[d + j]) % fs.modulus
                got = fs.mont_plane_to_ints(out[j][:, b : b + 1])[0]
                assert got == want, (cfg.field.name, b, j)
        # output honors the framework-wide < 2p invariant
        for j in range(d):
            raw = [fs.limbs_to_int(out[j][:, b]) for b in range(B)]
            assert all(v < 2 * fs.modulus for v in raw)

    # d mismatch is rejected
    cfg = get_default_anemoi_parameters(BLS12_381_FR, 1)
    with pytest.raises(ValueError, match="t = 2"):
        jive_compress_pairs(
            cfg,
            jnp.zeros((2, cfg.field.nlimbs, 4), dtype=jnp.int32),
            jnp.zeros((2, cfg.field.nlimbs, 4), dtype=jnp.int32),
        )

    # Jive-mode Merkle root == sequential host reduction with the same rule
    cfg = get_default_anemoi_parameters(BLS12_381_FR, 1)
    fs = cfg.field
    N = 8
    leaf_ints = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=N)]
    leaves = jnp.asarray(fs.ints_to_mont_plane(leaf_ints))[None]  # (1, L, N)
    root = np.asarray(merkle_root_jive(cfg, leaves))
    cur = list(leaf_ints)
    while len(cur) > 1:
        nxt = []
        for i in range(0, len(cur), 2):
            o = cfg.oracle_sponge()
            o.state = [cur[i], cur[i + 1]]
            o.permute()
            nxt.append((cur[i] + cur[i + 1] + o.state[0] + o.state[1]) % fs.modulus)
        cur = nxt
    assert fs.mont_plane_to_ints(root[0][:, None])[0] == cur[0]


def test_jive_merkle_open_verify_batch():
    """Jive-mode Merkle proofs: merkle_tree_jive levels + the
    compression-agnostic merkle_open_batch_wide + merkle_verify_batch_jive
    accept genuine proofs and flag tampered leaves, paths, and indices —
    and the sponge-mode verifier rejects Jive proofs (the two compressions
    are distinct functions of the same tree inputs).

    Config: Griffin Goldilocks rate-4 (t = 8, d = 4) — a 64-bit inverse
    ladder keeps the depth-4 fused verify program small enough for the CPU
    CI compile; the t = 2 Anemoi Jive width is covered by
    ``test_jive_compression_vs_oracle``."""
    from sponge_jax import GOLDILOCKS_FR, get_default_griffin_parameters
    from sponge_jax.hash import (
        merkle_open_batch_wide,
        merkle_root_jive,
        merkle_tree_jive,
        merkle_verify_batch_jive,
        merkle_verify_batch_wide,
    )

    cfg = get_default_griffin_parameters(GOLDILOCKS_FR, 4)  # t = 8, d = 4
    fs = cfg.field
    d = cfg.t // 2
    rng = np.random.default_rng(45)
    N = 16
    grid = [[int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=N)]
            for _ in range(d)]
    leaves = jnp.asarray(
        np.stack([fs.ints_to_mont_plane(row) for row in grid], axis=0)
    )  # (d, L, N)

    levels = merkle_tree_jive(cfg, leaves)
    assert [lvl.shape[-1] for lvl in levels] == [16, 8, 4, 2, 1]
    root = levels[-1][..., 0]
    # tree root == the direct reduction
    assert np.array_equal(np.asarray(root), np.asarray(merkle_root_jive(cfg, leaves)))

    idx = [0, 3, 7, 8, 15, 10]
    paths = merkle_open_batch_wide(levels, idx)
    opened = jnp.take(leaves, jnp.asarray(idx, dtype=jnp.int32), axis=2)

    ok = np.asarray(merkle_verify_batch_jive(cfg, root, opened, paths, idx))
    assert ok.tolist() == [True] * len(idx)

    # tampered leaf fails only that lane
    bad_leaf = opened.at[0, 0, 2].add(1)
    ok = np.asarray(merkle_verify_batch_jive(cfg, root, bad_leaf, paths, idx))
    assert ok.tolist() == [True, True, False, True, True, True]

    # tampered path node fails only that lane
    bad_path = paths.at[1, 0, 0, 4].add(1)
    ok = np.asarray(merkle_verify_batch_jive(cfg, root, opened, bad_path, idx))
    assert ok.tolist() == [True, True, True, True, False, True]

    # wrong index (direction flip) fails
    wrong = list(idx)
    wrong[0] = 1
    ok = np.asarray(merkle_verify_batch_jive(cfg, root, opened, paths, wrong))
    assert not ok[0]
    with pytest.raises(IndexError):
        merkle_verify_batch_jive(cfg, root, opened, paths, [N])

    # the sponge-mode verifier rejects every Jive proof
    ok = np.asarray(merkle_verify_batch_wide(cfg, root, opened, paths, idx))
    assert not ok.any()


def test_sharded_merkle_verify_batch_matches_local():
    """Proof-lane-sharded batched verification (8-device mesh) == the
    single-device merkle_verify_batch, incl. rejecting a tampered lane
    (VERDICT r2 item 6: batched proof verify crossing shard_map)."""
    from sponge_jax.hash import merkle_open_batch, merkle_tree, merkle_verify_batch
    from sponge_jax.parallel import sharded_merkle_verify_batch

    mesh = make_mesh(8)
    N = 64
    vals = rand_fr(N)
    leaves = jnp.asarray(FR.ints_to_mont_plane(vals))
    levels = merkle_tree(CFG, leaves)
    root = levels[-1][:, 0]
    idx = [0, 5, 9, 13, 21, 33, 47, 63, 1, 2, 62, 58, 17, 25, 40, 44]
    paths = merkle_open_batch(levels, idx)
    opened = jnp.take(leaves, jnp.asarray(idx, dtype=jnp.int32), axis=1)

    ok_sharded = np.asarray(
        sharded_merkle_verify_batch(CFG, root, opened, paths, idx, mesh)
    )
    ok_local = np.asarray(merkle_verify_batch(CFG, root, opened, paths, idx))
    assert np.array_equal(ok_sharded, ok_local)
    assert ok_sharded.all()

    # Tamper one lane per device slice: sharded result flags exactly those.
    bad = opened.at[0, 3].add(1)
    ok_bad = np.asarray(
        sharded_merkle_verify_batch(CFG, root, bad, paths, idx, mesh)
    )
    want = np.ones(len(idx), dtype=bool)
    want[3] = False
    assert np.array_equal(ok_bad, want)


def test_sharded_merkle_root_wide_matches_local():
    """Sharded wide-digest Merkle root (d-element digests, 8-device mesh,
    narrow-tail cutover) == single-device merkle_root_wide."""
    from sponge_jax import GOLDILOCKS_FR, get_default_poseidon2_parameters
    from sponge_jax.hash import merkle_root_wide
    from sponge_jax.parallel import sharded_merkle_root_wide

    fs = GOLDILOCKS_FR
    cfg = get_default_poseidon2_parameters(fs, 8)
    d = cfg.capacity
    N = 64
    rng = np.random.default_rng(23)
    grid = [[int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=N)]
            for _ in range(d)]
    leaves = jnp.asarray(
        np.stack([fs.ints_to_mont_plane(row) for row in grid], axis=0)
    )
    mesh = make_mesh(8)
    root_sharded = np.asarray(sharded_merkle_root_wide(cfg, leaves, mesh))
    root_local = np.asarray(merkle_root_wide(cfg, leaves))
    for j in range(d):
        assert fs.mont_limbs_to_int(root_sharded[j]) == fs.mont_limbs_to_int(
            root_local[j]
        )


def test_sharded_merkle_root_jive_matches_local():
    """Sharded Jive-mode Merkle root (8-device mesh, feed-forward compression,
    narrow-tail cutover) == single-device merkle_root_jive."""
    from sponge_jax import GOLDILOCKS_FR, get_default_griffin_parameters
    from sponge_jax.hash import merkle_root_jive
    from sponge_jax.parallel import sharded_merkle_root_jive

    fs = GOLDILOCKS_FR
    cfg = get_default_griffin_parameters(fs, 4)  # t = 8, d = 4
    d = cfg.t // 2
    N = 64
    rng = np.random.default_rng(29)
    grid = [[int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=N)]
            for _ in range(d)]
    leaves = jnp.asarray(
        np.stack([fs.ints_to_mont_plane(row) for row in grid], axis=0)
    )
    mesh = make_mesh(8)
    root_sharded = np.asarray(sharded_merkle_root_jive(cfg, leaves, mesh))
    root_local = np.asarray(merkle_root_jive(cfg, leaves))
    for j in range(d):
        assert fs.mont_limbs_to_int(root_sharded[j]) == fs.mont_limbs_to_int(
            root_local[j]
        )

