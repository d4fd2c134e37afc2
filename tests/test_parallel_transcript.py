"""Multi-chip coverage for the production Fiat–Shamir shape: sharded compiled
transcripts (mode flips + multi-chunk squeezes) and checkpoint/restore across
different mesh sizes — on the 8-virtual-device CPU mesh (conftest)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sponge_jax import BLS12_381_FR, get_default_poseidon_parameters
from sponge_jax.hash import compress_pairs, merkle_root
from sponge_jax.parallel import (
    DATA_AXIS,
    leaf_sharding,
    make_mesh,
    sharded_merkle_root,
    sharded_transcript_fn,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge
from sponge_jax.transcript import Absorb, SqueezeNative, transcript_shape

FR = BLS12_381_FR
CFG = get_default_poseidon_parameters(FR, 2, False)
RNG = np.random.default_rng(97)


def rand_fr(n):
    return [int(RNG.integers(0, 2 ** 63)) ** 4 % FR.modulus for _ in range(n)]


def test_sharded_transcript_matches_oracle():
    """Sharded compiled transcript (8-device mesh, lanes split over devices) ==
    oracle, on a schedule crossing mode flips, rate boundaries, and the
    multi-chunk squeeze quirk path."""
    schedule = [
        Absorb(3),          # crosses the rate-2 boundary (one mid-absorb permute)
        SqueezeNative(2),
        Absorb(1),          # squeeze -> absorb mode flip
        SqueezeNative(5),   # multi-chunk squeeze incl. the no-permute quirk
        SqueezeNative(1),
    ]
    total_a, total_q = transcript_shape(schedule)
    mesh = make_mesh(8)
    B = 16  # 2 lanes per device
    lanes = [rand_fr(total_a) for _ in range(B)]
    grid = np.asarray(lanes, dtype=object).T  # (total_a, B)
    elems = jnp.asarray(
        np.stack([FR.ints_to_mont_plane(row) for row in grid], axis=0)
    )
    fn = sharded_transcript_fn(CFG, schedule, mesh)
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


def test_sharded_transcript_rejects_undersized_plane():
    mesh = make_mesh(8)
    fn = sharded_transcript_fn(CFG, [Absorb(3), SqueezeNative(1)], mesh)
    bad = jnp.zeros((2, FR.nlimbs, 16), dtype=jnp.int32)
    with pytest.raises(ValueError, match="absorbs 3"):
        fn(bad)


def test_merkle_checkpoint_across_mesh_sizes(tmp_path):
    """A Merkle level produced under an 8-device sharded layer checkpoints and
    resumes on a DIFFERENT device count (4-device mesh and single device),
    all agreeing with the never-interrupted single-device root."""
    from sponge_jax.checkpoint import load_merkle_level, save_merkle_level

    N = 64
    vals = rand_fr(N)
    leaves = jnp.asarray(FR.ints_to_mont_plane(vals))
    want_root = FR.mont_limbs_to_int(np.asarray(merkle_root(CFG, leaves)))

    # One sharded tree level on the 8-device mesh (the production wide phase).
    mesh8 = make_mesh(8)

    def local_layer(chunk):
        n = chunk.shape[-1]
        pairs = chunk.reshape(FR.nlimbs, n // 2, 2)
        return compress_pairs(CFG, pairs[..., 0], pairs[..., 1])

    layer = shard_map(
        local_layer, mesh=mesh8, in_specs=P(None, DATA_AXIS), out_specs=P(None, DATA_AXIS)
    )
    level = layer(jax.device_put(leaves, leaf_sharding(mesh8)))

    path = tmp_path / "level.npz"
    save_merkle_level(path, CFG, np.asarray(level), depth=1)  # gathers the shards

    plane, depth = load_merkle_level(path, CFG)
    assert depth == 1 and plane.shape == (FR.nlimbs, N // 2)

    # Resume on a 4-device mesh...
    root4 = sharded_merkle_root(CFG, jnp.asarray(plane), make_mesh(4))
    assert FR.mont_limbs_to_int(np.asarray(root4)) == want_root
    # ...and on a single device.
    root1 = merkle_root(CFG, jnp.asarray(plane))
    assert FR.mont_limbs_to_int(np.asarray(root1)) == want_root
