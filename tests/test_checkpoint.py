"""Durable checkpoint/resume: sponge mid-protocol and Merkle mid-tree."""

import numpy as np
import pytest

import jax.numpy as jnp

from sponge_jax import BLS12_381_FR, Fp, PoseidonSponge, get_default_poseidon_parameters
from sponge_jax.checkpoint import (
    load_merkle_level,
    load_sponge,
    save_merkle_level,
    save_sponge,
)
from sponge_jax.hash import merkle_root

FR = BLS12_381_FR
CFG = get_default_poseidon_parameters(FR, 2, False)
RNG = np.random.default_rng(71)


def rand_fr(n):
    return [int(RNG.integers(0, 2 ** 63)) ** 4 % FR.modulus for _ in range(n)]


def test_sponge_checkpoint_roundtrip(tmp_path):
    s = PoseidonSponge(CFG, batch_size=2)
    s.absorb([Fp(v, FR) for v in rand_fr(3)])
    s.squeeze_native_field_elements(1)
    path = tmp_path / "sponge.npz"
    save_sponge(path, s)
    resumed = load_sponge(path, CFG)
    assert resumed.squeeze_native_field_elements(2) == s.squeeze_native_field_elements(2)


def test_sponge_checkpoint_config_mismatch(tmp_path):
    s = PoseidonSponge(CFG, batch_size=1)
    s.absorb([Fp(1, FR)])
    path = tmp_path / "sponge.npz"
    save_sponge(path, s)
    other = get_default_poseidon_parameters(FR, 3, False)
    with pytest.raises(ValueError):
        load_sponge(path, other)


def test_merkle_level_checkpoint_resume(tmp_path):
    vals = rand_fr(16)
    leaves = jnp.asarray(FR.ints_to_mont_plane(vals))
    full_root = merkle_root(CFG, leaves)

    # Run two levels, checkpoint, "crash", resume from the snapshot.
    from sponge_jax.hash import compress_pairs

    level = leaves
    for depth in range(2):
        pairs = level.reshape(FR.nlimbs, level.shape[-1] // 2, 2)
        level = compress_pairs(CFG, pairs[..., 0], pairs[..., 1])
    path = tmp_path / "level.npz"
    save_merkle_level(path, CFG, np.asarray(level), depth=2)

    plane, depth = load_merkle_level(path, CFG)
    assert depth == 2 and plane.shape == (FR.nlimbs, 4)
    resumed_root = merkle_root(CFG, jnp.asarray(plane))
    assert FR.mont_limbs_to_int(np.asarray(resumed_root)) == FR.mont_limbs_to_int(
        np.asarray(full_root)
    )


def test_sponge_checkpoint_table_tamper_detected(tmp_path):
    """Configs sharing geometry but differing anywhere in ark/mds must not
    validate against each other's checkpoints (full-table fingerprint)."""
    s = PoseidonSponge(CFG, batch_size=1)
    s.absorb([Fp(1, FR)])
    path = tmp_path / "sponge.npz"
    save_sponge(path, s)
    ark = [list(row) for row in CFG.ark]
    ark[-1][-1] = (ark[-1][-1] + 1) % FR.modulus  # NOT the sampled corner
    tampered = type(CFG)(
        field=CFG.field,
        full_rounds=CFG.full_rounds,
        partial_rounds=CFG.partial_rounds,
        alpha=CFG.alpha,
        ark=tuple(tuple(r) for r in ark),
        mds=CFG.mds,
        rate=CFG.rate,
        capacity=CFG.capacity,
    )
    with pytest.raises(ValueError):
        load_sponge(path, tampered)


def test_sponge_checkpoint_wide_value_no_truncation(tmp_path):
    """Decimal width is sized from the modulus (77 digits here) — a state value
    longer than the old fixed U100... is impossible for shipped fields, so
    instead assert the stored width covers the modulus exactly."""
    s = PoseidonSponge(CFG, batch_size=1)
    big = FR.modulus - 1  # 77 decimal digits
    s.absorb([Fp(big, FR)])
    path = tmp_path / "sponge.npz"
    save_sponge(path, s)
    resumed = load_sponge(path, CFG)
    assert resumed.into_state().state == s.into_state().state
