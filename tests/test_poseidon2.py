"""Poseidon2 permutation family: oracle / XLA tier / Pallas kernel parity and
sponge integration.

The Poseidon2 capability is ADDITIVE (the reference crate has no Poseidon2),
so the scalar python-int oracle is the ground truth: the device tiers must
match it bit-for-bit, and the duplex machinery shared with Poseidon
(/root/reference/src/poseidon/mod.rs:121-182) must behave identically when
driven by a Poseidon2Config.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from conftest import TINY_FR, tiny_poseidon2_config
from sponge_jax import (
    BLS12_381_FR,
    OraclePoseidon2Sponge,
    Poseidon2Config,
    PoseidonSponge,
    generate_poseidon2_parameters,
    get_default_poseidon2_parameters,
)
from sponge_jax.poseidon2.params import external_matrix, internal_diag
from sponge_jax.poseidon2.permutation import poseidon2_permute_jit


def rand_ints(fs, n, seed=20260817):
    rng = np.random.default_rng(seed)
    return [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=n)]


# ---------------------------------------------------------------------------
# Parameter generation
# ---------------------------------------------------------------------------


def test_external_matrix_shapes():
    assert external_matrix(2) == ((2, 1), (1, 2))
    assert external_matrix(3) == ((2, 1, 1), (1, 2, 1), (1, 1, 2))
    m4 = external_matrix(4)
    assert m4[0] == (5, 7, 1, 3)
    m8 = external_matrix(8)
    # Block circulant: diagonal blocks 2*M4, off-diagonal M4.
    assert m8[0][:4] == (10, 14, 2, 6) and m8[0][4:] == (5, 7, 1, 3)
    assert m8[4][:4] == (5, 7, 1, 3) and m8[4][4:] == (10, 14, 2, 6)
    with pytest.raises(ValueError):
        external_matrix(5)


def test_fixed_small_diagonals():
    assert internal_diag(2, TINY_FR, None) == (2, 3)
    assert internal_diag(3, TINY_FR, None) == (2, 2, 3)


def test_generation_is_deterministic():
    a = generate_poseidon2_parameters(TINY_FR, 2, 5, 4, 8)
    b = generate_poseidon2_parameters(TINY_FR, 2, 5, 4, 8)
    assert a == b
    assert len(a.external_rc) == 4 and len(a.internal_rc) == 8


def test_default_parameters_bls():
    cfg = get_default_poseidon2_parameters(BLS12_381_FR, 2)
    assert cfg.alpha == 17 and cfg.full_rounds == 8 and cfg.partial_rounds == 31
    assert cfg.mat_e == ((2, 1, 1), (1, 2, 1), (1, 1, 2))
    assert cfg.mat_i_diag == (2, 2, 3)


def test_config_validation():
    cfg = tiny_poseidon2_config()
    with pytest.raises(ValueError):
        Poseidon2Config(
            field=TINY_FR,
            full_rounds=5,  # odd
            partial_rounds=3,
            alpha=5,
            external_rc=cfg.external_rc[:5],
            internal_rc=cfg.internal_rc[:3],
            mat_e=cfg.mat_e,
            mat_i_diag=cfg.mat_i_diag,
            rate=2,
        )


# ---------------------------------------------------------------------------
# Golden regression: self-generated instance, frozen squeeze values.
# ---------------------------------------------------------------------------


def test_oracle_golden_regression_tiny():
    """Frozen end-to-end vector for the tiny-field instance: any change to
    constant derivation, matrices, or the round schedule shows up here."""
    s = OraclePoseidon2Sponge(tiny_poseidon2_config())
    s.absorb_field_elements([0, 1, 2])
    got = s.squeeze_native_field_elements(3)
    assert got == [2041425071, 11606794380, 33819483313]


# ---------------------------------------------------------------------------
# XLA tier vs oracle
# ---------------------------------------------------------------------------


def _xla_vs_oracle(cfg, B=8):
    fs = cfg.field
    vals = [rand_ints(fs, B, seed=7 + cfg.t) for _ in range(cfg.t)]
    state = jnp.asarray(
        np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
    )
    out = np.asarray(poseidon2_permute_jit(cfg)(state))
    for b in range(B):
        o = OraclePoseidon2Sponge(cfg)
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        got = [fs.mont_plane_to_ints(out[i][:, b : b + 1])[0] for i in range(cfg.t)]
        assert got == o.state, b


def test_xla_tier_tiny_t3():
    _xla_vs_oracle(tiny_poseidon2_config())


def test_xla_tier_tiny_t4_montgomery_diag():
    """t=4 samples a full-range Grain diagonal — the Montgomery-diagonal path."""
    cfg = tiny_poseidon2_config(rate=3, alpha=5, full_rounds=4, partial_rounds=6)
    assert any((d - 1) % TINY_FR.modulus >= 16 for d in cfg.mat_i_diag)
    _xla_vs_oracle(cfg)


def test_xla_tier_tiny_t8_block_circulant():
    cfg = tiny_poseidon2_config(rate=7, alpha=5, full_rounds=4, partial_rounds=4)
    _xla_vs_oracle(cfg)


def test_xla_tier_bls_default():
    _xla_vs_oracle(get_default_poseidon2_parameters(BLS12_381_FR, 2))


# ---------------------------------------------------------------------------
# XLA tier over the tiny field: the shapes a fused kernel would have to
# cover (deep internal chains into the rho-folding regime, alpha = 17, the
# Montgomery-form diagonal at t = 4).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        dict(partial_rounds=8),
        dict(rate=2, alpha=17, full_rounds=4, partial_rounds=8),
        dict(rate=3, alpha=5, full_rounds=4, partial_rounds=6),
    ],
    ids=["small-diag-rp8", "alpha17", "montgomery-diag"],
)
def test_xla_tier_tiny_configs(kw):
    from conftest import check_permutation_vs_oracle

    check_permutation_vs_oracle(tiny_poseidon2_config(**kw), B=128, stride=29)


# ---------------------------------------------------------------------------
# Duplex sponge integration (shared machinery driven by a Poseidon2Config)
# ---------------------------------------------------------------------------


def test_batched_sponge_matches_oracle():
    cfg = tiny_poseidon2_config()
    B = 4
    dev = PoseidonSponge(cfg, batch_size=B)
    oracles = [OraclePoseidon2Sponge(cfg) for _ in range(B)]

    from sponge_jax import Batched, Fp

    lanes = [[i + 1, 7 * i + 2, 3] for i in range(B)]
    dev.absorb(Batched(lanes=[[Fp(v, TINY_FR) for v in lane] for lane in lanes]))
    for o, lane in zip(oracles, lanes):
        o.absorb_field_elements(lane)
    got = dev.squeeze_native_field_elements(4)
    for b in range(B):
        assert got[b] == oracles[b].squeeze_native_field_elements(4)
    # Mode flip back to absorbing, then squeeze bytes.
    dev.absorb(Batched(lanes=[[Fp(b, TINY_FR)] for b in range(B)]))
    for b, o in enumerate(oracles):
        o.absorb_field_elements([b])
    got_bytes = dev.squeeze_bytes(9)
    for b in range(B):
        assert got_bytes[b] == bytes(oracles[b].squeeze_bytes(9))


def test_oracle_fork_clone_subclass_safe():
    cfg = tiny_poseidon2_config()
    s = OraclePoseidon2Sponge(cfg)
    s.absorb_field_elements([5, 6])
    f = s.fork(b"domain")
    assert isinstance(f, OraclePoseidon2Sponge)
    # Forked sponge diverges from the original.
    assert f.squeeze_native_field_elements(1) != s.squeeze_native_field_elements(1)


def test_sponge_state_roundtrip():
    cfg = tiny_poseidon2_config()
    s = OraclePoseidon2Sponge(cfg)
    s.absorb_field_elements([9, 8, 7])
    st = s.into_state()
    r = OraclePoseidon2Sponge.from_state(st, cfg)
    assert r.squeeze_native_field_elements(2) == s.squeeze_native_field_elements(2)


# ---------------------------------------------------------------------------
# Shared-machinery integration: transcripts, Merkle, lazy sponge, checkpoints
# all run on a Poseidon2Config through the config-dispatch hook.
# ---------------------------------------------------------------------------


def test_compiled_transcript_poseidon2():
    import jax.numpy as jnp

    from sponge_jax.transcript import Absorb, SqueezeNative, compile_transcript

    cfg = tiny_poseidon2_config()
    fs = cfg.field
    steps = [Absorb(3), SqueezeNative(2), Absorb(1), SqueezeNative(1)]
    B = 4
    vals = [rand_ints(fs, B, seed=42 + k) for k in range(4)]
    plane = jnp.asarray(
        np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
    )
    out = np.asarray(compile_transcript(cfg, steps)(plane))  # (3, L, B)
    for b in range(B):
        o = OraclePoseidon2Sponge(cfg)
        o.absorb_field_elements([vals[0][b], vals[1][b], vals[2][b]])
        want = o.squeeze_native_field_elements(2)
        o.absorb_field_elements([vals[3][b]])
        want += o.squeeze_native_field_elements(1)
        got = [fs.limbs_to_int(out[k][:, b]) for k in range(3)]
        assert got == want, b


def test_merkle_root_poseidon2():
    import jax.numpy as jnp

    from sponge_jax.hash import merkle_root

    cfg = tiny_poseidon2_config()
    fs = cfg.field
    N = 8
    leaves_int = rand_ints(fs, N, seed=77)
    leaves = jnp.asarray(fs.ints_to_mont_plane(leaves_int))
    # merkle levels stay in Montgomery form (compress_pairs returns the raw
    # permuted rate element).
    root = fs.mont_limbs_to_int(np.asarray(merkle_root(cfg, leaves)))

    # Host re-computation through the oracle-checked compress (2-to-1 = one
    # duplex absorb of [l, r] + squeeze 1, matching hash.compress_pairs).
    def compress2(l, r):
        o = OraclePoseidon2Sponge(cfg)
        o.absorb_field_elements([l, r])
        return o.squeeze_native_field_elements(1)[0]

    lvl = leaves_int
    while len(lvl) > 1:
        lvl = [compress2(lvl[i], lvl[i + 1]) for i in range(0, len(lvl), 2)]
    assert root == lvl[0]


def test_lazy_sponge_poseidon2():
    from sponge_jax import LazyPoseidonSponge

    cfg = tiny_poseidon2_config()
    B = 3
    lazy = LazyPoseidonSponge(cfg, batch_size=B)
    oracles = [OraclePoseidon2Sponge(cfg) for _ in range(B)]
    lanes = [[b + 1, 5 * b + 2] for b in range(B)]
    from sponge_jax import Batched, Fp

    lazy.absorb(Batched(lanes=[[Fp(v, TINY_FR) for v in lane] for lane in lanes]))
    for o, lane in zip(oracles, lanes):
        o.absorb_field_elements(lane)
    got = lazy.squeeze_native_field_elements(3)
    for b in range(B):
        assert got[b] == oracles[b].squeeze_native_field_elements(3), b


def test_checkpoint_roundtrip_poseidon2(tmp_path):
    from sponge_jax import Batched, Fp
    from sponge_jax.checkpoint import load_sponge, save_sponge

    cfg = tiny_poseidon2_config()
    s = PoseidonSponge(cfg, batch_size=2)
    s.absorb(Batched(lanes=[[Fp(4, TINY_FR)], [Fp(9, TINY_FR)]]))
    path = tmp_path / "p2_ckpt.npz"
    save_sponge(path, s)
    r = load_sponge(path, cfg)
    assert r.squeeze_native_field_elements(2) == s.squeeze_native_field_elements(2)
    # A Poseidon config with the same geometry must NOT validate (fingerprint
    # includes the config kind and all constant tables).
    from conftest import tiny_poseidon_config

    with pytest.raises(ValueError):
        load_sponge(path, tiny_poseidon_config())


def test_oracle_golden_regression_bls():
    """Frozen end-to-end vector for the production BLS12-381 rate-2 instance
    (self-generated deterministic parameters; freezing makes any change to the
    Grain-derivation order, matrices, or schedule loud)."""
    s = OraclePoseidon2Sponge(get_default_poseidon2_parameters(BLS12_381_FR, 2))
    s.absorb_field_elements([0, 1, 2])
    assert s.squeeze_native_field_elements(3) == [
        52083961829638530329803873513984423317950149524710559639711710544245016843101,
        46550625866894159897150880606355238520431023163927606006962896442099973167881,
        42226209967555737499361210161376034319861506751659560949906643713058884560743,
    ]


def test_default_parameters_other_fields():
    """BN254 / BLS12-377 default tables also drive Poseidon2 generation."""
    from sponge_jax import BLS12_377_FR, BN254_FR

    for fs in (BN254_FR, BLS12_377_FR):
        cfg = get_default_poseidon2_parameters(fs, 2)
        assert cfg.t == 3 and cfg.mat_i_diag == (2, 2, 3)


def test_minimum_headroom_wide_state_matches_oracle():
    """The hardest value-growth case for the XLA tier: a minimum-headroom
    field (44-bit prime, R/p ~ 16) at t = 8, where the external row sums
    exceed R within one round.  The rho-folding discipline must stay exact
    (an earlier design raised here; the folding one must simply be right)."""
    from sponge_jax.fields import FieldSpec

    low_headroom = FieldSpec(
        name="low_headroom_44", modulus=(1 << 44) - 17, generator=3
    )
    cfg = generate_poseidon2_parameters(low_headroom, 7, 5, 4, 4)  # t=8
    _xla_vs_oracle(cfg)
