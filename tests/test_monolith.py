"""Monolith family (ePrint 2023/1025 structure): Bars/Bricks/Concrete over
the bar-safe fields (Goldilocks, Mersenne31, KoalaBear, BabyBear), behind
the shared duplex machinery.  The scalar oracle is the ground truth; golden
vectors below freeze the self-consistent default instances."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from sponge_jax import (
    BABYBEAR_FR,
    GOLDILOCKS_FR as GL,
    KOALABEAR_FR as KB,
    MERSENNE31_FR as M31,
)
from sponge_jax.fields import FieldSpec
from sponge_jax.monolith import (
    MonolithConfig,
    OracleMonolithSponge,
    bar_chunks,
    bar_int,
    chunk_sbox,
    generate_monolith_parameters,
    get_default_monolith_parameters,
    monolith_permute_jit,
)
from sponge_jax.monolith.config import check_bar_field

CFG_GL = get_default_monolith_parameters(GL)
CFG_M31 = get_default_monolith_parameters(M31)
CFG_KB = get_default_monolith_parameters(KB)
CFG_BB = get_default_monolith_parameters(BABYBEAR_FR)


def rand_elems(fs, n, seed=5):
    rng = np.random.default_rng(seed)
    return [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=n)]


# ---------------------------------------------------------------------------
# Bars: S-box and range-preservation properties.
# ---------------------------------------------------------------------------


def test_chunk_sbox_bijective_with_fixed_points():
    for k in (4, 5, 7, 8):
        table = [chunk_sbox(y, k) for y in range(1 << k)]
        assert len(set(table)) == 1 << k, k
        assert table[0] == 0 and table[-1] == (1 << k) - 1, k


def test_bar_chunks_geometry():
    assert bar_chunks(GL) == (8,) * 8
    assert bar_chunks(M31) == (8, 8, 8, 7)
    assert bar_chunks(KB) == (8, 8, 8, 7)
    # BabyBear's m = 27 is not byte-aligned: the top byte splits at the
    # boundary the range-preservation lemma needs (8 + 8 + 8 + 3 | 4).
    assert bar_chunks(BABYBEAR_FR) == (8, 8, 8, 3, 4)


def test_bar_safety_gate():
    for fs in (GL, M31, KB, BABYBEAR_FR):
        check_bar_field(fs)
    # A generic prime (d = 2^n + 1 - p not a power of two) is rejected.
    from sponge_jax import BLS12_381_FR

    with pytest.raises(ValueError, match="not a power of two"):
        check_bar_field(BLS12_381_FR)


def test_bar_range_preserving_exhaustive_tiny_field():
    """p = 2^13 - 1 (chunks 8, 5): bar maps [0, p) onto [0, p), exhaustively."""
    fs = FieldSpec(name="tiny_m13", modulus=(1 << 13) - 1, generator=17)
    check_bar_field(fs)
    imgs = {bar_int(fs, x) for x in range(fs.modulus)}
    assert imgs == set(range(fs.modulus))


def test_bar_range_preserving_exhaustive_split_chunk():
    """p = 2^13 - 2^9 + 1 = 7681 (the classic NTT prime): m = 9 is not
    byte-aligned, so the chunks split at it (8, 1, 4) — the BabyBear
    mechanism, exhaustively verified on a field small enough to enumerate."""
    fs = FieldSpec(name="tiny_7681", modulus=7681, generator=17)
    assert bar_chunks(fs) == (8, 1, 4)
    check_bar_field(fs)
    imgs = {bar_int(fs, x) for x in range(fs.modulus)}
    assert imgs == set(range(fs.modulus))


def test_bar_edge_values():
    for fs in (GL, M31, KB, BABYBEAR_FR):
        assert bar_int(fs, 0) == 0
        assert 0 <= bar_int(fs, fs.modulus - 1) < fs.modulus
        # Goldilocks: 2^64 - 2^32 (top 32 bits ones, low 32 zero) is the
        # boundary canonical value; its bar must stay canonical.
        x = fs.modulus - 1
        assert 0 <= bar_int(fs, bar_int(fs, x)) < fs.modulus


# ---------------------------------------------------------------------------
# Config validation + default geometries.
# ---------------------------------------------------------------------------


def test_default_geometries():
    assert (CFG_GL.t, CFG_GL.bars, CFG_GL.rounds) == (12, 4, 6)
    assert (CFG_M31.t, CFG_M31.bars, CFG_M31.rounds) == (16, 8, 6)
    assert (CFG_KB.t, CFG_KB.bars, CFG_KB.rounds) == (16, 8, 6)
    assert (CFG_BB.t, CFG_BB.bars, CFG_BB.rounds) == (16, 8, 6)
    assert CFG_GL.pow2_circulant_exponents() is not None  # pow2 circulant
    assert CFG_M31.pow2_circulant_exponents() is None  # small-int circulant
    # all defaults take the multiplication-free scaled device path
    for c in (CFG_GL, CFG_M31, CFG_KB, CFG_BB):
        assert c.concrete_small_entries() is not None
    with pytest.raises(ValueError, match="no default"):
        get_default_monolith_parameters(GL, rate=2)


def test_config_validation():
    with pytest.raises(ValueError, match="last rc row"):
        MonolithConfig(
            field=M31,
            rounds=2,
            bars=2,
            rc=((1,) * 4, (1,) * 4),
            concrete=((1,) * 4,) * 4,
            rate=2,
            capacity=2,
        )
    with pytest.raises(ValueError, match="bars must be"):
        generate_monolith_parameters(M31, 2, 2, bars=5)


def test_default_concrete_matrices():
    """Goldilocks: the MDS-verified pow2 circulant; 31-bit fields: the
    MDS-verified small-integer circulant (tools/check_mds.cc, seed 20230825)
    — invertible over each field, circulant-shaped, entries <= 31."""
    from sponge_jax.poseidon2.params import _det_mod_p

    row = (31, 19, 21, 11, 5, 7, 9, 26, 9, 16, 23, 13, 30, 30, 17, 5)
    for cfg in (CFG_M31, CFG_KB, CFG_BB):
        assert cfg.concrete[0] == row
        t = cfg.t
        for i in range(t):
            for j in range(t):
                assert cfg.concrete[i][j] == row[(j - i) % t]
        assert _det_mod_p([list(r) for r in cfg.concrete], cfg.field.modulus) != 0

    # non-default geometry falls back to the provably-MDS Cauchy draw
    cfg = generate_monolith_parameters(M31, rate=2, capacity=2, rounds=6, bars=2)
    assert cfg.concrete_small_entries() is None
    assert _det_mod_p([list(r) for r in cfg.concrete], M31.modulus) != 0


# ---------------------------------------------------------------------------
# Frozen golden vectors (pin the self-consistent default instances).
# ---------------------------------------------------------------------------


def test_oracle_golden_regression():
    expect = {
        "goldilocks_fr": [
            5256865702680375205,
            16889867171626752680,
            17825305887195455664,
        ],
        "mersenne31_fr": [1207749644, 841790736, 175126303],
        "koalabear_fr": [935778397, 727696613, 565866719],
        "babybear_fr": [1869215551, 585220566, 752895513],
    }
    for cfg in (CFG_GL, CFG_M31, CFG_KB, CFG_BB):
        s = OracleMonolithSponge(cfg)
        s.absorb_field_elements(list(range(8)))
        assert s.squeeze_native_field_elements(3) == expect[cfg.field.name]


# ---------------------------------------------------------------------------
# Device tier vs oracle (both Concrete paths) + duplex sponge integration.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "cfg", [CFG_GL, CFG_M31, CFG_KB, CFG_BB], ids=lambda c: c.field.name
)
def test_xla_tier_vs_oracle(cfg):
    fs = cfg.field
    B = 4
    vals = [rand_elems(fs, B, seed=11 + i) for i in range(cfg.t)]
    # adversarial lanes: 0, 1, p-1 in the barred region
    vals[0][0] = 0
    vals[1][0] = 1
    vals[2][0] = fs.modulus - 1
    state = jnp.asarray(np.stack([fs.ints_to_mont_plane(r) for r in vals], axis=0))
    out = np.asarray(monolith_permute_jit(cfg)(state))
    for b in range(B):
        o = OracleMonolithSponge(cfg)
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        got = [fs.mont_plane_to_ints(out[i][:, b : b + 1])[0] for i in range(cfg.t)]
        assert got == o.state, b


def test_sponge_device_vs_oracle():
    """Full duplex sponge over Monolith on the batched device path, with a
    mode flip and a multi-chunk squeeze."""
    from sponge_jax import Batched
    from sponge_jax.absorb import Fp
    from sponge_jax.sponge import PoseidonSponge

    cfg = CFG_M31
    fs = cfg.field
    B = 3
    lanes = [rand_elems(fs, 10, seed=60 + b) for b in range(B)]
    dev = PoseidonSponge(cfg, batch_size=B)
    dev.absorb(Batched([[Fp(v, fs) for v in vals] for vals in lanes]))
    got = dev.squeeze_native_field_elements(11)
    dev.absorb(Batched([[Fp(9, fs)]] * B))
    got2 = dev.squeeze_bytes(7)
    for b in range(B):
        o = OracleMonolithSponge(cfg)
        o.absorb_field_elements(lanes[b])
        assert got[b] == o.squeeze_native_field_elements(11), b
        o.absorb_field_elements([9])
        assert got2[b] == o.squeeze_bytes(7), b


def test_hash_over_monolith():
    """The config-agnostic batched hash layer runs over the Monolith hook."""
    from sponge_jax.hash import hash_elements

    cfg = CFG_KB
    fs = cfg.field
    B, k = 4, 5
    msgs = [rand_elems(fs, k, seed=77 + b) for b in range(B)]
    elems = jnp.asarray(
        np.stack(
            [fs.ints_to_mont_plane([msgs[b][i] for b in range(B)]) for i in range(k)],
            axis=0,
        )
    )
    digests = np.asarray(hash_elements(cfg, elems, num_outputs=2))
    for b in range(B):
        o = OracleMonolithSponge(cfg)
        o.absorb_field_elements(msgs[b])
        want = o.squeeze_native_field_elements(2)
        got = [fs.mont_plane_to_ints(digests[i][:, b : b + 1])[0] for i in range(2)]
        assert got == want, b


def test_tiny_field_structural():
    """2-limb bar-safe field (p = 2^13 - 1, chunks 8+5): the whole stack —
    params, oracle, device tier — at a geometry no shipped default uses."""
    fs = FieldSpec(name="tiny_m13", modulus=(1 << 13) - 1, generator=17)
    cfg = generate_monolith_parameters(fs, rate=2, capacity=2, rounds=6, bars=2)
    B = 8
    vals = [rand_elems(fs, B, seed=3 + i) for i in range(cfg.t)]
    state = jnp.asarray(np.stack([fs.ints_to_mont_plane(r) for r in vals], axis=0))
    out = np.asarray(monolith_permute_jit(cfg)(state))
    for b in range(B):
        o = OracleMonolithSponge(cfg)
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        got = [fs.mont_plane_to_ints(out[i][:, b : b + 1])[0] for i in range(cfg.t)]
        assert got == o.state, b


# ---------------------------------------------------------------------------
# XLA tier at the geometries a fused kernel would have to cover: the dense
# (Cauchy) Concrete over a non-Mersenne and a Mersenne 31-bit field, and a
# 2-limb bar-safe tiny field.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "fs", [KB, M31, FieldSpec(name="tiny_m13", modulus=(1 << 13) - 1, generator=17)],
    ids=lambda f: f.name,
)
def test_xla_tier_dense_concrete_vs_oracle(fs):
    from conftest import check_permutation_vs_oracle

    cfg = generate_monolith_parameters(fs, rate=2, capacity=2, rounds=6, bars=2)
    check_permutation_vs_oracle(cfg, B=64, stride=5)


def test_sharded_monolith_matches_local():
    """The config-agnostic sharded machinery runs the Monolith hook on an
    8-device mesh, bit-identical to the local XLA tier."""
    import jax

    from sponge_jax.parallel import make_mesh, sharded_permute_fn

    cfg = CFG_KB
    fs = cfg.field
    mesh = make_mesh(8)
    B = 32
    vals = [rand_elems(fs, B, seed=31 + i) for i in range(cfg.t)]
    plane = np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
    state = jax.device_put(
        jnp.asarray(plane),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, None, "data")),
    )
    out_sharded = np.asarray(sharded_permute_fn(cfg, mesh)(state))
    out_local = np.asarray(monolith_permute_jit(cfg)(jnp.asarray(plane)))
    assert np.array_equal(out_sharded, out_local)


def test_goldilocks_t8_paper_geometry():
    """The paper's second Monolith-64 geometry (t=8, u=4) as a rate-4
    default, with the MDS-verified t=8 small circulant; XLA tier + oracle
    golden vector pinned."""
    cfg = get_default_monolith_parameters(GL, rate=4)
    assert (cfg.t, cfg.bars, cfg.rounds, cfg.capacity) == (8, 4, 6, 4)
    assert cfg.concrete[0] == (25, 6, 2, 25, 27, 14, 29, 1)
    assert cfg.concrete_small_entries() is not None
    s = OracleMonolithSponge(cfg)
    s.absorb_field_elements(list(range(4)))
    assert s.squeeze_native_field_elements(2) == [
        3013020673448842056,
        17604359482555244088,
    ]
    from conftest import check_permutation_vs_oracle

    check_permutation_vs_oracle(cfg, B=128, stride=17)
