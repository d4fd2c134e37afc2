"""Anemoi family: structure, Flystel invertibility, oracle golden
regression, XLA tier vs oracle, duplex integration.

Ground truth is the scalar oracle; golden values are frozen self-consistent
instances (docs/SECURITY.md provenance table).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
import pytest

from sponge_jax import (
    BLS12_381_FR as FR,
    GOLDILOCKS_FR as GL,
    MERSENNE31_FR as M31,
)
from sponge_jax.anemoi import (
    AnemoiConfig,
    OracleAnemoiSponge,
    anemoi_default_rounds,
    generate_anemoi_parameters,
    get_default_anemoi_parameters,
)
from sponge_jax.anemoi.permutation import anemoi_permute_jit
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

CFG = get_default_anemoi_parameters(FR, 1)  # t = 2, the Jive-mode width


def rand_fr(fs, n, seed=7):
    rng = np.random.default_rng(seed)
    return [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=n)]


def test_structure_and_defaults():
    assert CFG.t == 2 and CFG.l == 1 and CFG.alpha == 5 and CFG.g == 7
    assert CFG.rounds == anemoi_default_rounds(1) == 25
    assert CFG.alpha * CFG.inv_alpha % (FR.modulus - 1) == 1
    assert CFG.g * CFG.g_inv % FR.modulus == 1
    cfg4 = get_default_anemoi_parameters(FR, 3)
    assert cfg4.l == 2 and cfg4.mat_x == (
        (1, 7), (7, 50),
    )  # the paper's [[1, g], [g, g^2+1]]
    cfg8 = get_default_anemoi_parameters(GL, 4)
    assert cfg8.t == 8 and cfg8.l == 4 and cfg8.rounds == 14


def test_config_validation():
    with pytest.raises(ValueError, match="must be even"):
        generate_anemoi_parameters(FR, 2, capacity=1)  # t = 3
    with pytest.raises(ValueError, match="not invertible"):
        AnemoiConfig(
            field=FR, rounds=2, alpha=3, g=7, mat_x=CFG.mat_x,
            rc_x=CFG.rc_x[:2], rc_y=CFG.rc_y[:2], rate=1, capacity=1,
        )
    with pytest.raises(ValueError, match="rc_x must have"):
        AnemoiConfig(
            field=FR, rounds=3, alpha=5, g=7, mat_x=CFG.mat_x,
            rc_x=CFG.rc_x[:2], rc_y=CFG.rc_y[:3], rate=1, capacity=1,
        )
    # 31-bit fields have no published Anemoi analysis: defaults refuse
    with pytest.raises(ValueError, match="pass rounds"):
        generate_anemoi_parameters(M31, 8, capacity=8)
    # every tier skips the 1x1 multiply at l = 1, so a non-identity matrix
    # (which the oracle WOULD apply) is rejected rather than diverging
    with pytest.raises(ValueError, match="identity at l = 1"):
        AnemoiConfig(
            field=FR, rounds=25, alpha=5, g=7, mat_x=((2,),),
            rc_x=CFG.rc_x, rc_y=CFG.rc_y, rate=1, capacity=1,
        )


def test_flystel_is_invertible():
    """The open Flystel is a 3-step butterfly of translations, inverted by
    replaying the steps backwards — checked concretely on random pairs."""
    for cfg, seed in ((CFG, 3), (get_default_anemoi_parameters(GL, 4), 4)):
        p = cfg.field.modulus
        o = OracleAnemoiSponge(cfg)
        for k in range(4):
            x, y = rand_fr(cfg.field, 2, seed=10 * seed + k)
            w, v = o._flystel(x, y)
            u = (w - cfg.g * v * v) % p
            yy = (v + pow(u, cfg.inv_alpha, p)) % p
            xx = (u + cfg.g * yy * yy + cfg.g_inv) % p
            assert (xx, yy) == (x, y)


def test_oracle_golden_regression():
    o = OracleAnemoiSponge(CFG)
    o.absorb_field_elements([0])
    assert o.squeeze_native_field_elements(2) == [
        35675714314881219429352217523578393221143023524104408084397769653631559795453,
        29250560957318018735580408678162621932017287796996990149206325536109642299737,
    ]
    gl_cfg = get_default_anemoi_parameters(GL, 4)
    o = OracleAnemoiSponge(gl_cfg)
    o.absorb_field_elements(list(range(4)))
    assert o.squeeze_native_field_elements(2) == [
        8816711172724677702, 3319201661018352774,
    ]


def test_xla_tier_vs_oracle():
    for fs, rate in ((FR, 1), (FR, 3), (GL, 4)):
        cfg = get_default_anemoi_parameters(fs, rate)
        B = 4
        vals = [rand_fr(fs, B, seed=11 + i) for i in range(cfg.t)]
        state = jnp.asarray(
            np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
        )
        out = np.asarray(anemoi_permute_jit(cfg)(state))
        for b in range(B):
            o = OracleAnemoiSponge(cfg)
            o.state = [vals[i][b] for i in range(cfg.t)]
            o.permute()
            got = [fs.mont_limbs_to_int(out[i][:, b]) for i in range(cfg.t)]
            assert got == o.state, (fs.name, rate, b)


def test_xla_tier_small_field_explicit_rounds():
    """31-bit fields run with explicit round counts; the value-safe fold
    discipline keeps the tier exact at the minimum R/p headroom (t=16 over
    Mersenne31)."""
    cfg = generate_anemoi_parameters(M31, 8, capacity=8, rounds=12)
    B = 4
    vals = [rand_fr(M31, B, seed=29 + i) for i in range(cfg.t)]
    state = jnp.asarray(
        np.stack([M31.ints_to_mont_plane(row) for row in vals], axis=0)
    )
    out = np.asarray(anemoi_permute_jit(cfg)(state))
    for b in range(B):
        o = OracleAnemoiSponge(cfg)
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        got = [M31.mont_limbs_to_int(out[i][:, b]) for i in range(cfg.t)]
        assert got == o.state, b


def test_duplex_sponge_integration():
    """The shared batched duplex sponge runs an AnemoiConfig unmodified via
    the batched_permute dispatch hook (same plug-in path as Poseidon2)."""
    from sponge_jax import Batched
    from sponge_jax.absorb import Fp
    from sponge_jax.sponge import PoseidonSponge

    cfg = get_default_anemoi_parameters(FR, 3)
    B = 2
    lanes = [rand_fr(FR, 5, seed=50 + b) for b in range(B)]
    dev = PoseidonSponge(cfg, batch_size=B)
    dev.absorb(Batched([[Fp(v, FR) for v in vals] for vals in lanes]))
    got_elems = dev.squeeze_native_field_elements(3)
    got_bytes = dev.squeeze_bytes(17)
    for b in range(B):
        o = OracleAnemoiSponge(cfg)
        o.absorb_field_elements(lanes[b])
        assert got_elems[b] == o.squeeze_native_field_elements(3), b
        assert got_bytes[b] == o.squeeze_bytes(17), b


def test_oracle_duplex_is_poseidon_machine():
    """Anemoi's duplex behavior (lazy permutes, mode flips, additive absorb)
    is byte-identical to the shared machine — only permute() differs."""
    o = OracleAnemoiSponge(CFG)
    assert isinstance(o, OraclePoseidonSponge)
    o.absorb_field_elements([5])
    st = o.into_state()
    o2 = OracleAnemoiSponge.from_state(st, CFG)
    assert o2.squeeze_native_field_elements(1) == o.squeeze_native_field_elements(1)


def test_sharded_permute_matches_local():
    """Anemoi through shard_map (8-device CPU mesh) == the local XLA tier
    (VERDICT r2 item 6: Anemoi crossing shard_map)."""
    import jax

    from sponge_jax import GOLDILOCKS_FR
    from sponge_jax.parallel import make_mesh, sharded_permute_fn
    from sponge_jax.poseidon.permutation import batched_permute

    fs = GOLDILOCKS_FR
    cfg = get_default_anemoi_parameters(fs, 4)
    B = 32
    vals = [rand_fr(fs, B, seed=70 + i) for i in range(cfg.t)]
    plane = np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
    mesh = make_mesh(8)
    state = jax.device_put(
        jnp.asarray(plane),
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, None, "data")
        ),
    )
    out_sharded = np.asarray(sharded_permute_fn(cfg, mesh)(state))
    out_local = np.asarray(batched_permute(cfg, jnp.asarray(plane)))
    assert np.array_equal(out_sharded, out_local)


# ---- XLA tier at small fields ----

from conftest import check_permutation_vs_oracle


def _tiny_anemoi_config(rate=3, rounds=4):
    """Anemoi config over a 25-bit, 3-limb field (cheap to compile)."""
    from sponge_jax.fields import FieldSpec

    fs = FieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3)
    return generate_anemoi_parameters(fs, rate, rounds=rounds)


@pytest.mark.parametrize("rounds", [2, 4], ids=["r2", "r4"])
@pytest.mark.parametrize("rate", [1, 3], ids=["one-pair", "two-pairs"])
def test_xla_tier_tiny_field_vs_oracle(rate, rounds):
    """The Flystel ladder over one and several column pairs, in the XLA tier
    (the family's only device tier)."""
    check_permutation_vs_oracle(_tiny_anemoi_config(rate, rounds))
