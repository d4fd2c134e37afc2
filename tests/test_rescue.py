"""Rescue-Prime family: spec-derived parameters, oracle, XLA tier, duplex
integration.

The reference ships only Poseidon; Rescue-Prime is an additive family behind
the same duplex machinery (like Poseidon2).  Ground truth is the scalar
oracle; golden values below are frozen self-consistent instances
(docs/SECURITY.md provenance table).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from sponge_jax import (
    BLS12_381_FR as FR,
    GOLDILOCKS_FR as GL,
    MERSENNE31_FR as M31,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge
from sponge_jax.rescue import (
    OracleRescueSponge,
    RescueConfig,
    get_default_rescue_parameters,
    rescue_round_count,
    smallest_alpha,
)
from sponge_jax.rescue.permutation import rescue_permute_jit

CFG = get_default_rescue_parameters(FR, 2)


def rand_fr(fs, n, seed=7):
    rng = np.random.default_rng(seed)
    return [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=n)]


def test_spec_parameters():
    """Spec §2.2/§2.5: smallest prime alpha coprime to p-1; Groebner-model
    round count (the classic 255-bit t=3 alpha=5 instance lands on N=14)."""
    assert smallest_alpha(FR.modulus) == 5
    assert smallest_alpha(GL.modulus) == 7
    assert smallest_alpha(M31.modulus) == 5
    assert rescue_round_count(FR.modulus, 3, 1, 128, 5) == 14
    assert CFG.t == 3 and CFG.alpha == 5 and CFG.rounds == 14
    # inverse S-box exponent really inverts
    assert CFG.alpha * CFG.inv_alpha % (FR.modulus - 1) == 1
    x = 123456789
    assert pow(pow(x, CFG.alpha, FR.modulus), CFG.inv_alpha, FR.modulus) == x


def test_config_validation():
    import pytest

    # alpha = 3 divides p-1 for BLS12-381 Fr: not invertible
    with pytest.raises(ValueError, match="not invertible"):
        RescueConfig(
            field=FR, rounds=2, alpha=3,
            mds=CFG.mds, rc=CFG.rc[:4], rate=2, capacity=1,
        )
    with pytest.raises(ValueError, match="rc must have"):
        RescueConfig(
            field=FR, rounds=3, alpha=5,
            mds=CFG.mds, rc=CFG.rc[:4], rate=2, capacity=1,
        )


def test_oracle_golden_regression():
    o = OracleRescueSponge(CFG)
    o.absorb_field_elements([0, 1])
    assert o.squeeze_native_field_elements(2) == [
        45302786381541930325162575638737089225573393886344434601026979521681543727945,
        26952253882373158469686854567157364530461338720960972120602142787680627985088,
    ]
    gl_cfg = get_default_rescue_parameters(GL, 8)
    assert gl_cfg.rounds == 8 and gl_cfg.alpha == 7
    o = OracleRescueSponge(gl_cfg)
    o.absorb_field_elements(list(range(8)))
    assert o.squeeze_native_field_elements(2) == [
        11777114957144409127, 14272716373264212525,
    ]


def test_xla_tier_vs_oracle():
    for fs, rate in ((FR, 2), (M31, 8)):
        cfg = get_default_rescue_parameters(fs, rate)
        B = 4
        vals = [rand_fr(fs, B, seed=11 + i) for i in range(cfg.t)]
        state = jnp.asarray(
            np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
        )
        out = np.asarray(rescue_permute_jit(cfg)(state))
        for b in range(B):
            o = OracleRescueSponge(cfg)
            o.state = [vals[i][b] for i in range(cfg.t)]
            o.permute()
            got = [fs.mont_limbs_to_int(out[i][:, b]) for i in range(cfg.t)]
            assert got == o.state, (fs.name, b)


def test_duplex_sponge_integration():
    """The shared batched duplex sponge runs a RescueConfig unmodified via
    the batched_permute dispatch hook (same plug-in path as Poseidon2)."""
    from sponge_jax import Batched
    from sponge_jax.absorb import Fp
    from sponge_jax.sponge import PoseidonSponge

    B = 2
    lanes = [rand_fr(FR, 5, seed=50 + b) for b in range(B)]
    dev = PoseidonSponge(CFG, batch_size=B)
    dev.absorb(Batched([[Fp(v, FR) for v in vals] for vals in lanes]))
    got_elems = dev.squeeze_native_field_elements(3)
    got_bytes = dev.squeeze_bytes(17)
    for b in range(B):
        o = OracleRescueSponge(CFG)
        o.absorb_field_elements(lanes[b])
        assert got_elems[b] == o.squeeze_native_field_elements(3), b
        assert got_bytes[b] == o.squeeze_bytes(17), b


def test_oracle_duplex_is_poseidon_machine():
    """Rescue's duplex behavior (lazy permutes, mode flips, additive absorb)
    is byte-identical to the shared machine — only permute() differs."""
    o = OracleRescueSponge(CFG)
    assert isinstance(o, OraclePoseidonSponge)
    o.absorb_field_elements([5])
    st = o.into_state()
    o2 = OracleRescueSponge.from_state(st, CFG)
    assert o2.squeeze_native_field_elements(1) == o.squeeze_native_field_elements(1)


def test_sharded_permute_matches_local():
    """Rescue through shard_map (8-device CPU mesh) == the local XLA tier
    (VERDICT r2 item 6: Rescue crossing shard_map)."""
    import jax

    from sponge_jax import GOLDILOCKS_FR
    from sponge_jax.parallel import make_mesh, sharded_permute_fn
    from sponge_jax.poseidon.permutation import batched_permute

    fs = GOLDILOCKS_FR
    cfg = get_default_rescue_parameters(fs, 4)
    B = 32
    vals = [rand_fr(fs, B, seed=90 + i) for i in range(cfg.t)]
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

import pytest

from conftest import check_permutation_vs_oracle


def _tiny_rescue_config(rate=2, rounds=4):
    """Rescue config over a 25-bit, 3-limb field (cheap to compile)."""
    from sponge_jax.fields import FieldSpec
    from sponge_jax.rescue.params import generate_rescue_parameters

    fs = FieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3)
    return generate_rescue_parameters(fs, rate, rounds=rounds)


@pytest.mark.parametrize("rounds", [2, 4], ids=["r2", "r4"])
@pytest.mark.parametrize("rate", [1, 2, 3], ids=["rate1", "rate2", "rate3"])
def test_xla_tier_tiny_field_vs_oracle(rate, rounds):
    """The inverse-S-box ladder, MDS and round constants of the XLA tier
    (the family's only device tier) at several widths."""
    check_permutation_vs_oracle(_tiny_rescue_config(rate, rounds))
