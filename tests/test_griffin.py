"""Griffin-pi family: structure, oracle golden regression, XLA tier vs
oracle, permutation-property (invertibility) check, duplex integration.

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
from sponge_jax.griffin import (
    GriffinConfig,
    OracleGriffinSponge,
    generate_griffin_parameters,
    get_default_griffin_parameters,
    griffin_default_rounds,
    is_quadratic_nonresidue,
)
from sponge_jax.griffin.permutation import griffin_permute_jit
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

CFG = get_default_griffin_parameters(FR, 2)


def rand_fr(fs, n, seed=7):
    rng = np.random.default_rng(seed)
    return [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=n)]


def test_structure_and_defaults():
    assert CFG.t == 3 and CFG.alpha == 5 and CFG.rounds == 14
    assert CFG.alpha * CFG.inv_alpha % (FR.modulus - 1) == 1
    # quadratic discriminants are non-residues for EVERY element index
    cfg8 = get_default_griffin_parameters(GL, 4)
    assert cfg8.t == 8 and cfg8.alpha == 7 and cfg8.rounds == 12
    for i in range(2, cfg8.t):
        a_i, b_i = cfg8.quad_coeffs(i)
        assert is_quadratic_nonresidue(
            (a_i * a_i - 4 * b_i) % GL.modulus, GL.modulus
        ), i
    assert griffin_default_rounds(3) == 16
    # linear layer is the Poseidon2 small-int family
    assert CFG.mat_e == ((2, 1, 1), (1, 2, 1), (1, 1, 2))


def test_config_validation():
    with pytest.raises(ValueError, match="t % 4 == 0"):
        generate_griffin_parameters(FR, 4, capacity=1)  # t = 5
    with pytest.raises(ValueError, match="width must be 3 or a multiple"):
        GriffinConfig(
            field=FR, rounds=2, alpha=5, mat_e=((2, 1), (1, 2)),
            rc=(CFG.rc[0][:2],), qc_alpha=CFG.qc_alpha,
            qc_beta=CFG.qc_beta, rate=1, capacity=1,
        )  # t = 2: valid Poseidon2 width, too narrow for Griffin
    with pytest.raises(ValueError, match="not invertible"):
        GriffinConfig(
            field=FR, rounds=2, alpha=3, mat_e=CFG.mat_e, rc=CFG.rc[:1],
            qc_alpha=CFG.qc_alpha, qc_beta=CFG.qc_beta, rate=2, capacity=1,
        )
    with pytest.raises(ValueError, match="rc must have"):
        GriffinConfig(
            field=FR, rounds=3, alpha=5, mat_e=CFG.mat_e, rc=CFG.rc[:1],
            qc_alpha=CFG.qc_alpha, qc_beta=CFG.qc_beta, rate=2, capacity=1,
        )
    # a perfect-square discriminant must be rejected: a=2, b=0 -> disc=4
    with pytest.raises(ValueError, match="non-residue"):
        GriffinConfig(
            field=FR, rounds=14, alpha=5, mat_e=CFG.mat_e, rc=CFG.rc,
            qc_alpha=2, qc_beta=0, rate=2, capacity=1,
        )
    # 31-bit fields have no published Griffin analysis: defaults refuse
    with pytest.raises(ValueError, match="pass rounds"):
        generate_griffin_parameters(M31, 8, capacity=8)


def test_nonlinear_layer_is_invertible():
    """The permutation property argued in griffin/config.py, checked
    concretely: invert S sequentially (y0^d, y1^(1/d), then divide by the
    quadratic gate in index order) and roundtrip random states."""
    for cfg, seed in ((CFG, 3), (get_default_griffin_parameters(GL, 4), 4)):
        p = cfg.field.modulus
        o = OracleGriffinSponge(cfg)
        x = rand_fr(cfg.field, cfg.t, seed=seed)
        y = list(x)
        o._nonlinear(y)
        # invert
        back = [pow(y[0], cfg.alpha, p), pow(y[1], cfg.inv_alpha, p)]
        for i in range(2, cfg.t):
            li = ((i - 1) * y[0] + y[1] + (back[i - 1] if i >= 3 else 0)) % p
            a_i, b_i = cfg.quad_coeffs(i)
            quad = (li * li + a_i * li + b_i) % p
            back.append(y[i] * pow(quad, -1, p) % p)
        assert back == x


def test_oracle_golden_regression():
    o = OracleGriffinSponge(CFG)
    o.absorb_field_elements([0, 1])
    assert o.squeeze_native_field_elements(2) == [
        17568489372357836836505885331655087491470577238226034896877593231157640869808,
        14593224294559100415741393686604387315592950665506024215387915292647432429441,
    ]
    gl_cfg = get_default_griffin_parameters(GL, 4)
    o = OracleGriffinSponge(gl_cfg)
    o.absorb_field_elements(list(range(4)))
    assert o.squeeze_native_field_elements(2) == [
        5142094782954152270, 13580507934772854974,
    ]


def test_xla_tier_vs_oracle():
    for fs, rate in ((FR, 2), (GL, 4)):
        cfg = get_default_griffin_parameters(fs, rate)
        B = 4
        vals = [rand_fr(fs, B, seed=11 + i) for i in range(cfg.t)]
        state = jnp.asarray(
            np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
        )
        out = np.asarray(griffin_permute_jit(cfg)(state))
        for b in range(B):
            o = OracleGriffinSponge(cfg)
            o.state = [vals[i][b] for i in range(cfg.t)]
            o.permute()
            got = [fs.mont_limbs_to_int(out[i][:, b]) for i in range(cfg.t)]
            assert got == o.state, (fs.name, b)


def test_xla_tier_small_field_explicit_rounds():
    """31-bit fields run with explicit round counts; the value-safe fold
    discipline keeps the tier exact at the minimum R/p headroom (t=16 over
    Mersenne31: un-reduced row sums far exceed R without folding)."""
    cfg = generate_griffin_parameters(M31, 8, capacity=8, rounds=10)
    B = 4
    vals = [rand_fr(M31, B, seed=29 + i) for i in range(cfg.t)]
    state = jnp.asarray(
        np.stack([M31.ints_to_mont_plane(row) for row in vals], axis=0)
    )
    out = np.asarray(griffin_permute_jit(cfg)(state))
    for b in range(B):
        o = OracleGriffinSponge(cfg)
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        got = [M31.mont_limbs_to_int(out[i][:, b]) for i in range(cfg.t)]
        assert got == o.state, b


def test_duplex_sponge_integration():
    """The shared batched duplex sponge runs a GriffinConfig unmodified via
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
        o = OracleGriffinSponge(CFG)
        o.absorb_field_elements(lanes[b])
        assert got_elems[b] == o.squeeze_native_field_elements(3), b
        assert got_bytes[b] == o.squeeze_bytes(17), b


def test_oracle_duplex_is_poseidon_machine():
    """Griffin's duplex behavior (lazy permutes, mode flips, additive absorb)
    is byte-identical to the shared machine — only permute() differs."""
    o = OracleGriffinSponge(CFG)
    assert isinstance(o, OraclePoseidonSponge)
    o.absorb_field_elements([5])
    st = o.into_state()
    o2 = OracleGriffinSponge.from_state(st, CFG)
    assert o2.squeeze_native_field_elements(1) == o.squeeze_native_field_elements(1)


# ---- XLA tier at small fields ----

from conftest import check_permutation_vs_oracle


def _tiny_griffin_config(rate=2, rounds=4):
    """Griffin config over a 25-bit, 3-limb field (cheap to compile)."""
    from sponge_jax.fields import FieldSpec

    fs = FieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3)
    return generate_griffin_parameters(fs, rate, rounds=rounds)


@pytest.mark.parametrize("rounds", [2, 4], ids=["r2", "r4"])
@pytest.mark.parametrize("rate", [2, 3], ids=["rate2", "rate3"])
def test_xla_tier_tiny_field_vs_oracle(rate, rounds):
    """The inverse ladder, quadratic gates and linear layer of the XLA tier
    (the family's only device tier) at small widths."""
    check_permutation_vs_oracle(_tiny_griffin_config(rate, rounds))
