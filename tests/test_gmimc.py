"""GMiMC-erf family: structure, oracle golden regression, XLA tier vs
oracle, permutation-property (invertibility) check, duplex integration,
native host parity.

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
from sponge_jax.gmimc import (
    GmimcConfig,
    OracleGmimcSponge,
    generate_gmimc_parameters,
    get_default_gmimc_parameters,
    gmimc_default_rounds,
)
from sponge_jax.gmimc.permutation import gmimc_permute_jit
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

CFG = get_default_gmimc_parameters(FR, 2)


def rand_fr(fs, n, seed=7):
    rng = np.random.default_rng(seed)
    return [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=n)]


def test_structure_and_defaults():
    # rounds = 2*ceil(log_alpha p) + 2t: BLS alpha=5 -> 2*110 + 6 = 226
    assert CFG.t == 3 and CFG.alpha == 5 and CFG.rounds == 226
    assert len(CFG.rc) == CFG.rounds
    cfg8 = get_default_gmimc_parameters(GL, 4)
    assert cfg8.t == 8 and cfg8.alpha == 7 and cfg8.rounds == 62
    assert gmimc_default_rounds(GL, 8, 7) == 62


def test_config_validation():
    with pytest.raises(ValueError, match="width must be >= 2"):
        GmimcConfig(field=FR, rounds=2, alpha=5, rc=(1, 2), rate=0, capacity=1)
    with pytest.raises(ValueError, match="not invertible"):
        GmimcConfig(field=FR, rounds=2, alpha=3, rc=(1, 2), rate=2, capacity=1)
    with pytest.raises(ValueError, match="one constant per round"):
        GmimcConfig(field=FR, rounds=3, alpha=5, rc=(1, 2), rate=2, capacity=1)
    # 31-bit fields have no post-attack analysis at our envelope: defaults refuse
    with pytest.raises(ValueError, match="pass rounds"):
        generate_gmimc_parameters(M31, 8, capacity=8)


def test_permutation_is_invertible():
    """The erf Feistel inverts exactly: x_0 = y_{t-1}, F recomputes from it,
    x_i = y_{i-1} - F — roundtrip random states on two widths."""
    for cfg, seed in ((CFG, 3), (get_default_gmimc_parameters(GL, 4), 4)):
        p = cfg.field.modulus
        x = rand_fr(cfg.field, cfg.t, seed=seed)
        o = OracleGmimcSponge(cfg)
        o.state = list(x)
        o.permute()
        back = list(o.state)
        for r in range(cfg.rounds - 1, -1, -1):
            x0 = back[-1]
            f = pow((x0 + cfg.rc[r]) % p, cfg.alpha, p)
            back = [x0] + [(back[i] - f) % p for i in range(cfg.t - 1)]
        assert back == x


def test_oracle_golden_regression():
    o = OracleGmimcSponge(CFG)
    o.absorb_field_elements([0, 1])
    assert o.squeeze_native_field_elements(2) == [
        37046578519137793905068004997922276005969922553874139160809393105572205846096,
        36927340725794352549314907498009288447328445793911509161713498516543876008544,
    ]
    gl_cfg = get_default_gmimc_parameters(GL, 4)
    o = OracleGmimcSponge(gl_cfg)
    o.absorb_field_elements(list(range(4)))
    assert o.squeeze_native_field_elements(2) == [
        2530300686986820728, 5710632959018033549,
    ]


def test_xla_tier_vs_oracle():
    for fs, rate in ((FR, 2), (GL, 4)):
        cfg = get_default_gmimc_parameters(fs, rate)
        B = 4
        vals = [rand_fr(fs, B, seed=11 + i) for i in range(cfg.t)]
        state = jnp.asarray(
            np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
        )
        out = np.asarray(gmimc_permute_jit(cfg)(state))
        for b in range(B):
            o = OracleGmimcSponge(cfg)
            o.state = [vals[i][b] for i in range(cfg.t)]
            o.permute()
            got = [fs.mont_limbs_to_int(out[i][:, b]) for i in range(cfg.t)]
            assert got == o.state, (fs.name, b)


def test_xla_tier_small_field_explicit_rounds():
    """31-bit fields run with explicit round counts; the value-safe fold
    discipline keeps the tier exact at the minimum R/p headroom."""
    cfg = generate_gmimc_parameters(M31, 8, capacity=8, rounds=20)
    B = 4
    vals = [rand_fr(M31, B, seed=29 + i) for i in range(cfg.t)]
    state = jnp.asarray(
        np.stack([M31.ints_to_mont_plane(row) for row in vals], axis=0)
    )
    out = np.asarray(gmimc_permute_jit(cfg)(state))
    for b in range(B):
        o = OracleGmimcSponge(cfg)
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        got = [M31.mont_limbs_to_int(out[i][:, b]) for i in range(cfg.t)]
        assert got == o.state, b


def test_duplex_sponge_integration():
    """The shared batched duplex sponge runs a GmimcConfig unmodified via
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
        o = OracleGmimcSponge(CFG)
        o.absorb_field_elements(lanes[b])
        assert got_elems[b] == o.squeeze_native_field_elements(3), b
        assert got_bytes[b] == o.squeeze_bytes(17), b


def test_compiled_transcript_with_gmimc():
    """compile_transcript is family-agnostic via the batched_permute hook:
    a full Fiat-Shamir schedule (mode flips, multi-chunk squeeze) over a
    GmimcConfig matches the oracle replay."""
    import jax.numpy as jnp

    from sponge_jax.transcript import (
        Absorb,
        SqueezeNative,
        compile_transcript,
        transcript_shape,
    )

    schedule = [Absorb(3), SqueezeNative(2), Absorb(1), SqueezeNative(5)]
    total_a, total_q = transcript_shape(schedule)
    B = 2
    lanes = [rand_fr(FR, total_a, seed=70 + b) for b in range(B)]
    grid = np.asarray(lanes, dtype=object).T  # (total_a, B)
    elems = jnp.asarray(
        np.stack([FR.ints_to_mont_plane(row) for row in grid], axis=0)
    )
    out = np.asarray(compile_transcript(CFG, schedule)(elems))
    for b in range(B):
        o = OracleGmimcSponge(CFG)
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


def test_oracle_duplex_is_poseidon_machine():
    """GMiMC's duplex behavior (lazy permutes, mode flips, additive absorb)
    is byte-identical to the shared machine — only permute() differs."""
    o = OracleGmimcSponge(CFG)
    assert isinstance(o, OraclePoseidonSponge)
    o.absorb_field_elements([5])
    st = o.into_state()
    o2 = OracleGmimcSponge.from_state(st, CFG)
    assert o2.squeeze_native_field_elements(1) == o.squeeze_native_field_elements(1)


def test_host_gmimc_vs_oracle():
    """Native GMiMC (one mont_pow + t-1 mont_adds per round) vs the oracle:
    single permute, and a mixed absorb/squeeze schedule in one native call."""
    from sponge_jax import host_run_schedule
    from sponge_jax.poseidon.host import HostGmimcSponge, host_available

    for fs, rate in ((FR, 2), (GL, 4)):
        cfg = get_default_gmimc_parameters(fs, rate)
        if not host_available(cfg):
            pytest.skip("native host runtime unavailable")
        vals = rand_fr(fs, cfg.t, seed=61)
        o = OracleGmimcSponge(cfg)
        o.state = list(vals)
        o.permute()
        h = HostGmimcSponge(cfg)
        h.state = list(vals)
        h.permute()
        assert h.state == o.state, fs.name

        elems = rand_fr(fs, 7, seed=62)
        steps = [("absorb", 5), ("squeeze", 3), ("absorb", 2), ("squeeze", 4)]
        sq, st = host_run_schedule(cfg, steps, elems)
        o2 = OracleGmimcSponge(cfg)
        o2.absorb_field_elements(elems[:5])
        want = o2.squeeze_native_field_elements(3)
        o2.absorb_field_elements(elems[5:])
        want += o2.squeeze_native_field_elements(4)
        assert sq == want, fs.name
        assert st.state == o2.state and st.mode == o2.mode
        assert st.index == o2.index


# ---- XLA tier at small fields ----

import pytest

from conftest import check_permutation_vs_oracle


def _tiny_gmimc_config(t=3, alpha=5, rounds=30, seed=21):
    """GMiMC config over a 25-bit, 3-limb field (cheap to compile)."""
    from sponge_jax.fields import FieldSpec

    fs = FieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3)
    rng = np.random.default_rng(seed)
    rc = tuple(int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=rounds))
    return GmimcConfig(
        field=fs, rounds=rounds, alpha=alpha, rc=rc, rate=t - 1, capacity=1
    )


@pytest.mark.parametrize("alpha", [3, 5], ids=["a3", "a5"])
@pytest.mark.parametrize("t", [3, 5], ids=["t3", "t5"])
def test_xla_tier_tiny_field_vs_oracle(t, alpha):
    """The XLA tier (the family's only device tier) at small widths and
    both S-box degrees, over many rounds of unreduced branch adds."""
    check_permutation_vs_oracle(_tiny_gmimc_config(t=t, alpha=alpha))
