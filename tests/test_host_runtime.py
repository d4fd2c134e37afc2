"""Native C++ host runtime (csrc/poseidon_host.cc) ≡ the python oracle.

The host tier re-implements ark-ff's 4x64 Montgomery backend + the reference
duplex state machine (/root/reference/src/poseidon/mod.rs:95-182, 232-341) in
C++; these tests pin it bit-exactly against the oracle on the golden vector,
random transcripts (all duplex transitions incl. the no-permute squeeze
quirk), batched permutes, and segmented schedule resume.
"""

import numpy as np
import pytest

from sponge_jax import BLS12_381_FR, BN254_FR, get_default_poseidon_parameters
from sponge_jax.absorb import Fp
from sponge_jax.poseidon.host import (
    HostPoseidonSponge,
    host_available,
    host_permute_states,
    host_run_schedule,
)
from sponge_jax.poseidon.oracle import ABSORBING, OraclePoseidonSponge

FR = BLS12_381_FR
CFG = get_default_poseidon_parameters(FR, 2, False)

pytestmark = pytest.mark.skipif(
    not host_available(CFG), reason="no C++ toolchain for the native host tier"
)


def rand_fr(rng, n):
    return [int(rng.integers(0, 2 ** 63)) ** 4 % FR.modulus for _ in range(n)]


def test_golden_vector_host():
    """poseidon/mod.rs:376-399 through the native-permutation sponge."""
    s = HostPoseidonSponge(CFG)
    assert s._native
    s.absorb([Fp(0, FR), Fp(1, FR), Fp(2, FR)])
    assert s.squeeze_native_field_elements(3) == [
        40442793463571304028337753002242186710310163897048962278675457993207843616876,
        2664374461699898000291153145224099287711224021716202960480903840045233645301,
        50191078828066923662070228256530692951801504043422844038937334196346054068797,
    ]


@pytest.mark.parametrize("rate", [2, 4, 8])
def test_host_permute_batch_vs_oracle(rate):
    """Batched native permute ≡ oracle permute, at several state widths."""
    cfg = get_default_poseidon_parameters(FR, rate, False)
    rng = np.random.default_rng(rate)
    n = 5
    states = rand_fr(rng, n * cfg.t)
    got = host_permute_states(cfg, states)
    want = []
    for i in range(n):
        o = OraclePoseidonSponge(cfg)
        o.state = states[i * cfg.t : (i + 1) * cfg.t]
        o.permute()
        want.extend(o.state)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_sponge_vs_oracle_random_transcripts(seed):
    rng = np.random.default_rng(seed)
    h = HostPoseidonSponge(CFG)
    o = OraclePoseidonSponge(CFG)
    for _ in range(16):
        n = int(rng.integers(1, 8))
        if rng.choice([True, False]):
            vals = rand_fr(rng, n)
            h.absorb_field_elements(vals)
            o.absorb_field_elements(vals)
        else:
            assert h.squeeze_native_field_elements(
                n
            ) == o.squeeze_native_field_elements(n)
        assert (h.mode, h.index) == (o.mode, o.index)
        assert h.state == o.state


def test_host_sponge_formatting_and_fork():
    """Inherited bytes/bits/nonnative/fork surfaces run on the native permute."""
    rng = np.random.default_rng(9)
    vals = rand_fr(rng, 3)
    h, o = HostPoseidonSponge(CFG), OraclePoseidonSponge(CFG)
    h.absorb([Fp(v, FR) for v in vals])
    o.absorb([Fp(v, FR) for v in vals])
    hf, of = h.fork(b"domain"), o.fork(b"domain")
    assert isinstance(hf, HostPoseidonSponge)
    assert hf.squeeze_bytes(77) == of.squeeze_bytes(77)
    assert h.squeeze_bits(300) == o.squeeze_bits(300)
    h2, o2 = h.clone(), o.clone()
    assert h2.squeeze_field_elements(BN254_FR, 3) == o2.squeeze_field_elements(
        BN254_FR, 3
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_host_run_schedule_vs_oracle(seed):
    """Whole-schedule native driver ≡ stepping the oracle, incl. final state."""
    rng = np.random.default_rng(100 + seed)
    steps, elems = [], []
    for _ in range(14):
        n = int(rng.integers(0, 8))  # include zero-count steps
        if rng.choice([True, False]):
            steps.append(("absorb", n))
            elems.extend(rand_fr(rng, n))
        else:
            steps.append(("squeeze", n))
    got, got_state = host_run_schedule(CFG, steps, elems)

    o = OraclePoseidonSponge(CFG)
    want, pos = [], 0
    for kind, n in steps:
        if kind == "absorb":
            o.absorb_field_elements(elems[pos : pos + n])
            pos += n
        else:
            want.extend(o.squeeze_native_field_elements(n))
    assert got == want
    ostate = o.into_state()
    assert got_state.state == ostate.state
    assert (got_state.mode, got_state.index) == (ostate.mode, ostate.index)


def test_host_run_schedule_segmented_resume():
    """Splitting a schedule across two native calls (state passthrough) ≡ one."""
    rng = np.random.default_rng(42)
    steps = [("absorb", 3), ("squeeze", 2), ("absorb", 1), ("squeeze", 4),
             ("absorb", 5), ("squeeze", 3)]
    elems = rand_fr(rng, 9)
    full, full_state = host_run_schedule(CFG, steps, elems)

    a, sa = host_run_schedule(CFG, steps[:3], elems[:4])
    b, sb = host_run_schedule(CFG, steps[3:], elems[4:], state=sa)
    assert a + b == full
    assert sb.state == full_state.state
    assert (sb.mode, sb.index) == (full_state.mode, full_state.index)


def test_host_run_schedule_validates_elems():
    with pytest.raises(ValueError):
        host_run_schedule(CFG, [("absorb", 2)], [1])


def test_host_sponge_ext_roundtrip():
    """SpongeExt through the host tier interoperates with the oracle."""
    rng = np.random.default_rng(5)
    vals = rand_fr(rng, 4)
    h = HostPoseidonSponge(CFG)
    h.absorb_field_elements(vals)
    st = h.into_state()
    o = OraclePoseidonSponge.from_state(st, CFG)
    h2 = HostPoseidonSponge.from_state(st, CFG)
    assert st.mode == ABSORBING
    assert h2.squeeze_native_field_elements(
        3
    ) == o.squeeze_native_field_elements(3)


# ---------------------------------------------------------------------------
# Poseidon2 through the same native runtime (csrc poseidon2_* entries)
# ---------------------------------------------------------------------------


def test_host_poseidon2_permute_vs_oracle():
    from sponge_jax import get_default_poseidon2_parameters
    from sponge_jax.poseidon2 import OraclePoseidon2Sponge

    cfg2 = get_default_poseidon2_parameters(FR, 2)
    rng = np.random.default_rng(3)
    states = rand_fr(rng, 4 * cfg2.t)
    got = host_permute_states(cfg2, states)
    for b in range(4):
        o = OraclePoseidon2Sponge(cfg2)
        o.state = states[b * cfg2.t : (b + 1) * cfg2.t]
        o.permute()
        assert got[b * cfg2.t : (b + 1) * cfg2.t] == o.state, b


def test_host_poseidon2_sponge_vs_oracle():
    from sponge_jax import get_default_poseidon2_parameters
    from sponge_jax.poseidon.host import HostPoseidon2Sponge
    from sponge_jax.poseidon2 import OraclePoseidon2Sponge

    cfg2 = get_default_poseidon2_parameters(FR, 2)
    h = HostPoseidon2Sponge(cfg2)
    assert h._native
    o = OraclePoseidon2Sponge(cfg2)
    for s in (h, o):
        s.absorb([Fp(0, FR), Fp(1, FR), Fp(2, FR)])
    assert h.squeeze_native_field_elements(3) == o.squeeze_native_field_elements(3)
    # Mode flip + bytes path + fork (inherited formatting over native permute).
    for s in (h, o):
        s.absorb([Fp(9, FR)])
    assert h.squeeze_bytes(13) == o.squeeze_bytes(13)
    hf, of = h.fork(b"d"), o.fork(b"d")
    assert isinstance(hf, HostPoseidon2Sponge)
    assert hf.squeeze_native_field_elements(1) == of.squeeze_native_field_elements(1)


def test_host_poseidon2_run_schedule_vs_oracle():
    from sponge_jax import get_default_poseidon2_parameters
    from sponge_jax.poseidon2 import OraclePoseidon2Sponge

    cfg2 = get_default_poseidon2_parameters(FR, 2)
    rng = np.random.default_rng(11)
    elems = rand_fr(rng, 7)
    steps = [("absorb", 3), ("squeeze", 2), ("absorb", 4), ("squeeze", 5)]
    got, state = host_run_schedule(cfg2, steps, elems)
    o = OraclePoseidon2Sponge(cfg2)
    o.absorb_field_elements(elems[:3])
    want = o.squeeze_native_field_elements(2)
    o.absorb_field_elements(elems[3:])
    want += o.squeeze_native_field_elements(5)
    assert got == want
    assert state.state == o.state and state.index == o.index


def test_host_monolith_vs_oracle():
    """Native Monolith permute + full sponge + schedule driver vs oracle,
    over all four bar-safe fields (BabyBear exercises the non-byte-aligned
    bar chunk boundary in the native bar_u64)."""
    from sponge_jax import (
        BABYBEAR_FR,
        GOLDILOCKS_FR,
        KOALABEAR_FR,
        MERSENNE31_FR,
        get_default_monolith_parameters,
    )
    from sponge_jax.monolith import OracleMonolithSponge
    from sponge_jax.poseidon.host import HostMonolithSponge, host_available

    rng = np.random.default_rng(13)
    for fs in (GOLDILOCKS_FR, MERSENNE31_FR, KOALABEAR_FR, BABYBEAR_FR):
        cfg = get_default_monolith_parameters(fs)
        if not host_available(cfg):
            pytest.skip("no C++ toolchain")
        t = cfg.t
        states = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=2 * t)]
        states[0] = 0
        states[1] = fs.modulus - 1
        got = host_permute_states(cfg, states)
        for b in range(2):
            o = OracleMonolithSponge(cfg)
            o.state = states[b * t : (b + 1) * t]
            o.permute()
            assert got[b * t : (b + 1) * t] == o.state, (fs.name, b)
        h = HostMonolithSponge(cfg)
        assert h._native
        o = OracleMonolithSponge(cfg)
        vals = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=10)]
        h.absorb_field_elements(vals)
        o.absorb_field_elements(vals)
        assert h.squeeze_native_field_elements(11) == o.squeeze_native_field_elements(11)
        sq, st = host_run_schedule(
            cfg, [("absorb", 10), ("squeeze", 11), ("absorb", 1), ("squeeze", 3)],
            vals + [7],
        )
        o2 = OracleMonolithSponge(cfg)
        o2.absorb_field_elements(vals)
        want = o2.squeeze_native_field_elements(11)
        o2.absorb_field_elements([7])
        want += o2.squeeze_native_field_elements(3)
        assert sq == want, fs.name
        assert st.state == o2.state and st.index == o2.index


def test_host_rescue_vs_oracle():
    """Native Rescue-Prime (wide-exponent inverse S-box) vs oracle, 31-bit
    and 255-bit fields."""
    from sponge_jax import MERSENNE31_FR, get_default_rescue_parameters
    from sponge_jax.poseidon.host import HostRescueSponge, host_available
    from sponge_jax.rescue import OracleRescueSponge

    rng = np.random.default_rng(14)
    for fs, rate in ((MERSENNE31_FR, 8), (FR, 2)):
        cfg = get_default_rescue_parameters(fs, rate)
        if not host_available(cfg):
            pytest.skip("no C++ toolchain")
        t = cfg.t
        states = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=t)]
        states[0] = 0
        got = host_permute_states(cfg, states)
        o = OracleRescueSponge(cfg)
        o.state = list(states)
        o.permute()
        assert got == o.state, fs.name
        h = HostRescueSponge(cfg)
        assert h._native
        o = OracleRescueSponge(cfg)
        vals = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=5)]
        h.absorb_field_elements(vals)
        o.absorb_field_elements(vals)
        assert h.squeeze_native_field_elements(rate + 3) == \
            o.squeeze_native_field_elements(rate + 3)
        sq, _ = host_run_schedule(cfg, [("absorb", 5), ("squeeze", 3)], vals)
        o2 = OracleRescueSponge(cfg)
        o2.absorb_field_elements(vals)
        assert sq == o2.squeeze_native_field_elements(3), fs.name


def test_host_griffin_vs_oracle():
    """Native Griffin (wide-exponent y0 ladder + quadratic-gated elements)
    vs oracle, 255-bit t=3 and Goldilocks t=8."""
    from sponge_jax import GOLDILOCKS_FR, get_default_griffin_parameters
    from sponge_jax.griffin import OracleGriffinSponge
    from sponge_jax.poseidon.host import HostGriffinSponge, host_available

    rng = np.random.default_rng(15)
    for fs, rate in ((FR, 2), (GOLDILOCKS_FR, 4)):
        cfg = get_default_griffin_parameters(fs, rate)
        if not host_available(cfg):
            pytest.skip("no C++ toolchain")
        t = cfg.t
        states = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=t)]
        states[0] = 0
        got = host_permute_states(cfg, states)
        o = OracleGriffinSponge(cfg)
        o.state = list(states)
        o.permute()
        assert got == o.state, fs.name
        h = HostGriffinSponge(cfg)
        assert h._native
        o = OracleGriffinSponge(cfg)
        vals = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=5)]
        h.absorb_field_elements(vals)
        o.absorb_field_elements(vals)
        assert h.squeeze_native_field_elements(rate + 3) == \
            o.squeeze_native_field_elements(rate + 3)
        sq, _ = host_run_schedule(cfg, [("absorb", 5), ("squeeze", 3)], vals)
        o2 = OracleGriffinSponge(cfg)
        o2.absorb_field_elements(vals)
        assert sq == o2.squeeze_native_field_elements(3), fs.name


def test_host_anemoi_vs_oracle():
    """Native Anemoi (Flystel with wide-exponent ladder + mont_sub) vs
    oracle, 255-bit t=2/t=4 and Goldilocks t=8."""
    from sponge_jax import GOLDILOCKS_FR, get_default_anemoi_parameters
    from sponge_jax.anemoi import OracleAnemoiSponge
    from sponge_jax.poseidon.host import HostAnemoiSponge, host_available

    rng = np.random.default_rng(16)
    for fs, rate in ((FR, 1), (FR, 3), (GOLDILOCKS_FR, 4)):
        cfg = get_default_anemoi_parameters(fs, rate)
        if not host_available(cfg):
            pytest.skip("no C++ toolchain")
        t = cfg.t
        states = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=t)]
        states[0] = 0
        got = host_permute_states(cfg, states)
        o = OracleAnemoiSponge(cfg)
        o.state = list(states)
        o.permute()
        assert got == o.state, (fs.name, rate)
        h = HostAnemoiSponge(cfg)
        assert h._native
        o = OracleAnemoiSponge(cfg)
        vals = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=5)]
        h.absorb_field_elements(vals)
        o.absorb_field_elements(vals)
        assert h.squeeze_native_field_elements(rate + 3) == \
            o.squeeze_native_field_elements(rate + 3)
        sq, _ = host_run_schedule(cfg, [("absorb", 5), ("squeeze", 3)], vals)
        o2 = OracleAnemoiSponge(cfg)
        o2.absorb_field_elements(vals)
        assert sq == o2.squeeze_native_field_elements(3), (fs.name, rate)
