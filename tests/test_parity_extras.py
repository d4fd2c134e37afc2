"""Cross-field and wide-state parity extras: BN254 sponges, rate-8 configs,
gadget registry, and curve-point gadget vs native codec agreement."""

import numpy as np

from sponge_jax import (
    BLS12_381_FR,
    BN254_FR,
    Fp,
    PoseidonSponge,
    SWPoint,
    get_default_poseidon_parameters,
    to_sponge_field_elements,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge
from sponge_jax.tracer import (
    Boolean,
    ConstraintSystem,
    FpVar,
    PoseidonSpongeVar,
    SWPointVar,
    gadget_of,
    to_sponge_field_elements_gadget,
)

RNG = np.random.default_rng(41)


def rand(fs, n):
    return [int(RNG.integers(0, 2 ** 63)) ** 4 % fs.modulus for _ in range(n)]


def test_bn254_sponge_device_vs_oracle():
    """Full BN254 Fr sponge flow, device vs oracle (alternate parameterization,
    alpha=5 — BASELINE.json config 2)."""
    cfg = get_default_poseidon_parameters(BN254_FR, 3, False)
    assert cfg.alpha == 5 and cfg.t == 4
    vals = rand(BN254_FR, 5)
    dev = PoseidonSponge(cfg, batch_size=2)
    o = OraclePoseidonSponge(cfg)
    dev.absorb([Fp(v, BN254_FR) for v in vals])
    o.absorb_field_elements(vals)
    assert dev.squeeze_native_field_elements(3) == [o.squeeze_native_field_elements(3)] * 2
    assert dev.squeeze_bytes(40) == [o.squeeze_bytes(40)] * 2


def test_rate8_wide_state_device_vs_oracle():
    """Widest default config (t=9, R_P=57): exercises the wide-state dispatch
    path and the vectorized kernels' t-generality."""
    cfg = get_default_poseidon_parameters(BLS12_381_FR, 8, False)
    assert cfg.t == 9
    vals = rand(BLS12_381_FR, 11)  # crosses one rate boundary
    dev = PoseidonSponge(cfg, batch_size=1)
    o = OraclePoseidonSponge(cfg)
    dev.absorb([Fp(v, BLS12_381_FR) for v in vals])
    o.absorb_field_elements(vals)
    assert dev.squeeze_native_field_elements(10) == [o.squeeze_native_field_elements(10)]


def test_weights_optimized_alpha257():
    """alpha=257 weights-optimized config end-to-end (traits.rs weights table)."""
    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, True)
    assert cfg.alpha == 257
    vals = rand(BLS12_381_FR, 2)
    dev = PoseidonSponge(cfg, batch_size=1)
    o = OraclePoseidonSponge(cfg)
    dev.absorb([Fp(v, BLS12_381_FR) for v in vals])
    o.absorb_field_elements(vals)
    assert dev.squeeze_native_field_elements(2) == [o.squeeze_native_field_elements(2)]


def test_gadget_registry():
    assert gadget_of(PoseidonSponge) is PoseidonSpongeVar


def test_point_gadget_matches_native_codec():
    FR = BLS12_381_FR
    x, y = rand(FR, 2)
    native = to_sponge_field_elements(SWPoint(Fp(x, FR), Fp(y, FR)), FR)
    cs = ConstraintSystem(FR)
    var = SWPointVar(
        FpVar.new_witness(cs, x), FpVar.new_witness(cs, y), Boolean.constant(False, FR)
    )
    gadget = to_sponge_field_elements_gadget(var, cs, FR)
    assert [g.value for g in gadget] == native


def test_field_element_size_sum():
    """FieldElementSize::sum (lib.rs:54-58): every size contributes num_bits
    (= MODULUS_BIT_SIZE - 1, incl. the Truncated quirk)."""
    from sponge_jax import BLS12_381_FR, FULL, Truncated, field_element_size_sum

    per = BLS12_381_FR.modulus_bit_size - 1
    assert field_element_size_sum([FULL] * 3, BLS12_381_FR) == 3 * per
    assert field_element_size_sum([FULL, Truncated(100)], BLS12_381_FR) == 2 * per
    assert field_element_size_sum([], BLS12_381_FR) == 0
