"""Tracer (R1CS) mirror tests: native ≡ circuit consistency + satisfaction.

Mirrors the reference's constraints tests (poseidon/constraints.rs:308-347 native
vs gadget agreement + cs.is_satisfied(); constraints/absorb.rs:239-265 encoding
agreement), plus constraint-count accounting the reference exposes through
ark-relations.
"""

import numpy as np

from sponge_jax import BLS12_381_FR, BN254_FR, get_default_poseidon_parameters
from sponge_jax.absorb import Fp, Some, NONE, U8, to_sponge_bytes, to_sponge_field_elements
from sponge_jax.poseidon.oracle import FULL, OraclePoseidonSponge
from sponge_jax.tracer import (
    Boolean,
    ConstraintSystem,
    FpVar,
    OptionVar,
    PoseidonSpongeVar,
    UInt8,
    get_params,
    nonnative_limbs_value,
    to_sponge_bytes_gadget,
    to_sponge_field_elements_gadget,
)

FR = BLS12_381_FR
CFG = get_default_poseidon_parameters(FR, 2, False)
RNG = np.random.default_rng(23)


def rand_fr(n):
    return [int(RNG.integers(0, 2 ** 63)) ** 4 % FR.modulus for _ in range(n)]


def test_native_vs_circuit_squeeze():
    """Same absorbs -> same squeezed values, and the recorded R1CS is satisfied
    (poseidon/constraints.rs:308-347)."""
    vals = rand_fr(3)
    cs = ConstraintSystem(FR)
    var_sponge = PoseidonSpongeVar(cs, CFG)
    var_sponge.absorb([FpVar.new_witness(cs, v) for v in vals])
    got = [e.value for e in var_sponge.squeeze_field_elements(3)]

    native = OraclePoseidonSponge(CFG)
    native.absorb_field_elements(vals)
    want = native.squeeze_native_field_elements(3)

    assert got == want
    assert cs.is_satisfied()
    assert cs.num_constraints > 0


def test_permutation_constraint_count():
    """alpha=17 S-box costs 5 muls; permutation = 5 * (R_F * t + R_P) constraints
    (pow_by_constant chains, poseidon/constraints.rs:47,52; ARK/MDS are free)."""
    cs = ConstraintSystem(FR)
    sponge = PoseidonSpongeVar(cs, CFG)
    sponge.state = [FpVar.new_witness(cs, v) for v in rand_fr(CFG.t)]
    base = cs.num_constraints
    sponge.permute()
    per_sbox = 5  # x^17: 4 squarings + 1 multiply
    expected = per_sbox * (CFG.full_rounds * CFG.t + CFG.partial_rounds)
    assert cs.num_constraints - base == expected
    assert cs.is_satisfied()


def test_gadget_encoding_matches_native_codec():
    """Gadget field-element encoding == native Absorb codec
    (constraints/absorb.rs:239-265)."""
    data = bytes(range(40))
    cs = ConstraintSystem(FR)
    gadget_bytes = [UInt8.constant(b, FR) for b in data]
    gadget_elems = to_sponge_field_elements_gadget(gadget_bytes, cs, FR)
    native_elems = to_sponge_field_elements(data, FR)
    assert [e.value for e in gadget_elems] == native_elems

    # Booleans and field elements too.
    assert to_sponge_field_elements_gadget(Boolean.constant(True, FR), cs, FR)[0].value == 1
    x = rand_fr(1)[0]
    assert to_sponge_field_elements_gadget(FpVar.constant(x, FR), cs, FR)[0].value == x


def test_squeeze_bits_bytes_match_native():
    vals = rand_fr(2)
    cs = ConstraintSystem(FR)
    var_sponge = PoseidonSpongeVar(cs, CFG)
    var_sponge.absorb([FpVar.new_witness(cs, v) for v in vals])
    native = OraclePoseidonSponge(CFG)
    native.absorb_field_elements(vals)

    got_bits = [b.value for b in var_sponge.squeeze_bits(300)]
    want_bits = native.squeeze_bits(300)
    assert got_bits == want_bits
    assert cs.is_satisfied()

    cs2 = ConstraintSystem(FR)
    v2 = PoseidonSpongeVar(cs2, CFG)
    v2.absorb([FpVar.new_witness(cs2, v) for v in vals])
    n2 = OraclePoseidonSponge(CFG)
    n2.absorb_field_elements(vals)
    got_bytes = bytes(b.value for b in v2.squeeze_bytes(50))
    assert got_bytes == n2.squeeze_bytes(50)
    assert cs2.is_satisfied()


def test_nonnative_squeeze_limbs():
    """Nonnative squeeze returns (limbs, bits) whose recombination equals the
    native nonnative squeeze (constraints/mod.rs:122-153), with ark's
    get_params-derived limb geometry and big-endian limb order."""
    vals = rand_fr(2)
    cs = ConstraintSystem(FR)
    var_sponge = PoseidonSpongeVar(cs, CFG)
    var_sponge.absorb([FpVar.new_witness(cs, v) for v in vals])
    gadgets, bit_vecs = var_sponge.squeeze_nonnative_field_elements(BN254_FR, 2)

    native = OraclePoseidonSponge(CFG)
    native.absorb_field_elements(vals)
    want = native.squeeze_field_elements(BN254_FR, 2)

    params = get_params(BN254_FR.modulus_bit_size, FR.modulus_bit_size)
    got = [
        nonnative_limbs_value(limbs, params.bits_per_limb, BN254_FR)
        for limbs in gadgets
    ]
    assert got == want
    assert cs.is_satisfied()
    assert all(len(bv) == BN254_FR.modulus_bit_size - 1 for bv in bit_vecs)


def test_nonnative_limb_geometry_matches_ark():
    """Limb counts/sizes follow ark-r1cs-std get_params (constraints/mod.rs:44-48):
    pinned values for the (254-bit BN254 over 255-bit BLS) pair, limb values in
    range, and exactly num_limbs witnesses + num_limbs enforcements per element."""
    params = get_params(BN254_FR.modulus_bit_size, FR.modulus_bit_size, "constraints")
    assert (params.num_limbs, params.bits_per_limb) == (17, 15)
    wparams = get_params(BN254_FR.modulus_bit_size, FR.modulus_bit_size, "weight")
    assert (wparams.num_limbs, wparams.bits_per_limb) == (6, 43)

    cs = ConstraintSystem(FR)
    var_sponge = PoseidonSpongeVar(cs, CFG)
    var_sponge.absorb([FpVar.new_witness(cs, v) for v in rand_fr(1)])
    # Consume the squeeze, then measure ONLY the limb-packing accounting.
    per = BN254_FR.modulus_bit_size - 1
    bits = var_sponge.squeeze_bits(2 * per)
    from sponge_jax.tracer import bits_le_to_nonnative

    base_w, base_c = cs.num_witness_variables, cs.num_constraints
    gadgets = bits_le_to_nonnative(cs, [bits[:per], bits[per:]], BN254_FR)
    assert cs.num_witness_variables - base_w == 2 * params.num_limbs
    assert cs.num_constraints - base_c == 2 * params.num_limbs
    for limbs in gadgets:
        assert len(limbs) == params.num_limbs
        # Big-endian: every limb holds < 2^bits_per_limb (canonical windows).
        assert all(l.value < (1 << params.bits_per_limb) for l in limbs)
    assert cs.is_satisfied()


def test_gadget_byte_encoding_matches_native():
    """Gadget byte-mode == native byte codec (constraints/absorb.rs:239-265):
    u8 batches (no length prefix) and field elements (full LE bytes)."""
    cs = ConstraintSystem(FR)
    data = bytes([0, 1, 2, 3, 4, 5])
    gadget = [UInt8.constant(b, FR) for b in data]
    got = bytes(b.value for b in to_sponge_bytes_gadget(gadget, cs, FR))
    assert got == to_sponge_bytes(data)

    vals = rand_fr(10)
    fp_vars = [FpVar.new_witness(cs, v) for v in vals]
    got = bytes(b.value for b in to_sponge_bytes_gadget(fp_vars, cs, FR))
    assert got == to_sponge_bytes([Fp(v, FR) for v in vals])
    assert cs.is_satisfied()

    # Boolean: single byte (absorb.rs:75-77).
    assert [b.value for b in to_sponge_bytes_gadget(Boolean.constant(True, FR), cs, FR)] == [1]


def test_gadget_option_matches_native():
    """OptionVar in both wire formats vs the native Some/NONE codec
    (constraints/absorb.rs:169-187 vs absorb.rs:288-302)."""
    x = rand_fr(1)[0]
    cs = ConstraintSystem(FR)
    some = OptionVar(FpVar.new_witness(cs, x))
    none = OptionVar(None)

    got_elems = [e.value for e in to_sponge_field_elements_gadget(some, cs, FR)]
    assert got_elems == to_sponge_field_elements(Some(Fp(x, FR)), FR)
    got_elems = [e.value for e in to_sponge_field_elements_gadget(none, cs, FR)]
    assert got_elems == to_sponge_field_elements(NONE, FR)

    got_bytes = bytes(b.value for b in to_sponge_bytes_gadget(some, cs, FR))
    assert got_bytes == to_sponge_bytes(Some(Fp(x, FR)))
    got_bytes = bytes(b.value for b in to_sponge_bytes_gadget(none, cs, FR))
    assert got_bytes == to_sponge_bytes(NONE)


def test_fork_matches_native():
    vals = rand_fr(2)
    cs = ConstraintSystem(FR)
    var_sponge = PoseidonSpongeVar(cs, CFG)
    var_sponge.absorb([FpVar.new_witness(cs, v) for v in vals])
    native = OraclePoseidonSponge(CFG)
    native.absorb_field_elements(vals)
    got = [e.value for e in var_sponge.fork(b"dom").squeeze_field_elements(2)]
    assert got == native.fork(b"dom").squeeze_native_field_elements(2)


def test_tampered_witness_fails():
    """A corrupted witness must make is_satisfied() return False."""
    cs = ConstraintSystem(FR)
    var_sponge = PoseidonSpongeVar(cs, CFG)
    var_sponge.absorb([FpVar.new_witness(cs, v) for v in rand_fr(2)])
    var_sponge.squeeze_field_elements(1)
    assert cs.is_satisfied()
    cs.witness[len(cs.witness) // 2] = (cs.witness[len(cs.witness) // 2] + 1) % FR.modulus
    assert not cs.is_satisfied()


def test_gadget_macros_equivalence():
    """absorb_gadget! / collect_sponge_field_elements_gadget! analogues
    (constraints/absorb.rs:201-223): sequential absorbs == one absorb of the
    collected encoding."""
    from sponge_jax.tracer import absorb_gadget, collect_sponge_field_elements_gadget

    vals = rand_fr(3)
    cs = ConstraintSystem(FR)
    items = [FpVar.new_witness(cs, vals[0]), Boolean.constant(True, FR),
             [FpVar.new_witness(cs, v) for v in vals[1:]]]

    s1 = PoseidonSpongeVar(cs, CFG)
    absorb_gadget(s1, *items)

    s2 = PoseidonSpongeVar(cs, CFG)
    s2.absorb(collect_sponge_field_elements_gadget(cs, FR, *items))

    assert [e.value for e in s1.squeeze_field_elements(2)] == [
        e.value for e in s2.squeeze_field_elements(2)
    ]
    assert cs.is_satisfied()
