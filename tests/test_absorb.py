"""Absorb codec tests: encoding injectivity + macro equivalence.

Mirrors /root/reference/src/poseidon/tests.rs:8-117 (assert_different_encodings,
variable-size lists, macros) and absorb.rs semantics over the typed wrappers.
"""

import numpy as np
import pytest

from sponge_jax import (
    BLS12_381_FR,
    BN254_FR,
    NONE,
    Fp,
    I64,
    Some,
    SWPoint,
    TEPoint,
    U8,
    U64,
    U128,
    Usize,
    WithLength,
    collect_sponge_bytes,
    collect_sponge_field_elements,
    get_default_poseidon_parameters,
    to_sponge_bytes,
    to_sponge_field_elements,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

FR = BLS12_381_FR
CFG = get_default_poseidon_parameters(FR, 2, False)
RNG = np.random.default_rng(3)


def rand_fr():
    return int(RNG.integers(0, 2 ** 63)) ** 4 % FR.modulus


def assert_different_encodings(a, b):
    """tests.rs:8-24: byte encodings differ AND squeezed outputs differ."""
    assert to_sponge_bytes(a) != to_sponge_bytes(b)
    s1, s2 = OraclePoseidonSponge(CFG), OraclePoseidonSponge(CFG)
    s1.absorb(a)
    s2.absorb(b)
    assert s1.squeeze_native_field_elements(3) != s2.squeeze_native_field_elements(3)


def test_single_field_element():
    """tests.rs:27-33."""
    x = rand_fr()
    assert_different_encodings(Fp(x, FR), Fp((x + 1) % FR.modulus, FR))


def test_list_with_constant_size_element():
    """tests.rs:36-43 (scaled down from 8K to keep the oracle fast)."""
    lst1 = [Fp(rand_fr(), FR) for _ in range(256)]
    lst2 = list(lst1)
    lst2[3] = Fp((lst2[3].value + 1) % FR.modulus, FR)
    assert_different_encodings(lst1, lst2)


def test_list_with_nonconstant_size_element():
    """tests.rs:57-69: length prefixes distinguish [[1,2,3,4],[5,6]] from
    [[1,2],[3,4,5,6]]."""
    lst1 = [WithLength(bytes([1, 2, 3, 4])), WithLength(bytes([5, 6]))]
    lst2 = [WithLength(bytes([1, 2])), WithLength(bytes([3, 4, 5, 6]))]
    assert_different_encodings(lst1, lst2)


def test_macros_equivalence():
    """tests.rs:88-117: sequential absorbs ≡ absorb! macro; collect_* ≡ manual."""
    s1 = OraclePoseidonSponge(CFG)
    s1.absorb([U64(i) for i in [1, 2, 3, 4, 5, 6]])
    s1.absorb(Fp(114514, FR))
    s2 = OraclePoseidonSponge(CFG)
    for item in ([U64(i) for i in [1, 2, 3, 4, 5, 6]], Fp(114514, FR)):
        s2.absorb(item)
    assert s1.squeeze_native_field_elements(3) == s2.squeeze_native_field_elements(3)

    manual = bytearray()
    manual.extend(to_sponge_bytes([U64(i) for i in [6, 5, 4, 3, 2, 1]]))
    manual.extend(to_sponge_bytes(Fp(42, FR)))
    assert collect_sponge_bytes(
        [U64(i) for i in [6, 5, 4, 3, 2, 1]], Fp(42, FR)
    ) == bytes(manual)

    manual_fe = to_sponge_field_elements([U64(i) for i in [6, 5, 4, 3, 2, 1]], FR)
    to_sponge_field_elements(Fp(42, FR), FR, manual_fe)
    assert (
        collect_sponge_field_elements(FR, [U64(i) for i in [6, 5, 4, 3, 2, 1]], Fp(42, FR))
        == manual_fe
    )


def test_u8_batch_length_prefix():
    """absorb.rs:135-139: u64 LE length prefix + 31-byte LE chunk packing."""
    data = bytes(range(40))
    elems = to_sponge_field_elements(data, FR)
    payload = len(data).to_bytes(8, "little") + data
    assert elems[0] == int.from_bytes(payload[:31], "little")
    assert elems[1] == int.from_bytes(payload[31:], "little")
    # Byte mode has NO length prefix (absorb.rs:131-133).
    assert to_sponge_bytes(data) == data


def test_signed_ints_absorb_negative():
    """absorb.rs:186-208: negative -> -F::from(abs)."""
    assert to_sponge_field_elements(I64(-5), FR) == [(FR.modulus - 5)]
    assert to_sponge_field_elements(I64(5), FR) == [5]
    assert to_sponge_bytes(I64(-5)) == (-5).to_bytes(8, "little", signed=True)


def test_bool_option():
    """absorb.rs:142-150, 288-302."""
    assert to_sponge_field_elements(True, FR) == [1]
    assert to_sponge_field_elements(Some(U8(9)), FR) == [1, 9]
    assert to_sponge_field_elements(NONE, FR) == [0]
    assert to_sponge_bytes(Some(U8(9))) == bytes([1, 9])
    assert to_sponge_bytes(NONE) == bytes([0])


def test_u128_and_usize():
    v = (1 << 100) + 7
    assert to_sponge_field_elements(U128(v), FR) == [v % FR.modulus]
    assert to_sponge_bytes(U128(v)) == v.to_bytes(16, "little")
    assert to_sponge_bytes(Usize(3)) == (3).to_bytes(8, "little")


def test_fp_serialize_compressed():
    """absorb.rs:153-155: 32 canonical LE bytes for a 255-bit field element."""
    x = rand_fr()
    b = to_sponge_bytes(Fp(x, FR))
    assert len(b) == 32 and int.from_bytes(b, "little") == x


def test_curve_points():
    """absorb.rs:230-254: TE = [x, y]; SW = [x, y, infinity]."""
    x, y = rand_fr(), rand_fr()
    te = TEPoint(Fp(x, FR), Fp(y, FR))
    assert to_sponge_field_elements(te, FR) == [x, y]
    sw = SWPoint(Fp(x, FR), Fp(y, FR), infinity=False)
    assert to_sponge_field_elements(sw, FR) == [x, y, 0]
    # byte form: u64 length prefix + compressed coords
    bts = to_sponge_bytes(te)
    assert bts[:8] == (2).to_bytes(8, "little") and len(bts) == 8 + 64


def test_nonnative_fp_batch_raises():
    """Vec<Fp> over a different characteristic panics (absorb.rs:159-164)."""
    with pytest.raises(ValueError):
        to_sponge_field_elements([Fp(1, BN254_FR), Fp(2, BN254_FR)], FR)


def test_plain_int_rejected():
    with pytest.raises(TypeError):
        to_sponge_field_elements(5, FR)
