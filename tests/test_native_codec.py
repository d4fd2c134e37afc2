"""Native C++ host codec ≡ pure-python codec (bit-exact), with graceful fallback."""

import numpy as np
import pytest

from sponge_jax.fields import BLS12_381_FR, BN254_FR
from sponge_jax.utils.native import (
    decode_mont_plane_native,
    encode_mont_plane_native,
    get_lib,
)

RNG = np.random.default_rng(31)
FIELDS = [BLS12_381_FR, BN254_FR]

needs_native = pytest.mark.skipif(
    get_lib() is None, reason="native codec unavailable (no C++ toolchain)"
)


def rand_vals(fs, n):
    vals = [int(RNG.integers(0, 2 ** 63)) ** 4 % fs.modulus for _ in range(n)]
    return vals + [0, 1, fs.modulus - 1, fs.modulus - 2]


@needs_native
@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_native_encode_matches_python(fs):
    xs = rand_vals(fs, 32)
    want = np.stack([fs.int_to_mont_limbs(x) for x in xs], axis=-1).astype(np.int32)
    buf = b"".join(x.to_bytes(32, "little") for x in xs)
    got = encode_mont_plane_native(fs, buf, len(xs))
    assert np.array_equal(got, want)


@needs_native
@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_native_decode_roundtrip(fs):
    xs = rand_vals(fs, 32)
    plane = np.stack([fs.int_to_mont_limbs(x) for x in xs], axis=-1).astype(np.int32)
    raw = decode_mont_plane_native(fs, plane)
    got = [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(len(xs))]
    assert got == xs


@needs_native
def test_native_decode_redundant_limbs():
    """Device planes carry redundant limbs (values up to 2^12 and total value up
    to ~2p); the native decoder must canonicalize them."""
    fs = BLS12_381_FR
    xs = rand_vals(fs, 8)
    plane = np.stack([fs.int_to_mont_limbs(x) for x in xs], axis=-1).astype(np.int64)
    # add 3p (in limb form) so the represented value exceeds 2^256 — the worst
    # case produced by the device's MDS sum-of-products (~4.2p bound).
    p_limbs = fs.int_to_limbs(3 * fs.modulus).astype(np.int64)
    plane = plane + p_limbs[:, None]
    assert plane.max() <= (1 << 14)
    raw = decode_mont_plane_native(fs, plane.astype(np.int32))
    got = [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(len(xs))]
    assert got == xs


def test_field_api_uses_native_transparently():
    """ints_to_mont_plane/mont_plane_to_ints agree with the scalar python path
    regardless of which tier actually ran."""
    fs = BLS12_381_FR
    xs = rand_vals(fs, 16)
    plane = fs.ints_to_mont_plane(xs)
    want = np.stack([fs.int_to_mont_limbs(x) for x in xs], axis=-1).astype(np.int32)
    assert np.array_equal(plane, want)
    assert fs.mont_plane_to_ints(plane) == xs
