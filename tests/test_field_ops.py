"""Batched Montgomery limb-plane kernels vs the python-int oracle.

Kernel-tier ≡ oracle-tier consistency, the batched analogue of the reference's
native↔gadget consistency tests (SURVEY.md §4 category 5).
"""

import numpy as np
import pytest

import jax

from sponge_jax.fields import BLS12_381_FR, BN254_FR, LIMB_BITS
from sponge_jax.ops import montgomery as mont

FIELDS = [BLS12_381_FR, BN254_FR]
RNG = np.random.default_rng(0)


def rand_ints(fs, n, adversarial=False):
    if adversarial:
        # Boundary-heavy values: 0, 1, p-1, p-2, values with all-ones limb patterns.
        specials = [0, 1, fs.modulus - 1, fs.modulus - 2, (1 << 255) % fs.modulus,
                    int("f" * 63, 16) % fs.modulus]
        return (specials * ((n // len(specials)) + 1))[:n]
    return [int(RNG.integers(0, 2 ** 63)) ** 4 % fs.modulus for _ in range(n)]


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_limb_roundtrip(fs):
    for x in rand_ints(fs, 16) + rand_ints(fs, 6, adversarial=True):
        assert fs.limbs_to_int(fs.int_to_limbs(x)) == x
        assert fs.mont_limbs_to_int(fs.int_to_mont_limbs(x)) == x


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("adversarial", [False, True])
def test_mont_mul(fs, adversarial):
    oracle = mont.OracleField(fs)
    n = 12
    xs = rand_ints(fs, n, adversarial)
    ys = list(reversed(rand_ints(fs, n, adversarial)))
    a = jax.numpy.asarray(fs.ints_to_mont_plane(xs))
    b = jax.numpy.asarray(fs.ints_to_mont_plane(ys))
    out = mont.mont_mul(fs, a, b)
    got = fs.mont_plane_to_ints(np.asarray(out))
    want = [oracle.mul(x, y) for x, y in zip(xs, ys)]
    assert got == want
    # redundant-limb invariant maintained
    assert int(np.max(np.asarray(out))) <= 1 << LIMB_BITS
    assert int(np.min(np.asarray(out))) >= 0


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_mont_add_kary(fs):
    oracle = mont.OracleField(fs)
    n = 8
    cols = [rand_ints(fs, n) for _ in range(5)]
    planes = [jax.numpy.asarray(fs.ints_to_mont_plane(c)) for c in cols]
    out = mont.mont_add(fs, *planes)
    got = fs.mont_plane_to_ints(np.asarray(out))
    want = [sum(vals) % fs.modulus for vals in zip(*cols)]
    assert got == want


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("alpha", [5, 17, 257])
def test_mont_pow(fs, alpha):
    oracle = mont.OracleField(fs)
    xs = rand_ints(fs, 8) + [0, 1, fs.modulus - 1]
    a = jax.numpy.asarray(fs.ints_to_mont_plane(xs))
    out = mont.mont_pow(fs, a, alpha)
    got = fs.mont_plane_to_ints(np.asarray(out))
    want = [oracle.pow(x, alpha) for x in xs]
    assert got == want


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_to_from_mont_device(fs):
    xs = rand_ints(fs, 8, adversarial=True)
    plain = np.stack([fs.int_to_limbs(x) for x in xs], axis=-1).astype(np.int32)
    m = mont.to_mont(fs, jax.numpy.asarray(plain))
    got = fs.mont_plane_to_ints(np.asarray(m))
    assert got == xs  # to_mont then interpret-as-montgomery == identity on values

    back = mont.from_mont(fs, m)
    back_np = np.asarray(back)
    for i, x in enumerate(xs):
        assert fs.limbs_to_int(back_np[:, i]) == x  # canonical plain limbs


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_canonicalize_unique(fs):
    # from_mont output must be the unique representative < p even for x = 0 and
    # values whose Montgomery reduction lands exactly on p.
    xs = [0, 1, fs.modulus - 1]
    m = jax.numpy.asarray(fs.ints_to_mont_plane(xs))
    out = np.asarray(mont.from_mont(fs, m))
    for i, x in enumerate(xs):
        assert fs.limbs_to_int(out[:, i]) == x
        assert np.all(out[:, i] <= (1 << LIMB_BITS) - 1)
