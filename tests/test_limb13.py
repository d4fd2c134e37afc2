"""13-bit limb plan (DESIGN §7): width-parameterized limb planes.

The 13-bit plan (L 22 -> 20 for 255-bit fields) threads the limb width
through every codec and XLA-tier helper; FieldSpec classifies each field's
32-bit column budget (fields.py ``unsigned_accum``).  These tests pin:

  * FieldSpec budget classification (int32 / uint32 / reject) and the
    13-bit host codecs;
  * XLA-tier parity vs the scalar oracle at a 13-bit tiny field and at a
    15-bit field whose worst kernel column would exceed 2^31, across widths
    and S-box degrees.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from conftest import tiny_poseidon_config  # noqa: E402

from sponge_jax.fields import BLS12_381_FR, BLS12_381_FR_L13, FieldSpec  # noqa: E402

TINY13 = FieldSpec(name="tiny13", modulus=(1 << 35) - 31, generator=3, limb_bits=13)
# 25-bit modulus at 15-bit limbs: L=2, worst column bound lands in
# [2^31, 2^32) -> unsigned_accum=True with a cheap kernel body.
TINY_U15 = FieldSpec(
    name="tiny_u15", modulus=(1 << 25) - 39, generator=3, limb_bits=15
)


def test_field_spec_budget_classification():
    assert BLS12_381_FR.nlimbs == 22 and not BLS12_381_FR.unsigned_accum
    assert BLS12_381_FR_L13.nlimbs == 20 and BLS12_381_FR_L13.unsigned_accum
    assert BLS12_381_FR_L13.modulus == BLS12_381_FR.modulus
    assert BLS12_381_FR_L13.name == BLS12_381_FR.name  # same field identity
    assert not TINY13.unsigned_accum
    assert TINY_U15.unsigned_accum
    with pytest.raises(ValueError):
        FieldSpec(name="x", modulus=BLS12_381_FR.modulus, generator=7, limb_bits=14)


def test_codec_roundtrip_13bit():
    fs = BLS12_381_FR_L13
    rng = np.random.default_rng(3)
    xs = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=16)] + [
        0,
        1,
        fs.modulus - 1,
        fs.modulus - 2,
    ]
    for x in xs:
        assert fs.limbs_to_int(fs.int_to_limbs(x)) == x
        assert fs.mont_limbs_to_int(fs.int_to_mont_limbs(x)) == x
        assert int(fs.int_to_limbs(x).max()) <= fs.limb_mask
    plane = fs.ints_to_mont_plane(xs)
    assert plane.shape == (20, len(xs))
    assert fs.mont_plane_to_ints(plane) == xs


@pytest.mark.parametrize("alpha", [3, 5, 17], ids=["a3", "a5", "a17"])
@pytest.mark.parametrize("t", [2, 3, 4], ids=["t2", "t3", "t4"])
@pytest.mark.parametrize("fs", [TINY13, TINY_U15], ids=["tiny13", "tiny_u15"])
def test_xla_tier_parity_widths_and_degrees(fs, t, alpha):
    """The XLA tier at non-12-bit limb widths over every width the main path
    uses and each shipped S-box degree (alpha = 3 takes the value-safe
    folding round where its fixpoint would reach R)."""
    from conftest import check_permutation_vs_oracle

    cfg = tiny_poseidon_config(t=t, alpha=alpha, field=fs, seed=3 + t)
    check_permutation_vs_oracle(cfg, B=64, stride=9, seed=alpha)


@pytest.mark.parametrize("fs", [TINY13, TINY_U15], ids=["tiny13", "tiny_u15"])
def test_xla_tier_parity_nonstandard_widths(fs):
    """The generic XLA tier (ops/montgomery.py) is limb-width-parameterized:
    its non-interleaved REDC normalizes between steps, so columns stay int32
    at 13-bit limbs (bound analysis in ``normalize``'s docstring)."""
    from sponge_jax.poseidon.permutation import batched_permute

    cfg = tiny_poseidon_config(field=fs)
    rng = np.random.default_rng(5)
    B = 256
    vals = [
        [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=B)]
        for _ in range(cfg.t)
    ]
    state = np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
    out = np.asarray(batched_permute(cfg, state, backend="xla"))
    for k in range(0, B, 37):
        o = cfg.oracle_sponge()
        o.state = [vals[i][k] for i in range(cfg.t)]
        o.permute()
        got = [fs.mont_limbs_to_int(out[i][:, k]) % fs.modulus for i in range(cfg.t)]
        assert got == [v % fs.modulus for v in o.state], (fs.name, k)
