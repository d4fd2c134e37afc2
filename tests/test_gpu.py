"""The device path at production widths, on the card (``gpu`` marker).

XLA-CPU takes minutes to compile these shapes (L = 20/22 limbs), so they
skip here and run on the card only, inside ``python chip_smoke.py``.
"""

import pytest

import jax
import jax.numpy as jnp

from conftest import check_permutation_vs_oracle

from sponge_jax import (
    BLS12_381_FR,
    BLS12_381_FR_L13,
    BN254_FR,
    get_default_poseidon_parameters,
)
from sponge_jax.poseidon.permutation import batched_permute


@pytest.mark.gpu
@pytest.mark.parametrize(
    "field,rate",
    [(BLS12_381_FR_L13, 2), (BLS12_381_FR, 2), (BN254_FR, 3), (BLS12_381_FR, 8)],
    ids=["bls-l13-rate2", "bls-rate2", "bn254-rate3", "bls-rate8"],
)
def test_production_width_vs_oracle(gpu, field, rate):
    cfg = get_default_poseidon_parameters(field, rate, False)
    check_permutation_vs_oracle(cfg, B=1024, stride=61, backend="auto")


@pytest.mark.gpu
def test_permutation_runs_on_the_card(gpu):
    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, False)
    state = jnp.zeros((cfg.t, cfg.field.nlimbs, 256), jnp.int32)
    out = jax.block_until_ready(batched_permute(cfg, state))
    assert out.devices() == {gpu}
