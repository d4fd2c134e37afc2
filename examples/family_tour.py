"""One sponge API, six permutation families, seven fields.

Everything above the permutation — the duplex sponge, the absorb codec,
transcripts, Merkle trees, checkpointing, sharding — is config-agnostic:
a config type provides a ``batched_permute`` hook and an oracle, and the
whole framework runs over it.

Run: python examples/family_tour.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

from sponge_jax import (
    BLS12_381_FR,
    GOLDILOCKS_FR,
    KOALABEAR_FR,
    MERSENNE31_FR,
    Fp,
    PoseidonSponge,
    U64,
    get_default_anemoi_parameters,
    get_default_gmimc_parameters,
    get_default_griffin_parameters,
    get_default_monolith_parameters,
    get_default_poseidon2_parameters,
    get_default_poseidon_parameters,
    get_default_rescue_parameters,
)

CONFIGS = [
    ("Poseidon / BLS12-381 (the reference instance)",
     get_default_poseidon_parameters(BLS12_381_FR, rate=2)),
    ("Poseidon2 / KoalaBear", get_default_poseidon2_parameters(KOALABEAR_FR, 8)),
    ("Rescue-Prime / Mersenne31", get_default_rescue_parameters(MERSENNE31_FR, 8)),
    ("Monolith / Goldilocks", get_default_monolith_parameters(GOLDILOCKS_FR)),
    ("Griffin / Goldilocks", get_default_griffin_parameters(GOLDILOCKS_FR, 4)),
    ("Anemoi / Goldilocks", get_default_anemoi_parameters(GOLDILOCKS_FR, 4)),
    ("GMiMC-erf / Goldilocks", get_default_gmimc_parameters(GOLDILOCKS_FR, 4)),
]

print("backend:", jax.default_backend())
for name, cfg in CONFIGS:
    fs = cfg.field
    s = PoseidonSponge(cfg, batch_size=8)  # 8 lanes in lockstep
    s.absorb(b"domain: example")           # bytes (u64-length-prefixed packing)
    s.absorb(U64(42))                       # typed ints
    s.absorb([Fp(3, fs), Fp(5, fs)])        # field elements
    sub = s.fork(b"sub-protocol")           # domain separation
    c = s.squeeze_native_field_elements(1)[0]
    b = sub.squeeze_bytes(8)[0]
    state = s.into_state()                  # SpongeExt checkpoint
    s2 = PoseidonSponge.from_state(state, cfg)
    assert s2.squeeze_native_field_elements(1) == s.squeeze_native_field_elements(1)
    print(f"  {name}: challenge={c[0]}  forked_bytes={b.hex()}")
