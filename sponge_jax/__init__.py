"""sponge_jax: a batched cryptographic (duplex) sponge framework for JAX.

A from-scratch JAX/Pallas rebuild of the capabilities of `arkworks-rs/sponge`
(`ark-sponge`): the `CryptographicSponge` duplex API, the Poseidon permutation,
Grain-LFSR parameter generation, the Absorb input codec, sponge state
save/restore, and a constraint-tracing mirror — re-architected around batched
limb-plane field arithmetic (XLA-compiled for the GPU) and `jax.sharding`
data parallelism.
"""

from .absorb import (
    NONE,
    Fp,
    I8,
    I16,
    I32,
    I64,
    I128,
    Isize,
    Some,
    SWPoint,
    TEPoint,
    U8,
    U16,
    U32,
    U64,
    U128,
    Usize,
    WithLength,
    collect_sponge_bytes,
    collect_sponge_field_elements,
    to_sponge_bytes,
    to_sponge_field_elements,
)
from .absorb import field_cast
from .fields import (
    BABYBEAR_FR,
    BLS12_377_FR,
    BLS12_381_FR,
    BLS12_381_FR_L13,
    BN254_FR,
    GOLDILOCKS_FR,
    KOALABEAR_FR,
    MERSENNE31_FR,
    FieldSpec,
    get_field,
)
from .poseidon.config import PoseidonConfig
from .poseidon.oracle import (
    ABSORBING,
    FULL,
    SQUEEZING,
    OraclePoseidonSponge,
    SpongeState,
    Truncated,
    field_element_size_num_bits,
    field_element_size_sum,
)
from .poseidon.params import (
    find_poseidon_ark_and_mds,
    get_default_poseidon_parameters,
    poseidon_test_fixture,
    register_default_table,
)
from .poseidon2 import (
    OraclePoseidon2Sponge,
    Poseidon2Config,
    generate_poseidon2_parameters,
    get_default_poseidon2_parameters,
)
from .rescue import (
    OracleRescueSponge,
    RescueConfig,
    generate_rescue_parameters,
    get_default_rescue_parameters,
)
from .monolith import (
    MonolithConfig,
    OracleMonolithSponge,
    generate_monolith_parameters,
    get_default_monolith_parameters,
)
from .griffin import (
    GriffinConfig,
    OracleGriffinSponge,
    generate_griffin_parameters,
    get_default_griffin_parameters,
)
from .anemoi import (
    AnemoiConfig,
    OracleAnemoiSponge,
    generate_anemoi_parameters,
    get_default_anemoi_parameters,
)
from .gmimc import (
    GmimcConfig,
    OracleGmimcSponge,
    generate_gmimc_parameters,
    get_default_gmimc_parameters,
)
from .lazy import LazyPoseidonSponge
from .poseidon.host import (
    HostAnemoiSponge,
    HostGmimcSponge,
    HostGriffinSponge,
    HostMonolithSponge,
    HostPoseidon2Sponge,
    HostRescueSponge,
    HostPoseidonSponge,
    host_available,
    host_run_schedule,
)
from .sponge import Batched, PoseidonSponge
from .transcript import Absorb as TranscriptAbsorb
from .transcript import SqueezeNative as TranscriptSqueeze
from .transcript import compile_transcript

__all__ = [
    "compile_transcript",
    "TranscriptAbsorb",
    "TranscriptSqueeze",
    "ABSORBING",
    "SQUEEZING",
    "OraclePoseidonSponge",
    "field_cast",
    "poseidon_test_fixture",
    "BLS12_381_FR",
    "BLS12_381_FR_L13",
    "BN254_FR",
    "BLS12_377_FR",
    "GOLDILOCKS_FR",
    "BABYBEAR_FR",
    "MERSENNE31_FR",
    "KOALABEAR_FR",
    "FieldSpec",
    "get_field",
    "PoseidonConfig",
    "find_poseidon_ark_and_mds",
    "get_default_poseidon_parameters",
    "register_default_table",
    "PoseidonSponge",
    "LazyPoseidonSponge",
    "HostPoseidonSponge",
    "HostAnemoiSponge",
    "HostGmimcSponge",
    "HostGriffinSponge",
    "HostMonolithSponge",
    "HostPoseidon2Sponge",
    "HostRescueSponge",
    "Poseidon2Config",
    "OraclePoseidon2Sponge",
    "generate_poseidon2_parameters",
    "get_default_poseidon2_parameters",
    "RescueConfig",
    "OracleRescueSponge",
    "generate_rescue_parameters",
    "get_default_rescue_parameters",
    "MonolithConfig",
    "OracleMonolithSponge",
    "generate_monolith_parameters",
    "get_default_monolith_parameters",
    "GriffinConfig",
    "OracleGriffinSponge",
    "generate_griffin_parameters",
    "get_default_griffin_parameters",
    "AnemoiConfig",
    "OracleAnemoiSponge",
    "generate_anemoi_parameters",
    "get_default_anemoi_parameters",
    "GmimcConfig",
    "OracleGmimcSponge",
    "generate_gmimc_parameters",
    "get_default_gmimc_parameters",
    "host_available",
    "host_run_schedule",
    "Batched",
    "SpongeState",
    "FULL",
    "Truncated",
    "field_element_size_num_bits",
    "field_element_size_sum",
    "Fp",
    "U8",
    "U16",
    "U32",
    "U64",
    "U128",
    "I8",
    "I16",
    "I32",
    "I64",
    "I128",
    "Usize",
    "Isize",
    "Some",
    "NONE",
    "WithLength",
    "SWPoint",
    "TEPoint",
    "to_sponge_bytes",
    "to_sponge_field_elements",
    "collect_sponge_bytes",
    "collect_sponge_field_elements",
]

__version__ = "0.1.0"
