"""Monolith permutation family (ePrint 2023/1025 structure) behind the
shared duplex sponge machinery — see config.py for the limb-plane design."""

from .config import MonolithConfig, bar_chunks, bar_int, chunk_sbox
from .oracle import OracleMonolithSponge
from .params import generate_monolith_parameters, get_default_monolith_parameters
from .permutation import batched_monolith_permute, monolith_permute_jit

__all__ = [
    "MonolithConfig",
    "bar_chunks",
    "bar_int",
    "chunk_sbox",
    "OracleMonolithSponge",
    "generate_monolith_parameters",
    "get_default_monolith_parameters",
    "batched_monolith_permute",
    "monolith_permute_jit",
]
