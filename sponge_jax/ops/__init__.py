"""Low-level batched field arithmetic (the XLA tier)."""

from .montgomery import (
    OracleField,
    canonicalize,
    from_mont,
    mont_add,
    mont_mul,
    mont_pow,
    to_mont,
)

__all__ = [
    "OracleField",
    "canonicalize",
    "from_mont",
    "mont_add",
    "mont_mul",
    "mont_pow",
    "to_mont",
]
