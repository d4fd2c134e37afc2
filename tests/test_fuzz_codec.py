"""Fuzz: random typed absorb structures + random squeeze schedules, device ≡
oracle.  Exercises the full codec surface through both sponges in one walk."""

import numpy as np
import pytest

from sponge_jax import (
    BLS12_381_FR,
    NONE,
    Fp,
    I8,
    I64,
    PoseidonSponge,
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
    get_default_poseidon_parameters,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge

FR = BLS12_381_FR
CFG = get_default_poseidon_parameters(FR, 2, False)


def random_absorbable(rng, depth=0):
    kinds = [
        "u8", "u16", "u32", "u64", "u128", "i8", "i64", "usize", "bool",
        "fp", "bytes", "point_te", "point_sw", "option",
    ]
    if depth < 2:
        kinds += ["list", "with_length"]
    kind = rng.choice(kinds)
    r = lambda b: int(rng.integers(0, 1 << b))
    if kind == "u8":
        return U8(r(8))
    if kind == "u16":
        return U16(r(16))
    if kind == "u32":
        return U32(r(32))
    if kind == "u64":
        return U64(r(63))
    if kind == "u128":
        return U128(r(63) * r(63))
    if kind == "i8":
        return I8(int(rng.integers(-128, 128)))
    if kind == "i64":
        return I64(int(rng.integers(-(1 << 62), 1 << 62)))
    if kind == "usize":
        return Usize(r(40))
    if kind == "bool":
        return bool(rng.integers(0, 2))
    if kind == "fp":
        return Fp(r(63) ** 4 % FR.modulus, FR)
    if kind == "bytes":
        return bytes(rng.integers(0, 256, size=int(rng.integers(0, 70)), dtype=np.uint8))
    if kind == "point_te":
        return TEPoint(Fp(r(63), FR), Fp(r(63), FR))
    if kind == "point_sw":
        return SWPoint(Fp(r(63), FR), Fp(r(63), FR), bool(rng.integers(0, 2)))
    if kind == "option":
        return Some(random_absorbable(rng, depth + 1)) if rng.integers(0, 2) else NONE
    if kind == "with_length":
        return WithLength(
            bytes(rng.integers(0, 256, size=int(rng.integers(1, 20)), dtype=np.uint8))
        )
    if kind == "list":
        return [random_absorbable(rng, depth + 1) for _ in range(int(rng.integers(1, 4)))]
    raise AssertionError(kind)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_typed_absorbs_device_vs_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    dev = PoseidonSponge(CFG, batch_size=2)
    o = OraclePoseidonSponge(CFG)
    for _ in range(10):
        action = rng.choice(["absorb", "squeeze", "bytes", "bits"])
        if action == "absorb":
            value = random_absorbable(rng)
            dev.absorb(value)
            o.absorb(value)
        elif action == "squeeze":
            n = int(rng.integers(1, 6))
            assert dev.squeeze_native_field_elements(n) == [
                o.squeeze_native_field_elements(n)
            ] * 2, f"squeeze({n})"
        elif action == "bytes":
            n = int(rng.integers(1, 70))
            assert dev.squeeze_bytes(n) == [o.squeeze_bytes(n)] * 2
        else:
            n = int(rng.integers(1, 300))
            assert dev.squeeze_bits(n) == [o.squeeze_bits(n)] * 2
    assert dev.mode == o.mode and dev.index == o.index
