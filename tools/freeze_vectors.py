"""Generate / load the frozen regression-vector corpus.

SURVEY.md §7.3 item 2 calls for a wide, *frozen* cross-checking corpus: mixed
typed absorbs (bytes, bools, ints, signed ints, field elements, curve points,
Options, WithLength, nested lists) interleaved with every squeeze flavor
(native elements, bytes, bits, nonnative elements), with the exact outputs
pinned as JSON.  The live oracle (sponge_jax.poseidon.oracle) is itself anchored
to the three in-reference golden vectors; this corpus extends that anchor across
the whole codec surface so future kernel/codec rewrites diff against *frozen*
values rather than against code that may be rewritten alongside them.

Usage:
    python tools/freeze_vectors.py            # writes vectors/regression_corpus.json
                                              # (refuses to overwrite; pass --force)

The corpus layout (per schedule): the typed absorb values (self-describing
tagged JSON), each value's byte-mode and field-element-mode encodings, every
squeeze output, and the final duplex (mode, index).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from sponge_jax import (  # noqa: E402
    BLS12_381_FR,
    BN254_FR,
    NONE,
    Fp,
    I8,
    I64,
    SWPoint,
    Some,
    TEPoint,
    U8,
    U16,
    U32,
    U64,
    U128,
    Usize,
    WithLength,
    get_default_poseidon_parameters,
    to_sponge_bytes,
    to_sponge_field_elements,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge  # noqa: E402

FR = BLS12_381_FR
CORPUS_PATH = pathlib.Path(__file__).resolve().parent.parent / "vectors" / "regression_corpus.json"

NUM_SCHEDULES = 24
STEPS_PER_SCHEDULE = 12


# ---------------------------------------------------------------------------
# Tagged-JSON serde for typed absorbable values.
# ---------------------------------------------------------------------------

def ser_value(v):
    if isinstance(v, U8):
        return {"t": "u8", "v": int(v)}
    if isinstance(v, U16):
        return {"t": "u16", "v": int(v)}
    if isinstance(v, U32):
        return {"t": "u32", "v": int(v)}
    if isinstance(v, U64):
        return {"t": "u64", "v": str(int(v))}
    if isinstance(v, U128):
        return {"t": "u128", "v": str(int(v))}
    if isinstance(v, I8):
        return {"t": "i8", "v": int(v)}
    if isinstance(v, I64):
        return {"t": "i64", "v": str(int(v))}
    if isinstance(v, Usize):
        return {"t": "usize", "v": str(int(v))}
    if isinstance(v, bool):
        return {"t": "bool", "v": v}
    if isinstance(v, Fp):
        return {"t": "fp", "v": str(v.value), "field": v.field.name}
    if isinstance(v, bytes):
        return {"t": "bytes", "v": v.hex()}
    if isinstance(v, TEPoint):
        return {"t": "te", "x": str(v.x.value), "y": str(v.y.value)}
    if isinstance(v, SWPoint):
        return {
            "t": "sw",
            "x": str(v.x.value),
            "y": str(v.y.value),
            "infinity": v.infinity,
        }
    if v is NONE:
        return {"t": "none"}
    if isinstance(v, Some):
        return {"t": "some", "v": ser_value(v.value)}
    if isinstance(v, WithLength):
        return {"t": "withlen", "v": ser_value(v.value)}
    if isinstance(v, list):
        return {"t": "list", "v": [ser_value(e) for e in v]}
    raise TypeError(f"cannot serialize {type(v)!r}")


def de_value(d):
    from sponge_jax import get_field

    t = d["t"]
    if t == "u8":
        return U8(d["v"])
    if t == "u16":
        return U16(d["v"])
    if t == "u32":
        return U32(d["v"])
    if t == "u64":
        return U64(int(d["v"]))
    if t == "u128":
        return U128(int(d["v"]))
    if t == "i8":
        return I8(d["v"])
    if t == "i64":
        return I64(int(d["v"]))
    if t == "usize":
        return Usize(int(d["v"]))
    if t == "bool":
        return bool(d["v"])
    if t == "fp":
        return Fp(int(d["v"]), get_field(d["field"]))
    if t == "bytes":
        return bytes.fromhex(d["v"])
    if t == "te":
        return TEPoint(Fp(int(d["x"]), FR), Fp(int(d["y"]), FR))
    if t == "sw":
        return SWPoint(Fp(int(d["x"]), FR), Fp(int(d["y"]), FR), d["infinity"])
    if t == "none":
        return NONE
    if t == "some":
        return Some(de_value(d["v"]))
    if t == "withlen":
        return WithLength(de_value(d["v"]))
    if t == "list":
        return [de_value(e) for e in d["v"]]
    raise TypeError(f"cannot deserialize tag {t!r}")


# ---------------------------------------------------------------------------
# Deterministic schedule generation (mirrors tests/test_fuzz_codec.py kinds).
# ---------------------------------------------------------------------------

def random_absorbable(rng, depth=0):
    kinds = [
        "u8", "u16", "u32", "u64", "u128", "i8", "i64", "usize", "bool",
        "fp", "bytes", "point_te", "point_sw", "option", "withlen_bytes",
    ]
    if depth < 2:
        kinds += ["list", "withlen_list"]
    kind = rng.choice(kinds)
    r = lambda b: int(rng.integers(0, 1 << b))  # noqa: E731
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
    if kind == "withlen_bytes":
        return WithLength(
            bytes(rng.integers(0, 256, size=int(rng.integers(1, 20)), dtype=np.uint8))
        )
    if kind == "withlen_list":
        return WithLength(
            [random_absorbable(rng, depth + 1) for _ in range(int(rng.integers(1, 4)))]
        )
    if kind == "list":
        return [random_absorbable(rng, depth + 1) for _ in range(int(rng.integers(1, 4)))]
    raise AssertionError(kind)


def generate_schedule(seed: int):
    rng = np.random.default_rng(7000 + seed)
    cfg = get_default_poseidon_parameters(FR, 2, False)
    o = OraclePoseidonSponge(cfg)
    steps = []
    # Always start with one absorb so squeezes are meaningful.
    first = random_absorbable(rng)
    steps.append(_absorb_step(o, first))
    for _ in range(STEPS_PER_SCHEDULE - 1):
        action = rng.choice(
            ["absorb", "squeeze_native", "squeeze_bytes", "squeeze_bits",
             "squeeze_nonnative"]
        )
        if action == "absorb":
            steps.append(_absorb_step(o, random_absorbable(rng)))
        elif action == "squeeze_native":
            n = int(rng.integers(1, 6))
            out = o.squeeze_native_field_elements(n)
            steps.append({"op": "squeeze_native", "n": n, "out": [str(v) for v in out]})
        elif action == "squeeze_bytes":
            n = int(rng.integers(1, 70))
            out = o.squeeze_bytes(n)
            steps.append({"op": "squeeze_bytes", "n": n, "out": out.hex()})
        elif action == "squeeze_bits":
            n = int(rng.integers(1, 300))
            bits = o.squeeze_bits(n)
            packed = sum(int(b) << i for i, b in enumerate(bits))
            steps.append(
                {"op": "squeeze_bits", "n": n,
                 "out": packed.to_bytes((n + 7) // 8 or 1, "little").hex()}
            )
        else:
            n = int(rng.integers(1, 4))
            out = o.squeeze_field_elements(BN254_FR, n)
            steps.append(
                {"op": "squeeze_nonnative", "n": n, "field": "bn254_fr",
                 "out": [str(v) for v in out]}
            )
    return {
        "seed": seed,
        "steps": steps,
        "final_mode": o.mode,
        "final_index": o.index,
        "final_state": [str(v) for v in o.state],
    }


def _absorb_step(o, value):
    enc_bytes = to_sponge_bytes(value)
    enc_elems = to_sponge_field_elements(value, FR)
    o.absorb(value)
    return {
        "op": "absorb",
        "value": ser_value(value),
        "enc_bytes": enc_bytes.hex(),
        "enc_elems": [str(v) for v in enc_elems],
    }


def generate_corpus():
    return {
        "description": "Frozen regression corpus: typed absorbs + all squeeze "
        "flavors over BLS12-381 Fr default rate-2 params (ark-sponge parity "
        "semantics; see tools/freeze_vectors.py)",
        "field": FR.name,
        "rate": 2,
        "optimized_for_weights": False,
        "schedules": [generate_schedule(s) for s in range(NUM_SCHEDULES)],
    }


def load_corpus():
    with open(CORPUS_PATH) as f:
        return json.load(f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--force", action="store_true", help="overwrite existing corpus")
    args = ap.parse_args()
    if CORPUS_PATH.exists() and not args.force:
        # Frozen means frozen: regenerating silently would defeat the corpus.
        raise SystemExit(f"{CORPUS_PATH} exists; pass --force to regenerate")
    corpus = generate_corpus()
    CORPUS_PATH.write_text(json.dumps(corpus, indent=1) + "\n")
    n_steps = sum(len(s["steps"]) for s in corpus["schedules"])
    print(f"wrote {CORPUS_PATH} ({len(corpus['schedules'])} schedules, {n_steps} steps)")


if __name__ == "__main__":
    main()
