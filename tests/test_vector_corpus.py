"""Replay the frozen regression-vector corpus (vectors/regression_corpus.json).

The corpus pins typed-absorb encodings (byte + field-element wire formats) and
every squeeze flavor's outputs to values frozen at generation time
(tools/freeze_vectors.py), extending the three in-reference golden vectors
(/root/reference/src/poseidon/mod.rs:383-398) across the whole codec surface.
Future codec/kernel rewrites must reproduce these bytes, not merely agree with
whatever the live oracle then computes.
"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

from freeze_vectors import de_value, load_corpus  # noqa: E402

from sponge_jax import (  # noqa: E402
    BLS12_381_FR,
    PoseidonSponge,
    get_default_poseidon_parameters,
    get_field,
    to_sponge_bytes,
    to_sponge_field_elements,
)
from sponge_jax.poseidon.oracle import OraclePoseidonSponge  # noqa: E402

FR = BLS12_381_FR
CORPUS = load_corpus()
CFG = get_default_poseidon_parameters(
    get_field(CORPUS["field"]), CORPUS["rate"], CORPUS["optimized_for_weights"]
)

# Device replays are slower (per-step dispatch); a subset keeps CI time sane
# while still running every op kind through the batched sponge.
DEVICE_SCHEDULES = (0, 5, 11, 17, 23)


def _replay(sponge, schedule, *, device: bool):
    for step in schedule["steps"]:
        op = step["op"]
        if op == "absorb":
            value = de_value(step["value"])
            # The codec encodings themselves are pinned.
            assert to_sponge_bytes(value).hex() == step["enc_bytes"]
            assert [str(v) for v in to_sponge_field_elements(value, FR)] == step[
                "enc_elems"
            ]
            sponge.absorb(value)
        elif op == "squeeze_native":
            out = sponge.squeeze_native_field_elements(step["n"])
            if device:
                out = out[0]
            assert [str(v) for v in out] == step["out"], step
        elif op == "squeeze_bytes":
            out = sponge.squeeze_bytes(step["n"])
            if device:
                out = out[0]
            assert out.hex() == step["out"], step
        elif op == "squeeze_bits":
            bits = sponge.squeeze_bits(step["n"])
            if device:
                bits = bits[0]
            packed = sum(int(b) << i for i, b in enumerate(bits))
            n = step["n"]
            assert packed.to_bytes((n + 7) // 8 or 1, "little").hex() == step["out"]
        elif op == "squeeze_nonnative":
            target = get_field(step["field"])
            out = sponge.squeeze_field_elements(target, step["n"])
            if device:
                out = out[0]
            assert [str(v) for v in out] == step["out"], step
        else:
            raise AssertionError(op)


@pytest.mark.parametrize("idx", range(len(CORPUS["schedules"])), ids=lambda i: f"s{i}")
def test_corpus_oracle_replay(idx):
    schedule = CORPUS["schedules"][idx]
    o = OraclePoseidonSponge(CFG)
    _replay(o, schedule, device=False)
    assert o.mode == schedule["final_mode"]
    assert o.index == schedule["final_index"]
    assert [str(v) for v in o.state] == schedule["final_state"]


@pytest.mark.parametrize("idx", DEVICE_SCHEDULES, ids=lambda i: f"s{i}")
def test_corpus_device_replay(idx):
    schedule = CORPUS["schedules"][idx]
    dev = PoseidonSponge(CFG, batch_size=1)
    _replay(dev, schedule, device=True)
    assert dev.mode == schedule["final_mode"]
    assert dev.index == schedule["final_index"]


def test_rust_crosscheck_harness_in_sync():
    """The emitted Rust harness (tools/rust_crosscheck/) matches its generator
    and handles every tag the frozen corpus actually contains."""
    import pathlib
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo / "tools"))
    import gen_rust_crosscheck as gen

    out = repo / "tools" / "rust_crosscheck"
    assert (out / "Cargo.toml").read_text() == gen.CARGO_TOML
    assert (out / "src" / "main.rs").read_text() == gen.MAIN_RS
    assert (out / "README.md").read_text() == gen.README_MD

    # Every tag present in the corpus has a match arm in the Rust interpreter.
    tags = set()

    def walk(v):
        tags.add(v["t"])
        if v["t"] in ("some", "withlen"):
            walk(v["v"])
        if v["t"] == "list":
            for e in v["v"]:
                walk(e)

    for sch in CORPUS["schedules"]:
        for st in sch["steps"]:
            if st["op"] == "absorb":
                walk(st["value"])
    for t in tags:
        assert f'"{t}"' in gen.MAIN_RS, f"corpus tag {t!r} unhandled in main.rs"


def test_rust_crosscheck_decomposition_reproduces_corpus():
    """main.rs decomposes Option/WithLength/mixed-list composites into leaf
    Absorb calls (flag+payload, len+payload, child concat).  Replay that exact
    decision tree here and assert it reproduces every frozen encoding, so the
    generated Rust's structural logic is validated even without a toolchain."""
    from sponge_jax import Fp, U8, Usize, get_field, to_sponge_bytes, to_sponge_field_elements
    from tools.freeze_vectors import de_value
    from sponge_jax.absorb import NONE, Some, WithLength, _absorb_length

    FR = get_field("bls12_381_fr")

    def encode(v, bytes_out, elems_out):
        # Mirrors encode_value in tools/rust_crosscheck/src/main.rs.
        if isinstance(v, Some):
            encode(True, bytes_out, elems_out)
            encode(v.value, bytes_out, elems_out)
        elif v is NONE:
            encode(False, bytes_out, elems_out)
        elif isinstance(v, WithLength):
            encode(Usize(_absorb_length(v.value)), bytes_out, elems_out)
            encode(v.value, bytes_out, elems_out)
        elif isinstance(v, list) and not (
            v and (all(isinstance(e, U8) for e in v) or all(isinstance(e, Fp) for e in v))
        ):
            for c in v:
                encode(c, bytes_out, elems_out)
        else:
            # Leaf / homogeneous vector: the real Absorb impl.
            bytes_out.extend(to_sponge_bytes(v))
            to_sponge_field_elements(v, FR, elems_out)

    for sch in CORPUS["schedules"]:
        for st in sch["steps"]:
            if st["op"] != "absorb":
                continue
            v = de_value(st["value"])
            b, e = bytearray(), []
            encode(v, b, e)
            assert bytes(b).hex() == st["enc_bytes"], st["value"]
            assert [str(x) for x in e] == st["enc_elems"], st["value"]
