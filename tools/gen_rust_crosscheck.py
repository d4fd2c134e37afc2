"""Emit the self-contained Rust cross-check harness for the frozen corpus.

VERDICT r4 Missing #1: the byte-mode serialization edges (compressed Fp
serialization, /root/reference/src/absorb.rs:153-155; curve-point byte absorbs,
absorb.rs:231-236, 244-249) are matched to documented ark-serialize semantics
plus the self-generated frozen corpus (vectors/regression_corpus.json), but
this box has no Rust toolchain, so no *independent external* anchor exists.

This script writes ``tools/rust_crosscheck/`` — a complete Cargo project that
replays every schedule of the frozen corpus through the real arkworks sponge
(`ark-crypto-primitives` 0.4, the released successor crate the archived
reference was merged into — /root/reference/README.md:12) and asserts every
frozen byte/bit/element encoding and squeeze output bit-exactly.  The day any
machine with a Rust toolchain runs ``cargo run --release`` in that directory,
the corpus gains its external anchor.

The emitted files are checked in; re-run this script only to regenerate them
(e.g. after regenerating the corpus with a different layout).  The harness is
data-driven — it parses vectors/regression_corpus.json at compile time via
``include_str!`` — so corpus regeneration alone does NOT require re-emitting.

Usage:
    python tools/gen_rust_crosscheck.py          # writes tools/rust_crosscheck/
"""

from __future__ import annotations

import pathlib

OUT_DIR = pathlib.Path(__file__).resolve().parent / "rust_crosscheck"

CARGO_TOML = """\
# Generated by tools/gen_rust_crosscheck.py — external cross-check harness for
# vectors/regression_corpus.json.  Requires network access for crates.io.
[package]
name = "sponge-jax-crosscheck"
version = "0.1.0"
edition = "2021"
publish = false

[dependencies]
# The archived arkworks-rs/sponge reference was merged verbatim into
# ark-crypto-primitives (reference README.md:12); 0.4 is the released crate
# carrying that sponge module, buildable against released ark-ff/ark-ec 0.4.
ark-crypto-primitives = { version = "0.4", default-features = false, features = ["sponge"] }
ark-ff = { version = "0.4", default-features = false }
ark-ec = { version = "0.4", default-features = false }
ark-serialize = { version = "0.4", default-features = false }
ark-std = { version = "0.4", default-features = false }
# Released BN254 scalar field: the nonnative-squeeze target of the corpus.
ark-bn254 = { version = "0.4", default-features = false, features = ["scalar_field"] }
serde_json = "1"

[profile.release]
opt-level = 2
"""

MAIN_RS = r'''//! Replay vectors/regression_corpus.json through the real arkworks sponge.
//!
//! Generated by tools/gen_rust_crosscheck.py.  For every schedule in the
//! frozen corpus this binary:
//!   1. recomputes each absorbed value's byte-mode and field-element-mode
//!      encodings with the reference `Absorb` impls and asserts them against
//!      the frozen `enc_bytes` / `enc_elems`,
//!   2. absorbs the recomputed field elements into a `PoseidonSponge<Fr>`
//!      built from `Fr::get_default_poseidon_parameters(2, false)`,
//!   3. asserts every squeeze output (native elems / bytes / bits / nonnative
//!      BN254 elems) against the frozen values, and
//!   4. asserts the final duplex (state, mode, index).
//!
//! Exit code 0 means the whole corpus is bit-exact against arkworks.
//!
//! Heterogeneous composites (mixed-type lists — a Python-side extension with
//! no Rust type) are encoded by concatenating their children, which is
//! exactly the reference's default batch semantics
//! (/root/reference/src/absorb.rs:39-46, 60-67); `Option` and
//! `AbsorbWithLength` composites are decomposed the same way the reference
//! impls do (absorb.rs:288-302 and absorb.rs:82-101 respectively).

use ark_crypto_primitives::sponge::poseidon::{
    PoseidonConfig, PoseidonDefaultConfig, PoseidonDefaultConfigEntry,
    PoseidonDefaultConfigField, PoseidonSponge,
};
use ark_crypto_primitives::sponge::{
    Absorb, CryptographicSponge, DuplexSpongeMode, FieldBasedCryptographicSponge,
};
use ark_ec::short_weierstrass::{self as sw, SWCurveConfig};
use ark_ec::twisted_edwards::{self as te, MontCurveConfig, TECurveConfig};
use ark_ec::CurveConfig;
use ark_ff::fields::Fp256;
use ark_ff::{AdditiveGroup, Field, MontBackend, MontConfig, MontFp, PrimeField};
use serde_json::Value;

// ---------------------------------------------------------------------------
// BLS12-381 scalar field, defined exactly as the reference test fixture does
// (/root/reference/src/test.rs:5-32) so the orphan rule lets us attach the
// default-parameter tables.
// ---------------------------------------------------------------------------

#[derive(MontConfig)]
#[modulus = "52435875175126190479447740508185965837690552500527637822603658699938581184513"]
#[generator = "7"]
pub struct FrBackend;

type FrConfig = MontBackend<FrBackend, 4>;
pub type Fr = Fp256<FrConfig>;

impl PoseidonDefaultConfig<4> for FrConfig {
    const PARAMS_OPT_FOR_CONSTRAINTS: [PoseidonDefaultConfigEntry; 7] = [
        PoseidonDefaultConfigEntry::new(2, 17, 8, 31, 0),
        PoseidonDefaultConfigEntry::new(3, 5, 8, 56, 0),
        PoseidonDefaultConfigEntry::new(4, 5, 8, 56, 0),
        PoseidonDefaultConfigEntry::new(5, 5, 8, 57, 0),
        PoseidonDefaultConfigEntry::new(6, 5, 8, 57, 0),
        PoseidonDefaultConfigEntry::new(7, 5, 8, 57, 0),
        PoseidonDefaultConfigEntry::new(8, 5, 8, 57, 0),
    ];
    const PARAMS_OPT_FOR_WEIGHTS: [PoseidonDefaultConfigEntry; 7] = [
        PoseidonDefaultConfigEntry::new(2, 257, 8, 13, 0),
        PoseidonDefaultConfigEntry::new(3, 257, 8, 13, 0),
        PoseidonDefaultConfigEntry::new(4, 257, 8, 13, 0),
        PoseidonDefaultConfigEntry::new(5, 257, 8, 13, 0),
        PoseidonDefaultConfigEntry::new(6, 257, 8, 13, 0),
        PoseidonDefaultConfigEntry::new(7, 257, 8, 13, 0),
        PoseidonDefaultConfigEntry::new(8, 257, 8, 13, 0),
    ];
}

// ---------------------------------------------------------------------------
// Dummy curves over Fr as base field: the corpus' synthetic points (random
// coordinates, never validated on-curve — the reference absorb path reads
// stored coordinates via ToConstraintField, absorb.rs:230-254, and
// `new_unchecked` never checks membership).  Curve coefficients are
// irrelevant to every absorb encoding.
// ---------------------------------------------------------------------------

pub struct SwConfig;

impl CurveConfig for SwConfig {
    type BaseField = Fr;
    type ScalarField = Fr;
    const COFACTOR: &'static [u64] = &[1];
    const COFACTOR_INV: Fr = MontFp!("1");
}

impl SWCurveConfig for SwConfig {
    const COEFF_A: Fr = MontFp!("0");
    const COEFF_B: Fr = MontFp!("7");
    const GENERATOR: sw::Affine<SwConfig> =
        sw::Affine::new_unchecked(MontFp!("1"), MontFp!("2"));
}

pub struct TeConfig;

impl CurveConfig for TeConfig {
    type BaseField = Fr;
    type ScalarField = Fr;
    const COFACTOR: &'static [u64] = &[1];
    const COFACTOR_INV: Fr = MontFp!("1");
}

impl TECurveConfig for TeConfig {
    const COEFF_A: Fr = MontFp!("1");
    const COEFF_D: Fr = MontFp!("3");
    const GENERATOR: te::Affine<TeConfig> =
        te::Affine::new_unchecked(MontFp!("0"), MontFp!("1"));
    type MontCurveConfig = TeConfig;
}

impl MontCurveConfig for TeConfig {
    const COEFF_A: Fr = MontFp!("1");
    const COEFF_B: Fr = MontFp!("1");
    type TECurveConfig = TeConfig;
}

// ---------------------------------------------------------------------------
// Helpers
// ---------------------------------------------------------------------------

fn fr_from_dec(s: &str) -> Fr {
    // Canonical decimal -> Fr; every corpus value is < p so this is exact.
    s.bytes().fold(Fr::ZERO, |acc, b| {
        assert!(b.is_ascii_digit(), "bad decimal digit");
        acc * Fr::from(10u64) + Fr::from((b - b'0') as u64)
    })
}

fn bn_from_dec(s: &str) -> ark_bn254::Fr {
    s.bytes().fold(ark_bn254::Fr::ZERO, |acc, b| {
        acc * ark_bn254::Fr::from(10u64) + ark_bn254::Fr::from((b - b'0') as u64)
    })
}

fn hex_decode(s: &str) -> Vec<u8> {
    assert!(s.len() % 2 == 0, "odd hex length");
    (0..s.len() / 2)
        .map(|i| u8::from_str_radix(&s[2 * i..2 * i + 2], 16).unwrap())
        .collect()
}

/// Run a value through the reference Absorb impl, appending both wire formats.
fn enc<A: Absorb>(v: &A, bytes: &mut Vec<u8>, elems: &mut Vec<Fr>) {
    v.to_sponge_bytes(bytes);
    v.to_sponge_field_elements(elems);
}

fn tag(v: &Value) -> &str {
    v["t"].as_str().expect("tagged value")
}

fn list_children(v: &Value) -> &Vec<Value> {
    v["v"].as_array().expect("list payload")
}

/// Length a `WithLength` wrapper absorbs (absorb.rs:82-101: element count of
/// the underlying sequence).
fn absorb_length(v: &Value) -> usize {
    match tag(v) {
        "bytes" => v["v"].as_str().unwrap().len() / 2,
        "list" => list_children(v).len(),
        other => panic!("WithLength over non-sequence {other}"),
    }
}

/// Recompute both wire-format encodings of a tagged corpus value using the
/// reference `Absorb` impls wherever a Rust-expressible type exists.
fn encode_value(v: &Value, bytes: &mut Vec<u8>, elems: &mut Vec<Fr>) {
    match tag(v) {
        "u8" => enc(&(v["v"].as_u64().unwrap() as u8), bytes, elems),
        "u16" => enc(&(v["v"].as_u64().unwrap() as u16), bytes, elems),
        "u32" => enc(&(v["v"].as_u64().unwrap() as u32), bytes, elems),
        "u64" => enc(&v["v"].as_str().unwrap().parse::<u64>().unwrap(), bytes, elems),
        "u128" => enc(&v["v"].as_str().unwrap().parse::<u128>().unwrap(), bytes, elems),
        "i8" => enc(&(v["v"].as_i64().unwrap() as i8), bytes, elems),
        "i64" => enc(&v["v"].as_str().unwrap().parse::<i64>().unwrap(), bytes, elems),
        "usize" => enc(
            &(v["v"].as_str().unwrap().parse::<u64>().unwrap() as usize),
            bytes,
            elems,
        ),
        "bool" => enc(&v["v"].as_bool().unwrap(), bytes, elems),
        "fp" => {
            assert_eq!(v["field"].as_str().unwrap(), "bls12_381_fr");
            enc(&fr_from_dec(v["v"].as_str().unwrap()), bytes, elems)
        }
        "bytes" => enc(&hex_decode(v["v"].as_str().unwrap()), bytes, elems),
        "te" => {
            let p = te::Affine::<TeConfig>::new_unchecked(
                fr_from_dec(v["x"].as_str().unwrap()),
                fr_from_dec(v["y"].as_str().unwrap()),
            );
            enc(&p, bytes, elems)
        }
        "sw" => {
            let mut p = sw::Affine::<SwConfig>::new_unchecked(
                fr_from_dec(v["x"].as_str().unwrap()),
                fr_from_dec(v["y"].as_str().unwrap()),
            );
            p.infinity = v["infinity"].as_bool().unwrap();
            enc(&p, bytes, elems)
        }
        // Option: is_some flag then payload — the reference impl verbatim
        // (absorb.rs:288-302), decomposed so nested composites work.
        "none" => enc(&false, bytes, elems),
        "some" => {
            enc(&true, bytes, elems);
            encode_value(&v["v"], bytes, elems)
        }
        // AbsorbWithLength: element count as usize, then payload
        // (absorb.rs:89-101).
        "withlen" => {
            enc(&absorb_length(&v["v"]), bytes, elems);
            encode_value(&v["v"], bytes, elems)
        }
        "list" => {
            let children = list_children(v);
            if !children.is_empty() && children.iter().all(|c| tag(c) == "u8") {
                // Vec<u8> routes through the u8 batch impl: raw bytes in byte
                // mode, u64-length-prefixed packing in element mode
                // (absorb.rs:131-139).
                let raw: Vec<u8> = children
                    .iter()
                    .map(|c| c["v"].as_u64().unwrap() as u8)
                    .collect();
                enc(&raw, bytes, elems)
            } else if !children.is_empty() && children.iter().all(|c| tag(c) == "fp") {
                // Vec<Fp>: field_cast with unwrap (absorb.rs:159-164).
                let fps: Vec<Fr> = children
                    .iter()
                    .map(|c| fr_from_dec(c["v"].as_str().unwrap()))
                    .collect();
                enc(&fps, bytes, elems)
            } else {
                // Mixed list (Python-side extension): the default batch
                // semantics — concatenate each child (absorb.rs:39-46, 60-67).
                for c in children {
                    encode_value(c, bytes, elems)
                }
            }
        }
        other => panic!("unknown tag {other}"),
    }
}

// ---------------------------------------------------------------------------
// Schedule replay
// ---------------------------------------------------------------------------

fn run_schedule(schedule: &Value) -> Result<(), String> {
    let seed = schedule["seed"].as_u64().unwrap();
    let params: PoseidonConfig<Fr> = Fr::get_default_poseidon_parameters(2, false)
        .expect("default rate-2 BLS12-381 parameters");
    let mut sponge = PoseidonSponge::new(&params);

    for (i, step) in schedule["steps"].as_array().unwrap().iter().enumerate() {
        let op = step["op"].as_str().unwrap();
        let ctx = |what: &str| format!("schedule {seed} step {i} ({op}): {what}");
        match op {
            "absorb" => {
                let mut bytes = Vec::new();
                let mut elems: Vec<Fr> = Vec::new();
                encode_value(&step["value"], &mut bytes, &mut elems);
                let want_bytes = hex_decode(step["enc_bytes"].as_str().unwrap());
                if bytes != want_bytes {
                    return Err(ctx("byte-mode encoding mismatch"));
                }
                let want_elems: Vec<String> = step["enc_elems"]
                    .as_array()
                    .unwrap()
                    .iter()
                    .map(|e| e.as_str().unwrap().to_string())
                    .collect();
                let got_elems: Vec<String> =
                    elems.iter().map(|e| format!("{e}")).collect();
                if got_elems != want_elems {
                    return Err(ctx("element-mode encoding mismatch"));
                }
                // Absorbing the element encoding is definitionally what
                // absorbing the value does (absorb -> to_sponge_field_elements
                // -> absorb_internal; poseidon/mod.rs:232-253).
                sponge.absorb(&elems);
            }
            "squeeze_native" => {
                let n = step["n"].as_u64().unwrap() as usize;
                let out = sponge.squeeze_native_field_elements(n);
                let got: Vec<String> = out.iter().map(|e| format!("{e}")).collect();
                let want: Vec<String> = step["out"]
                    .as_array()
                    .unwrap()
                    .iter()
                    .map(|e| e.as_str().unwrap().to_string())
                    .collect();
                if got != want {
                    return Err(ctx("squeeze_native mismatch"));
                }
            }
            "squeeze_bytes" => {
                let n = step["n"].as_u64().unwrap() as usize;
                let out = sponge.squeeze_bytes(n);
                if out != hex_decode(step["out"].as_str().unwrap()) {
                    return Err(ctx("squeeze_bytes mismatch"));
                }
            }
            "squeeze_bits" => {
                let n = step["n"].as_u64().unwrap() as usize;
                let bits = sponge.squeeze_bits(n);
                let mut packed = vec![0u8; (n + 7) / 8];
                for (j, b) in bits.iter().enumerate() {
                    if *b {
                        packed[j / 8] |= 1 << (j % 8);
                    }
                }
                if packed != hex_decode(step["out"].as_str().unwrap()) {
                    return Err(ctx("squeeze_bits mismatch"));
                }
            }
            "squeeze_nonnative" => {
                assert_eq!(step["field"].as_str().unwrap(), "bn254_fr");
                let n = step["n"].as_u64().unwrap() as usize;
                let out: Vec<ark_bn254::Fr> = sponge.squeeze_field_elements(n);
                let want: Vec<ark_bn254::Fr> = step["out"]
                    .as_array()
                    .unwrap()
                    .iter()
                    .map(|e| bn_from_dec(e.as_str().unwrap()))
                    .collect();
                if out != want {
                    return Err(ctx("squeeze_nonnative mismatch"));
                }
            }
            other => panic!("unknown op {other}"),
        }
    }

    // Final duplex state, mode, index.
    let want_state: Vec<Fr> = schedule["final_state"]
        .as_array()
        .unwrap()
        .iter()
        .map(|e| fr_from_dec(e.as_str().unwrap()))
        .collect();
    if sponge.state != want_state {
        return Err(format!("schedule {seed}: final state mismatch"));
    }
    let want_index = schedule["final_index"].as_u64().unwrap() as usize;
    let mode_ok = match (schedule["final_mode"].as_str().unwrap(), &sponge.mode) {
        ("absorbing", DuplexSpongeMode::Absorbing { next_absorb_index }) => {
            *next_absorb_index == want_index
        }
        ("squeezing", DuplexSpongeMode::Squeezing { next_squeeze_index }) => {
            *next_squeeze_index == want_index
        }
        _ => false,
    };
    if !mode_ok {
        return Err(format!("schedule {seed}: final mode/index mismatch"));
    }
    Ok(())
}

fn main() {
    let corpus: Value =
        serde_json::from_str(include_str!("../../../vectors/regression_corpus.json"))
            .expect("parse corpus");
    assert_eq!(corpus["field"].as_str().unwrap(), "bls12_381_fr");
    assert_eq!(corpus["rate"].as_u64().unwrap(), 2);
    assert!(!corpus["optimized_for_weights"].as_bool().unwrap());

    let schedules = corpus["schedules"].as_array().unwrap();
    let mut failures = 0;
    for schedule in schedules {
        match run_schedule(schedule) {
            Ok(()) => println!("schedule {}: OK", schedule["seed"]),
            Err(e) => {
                failures += 1;
                eprintln!("FAIL: {e}");
            }
        }
    }
    if failures > 0 {
        eprintln!("{failures}/{} schedules FAILED", schedules.len());
        std::process::exit(1);
    }
    println!(
        "all {} schedules bit-exact vs arkworks (ark-crypto-primitives sponge)",
        schedules.len()
    );
}
'''

README_MD = """\
# Rust cross-check harness for the frozen corpus

Generated by `tools/gen_rust_crosscheck.py`.  This is the external anchor for
the one parity surface that has none on a Rust-less box (VERDICT r4 Missing
#1): byte-mode serialization edges — compressed `Fp` serialization
(`/root/reference/src/absorb.rs:153-155`) and curve-point byte absorbs
(`absorb.rs:231-254`) — plus, transitively, every other encoding and squeeze
flavor in `vectors/regression_corpus.json` (24 schedules x 12 steps).

On any machine with a Rust toolchain and network access:

```sh
cd tools/rust_crosscheck
cargo run --release
```

Exit code 0 = the whole frozen corpus is bit-exact against the real arkworks
sponge.  The harness targets `ark-crypto-primitives` 0.4 — the released crate
the archived `arkworks-rs/sponge` reference was merged into (reference
`README.md:12`) — with released `ark-ff`/`ark-ec` 0.4, so the build is
reproducible (the reference's own `[patch.crates-io]` git-master pins are
not).  The corpus JSON is read at compile time via `include_str!`, so
regenerating the corpus automatically regenerates the expectations.

This directory is emitted code: edit `tools/gen_rust_crosscheck.py` and re-run
it rather than editing files here (a test pins the two in sync).
"""


def main():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "src").mkdir(exist_ok=True)
    (OUT_DIR / "Cargo.toml").write_text(CARGO_TOML)
    (OUT_DIR / "src" / "main.rs").write_text(MAIN_RS)
    (OUT_DIR / "README.md").write_text(README_MD)
    print(f"wrote {OUT_DIR}/{{Cargo.toml, src/main.rs, README.md}}")


if __name__ == "__main__":
    main()
