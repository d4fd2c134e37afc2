"""Full benchmark suite: the BASELINE.json measurement configs on the GPU.

Prints one JSON line per row and writes them all to
``chiprun_out/full_bench.json``.  Every permutation row is oracle-gated on
sampled lanes before it is timed; every timing window ends in
``block_until_ready``.  Refuses to run without a GPU.

Run: ``python bench/full_bench.py [--quick]``
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "bench"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _harness import (  # noqa: E402
    card_info,
    check_lanes,
    random_mont_plane,
    require_gpu,
    time_perms,
    timed_best,
)


def bench_parity():
    """Config 1: single-state absorb/squeeze parity vs ark-sponge vectors."""
    from sponge_jax import BLS12_381_FR, Fp, PoseidonSponge, get_default_poseidon_parameters

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, False)
    s = PoseidonSponge(cfg, batch_size=1)
    s.absorb([Fp(0, BLS12_381_FR), Fp(1, BLS12_381_FR), Fp(2, BLS12_381_FR)])
    out = s.squeeze_native_field_elements(3)[0]
    golden = [
        40442793463571304028337753002242186710310163897048962278675457993207843616876,
        2664374461699898000291153145224099287711224021716202960480903840045233645301,
        50191078828066923662070228256530692951801504043422844038937334196346054068797,
    ]
    return {"name": "single-state parity vs ark-sponge vectors",
            "value": "bit-exact" if out == golden else "MISMATCH", "unit": ""}


def bench_permutation(cfg, label, log_batch, reps=6):
    """Batched permutation throughput, oracle-gated on 64 sampled lanes."""
    from sponge_jax.poseidon.permutation import batched_permute

    B = 1 << log_batch
    state = random_mont_plane(cfg.field, (cfg.t, B), seed=log_batch)
    out = batched_permute(cfg, state)
    check_lanes(cfg, state, out, n=64, label=label)
    rate = time_perms(lambda s: batched_permute(cfg, s), out, B, iters=reps)
    return {"name": f"{label} permutation (B=2^{log_batch}, oracle-gated)",
            "value": round(rate), "unit": "perms/s"}


def bench_merkle(log_leaves=24):
    """Config 4: 2-to-1 Poseidon Merkle tree over 2^24 leaves."""
    from sponge_jax import BLS12_381_FR, get_default_poseidon_parameters
    from sponge_jax.hash import merkle_root

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, False)
    N = 1 << log_leaves
    leaves = random_mont_plane(BLS12_381_FR, (N,), seed=4)
    jax.block_until_ready(merkle_root(cfg, leaves))  # warm-up / compile

    def _window():
        t0 = time.perf_counter()
        jax.block_until_ready(merkle_root(cfg, leaves))
        return N / (time.perf_counter() - t0)

    return {"name": f"Merkle tree, 2^{log_leaves} leaves (2-to-1, one perm/node)",
            "value": round(timed_best(_window)), "unit": "leaves/s"}


def bench_transcript(batch=1 << 14, reps=3, lazy=True):
    """Config 5: mixed Fiat-Shamir transcript through ``PoseidonSponge``
    (``lazy=True``: absorbs queue host-side, one fused segment per squeeze;
    ``lazy=False``: several small device dispatches per duplex step)."""
    from sponge_jax import U64, BLS12_381_FR, Fp, get_default_poseidon_parameters
    from sponge_jax.sponge import PoseidonSponge

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, False)

    def one_pass():
        s = PoseidonSponge(cfg, batch_size=batch, lazy=lazy)
        s.absorb(b"transcript-header")
        s.absorb(U64(1))
        s.absorb([Fp(12345, BLS12_381_FR), Fp(67890, BLS12_381_FR)])
        s.squeeze_native_plane(2)
        s.absorb(U64(2))
        return s.squeeze_native_plane(1)

    jax.block_until_ready(one_pass())  # warm-up / compile

    def _window():
        t0 = time.perf_counter()
        for _ in range(reps):
            out = one_pass()
        jax.block_until_ready(out)
        return batch * reps / (time.perf_counter() - t0)

    mode = "lazy default" if lazy else "eager, lazy=False"
    return {"name": f"Fiat-Shamir transcript (5 steps, B={batch} lanes, {mode})",
            "value": round(timed_best(_window)), "unit": "transcripts/s"}


def bench_compiled_transcript(batch=1 << 17, reps=5):
    """Config 5 (fast path): the same transcript as ONE fused program."""
    from sponge_jax import BLS12_381_FR, get_default_poseidon_parameters
    from sponge_jax.transcript import Absorb, SqueezeNative, compile_transcript

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, False)
    schedule = [Absorb(3), SqueezeNative(2), Absorb(1), SqueezeNative(1)]
    fn = compile_transcript(cfg, schedule)
    elems = jnp.zeros((4, BLS12_381_FR.nlimbs, batch), dtype=jnp.int32)
    jax.block_until_ready(fn(elems))

    def _window():
        t0 = time.perf_counter()
        for _ in range(reps):
            o = fn(elems)
        jax.block_until_ready(o)
        return batch * reps / (time.perf_counter() - t0)

    return {"name": f"compiled Fiat-Shamir transcript (4 steps fused, B={batch})",
            "value": round(timed_best(_window)), "unit": "transcripts/s"}


def bench_host_runtime(reps=3000):
    """Host (CPU, single-thread) native C++ tier: the verifier-side path where a
    device dispatch round trip dwarfs the arithmetic.  Parity-gated by
    tests/test_host_runtime.py (oracle-exact)."""
    from sponge_jax import BLS12_381_FR, get_default_poseidon_parameters
    from sponge_jax.poseidon.host import host_available, host_run_schedule

    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, False)
    if not host_available(cfg):
        return {"name": "native host transcript (no C++ toolchain)",
                "value": 0, "unit": "transcripts/s"}
    steps = [("absorb", 3), ("squeeze", 2), ("absorb", 1), ("squeeze", 1)]
    elems = [12345, 67890, 424242, 777]
    host_run_schedule(cfg, steps, elems)  # build + table warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        host_run_schedule(cfg, steps, elems)
    rate = reps / (time.perf_counter() - t0)
    return {"name": "native host transcript (4 steps, C++ single-thread)",
            "value": round(rate), "unit": "transcripts/s"}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true", help="smaller shapes")
    args = parser.parse_args()
    require_gpu()

    import sponge_jax as sj
    from sponge_jax.utils.jaxcache import configure_cache

    configure_cache()
    q = args.quick
    perm_rows = [
        (sj.get_default_poseidon_parameters(sj.BLS12_381_FR, 2), "BLS12-381 Fr rate-2, 12-bit/L=22"),
        (sj.get_default_poseidon_parameters(sj.BLS12_381_FR_L13, 2), "BLS12-381 Fr rate-2, 13-bit/L=20"),
        (sj.get_default_poseidon_parameters(sj.BN254_FR, 3), "BN254 Fr rate-3"),
        (sj.get_default_poseidon2_parameters(sj.BLS12_381_FR, 2), "Poseidon2 BLS12-381 Fr rate-2"),
        (sj.get_default_poseidon_parameters(sj.GOLDILOCKS_FR, 8), "Goldilocks rate-8 (t=12)"),
        (sj.get_default_poseidon2_parameters(sj.BABYBEAR_FR, 8), "Poseidon2 BabyBear rate-8 (t=16)"),
    ]
    rows = [bench_parity()]
    rows += [bench_permutation(cfg, label, 14 if q else 20) for cfg, label in perm_rows]
    rows.append(bench_merkle(14 if q else 24))
    rows.append(bench_transcript(1 << (10 if q else 14)))
    rows.append(bench_transcript(1 << (10 if q else 14), lazy=False))
    rows.append(bench_compiled_transcript(1 << (12 if q else 17)))
    rows.append(bench_host_runtime(500 if q else 3000))

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card_info()}
    for r in rows:
        r["device"] = device
        print(json.dumps(r))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "full_bench.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
