"""Benchmark harness: Poseidon rate-2 permutations/sec on the local GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

The baseline denominator is the BASELINE.json north-star target spread over
16 devices: 2^24 perms/s / 16 = 2^20 = 1,048,576 perms/s per device.
``vs_baseline`` > 1.0 beats it.

Correctness gate: before any timing is reported, the auto-dispatched tier is
run on random field elements and sampled lanes are decoded against the scalar
python-int oracle (OraclePoseidonSponge.permute, itself pinned to the
reference golden vectors).  A mismatch raises and the bench emits NO number.
Without a GPU the bench refuses to run.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "bench"))

PER_CHIP_TARGET = float(1 << 20)  # 2^24 / 16 devices (BASELINE.json north star)
PARITY_SAMPLE = 64


def measure_perms_per_sec(log_batch: int = 20, reps: int = 8) -> float:
    from _harness import check_lanes, random_mont_plane, require_gpu, time_perms

    from sponge_jax import BLS12_381_FR_L13, get_default_poseidon_parameters
    from sponge_jax.poseidon.permutation import batched_permute
    from sponge_jax.utils.jaxcache import configure_cache

    require_gpu()
    configure_cache()
    # Flagship limb plan: 13-bit/L=20 with uint32 accumulation (same field,
    # same parameters, same oracle as the 12-bit plan; DESIGN §7).
    cfg = get_default_poseidon_parameters(BLS12_381_FR_L13, 2, False)
    B = 1 << log_batch
    state = random_mont_plane(cfg.field, (cfg.t, B), seed=20240817)
    out = batched_permute(cfg, state)
    check_lanes(cfg, state, out, n=PARITY_SAMPLE, label="auto-dispatched")
    print(f"parity gate: {PARITY_SAMPLE} sampled lanes match the oracle", file=sys.stderr)
    return time_perms(lambda s: batched_permute(cfg, s), out, B, iters=reps)


def main():
    value = measure_perms_per_sec()
    print(
        json.dumps(
            {
                "metric": "poseidon_rate2_bls12_381_fr_permutations_per_sec_per_chip",
                "value": round(value),
                "unit": "perms/s",
                "vs_baseline": round(value / PER_CHIP_TARGET, 4),
            }
        )
    )


if __name__ == "__main__":
    main()
