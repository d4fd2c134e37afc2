"""Shared measurement harness for the GPU benchmarks and ``chip_smoke.py``.

Every measurement follows the same protocol: seed lanes with random field
values, parity-gate the compiled tier against the scalar oracle (refuse to
print a number on mismatch), then time warm repetitions that each end in
``block_until_ready``.  A measurement path that finds no GPU fails
(``require_gpu``); it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np

import jax
import jax.numpy as jnp


def require_gpu():
    """Raise unless JAX's default device is a GPU (no CPU fallback)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {dev.platform!r}; "
            "this measurement runs on the card only"
        )
    return dev


def card_info() -> str:
    """Each card's name and power limit, read by nvidia-smi (not through
    JAX); several cards are joined with "; "."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def random_mont_plane(fs, lead_shape, seed=0):
    """Random canonical limb plane of shape ``(*lead, L, B)`` made on device.

    ``lead_shape`` is ``(*lead, B)``.  Every value is below 2^(bits(p)-1) < p,
    so each lane is a valid Montgomery representation of some element; no
    host-side big integers are involved, so 2^24 lanes cost milliseconds.
    """
    *lead, B = lead_shape
    L, lb = fs.nlimbs, fs.limb_bits
    top = fs.modulus_bit_size - 1
    masks = np.array(
        [(1 << max(0, min(lb, top - l * lb))) - 1 for l in range(L)], np.uint32
    )
    bits = jax.random.bits(jax.random.key(seed), (*lead, L, B), jnp.uint32)
    return (bits & jnp.asarray(masks)[:, None]).astype(jnp.int32)


def sample_lanes(B, n, seed=1):
    """``n`` distinct lane indices spread over ``range(B)`` (first and last
    included)."""
    rng = np.random.default_rng(seed)
    inner = rng.choice(np.arange(1, B - 1), size=min(n, B) - 2, replace=False)
    return sorted({0, B - 1, *inner.tolist()})


def check_lanes(cfg, state_in, state_out, n=64, label="permutation"):
    """Raise unless sampled lanes of ``state_out`` equal the scalar oracle's
    permutation of the same lanes of ``state_in`` (both (t, L, B) planes)."""
    fs = cfg.field
    lanes = sample_lanes(state_in.shape[-1], n)
    idx = np.asarray(lanes)
    ins = np.asarray(state_in[..., idx])
    outs = np.asarray(state_out[..., idx])
    for k, lane in enumerate(lanes):
        o = cfg.oracle_sponge()
        o.state = [fs.mont_limbs_to_int(ins[i][:, k]) for i in range(cfg.t)]
        o.permute()
        got = [fs.mont_limbs_to_int(outs[i][:, k]) % fs.modulus for i in range(cfg.t)]
        if got != [v % fs.modulus for v in o.state]:
            raise RuntimeError(f"{label} PARITY FAILURE at lane {lane}")
    return len(lanes)


def timed_calls(fn, calls):
    """Wall seconds of ``calls`` separate calls of ``fn``, each ending in
    ``block_until_ready`` (one untimed call first)."""
    jax.block_until_ready(fn())
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return times


def timed_best(window_fn, windows=3):
    """Best rate over ``windows`` calls of ``window_fn`` (a thunk that runs
    one timed window, waits for the device, and returns a rate), after one
    untimed warm call — for workloads that are not state-in/state-out
    chainable (Merkle roots, transcripts)."""
    window_fn()
    return max(window_fn() for _ in range(windows))


def time_perms(fn, first_out, B, iters=5, windows=3):
    """Permutations/sec: one untimed warm window, then the best of
    ``windows`` timed windows of ``iters`` chained repetitions of ``fn``
    (state in, state out), each window ending in ``block_until_ready``."""
    cur = first_out
    for _ in range(iters):
        cur = fn(cur)
    jax.block_until_ready(cur)
    best = 0.0
    for _w in range(windows):
        cur = first_out
        t0 = time.perf_counter()
        for _ in range(iters):
            cur = fn(cur)
        jax.block_until_ready(cur)
        best = max(best, iters * B / (time.perf_counter() - t0))
    return best
