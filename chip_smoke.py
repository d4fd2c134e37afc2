"""Smoke run of the Poseidon main path on the GPU, through the public API.

One process, one card, at the BASELINE.json sizes:

1. device: platform, kind, count, the card's name and power limit, XLA flags;
2. the ark-sponge golden vector out of a batched ``PoseidonSponge``;
3. ``batched_permute`` at B = 2^20 for BLS12-381 (13-bit/L=20 and
   12-bit/L=22 plans) and BN254 rate 3, vs the scalar oracle on sampled
   lanes, with compile and warm times and ``memory_analysis()``;
4. a Merkle tree over 2^24 BLS12-381 leaves: root, sampled nodes on every
   level vs the oracle, 1,024 openings through ``merkle_open_batch`` and
   ``merkle_verify_batch``;
5. Fiat-Shamir: ``compile_transcript`` at 2^16 lanes and a lazy
   ``PoseidonSponge`` over bytes, ``U64`` and field elements, vs the oracle;
6. the ``gpu``-marked tests, in this process (a second JAX process would
   not get the card's memory).

``--four`` runs only the sharded path (``parallel``) on a mesh of four cards
and compares it with one card.  Every time printed carries the card's name
and power limit.  Any failure exits non-zero; without a GPU the script
refuses to run.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Run:  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "bench"))

GOLDEN = [
    40442793463571304028337753002242186710310163897048962278675457993207843616876,
    2664374461699898000291153145224099287711224021716202960480903840045233645301,
    50191078828066923662070228256530692951801504043422844038937334196346054068797,
]
SCHEDULE = ((3, 2), (1, 5))  # (absorb, squeeze) pairs of the transcript phase
PERM_CONFIGS = (("BLS12_381_FR_L13", 2), ("BLS12_381_FR", 2), ("BN254_FR", 3))


def log(msg):
    print(msg, flush=True)


class Clock:
    """Wall times that end in ``block_until_ready``, printed beside the card."""

    def __init__(self, card: str):
        self.card = card

    def run(self, label, fn, *args):
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        dt = time.perf_counter() - t0
        log(f"  {label}: {dt:.3f} s  [{self.card}]")
        return out, dt


def _canon(fs, plane):
    from sponge_jax.ops import montgomery as mont

    return mont.from_mont(fs, plane)


def _oracle_compress(cfg, left: int, right: int) -> int:
    from sponge_jax.poseidon.oracle import OraclePoseidonSponge

    o = OraclePoseidonSponge(cfg)
    o.absorb_field_elements([left, right])
    return o.squeeze_native_field_elements(1)[0]


def _memory(fn, *args) -> str:
    """``memory_analysis()`` of the compiled program ``fn`` runs on ``args``."""
    m = fn.lower(*args).compile().memory_analysis()
    return (
        f"args {m.argument_size_in_bytes} B, out {m.output_size_in_bytes} B, "
        f"temp {m.temp_size_in_bytes} B"
    )


def phase_device():
    import jax

    from _harness import card_info

    devs = jax.devices()
    d = devs[0]
    card = card_info()
    log(f"device: platform={d.platform} kind={d.device_kind} count={len(devs)}")
    log(card)  # as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return card


def phase_golden(clock, batch=256, seed=2):
    """The ark-sponge rate-2 vector out of lane 0 of a batched sponge; the
    other lanes carry random inputs and are checked against the oracle."""
    import numpy as np

    from sponge_jax import BLS12_381_FR, Batched, Fp, PoseidonSponge
    from sponge_jax import get_default_poseidon_parameters
    from sponge_jax.poseidon.oracle import OraclePoseidonSponge

    fs = BLS12_381_FR
    cfg = get_default_poseidon_parameters(fs, 2, False)
    rng = np.random.default_rng(seed)
    lanes = [[0, 1, 2]] + [
        [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=3)]
        for _ in range(batch - 1)
    ]
    sponge = PoseidonSponge(cfg, batch_size=batch)
    sponge.absorb(Batched([[Fp(v, fs) for v in lane] for lane in lanes]))
    out, _ = clock.run(
        f"golden: absorb 3 + squeeze 3 over {batch} lanes",
        sponge.squeeze_native_field_elements, 3,
    )
    if out[0] != GOLDEN:
        raise AssertionError(f"golden vector mismatch: {out[0]}")
    for b in (1, batch // 2, batch - 1):
        o = OraclePoseidonSponge(cfg)
        o.absorb_field_elements(lanes[b])
        if out[b] != o.squeeze_native_field_elements(3):
            raise AssertionError(f"golden phase: lane {b} differs from the oracle")
    log("golden: lane 0 = ark-sponge vector; random lanes match the oracle")


def phase_permutation(clock, cfg, log_batch, lanes=64):
    """``batched_permute(cfg, ·)`` (auto dispatch) at 2^log_batch lanes."""
    from _harness import check_lanes, random_mont_plane
    from sponge_jax.poseidon.permutation import batched_permute, permute_jit

    fs = cfg.field
    B = 1 << log_batch
    state = random_mont_plane(fs, (cfg.t, B), seed=log_batch + cfg.t)
    name = f"{fs.name} L={fs.nlimbs} t={cfg.t} B=2^{log_batch}"
    out, _ = clock.run(f"{name}: first call (compile + run)", batched_permute, cfg, state)
    clock.run(f"{name}: warm call", batched_permute, cfg, state)
    n = check_lanes(cfg, state, out, n=lanes, label=name)
    log(f"  {name}: {n} sampled lanes match the oracle")
    log(f"  {name}: memory_analysis: {_memory(permute_jit(cfg), state)}")
    return out


def phase_merkle(clock, cfg, log_leaves, n_open=1024, per_level=4, seed=4):
    """``merkle_tree`` / ``merkle_root`` / batch open + verify vs the oracle."""
    import jax.numpy as jnp
    import numpy as np

    from _harness import random_mont_plane
    from sponge_jax.hash import (
        merkle_open_batch,
        merkle_root,
        merkle_tree,
        merkle_verify_batch,
    )

    fs = cfg.field
    N = 1 << log_leaves
    leaves = random_mont_plane(fs, (N,), seed=seed)
    levels, _ = clock.run(f"merkle_tree 2^{log_leaves} leaves (compile + run)",
                          merkle_tree, cfg, leaves)
    root, _ = clock.run(f"merkle_root 2^{log_leaves} leaves", merkle_root, cfg, leaves)
    if not bool(jnp.array_equal(_canon(fs, root[:, None]),
                                _canon(fs, levels[-1][:, :1]))):
        raise AssertionError("merkle_root != merkle_tree root")
    rng = np.random.default_rng(seed)
    for d in range(1, len(levels)):
        width = levels[d].shape[-1]
        idx = sorted({0, width - 1, *rng.integers(0, width, size=per_level).tolist()})
        parents = np.asarray(levels[d][:, idx])
        kids = np.asarray(levels[d - 1][:, [i for j in idx for i in (2 * j, 2 * j + 1)]])
        for k, j in enumerate(idx):
            want = _oracle_compress(
                cfg, fs.mont_limbs_to_int(kids[:, 2 * k]),
                fs.mont_limbs_to_int(kids[:, 2 * k + 1]),
            )
            if fs.mont_limbs_to_int(parents[:, k]) % fs.modulus != want:
                raise AssertionError(f"merkle level {d} node {j} != oracle")
    log(f"  merkle: {len(levels) - 1} levels, sampled nodes on each match the oracle")
    n_open = min(n_open, N)
    indices = rng.choice(N, size=n_open, replace=False)
    paths, _ = clock.run(f"merkle_open_batch {n_open}", merkle_open_batch, levels, indices)
    ok, _ = clock.run(
        f"merkle_verify_batch {n_open} (compile + run)", merkle_verify_batch,
        cfg, root, leaves[:, indices], paths, indices,
    )
    if not bool(np.all(np.asarray(ok))):
        raise AssertionError("merkle_verify_batch rejected a valid opening")
    log(f"  merkle: {n_open} openings verify")
    return root


def _transcript_elems(fs, lanes, seed=5):
    from _harness import random_mont_plane

    total = sum(a for a, _ in SCHEDULE)
    return random_mont_plane(fs, (total, lanes), seed=seed)


def _transcript_oracle(cfg, elems_host, lane):
    """The schedule on one lane through the oracle sponge."""
    from sponge_jax.poseidon.oracle import OraclePoseidonSponge

    fs = cfg.field
    o = OraclePoseidonSponge(cfg)
    out, row = [], 0
    for a, s in SCHEDULE:
        o.absorb_field_elements(
            [fs.mont_limbs_to_int(elems_host[row + i][:, lane]) for i in range(a)]
        )
        row += a
        out += o.squeeze_native_field_elements(s)
    return out


def _check_transcript(cfg, elems, out, lanes, label):
    import numpy as np

    from _harness import sample_lanes

    fs = cfg.field
    pick = sample_lanes(elems.shape[-1], lanes)
    e = np.asarray(elems[..., pick])
    o = np.asarray(out[..., pick])
    for k in range(len(pick)):
        got = [fs.limbs_to_int(o[i][:, k]) for i in range(o.shape[0])]
        if got != _transcript_oracle(cfg, e, k):
            raise AssertionError(f"{label}: lane {pick[k]} differs from the oracle")
    return len(pick)


def phase_transcript(clock, cfg, lanes, sponge_lanes=256, checked=16, seed=6):
    """``compile_transcript`` and a lazy ``PoseidonSponge`` vs the oracle."""
    import numpy as np

    from sponge_jax import U64, Batched, Fp, PoseidonSponge
    from sponge_jax.poseidon.oracle import OraclePoseidonSponge
    from sponge_jax.transcript import Absorb, SqueezeNative, compile_transcript

    fs = cfg.field
    steps = [x for a, s in SCHEDULE for x in (Absorb(a), SqueezeNative(s))]
    fn = compile_transcript(cfg, steps)
    elems = _transcript_elems(fs, lanes)
    out, _ = clock.run(f"compile_transcript {lanes} lanes (compile + run)", fn, elems)
    clock.run(f"compile_transcript {lanes} lanes, warm", fn, elems)
    n = _check_transcript(cfg, elems, out, checked, "compiled transcript")
    log(f"  transcript: {n} sampled lanes match the oracle")

    rng = np.random.default_rng(seed)
    u64s = [int(v) for v in rng.integers(0, 1 << 62, size=sponge_lanes)]
    felts = [
        [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=2)]
        for _ in range(sponge_lanes)
    ]

    def drive():
        s = PoseidonSponge(cfg, batch_size=sponge_lanes)
        s.absorb(b"chip smoke transcript")
        s.absorb(Batched([U64(v) for v in u64s]))
        s.absorb(Batched([[Fp(v, fs) for v in lane] for lane in felts]))
        return (s.squeeze_bytes(40), s.squeeze_bits(77),
                s.squeeze_native_field_elements(3))

    t0 = time.perf_counter()
    got_bytes, got_bits, got_elems = drive()
    log(f"  lazy sponge {sponge_lanes} lanes (compile + run): "
        f"{time.perf_counter() - t0:.3f} s  [{clock.card}]")
    for b in sorted({0, sponge_lanes // 3, sponge_lanes - 1}):
        o = OraclePoseidonSponge(cfg)
        o.absorb(b"chip smoke transcript")
        o.absorb(U64(u64s[b]))
        o.absorb([Fp(v, fs) for v in felts[b]])
        want = (o.squeeze_bytes(40), o.squeeze_bits(77), o.squeeze_native_field_elements(3))
        if (got_bytes[b], got_bits[b], got_elems[b]) != want:
            raise AssertionError(f"lazy sponge lane {b} differs from the oracle")
    log("  lazy sponge: bytes, bits and field elements match the oracle")


def phase_gpu_tests():
    """The ``gpu``-marked tests, in this process."""
    import pytest

    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", str(ROOT / "tests")]
    )
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit code {int(rc)})")
    log("gpu tests: passed")


def phase_sharded(clock, n_devices=4, log_batch=20, log_leaves=24, lanes=1 << 16,
                  cfgs=None):
    """The sharded path on ``n_devices`` cards vs one card (device 0).

    ``cfgs`` = (permutation config, tree and transcript config); default the
    BLS12-381 rate-2 configs on the 13-bit and 12-bit limb plans.  The
    one-card references run at the one-card phases' shapes (2^log_batch
    lanes per call, ``lanes`` per transcript call), so a warm compile cache
    serves them."""
    import jax
    import jax.numpy as jnp

    import sponge_jax as sj
    from _harness import check_lanes, random_mont_plane
    from sponge_jax.hash import merkle_root
    from sponge_jax.parallel import (
        batch_sharding,
        leaf_sharding,
        make_mesh,
        sharded_merkle_root,
        sharded_permute_fn,
        sharded_transcript_fn,
    )
    from sponge_jax.poseidon.permutation import batched_permute
    from sponge_jax.transcript import Absorb, SqueezeNative, compile_transcript

    if len(jax.devices()) < n_devices:
        raise AssertionError(f"--four needs {n_devices} GPUs, found {len(jax.devices())}")
    mesh = make_mesh(n_devices)
    dev0 = jax.devices()[0]
    cfg, cfg2 = cfgs or (
        sj.get_default_poseidon_parameters(sj.BLS12_381_FR_L13, 2, False),
        sj.get_default_poseidon_parameters(sj.BLS12_381_FR, 2, False),
    )

    def one_card(fn, plane, width):
        """``fn`` on device 0 over ``width``-lane slices of ``plane``."""
        local = jax.device_put(plane, dev0)
        parts = [fn(local[..., lo : lo + width])
                 for lo in range(0, local.shape[-1], width)]
        return jnp.concatenate(parts, axis=-1)

    B = n_devices << log_batch
    state = random_mont_plane(cfg.field, (cfg.t, B), seed=40)
    sharded = jax.device_put(state, batch_sharding(mesh))
    fn = sharded_permute_fn(cfg, mesh)
    out, _ = clock.run(f"sharded_permute {n_devices}x2^{log_batch} (compile + run)", fn, sharded)
    _, t_shard = clock.run(f"sharded_permute {n_devices}x2^{log_batch}, warm", fn, sharded)
    one, t_one = clock.run(f"one card, {n_devices} calls of 2^{log_batch}", one_card,
                           lambda s: batched_permute(cfg, s), state, 1 << log_batch)
    if not bool(jnp.array_equal(jax.device_put(out, dev0), one)):
        raise AssertionError("sharded permutation != one card")
    check_lanes(cfg, state, out, n=64, label="sharded permutation")
    log(f"  sharded permutation == one card; 64 oracle lanes match; one card "
        f"{t_one:.3f} s vs {n_devices} cards {t_shard:.3f} s  [{clock.card}]")

    leaves = random_mont_plane(cfg2.field, (1 << log_leaves,), seed=41)
    root4, _ = clock.run(f"sharded_merkle_root 2^{log_leaves} (compile + run)",
                         sharded_merkle_root, cfg2, jax.device_put(leaves, leaf_sharding(mesh)), mesh)
    root1, _ = clock.run(f"merkle_root 2^{log_leaves} on one card",
                         merkle_root, cfg2, jax.device_put(leaves, dev0))
    if not bool(jnp.array_equal(_canon(cfg2.field, jax.device_put(root4, dev0)[:, None]),
                                _canon(cfg2.field, root1[:, None]))):
        raise AssertionError("sharded Merkle root != one card")
    log("  sharded Merkle root == one card")

    steps = [x for a, s in SCHEDULE for x in (Absorb(a), SqueezeNative(s))]
    elems = _transcript_elems(cfg2.field, n_devices * lanes)
    tfn = sharded_transcript_fn(cfg2, steps, mesh)
    tout, _ = clock.run(f"sharded_transcript {n_devices}x{lanes} (compile + run)",
                        tfn, jax.device_put(elems, batch_sharding(mesh)))
    tone, _ = clock.run(f"compile_transcript on one card, {n_devices} calls of {lanes}",
                        one_card, compile_transcript(cfg2, steps), elems, lanes)
    if not bool(jnp.array_equal(jax.device_put(tout, dev0), tone)):
        raise AssertionError("sharded transcript != one card")
    n = _check_transcript(cfg2, elems, tout, 16, "sharded transcript")
    log(f"  sharded transcript == one card; {n} oracle lanes match")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path, on four cards")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is {dev.platform!r}); "
              "this smoke run needs the card", file=sys.stderr)
        return 2

    import sponge_jax as sj
    from sponge_jax.utils.jaxcache import configure_cache

    log(f"compile cache: {configure_cache()}")
    clock = Clock(phase_device())
    if args.four:
        log("phase sharded (--four)")
        phase_sharded(clock)
    else:
        log("phase 2: golden vector")
        phase_golden(clock)
        log("phase 3: batched permutation")
        for field_name, rate in PERM_CONFIGS:
            cfg = sj.get_default_poseidon_parameters(getattr(sj, field_name), rate, False)
            phase_permutation(clock, cfg, 20)
        log("phase 4: Merkle tree")
        phase_merkle(clock, sj.get_default_poseidon_parameters(sj.BLS12_381_FR, 2, False), 24)
        log("phase 5: Fiat-Shamir")
        phase_transcript(clock, sj.get_default_poseidon_parameters(sj.BLS12_381_FR, 2, False),
                         1 << 16)
        log("phase 6: gpu tests")
        phase_gpu_tests()
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
