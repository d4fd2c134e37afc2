"""Multi-host (pod-slice) initialization and launch helpers.

The reference has no distributed story at all (SURVEY.md §2.3); this is the
additive capability: one process per host joins a ``jax.distributed``
cluster, builds the global data mesh over every device of the cluster, and runs the
same `shard_map`-based workloads as the single-host path — XLA routes the
batch-axis collectives over the host's interconnect (NVLink) and the
network across hosts.

Typical launcher (one command per host):

    python -m sponge_jax.parallel.multihost --coordinator=HOST0:1234 \
        --num-processes=N --process-id=K

or programmatically::

    from sponge_jax.parallel.multihost import initialize, global_mesh
    initialize(coordinator, num_processes, process_id)   # no-op if single host
    mesh = global_mesh()                                 # all chips, 1-D "data"
"""

from __future__ import annotations

import argparse
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import DATA_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Join the jax.distributed cluster (no-op for single-process runs).

    Pass ``coordinator_address`` (e.g. ``localhost:<port>``),
    ``num_processes`` and ``process_id`` explicitly: nothing auto-detects a
    cluster on a plain GPU host.
    """
    if num_processes is None and coordinator_address is None:
        return  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh() -> Mesh:
    """1-D data mesh over every device in the (possibly multi-host) slice."""
    return Mesh(np.asarray(jax.devices()), (DATA_AXIS,))


def scaling_report(
    cfg,
    batch_per_device: int = 1 << 17,
    reps: int = 5,
    parity_lanes: int = 64,
    parity_stride: int = 7,
) -> dict:
    """Measure sharded permutation throughput on the global mesh.

    Returns {devices, perms_per_sec, perms_per_sec_per_device} — the harness
    behind the >=90% multi-host scaling-efficiency target (BASELINE.md): compare
    ``perms_per_sec_per_device`` across 1-chip / 1-host / N-host runs.

    Parity-gated like every bench probe (bench/_harness.py's refuse-to-report
    rule): lanes are seeded with ``parity_lanes`` random field elements tiled
    periodically across the batch, and the first permutation's output is
    checked against the scalar oracle on this process's addressable shard
    before any number is reported.  Raises RuntimeError on mismatch.  The
    periodic tiling makes every device's shard verifiable locally, so the gate
    works unchanged in multi-process (jax.distributed) runs.
    """
    import time

    from .mesh import batch_sharding
    from .sharded import sharded_permute_fn

    fs = cfg.field
    mesh = global_mesh()
    D = mesh.devices.size
    B = batch_per_device * D
    parity_lanes = min(parity_lanes, batch_per_device)
    sharding = batch_sharding(mesh)

    # Seed lanes: parity_lanes random canonical elements per state row, tiled
    # periodically across the batch so any contiguous shard holds known lanes.
    rng = np.random.default_rng(1234)
    vals = [
        [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=parity_lanes)]
        for _ in range(cfg.t)
    ]
    seed_plane = np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)

    def shard_data(index):
        sl = index[-1]
        cols = np.arange(sl.start or 0, B if sl.stop is None else sl.stop)
        return seed_plane[index[0], index[1], :][..., cols % parity_lanes]

    state = jax.make_array_from_callback((cfg.t, fs.nlimbs, B), sharding, shard_data)
    fn = sharded_permute_fn(cfg, mesh)
    out = fn(state)

    # Scalar-oracle expectations for every seed lane (host bigint; cheap).
    oracle = []
    for b in range(parity_lanes):
        o = cfg.oracle_sponge()
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        oracle.append([v % fs.modulus for v in o.state])

    # Parity gate on the locally-addressable shard (works under multi-process).
    shard = out.addressable_shards[0]
    start = shard.index[-1].start or 0
    local = np.asarray(shard.data)
    for k in range(0, min(parity_lanes, local.shape[-1]), parity_stride):
        got = [
            fs.mont_limbs_to_int(local[i][:, k]) % fs.modulus for i in range(cfg.t)
        ]
        if got != oracle[(start + k) % parity_lanes]:
            raise RuntimeError(
                f"scaling_report PARITY FAILURE at local lane {k} "
                f"(global {start + k}); refusing to report a throughput number"
            )

    def _force(x):
        return np.asarray(x.addressable_shards[0].data[0, 0, :4])

    # One untimed warm window, then best-of-3 timed windows — the same
    # protocol as bench/_harness.time_perms: the host-side oracle/parity work
    # above leaves the device idle for ~seconds, and a single cold window has
    # been measured up to ~10x low (clock-down).  All processes execute the
    # same constant call counts, so the loop stays collective-consistent
    # under jax.distributed.
    for _ in range(reps):
        out = fn(out)
    _force(out)
    best_dt = None
    for _w in range(3):
        t0 = time.time()
        for _ in range(reps):
            out = fn(out)
        _force(out)
        dt = (time.time() - t0) / reps
        best_dt = dt if best_dt is None else min(best_dt, dt)
    return {
        "devices": D,
        "perms_per_sec": B / best_dt,
        "perms_per_sec_per_device": B / best_dt / D,
    }


def _main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--batch-per-device", type=int, default=1 << 17)
    args = parser.parse_args()

    from ..fields import BLS12_381_FR
    from ..poseidon.params import get_default_poseidon_parameters

    initialize(args.coordinator, args.num_processes, args.process_id)
    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2, False)
    report = scaling_report(cfg, args.batch_per_device)
    if jax.process_index() == 0:
        print(report)


if __name__ == "__main__":
    _main()
