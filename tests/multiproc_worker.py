"""Worker process for the 2-process jax.distributed CPU cluster test.

Launched (twice) by tests/test_multiprocess.py:

    python tests/multiproc_worker.py <coordinator> <num_processes> <process_id>

Each process owns 4 virtual CPU devices; the pair forms an 8-device global
mesh through ``multihost.initialize`` (the jax.distributed cluster branch —
SURVEY.md §4: multi-host tests run on CPU via jax.distributed).  The worker
runs the production sharded paths over the GLOBAL mesh and asserts
bit-exactness against the scalar oracle on its addressable shards, then runs
the parity-gated scaling harness end-to-end.  Prints MULTIPROC_OK on success.
"""

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    coordinator, num_processes, process_id = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
    )
    # 4 virtual CPU devices per process — must be set before jax import.
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.pop("JAX_PLATFORMS", None)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from sponge_jax.parallel.multihost import global_mesh, initialize

    initialize(coordinator, num_processes, process_id)
    assert jax.process_count() == num_processes, jax.process_count()
    assert len(jax.local_devices()) == 4
    assert len(jax.devices()) == 4 * num_processes

    import numpy as np

    import jax.numpy as jnp  # noqa: F401
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sponge_jax import GOLDILOCKS_FR, get_default_poseidon_parameters
    from sponge_jax.parallel.mesh import DATA_AXIS
    from sponge_jax.poseidon.permutation import batched_permute

    cfg = get_default_poseidon_parameters(GOLDILOCKS_FR, 4)
    fs = cfg.field
    mesh = global_mesh()
    D = mesh.devices.size

    # ---- 1) sharded permutation over the cross-process mesh == oracle ----
    B = 2 * D
    rng = np.random.default_rng(42)  # same seed in every process
    vals = [
        [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=B)]
        for _ in range(cfg.t)
    ]
    plane = np.stack([fs.ints_to_mont_plane(row) for row in vals], axis=0)
    sharding = NamedSharding(mesh, P(None, None, DATA_AXIS))
    state = jax.make_array_from_callback(
        plane.shape, sharding, lambda idx: plane[idx]
    )
    fn = jax.jit(
        shard_map(
            lambda c: batched_permute(cfg, c, "xla"),
            mesh=mesh,
            in_specs=P(None, None, DATA_AXIS),
            out_specs=P(None, None, DATA_AXIS),
        )
    )
    out = fn(state)
    jax.block_until_ready(out)

    expect = []
    for b in range(B):
        o = cfg.oracle_sponge()
        o.state = [vals[i][b] for i in range(cfg.t)]
        o.permute()
        expect.append([v % fs.modulus for v in o.state])
    checked = 0
    for shard in out.addressable_shards:
        start = shard.index[-1].start or 0
        loc = np.asarray(shard.data)
        for k in range(loc.shape[-1]):
            got = [
                fs.mont_limbs_to_int(loc[i][:, k]) % fs.modulus
                for i in range(cfg.t)
            ]
            assert got == expect[start + k], (start + k, got, expect[start + k])
            checked += 1
    assert checked == B // num_processes, checked
    print(f"[p{process_id}] sharded permute == oracle on {checked} local lanes", flush=True)

    # ---- 2) sharded Merkle root across processes == host oracle root ----
    from sponge_jax.parallel import sharded_merkle_root

    N = 4 * D
    leaf_vals = [int(v) % fs.modulus for v in rng.integers(0, 1 << 62, size=N)]
    leaves_np = fs.ints_to_mont_plane(leaf_vals)
    leaves = jax.make_array_from_callback(
        leaves_np.shape, NamedSharding(mesh, P(None, DATA_AXIS)),
        lambda idx: leaves_np[idx],
    )
    root = sharded_merkle_root(cfg, leaves, mesh)
    jax.block_until_ready(root)

    def oracle_compress(left, right):
        o = cfg.oracle_sponge()
        o.absorb_field_elements([left, right])
        return o.squeeze_native_field_elements(1)[0]

    level = list(leaf_vals)
    while len(level) > 1:
        level = [
            oracle_compress(level[i], level[i + 1]) for i in range(0, len(level), 2)
        ]
    got_root = fs.mont_limbs_to_int(
        np.asarray(root.addressable_shards[0].data).reshape(-1)
    ) % fs.modulus
    assert got_root == level[0] % fs.modulus, (got_root, level[0])
    print(f"[p{process_id}] sharded Merkle root == oracle root", flush=True)

    # ---- 3) the parity-gated scaling harness, end to end ----
    from sponge_jax.parallel.multihost import scaling_report

    report = scaling_report(cfg, batch_per_device=8, reps=1, parity_lanes=8)
    assert report["devices"] == 4 * num_processes
    assert report["perms_per_sec"] > 0
    print(f"[p{process_id}] scaling_report gated OK: {report}", flush=True)

    print("MULTIPROC_OK", flush=True)


if __name__ == "__main__":
    main()
