"""Merkle commitment workflow: build a tree on device, open a batch of
indices in one fused gather program, verify the batch in one device program.

This is the STARK/FRI commitment shape: commit to 2^k leaves, the verifier
samples q random indices, the prover opens all q paths at once.

Run: python examples/merkle_commitment.py   (CPU-safe; uses the GPU when present)
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import jax
import jax.numpy as jnp

from sponge_jax import GOLDILOCKS_FR as F, get_default_monolith_parameters
from sponge_jax.hash import (
    merkle_open_batch,
    merkle_root,
    merkle_tree,
    merkle_verify_batch,
)

# Any permutation family drives the Merkle layer through the config hook;
# Monolith over Goldilocks is the small-field throughput choice.
cfg = get_default_monolith_parameters(F)

N = 1 << 10
rng = np.random.default_rng(1)
leaf_vals = [int(v) % F.modulus for v in rng.integers(0, 1 << 62, size=N)]
leaves = jnp.asarray(F.ints_to_mont_plane(leaf_vals))  # (L, N)

levels = merkle_tree(cfg, leaves)  # all levels, device-resident
root = merkle_root(cfg, leaves)
assert np.array_equal(np.asarray(levels[-1])[:, 0], np.asarray(root))

# Open q indices in ONE fused gather program.
q = 32
indices = rng.integers(0, N, size=q)
paths = merkle_open_batch(levels, indices)  # (depth, L, q) sibling planes

# Verify all q proofs in ONE device program (depth batched compressions).
opened = jnp.asarray(
    np.stack([np.asarray(leaves)[:, i] for i in indices], axis=-1)
)
ok = merkle_verify_batch(cfg, root, opened, paths, indices)
assert bool(np.all(np.asarray(ok))), "all proofs must verify"

# Tamper with one opened leaf: exactly that proof must fail.
bad = np.asarray(opened).copy()
bad[:, 3] = np.asarray(F.ints_to_mont_plane([(leaf_vals[indices[3]] + 1) % F.modulus]))[:, 0]
ok2 = np.asarray(merkle_verify_batch(cfg, root, jnp.asarray(bad), paths, indices))
assert not ok2[3] and ok2[[i for i in range(q) if i != 3]].all()

print(f"committed {N} Goldilocks leaves on {jax.default_backend()}; "
      f"opened+verified {q} proofs in 2 device programs")
print("root =", F.mont_limbs_to_int(np.asarray(root)))
