"""End-to-end Fiat-Shamir flow: batched prover on device, scalar verifier on
the native host runtime, bit-identical challenges.

The shape every SNARK/STARK toolchain needs from the sponge (the reference's
downstream use in marlin/fractal):

  prover   : thousands of independent transcripts advance in lockstep on the
             accelerator (one compiled device program for the whole schedule);
  verifier : a single transcript replayed on CPU in one native call.

Run: python examples/fiat_shamir.py   (CPU-safe; uses the GPU when present)
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import jax.numpy as jnp

from sponge_jax import BLS12_381_FR as FR, get_default_poseidon_parameters
from sponge_jax.poseidon.host import host_available, host_run_schedule
from sponge_jax.poseidon.oracle import OraclePoseidonSponge
from sponge_jax.transcript import Absorb, SqueezeNative, compile_transcript

cfg = get_default_poseidon_parameters(FR, rate=2)

# The protocol schedule: absorb 3 commitments, draw 2 challenges, absorb the
# response, draw the final challenge.  Static -> one fused device program.
schedule = [Absorb(3), SqueezeNative(2), Absorb(1), SqueezeNative(1)]

# --- Prover side: B independent transcripts in lockstep -------------------
B = 256
rng = np.random.default_rng(0)
msgs = rng.integers(0, 1 << 62, size=(4, B)).tolist()  # 4 absorbed rows

plan = compile_transcript(cfg, schedule)
elem_plane = jnp.asarray(
    np.stack([FR.ints_to_mont_plane(row) for row in msgs], axis=0)
)  # (total_absorbed, L, B)
challenge_planes = plan(elem_plane)  # (n_squeezed, L, B) canonical limb planes
challenges = [
    [FR.limbs_to_int(np.asarray(challenge_planes[i])[:, b]) for b in range(B)]
    for i in range(3)
]
import jax

print(f"prover: {B} transcripts x {len(challenges)} challenges on "
      f"{jax.default_backend()}")

# --- Verifier side: replay transcript #7 on the host runtime --------------
lane = 7
steps = [("absorb", 3), ("squeeze", 2), ("absorb", 1), ("squeeze", 1)]
absorbed = [msgs[i][lane] for i in range(3)] + [msgs[3][lane]]
if host_available(cfg):
    squeezed, _state = host_run_schedule(cfg, steps, absorbed)
    where = "native host runtime (one C++ call)"
else:
    o = OraclePoseidonSponge(cfg)
    o.absorb_field_elements(absorbed[:3])
    squeezed = o.squeeze_native_field_elements(2)
    o.absorb_field_elements(absorbed[3:])
    squeezed += o.squeeze_native_field_elements(1)
    where = "python oracle (no C++ toolchain)"

device_view = [challenges[i][lane] for i in range(3)]
assert squeezed == device_view, (squeezed, device_view)
print(f"verifier ({where}): challenges match the device transcript lane")
print("challenge[0] =", squeezed[0])
