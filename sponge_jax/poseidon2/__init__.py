"""Poseidon2 permutation family (additive capability; no reference counterpart).

The reference crate (/root/reference) ships only the original Poseidon
permutation.  Poseidon2 (Grassi-Khovratovich-Schofnegger, ePrint 2023/323)
keeps the same duplex-sponge interface but replaces the dense MDS linear layer
with two cheap structured matrices:

* external (full) rounds use ``M_E`` with tiny integer entries (circulant
  ``circ(2,1,1)`` at t=3; 4x4 ``M4`` blocks for t = 4k), and
* internal (partial) rounds use ``M_I = J + diag(mu - 1)`` (all-ones plus a
  diagonal), so one round costs a single S-box plus a shared row sum.

This maps exceptionally well to the limb-plane design: multiplying a
Montgomery-form element by a small plain integer is just ``c * x`` on the
limb planes followed by a carry renormalization — no REDC at all — so the
whole Poseidon2 linear layer runs without Montgomery multiplications and the
permutation's only REDCs are the S-box chains.

Everything above the permutation (duplex state machine, absorb codec,
squeeze formatting, transcripts, Merkle, checkpointing) is shared with
Poseidon: ``PoseidonSponge(Poseidon2Config(...))`` just works, because the
sponge dispatches the permutation on the config type.
"""

from .config import Poseidon2Config
from .oracle import OraclePoseidon2Sponge
from .params import get_default_poseidon2_parameters, generate_poseidon2_parameters
from .permutation import poseidon2_permute

__all__ = [
    "Poseidon2Config",
    "OraclePoseidon2Sponge",
    "get_default_poseidon2_parameters",
    "generate_poseidon2_parameters",
    "poseidon2_permute",
]
