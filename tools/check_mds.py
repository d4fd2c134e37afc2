"""Offline MDS verification for circulant matrices over prime fields.

A t x t matrix is MDS iff every square submatrix (minor of every order
1..t) is nonsingular.  For a circulant matrix ``M[i][j] = c[(j - i) mod t]``
minors are invariant under simultaneous rotation of the row and column index
sets, which dedupes the ~C(2t, t) minors by a factor ~t — enough to verify
t = 12 exhaustively in pure Python in a few minutes.

Used once, offline, to pin the power-of-two circulant Concrete matrix of the
Monolith-64 instance (sponge_jax/monolith/params.py); the verified first row
and this script's output are recorded in docs/SECURITY.md.

Run: python tools/check_mds.py
"""

from __future__ import annotations

import itertools
import sys
import time


def det_mod_p(rows_cols, c, t, p):
    """Determinant of the circulant submatrix M[I][J] mod p (Gaussian elim)."""
    I, J = rows_cols
    k = len(I)
    m = [[c[(J[b] - I[a]) % t] % p for b in range(k)] for a in range(k)]
    det = 1
    for col in range(k):
        pivot = next((r for r in range(col, k) if m[r][col] != 0), None)
        if pivot is None:
            return 0
        if pivot != col:
            m[col], m[pivot] = m[pivot], m[col]
            det = p - det if det else 0
        det = (det * m[col][col]) % p
        inv = pow(m[col][col], -1, p)
        for r in range(col + 1, k):
            f = (m[r][col] * inv) % p
            if f:
                mc, mr = m[col], m[r]
                for cc in range(col, k):
                    mr[cc] = (mr[cc] - f * mc[cc]) % p
    return det


def canonical(I, J, t):
    """Canonical representative of the rotation orbit of the (I, J) pair."""
    best = None
    for s in range(t):
        key = (
            tuple(sorted((i + s) % t for i in I)),
            tuple(sorted((j + s) % t for j in J)),
        )
        if best is None or key < best:
            best = key
    return best


def circulant_is_mds(c, p, verbose=True):
    """Exhaustive minor check with rotation dedup; returns (ok, bad_minor)."""
    t = len(c)
    if any(v % p == 0 for v in c):
        return False, ("entry", c)
    t0 = time.time()
    for k in range(2, t + 1):
        seen = set()
        checked = 0
        for I in itertools.combinations(range(t), k):
            for J in itertools.combinations(range(t), k):
                key = canonical(I, J, t)
                if key in seen:
                    continue
                seen.add(key)
                checked += 1
                if det_mod_p((I, J), c, t, p) == 0:
                    return False, (I, J)
        if verbose:
            print(
                f"  order {k:2d}: {checked} unique minors ok "
                f"({time.time() - t0:.1f}s)",
                flush=True,
            )
    return True, None


GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1

# Candidate power-of-two circulant first row for the t=12 Monolith-64
# Concrete layer (entries are 2^k, so the limb-plane matmul is
# multiplication-free: static shifts + adds).
CANDIDATE_T12 = (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)


def main():
    rows = [("goldilocks t=12 pow2 circulant", CANDIDATE_T12, GOLDILOCKS_P)]
    for name, c, p in rows:
        print(f"checking {name}: {c}", flush=True)
        ok, bad = circulant_is_mds(c, p)
        print(f"  -> MDS: {ok}" + (f"  (singular minor at {bad})" if bad else ""))
        if not ok:
            sys.exit(1)


if __name__ == "__main__":
    main()
