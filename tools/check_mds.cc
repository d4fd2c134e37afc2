// Exhaustive MDS verification for circulant matrices over prime fields.
//
// A t x t matrix is MDS iff every square submatrix is nonsingular.  For a
// circulant M[i][j] = c[(j - i) mod t], minors are invariant under
// simultaneous rotation of the row/column index sets, so it suffices to
// check pairs whose row mask contains index 0 and that are lexicographically
// minimal over the rotations keeping 0 in the row set (~C(2t,t)/t minors;
// t = 16 -> ~38M determinants, seconds-to-minutes multi-threaded).
//
// This is the native companion of tools/check_mds.py (same semantics; the
// python version cross-checks this one on the Goldilocks t=12 row).  Used
// offline to pin power-of-two circulant Concrete matrices for the Monolith
// instances (sponge_jax/monolith/params.py); results are recorded in
// docs/SECURITY.md.
//
// Build:  g++ -O2 -std=c++17 -pthread -o /tmp/check_mds tools/check_mds.cc
// Check:  /tmp/check_mds check  <p> <t> <c0> <c1> ... <c_{t-1}>
// Search: /tmp/check_mds search <p> <t> <max_exp> <seed> [n_candidates]
//         (deterministic xorshift64 exponent draws; prints the first row of
//          powers of two whose circulant is MDS)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

static u64 P;  // the prime modulus (< 2^63)

static inline u64 mulmod(u64 a, u64 b) { return (u64)((u128)a * b % P); }
static inline u64 submod(u64 a, u64 b) { return a >= b ? a - b : a + P - b; }

// Nonsingularity test by cross-multiplication elimination (no inversions):
// zero-ness of the determinant is preserved since every row update scales
// the determinant by the (nonzero) pivot.
static bool nonsingular(u64 m[16][16], int k) {
  for (int col = 0; col < k; ++col) {
    int piv = -1;
    for (int r = col; r < k; ++r)
      if (m[r][col] != 0) { piv = r; break; }
    if (piv < 0) return false;
    if (piv != col)
      for (int c = col; c < k; ++c) std::swap(m[piv][c], m[col][c]);
    const u64 pv = m[col][col];
    for (int r = col + 1; r < k; ++r) {
      const u64 f = m[r][col];
      if (!f) continue;
      for (int c = col; c < k; ++c)
        m[r][c] = submod(mulmod(m[r][c], pv), mulmod(m[col][c], f));
    }
  }
  return true;
}

static inline unsigned ror(unsigned mask, int s, int t) {
  const unsigned full = (t == 32) ? 0xffffffffu : ((1u << t) - 1);
  s %= t;
  return ((mask >> s) | (mask << (t - s))) & full;
}

// Canonical-orbit filter: among the rotations of (I, J) that keep 0 in I,
// process only the lexicographically smallest (I, then J) representative.
static inline bool is_canonical(unsigned mi, unsigned mj, int t) {
  for (int s = 1; s < t; ++s) {
    if (!(mi >> s & 1)) continue;  // rotation by -s keeps 0 in I iff s in I
    const unsigned ri = ror(mi, s, t), rj = ror(mj, s, t);
    if (ri < mi || (ri == mi && rj < mj)) return false;
  }
  return true;
}

struct Shared {
  const std::vector<u64>* c;
  int t;
  const std::vector<std::vector<unsigned>>* by_pop;  // masks per popcount
  std::atomic<bool> singular{false};
  std::atomic<long long> checked{0};
};

static void worker(Shared* sh, int tid, int nthreads) {
  const int t = sh->t;
  const std::vector<u64>& c = *sh->c;
  u64 m[16][16];
  int idx[16], jdx[16];
  long long local = 0;
  // Row masks containing bit 0, striped across threads.
  for (unsigned mi = 1; mi < (1u << t); mi += 2) {
    if (((mi >> 1) % (unsigned)nthreads) != (unsigned)tid) continue;
    if (sh->singular.load(std::memory_order_relaxed)) return;
    const int k = __builtin_popcount(mi);
    int ni = 0;
    for (int b = 0; b < t; ++b)
      if (mi >> b & 1) idx[ni++] = b;
    for (unsigned mj : (*sh->by_pop)[k]) {
      if (!is_canonical(mi, mj, t)) continue;
      int nj = 0;
      for (int b = 0; b < t; ++b)
        if (mj >> b & 1) jdx[nj++] = b;
      for (int a = 0; a < k; ++a)
        for (int b = 0; b < k; ++b)
          m[a][b] = c[(jdx[b] - idx[a] + t) % t];
      ++local;
      if (!nonsingular(m, k)) {
        sh->singular.store(true);
        std::fprintf(stderr, "singular minor: I=%#x J=%#x (k=%d)\n", mi, mj, k);
        return;
      }
    }
  }
  sh->checked.fetch_add(local);
}

static bool circulant_is_mds(const std::vector<u64>& c, int t, long long* n) {
  for (u64 v : c)
    if (v % P == 0) return false;
  std::vector<std::vector<unsigned>> by_pop(t + 1);
  for (unsigned m = 1; m < (1u << t); ++m)
    by_pop[__builtin_popcount(m)].push_back(m);
  Shared sh;
  sh.c = &c;
  sh.t = t;
  sh.by_pop = &by_pop;
  const int nt = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> ts;
  for (int i = 0; i < nt; ++i) ts.emplace_back(worker, &sh, i, nt);
  for (auto& th : ts) th.join();
  if (n) *n = sh.checked.load();
  return !sh.singular.load();
}

static u64 xorshift64(u64* s) {
  u64 x = *s;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return *s = x;
}

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr, "usage: %s check|search <p> <t> ...\n", argv[0]);
    return 2;
  }
  P = std::strtoull(argv[2], nullptr, 0);
  const int t = std::atoi(argv[3]);
  if (t < 2 || t > 16) {
    std::fprintf(stderr, "t must be in [2, 16]\n");
    return 2;
  }
  if (!std::strcmp(argv[1], "check")) {
    if (argc != 4 + t) {
      std::fprintf(stderr, "check needs %d entries\n", t);
      return 2;
    }
    std::vector<u64> c(t);
    for (int i = 0; i < t; ++i) c[i] = std::strtoull(argv[4 + i], nullptr, 0) % P;
    long long n = 0;
    const bool ok = circulant_is_mds(c, t, &n);
    std::printf("MDS: %s (%lld rotation-unique minors checked)\n",
                ok ? "true" : "FALSE", n);
    return ok ? 0 : 1;
  }
  // search  = power-of-two entries 2^e, e in [0, max);
  // searchv = small integer entries in [1, max]  (plain-scaling path).
  const bool pow2 = !std::strcmp(argv[1], "search");
  if (pow2 || !std::strcmp(argv[1], "searchv")) {
    if (argc < 6) {
      std::fprintf(stderr, "search|searchv <p> <t> <max> <seed> [n]\n");
      return 2;
    }
    const int maxv = std::atoi(argv[4]);
    u64 seed = std::strtoull(argv[5], nullptr, 0);
    const int ncand = argc > 6 ? std::atoi(argv[6]) : 1000;
    for (int cand = 0; cand < ncand; ++cand) {
      std::vector<u64> c(t);
      for (int i = 0; i < t; ++i) {
        const u64 v = xorshift64(&seed) % (u64)maxv;
        c[i] = pow2 ? ((u64)1 << v) : v + 1;
      }
      long long n = 0;
      if (circulant_is_mds(c, t, &n)) {
        std::printf("MDS FOUND: candidate %d (%lld minors):", cand, n);
        for (int i = 0; i < t; ++i) std::printf(" %llu", (unsigned long long)c[i]);
        std::printf("\n");
        return 0;
      }
      if (cand % 200 == 199) {
        std::printf("... %d candidates rejected\n", cand + 1);
        std::fflush(stdout);
      }
    }
    std::printf("no MDS circulant found\n");
    return 1;
  }
  std::fprintf(stderr, "unknown mode %s\n", argv[1]);
  return 2;
}
