// Native host-side codec: canonical byte values <-> Montgomery 12-bit limb planes.
//
// The framework stores field elements as 22 x 12-bit limbs in int32 planes
// (see sponge_jax/fields.py).  Converting between canonical integers and
// Montgomery-form limbs requires one modular multiplication per element
// (by R^2 mod p, resp. by 1) — pure host work that gates absorb/decode
// throughput for large batches when done in Python.  This file implements the
// conversion in portable C++ (schoolbook 32-bit-limb Montgomery arithmetic with
// 64-bit accumulators, base-2^32 CIOS), exposed with a C ABI for ctypes.
//
// This is the host-runtime analogue of the reference's ark-ff Montgomery
// backend (/root/reference/src/test.rs:10 uses MontBackend<.., 4>); the device
// hot path never touches it.
//
// Build: c++ -O3 -shared -fPIC -o libhostcodec.so host_codec.cc

#include <cstdint>
#include <cstring>

namespace {

constexpr int NWORDS = 8;     // 8 x 32-bit words = 256 bits
constexpr int NLIMBS = 22;    // 22 x 12-bit limbs = 264 bits (matches fields.py)
constexpr int LIMB_BITS = 12;

struct FieldCtx {
  uint32_t p[NWORDS];     // modulus, little-endian 32-bit words
  uint32_t enc[NWORDS];   // encode multiplier: (2^256 * R_dev) mod p
  uint32_t dec[NWORDS];   // decode multiplier: (2^256 / R_dev * 2^256) ... see below
  uint32_t n0inv;         // -p^{-1} mod 2^32
};
// The device limb plane uses R_dev = 2^264 while this file's word-CIOS uses
// R_c = 2^256.  mont_mul(x, c) computes x * c / R_c mod p, so:
//   encode: x -> x * R_dev       needs c_enc = R_c * R_dev mod p
//   decode: y = x * R_dev -> x   needs c_dec = R_c / R_dev mod p

// t (NWORDS+2 words, little-endian) += a * b (single word each) at offset k.
inline void mont_mul(const FieldCtx& f, const uint32_t* a, const uint32_t* b,
                     uint32_t* out) {
  // CIOS: t has NWORDS + 2 words.
  uint32_t t[NWORDS + 2] = {0};
  for (int i = 0; i < NWORDS; ++i) {
    // t += a * b[i]
    uint64_t carry = 0;
    for (int j = 0; j < NWORDS; ++j) {
      uint64_t cur = (uint64_t)t[j] + (uint64_t)a[j] * b[i] + carry;
      t[j] = (uint32_t)cur;
      carry = cur >> 32;
    }
    uint64_t cur = (uint64_t)t[NWORDS] + carry;
    t[NWORDS] = (uint32_t)cur;
    t[NWORDS + 1] = (uint32_t)(cur >> 32);

    // m = t[0] * n0inv mod 2^32;  t += m * p;  t >>= 32
    uint32_t m = t[0] * f.n0inv;
    uint64_t cur2 = (uint64_t)t[0] + (uint64_t)m * f.p[0];
    carry = cur2 >> 32;
    for (int j = 1; j < NWORDS; ++j) {
      uint64_t c2 = (uint64_t)t[j] + (uint64_t)m * f.p[j] + carry;
      t[j - 1] = (uint32_t)c2;
      carry = c2 >> 32;
    }
    uint64_t c3 = (uint64_t)t[NWORDS] + carry;
    t[NWORDS - 1] = (uint32_t)c3;
    t[NWORDS] = t[NWORDS + 1] + (uint32_t)(c3 >> 32);
    t[NWORDS + 1] = 0;
  }
  // Conditional subtraction: result in t[0..NWORDS) (+ t[NWORDS] overflow bit).
  uint64_t borrow = 0;
  uint32_t res[NWORDS];
  for (int j = 0; j < NWORDS; ++j) {
    uint64_t d = (uint64_t)t[j] - f.p[j] - borrow;
    res[j] = (uint32_t)d;
    borrow = (d >> 63) & 1;  // 1 if underflow
  }
  bool ge_p = (t[NWORDS] != 0) || (borrow == 0);
  for (int j = 0; j < NWORDS; ++j) out[j] = ge_p ? res[j] : t[j];
}

inline void words_to_limbs(const uint32_t* w, int32_t* limbs) {
  // 8 x 32-bit words -> 22 x 12-bit limbs (little-endian bit order).
  uint64_t acc = 0;
  int acc_bits = 0, wi = 0;
  for (int l = 0; l < NLIMBS; ++l) {
    if (acc_bits < LIMB_BITS && wi < NWORDS) {
      acc |= (uint64_t)w[wi++] << acc_bits;
      acc_bits += 32;
    }
    limbs[l] = (int32_t)(acc & 0xFFF);
    acc >>= LIMB_BITS;
    acc_bits -= LIMB_BITS;
    if (acc_bits < 0) acc_bits = 0;
  }
}

inline void limbs_to_words(const FieldCtx& f, const int32_t* limbs, uint32_t* w) {
  // 22 x 12-bit limbs -> 8 x 32-bit words by Horner from the top limb.
  // Accepts REDUNDANT limbs (values up to ~2^13, as produced by the device
  // kernels); the represented value can reach limb_max * 2^(12*21) * 2 < 2^266
  // (t=9 XLA-tier states sum up to ~10p).  The Horner accumulates into 9 words
  // (288 bits); binary shift-and-subtract (conditional subtract of p << k for
  // k = 11..0) reduces below p < 2^255 before narrowing to 8 words — exact for
  // any value < p * 2^12.
  uint32_t w9[NWORDS + 1] = {0};
  for (int l = NLIMBS - 1; l >= 0; --l) {
    uint64_t carry = (uint64_t)(uint32_t)limbs[l];  // w9 = (w9 << 12) + limb
    for (int j = 0; j < NWORDS + 1; ++j) {
      uint64_t cur = ((uint64_t)w9[j] << LIMB_BITS) + carry;
      w9[j] = (uint32_t)cur;
      carry = cur >> 32;
    }
  }
  for (int k = 11; k >= 0; --k) {
    // pk = p << k over 9 words.
    uint32_t pk[NWORDS + 1];
    uint32_t hi = 0;
    for (int j = 0; j < NWORDS + 1; ++j) {
      uint32_t pj = j < NWORDS ? f.p[j] : 0;
      pk[j] = (k == 0) ? pj : ((pj << k) | hi);
      hi = (k == 0) ? 0 : (uint32_t)((uint64_t)pj >> (32 - k));
    }
    uint32_t d[NWORDS + 1];
    uint64_t borrow = 0;
    for (int j = 0; j < NWORDS + 1; ++j) {
      uint64_t cur = (uint64_t)w9[j] - pk[j] - borrow;
      d[j] = (uint32_t)cur;
      borrow = (cur >> 63) & 1;
    }
    if (!borrow) std::memcpy(w9, d, sizeof(d));  // w9 >= p<<k: keep difference
  }
  std::memcpy(w, w9, NWORDS * sizeof(uint32_t));
}

}  // namespace

extern "C" {

static void load_ctx(const uint32_t* fctx, FieldCtx* f) {
  std::memcpy(f->p, fctx, sizeof(f->p));
  std::memcpy(f->enc, fctx + NWORDS, sizeof(f->enc));
  std::memcpy(f->dec, fctx + 2 * NWORDS, sizeof(f->dec));
  f->n0inv = fctx[3 * NWORDS];
}

// in:  n elements as 32-byte little-endian canonical values (n * 32 bytes)
// out: Montgomery limb plane, limb-major: out[l * n + i] (NLIMBS * n int32)
// fctx: p (8 words LE) ‖ c_enc (8) ‖ c_dec (8) ‖ n0inv (1)
void encode_mont_plane(const uint8_t* in, int64_t n, const uint32_t* fctx,
                       int32_t* out) {
  FieldCtx f;
  load_ctx(fctx, &f);
  int32_t limbs[NLIMBS];
  uint32_t words[NWORDS], mont[NWORDS];
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(words, in + i * 32, 32);
    mont_mul(f, words, f.enc, mont);  // x * c_enc / R_c = x * R_dev
    words_to_limbs(mont, limbs);
    for (int l = 0; l < NLIMBS; ++l) out[(int64_t)l * n + i] = limbs[l];
  }
}

// in:  Montgomery limb plane, limb-major, CANONICAL 12-bit limbs
// out: n elements as 32-byte little-endian canonical values
void decode_mont_plane(const int32_t* in, int64_t n, const uint32_t* fctx,
                       uint8_t* out) {
  FieldCtx f;
  load_ctx(fctx, &f);
  int32_t limbs[NLIMBS];
  uint32_t words[NWORDS], plain[NWORDS];
  for (int64_t i = 0; i < n; ++i) {
    for (int l = 0; l < NLIMBS; ++l) limbs[l] = in[(int64_t)l * n + i];
    limbs_to_words(f, limbs, words);
    mont_mul(f, words, f.dec, plain);  // (x * R_dev) * c_dec / R_c = x
    std::memcpy(out + i * 32, plain, 32);
  }
}

// Pack a byte stream into field elements: 31-byte little-endian chunks
// (ark-ff ToConstraintField semantics, /root/reference/src/absorb.rs:138),
// emitted as 32-byte LE canonical values.  Returns the element count.
int64_t pack_bytes_to_elements(const uint8_t* in, int64_t nbytes,
                               int64_t chunk, uint8_t* out) {
  int64_t n = (nbytes + chunk - 1) / chunk;
  for (int64_t i = 0; i < n; ++i) {
    int64_t lo = i * chunk;
    int64_t len = nbytes - lo < chunk ? nbytes - lo : chunk;
    std::memset(out + i * 32, 0, 32);
    std::memcpy(out + i * 32, in + lo, (size_t)len);
  }
  return n;
}

}  // extern "C"
