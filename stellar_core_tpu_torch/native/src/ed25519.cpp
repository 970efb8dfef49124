// Ed25519 strict verification — native CPU backend + batch bridge.
//
// From-scratch implementation over GF(2^255-19) in radix-2^51 with
// unsigned __int128 products. Semantics match the framework contract
// defined in stellar_core_tpu/crypto/ed25519_ref.py (and thereby libsodium's
// crypto_sign_verify_detached, reference crypto/SecretKey.cpp:427-460):
//   - reject S >= L, non-canonical A/R encodings, small-order A/R
//   - cofactorless [S]B == R + [k]A, k = SHA512(R‖A‖M) mod L
//
// Exposed C ABI:
//   sc_ed25519_verify(pub, sig, msg, msglen) -> 1/0
//   sc_ed25519_batch_verify(...)             -> per-sig results (CPU baseline)
//   sc_ed25519_batch_prepare(...)            -> k scalars + precheck flags
//       (host-side prep feeding the JAX/TPU kernel)
//   sc_ed25519_public_from_seed(seed, out)

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

namespace scnative {
void sha512(const uint8_t* data, size_t len, uint8_t out[64]);

// ---------------------------------------------------------------- field ----
// fe: 5 limbs of 51 bits, value = sum limb[i] * 2^(51 i), loosely reduced.
typedef uint64_t fe[5];
typedef unsigned __int128 u128;

static const uint64_t MASK51 = (1ULL << 51) - 1;

static void fe_0(fe h) { memset(h, 0, sizeof(fe)); }
static void fe_1(fe h) { fe_0(h); h[0] = 1; }
static void fe_copy(fe h, const fe f) { memcpy(h, f, sizeof(fe)); }

static void fe_frombytes(fe h, const uint8_t s[32]) {
    uint64_t v[4];
    for (int i = 0; i < 4; i++) {
        v[i] = 0;
        for (int j = 0; j < 8; j++) v[i] |= (uint64_t)s[i * 8 + j] << (8 * j);
    }
    h[0] = v[0] & MASK51;
    h[1] = ((v[0] >> 51) | (v[1] << 13)) & MASK51;
    h[2] = ((v[1] >> 38) | (v[2] << 26)) & MASK51;
    h[3] = ((v[2] >> 25) | (v[3] << 39)) & MASK51;
    h[4] = (v[3] >> 12) & MASK51;  // drops bit 255 (the sign bit)
}

static void fe_carry(fe h) {
    uint64_t c;
    c = h[0] >> 51; h[0] &= MASK51; h[1] += c;
    c = h[1] >> 51; h[1] &= MASK51; h[2] += c;
    c = h[2] >> 51; h[2] &= MASK51; h[3] += c;
    c = h[3] >> 51; h[3] &= MASK51; h[4] += c;
    c = h[4] >> 51; h[4] &= MASK51; h[0] += c * 19;
    c = h[0] >> 51; h[0] &= MASK51; h[1] += c;
}

// fully reduce to [0, p) and serialize little-endian (255 bits)
static void fe_tobytes(uint8_t s[32], const fe f) {
    fe t;
    fe_copy(t, f);
    fe_carry(t);
    fe_carry(t);
    // now t < 2^255 + small; subtract p if >= p, twice to be safe
    for (int pass = 0; pass < 2; pass++) {
        // compute t - p = t - (2^255 - 19) = t + 19 - 2^255
        uint64_t q[5];
        u128 c = (u128)t[0] + 19;
        q[0] = (uint64_t)c & MASK51; c >>= 51;
        for (int i = 1; i < 5; i++) {
            c += t[i];
            q[i] = (uint64_t)c & MASK51;
            c >>= 51;
        }
        // c is now bit 255 of (t+19): if set, t >= p
        if (c) {
            memcpy(t, q, sizeof(q));
        }
    }
    uint64_t v0 = t[0] | (t[1] << 51);
    uint64_t v1 = (t[1] >> 13) | (t[2] << 38);
    uint64_t v2 = (t[2] >> 26) | (t[3] << 25);
    uint64_t v3 = (t[3] >> 39) | (t[4] << 12);
    uint64_t v[4] = {v0, v1, v2, v3};
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++) s[i * 8 + j] = (uint8_t)(v[i] >> (8 * j));
}

static void fe_add(fe h, const fe f, const fe g) {
    for (int i = 0; i < 5; i++) h[i] = f[i] + g[i];
}

// h = f - g, biased by 4p so it stays positive even when g's limbs are
// un-carried sums up to ~2^53 (as produced by fe_add inside ge_add)
static void fe_sub(fe h, const fe f, const fe g) {
    h[0] = f[0] + ((MASK51 - 18) << 2) - g[0];
    h[1] = f[1] + (MASK51 << 2) - g[1];
    h[2] = f[2] + (MASK51 << 2) - g[2];
    h[3] = f[3] + (MASK51 << 2) - g[3];
    h[4] = f[4] + (MASK51 << 2) - g[4];
    fe_carry(h);
}

static void fe_mul(fe h, const fe f, const fe g) {
    u128 r0, r1, r2, r3, r4;
    uint64_t f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4];
    uint64_t g0 = g[0], g1 = g[1], g2 = g[2], g3 = g[3], g4 = g[4];
    uint64_t g1_19 = g1 * 19, g2_19 = g2 * 19, g3_19 = g3 * 19, g4_19 = g4 * 19;
    r0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 + (u128)f3 * g2_19 + (u128)f4 * g1_19;
    r1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 + (u128)f3 * g3_19 + (u128)f4 * g2_19;
    r2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 + (u128)f3 * g4_19 + (u128)f4 * g3_19;
    r3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 + (u128)f3 * g0 + (u128)f4 * g4_19;
    r4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 + (u128)f3 * g1 + (u128)f4 * g0;
    uint64_t c;
    uint64_t h0 = (uint64_t)r0 & MASK51; c = (uint64_t)(r0 >> 51);
    r1 += c; uint64_t h1 = (uint64_t)r1 & MASK51; c = (uint64_t)(r1 >> 51);
    r2 += c; uint64_t h2 = (uint64_t)r2 & MASK51; c = (uint64_t)(r2 >> 51);
    r3 += c; uint64_t h3 = (uint64_t)r3 & MASK51; c = (uint64_t)(r3 >> 51);
    r4 += c; uint64_t h4 = (uint64_t)r4 & MASK51; c = (uint64_t)(r4 >> 51);
    h0 += c * 19; c = h0 >> 51; h0 &= MASK51; h1 += c;
    h[0] = h0; h[1] = h1; h[2] = h2; h[3] = h3; h[4] = h4;
}

static void fe_sq(fe h, const fe f) { fe_mul(h, f, f); }

static void fe_nsquare(fe h, const fe f, int n) {
    fe_copy(h, f);
    for (int i = 0; i < n; i++) fe_sq(h, h);
}

// h = f^(p-2) = f^(2^255 - 21)  (standard square-multiply chain)
static void fe_invert(fe out, const fe z) {
    fe t0, t1, t2, t3;
    fe_sq(t0, z);                        // 2
    fe_nsquare(t1, t0, 2);               // 8
    fe_mul(t1, z, t1);                   // 9
    fe_mul(t0, t0, t1);                  // 11
    fe_sq(t2, t0);                       // 22
    fe_mul(t1, t1, t2);                  // 31 = 2^5-1
    fe_nsquare(t2, t1, 5);
    fe_mul(t1, t2, t1);                  // 2^10-1
    fe_nsquare(t2, t1, 10);
    fe_mul(t2, t2, t1);                  // 2^20-1
    fe_nsquare(t3, t2, 20);
    fe_mul(t2, t3, t2);                  // 2^40-1
    fe_nsquare(t2, t2, 10);
    fe_mul(t1, t2, t1);                  // 2^50-1
    fe_nsquare(t2, t1, 50);
    fe_mul(t2, t2, t1);                  // 2^100-1
    fe_nsquare(t3, t2, 100);
    fe_mul(t2, t3, t2);                  // 2^200-1
    fe_nsquare(t2, t2, 50);
    fe_mul(t1, t2, t1);                  // 2^250-1
    fe_nsquare(t1, t1, 5);               // 2^255-2^5
    fe_mul(out, t1, t0);                 // 2^255-21
}

// h = f^((p-5)/8) = f^(2^252-3)
static void fe_pow2523(fe out, const fe z) {
    fe t0, t1, t2;
    fe_sq(t0, z);
    fe_nsquare(t1, t0, 2);
    fe_mul(t1, z, t1);                   // 9
    fe_mul(t0, t0, t1);                  // 11
    fe_sq(t0, t0);                       // 22
    fe_mul(t0, t1, t0);                  // 31
    fe_nsquare(t1, t0, 5);
    fe_mul(t0, t1, t0);                  // 2^10-1
    fe_nsquare(t1, t0, 10);
    fe_mul(t1, t1, t0);                  // 2^20-1
    fe_nsquare(t2, t1, 20);
    fe_mul(t1, t2, t1);                  // 2^40-1
    fe_nsquare(t1, t1, 10);
    fe_mul(t0, t1, t0);                  // 2^50-1
    fe_nsquare(t1, t0, 50);
    fe_mul(t1, t1, t0);                  // 2^100-1
    fe_nsquare(t2, t1, 100);
    fe_mul(t1, t2, t1);                  // 2^200-1
    fe_nsquare(t1, t1, 50);
    fe_mul(t0, t1, t0);                  // 2^250-1
    fe_nsquare(t0, t0, 2);               // 2^252-4
    fe_mul(out, t0, z);                  // 2^252-3
}

static int fe_isnonzero(const fe f) {
    uint8_t s[32];
    fe_tobytes(s, f);
    uint8_t acc = 0;
    for (int i = 0; i < 32; i++) acc |= s[i];
    return acc != 0;
}

static int fe_isnegative(const fe f) {
    uint8_t s[32];
    fe_tobytes(s, f);
    return s[0] & 1;
}

// constants
static fe FE_D, FE_SQRTM1;
static void init_constants();

// ---------------------------------------------------------------- group ----
// extended coordinates (X, Y, Z, T), x=X/Z, y=Y/Z, T=XY/Z
struct ge {
    fe X, Y, Z, T;
};

static void ge_identity(ge& h) {
    fe_0(h.X); fe_1(h.Y); fe_1(h.Z); fe_0(h.T);
}

// complete unified addition (a=-1 twisted Edwards, add-2008-hwcd-3 shape)
static void ge_add(ge& r, const ge& p, const ge& q) {
    fe a, b, c, d, e, f, g, h, t;
    fe_sub(t, p.Y, p.X);
    fe_sub(a, q.Y, q.X);
    fe_mul(a, t, a);
    fe_add(t, p.Y, p.X);
    fe_add(b, q.Y, q.X);
    fe_mul(b, t, b);
    fe_mul(c, p.T, q.T);
    fe_mul(c, c, FE_D);
    fe_add(c, c, c);
    fe_mul(d, p.Z, q.Z);
    fe_add(d, d, d);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.X, e, f);
    fe_mul(r.Y, g, h);
    fe_mul(r.Z, f, g);
    fe_mul(r.T, e, h);
}

// dedicated doubling, dbl-2008-hwcd (a=-1): 4M + 4S — much cheaper than
// the unified add for the 256 doublings of the verify ladder
static void ge_double(ge& r, const ge& p) {
    fe A, B, C, D, E, G, F, H;
    fe_sq(A, p.X);
    fe_sq(B, p.Y);
    fe_sq(C, p.Z);
    fe_add(C, C, C);
    fe_add(D, p.X, p.Y);
    fe_sq(D, D);
    fe_add(H, A, B);
    fe_sub(E, H, D);     // E = A + B - (X+Y)^2 = -2XY
    fe_sub(G, A, B);     // G = A - B   (a=-1: G = aA - B ... sign folded below)
    fe_add(F, C, G);
    fe_mul(r.X, E, F);
    fe_mul(r.Y, G, H);
    fe_mul(r.T, E, H);
    fe_mul(r.Z, F, G);
}

// cached-operand representation of a point for repeated additions:
// (Y+X, Y−X, Z, 2dT) — one-time conversion, then each add saves the
// operand sums and the d multiplication (add-2008-hwcd-3 shape)
struct gecached {
    fe YplusX, YminusX, Z, T2d;
};

static fe FE_2D;

static void ge_to_cached(gecached& c, const ge& p) {
    fe_add(c.YplusX, p.Y, p.X);
    fe_sub(c.YminusX, p.Y, p.X);
    fe_copy(c.Z, p.Z);
    fe_mul(c.T2d, p.T, FE_2D);
}

static void ge_add_cached(ge& r, const ge& p, const gecached& q) {
    fe a, b, c, d, e, f, g, h, t;
    fe_sub(t, p.Y, p.X);
    fe_mul(a, t, q.YminusX);
    fe_add(t, p.Y, p.X);
    fe_mul(b, t, q.YplusX);
    fe_mul(c, p.T, q.T2d);
    fe_mul(d, p.Z, q.Z);
    fe_add(d, d, d);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.X, e, f);
    fe_mul(r.Y, g, h);
    fe_mul(r.Z, f, g);
    fe_mul(r.T, e, h);
}

// subtraction against a cached point: swap the (Y±X) operands and
// negate the T2d term
static void ge_sub_cached(ge& r, const ge& p, const gecached& q) {
    fe a, b, c, d, e, f, g, h, t;
    fe_sub(t, p.Y, p.X);
    fe_mul(a, t, q.YplusX);
    fe_add(t, p.Y, p.X);
    fe_mul(b, t, q.YminusX);
    fe_mul(c, p.T, q.T2d);
    fe_mul(d, p.Z, q.Z);
    fe_add(d, d, d);
    fe_sub(e, b, a);
    fe_add(f, d, c);      // f = 2ZZ' + c  (c negated => add)
    fe_sub(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.X, e, f);
    fe_mul(r.Y, g, h);
    fe_mul(r.Z, f, g);
    fe_mul(r.T, e, h);
}

static void ge_neg(ge& r, const ge& p) {
    fe zero;
    fe_0(zero);
    fe_sub(r.X, zero, p.X);
    fe_copy(r.Y, p.Y);
    fe_copy(r.Z, p.Z);
    fe_sub(r.T, zero, p.T);
}

static void ge_tobytes(uint8_t s[32], const ge& p) {
    fe zi, x, y;
    fe_invert(zi, p.Z);
    fe_mul(x, p.X, zi);
    fe_mul(y, p.Y, zi);
    fe_tobytes(s, y);
    s[31] ^= (uint8_t)(fe_isnegative(x) << 7);
}

// strict decompression: rejects y >= p, invalid x, and "-0"
static int ge_frombytes_strict(ge& h, const uint8_t s[32]) {
    // canonical check: y (low 255 bits) must be < p = 2^255-19
    {
        int ge_p = 1;  // assume >= p, falsify
        if ((s[31] & 0x7F) != 0x7F) ge_p = 0;
        for (int i = 30; i >= 1 && ge_p; i--)
            if (s[i] != 0xFF) ge_p = 0;
        if (ge_p && s[0] < 0xED) ge_p = 0;
        if (ge_p) return 0;
    }
    int sign = s[31] >> 7;
    fe y, u, v, v3, x, vxx, check;
    fe_frombytes(y, s);
    fe one;
    fe_1(one);
    fe_sq(u, y);
    fe_mul(v, u, FE_D);
    fe_sub(u, u, one);   // u = y^2 - 1
    fe_add(v, v, one);   // v = d y^2 + 1
    // x = u v^3 (u v^7)^((p-5)/8)
    fe_sq(v3, v);
    fe_mul(v3, v3, v);
    fe_sq(x, v3);
    fe_mul(x, x, v);
    fe_mul(x, x, u);     // u v^7
    fe_pow2523(x, x);
    fe_mul(x, x, v3);
    fe_mul(x, x, u);     // u v^3 (u v^7)^((p-5)/8)
    fe_sq(vxx, x);
    fe_mul(vxx, vxx, v);
    fe_sub(check, vxx, u);
    if (fe_isnonzero(check)) {
        fe_add(check, vxx, u);
        if (fe_isnonzero(check)) return 0;
        fe_mul(x, x, FE_SQRTM1);
    }
    if (!fe_isnonzero(x) && sign) return 0;  // "-0"
    if (fe_isnegative(x) != sign) {
        fe zero;
        fe_0(zero);
        fe_sub(x, zero, x);
    }
    fe_copy(h.X, x);
    fe_copy(h.Y, y);
    fe_1(h.Z);
    fe_mul(h.T, x, y);
    return 1;
}

static int ge_is_identity(const ge& p) {
    // X == 0 and Y == Z
    fe t;
    fe_sub(t, p.Y, p.Z);
    return !fe_isnonzero(p.X) && !fe_isnonzero(t);
}

static int ge_has_small_order(const ge& p) {
    ge q;
    ge_double(q, p);
    ge_double(q, q);
    ge_double(q, q);
    return ge_is_identity(q);
}

// ------------------------------------------------------------- scalars ----
// L = 2^252 + 27742317777372353535851937790883648493

static const uint8_t L_BYTES[32] = {
    0xED, 0xD3, 0xF5, 0x5C, 0x1A, 0x63, 0x12, 0x58,
    0xD6, 0x9C, 0xF7, 0xA2, 0xDE, 0xF9, 0xDE, 0x14,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};

static int sc_is_canonical(const uint8_t s[32]) {
    // s < L, little-endian compare
    for (int i = 31; i >= 0; i--) {
        if (s[i] < L_BYTES[i]) return 1;
        if (s[i] > L_BYTES[i]) return 0;
    }
    return 0;  // s == L
}

// reduce a 512-bit little-endian number mod L by shifted conditional subtract
static void sc_reduce512(uint8_t out[32], const uint8_t in[64]) {
    // limbs base 2^32, 16 limbs input + headroom
    uint64_t n[17] = {0};
    for (int i = 0; i < 16; i++)
        n[i] = (uint64_t)in[4 * i] | ((uint64_t)in[4 * i + 1] << 8) |
               ((uint64_t)in[4 * i + 2] << 16) | ((uint64_t)in[4 * i + 3] << 24);
    uint64_t l[9] = {0};
    for (int i = 0; i < 8; i++)
        l[i] = (uint64_t)L_BYTES[4 * i] | ((uint64_t)L_BYTES[4 * i + 1] << 8) |
               ((uint64_t)L_BYTES[4 * i + 2] << 16) | ((uint64_t)L_BYTES[4 * i + 3] << 24);
    // for shift = 260 down to 0 bits: if n >= L<<shift, subtract
    for (int shift = 260; shift >= 0; shift--) {
        int limb = shift / 32, bits = shift % 32;
        // build L<<shift into 17 limbs
        uint64_t ls[17] = {0};
        uint64_t carry = 0;
        for (int i = 0; i < 9; i++) {
            uint64_t cur = (l[i] << bits) | carry;
            if (limb + i < 17) ls[limb + i] |= cur & 0xFFFFFFFFULL;
            carry = bits ? (l[i] >> (32 - bits)) : 0;
        }
        if (carry && limb + 9 < 17) ls[limb + 9] |= carry;
        // compare n >= ls
        int geq = 1;
        for (int i = 16; i >= 0; i--) {
            if (n[i] > ls[i]) { geq = 1; break; }
            if (n[i] < ls[i]) { geq = 0; break; }
        }
        if (geq) {
            int64_t borrow = 0;
            for (int i = 0; i < 17; i++) {
                int64_t d = (int64_t)n[i] - (int64_t)ls[i] - borrow;
                if (d < 0) { d += 0x100000000LL; borrow = 1; } else borrow = 0;
                n[i] = (uint64_t)d;
            }
        }
    }
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)n[i];
        out[4 * i + 1] = (uint8_t)(n[i] >> 8);
        out[4 * i + 2] = (uint8_t)(n[i] >> 16);
        out[4 * i + 3] = (uint8_t)(n[i] >> 24);
    }
}

// out = (k*a + r) mod L — schoolbook 32x32 limb product into a 512-bit
// accumulator, then the shared sc_reduce512. Feeds signing's
// S = r + H(R‖A‖M)·a.
static void sc_muladd(uint8_t out[32], const uint8_t k[32],
                      const uint8_t a[32], const uint8_t r[32]) {
    uint64_t kk[8], aa[8], rr[8];
    for (int i = 0; i < 8; i++) {
        kk[i] = (uint64_t)k[4 * i] | ((uint64_t)k[4 * i + 1] << 8) |
                ((uint64_t)k[4 * i + 2] << 16) | ((uint64_t)k[4 * i + 3] << 24);
        aa[i] = (uint64_t)a[4 * i] | ((uint64_t)a[4 * i + 1] << 8) |
                ((uint64_t)a[4 * i + 2] << 16) | ((uint64_t)a[4 * i + 3] << 24);
        rr[i] = (uint64_t)r[4 * i] | ((uint64_t)r[4 * i + 1] << 8) |
                ((uint64_t)r[4 * i + 2] << 16) | ((uint64_t)r[4 * i + 3] << 24);
    }
    uint64_t prod[16] = {0};
    for (int i = 0; i < 8; i++) {
        u128 carry = 0;
        for (int j = 0; j < 8; j++) {
            u128 t = (u128)prod[i + j] + (u128)kk[i] * aa[j] + carry;
            prod[i + j] = (uint64_t)t & 0xFFFFFFFFULL;
            carry = t >> 32;
        }
        prod[i + 8] += (uint64_t)carry;  // < 2^32, cell untouched so far
    }
    u128 c = 0;
    for (int i = 0; i < 16; i++) {
        c += prod[i] + (i < 8 ? rr[i] : 0);
        prod[i] = (uint64_t)c & 0xFFFFFFFFULL;
        c >>= 32;
    }
    uint8_t bytes[64];
    for (int i = 0; i < 16; i++) {
        bytes[4 * i] = (uint8_t)prod[i];
        bytes[4 * i + 1] = (uint8_t)(prod[i] >> 8);
        bytes[4 * i + 2] = (uint8_t)(prod[i] >> 16);
        bytes[4 * i + 3] = (uint8_t)(prod[i] >> 24);
    }
    sc_reduce512(out, bytes);
}

// ------------------------------------------------- double scalar mult ----
// r = [s]B + [k]A — Strauss-Shamir with signed sliding-window NAF:
// width-8 over the fixed base B (static odd-multiple table built once)
// and width-5 over the per-signature A (vartime is fine: verification
// handles public data only)
static ge BASE_POINT;
static gecached B_TABLE[64];   // 1B, 3B, 5B, ..., 127B

// signed sliding-window recode: digits are odd, |digit| < 2^(w-1)+1,
// at most one nonzero digit per w consecutive positions.
// PRECONDITION: a < 2^253 (carry ripple past bit 255 would be dropped);
// verify gates both scalars through sc_is_canonical / sc_reduce512 so
// they are < L < 2^253.
static void slide(int8_t r[256], const uint8_t a[32], int w) {
    int limit = 1 << (w - 1);
    for (int i = 0; i < 256; i++)
        r[i] = 1 & (a[i >> 3] >> (i & 7));
    for (int i = 0; i < 256; i++) {
        if (!r[i])
            continue;
        for (int b = 1; b < w && i + b < 256; b++) {
            if (!r[i + b])
                continue;
            if (r[i] + (r[i + b] << b) <= limit) {
                r[i] = (int8_t)(r[i] + (r[i + b] << b));
                r[i + b] = 0;
            } else if (r[i] - (r[i + b] << b) >= -limit) {
                r[i] = (int8_t)(r[i] - (r[i + b] << b));
                for (int kk = i + b; kk < 256; kk++) {
                    if (!r[kk]) {
                        r[kk] = 1;
                        break;
                    }
                    r[kk] = 0;
                }
            } else {
                break;
            }
        }
    }
}

static void ge_double_scalarmult(ge& r, const uint8_t s[32], const uint8_t k[32],
                                 const ge& A) {
    int8_t naf_s[256], naf_k[256];
    slide(naf_s, s, 8);
    slide(naf_k, k, 5);
    // odd multiples of A: 1A, 3A, ..., 15A
    gecached tabA[8];
    {
        ge A2, cur;
        ge_double(A2, A);
        gecached a2c;
        ge_to_cached(a2c, A2);
        cur = A;
        ge_to_cached(tabA[0], cur);
        for (int i = 1; i < 8; i++) {
            ge_add_cached(cur, cur, a2c);
            ge_to_cached(tabA[i], cur);
        }
    }
    int i = 255;
    while (i >= 0 && !naf_s[i] && !naf_k[i]) i--;
    ge_identity(r);
    for (; i >= 0; i--) {
        ge_double(r, r);
        int ds = naf_s[i], dk = naf_k[i];
        if (ds > 0)
            ge_add_cached(r, r, B_TABLE[ds >> 1]);
        else if (ds < 0)
            ge_sub_cached(r, r, B_TABLE[(-ds) >> 1]);
        if (dk > 0)
            ge_add_cached(r, r, tabA[dk >> 1]);
        else if (dk < 0)
            ge_sub_cached(r, r, tabA[(-dk) >> 1]);
    }
}

// single scalar mult (for key derivation)
static void ge_scalarmult(ge& r, const uint8_t s[32], const ge& P) {
    ge tab[16];
    ge_identity(tab[0]);
    tab[1] = P;
    for (int i = 2; i < 16; i++) ge_add(tab[i], tab[i - 1], P);
    ge_identity(r);
    for (int i = 63; i >= 0; i--) {
        ge_double(r, r);
        ge_double(r, r);
        ge_double(r, r);
        ge_double(r, r);
        int byte = i / 2;
        int nib = (i & 1) ? (s[byte] >> 4) : (s[byte] & 0x0F);
        if (nib) ge_add(r, r, tab[nib]);
    }
}

static void init_constants() {
    // d = -121665/121666 mod p; sqrt(-1) = 2^((p-1)/4)
    fe t121665, t121666;
    fe_0(t121665); t121665[0] = 121665;
    fe_0(t121666); t121666[0] = 121666;
    fe zero;
    fe_0(zero);
    fe neg;
    fe_sub(neg, zero, t121665);
    fe inv;
    fe_invert(inv, t121666);
    fe_mul(FE_D, neg, inv);
    fe_add(FE_2D, FE_D, FE_D);
    // sqrt(-1): 2^((p-1)/4). compute via pow2523 identities:
    // 2^((p-1)/4) = 2 * (2^((p-5)/8))  since (p-1)/4 = (p-5)/8 * 2 + 1
    fe two;
    fe_0(two); two[0] = 2;
    fe e;
    fe_pow2523(e, two);    // 2^((p-5)/8)
    fe_sq(e, e);           // 2^((p-5)/4)
    fe_mul(FE_SQRTM1, e, two);  // 2^((p-5)/4 + 1) = 2^((p-1)/4)
    // base point: y = 4/5
    fe four, five, y;
    fe_0(four); four[0] = 4;
    fe_0(five); five[0] = 5;
    fe_invert(inv, five);
    fe_mul(y, four, inv);
    uint8_t yb[32];
    fe_tobytes(yb, y);
    // x is "positive" (even) for the standard base point => sign bit 0
    ge_frombytes_strict(BASE_POINT, yb);
    // static width-8 NAF table: odd multiples 1B..127B
    {
        ge B2, cur;
        ge_double(B2, BASE_POINT);
        gecached b2c;
        ge_to_cached(b2c, B2);
        cur = BASE_POINT;
        ge_to_cached(B_TABLE[0], cur);
        for (int i = 1; i < 64; i++) {
            ge_add_cached(cur, cur, b2c);
            ge_to_cached(B_TABLE[i], cur);
        }
    }
}

struct Initializer {
    Initializer() { init_constants(); }
} g_init;

// ------------------------------------------------------------- verify ----
// k = SHA512(R ‖ A ‖ M) mod L. Typical messages are 32-byte tx hashes;
// serve those from the stack, heap only for oversized payloads.
static void hash_ram(uint8_t k[32], const uint8_t sig[64],
                     const uint8_t pub[32], const uint8_t* msg,
                     size_t msglen) {
    uint8_t hbuf[64];
    uint8_t stackbuf[576];
    uint8_t* tmp = (64 + msglen <= sizeof(stackbuf))
                       ? stackbuf
                       : new uint8_t[64 + msglen];
    memcpy(tmp, sig, 32);
    memcpy(tmp + 32, pub, 32);
    memcpy(tmp + 64, msg, msglen);
    sha512(tmp, 64 + msglen, hbuf);
    if (tmp != stackbuf)
        delete[] tmp;
    sc_reduce512(k, hbuf);
}

static int verify_one(const uint8_t pub[32], const uint8_t sig[64],
                      const uint8_t* msg, size_t msglen) {
    if (!sc_is_canonical(sig + 32)) return 0;
    ge A, R;
    if (!ge_frombytes_strict(A, pub)) return 0;
    if (!ge_frombytes_strict(R, sig)) return 0;
    if (ge_has_small_order(A) || ge_has_small_order(R)) return 0;
    uint8_t k[32];
    hash_ram(k, sig, pub, msg, msglen);
    // Rcheck = [S]B + [k](-A); accept iff encoding equals sig[0..31]
    ge negA, Rcheck;
    ge_neg(negA, A);
    ge_double_scalarmult(Rcheck, sig + 32, k, negA);
    uint8_t rb[32];
    ge_tobytes(rb, Rcheck);
    return memcmp(rb, sig, 32) == 0;
}

}  // namespace scnative

extern "C" {

int sc_ed25519_verify(const uint8_t pub[32], const uint8_t sig[64],
                      const uint8_t* msg, size_t msglen) {
    return scnative::verify_one(pub, sig, msg, msglen);
}

// CPU batch verify: msgs concatenated, offsets[n+1] delimiting each message.
void sc_ed25519_batch_verify(const uint8_t* pubs, const uint8_t* sigs,
                             const uint8_t* msgs, const uint64_t* offsets,
                             uint64_t n, uint8_t* results) {
    for (uint64_t i = 0; i < n; i++) {
        results[i] = (uint8_t)scnative::verify_one(
            pubs + 32 * i, sigs + 64 * i, msgs + offsets[i],
            (size_t)(offsets[i + 1] - offsets[i]));
    }
}

// Host-side prep for the TPU kernel: k scalars (reduced) + S-canonicality
// flags. Point decompression/small-order checks live in
// sc_ed25519_batch_host_precheck below; the device kernel only does the
// double-scalar-mult and R comparison.
static void batch_prepare_range(const uint8_t* pubs, const uint8_t* sigs,
                                const uint8_t* msgs,
                                const uint64_t* offsets, uint64_t lo,
                                uint64_t hi, uint8_t* k_out,
                                uint8_t* s_canonical_out) {
    for (uint64_t i = lo; i < hi; i++) {
        size_t msglen = (size_t)(offsets[i + 1] - offsets[i]);
        scnative::hash_ram(k_out + 32 * i, sigs + 64 * i, pubs + 32 * i,
                           msgs + offsets[i], msglen);
        s_canonical_out[i] =
            (uint8_t)scnative::sc_is_canonical(sigs + 64 * i + 32);
    }
}

// Per-signature SHA-512 prep is embarrassingly parallel; split across
// hardware threads so the ~47k sig/s single-core ceiling documented in
// docs/KERNEL_PROFILE.md §4 scales with the host instead of bounding the
// whole pipeline (the ctypes caller already releases the GIL). One core
// (or small batches, where thread spawn would dominate) keeps the serial
// path.
void sc_ed25519_batch_prepare(const uint8_t* pubs, const uint8_t* sigs,
                              const uint8_t* msgs, const uint64_t* offsets,
                              uint64_t n, uint8_t* k_out,
                              uint8_t* s_canonical_out) {
    unsigned hw = std::thread::hardware_concurrency();
    uint64_t want = hw ? hw : 1;
    if (want > 1 && n / want > 256) {
        uint64_t nthreads = want;
        std::vector<std::thread> pool;
        pool.reserve(nthreads - 1);
        uint64_t chunk = (n + nthreads - 1) / nthreads;
        for (uint64_t t = 1; t < nthreads; t++) {
            uint64_t lo = t * chunk;
            uint64_t hi = lo + chunk < n ? lo + chunk : n;
            if (lo >= hi) break;
            pool.emplace_back(batch_prepare_range, pubs, sigs, msgs,
                              offsets, lo, hi, k_out, s_canonical_out);
        }
        batch_prepare_range(pubs, sigs, msgs, offsets, 0,
                            chunk < n ? chunk : n, k_out, s_canonical_out);
        for (auto& th : pool) th.join();
        return;
    }
    batch_prepare_range(pubs, sigs, msgs, offsets, 0, n, k_out,
                        s_canonical_out);
}

// Host-side point prep for the TPU kernel: strict-decompress A and R, apply
// the small-order rejections, and emit affine (-A) = (x, y) as canonical
// 32-byte field elements (the kernel computes T = x*y on device). R itself is
// only validated here — the kernel compares compressed [S]B + [k](-A) against
// the raw R bytes.
void sc_ed25519_batch_host_precheck(const uint8_t* pubs, const uint8_t* sigs,
                                    uint64_t n, uint8_t* neg_a_xy,
                                    uint8_t* ok_out) {
    for (uint64_t i = 0; i < n; i++) {
        scnative::ge A, R;
        int ok = scnative::ge_frombytes_strict(A, pubs + 32 * i) &&
                 !scnative::ge_has_small_order(A) &&
                 scnative::ge_frombytes_strict(R, sigs + 64 * i) &&
                 !scnative::ge_has_small_order(R);
        uint8_t* out = neg_a_xy + 64 * i;
        if (ok) {
            scnative::ge negA;
            scnative::ge_neg(negA, A);
            // A came from ge_frombytes_strict, so Z=1: X/Y are affine
            scnative::fe_tobytes(out, negA.X);
            scnative::fe_tobytes(out + 32, negA.Y);
        } else {
            memset(out, 0, 64);
        }
        ok_out[i] = (uint8_t)ok;
    }
}

// RFC 8032 signing, byte-identical to libsodium / ed25519_ref.sign:
//   h = SHA512(seed); a = clamp(h[0:32]); prefix = h[32:64]
//   r = SHA512(prefix ‖ M) mod L;  R = [r]B
//   S = (r + SHA512(R ‖ A ‖ M)·a) mod L;  sig = R ‖ S
// `pub` is the caller's cached A (SecretKey holds it) — recomputing it
// here would double the work. VARTIME like the pure-python signer this
// replaces: fine for the harness/simulation load paths that hammer it;
// production keys should prefer the constant-time OpenSSL backend when
// the wheel is present (crypto/keys.py tries it first).
void sc_ed25519_sign(const uint8_t seed[32], const uint8_t pub[32],
                     const uint8_t* msg, size_t msglen,
                     uint8_t sig_out[64]) {
    uint8_t h[64];
    scnative::sha512(seed, 32, h);
    uint8_t a[32];
    memcpy(a, h, 32);
    a[0] &= 248;
    a[31] &= 127;
    a[31] |= 64;
    // r = SHA512(prefix ‖ M) mod L — stack buffer for the typical
    // 32-byte tx-hash message, heap for oversized payloads
    uint8_t rh[64];
    {
        uint8_t stackbuf[544];
        uint8_t* tmp = (32 + msglen <= sizeof(stackbuf))
                           ? stackbuf
                           : new uint8_t[32 + msglen];
        memcpy(tmp, h + 32, 32);
        memcpy(tmp + 32, msg, msglen);
        scnative::sha512(tmp, 32 + msglen, rh);
        if (tmp != stackbuf)
            delete[] tmp;
    }
    uint8_t r[32];
    scnative::sc_reduce512(r, rh);
    scnative::ge R;
    scnative::ge_scalarmult(R, r, scnative::BASE_POINT);
    scnative::ge_tobytes(sig_out, R);
    uint8_t k[32];
    {
        // hash_ram reads only the R half of its sig argument
        uint8_t fake_sig[64];
        memcpy(fake_sig, sig_out, 32);
        scnative::hash_ram(k, fake_sig, pub, msg, msglen);
    }
    scnative::sc_muladd(sig_out + 32, k, a, r);
}

void sc_ed25519_public_from_seed(const uint8_t seed[32], uint8_t pub[32]) {
    uint8_t h[64];
    scnative::sha512(seed, 32, h);
    h[0] &= 248;
    h[31] &= 127;
    h[31] |= 64;
    scnative::ge R;
    scnative::ge_scalarmult(R, h, scnative::BASE_POINT);
    scnative::ge_tobytes(pub, R);
}

}  // extern "C"
