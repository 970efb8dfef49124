// SHA-512 (FIPS 180-4) — native hashing for the batch-verify bridge.
// Round constants are generated at build time by loader.py (cube-root
// fractional parts of the first 80 primes) into sha512_consts.h.
//
// Reference parity: the reference uses libsodium's SHA-512 inside Ed25519
// (crypto/SecretKey.cpp); this is our independent implementation.

#include <cstdint>
#include <cstring>
#include <cstddef>

#include "sha512_consts.h"  // generated: SHA512_K[80], SHA512_H0[8]

namespace scnative {

static inline uint64_t rotr(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

struct Sha512Ctx {
    uint64_t h[8];
    uint8_t buf[128];
    uint64_t bytelen;
    size_t buflen;
};

void sha512_init(Sha512Ctx* c) {
    memcpy(c->h, SHA512_H0, sizeof(c->h));
    c->bytelen = 0;
    c->buflen = 0;
}

static void sha512_block(Sha512Ctx* c, const uint8_t* p) {
    uint64_t w[80];
    for (int i = 0; i < 16; i++) {
        w[i] = ((uint64_t)p[i * 8] << 56) | ((uint64_t)p[i * 8 + 1] << 48) |
               ((uint64_t)p[i * 8 + 2] << 40) | ((uint64_t)p[i * 8 + 3] << 32) |
               ((uint64_t)p[i * 8 + 4] << 24) | ((uint64_t)p[i * 8 + 5] << 16) |
               ((uint64_t)p[i * 8 + 6] << 8) | (uint64_t)p[i * 8 + 7];
    }
    for (int i = 16; i < 80; i++) {
        uint64_t s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
        uint64_t s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = c->h[0], b = c->h[1], cc = c->h[2], d = c->h[3];
    uint64_t e = c->h[4], f = c->h[5], g = c->h[6], h = c->h[7];
    for (int i = 0; i < 80; i++) {
        uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = h + S1 + ch + SHA512_K[i] + w[i];
        uint64_t S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
        uint64_t maj = (a & b) ^ (a & cc) ^ (b & cc);
        uint64_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
    c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

void sha512_update(Sha512Ctx* c, const uint8_t* data, size_t len) {
    c->bytelen += len;
    if (c->buflen) {
        size_t need = 128 - c->buflen;
        size_t take = len < need ? len : need;
        memcpy(c->buf + c->buflen, data, take);
        c->buflen += take;
        data += take;
        len -= take;
        if (c->buflen == 128) {
            sha512_block(c, c->buf);
            c->buflen = 0;
        }
    }
    while (len >= 128) {
        sha512_block(c, data);
        data += 128;
        len -= 128;
    }
    if (len) {
        memcpy(c->buf, data, len);
        c->buflen = len;
    }
}

void sha512_final(Sha512Ctx* c, uint8_t out[64]) {
    uint64_t bitlen = c->bytelen * 8;
    uint8_t pad = 0x80;
    sha512_update(c, &pad, 1);
    uint8_t z = 0;
    while (c->buflen != 112) {
        sha512_update(c, &z, 1);
    }
    uint8_t lenbuf[16] = {0};
    for (int i = 0; i < 8; i++) lenbuf[15 - i] = (uint8_t)(bitlen >> (8 * i));
    sha512_update(c, lenbuf, 16);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            out[i * 8 + j] = (uint8_t)(c->h[i] >> (56 - 8 * j));
}

void sha512(const uint8_t* data, size_t len, uint8_t out[64]) {
    Sha512Ctx c;
    sha512_init(&c);
    sha512_update(&c, data, len);
    sha512_final(&c, out);
}

}  // namespace scnative

extern "C" {
void sc_sha512(const uint8_t* data, size_t len, uint8_t out[64]) {
    scnative::sha512(data, len, out);
}
}
