// One-block SHA-512 of the 96-byte message R‖A‖M on native uint64 words.
//
// Replaces stellar_core_tpu/ops/sha512.py::sha512_96, which split every
// word into (hi, lo) uint32 halves because the TPU has no 64-bit lanes.
// The plain version (ops/sha512.py) keeps that split, since PyTorch has
// no uint64 shift on the CPU; the words it computes are the same.
#pragma once
#include <stdint.h>

__constant__ uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

// Byte swap: a little-endian row word <-> the big-endian word SHA-512
// reads from the same eight bytes.
__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  return ((uint64_t)__byte_perm(lo, 0, 0x0123) << 32) | __byte_perm(hi, 0, 0x0123);
}

// SHA-512 of r(32) ‖ a(32) ‖ m(32): one block, constant padding. Inputs
// are rows as little-endian words; the digest comes back the same way
// (word i holds digest bytes 8i .. 8i+7, little-endian), as sc_reduce
// reads it.
__device__ __forceinline__ void sha512_96(uint64_t digest[8], const uint64_t r[4],
                                          const uint64_t a[4], const uint64_t m[4]) {
  uint64_t w[16];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    w[i] = bswap64(r[i]);
    w[4 + i] = bswap64(a[i]);
    w[8 + i] = bswap64(m[i]);
  }
  w[12] = 0x8000000000000000ULL;  // byte 96 = 0x80
  w[13] = 0;
  w[14] = 0;
  w[15] = 96 * 8;                 // message length in bits
  const uint64_t iv[8] = {
      0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
      0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
      0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  uint64_t a_ = iv[0], b_ = iv[1], c_ = iv[2], d_ = iv[3];
  uint64_t e_ = iv[4], f_ = iv[5], g_ = iv[6], h_ = iv[7];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {
      const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint64_t ch = (e_ & f_) ^ (~e_ & g_);
    const uint64_t maj = (a_ & b_) ^ (a_ & c_) ^ (b_ & c_);
    const uint64_t big1 = rotr64(e_, 14) ^ rotr64(e_, 18) ^ rotr64(e_, 41);
    const uint64_t big0 = rotr64(a_, 28) ^ rotr64(a_, 34) ^ rotr64(a_, 39);
    const uint64_t t1 = h_ + big1 + ch + SHA512_K[t] + w[t & 15];
    const uint64_t t2 = big0 + maj;
    h_ = g_;
    g_ = f_;
    f_ = e_;
    e_ = d_ + t1;
    d_ = c_;
    c_ = b_;
    b_ = a_;
    a_ = t1 + t2;
  }
  const uint64_t out[8] = {a_ + iv[0], b_ + iv[1], c_ + iv[2], d_ + iv[3],
                           e_ + iv[4], f_ + iv[5], g_ + iv[6], h_ + iv[7]};
#pragma unroll
  for (int i = 0; i < 8; i++) digest[i] = bswap64(out[i]);
}
