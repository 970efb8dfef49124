// Exact reduction of a 512-bit little-endian value mod L (ref10 sc_reduce).
//
// Replaces stellar_core_tpu/ops/sha512.py::mod_l (a byte-limb table fold
// in int32 plus four conditional subtractions). Here: 24 signed 21-bit
// limbs in int64; the limbs above 2^252 fold down with
// 2^252 = -(L - 2^252) mod L, written as six signed 21-bit digits. The
// result is canonical (< L). ops/sha512.py::mod_l is the plain version,
// step for step.
#pragma once
#include <stdint.h>

__device__ __forceinline__ void sc_fold(int64_t s[24], int i) {
  s[i - 12] += s[i] * 666643;
  s[i - 11] += s[i] * 470296;
  s[i - 10] += s[i] * 654183;
  s[i - 9] -= s[i] * 997805;
  s[i - 8] += s[i] * 136657;
  s[i - 7] -= s[i] * 683901;
  s[i] = 0;
}

__device__ __forceinline__ void sc_carry_round(int64_t s[24], int i) {
  const int64_t c = (s[i] + (1LL << 20)) >> 21;
  s[i + 1] += c;
  s[i] -= c * (1LL << 21);
}

__device__ __forceinline__ void sc_carry_floor(int64_t s[24], int i) {
  const int64_t c = s[i] >> 21;
  s[i + 1] += c;
  s[i] -= c * (1LL << 21);
}

// bits off .. off+w of a 512-bit little-endian value in words (w <= 29)
__device__ __forceinline__ int64_t sc_bits(const uint64_t d[8], int off, int w) {
  const int wi = off >> 6, sh = off & 63;
  uint64_t t = d[wi] >> sh;
  if (sh + w > 64) t |= d[wi + 1] << (64 - sh);
  return (int64_t)(t & ((1ULL << w) - 1));
}

// d (eight little-endian words) mod L -> four little-endian words.
__device__ __forceinline__ void sc_reduce(uint64_t out[4], const uint64_t d[8]) {
  int64_t s[24];
#pragma unroll
  for (int i = 0; i < 23; i++) s[i] = sc_bits(d, 21 * i, 21);
  s[23] = sc_bits(d, 483, 29);
#pragma unroll
  for (int i = 23; i > 17; i--) sc_fold(s, i);
#pragma unroll
  for (int i = 6; i < 17; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 7; i < 16; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 17; i > 11; i--) sc_fold(s, i);
#pragma unroll
  for (int i = 0; i < 11; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 1; i < 12; i += 2) sc_carry_round(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i < 12; i++) sc_carry_floor(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i < 11; i++) sc_carry_floor(s, i);
  // pack twelve 21-bit limbs (the last below 2^22) into 256 bits
#pragma unroll
  for (int i = 0; i < 4; i++) out[i] = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    const uint64_t v = (uint64_t)s[i];
    const int off = 21 * i, wi = off >> 6, sh = off & 63;
    out[wi] |= v << sh;
    if (sh + 25 > 64 && wi < 3) out[wi + 1] |= v >> (64 - sh);
  }
}
