// GF(2^255-19) in ten signed limbs, radix 2^25.5 (ref10 layout).
//
// Replaces the fe8 field of stellar_core_tpu/ops/fe8.py (32 int32 byte
// limbs, chosen because the TPU has no wide multiply). Hopper multiplies
// 32x32->64 in one instruction (IMAD.WIDE), so an element is ten int32
// limbs at bit offsets 0, 26, 51, 77, ... (widths 26, 25, 26, ...); a
// product is 100 such multiplies and a squaring 55 (10 squares and 45
// doubled cross products). ops/field.py is the plain version of every
// function here, step for step; tests/test_torch_field.py proves the limb
// bounds (no int64 column overflows, every stored limb fits int32) over
// the op sequences of both kernels.
#pragma once
#include <stdint.h>

struct fe {
  int32_t v[10];
};

#define FE_W(i) (((i) & 1) ? 25 : 26)

__device__ __forceinline__ fe fe_const(const int32_t* c) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ fe fe_small(int32_t x) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = i ? 0 : x;
  return r;
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] + b.v[i];
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] - b.v[i];
  return r;
}

__device__ __forceinline__ fe fe_neg(const fe& a) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = -a.v[i];
  return r;
}

__device__ __forceinline__ fe fe_select(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// Carry chain after a product: 0 -> 1 -> ... -> 9, the carry out of limb
// 9 folded into limb 0 times 19, then 0 -> 1 once more. Carries round to
// nearest, so limbs come out signed, |limb| <= 2^(w-1) (limb 1 a little
// more).
__device__ __forceinline__ fe fe_carry(int64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int w = FE_W(i);
    int64_t c = (h[i] + (1LL << (w - 1))) >> w;
    h[i + 1] += c;
    h[i] -= c * (1LL << w);
  }
  int64_t c = (h[9] + (1LL << 24)) >> 25;
  h[0] += c * 19;
  h[9] -= c * (1LL << 25);
  c = (h[0] + (1LL << 25)) >> 26;
  h[1] += c;
  h[0] -= c * (1LL << 26);
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
  return r;
}

// Columns 10..18 folded times 19 (2^255 = 19 mod p), then the carry.
__device__ __forceinline__ fe fe_fold_carry(const int64_t lo[10], const int64_t hi[9]) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 9; k++) h[k] = lo[k] + hi[k] * 19;
  h[9] = lo[9];
  return fe_carry(h);
}

// Column sums of the 100 limb products (odd x odd products doubled).
__device__ __forceinline__ fe fe_mul(const fe& f, const fe& g) {
  int32_t g2[10];
#pragma unroll
  for (int j = 0; j < 10; j++) g2[j] = (j & 1) ? 2 * g.v[j] : g.v[j];
  int64_t lo[10], hi[9];
#pragma unroll
  for (int k = 0; k < 10; k++) lo[k] = 0;
#pragma unroll
  for (int k = 0; k < 9; k++) hi[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const int64_t p = (int64_t)f.v[i] * (int64_t)((i & 1) ? g2[j] : g.v[j]);
      if (i + j < 10)
        lo[i + j] += p;
      else
        hi[i + j - 10] += p;
    }
  }
  return fe_fold_carry(lo, hi);
}

// The same column sums as fe_mul(f, f) from 55 products: f_i^2 (doubled
// for odd i) and, for i < j, (2 f_i) f_j ((2 f_i)(2 f_j) when both are
// odd). The doubled operands stay in int32 (|f_i| < 2^30).
__device__ __forceinline__ fe fe_sq(const fe& f) {
  int32_t f2[10];
#pragma unroll
  for (int j = 0; j < 10; j++) f2[j] = 2 * f.v[j];
  int64_t lo[10], hi[9];
#pragma unroll
  for (int k = 0; k < 10; k++) lo[k] = 0;
#pragma unroll
  for (int k = 0; k < 9; k++) hi[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      const int32_t a = (i == j && !(i & 1)) ? f.v[i] : f2[i];
      const int32_t b = (i != j && (i & 1) && (j & 1)) ? f2[j] : f.v[j];
      const int64_t p = (int64_t)a * (int64_t)b;
      if (i + j < 10)
        lo[i + j] += p;
      else
        hi[i + j - 10] += p;
    }
  }
  return fe_fold_carry(lo, hi);
}

__device__ __noinline__ fe fe_nsquare(fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) a = fe_sq(a);
  return a;
}

// (z^(2^250 - 1), z^11): the shared head of fe_invert and fe_pow_p58.
__device__ __noinline__ fe fe_pow22501(const fe& z, fe* z11) {
  fe t0 = fe_sq(z);              // 2
  fe t1 = fe_nsquare(t0, 2);     // 8
  t1 = fe_mul(z, t1);            // 9
  t0 = fe_mul(t0, t1);           // 11
  *z11 = t0;
  t0 = fe_sq(t0);                // 22
  t1 = fe_mul(t1, t0);           // 2^5 - 1
  t0 = fe_nsquare(t1, 5);
  t1 = fe_mul(t0, t1);           // 2^10 - 1
  t0 = fe_nsquare(t1, 10);
  fe t2 = fe_mul(t0, t1);        // 2^20 - 1
  t0 = fe_nsquare(t2, 20);
  t0 = fe_mul(t0, t2);           // 2^40 - 1
  t0 = fe_nsquare(t0, 10);
  t1 = fe_mul(t0, t1);           // 2^50 - 1
  t0 = fe_nsquare(t1, 50);
  t2 = fe_mul(t0, t1);           // 2^100 - 1
  t0 = fe_nsquare(t2, 100);
  t0 = fe_mul(t0, t2);           // 2^200 - 1
  t0 = fe_nsquare(t0, 50);
  return fe_mul(t0, t1);         // 2^250 - 1
}

// z^(p-2) = z^(2^255 - 21): the exponent of fe8.invert.
__device__ __forceinline__ fe fe_invert(const fe& z) {
  fe z11;
  fe t = fe_pow22501(z, &z11);
  return fe_mul(fe_nsquare(t, 5), z11);
}

// z^((p-5)/8) = z^(2^252 - 3).
__device__ __forceinline__ fe fe_pow_p58(const fe& z) {
  fe z11;
  fe t = fe_pow22501(z, &z11);
  return fe_mul(fe_nsquare(t, 2), z);
}

// Canonical value in [0, p) as four little-endian 64-bit words. Bias by
// 8p (all limbs >= 0), floor-carry with the top carry folded times 19
// (value < 2p), q = floor((value + 19) / 2^255), add 19q, floor-carry,
// drop bit 255. Same steps as field.canon_limbs.
__device__ __forceinline__ void fe_towords(uint64_t w[4], const fe& f) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++)
    h[i] = (int64_t)f.v[i] + 8LL * ((1LL << FE_W(i)) - (i == 0 ? 19 : 1));
#pragma unroll
  for (int i = 0; i < 9; i++) {
    int64_t c = h[i] >> FE_W(i);
    h[i + 1] += c;
    h[i] -= c * (1LL << FE_W(i));
  }
  int64_t c = h[9] >> 25;
  h[9] -= c * (1LL << 25);
  h[0] += c * 19;
  int64_t q = (h[0] + 19) >> 26;
#pragma unroll
  for (int i = 1; i < 10; i++) q = (h[i] + q) >> FE_W(i);
  h[0] += q * 19;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    c = h[i] >> FE_W(i);
    h[i + 1] += c;
    h[i] -= c * (1LL << FE_W(i));
  }
  h[9] -= (h[9] >> 25) * (1LL << 25);
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int i = 0; i < 4; i++) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const uint64_t v = (uint64_t)h[i];
    const int wi = off[i] >> 6, sh = off[i] & 63;
    w[wi] |= v << sh;
    if (sh + FE_W(i) > 64) w[wi + 1] |= v >> (64 - sh);
  }
}

// The low 255 bits of four little-endian words (bit 255 is ignored).
__device__ __forceinline__ fe fe_fromwords(const uint64_t w[4]) {
  const int off[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int wi = off[i] >> 6, sh = off[i] & 63;
    uint64_t v = w[wi] >> sh;
    if (sh + FE_W(i) > 64) v |= w[wi + 1] << (64 - sh);
    r.v[i] = (int32_t)(v & ((1ULL << FE_W(i)) - 1));
  }
  return r;
}

__device__ __forceinline__ bool words_is_zero(const uint64_t w[4]) {
  return (w[0] | w[1] | w[2] | w[3]) == 0;
}

// Little-endian 256-bit a < c.
__device__ __forceinline__ bool words_lt(const uint64_t a[4], const uint64_t* c) {
  bool lt = false, eq = true;
#pragma unroll
  for (int i = 3; i >= 0; i--) {
    lt = lt || (eq && a[i] < c[i]);
    eq = eq && a[i] == c[i];
  }
  return lt;
}

__device__ __forceinline__ bool words_eq(const uint64_t a[4], const uint64_t* c) {
  return ((a[0] ^ c[0]) | (a[1] ^ c[1]) | (a[2] ^ c[2]) | (a[3] ^ c[3])) == 0;
}
