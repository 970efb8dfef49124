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

// The prep kernel's products, one element on kPrepLanes consecutive lanes
// (a group), every lane holding all ten limbs. A product is cut by its
// folded output columns, h[c] = lo[c] + 19 hi[c] of fe_fold_carry: lane r
// of the group sums the columns c = r + kPrepLanes t (ops/field.py
// PREP_LANE_COLUMNS), each from its ten products, the lanes exchange the
// ten int64 columns by __shfl_sync, and every lane runs fe_carry on them.
// The columns are the integers fe_mul sums and the carry is fe_carry, so
// every lane returns the limbs fe_mul returns; fe_sq_lanes sums fe_sq's
// columns from the 55 products of a squaring, and returns fe_sq's limbs.
//
// Every lane runs the same instructions. Column c = r + kPrepLanes t sums
// f_i g_((c - i) mod 10), so lane r reads g rotated by r: with
// gr[k] = g[(k + r) mod 10], the operand of f_i is gr[(kPrepLanes t - i)
// mod 10] on every lane. The weights go onto the operands: f_i doubled
// for odd i in an even column (odd x odd), and g times 19 where the
// product wraps past limb 9 (g_j with j > c): for k = (kPrepLanes t - i)
// mod 10 that is k > kPrepLanes t and k + r < 10, the second test only
// for k >= 11 - kPrepLanes, where it depends on the lane (lanes::m). The
// prep's operands stay below 2^26 in magnitude, so 19 g and 4 f fit int32
// (tests/test_torch_field.py walks the chain with intervals).
//
// What bounds it: a lane still runs about as many instructions per
// squaring as one thread's fe_sq (30 products, 20 shuffles, 10 selects,
// 33 scalings and the whole carry, against 55 products, the fold and the
// carry), so the split buys latency where a warp waits on its chain
// (small n) and costs instruction throughput where the card is full. Two
// lanes measured faster than four at 16384 and 64000 (PERF.md), since
// each added lane repeats the carry and the shuffles, and only two split
// a squaring's pairs with the same instructions on each lane.
constexpr int kPrepLanes = 2;
constexpr int kLaneSlots = (10 + kPrepLanes - 1) / kPrepLanes;  // columns per lane
constexpr int kLaneWrap = 11 - kPrepLanes;  // first k whose wrap depends on the lane

struct lanes {
  int base, r;                    // the group's first lane, the lane's place in it
  int32_t dbl;                    // 2 on lanes of even columns, else 1
  int32_t m[10 - kLaneWrap];      // m[k - kLaneWrap]: 19 if k + r < 10, else 1
  int32_t a, b;                   // fe_sq_lanes' pair weights: 1 + r, 2 - 2r
};

__device__ __forceinline__ lanes lanes_of(int tid) {
  lanes q;
  q.r = tid % kPrepLanes;
  q.base = (tid & 31) - q.r;
  q.dbl = 2 - (q.r & 1);
  q.a = 1 + q.r;
  q.b = 2 - 2 * q.r;
#pragma unroll
  for (int k = kLaneWrap; k < 10; k++) q.m[k - kLaneWrap] = k + q.r < 10 ? 19 : 1;
  return q;
}

// g[(k + r) mod 10] at k, by selects over the bits of r.
__device__ __forceinline__ fe fe_rotate(const fe& g, int r) {
  fe out = g;
#pragma unroll
  for (int b = 1; b < kPrepLanes; b <<= 1) {
    fe s;
#pragma unroll
    for (int k = 0; k < 10; k++) s.v[k] = out.v[(k + b) % 10];
    out = fe_select((r & b) != 0, s, out);
  }
  return out;
}

// The lanes' folded columns exchanged (column c from lane c % kPrepLanes,
// slot c / kPrepLanes) and carried on every lane.
__device__ __forceinline__ fe fe_lanes_carry(const int64_t acc[kLaneSlots], const lanes& q) {
  int64_t h[10];
#pragma unroll
  for (int c = 0; c < 10; c++) {
    const int64_t v = acc[c / kPrepLanes];
    const int src = q.base + c % kPrepLanes;
    const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)v, src);
    const uint32_t hi = __shfl_sync(0xffffffffu, (uint32_t)((uint64_t)v >> 32), src);
    h[c] = (int64_t)(((uint64_t)hi << 32) | lo);
  }
  return fe_carry(h);
}

__device__ __forceinline__ fe fe_mul_lanes(const fe& f, const fe& g, const lanes& q) {
  const fe gr = fe_rotate(g, q.r);
  int32_t gw[10], fd[10];
#pragma unroll
  for (int k = 0; k < 10; k++) gw[k] = gr.v[k] * (k >= kLaneWrap ? q.m[k - kLaneWrap] : 19);
#pragma unroll
  for (int i = 0; i < 10; i++) fd[i] = (i & 1) ? f.v[i] * q.dbl : f.v[i];
  int64_t acc[kLaneSlots];
#pragma unroll
  for (int t = 0; t < kLaneSlots; t++) {
    const int c = kPrepLanes * t;  // the lane's column, less r
    acc[t] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      const int k = ((c - i) % 10 + 10) % 10;
      acc[t] += (int64_t)fd[i] * (int64_t)(k > c ? gw[k] : gr.v[k]);
    }
  }
  return fe_lanes_carry(acc, q);
}

// f^2 from its 55 products (two lanes): column c = r + 2t takes six
// products f_i gr[k], i = t + d and k = (t - d) mod 10 for d = 0, 5, 6,
// 7, 8, 9 (ops/field.py SQ_OFFSETS). On the even lane (c = 2t) these are
// the diagonal products at t and t + 5 and one product of each of the
// four other pairs; on the odd lane, one of each of its five pairs, the
// pair (t + 5, t + 6) met twice: the term at t + 6 is weighted 0. The
// pair weight (2 off the diagonal) and the odd x odd doubling go onto f:
// A (d = 0, 5) = f times 1 or 2 on the even lane, 2f on the odd; B (d = 6)
// = 2 or 4 f on the even lane, 0 on the odd; C = 2f, doubled again for
// odd i on the even lane. g takes the wraps as in fe_mul_lanes.
__device__ __forceinline__ fe fe_sq_lanes(const fe& f, const lanes& q) {
  static_assert(kPrepLanes == 2, "fe_sq_lanes pairs the columns of two lanes");
  const fe gr = fe_rotate(f, q.r);
  int32_t gw[10], f2[10];
#pragma unroll
  for (int k = 0; k < 10; k++) gw[k] = gr.v[k] * (k >= kLaneWrap ? q.m[k - kLaneWrap] : 19);
#pragma unroll
  for (int i = 0; i < 10; i++) f2[i] = 2 * f.v[i];
  int64_t acc[kLaneSlots];
#pragma unroll
  for (int t = 0; t < kLaneSlots; t++) {
    acc[t] = 0;
#pragma unroll
    for (int j = 0; j < 6; j++) {
      const int d = j ? j + 4 : 0;
      const int i = (t + d) % 10, k = (t - d + 10) % 10;
      const int32_t a = j < 2 ? ((i & 1) ? f2[i] : f.v[i] * q.a)
                              : j == 2 ? ((i & 1) ? f2[i] : f.v[i]) * q.b
                                       : ((i & 1) ? f2[i] * q.dbl : f2[i]);
      acc[t] += (int64_t)a * (int64_t)(k > 2 * t ? gw[k] : gr.v[k]);
    }
  }
  return fe_lanes_carry(acc, q);
}

__device__ __noinline__ fe fe_nsquare_lanes(fe a, int n, lanes q) {
#pragma unroll 1
  for (int i = 0; i < n; i++) a = fe_sq_lanes(a, q);
  return a;
}

// z^((p-5)/8) = z^(2^252 - 3): the products of fe_pow_p58 (fe_pow22501's
// chain, two squarings, z), each on the group's lanes.
__device__ __noinline__ fe fe_pow_p58_lanes(const fe& z, lanes q) {
  fe t0 = fe_sq_lanes(z, q);           // 2
  fe t1 = fe_nsquare_lanes(t0, 2, q);  // 8
  t1 = fe_mul_lanes(z, t1, q);         // 9
  t0 = fe_mul_lanes(t0, t1, q);        // 11
  t0 = fe_sq_lanes(t0, q);             // 22
  t1 = fe_mul_lanes(t1, t0, q);        // 2^5 - 1
  t0 = fe_nsquare_lanes(t1, 5, q);
  t1 = fe_mul_lanes(t0, t1, q);        // 2^10 - 1
  t0 = fe_nsquare_lanes(t1, 10, q);
  fe t2 = fe_mul_lanes(t0, t1, q);     // 2^20 - 1
  t0 = fe_nsquare_lanes(t2, 20, q);
  t0 = fe_mul_lanes(t0, t2, q);        // 2^40 - 1
  t0 = fe_nsquare_lanes(t0, 10, q);
  t1 = fe_mul_lanes(t0, t1, q);        // 2^50 - 1
  t0 = fe_nsquare_lanes(t1, 50, q);
  t2 = fe_mul_lanes(t0, t1, q);        // 2^100 - 1
  t0 = fe_nsquare_lanes(t2, 100, q);
  t0 = fe_mul_lanes(t0, t2, q);        // 2^200 - 1
  t0 = fe_nsquare_lanes(t0, 50, q);
  t0 = fe_mul_lanes(t0, t1, q);        // 2^250 - 1
  return fe_mul_lanes(fe_nsquare_lanes(t0, 2, q), z, q);
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
