// Point arithmetic of the ladder, one point spread over a group of four
// consecutive lanes: lane r of the group holds coordinate r of the point
// as one field element. The formulas are ref10's (ge_p2_dbl, ge_madd,
// ge_add, ge_p1p1_to_p2 / _p3) on twisted Edwards coordinates, complete
// on edwards25519, so no lane branches on data:
//   p3     (X, Y, Z, T), x = X/Z, y = Y/Z, xy = T/Z
//   p1p1   (X, Y, Z, T), x = X/Z, y = Y/T
//   cached (Y+X, Y-X, 2dT, Z)   per-lane multiples of -A
//   niels  (y+x, y-x, 2dxy)     affine multiples of B
// Each operation is one round of four independent field products (one
// per lane; Hisil-Wong-Carter-Dawson 2008 give the parallel forms) and
// an exchange of operands through __shfl_sync. All 32 lanes of a warp run
// every shuffle, so callers keep the control flow uniform per warp.
// ops/ladder.py holds the plain version of each.
#pragma once
#include "field.cuh"

__device__ __forceinline__ fe fe_shfl(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = __shfl_sync(0xffffffffu, a.v[i], src);
  return r;
}

// The lane's group: its first lane and its role r in 0..3.
struct quad {
  int base, r, lane;
};

// p2 or p3 -> p1p1 (ref10 ge_p2_dbl): four squarings, one per lane:
// X^2, Y^2, Z^2, (X+Y)^2; then X3 = AA - (YY+XX), Y3 = YY+XX,
// Z3 = YY-XX, T3 = 2ZZ - Z3.
__device__ __forceinline__ fe quad_dbl(const fe& v, const quad& q) {
  const fe x = fe_shfl(v, q.base), y = fe_shfl(v, q.base + 1);
  const fe a = q.r == 0 ? x : q.r == 1 ? y : q.r == 2 ? v : fe_add(x, y);
  const fe s = fe_sq(a);
  const fe xx = fe_shfl(s, q.base), yy = fe_shfl(s, q.base + 1);
  const fe o = fe_shfl(s, q.base + (q.r == 0 ? 3 : 2));   // AA or ZZ
  const fe p = fe_add(yy, xx), m = fe_sub(yy, xx);
  if (q.r == 0) return fe_sub(o, p);
  if (q.r == 1) return p;
  if (q.r == 2) return m;
  return fe_sub(fe_add(o, o), m);
}

// p1p1 -> p3 (X T, Y Z, Z T, X Y); with_t false gives p2, and lane 3
// then runs no product (its T is stale; a doubling does not read it).
__device__ __forceinline__ fe quad_p1p1_to(const fe& c, const quad& q, bool with_t) {
  const fe a = fe_shfl(c, q.r == 3 ? q.base : q.lane);
  const fe b = fe_shfl(c, q.base + ((0x1323 >> (4 * q.r)) & 0xf));  // T, Z, T, Y
  if (q.r < 3 || with_t) return fe_mul(a, b);
  return c;
}

// The shared tail of ge_madd and ge_add: lanes 0..3 hold A, B, C, D;
// p1p1 = (A - B, A + B, D + C, D - C).
__device__ __forceinline__ fe quad_combine(const fe& m, const quad& q) {
  const fe u = fe_shfl(m, q.base + (q.r < 2 ? 0 : 3));
  const fe w = fe_shfl(m, q.base + (q.r < 2 ? 1 : 2));
  return (q.r == 1 || q.r == 2) ? fe_add(u, w) : fe_sub(u, w);
}

// First operands of an addition: Y+X, Y-X, T, Z (lanes 2 and 3 swap
// the p3 point's Z and T).
__device__ __forceinline__ fe quad_add_operand(const fe& v, const quad& q) {
  const fe s1 = fe_shfl(v, q.base + (q.r == 2 ? 3 : q.r == 3 ? 2 : 0));  // X, X, T, Z
  const fe s2 = fe_shfl(v, q.base + 1);                                 // Y
  return q.r == 0 ? fe_add(s2, s1) : q.r == 1 ? fe_sub(s2, s1) : s1;
}

// p3 + niels -> p1p1 (ref10 ge_madd): A = (Y+X)(y+x), B = (Y-X)(y-x),
// C = T 2dxy on lanes 0..2; lane 3 forms D = 2Z without a product.
// n holds this lane's coordinate of the niels operand (lane 3: unused).
__device__ __forceinline__ fe quad_madd(const fe& v, const fe& n, const quad& q) {
  const fe a = quad_add_operand(v, q);
  const fe m = q.r < 3 ? fe_mul(a, n) : fe_add(a, a);
  return quad_combine(m, q);
}

// p3 + cached -> p1p1 (ref10 ge_add): A, B, C = T 2dT2 and ZZ = Z Z2 on
// the four lanes, D = 2ZZ. c holds this lane's coordinate of the cached
// operand (Y+X, Y-X, 2dT, Z).
__device__ __forceinline__ fe quad_add(const fe& v, const fe& c, const quad& q) {
  const fe a = quad_add_operand(v, q);
  fe m = fe_mul(a, c);
  if (q.r == 3) m = fe_add(m, m);
  return quad_combine(m, q);
}

// p3 -> cached (Y+X, Y-X, 2dT, Z).
__device__ __forceinline__ fe quad_to_cached(const fe& v, const fe& d2, const quad& q) {
  const fe s1 = fe_shfl(v, q.base + (q.r == 2 ? 3 : q.r == 3 ? 2 : 0));  // X, X, T, Z
  const fe y = fe_shfl(v, q.base + 1);
  if (q.r == 2) return fe_mul(s1, d2);
  return q.r == 0 ? fe_add(y, s1) : q.r == 1 ? fe_sub(y, s1) : s1;
}
