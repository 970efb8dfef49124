// Extended twisted-Edwards points (X, Y, Z, T) and the cached form
// (Y+X, Y-X, 2Z, 2dT). The formulas are those of
// stellar_core_tpu/ops/ed25519_kernel.py (ge_dbl_w, to_cached,
// ge_add_cached) and are complete on edwards25519, so the ladder has no
// data-dependent branch. ops/ladder.py holds the plain version of each.
#pragma once
#include "field.cuh"

struct ge {
  fe x, y, z, t;
};

struct ge_cached {
  fe yx, ym, z2, t2d;
};

// dbl-2008-hwcd with a = -1, all outputs scaled by -1: 4 squarings + 4
// products.
__device__ __forceinline__ ge ge_dbl(const ge& p) {
  const fe a = fe_sq(p.x);
  const fe b = fe_sq(p.y);
  const fe zz = fe_sq(p.z);
  const fe e0 = fe_sq(fe_add(p.x, p.y));
  const fe c = fe_add(zz, zz);
  const fe s1 = fe_add(a, b);
  const fe e = fe_sub(e0, s1);
  const fe g = fe_sub(b, a);
  const fe f = fe_sub(c, g);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, s1);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, s1);
  return r;
}

__device__ __forceinline__ ge_cached ge_to_cached(const ge& q, const fe& d2) {
  ge_cached c;
  c.yx = fe_add(q.y, q.x);
  c.ym = fe_sub(q.y, q.x);
  c.z2 = fe_add(q.z, q.z);
  c.t2d = fe_mul(q.t, d2);
  return c;
}

// add-2008-hwcd-3 with a cached operand: 8 products.
__device__ __forceinline__ ge ge_add_cached(const ge& p, const ge_cached& q) {
  const fe a = fe_mul(fe_sub(p.y, p.x), q.ym);
  const fe b = fe_mul(fe_add(p.y, p.x), q.yx);
  const fe c = fe_mul(p.t, q.t2d);
  const fe d = fe_mul(p.z, q.z2);
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(b, a);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}
