// Curve formulas for the CUDA kernels, on short-Weierstrass curves with
// a = 0 (every supported curve): the device-side counterpart of the curve
// formulas of the JAX package (ops/pallas_ff.py: k_ec_double, k_ec_add,
// k_ec_add_fast, k_ec_add_mixed, k_ec_madd_fast).  Each
// follows the same formula and the same select order, so the Jacobian
// representative is the same limb for limb.
//
// Identity is Z == 0 (Jacobian) / ZZ == 0 (XYZZ); the affine identity is
// y == 0 (no point of a prime-order curve has y = 0).
#pragma once
#include "ff.cuh"

struct Jac {
  Fe x, y, z;
};

// dbl-2009-l, a = 0.  Identity-safe: Z3 = 2YZ = 0 when Z = 0.
__device__ __forceinline__ Jac ec_double(const Jac& p, const FieldParams& P) {
  Fe A = fe_sqr(p.x, P);
  Fe B = fe_sqr(p.y, P);
  Fe C = fe_sqr(B, P);
  Fe t = fe_sqr(fe_add(p.x, B, P), P);
  Fe D = fe_double(fe_sub(fe_sub(t, A, P), C, P), P);
  Fe E = fe_add(fe_double(A, P), A, P);
  Fe F = fe_sqr(E, P);
  Jac r;
  r.x = fe_sub(F, fe_double(D, P), P);
  r.y = fe_sub(fe_mul(E, fe_sub(D, r.x, P), P),
               fe_double(fe_double(fe_double(C, P), P), P), P);
  r.z = fe_double(fe_mul(p.y, p.z, P), P);
  return r;
}

// The generic add-2007-bl body shared by the complete and the fast add.
struct AddCore {
  Jac sum;
  bool h0, r0;
};

__device__ __forceinline__ AddCore ec_add_core(const Jac& p, const Jac& q,
                                               const FieldParams& P) {
  Fe z1z1 = fe_sqr(p.z, P);
  Fe z2z2 = fe_sqr(q.z, P);
  Fe u1 = fe_mul(p.x, z2z2, P);
  Fe u2 = fe_mul(q.x, z1z1, P);
  Fe s1 = fe_mul(p.y, fe_mul(q.z, z2z2, P), P);
  Fe s2 = fe_mul(q.y, fe_mul(p.z, z1z1, P), P);
  Fe h = fe_sub(u2, u1, P);
  Fe r = fe_sub(s2, s1, P);
  Fe hh = fe_sqr(h, P);
  Fe hhh = fe_mul(h, hh, P);
  Fe v = fe_mul(u1, hh, P);
  AddCore o;
  o.sum.x = fe_sub(fe_sub(fe_sqr(r, P), hhh, P), fe_double(v, P), P);
  o.sum.y = fe_sub(fe_mul(r, fe_sub(v, o.sum.x, P), P), fe_mul(s1, hhh, P), P);
  o.sum.z = fe_mul(fe_mul(p.z, q.z, P), h, P);
  o.h0 = fe_is_zero(h);
  o.r0 = fe_is_zero(r);
  return o;
}

__device__ __forceinline__ Jac jac_select(bool m, const Jac& a, const Jac& b) {
  Jac r;
  r.x = fe_select(m, a.x, b.x);
  r.y = fe_select(m, a.y, b.y);
  r.z = fe_select(m, a.z, b.z);
  return r;
}

// The generic madd-2007-bl body (Z2 = 1) shared by the complete and the fast
// mixed add: 3 squarings and 8 products.
struct MaddCore {
  Jac sum;
  bool h0, r0;
};

__device__ __forceinline__ MaddCore ec_madd_core(const Jac& p, const Fe& qx, const Fe& qy,
                                                 const FieldParams& P) {
  Fe z1z1 = fe_sqr(p.z, P);
  Fe u2 = fe_mul(qx, z1z1, P);
  Fe s2 = fe_mul(qy, fe_mul(p.z, z1z1, P), P);
  Fe h = fe_sub(u2, p.x, P);
  Fe r = fe_sub(s2, p.y, P);
  Fe hh = fe_sqr(h, P);
  Fe hhh = fe_mul(h, hh, P);
  Fe v = fe_mul(p.x, hh, P);
  MaddCore o;
  o.sum.x = fe_sub(fe_sub(fe_sqr(r, P), hhh, P), fe_double(v, P), P);
  o.sum.y = fe_sub(fe_mul(r, fe_sub(v, o.sum.x, P), P), fe_mul(p.y, hhh, P), P);
  o.sum.z = fe_mul(p.z, h, P);
  o.h0 = fe_is_zero(h);
  o.r0 = fe_is_zero(r);
  return o;
}

// Complete Jacobian + affine add: the generic sum (11 products) and the
// doubling of p (7), then the selects in the order of the JAX package's
// k_ec_add_mixed (doubling, inverse, q identity, p identity, both).  q_ident
// marks the affine identity; with p the identity the result is (qx, qy, 1).
__device__ __forceinline__ Jac ec_add_mixed_complete(const Jac& p, const Fe& qx,
                                                     const Fe& qy, bool q_ident,
                                                     const FieldParams& P) {
  MaddCore c = ec_madd_core(p, qx, qy, P);
  bool id1 = fe_is_zero(p.z);
  Jac dbl = ec_double(p, P);
  Jac ident;
  ident.x = fe_one(P);
  ident.y = fe_one(P);
  ident.z = fe_zero();
  Jac q;
  q.x = qx;
  q.y = qy;
  q.z = fe_one(P);
  Jac o = c.sum;
  o = jac_select(c.h0 && c.r0, dbl, o);
  o = jac_select(c.h0 && !c.r0, ident, o);
  o = jac_select(q_ident && !id1, p, o);
  o = jac_select(id1 && !q_ident, q, o);
  o = jac_select(id1 && q_ident, ident, o);
  return o;
}

// Jacobian + affine add with no exceptional path (the JAX package's
// k_ec_madd_fast): the generic sum alone.  The affine identity (qy == 0)
// passes p through unflagged; an identity p or p == +-Q (h == 0) sets *exc,
// and such a lane keeps the generic formula's values, as the reference's
// does.
__device__ __forceinline__ Jac ec_add_mixed_fast(const Jac& p, const Fe& qx, const Fe& qy,
                                                 const FieldParams& P, bool* exc) {
  MaddCore c = ec_madd_core(p, qx, qy, P);
  bool id1 = fe_is_zero(p.z);
  bool id2 = fe_is_zero(qy);
  *exc = !id2 && (id1 || c.h0);
  return jac_select(id2, p, c.sum);
}

// Generic Jacobian add with no doubling path.  Identity operands pass through
// exactly; P + (-P) gives z3 = 0, a valid identity; only a true doubling
// (h == 0, r == 0, both operands non-identity) sets *exc.
__device__ __forceinline__ Jac ec_add_fast(const Jac& p, const Jac& q,
                                           const FieldParams& P, bool* exc) {
  AddCore c = ec_add_core(p, q, P);
  bool id1 = fe_is_zero(p.z);
  bool id2 = fe_is_zero(q.z);
  *exc = !id1 && !id2 && c.h0 && c.r0;
  return jac_select(id2, p, jac_select(id1, q, c.sum));
}
