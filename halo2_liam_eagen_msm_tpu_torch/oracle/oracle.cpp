// Bit-exact CPU oracle of the PyTorch/CUDA port (the port's own copy).
//
// An independent implementation of the field / curve / polynomial / divisor
// semantics (4x64-bit Montgomery CIOS, like the Rust reference's halo2curves
// stack), used to cross-check the port's CUDA kernels and plain versions.
// It mirrors:
//   * field ops:      the reference's `ff` crate semantics
//   * Jacobian EC:    halo2curves CurveExt group law (identity = z==0)
//   * Polynomial:     the reference's regular_functions_utils.rs:26-216
//   * divisor merge:  regular_functions_utils.rs:305-480 under the
//                     canonical affine line normalization of the port's
//                     divisor.py (lines from affine-normalized points)
//
// C ABI: all field elements cross the boundary as canonical (non-Montgomery)
// little-endian 4x64 limb arrays.  Built by oracle/__init__.py with g++.

#include <cstdint>
#include <cstring>
#include <vector>

using u64 = uint64_t;
using u128 = __uint128_t;

struct Fp {
    u64 l[4];
};

static inline bool fp_is_zero(const Fp &a) {
    return (a.l[0] | a.l[1] | a.l[2] | a.l[3]) == 0;
}
static inline bool fp_eq(const Fp &a, const Fp &b) {
    return a.l[0] == b.l[0] && a.l[1] == b.l[1] && a.l[2] == b.l[2] &&
           a.l[3] == b.l[3];
}
static inline int fp_cmp(const Fp &a, const Fp &b) {
    for (int i = 3; i >= 0; --i) {
        if (a.l[i] < b.l[i]) return -1;
        if (a.l[i] > b.l[i]) return 1;
    }
    return 0;
}

struct FieldCtx {
    Fp p;
    u64 n0inv;  // -p^-1 mod 2^64
    Fp r2;      // R^2 mod p, R = 2^256
    Fp one;     // R mod p (1 in Montgomery form)
};

static Fp add_raw(const Fp &a, const Fp &b, u64 *carry_out) {
    Fp r;
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
        u128 v = (u128)a.l[i] + b.l[i] + c;
        r.l[i] = (u64)v;
        c = v >> 64;
    }
    if (carry_out) *carry_out = (u64)c;
    return r;
}

static Fp sub_raw(const Fp &a, const Fp &b, u64 *borrow_out) {
    Fp r;
    u64 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 v = (u128)a.l[i] - b.l[i] - borrow;
        r.l[i] = (u64)v;
        borrow = (v >> 64) ? 1 : 0;
    }
    if (borrow_out) *borrow_out = borrow;
    return r;
}

static Fp fp_add(const FieldCtx &c, const Fp &a, const Fp &b) {
    u64 carry;
    Fp s = add_raw(a, b, &carry);
    if (carry || fp_cmp(s, c.p) >= 0) {
        u64 borrow;
        s = sub_raw(s, c.p, &borrow);
    }
    return s;
}

static Fp fp_sub(const FieldCtx &c, const Fp &a, const Fp &b) {
    u64 borrow;
    Fp d = sub_raw(a, b, &borrow);
    if (borrow) d = add_raw(d, c.p, nullptr);
    return d;
}

static Fp fp_neg(const FieldCtx &c, const Fp &a) {
    if (fp_is_zero(a)) return a;
    u64 borrow;
    return sub_raw(c.p, a, &borrow);
}

// CIOS Montgomery multiply, 4x64
static Fp fp_mul(const FieldCtx &c, const Fp &a, const Fp &b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 v = (u128)a.l[i] * b.l[j] + t[j] + carry;
            t[j] = (u64)v;
            carry = v >> 64;
        }
        u128 v = (u128)t[4] + carry;
        t[4] = (u64)v;
        t[5] = (u64)(v >> 64);
        u64 m = t[0] * c.n0inv;
        carry = ((u128)m * c.p.l[0] + t[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 w = (u128)m * c.p.l[j] + t[j] + carry;
            t[j - 1] = (u64)w;
            carry = w >> 64;
        }
        v = (u128)t[4] + carry;
        t[3] = (u64)v;
        t[4] = t[5] + (u64)(v >> 64);
        t[5] = 0;
    }
    Fp r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || fp_cmp(r, c.p) >= 0) {
        u64 borrow;
        r = sub_raw(r, c.p, &borrow);
    }
    return r;
}

static Fp fp_pow(const FieldCtx &c, const Fp &a, const Fp &e) {
    Fp acc = c.one;
    bool started = false;
    for (int i = 3; i >= 0; --i) {
        for (int b = 63; b >= 0; --b) {
            if (started) acc = fp_mul(c, acc, acc);
            if ((e.l[i] >> b) & 1) {
                if (started)
                    acc = fp_mul(c, acc, a);
                else {
                    acc = a;
                    started = true;
                }
            }
        }
    }
    return acc;
}

static Fp fp_inv(const FieldCtx &c, const Fp &a) {
    // Fermat: a^(p-2); inv(0) = 0
    if (fp_is_zero(a)) return a;
    Fp two = {{2, 0, 0, 0}};
    u64 borrow;
    Fp e = sub_raw(c.p, two, &borrow);
    return fp_pow(c, a, e);
}

static Fp to_mont(const FieldCtx &c, const Fp &a) { return fp_mul(c, a, c.r2); }
static Fp from_mont(const FieldCtx &c, const Fp &a) {
    Fp one = {{1, 0, 0, 0}};
    return fp_mul(c, a, one);
}

// ---------------------------------------------------------------------------
// curve ops (Jacobian, values in Montgomery form)
// ---------------------------------------------------------------------------

struct CurveCtx {
    FieldCtx f;    // base field
    Fp a_mont, b_mont;
};

struct Pt {
    Fp x, y, z;  // identity iff z == 0
};

static Pt pt_identity(const CurveCtx &cv) {
    Pt r;
    r.x = cv.f.one;
    r.y = cv.f.one;
    memset(&r.z, 0, sizeof(Fp));
    return r;
}
static bool pt_is_identity(const Pt &p) { return fp_is_zero(p.z); }

static Pt ec_double(const CurveCtx &cv, const Pt &p) {
    const FieldCtx &f = cv.f;
    if (pt_is_identity(p)) return p;
    Fp A = fp_mul(f, p.x, p.x);
    Fp B = fp_mul(f, p.y, p.y);
    Fp C = fp_mul(f, B, B);
    Fp t = fp_add(f, p.x, B);
    t = fp_mul(f, t, t);
    Fp D = fp_sub(f, fp_sub(f, t, A), C);
    D = fp_add(f, D, D);
    Fp E = fp_add(f, fp_add(f, A, A), A);
    if (!fp_is_zero(cv.a_mont)) {
        Fp z2 = fp_mul(f, p.z, p.z);
        Fp z4 = fp_mul(f, z2, z2);
        E = fp_add(f, E, fp_mul(f, cv.a_mont, z4));
    }
    Fp F = fp_mul(f, E, E);
    Pt r;
    r.x = fp_sub(f, F, fp_add(f, D, D));
    Fp c8 = fp_add(f, C, C);
    c8 = fp_add(f, c8, c8);
    c8 = fp_add(f, c8, c8);
    r.y = fp_sub(f, fp_mul(f, E, fp_sub(f, D, r.x)), c8);
    r.z = fp_mul(f, p.y, p.z);
    r.z = fp_add(f, r.z, r.z);
    return r;
}

static Pt ec_add(const CurveCtx &cv, const Pt &p, const Pt &q) {
    const FieldCtx &f = cv.f;
    if (pt_is_identity(p)) return q;
    if (pt_is_identity(q)) return p;
    Fp z1z1 = fp_mul(f, p.z, p.z);
    Fp z2z2 = fp_mul(f, q.z, q.z);
    Fp u1 = fp_mul(f, p.x, z2z2);
    Fp u2 = fp_mul(f, q.x, z1z1);
    Fp s1 = fp_mul(f, p.y, fp_mul(f, q.z, z2z2));
    Fp s2 = fp_mul(f, q.y, fp_mul(f, p.z, z1z1));
    Fp h = fp_sub(f, u2, u1);
    Fp r = fp_sub(f, s2, s1);
    if (fp_is_zero(h)) {
        if (fp_is_zero(r)) return ec_double(cv, p);
        return pt_identity(cv);
    }
    Fp hh = fp_mul(f, h, h);
    Fp hhh = fp_mul(f, h, hh);
    Fp v = fp_mul(f, u1, hh);
    Pt o;
    o.x = fp_sub(f, fp_sub(f, fp_mul(f, r, r), hhh), fp_add(f, v, v));
    o.y = fp_sub(f, fp_mul(f, r, fp_sub(f, v, o.x)), fp_mul(f, s1, hhh));
    o.z = fp_mul(f, fp_mul(f, p.z, q.z), h);
    return o;
}

static void pt_to_affine(const CurveCtx &cv, const Pt &p, Fp *x, Fp *y,
                         int *is_inf) {
    if (pt_is_identity(p)) {
        memset(x, 0, sizeof(Fp));
        memset(y, 0, sizeof(Fp));
        *is_inf = 1;
        return;
    }
    const FieldCtx &f = cv.f;
    Fp zi = fp_inv(f, p.z);
    Fp zi2 = fp_mul(f, zi, zi);
    *x = fp_mul(f, p.x, zi2);
    *y = fp_mul(f, p.y, fp_mul(f, zi, zi2));
    *is_inf = 0;
}

// ---------------------------------------------------------------------------
// polynomials over the base field (Montgomery coefficients)
// ---------------------------------------------------------------------------

using Poly = std::vector<Fp>;

static Poly poly_mul(const FieldCtx &f, const Poly &a, const Poly &b) {
    if (a.empty() || b.empty()) return Poly();
    Poly r(a.size() + b.size() - 1);
    for (auto &x : r) memset(&x, 0, sizeof(Fp));
    for (size_t i = 0; i < a.size(); ++i)
        for (size_t j = 0; j < b.size(); ++j)
            r[i + j] = fp_add(f, r[i + j], fp_mul(f, a[i], b[j]));
    return r;
}

static Poly poly_add(const FieldCtx &f, const Poly &a, const Poly &b) {
    Poly r(std::max(a.size(), b.size()));
    for (size_t i = 0; i < r.size(); ++i) {
        Fp x;
        memset(&x, 0, sizeof(Fp));
        if (i < a.size()) x = fp_add(f, x, a[i]);
        if (i < b.size()) x = fp_add(f, x, b[i]);
        r[i] = x;
    }
    return r;
}

// synthetic division by (x - b), remainder dropped (reference kate_division)
static Poly poly_kate_div(const FieldCtx &f, const Poly &c, const Fp &b) {
    if (c.empty()) return Poly();
    Poly q(c.size() - 1);
    Fp acc;
    memset(&acc, 0, sizeof(Fp));
    for (size_t j = c.size() - 1; j >= 1; --j) {
        acc = fp_add(f, fp_mul(f, acc, b), c[j]);
        q[j - 1] = acc;
    }
    return q;
}

static Fp poly_eval(const FieldCtx &f, const Poly &c, const Fp &x) {
    Fp acc;
    memset(&acc, 0, sizeof(Fp));
    for (size_t i = c.size(); i-- > 0;) acc = fp_add(f, fp_mul(f, acc, x), c[i]);
    return acc;
}

// ---------------------------------------------------------------------------
// divisor witness (canonical affine line normalization; see divisor.py)
// ---------------------------------------------------------------------------

struct RegFun {
    Poly a, b;  // a(x) + y*b(x)
};

struct Prop {
    Pt out;
    RegFun w;
};

// canonical projective coords: identity -> (0, 1, 0); else (x, y, 1)
static void canon_coords(const CurveCtx &cv, const Pt &p, Fp *x, Fp *y, Fp *z) {
    if (pt_is_identity(p)) {
        memset(x, 0, sizeof(Fp));
        *y = cv.f.one;
        memset(z, 0, sizeof(Fp));
        return;
    }
    int inf;
    pt_to_affine(cv, p, x, y, &inf);
    *z = cv.f.one;
}

static RegFun linefunc(const CurveCtx &cv, const Pt &pa, const Pt &pb) {
    const FieldCtx &f = cv.f;
    Fp ax, ay, az, bx, by, bz;
    canon_coords(cv, pa, &ax, &ay, &az);
    canon_coords(cv, pb, &bx, &by, &bz);
    Fp lx = fp_sub(f, fp_mul(f, ay, bz), fp_mul(f, az, by));
    Fp ly = fp_sub(f, fp_mul(f, az, bx), fp_mul(f, ax, bz));
    Fp lz = fp_sub(f, fp_mul(f, ax, by), fp_mul(f, ay, bx));
    if (!(fp_is_zero(lx) && fp_is_zero(ly) && fp_is_zero(lz))) {
        RegFun r;
        r.a = {lz, lx};
        r.b = {ly};
        return r;
    }
    // degenerate: line through c = -(a + b)
    Pt c = ec_add(cv, pa, pb);
    c.y = fp_neg(f, c.y);
    Fp cx, cy, cz;
    canon_coords(cv, c, &cx, &cy, &cz);
    RegFun r;
    r.a = {fp_sub(f, fp_mul(f, ax, cy), fp_mul(f, ay, cx)),
           fp_sub(f, fp_mul(f, ay, cz), fp_mul(f, az, cy))};
    r.b = {fp_sub(f, fp_mul(f, az, cx), fp_mul(f, ax, cz))};
    return r;
}

static RegFun rf_mul(const CurveCtx &cv, const RegFun &p, const RegFun &q) {
    const FieldCtx &f = cv.f;
    Fp zero;
    memset(&zero, 0, sizeof(Fp));
    Poly subst = {cv.b_mont, cv.a_mont, zero, f.one};
    RegFun r;
    r.a = poly_add(f, poly_mul(f, p.a, q.a),
                   poly_mul(f, poly_mul(f, p.b, q.b), subst));
    r.b = poly_add(f, poly_mul(f, p.a, q.b), poly_mul(f, p.b, q.a));
    return r;
}

static Prop prop_empty(const CurveCtx &cv) {
    Prop r;
    r.out = pt_identity(cv);
    r.w.a = {cv.f.one};
    return r;
}

static Prop prop_from_pair(const CurveCtx &cv, const Pt &p1, const Pt &p2) {
    const FieldCtx &f = cv.f;
    if (pt_is_identity(p1)) {
        if (pt_is_identity(p2)) return prop_empty(cv);
        // from_point(p2): line(p2, -p2), output -p2
        Pt n2 = p2;
        n2.y = fp_neg(f, n2.y);
        Prop r;
        r.out = n2;
        r.w = linefunc(cv, p2, n2);
        return r;
    }
    Prop r;
    r.out = ec_add(cv, p1, p2);
    r.out.y = fp_neg(f, r.out.y);
    r.w = linefunc(cv, p1, p2);
    return r;
}

static Prop prop_merge(const CurveCtx &cv, const Prop &a, const Prop &b) {
    const FieldCtx &f = cv.f;
    Prop r;
    r.out = ec_add(cv, a.out, b.out);
    if (pt_is_identity(a.out) || pt_is_identity(b.out)) {
        r.w = rf_mul(cv, a.w, b.w);
        return r;
    }
    Pt na = a.out, nb = b.out;
    na.y = fp_neg(f, na.y);
    nb.y = fp_neg(f, nb.y);
    RegFun num = rf_mul(cv, a.w, rf_mul(cv, b.w, linefunc(cv, na, nb)));
    Fp ax, ay, bx, by;
    int inf;
    pt_to_affine(cv, a.out, &ax, &ay, &inf);
    pt_to_affine(cv, b.out, &bx, &by, &inf);
    r.w.a = poly_kate_div(f, poly_kate_div(f, num.a, ax), bx);
    r.w.b = poly_kate_div(f, poly_kate_div(f, num.b, ax), bx);
    return r;
}

static Prop divisor_witness(const CurveCtx &cv, std::vector<Pt> pts) {
    if (pts.size() % 2) pts.push_back(pt_identity(cv));  // canonical padding
    std::vector<Prop> props;
    for (size_t i = 0; i + 1 < pts.size(); i += 2)
        props.push_back(prop_from_pair(cv, pts[i], pts[i + 1]));
    if (props.empty()) props.push_back(prop_empty(cv));
    while (props.size() > 1) {
        std::vector<Prop> nxt;
        size_t j = 0;
        for (; j + 1 < props.size(); j += 2)
            nxt.push_back(prop_merge(cv, props[j], props[j + 1]));
        if (j < props.size()) nxt.push_back(props[j]);
        props.swap(nxt);
    }
    return props[0];
}

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

static void load_fp(const u64 *src, Fp *dst) { memcpy(dst->l, src, 32); }
static void store_fp(const Fp &src, u64 *dst) { memcpy(dst, src.l, 32); }

extern "C" {

// field context from canonical modulus limbs; r2/one computed via doubling
void oracle_field_ctx(const u64 *p_limbs, FieldCtx *ctx) {
    load_fp(p_limbs, &ctx->p);
    // n0inv = -p^-1 mod 2^64 (Newton iteration)
    u64 p0 = ctx->p.l[0];
    u64 inv = 1;
    for (int i = 0; i < 6; ++i) inv *= 2 - p0 * inv;
    ctx->n0inv = (u64)(0 - inv);
    // one = R mod p by repeated doubling of 1: 2^256 mod p
    Fp acc = {{1, 0, 0, 0}};
    for (int i = 0; i < 256; ++i) acc = fp_add(*ctx, acc, acc);
    // careful: fp_add needs one/r2 unset — it only uses p; fine
    ctx->one = acc;
    // r2 = R^2 mod p by squaring... need mont mul which needs n0inv (set) and
    // works for any inputs: r2 = mont_mul(one, one) * ... mont_mul(a,b)=abR^-1
    // => mont_mul(one, one) = R^2 * R^-1 = R = one.  Instead double 256 more:
    Fp r2 = acc;
    for (int i = 0; i < 256; ++i) r2 = fp_add(*ctx, r2, r2);
    ctx->r2 = r2;
}

void oracle_curve_ctx(const u64 *p_limbs, const u64 *a_limbs, const u64 *b_limbs,
                      CurveCtx *cv) {
    oracle_field_ctx(p_limbs, &cv->f);
    Fp a, b;
    load_fp(a_limbs, &a);
    load_fp(b_limbs, &b);
    cv->a_mont = to_mont(cv->f, a);
    cv->b_mont = to_mont(cv->f, b);
}

int oracle_sizeof_field_ctx() { return (int)sizeof(FieldCtx); }
int oracle_sizeof_curve_ctx() { return (int)sizeof(CurveCtx); }

// batched field ops on canonical limbs
void oracle_ff_mul(const FieldCtx *c, int n, const u64 *a, const u64 *b, u64 *out) {
    for (int i = 0; i < n; ++i) {
        Fp x, y;
        load_fp(a + 4 * i, &x);
        load_fp(b + 4 * i, &y);
        Fp r = from_mont(*c, fp_mul(*c, to_mont(*c, x), to_mont(*c, y)));
        store_fp(r, out + 4 * i);
    }
}
void oracle_ff_add(const FieldCtx *c, int n, const u64 *a, const u64 *b, u64 *out) {
    for (int i = 0; i < n; ++i) {
        Fp x, y;
        load_fp(a + 4 * i, &x);
        load_fp(b + 4 * i, &y);
        store_fp(fp_add(*c, x, y), out + 4 * i);
    }
}
void oracle_ff_inv(const FieldCtx *c, int n, const u64 *a, u64 *out) {
    for (int i = 0; i < n; ++i) {
        Fp x;
        load_fp(a + 4 * i, &x);
        // Montgomery exponentiation of a Montgomery input yields
        // mont(x^(p-2)) = mont(x^-1); convert back out
        Fp r = from_mont(*c, fp_inv(*c, to_mont(*c, x)));
        store_fp(r, out + 4 * i);
    }
}

// points: canonical affine (x, y) pairs; is_inf flags separate
// MSM: scalars as 4x64 canonical little-endian
void oracle_ec_msm(const CurveCtx *cv, int n, const u64 *scalars,
                   const u64 *xs, const u64 *ys, const int *is_inf,
                   u64 *out_x, u64 *out_y, int *out_inf) {
    Pt acc = pt_identity(*cv);
    for (int i = 0; i < n; ++i) {
        if (is_inf[i]) continue;
        Fp x, y;
        load_fp(xs + 4 * i, &x);
        load_fp(ys + 4 * i, &y);
        Pt p;
        p.x = to_mont(cv->f, x);
        p.y = to_mont(cv->f, y);
        p.z = cv->f.one;
        // double-and-add over scalar bits, msb first
        Pt s = pt_identity(*cv);
        for (int limb = 3; limb >= 0; --limb)
            for (int b = 63; b >= 0; --b) {
                s = ec_double(*cv, s);
                if ((scalars[4 * i + limb] >> b) & 1) s = ec_add(*cv, s, p);
            }
        acc = ec_add(*cv, acc, s);
    }
    Fp ax, ay;
    pt_to_affine(*cv, acc, &ax, &ay, out_inf);
    store_fp(from_mont(cv->f, ax), out_x);
    store_fp(from_mont(cv->f, ay), out_y);
}

// divisor witness: n affine points -> witness polys (canonical coeffs) +
// output point.  out_a/out_b must have capacity cap coefficients each.
// Returns 0 on success, -1 if cap too small.
int oracle_divisor_witness(const CurveCtx *cv, int n, const u64 *xs,
                           const u64 *ys, const int *is_inf, int cap,
                           u64 *out_a, u64 *out_b, int *len_a, int *len_b,
                           u64 *out_x, u64 *out_y, int *out_inf) {
    std::vector<Pt> pts(n);
    for (int i = 0; i < n; ++i) {
        if (is_inf[i]) {
            pts[i] = pt_identity(*cv);
            continue;
        }
        Fp x, y;
        load_fp(xs + 4 * i, &x);
        load_fp(ys + 4 * i, &y);
        pts[i].x = to_mont(cv->f, x);
        pts[i].y = to_mont(cv->f, y);
        pts[i].z = cv->f.one;
    }
    Prop r = divisor_witness(*cv, pts);
    if ((int)r.w.a.size() > cap || (int)r.w.b.size() > cap) return -1;
    *len_a = (int)r.w.a.size();
    *len_b = (int)r.w.b.size();
    for (int i = 0; i < *len_a; ++i)
        store_fp(from_mont(cv->f, r.w.a[i]), out_a + 4 * i);
    for (int i = 0; i < *len_b; ++i)
        store_fp(from_mont(cv->f, r.w.b[i]), out_b + 4 * i);
    Fp ax, ay;
    pt_to_affine(*cv, r.out, &ax, &ay, out_inf);
    store_fp(from_mont(cv->f, ax), out_x);
    store_fp(from_mont(cv->f, ay), out_y);
    return 0;
}

}  // extern "C"
