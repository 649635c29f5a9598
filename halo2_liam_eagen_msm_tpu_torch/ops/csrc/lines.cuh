// affine_lines: the divisor merge tree's head, mont_mul's (and mont_addsub's)
// work at the shape of divisor.merge_head and divisor.seeds, in one launch a
// level.  Included by kernels.cu; wrapper and plain version in
// ops/cuda_lines.py.
//
// Replaces pallas_ff.py:515 mont_mul and :541 mont_addsub where the JAX
// package's divisor.py (:101-118 linefunc_affine, :161 _multi_affine,
// :268-300 merge_head) and ops/ec.py (:402-416 to_affine) compile them into
// one graph: the affine normalisation of three points whose Z the caller
// inverted (one batch_inv launch), the line through the first two, the line
// through the first and the third where that one vanishes, and the masks.
// The port ran it as 16 mont_mul and 8 mont_addsub launches and about twenty
// PyTorch selects a level, 21 levels a round, most of them at widths where a
// launch costs only its floor.
//
// One thread a slot.  Point k of slot i is row k n + i of x, y and zinv
// (the three points stacked, as the caller stacks their Z for the
// inversion).  A thread
//   * normalises the first two points: (x zinv^2, y zinv^3); zinv = 0 (the
//     identity: batch_inv maps 0 to 0) gives (0, 0), the identity's mask
//     being zinv == 0;
//   * head (merge_head: a.out, b.out, a.out + b.out): negates the two ys
//     (the lines go through -a.out and -b.out; -0 = 0), bypass = either
//     point the identity; seeds (p1, p2, -(p1 + p2)): where p1 is the
//     identity the line goes through (p2, -p2) and the third point is the
//     identity (p2 + (-p2) = O, so seeds need no second curve add);
//   * the line lx X + ly Y + lz through the two as canonical projective
//     points, (x, y, 1) or (0, 1, 0) for the identity: the cross product.
//     Four of its six products have a factor z of 0 or 1 (R mod p, whose
//     Montgomery product with v is v itself), so they are selects: 2
//     products and 3 subtractions;
//   * where it vanishes (equal points, the tangent case; in the head not on
//     bypass slots), normalises the third point and takes the line through
//     the first and the third instead (in a branch: only such slots pay);
//   * bypass (head) or both points the identity (seeds): the line (0, 0, 1).
// Head outputs, rows k n + i of out: lx, ly, lz, the negated ys, the roots
// (the affine x of a.out and b.out, 1 on bypass slots); flags[i] = deg,
// flags[n + i] = bypass.  Seeds: lx, ly, lz.  Every value is fully reduced,
// so the limbs equal the plain version's and the route of launches it
// replaced.
//
// What bounds it: 13 rows a slot in and out (the first two points' 6 in, the
// third's 3 more on a degenerate slot; 7 out in the head, 3 in the seeds) and
// 10 products (16 on a degenerate slot); the path calls it at every width from
// 2^19 slots down to 1, so at most levels one thread's chain of dependent
// products and the launch, not the card's rate, set its time.

#define LINES_BLOCK 128
#define LINES_HEAD_ROWS 7
#define LINES_SEEDS_ROWS 3

struct AffPt {
  Fe x, y;
  bool id;
};

// Point k of slot i normalised: (x zinv^2, y zinv^3), (0, 0) for the identity.
__device__ __forceinline__ AffPt aff_normalise(const uint32_t* __restrict__ x,
                                               const uint32_t* __restrict__ y,
                                               const uint32_t* __restrict__ zinv, int64_t row,
                                               const FieldParams& P) {
  const Fe zi = fe_load(zinv + row * ELEMS_PER_ROW);
  const Fe zi2 = fe_sqr(zi, P);
  AffPt a;
  a.x = fe_mul(fe_load(x + row * ELEMS_PER_ROW), zi2, P);
  a.y = fe_mul(fe_load(y + row * ELEMS_PER_ROW), fe_mul(zi, zi2, P), P);
  a.id = fe_is_zero(zi);
  return a;
}

// The cross product of (ax, ay, az) and (bx, by, bz), the points as (x, y, 1)
// or (0, 1, 0) for the identity (divisor.linefunc_affine): ay bz - az by,
// az bx - ax bz, ax by - ay bx, where a product by az or bz is a select.
__device__ __forceinline__ void aff_line(const AffPt& a, const AffPt& b, const Fe& one,
                                         const FieldParams& P, Fe& lx, Fe& ly, Fe& lz) {
  const Fe zero = fe_zero();
  const Fe ax = fe_select(a.id, zero, a.x), ay = fe_select(a.id, one, a.y);
  const Fe bx = fe_select(b.id, zero, b.x), by = fe_select(b.id, one, b.y);
  lx = fe_sub(fe_select(b.id, zero, ay), fe_select(a.id, zero, by), P);
  ly = fe_sub(fe_select(a.id, zero, bx), fe_select(b.id, zero, ax), P);
  lz = fe_sub(fe_mul(ax, by, P), fe_mul(ay, bx, P), P);
}

__global__ void __launch_bounds__(LINES_BLOCK)
affine_lines_kernel(FieldParams P, const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ y, const uint32_t* __restrict__ zinv,
                    uint32_t* __restrict__ out, uint8_t* __restrict__ flags, int64_t n,
                    int head) {
  const int64_t i = global_index();
  if (i >= n) return;
  const Fe one = fe_one(P), zero = fe_zero();
  AffPt a = aff_normalise(x, y, zinv, i, P);
  AffPt b = aff_normalise(x, y, zinv, n + i, P);
  bool bypass, c_identity = false;
  if (head) {
    a.y = fe_sub(zero, a.y, P);
    b.y = fe_sub(zero, b.y, P);
    bypass = a.id || b.id;
  } else {
    bypass = a.id && b.id;  // both identity: the witness is the constant 1
    if (a.id) {             // the line through (p2, -p2); c = p2 + (-p2) = O
      a = b;
      b.y = fe_sub(zero, b.y, P);
      c_identity = true;
    }
  }
  Fe lx, ly, lz;
  aff_line(a, b, one, P, lx, ly, lz);
  const bool deg = fe_is_zero(lx) && fe_is_zero(ly) && fe_is_zero(lz) && !(head && bypass);
  if (deg) {
    AffPt c = aff_normalise(x, y, zinv, 2 * n + i, P);
    c.id = c.id || c_identity;
    aff_line(a, c, one, P, lx, ly, lz);
  }
  if (bypass) {
    lx = zero;
    ly = zero;
    lz = one;
  }
  fe_store(out + i * ELEMS_PER_ROW, lx);
  fe_store(out + (n + i) * ELEMS_PER_ROW, ly);
  fe_store(out + (2 * n + i) * ELEMS_PER_ROW, lz);
  if (head) {
    fe_store(out + (3 * n + i) * ELEMS_PER_ROW, a.y);
    fe_store(out + (4 * n + i) * ELEMS_PER_ROW, b.y);
    fe_store(out + (5 * n + i) * ELEMS_PER_ROW, fe_select(bypass, one, a.x));
    fe_store(out + (6 * n + i) * ELEMS_PER_ROW, fe_select(bypass, one, b.x));
    flags[i] = deg;
    flags[n + i] = bypass;
  }
}
