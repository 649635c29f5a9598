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
//
// Point k of slot i is row k n + i of x, y and zinv (the three points
// stacked, as the caller stacks their Z for the inversion).  For a slot:
//   * the first two points normalised: (x zinv^2, y zinv^3); zinv = 0 (the
//     identity: batch_inv maps 0 to 0) gives (0, 0), the identity's mask
//     being zinv == 0;
//   * head (merge_head: a.out, b.out, a.out + b.out): the two ys negated
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
//     bypass slots), the third point normalised and the line through the
//     first and the third taken instead;
//   * bypass (head) or both points the identity (seeds): the line (0, 0, 1).
// Head outputs, rows k n + i of out: lx, ly, lz, the negated ys, the roots
// (the affine x of a.out and b.out, 1 on bypass slots); flags[i] = deg,
// flags[n + i] = bypass.  Seeds: lx, ly, lz.  Every value is fully reduced,
// so the limbs equal the plain version's whatever the kernel.
//
// What bounds it: 13 rows a slot in and out (the first two points' 6 in, the
// third's 3 more on a degenerate slot; 7 out in the head, 3 in the seeds) and
// 10 products (16 on a degenerate slot); the path calls it at every width
// from 2^19 slots down to 1.  The first design (affine_lines_v1 below, one
// thread a slot, 138 registers) was bound by the latency of its chain of 10
// dependent products: at most levels the chain itself (0.0096 ms at B <= 32
// against a launch of 0.0025 ms), at the wide ones the few warps its
// registers leave an SM to hide it (0.375 ms at 2^19 slots against a bytes
// bound of 0.091 ms; PERF.md row 1e).
//
// The design of the path (affine_lines_kernel) spreads a slot over
// LINES_LANES = 2 neighbouring lanes, whose exchanges are __shfl_sync within
// the pair:
//   * lane k normalises point k (zinv^2, then x zinv^2 and zinv^3 side by
//     side, then y zinv^3: three products deep), head negating its own y;
//     one exchange of (x, y, id);
//   * the line's two products on the two lanes (a fourth product deep),
//     exchanged;
//   * where a slot of the warp is degenerate and not bypassed (a warp vote,
//     so that every lane takes the exchanges), the third point on two
//     lanes, one coordinate each, and the second line's two products: three
//     and one more deep.  Only warps holding such a slot pay (the first
//     design took the branch for the seeds' slots of two identities too,
//     whose line the bypass overrides);
//   * the rows stored round-robin over the lanes, flags by the last lane.
// So a slot's chain is four products deep (eight on a degenerate slot)
// where it was ten (sixteen).  A ragged last block gives its spare pairs of
// lanes slot n - 1 and stores nothing from them.  Four lanes a slot (each a
// coordinate of a point, three products deep) ran faster only up to 2^13
// slots and slower from 2^14 up, where a round's time is (PERF.md row 1e),
// and was dropped.  The wide levels are bound by the rate at which an SM
// sub-partition dispatches fe_mul's instructions (a warp's product holds it
// about as many cycles as its chain takes alone), as kate_div2 is.

#define LINES_BLOCK 128
#define LINES_LANES 2
// four blocks an SM: at most 128 registers a thread (140-150 without the
// bound: three blocks), a few bytes spilled; faster at the wide levels, in
// turns, than no bound and than five blocks (96 registers, 200 bytes
// spilled; PERF.md row 1e)
#define LINES_MIN_BLOCKS 4
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

// One coordinate of a normalised point: x zinv^2 (half 0) or y zinv^3 (half
// 1), three dependent products either way (half 0's second is a product by
// the Montgomery one, so that both lanes run the same instructions); id:
// zinv == 0.
__device__ __forceinline__ Fe aff_coord(const uint32_t* __restrict__ x,
                                        const uint32_t* __restrict__ y,
                                        const uint32_t* __restrict__ zinv, int64_t row, int half,
                                        const Fe& one, const FieldParams& P, bool& id) {
  const Fe zi = fe_load(zinv + row * ELEMS_PER_ROW);
  id = fe_is_zero(zi);
  const Fe f = fe_mul(fe_select(half, zi, one), fe_sqr(zi, P), P);
  return fe_mul(fe_load((half ? y : x) + row * ELEMS_PER_ROW), f, P);
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

// aff_line with its two products on a pair of lanes: ax by on lane 0, ay bx
// on lane 1, exchanged; both lanes return the whole line.
__device__ __forceinline__ void lane_line(const AffPt& a, const AffPt& b, const Fe& one,
                                          int lane, const FieldParams& P, Fe& lx, Fe& ly,
                                          Fe& lz) {
  const Fe zero = fe_zero();
  const bool odd = lane & 1;
  const Fe ax = fe_select(a.id, zero, a.x), ay = fe_select(a.id, one, a.y);
  const Fe bx = fe_select(b.id, zero, b.x), by = fe_select(b.id, one, b.y);
  lx = fe_sub(fe_select(b.id, zero, ay), fe_select(a.id, zero, by), P);
  ly = fe_sub(fe_select(a.id, zero, bx), fe_select(b.id, zero, ax), P);
  const Fe mine = fe_mul(fe_select(odd, ay, ax), fe_select(odd, bx, by), P);
  const Fe other = fe_shfl(mine, lane ^ 1, LINES_LANES);
  lz = fe_sub(fe_select(odd, other, mine), fe_select(odd, mine, other), P);
}

__global__ void __launch_bounds__(LINES_BLOCK, LINES_MIN_BLOCKS)
affine_lines_kernel(FieldParams P, const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ y, const uint32_t* __restrict__ zinv,
                    uint32_t* __restrict__ out, uint8_t* __restrict__ flags, int64_t n,
                    int head) {
  const int lane = threadIdx.x % LINES_LANES;
  const int64_t i = global_index() / LINES_LANES;
  const int64_t s = i < n ? i : n - 1;
  const Fe one = fe_one(P), zero = fe_zero();
  AffPt mine = aff_normalise(x, y, zinv, lane * n + s, P);
  if (head) mine.y = fe_sub(zero, mine.y, P);
  AffPt other;
  other.x = fe_shfl(mine.x, lane ^ 1, LINES_LANES);
  other.y = fe_shfl(mine.y, lane ^ 1, LINES_LANES);
  other.id = __shfl_sync(0xFFFFFFFFu, (int)mine.id, lane ^ 1, LINES_LANES) != 0;
  AffPt a = lane ? other : mine;
  AffPt b = lane ? mine : other;
  bool bypass, c_identity = false;
  if (head) {
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
  lane_line(a, b, one, lane, P, lx, ly, lz);
  // a bypass slot's line is the constant whatever its points (in the seeds
  // two identities give a vanishing line too), so only the others may need
  // the third point
  const bool deg = fe_is_zero(lx) && fe_is_zero(ly) && fe_is_zero(lz) && !bypass;
  if (__ballot_sync(0xFFFFFFFFu, deg) != 0) {
    bool id;
    const Fe v = aff_coord(x, y, zinv, 2 * n + s, lane, one, P, id);
    AffPt c;
    c.x = fe_shfl(v, 0, LINES_LANES);
    c.y = fe_shfl(v, 1, LINES_LANES);
    c.id = id || c_identity;
    Fe lx2, ly2, lz2;
    lane_line(a, c, one, lane, P, lx2, ly2, lz2);
    lx = fe_select(deg, lx2, lx);
    ly = fe_select(deg, ly2, ly);
    lz = fe_select(deg, lz2, lz);
  }
  if (bypass) {
    lx = zero;
    ly = zero;
    lz = one;
  }
  if (i >= n) return;
  // row k by lane k % 2; k is known when the kernel is compiled, so the
  // value a row takes is too (no local array indexed at run time)
#pragma unroll
  for (int k = 0; k < LINES_HEAD_ROWS; k++) {
    if (k % LINES_LANES != lane || (!head && k >= LINES_SEEDS_ROWS)) continue;
    const Fe v = k == 0 ? lx : k == 1 ? ly : k == 2 ? lz : k == 3 ? a.y : k == 4 ? b.y
               : fe_select(bypass, one, k == 5 ? a.x : b.x);
    fe_store(out + (k * n + i) * ELEMS_PER_ROW, v);
  }
  if (head && lane == LINES_LANES - 1) {
    flags[i] = deg;
    flags[n + i] = bypass;
  }
}

// ---- affine_lines_v1: the first design, one thread a slot ---------------------
//
// Kept for one A/B against the design above (ROADMAP Queue 2's retirement
// rule); no path launches it.  A thread normalises the first two points,
// takes their line and, on a degenerate slot (in a branch: only such slots
// pay), normalises the third and takes the second line: a chain of 10
// dependent products (16).

__global__ void __launch_bounds__(LINES_BLOCK)
affine_lines_v1_kernel(FieldParams P, const uint32_t* __restrict__ x,
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
    bypass = a.id && b.id;
    if (a.id) {
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
