// The ten kernels of the field and curve layers and their C launchers, with
// those of the kernels included below: the divisor merge tree's five in
// ntt.cuh, the MSM's radix reorder's four in radix.cuh, the coefficient
// levels' two (poly_mul_naive and kate_div) in poly.cuh, the merge head's
// affine_lines in lines.cuh and the tensor-core product by a constant
// (mxu_mul_const, mxu_mul_table: ops/mxu_ff.py's, on no path) in mxu.cuh.
// mont_mul and ec_add_mixed_fast are one thread per element: each reads its
// (16,) rows, does the whole formula in registers (ff.cuh, ec.cuh) and writes
// its rows back; mont_addsub spreads one row over four lanes, ec_add,
// ec_add_fast and ec_double one point over four, ec_madd_xyzz_fast one carry
// over four, fused_madd_scan_xyzz and ec_add_mixed one carry over two, and
// batch_inv gives a thread a chain of rows (see each).
// No kernel allocates or synchronises; a launcher enqueues on the stream it
// is given and returns cudaGetLastError().
//
// What bounds them on this card: mont_mul and mont_addsub move 192 bytes for
// at most 136 multiply-adds of 32 bits and are bound by bytes; the curve
// kernels do 7 to 23 field products on 5 to 10 rows and sit at the crossover
// of bytes and integer operations.  So every kernel keeps all intermediates
// of its formula in registers or shared memory and touches device memory
// once per input and output, in 16-byte accesses.
#include <cuda_runtime.h>
#include "ec.cuh"

#define ELEMS_PER_ROW 16
#define BLOCK 128

static inline unsigned int grid_for(int64_t n, int block) {
  return (unsigned int)((n + block - 1) / block);
}

__device__ __forceinline__ int64_t global_index() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

#include "ntt.cuh"
#include "radix.cuh"
#include "poly.cuh"
#include "lines.cuh"
#include "mxu.cuh"

// ---- 1. mont_mul: replaces pallas_ff.mont_mul ---------------------------------

__global__ void __launch_bounds__(BLOCK)
mont_mul_kernel(FieldParams P, const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b, uint32_t* __restrict__ out, int64_t n) {
  int64_t i = global_index();
  if (i >= n) return;
  Fe r = fe_mul(fe_load(a + i * ELEMS_PER_ROW), fe_load(b + i * ELEMS_PER_ROW), P);
  fe_store(out + i * ELEMS_PER_ROW, r);
}

// ---- 1b. batch_inv: mont_mul at the shape of the batch inversions -------------
//
// Almost every mont_mul launch of the paths was one product of a batch
// inversion (FF.batch_inv, FF.inv): 64-step prefix and suffix chains and a
// Fermat chain of 330-379 products, each product a launch on a few thousand
// to 32,768 rows, about 460 launches an inversion.  Each paid the launch and
// sent the chain's working set through device memory again.  Here a whole
// Montgomery-trick inversion is one launch: thread c owns the chain of rows
// c, c + C, c + 2C, ... below n (C = ceil(n / L) chains of at most L rows, so
// neighbouring threads read neighbouring rows).  It walks its chain forward
// with the running product in registers, writing each exclusive prefix into
// the first half of the row's output (packed, 32 bytes); inverts the total by
// fe_pow with the exponent p - 2 by value; walks back, writing out[i] =
// prefix[i] * (running inverse) and stepping the running inverse by row i.
// A zero row counts as one in the products and its output is zero.  Every
// output is the unique a^-1 R mod p, fully reduced, so any L gives the same
// limbs as the plain version and the chains of launches; L = 1 is a plain
// Fermat inversion, one element a thread.
//
// What bounds it: each thread runs 3 (L - 1) products and one power (about
// 290-320 products) one after another, so a launch has a latency floor of a
// few hundred products whatever its width; the wrapper picks L = n / 16,384
// (at most 64) so that a wide batch still gives the card at least 16,384
// chains.  Device memory sees
// each row five times (read, prefix out, read, prefix in, write: 256 bytes).

#define INV_BLOCK 64

__global__ void __launch_bounds__(INV_BLOCK)
batch_inv_kernel(FieldParams P, PowExp e, const uint32_t* __restrict__ a,
                 uint32_t* __restrict__ out, int64_t n, int64_t chains, int chain_len) {
  const int64_t c = global_index();
  if (c >= chains) return;
  const int64_t left = (n - 1 - c) / chains + 1;
  const int m = left < chain_len ? (int)left : chain_len;
  const Fe one = fe_one(P);
  Fe x = fe_load(a + c * ELEMS_PER_ROW);
  Fe acc = fe_select(fe_is_zero(x), one, x);
#pragma unroll 1
  for (int i = 1; i < m; i++) {
    const int64_t row = c + (int64_t)i * chains;
    fe_store_packed(out + row * ELEMS_PER_ROW, acc);
    x = fe_load(a + row * ELEMS_PER_ROW);
    acc = fe_mul(acc, fe_select(fe_is_zero(x), one, x), P);
  }
  Fe inv = fe_pow(acc, e, P);
#pragma unroll 1
  for (int i = m - 1; i > 0; i--) {
    const int64_t row = c + (int64_t)i * chains;
    x = fe_load(a + row * ELEMS_PER_ROW);
    const bool z = fe_is_zero(x);
    const Fe r = fe_mul(fe_load_packed(out + row * ELEMS_PER_ROW), inv, P);
    fe_store(out + row * ELEMS_PER_ROW, fe_select(z, fe_zero(), r));
    inv = fe_mul(inv, fe_select(z, one, x), P);
  }
  x = fe_load(a + c * ELEMS_PER_ROW);
  fe_store(out + c * ELEMS_PER_ROW, fe_select(fe_is_zero(x), fe_zero(), inv));
}

// ---- 2. mont_addsub: replaces pallas_ff.mont_addsub ----------------------------
//
// Replaces pallas_ff.py:541 mont_addsub (its body k_add / k_sub).  A field
// add moves 192 bytes a row for 16 word additions, so bytes bound it where a
// launch is wide; the main path calls it at every width from 1 row to 1.3 M
// (the divisor's coefficient levels, Horner, the element-major butterflies):
// a quarter of its launches at 8,192 rows or fewer, where the launch itself
// bounds it, two fifths at 16,384 and 32,768 rows, where a launch holds fewer
// threads than the card has slots, and a fifth from 2^18 rows up, where bytes
// do (chip_smoke.py's tally).  The first design (one thread a row, deleted
// after its comparison) made four 16-byte loads 64 bytes apart, so a warp's
// load touched 32 separate pieces, and at B = 32,768 it put 32,768 threads
// on 132 SMs.  Here
// ADDSUB_LANES = 4 neighbouring lanes share a row: lane k loads the row's
// 16-byte quarter k of each input (limbs 4k .. 4k + 3, 64 bits), so a warp's
// load covers 512 contiguous bytes and a launch has four times the threads.
// Each lane adds or subtracts its 64 bits; the carries (borrows) between the
// quarters come from a carry-lookahead over the group (group_carries: two
// __shfl_sync exchanges gather the lanes' generate and propagate bits), and
// once more for the conditional subtraction of p, or the addition of p after
// a borrow, whose choice is the group's carry out, the same in every lane.
// The result is fully reduced in [0, p), so it equals the plain version limb
// for limb.  Spare groups of a ragged last block load row n - 1 and store
// nothing.

#define ADDSUB_LANES 4

// One 64-bit quarter of a (16,) row: limbs 4k .. 4k + 3, one 16-byte access.
__device__ __forceinline__ uint64_t quarter_load(const uint32_t* __restrict__ q4) {
  const uint4 q = *reinterpret_cast<const uint4*>(q4);
  return (uint64_t)((q.x & 0xFFFFu) | (q.y << 16)) |
         ((uint64_t)((q.z & 0xFFFFu) | (q.w << 16)) << 32);
}

__device__ __forceinline__ void quarter_store(uint32_t* __restrict__ q4, uint64_t w) {
  uint4 q;
  q.x = (uint32_t)w & 0xFFFFu;
  q.y = (uint32_t)(w >> 16) & 0xFFFFu;
  q.z = (uint32_t)(w >> 32) & 0xFFFFu;
  q.w = (uint32_t)(w >> 48);
  *reinterpret_cast<uint4*>(q4) = q;
}

// The carries into the four quarters of a row from each lane's generate bit
// g (its 64-bit sum carries out by itself) and propagate bit p (its sum is
// all ones, so a carry in passes on; g and p never both hold).  Two exchanges
// gather the group's bits into every lane (bit k: lane k's g, bit 4 + k: its
// p); then bit k of ((G | P) + G) ^ P is the carry into quarter k, and bit 4
// the carry out of the row.  Borrows work the same way.
__device__ __forceinline__ uint32_t group_carries(bool g, bool p, int lane) {
  uint32_t x = ((uint32_t)g << lane) | ((uint32_t)p << (4 + lane));
  x |= __shfl_sync(0xFFFFFFFFu, x, lane ^ 1, ADDSUB_LANES);
  x |= __shfl_sync(0xFFFFFFFFu, x, lane ^ 2, ADDSUB_LANES);
  const uint32_t gen = x & 0xFu, prop = x >> 4;
  return ((gen | prop) + gen) ^ prop;
}

__global__ void __launch_bounds__(BLOCK)
mont_addsub_kernel(FieldParams P, int is_sub, const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, uint32_t* __restrict__ out, int64_t n) {
  const int lane = threadIdx.x % ADDSUB_LANES;
  const int64_t i = global_index() / ADDSUB_LANES;
  const int64_t off = (i < n ? i : n - 1) * ELEMS_PER_ROW + 4 * lane;
  const uint64_t x = quarter_load(a + off), y = quarter_load(b + off);
  uint64_t pk = 0;  // quarter `lane` of p
#pragma unroll
  for (int k = 0; k < ADDSUB_LANES; k++)
    if (k == lane) pk = (uint64_t)P.p[2 * k] | ((uint64_t)P.p[2 * k + 1] << 32);
  uint64_t r;
  if (is_sub) {
    // a - b; on a borrow out of the row, + p (its carry out dropped)
    uint64_t d = x - y;
    uint32_t c = group_carries(x < y, x == y, lane);
    d -= (c >> lane) & 1u;
    const bool borrow = (c >> ADDSUB_LANES) & 1u;
    uint64_t e = d + pk;
    c = group_carries(e < d, e == ~0ull, lane);
    e += (c >> lane) & 1u;
    r = borrow ? e : d;
  } else {
    // a + b < 2p < 2^256; then s - p, kept unless it borrows out (s < p)
    uint64_t s = x + y;
    uint32_t c = group_carries(s < x, s == ~0ull, lane);
    s += (c >> lane) & 1u;
    uint64_t d = s - pk;
    c = group_carries(s < pk, s == pk, lane);
    d -= (c >> lane) & 1u;
    r = ((c >> ADDSUB_LANES) & 1u) ? s : d;
  }
  if (i < n) quarter_store(out + off, r);
}

// ---- 3. ec_add: replaces pallas_ff.ec_add -------------------------------------

__device__ __forceinline__ Jac jac_load(const uint32_t* x, const uint32_t* y,
                                        const uint32_t* z, int64_t i) {
  Jac p;
  p.x = fe_load(x + i * ELEMS_PER_ROW);
  p.y = fe_load(y + i * ELEMS_PER_ROW);
  p.z = fe_load(z + i * ELEMS_PER_ROW);
  return p;
}

__device__ __forceinline__ void jac_store(uint32_t* x, uint32_t* y, uint32_t* z,
                                          int64_t i, const Jac& p) {
  fe_store(x + i * ELEMS_PER_ROW, p.x);
  fe_store(y + i * ELEMS_PER_ROW, p.y);
  fe_store(z + i * ELEMS_PER_ROW, p.z);
}

// ADD_LANES = 4 neighbouring lanes share one point.  The paths call it at a
// few thousand points (B = 2048 in every MSM window), where one thread a
// point (the first design) leaves the card one warp an SM sub-partition and
// a chain of 23 dependent products, so latency bounds it, not the
// operations (0.034 ms against a 0.0004 ms bound).  Here the complete add
// (add-2007-bl, the doubling of p by dbl-2009-l, and the selects of the JAX
// package's k_ec_add, as in cuda_ff.ec_add_plain) is cut into six rounds of up to four independent products, one a lane, and
// eight rounds of up to four field adds or subtractions.  Every value lives
// in a slot of the point's scratch in shared memory; a round reads its
// operands from slots, writes its result to a fresh slot and ends in
// __syncwarp().  A lane picks its slots by its lane index from constants (no
// branch), so the four lanes of a group run the same instructions and the
// warp does not diverge; an idle lane repeats a product into a sink slot of
// its own.  The values are those of the plain version, each fully reduced,
// and the selects keep its order, so the result is the same limb for limb.  A
// ragged last block loads point n - 1 into its spare groups and stores
// nothing from them.  The product is fe_mul's C: one by PTX carry chains ran
// slower on the H100.

#define ADD_LANES 4
#define ADD_BLOCK 64
#define ADD_PTS (ADD_BLOCK / ADD_LANES)

enum AddSlot {
  S_X1, S_Y1, S_Z1, S_X2, S_Y2, S_Z2,
  // the generic sum (add-2007-bl)
  S_Z1Z1, S_Z2Z2, S_U1, S_U2, S_Z1C, S_Z2C, S_S1, S_S2, S_H, S_R, S_HH, S_HHH, S_V,
  S_RR, S_T1, S_V2, S_X3, S_VX, S_RY, S_SH, S_Y3, S_Z1Z2, S_Z3,
  // the doubling of p (dbl-2009-l)
  S_A, S_B, S_XB, S_A2, S_T, S_E, S_TA, S_C, S_TAC, S_C2, S_D, S_C4, S_D2, S_C8, S_F,
  S_X3D, S_DX, S_EDX, S_Y3D, S_YZ, S_Z3D,
  S_SINK1, S_SINK2, S_SINK3,  // where an idle lane writes
  ADD_SLOTS
};
// A point's scratch: two uint4 a slot, one more so that the points of a warp
// start on different banks.
#define ADD_STRIDE (2 * ADD_SLOTS + 1)

// Four slot numbers, one a lane, in one word.
#define LANES4(a, b, c, d) \
  ((uint32_t)(a) | ((uint32_t)(b) << 8) | ((uint32_t)(c) << 16) | ((uint32_t)(d) << 24))

__device__ __forceinline__ int lane_slot(uint32_t four, int lane) {
  return (int)((four >> (8 * lane)) & 0xFFu);
}

__device__ __forceinline__ Fe slot_load(const uint4* sc, int s) {
  uint4 lo = sc[2 * s], hi = sc[2 * s + 1];
  Fe a;
  a.v[0] = lo.x; a.v[1] = lo.y; a.v[2] = lo.z; a.v[3] = lo.w;
  a.v[4] = hi.x; a.v[5] = hi.y; a.v[6] = hi.z; a.v[7] = hi.w;
  return a;
}

__device__ __forceinline__ void slot_store(uint4* sc, int s, const Fe& a) {
  uint4 lo, hi;
  lo.x = a.v[0]; lo.y = a.v[1]; lo.z = a.v[2]; lo.w = a.v[3];
  hi.x = a.v[4]; hi.y = a.v[5]; hi.z = a.v[6]; hi.w = a.v[7];
  sc[2 * s] = lo;
  sc[2 * s + 1] = hi;
}

// (a + b) or (a - b) mod p by one branch-free body: a + (p - b) < 2p reduces
// to a - b (b = 0 gives a + p, which reduces to a).
__device__ __forceinline__ Fe fe_add_or_sub(const Fe& a, const Fe& b, bool sub,
                                            const FieldParams& P) {
  Fe nb;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) {
    uint64_t s = (uint64_t)P.p[k] - (uint64_t)b.v[k] - borrow;
    nb.v[k] = (uint32_t)s;
    borrow = s >> 63;
  }
  return fe_add(a, fe_select(sub, nb, b), P);
}

// One round of products: slot out = slot a * slot b, each picked by lane.
__device__ __forceinline__ void slot_mul_round(uint4* sc, int lane, uint32_t a, uint32_t b,
                                              uint32_t out, const FieldParams& P) {
  Fe r = fe_mul(slot_load(sc, lane_slot(a, lane)), slot_load(sc, lane_slot(b, lane)), P);
  slot_store(sc, lane_slot(out, lane), r);
  __syncwarp();
}

// One round of adds: slot out = slot a +- slot b; bit `lane` of sub_mask
// asks for the difference.
__device__ __forceinline__ void slot_lin_round(uint4* sc, int lane, uint32_t a, uint32_t b,
                                              uint32_t out, unsigned sub_mask,
                                              const FieldParams& P) {
  Fe r = fe_add_or_sub(slot_load(sc, lane_slot(a, lane)), slot_load(sc, lane_slot(b, lane)),
                       (sub_mask >> lane) & 1u, P);
  slot_store(sc, lane_slot(out, lane), r);
  __syncwarp();
}

__global__ void __launch_bounds__(ADD_BLOCK)
ec_add_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
              const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
              uint32_t* ox, uint32_t* oy, uint32_t* oz, int64_t n) {
  __shared__ uint4 add_sm[ADD_PTS * ADD_STRIDE];
  const int lane = threadIdx.x % ADD_LANES;
  const int pt = threadIdx.x / ADD_LANES;
  const int64_t i = (int64_t)blockIdx.x * ADD_PTS + pt;
  const int64_t src = i < n ? i : n - 1;
  uint4* sc = add_sm + pt * ADD_STRIDE;
  for (int r = lane; r < 6; r += ADD_LANES) {
    const uint32_t* row = r == 0 ? x1 : r == 1 ? y1 : r == 2 ? z1 : r == 3 ? x2 : r == 4 ? y2 : z2;
    slot_store(sc, r, fe_load(row + src * ELEMS_PER_ROW));
  }
  __syncwarp();
  // Lane:              0                    1                    2                 3
  slot_mul_round(sc, lane, LANES4(S_Z1, S_Z2, S_X1, S_Y1), LANES4(S_Z1, S_Z2, S_X1, S_Y1),
                LANES4(S_Z1Z1, S_Z2Z2, S_A, S_B), P);
  slot_mul_round(sc, lane, LANES4(S_X1, S_X2, S_Z2, S_Z1), LANES4(S_Z2Z2, S_Z1Z1, S_Z2Z2, S_Z1Z1),
                LANES4(S_U1, S_U2, S_Z2C, S_Z1C), P);
  slot_lin_round(sc, lane, LANES4(S_U2, S_X1, S_A, S_X1), LANES4(S_U1, S_B, S_A, S_X1),
                LANES4(S_H, S_XB, S_A2, S_SINK3), 0x1u, P);
  slot_mul_round(sc, lane, LANES4(S_Y1, S_Y2, S_H, S_XB), LANES4(S_Z2C, S_Z1C, S_H, S_XB),
                LANES4(S_S1, S_S2, S_HH, S_T), P);
  slot_lin_round(sc, lane, LANES4(S_S2, S_A2, S_T, S_X1), LANES4(S_S1, S_A, S_A, S_X1),
                LANES4(S_R, S_E, S_TA, S_SINK3), 0x5u, P);
  slot_mul_round(sc, lane, LANES4(S_H, S_U1, S_R, S_B), LANES4(S_HH, S_HH, S_R, S_B),
                LANES4(S_HHH, S_V, S_RR, S_C), P);
  slot_lin_round(sc, lane, LANES4(S_RR, S_V, S_TA, S_C), LANES4(S_HHH, S_V, S_C, S_C),
                LANES4(S_T1, S_V2, S_TAC, S_C2), 0x5u, P);
  slot_lin_round(sc, lane, LANES4(S_T1, S_TAC, S_C2, S_X1), LANES4(S_V2, S_TAC, S_C2, S_X1),
                LANES4(S_X3, S_D, S_C4, S_SINK3), 0x1u, P);
  slot_lin_round(sc, lane, LANES4(S_V, S_D, S_C4, S_X1), LANES4(S_X3, S_D, S_C4, S_X1),
                LANES4(S_VX, S_D2, S_C8, S_SINK3), 0x1u, P);
  slot_mul_round(sc, lane, LANES4(S_R, S_S1, S_E, S_Z1), LANES4(S_VX, S_HHH, S_E, S_Z2),
                LANES4(S_RY, S_SH, S_F, S_Z1Z2), P);
  slot_lin_round(sc, lane, LANES4(S_RY, S_F, S_X1, S_X1), LANES4(S_SH, S_D2, S_X1, S_X1),
                LANES4(S_Y3, S_X3D, S_SINK2, S_SINK3), 0x3u, P);
  slot_lin_round(sc, lane, LANES4(S_D, S_X1, S_X1, S_X1), LANES4(S_X3D, S_X1, S_X1, S_X1),
                LANES4(S_DX, S_SINK1, S_SINK2, S_SINK3), 0x1u, P);
  slot_mul_round(sc, lane, LANES4(S_E, S_Z1Z2, S_Y1, S_X1), LANES4(S_DX, S_H, S_Z1, S_X1),
                LANES4(S_EDX, S_Z3, S_YZ, S_SINK3), P);
  slot_lin_round(sc, lane, LANES4(S_EDX, S_YZ, S_X1, S_X1), LANES4(S_C8, S_YZ, S_X1, S_X1),
                LANES4(S_Y3D, S_Z3D, S_SINK2, S_SINK3), 0x1u, P);
  if (lane < 3 && i < n) {
    // lane k writes coordinate k, through k_ec_add's selects in its order
    const bool h0 = fe_is_zero(slot_load(sc, S_H));
    const bool r0 = fe_is_zero(slot_load(sc, S_R));
    const bool id1 = fe_is_zero(slot_load(sc, S_Z1));
    const bool id2 = fe_is_zero(slot_load(sc, S_Z2));
    const Fe ident = lane < 2 ? fe_one(P) : fe_zero();
    Fe o = slot_load(sc, lane_slot(LANES4(S_X3, S_Y3, S_Z3, 0), lane));
    o = fe_select(h0 && r0, slot_load(sc, lane_slot(LANES4(S_X3D, S_Y3D, S_Z3D, 0), lane)), o);
    o = fe_select(h0 && !r0, ident, o);
    o = fe_select(id2 && !id1, slot_load(sc, lane), o);
    o = fe_select(id1 && !id2, slot_load(sc, 3 + lane), o);
    o = fe_select(id1 && id2, ident, o);
    fe_store((lane == 0 ? ox : lane == 1 ? oy : oz) + i * ELEMS_PER_ROW, o);
  }
}

// ---- 4. ec_add_fast: replaces pallas_ff.ec_add_fast ----------------------------
//
// Replaces pallas_ff.py:630 ec_add_fast (its body k_ec_add_fast, :394-420).
// The MSM calls it at a few thousand points: every step of a window's
// blocked triangle scan is one launch at B = 2048 lanes (ops/msm.py
// _pick_block_width keeps g = n / w at ops/ec.SUM_G), the rest near
// B = 32,768.  At B = 2048 one thread a point (the first design, 126
// registers, deleted after its comparison) puts 16 blocks on 132 SMs, each
// thread a
// chain of 16 dependent products, so latency bounds it, not the
// operations.  Here ADD_LANES = 4 neighbouring lanes share a point, by
// ec_add's slot machinery above: the 16 products of add-2007-bl (the generic
// sum alone; no doubling path) in five rounds of up to four independent
// products,
//   {Z1^2, Z2^2, Z1 Z2} -> {u1, u2, Z2 Z2Z2, Z1 Z1Z1} -> {s1, s2, h^2, Z1Z2 h}
//   -> {h hh, u1 hh, r^2} -> {r (v - x3), s1 hhh},
// with the adds for h, r, x3 and v - x3 in rounds between them.  Lane k
// writes coordinate k through k_ec_add_fast's selects in its order (q
// identity passes p, p identity passes q), lane 3 the flag byte (a true
// doubling, neither operand the identity).  Every value is fully reduced, so
// the output equals the plain version limb for limb.
// A ragged last block loads point n - 1 into its spare groups and stores
// nothing from them.  Wide launches pay for the lanes: the product rounds
// fill 16 of 20 lane slots and the add rounds one of four, so at B = 32,768,
// where the card has the warps to be bound by issue, this runs about a tenth
// slower than the first design (51 such launches an MSM against 272 at
// B = 2048; PERF.md).

enum FastAddSlot {
  F_X1, F_Y1, F_Z1, F_X2, F_Y2, F_Z2,
  F_Z1Z1, F_Z2Z2, F_Z1Z2, F_U1, F_U2, F_Z1C, F_Z2C, F_H, F_S1, F_S2, F_HH, F_Z3, F_R,
  F_HHH, F_V, F_RR, F_X3, F_VX, F_RY, F_SH,
  F_ZERO,                     // zero: x3 - 0 and z3 - 0 in the last round
  F_SINK1, F_SINK2, F_SINK3,  // where an idle lane writes
  FAST_SLOTS
};
#define FAST_STRIDE (2 * FAST_SLOTS + 1)

__global__ void __launch_bounds__(ADD_BLOCK)
ec_add_fast_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                   const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                   uint32_t* ox, uint32_t* oy, uint32_t* oz, uint8_t* exc, int64_t n) {
  __shared__ uint4 fast_sm[ADD_PTS * FAST_STRIDE];
  const int lane = threadIdx.x % ADD_LANES;
  const int pt = threadIdx.x / ADD_LANES;
  const int64_t i = (int64_t)blockIdx.x * ADD_PTS + pt;
  const int64_t src = i < n ? i : n - 1;
  uint4* sc = fast_sm + pt * FAST_STRIDE;
  for (int r = lane; r < 6; r += ADD_LANES) {
    const uint32_t* row = r == 0 ? x1 : r == 1 ? y1 : r == 2 ? z1 : r == 3 ? x2 : r == 4 ? y2 : z2;
    slot_store(sc, r, fe_load(row + src * ELEMS_PER_ROW));
  }
  if (lane == 3) slot_store(sc, F_ZERO, fe_zero());
  __syncwarp();
  // Lane:              0                    1                    2                 3
  slot_mul_round(sc, lane, LANES4(F_Z1, F_Z2, F_Z1, F_Z1), LANES4(F_Z1, F_Z2, F_Z2, F_Z1),
                 LANES4(F_Z1Z1, F_Z2Z2, F_Z1Z2, F_SINK3), P);
  slot_mul_round(sc, lane, LANES4(F_X1, F_X2, F_Z2, F_Z1), LANES4(F_Z2Z2, F_Z1Z1, F_Z2Z2, F_Z1Z1),
                 LANES4(F_U1, F_U2, F_Z2C, F_Z1C), P);
  slot_lin_round(sc, lane, LANES4(F_U2, F_X1, F_X1, F_X1), LANES4(F_U1, F_X1, F_X1, F_X1),
                 LANES4(F_H, F_SINK1, F_SINK2, F_SINK3), 0x1u, P);
  slot_mul_round(sc, lane, LANES4(F_Y1, F_Y2, F_H, F_Z1Z2), LANES4(F_Z2C, F_Z1C, F_H, F_H),
                 LANES4(F_S1, F_S2, F_HH, F_Z3), P);
  slot_lin_round(sc, lane, LANES4(F_S2, F_X1, F_X1, F_X1), LANES4(F_S1, F_X1, F_X1, F_X1),
                 LANES4(F_R, F_SINK1, F_SINK2, F_SINK3), 0x1u, P);
  slot_mul_round(sc, lane, LANES4(F_H, F_U1, F_R, F_X1), LANES4(F_HH, F_HH, F_R, F_X1),
                 LANES4(F_HHH, F_V, F_RR, F_SINK3), P);
  {
    // x3 = (r^2 - hhh) - 2v and v - x3, the same body in every lane; lane 0
    // keeps x3, lane 1 v - x3
    const Fe v = slot_load(sc, F_V);
    const Fe x3 = fe_sub(fe_sub(slot_load(sc, F_RR), slot_load(sc, F_HHH), P),
                         fe_double(v, P), P);
    slot_store(sc, lane_slot(LANES4(F_X3, F_VX, F_SINK2, F_SINK3), lane),
               fe_select(lane == 0, x3, fe_sub(v, x3, P)));
    __syncwarp();
  }
  slot_mul_round(sc, lane, LANES4(F_R, F_S1, F_X1, F_X1), LANES4(F_VX, F_HHH, F_X1, F_X1),
                 LANES4(F_RY, F_SH, F_SINK2, F_SINK3), P);
  // the generic sum's coordinate `lane`: x3 - 0, r (v - x3) - s1 hhh, z3 - 0
  Fe o = fe_sub(slot_load(sc, lane_slot(LANES4(F_X3, F_RY, F_Z3, F_X1), lane)),
                slot_load(sc, lane_slot(LANES4(F_ZERO, F_SH, F_ZERO, F_X1), lane)), P);
  const bool id1 = fe_is_zero(slot_load(sc, F_Z1));
  const bool id2 = fe_is_zero(slot_load(sc, F_Z2));
  if (i < n) {
    if (lane < 3) {
      o = fe_select(id1, slot_load(sc, 3 + lane), o);
      o = fe_select(id2, slot_load(sc, lane), o);
      fe_store((lane == 0 ? ox : lane == 1 ? oy : oz) + i * ELEMS_PER_ROW, o);
    } else {
      const bool dbl = fe_is_zero(slot_load(sc, F_H)) && fe_is_zero(slot_load(sc, F_R));
      exc[i] = (!id1 && !id2 && dbl) ? 1 : 0;
    }
  }
}

// ---- 5. ec_double: replaces pallas_ff.ec_double ---------------------------------
//
// Replaces pallas_ff.py:832 ec_double (its body k_ec_double), k times over:
// the counterpart of the JAX package's msm._double_n, a fori_loop of
// doublings in one program.  The paths call it on one point: the MSM's
// Horner fold doubles its accumulator c times a window, the carry stage its
// carry twice a round (scalar_mul_small by base 5).  One thread a point (the
// first design, retired after its comparison) runs the 7 products of
// dbl-2009-l as one chain, and a launch a doubling.  Here the point lives in shared memory
// between its k doublings, and ADD_LANES = 4 neighbouring lanes share it by
// ec_add's slot machinery: a doubling is three rounds of independent
// products,
//   {X^2, Y^2, Y Z} -> {B^2, (X + B)^2, E^2} -> {E (D - X3)},
// the least the formula allows (each round needs the one before), each
// followed by a round of adds that every lane computes alike and whose
// results it keeps by its lane index (no branch).  A round writes the new X,
// Y or Z over the old one only after the last round of the doubling that
// reads it.  The values are those of ec_double_plain, fully reduced, so the
// Jacobian representative is the same limb for limb; Z = 0 stays the
// identity (Z3 = 2 Y Z).  k = 0 copies the point.  A ragged last block loads
// point n - 1 into its spare groups and stores nothing from them.

enum DblSlot {
  D_X, D_Y, D_Z,  // the point: lane k writes coordinate k at the end
  D_A, D_B, D_YZ, D_XB, D_E, D_C, D_T, D_F, D_DX, D_C8, D_EDX,
  D_SINK1, D_SINK2, D_SINK3,  // where an idle lane writes
  DBL_SLOTS
};
#define DBL_STRIDE (2 * DBL_SLOTS + 1)

// One of four values by lane index, without a branch.
__device__ __forceinline__ Fe lane_pick(int lane, const Fe& a, const Fe& b, const Fe& c,
                                        const Fe& d) {
  return fe_select(lane == 0, a, fe_select(lane == 1, b, fe_select(lane == 2, c, d)));
}

__global__ void __launch_bounds__(ADD_BLOCK)
ec_double_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                 uint32_t* ox, uint32_t* oy, uint32_t* oz, int64_t n, int k) {
  __shared__ uint4 dbl_sm[ADD_PTS * DBL_STRIDE];
  const int lane = threadIdx.x % ADD_LANES;
  const int pt = threadIdx.x / ADD_LANES;
  const int64_t i = (int64_t)blockIdx.x * ADD_PTS + pt;
  const int64_t src = i < n ? i : n - 1;
  uint4* sc = dbl_sm + pt * DBL_STRIDE;
  if (lane < 3)
    slot_store(sc, lane, fe_load((lane == 0 ? x1 : lane == 1 ? y1 : z1) + src * ELEMS_PER_ROW));
  __syncwarp();
#pragma unroll 1
  for (int r = 0; r < k; r++) {
    // Lane:              0                    1                    2                 3
    slot_mul_round(sc, lane, LANES4(D_X, D_Y, D_Y, D_X), LANES4(D_X, D_Y, D_Z, D_X),
                   LANES4(D_A, D_B, D_YZ, D_SINK3), P);
    {
      // X + B, E = 2A + A and Z3 = 2 YZ; lane 2 writes Z3 over Z
      const Fe a = slot_load(sc, D_A);
      const Fe xb = fe_add(slot_load(sc, D_X), slot_load(sc, D_B), P);
      const Fe e = fe_add(fe_double(a, P), a, P);
      const Fe z3 = fe_double(slot_load(sc, D_YZ), P);
      slot_store(sc, lane_slot(LANES4(D_XB, D_E, D_Z, D_SINK3), lane),
                 lane_pick(lane, xb, e, z3, z3));
      __syncwarp();
    }
    slot_mul_round(sc, lane, LANES4(D_B, D_XB, D_E, D_A), LANES4(D_B, D_XB, D_E, D_A),
                   LANES4(D_C, D_T, D_F, D_SINK3), P);
    {
      // D = 2 ((T - A) - C), X3 = F - 2D, D - X3 and 8C; lane 0 writes X3
      // over X
      const Fe c = slot_load(sc, D_C);
      const Fe d = fe_double(fe_sub(fe_sub(slot_load(sc, D_T), slot_load(sc, D_A), P), c, P), P);
      const Fe x3 = fe_sub(slot_load(sc, D_F), fe_double(d, P), P);
      const Fe c8 = fe_double(fe_double(fe_double(c, P), P), P);
      slot_store(sc, lane_slot(LANES4(D_X, D_DX, D_C8, D_SINK3), lane),
                 lane_pick(lane, x3, fe_sub(d, x3, P), c8, c8));
      __syncwarp();
    }
    slot_mul_round(sc, lane, LANES4(D_E, D_E, D_E, D_E), LANES4(D_DX, D_DX, D_DX, D_DX),
                   LANES4(D_EDX, D_SINK1, D_SINK2, D_SINK3), P);
    {
      // Y3 = E (D - X3) - 8C over Y
      const Fe y3 = fe_sub(slot_load(sc, D_EDX), slot_load(sc, D_C8), P);
      slot_store(sc, lane_slot(LANES4(D_Y, D_SINK1, D_SINK2, D_SINK3), lane), y3);
      __syncwarp();
    }
  }
  if (lane < 3 && i < n)
    fe_store((lane == 0 ? ox : lane == 1 ? oy : oz) + i * ELEMS_PER_ROW, slot_load(sc, lane));
}

// ---- 6. fused_madd_scan_xyzz: replaces pallas_ff.fused_madd_scan_xyzz ------------
//
// The whole blinded prefix scan of one Pippenger window in one launch.  Carry
// l seeds its XYZZ sum at the blinding point T, walks its w consecutive
// packed rows (rows l*w .. l*w + w - 1 of the sorted (g*w, 16) array, read in
// place: no transpose is materialised) by ec_madd_xyzz_fast's formula, and
// after each step writes the carry as the inner prefix of that row,
// limb-major (w, 16, g) so that neighbouring carries write neighbouring
// words.  At the end it writes its total as a (16,) row and its exception
// flag as one byte.
//
// One thread a carry (the first design, deleted after its comparison) walks
// w = 64 steps of 10 dependent products in a chain, with g = 16,384 carries
// about four warps an SM, so latency bounds it (0.622 ms against a 0.101 ms
// bound).  Here SCAN_LANES = 2 neighbouring lanes share a carry, as ec_add's
// four do a point: a step is five rounds of two independent products, a lane each,
//   {u2, s2} -> {pp^2, r^2} -> {ppp, q} -> {r (q - x3), y ppp} -> {zz3, zzz3},
// with rounds of adds and subtractions between them, every value in a slot
// of the carry's scratch in shared memory, slots picked by lane index from
// constants (no branch), __syncwarp() after each round.  Two lanes and not
// four: a warp issues a round once for all its lanes, so four lanes (ten
// products in four rounds of four slots) cost 1.6 times the products' issue
// of one thread a carry and ran slower than it at g = 16,384 on the H100,
// where two fill every slot and still halve the chain.  In the last round of
// a step lane 0 takes coordinates x and y of the new carry, lane 1 zz and
// zzz, through the affine identity's select, and writes them back to their
// slots and to the inner prefixes.  The values are those of
// ec_madd_xyzz_fast, each fully reduced, in its select order, so every output
// is the plain version's limb for limb.  The next row is loaded into
// registers while the step runs.  Spare carries of a ragged last block walk
// carry g - 1 and store nothing.

#define SCAN_LANES 2
#define SCAN_BLOCK 64
#define SCAN_CARRIES (SCAN_BLOCK / SCAN_LANES)

enum ScanSlot {
  C_X, C_Y, C_ZZ, C_ZZZ,  // the carry: lane k owns slots 2k and 2k + 1 at the end of a step
  C_QX, C_QY,             // the step's affine row
  C_U2, C_S2, C_PP, C_R, C_PPSQ, C_RR, C_PPP, C_Q, C_X3, C_D, C_RD, C_YPPP, C_ZZ3, C_ZZZ3,
  C_ZERO,                 // zero: zzz3 - 0 = zzz3 in the last round
  C_SINK,                 // where an idle lane writes
  SCAN_SLOTS
};
#define SCAN_STRIDE (2 * SCAN_SLOTS + 1)

// Two slot numbers, one a lane, in the word of LANES4.
#define LANES2(a, b) LANES4(a, b, 0, 0)

__global__ void __launch_bounds__(SCAN_BLOCK)
fused_madd_scan_xyzz_kernel(FieldParams P, Fe tx, Fe ty,
                            const uint32_t* __restrict__ rows, int w, int64_t g,
                            uint32_t* __restrict__ ix, uint32_t* __restrict__ iy,
                            uint32_t* __restrict__ izz, uint32_t* __restrict__ izzz,
                            uint32_t* __restrict__ totx, uint32_t* __restrict__ toty,
                            uint32_t* __restrict__ totzz, uint32_t* __restrict__ totzzz,
                            uint8_t* __restrict__ exc) {
  __shared__ uint4 scan_sm[SCAN_CARRIES * SCAN_STRIDE];
  const int lane = threadIdx.x % SCAN_LANES;
  const int64_t carry = (int64_t)blockIdx.x * SCAN_CARRIES + threadIdx.x / SCAN_LANES;
  const int64_t src = carry < g ? carry : g - 1;
  uint4* sc = scan_sm + (threadIdx.x / SCAN_LANES) * SCAN_STRIDE;
  // lane 0 writes x and y, lane 1 zz and zzz
  uint32_t* inner1 = lane == 0 ? ix : izz;
  uint32_t* inner2 = lane == 0 ? iy : izzz;
  // lane 0 reads a row's x, lane 1 its y
  const uint32_t* r = rows + src * w * ELEMS_PER_ROW + lane * FE_WORDS;
  slot_store(sc, 2 * lane, lane == 0 ? tx : fe_one(P));
  slot_store(sc, 2 * lane + 1, lane == 0 ? ty : fe_one(P));
  slot_store(sc, lane_slot(LANES2(C_ZERO, C_SINK), lane), fe_zero());
  Fe q = fe_load_packed(r);
  Fe o1, o2;
  bool any = false;
#pragma unroll 1
  for (int t = 0; t < w; t++) {
    // the barrier after this store also ends the last round of the step before
    slot_store(sc, lane_slot(LANES2(C_QX, C_QY), lane), q);
    __syncwarp();
    if (t + 1 < w) q = fe_load_packed(r + (int64_t)(t + 1) * ELEMS_PER_ROW);
    // Lane:                        0       1
    slot_mul_round(sc, lane, LANES2(C_QX, C_QY), LANES2(C_ZZ, C_ZZZ), LANES2(C_U2, C_S2), P);
    slot_lin_round(sc, lane, LANES2(C_U2, C_S2), LANES2(C_X, C_Y), LANES2(C_PP, C_R), 0x3u, P);
    // the affine identity (qy == 0) keeps the carry; an identity carry or
    // carry == +-Q (pp == 0) flags the carry
    const bool id2 = fe_is_zero(slot_load(sc, C_QY));
    any = any || (!id2 && (fe_is_zero(slot_load(sc, C_ZZ)) || fe_is_zero(slot_load(sc, C_PP))));
    slot_mul_round(sc, lane, LANES2(C_PP, C_R), LANES2(C_PP, C_R), LANES2(C_PPSQ, C_RR), P);
    slot_mul_round(sc, lane, LANES2(C_PP, C_X), LANES2(C_PPSQ, C_PPSQ), LANES2(C_PPP, C_Q), P);
    {
      // x3 = (r^2 - ppp) - 2q and d = q - x3 in one round; lane 1 repeats
      // them into its sink.  No barrier: only lane 0 reads what it wrote.
      const Fe qq = slot_load(sc, C_Q);
      const Fe x3 = fe_sub(fe_sub(slot_load(sc, C_RR), slot_load(sc, C_PPP), P),
                           fe_double(qq, P), P);
      slot_store(sc, lane_slot(LANES2(C_X3, C_SINK), lane), x3);
      slot_store(sc, lane_slot(LANES2(C_D, C_SINK), lane), fe_sub(qq, x3, P));
    }
    slot_mul_round(sc, lane, LANES2(C_R, C_Y), LANES2(C_D, C_PPP), LANES2(C_RD, C_YPPP), P);
    slot_mul_round(sc, lane, LANES2(C_ZZ, C_ZZZ), LANES2(C_PPSQ, C_PPP), LANES2(C_ZZ3, C_ZZZ3),
                   P);
    // lane 0: x, y = r d - y ppp; lane 1: zz, zzz = zzz3 - 0
    o1 = fe_select(id2, slot_load(sc, 2 * lane), slot_load(sc, lane_slot(LANES2(C_X3, C_ZZ3), lane)));
    o2 = fe_select(id2, slot_load(sc, 2 * lane + 1),
                   fe_sub(slot_load(sc, lane_slot(LANES2(C_RD, C_ZZZ3), lane)),
                          slot_load(sc, lane_slot(LANES2(C_YPPP, C_ZERO), lane)), P));
    slot_store(sc, 2 * lane, o1);
    slot_store(sc, 2 * lane + 1, o2);
    if (carry < g) {
      const int64_t off = (int64_t)t * ELEMS_PER_ROW * g + carry;
      fe_store_limb_major(inner1 + off, g, o1);
      fe_store_limb_major(inner2 + off, g, o2);
    }
  }
  if (carry < g) {
    fe_store((lane == 0 ? totx : totzz) + carry * ELEMS_PER_ROW, o1);
    fe_store((lane == 0 ? toty : totzzz) + carry * ELEMS_PER_ROW, o2);
    if (lane == 0) exc[carry] = any ? 1 : 0;
  }
}

// ---- 7. ec_madd_xyzz_fast: replaces pallas_ff.ec_madd_xyzz_fast -----------------
//
// Replaces pallas_ff.py:699 ec_madd_xyzz_fast (its body k_ec_madd_xyzz_fast),
// w times over: the counterpart of the JAX package's jax.lax.scan of
// E.madd_xyzz_fast in msm.prefix_scan_parts_affine_fast, the blinded stepwise
// scan of a card window below ops/msm.FUSED_SCAN_MIN_ROWS points.  Carry j (of
// g) starts at (x1, y1, zz1, zzz1)[j] (XYZZ; the blinding point T on the
// path) and takes, at step t, the XYZZ + affine add (madd-2008-s, no
// exceptional path) of row j w + t of (qx, qy), and writes the new carry to
// row j w + t of the inner prefixes; at the end its total to row j of tx, ty,
// tzz, tzzz (unless tx is null) and its flag byte, the OR over its steps (an
// identity carry or carry == +-Q where qy != 0).  w = 1 is the single step of
// EC.madd_xyzz_fast, a flag an element.
//
// The paths call it at g = 32 to 2048 carries (half a window's points at
// most, w = 2 to 32 steps): a few blocks, so latency bounds it, not bytes
// (10 products on 6 rows a step).  One thread a carry and a launch a step
// (the first design, retired after its comparison: PERF.md row 7) ran the 10
// products as one chain, and the stepwise scan's w launches paid a launch
// each and PyTorch's flag ORs and stacks besides.  Here the carry stays in shared memory between
// the steps, and ADD_LANES = 4 neighbouring lanes share it by ec_add's slot
// machinery: a step is four rounds of up to three independent products,
//   {u2, s2} -> {pp^2, r^2} -> {ppp, q, zz3} -> {r (q - x3), y ppp, zzz3},
// the least the formula allows (each round needs the one before), with the
// subtractions for pp and r, and x3 and q - x3 (lane 0 alone: only it reads
// them), between them.  In the last round lane k takes coordinate k of the
// new carry through the affine identity's select and writes it back to its
// slot and to the inner prefixes.  The values are those of
// ec_madd_xyzz_fast_plain, each fully reduced, in its select order, so every
// output equals the plain version's limb for limb.  The next step's row is
// loaded into registers while a step runs.  Spare carries of a ragged last
// block walk carry g - 1 and store nothing.

enum XyzzSlot {
  Z_X, Z_Y, Z_ZZ, Z_ZZZ,  // the carry: lane k writes coordinate k at the end of a step
  Z_QX, Z_QY,             // the step's affine row
  Z_U2, Z_S2, Z_PP, Z_R, Z_PPSQ, Z_RR, Z_PPP, Z_Q, Z_ZZ3, Z_X3, Z_D, Z_RD, Z_YPPP, Z_ZZZ3,
  Z_ZERO,                     // zero: x3 - 0, zz3 - 0 and zzz3 - 0 in the last round
  Z_SINK1, Z_SINK2, Z_SINK3,  // where an idle lane writes
  XYZZ_SLOTS
};
#define XYZZ_STRIDE (2 * XYZZ_SLOTS + 1)

__global__ void __launch_bounds__(ADD_BLOCK)
ec_madd_xyzz_fast_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1,
                         const uint32_t* zz1, const uint32_t* zzz1,
                         const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                         int w, int64_t g, uint32_t* ix, uint32_t* iy, uint32_t* izz,
                         uint32_t* izzz, uint32_t* tx, uint32_t* ty, uint32_t* tzz,
                         uint32_t* tzzz, uint8_t* __restrict__ exc) {
  __shared__ uint4 xyzz_sm[ADD_PTS * XYZZ_STRIDE];
  const int lane = threadIdx.x % ADD_LANES;
  const int64_t j = (int64_t)blockIdx.x * ADD_PTS + threadIdx.x / ADD_LANES;
  const int64_t src = j < g ? j : g - 1;
  uint4* sc = xyzz_sm + (threadIdx.x / ADD_LANES) * XYZZ_STRIDE;
  // lane k loads and writes coordinate k
  const uint32_t* carry = lane == 0 ? x1 : lane == 1 ? y1 : lane == 2 ? zz1 : zzz1;
  uint32_t* inner = (lane == 0 ? ix : lane == 1 ? iy : lane == 2 ? izz : izzz) +
                    src * w * ELEMS_PER_ROW;
  uint32_t* total = lane == 0 ? tx : lane == 1 ? ty : lane == 2 ? tzz : tzzz;
  slot_store(sc, lane, fe_load(carry + src * ELEMS_PER_ROW));
  if (lane == 3) slot_store(sc, Z_ZERO, fe_zero());
  // lanes 0 and 2 read the steps' x, lanes 1 and 3 their y
  const uint32_t* qrow = ((lane & 1) ? qy : qx) + src * w * ELEMS_PER_ROW;
  Fe q = fe_load(qrow);
  Fe o;
  bool any = false;
#pragma unroll 1
  for (int t = 0; t < w; t++) {
    // the barrier after this store also ends the step before, whose last
    // round wrote the carry
    slot_store(sc, lane_slot(LANES4(Z_QX, Z_QY, Z_SINK2, Z_SINK3), lane), q);
    __syncwarp();
    if (t + 1 < w) q = fe_load(qrow + (int64_t)(t + 1) * ELEMS_PER_ROW);
    // Lane:              0                    1                    2                 3
    slot_mul_round(sc, lane, LANES4(Z_QX, Z_QY, Z_X, Z_X), LANES4(Z_ZZ, Z_ZZZ, Z_X, Z_X),
                   LANES4(Z_U2, Z_S2, Z_SINK2, Z_SINK3), P);
    slot_lin_round(sc, lane, LANES4(Z_U2, Z_S2, Z_X, Z_X), LANES4(Z_X, Z_Y, Z_X, Z_X),
                   LANES4(Z_PP, Z_R, Z_SINK2, Z_SINK3), 0x3u, P);
    // the affine identity (qy == 0) keeps the carry; an identity carry or
    // carry == +-Q (pp == 0) flags the carry
    const bool id2 = fe_is_zero(slot_load(sc, Z_QY));
    any = any || (!id2 && (fe_is_zero(slot_load(sc, Z_ZZ)) || fe_is_zero(slot_load(sc, Z_PP))));
    slot_mul_round(sc, lane, LANES4(Z_PP, Z_R, Z_X, Z_X), LANES4(Z_PP, Z_R, Z_X, Z_X),
                   LANES4(Z_PPSQ, Z_RR, Z_SINK2, Z_SINK3), P);
    slot_mul_round(sc, lane, LANES4(Z_PP, Z_X, Z_ZZ, Z_X), LANES4(Z_PPSQ, Z_PPSQ, Z_PPSQ, Z_X),
                   LANES4(Z_PPP, Z_Q, Z_ZZ3, Z_SINK3), P);
    {
      // x3 = (r^2 - ppp) - 2q and d = q - x3, the same body in every lane;
      // lane 0 keeps them, the others write their sinks.  No barrier: only
      // lane 0 reads what it wrote.
      const Fe qq = slot_load(sc, Z_Q);
      const Fe x3 = fe_sub(fe_sub(slot_load(sc, Z_RR), slot_load(sc, Z_PPP), P),
                           fe_double(qq, P), P);
      slot_store(sc, lane_slot(LANES4(Z_X3, Z_SINK1, Z_SINK2, Z_SINK3), lane), x3);
      slot_store(sc, lane_slot(LANES4(Z_D, Z_SINK1, Z_SINK2, Z_SINK3), lane), fe_sub(qq, x3, P));
    }
    slot_mul_round(sc, lane, LANES4(Z_R, Z_Y, Z_ZZZ, Z_X), LANES4(Z_D, Z_PPP, Z_PPP, Z_X),
                   LANES4(Z_RD, Z_YPPP, Z_ZZZ3, Z_SINK3), P);
    // lane k: coordinate k of the new carry, x3 - 0, r d - y ppp, zz3 - 0 or
    // zzz3 - 0, or the carry's own where q is the affine identity
    o = fe_select(id2, slot_load(sc, lane),
                  fe_sub(slot_load(sc, lane_slot(LANES4(Z_X3, Z_RD, Z_ZZ3, Z_ZZZ3), lane)),
                         slot_load(sc, lane_slot(LANES4(Z_ZERO, Z_YPPP, Z_ZERO, Z_ZERO), lane)),
                         P));
    slot_store(sc, lane, o);
    if (j < g) fe_store(inner + (int64_t)t * ELEMS_PER_ROW, o);
  }
  if (j < g) {
    if (total != nullptr) fe_store(total + j * ELEMS_PER_ROW, o);
    if (lane == 0) exc[j] = any ? 1 : 0;
  }
}

// ---- 8. ec_add_mixed: replaces pallas_ff.ec_add_mixed ---------------------------
//
// Replaces pallas_ff.py:599 ec_add_mixed (its body k_ec_add_mixed), w times
// over: the counterpart of the JAX package's jax.lax.scan of E.add_mixed in
// msm.prefix_scan_parts_affine, the safe flavor's prefix scan of a window.
// Carry j (of g) starts at (x1, y1, z1)[j] and takes, at step t, the
// complete Jacobian + affine add of row j w + t of (qx, qy) with its
// identity mask byte (the scan's column layout as the rows lie: carry j's w
// rows are consecutive), and writes the new carry to row j w + t of the
// inner prefixes; at the end its total to row j of tx, ty, tz (unless tx is
// null).  w = 1 is the single complete mixed add of EC.add_mixed.
//
// One thread a point and a launch a step (the first design, retired after
// its comparison: 138 registers, 128 blocks of 4 warps at a window's g = 16,384 for
// 132 SMs, the 18 products one chain).  Here the carry stays in shared
// memory between the steps, and MIX_LANES = 2 neighbouring lanes share it
// by ec_add's slot machinery: the 11 products of madd-2007-bl in six rounds
// of up to two independent products,
//   {Z1^2} -> {u2, Z1 Z1Z1} -> {s2, h^2} -> {h hh, X1 hh} -> {r^2, Z1 h}
//   -> {r (v - x3), Y1 hhh},
// with the subtractions for h, r, x3 and v - x3 between them.  The doubling
// of the carry (7 products), which k_ec_add_mixed computes in every lane
// and selects where q == carry, is computed only where it is selected (h ==
// 0 and r == 0, the same in both lanes of a carry), by ec.cuh's ec_double in
// each of the two lanes: no barrier in that branch, which a warp takes only
// at a step where one of its carries equals the row it meets (a lane whose
// rows open on a point twice).  Then both lanes run k_ec_add_mixed's selects
// in its order
// (doubling, inverse, q identity, p identity, both) on the carry and the
// step's point read into registers at the step's start; lane 0 writes x and
// y of the new carry, lane 1 z, to their slots and to the inner prefixes.
// Two lanes and not four: the madd chain has at most three products a
// round, so four lanes would leave their product slots idle or give them to
// the doubling, and at a 2^20 window (g = 16,384, w = 64) the scan is bound
// by the instructions those slots take, not by its chain (PERF.md).  Every
// value is that of ec_add_mixed_plain, fully reduced, so every output equals
// the plain version's limb for limb.  The
// next step's row and mask byte are loaded into registers while a step
// runs.  Spare carries of a ragged last block walk carry g - 1 and store
// nothing.

#define MIX_LANES 2
#define MIX_BLOCK 64
#define MIX_CARRIES (MIX_BLOCK / MIX_LANES)

enum MixedSlot {
  MX_X1, MX_Y1, MX_Z1,  // the carry
  MX_QX, MX_QY,         // the step's affine point
  MX_Z1Z1, MX_U2, MX_Z1C, MX_H, MX_S2, MX_HH, MX_R, MX_HHH, MX_V, MX_RR, MX_Z3, MX_X3, MX_VX,
  MX_RY, MX_SH,
  MX_SINK,              // where lane 1 writes when it has no product
  MIXED_SLOTS
};
#define MIXED_STRIDE (2 * MIXED_SLOTS + 1)

__global__ void __launch_bounds__(MIX_BLOCK)
ec_add_mixed_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                    const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                    const uint8_t* __restrict__ q_ident, int w, int64_t g,
                    uint32_t* ix, uint32_t* iy, uint32_t* iz,
                    uint32_t* tx, uint32_t* ty, uint32_t* tz) {
  __shared__ uint4 mixed_sm[MIX_CARRIES * MIXED_STRIDE];
  const int lane = threadIdx.x % MIX_LANES;
  const int64_t j = (int64_t)blockIdx.x * MIX_CARRIES + threadIdx.x / MIX_LANES;
  const int64_t src = j < g ? j : g - 1;
  uint4* sc = mixed_sm + (threadIdx.x / MIX_LANES) * MIXED_STRIDE;
  // lane 0 loads and writes x and y, lane 1 z (and reads the qy rows)
  slot_store(sc, lane == 0 ? MX_X1 : MX_Z1,
             fe_load((lane == 0 ? x1 : z1) + src * ELEMS_PER_ROW));
  if (lane == 0) slot_store(sc, MX_Y1, fe_load(y1 + src * ELEMS_PER_ROW));
  const uint32_t* qrow = (lane == 0 ? qx : qy) + src * w * ELEMS_PER_ROW;
  const uint8_t* qid = q_ident + src * w;
  uint32_t* inner1 = (lane == 0 ? ix : iz) + src * w * ELEMS_PER_ROW;
  uint32_t* inner2 = iy + src * w * ELEMS_PER_ROW;
  const Fe one = fe_one(P);
  Jac ident;
  ident.x = one;
  ident.y = one;
  ident.z = fe_zero();
  Fe q = fe_load(qrow);
  bool q_next = qid[0] != 0;
  Jac o;
#pragma unroll 1
  for (int t = 0; t < w; t++) {
    // the barrier after this store also ends the step before, whose last
    // round wrote the carry
    slot_store(sc, MX_QX + lane, q);
    const bool q_id = q_next;
    __syncwarp();
    if (t + 1 < w) {
      q = fe_load(qrow + (int64_t)(t + 1) * ELEMS_PER_ROW);
      q_next = qid[t + 1] != 0;
    }
    // the carry and the step's point in registers: the last round writes
    // their slots while the other lane may still be reading
    Jac p, qa;
    p.x = slot_load(sc, MX_X1);
    p.y = slot_load(sc, MX_Y1);
    p.z = slot_load(sc, MX_Z1);
    qa.x = slot_load(sc, MX_QX);
    qa.y = slot_load(sc, MX_QY);
    qa.z = one;
    // Lane:                            0         1
    slot_mul_round(sc, lane, LANES2(MX_Z1, MX_Z1), LANES2(MX_Z1, MX_Z1),
                   LANES2(MX_Z1Z1, MX_SINK), P);
    slot_mul_round(sc, lane, LANES2(MX_QX, MX_Z1), LANES2(MX_Z1Z1, MX_Z1Z1),
                   LANES2(MX_U2, MX_Z1C), P);
    slot_lin_round(sc, lane, LANES2(MX_U2, MX_X1), LANES2(MX_X1, MX_X1),
                   LANES2(MX_H, MX_SINK), 0x1u, P);
    slot_mul_round(sc, lane, LANES2(MX_QY, MX_H), LANES2(MX_Z1C, MX_H), LANES2(MX_S2, MX_HH), P);
    slot_lin_round(sc, lane, LANES2(MX_S2, MX_X1), LANES2(MX_Y1, MX_X1),
                   LANES2(MX_R, MX_SINK), 0x1u, P);
    slot_mul_round(sc, lane, LANES2(MX_H, MX_X1), LANES2(MX_HH, MX_HH), LANES2(MX_HHH, MX_V), P);
    slot_mul_round(sc, lane, LANES2(MX_R, MX_Z1), LANES2(MX_R, MX_H), LANES2(MX_RR, MX_Z3), P);
    {
      // x3 = (r^2 - hhh) - 2v and v - x3, the same body in both lanes
      const Fe v = slot_load(sc, MX_V);
      const Fe x3 = fe_sub(fe_sub(slot_load(sc, MX_RR), slot_load(sc, MX_HHH), P),
                           fe_double(v, P), P);
      slot_store(sc, lane == 0 ? MX_X3 : MX_VX, fe_select(lane == 0, x3, fe_sub(v, x3, P)));
      __syncwarp();
    }
    slot_mul_round(sc, lane, LANES2(MX_R, MX_Y1), LANES2(MX_VX, MX_HHH),
                   LANES2(MX_RY, MX_SH), P);
    // the new carry, the same body in both lanes: the generic sum, the
    // doubling where it is taken (h == 0 and r == 0: both lanes agree), then
    // k_ec_add_mixed's selects in its order
    const bool h0 = fe_is_zero(slot_load(sc, MX_H));
    const bool r0 = fe_is_zero(slot_load(sc, MX_R));
    const bool id1 = fe_is_zero(p.z);
    o.x = slot_load(sc, MX_X3);
    o.y = fe_sub(slot_load(sc, MX_RY), slot_load(sc, MX_SH), P);
    o.z = slot_load(sc, MX_Z3);
    if (h0 && r0) o = ec_double(p, P);
    o = jac_select(h0 && !r0, ident, o);
    o = jac_select(q_id && !id1, p, o);
    o = jac_select(id1 && !q_id, qa, o);
    o = jac_select(id1 && q_id, ident, o);
    slot_store(sc, lane == 0 ? MX_X1 : MX_Z1, lane == 0 ? o.x : o.z);
    if (lane == 0) slot_store(sc, MX_Y1, o.y);
    if (j < g) {
      fe_store(inner1 + (int64_t)t * ELEMS_PER_ROW, lane == 0 ? o.x : o.z);
      if (lane == 0) fe_store(inner2 + (int64_t)t * ELEMS_PER_ROW, o.y);
    }
  }
  if (j < g && tx != nullptr) {
    fe_store((lane == 0 ? tx : tz) + j * ELEMS_PER_ROW, lane == 0 ? o.x : o.z);
    if (lane == 0) fe_store(ty + j * ELEMS_PER_ROW, o.y);
  }
}

// ---- 9. ec_add_mixed_fast: replaces pallas_ff.ec_add_mixed_fast -----------------
//
// Replaces pallas_ff.py:664 ec_add_mixed_fast (its body k_ec_madd_fast): the
// Jacobian + affine add with no exceptional path of the entry point
// EC.add_mixed_fast, 3 squarings and 8 products on 5 rows in, 3 rows and a
// flag byte out, called at 2^20 points.  Its bound is the bytes' (513 an
// element; the 11 products, counted at the card's int32 rate, take a third
// of that), but fe_mul issues several instructions for each multiply-add it
// is counted at (64-bit sums of 32-bit words), one chain of them a product,
// so the products take the time: their chain at a few thousand points, their
// instructions at 2^20 (stages_small and batch_inv show the same).
//
// One thread a point, its rows read and written in place (four 16-byte
// accesses a row) and the whole formula in registers (ec.cuh's
// ec_add_mixed_fast, k_ec_madd_fast's select: the affine identity passes the
// carry through unflagged).  The flag is one byte 0 or 1 a point, written
// into the wrapper's bool tensor.  Two other designs lost to this one at
// 2^16 and 2^20 (PERF.md row 9): one thread a point with its rows staged
// through shared memory by coalesced copies, and two lanes a point on
// staged rows (five rounds of two products); the access pattern is not what
// holds it.

__global__ void __launch_bounds__(BLOCK)
ec_add_mixed_fast_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1,
                         const uint32_t* z1, const uint32_t* qx, const uint32_t* qy,
                         uint32_t* ox, uint32_t* oy, uint32_t* oz, uint8_t* exc, int64_t n) {
  int64_t i = global_index();
  if (i >= n) return;
  bool e;
  Jac r = ec_add_mixed_fast(jac_load(x1, y1, z1, i), fe_load(qx + i * ELEMS_PER_ROW),
                            fe_load(qy + i * ELEMS_PER_ROW), P, &e);
  jac_store(ox, oy, oz, i, r);
  exc[i] = e ? 1 : 0;
}

// ---- C launchers ------------------------------------------------------------

extern "C" {

int mont_mul_launch(const FieldParams* P, const void* a, const void* b, void* out,
                    int64_t n, void* stream) {
  if (n > 0)
    mont_mul_kernel<<<grid_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// e: the exponent p - 2 as 8 words of 32 bits; chain_len: L, the rows a
// chain at most (chains = ceil(n / L)).
int batch_inv_launch(const FieldParams* P, const uint32_t* e, const void* a, void* out,
                     int64_t n, int chain_len, void* stream) {
  if (n > 0 && chain_len > 0) {
    PowExp pe;
    for (int k = 0; k < FE_WORDS; k++) pe.w[k] = e[k];
    const int64_t chains = (n + chain_len - 1) / chain_len;
    batch_inv_kernel<<<grid_for(chains, INV_BLOCK), INV_BLOCK, 0, (cudaStream_t)stream>>>(
        *P, pe, (const uint32_t*)a, (uint32_t*)out, n, chains, chain_len);
  }
  return (int)cudaGetLastError();
}

int mont_addsub_launch(const FieldParams* P, int is_sub, const void* a, const void* b,
                       void* out, int64_t n, void* stream) {
  if (n > 0)
    mont_addsub_kernel<<<grid_for(n, BLOCK / ADDSUB_LANES), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, is_sub, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int ec_add_launch(const FieldParams* P, const void* x1, const void* y1, const void* z1,
                  const void* x2, const void* y2, const void* z2,
                  void* ox, void* oy, void* oz, int64_t n, void* stream) {
  if (n > 0)
    ec_add_kernel<<<grid_for(n, ADD_PTS), ADD_BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

int ec_add_fast_launch(const FieldParams* P, const void* x1, const void* y1, const void* z1,
                       const void* x2, const void* y2, const void* z2,
                       void* ox, void* oy, void* oz, void* exc, int64_t n, void* stream) {
  if (n > 0)
    ec_add_fast_kernel<<<grid_for(n, ADD_PTS), ADD_BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)exc, n);
  return (int)cudaGetLastError();
}

// k >= 0 doublings of each point.
int ec_double_launch(const FieldParams* P, const void* x1, const void* y1, const void* z1,
                     void* ox, void* oy, void* oz, int64_t n, int k, void* stream) {
  if (n > 0)
    ec_double_kernel<<<grid_for(n, ADD_PTS), ADD_BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, k);
  return (int)cudaGetLastError();
}

// tx, ty: the blinding point's Montgomery coordinates as 8 words of 32 bits.
static inline void words_to_fe(const uint32_t* words, Fe* f) {
  for (int k = 0; k < FE_WORDS; k++) f->v[k] = words[k];
}

int fused_madd_scan_xyzz_launch(const FieldParams* P, const uint32_t* tx, const uint32_t* ty,
                                const void* rows, int w, int64_t g,
                                void* ix, void* iy, void* izz, void* izzz,
                                void* totx, void* toty, void* totzz, void* totzzz,
                                void* exc, void* stream) {
  if (g > 0 && w > 0) {
    Fe fx, fy;
    words_to_fe(tx, &fx);
    words_to_fe(ty, &fy);
    fused_madd_scan_xyzz_kernel<<<grid_for(g, SCAN_CARRIES), SCAN_BLOCK, 0,
                                  (cudaStream_t)stream>>>(
        *P, fx, fy, (const uint32_t*)rows, w, g,
        (uint32_t*)ix, (uint32_t*)iy, (uint32_t*)izz, (uint32_t*)izzz,
        (uint32_t*)totx, (uint32_t*)toty, (uint32_t*)totzz, (uint32_t*)totzzz,
        (uint8_t*)exc);
  }
  return (int)cudaGetLastError();
}

// x1, y1, zz1, zzz1: (g, 16) XYZZ carries; qx, qy: (g * w, 16) affine rows,
// carry j's steps at rows j w .. j w + w - 1; -> the inner prefixes ix, iy,
// izz, izzz (g * w, 16), unless tx is null the totals tx, ty, tzz, tzzz (g,
// 16), and a flag byte a carry.
int ec_madd_xyzz_fast_launch(const FieldParams* P, const void* x1, const void* y1,
                             const void* zz1, const void* zzz1, const void* qx,
                             const void* qy, int w, int64_t g, void* ix, void* iy, void* izz,
                             void* izzz, void* tx, void* ty, void* tzz, void* tzzz, void* exc,
                             void* stream) {
  if (g > 0 && w > 0)
    ec_madd_xyzz_fast_kernel<<<grid_for(g, ADD_PTS), ADD_BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)zz1,
        (const uint32_t*)zzz1, (const uint32_t*)qx, (const uint32_t*)qy, w, g,
        (uint32_t*)ix, (uint32_t*)iy, (uint32_t*)izz, (uint32_t*)izzz,
        (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tzz, (uint32_t*)tzzz, (uint8_t*)exc);
  return (int)cudaGetLastError();
}

// x1, y1, z1: (g, 16) carries; qx, qy: (g * w, 16) rows and q_ident (g * w)
// bytes, carry j's steps at rows j w .. j w + w - 1; -> the inner prefixes
// ix, iy, iz (g * w, 16) and, unless tx is null, the totals tx, ty, tz (g, 16).
int ec_add_mixed_launch(const FieldParams* P, const void* x1, const void* y1,
                        const void* z1, const void* qx, const void* qy,
                        const void* q_ident, int w, int64_t g, void* ix, void* iy, void* iz,
                        void* tx, void* ty, void* tz, void* stream) {
  if (g > 0 && w > 0)
    ec_add_mixed_kernel<<<grid_for(g, MIX_CARRIES), MIX_BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)qx, (const uint32_t*)qy, (const uint8_t*)q_ident, w, g,
        (uint32_t*)ix, (uint32_t*)iy, (uint32_t*)iz,
        (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz);
  return (int)cudaGetLastError();
}

int ec_add_mixed_fast_launch(const FieldParams* P, const void* x1, const void* y1,
                             const void* z1, const void* qx, const void* qy,
                             void* ox, void* oy, void* oz, void* exc, int64_t n,
                             void* stream) {
  if (n > 0)
    ec_add_mixed_fast_kernel<<<grid_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)qx, (const uint32_t*)qy,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)exc, n);
  return (int)cudaGetLastError();
}

// a_stride, b_stride: rows from one pair's operand to the next's (0: one
// operand for all pairs); group: pairs a block of `threads` (at most
// PMUL_MAX_THREADS); staged: 0 reads the rows from device memory (the
// wrapper's choice where a pair's rows exceed the block's shared memory);
// lazy: the second design's instantiation (two outputs a thread) or the
// first's (one).
static inline size_t pmul_smem(int la, int lb, int64_t a_stride, int64_t b_stride, int group,
                               int staged) {
  return staged ? (size_t)8 * sizeof(uint32_t) *
      ((a_stride ? group * la : la) + (b_stride ? group * lb : lb)) : 0;
}

static inline double pmul_inv_p_hi(const FieldParams* P) {
  return 1.0 / ((double)P->p[FE_WORDS - 1] + 1.0);
}

int poly_mul_naive_launch(const FieldParams* P, const void* a, const void* b, void* out,
                          int64_t pairs, int la, int lb, int64_t a_stride, int64_t b_stride,
                          int group, int threads, int staged, int lazy, void* stream) {
  if (pairs > 0 && la > 0 && lb > 0 && group > 0) {
    const size_t smem = pmul_smem(la, lb, a_stride, b_stride, group, staged);
    auto* kern = lazy ? &poly_mul_naive_kernel<true> : &poly_mul_naive_kernel<false>;
    kern<<<grid_for(pairs, group), threads, smem, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, pairs, la, lb,
        a_stride, b_stride, group, staged, pmul_inv_p_hi(P));
  }
  return (int)cudaGetLastError();
}

// b_stride: rows from one pair's b to the next's (0: one b for all pairs).
int kate_div_launch(const FieldParams* P, const void* c, const void* b, void* out,
                    int64_t pairs, int n, int64_t b_stride, void* stream) {
  if (pairs > 0 && n > 0)
    kate_div_kernel<<<grid_for(pairs, KDIV_PAIRS), KDIV_PAIRS, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)c, (const uint32_t*)b, (uint32_t*)out, pairs, n, b_stride);
  return (int)cudaGetLastError();
}

// ra_stride, rb_stride: rows from one pair's root to the next's (0: one root
// for all pairs).
int kate_div2_launch(const FieldParams* P, const void* c, const void* ra, const void* rb,
                     void* out, int64_t pairs, int n, int64_t ra_stride, int64_t rb_stride,
                     void* stream) {
  if (pairs > 0 && n > 0)
    kate_div2_kernel<<<grid_for(2 * pairs, KDIV2_BLOCK), KDIV2_BLOCK, 0,
                       (cudaStream_t)stream>>>(
        *P, (const uint32_t*)c, (const uint32_t*)ra, (const uint32_t*)rb, (uint32_t*)out, pairs,
        n, ra_stride, rb_stride);
  return (int)cudaGetLastError();
}

// x, y, zinv: (3, n) rows, the three points of each slot; out: (7, n) rows
// (head) or (3, n) (seeds); flags: (2, n) bytes, written in head mode only.
int affine_lines_launch(const FieldParams* P, const void* x, const void* y, const void* zinv,
                        void* out, void* flags, int64_t n, int head, void* stream) {
  if (n > 0)
    affine_lines_kernel<<<grid_for(LINES_LANES * n, LINES_BLOCK), LINES_BLOCK, 0,
                          (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)zinv, (uint32_t*)out,
        (uint8_t*)flags, n, head);
  return (int)cudaGetLastError();
}

// The first design, for the A/B: the same arguments.
int affine_lines_v1_launch(const FieldParams* P, const void* x, const void* y, const void* zinv,
                           void* out, void* flags, int64_t n, int head, void* stream) {
  if (n > 0)
    affine_lines_v1_kernel<<<grid_for(n, LINES_BLOCK), LINES_BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)zinv, (uint32_t*)out,
        (uint8_t*)flags, n, head);
  return (int)cudaGetLastError();
}

}  // extern "C"
