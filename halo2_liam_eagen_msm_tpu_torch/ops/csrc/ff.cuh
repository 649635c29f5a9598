// Prime-field arithmetic for the CUDA kernels: the device-side counterpart of
// the in-kernel limb library of the JAX package (ops/pallas_ff.py: _mul_cols,
// _sqr_cols, _mont_reduce, k_cond_sub_p, k_add, k_sub).
//
// Tensors keep the package's public layout: one field element is a row of 16
// little-endian 16-bit limbs, one limb per 32-bit word, Montgomery form with
// R = 2^256, fully reduced to [0, p).  That layout exists because the JAX
// package's target has no 32x32->64 multiply.  This card has one, so a row is
// repacked to 8 limbs of 32 bits in registers on load, multiplied with a
// word-serial (CIOS) Montgomery product with n0 = -p^-1 mod 2^32, and unpacked
// on store.  Results are fully reduced, so they are bit-identical to the
// 16-bit formulation whatever the limb width.
//
// Works for any prime p < 2^255 (every field of fields.py): then a CIOS
// result and a sum of two reduced values are both < 2p < 2^256 and need one
// conditional subtraction.
#pragma once
#include <stdint.h>

#define FE_WORDS 8

struct FieldParams {
  uint32_t p[FE_WORDS];    // modulus
  uint32_t one[FE_WORDS];  // R mod p, the Montgomery form of 1
  uint32_t n0;             // -p^-1 mod 2^32
};

struct Fe {
  uint32_t v[FE_WORDS];
};

// ---- load / store ----------------------------------------------------------

// One (16,) row of 16-bit limbs, 64 bytes, read as four 16-byte loads.
__device__ __forceinline__ Fe fe_load(const uint32_t* __restrict__ row) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  Fe a;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint4 q = r4[k];
    a.v[2 * k] = (q.x & 0xFFFFu) | (q.y << 16);
    a.v[2 * k + 1] = (q.z & 0xFFFFu) | (q.w << 16);
  }
  return a;
}

__device__ __forceinline__ void fe_store(uint32_t* __restrict__ row, const Fe& a) {
  uint4* r4 = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint4 q;
    q.x = a.v[2 * k] & 0xFFFFu;
    q.y = a.v[2 * k] >> 16;
    q.z = a.v[2 * k + 1] & 0xFFFFu;
    q.w = a.v[2 * k + 1] >> 16;
    r4[k] = q;
  }
}

// Eight words that already hold two 16-bit limbs each (the packed rows of
// ops/msm._pack_pair): no repacking, two 16-byte loads.
__device__ __forceinline__ Fe fe_load_packed(const uint32_t* __restrict__ half_row) {
  const uint4* r4 = reinterpret_cast<const uint4*>(half_row);
  uint4 lo = r4[0], hi = r4[1];
  Fe a;
  a.v[0] = lo.x; a.v[1] = lo.y; a.v[2] = lo.z; a.v[3] = lo.w;
  a.v[4] = hi.x; a.v[5] = hi.y; a.v[6] = hi.z; a.v[7] = hi.w;
  return a;
}

// The twin of fe_load_packed: eight words, two 16-byte stores.
__device__ __forceinline__ void fe_store_packed(uint32_t* __restrict__ half_row, const Fe& a) {
  uint4* r4 = reinterpret_cast<uint4*>(half_row);
  uint4 lo, hi;
  lo.x = a.v[0]; lo.y = a.v[1]; lo.z = a.v[2]; lo.w = a.v[3];
  hi.x = a.v[4]; hi.y = a.v[5]; hi.z = a.v[6]; hi.w = a.v[7];
  r4[0] = lo;
  r4[1] = hi;
}

// Limb-major store: limb j of this element goes to base[j * stride], so that
// neighbouring threads (stride = number of lanes) write neighbouring words.
__device__ __forceinline__ void fe_store_limb_major(uint32_t* __restrict__ base,
                                                    int64_t stride, const Fe& a) {
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) {
    base[(2 * k) * stride] = a.v[k] & 0xFFFFu;
    base[(2 * k + 1) * stride] = a.v[k] >> 16;
  }
}

// Limb-major load, the twin of the store above: limb j of this element at
// base[j * stride].
__device__ __forceinline__ Fe fe_load_limb_major(const uint32_t* __restrict__ base,
                                                 int64_t stride) {
  Fe a;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++)
    a.v[k] = (base[(2 * k) * stride] & 0xFFFFu) | (base[(2 * k + 1) * stride] << 16);
  return a;
}

// ---- predicates / selects ----------------------------------------------------

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) acc |= a.v[k];
  return acc == 0;
}

__device__ __forceinline__ Fe fe_select(bool m, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) r.v[k] = m ? a.v[k] : b.v[k];
  return r;
}

// Lane src's element, within groups of `width` neighbouring lanes (every
// lane of the warp takes part): eight word shuffles.
__device__ __forceinline__ Fe fe_shfl(const Fe& a, int src, int width) {
  Fe r;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) r.v[k] = __shfl_sync(0xFFFFFFFFu, a.v[k], src, width);
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) r.v[k] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one(const FieldParams& P) {
  Fe r;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) r.v[k] = P.one[k];
  return r;
}

// ---- add / sub -------------------------------------------------------------

// a < 2p  ->  a mod p
__device__ __forceinline__ Fe fe_cond_sub_p(const Fe& a, const FieldParams& P) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) {
    uint64_t s = (uint64_t)a.v[k] - (uint64_t)P.p[k] - borrow;
    d.v[k] = (uint32_t)s;
    borrow = s >> 63;
  }
  return fe_select(borrow == 0, d, a);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldParams& P) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) {
    c += (uint64_t)a.v[k] + (uint64_t)b.v[k];
    s.v[k] = (uint32_t)c;
    c >>= 32;
  }
  return fe_cond_sub_p(s, P);  // a + b < 2p < 2^256: no carry out
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldParams& P) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) {
    uint64_t s = (uint64_t)a.v[k] - (uint64_t)b.v[k] - borrow;
    d.v[k] = (uint32_t)s;
    borrow = s >> 63;
  }
  // add p back on underflow (the carry out of that sum is dropped)
  Fe dp;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) {
    c += (uint64_t)d.v[k] + (uint64_t)P.p[k];
    dp.v[k] = (uint32_t)c;
    c >>= 32;
  }
  return fe_select(borrow != 0, dp, d);
}

__device__ __forceinline__ Fe fe_double(const Fe& a, const FieldParams& P) {
  return fe_add(a, a, P);
}

// ---- Montgomery product ------------------------------------------------------

// a * b * R^-1 mod p, word-serial (CIOS, Koc-Acar-Kaliski) over 8 words.
// Every partial sum a*b + t + c fits 64 bits exactly.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, const FieldParams& P) {
  uint32_t t[FE_WORDS + 2];
#pragma unroll
  for (int k = 0; k < FE_WORDS + 2; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_WORDS; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FE_WORDS; j++) {
      uint64_t s = (uint64_t)a.v[j] * (uint64_t)b.v[i] + (uint64_t)t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[FE_WORDS] + c;
    t[FE_WORDS] = (uint32_t)s;
    t[FE_WORDS + 1] = (uint32_t)(s >> 32);

    uint32_t m = t[0] * P.n0;
    s = (uint64_t)m * (uint64_t)P.p[0] + (uint64_t)t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < FE_WORDS; j++) {
      s = (uint64_t)m * (uint64_t)P.p[j] + (uint64_t)t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[FE_WORDS] + c;
    t[FE_WORDS - 1] = (uint32_t)s;
    t[FE_WORDS] = t[FE_WORDS + 1] + (uint32_t)(s >> 32);
  }
  // p < 2^255 and a, b < p: the result is < 2p < 2^256, so t[8] == 0
  Fe r;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) r.v[k] = t[k];
  return fe_cond_sub_p(r, P);
}

__device__ __forceinline__ Fe fe_sqr(const Fe& a, const FieldParams& P) {
  return fe_mul(a, a, P);
}

// ---- fixed-exponent power ------------------------------------------------------

// A fixed exponent by value, 8 words of 32 bits, little-endian.
struct PowExp {
  uint32_t w[FE_WORDS];
};

#define POW_WINDOW 4
#define POW_ODD (1 << (POW_WINDOW - 1))  // a, a^3, ..., a^15

__device__ __forceinline__ uint32_t exp_bit(const PowExp& e, int i) {
  return (e.w[i >> 5] >> (i & 31)) & 1u;
}

// a^e for e > 0: left-to-right sliding windows of up to POW_WINDOW bits over
// the odd powers of a (ops/cuda_ff.pow_schedule is the same walk, and counts
// its products).  Every thread of a launch takes the same exponent, so the
// walk is the same for all of them and the warp does not diverge; only the
// table lookup is indexed at run time (local memory).
__device__ Fe fe_pow(const Fe& a, const PowExp& e, const FieldParams& P) {
  Fe odd[POW_ODD];
  odd[0] = a;
  const Fe a2 = fe_sqr(a, P);
#pragma unroll 1
  for (int k = 1; k < POW_ODD; k++) odd[k] = fe_mul(odd[k - 1], a2, P);
  int i = 32 * FE_WORDS - 1;
  while (i > 0 && !exp_bit(e, i)) i--;
  Fe acc = a;
  bool started = false;
#pragma unroll 1
  while (i >= 0) {
    if (!exp_bit(e, i)) {
      acc = fe_sqr(acc, P);
      i--;
      continue;
    }
    int j = i - (POW_WINDOW - 1);
    if (j < 0) j = 0;
    while (!exp_bit(e, j)) j++;
    uint32_t v = 0;
    for (int b = i; b >= j; b--) v = (v << 1) | exp_bit(e, b);
    if (started) {
#pragma unroll 1
      for (int b = i; b >= j; b--) acc = fe_sqr(acc, P);
      acc = fe_mul(acc, odd[v >> 1], P);
    } else {
      acc = odd[v >> 1];
      started = true;
    }
    i = j - 1;
  }
  return acc;
}
