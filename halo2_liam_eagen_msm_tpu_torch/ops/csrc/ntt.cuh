// The five kernels of the divisor merge tree's evaluation-domain tail and
// their C launchers: the counterparts of the JAX package's ops/pallas_ntt.py
// (lm_mul, lm_addsub, lm_mul_const, _stage_big, _stages_small).  Included by
// kernels.cu after BLOCK, grid_for and global_index.
//
// Layout: an array of E field elements is a (16, E) limb-major tensor, limb
// i of element e at [i * E + e] (structure of arrays).  A warp reading limb i
// of 32 neighbouring elements reads 128 contiguous bytes.  There is no
// padding and no tiling: the TPU's (16, nb, 8, 128) blocks exist for its
// vector registers.  A transform of a (pairs, n) batch runs over the flat
// order e = pair * n + j; every butterfly partner e ^ s stays inside its
// transform because s < n.
//
// What bounds them on this card: the pointwise kernels move 3 rows (2 for
// the constant product) of 64 bytes an element for one product or add, so
// bytes; so do the butterfly stages (2 rows in and out, half a product an
// element).  Each thread repacks its element to 8 words of 32 bits in
// registers (ff.cuh) and touches device memory once per input and output
// word.  stages_small keeps a whole tile of up to 1024 elements in shared
// memory for all its stages, so those stages cost the card one read and one
// write of the array together.
#pragma once
#include "ff.cuh"

#define SMALL_TILE 1024  // elements of one stages_small tile (32 KB of shared memory)

// Twiddles: the flat stage-major table of ops/ntt._twiddle_flat_host, kept
// limb-major (16, n - 1) with row stride tw_stride: the stage of half-size s
// (m = 2s) occupies columns [s - 1, 2s - 1), and pair element j uses column
// s - 1 + (j & (s - 1)).
__device__ __forceinline__ Fe stage_twiddle(const uint32_t* __restrict__ tw, int64_t tw_stride,
                                            int64_t s, int64_t j) {
  return fe_load_limb_major(tw + (s - 1) + (j & (s - 1)), tw_stride);
}

// One radix-2 butterfly: forward DIF (x0 + x1, tw (x0 - x1)), inverse DIT
// (x0 + tw x1, x0 - tw x1); ops/ntt.ntt_dif / intt_dit's network.
__device__ __forceinline__ void butterfly(int inverse, Fe& x0, Fe& x1, const Fe& tw,
                                          const FieldParams& P) {
  if (!inverse) {
    Fe d = fe_sub(x0, x1, P);
    x0 = fe_add(x0, x1, P);
    x1 = fe_mul(tw, d, P);
  } else {
    Fe t = fe_mul(tw, x1, P);
    x1 = fe_sub(x0, t, P);
    x0 = fe_add(x0, t, P);
  }
}

// ---- 10. lm_mul: replaces pallas_ntt.lm_mul ------------------------------------

__global__ void __launch_bounds__(BLOCK)
lm_mul_kernel(FieldParams P, const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              uint32_t* __restrict__ out, int64_t e) {
  int64_t i = global_index();
  if (i >= e) return;
  fe_store_limb_major(out + i, e,
                      fe_mul(fe_load_limb_major(a + i, e), fe_load_limb_major(b + i, e), P));
}

// ---- 11. lm_addsub: replaces pallas_ntt.lm_addsub --------------------------------

__global__ void __launch_bounds__(BLOCK)
lm_addsub_kernel(FieldParams P, int is_sub, const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t* __restrict__ out, int64_t e) {
  int64_t i = global_index();
  if (i >= e) return;
  Fe x = fe_load_limb_major(a + i, e);
  Fe y = fe_load_limb_major(b + i, e);
  fe_store_limb_major(out + i, e, is_sub ? fe_sub(x, y, P) : fe_add(x, y, P));
}

// ---- 12. lm_mul_const: replaces pallas_ntt.lm_mul_const ---------------------------
//
// The constant (a Montgomery-form value, 8 words) comes by value in the
// kernel's parameters, beside FieldParams: no operand array is read.

__global__ void __launch_bounds__(BLOCK)
lm_mul_const_kernel(FieldParams P, Fe c, const uint32_t* __restrict__ a,
                    uint32_t* __restrict__ out, int64_t e) {
  int64_t i = global_index();
  if (i >= e) return;
  fe_store_limb_major(out + i, e, fe_mul(fe_load_limb_major(a + i, e), c, P));
}

// ---- 13. stage_big: replaces pallas_ntt._stage_big --------------------------------
//
// One butterfly stage of half-size s (the TPU kernel takes s >= 1024; this
// one takes any power of two s with 2s dividing e).  One thread per pair
// (e0, e0 + s), e0 with bit s clear: it reads both inputs once and writes
// both outputs (the TPU reads both blocks for each output block).

__global__ void __launch_bounds__(BLOCK)
stage_big_kernel(FieldParams P, int inverse, const uint32_t* __restrict__ x,
                 uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
                 int64_t tw_stride, int64_t s, int log_s, int64_t e) {
  int64_t t = global_index();
  if (t >= e / 2) return;
  int64_t j = t & (s - 1);
  int64_t e0 = ((t >> log_s) << (log_s + 1)) + j;
  Fe x0 = fe_load_limb_major(x + e0, e);
  Fe x1 = fe_load_limb_major(x + e0 + s, e);
  butterfly(inverse, x0, x1, stage_twiddle(tw, tw_stride, s, j), P);
  fe_store_limb_major(out + e0, e, x0);
  fe_store_limb_major(out + e0 + s, e, x1);
}

// ---- 14. stages_small: replaces pallas_ntt._stages_small --------------------------
//
// Every stage with s <= tile / 2 in one launch: forward s = tile/2 ... 1,
// inverse 1 ... tile/2, where tile = min(n, 1024) and tile divides e.  A
// block owns one aligned tile (every partner e ^ s, s < tile, lies in it;
// for n < 1024 the tile is one whole transform) and keeps it in shared memory
// as 8 words of 32 bits an element, word-major so that neighbouring threads
// touch neighbouring banks: 32 KB, under the 48 KB of static shared memory.
// One thread per pair, tile / 2 threads, __syncthreads() between stages.
// The TPU kernel multiplies the forward x0 lanes by the Montgomery one to
// stay branch-free; that leaves a fully reduced value unchanged, and every
// input on this path is fully reduced, so this kernel skips the product.

__global__ void __launch_bounds__(SMALL_TILE / 2)
stages_small_kernel(FieldParams P, int inverse, const uint32_t* __restrict__ x,
                    uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
                    int64_t tw_stride, int tile, int64_t e) {
  __shared__ uint32_t sm[FE_WORDS][SMALL_TILE];
  const int half = tile / 2;
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * tile;
  for (int r = 0; r < 2; r++) {
    int i = t + r * half;
    Fe a = fe_load_limb_major(x + base + i, e);
#pragma unroll
    for (int k = 0; k < FE_WORDS; k++) sm[k][i] = a.v[k];
  }
  __syncthreads();
  for (int s = inverse ? 1 : half; s >= 1 && s <= half; s = inverse ? 2 * s : s / 2) {
    int j = t & (s - 1);
    int i0 = ((t - j) << 1) + j;
    Fe x0, x1;
#pragma unroll
    for (int k = 0; k < FE_WORDS; k++) {
      x0.v[k] = sm[k][i0];
      x1.v[k] = sm[k][i0 + s];
    }
    butterfly(inverse, x0, x1, stage_twiddle(tw, tw_stride, s, j), P);
#pragma unroll
    for (int k = 0; k < FE_WORDS; k++) {
      sm[k][i0] = x0.v[k];
      sm[k][i0 + s] = x1.v[k];
    }
    __syncthreads();
  }
  for (int r = 0; r < 2; r++) {
    int i = t + r * half;
    Fe a;
#pragma unroll
    for (int k = 0; k < FE_WORDS; k++) a.v[k] = sm[k][i];
    fe_store_limb_major(out + base + i, e, a);
  }
}

// ---- C launchers ------------------------------------------------------------

extern "C" {

int lm_mul_launch(const FieldParams* P, const void* a, const void* b, void* out,
                  int64_t e, void* stream) {
  if (e > 0)
    lm_mul_kernel<<<grid_for(e, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, e);
  return (int)cudaGetLastError();
}

int lm_addsub_launch(const FieldParams* P, int is_sub, const void* a, const void* b,
                     void* out, int64_t e, void* stream) {
  if (e > 0)
    lm_addsub_kernel<<<grid_for(e, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, is_sub, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, e);
  return (int)cudaGetLastError();
}

// c: the constant's Montgomery form as 8 words of 32 bits.
int lm_mul_const_launch(const FieldParams* P, const uint32_t* c, const void* a, void* out,
                        int64_t e, void* stream) {
  if (e > 0) {
    Fe cv;
    for (int k = 0; k < FE_WORDS; k++) cv.v[k] = c[k];
    lm_mul_const_kernel<<<grid_for(e, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, cv, (const uint32_t*)a, (uint32_t*)out, e);
  }
  return (int)cudaGetLastError();
}

// s: the stage's half-size, a power of two with 2s dividing e.
int stage_big_launch(const FieldParams* P, int inverse, const void* x, void* out,
                     const void* tw, int64_t tw_stride, int64_t s, int64_t e, void* stream) {
  int log_s = 0;
  while (((int64_t)1 << log_s) < s) log_s++;
  if (e > 0)
    stage_big_kernel<<<grid_for(e / 2, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, inverse, (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, tw_stride, s,
        log_s, e);
  return (int)cudaGetLastError();
}

// tile: min(n, 1024), a power of two >= 2 dividing e.
int stages_small_launch(const FieldParams* P, int inverse, const void* x, void* out,
                        const void* tw, int64_t tw_stride, int tile, int64_t e, void* stream) {
  if (e > 0)
    stages_small_kernel<<<(unsigned int)(e / tile), tile / 2, 0, (cudaStream_t)stream>>>(
        *P, inverse, (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, tw_stride, tile,
        e);
  return (int)cudaGetLastError();
}

}  // extern "C"
