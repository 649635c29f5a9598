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
// inverse 1 ... tile/2, where tile = min(n, 1024) and tile divides e.  Every
// partner e ^ s, s < tile, lies in the element's aligned tile (for n < 1024
// the tile is one whole transform), so a block keeps its tiles in shared
// memory for all the stages.  The TPU kernel multiplies the forward x0 lanes
// by the Montgomery one to stay branch-free; that leaves a fully reduced
// value unchanged, and every input on this path is fully reduced, so this
// kernel skips the product.
//
// Operations bound it (half a product and an add an element a stage), so its
// design keeps the multiplier busy:
//  - register blocking: a thread owns 2^R = 4 elements and runs R = 2 stages
//    on them in registers between exchanges through shared memory, with two
//    independent products a stage; the stages are cut into windows of R bits
//    from the bottom (the top window, where log2(tile) is odd, runs only its
//    upper stage), so ceil(log2(tile) / 2) barriers a launch.  R = 2 is what
//    measured fastest on the H100: 80 registers a thread, three blocks of 256
//    threads an SM (the launch bound asks for three).  R = 3 needs 146-187
//    registers, which leaves 12 warps an SM, and ran slower than the first
//    design (a butterfly a thread, __syncthreads() between stages); a
//    product by PTX carry chains (mad.lo.cc / madc.hi.cc) ran slower than
//    fe_mul's C, its chains being serial; a 1-bit window (R = 1)
//    is taken for the tile of 2 alone (one window): with the window loop
//    written as a count it equals the plain stages at every tile from 2 to
//    1024 both ways (chip_smoke.py holds it there in every run, through
//    the test-only launcher below), but no tile is routed to it;
//  - twiddles staged once a block: the tile - 1 columns of the limb-major
//    table, read coalesced and packed to 8 words in shared memory (reading
//    them from the table in each stage ran slower);
//  - no product by one: in the bottom window a butterfly's twiddle index j is
//    known when the kernel is compiled, and where j = 0 (ω^0, the Montgomery
//    one) the product is dropped, fe_mul(one, d) == d for a reduced d: every
//    butterfly of the s = 1 stage and half of s = 2, 768 of a 1024-tile's
//    5,120 products;
//  - a block holds SMALL_BLOCK_ELEMS elements, one tile or several small
//    ones, so the lowest levels (tiles of 128 to 512) run full blocks too; a
//    ragged last block computes its spare tiles on zeros and stores nothing.
// Shared memory (67,584 bytes a block, dynamic) is word-major (row w holds
// word w of every element) with one padding word every 32, so that the
// strided reads of the bottom window fall on distinct banks.

#define SMALL_BLOCK_ELEMS 1024
#define SMALL_ROW (SMALL_BLOCK_ELEMS + SMALL_BLOCK_ELEMS / 32)  // padded words a row
#define SMALL_R 2  // stages a thread runs in registers

__device__ __forceinline__ int small_pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ Fe small_load(const uint32_t* rows, int i) {
  Fe a;
  const int k = small_pad(i);
#pragma unroll
  for (int w = 0; w < FE_WORDS; w++) a.v[w] = rows[w * SMALL_ROW + k];
  return a;
}

__device__ __forceinline__ void small_store(uint32_t* rows, int i, const Fe& a) {
  const int k = small_pad(i);
#pragma unroll
  for (int w = 0; w < FE_WORDS; w++) rows[w * SMALL_ROW + k] = a.v[w];
}

// One window of R stage bits at bit b: the thread's elements are
// i0 + (k << b), k < 2^R; stages of bit b + m, m >= m_lo, run in registers.
template <int R, bool INV, bool BOTTOM>
__device__ __forceinline__ void small_window(const FieldParams& P, uint32_t* data,
                                             const uint32_t* twid, int t, int b, int m_lo) {
  const int bb = BOTTOM ? 0 : b;
  const int i0 = ((t >> bb) << (bb + R)) | (t & ((1 << bb) - 1));
  Fe v[1 << R];
#pragma unroll
  for (int k = 0; k < (1 << R); k++) v[k] = small_load(data, i0 + (k << bb));
#pragma unroll
  for (int mm = 0; mm < R; mm++) {
    const int m = INV ? mm : R - 1 - mm;
    if (m < m_lo) continue;
    const int s = 1 << (bb + m);
#pragma unroll
    for (int k = 0; k < (1 << R); k++) {
      if (k & (1 << m)) continue;
      const int j = BOTTOM ? (k & ((1 << m) - 1)) : ((i0 + (k << bb)) & (s - 1));
      if (BOTTOM && j == 0) {
        Fe d = fe_sub(v[k], v[k | (1 << m)], P);
        v[k] = fe_add(v[k], v[k | (1 << m)], P);
        v[k | (1 << m)] = d;
      } else {
        butterfly(INV, v[k], v[k | (1 << m)], small_load(twid, s - 1 + j), P);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < (1 << R); k++) small_store(data, i0 + (k << bb), v[k]);
}

template <int R, bool INV>
__device__ __forceinline__ void small_stages(const FieldParams& P, uint32_t* data,
                                             const uint32_t* twid, int t, int log_tile) {
  const int full = log_tile / R;
  const int top_m_lo = log_tile % R ? R - log_tile % R : R;  // R: no top window
  if (!INV && top_m_lo < R) {
    small_window<R, INV, false>(P, data, twid, t, log_tile - R, top_m_lo);
    __syncthreads();
  }
  // the windows walked as a count, the window's index derived from it: nvcc
  // compiled the R = 1 forward instantiation of a loop that stepped c down
  // from full - 1 with the test c >= 0 && c < full into a back edge testing
  // c <= full && full != 1, which hung the launch on the card from a tile
  // of 4 up (PERF.md section 7)
  for (int w = 0; w < full; w++) {
    const int c = INV ? w : full - 1 - w;
    if (c == 0)
      small_window<R, INV, true>(P, data, twid, t, 0, 0);
    else
      small_window<R, INV, false>(P, data, twid, t, c * R, 0);
    __syncthreads();
  }
  if (INV && top_m_lo < R) {
    small_window<R, INV, false>(P, data, twid, t, log_tile - R, top_m_lo);
    __syncthreads();
  }
}

// R = min(SMALL_R, log2(tile)); SMALL_BLOCK_ELEMS >> R threads a block;
// dynamic shared memory: 8 rows of SMALL_ROW words of data, then 8 rows of
// SMALL_ROW words of twiddles.
template <int R>
__global__ void __launch_bounds__(SMALL_BLOCK_ELEMS >> R, R == SMALL_R ? 3 : 1)
stages_small_kernel(FieldParams P, int inverse, const uint32_t* __restrict__ x,
                    uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
                    int64_t tw_stride, int log_tile, int64_t e) {
  extern __shared__ uint32_t small_sm[];
  uint32_t* data = small_sm;
  uint32_t* twid = small_sm + FE_WORDS * SMALL_ROW;
  const int threads = SMALL_BLOCK_ELEMS >> R;
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * SMALL_BLOCK_ELEMS;
  const int tile = 1 << log_tile;
  for (int c = t; c < tile - 1; c += threads) {
    Fe w;
#pragma unroll
    for (int k = 0; k < FE_WORDS; k++)
      w.v[k] = (tw[(2 * k) * tw_stride + c] & 0xFFFFu) | (tw[(2 * k + 1) * tw_stride + c] << 16);
    small_store(twid, c, w);
  }
  for (int i = t; i < SMALL_BLOCK_ELEMS; i += threads) {
    Fe a = base + i < e ? fe_load_limb_major(x + base + i, e) : fe_zero();
    small_store(data, i, a);
  }
  __syncthreads();
  if (inverse)
    small_stages<R, true>(P, data, twid, t, log_tile);
  else
    small_stages<R, false>(P, data, twid, t, log_tile);
  for (int i = t; i < SMALL_BLOCK_ELEMS; i += threads)
    if (base + i < e) fe_store_limb_major(out + base + i, e, small_load(data, i));
}

// ---- C launchers ------------------------------------------------------------

template <int R>
static int stages_small_launch_r(const FieldParams* P, int inverse, const void* x, void* out,
                                 const void* tw, int64_t tw_stride, int log_tile, int64_t e,
                                 void* stream) {
  const int smem = 2 * FE_WORDS * SMALL_ROW * (int)sizeof(uint32_t);
  int rc = (int)cudaFuncSetAttribute(stages_small_kernel<R>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  stages_small_kernel<R><<<(unsigned int)((e + SMALL_BLOCK_ELEMS - 1) / SMALL_BLOCK_ELEMS),
                           SMALL_BLOCK_ELEMS >> R, smem, (cudaStream_t)stream>>>(
      *P, inverse, (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, tw_stride, log_tile,
      e);
  return (int)cudaGetLastError();
}


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
  int log_tile = 0;
  while ((1 << log_tile) < tile) log_tile++;
  if (e <= 0) return (int)cudaGetLastError();
  if (log_tile == 1)
    return stages_small_launch_r<1>(P, inverse, x, out, tw, tw_stride, log_tile, e, stream);
  return stages_small_launch_r<SMALL_R>(P, inverse, x, out, tw, tw_stride, log_tile, e, stream);
}

// Test-only: the 1-bit window (R = 1) at any tile, which stages_small_launch
// takes at a tile of 2 alone (section 14).  No path calls it; the host
// rehearsal (tests/test_torch_kernels_host.py) and the card probe
// (utils/probe_stages_small_r1.py, which chip_smoke.py runs) do.
int stages_small_r1_probe_launch(const FieldParams* P, int inverse, const void* x, void* out,
                                 const void* tw, int64_t tw_stride, int tile, int64_t e,
                                 void* stream) {
  int log_tile = 0;
  while ((1 << log_tile) < tile) log_tile++;
  if (e <= 0) return (int)cudaGetLastError();
  return stages_small_launch_r<1>(P, inverse, x, out, tw, tw_stride, log_tile, e, stream);
}

}  // extern "C"
