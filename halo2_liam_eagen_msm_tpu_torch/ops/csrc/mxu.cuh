// The Montgomery product by a constant on the tensor cores: mxu_mul_const (one
// constant for every row) and mxu_mul_table (a constant a position, the NTT
// twiddle stage's shape), the card's form of ops/mxu_ff.mul_const and
// mul_table (the JAX package's ops/mxu_ff.py:89 and :114, a jnp module).
// It replaces no Pallas kernel: the JAX module has none, and no path of
// either package calls it.  It is here to measure whether taking the field
// product off the integer pipes pays on this card.  Included by kernels.cu.
//
// What it computes, as the JAX module does: a row's 16 limbs are 32 bytes,
// and the product by a constant c is the byte convolution a * c, a matrix
// product with the 32 x 64 Toeplitz matrix T[k][n] = byte_{n-k}(c).  Three
// such products make a Montgomery product by c: t = a c, m = (t mod R) mu mod
// R (mu = -p^-1 mod 2^256: only the low 32 byte columns), u = m p; between
// them the 16-bit carry networks, and at the end (t + u) / R reduced once.
// A byte column sums at most 32 products of two bytes, below 2^21, and a
// pair of byte columns makes a 16-bit column below 2^29.1; t's high half plus
// u's stays below 2^30.1, so every column fits a 32-bit word.
//
// Operand type: mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32.  Bytes are
// exact as u8 and their sums exact in the s32 accumulator, and u8 runs at
// twice the rate of bf16 with fp32 accumulation (the JAX module's operand
// type on its matrix unit), which would also be exact below 2^24.
//
// What bounds it: 64 bytes in and 64 out a row (0.0401 ms at 2^20 rows at
// 3.35 TB/s) against about 5,120 u8 multiply-adds a row on the tensor cores
// (5 us at 2^20 at 1,979 TOP/s) and about 400 integer operations a row of
// carry network (13 us at 33.5 TOP/s): bytes.  The design reads each row
// once and writes it once; everything between the three products stays on
// chip:
//  - a warp takes tiles of 32 rows (two m16 tiles); row r's 32 bytes are one
//    row of the A operand, so a lane loads its A fragments straight from its
//    rows (words t and t + 4 of rows g and g + 8: 8 bytes a load);
//  - the B fragments (c's, mu's and p's Toeplitz columns, 40 registers' worth
//    a lane) are built once a block in shared memory from the constants'
//    bytes, never materialised in device memory; for mxu_mul_table a block
//    takes rows of one position (stride n_pos rows) and builds c's from its
//    table row;
//  - the accumulator of a row is spread over the four lanes of a quad (lane
//    t holds byte columns 8j + 2t and 8j + 2t + 1, that is 16-bit column
//    4j + t), so each product's 16-bit columns are staged through shared
//    memory (32 rows of 36 words a warp, 4.6 KB: conflict-free both ways),
//    and lane l carries row l's columns in registers, one thread a row;
//    the carried bytes go back through the same buffer as the next A tile.
// The carry network is a ripple, column by column: the value it leaves is
// the JAX module's (exact base 2^16 digits of the column sum, the top digit
// as the carry out), so the output equals the plain version limb for limb.

#pragma once
#include "ff.cuh"

#define MXU_WARPS 4
#define MXU_THREADS (MXU_WARPS * 32)
#define MXU_TILE_ROWS 32       // rows a warp tile: two m16 tiles
#define MXU_STRIDE 36          // words a staged row (32 columns + 4)
#define MXU_TILES_A_WARP 4     // tiles each warp of a block takes, at most
#define MXU_FRAGS 40           // B fragment registers a lane: c 16, mu 8, p 16
#define MXU_PAD 32             // zero bytes on either side of a constant's 32

// The constants of one launch: c (mxu_mul_const's; zero for a table), mu =
// -p^-1 mod 2^256 and 2^256 - p, each as 8 words of 32 bits.
struct MxuParams {
  uint32_t c[FE_WORDS];
  uint32_t mu[FE_WORDS];
  uint32_t rp[FE_WORDS];
};

// d = A (16 x 32 u8, row-major) times B (32 x 8 u8, column-major) plus c, in
// s32: one m16n8k32 product of a warp.  Fragments as the PTX ISA lays them
// out for u8 (g = lane / 4, t = lane % 4): a[0] row g, bytes 4t..4t+3; a[1]
// row g + 8, the same bytes; a[2], a[3] as a[0], a[1] at bytes 16 + 4t..;
// b[0] column g, bytes 4t..4t+3, b[1] the same at 16 + 4t..; d[0], d[1] row
// g, columns 2t and 2t + 1, d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_u8_m16n8k32(int32_t d[4], const uint32_t a[4],
                                                const uint32_t b[2], const int32_t c[4]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
#elif !defined(__CUDACC__)
  // The host rehearsal (g++ behind tests/test_torch_kernels_host.py's shim),
  // which runs no PTX: the warp's 32 lanes publish their fragments, and
  // between two barriers each lane computes its four outputs by the layout
  // above.  (nvcc's host pass compiles neither branch: device code.)
  __shared__ uint32_t mma_xchg[MXU_THREADS][10];
  uint32_t* mine = mma_xchg[threadIdx.x];
  for (int k = 0; k < 4; k++) mine[k] = a[k];
  mine[4] = b[0];
  mine[5] = b[1];
  for (int k = 0; k < 4; k++) mine[6 + k] = (uint32_t)c[k];
  __syncwarp();
  const uint32_t(*w)[10] = mma_xchg + (threadIdx.x & ~31u);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  int32_t r[4];
  for (int i = 0; i < 4; i++) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    uint32_t acc = w[4 * g + t][6 + i];
    for (int k = 0; k < 32; k++) {
      // A[row][k]: lane 4 (row % 8) + (k % 16) / 4, register row / 8 + 2 (k / 16);
      // B[k][col]: lane 4 col + (k % 16) / 4, register k / 16; byte k % 4
      const int q = (k & 15) >> 2, sh = 8 * (k & 3);
      const uint32_t ab = (w[4 * (row & 7) + q][(row >> 3) + 2 * (k >> 4)] >> sh) & 0xFFu;
      const uint32_t bb = (w[4 * col + q][4 + (k >> 4)] >> sh) & 0xFFu;
      acc += ab * bb;
    }
    r[i] = (int32_t)acc;
  }
  __syncwarp();
  for (int i = 0; i < 4; i++) d[i] = r[i];
#endif
}

// Carry K columns (each below 2^31) into 16-bit limbs; returns the carry
// out (the value's digit K).
template <int K>
__device__ __forceinline__ uint32_t mxu_ripple(const uint32_t* cols, uint32_t* limbs) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < K; k++) {
    const uint32_t v = cols[k] + c;
    limbs[k] = v & 0xFFFFu;
    c = v >> 16;
  }
  return c;
}

// The carry out of mxu_ripple alone.
template <int K>
__device__ __forceinline__ uint32_t mxu_carry(const uint32_t* cols) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < K; k++) c = (cols[k] + c) >> 16;
  return c;
}

// Limb k of 2^256 - p.
__device__ __forceinline__ uint32_t mxu_rp(const MxuParams& M, int k) {
  return (M.rp[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
}

// One product by a constant over a warp's two m16 tiles: the A fragments of
// the tile's 32 rows, J n-tiles of 8 byte columns from the B fragments at
// frag[f0 ..]; the 16-bit columns 0 .. 4J - 1 of row r go to S[r * STRIDE ..].
template <int J>
__device__ __forceinline__ void mxu_product(const uint32_t A[2][4],
                                            const uint32_t (*frag)[32], int f0, uint32_t* S,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int32_t zero[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < J; j++) {
    const uint32_t b[2] = {frag[f0 + 2 * j][lane], frag[f0 + 2 * j + 1][lane]};
#pragma unroll
    for (int m = 0; m < 2; m++) {
      int32_t d[4];
      mma_u8_m16n8k32(d, A[m], b, zero);
      // byte columns 8j + 2t, 8j + 2t + 1: the 16-bit column 4j + t
      S[(16 * m + g) * MXU_STRIDE + 4 * j + t] = (uint32_t)d[0] + ((uint32_t)d[1] << 8);
      S[(16 * m + g + 8) * MXU_STRIDE + 4 * j + t] = (uint32_t)d[2] + ((uint32_t)d[3] << 8);
    }
  }
}

// Lane `lane`'s row of the staged columns: N (a multiple of 4) words.
template <int N>
__device__ __forceinline__ void mxu_read_row(const uint32_t* S, int lane, uint32_t* cols) {
  const uint4* r = reinterpret_cast<const uint4*>(S + lane * MXU_STRIDE);
#pragma unroll
  for (int q = 0; q < N / 4; q++) {
    const uint4 v = r[q];
    cols[4 * q] = v.x;
    cols[4 * q + 1] = v.y;
    cols[4 * q + 2] = v.z;
    cols[4 * q + 3] = v.w;
  }
}

// Lane `lane` writes its row's 16 limbs, two a word, to words 0..7 of its
// staged row; after a barrier the warp reads them back as the A fragments of
// the next product.
__device__ __forceinline__ void mxu_stage_limbs(uint32_t* S, int lane, const uint32_t* limbs) {
  uint4* r = reinterpret_cast<uint4*>(S + lane * MXU_STRIDE);
#pragma unroll
  for (int q = 0; q < 2; q++) {
    uint4 v;
    v.x = limbs[8 * q] | (limbs[8 * q + 1] << 16);
    v.y = limbs[8 * q + 2] | (limbs[8 * q + 3] << 16);
    v.z = limbs[8 * q + 4] | (limbs[8 * q + 5] << 16);
    v.w = limbs[8 * q + 6] | (limbs[8 * q + 7] << 16);
    r[q] = v;
  }
}

__device__ __forceinline__ void mxu_staged_a(const uint32_t* S, int lane, uint32_t A[2][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; m++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      A[m][h] = S[(16 * m + g + 8 * h) * MXU_STRIDE + t];
      A[m][2 + h] = S[(16 * m + g + 8 * h) * MXU_STRIDE + 4 + t];
    }
}

// The A fragments of rows i0 .. i0 + 31 of a: words t and t + 4 of rows g,
// g + 8 of each m16 tile (8 bytes a load), zero past n_lead.
__device__ __forceinline__ void mxu_load_a(const uint32_t* __restrict__ a, int64_t i0,
                                           int64_t n_lead, int64_t n_pos, int64_t pos, int lane,
                                           uint32_t A[2][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; m++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int64_t i = i0 + 16 * m + g + 8 * h;
      uint2 lo = {0, 0}, hi = {0, 0};
      if (i < n_lead) {
        const uint32_t* row = a + (i * n_pos + pos) * ELEMS_PER_ROW;
        lo = *reinterpret_cast<const uint2*>(row + 2 * t);
        hi = *reinterpret_cast<const uint2*>(row + 8 + 2 * t);
      }
      A[m][h] = (lo.x & 0xFFFFu) | ((lo.y & 0xFFFFu) << 16);
      A[m][2 + h] = (hi.x & 0xFFFFu) | ((hi.y & 0xFFFFu) << 16);
    }
}

// a, out: rows of 16 limbs; row i of position pos at (i * n_pos + pos).
// table: (n_pos, 16) limbs, or null for M.c.  Block b takes position
// b / blocks_per_pos, and its warps the tiles xb MXU_WARPS + warp + k
// blocks_per_pos MXU_WARPS of that position's rows, xb = b % blocks_per_pos.
// (Neighbouring positions in neighbouring blocks together with a warp
// loading its next tile while this one's products run ran 2-4 % slower on
// the H100: PERF.md.)
__global__ void __launch_bounds__(MXU_THREADS, 4)
mxu_mul_kernel(FieldParams P, MxuParams M, const uint32_t* __restrict__ table,
               const uint32_t* __restrict__ a, uint32_t* __restrict__ out, int64_t n_lead,
               int64_t n_pos, int64_t blocks_per_pos) {
  __shared__ uint8_t cbytes[3][MXU_PAD + 32 + MXU_PAD];
  __shared__ uint32_t frag[MXU_FRAGS][32];
  __shared__ __align__(16) uint32_t stage[MXU_WARPS][MXU_TILE_ROWS * MXU_STRIDE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t pos = blockIdx.x / blocks_per_pos;
  const int64_t xb = blockIdx.x % blocks_per_pos;

  // the bytes of c (or of this position's table row), mu and p, zero-padded:
  // thread 8 which + w < 24 writes word w of constant `which` (the params
  // indexed by constants only, so they are never copied to local memory),
  // the others the padding
  for (int i = tid; i < 3 * (2 * MXU_PAD + 32); i += MXU_THREADS) {
    const int k = i % (2 * MXU_PAD + 32) - MXU_PAD;
    if (k < 0 || k >= 32) cbytes[i / (2 * MXU_PAD + 32)][MXU_PAD + k] = 0;
  }
  if (tid < 3 * FE_WORDS) {
    const int which = tid / FE_WORDS, w = tid % FE_WORDS;
    uint32_t v = 0;
    if (which == 0 && table != nullptr) {
      const uint32_t* row = table + pos * ELEMS_PER_ROW + 2 * w;
      v = (row[0] & 0xFFFFu) | ((row[1] & 0xFFFFu) << 16);
    } else {
#pragma unroll
      for (int q = 0; q < FE_WORDS; q++)
        if (q == w) v = which == 0 ? M.c[q] : which == 1 ? M.mu[q] : P.p[q];
    }
#pragma unroll
    for (int b = 0; b < 4; b++) cbytes[which][MXU_PAD + 4 * w + b] = (uint8_t)(v >> (8 * b));
  }
  __syncthreads();
  // B fragments: f < 16 c's n-tiles 0..7, f < 24 mu's 0..3, then p's 0..7;
  // register f & 1 of n-tile j holds T[k][n] = byte_{n-k}, n = 8j + g, k =
  // 16 (f & 1) + 4t + i in byte i
  for (int i = tid; i < MXU_FRAGS * 32; i += MXU_THREADS) {
    const int f = i >> 5, l = i & 31;
    const int which = f < 16 ? 0 : f < 24 ? 1 : 2;
    const int j = (f - (which == 0 ? 0 : which == 1 ? 16 : 24)) >> 1;
    const int n = 8 * j + (l >> 2), k0 = 16 * (f & 1) + 4 * (l & 3);
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; b++) v |= (uint32_t)cbytes[which][MXU_PAD + n - k0 - b] << (8 * b);
    frag[f][l] = v;
  }
  __syncthreads();

  uint32_t* S = stage[warp];
  const int64_t tiles = (n_lead + MXU_TILE_ROWS - 1) / MXU_TILE_ROWS;
  const int64_t stride = blocks_per_pos * MXU_WARPS;
  uint32_t A[2][4];
  for (int64_t tile = xb * MXU_WARPS + warp; tile < tiles; tile += stride) {
    const int64_t i0 = tile * MXU_TILE_ROWS;
    mxu_load_a(a, i0, n_lead, n_pos, pos, lane, A);

    // t = a c: 32 columns; lane l carries row l's low 16 into t_lo
    mxu_product<8>(A, frag, 0, S, lane);
    __syncwarp();
    uint32_t tc[32];
    mxu_read_row<32>(S, lane, tc);
    __syncwarp();
    uint32_t t_lo[16];
    const uint32_t t_lo_carry = mxu_ripple<16>(tc, t_lo);
    mxu_stage_limbs(S, lane, t_lo);
    __syncwarp();
    mxu_staged_a(S, lane, A);
    __syncwarp();

    // m = t_lo mu mod R: the low 16 columns
    mxu_product<4>(A, frag, 16, S, lane);
    __syncwarp();
    uint32_t cols[32];
    mxu_read_row<16>(S, lane, cols);
    __syncwarp();
    uint32_t limbs[16];
    mxu_ripple<16>(cols, limbs);
    mxu_stage_limbs(S, lane, limbs);
    __syncwarp();
    mxu_staged_a(S, lane, A);
    __syncwarp();

    // u = m p; the low halves cancel, their carry goes to column 16
    mxu_product<8>(A, frag, 24, S, lane);
    __syncwarp();
    mxu_read_row<32>(S, lane, cols);
    __syncwarp();  // the next tile's first product writes S again
#pragma unroll
    for (int k = 0; k < 16; k++) cols[k] += t_lo[k];
    const uint32_t lo_carry = mxu_carry<16>(cols);
    // hi = t's high half + u's + the two carries, a value below 2p; the
    // value + 2^256 - p carries out exactly where it is >= p, and then that
    // sum's digits are the reduced value
    uint32_t* hi = cols + 16;
#pragma unroll
    for (int k = 0; k < 16; k++) hi[k] += tc[16 + k];
    hi[0] += lo_carry + t_lo_carry;
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < 16; k++) c = (hi[k] + mxu_rp(M, k) + c) >> 16;
    const bool ge = c == 1u;
#pragma unroll
    for (int k = 0; k < 16; k++) hi[k] += ge ? mxu_rp(M, k) : 0u;
    mxu_ripple<16>(hi, limbs);
    const int64_t i = i0 + lane;
    if (i < n_lead) {
      uint4* o = reinterpret_cast<uint4*>(out + (i * n_pos + pos) * ELEMS_PER_ROW);
#pragma unroll
      for (int q = 0; q < 4; q++) {
        uint4 v;
        v.x = limbs[4 * q];
        v.y = limbs[4 * q + 1];
        v.z = limbs[4 * q + 2];
        v.w = limbs[4 * q + 3];
        o[q] = v;
      }
    }
  }
}

static inline int64_t mxu_blocks(int64_t n_lead) {
  const int64_t tiles = (n_lead + MXU_TILE_ROWS - 1) / MXU_TILE_ROWS;
  return (tiles + MXU_WARPS * MXU_TILES_A_WARP - 1) / (MXU_WARPS * MXU_TILES_A_WARP);
}

extern "C" {

// a, out: (n, 16) rows; M: c, mu and 2^256 - p.
int mxu_mul_const_launch(const FieldParams* P, const MxuParams* M, const void* a, void* out,
                         int64_t n, void* stream) {
  if (n > 0) {
    const int64_t bpp = mxu_blocks(n);
    if (bpp > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    mxu_mul_kernel<<<(unsigned int)bpp, MXU_THREADS, 0, (cudaStream_t)stream>>>(
        *P, *M, nullptr, (const uint32_t*)a, (uint32_t*)out, n, 1, bpp);
  }
  return (int)cudaGetLastError();
}

// table: (n_pos, 16) rows; a, out: (n_lead, n_pos, 16) rows; M: mu and
// 2^256 - p (its c unused).
int mxu_mul_table_launch(const FieldParams* P, const MxuParams* M, const void* table,
                         const void* a, void* out, int64_t n_lead, int64_t n_pos,
                         void* stream) {
  if (n_lead > 0 && n_pos > 0) {
    const int64_t bpp = mxu_blocks(n_lead);
    if (bpp * n_pos > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    const unsigned int grid = (unsigned int)(bpp * n_pos);
    mxu_mul_kernel<<<grid, MXU_THREADS, 0, (cudaStream_t)stream>>>(
        *P, *M, (const uint32_t*)table, (const uint32_t*)a, (uint32_t*)out, n_lead, n_pos, bpp);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
