// The coefficient levels' two kernels: mont_mul's work at the shapes of the
// divisor merge tree's coefficient levels (divisor.merge_pairs below
// FUSE_MIN_LA), each in one launch.  Included by kernels.cu; wrappers and
// plain versions in ops/cuda_poly.py.
//
// Both replace pallas_ff.py:515 mont_mul (and :541 mont_addsub) where the
// JAX package's ops/poly.py compiles them into one body: mul_naive (:104,
// one Pallas product of the La x Lb outer product, XLA's fused column sums)
// and kate_div (:55, a lax.scan of one product and one add).  The port ran
// them as a product launch over the materialised outer product, a pad, int64
// anti-diagonal sums and the reduction's own launches; and as a Python loop
// of 2 (n - 1) launches with a copy of every coefficient slice.  Here each is
// one launch whose intermediates stay in registers and shared memory.
//
// What bounds them: poly_mul_naive does La Lb field products for La + Lb
// rows in and La + Lb - 1 out a pair, so integer operations bound it from a
// few terms up (at La = Lb = 33, 1,089 products for 129 rows); kate_div does
// n - 1 dependent products and adds a pair, so one chain's latency bounds a
// launch of few pairs, and the card's product rate one of many.

// ---- poly_mul_naive: the schoolbook product of the coefficient levels --------
//
// out[pair, k] = sum_{i + j = k} a[pair, i] * b[pair, j] * R^-1 mod p, fully
// reduced, for every pair of polynomials: a block takes `group` pairs, stages
// their a and b rows once into shared memory, repacked to 8 words of 32 bits
// (an operand shared by all pairs, stride 0, is staged once), and a thread
// takes one output coefficient k of one pair (the wrapper sizes the block to
// the group's outputs, rounded up to whole warps, so few threads idle): it
// walks its anti-diagonal with fe_mul and adds each product with fe_add, so
// the sum is exact mod p in any order and equals the plain version's
// (products, int64 column sums, one reduction) limb for limb.  Threads of a
// block take the group's outputs in order, so neighbouring threads write
// neighbouring rows.  Where even one
// pair's rows do not fit the block's shared memory (the wrapper decides;
// never on the path, whose operands have at most 65 terms), the threads read
// their rows from device memory instead (staged = 0).  The La x Lb products
// never touch device memory.

#define PMUL_MAX_THREADS 256

// Row r of a staged operand: 8 words (two uint4) of shared memory.
__device__ __forceinline__ Fe staged_row(const uint32_t* sm, int r) {
  const uint4* s4 = reinterpret_cast<const uint4*>(sm + 8 * r);
  const uint4 lo = s4[0], hi = s4[1];
  Fe x;
  x.v[0] = lo.x; x.v[1] = lo.y; x.v[2] = lo.z; x.v[3] = lo.w;
  x.v[4] = hi.x; x.v[5] = hi.y; x.v[6] = hi.z; x.v[7] = hi.w;
  return x;
}

__device__ __forceinline__ void staged_store(uint32_t* sm, int r, const Fe& x) {
  uint4* s4 = reinterpret_cast<uint4*>(sm + 8 * r);
  uint4 lo, hi;
  lo.x = x.v[0]; lo.y = x.v[1]; lo.z = x.v[2]; lo.w = x.v[3];
  hi.x = x.v[4]; hi.y = x.v[5]; hi.z = x.v[6]; hi.w = x.v[7];
  s4[0] = lo;
  s4[1] = hi;
}

// Stage `rows` rows of 16 limbs into shared memory as 8 words each: the
// block's threads take the rows' 16-byte quarters in order, so a warp reads
// 512 contiguous bytes where the rows are contiguous.  Row r is global row
// row_of(r).
template <class RowOf>
__device__ __forceinline__ void stage_rows(uint32_t* sm, const uint32_t* __restrict__ src,
                                           int rows, RowOf row_of) {
  for (int u = threadIdx.x; u < 4 * rows; u += blockDim.x) {
    const int r = u >> 2, q = u & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(src + row_of(r) * ELEMS_PER_ROW + 4 * q);
    sm[8 * r + 2 * q] = (v.x & 0xFFFFu) | (v.y << 16);
    sm[8 * r + 2 * q + 1] = (v.z & 0xFFFFu) | (v.w << 16);
  }
}

__global__ void __launch_bounds__(PMUL_MAX_THREADS)
poly_mul_naive_kernel(FieldParams P, const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                      int64_t pairs, int la, int lb, int64_t a_stride, int64_t b_stride,
                      int group, int staged) {
  extern __shared__ uint4 pmul_sm[];
  const int nout = la + lb - 1;
  const int64_t first = (int64_t)blockIdx.x * group;
  const int in_block = (int)(pairs - first < group ? pairs - first : group);
  // rows staged: a pair's own rows, or one copy of a shared operand
  const int a_rows = a_stride ? in_block * la : la;
  uint32_t* sa = reinterpret_cast<uint32_t*>(pmul_sm);
  uint32_t* sb = sa + 8 * (a_stride ? group * la : la);
  if (staged) {
    // row r of a's stage: pair first + r / la, term r % la (a_stride = la),
    // or term r of the one shared row (a_stride = 0); the same for b
    stage_rows(sa, a, a_rows, [&](int r) { return first * a_stride + r; });
    stage_rows(sb, b, b_stride ? in_block * lb : lb,
               [&](int r) { return first * b_stride + r; });
    __syncthreads();
  }
  for (int o = threadIdx.x; o < in_block * nout; o += blockDim.x) {
    const int g = o / nout, k = o - g * nout;
    const int i_lo = k - lb + 1 > 0 ? k - lb + 1 : 0;
    const int i_hi = k < la - 1 ? k : la - 1;
    const int64_t pair = first + g;
    Fe acc = fe_zero();
#pragma unroll 1
    for (int i = i_lo; i <= i_hi; i++) {
      Fe x, y;
      if (staged) {
        x = staged_row(sa, (a_stride ? g * la : 0) + i);
        y = staged_row(sb, (b_stride ? g * lb : 0) + k - i);
      } else {
        x = fe_load(a + (pair * a_stride + i) * ELEMS_PER_ROW);
        y = fe_load(b + (pair * b_stride + k - i) * ELEMS_PER_ROW);
      }
      acc = fe_add(acc, fe_mul(x, y, P), P);
    }
    fe_store(out + (pair * nout + k) * ELEMS_PER_ROW, acc);
  }
}

// ---- kate_div: synthetic division of the coefficient levels -------------------
//
// For each pair, the quotient of c(x) by (x - b) with the remainder dropped:
// q_{n-1} = 0 and q_{k-1} = c_k + b q_k, down to q_0 (b = 0 gives the shift),
// the same static length n with a zero last row, limb for limb the plain
// version's (and the JAX scan body's) arithmetic.  A thread runs one pair's
// chain of n - 1 dependent products and adds in registers.  A thread reading
// its own pair's rows would read 64 bytes at a stride of n x 64 bytes, so the
// block stages its KDIV_PAIRS pairs' rows in chunks of KDIV_CHUNK coefficients
// from the top: the block's threads load the chunk's rows coalesced (a pair's
// chunk is contiguous) into shared memory, repacked to 8 words; each thread
// walks its chunk down, writing each quotient row over the coefficient it
// consumed (q_{j-1} over c_j); the block writes the chunk back coalesced, one
// row lower.  Spare threads of a ragged last block walk rows no one loaded and
// store nothing.

#define KDIV_PAIRS 32
#define KDIV_CHUNK 16

__global__ void __launch_bounds__(KDIV_PAIRS)
kate_div_kernel(FieldParams P, const uint32_t* __restrict__ c, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, int64_t pairs, int n, int64_t b_stride) {
  __shared__ uint32_t kdiv_sm[KDIV_PAIRS * KDIV_CHUNK * 8];
  const int t = threadIdx.x;
  const int64_t first = (int64_t)blockIdx.x * KDIV_PAIRS;
  const int in_block = (int)(pairs - first < KDIV_PAIRS ? pairs - first : KDIV_PAIRS);
  const int64_t pair = first + (t < in_block ? t : in_block - 1);
  const Fe bb = fe_load(b + pair * b_stride * ELEMS_PER_ROW);
  Fe acc = fe_zero();
  // the chunk holds coefficients lo + 1 .. hi (rows r = 0 .. hi - lo - 1)
#pragma unroll 1
  for (int hi = n - 1; hi >= 1; hi -= KDIV_CHUNK) {
    const int lo = hi - KDIV_CHUNK > 0 ? hi - KDIV_CHUNK : 0;
    const int rows = hi - lo;
    for (int u = t; u < 4 * rows * in_block; u += KDIV_PAIRS) {
      const int g = u / (4 * rows), r = (u >> 2) % rows, q = u & 3;
      const uint4 v = *reinterpret_cast<const uint4*>(
          c + ((first + g) * n + lo + 1 + r) * ELEMS_PER_ROW + 4 * q);
      uint32_t* w = kdiv_sm + 8 * (g * KDIV_CHUNK + r) + 2 * q;
      w[0] = (v.x & 0xFFFFu) | (v.y << 16);
      w[1] = (v.z & 0xFFFFu) | (v.w << 16);
    }
    __syncthreads();
#pragma unroll 1
    for (int r = rows - 1; r >= 0; r--) {
      acc = fe_add(staged_row(kdiv_sm, t * KDIV_CHUNK + r), fe_mul(bb, acc, P), P);
      staged_store(kdiv_sm, t * KDIV_CHUNK + r, acc);  // q_{lo + r}
    }
    __syncthreads();
    for (int u = t; u < 4 * rows * in_block; u += KDIV_PAIRS) {
      const int g = u / (4 * rows), r = (u >> 2) % rows, q = u & 3;
      const uint32_t* w = kdiv_sm + 8 * (g * KDIV_CHUNK + r) + 2 * q;
      uint4 v;
      v.x = w[0] & 0xFFFFu;
      v.y = w[0] >> 16;
      v.z = w[1] & 0xFFFFu;
      v.w = w[1] >> 16;
      *reinterpret_cast<uint4*>(out + ((first + g) * n + lo + r) * ELEMS_PER_ROW + 4 * q) = v;
    }
    __syncthreads();
  }
  // the last row, q_{n-1} = 0
  for (int u = t; u < 4 * in_block; u += KDIV_PAIRS) {
    uint4 z;
    z.x = z.y = z.z = z.w = 0;
    *reinterpret_cast<uint4*>(out + ((first + u / 4) * n + n - 1) * ELEMS_PER_ROW +
                              4 * (u & 3)) = z;
  }
}
