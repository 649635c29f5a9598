// The coefficient levels' kernels: mont_mul's work at the shapes of the
// divisor merge tree's coefficient levels (divisor.merge_pairs below
// FUSE_MIN_LA), each in one launch: poly_mul_naive, and the divisions,
// kate_div by one root and kate_div2 by two in one walk (the path's).
// Included by kernels.cu; wrappers and plain versions in ops/cuda_poly.py.
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
// (an operand shared by all pairs, stride 0, is staged once).  Where even one
// pair's rows do not fit the block's shared memory (the wrapper decides;
// never on the path, whose operands have at most 65 terms), the threads read
// their rows from device memory instead (staged = 0).  The La x Lb products
// never touch device memory.
//
// One kernel, poly_mul_naive_kernel<LAZY>, in two instantiations.
//
// LAZY = false, the first design: a thread takes one output coefficient k
// and walks its anti-diagonal with fe_mul and fe_add, a full Montgomery
// reduction and a modular add a product.  At (La, Lb) = (17, 19), the
// heaviest shape of a round, a warp's 32 outputs have diagonals of 1 to 17
// products, so the warp runs for its longest, about twice the mean.
// poly_mul_naive takes it where no diagonal has more than two products
// (min(La, Lb) <= 2): there a lazy sum saves nothing, and its larger
// footprint (78 registers a thread against 62) costs occupancy at
// shapes that are bound by bytes (0.83-0.91x of this design on an H100 80GB
// HBM3 at 700 W, PERF.md).
//
// LAZY = true, the second design, for every other shape:
//   * lazy accumulation.  A term's 512-bit product (8 x 8 word products)
//     is added into a 17-word accumulator, and the sum is reduced once an
//     output (acc_reduce): about 64 multiply-adds a term and 64 an output,
//     where the first design spends 136 a term and an fe_add.  The sum T of
//     K products of reduced operands is below K p^2; its REDC r = (T + m p)
//     / R lies below (K p / R + 1) p, so more than a conditional
//     subtraction is needed from K = 4 on (R / p is about 4 for Pallas and
//     Vesta): acc_reduce takes a quotient from r's top 64 bits, one that
//     may be one too large, then adds p back or subtracts it, at most
//     once each.  A diagonal longer than PMUL_LAZY_TERMS
//     products (never on the path, whose diagonals have at most 33) is
//     summed in runs of that many, each run reduced and the reduced runs
//     added with fe_add, so every output is fully reduced whatever the
//     length.
//   * balanced threads.  A thread takes output k and output k + ceil(nout /
//     2) of the same pair: a diagonal of the rising ramp with one of the
//     falling ramp, whose lengths sum to about min(La, Lb) + 1, so at
//     (17, 19) every thread walks 17 or 18 products.  (Pairing k with
//     nout - 1 - k would pair equal lengths: the diagonals are symmetric.)
// Threads of a block take the group's outputs in order, so neighbouring
// threads write neighbouring rows.  Both instantiations give the unique
// reduced value, so their limbs equal each other's and the plain version's.

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

#define PMUL_ACC_WORDS (2 * FE_WORDS + 1)
#define PMUL_LAZY_TERMS 64

// acc += x y, exactly: eight rows of eight word products.  Row i adds into
// words i .. i + 8; its carry out of word i + 8 (at most 1) is added at the
// end of row i + 1, whose own products stop at word i + 8, and the last
// row's into word 16.  A sum of up to PMUL_LAZY_TERMS products of reduced
// operands is below 2^6 p^2 < 2^516, so word 16 never overflows.
__device__ __forceinline__ void acc_mul_add(uint32_t (&acc)[PMUL_ACC_WORDS], const Fe& x,
                                            const Fe& y) {
  uint32_t pend = 0;
#pragma unroll
  for (int i = 0; i < FE_WORDS; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FE_WORDS; j++) {
      const uint64_t s = (uint64_t)x.v[j] * (uint64_t)y.v[i] + (uint64_t)acc[i + j] + c;
      acc[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    const uint64_t s = (uint64_t)acc[i + FE_WORDS] + c + pend;
    acc[i + FE_WORDS] = (uint32_t)s;
    pend = (uint32_t)(s >> 32);
  }
  acc[2 * FE_WORDS] += pend;
}

// T R^-1 mod p, fully reduced, for the lazy sum T of at most PMUL_LAZY_TERMS
// products (the wrapper requires 2^247 < p < 2^255).  Eight word steps of REDC
// (the carries as in acc_mul_add) leave r = (T + m p) / R in words 8 .. 16, r <
// (K p / R + 1) p <= 33 p < 2^261.  With W = 2^224, r_hi = r / W < 2^37, p_hi =
// p / W (the top word of p, at least 2^23) and F = floor(r_hi / (p_hi + 1)) <
// 2^14: F p < F (p_hi + 1) W <= r, and r - F p < (r_hi + 1 - F p_hi) W <= (p_hi
// + F + 1) W <= p + (F + 1) W < 2p, as (F + 1) W <= 2^238 < p.  The ratio r_hi /
// (p_hi + 1) is estimated in double precision from inv_p_hi, the rounded 1 /
// (p_hi + 1), to within 2^-38; a ratio that is not an integer lies at least 1 /
// (p_hi + 1) >= 2^-32 from one, so the estimate's floor is F, or F - 1 where
// r_hi = F (p_hi + 1) exactly.  So q = floor + 1 is F or F + 1, and r - q p lies
// in [-p, 2p): where it is negative (word 8 of the difference all ones) p is
// added back, and one conditional subtraction finishes it.  The difference fits
// 256 bits either way, so its words 0 .. 7 are all that is kept.  (A 64-bit
// integer division here made the short diagonals slower than the first
// design's.)
__device__ __forceinline__ Fe acc_reduce(uint32_t (&t)[PMUL_ACC_WORDS], const FieldParams& P,
                                         double inv_p_hi) {
  uint32_t pend = 0;
#pragma unroll
  for (int i = 0; i < FE_WORDS; i++) {
    const uint32_t m = t[i] * P.n0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FE_WORDS; j++) {
      const uint64_t s = (uint64_t)m * (uint64_t)P.p[j] + (uint64_t)t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    const uint64_t s = (uint64_t)t[i + FE_WORDS] + c + pend;
    t[i + FE_WORDS] = (uint32_t)s;
    pend = (uint32_t)(s >> 32);
  }
  t[2 * FE_WORDS] += pend;
  const uint64_t r_hi = ((uint64_t)t[2 * FE_WORDS] << 32) | t[2 * FE_WORDS - 1];
  const uint64_t q = (uint64_t)((double)r_hi * inv_p_hi) + 1;
  Fe d;
  uint64_t c = 0, borrow = 0;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) {
    const uint64_t qp = q * (uint64_t)P.p[k] + c;
    c = qp >> 32;
    const uint64_t s = (uint64_t)t[FE_WORDS + k] - (uint64_t)(uint32_t)qp - borrow;
    d.v[k] = (uint32_t)s;
    borrow = s >> 63;
  }
  const uint32_t neg = t[2 * FE_WORDS] - (uint32_t)c - (uint32_t)borrow;  // 0 or ~0
  uint64_t s = 0;
#pragma unroll
  for (int k = 0; k < FE_WORDS; k++) {
    s += (uint64_t)d.v[k] + (P.p[k] & neg);
    d.v[k] = (uint32_t)s;
    s >>= 32;
  }
  return fe_cond_sub_p(d, P);
}

template <bool LAZY>
__global__ void __launch_bounds__(PMUL_MAX_THREADS)
poly_mul_naive_kernel(FieldParams P, const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                      int64_t pairs, int la, int lb, int64_t a_stride, int64_t b_stride,
                      int group, int staged, double inv_p_hi) {
  extern __shared__ uint4 pmul_sm[];
  const int nout = la + lb - 1;
  const int step = LAZY ? (nout + 1) / 2 : nout;  // a thread's outputs k, k + step
  const int64_t first = (int64_t)blockIdx.x * group;
  const int in_block = (int)(pairs - first < group ? pairs - first : group);
  const int a_rows = a_stride ? in_block * la : la;
  uint32_t* sa = reinterpret_cast<uint32_t*>(pmul_sm);
  uint32_t* sb = sa + 8 * (a_stride ? group * la : la);
  if (staged) {
    stage_rows(sa, a, a_rows, [&](int r) { return first * a_stride + r; });
    stage_rows(sb, b, b_stride ? in_block * lb : lb,
               [&](int r) { return first * b_stride + r; });
    __syncthreads();
  }
  for (int o = threadIdx.x; o < in_block * step; o += blockDim.x) {
    const int g = o / step;
    const int64_t pair = first + g;
    // term i of output k: a[i] and b[k - i] of this pair
    auto operands = [&](int i, int k, Fe& x, Fe& y) {
      if (staged) {
        x = staged_row(sa, (a_stride ? g * la : 0) + i);
        y = staged_row(sb, (b_stride ? g * lb : 0) + k - i);
      } else {
        x = fe_load(a + (pair * a_stride + i) * ELEMS_PER_ROW);
        y = fe_load(b + (pair * b_stride + k - i) * ELEMS_PER_ROW);
      }
    };
#pragma unroll 1
    for (int k = o - g * step; k < nout; k += step) {
      const int i_lo = k - lb + 1 > 0 ? k - lb + 1 : 0;
      const int i_hi = k < la - 1 ? k : la - 1;
      Fe sum = fe_zero(), x, y;
      if constexpr (LAZY) {
#pragma unroll 1
        for (int run = i_lo; run <= i_hi; run += PMUL_LAZY_TERMS) {
          const int run_end =
              run + PMUL_LAZY_TERMS - 1 < i_hi ? run + PMUL_LAZY_TERMS - 1 : i_hi;
          uint32_t acc[PMUL_ACC_WORDS];
#pragma unroll
          for (int w = 0; w < PMUL_ACC_WORDS; w++) acc[w] = 0;
#pragma unroll 1
          for (int i = run; i <= run_end; i++) {
            operands(i, k, x, y);
            acc_mul_add(acc, x, y);
          }
          const Fe run_sum = acc_reduce(acc, P, inv_p_hi);
          sum = run == i_lo ? run_sum : fe_add(sum, run_sum, P);
        }
      } else {
#pragma unroll 1
        for (int i = i_lo; i <= i_hi; i++) {
          operands(i, k, x, y);
          sum = fe_add(sum, fe_mul(x, y, P), P);
        }
      }
      fe_store(out + (pair * nout + k) * ELEMS_PER_ROW, sum);
    }
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

// ---- kate_div2: both divisions of a coefficient level in one walk -------------
//
// For each pair, the quotient of c(x) by (x - ra)(x - rb) with the remainders
// dropped, limb for limb kate_div(kate_div(c, ra), rb): the same static length
// n, the last rows zero.  The two recurrences run top-down in one walk,
//   q1_{k-1} = c_k + ra q1_k,   q2_{k-1} = q1_k + rb q2_k,   q1_{n-1} = q2_{n-1} = 0,
// q2 written as it comes, q1 never leaving registers.  Two lanes a pair: the
// even lane carries q1 (it reads the coefficients, one row ahead of the
// step), the odd one q2 (it writes the quotient); at each step the odd lane
// takes q1_k from the even one by __shfl_sync, so the two products of a step
// run side by side on two lanes.
//
// Against kate_div launched twice, the first design's route (a warp a block,
// a thread a pair, rows staged through shared memory a chunk at a time):
// half the launches, half the bytes (q1 is never written and read back; n
// rows in, n out and two roots a pair), four warps a block, each thread's
// loads a row ahead, and one chain of n - 1 steps of one product each in
// place of two.  What bounds it is the rate at which an SM sub-partition
// dispatches fe_mul's instructions: a warp's product holds its
// sub-partition about as many cycles as its chain takes alone, so the 2^14
// pairs of 34-35 terms (two warps a sub-partition) run at about twice one
// chain's time, and the 2^18 pairs of 4-5 terms at 2.4x their bytes bound.
// One thread a pair, the two products of a step side by side in it, ran
// 1.6x slower over a round (its two products do not overlap; PERF.md row
// 1d).

#define KDIV2_BLOCK 128

__global__ void __launch_bounds__(KDIV2_BLOCK)
kate_div2_kernel(FieldParams P, const uint32_t* __restrict__ c, const uint32_t* __restrict__ ra,
                 const uint32_t* __restrict__ rb, uint32_t* __restrict__ out, int64_t pairs,
                 int n, int64_t ra_stride, int64_t rb_stride) {
  const int odd = threadIdx.x & 1;
  const int64_t pair = global_index() >> 1;
  const int64_t s = pair < pairs ? pair : pairs - 1;  // a ragged block's spare lanes
  const bool store = odd && pair < pairs;
  const Fe r = fe_load(odd ? rb + s * rb_stride * ELEMS_PER_ROW
                           : ra + s * ra_stride * ELEMS_PER_ROW);
  const uint32_t* crow = c + s * n * ELEMS_PER_ROW;
  uint32_t* orow = out + s * n * ELEMS_PER_ROW;
  Fe acc = fe_zero();
  Fe next = fe_zero();
  if (!odd && n >= 2) next = fe_load(crow + (int64_t)(n - 1) * ELEMS_PER_ROW);  // c_{n-1}
#pragma unroll 1
  for (int k = n - 1; k >= 1; k--) {
    const Fe q1 = fe_shfl(acc, 0, 2);  // q1_k, the even lane's
    const Fe addend = odd ? q1 : next;
    if (!odd && k >= 2) next = fe_load(crow + (int64_t)(k - 1) * ELEMS_PER_ROW);
    acc = fe_add(addend, fe_mul(r, acc, P), P);
    if (store) fe_store(orow + (int64_t)(k - 1) * ELEMS_PER_ROW, acc);  // q2_{k-1}
  }
  if (store) fe_store(orow + (int64_t)(n - 1) * ELEMS_PER_ROW, fe_zero());
}
