// The four kernels of the radix reorder of one MSM window and their C
// launchers: the counterparts of the JAX package's ops/radix.py
// (_rank_kernel, _shuffle_kernel, _pass_b_kernel, _compact_kernel).  Included
// by kernels.cu after BLOCK, grid_for and global_index.
//
// A window's reorder puts the packed (x, y) rows of its points (16 words of
// 32 bits, 64 bytes; the affine identity is the all-zero row) into bucket
// order without a sort of the whole window.  Key = bucket id in [0, 2^c),
// split into a coarse id (key >> fb, P = 2^cb partitions) and a fine id
// (key & (2^fb - 1)):
//
//   rank     per tile of T rows: stable rank of each valid row within its
//            coarse partition, per-partition counts, spill ranks for rows
//            ranked past the S slots, and each row's place in the tile image
//   shuffle  per tile: the rows and their keys moved to those places; the
//            image is P x S slot rows, then SP spill rows, 80 bytes a row
//   pass B   per partition (its R = n_tiles * S slot rows, gathered
//            partition-major by plain PyTorch): a stable counting sort by
//            fine id; rows of no point go to the tail as zeros
//   compact  the partitions' row blocks end to end at 64-row aligned bases
//
// The TPU kernels permute rows with one-hot bf16 matrix products because its
// vector unit has no per-lane scatter; this card has one, so here every row
// is moved by one thread with 16-byte loads and stores, and the ranks that
// need row order are counted in shared memory.  All four are data movement:
// the bound is bytes.  In this first version the rank and pass-B walks (one
// thread per partition or fine id, walking the rows in order) are serial in
// the rows of a block, which keeps the ranks stable and needs only
// __syncthreads().
#pragma once

#define RADIX_RANK_THREADS 512     // rows a chunk of the rank walk; >= P (cb <= 9)
#define RADIX_SHUFFLE_THREADS 512
#define RADIX_MAX_OUT_ROWS 8704    // the tallest tile image make_plan gives (T = 4096)
#define RADIX_PASS_B_THREADS 256   // rows a chunk of the pass-B walk
#define RADIX_MAX_BINS 65          // 2^fb + 1 fine ids (fb <= 6), the last = no point
#define RADIX_PAY_CHUNKS 4         // 16-byte chunks of a 64-byte payload row
#define RADIX_IMG_CHUNKS 5         // ... of an 80-byte image row (payload, key, 3 zero words)

__device__ __forceinline__ bool radix_row_nonzero(const uint4* r) {
  uint32_t acc = 0;
  for (int k = 0; k < RADIX_PAY_CHUNKS; k++) acc |= r[k].x | r[k].y | r[k].z | r[k].w;
  return acc != 0;
}

__device__ __forceinline__ uint4 radix_zero4() {
  uint4 v;
  v.x = v.y = v.z = v.w = 0;
  return v;
}

// ---- 15. radix_rank: replaces radix._rank_kernel ---------------------------
//
// One block a tile, the tile's rows in chunks of RADIX_RANK_THREADS.  For each
// chunk a thread loads its row (four 16-byte loads) and writes its coarse id
// (-1 for a row of no point) to shared memory; then thread p walks the chunk
// in row order and numbers the rows of partition p, carrying its count from
// chunk to chunk, which makes the rank stable; then a Hillis-Steele scan of
// the chunk's spill flags, carried across chunks the same way, gives the
// spill ranks.  dst: the row's place in the tile image, out_rows = dropped (a
// row of no point or with a key past 2^c, or a spill past the SP spill rows).
// cnt: the valid rows of each partition, spilled ones included.

__global__ void __launch_bounds__(RADIX_RANK_THREADS)
radix_rank_kernel(const int32_t* __restrict__ keys, const uint4* __restrict__ pay,
                  int32_t* __restrict__ dst, int32_t* __restrict__ cnt, int T, int fb,
                  int P, int S, int SP, int out_rows) {
  __shared__ int part[RADIX_RANK_THREADS];
  __shared__ int rank[RADIX_RANK_THREADS];
  __shared__ int scan[2][RADIX_RANK_THREADS];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * T;
  int run = 0;         // thread p: valid rows of partition p so far
  int spill_base = 0;  // spilled rows of the earlier chunks
  for (int c0 = 0; c0 < T; c0 += RADIX_RANK_THREADS) {
    const int i = c0 + t;
    int coarse = -1;
    if (i < T && radix_row_nonzero(pay + (base + i) * RADIX_PAY_CHUNKS)) {
      const int k = keys[base + i] >> fb;
      if (k >= 0 && k < P) coarse = k;  // a key past 2^c is dropped; the caller flags it
    }
    part[t] = coarse;
    __syncthreads();
    if (t < P) {
      const int m = T - c0 < RADIX_RANK_THREADS ? T - c0 : RADIX_RANK_THREADS;
      for (int j = 0; j < m; j++)
        if (part[j] == t) rank[j] = run++;
    }
    __syncthreads();
    const int r = coarse >= 0 ? rank[t] : 0;
    const int spill = coarse >= 0 && r >= S;
    scan[0][t] = spill;
    __syncthreads();
    int src = 0;
    for (int d = 1; d < RADIX_RANK_THREADS; d <<= 1) {
      int v = scan[src][t];
      if (t >= d) v += scan[src][t - d];
      scan[src ^ 1][t] = v;
      src ^= 1;
      __syncthreads();
    }
    if (i < T) {
      const int sp_rank = spill_base + scan[src][t] - 1;
      int d;
      if (coarse < 0 || (spill && sp_rank >= SP)) d = out_rows;
      else if (spill) d = P * S + sp_rank;
      else d = coarse * S + r;
      dst[base + i] = d;
    }
    spill_base += scan[src][RADIX_RANK_THREADS - 1];
    __syncthreads();  // part, rank and scan are reused by the next chunk
  }
  if (t < P) cnt[(int64_t)blockIdx.x * P + t] = run;
}

// ---- 16. radix_shuffle: replaces radix._shuffle_kernel ---------------------
//
// One block a tile.  The block first inverts dst in shared memory (src_of[r]
// = the tile row that lands on image row r, -1 for none), then writes the
// whole image row by row, 16 bytes a thread, neighbouring threads on
// neighbouring chunks: payload chunks 0-3, then (key, 0, 0, 0); a row no
// source lands on is written as zeros.  So each image byte is written once
// and no zero-fill pass runs before it.

__global__ void __launch_bounds__(RADIX_SHUFFLE_THREADS)
radix_shuffle_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ dst,
                     const uint4* __restrict__ pay, uint4* __restrict__ tiles, int T,
                     int out_rows) {
  __shared__ int src_of[RADIX_MAX_OUT_ROWS];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * T;
  for (int r = t; r < out_rows; r += RADIX_SHUFFLE_THREADS) src_of[r] = -1;
  __syncthreads();
  for (int i = t; i < T; i += RADIX_SHUFFLE_THREADS) {
    const int d = dst[base + i];
    if (d >= 0 && d < out_rows) src_of[d] = i;
  }
  __syncthreads();
  uint4* out = tiles + (int64_t)blockIdx.x * out_rows * RADIX_IMG_CHUNKS;
  for (int k = t; k < out_rows * RADIX_IMG_CHUNKS; k += RADIX_SHUFFLE_THREADS) {
    const int r = k / RADIX_IMG_CHUNKS;
    const int ch = k - r * RADIX_IMG_CHUNKS;
    const int s = src_of[r];
    uint4 v = radix_zero4();
    if (s >= 0) {
      if (ch < RADIX_PAY_CHUNKS) v = pay[(base + s) * RADIX_PAY_CHUNKS + ch];
      else v.x = (uint32_t)keys[base + s];
    }
    out[k] = v;
  }
}

// ---- 17. radix_pass_b: replaces radix._pass_b_kernel -----------------------
//
// One block a partition.  A histogram of the fine ids (atomics in shared
// memory; the counts do not depend on their order) and its exclusive scan
// give each fine id its first place; then the rows in chunks of
// RADIX_PASS_B_THREADS: each thread holds its row in registers, thread f
// walks the chunk in row order and hands out the places of fine id f, and
// each thread stores its row there.  Rows of no point have fine id 2^fb and
// land in the tail; their payload is zero.  Rows [R, R_pad) are zeroed.

__device__ __forceinline__ int radix_fine_id(const uint4* row, int nf) {
  return radix_row_nonzero(row) ? (int)(row[RADIX_PAY_CHUNKS].x & (uint32_t)(nf - 1)) : nf;
}

__global__ void __launch_bounds__(RADIX_PASS_B_THREADS)
radix_pass_b_kernel(const uint4* __restrict__ main_rows, uint4* __restrict__ parts,
                    int32_t* __restrict__ fc, int64_t R, int64_t R_pad, int fb) {
  __shared__ int hist[RADIX_MAX_BINS];
  __shared__ int fine[RADIX_PASS_B_THREADS];
  __shared__ int place[RADIX_PASS_B_THREADS];
  const int t = threadIdx.x;
  const int nf = 1 << fb;
  const int bins = nf + 1;
  const uint4* in = main_rows + (int64_t)blockIdx.x * R * RADIX_IMG_CHUNKS;
  uint4* out = parts + (int64_t)blockIdx.x * R_pad * RADIX_PAY_CHUNKS;
  if (t < bins) hist[t] = 0;
  __syncthreads();
  for (int64_t j = t; j < R; j += RADIX_PASS_B_THREADS)
    atomicAdd(&hist[radix_fine_id(in + j * RADIX_IMG_CHUNKS, nf)], 1);
  __syncthreads();
  int run = 0;  // thread f: the next place of fine id f
  if (t < bins) {
    fc[(int64_t)blockIdx.x * bins + t] = hist[t];
    for (int f = 0; f < t; f++) run += hist[f];
  }
  for (int64_t c0 = 0; c0 < R; c0 += RADIX_PASS_B_THREADS) {
    const int64_t j = c0 + t;
    uint4 row[RADIX_PAY_CHUNKS];
    int f = -1;
    if (j < R) {
      const uint4* src = in + j * RADIX_IMG_CHUNKS;
      for (int k = 0; k < RADIX_PAY_CHUNKS; k++) row[k] = src[k];
      f = radix_fine_id(src, nf);
    }
    fine[t] = f;
    __syncthreads();
    if (t < bins) {
      const int m = R - c0 < RADIX_PASS_B_THREADS ? (int)(R - c0) : RADIX_PASS_B_THREADS;
      for (int k = 0; k < m; k++)
        if (fine[k] == t) place[k] = run++;
    }
    __syncthreads();
    if (j < R) {
      uint4* o = out + (int64_t)place[t] * RADIX_PAY_CHUNKS;
      for (int k = 0; k < RADIX_PAY_CHUNKS; k++) o[k] = row[k];
    }
    __syncthreads();  // fine and place are reused by the next chunk
  }
  for (int64_t k = R * RADIX_PAY_CHUNKS + t; k < R_pad * RADIX_PAY_CHUNKS;
       k += RADIX_PASS_B_THREADS)
    out[k] = radix_zero4();
}

// ---- 18. radix_compact: replaces radix._compact_kernel ---------------------
//
// The TPU issues one ordered copy per partition, R_pad rows to base4[p], so
// that partition p + 1 overwrites p's zero tail.  Here it is a gather, one
// thread per 16-byte chunk of an output row r: the row comes from the largest
// p with base4[p] <= r (base4 does not decrease; of equal bases the later
// partition wins, as the later copy would), at r - base4[p] if that is below
// R_pad, else it is zero.  No order between blocks is needed.

__global__ void __launch_bounds__(BLOCK)
radix_compact_kernel(const uint4* __restrict__ parts, const int32_t* __restrict__ base4,
                     uint4* __restrict__ out, int P, int64_t R_pad, int64_t n_rows) {
  const int64_t k = global_index();
  if (k >= n_rows * RADIX_PAY_CHUNKS) return;
  const int64_t r = k / RADIX_PAY_CHUNKS;
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (base4[mid] <= r) lo = mid;
    else hi = mid - 1;
  }
  const int64_t rr = r - base4[lo];
  uint4 v = radix_zero4();
  if (rr < R_pad) v = parts[((int64_t)lo * R_pad + rr) * RADIX_PAY_CHUNKS + k % RADIX_PAY_CHUNKS];
  out[k] = v;
}

// ---- C launchers ------------------------------------------------------------

extern "C" {

// keys (n_tiles * T) int32, pay (n_tiles * T, 16) -> dst (n_tiles * T), cnt (n_tiles, P).
int radix_rank_launch(const void* keys, const void* pay, void* dst, void* cnt, int64_t n_tiles,
                      int T, int fb, int P, int S, int SP, int out_rows, void* stream) {
  if (n_tiles > 0)
    radix_rank_kernel<<<(unsigned int)n_tiles, RADIX_RANK_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)keys, (const uint4*)pay, (int32_t*)dst, (int32_t*)cnt, T, fb, P, S, SP,
        out_rows);
  return (int)cudaGetLastError();
}

// -> tiles (n_tiles, out_rows, 20); out_rows <= RADIX_MAX_OUT_ROWS.
int radix_shuffle_launch(const void* keys, const void* dst, const void* pay, void* tiles,
                         int64_t n_tiles, int T, int out_rows, void* stream) {
  if (n_tiles > 0)
    radix_shuffle_kernel<<<(unsigned int)n_tiles, RADIX_SHUFFLE_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)keys, (const int32_t*)dst, (const uint4*)pay, (uint4*)tiles, T,
        out_rows);
  return (int)cudaGetLastError();
}

// main (P, R, 20) -> parts (P, R_pad, 16), fc (P, 2^fb + 1); fb <= 6.
int radix_pass_b_launch(const void* main_rows, void* parts, void* fc, int P, int64_t R,
                        int64_t R_pad, int fb, void* stream) {
  if (P > 0)
    radix_pass_b_kernel<<<(unsigned int)P, RADIX_PASS_B_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)main_rows, (uint4*)parts, (int32_t*)fc, R, R_pad, fb);
  return (int)cudaGetLastError();
}

// parts (P, R_pad, 16), base4 (P,) int32 with base4[0] = 0 -> out (n_rows, 16).
int radix_compact_launch(const void* parts, const void* base4, void* out, int P, int64_t R_pad,
                         int64_t n_rows, void* stream) {
  if (n_rows > 0)
    radix_compact_kernel<<<grid_for(n_rows * RADIX_PAY_CHUNKS, BLOCK), BLOCK, 0,
                           (cudaStream_t)stream>>>(
        (const uint4*)parts, (const int32_t*)base4, (uint4*)out, P, R_pad, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
