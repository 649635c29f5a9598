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
// is moved with 16-byte loads and stores (pass B's by the lanes that hold
// its four chunks, the others' by one thread).  All four are data movement:
// the bound is bytes.  The ranks that need row order (rank and
// pass B) come from warp votes: __match_any_sync on the id gives a row the
// lanes of its warp with the same id, the popcount of those below it its
// rank in the warp, and a scan of per-warp counts over the warps of a chunk
// (one thread an id, in shared memory) each warp's base; the same scan
// carries the running count from chunk to chunk, so the ranks are stable in
// row order.  No thread walks the rows of a chunk.
#pragma once

#define RADIX_RANK_THREADS 512     // rows a chunk of the rank; >= P (cb <= 9)
#define RADIX_RANK_WARPS (RADIX_RANK_THREADS / 32)
#define RADIX_SHUFFLE_THREADS 512
#define RADIX_MAX_OUT_ROWS 8704    // the tallest tile image make_plan gives (T = 4096)
#define RADIX_PASS_B_THREADS 512   // rows a chunk of pass B
#define RADIX_PASS_B_WARPS (RADIX_PASS_B_THREADS / 32)
#ifndef RADIX_PASS_B_STASH        // the host rehearsal builds with a smaller one
#define RADIX_PASS_B_STASH 16384   // R up to which pass B keeps its fine ids in shared memory
#endif
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

// The lanes of this thread's warp below it, as a mask (blocks are 1-D).
__device__ __forceinline__ unsigned int radix_lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Thread id of a chunk: cw[k][id], k = 0 .. WARPS - 1, holds warp k's rows of
// that id (0 where it has none).  Turns the counts into bases in place: each
// nonzero entry becomes the id's running count before warp k's rows, and run
// goes past the chunk.  Laid out [warp][id], so the threads of a warp read
// neighbouring words at each step and no bank is hit twice.
template <int WARPS, int IDS>
__device__ __forceinline__ void radix_column_scan(int (*cw)[IDS], int id, int& run) {
  int c[WARPS];
#pragma unroll
  for (int k = 0; k < WARPS; k++) c[k] = cw[k][id];
#pragma unroll
  for (int k = 0; k < WARPS; k++)
    if (c[k]) {
      cw[k][id] = run;
      run += c[k];
    }
}

// ---- 15. radix_rank: replaces radix._rank_kernel ---------------------------
//
// One block a tile, its rows in chunks of RADIX_RANK_THREADS, a row a thread,
// 32 consecutive rows a warp.  A thread loads its row (four 16-byte loads
// and the key; the next chunk's are loaded while this one is ranked) and
// takes its coarse id, -1 for a row of no point or a key past 2^c.  Then:
//   - __match_any_sync on the coarse id gives the row its peers in the warp,
//     the popcount of the peers below it its rank among them, and the lowest
//     peer writes the peers' count to cnt_w[warp][partition] (32 KB);
//   - thread p scans column p over the 16 warps (radix_column_scan): each
//     warp's base in partition p, the tile's running count carried on;
//   - rank = base + rank in the warp; the lowest peer zeroes its entry again
//     for the next chunk;
//   - spill = rank >= S: __ballot_sync of the spill flags, the popcount below
//     the lane and a sum of the warps' totals give the spill rank, the spill
//     rows of the earlier chunks carried on.
// dst: the row's place in the tile image, out_rows = dropped (a row of no
// point or with a key past 2^c, or a spill past the SP spill rows).  cnt: the
// valid rows of each partition, spilled ones included.  Three barriers a
// chunk.

__device__ __forceinline__ void radix_load_row(const uint4* src, uint4 (&row)[RADIX_PAY_CHUNKS]) {
  for (int k = 0; k < RADIX_PAY_CHUNKS; k++) row[k] = src[k];
}

__global__ void __launch_bounds__(RADIX_RANK_THREADS)
radix_rank_kernel(const int32_t* __restrict__ keys, const uint4* __restrict__ pay,
                  int32_t* __restrict__ dst, int32_t* __restrict__ cnt, int T, int fb,
                  int P, int S, int SP, int out_rows) {
  __shared__ int cnt_w[RADIX_RANK_WARPS][RADIX_RANK_THREADS];
  __shared__ int spill_w[RADIX_RANK_WARPS];
  const int t = threadIdx.x;
  const int w = t >> 5;
  const unsigned int below = radix_lanes_below();
  const int64_t base = (int64_t)blockIdx.x * T;
  if (t < P)
    for (int k = 0; k < RADIX_RANK_WARPS; k++) cnt_w[k][t] = 0;
  uint4 row[RADIX_PAY_CHUNKS];
  int key = 0;
  if (t < T) {
    radix_load_row(pay + (base + t) * RADIX_PAY_CHUNKS, row);
    key = keys[base + t];
  }
  __syncthreads();
  int run = 0;         // thread p: valid rows of partition p so far
  int spill_base = 0;  // spilled rows of the earlier chunks
  for (int c0 = 0; c0 < T; c0 += RADIX_RANK_THREADS) {
    const int i = c0 + t;
    int coarse = -1;
    if (i < T && radix_row_nonzero(row)) {
      const int k = key >> fb;
      if (k >= 0 && k < P) coarse = k;  // a key past 2^c is dropped; the caller flags it
    }
    if (i + RADIX_RANK_THREADS < T) {
      radix_load_row(pay + (base + i + RADIX_RANK_THREADS) * RADIX_PAY_CHUNKS, row);
      key = keys[base + i + RADIX_RANK_THREADS];
    }
    const unsigned int peers = __match_any_sync(0xFFFFFFFFu, coarse);
    const bool lead = (peers & below) == 0;
    if (coarse >= 0 && lead) cnt_w[w][coarse] = __popc(peers);
    __syncthreads();
    if (t < P) radix_column_scan<RADIX_RANK_WARPS, RADIX_RANK_THREADS>(cnt_w, t, run);
    __syncthreads();
    const int r = coarse >= 0 ? cnt_w[w][coarse] + __popc(peers & below) : 0;
    __syncwarp();
    if (coarse >= 0 && lead) cnt_w[w][coarse] = 0;
    const int spill = coarse >= 0 && r >= S;
    const unsigned int spills = __ballot_sync(0xFFFFFFFFu, spill);
    if ((t & 31) == 0) spill_w[w] = __popc(spills);
    __syncthreads();
    int before = spill_base, total = 0;
    for (int k = 0; k < RADIX_RANK_WARPS; k++) {
      const int s = spill_w[k];
      if (k < w) before += s;
      total += s;
    }
    if (i < T) {
      const int sp_rank = before + __popc(spills & below);
      int d;
      if (coarse < 0 || (spill && sp_rank >= SP)) d = out_rows;
      else if (spill) d = P * S + sp_rank;
      else d = coarse * S + r;
      dst[base + i] = d;
    }
    spill_base += total;  // spill_w is rewritten after the next chunk's first barrier
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
// One block a partition, its rows in chunks of RADIX_PASS_B_THREADS, a row a
// thread, 32 consecutive rows a warp.  Rows of no point have fine id 2^fb
// and land in the tail; their payload is zero.
//   pass 1 reads each row's payload (for "no point") and key word, 68 of its
//     80 bytes: the histogram of the fine ids, counted a warp at a time
//     (__match_any_sync on the fine id; the lowest peer adds the peers'
//     count), and, where R <= RADIX_PASS_B_STASH, each row's fine id kept in
//     shared memory as a byte (the stash).  fc = the histogram; its
//     exclusive scan gives each fine id its first place.
//   pass 2 reads the 64-byte payload of the rows with a point only (their
//     fine ids from the stash; past its R, every row's payload and key word
//     again, which takes 15 % more time a row: R = 16,640 against 16,384 on
//     an H100, chip_smoke.py) and ranks them as radix_rank does: per-warp
//     counts cnt_w[warp][fine id] and a column scan over the warps by thread
//     f, each fine id's next place carried from chunk to chunk.  A warp's 32
//     rows are 160 contiguous 16-byte chunks; lane l loads chunks l, l + 32,
//     ..., l + 128 (so each load of the warp covers 512 contiguous bytes)
//     and stores each at the place of its row, which it takes from the row's
//     lane by __shfl_sync: the four chunks of a row go out from neighbouring
//     lanes.
//     Thread-per-row loads and stores took 0.18 ms at the 2^20, c = 15 plan
//     where these take 0.14 (H100, chip_smoke.py's timing).
// Then rows [valid rows, R_pad) are written as zeros: the tail of rows of no
// point and the padding.

__device__ __forceinline__ int radix_fine_id(const uint4* row, int nf) {
  return radix_row_nonzero(row) ? (int)(row[RADIX_PAY_CHUNKS].x & (uint32_t)(nf - 1)) : nf;
}

__global__ void __launch_bounds__(RADIX_PASS_B_THREADS)
radix_pass_b_kernel(const uint4* __restrict__ main_rows, uint4* __restrict__ parts,
                    int32_t* __restrict__ fc, int64_t R, int64_t R_pad, int fb) {
  __shared__ uint8_t fine[RADIX_PASS_B_STASH];
  __shared__ int hist[RADIX_MAX_BINS];
  __shared__ int cnt_w[RADIX_PASS_B_WARPS][RADIX_MAX_BINS - 1];
  const int t = threadIdx.x;
  const int w = t >> 5;
  const int lane = t & 31;
  const unsigned int below = radix_lanes_below();
  const int nf = 1 << fb;
  const int bins = nf + 1;
  const bool stash = R <= RADIX_PASS_B_STASH;
  const uint4* in = main_rows + (int64_t)blockIdx.x * R * RADIX_IMG_CHUNKS;
  uint4* out = parts + (int64_t)blockIdx.x * R_pad * RADIX_PAY_CHUNKS;
  if (t < bins) hist[t] = 0;
  if (t < nf)
    for (int k = 0; k < RADIX_PASS_B_WARPS; k++) cnt_w[k][t] = 0;
  __syncthreads();
  for (int64_t j0 = 0; j0 < R; j0 += RADIX_PASS_B_THREADS) {
    const int64_t j = j0 + t;
    int f = -1;
    if (j < R) {
      f = radix_fine_id(in + j * RADIX_IMG_CHUNKS, nf);
      if (stash) fine[j] = (uint8_t)f;  // read back by this thread alone
    }
    const unsigned int peers = __match_any_sync(0xFFFFFFFFu, f);
    if (f >= 0 && (peers & below) == 0) atomicAdd(&hist[f], __popc(peers));
  }
  __syncthreads();
  int run = 0;  // thread f: the next place of fine id f
  if (t < bins) {
    fc[(int64_t)blockIdx.x * bins + t] = hist[t];
    for (int f = 0; f < t; f++) run += hist[f];
  }
  for (int64_t c0 = 0; c0 < R; c0 += RADIX_PASS_B_THREADS) {
    const int64_t j = c0 + t;
    int f = nf;
    if (j < R) f = stash ? fine[j] : radix_fine_id(in + j * RADIX_IMG_CHUNKS, nf);
    const uint4* wsrc = in + (c0 + 32 * w) * RADIX_IMG_CHUNKS;  // the warp's rows
    uint4 x[RADIX_IMG_CHUNKS];
    int fq[RADIX_IMG_CHUNKS];  // the fine id of the row of chunk lane + 32 m
#pragma unroll
    for (int m = 0; m < RADIX_IMG_CHUNKS; m++) {
      const int q = lane + 32 * m;
      fq[m] = __shfl_sync(0xFFFFFFFFu, f, q / RADIX_IMG_CHUNKS);
      if (q % RADIX_IMG_CHUNKS < RADIX_PAY_CHUNKS && fq[m] < nf) x[m] = wsrc[q];
    }
    const unsigned int peers = __match_any_sync(0xFFFFFFFFu, f);
    const bool lead = (peers & below) == 0;
    if (f < nf && lead) cnt_w[w][f] = __popc(peers);
    __syncthreads();
    if (t < nf) radix_column_scan<RADIX_PASS_B_WARPS, RADIX_MAX_BINS - 1>(cnt_w, t, run);
    __syncthreads();
    const int place = f < nf ? cnt_w[w][f] + __popc(peers & below) : 0;
    __syncwarp();
    if (f < nf && lead) cnt_w[w][f] = 0;
#pragma unroll
    for (int m = 0; m < RADIX_IMG_CHUNKS; m++) {
      const int q = lane + 32 * m;
      const int pq = __shfl_sync(0xFFFFFFFFu, place, q / RADIX_IMG_CHUNKS);
      if (q % RADIX_IMG_CHUNKS < RADIX_PAY_CHUNKS && fq[m] < nf)
        out[(int64_t)pq * RADIX_PAY_CHUNKS + q % RADIX_IMG_CHUNKS] = x[m];
    }
    __syncwarp();  // the zeroed entries before the next chunk's counts
  }
  const int64_t valid = R - hist[nf];
  for (int64_t k = valid * RADIX_PAY_CHUNKS + t; k < R_pad * RADIX_PAY_CHUNKS;
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
