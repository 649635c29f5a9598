// The nine kernels of the field and curve layers and their C launchers
// (the five of the divisor merge tree are in ntt.cuh, the four of the MSM's
// radix reorder in radix.cuh, both included below).  Each kernel is one
// thread per element (per lane for the scan): it reads its (16,) rows, does
// the whole formula in registers (ff.cuh, ec.cuh) and writes its rows back.
// No kernel allocates or synchronises; a launcher enqueues on the stream it
// is given and returns cudaGetLastError().
//
// What bounds them on this card: mont_mul and mont_addsub move 192 bytes for
// at most 136 multiply-adds of 32 bits and are bound by bytes; the curve
// kernels do 7 to 23 field products on 5 to 10 rows and sit at the crossover
// of bytes and integer operations.  So every kernel keeps all intermediates
// of its formula in registers and touches device memory once per input and
// output, in 16-byte accesses.
#include <cuda_runtime.h>
#include "ec.cuh"

#define ELEMS_PER_ROW 16
#define BLOCK 128
#define SCAN_BLOCK 32

static inline unsigned int grid_for(int64_t n, int block) {
  return (unsigned int)((n + block - 1) / block);
}

__device__ __forceinline__ int64_t global_index() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

#include "ntt.cuh"
#include "radix.cuh"

// ---- 1. mont_mul: replaces pallas_ff.mont_mul ---------------------------------

__global__ void __launch_bounds__(BLOCK)
mont_mul_kernel(FieldParams P, const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b, uint32_t* __restrict__ out, int64_t n) {
  int64_t i = global_index();
  if (i >= n) return;
  Fe r = fe_mul(fe_load(a + i * ELEMS_PER_ROW), fe_load(b + i * ELEMS_PER_ROW), P);
  fe_store(out + i * ELEMS_PER_ROW, r);
}

// ---- 2. mont_addsub: replaces pallas_ff.mont_addsub ----------------------------

__global__ void __launch_bounds__(BLOCK)
mont_addsub_kernel(FieldParams P, int is_sub, const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, uint32_t* __restrict__ out, int64_t n) {
  int64_t i = global_index();
  if (i >= n) return;
  Fe x = fe_load(a + i * ELEMS_PER_ROW);
  Fe y = fe_load(b + i * ELEMS_PER_ROW);
  Fe r = is_sub ? fe_sub(x, y, P) : fe_add(x, y, P);
  fe_store(out + i * ELEMS_PER_ROW, r);
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

__global__ void __launch_bounds__(BLOCK)
ec_add_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
              const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
              uint32_t* ox, uint32_t* oy, uint32_t* oz, int64_t n) {
  int64_t i = global_index();
  if (i >= n) return;
  Jac r = ec_add_complete(jac_load(x1, y1, z1, i), jac_load(x2, y2, z2, i), P);
  jac_store(ox, oy, oz, i, r);
}

// ---- 4. ec_add_fast: replaces pallas_ff.ec_add_fast ----------------------------

__global__ void __launch_bounds__(BLOCK)
ec_add_fast_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                   const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                   uint32_t* ox, uint32_t* oy, uint32_t* oz, uint8_t* exc, int64_t n) {
  int64_t i = global_index();
  if (i >= n) return;
  bool e;
  Jac r = ec_add_fast(jac_load(x1, y1, z1, i), jac_load(x2, y2, z2, i), P, &e);
  jac_store(ox, oy, oz, i, r);
  exc[i] = e ? 1 : 0;
}

// ---- 5. ec_double: replaces pallas_ff.ec_double ---------------------------------

__global__ void __launch_bounds__(BLOCK)
ec_double_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                 uint32_t* ox, uint32_t* oy, uint32_t* oz, int64_t n) {
  int64_t i = global_index();
  if (i >= n) return;
  jac_store(ox, oy, oz, i, ec_double(jac_load(x1, y1, z1, i), P));
}

// ---- 6. fused_madd_scan_xyzz: replaces pallas_ff.fused_madd_scan_xyzz ------------
//
// The whole blinded prefix scan of one Pippenger window in one launch.  One
// thread owns one lane: it seeds its XYZZ carry at the blinding point T,
// walks its w consecutive packed rows (lane l owns rows l*w .. l*w + w - 1 of
// the sorted (g*w, 16) array, read in place: no transpose is materialised),
// and keeps the carry in registers for all w steps.  After each step it
// writes the carry as the inner prefix of that row, limb-major (w, 16, g) so
// that neighbouring lanes write neighbouring words.  At the end it writes its
// total as a (16,) row and its exception flag as one byte.

__global__ void __launch_bounds__(SCAN_BLOCK)
fused_madd_scan_xyzz_kernel(FieldParams P, Fe tx, Fe ty,
                            const uint32_t* __restrict__ rows, int w, int64_t g,
                            uint32_t* __restrict__ ix, uint32_t* __restrict__ iy,
                            uint32_t* __restrict__ izz, uint32_t* __restrict__ izzz,
                            uint32_t* __restrict__ totx, uint32_t* __restrict__ toty,
                            uint32_t* __restrict__ totzz, uint32_t* __restrict__ totzzz,
                            uint8_t* __restrict__ exc) {
  int64_t lane = global_index();
  if (lane >= g) return;
  Xyzz c;
  c.x = tx;
  c.y = ty;
  c.zz = fe_one(P);
  c.zzz = fe_one(P);
  bool any = false;
  const uint32_t* r = rows + lane * w * ELEMS_PER_ROW;
#pragma unroll 1
  for (int t = 0; t < w; t++) {
    Fe qx = fe_load_packed(r + (int64_t)t * ELEMS_PER_ROW);
    Fe qy = fe_load_packed(r + (int64_t)t * ELEMS_PER_ROW + FE_WORDS);
    bool e;
    c = ec_madd_xyzz_fast(c, qx, qy, P, &e);
    any = any || e;
    int64_t off = (int64_t)t * ELEMS_PER_ROW * g + lane;
    fe_store_limb_major(ix + off, g, c.x);
    fe_store_limb_major(iy + off, g, c.y);
    fe_store_limb_major(izz + off, g, c.zz);
    fe_store_limb_major(izzz + off, g, c.zzz);
  }
  fe_store(totx + lane * ELEMS_PER_ROW, c.x);
  fe_store(toty + lane * ELEMS_PER_ROW, c.y);
  fe_store(totzz + lane * ELEMS_PER_ROW, c.zz);
  fe_store(totzzz + lane * ELEMS_PER_ROW, c.zzz);
  exc[lane] = any ? 1 : 0;
}

// ---- 7. ec_madd_xyzz_fast: replaces pallas_ff.ec_madd_xyzz_fast -----------------
//
// One step of the blinded XYZZ prefix scan as a kernel of its own, for scans
// that step through their rows in Python (card windows below
// ops/msm.FUSED_SCAN_MIN_ROWS points, which the fused scan would walk with a
// handful of threads).  10 products on 6 rows in, 4 rows and a flag byte out:
// bound by bytes, and by the launch itself at the widths it is called with
// (half a window's points, so fewer than FUSED_SCAN_MIN_ROWS / 2 lanes).

__global__ void __launch_bounds__(BLOCK)
ec_madd_xyzz_fast_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1,
                         const uint32_t* zz1, const uint32_t* zzz1,
                         const uint32_t* qx, const uint32_t* qy,
                         uint32_t* ox, uint32_t* oy, uint32_t* ozz, uint32_t* ozzz,
                         uint8_t* exc, int64_t n) {
  int64_t i = global_index();
  if (i >= n) return;
  Xyzz c;
  c.x = fe_load(x1 + i * ELEMS_PER_ROW);
  c.y = fe_load(y1 + i * ELEMS_PER_ROW);
  c.zz = fe_load(zz1 + i * ELEMS_PER_ROW);
  c.zzz = fe_load(zzz1 + i * ELEMS_PER_ROW);
  bool e;
  Xyzz r = ec_madd_xyzz_fast(c, fe_load(qx + i * ELEMS_PER_ROW),
                             fe_load(qy + i * ELEMS_PER_ROW), P, &e);
  fe_store(ox + i * ELEMS_PER_ROW, r.x);
  fe_store(oy + i * ELEMS_PER_ROW, r.y);
  fe_store(ozz + i * ELEMS_PER_ROW, r.zz);
  fe_store(ozzz + i * ELEMS_PER_ROW, r.zzz);
  exc[i] = e ? 1 : 0;
}

// ---- 8. ec_add_mixed: replaces pallas_ff.ec_add_mixed ---------------------------
//
// Complete Jacobian + affine add, the step of the safe flavor's prefix scan.
// 18 products (the generic sum and the doubling, both computed, then
// selected) on 5 rows and one mask byte in, 3 rows out: bytes and operations
// nearly level, bytes the larger by a hair (513 bytes against 18 products and
// 21 adds an element).
// The JAX package streams the identity mask as a (B, 16) row; here it is one
// byte an element.

__global__ void __launch_bounds__(BLOCK)
ec_add_mixed_kernel(FieldParams P, const uint32_t* x1, const uint32_t* y1,
                    const uint32_t* z1, const uint32_t* qx, const uint32_t* qy,
                    const uint8_t* __restrict__ q_ident,
                    uint32_t* ox, uint32_t* oy, uint32_t* oz, int64_t n) {
  int64_t i = global_index();
  if (i >= n) return;
  Jac r = ec_add_mixed_complete(jac_load(x1, y1, z1, i),
                                fe_load(qx + i * ELEMS_PER_ROW),
                                fe_load(qy + i * ELEMS_PER_ROW), q_ident[i] != 0, P);
  jac_store(ox, oy, oz, i, r);
}

// ---- 9. ec_add_mixed_fast: replaces pallas_ff.ec_add_mixed_fast -----------------
//
// Jacobian + affine add with no exceptional path, the entry point
// EC.add_mixed_fast: 3 squarings and 8 products on 5 rows in, 3 rows and a
// flag byte out.  Bound by bytes (513 bytes against 11 products an element).
// The JAX package streams the flag as a (B, 16) row block; here it is one
// byte an element.

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

int mont_addsub_launch(const FieldParams* P, int is_sub, const void* a, const void* b,
                       void* out, int64_t n, void* stream) {
  if (n > 0)
    mont_addsub_kernel<<<grid_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, is_sub, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int ec_add_launch(const FieldParams* P, const void* x1, const void* y1, const void* z1,
                  const void* x2, const void* y2, const void* z2,
                  void* ox, void* oy, void* oz, int64_t n, void* stream) {
  if (n > 0)
    ec_add_kernel<<<grid_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

int ec_add_fast_launch(const FieldParams* P, const void* x1, const void* y1, const void* z1,
                       const void* x2, const void* y2, const void* z2,
                       void* ox, void* oy, void* oz, void* exc, int64_t n, void* stream) {
  if (n > 0)
    ec_add_fast_kernel<<<grid_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint8_t*)exc, n);
  return (int)cudaGetLastError();
}

int ec_double_launch(const FieldParams* P, const void* x1, const void* y1, const void* z1,
                     void* ox, void* oy, void* oz, int64_t n, void* stream) {
  if (n > 0)
    ec_double_kernel<<<grid_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

// tx, ty: the blinding point's Montgomery coordinates as 8 words of 32 bits.
int fused_madd_scan_xyzz_launch(const FieldParams* P, const uint32_t* tx, const uint32_t* ty,
                                const void* rows, int w, int64_t g,
                                void* ix, void* iy, void* izz, void* izzz,
                                void* totx, void* toty, void* totzz, void* totzzz,
                                void* exc, void* stream) {
  if (g > 0 && w > 0) {
    Fe fx, fy;
    for (int k = 0; k < FE_WORDS; k++) {
      fx.v[k] = tx[k];
      fy.v[k] = ty[k];
    }
    fused_madd_scan_xyzz_kernel<<<grid_for(g, SCAN_BLOCK), SCAN_BLOCK, 0,
                                  (cudaStream_t)stream>>>(
        *P, fx, fy, (const uint32_t*)rows, w, g,
        (uint32_t*)ix, (uint32_t*)iy, (uint32_t*)izz, (uint32_t*)izzz,
        (uint32_t*)totx, (uint32_t*)toty, (uint32_t*)totzz, (uint32_t*)totzzz,
        (uint8_t*)exc);
  }
  return (int)cudaGetLastError();
}

int ec_madd_xyzz_fast_launch(const FieldParams* P, const void* x1, const void* y1,
                             const void* zz1, const void* zzz1, const void* qx,
                             const void* qy, void* ox, void* oy, void* ozz, void* ozzz,
                             void* exc, int64_t n, void* stream) {
  if (n > 0)
    ec_madd_xyzz_fast_kernel<<<grid_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)zz1,
        (const uint32_t*)zzz1, (const uint32_t*)qx, (const uint32_t*)qy,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)ozz, (uint32_t*)ozzz,
        (uint8_t*)exc, n);
  return (int)cudaGetLastError();
}

int ec_add_mixed_launch(const FieldParams* P, const void* x1, const void* y1,
                        const void* z1, const void* qx, const void* qy,
                        const void* q_ident, void* ox, void* oy, void* oz,
                        int64_t n, void* stream) {
  if (n > 0)
    ec_add_mixed_kernel<<<grid_for(n, BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        *P, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
        (const uint32_t*)qx, (const uint32_t*)qy, (const uint8_t*)q_ident,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
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

}  // extern "C"
