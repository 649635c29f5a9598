"""The CUDA sources of the port, rehearsed without a card: csrc/kernels.cu
(with csrc/ntt.cuh, csrc/radix.cuh, csrc/poly.cuh and csrc/lines.cuh)
compiles for the host
with g++ behind a small shim, the
result is loaded in place of the nvcc library, and every kernel's wrapper is
held against its plain PyTorch version on CPU tensors.

The shim rewrites `kernel<<<grid, block, smem, stream>>>(...)` into a call of
host_launch, which runs the blocks one after another and each thread of a
block as a coroutine (ucontext) on the calling thread, with a stack of its
own.  The threads of a block take turns: one runs at a
time, in a fixed order (ascending thread index in even blocks, descending in
odd ones), and hands on to the next at each __syncthreads() or __syncwarp()
and when it returns; so a barrier is a whole round of the block (every
kernel reaches each __syncwarp() with all its lanes, so a block-wide barrier
is a stricter one), and a value read from another thread without a barrier
between its write and the read is, deterministically, the stale one for
half the pairs.  __shfl_sync and __shfl_up_sync, and the warp votes
__ballot_sync and __match_any_sync, go through a per-block exchange array
between two barriers; __popc is the compiler's popcount.  __shared__ arrays and the extern
__shared__ dynamic array are static (one block is alive at a time; the
launch's dynamic size is ignored), cudaFuncSetAttribute a stub and atomicAdd
an atomic fetch-and-add.

This checks the arithmetic of the device functions, the C interface and the
wrappers' pointer plumbing; that the sources compile with nvcc and run on
the card is chip_smoke.py's business.  Integer arithmetic: torch.equal."""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from halo2_liam_eagen_msm_tpu_torch.convert import JPoint
from halo2_liam_eagen_msm_tpu_torch.fields import PALLAS
from halo2_liam_eagen_msm_tpu_torch.limbs import ints_to_limbs, ints_to_mont_limbs, mont_limbs_to_ints
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ff as CF
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_lines as CL
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_ntt as CN
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_poly as CP
from halo2_liam_eagen_msm_tpu_torch.ops import cuda_radix as CR
from halo2_liam_eagen_msm_tpu_torch.ops import msm as M
from halo2_liam_eagen_msm_tpu_torch.ops import mxu_ff as MX
from halo2_liam_eagen_msm_tpu_torch.ops import radix as RX
from halo2_liam_eagen_msm_tpu_torch.ops.ec import ec
from halo2_liam_eagen_msm_tpu_torch.ops.ff import ff
from halo2_liam_eagen_msm_tpu_torch.ops.poly import Poly
from halo2_liam_eagen_msm_tpu_torch.utils import pyref

torch.set_num_threads(1)

CURVE = PALLAS
SPEC = PALLAS.field
B = 37  # ragged: not a multiple of the block of 128 threads
_CSRC = Path(CF.__file__).resolve().parent / "csrc"

_SHIM = """
#include <stdint.h>
#include <stdlib.h>
#include <ucontext.h>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct idx3 { unsigned int x; };
static idx3 blockIdx, threadIdx, blockDim, gridDim;
// The threads of one block, coroutines on the launching thread taking turns:
// the one at place cur of the order runs until a barrier or its end, then
// hands on to the next live place.
struct HostBlock {
  std::vector<ucontext_t> ctx;  // never moved once made (a context points into itself)
  std::vector<unsigned int> idx;
  std::vector<char> done;
  ucontext_t launcher;
  unsigned int cur;
  void (*body)(void*);
  void* arg;
};
static HostBlock* host_block;
static bool host_next_live(unsigned int& q) {
  const unsigned int n = (unsigned int)host_block->ctx.size();
  for (unsigned int k = 1; k <= n; k++) {
    q = (host_block->cur + k) % n;
    if (!host_block->done[q]) return true;
  }
  return false;
}
static inline void __syncthreads() {
  HostBlock* hb = host_block;
  unsigned int q;
  host_next_live(q);  // the running place is live, so there is one
  if (q == hb->cur) return;
  const unsigned int from = hb->cur;
  hb->cur = q;
  threadIdx.x = hb->idx[q];
  swapcontext(&hb->ctx[from], &hb->ctx[q]);
}
static void host_entry() {
  HostBlock* hb = host_block;
  hb->body(hb->arg);
  hb->done[hb->cur] = 1;
  unsigned int q;
  if (host_next_live(q)) {
    hb->cur = q;
    threadIdx.x = hb->idx[q];
    setcontext(&hb->ctx[q]);
  }
  // the last one returns to the launcher (uc_link)
}
static inline void __syncwarp() { __syncthreads(); }
static uint64_t host_xchg[1024];
template <class T>
static inline T __shfl_sync(unsigned int, T v, int src, int width = 32) {
  host_xchg[threadIdx.x] = (uint64_t)v;
  __syncthreads();
  const unsigned int w = (unsigned int)width;
  const T r = (T)host_xchg[(threadIdx.x & ~(w - 1)) | ((unsigned int)src & (w - 1))];
  __syncthreads();
  return r;
}
template <class T>
static inline T __shfl_up_sync(unsigned int, T v, unsigned int delta, int width = 32) {
  host_xchg[threadIdx.x] = (uint64_t)v;
  __syncthreads();
  const T r = (threadIdx.x & (unsigned int)(width - 1)) >= delta
      ? (T)host_xchg[threadIdx.x - delta] : v;
  __syncthreads();
  return r;
}
// The warp votes: every lane of the warp publishes, then reads the others'.
static inline unsigned int host_warp_mask(bool (*same)(uint64_t, uint64_t), uint64_t v) {
  host_xchg[threadIdx.x] = v;
  __syncthreads();
  const unsigned int w0 = threadIdx.x & ~31u;
  unsigned int r = 0;
  for (unsigned int k = 0; k < 32 && w0 + k < blockDim.x; k++)
    if (same(host_xchg[w0 + k], v)) r |= 1u << k;
  __syncthreads();
  return r;
}
static inline unsigned int __ballot_sync(unsigned int, int pred) {
  return host_warp_mask([](uint64_t o, uint64_t) { return o != 0; }, pred != 0);
}
template <class T>
static inline unsigned int __match_any_sync(unsigned int, T v) {
  return host_warp_mask([](uint64_t o, uint64_t m) { return o == m; }, (uint64_t)v);
}
static inline int __popc(unsigned int x) { return __builtin_popcount(x); }
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaErrorInvalidValue = 1 };
template <class F>
static inline int cudaFuncSetAttribute(F, int, int) { return 0; }
static inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
typedef void* cudaStream_t;
static inline int cudaGetLastError() { return 0; }
template <class F>
static void host_launch(unsigned int grid, unsigned int block, F body) {
  const size_t stack = (size_t)1 << 18;
  char* stacks = (char*)malloc(stack * block);
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned int b = 0; b < grid; b++) {
    HostBlock hb;
    hb.ctx.resize(block);
    hb.done.assign(block, 0);
    hb.body = [](void* f) { (*(F*)f)(); };
    hb.arg = &body;
    blockIdx.x = b;
    for (unsigned int k = 0; k < block; k++) {
      hb.idx.push_back(b % 2 ? block - 1 - k : k);
      getcontext(&hb.ctx[k]);
      hb.ctx[k].uc_stack.ss_sp = stacks + stack * k;
      hb.ctx[k].uc_stack.ss_size = stack;
      hb.ctx[k].uc_link = &hb.launcher;
      makecontext(&hb.ctx[k], host_entry, 0);
    }
    host_block = &hb;
    hb.cur = 0;
    threadIdx.x = hb.idx[0];
    swapcontext(&hb.launcher, &hb.ctx[0]);
  }
  free(stacks);
}
"""
_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?),\s*([^,]+?),\s*([^,]+?),\s*\(cudaStream_t\)\s*stream>>>\(",
                     re.S)
_DYN_SHARED = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")


def _rewrite_launches(src: str):
    """kernel<<<grid, block, smem, (cudaStream_t)stream>>>(args); ->
    host_launch(grid, block, [&]() { kernel(args); }); and the dynamic
    shared array a static one of 128 KB."""
    out, pos, count = [], 0, 0
    for m in _LAUNCH.finditer(src):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        assert src[i] == ";"
        out.append(src[pos:m.start()])
        out.append(f"host_launch({m.group(2)}, {m.group(3)}, [&]() {{ "
                   f"{m.group(1)}({src[m.end():i - 1]}); }})")
        pos = i
        count += 1
    out.append(src[pos:])
    return _DYN_SHARED.sub(r"static \1 \2[1 << 15];", "".join(out)), count


# radix_pass_b keeps its fine ids in shared memory up to this R in the host
# build (16,384 in csrc/radix.cuh), so that the host's plans take both routes
HOST_STASH_ROWS = 512


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the CUDA sources for the host")
    out = tmp_path_factory.mktemp("host_kernels")
    n = 0
    for name in ("kernels.cu", "ntt.cuh", "radix.cuh", "poly.cuh", "lines.cuh", "mxu.cuh"):
        src = (_CSRC / name).read_text().replace("#include <cuda_runtime.h>", _SHIM)
        src, count = _rewrite_launches(src)
        n += count
        (out / (name.replace(".cu", ".cpp") if name.endswith(".cu") else name)).write_text(src)
    assert n == len(CF.KERNELS), "every launcher launches one kernel"
    for name in ("ff.cuh", "ec.cuh"):
        shutil.copy(_CSRC / name, out / name)
    lib = out / "libkernels_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    f"-DRADIX_PASS_B_STASH={HOST_STASH_ROWS}",
                    "-o", str(lib), str(out / "kernels.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
    return lib


@pytest.fixture
def host_kernels(host_library, monkeypatch):
    """The wrappers of ops/cuda_ff.py on CPU tensors, bound to the host
    build."""
    def launch(name, dev, *args):
        rc = getattr(CF._lib(), name + "_launch")(*args, None)
        CF.LAUNCHES[name] += 1
        assert rc == 0

    monkeypatch.setattr(CF, "build_library", lambda: host_library)
    monkeypatch.setattr(CF, "_LIB", None)
    monkeypatch.setattr(CF, "_check_cuda", lambda name, *tensors: None)
    monkeypatch.setattr(CF, "_launch", launch)
    monkeypatch.setattr(CF, "_check_device", lambda name, *tensors: None)
    monkeypatch.setattr(CF, "_use_kernel", lambda t: True)
    return CF


def _field(nprng, b):
    vals = [int(v) for v in nprng.integers(0, 1 << 62, size=b)]
    vals = [(v * v * v * 0x9E3779B97F4A7C15 + 1) % SPEC.p for v in vals]
    vals[:4] = [0, SPEC.p - 1, 1, 0]
    return torch.from_numpy(ints_to_mont_limbs(vals, SPEC).view("int32").copy())


def _jacobian(rng, nprng, pts):
    """Host points -> Jacobian limbs with a random representative a lane."""
    E = ec(CURVE)
    p = E.points_from_ints(pts, "cpu")
    lam = _field(nprng, len(pts))
    lam[:, 0] |= 1
    mul = lambda u, v: CF.mont_mul_plain(SPEC, u, v)
    l2 = mul(lam, lam)
    z = torch.where(E.is_identity(p)[:, None], p.z, lam)
    return JPoint(mul(p.x, l2), mul(p.y, mul(l2, lam)), z)


def _edge_points(rng):
    """Two host lists with the edge lanes: p identity, q identity, both,
    q == p, q == -p."""
    p = pyref.random_points(rng, CURVE, B)
    q = pyref.random_points(rng, CURVE, B)
    p[0] = q[1] = p[2] = q[2] = None
    q[3] = p[3]
    q[4] = pyref.ec_neg(p[4], CURVE)
    return p, q


def _lm(nprng, e):
    """(16, e) limb-major field elements with the edge values first."""
    return _field(nprng, e).t().contiguous()


def _lm_case(name, nprng):
    """The five kernels of csrc/ntt.cuh.  The stages run at small sizes:
    stage_big at n = 16 (s = 8, 4), at n = 32 with E = 3 * 32 (s = 16, 8)
    and at s = 1024 (n = 2048); stages_small (and its first kernel) at
    tiles 2, 4, 8, 128 and 1024 over two tiles (the full tile: two blocks),
    and at n = 64 with E = 3 * 64."""
    if name == "lm_mul":
        return (lambda a, b: (CN.lm_mul(SPEC, a, b),),
                lambda a, b: (CN.lm_mul_plain(SPEC, a, b),), (_lm(nprng, B), _lm(nprng, B)))
    if name == "lm_addsub":
        def both(fn):
            return lambda a, b: (fn(SPEC, False, a, b), fn(SPEC, True, a, b))
        return both(CN.lm_addsub), both(CN.lm_addsub_plain), (_lm(nprng, B), _lm(nprng, B))
    if name == "lm_mul_const":
        c = (SPEC.r_mod_p * 0x1234567) % SPEC.p
        return (lambda a: (CN.lm_mul_const(SPEC, a, c), CN.lm_mul_const(SPEC, a, SPEC.p - 1)),
                lambda a: (CN.lm_mul_const_plain(SPEC, a, c),
                           CN.lm_mul_const_plain(SPEC, a, SPEC.p - 1)),
                (_lm(nprng, B),))
    cases = []
    if name == "stage_big":
        for logn, e, stages in ((4, 32, (8, 4)), (5, 96, (16, 8)), (11, 2048, (1024,))):
            for inverse in (False, True):
                tw = CN.tables(SPEC, logn, inverse, "cpu")
                cases += [(s, inverse, tw, e) for s in stages]
        fn, plain = CN.stage_big, CN.stage_big_plain
    else:
        assert name == "stages_small"
        # tiles 2, 4, 8, 128 and 1024 at E = two tiles, and 64 at E = three
        # (a ragged block for the kernel of the path): one window of 1 bit,
        # one of 2 bits, windows with a top window of 1 bit, 5 windows
        for logn, e in ((1, 4), (2, 8), (3, 16), (6, 192), (7, 256), (10, 2048)):
            for inverse in (False, True):
                cases.append((1 << logn, inverse, CN.tables(SPEC, logn, inverse, "cpu"), e))
        fn, plain = CN.stages_small, CN.stages_small_plain
    xs = [_lm(nprng, e) for *_, e in cases]
    return (lambda *x: tuple(fn(SPEC, xi, w, inv, tw) for xi, (w, inv, tw, _) in zip(x, cases)),
            lambda *x: tuple(plain(SPEC, xi, w, inv, tw) for xi, (w, inv, tw, _) in zip(x, cases)),
            tuple(xs))


def _radix_windows(nprng):
    """(plan, keys, payload) of two windows for the rank and shuffle kernels:
    two tiles of 256 rows (one chunk of the rank walk, partial), the first
    overflowing its spill rows, the second spilling some; and two tiles of
    768 rows (two chunks), 300 rows of each in one partition, so that ranks
    and spill ranks carry from chunk to chunk.  Identity rows and two keys
    out of range mixed in."""
    out = []
    for n, c, T, crowd in ((512, 8, 256, 200), (1536, 10, 768, 300)):
        plan = RX.make_plan(n, c, T)
        keys = nprng.integers(0, 1 << c, size=n).astype("int32")
        pay = nprng.integers(-1 << 31, 1 << 31, size=(n, 16)).astype("int32")
        pay[nprng.random(n) < 0.05] = 0
        keys[nprng.choice(T, size=crowd, replace=False)] = 9 << plan.fb
        keys[T + nprng.choice(T, size=30 + crowd // 2, replace=False)] = (3 << plan.fb) + 1
        keys[[1, T + 2]] = [1 << c, -7]  # keys past 2^c: dropped
        pay[[1, T + 2], 0] = 1
        out.append((plan, torch.from_numpy(keys), torch.from_numpy(pay)))
    return out


def _radix_case(name, nprng):
    """The four kernels of csrc/radix.cuh at the plans above; pass B also at a plan cut to 3 partitions of
    300 rows (2^3 + 1 fine ids, a zero tail to 320), compact at 6 partitions
    whose bases repeat (0, 64, 64, 128, 192, 192: partitions 1 and 4 are
    overwritten by the next) with rows past the last one."""
    if name in ("radix_rank", "radix_shuffle"):
        wins = _radix_windows(nprng)
        if name == "radix_rank":
            return (lambda *a: tuple(CR.rank(p, k, y) for p, k, y in wins),
                    lambda *a: tuple(CR.rank_plain(p, k, y) for p, k, y in wins), ())
        dsts = [CR.rank_plain(p, k, y)[0] for p, k, y in wins]
        return (lambda *a: tuple(CR.shuffle(p, k, d, y) for (p, k, y), d in zip(wins, dsts)),
                lambda *a: tuple(CR.shuffle_plain(p, k, d, y)
                                 for (p, k, y), d in zip(wins, dsts)), ())
    if name == "radix_pass_b":
        p, k, y = _radix_windows(nprng)[0]
        tiles = CR.shuffle_plain(p, k, CR.rank_plain(p, k, y)[0], y)
        main = tiles[:, :p.P * p.S].reshape(p.n_tiles, p.P, p.S, 20).transpose(0, 1) \
            .reshape(p.P, p.R, 20)
        cut = dataclasses.replace(RX.make_plan(1 << 18, 12), P=3, R=300, R_pad=320)
        rnd = torch.from_numpy(nprng.integers(-1 << 31, 1 << 31, size=(3, 300, 20)).astype("int32"))
        rnd[torch.from_numpy(nprng.random((3, 300)) < 0.2), :16] = 0
        cases = ((p, main), (cut, rnd))
        return (lambda *a: tuple(CR.pass_b(q, m) for q, m in cases),
                lambda *a: tuple(CR.pass_b_plain(q, m) for q, m in cases), ())
    assert name == "radix_compact"
    plan = dataclasses.replace(RX.make_plan(512, 8, 256), P=6, R_pad=64, n_ext=300)
    parts = torch.from_numpy(nprng.integers(-1 << 31, 1 << 31, size=(6, 64, 16)).astype("int32"))
    base4 = torch.tensor([0, 64, 64, 128, 192, 192], dtype=torch.int32)
    return (lambda *a: (CR.compact(plan, parts, base4),),
            lambda *a: (CR.compact_plain(plan, parts, base4),), ())


def _mont(v: int) -> int:
    return v * SPEC.r_mod_p % SPEC.p


def _mxu_case(name, nprng):
    """The tensor-core product by a constant (csrc/mxu.cuh).  mxu_mul_const
    at ragged 37 rows (two warp tiles of 32, the second partial) and at 600
    (19 tiles: two blocks, the warps of the first taking three tiles each),
    by five constants: a random one, 0, 1, the Montgomery one and p - 1's
    Montgomery form; the rows 0, p - 1 and 1 among the inputs (_field).
    mxu_mul_table at a (5, 8) table with 0 and the Montgomery one among its
    rows (a block a position, 5 of its 32 rows used), at (70, 5) and at
    (520, 4) (17 tiles a position: two blocks a position, the second
    block's warps starting at tile 4)."""
    if name == "mxu_mul_const":
        cs = [_mont(0x1234567 ** 5 % SPEC.p), 0, 1, SPEC.r_mod_p, _mont(SPEC.p - 1)]
        return (lambda *x: tuple(MX.mul_const(SPEC, xi, c) for xi in x for c in cs),
                lambda *x: tuple(MX.mul_const_plain(SPEC, xi, c) for xi in x for c in cs),
                (_field(nprng, B), _field(nprng, 600)))
    assert name == "mxu_mul_table"
    cases = []
    for lead, n_pos in ((5, 8), (70, 5), (520, 4)):
        table = _field(nprng, n_pos)
        table[1] = 0
        table[-1] = torch.from_numpy(ints_to_mont_limbs([1], SPEC).view("int32").copy())[0]
        cases.append((_field(nprng, lead * n_pos).reshape(lead, n_pos, 16), table))
    return (lambda *x: tuple(MX.mul_table(SPEC, a, t) for a, t in cases),
            lambda *x: tuple(MX.mul_table_plain(SPEC, a, t) for a, t in cases), ())


def _case(name, rng, nprng):
    """(kernel call, plain call, arguments) for kernel `name`."""
    E = ec(CURVE)
    if name.startswith("lm_") or name.startswith("stage"):
        return _lm_case(name, nprng)
    if name.startswith("mxu_"):
        return _mxu_case(name, nprng)
    if name.startswith("radix_"):
        return _radix_case(name, nprng)
    if name == "mont_mul":
        return (lambda a, b: (CF.mont_mul(SPEC, a, b),),
                lambda a, b: (CF.mont_mul_plain(SPEC, a, b),),
                (_field(nprng, B), _field(nprng, B)))
    if name == "batch_inv":
        # zeros at rows 0, 3, 20 and the last; chains of 1 (a power a row),
        # 4 (ten chains, the last three a row short) and 64 (one chain)
        a = _field(nprng, B)
        a[[20, B - 1]] = 0
        chains = (1, 4, 64)
        return (lambda a: tuple(CF.batch_inv(SPEC, a, chain=c) for c in chains),
                lambda a: tuple(CF.batch_inv_plain(SPEC, a, chain=c) for c in chains), (a,))
    if name == "mont_addsub":
        def both(fn):
            return lambda a, b: (fn(SPEC, False, a, b), fn(SPEC, True, a, b))
        return both(CF.mont_addsub), both(CF.mont_addsub_plain), \
            (_field(nprng, B), _field(nprng, B))
    if name == "poly_mul_naive":
        # (pairs, La, Lb): La = 17, Lb = 33 (49 outputs a pair, 10 pairs a
        # block: 7 pairs end in a ragged block), La > Lb,
        # La = 1, and Lb = 4 shared by all pairs (the substitution
        # polynomial of rf_mul)
        shapes = ((7, 17, 33), (3, 8, 3), (5, 1, 6))
        ops = [(_field(nprng, m * la).reshape(m, la, 16), _field(nprng, m * lb).reshape(m, lb, 16))
               for m, la, lb in shapes]
        ops.append((_field(nprng, 9 * 5).reshape(9, 5, 16), _field(nprng, 4).expand(9, 4, 16)))
        return (lambda *a: tuple(CP.poly_mul_naive(SPEC, x, y) for x, y in ops),
                lambda *a: tuple(CP.poly_mul_naive_plain(SPEC, x, y) for x, y in ops), ())
    if name.startswith("affine_lines"):
        # head and seeds on the edge slots of _edge_points (37 slots: a
        # ragged block)
        hp, hq = _edge_points(rng)
        ins = _lines_inputs(_jacobian(rng, nprng, hp), _jacobian(rng, nprng, hq))

        def both(fn):
            return lambda *a: (*fn(SPEC, True, *ins[True]), fn(SPEC, False, *ins[False])[0])
        return both(getattr(CL, name)), both(CL.affine_lines_plain), ()
    if name == "kate_div":
        # 37 pairs (a ragged second block) at n = 5 and 34 (two chunks of the
        # chain, the second one row), b = 0 in pair 3; one b for all pairs
        cases = []
        for n in (5, 34):
            b = _field(nprng, B)
            b[3] = 0
            cases.append((_field(nprng, B * n).reshape(B, n, 16), b))
        cases.append((_field(nprng, 6 * 3).reshape(6, 3, 16), _field(nprng, 1)[0]))
        return (lambda *a: tuple(CP.kate_div(SPEC, c, b) for c, b in cases),
                lambda *a: tuple(CP.kate_div_plain(SPEC, c, b) for c, b in cases), ())
    if name == "kate_div2":
        # 37 pairs (74 lanes: a ragged block of 128) at n = 5 and 34, ra = 0
        # in pair 3 and rb = 0 in pair 4; one pair of roots (p - 1, 1) for all
        # pairs
        cases = []
        for n in (5, 34):
            ra, rb = _field(nprng, B), _field(nprng, B)
            ra[3], rb[4] = 0, 0
            cases.append((_field(nprng, B * n).reshape(B, n, 16), ra, rb))
        cases.append((_field(nprng, 6 * 3).reshape(6, 3, 16), *_field(nprng, 4)[1:3]))
        return (lambda *a: tuple(CP.kate_div2(SPEC, *c) for c in cases),
                lambda *a: tuple(CP.kate_div2_plain(SPEC, *c) for c in cases), ())
    hp, hq = _edge_points(rng)
    p = _jacobian(rng, nprng, hp)
    if name in ("ec_add", "ec_add_fast", "ec_double"):
        args = tuple(p) if name == "ec_double" else (*p, *_jacobian(rng, nprng, hq))
        kernel = getattr(CF, name)
        plain = getattr(CF, name + "_plain")
        return (lambda *a: kernel(CURVE, *a)), (lambda *a: plain(CURVE, *a)), args
    qx, qy, qid = E.to_affine(E.points_from_ints(hq, "cpu"))
    if name == "ec_add_mixed":
        return (lambda *a: CF.ec_add_mixed(CURVE, *a),
                lambda *a: CF.ec_add_mixed_plain(CURVE, *a), (*p, qx, qy, qid))
    kernel = getattr(CF, name, None)
    if name == "ec_add_mixed_fast":
        return (lambda *a: kernel(CURVE, *a),
                lambda *a: CF.ec_add_mixed_fast_plain(CURVE, *a), (*p, qx, qy))
    if name == "ec_madd_xyzz_fast":
        return (lambda *a: kernel(CURVE, *a),
                lambda *a: CF.ec_madd_xyzz_fast_plain(CURVE, *a), (*_xyzz(p), qx, qy))
    assert name == "fused_madd_scan_xyzz"
    w, g = 4, 9  # nine carries of two lanes each: one ragged block of 32 carries
    pts = pyref.random_points(rng, CURVE, 8) * 5
    pts = pts[:w * g]
    pts[2] = pts[7] = None                                 # zero rows
    pts[5 * w] = pyref.ec_neg(E.offset_point_ints(), CURVE)  # flags lane 5
    ax, ay, _ = E.to_affine(E.points_from_ints(pts, "cpu"))
    t_limbs = tuple(tuple(int(v) for v in ints_to_mont_limbs([c], SPEC)[0])
                    for c in E.offset_point_ints())
    return (lambda rows: CF.fused_madd_scan_xyzz(CURVE, t_limbs, rows, w),
            lambda rows: CF.fused_madd_scan_xyzz_plain(CURVE, t_limbs, rows, w),
            (M._pack_pair(ax, ay).contiguous(),))


def _xyzz(p):
    """A Jacobian batch in XYZZ form: (x, y, z^2, z^3); the identity has zz
    = zzz = 0."""
    zz = CF.mont_mul_plain(SPEC, p.z, p.z)
    return p.x, p.y, zz, CF.mont_mul_plain(SPEC, zz, p.z)


def _lines_inputs(p, q):
    """affine_lines' inputs {head: (x, y, zinv)} from two Jacobian batches:
    (p, q, p + q) for the head, (p, q, -(p + q)) for the seeds, the Z of the
    three inverted at once."""
    out = JPoint(*CF.ec_add_plain(CURVE, *p, *q))
    neg = JPoint(out.x, CF.mont_addsub_plain(SPEC, True, torch.zeros_like(out.y), out.y), out.z)
    ins = {}
    for head, third in ((True, out), (False, neg)):
        x, y, z = (torch.stack(c) for c in zip(p, q, third))
        zinv = CF.batch_inv_plain(SPEC, z.reshape(-1, 16)).reshape(z.shape)
        ins[head] = (x, y, zinv)
    return ins


def _lines_ints(head, hp, hq):
    """affine_lines slot by slot on Python ints: (rows, flags) as ints, the
    lines through the canonical projective points (x, y, 1), (0, 1, 0) for
    the identity."""
    p = SPEC.p
    neg = lambda u: pyref.ec_neg(u, CURVE)

    def line(a, b):
        ax, ay, az = (0, 1, 0) if a is None else (a[0], a[1], 1)
        bx, by, bz = (0, 1, 0) if b is None else (b[0], b[1], 1)
        return [(ay * bz - az * by) % p, (az * bx - ax * bz) % p, (ax * by - ay * bx) % p]
    rows, flags = [], []
    for u, v in zip(hp, hq):
        if head:
            a, b, c = neg(u), neg(v), pyref.ec_add(u, v, CURVE)
            mask = u is None or v is None
        else:
            a, b = (u, v) if u is not None else (v, neg(v))
            c = neg(pyref.ec_add(u, v, CURVE)) if u is not None else None
            mask = u is None and v is None
        lv = line(a, b)
        deg = lv == [0, 0, 0] and not (head and mask)
        if deg:
            lv = line(a, c)
        if mask:
            lv = [0, 0, 1]
        if head:
            lv += [a[1] if a else 0, b[1] if b else 0, 1 if mask else u[0], 1 if mask else v[0]]
            flags.append((deg, mask))
        rows.append(lv)
    return rows, flags


def _flat(out):
    flat = []
    for o in out:
        flat.extend(o if isinstance(o, tuple) else [o])
    return flat


@pytest.mark.parametrize("name", CF.KERNELS)
def test_kernel_source_on_host_equals_plain(name, host_kernels, rng, nprng):
    kernel, plain, args = _case(name, rng, nprng)
    before = CF.LAUNCHES[name]
    got = _flat(kernel(*args))
    want = _flat(plain(*args))
    assert CF.LAUNCHES[name] > before
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    if name.startswith(("ec_madd_xyzz_fast", "ec_add_mixed_fast")):
        # identity carry, carry == Q, carry == -Q; qy == 0 passes unflagged
        assert got[-1].nonzero().flatten().tolist() == [0, 3, 4]
    if name == "fused_madd_scan_xyzz":
        assert got[8].nonzero().flatten().tolist() == [5]
    if name == "batch_inv":
        assert all(torch.equal(g, ff(SPEC)._inv_host(args[0])) for g in got)


def _rank_rows(nprng, plan):
    """Uniform keys in [0, 2^c) and random payload rows, 5 % of no point."""
    keys = nprng.integers(0, 1 << plan.c, size=plan.n).astype("int32")
    pay = nprng.integers(-1 << 31, 1 << 31, size=(plan.n, 16)).astype("int32")
    pay[nprng.random(plan.n) < 0.05] = 0
    return keys, pay


def _slot_rows(nprng, plan):
    """Random image rows (payload, key, three words) for pass B, 20 % of no
    point."""
    main = nprng.integers(-1 << 31, 1 << 31, size=(plan.P, plan.R, 20)).astype("int32")
    main[nprng.random((plan.P, plan.R)) < 0.2, :16] = 0
    return main


def _cut_plan(c: int, R: int):
    """A 2^18-point plan at width c cut to 3 partitions of R rows."""
    return dataclasses.replace(RX.make_plan(1 << 18, c), P=3, R=R, R_pad=-(-R // 64) * 64)


def _radix_edge_calls(case, nprng):
    """[("rank", plan, keys, pay) or ("pass_b", plan, main)] of one edge
    case.  Rank plans have two or four tiles of at most 768 rows (two chunks
    of the rank, the second partial); pass B's the main rows of such a plan
    or a cut plan of 3 partitions."""
    calls = []
    if case in ("one partition", "identity tile", "skewed warp"):
        plan = RX.make_plan(1536, 10, 768)
        keys, pay = _rank_rows(nprng, plan)
        if case == "one partition":  # tile 0 wholly in partition 5: 754 spills past SP
            keys[:768] = (5 << plan.fb) + nprng.integers(0, 1 << plan.fb, size=768)
        elif case == "identity tile":
            pay[768:] = 0
        else:  # whole warps of one partition, and of one fine id
            keys[64:96] = 3 << plan.fb
            keys[768 + 512:768 + 576] = (9 << plan.fb) + 2
        calls.append(("rank", plan, keys, pay))
        k, y = torch.from_numpy(keys), torch.from_numpy(pay)
        tiles = CR.shuffle_plain(plan, k, CR.rank_plain(plan, k, y)[0], y)
        calls.append(("pass_b", plan, RX.partition_major(plan, tiles).numpy()))
        if case == "skewed warp":  # one fine id in every lane, and over a whole partition
            plan = _cut_plan(15, 1100)
            main = _slot_rows(nprng, plan)
            main[0, 32:64, 16] = 7
            main[1, :, 16] = 64 * nprng.integers(0, 1 << 20, size=1100) + 40
            calls.append(("pass_b", plan, main))
    elif case == "keys out of range":  # past 2^c and negative
        plan = RX.make_plan(1024, 9, 256)
        keys, pay = _rank_rows(nprng, plan)
        pick = nprng.random(plan.n)
        keys[pick < 0.15] = nprng.integers(1 << plan.c, 1 << 31, size=int((pick < 0.15).sum()))
        keys[pick > 0.85] = -nprng.integers(1, 1 << 31, size=int((pick > 0.85).sum()))
        calls.append(("rank", plan, keys, pay))
    elif case.startswith("fb = "):
        fb = int(case[5:])
        plan = RX.make_plan(1536, 7 + fb, 768)
        assert plan.fb == fb
        calls.append(("rank", plan, *_rank_rows(nprng, plan)))
        plan = _cut_plan({3: 12, 5: 14, 6: 15}[fb], 1100)  # three chunks, the last partial
        assert plan.fb == fb
        calls.append(("pass_b", plan, _slot_rows(nprng, plan)))
    else:
        assert case == "ragged R"  # one partial chunk; one row past a chunk
        for r in (300, HOST_STASH_ROWS + 1):  # the stash's route, then the re-read's
            plan = _cut_plan(12, r)
            calls.append(("pass_b", plan, _slot_rows(nprng, plan)))
    return calls


RADIX_EDGE_CASES = ["one partition", "identity tile", "keys out of range", "fb = 3", "fb = 5",
                    "fb = 6", "ragged R", "skewed warp"]


@pytest.mark.parametrize("case", RADIX_EDGE_CASES)
def test_radix_ranks_edges_on_host(case, host_kernels, nprng):
    """radix_rank and radix_pass_b at the edges of stable ranks, equal to
    their plain versions output for output: a tile wholly in one partition (every
    lane of a warp a peer; spills past SP dropped), a tile of identity rows
    only, keys past 2^c and negative keys, fb = 3, 5 and 6, a pass-B
    partition whose R is not a multiple of the chunk, one fine id in every
    lane of a warp and over a whole partition.  Pass B by both routes: its
    fine ids kept in shared memory (R <= HOST_STASH_ROWS) and read again from
    the rows (R = 513 and 1100)."""
    calls = _radix_edge_calls(case, nprng)
    for kind, plan, *args in calls:
        args = [torch.from_numpy(a) for a in args]
        fn = CR.rank if kind == "rank" else CR.pass_b
        want = (CR.rank_plain if kind == "rank" else CR.pass_b_plain)(plan, *args)
        before = CF.LAUNCHES["radix_" + kind]
        got = fn(plan, *args)
        assert CF.LAUNCHES["radix_" + kind] == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    if case == "one partition":
        dst = CR.rank_plain(*calls[0][1:2], *map(torch.from_numpy, calls[0][2:]))[0]
        assert int((dst[:768] == calls[0][1].OUT_ROWS).sum()) == 768 - 14 - 128


@pytest.mark.parametrize("k", [0, 1, 2, 15])
def test_ec_double_k_on_host(k, host_kernels, rng, nprng):
    """ec_double (four lanes a point, k doublings a launch) at ragged B = 37
    with identities at lanes 0 and 2: equal to the plain version's k
    doublings limb for limb and to [2^k]P on Python ints."""
    hp, _ = _edge_points(rng)
    p = _jacobian(rng, nprng, hp)
    before = CF.LAUNCHES["ec_double"]
    got = CF.ec_double(CURVE, *p, k=k)
    assert CF.LAUNCHES["ec_double"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, CF.ec_double_plain(CURVE, *p, k=k)))
    assert ec(CURVE).points_to_ints(JPoint(*got)) == \
        [pyref.ec_mul(u, 1 << k, CURVE) if u else None for u in hp]


def _scan_rows(rng, g: int, w: int):
    """g carries and g*w affine rows of a safe scan, and the expected
    inclusive prefixes on Python ints.  Lanes open on an identity carry (0,
    34), an affine identity (1), q == the carry, a doubling (2, 32), q ==
    -carry, the identity (3), and both identities (4); where w > 2 the third
    row of lanes 5 and 33 doubles the carry and that of lane 6 cancels it.
    Identity rows are sprinkled in.  Both blocks of the kernel (32 carries
    a block) hold edges, so that the rehearsal runs them in both orders of
    its threads."""
    carries = pyref.random_points(rng, CURVE, g)
    base = pyref.random_points(rng, CURVE, 8)
    rows = [rng.choice(base) if rng.random() > 0.15 else None for _ in range(g * w)]
    carries[0] = carries[4] = carries[34] = None
    rows[w] = rows[4 * w] = None
    rows[2 * w], rows[32 * w] = carries[2], carries[32]
    rows[3 * w] = pyref.ec_neg(carries[3], CURVE)
    want = []
    for j in range(g):
        acc = carries[j]
        for t in range(w):
            i = j * w + t
            if w > 2 and t == 2 and j in (5, 6, 33):
                rows[i] = pyref.ec_neg(acc, CURVE) if j == 6 and acc else acc
            acc = pyref.ec_add(acc, rows[i], CURVE)
            want.append(acc)
    return carries, rows, want


@pytest.mark.parametrize("w", [1, 2, 64])
def test_ec_add_mixed_scan_on_host(w, host_kernels, rng, nprng):
    """ec_add_mixed's w-step scan (two lanes a carry) at ragged g = 37 lanes
    (two blocks of 32, the second partial) on the edges of _scan_rows: inner
    prefixes and totals equal to the plain version's loop limb for limb and
    to the prefixes on Python ints; w = 1 through the single add's wrapper
    too."""
    g = 37
    carries, rows, want = _scan_rows(rng, g, w)
    E = ec(CURVE)
    p = _jacobian(rng, nprng, carries)
    qx, qy, qid = E.to_affine(E.points_from_ints(rows, "cpu"))
    before = CF.LAUNCHES["ec_add_mixed"]
    inner, totals = CF.ec_add_mixed_scan(CURVE, *p, qx, qy, qid, w)
    assert CF.LAUNCHES["ec_add_mixed"] == before + 1
    want_inner, want_totals = CF.ec_add_mixed_scan_plain(CURVE, *p, qx, qy, qid, w)
    assert all(torch.equal(a, b) for a, b in zip(inner + totals, want_inner + want_totals))
    assert E.points_to_ints(JPoint(*inner)) == want
    assert E.points_to_ints(JPoint(*totals)) == want[w - 1::w]
    if w == 1:
        got = CF.ec_add_mixed(CURVE, *p, qx, qy, qid)
        assert all(torch.equal(a, b) for a, b in zip(got, inner))


def _xyzz_scan_rows(rng, g: int, w: int):
    """g carries and g*w affine rows of a blinded stepwise scan, each
    carry's flag and (flagged so far, inclusive prefix) at every step on
    Python ints.  Every block of the kernel (16 carries) holds edge lanes:
    an identity carry (0, 16, 32), an affine identity (1, 17), q == the
    carry (2, 18), q == -carry (3, 33) and both identities (4, 20), each at
    the lane's first step; where w > 2 the third row of lanes 5 and 21
    equals the running carry and that of lane 6 its negation.  Identity
    rows are sprinkled in."""
    carries = pyref.random_points(rng, CURVE, g)
    base = pyref.random_points(rng, CURVE, 8)
    rows = [rng.choice(base) if rng.random() > 0.15 else None for _ in range(g * w)]
    for j in (0, 4, 16, 20, 32):
        carries[j] = None
    for j in (1, 4, 17, 20):
        rows[j * w] = None
    for j in (2, 18):
        rows[j * w] = carries[j]
    for j in (3, 33):
        rows[j * w] = pyref.ec_neg(carries[j], CURVE)
    flags, want = [], []
    for j in range(g):
        acc, flag = carries[j], False
        for t in range(w):
            i = j * w + t
            if w > 2 and t == 2 and j in (5, 6, 21):
                rows[i] = pyref.ec_neg(acc, CURVE) if j == 6 else acc
            q = rows[i]
            flag = flag or (q is not None and (acc is None or q in (acc, pyref.ec_neg(acc, CURVE))))
            acc = pyref.ec_add(acc, q, CURVE)
            want.append((flag, acc))
        flags.append(flag)
    return carries, rows, flags, want


@pytest.mark.parametrize("logn", range(3, 11))
def test_stages_small_r1_on_host(logn, host_kernels, nprng):
    """stages_small's 1-bit window (R = 1, 512 threads a block of 1024
    elements, a barrier a stage), which the path's launcher takes at a tile
    of 2 alone, run at the tile 2^logn through the test-only launcher, forward
    and inverse: equal to the plain stages (_stage_plain, stage by stage)
    limb for limb, over two blocks (the second ragged below a tile of 1024:
    its spare tiles computed on zeros and not stored)."""
    tile = 1 << logn
    e = 2048 if tile == CN.BLOCK else CN.BLOCK + 3 * tile
    before = dict(CF.LAUNCHES)
    for inverse in (False, True):
        tw = CN.tables(SPEC, logn, inverse, "cpu")
        x = _lm(nprng, e)
        got = CN.stages_small_r1(SPEC, x, tile, inverse, tw)
        assert torch.equal(got, CN.stages_small_plain(SPEC, x, tile, inverse, tw))
    assert CF.LAUNCHES == before  # a probe, counted on no path


@pytest.mark.parametrize("w", [1, 2, 32])
def test_ec_madd_xyzz_fast_scan_on_host(w, host_kernels, rng, nprng):
    """ec_madd_xyzz_fast's w-step scan (four lanes a carry) at ragged g = 37
    carries (blocks of 16, the third partial) on the edges of
    _xyzz_scan_rows: inner prefixes, totals and flags equal to the plain
    version's loop limb for limb and flag for flag, and to the Python-int
    oracle (the flags exactly at the
    identity carries and carry == +-Q, the prefixes of every unflagged
    step); w = 1 through the single step's wrapper too."""
    g = 37
    carries, rows, flags, want = _xyzz_scan_rows(rng, g, w)
    E = ec(CURVE)
    c = _xyzz(_jacobian(rng, nprng, carries))
    qx, qy, _ = E.to_affine(E.points_from_ints(rows, "cpu"))
    before = CF.LAUNCHES["ec_madd_xyzz_fast"]
    inner, totals, exc = CF.ec_madd_xyzz_fast_scan(CURVE, *c, qx, qy, w)
    assert CF.LAUNCHES["ec_madd_xyzz_fast"] == before + 1
    want_inner, want_totals, want_exc = CF.ec_madd_xyzz_fast_scan_plain(CURVE, *c, qx, qy, w)
    assert all(torch.equal(a, b) for a, b in zip(inner + totals, want_inner + want_totals))
    assert exc.dtype == torch.bool and torch.equal(exc, want_exc) and exc.tolist() == flags
    got = E.points_to_ints(E.xyzz_to_jacobian(*inner))
    assert [u for u, (f, _) in zip(got, want) if not f] == [a for f, a in want if not f]
    if w == 1:
        *one, one_exc = CF.ec_madd_xyzz_fast(CURVE, *c, qx, qy)
        assert all(torch.equal(a, b) for a, b in zip(one, inner)) and torch.equal(one_exc, exc)


@pytest.mark.parametrize("n", [137, 300])
def test_ec_add_mixed_fast_on_host(n, host_kernels, rng, nprng):
    """ec_add_mixed_fast (a thread a point, blocks of 128) at ragged B, two
    and three blocks with the last one partial, with edge lanes in each
    block: an identity carry, an affine identity, both, carry == Q and
    carry == -Q, and carry == Q at the last row.  Equal to the plain version
    limb for limb and flag for flag; the flags exactly at the identity
    carries and carry == +-Q; every unflagged lane equal to the Python-int
    oracle."""
    E = ec(CURVE)
    hp = pyref.random_points(rng, CURVE, n)
    hq = pyref.random_points(rng, CURVE, n)
    flagged = []
    for b in range(0, n, 128):
        hp[b] = None
        hq[b + 1] = None
        hp[b + 2] = hq[b + 2] = None
        hq[b + 3] = hp[b + 3]
        hq[b + 4] = pyref.ec_neg(hp[b + 4], CURVE)
        flagged += [b, b + 3, b + 4]
    hq[n - 1] = hp[n - 1]
    flagged.append(n - 1)
    p = _jacobian(rng, nprng, hp)
    qx, qy, _ = E.to_affine(E.points_from_ints(hq, "cpu"))
    before = CF.LAUNCHES["ec_add_mixed_fast"]
    got = CF.ec_add_mixed_fast(CURVE, *p, qx, qy)
    assert CF.LAUNCHES["ec_add_mixed_fast"] == before + 1
    want = CF.ec_add_mixed_fast_plain(CURVE, *p, qx, qy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[3].nonzero().flatten().tolist() == flagged
    pts = E.points_to_ints(JPoint(*got[:3]))
    assert [pts[i] for i in range(n) if i not in flagged] == \
        [pyref.ec_add(hp[i], hq[i], CURVE) for i in range(n) if i not in flagged]


def test_flag_outputs_are_bool(host_kernels, rng, nprng):
    """Every flag a curve wrapper returns is a bool tensor, the one its
    kernel wrote: no comparison op (aten.ne, aten.eq) runs in the wrapper
    after the kernel.  The plain versions return bool flags too."""
    from chip_smoke import AtenOps

    E = ec(CURVE)
    hp, hq = _edge_points(rng)
    p, q = _jacobian(rng, nprng, hp), _jacobian(rng, nprng, hq)
    qx, qy, _ = E.to_affine(E.points_from_ints(hq, "cpu"))
    c = _xyzz(p)
    rows = M._pack_pair(qx[:36], qy[:36]).contiguous()
    t_limbs = tuple(tuple(int(v) for v in ints_to_mont_limbs([u], SPEC)[0])
                    for u in E.offset_point_ints())
    cols = [r[:36] for r in (qx, qy)]
    calls = {
        "ec_add_fast": (lambda: CF.ec_add_fast(CURVE, *p, *q)[-1],
                        lambda: CF.ec_add_fast_plain(CURVE, *p, *q)[-1]),
        "ec_madd_xyzz_fast": (lambda: CF.ec_madd_xyzz_fast(CURVE, *c, qx, qy)[-1],
                              lambda: CF.ec_madd_xyzz_fast_plain(CURVE, *c, qx, qy)[-1]),
        "ec_madd_xyzz_fast_scan": (
            lambda: CF.ec_madd_xyzz_fast_scan(CURVE, *(u[:18] for u in c), *cols, 2)[-1],
            lambda: CF.ec_madd_xyzz_fast_scan_plain(CURVE, *(u[:18] for u in c), *cols, 2)[-1]),
        "ec_add_mixed_fast": (lambda: CF.ec_add_mixed_fast(CURVE, *p, qx, qy)[-1],
                              lambda: CF.ec_add_mixed_fast_plain(CURVE, *p, qx, qy)[-1]),
        "fused_madd_scan_xyzz": (
            lambda: CF.fused_madd_scan_xyzz(CURVE, t_limbs, rows, 4)[-1],
            lambda: CF.fused_madd_scan_xyzz_plain(CURVE, t_limbs, rows, 4)[-1]),
    }
    for name, (wrapper, plain) in calls.items():
        with AtenOps() as ops:
            flags = wrapper()
        assert flags.dtype == torch.bool, name
        assert not [op for op in ops.names if op.startswith(("aten.ne", "aten.eq"))], name
        assert torch.equal(flags, plain()), name


def test_fused_merge_level_on_host_kernels(host_kernels, rng):
    """One fused merge level (two pairs at NTT size 128, the top pair of a
    128-point list at 128 too) through the limb-major tail with the five
    kernels of the host build, their wrappers' layout checks included: the
    same level as the plain versions give."""
    from halo2_liam_eagen_msm_tpu_torch import divisor as D

    pts = ec(CURVE).points_from_ints(pyref.random_points(rng, CURVE, 256), "cpu")
    lv, b_sem = D.seeds(CURVE, pts), 1
    for _ in range(5):
        b_sem *= 2
        lv = D.merge_level(CURVE, b_sem + 1, b_sem, lv)
    for m in (4, 2):  # two pairs, then one (pairs = 1: the top level's shape)
        a, b = D._take_level(lv, slice(0, m, 2)), D._take_level(lv, slice(1, m, 2))
        before = dict(CF.LAUNCHES)
        got = D.merge_pairs(CURVE, a, b)
        assert all(CF.LAUNCHES[k] > before[k] for k in
                   ("lm_mul", "lm_addsub", "lm_mul_const", "stages_small"))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(CF, "_use_kernel", lambda t: False)
            want = D.merge_pairs(CURVE, a, b)
        assert torch.equal(got.wtns.a, want.wtns.a) and torch.equal(got.wtns.b, want.wtns.b)


def _addsub_edges(rng):
    """B pairs (a, b) of reduced ints: 0, 1 and p - 1 on both sides; a + b = p
    exactly; a - b = 0; a < b; words of all ones up to each 64-bit boundary,
    so that a carry or a borrow crosses every lane of the row; the rest
    random."""
    p = SPEC.p
    pairs = [(0, 0), (0, 1), (1, 0), (1, 1), (p - 1, p - 1), (p - 1, 1), (1, p - 1),
             (0, p - 1), (p - 1, 0)]
    pairs += [(x, p - x) for x in (1 << 64, 1 << 128, 1 << 192, 12345)]
    pairs += [(x, x) for x in (7, 1 << 64, (1 << 192) - 1)]
    pairs += [(5, 7), (1 << 64, (1 << 64) + 1)]
    for k in (1, 2, 3):
        pairs += [((1 << 64 * k) - 1, 1), (1 << 64 * k, 1), (1, (1 << 64 * k) - 1)]
    pairs += [(p - 1, (1 << 192) - 1)]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(B - len(pairs))]
    return pairs


@pytest.mark.parametrize("name", ["mont_addsub"])
def test_mont_addsub_edges_on_host(name, host_kernels, rng):
    """The four-lane mont_addsub at the carry edges, at ragged B = 37: equal
    to the plain version and to exact ints, raw limbs."""
    pairs = _addsub_edges(rng)
    assert len(pairs) == B
    limbs = lambda xs: torch.from_numpy(ints_to_limbs(xs).view("int32").copy())
    a, b = limbs([x for x, _ in pairs]), limbs([y for _, y in pairs])
    for is_sub in (False, True):
        got = getattr(CF, name)(SPEC, is_sub, a, b)
        assert torch.equal(got, CF.mont_addsub_plain(SPEC, is_sub, a, b))
        want = [(x - y if is_sub else x + y) % SPEC.p for x, y in pairs]
        assert torch.equal(got, limbs(want))


@pytest.mark.parametrize("name", ["ec_add_fast", "affine_lines head", "affine_lines seeds",
                                  "affine_lines_v1 head", "affine_lines_v1 seeds"])
def test_ec_add_fast_edges_on_host(name, host_kernels, rng, nprng):
    """The four-lane ec_add_fast at ragged B = 37 with the edge lanes: p identity (passes q), q identity (passes p), both
    identities, P + P (flagged, the only flag), P + (-P) (z = 0, unflagged);
    equal to the plain version limb for limb and to the Python-int oracle on
    every unflagged lane.  The identities carry x and y of other lanes (any
    x, y with z = 0 is the identity), so that lane 2 pins the selects' order:
    a q identity passes p first.  affine_lines (head and seeds; two lanes a
    slot, and its first design, one thread) on the same slots (bypass
    slots 0-2, the tangent slot 3, P and -P in slot 4; the tangent slot's
    warp takes the second line, the others not): equal to its plain
    version, to the first design and to the lines on Python ints, every
    slot."""
    hp, hq = _edge_points(rng)
    p, q = _jacobian(rng, nprng, hp), _jacobian(rng, nprng, hq)
    for c, lane, src in ((p, 0, 5), (q, 1, 6), (p, 2, 7), (q, 2, 8)):
        c.x[lane], c.y[lane] = c.x[src], c.y[src]
    if name != "ec_add_fast":
        head = name.endswith("head")
        ins = _lines_inputs(p, q)[head]
        if name.startswith("affine_lines_v1"):
            rows, flags = CL.affine_lines_v1(SPEC, head, *ins)
        else:
            rows, flags = CL.affine_lines(SPEC, head, *ins)
            v1_rows, v1_flags = CL.affine_lines_v1(SPEC, head, *ins)
            assert torch.equal(rows, v1_rows)
            assert flags is v1_flags is None or torch.equal(flags, v1_flags)
        want_rows, want_flags = CL.affine_lines_plain(SPEC, head, *ins)
        assert torch.equal(rows, want_rows)
        assert flags is want_flags is None or torch.equal(flags, want_flags)
        ints, int_flags = _lines_ints(head, hp, hq)
        got = mont_limbs_to_ints(rows.reshape(-1, 16).numpy().view("uint32"), SPEC)
        assert [got[k * B + i] for i in range(B) for k in range(len(ints[0]))] == \
            [v for r in ints for v in r]
        if head:
            assert list(zip(*flags.tolist())) == int_flags
            assert int_flags[:5] == [(False, True)] * 3 + [(True, False), (False, False)]
        return
    got = getattr(CF, name)(CURVE, *p, *q)
    want = CF.ec_add_fast_plain(CURVE, *p, *q)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    *out, exc = got
    assert exc.nonzero().flatten().tolist() == [3]
    assert all(torch.equal(o[0], c[0]) for o, c in zip(out, q))
    assert all(torch.equal(o[k], c[k]) for o, c in zip(out, p) for k in (1, 2))
    assert int(out[2][4].abs().sum()) == 0
    pts = ec(CURVE).points_to_ints(JPoint(*out))
    assert [v for k, v in enumerate(pts) if k != 3] == \
        [pyref.ec_add(u, v, CURVE) for k, (u, v) in enumerate(zip(hp, hq)) if k != 3]


def _mont_rows(vals):
    """Python ints (any nesting of equal-length lists) -> Montgomery limbs."""
    arr = ints_to_mont_limbs([v for row in vals for v in row], SPEC).view("int32")
    return torch.from_numpy(arr.copy()).reshape(len(vals), len(vals[0]), 16)


def _raw_rows(vals):
    """Python ints -> limbs taken as they are (no Montgomery form)."""
    return torch.from_numpy(ints_to_limbs(vals).view("int32").copy())


def _from_rows(t):
    flat = mont_limbs_to_ints(t.reshape(-1, 16).numpy().view("uint32"), SPEC)
    width = t.shape[-2]
    return [flat[i:i + width] for i in range(0, len(flat), width)]


# (pairs, La, Lb) of each case (None: 3 pairs and one a reduction edge)
PMUL_EDGE_SHAPES = {
    "poly_mul_naive": ((13, 17, 33), (4, 9, 2), (6, 1, 5), (3, 1, 1), (3, 70, 66), (None, 17, 19)),
    "min_terms_le_2": ((13, 1, 2), (11, 2, 1), (7, 2, 2), (5, 2, 19), (9, 33, 1)),
}


@pytest.mark.parametrize("name", list(PMUL_EDGE_SHAPES))
@pytest.mark.parametrize("staging", ["shared", "device"])
def test_poly_mul_naive_edges_on_host(staging, name, host_kernels, monkeypatch, rng):
    """poly_mul_naive at its edges, equal to the plain version limb for limb
    and to the product of Python ints: raw limbs of p - 1 in every
    coefficient of pair 0 (the longest anti-diagonal sums min(La, Lb) such
    products), zero coefficients in pair 1 and a zero polynomial in pair 2.
    Case poly_mul_naive: 13 pairs of 17 x 33 (a ragged last block), La >
    Lb, La = 1 on both sides, and 3 pairs of 70 x 66, whose middle
    diagonals pass the lazy sums' run of 64 products (66 products: a run of
    64 and one of 2); and 17 x 19, where the pairs from 3 on have the
    17-product diagonal 16 built so that its REDC r = (T + m p) / R falls
    where a quotient from r's top words is hardest to take
    (cuda_poly.reduction_edges).  Case min_terms_le_2: the shapes of at most
    two products a diagonal (La = 1, Lb = 2 and the like), which take the
    first design's instantiation.
    Rows staged in shared memory, or read from device memory (the route of a
    pair too long to stage)."""
    if staging == "device":
        monkeypatch.setattr(CP, "PMUL_SMEM", 0)
    p = SPEC.p
    edge = _raw_rows([p - 1])[0]
    edges = CP.reduction_edges(SPEC, 17)
    for m, la, lb in PMUL_EDGE_SHAPES[name]:
        m = m or 3 + len(edges)
        xs = [[rng.randrange(p) for _ in range(la)] for _ in range(m)]
        ys = [[rng.randrange(p) for _ in range(lb)] for _ in range(m)]
        xs[1][::2] = [0] * len(xs[1][::2])
        ys[1][1::2] = [0] * len(ys[1][1::2])
        xs[2] = [0] * la
        a, b = _mont_rows(xs), _mont_rows(ys)
        a[0], b[0] = edge, edge
        if (la, lb) == (17, 19):
            for g, (xe, ye) in enumerate(edges, start=3):
                a[g] = _raw_rows(xe)
                b[g, :17] = _raw_rows(ye)
        got = CP.poly_mul_naive(SPEC, a, b)
        assert torch.equal(got, CP.poly_mul_naive_plain(SPEC, a, b))
        xs, ys = _from_rows(a), _from_rows(b)
        assert _from_rows(got) == [Poly(SPEC, x).mul_naive(Poly(SPEC, y)).coeffs
                                   for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n", [2, 17, 64, 35] + [
    pytest.param(("kate_div2", k), id=f"kate_div2-{k}") for k in (2, 17, 35, 64)])
def test_kate_div_edges_on_host(n, host_kernels, rng):
    """kate_div at ragged B = 37 pairs of n coefficients (n = 17: one whole
    chunk of the chain; 35: the round's longest; 64: three and a part): b =
    0 (the shift), b = p - 1 with every coefficient p - 1, zero
    coefficients, a zero polynomial; equal to the plain version limb for limb
    and to Poly.kate_div on Python ints, the last row zero.  kate_div2 on the
    same kind of pairs with a second root (ra = 0 in pair 0, rb = 0 in pairs
    4 and 5, ra = rb in pair 6): equal to its plain version, to kate_div
    launched twice and to Poly.kate_div twice."""
    if isinstance(n, tuple):
        _kate_div2_edges(n[1], rng)
        return
    p = SPEC.p
    cs = [[rng.randrange(p) for _ in range(n)] for _ in range(B)]
    bs = [rng.randrange(p) for _ in range(B)]
    bs[0] = 0
    cs[1], bs[1] = [p - 1] * n, p - 1
    cs[2][::3] = [0] * len(cs[2][::3])
    cs[3] = [0] * n
    coeffs, b = _mont_rows(cs), _mont_rows([bs])[0]
    got = CP.kate_div(SPEC, coeffs, b)
    assert torch.equal(got, CP.kate_div_plain(SPEC, coeffs, b))
    assert _from_rows(got) == [Poly(SPEC, c).kate_div(x).coeffs + [0] for c, x in zip(cs, bs)]
    assert _from_rows(got)[0] == cs[0][1:] + [0]


def _kate_div2_edges(n, rng):
    p = SPEC.p
    cs = [[rng.randrange(p) for _ in range(n)] for _ in range(B)]
    ras = [rng.randrange(p) for _ in range(B)]
    rbs = [rng.randrange(p) for _ in range(B)]
    ras[0] = 0
    cs[1], ras[1], rbs[1] = [p - 1] * n, p - 1, p - 1
    cs[2][::3] = [0] * len(cs[2][::3])
    cs[3] = [0] * n
    rbs[4] = rbs[5] = 0
    ras[5] = 0
    rbs[6] = ras[6]
    coeffs, ra, rb = _mont_rows(cs), _mont_rows([ras])[0], _mont_rows([rbs])[0]
    got = CP.kate_div2(SPEC, coeffs, ra, rb)
    assert torch.equal(got, CP.kate_div2_plain(SPEC, coeffs, ra, rb))
    assert torch.equal(got, CP.kate_div(SPEC, CP.kate_div(SPEC, coeffs, ra), rb))
    assert _from_rows(got) == [Poly(SPEC, c).kate_div(x).kate_div(y).coeffs + [0] * min(n, 2)
                               for c, x, y in zip(cs, ras, rbs)]


_NEIGHBOURS = """#include <cuda_runtime.h>
// Thread t of a 64-thread block publishes its value and takes thread t ^ 1's:
// through shared memory with or without a barrier between the write and the
// read, or through __shfl_sync (groups of 4) and __shfl_up_sync (by 1); or
// it takes its warp's vote on its value: __ballot_sync of x % 3 == 0, the
// __match_any_sync mask of x % 5; or __popc of a hash of x.
__global__ void neighbours_kernel(int how, uint32_t* out) {
  __shared__ uint32_t v[64];
  const unsigned int t = threadIdx.x;
  const uint32_t x = 7 * t + 1 + 1000 * blockIdx.x;
  uint32_t r;
  if (how < 2) {
    v[t] = x;
    if (how == 1) __syncthreads();
    r = v[t ^ 1];
  } else if (how == 2) {
    r = __shfl_sync(0xFFFFFFFFu, x, (int)(t & 3) ^ 1, 4);
  } else if (how == 3) {
    r = __shfl_up_sync(0xFFFFFFFFu, x, 1, 4);
  } else if (how == 4) {
    r = __ballot_sync(0xFFFFFFFFu, x % 3 == 0);
  } else if (how == 5) {
    r = __match_any_sync(0xFFFFFFFFu, x % 5);
  } else {
    r = (uint32_t)__popc(x * 0x9E3779B9u);
  }
  out[blockIdx.x * 64 + t] = r;
}
extern "C" int neighbours_launch(int how, void* out, void* stream) {
  neighbours_kernel<<<2, 64, 0, (cudaStream_t)stream>>>(how, (uint32_t*)out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def neighbours_library(host_library, tmp_path_factory):
    out = tmp_path_factory.mktemp("host_neighbours")
    src, count = _rewrite_launches(_NEIGHBOURS.replace("#include <cuda_runtime.h>", _SHIM))
    assert count == 1
    (out / "neighbours.cpp").write_text(src)
    lib = out / "libneighbours_host.so"
    subprocess.run([shutil.which("g++"), "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-o", str(lib), str(out / "neighbours.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).neighbours_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fn


SHIM_EXCHANGES = ["no barrier", "barrier", "shfl", "shfl_up", "ballot", "match_any", "popc"]


@pytest.mark.parametrize("how", SHIM_EXCHANGES)
def test_shim_exchanges_between_lanes(how, neighbours_library):
    """The shim's barrier and shuffles hand a neighbour's value over; a read
    of it without a barrier gets the stale value, for the lower thread of
    each pair in the ascending block and the upper one in the descending
    block, so a kernel that forgets its barrier fails the rehearsal.  The
    warp votes give every lane its own warp's mask (lanes in either order),
    __popc the popcount."""
    got = torch.zeros(128, dtype=torch.int32)
    neighbours_library(SHIM_EXCHANGES.index(how), got.data_ptr(), None)
    t = torch.arange(64).repeat(2)
    blk = torch.arange(2).repeat_interleave(64)
    x = 7 * t + 1 + 1000 * blk
    if how in ("ballot", "match_any", "popc"):
        x = x.tolist()
        if how == "popc":
            want = [bin(v * 0x9E3779B9 % 2**32).count("1") for v in x]
        else:
            same = (lambda u, v: u % 3 == 0) if how == "ballot" else \
                (lambda u, v: u % 5 == v % 5)
            want = [sum(1 << k for k in range(32) if same(x[i - i % 32 + k], x[i]))
                    for i in range(128)]
        assert got.numpy().view("uint32").tolist() == want
        return
    src = {"shfl_up": torch.where(t % 4 == 0, t, t - 1)}.get(how, t ^ 1)
    want = (7 * src + 1 + 1000 * blk).to(torch.int32)
    if how == "no barrier":
        stale = (got != want).nonzero().flatten()
        assert stale.tolist() == list(range(0, 64, 2)) + list(range(65, 128, 2))
    else:
        assert torch.equal(got, want)
