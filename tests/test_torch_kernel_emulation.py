"""The CUDA kernels' own source, run on the CPU: each ``.cu`` file of
``repro_torch/kernels/csrc`` compiled by the host C++ compiler against stub
CUDA headers, with one thread per block, and held against the kernel's plain
PyTorch version on the same inputs.

One thread stands in for a block: every phase of the kernels is a loop
``for (e = threadIdx.x; e < n; e += blockDim.x)`` whose iterations write
disjoint elements, and the phases are separated by ``__syncthreads()``, so
running each phase's loop whole on one thread, in order, computes what the
block computes; the learners' ``cp.async`` copies of the next update's
minibatch complete at once, and their side tasks (a row mean, the Adam
constants) fall on the one thread. What this checks on a machine without a
card: the kernels' indexing, shared-memory carve-up (the learners' resident
state, its permuted rows and the scratch), argument unpacking and op order.
What it cannot check: races, launch limits and the card's own
``expf``/``powf`` (the chip check does, ``chip_smoke.py``).

The bfloat16 ``gmm``, flash forward, flash backward, ``ssd_scan`` and
``wkv6_scan`` are the exceptions: their tensor-core kernels (TMA or the
threads' own staging, mbarriers or named barriers, ``wgmma``) have no
one-thread form, so without nvcc each source's launcher runs its host model
of that kernel instead (``csrc/gmm.cu``, ``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``, ``csrc/ssd_scan.cu``,
``csrc/wkv6_scan.cu``): the same blocks,
stage offsets, box coordinates, wgmma descriptors and epilogue, with TMA's
zero fill and 128-byte swizzle written out and each product read through
its descriptors as the tensor cores address the swizzled layouts; for the
flash kernels also the lanes of the CUDA cores' sums (the scores; in the
backward also dp) and their exchange into the accumulator fragment, the
softmax or p and ds, the three bf16 terms and their packing into A
fragments; for ``ssd_scan`` the blocks' tickets, the staging of x, B and C
into swizzled tiles, the two warpgroups' halves of the chunk's own state,
the carried states through their slots and flags, the decayed scores in
the accumulator fragment, the three-term packing of the scores, the
state and x w, and at P = 64 y's transpose within each quad of threads
(its shuffles exchanged between the modelled lanes); for ``wkv6_scan`` the
tickets, the 8- or 16-byte copies into swizzled tiles, the channels'
cumsums, the pairs within each sub-chunk and the u bonus on the CUDA cores,
the chunk's states at its sub-chunk ends and their two-term tiles, the
three- and two-term packing of every A fragment, and the carried states
through the ring's slots and flags. What the CPU no longer covers there:
the PTX, the barriers (and, for the scans, the blocks running at once and
waiting on their flags), the accumulator fragment layout on the card and
the tensor cores' own order of sums (``chip_smoke.py``'s ``check_gmm``,
``check_flash``, ``check_flash_bwd``, ``check_ssd`` and ``check_wkv`` hold
those on the card).

The learners' cases (``ddpg_learn``, ``episode_learn`` and their Adam
division) are in ``tests/test_torch_kernel_emulation_learners.py``, and the
flash backward's (dq, dk/dv) in
``tests/test_torch_kernel_emulation_flash_bwd.py``; both take this
module's fixtures.

Tolerances (measured):
``flash_attention_fwd`` float32 out and lse within 2e-6 relative (measured
4.8e-7 and 1.6e-7), bfloat16 (the tensor-core kernel's host model) out
within one bf16 ulp of its largest value (2^-7 relative; measured at most
2.1e-3, with at most 2.5e-5 of the elements more than one bf16 step away)
and lse within 2e-6 (measured 7.8e-8); ``gmm`` float32 (the CUDA-core
kernel) within 2e-6 relative, bfloat16 (the tensor-core kernel's host
model) within one bf16 ulp of the largest value (measured 0 and 0; at the
edge and whole tiles 0, and 2.1e-4 at D = 384, where one element rounds
the other way); ``ssd_scan`` y and state within 2e-6 relative in float32
(measured 6.6e-8 and 5.3e-9: the float64 cumsum rounds alike, the sums of
products differ in order), y within one bf16 ulp of its largest value and
the float32 state within 2e-6 in bfloat16 (the tensor-core kernel's host
model; measured at most 2.6e-9 and 2.0e-7, with no element more than one
bf16 step away); ``wkv6_scan`` y and state within 2e-6 relative in float32
(measured 2.7e-7 and 2.1e-8, strong decay included: the cumsums agree
bitwise, the sums of products differ in order), y within one bf16 ulp of its
largest value and the float32 state within 2e-6 in bfloat16 (the
tensor-core kernel's host model; measured at most 3.3e-3 and 2.1e-7, with
at most 1.1e-4 of the elements of y more than one bf16 step away).
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import TC_STAGES, \
    flash_attention_fwd_plain, scale_of, tc_smem_plan
from repro_torch.kernels.flash_attention import _bind as flash_bind
from repro_torch.kernels.gmm import STAGES as GMM_STAGES
from repro_torch.kernels.gmm import _bind as gmm_bind
from repro_torch.kernels.gmm import gmm_plain
from repro_torch.kernels.gmm import smem_plan as gmm_smem_plan
from repro_torch.kernels.ssd_scan import _bind as ssd_bind
from repro_torch.kernels.ssd_scan import smem_plan as ssd_smem_plan
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.kernels.ssd_scan import tc_scratch as ssd_tc_scratch
from repro_torch.kernels.ssd_scan import tc_smem_plan as ssd_tc_smem_plan
from repro_torch.kernels.wkv6_scan import _bind as wkv_bind
from repro_torch.kernels.wkv6_scan import smem_plan as wkv_smem_plan
from repro_torch.kernels.wkv6_scan import tc_scratch as wkv_tc_scratch
from repro_torch.kernels.wkv6_scan import tc_smem_plan as wkv_tc_smem_plan
from repro_torch.kernels.wkv6_scan import wkv6_scan_plain

STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct dim3_ { unsigned x, y, z; };
extern dim3_ threadIdx, blockIdx, blockDim;
extern float smem[];
inline void __syncthreads() {}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int __float2int_rn(float a) { return (int)std::nearbyint(a); }
using std::max;
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
struct cudaFuncAttributes {
  std::size_t sharedSizeBytes;
  int maxDynamicSharedSizeBytes;
};
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  *a = {0, 0};
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
"""
#: bfloat16 as its 16 bits; conversions round to nearest even (finite values)
BF16_STUB = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { std::uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
  std::uint32_t u = std::uint32_t(b.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  std::uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {std::uint16_t(u >> 16)};
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  return __float2bfloat16(f);
}
"""
DEFS = r"""
#include "cuda_runtime.h"
dim3_ threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
alignas(16) float smem[1 << 17];
"""
LAUNCH = re.compile(r"(\w+_kernel(?:<\w+>)?)"
                    r"<<<n, kThreads, smem, \(cudaStream_t\)stream>>>\(")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """name -> the ctypes library of ``csrc/<name>.cu`` built for the CPU."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    out = tmp_path_factory.mktemp("emulated")
    (out / "cuda_runtime.h").write_text(STUB)
    (out / "cuda_bf16.h").write_text(BF16_STUB)
    (out / "defs.cpp").write_text(DEFS)
    libs = {}
    for name in build.sources():
        for dep in build.dependencies(name)[1:]:
            shutil.copy(dep, out / dep.name)
        src = (build.CSRC / f"{name}.cu").read_text()
        src = src.replace("extern __shared__ float smem[];", "")
        src, count = LAUNCH.subn(
            r"for (blockIdx.x = 0; blockIdx.x < (unsigned)n; ++blockIdx.x) "
            r"\1(", src)
        assert count >= 1, name
        (out / f"{name}.cpp").write_text(src)
        lib = out / f"lib{name}.so"
        subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", "-I", str(out), "-o", str(lib),
                        str(out / f"{name}.cpp"), str(out / "defs.cpp")],
                       check=True, capture_output=True, timeout=300)
        libs[name] = ctypes.CDLL(str(lib))
    # the first torch.exp of a process may round some elements of a tensor
    # differently from every later call (seen on a [2, 3, 72, 72] tensor
    # in about 1 process of 6), which moves the plain versions' float32
    # results by up to ~5e-5: one call first, so that they are the same in
    # every process
    torch.exp(torch.zeros(8))
    return libs


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*(_clone(y) for y in x))


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fwd_source_matches_plain(emulated, causal, dtype):
    """Two query blocks and two key blocks of 64 (the causal loop stops at
    the diagonal for the first), GQA with two query heads per key/value
    head, two batch rows."""
    B, H, Kv, S, D = 2, 4, 2, 128, 16
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=dtype)
               for shape in ((B, H, S, D), (B, Kv, S, D), (B, Kv, S, D)))
    want_o, want_lse = flash_attention_fwd_plain(q, k, v, causal)
    got_o, got_lse = torch.empty_like(q), torch.empty((B, H, S))
    fn = emulated["flash_attention_fwd"].flash_attention_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
        [ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), got_o.data_ptr(),
             got_lse.data_ptr(), B, H, Kv, S, S, D, int(causal),
             int(dtype == torch.bfloat16), scale_of(D), None)
    assert err == 0
    assert _rel(got_lse, want_lse) <= 2e-6
    assert _rel(got_o, want_o) <= (2e-6 if dtype == torch.float32
                                   else 2.0 ** -7)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), got_o.data_ptr(),
              got_lse.data_ptr(), B, H, Kv, 96, 96, D, 1, 0, 1.0, None) == -1


def _bf16_steps(a, b):
    """Per element, |a - b| in units of the bfloat16 spacing at b (as
    ``chip_smoke.py`` counts them)."""
    b = b.float()
    _, exp = torch.frexp(b)
    step = torch.ldexp(torch.ones_like(b), exp - 8).clamp_min(2.0 ** -133)
    return (a.float() - b).abs() / step


@pytest.mark.parametrize("group", [8, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [128, 112, 64])
def test_flash_tensor_core_model_matches_plain(emulated, D, causal, group):
    """The bfloat16 launcher's host model of the tensor-core kernel at Sq =
    Sk = 192, a multiple of 64 but not of 128: the second query block runs
    past Sq (zero-filled rows, stores masked) and the second key tile past
    Sk (zero-filled keys, masked to -inf); D 112 and 64 zero-fill the head
    dim to 128. Two batch rows of 8 query heads over 1 (GQA group 8) or 8
    key/value heads. Every output written (the buffers start NaN); out
    within one bf16 ulp of the largest value and at most 1e-3 of the
    elements more than one bf16 step from the plain version (the card's
    share bound, which p rounded once to bf16 fails), at most 1e-3 of them
    differing at all (measured at most 3.4e-4; p as two bf16 terms instead
    of three puts 1.9e-3 to 2.3e-3 there), lse within 2e-6."""
    B, H, S = 2, 8, 192
    Kv = H // group
    rng = np.random.default_rng(11 + D + group + int(causal))
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16)
               for shape in ((B, H, S, D), (B, Kv, S, D), (B, Kv, S, D)))
    want_o, want_lse = flash_attention_fwd_plain(q, k, v, causal)
    got_o = torch.full_like(q, float("nan"))
    got_lse = torch.full((B, H, S), float("nan"))
    lib = flash_bind(emulated["flash_attention_fwd"])
    assert lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), got_o.data_ptr(),
        got_lse.data_ptr(), B, H, Kv, S, S, D, int(causal), 1, scale_of(D),
        None) == 0
    assert _rel(got_lse, want_lse) <= 2e-6
    assert _rel(got_o, want_o) <= 2.0 ** -7
    steps = _bf16_steps(got_o, want_o)
    assert float((steps > 1).float().mean()) <= 1e-3
    assert float((steps > 0).float().mean()) <= 1e-3


def test_flash_tensor_core_contract_and_plan(emulated):
    """The bfloat16 launcher takes D a multiple of 8 in [8, 128], Sq and Sk
    multiples of 64 and H a multiple of Kv, and refuses the rest with -1
    before it reads anything; the shared memory it asks for is
    ``tc_smem_plan``'s, with the stages ``kernels/flash_attention.py``
    states, within the 232,448 bytes a block may use."""
    lib = flash_bind(emulated["flash_attention_fwd"])
    for B, H, Kv, Sq, Sk, D in ((1, 4, 2, 96, 128, 64),
                                (1, 4, 2, 128, 160, 64),
                                (1, 4, 3, 128, 128, 64),
                                (1, 4, 0, 128, 128, 64),
                                (1, 4, 2, 128, 128, 136),
                                (1, 4, 2, 128, 128, 60),
                                (1, 4, 2, 128, 128, 0),
                                (0, 4, 2, 128, 128, 64),
                                (1, 4, 2, 0, 128, 64),
                                (1, 4, 2, 128, 0, 64)):
        assert lib.flash_attention_fwd_launch(
            None, None, None, None, None, B, H, Kv, Sq, Sk, D, 1, 1, 1.0,
            None) == -1
    assert lib.flash_attention_fwd_tc_stages() == TC_STAGES
    for stages in (2, 3):
        assert lib.flash_attention_fwd_tc_smem_bytes(stages) == \
            tc_smem_plan(stages)["total"]
    assert tc_smem_plan()["total"] == 230_440 <= 232_448


def _gmm_run(lib, shape, dtype, seed):
    """x, w from numpy; the launcher's output (NaN where it wrote nothing)
    and the plain version's."""
    E, C, D, F = shape
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((E, C, D)), dtype=dtype)
    w = torch.tensor(rng.standard_normal((E, D, F)), dtype=dtype)
    want = gmm_plain(x, w)
    got = torch.full_like(want, float("nan"))
    err = lib.gmm_launch(x.data_ptr(), w.data_ptr(), got.data_ptr(), E, C,
                         D, F, int(dtype == torch.bfloat16), None)
    return err, got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_source_matches_plain(emulated, dtype):
    """Three experts at C 128, D 160, F 192: float32 runs the CUDA-core
    kernel (two row tiles and three column tiles of 64, five chunks of 32),
    bfloat16 the tensor-core kernel's host model (one row tile of 128, two
    column tiles of 128, the second half past F, three K steps of 64, the
    last half past D); the last block of the plain version is partial. The
    launcher refuses a D that is not a multiple of 32."""
    E, C, D, F = 3, 128, 160, 192
    lib = gmm_bind(emulated["gmm"])
    err, got, want = _gmm_run(lib, (E, C, D, F), dtype, seed=7)
    assert err == 0
    bf16 = int(dtype == torch.bfloat16)
    assert lib.gmm_launch(got.data_ptr(), got.data_ptr(), got.data_ptr(), E,
                          C, 100, F, bf16, None) == -1
    tol = 2e-6 if dtype == torch.float32 else 2.0 ** -7
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("shape", [
    (3, 192, 160, 192),   # a partial row, column and K tile, three experts
    (1, 64, 32, 64),      # one tile, partial on every axis
    (2, 256, 128, 256),   # whole tiles only: two of each, two K steps
    (1, 128, 384, 128),   # six K steps: the ring of stages wraps
])
def test_gmm_tensor_core_model_matches_plain(emulated, shape):
    """The bfloat16 launcher's host model of the tensor-core kernel at edge
    and whole tiles: every output written (the buffer starts NaN), within
    one bf16 ulp of the largest value of the plain version."""
    err, got, want = _gmm_run(gmm_bind(emulated["gmm"]), shape,
                              torch.bfloat16, seed=sum(shape))
    assert err == 0
    assert _rel(got, want) <= 2.0 ** -7


def test_gmm_tensor_core_contract_and_plan(emulated):
    """The bfloat16 launcher takes C and F that are positive multiples of
    64 and D a positive multiple of 32, and refuses the rest with -1 before
    it reads anything; the shared memory it asks for is ``smem_plan``'s,
    with the stages ``kernels/gmm.py`` states, within the 232,448 bytes a
    block may use."""
    lib = gmm_bind(emulated["gmm"])
    for E, C, D, F in ((1, 96, 64, 64), (1, 64, 64, 96), (1, 64, 48, 64),
                       (0, 64, 64, 64), (1, 0, 64, 64), (1, 64, 0, 64),
                       (1, 64, 64, -64)):
        assert lib.gmm_launch(None, None, None, E, C, D, F, 1, None) == -1
    assert lib.gmm_stages() == GMM_STAGES
    for stages in (2, 3, 4, 5):
        assert lib.gmm_smem_bytes(stages) == gmm_smem_plan(stages)["total"]
    assert gmm_smem_plan()["total"] == 132_160 <= 232_448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (2, 3, 144, 32, 16, 72),    # odd chunk: a full and a partial sub-tile
    (1, 2, 128, 64, 64, 128),   # two full sub-tiles, N = P = 64
    (1, 2, 400, 16, 8, 200),    # zamba2's odd chunk of a 200-token prompt
])
def test_ssd_scan_source_matches_plain(emulated, b, h, s, p, n, chunk,
                                       dtype):
    """Two chunks per row (the state carried between them), the rows of a
    chunk in sub-tiles of 64, B and C shared by the heads of a batch row;
    the launcher refuses a chunk that does not divide S, and states the
    shared-memory plan."""
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((b * h, s, p)) * 0.5, dtype=dtype)
    dt = torch.tensor(rng.uniform(0.1, 0.9, (b * h, s)), dtype=torch.float32)
    A = -torch.tensor(rng.uniform(0.5, 2.0, b * h), dtype=torch.float32)
    Bm, Cm = (torch.tensor(rng.standard_normal((b, s, n)) * 0.3,
                           dtype=dtype) for _ in range(2))
    want_y, want_state = ssd_scan_plain(x, dt, A, Bm, Cm, heads=h,
                                        chunk=chunk)
    y = torch.empty_like(x)
    state = torch.empty((b * h, n, p))
    lib = ssd_bind(emulated["ssd_scan"])
    scratch = ssd_tc_scratch(b * h, s, chunk, "cpu")
    ptrs = [t.data_ptr() for t in (x, dt, A, Bm, Cm, y, state, *scratch)]
    bf16 = int(dtype == torch.bfloat16)
    assert lib.ssd_scan_launch(*ptrs, b * h, s, p, n, chunk, h, bf16,
                               None) == 0
    assert lib.ssd_scan_launch(*ptrs, b * h, s, p, n, 7, h, bf16,
                               None) == -1
    assert _rel(state, want_state) <= 2e-6
    assert _rel(y, want_y) <= (2e-6 if dtype == torch.float32
                               else 2.0 ** -7)
    for q in (1, 24, chunk, 200, 256):
        assert lib.ssd_scan_smem_bytes(q, n, p) == \
            ssd_smem_plan(q, n, p)["total"]


def _ssd_run(lib, shape, seed):
    """bf16 inputs from numpy as the source test draws them; the launcher's
    y and state (NaN where it wrote nothing) and the plain version's."""
    b, h, s, p, n, chunk = shape
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b * h, s, p)) * 0.5,
                     dtype=torch.bfloat16)
    dt = torch.tensor(rng.uniform(0.1, 0.9, (b * h, s)), dtype=torch.float32)
    A = -torch.tensor(rng.uniform(0.5, 2.0, b * h), dtype=torch.float32)
    Bm, Cm = (torch.tensor(rng.standard_normal((b, s, n)) * 0.3,
                           dtype=torch.bfloat16) for _ in range(2))
    want = ssd_scan_plain(x, dt, A, Bm, Cm, heads=h, chunk=chunk)
    y = torch.full_like(x, float("nan"))
    state = torch.full((b * h, n, p), float("nan"))
    scratch = ssd_tc_scratch(b * h, s, chunk, "cpu")
    err = lib.ssd_scan_launch(
        *(t.data_ptr() for t in (x, dt, A, Bm, Cm, y, state, *scratch)),
        b * h, s, p, n, chunk, h, 1, None)
    return err, (y, state), want, scratch


@pytest.mark.parametrize("shape", [
    (1, 2, 1024, 64, 64, 64),   # 16 chunks: the state carried 15 links
    (1, 3, 768, 64, 64, 256),   # three chunks of four row sub-tiles
    (2, 1, 96, 8, 12, 24),      # N, P and the chunk far below a tile
])
def test_ssd_tensor_core_model_matches_plain(emulated, shape):
    """The bfloat16 launcher's host model of the tensor-core kernel over
    many chunks per row (every state published, flagged and read back by
    the next chunk's block, the last chunk's written out), at chunk 256
    (both warpgroups' row sub-tiles) and at a chunk of one sub-tile with N
    and P zero-filled; every output written (the buffers start NaN), y
    within one bf16 ulp of its largest value with at most 1e-3 of the
    elements more than one bf16 step away, the float32 state within 2e-6
    (measured y 2.2e-4, 8.1e-4 and 0, at most 6.8e-6 of the elements over
    one step, the state at most 2.3e-7); every ticket taken and every flag
    but the last chunk's set."""
    err, got, want, (_, flags) = _ssd_run(ssd_bind(emulated["ssd_scan"]),
                                         shape, seed=sum(shape))
    assert err == 0
    y, state = got
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(state).all())
    assert _rel(y, want[0]) <= 2.0 ** -7
    assert float((_bf16_steps(y, want[0]) > 1).float().mean()) <= 1e-3
    assert _rel(state, want[1]) <= 2e-6
    b, h, s, _, _, chunk = shape
    nc = s // chunk
    assert int(flags[-1]) == nc * b * h
    assert flags[:(nc - 1) * b * h].eq(1).all()
    assert flags[(nc - 1) * b * h:-1].eq(0).all()


def test_ssd_tensor_core_contract_and_plan(emulated):
    """The bfloat16 launcher takes a chunk in [1, 256] that divides S, N
    and P multiples of 4 in [4, 64] and BH a positive multiple of heads,
    and refuses the rest with -1 before it reads anything, and x, B, C not
    8-byte aligned with -2; the shared memory it asks for is
    ``tc_smem_plan``'s, within the 232,448 bytes a block may use."""
    lib = ssd_bind(emulated["ssd_scan"])
    for BH, S, P, N, Q, heads in ((2, 512, 64, 64, 512, 1),
                                  (2, 300, 64, 64, 256, 1),
                                  (2, 256, 64, 68, 256, 1),
                                  (2, 256, 66, 64, 256, 1),
                                  (2, 256, 64, 0, 256, 1),
                                  (2, 256, 0, 64, 256, 1),
                                  (2, 256, 64, 64, 0, 1),
                                  (3, 256, 64, 64, 256, 2),
                                  (0, 256, 64, 64, 256, 1),
                                  (2, 0, 64, 64, 1, 1)):
        assert lib.ssd_scan_launch(*[None] * 9, BH, S, P, N, Q, heads, 1,
                                   None) == -1
    # bf16 rows are copied 8 bytes at a time: a misaligned x is refused
    assert lib.ssd_scan_launch(2, *[None] * 8, 2, 256, 64, 64, 256, 1, 1,
                               None) == -2
    assert lib.ssd_scan_tc_smem_bytes() == ssd_tc_smem_plan()["total"]
    assert ssd_tc_smem_plan()["total"] == 228_376 <= 232_448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,c,chunk,w0", [
    (3, 60, 16, 20, 0.0),    # rwkv6's smoke head size, a chunk below 64
    (2, 128, 64, 64, 0.0),   # rwkv6-3b's chunk and head size, two chunks
    (2, 128, 64, 64, 5.0),   # strong decay: |cumsum| ~9,600 per chunk
])
def test_wkv6_scan_source_matches_plain(emulated, bh, s, c, chunk, w0,
                                        dtype):
    """Several chunks per row (the state carried between them), the rows
    of a chunk in 4 x 4 score tiles; the launcher refuses a chunk that does
    not divide S, and states the shared-memory plan."""
    rng = np.random.default_rng(9)
    r, k, v = (torch.tensor(rng.standard_normal((bh, s, c)) * 0.5,
                            dtype=dtype) for _ in range(3))
    logw = -torch.tensor(np.exp(np.clip(
        rng.standard_normal((bh, s, c)) + w0, -8, 6)), dtype=torch.float32)
    u = torch.tensor(rng.standard_normal((bh, c)) * 0.5, dtype=torch.float32)
    want_y, want_state = wkv6_scan_plain(r, k, v, logw, u, chunk=chunk)
    y = torch.empty_like(r)
    state = torch.empty((bh, c, c))
    lib = wkv_bind(emulated["wkv6_scan"])
    scratch = wkv_tc_scratch(bh, "cpu")
    ptrs = [t.data_ptr() for t in (r, k, v, logw, u, y, state, *scratch)]
    bf16 = int(dtype == torch.bfloat16)
    assert lib.wkv6_scan_launch(*ptrs, bh, s, c, chunk, bf16, None) == 0
    assert lib.wkv6_scan_launch(*ptrs, bh, s, c, 7, bf16, None) == -1
    assert _rel(state, want_state) <= 2e-6
    assert _rel(y, want_y) <= (2e-6 if dtype == torch.float32
                               else 2.0 ** -7)
    for q in (1, 20, 24, 61, 64):
        assert lib.wkv6_scan_smem_bytes(q, c) == \
            wkv_smem_plan(q, c)["total"]


def _wkv_run(lib, shape, seed):
    """bf16 inputs from numpy as the source test draws them; the launcher's
    y and state (NaN where it wrote nothing), the plain version's, and the
    scratch."""
    bh, s, c, chunk, w0 = shape
    rng = np.random.default_rng(seed)
    r, k, v = (torch.tensor(rng.standard_normal((bh, s, c)) * 0.5,
                            dtype=torch.bfloat16) for _ in range(3))
    logw = -torch.tensor(np.exp(np.clip(
        rng.standard_normal((bh, s, c)) + w0, -8, 6)), dtype=torch.float32)
    u = torch.tensor(rng.standard_normal((bh, c)) * 0.5, dtype=torch.float32)
    want = wkv6_scan_plain(r, k, v, logw, u, chunk=chunk)
    y = torch.full_like(r, float("nan"))
    state = torch.full((bh, c, c), float("nan"))
    scratch = wkv_tc_scratch(bh, "cpu")
    err = lib.wkv6_scan_launch(
        *(t.data_ptr() for t in (r, k, v, logw, u, y, state, *scratch)),
        bh, s, c, chunk, 1, None)
    return err, (y, state), want, scratch


@pytest.mark.parametrize("shape", [
    (2, 1024, 64, 64, 0.0),   # 16 chunks: the ring's two slots reused
    (3, 120, 16, 24, 0.0),    # the smoke head size: a sub-chunk and a half
    (2, 96, 12, 48, 0.0),     # rows of 24 bytes: copied 8 bytes at a time
    (2, 68, 20, 17, 0.0),     # a chunk one step past a sub-chunk
    (2, 256, 64, 64, 5.0),    # strong decay
    (1, 8, 4, 1, 0.0),        # a step a chunk
])
def test_wkv6_tensor_core_model_matches_plain(emulated, shape):
    """The bfloat16 launcher's host model of the tensor-core kernel over
    many chunks per row (every state but the last published to the ring,
    flagged and read back by the next chunk's block, the last one written
    out), at chunks that are not a multiple of the 16-step sub-chunk and
    head sizes below 64, and under strong decay; every output written (the
    buffers start NaN), y within one bf16 ulp of its largest value with at
    most 1e-3 of the elements more than one bf16 step away, the float32
    state within 2e-6 (measured y at most 3.3e-3, at most 1.1e-4 of the
    elements over one step, the state at most 2.1e-7); every ticket taken
    and each slot's flag holding the chunk of its last state plus one."""
    err, got, want, (_, flags) = _wkv_run(wkv_bind(emulated["wkv6_scan"]),
                                          shape, seed=sum(shape[:4]))
    assert err == 0
    y, state = got
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(state).all())
    assert _rel(y, want[0]) <= 2.0 ** -7
    assert float((_bf16_steps(y, want[0]) > 1).float().mean()) <= 1e-3
    assert _rel(state, want[1]) <= 2e-6
    bh, s, _, chunk, _ = shape
    nc = s // chunk
    assert int(flags[-1]) == nc * bh
    want_flags = torch.zeros(bh, 2, dtype=torch.int32)
    for c in range(max(nc - 3, 0), nc - 1):  # the last state in each slot
        want_flags[:, c % 2] = c + 1
    assert torch.equal(flags[:-1].view(bh, 2), want_flags)


def test_wkv6_tensor_core_contract_and_plan(emulated):
    """The bfloat16 launcher takes a chunk in [1, 64] that divides S and C
    a multiple of 4 in [4, 64], and refuses the rest with -1 before it
    reads anything, and r, k, v not 8-byte aligned or logw not 16-byte
    aligned with -2; the shared
    memory it asks for is ``tc_smem_plan``'s, two blocks of which fit the
    233,472 bytes of an SM."""
    lib = wkv_bind(emulated["wkv6_scan"])
    for BH, S, C, Q in ((2, 130, 64, 65), (2, 100, 64, 64), (2, 128, 66, 64),
                        (2, 128, 0, 64), (2, 128, 68, 64), (2, 128, 64, 0),
                        (0, 128, 64, 64), (2, 0, 64, 1)):
        assert lib.wkv6_scan_launch(*[None] * 9, BH, S, C, Q, 1, None) == -1
    assert lib.wkv6_scan_launch(2, *[None] * 8, 2, 128, 64, 64, 1,
                                None) == -2
    assert lib.wkv6_scan_launch(None, None, None, 8, *[None] * 5, 2, 128,
                                64, 64, 1, None) == -2
    assert lib.wkv6_scan_tc_smem_bytes() == wkv_tc_smem_plan()["total"]
    assert 2 * (wkv_tc_smem_plan()["total"] + 1024) <= 233_472


@pytest.fixture(scope="module")
def learner_division(tmp_path_factory):
    """``ddpg::div_exact`` of ``csrc/ddpg_update.cuh`` built for the CPU,
    over arrays: (q, ok) of a / b (with ``root``, ``ddpg::sqrt_exact`` of
    a)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    out = tmp_path_factory.mktemp("division")
    (out / "cuda_runtime.h").write_text(STUB)
    shutil.copy(build.CSRC / "ddpg_update.cuh", out / "ddpg_update.cuh")
    (out / "div.cpp").write_text(
        '#include "ddpg_update.cuh"\n'
        'dim3_ threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};\n'
        'extern "C" void div_batch(const float* a, const float* b,\n'
        '                          float* q, int* ok, int n, int root) {\n'
        '  for (int i = 0; i < n; ++i) {\n'
        '    bool o = true;\n'
        '    q[i] = root ? ddpg::sqrt_exact(a[i])\n'
        '                : ddpg::div_exact(a[i], b[i], o);\n'
        '    ok[i] = o;\n'
        '  }\n'
        '}\n')
    lib = out / "libdiv.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(out), "-o", str(lib),
                    str(out / "div.cpp")], check=True, capture_output=True,
                   timeout=300)
    fn = ctypes.CDLL(str(lib)).div_batch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2

    def run(a, b, root=False):
        a = np.ascontiguousarray(a, np.float32)
        b = np.ascontiguousarray(b, np.float32)
        q = np.empty_like(a)
        ok = np.empty(a.shape, np.int32)
        fn(a.ctypes.data, b.ctypes.data, q.ctypes.data, ok.ctypes.data,
           a.size, int(root))
        return q, ok

    return run


def test_the_emulation_covers_every_source():
    assert build.sources() == ["ddpg_learn", "episode_learn",
                               "flash_attention_bwd", "flash_attention_fwd",
                               "gmm", "ssd_scan", "wkv6_scan"]
    assert pathlib.Path(build.CSRC / "ddpg_update.cuh").exists()
    assert pathlib.Path(build.CSRC / "tma_wgmma.cuh").exists()
