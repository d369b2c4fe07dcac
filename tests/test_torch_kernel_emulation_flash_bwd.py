"""The flash-attention backward kernels' own CUDA source run on the CPU,
held against their plain PyTorch version: ``csrc/flash_attention_bwd.cu``
(dq, and dk/dv) compiled by the host C++ compiler against stub CUDA
headers, as ``tests/test_torch_kernel_emulation.py`` (whose module
docstring says what this checks and what it cannot) builds it: the float32
CUDA-core kernels one thread per block, the bfloat16 tensor-core kernels
through their launchers' host models. The fixture ``emulated`` comes from
that module. These are its slow cases, in a file of their own so that the
files run on separate workers.

Tolerances (measured): float32 within 2e-6 relative (measured 4.2e-7);
bfloat16 (the tensor-core kernels' host models) within one bf16 ulp of the
largest value (2^-7 relative; measured at most 2.1e-3, with at most 9.3e-5
of the elements more than one bf16 step away).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import BWD_TC_STAGES, bind_bwd, \
    bwd_smem_plan, bwd_tc_smem_plan, flash_attention_bwd_plain, \
    flash_attention_fwd_plain, scale_of
from test_torch_kernel_emulation import _bf16_steps, _rel, \
    emulated  # noqa: F401 (fixture)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_source_matches_plain(emulated, causal, dtype):
    """Both backward launchers at S 128, D 16, GQA with two query heads per
    key/value head, two batch rows (float32: the CUDA-core kernels, two
    query and two key blocks of 64, the causal dq loop stopping at the
    diagonal and the dk/dv loop starting there; bfloat16: the tensor-core
    kernels' host models, one block of 128 rows and two tiles of 64); out
    and lse from the forward's plain version, delta as the wrapper computes
    it."""
    B, H, Kv, S, D = 2, 4, 2, 128, 16
    rng = np.random.default_rng(6)
    q, k, v, dout = (torch.tensor(rng.standard_normal(shape), dtype=dtype)
                     for shape in ((B, H, S, D), (B, Kv, S, D),
                                   (B, Kv, S, D), (B, H, S, D)))
    out, lse = flash_attention_fwd_plain(q, k, v, causal)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    delta = (dout.float() * out.float()).sum(-1)
    lib = bind_bwd(emulated["flash_attention_bwd"])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    args = [q, k, v, dout, lse, delta]
    for name, outs in (("dq", (dq,)), ("dkv", (dk, dv))):
        fn = getattr(lib, f"flash_attention_{name}_launch")
        ptrs = [t.data_ptr() for t in (*args, *outs)]
        assert fn(*ptrs, B, H, Kv, S, S, D, int(causal),
                  int(dtype == torch.bfloat16), scale_of(D), None) == 0
        assert fn(*ptrs, B, H, Kv, 96, 96, D, 1, 0, 1.0, None) == -1
    tol = 2e-6 if dtype == torch.float32 else 2.0 ** -7
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == ref.dtype
        assert _rel(got, ref) <= tol
    sizes = lib.flash_attention_bwd_smem_bytes
    for d in (16, 64, 128):
        plan = bwd_smem_plan(d)
        assert sizes(d, 0) == plan["dq"]["total"]
        assert sizes(d, 1) == plan["dkv"]["total"]


@pytest.mark.parametrize("group", [3, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [128, 112, 64])
def test_flash_bwd_tensor_core_model_matches_plain(emulated, D, causal,
                                                   group):
    """The bfloat16 launchers' host models of the tensor-core backward
    kernels at Sq = Sk = 192, a multiple of 64 but not of 128: the second
    dq block runs past Sq (zero-filled query rows, stores masked) and the
    second dk/dv block past Sk (zero-filled keys, stores masked); D 112 and
    64 zero-fill the head dim to 128. Three query heads over one key/value
    head (phi4-mini's group of 3) or over three. Every output written (the
    buffers start NaN); dq, dk, dv within one bf16 ulp of the largest value
    (measured at most 2.1e-3), at most 1e-3 of the elements more than one
    bf16 step from the plain version (the card's bound; measured at most
    9.3e-5) and at most 2e-3 differing at all (measured at most 7.4e-4)."""
    B, H, S = 1, 3, 192
    Kv = H // group
    rng = np.random.default_rng(21 + D + group + int(causal))
    q, k, v, dout = (torch.tensor(rng.standard_normal(shape),
                                  dtype=torch.bfloat16)
                     for shape in ((B, H, S, D), (B, Kv, S, D),
                                   (B, Kv, S, D), (B, H, S, D)))
    out, lse = flash_attention_fwd_plain(q, k, v, causal)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    delta = (dout.float() * out.float()).sum(-1)
    lib = bind_bwd(emulated["flash_attention_bwd"])
    got = [torch.full_like(x, float("nan")) for x in (q, k, v)]
    args = [t.data_ptr() for t in (q, k, v, dout, lse, delta)]
    dims = (B, H, Kv, S, S, D, int(causal), 1, scale_of(D), None)
    assert lib.flash_attention_dq_launch(*args, got[0].data_ptr(),
                                         *dims) == 0
    assert lib.flash_attention_dkv_launch(*args, got[1].data_ptr(),
                                          got[2].data_ptr(), *dims) == 0
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        assert _rel(g, w) <= 2.0 ** -7
        steps = _bf16_steps(g, w)
        assert float((steps > 1).float().mean()) <= 1e-3
        assert float((steps > 0).float().mean()) <= 2e-3


def test_flash_bwd_tensor_core_contract_and_plan(emulated):
    """Both bfloat16 launchers take D a multiple of 8 in [8, 128], Sq and
    Sk multiples of 64 and H a multiple of Kv, and refuse the rest with -1
    before they read anything; the shared memory each tensor-core kernel
    asks for is ``bwd_tc_smem_plan``'s, with the stages
    ``kernels/flash_attention.py`` states, within the 232,448 bytes a block
    may use."""
    lib = bind_bwd(emulated["flash_attention_bwd"])
    for B, H, Kv, Sq, Sk, D in ((1, 3, 1, 96, 128, 64),
                                (1, 3, 1, 128, 160, 64),
                                (1, 4, 3, 128, 128, 64),
                                (1, 4, 0, 128, 128, 64),
                                (1, 3, 1, 128, 128, 136),
                                (1, 3, 1, 128, 128, 60),
                                (1, 3, 1, 128, 128, 0),
                                (0, 3, 1, 128, 128, 64),
                                (1, 3, 1, 0, 128, 64),
                                (1, 3, 1, 128, 0, 64)):
        dims = (B, H, Kv, Sq, Sk, D, 1, 1, 1.0, None)
        assert lib.flash_attention_dq_launch(*[None] * 7, *dims) == -1
        assert lib.flash_attention_dkv_launch(*[None] * 8, *dims) == -1
    for which, name in ((0, "dq"), (1, "dkv")):
        assert lib.flash_attention_bwd_tc_stages(which) == \
            BWD_TC_STAGES[name]
        for stages in (2, 3):
            assert lib.flash_attention_bwd_tc_smem_bytes(which, stages) == \
                bwd_tc_smem_plan({name: stages})[name]["total"]
    plan = bwd_tc_smem_plan()
    assert plan["dq"]["total"] == 230_448 <= 232_448
    assert plan["dkv"]["total"] == 230_952 <= 232_448
    assert bwd_smem_plan(64)["dq_tc"] == plan["dq"]
    assert bwd_smem_plan(128)["dkv_tc"] == plan["dkv"]
