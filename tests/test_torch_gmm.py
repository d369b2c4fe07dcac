"""The port's grouped matmul (``repro_torch.kernels.gmm``, and its dispatch
``kernels.ops.grouped_matmul`` / ``grouped_swiglu``) against the JAX
package's Pallas kernel ``gmm`` (run in interpret mode, as the JAX
package's own tests run it on the CPU) and its oracle
``kernels/ref.py::grouped_swiglu_ref``, on the same numpy inputs.

Tolerances, as max|port - jax| / max|jax| (measured on the CPU):
- ``gmm_plain`` vs ``gmm`` (interpret) at the reference's own test shapes
  (D <= 256, one contraction block): float32 within 2e-6, bfloat16 within
  2^-7 (measured 0 and 0: equal; at D = 512 the two libraries' products sum
  in another order, measured 9.2e-7 in float32);
- ``grouped_swiglu`` vs ``grouped_swiglu_ref``: float32 within 1e-6
  (measured 1.5e-7), bfloat16 within 2^-6 (measured 4.1e-3: silu rounds
  at other places in the two frameworks);
- D = 640 (a multiple of 128, not of 512; the TPU kernel asserts there):
  ``gmm_plain`` vs a float64 einsum within 2e-6 (measured 4.4e-7).
The CUDA kernels themselves (bfloat16 on the tensor cores, float32 on the
CUDA cores) run only on a card (the ``cuda`` tests below, and
``chip_smoke.py``); their source runs on the CPU in
``tests/test_torch_kernel_emulation.py`` (bfloat16 through its host model
of the tensor-core kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.gmm import gmm as jgmm
from repro_torch.kernels import ops
from repro_torch.kernels.gmm import gmm, gmm_plain, work

#: the reference's own test shapes (tests/test_kernels.py::test_gmm)
SHAPES = [(2, 128, 128, 128), (4, 128, 256, 128), (8, 256, 128, 256)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(E, C, D, F, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, D)).astype(np.float32),
            rng.standard_normal((E, D, F)).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6),
                                       ("bfloat16", 2.0 ** -7)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_tpu_kernel_in_interpret_mode(shape, dtype, tol):
    x, w = _inputs(*shape)
    want = jgmm(jnp.asarray(x, getattr(jnp, dtype)),
                jnp.asarray(w, getattr(jnp, dtype)), interpret=True)
    got = gmm_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                    torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (shape[0], shape[1], shape[3])
    assert _rel(got.float().numpy(),
                np.asarray(want.astype(jnp.float32))) <= tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2.0 ** -6)])
def test_grouped_swiglu_matches_the_oracle(dtype, tol):
    """The expert FFN through ``ops.grouped_swiglu`` (aligned: every product
    is ``gmm_plain``) against ``grouped_swiglu_ref``."""
    E, C, D, F = 4, 128, 128, 256
    rng = np.random.default_rng(1)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    want = jref.grouped_swiglu_ref(*(jnp.asarray(a, getattr(jnp, dtype))
                                     for a in (x, *ws)))
    got = ops.grouped_swiglu(*(torch.from_numpy(a).to(getattr(torch, dtype))
                               for a in (x, *ws)))
    assert got.shape == (E, C, D)
    assert _rel(got.float().numpy(),
                np.asarray(want.astype(jnp.float32))) <= tol


def test_a_depth_the_tpu_kernel_refuses():
    """D = 640 is a multiple of 128 but not of 512: the TPU kernel asserts
    (as at deepseek-moe-16b's D = 1,408), the plain version sums a partial
    last block."""
    x, w = _inputs(3, 128, 640, 256, seed=2)
    with pytest.raises(AssertionError):
        jgmm(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = gmm_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.einsum("ecd,edf->ecf", x.astype(np.float64),
                     w.astype(np.float64))
    assert _rel(got, want) <= 2e-6


def test_dispatch_follows_the_reference_condition(monkeypatch):
    """Aligned (C, D, F multiples of 128) CPU input -> ``gmm_plain``, once
    per call; unaligned -> einsum (in the promoted type); autograd flows
    through both on the CPU."""
    calls = []

    def counted(x, w):
        calls.append(tuple(x.shape))
        return gmm_plain(x, w)

    monkeypatch.setattr(ops, "gmm_plain", counted)
    x, w = (torch.from_numpy(a) for a in _inputs(2, 128, 256, 128, seed=3))
    assert torch.equal(ops.grouped_matmul(x, w), gmm_plain(x, w))
    assert calls == [(2, 128, 256)]
    for C, D, F in ((120, 256, 128), (128, 200, 128), (128, 256, 96)):
        xs, ws = x[:, :C, :D].contiguous(), w[:, :D, :F].contiguous()
        assert torch.equal(ops.grouped_matmul(xs, ws),
                           torch.einsum("ecd,edf->ecf", xs, ws))
    assert len(calls) == 1
    mixed = ops.grouped_matmul(x[:, :120].bfloat16(), w)
    assert mixed.dtype == torch.float32
    ops.grouped_swiglu(x, w, w, w.transpose(1, 2).contiguous())
    assert len(calls) == 4
    xg = x.clone().requires_grad_()
    ops.grouped_matmul(xg, w).sum().backward()
    assert torch.allclose(xg.grad, w.sum(-1)[:, None, :].expand_as(x),
                          rtol=1e-5, atol=1e-5)


def test_a_cuda_input_that_needs_a_gradient_raises(monkeypatch):
    """On the card the kernel has no gradient: an aligned input that needs
    one raises naming the ROADMAP row, before anything launches; without
    a gradient it launches (a CPU tensor whose ``device`` reads ``cuda``
    stands in for the card here)."""
    x, w = (torch.from_numpy(a) for a in _inputs(1, 128, 128, 128))

    class FakeCuda:
        type = "cuda"

    x = x.requires_grad_()
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: FakeCuda))
    launched = []
    monkeypatch.setattr(ops, "gmm", lambda *a: launched.append(a))
    with pytest.raises(NotImplementedError, match="B4g"):
        ops.grouped_matmul(x, w)
    with torch.no_grad():
        ops.grouped_matmul(x, w)
    assert len(launched) == 1


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"), ("rank", "must be"), ("shape", "must be"),
    ("dtype", "must be of")])
def test_the_kernel_wrapper_refuses_what_it_cannot_take(case, match):
    """The CUDA wrapper checks before it launches and never runs the plain
    version: a CPU tensor is refused too."""
    x, w = (torch.from_numpy(a) for a in _inputs(2, 128, 128, 128))
    bad = {"cpu": (x, w), "rank": (x[0], w), "shape": (x, w[:, :64]),
           "dtype": (x.half(), w.half())}[case]
    before = gmm.launches
    with pytest.raises(ValueError, match=match):
        gmm(*bad)
    assert gmm.launches == before


def test_work_counts_the_serving_shapes():
    """deepseek-moe-16b's two products at 4 x 4096 tokens (C 1,920), bf16:
    7.09e11 operations on 1.22 GB each."""
    for D, F in ((2048, 1408), (1408, 2048)):
        w = work(64, 1920, D, F, 2)
        assert w["flops"] == 2 * 64 * 1920 * 2048 * 1408
        assert 7.08e11 <= w["flops"] <= 7.10e11
        assert w["bytes"] == 2 * 64 * (1920 * D + D * F + 1920 * F)
        assert 1.21e9 <= w["bytes"] <= 1.23e9
    assert work(1, 64, 32, 64, 4)["bytes"] == 4 * (64 * 32 + 32 * 64
                                                   + 64 * 64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 640, 384), (3, 192, 160, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_card(dtype, shape, monkeypatch):
    """Run on a CUDA card with nvcc: the kernel (bfloat16 on the tensor
    cores, float32 on the CUDA cores) against its plain version at E 4, C
    256, D 640, F 384, and at E 3, C 192, D 160, F 192, where the
    tensor-core kernel's 128 x 128 x 64 tiles run past C, F and D. float32
    within 1e-5 relative; bfloat16 within one bf16 ulp of the largest value
    (chip_smoke.py holds the serving shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x, w = (torch.from_numpy(a).to("cuda", dtype)
            for a in _inputs(*shape, seed=4))
    before = gmm.launches
    got = gmm(x, w)
    again = gmm(x, w)
    want = gmm_plain(x, w)
    torch.cuda.synchronize()
    assert gmm.launches == before + 2
    assert torch.equal(got, again)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert _rel(got.float().cpu(), want.float().cpu()) <= tol


@pytest.mark.cuda
def test_the_kernel_refuses_a_misaligned_bf16_tensor_on_the_card():
    """TMA reads from 16-byte aligned addresses: a bfloat16 x that starts 2
    bytes into its storage is refused before anything launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    E, C, D, F = 1, 64, 64, 64
    x = torch.zeros(E * C * D + 1, dtype=torch.bfloat16, device="cuda")
    x = x[1:].view(E, C, D)
    w = torch.zeros((E, D, F), dtype=torch.bfloat16, device="cuda")
    before = gmm.launches
    with pytest.raises(ValueError, match="aligned"):
        gmm(x, w)
    assert gmm.launches == before
