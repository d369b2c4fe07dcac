"""The port's flash-attention forward (``repro_torch.kernels.flash_attention``)
against the JAX package's Pallas kernel ``_flash_fwd`` (run in interpret
mode, as the JAX package's own tests run it on the CPU) and its oracle
``kernels/ref.py::attention_ref``, on the same numpy inputs.

Tolerances (measured on the CPU, float32, as max|port - jax| / max|jax|):
plain vs ``_flash_fwd`` out within 2e-6 (measured 4.9e-7), lse within 1e-6
(measured 8.3e-8); plain vs ``attention_ref`` out within 4e-6 (measured
9.0e-7); in bfloat16 within 1.6e-2 (measured 5.1e-3: ``attention_ref``
rounds the probabilities to bfloat16 before ``p v``, the flash numerics keep
them in float32). The CUDA kernel itself runs only on a card (the ``cuda``
test below, and ``chip_smoke.py``); its source runs on the CPU in
``tests/test_torch_kernel_emulation.py``.

The bf16 kernel's precision plan (the scores as the plain version sums
them, the float32 p into ``p v`` as three bf16 terms that hold it exactly)
is pinned here against the card's bounds, and rounding p once to bf16 is
shown to fail them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import _flash_fwd
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd, \
    flash_attention_fwd_plain, scale_of, work

# (B, S, H, Kv, D)
SHAPES = [(1, 128, 4, 1, 16), (1, 256, 4, 2, 32)]


def _inputs(B, S, H, Kv, D, seed=0):
    """q [B, H, S, D], k/v [B, Kv, S, D] float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, Kv, S, D)).astype(np.float32),
            rng.standard_normal((B, Kv, S, D)).astype(np.float32))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_tpu_kernel_in_interpret_mode(shape, causal):
    q, k, v = _inputs(*shape)
    want_o, want_lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, block_q=128,
                                  block_k=128, interpret=True)
    got_o, got_lse = flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    assert got_o.dtype == torch.float32 and got_lse.dtype == torch.float32
    assert got_lse.shape == (shape[0], shape[2], shape[1])
    assert _rel(got_o.numpy(), want_o) <= 2e-6
    assert _rel(got_lse.numpy(), want_lse) <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 4e-6),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_attention_ref(shape, causal, dtype, tol):
    q, k, v = _inputs(*shape, seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jref.attention_ref(*(jnp.swapaxes(jnp.asarray(x, jdt), 1, 2)
                                for x in (q, k, v)), causal)
    want = np.asarray(want.astype(jnp.float32))
    got, _ = flash_attention_fwd_plain(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), causal)
    assert got.dtype == dtype
    assert _rel(got.float().transpose(1, 2).numpy(), want) <= tol


def test_ops_attention_takes_the_model_layout():
    """``ops.attention`` is the plain version between two transposes on a
    CPU tensor, and refuses what the JAX package would not route to its
    kernel."""
    q, k, v = (torch.from_numpy(x).transpose(1, 2)
               for x in _inputs(*SHAPES[1]))          # [B, S, H|Kv, D]
    got = ops.attention(q, k, v, causal=True)
    want, _ = flash_attention_fwd_plain(
        *(x.transpose(1, 2).contiguous() for x in (q, k, v)), True)
    assert got.shape == q.shape
    assert torch.equal(got, want.transpose(1, 2))
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.attention(q[:, :64], k[:, :64], v[:, :64])
    with pytest.raises(ValueError, match="device meta"):
        ops.attention(*(x.to("meta") for x in (q, k, v)))


def _bad(case):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 128, 4, 2, 32))
    if case == "cpu":
        return q, k, v
    if case == "dtype":
        return q.half(), k.half(), v.half()
    if case == "mixed":
        return q, k.double(), v
    if case == "head_dim":
        return q[..., :12].contiguous(), k[..., :12].contiguous(), \
            v[..., :12].contiguous()
    if case == "seq":
        return q[:, :, :96], k[:, :, :96], v[:, :, :96]
    if case == "strides":
        return q.transpose(2, 3).contiguous().transpose(2, 3), k, v
    if case == "heads":
        return q[:, :3].contiguous(), k, v
    raise AssertionError(case)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"), ("dtype", "share one of"), ("mixed", "share"),
    ("head_dim", "multiple of 8"), ("seq", "multiples of 64"),
    ("strides", "contiguous"), ("heads", "not a multiple")])
def test_the_kernel_wrapper_refuses_what_it_cannot_take(case, match):
    """The CUDA wrapper checks before it launches and never runs the plain
    version: a CPU tensor is refused too."""
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match=match):
        flash_attention_fwd(*_bad(case))
    assert flash_attention_fwd.launches == before


def test_work_counts_the_serving_shapes():
    """The two bf16 prefill shapes of Yi-9B: causal operations over the
    S (S + 1) / 2 pairs, q/k/v/out bytes plus the float32 lse."""
    w = work(4, 32, 4, 512, 128, True, 2)
    assert w["flops"] == 4 * 4 * 32 * 128 * (512 * 513 // 2)
    assert w["bytes"] == 2 * (2 * 4 * 32 * 512 * 128 + 2 * 4 * 4 * 512 * 128) \
        + 4 * 4 * 32 * 512
    assert 8.6e9 <= w["flops"] <= 8.65e9 and 38.0e6 <= w["bytes"] <= 38.1e6
    w = work(1, 32, 4, 4096, 128, True, 2)
    assert 137.4e9 <= w["flops"] <= 137.5e9
    assert 75.5e6 <= w["bytes"] <= 76.1e6
    assert work(1, 4, 1, 128, 16, False, 4)["flops"] == 4 * 4 * 16 * 128 ** 2


#: the card's bounds on the bf16 kernel against its plain version
#: (``chip_smoke.py``: FLASH_BF16_RTOL, FLASH_BF16_OFF_SHARE)
CARD_OUT_RTOL = 2.0 ** -8
CARD_OFF_SHARE = 1e-3


def _bf16_steps(a, b):
    """Per element, |a - b| in units of the bfloat16 spacing at b (as
    ``chip_smoke.py`` counts them)."""
    b = b.float()
    _, exp = torch.frexp(b)
    step = torch.ldexp(torch.ones_like(b), exp - 8).clamp_min(2.0 ** -133)
    return (a.float() - b).abs() / step


def _split(p, terms: int) -> list:
    """p (float32) as ``terms`` bf16 terms, each the rounding of what the
    terms before it left, as the kernel splits it."""
    out, rest = [], p
    for _ in range(terms):
        out.append(rest.bfloat16().float())
        rest = rest - out[-1]
    return out


def _tensor_core_plan(q, k, v, causal: bool, terms: int):
    """The bf16 kernel's arithmetic: the scores as the plain version
    computes them (q times the float32 scale, float32 products); p = exp(s
    - max) in float32, masked entries 0; l the sum of p; ``p v`` from p as
    ``terms`` bf16 terms, the products and sums in float64; ``out = p v /
    l`` in bf16. Also returns whether the terms add up to p exactly."""
    B, H, S, D = q.shape
    g = H // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vd = v.double().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float() * float(scale_of(D)), kf.transpose(-1, -2))
    if causal:
        s.masked_fill_(torch.ones(S, S, dtype=torch.bool).triu(1),
                       -float("inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    parts = _split(p, terms)
    pv = sum(torch.matmul(x.double(), vd) for x in parts)
    exact = bool(torch.equal(sum(x.double() for x in parts), p.double()))
    return (pv / p.double().sum(-1, keepdim=True)).to(torch.bfloat16), exact


@pytest.mark.parametrize("terms,within", [(3, True), (1, False)])
@pytest.mark.parametrize("shape", [(1, 1024, 4, 4, 128), (1, 512, 4, 4, 112)])
def test_the_tensor_core_precision_plan(shape, terms, within):
    """Against the float32 plain version rounded to bf16, at Yi-9B's head
    dim and zamba2-7b's: p as three bf16 terms adds up to the float32 p
    exactly and stays within the card's bounds (out within 2^-8 of the
    largest value, at most 1e-3 of the elements more than one bf16 step
    apart); p rounded once to bf16 puts over 10x that share over one
    step."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(*shape,
                                                                seed=4))
    want, _ = flash_attention_fwd_plain(q, k, v, True)
    got, exact = _tensor_core_plan(q, k, v, True, terms)
    rel = _rel(got.float().numpy(), want.float().numpy())
    share = float((_bf16_steps(got, want) > 1).float().mean())
    if within:
        assert exact
        assert rel <= CARD_OUT_RTOL and share <= CARD_OFF_SHARE
    else:
        assert share > 10 * CARD_OFF_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_the_card(causal, dtype, monkeypatch):
    """Run on a CUDA card with nvcc: the kernel against its plain version at
    a GQA shape of 4 query blocks. float32 within 1e-5 relative; bfloat16
    out within one bf16 ulp of the largest value (chip_smoke.py holds the
    serving shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = (torch.from_numpy(x).to("cuda", dtype)
               for x in _inputs(2, 256, 8, 2, 64, seed=3))
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, causal)
    po, plse = flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert _rel(o.float().cpu(), po.float().cpu()) <= tol
    assert _rel(lse.cpu(), plse.cpu()) <= 1e-5
