"""The port's flash-attention backward (``repro_torch.kernels.flash_attention``
``flash_attention_bwd_plain``, and ``kernels.ops.attention``'s gradient)
against the JAX package's Pallas backward ``_flash_bwd`` (run in interpret
mode, as the JAX package's own tests run it on the CPU), against
``jax.grad`` through its ``flash_attention`` (``tests/test_kernels.py``
drives it the same way: by argument, interpret mode) and through its
oracle ``kernels/ref.py::attention_ref``, on the same numpy inputs.

Tolerances (measured on the CPU, as max|port - jax| / max|jax| over dq, dk,
dv):
- plain vs ``_flash_bwd`` on the same (q, k, v, out, lse, dout): float32
  within 2e-6 (measured 6.8e-7); bfloat16 within 2^-8, half a bf16 step of
  the largest value (measured 7.6e-4: the two cast dq, dk, dv to bf16 after
  float32 sums taken in another order, and some round the other way);
- ``ops.attention``'s gradient vs ``jax.grad`` of ``flash_attention``
  within 2e-6 (measured 7.1e-7) and of ``attention_ref`` within 4e-6
  (measured 9.6e-7), float32.
The CUDA kernels themselves run only on a card (the ``cuda`` test below,
and ``chip_smoke.py``); their source runs on the CPU in
``tests/test_torch_kernel_emulation.py``.

The bf16 kernels' precision plan (s and dp as the plain version sums them,
p and ds into the tensor-core products as three bf16 terms that hold them
exactly) is pinned here against the card's bounds; p and ds rounded once
to bf16, and (on rows whose softmax is all but one-hot) dp summed exactly
instead of in the plain version's float32 order, are shown to fail them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import _flash_bwd, _flash_fwd, \
    flash_attention as jflash_attention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import SMEM_LIMIT, bwd_smem_plan, \
    check_bwd_smem_fit, flash_attention_bwd, flash_attention_bwd_plain, \
    flash_attention_dkv, flash_attention_dq, flash_attention_fwd_plain, \
    scale_of, work_bwd

# (B, S, H, Kv, D)
SHAPES = [(1, 256, 4, 2, 32), (2, 256, 4, 1, 64)]
#: plain vs _flash_bwd, max over dq, dk, dv (measured before pinning)
TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -8}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _qkv(B, S, H, Kv, D, seed):
    """q, dout [B, H, S, D] and k, v [B, Kv, S, D] float32 numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32)
                     for shape in ((B, H, S, D), (B, Kv, S, D),
                                   (B, Kv, S, D), (B, H, S, D)))
    return q, k, v, dout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_tpu_kernels_in_interpret_mode(shape, causal,
                                                         dtype):
    """Both take the same (q, k, v, out, lse, dout): out and lse from the
    JAX forward, everything rounded to ``dtype`` once in numpy terms."""
    q, k, v, dout = _qkv(*shape, seed=2)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, dout))
    out, lse = _flash_fwd(jq, jk, jv, causal=causal, block_q=128,
                          block_k=128, interpret=True)
    want = _flash_bwd((jq, jk, jv, out, lse), jdo, causal=causal,
                      block_q=128, block_k=128, interpret=True)
    tdt = getattr(torch, dtype)
    got = flash_attention_bwd_plain(
        *(torch.from_numpy(_np32(x)).to(tdt) for x in (jq, jk, jv, out)),
        torch.from_numpy(np.array(lse)),
        torch.from_numpy(_np32(jdo)).to(tdt), causal)
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        assert _rel(_np32(g), _np32(w)) <= TOL[dtype]


def _port_grads(q, k, v, w, causal):
    """d sum(attention(q, k, v) * w) / d(q, k, v) through ``ops.attention``
    in the model layout; numpy in the kernel layout."""
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    out = ops.attention(tq, tk, tv, causal)
    loss = (out * torch.from_numpy(w).transpose(1, 2)).sum()
    return [g.transpose(1, 2).numpy() for g in
            torch.autograd.grad(loss, (tq, tk, tv))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_ops_attention_gradient_matches_jax_grad(shape, causal):
    """The port's autograd Function on the CPU (the plain forward and
    backward) against ``jax.grad`` through the JAX package's custom-VJP
    ``flash_attention`` (interpret mode) and through ``attention_ref``."""
    q, k, v, w = _qkv(*shape, seed=3)
    got = _port_grads(q, k, v, w, causal)

    def loss_flash(q, k, v):
        out = jflash_attention(q, k, v, causal, 128, 128, True)
        return jnp.sum(out * w)

    def loss_ref(q, k, v):
        qt, kt, vt = (jnp.swapaxes(t, 1, 2) for t in (q, k, v))
        out = jref.attention_ref(qt, kt, vt, causal)
        return jnp.sum(jnp.swapaxes(out, 1, 2) * w)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    for fn, tol in ((loss_flash, 2e-6), (loss_ref, 4e-6)):
        want = jax.grad(fn, argnums=(0, 1, 2))(*args)
        for g, x in zip(got, want):
            assert _rel(g, x) <= tol


def test_the_backward_runs_under_activation_checkpointing():
    """Non-reentrant checkpointing recomputes the forward and hands the
    backward the recomputed out and lse: the gradients equal the plain
    ones."""
    q, k, v, w = _qkv(1, 128, 4, 2, 16, seed=4)
    want = _port_grads(q, k, v, w, True)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    out = torch.utils.checkpoint.checkpoint(
        ops.attention, tq, tk, tv, True, use_reentrant=False)
    loss = (out * torch.from_numpy(w).transpose(1, 2)).sum()
    got = [g.transpose(1, 2).numpy()
           for g in torch.autograd.grad(loss, (tq, tk, tv))]
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


def test_work_bwd_counts_the_training_shape():
    """phi4-mini-3.8b at B 2, S 2048: 24 query over 8 key/value heads,
    D 128, bf16, causal. 100.7M (query, key) pairs; 6 D / 8 D / 10 D
    operations per pair for dq / dk-dv / one pass; each input read once and
    each output written once."""
    w = work_bwd(2, 24, 8, 2048, 128, True, 2)
    pairs = 2 * 24 * (2048 * 2049 // 2)
    assert pairs == 100_712_448
    assert w["dq"]["flops"] == 6 * 128 * pairs
    assert w["dkv"]["flops"] == 8 * 128 * pairs
    assert w["single_pass"]["flops"] == 10 * 128 * pairs
    q_bytes, kv_bytes, stats = 2 * 2 * 24 * 2048 * 128, \
        2 * 2 * 8 * 2048 * 128, 2 * 4 * 2 * 24 * 2048
    assert w["dq"]["bytes"] == 3 * q_bytes + 2 * kv_bytes + stats
    assert w["dkv"]["bytes"] == 2 * q_bytes + 4 * kv_bytes + stats
    assert 109.8e6 <= w["single_pass"]["bytes"] <= 109.9e6
    assert 128.9e9 <= w["single_pass"]["flops"] <= 129.0e9
    assert work_bwd(1, 4, 1, 128, 16, False, 4)["dq"]["flops"] == \
        6 * 4 * 16 * 128 ** 2


def test_shared_memory_plan_fits_and_refuses():
    """Both kernels' blocks fit the 232,448 B a block may use at the largest
    head dim they take (128)."""
    plan = check_bwd_smem_fit(128)
    assert plan["dq"]["total"] == 222_720 and plan["dkv"]["total"] == 220_672
    assert all(p["total"] <= SMEM_LIMIT for p in plan.values())
    assert bwd_smem_plan(144)["dq"]["total"] > SMEM_LIMIT
    with pytest.raises(ValueError, match="over the 232,448 B"):
        check_bwd_smem_fit(144)


def test_the_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers check before they launch and never run the plain
    version."""
    q, k, v, dout = (torch.from_numpy(x) for x in _qkv(1, 128, 4, 2, 32, 5))
    out, lse = flash_attention_fwd_plain(q, k, v, True)
    delta = (dout * out).sum(-1)
    counts = (flash_attention_bwd.launches, flash_attention_dq.launches,
              flash_attention_dkv.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd(q, k, v, out, lse, dout, True)
    for fn in (flash_attention_dq, flash_attention_dkv):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(q, k, v, dout, lse, delta, True)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention_bwd_plain(q, k, v, out, lse[:, :, :64], dout, True)
    assert counts == (flash_attention_bwd.launches,
                      flash_attention_dq.launches,
                      flash_attention_dkv.launches)


#: the card's bounds on the bf16 kernels against their plain version
#: (``chip_smoke.py``: FLASH_BWD_BF16_RTOL, FLASH_BWD_BF16_OFF_SHARE)
CARD_RTOL = 2.0 ** -8
CARD_OFF_SHARE = 1e-3


def _bf16_steps(a, b):
    """Per element, |a - b| in units of the bfloat16 spacing at b (as
    ``chip_smoke.py`` counts them)."""
    b = b.float()
    _, exp = torch.frexp(b)
    step = torch.ldexp(torch.ones_like(b), exp - 8).clamp_min(2.0 ** -133)
    return (a.float() - b).abs() / step


def _split(x, terms: int) -> torch.Tensor:
    """x (float32) as ``terms`` bf16 terms, each the rounding of what the
    terms before it left, as the kernels split it (x times 2^24, so that
    three terms hold even a subnormal x); their sum in float64, divided by
    2^24."""
    total, rest = torch.zeros_like(x, dtype=torch.float64), x * 2.0 ** 24
    for _ in range(terms):
        part = rest.bfloat16().float()
        total += part.double()
        rest = rest - part
    return total / 2.0 ** 24


def _tensor_core_plan(q, k, v, out, lse, dout, terms: int, dp_exact: bool):
    """The bf16 kernels' arithmetic (causal): s and dp as the plain version
    computes them (float32 products; with ``dp_exact``, dp summed exactly
    and rounded once instead), p = exp(s - lse) and ds = p (dp - delta) in
    float32, each as ``terms`` bf16 terms; their products with do, k and q
    in float64, dq and dk times the scale, dk from q itself; dq, dk, dv in
    bf16. Also returns whether the terms add up to p and ds exactly."""
    B, H, S, D = q.shape
    Kv = k.shape[1]
    g = H // Kv
    scale = torch.tensor(scale_of(D))
    qf = q.float().reshape(B, Kv, g, S, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dof = dout.float().reshape(B, Kv, g, S, D)
    delta = (dout.float() * out.float()).sum(-1).reshape(B, Kv, g, S, 1)
    s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    s.masked_fill_(torch.ones(S, S, dtype=torch.bool).triu(1), -math.inf)
    p = (s - lse.reshape(B, Kv, g, S, 1)).exp()
    if dp_exact:
        dp = torch.matmul(dof.double(), vf.double().transpose(-1, -2)).float()
    else:
        dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (dp - delta) * p
    pt, dst = _split(p, terms), _split(ds, terms)
    exact = bool(torch.equal(pt, p.double()) and torch.equal(dst, ds.double()))
    dv = torch.matmul(pt.transpose(-1, -2), dof.double()).sum(2)
    dq = torch.matmul(dst, kf.double()) * float(scale)
    dk = torch.matmul(dst.transpose(-1, -2), qf.double()).sum(2) * float(scale)
    return (dq.reshape(B, H, S, D).bfloat16(), dk.bfloat16(),
            dv.bfloat16()), exact


@pytest.mark.parametrize("amp,terms,dp_exact,within", [
    (1.0, 3, False, True), (1.0, 1, False, False),
    (40.0, 3, False, True), (40.0, 3, True, False)])
@pytest.mark.parametrize("shape", [(1, 1024, 3, 1, 128), (1, 512, 4, 2, 64)])
def test_the_tensor_core_precision_plan(shape, amp, terms, dp_exact,
                                        within):
    """Against the float32 plain version rounded to bf16, at phi4-mini's
    GQA group and head dim and at a smaller shape, causal: with s and dp
    the plain version's, p and ds as three bf16 terms add up to the float32
    values exactly (split times 2^24, as the kernels split them) and dq,
    dk, dv stay within the card's bounds (within 2^-8 of the largest value,
    at most 1e-3 of the elements more than one bf16 step apart; measured at
    most 2e-5 of them); rounded once to bf16, over 10x that share (measured
    0.12-0.13). With q scaled 40x the rows'
    softmax is all but one-hot, as on phi4-mini's random-weight layers
    (|s| ~ 1,300-1,500), and ds = p (dp - delta) cancels: three terms still
    hold (measured at most 1e-5), but dp summed exactly, as a tensor core
    could at best, puts over 10x the share over one step (measured 0.16 to
    0.23 of dq)."""
    B, S, H, Kv, D = shape
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.standard_normal((B, H, S, D)) * amp,
                     dtype=torch.bfloat16)
    k, v = (torch.tensor(rng.standard_normal((B, Kv, S, D)),
                         dtype=torch.bfloat16) for _ in range(2))
    dout = torch.tensor(rng.standard_normal((B, H, S, D)),
                        dtype=torch.bfloat16)
    out, lse = flash_attention_fwd_plain(q, k, v, True)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, True)
    got, exact = _tensor_core_plan(q, k, v, out, lse, dout, terms, dp_exact)
    rel = max(_rel(_np32(g), _np32(w)) for g, w in zip(got, want))
    share = max(float((_bf16_steps(g, w) > 1).float().mean())
                for g, w in zip(got, want))
    if within:
        assert exact
        assert rel <= CARD_RTOL and share <= CARD_OFF_SHARE
    else:
        assert share > 10 * CARD_OFF_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain_on_the_card(causal, dtype, monkeypatch):
    """Run on a CUDA card with nvcc: both backward kernels against their
    plain version at a GQA shape of 4 query blocks. float32 within 1e-5
    relative; bfloat16 within one bf16 step of the largest value
    (chip_smoke.py holds the training shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v, dout = (torch.from_numpy(x).to("cuda", dtype)
                     for x in _qkv(2, 256, 8, 2, 64, seed=6))
    out, lse = flash_attention_fwd_plain(q, k, v, causal)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for g, w in zip(got, want):
        assert _rel(g.float().cpu(), w.float().cpu()) <= tol
