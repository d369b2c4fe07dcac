"""The port's WKV scan (``repro_torch.kernels.wkv6_scan`` and its dispatch
``kernels.ops.wkv6``) against the JAX package's Pallas kernel ``wkv6_scan``
(run in interpret mode, as the JAX package's own tests run it on the CPU),
its oracle ``kernels/ref.py::wkv6_ref`` (the sequential recurrence), and
the same recurrence in numpy float64, on the same numpy inputs: r, k, v
~ 0.5 N(0, 1), u ~ 0.5 N(0, 1), logw = -exp(clip(N(0, 1) + w0, -8, 6)),
the clip that the model's ``_decay`` applies.

Tolerances, as max|port - ref| / max|ref| (measured on the CPU):
- ``wkv6_scan_plain`` vs ``wkv6_scan`` (interpret) at the reference test's
  three shapes (``tests/test_kernels.py::test_wkv6_kernel``) and one of
  strong decay (w0 = +5: about -150 per step, |cumsum| ~9,600 within a
  chunk, where an ulp of the exponent is ~1e-3): float32 y within 1e-5
  (measured 3.8e-6) and 1e-3 under strong decay (measured 4.9e-4: the two
  cumsums round differently, and each ulp of ~9,600 moves a decay by
  1e-3), the float32 state within 1e-5 (measured 4.5e-6); bfloat16 y within
  2^-7 (measured 3.3e-3 under strong decay, 6.9e-4 elsewhere: a few
  elements round to the neighbouring bf16 value) and the state within 1e-5
  (measured 4.5e-6);
- the port's plain version against the recurrence in float64: y within
  1e-5 (measured 1.7e-6; the Pallas kernel's 2.9e-6) and 2e-4 under strong
  decay (measured 6.9e-5; the Pallas kernel's 3.6e-4), the state within
  1e-5 (measured 3.8e-6);
- ``ops.wkv6`` (model layout) vs ``wkv6_ref`` on the same (bf16-rounded)
  inputs, also with S padded by zero steps to a multiple of the chunk as
  ``rwkv6_time_mix`` pads it: float32 y and state within 1e-5 (measured
  2.7e-6 and 1.9e-6), bfloat16 y within 2^-7 (the port rounds y once to
  bf16 from float32, ``wkv6_ref`` its float32 sum of float32 products;
  measured 3.0e-3) and the float32 state within 1e-5 (measured 1.9e-6).
The CUDA kernel itself runs only on a card (the ``cuda`` test below, and
``chip_smoke.py``); its source runs on the CPU in
``tests/test_torch_kernel_emulation.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6 import wkv6_scan as jwkv6_scan
from repro_torch.kernels import ops
from repro_torch.kernels.wkv6_scan import check_smem_fit, cumsum_rounded, \
    smem_plan, wkv6_scan, wkv6_scan_plain, work

#: (B, S, H, c, chunk, w0): the reference test's three shapes, and strong
#: decay
CASES = [(1, 64, 2, 16, 32, 0.0), (2, 128, 2, 32, 64, 0.0),
         (1, 256, 4, 64, 64, 0.0), (1, 128, 2, 64, 64, 5.0)]
STRONG = 5.0


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(B, S, H, c, w0, seed=0):
    """r, k, v, logw [B, S, H, c] and u [H, c], float32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, c)) * 0.5 for _ in range(3))
    logw = -np.exp(np.clip(rng.standard_normal((B, S, H, c)) + w0, -8, 6))
    u = rng.standard_normal((H, c)) * 0.5
    return [a.astype(np.float32) for a in (r, k, v, logw, u)]


def _fold(*ts):
    """The kernel layout [B H, S, c] of model-layout arrays (numpy)."""
    return [np.ascontiguousarray(t.swapaxes(1, 2).reshape(
        -1, t.shape[1], t.shape[3])) for t in ts]


def _fold_u(u, B):
    return np.broadcast_to(u[None], (B,) + u.shape).reshape(
        -1, u.shape[-1]).copy()


def _exact(r, k, v, logw, u):
    """The recurrence in float64 (kernel layout): (y, state)."""
    r, k, v, logw, u = (np.asarray(a, np.float64)
                        for a in (r, k, v, logw, u))
    BH, S, c = r.shape
    state = np.zeros((BH, c, c))
    y = np.zeros((BH, S, c))
    for t in range(S):
        kv = k[:, t, :, None] * v[:, t, None, :]
        y[:, t] = np.einsum("bc,bcd->bd", r[:, t], state + u[:, :, None] * kv)
        state = np.exp(logw[:, t])[:, :, None] * state + kv
    return y, state


def _round(a, dtype: str) -> np.ndarray:
    """``a`` rounded to ``dtype`` and back to float32."""
    return np.array(jnp.asarray(a, getattr(jnp, dtype)).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_the_tpu_kernel_in_interpret_mode(case, dtype):
    B, S, H, c, chunk, w0 = case
    r, k, v, logw, u = _inputs(B, S, H, c, w0)
    rf, kf, vf, lf = _fold(r, k, v, logw)
    uf = _fold_u(u, B)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, want_s = jwkv6_scan(*(jnp.asarray(a, jd) for a in (rf, kf, vf)),
                                jnp.asarray(lf), jnp.asarray(uf, jd),
                                chunk=chunk, interpret=True)
    y, state = wkv6_scan_plain(
        *(torch.from_numpy(a).to(td) for a in (rf, kf, vf)),
        torch.from_numpy(lf), torch.from_numpy(uf).to(td), chunk=chunk)
    assert y.dtype == td and state.dtype == torch.float32
    assert tuple(y.shape) == (B * H, S, c) and \
        tuple(state.shape) == (B * H, c, c)
    y_tol = 2.0 ** -7 if dtype == "bfloat16" else \
        1e-3 if w0 == STRONG else 1e-5
    assert _rel(y.float().numpy(),
                np.asarray(want_y.astype(jnp.float32))) <= y_tol
    assert _rel(state.numpy(), np.asarray(want_s)) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_the_exact_recurrence(case):
    """float32 against the recurrence in float64; under strong decay the
    port is nearer it than the Pallas kernel is (its cumsum keeps ``cum -
    logw`` equal to the previous prefix in most steps)."""
    B, S, H, c, chunk, w0 = case
    r, k, v, logw, u = _inputs(B, S, H, c, w0, seed=1)
    args = _fold(r, k, v, logw) + [_fold_u(u, B)]
    want_y, want_s = _exact(*args)
    y, state = wkv6_scan_plain(*(torch.from_numpy(a) for a in args),
                               chunk=chunk)
    got = _rel(y.numpy(), want_y)
    assert got <= (2e-4 if w0 == STRONG else 1e-5)
    assert _rel(state.numpy(), want_s) <= 1e-5
    if w0 == STRONG:
        jy, _ = jwkv6_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                           interpret=True)
        assert got < _rel(np.asarray(jy), want_y)


def test_cumsum_rounded_is_the_running_float32_sum():
    """Each step's sum in float64, rounded to float32: the same values as
    a running float32 sum (bitwise), and ``cum - lw`` is the previous
    prefix in most steps."""
    rng = np.random.default_rng(2)
    lw = (-np.exp(np.clip(rng.standard_normal((3, 64, 8)), -8, 6))) \
        .astype(np.float32)
    cum = cumsum_rounded(torch.from_numpy(lw), dim=1).numpy()
    run = np.zeros((3, 8), np.float32)
    for s in range(64):
        run = run + lw[:, s]
        assert np.array_equal(cum[:, s], run)
    assert np.mean((cum - lw)[:, 1:] == cum[:, :-1]) > 0.8


@pytest.mark.parametrize("dtype,y_tol", [("float32", 1e-5),
                                         ("bfloat16", 2.0 ** -7)])
@pytest.mark.parametrize("shape", [(2, 128, 2, 32, 64, 128),
                                   (1, 64, 3, 16, 32, 64),
                                   (2, 100, 2, 16, 64, 128)],
                         ids=["two-chunks", "chunk-32", "padded"])
def test_ops_wkv6_matches_the_oracle(shape, dtype, y_tol):
    """``ops.wkv6`` in the model layout against the sequential recurrence
    on the same inputs (rounded to ``dtype``); S 100 is padded with zero
    steps (k = v = logw = 0) to 128, as ``rwkv6_time_mix`` pads it, and the
    state passes through them unchanged."""
    B, S, H, c, chunk, padded = shape
    r, k, v, logw, u = _inputs(B, S, H, c, 0.0, seed=3)
    r, k, v, u = (_round(a, dtype) for a in (r, k, v, u))
    want_y, want_s = jref.wkv6_ref(*(jnp.asarray(a)
                                     for a in (r, k, v, logw, u)))
    td = getattr(torch, dtype)
    pad = [(0, 0), (0, padded - S), (0, 0), (0, 0)]
    y, state = ops.wkv6(*(torch.from_numpy(np.pad(a, pad)).to(td)
                          for a in (r, k, v)),
                        torch.from_numpy(np.pad(logw, pad)),
                        torch.from_numpy(u).to(td), chunk)
    assert y.dtype == td and tuple(y.shape) == (B, padded, H, c)
    assert tuple(state.shape) == (B, H, c, c)
    assert _rel(y[:, :S].float().numpy(), np.asarray(want_y)) <= y_tol
    assert _rel(state.numpy(), np.asarray(want_s)) <= 1e-5
    assert not y[:, S:].any()


def test_ops_wkv6_folds_and_dispatches_the_plain_version(monkeypatch):
    """A CPU tensor runs ``wkv6_scan_plain`` once, on the folded layout
    ``[B H, S, c]`` with u broadcast to every batch row; the results unfold
    to ``[B, S, H, c]`` and ``[B, H, c, c]``; autograd flows through the
    plain version on the CPU."""
    B, S, H, c, chunk = 2, 64, 3, 16, 32
    r, k, v, logw, u = (torch.from_numpy(a)
                        for a in _inputs(B, S, H, c, 0.0, seed=4))
    calls = []

    def counted(*args, chunk):
        calls.append((tuple(args[0].shape), tuple(args[4].shape), chunk))
        return wkv6_scan_plain(*args, chunk=chunk)

    monkeypatch.setattr(ops, "wkv6_scan_plain", counted)
    before = wkv6_scan.launches
    y, state = ops.wkv6(r, k, v, logw, u, chunk)
    assert calls == [((B * H, S, c), (B * H, c), chunk)]
    assert wkv6_scan.launches == before
    folded = [torch.from_numpy(a) for a in _fold(
        r.numpy(), k.numpy(), v.numpy(), logw.numpy())]
    yf, sf = wkv6_scan_plain(*folded, torch.from_numpy(_fold_u(u.numpy(), B)),
                             chunk=chunk)
    assert torch.equal(y, yf.reshape(B, H, S, c).transpose(1, 2))
    assert torch.equal(state, sf.reshape(B, H, c, c))
    rg = r.clone().requires_grad_()
    ops.wkv6(rg, k, v, logw, u, chunk)[0].sum().backward()
    assert rg.grad is not None and bool(torch.isfinite(rg.grad).all())


def test_a_sequence_the_chunk_does_not_divide_raises():
    r, k, v, logw, u = (torch.from_numpy(a)
                        for a in _inputs(1, 100, 2, 16, 0.0))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.wkv6(r, k, v, logw, u, 64)
    with pytest.raises(ValueError, match="does not divide"):
        wkv6_scan_plain(*(t[0].transpose(0, 1).contiguous()
                          for t in (r, k, v, logw)), u, chunk=64)


def test_a_cuda_input_that_needs_a_gradient_raises(monkeypatch):
    """On the card the kernel has no gradient: an input that needs one
    raises naming the ROADMAP row, before anything launches; without a
    gradient it launches (a CPU tensor whose ``device`` reads ``cuda``
    stands in for the card here)."""
    r, k, v, logw, u = (torch.from_numpy(a)
                        for a in _inputs(1, 64, 2, 16, 0.0))

    class FakeCuda:
        type = "cuda"

    r = r.requires_grad_()
    launched = []

    def fake(*args, chunk):
        launched.append(chunk)
        BH, S, c = args[0].shape
        return torch.zeros(BH, S, c), torch.zeros(BH, c, c)

    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: FakeCuda))
    monkeypatch.setattr(ops, "wkv6_scan", fake)
    with pytest.raises(NotImplementedError, match="A11g"):
        ops.wkv6(r, k, v, logw, u, 32)
    with torch.no_grad():
        ops.wkv6(r, k, v, logw, u, 32)
    assert launched == [32]


def test_another_device_raises():
    r, k, v, logw, u = (torch.empty(t.shape, device="meta") for t in (
        torch.from_numpy(a) for a in _inputs(1, 64, 2, 16, 0.0)))
    with pytest.raises(ValueError, match="no WKV scan for device meta"):
        ops.wkv6(r, k, v, logw, u, 32)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"), ("rank", "must be"), ("u", r"u must be"),
    ("dtype", "must share"), ("logw", "float32"),
    ("chunk", "does not divide")])
def test_the_kernel_wrapper_refuses_what_it_cannot_take(case, match):
    """The CUDA wrapper checks before it launches and never runs the plain
    version: a CPU tensor is refused too."""
    r, k, v, logw, u = _inputs(1, 64, 2, 16, 0.0)
    rf, kf, vf, lf = (torch.from_numpy(a) for a in _fold(r, k, v, logw))
    uf = torch.from_numpy(_fold_u(u, 1))
    good = dict(r=rf, k=kf, v=vf, logw=lf, u=uf, chunk=32)
    bad = {"cpu": {}, "rank": {"r": rf[0]}, "u": {"u": uf[:1]},
           "dtype": {"r": rf.half(), "k": kf.half(), "v": vf.half()},
           "logw": {"logw": lf.double()}, "chunk": {"chunk": 48}}[case]
    args = {**good, **bad}
    before = wkv6_scan.launches
    with pytest.raises(ValueError, match=match):
        wkv6_scan(args.pop("r"), args.pop("k"), args.pop("v"),
                  args.pop("logw"), args.pop("u"), **args)
    assert wkv6_scan.launches == before


def test_the_shared_memory_plan_fits_and_refuses_the_rest():
    """The kernel's block at rwkv6-3b's chunk 64 and head size 64 fits the
    232,448 B a block may use (one block per SM); other dims raise."""
    plan = check_smem_fit(64, 64)
    assert plan["total"] == 123_392 <= 232_448
    assert smem_plan(61, 64) == plan
    assert check_smem_fit(1, 16)["total"] < plan["total"]
    for args, match in (((65, 64), "chunk in"), ((0, 64), "chunk"),
                        ((64, 128), "c a multiple"), ((64, 6), "c a multiple")):
        with pytest.raises(ValueError, match=match):
            check_smem_fit(*args)


def test_work_counts_the_forward_shape():
    """rwkv6-3b's forward of 4 x 4096 tokens (BH 160, chunk 64, c 64),
    bf16: 10,240 chunks, 1.36e9 exps and 2.04e10 operations in all; 0.51
    GB (0.31 ms of float32 operations against 0.15 ms of bytes)."""
    w = work(160, 4096, 64, 64, torch.bfloat16)
    n = 160 * 64
    assert w["exps"] == n * (2016 * 64 + 64 * 64 + 64)
    assert 1.36e9 <= w["exps"] <= 1.37e9
    assert 2.04e10 <= w["flops"] <= 2.05e10
    assert w["bytes"] == 2 * 4 * 160 * 4096 * 64 \
        + 4 * (160 * 4096 * 64 + 160 * 64 + 160 * 64 * 64)
    assert 5.05e8 <= w["bytes"] <= 5.07e8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_card(dtype, monkeypatch):
    """Run on a CUDA card with nvcc: the kernel against its plain version
    at B 2, S 384, H 3, c 64, chunk 64 and at chunk 24, c 16. float32
    within 1e-5 relative; bfloat16 y within 2^-7 and the float32 state
    within 1e-5 (chip_smoke.py holds the forward's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for c, chunk in ((64, 64), (16, 24)):
        r, k, v, logw, u = _inputs(2, 384, 3, c, 0.0, seed=5)
        args = [torch.from_numpy(a).cuda() for a in
                _fold(r, k, v, logw) + [_fold_u(u, 2)]]
        for i in (0, 1, 2):
            args[i] = args[i].to(dtype)
        before = wkv6_scan.launches
        y, state = wkv6_scan(*args, chunk=chunk)
        y2, state2 = wkv6_scan(*args, chunk=chunk)
        py, ps = wkv6_scan_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert wkv6_scan.launches == before + 2
        assert torch.equal(y, y2) and torch.equal(state, state2)
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        assert _rel(y.float().cpu(), py.float().cpu()) <= tol
        assert _rel(state.cpu(), ps.cpu()) <= 1e-5
