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

The bf16 kernel's precision plan is pinned here against the card's bounds
(``_tensor_core_plan``): the decays taken per sub-chunk of 16 steps, the
pairs within a sub-chunk on the CUDA cores as the plain version computes
them, every other pair through the chunk's own states at the sub-chunk
ends; the chunk's states (which feed the carried state) from three bf16
terms of ``k exp(cum_b - cum)``, the products that feed only y from two
terms of each float32 operand. Three terms for y as well change nothing
the bounds see; two terms for the states put the float32 state over 1e-6
(``chip_smoke.py``'s ``WKV_BF16_STATE_RTOL``), and one term puts y over
its bounds too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6 import wkv6_scan as jwkv6_scan
from repro_torch.kernels import ops
from repro_torch.kernels.wkv6_scan import check_smem_fit, cumsum_rounded, \
    smem_plan, tc_operations, tc_scratch, tc_smem_plan, wkv6_scan, \
    wkv6_scan_plain, work

#: (B, S, H, c, chunk, w0): the reference test's three shapes, and strong
#: decay
CASES = [(1, 64, 2, 16, 32, 0.0), (2, 128, 2, 32, 64, 0.0),
         (1, 256, 4, 64, 64, 0.0), (1, 128, 2, 64, 64, 5.0)]
STRONG = 5.0
#: steps of the bf16 kernel's sub-chunk: pairs within one keep one exp each
SUB = 16


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


def _split(x: torch.Tensor, terms: int) -> list:
    """x (float32) as ``terms`` bf16 terms, each the rounding of what the
    terms before it left (``csrc/tma_wgmma.cuh::split_terms``), as float64
    tensors (three terms hold a float32 exactly)."""
    parts, rest = [], x
    for _ in range(terms):
        part = rest.bfloat16().float()
        parts.append(part.double())
        rest = rest - part
    return parts


def _times_exact(a: torch.Tensor, b: torch.Tensor, terms: int):
    """a @ b, a (float32) as ``terms`` bf16 terms, b exact in bf16 (float64),
    summed exactly (float64)."""
    return sum(part @ b for part in _split(a, terms))


def _times_split(a: torch.Tensor, b: torch.Tensor, terms: int):
    """a @ b of two float32 operands as ``terms`` bf16 terms each, the
    products of terms p, q with p + q < ``terms`` summed exactly
    (float64)."""
    A, B = _split(a, terms), _split(b, terms)
    return sum(A[p] @ B[q] for p in range(terms) for q in range(terms - p))


def _tensor_core_plan(r, k, v, logw, u, *, chunk: int, terms: int = 3,
                      y_terms: int = 2):
    """The bf16 tensor-core kernel's arithmetic, in ``wkv6_scan_plain``'s op
    order where the two share it, every product summed exactly (float64)
    and y rounded once, as a tensor core's other order of sums may at best:
    the cumsum and cum_prev as the plain version; the pairs s < t within a
    sub-chunk of ``SUB`` steps and the u bonus in float32 as the plain
    version computes them, then as ``y_terms`` bf16 terms times v; the
    chunk's state at the end e of each sub-chunk g chained as the state is
    across chunks, S_e = exp(cum_e - cum_e') S_e' + U_g with U_g = sum_{s
    in g} (k_s exp(cum_e - cum_s)) v_s^T from ``terms`` terms of its k
    exp(cum_e - cum); for t in sub-chunk g + 1, r_t exp(min(cum_prev_t -
    cum_e, 0)) times S_e, both float32 operands as ``y_terms`` terms;
    (r exp(cum_prev)) S_prev likewise; the carried state exp(cum_tot)
    S_prev + L as the plain version, L the chunk's state at its last
    step."""
    BH, S, c = r.shape
    Q = chunk
    t = torch.arange(Q, device=r.device)
    within = (t[:, None] // SUB == t[None, :] // SUB) & \
        (t[None, :] < t[:, None])
    u32 = u.float()[:, None, :]
    state = torch.zeros((BH, c, c), device=r.device)
    y = torch.empty_like(r)
    for c0 in range(0, S, Q):
        rc, kc, vc = (x[:, c0:c0 + Q].float() for x in (r, k, v))
        vd = vc.double()
        lw = logw[:, c0:c0 + Q]
        cum = cumsum_rounded(lw, dim=1)
        cum_prev = cum - lw
        dec = torch.where(within[:, :, None], torch.exp(torch.clamp(
            cum_prev[:, :, None, :] - cum[:, None, :, :], max=0.0)), 0.0)
        scores = (rc[:, :, None, :] * dec * kc[:, None, :, :]).sum(-1)
        scores = scores + torch.diag_embed((rc * u32 * kc).sum(-1))
        yc = _times_exact(scores, vd, y_terms)
        for lo in range(0, Q, SUB):
            e = min(lo + SUB, Q) - 1
            kd = kc[:, lo:e + 1] * torch.exp(cum[:, e:e + 1]
                                             - cum[:, lo:e + 1])
            part = _times_exact(kd.transpose(1, 2), vd[:, lo:e + 1],
                                terms).float()
            local = part if lo == 0 else torch.exp(
                cum[:, e:e + 1] - cum[:, lo - 1:lo]).transpose(1, 2) \
                * local + part
            rows = slice(e + 1, e + 1 + SUB)
            rt = rc[:, rows] * torch.exp(torch.clamp(
                cum_prev[:, rows] - cum[:, e:e + 1], max=0.0))
            yc[:, rows] += _times_split(rt, local, y_terms)
        yc += _times_split(rc * torch.exp(cum_prev), state, y_terms)
        y[:, c0:c0 + Q] = yc.float().to(r.dtype)
        state = torch.exp(cum[:, -1:]).transpose(1, 2) * state + local
    return y, state


def _bf16_steps(a, b):
    """Per element, |a - b| in units of the bfloat16 spacing at b (as
    ``chip_smoke.py`` counts them)."""
    b = b.float()
    _, exp = torch.frexp(b)
    step = torch.ldexp(torch.ones_like(b), exp - 8).clamp_min(2.0 ** -133)
    return (a.float() - b).abs() / step


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


@pytest.mark.parametrize("terms,y_terms", [(3, 2), (3, 3), (2, 2), (1, 1)],
                         ids=["shipped", "three", "two", "one"])
@pytest.mark.parametrize("shape", [(2, 256, 4, 64, 64, 0.0),
                                   (2, 120, 3, 16, 24, 0.0),
                                   (1, 256, 4, 64, 64, STRONG)],
                         ids=["rwkv6-3b", "smoke", "strong"])
def test_the_tensor_core_precision_plan(shape, terms, y_terms):
    """Against ``wkv6_scan_plain`` in bf16 (the card's bounds: y within one
    bf16 step of its largest value, at most 1e-3 of the elements more than
    one bf16 step apart, the float32 state within 1e-6), at rwkv6-3b's
    chunk 64 and head size 64, the smoke head size 16 at chunk 24, and
    strong decay. The shipped plan (three terms for the chunk's states, two
    for y's products) holds (measured y 1.5e-3-1.8e-3, 4.6e-5-1.7e-4 over
    one step, state 0-6.3e-8), as do three terms throughout (y 0-5.5e-5,
    none over one step: y's bounds do not tell its two terms from three);
    two terms throughout keep y within its bounds but put the state over
    1e-6 (1.5e-6-2.0e-6) except under strong decay, where the state is
    all but the last step's k v, near exact in any terms (measured
    6.0e-12); one term puts over 10x that share of y over one step
    (5.0e-2-8.4e-2) and, except under strong decay, the state over 1e-5
    (1.1e-3-1.2e-3; strong decay 3.6e-8)."""
    B, S, H, c, chunk, w0 = shape
    r, k, v, logw, u = _inputs(B, S, H, c, w0, seed=6)
    args = [torch.from_numpy(a) for a in _fold(r, k, v, logw)] + \
        [torch.from_numpy(_fold_u(u, B))]
    for i in (0, 1, 2, 4):
        args[i] = args[i].bfloat16()
    want_y, want_s = wkv6_scan_plain(*args, chunk=chunk)
    got_y, got_s = _tensor_core_plan(*args, chunk=chunk, terms=terms,
                                     y_terms=y_terms)
    share = float((_bf16_steps(got_y, want_y) > 1).float().mean())
    y_err = _rel(got_y.float().numpy(), want_y.float().numpy())
    s_err = _rel(got_s.numpy(), want_s.numpy())
    if terms == 3:
        assert y_err <= 2.0 ** -7 and share <= 1e-3 and s_err <= 1e-6
    elif terms == 2:
        assert y_err <= 2.0 ** -7 and share <= 1e-3  # y does not see it
        assert s_err > 1e-6 if w0 != STRONG else s_err <= 1e-6
    else:
        assert share > 1e-2
        assert s_err > 1e-5 if w0 != STRONG else s_err <= 1e-6


def test_the_tensor_core_kernel_s_operations_scratch_and_plan():
    """At rwkv6-3b's forward shape (BH 160, S 4096, chunk 64) the bf16
    kernel issues 56 m64n64k16 products per chunk (each sub-chunk's part
    of the chunk's state, 4 slices x 3 terms; the scores x v, 4 x 2; r~
    S_e, 12 x 3) and 12 more (r exp(cum_prev) S_prev, 4 x 3) in every
    chunk but a row's first: 9.1e10 operations, 4.5x ``work``'s count. Its
    scratch is a ring of two carried states per row (5.2 MB there) and a
    zeroed flag per slot and the ticket counter; its shared memory,
    whatever the dims, fits an SM twice."""
    n = tc_operations(160, 4096, 64)
    assert n == 160 * (64 * 56 + 63 * 12) * 2 * 64 * 64 * 16
    assert 4.4 < n / work(160, 4096, 64, 64)["flops"] < 4.5
    # a chunk of 24: two sub-chunks (one state at step 15), 2 x 3 + 2 x 2
    # + 4 x 3 products, and 4 x 3 after the first chunk
    assert tc_operations(6, 120, 24) == \
        6 * (5 * 22 + 4 * 12) * 2 * 64 * 64 * 16
    states, flags = tc_scratch(160, "cpu")
    assert tuple(states.shape) == (160, 2, 64 * 64)
    assert states.dtype == torch.float32
    assert states.numel() * 4 == 5_242_880
    assert tuple(flags.shape) == (2 * 160 + 1,) and not flags.any()
    plan = tc_smem_plan()
    assert plan["total"] == sum(v for k, v in plan.items() if k != "total")
    assert plan["total"] == 114_704
    assert 2 * (plan["total"] + 1024) <= 233_472


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
