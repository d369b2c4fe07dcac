"""The port's SSD scan (``repro_torch.kernels.ssd_scan`` and its dispatch
``kernels.ops.ssd``) against the JAX package's Pallas kernel ``ssd_scan``
(run in interpret mode, as the JAX package's own tests run it on the CPU)
and its oracle ``kernels/ref.py::ssd_ref`` (the sequential recurrence), on
the same numpy inputs.

Tolerances, as max|port - jax| / max|jax| (measured on the CPU):
- ``ssd_scan_plain`` vs ``ssd_scan`` (interpret) at the reference's own
  test shapes (``tests/test_kernels.py::test_ssd_kernel``), a chunk of 200
  (zamba2-7b's chunk for a 200-token prompt) and 8 heads: float32 y and
  state within 1e-5 (measured 3.0e-6 and 4.2e-6: the two cumsums sum in
  another order, and at chunk 200 the cumsum reaches -125, where one ulp is
  7.6e-6 of the exponent); bfloat16 y within 2^-8 (measured 2.3e-3: a few
  elements round to the neighbouring bf16 value) and the float32 state
  within 1e-5 (measured 4.2e-6);
- ``ops.ssd`` (model layout) vs ``ssd_ref`` on the same (bf16-rounded)
  inputs upcast to float32: float32 y and state within 1e-5 (measured
  2.3e-6 and 2.6e-6), bfloat16 y within 2^-7 (the port rounds y once to
  bf16, the oracle returns float32; measured 3.1e-3) and the float32 state
  within 1e-5 (measured 2.7e-6).
The CUDA kernel itself runs only on a card (the ``cuda`` test below, and
``chip_smoke.py``); its source runs on the CPU in
``tests/test_torch_kernel_emulation.py``.

The bf16 kernel's precision plan (its products on the tensor cores: C B^T
from the bf16 values, the decayed scores on the CUDA cores as the plain
version computes them, the scores, the carried state and x w entering
their products as three bf16 terms, each sum taken in another order than
the plain version's) is pinned here against the card's bounds; two bf16
terms instead of three are shown to fail them through the state alone,
and one term through y and the state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_scan import ssd_scan as jssd_scan
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import check_smem_fit, smem_plan, \
    ssd_scan, ssd_scan_plain, tc_operations, tc_scratch, tc_smem_plan, work

#: (b, s, h, p, n, chunk): the reference's own test shapes, a chunk of 200
#: (not a multiple of any tile) and 8 heads over 2 batch rows
SHAPES = [(1, 128, 2, 16, 8, 32), (2, 256, 3, 32, 16, 64),
          (1, 64, 1, 64, 64, 64), (1, 200, 2, 16, 16, 200),
          (2, 128, 8, 16, 16, 32)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(b, s, h, p, n, seed=0):
    """x [b, s, h, p], dt [b, s, h], A [h], Bm/Cm [b, s, n] float32, with
    the reference test's ranges."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)) * 0.5
    dt = rng.uniform(0.1, 0.9, (b, s, h))
    A = -rng.uniform(0.5, 2.0, (h,))
    Bm = rng.standard_normal((b, s, n)) * 0.3
    Cm = rng.standard_normal((b, s, n)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """x (float32) as ``terms`` bf16 terms, each the rounding of what the
    terms before it left (``csrc/tma_wgmma.cuh::split_terms``); their sum
    in float64 (three terms hold a float32 exactly)."""
    total, rest = torch.zeros_like(x, dtype=torch.float64), x
    for _ in range(terms):
        part = rest.bfloat16().float()
        total += part.double()
        rest = rest - part
    return total


def _tensor_core_plan(x, dt, A, Bm, Cm, *, heads: int, chunk: int,
                      terms: int = 3):
    """The bf16 tensor-core kernel's arithmetic, in ``ssd_scan_plain``'s op
    order: every product of the chunk summed exactly (float64) and rounded
    once to float32, as a tensor core's other order of sums may at best:
    C B^T from the bf16 values; the decayed scores ``cb * exp(cum_t -
    cum_s) * dt_s`` in float32 as the plain version computes them; the
    scores, the carried state and ``x w`` into their products as ``terms``
    bf16 terms; y rounded once to x's type, the state in float32."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    B, H, Q = BH // heads, heads, chunk
    xv, dtv, Av = x.reshape(B, H, S, P), dt.reshape(B, H, S), \
        A.reshape(B, H, 1)
    mask = torch.ones((Q, Q), dtype=torch.bool).tril()
    state = torch.zeros((B, H, N, P))
    y = torch.empty_like(xv)
    for c0 in range(0, S, Q):
        xc, dtc = xv[:, :, c0:c0 + Q].float(), dtv[:, :, c0:c0 + Q]
        Bc, Cc = (m[:, None, c0:c0 + Q].double() for m in (Bm, Cm))
        cum = torch.cumsum((dtc * Av).double(), dim=-1).float()
        dec = torch.where(mask, torch.exp(cum[..., :, None]
                                          - cum[..., None, :]), 0.0)
        cb = torch.matmul(Cc, Bc.transpose(-1, -2)).float()
        scores = cb * dec * dtc[..., None, :]
        yc = torch.matmul(_terms(scores, terms), xc.double()).float()
        yc = yc + torch.matmul(Cc, _terms(state, terms)).float() \
            * torch.exp(cum)[..., None]
        y[:, :, c0:c0 + Q] = yc.to(x.dtype)
        a_tot = cum[..., -1:]
        w = torch.exp(a_tot - cum) * dtc
        state = torch.exp(a_tot)[..., None] * state + torch.matmul(
            Bc.transpose(-1, -2), _terms(xc * w[..., None], terms)).float()
    return y.view(BH, S, P), state.view(BH, N, P)


def _bf16_steps(a, b):
    """Per element, |a - b| in units of the bfloat16 spacing at b (as
    ``chip_smoke.py`` counts them)."""
    b = b.float()
    _, exp = torch.frexp(b)
    step = torch.ldexp(torch.ones_like(b), exp - 8).clamp_min(2.0 ** -133)
    return (a.float() - b).abs() / step


def _fold(x, dt, A, h):
    """The kernel layout of the model layout's x, dt, A (numpy)."""
    b, s, _, p = x.shape
    return (np.ascontiguousarray(x.swapaxes(1, 2).reshape(b * h, s, p)),
            np.ascontiguousarray(dt.swapaxes(1, 2).reshape(b * h, s)),
            np.broadcast_to(A[None], (b, h)).reshape(b * h).copy())


def _round(a, dtype: str) -> np.ndarray:
    """``a`` rounded to ``dtype`` and back to float32."""
    return np.array(jnp.asarray(a, getattr(jnp, dtype)).astype(jnp.float32))


@pytest.mark.parametrize("dtype,y_tol", [("float32", 1e-5),
                                         ("bfloat16", 2.0 ** -8)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_tpu_kernel_in_interpret_mode(shape, dtype, y_tol):
    b, s, h, p, n, chunk = shape
    x, dt, A, Bm, Cm = _inputs(b, s, h, p, n)
    xf, dtf, Af = _fold(x, dt, A, h)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, want_s = jssd_scan(jnp.asarray(xf, jd), jnp.asarray(dtf),
                               jnp.asarray(Af), jnp.asarray(Bm, jd),
                               jnp.asarray(Cm, jd), heads=h, chunk=chunk,
                               interpret=True)
    y, state = ssd_scan_plain(
        torch.from_numpy(xf).to(td), torch.from_numpy(dtf),
        torch.from_numpy(Af), torch.from_numpy(Bm).to(td),
        torch.from_numpy(Cm).to(td), heads=h, chunk=chunk)
    assert y.dtype == td and state.dtype == torch.float32
    assert tuple(y.shape) == (b * h, s, p) and \
        tuple(state.shape) == (b * h, n, p)
    assert _rel(y.float().numpy(),
                np.asarray(want_y.astype(jnp.float32))) <= y_tol
    assert _rel(state.numpy(), np.asarray(want_s)) <= 1e-5


@pytest.mark.parametrize("dtype,y_tol", [("float32", 1e-5),
                                         ("bfloat16", 2.0 ** -7)])
@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[3:4])
def test_ops_ssd_matches_the_oracle(shape, dtype, y_tol):
    """``ops.ssd`` in the model layout against the sequential recurrence on
    the same inputs (rounded to ``dtype``, then float32)."""
    b, s, h, p, n, chunk = shape
    x, dt, A, Bm, Cm = _inputs(b, s, h, p, n, seed=1)
    x, Bm, Cm = (_round(a, dtype) for a in (x, Bm, Cm))
    want_y, want_s = jref.ssd_ref(*(jnp.asarray(a)
                                    for a in (x, dt, A, Bm, Cm)))
    td = getattr(torch, dtype)
    y, state = ops.ssd(torch.from_numpy(x).to(td), torch.from_numpy(dt),
                       torch.from_numpy(A), torch.from_numpy(Bm).to(td),
                       torch.from_numpy(Cm).to(td), chunk)
    assert tuple(y.shape) == (b, s, h, p) and \
        tuple(state.shape) == (b, h, n, p)
    assert _rel(y.float().numpy(), np.asarray(want_y)) <= y_tol
    assert _rel(state.numpy(), np.asarray(want_s)) <= 1e-5


@pytest.mark.parametrize("terms,within",
                         [(3, True), (2, False), (1, False)])
@pytest.mark.parametrize("shape", SHAPES[1:2] + SHAPES[3:4] +
                         [(2, 512, 4, 64, 64, 256)])
def test_the_tensor_core_precision_plan(shape, terms, within):
    """Against ``ssd_scan_plain`` in bf16 (the card's bounds: y within one
    bf16 step of its largest value, at most 1e-3 of the elements more than
    one bf16 step apart, the float32 state within 1e-6), at the reference's
    chunk 64, chunk 200 and zamba2-7b's chunk 256 at N = P = 64: with three
    terms the plan holds (measured y 7.9e-7-2.3e-3, a few elements rounding
    the other way; no element over one step; state 3.0e-8-8.0e-8); two
    terms keep y within its bounds (measured 1.4e-3-2.3e-3, 1.0e-4-1.6e-4
    over one step) but put the state over 1e-6 (3.7e-6-4.7e-6); one term
    puts over 10x that share over one step (measured 6.3e-2-7.2e-2) and
    the state over 1e-5 (1.9e-3-3.0e-3)."""
    b, s, h, p, n, chunk = shape
    x, dt, A, Bm, Cm = _inputs(b, s, h, p, n)
    xf, dtf, Af = (torch.from_numpy(a) for a in _fold(x, dt, A, h))
    args = (xf.bfloat16(), dtf, Af, torch.from_numpy(Bm).bfloat16(),
            torch.from_numpy(Cm).bfloat16())
    want_y, want_s = ssd_scan_plain(*args, heads=h, chunk=chunk)
    got_y, got_s = _tensor_core_plan(*args, heads=h, chunk=chunk,
                                     terms=terms)
    share = float((_bf16_steps(got_y, want_y) > 1).float().mean())
    y_err = _rel(got_y.float().numpy(), want_y.float().numpy())
    s_err = _rel(got_s.numpy(), want_s.numpy())
    if within:
        assert y_err <= 2.0 ** -7
        assert share <= 1e-3
        assert s_err <= 1e-6
    elif terms == 2:
        assert y_err <= 2.0 ** -7 and share <= 1e-3  # y does not see it
        assert s_err > 1e-6
    else:
        assert share > 1e-2
        assert s_err > 1e-5


def test_ops_ssd_folds_and_dispatches_the_plain_version(monkeypatch):
    """A CPU tensor runs ``ssd_scan_plain`` once, on the folded layout
    ``[b h, s, ...]`` with B and C shared by a batch row's heads; the
    results unfold to ``[b, s, h, p]`` and ``[b, h, n, p]``; autograd flows
    through the plain version on the CPU."""
    b, s, h, p, n, chunk = 2, 64, 3, 16, 8, 32
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs(b, s, h, p, n, seed=2))
    calls = []

    def counted(*args, heads, chunk):
        calls.append((tuple(args[0].shape), heads, chunk))
        return ssd_scan_plain(*args, heads=heads, chunk=chunk)

    monkeypatch.setattr(ops, "ssd_scan_plain", counted)
    before = ssd_scan.launches
    y, state = ops.ssd(x, dt, A, Bm, Cm, chunk)
    assert calls == [((b * h, s, p), h, chunk)]
    assert ssd_scan.launches == before
    xf, dtf, Af = _fold(x.numpy(), dt.numpy(), A.numpy(), h)
    yf, sf = ssd_scan_plain(torch.from_numpy(xf), torch.from_numpy(dtf),
                            torch.from_numpy(Af), Bm, Cm, heads=h,
                            chunk=chunk)
    assert torch.equal(y, yf.reshape(b, h, s, p).transpose(1, 2))
    assert torch.equal(state, sf.reshape(b, h, n, p))
    xg = x.clone().requires_grad_()
    ops.ssd(xg, dt, A, Bm, Cm, chunk)[0].sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


def test_a_sequence_the_chunk_does_not_divide_raises():
    """Where the reference's fallback asserts (``ssd_chunked``), the port
    raises ``ValueError``; so does the plain version."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs(1, 300, 2, 16, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd(x, dt, A, Bm, Cm, 256)
    with pytest.raises(ValueError, match="does not divide"):
        ssd_scan_plain(x[0].transpose(0, 1).contiguous(),
                       dt[0].T.contiguous(), A, Bm, Cm, heads=2, chunk=256)


def test_a_cuda_input_that_needs_a_gradient_raises(monkeypatch):
    """On the card the kernel has no gradient: an input that needs one
    raises naming the ROADMAP row, before anything launches; without a
    gradient it launches (a CPU tensor whose ``device`` reads ``cuda``
    stands in for the card here)."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs(1, 64, 2, 16, 8))

    class FakeCuda:
        type = "cuda"

    x = x.requires_grad_()
    launched = []

    def fake(*args, heads, chunk):
        launched.append(heads)
        BH, S, P = args[0].shape
        return torch.zeros(BH, S, P), torch.zeros(BH, args[3].shape[-1], P)

    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: FakeCuda))
    monkeypatch.setattr(ops, "ssd_scan", fake)
    with pytest.raises(NotImplementedError, match="A11f"):
        ops.ssd(x, dt, A, Bm, Cm, 32)
    with torch.no_grad():
        ops.ssd(x, dt, A, Bm, Cm, 32)
    assert launched == [2]


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"), ("rank", "must be"), ("heads", "multiple"),
    ("dtype", "must share"), ("dt", "float32"), ("chunk", "does not divide")])
def test_the_kernel_wrapper_refuses_what_it_cannot_take(case, match):
    """The CUDA wrapper checks before it launches and never runs the plain
    version: a CPU tensor is refused too."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs(1, 64, 2, 16, 8))
    xf, dtf, Af = (torch.from_numpy(a)
                   for a in _fold(x.numpy(), dt.numpy(), A.numpy(), 2))
    good = dict(x=xf, dt=dtf, A=Af, Bm=Bm, Cm=Cm, heads=2, chunk=32)
    bad = {"cpu": {}, "rank": {"x": xf[0]}, "heads": {"heads": 3},
           "dtype": {"x": xf.half(), "Bm": Bm.half(), "Cm": Cm.half()},
           "dt": {"dt": dtf.double()}, "chunk": {"chunk": 48}}[case]
    args = {**good, **bad}
    before = ssd_scan.launches
    with pytest.raises(ValueError, match=match):
        ssd_scan(args.pop("x"), args.pop("dt"), args.pop("A"),
                 args.pop("Bm"), args.pop("Cm"), **args)
    assert ssd_scan.launches == before


def test_the_shared_memory_plan_fits_and_refuses_the_rest():
    """The kernel's block at zamba2-7b's chunk 256, N = P = 64 fits the
    232,448 B a block may use; other dims raise naming the limit."""
    plan = check_smem_fit(256, 64, 64)
    assert plan["total"] == 203_776 <= 232_448
    assert smem_plan(200, 64, 64) == plan
    assert check_smem_fit(1, 8, 16)["total"] < plan["total"]
    for args, match in (((257, 64, 64), "chunk in"), ((0, 64, 64), "chunk"),
                        ((256, 128, 64), "N a multiple"),
                        ((256, 64, 6), "P a multiple")):
        with pytest.raises(ValueError, match=match):
            check_smem_fit(*args)


def test_work_counts_the_serving_shape():
    """zamba2-7b's prefill of 4 x 4096 tokens (BH 448, chunk 256, N = P =
    64), bf16: 448 x 16 chunks x 6,307,840 multiply-adds; 489 MB."""
    w = work(448, 4096, 64, 64, 256, torch.bfloat16, heads=112)
    assert w["flops"] == 2 * 448 * 16 * 6_307_840
    assert 9.04e10 <= w["flops"] <= 9.05e10
    assert w["bytes"] == 2 * (2 * 448 * 4096 * 64 + 2 * 4 * 4096 * 64) \
        + 4 * (448 * 4096 + 448 + 448 * 64 * 64)
    assert 4.88e8 <= w["bytes"] <= 4.89e8


def test_the_tensor_core_kernel_s_operations_scratch_and_plan():
    """At zamba2-7b's serving shape the bf16 kernel issues 256 m64n64k16
    products per chunk (10 tile pairs of C B^T, 4, and scores x, 4 x 3
    terms; C S, 4 x 3 per row sub-tile; L, 3 per 16 rows): 2.4e11
    operations, 2.66x ``work``'s count. Its scratch is the carried states
    (117 MB there) and a zeroed flag per state and the ticket counter; its
    shared memory, whatever the dims, fits the 232,448 B a block may use
    once (two buffers of x, B, C)."""
    ops = tc_operations(448, 4096, 256)
    assert ops == 448 * 16 * 256 * 2 * 64 * 64 * 16
    assert 2.65 < ops / work(448, 4096, 64, 64, 256, heads=112)["flops"] \
        < 2.67
    # a chunk of 72 is zero-filled to two sub-tiles: 3 pairs, 2 tiles of C S
    assert tc_operations(6, 144, 72) == \
        6 * 2 * (3 * 16 + 2 * 12 + 8 * 3) * 2 * 64 * 64 * 16
    states, flags = tc_scratch(448, 4096, 256, "cpu")
    assert tuple(states.shape) == (16, 448, 64 * 64)
    assert states.dtype == torch.float32
    assert states.numel() * 4 == 117_440_512
    assert tuple(flags.shape) == (16 * 448 + 1,) and not flags.any()
    plan = tc_smem_plan()
    assert plan["total"] == sum(v for k, v in plan.items() if k != "total")
    assert 232_448 / 2 < plan["total"] <= 232_448


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_card(dtype, monkeypatch):
    """Run on a CUDA card with nvcc: the kernel against its plain version
    at b 2, s 400, h 3, p 32, n 16, chunk 200. float32 within 1e-5
    relative; bfloat16 y within 2^-7 and the float32 state within 1e-5
    (chip_smoke.py holds the serving shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x, dt, A, Bm, Cm = _inputs(2, 400, 3, 32, 16, seed=4)
    xf, dtf, Af = _fold(x, dt, A, 3)
    args = [torch.from_numpy(a).cuda() for a in (xf, dtf, Af, Bm, Cm)]
    for i in (0, 3, 4):
        args[i] = args[i].to(dtype)
    before = ssd_scan.launches
    y, state = ssd_scan(*args, heads=3, chunk=200)
    y2, state2 = ssd_scan(*args, heads=3, chunk=200)
    py, ps = ssd_scan_plain(*args, heads=3, chunk=200)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(state, state2)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert _rel(y.float().cpu(), py.float().cpu()) <= tol
    assert _rel(state.cpu(), ps.cpu()) <= 1e-5
