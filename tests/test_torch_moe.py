"""The port's MoE slice (``repro_torch.models.moe``, the ``moe`` family of
``models.transformer``, the deepseek-moe-16b and arctic-480b configs)
against the JAX package on the same weights, carried across by
``convert.lm_params_from_jax``, and the same numpy inputs. Prefill and
greedy decode of both MoE smoke configs are in ``tests/test_torch_lm.py``
(its ``ARCHS``).

On the CPU the JAX package's experts take ``jnp.einsum``; the port's take
``gmm_plain`` where C, D and F are multiples of 128 and einsum elsewhere.

Tolerances, as max|port - jax| / max|jax| (measured on the CPU):
- ``moe_apply`` out, float32, deepseek / arctic smoke configs, with and
  without drops: within 1e-6 (measured 1.8e-7, 1.4e-7 with drops, arctic
  3.0e-7), aux within 1e-6 absolute (measured 0); bfloat16 within 2^-6
  (measured 7.1e-3 and 7.8e-3: the bf16 expert and shared FFNs round at
  other places in the two frameworks, as ``grouped_swiglu`` does in
  ``tests/test_torch_gmm.py``), aux within 1e-6 (measured 1.2e-7);
- the bfloat16 combine alone (experts replaced by the identity, no shared
  branch): bitwise equal, with and without drops: XLA adds the
  ``.at[st].add`` updates one by one in bf16 in their sorted order, and the
  port adds each token's contributions in that order;
- tied router probabilities (a zero router): within 1e-6 (measured 1.7e-7),
  aux measured 0;
- the aligned config (C = D = F = 128, ``gmm_plain``): within 1e-6
  (measured 1.6e-7), aux measured 0;
- ``forward`` logits within 1e-4 (measured 2.1e-5) and aux within 1e-6
  (measured 2.4e-7); bfloat16 prefill logits within 0.1 (measured 4.2e-2;
  over six prompts 4.4e-3 to 4.2e-2, where the dense Yi-9B smoke config
  reads 3.3e-3 to 3.6e-2: bf16 rounds at other places in the two
  frameworks, as ``tests/test_torch_lm.py`` bounds its bf16 decode);
- three ``make_train_step`` steps: loss within 1e-6 relative (measured
  3.8e-7), aux_loss within 1e-6 (measured 2.4e-7), grad_norm within 2e-3
  (measured 5.5e-6), every parameter within 2e-2 of its largest value and
  at most 10 % of its elements further apart than 1e-3 of it (measured
  4.2e-5 and 0; the bounds of ``tests/test_torch_train.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import make_cache as jmake_cache
from repro.models import model_defs as jmodel_defs
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro_torch import configs, optim
from repro_torch.convert import adamw_state_from_jax, lm_params_from_jax
from repro_torch.data import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.kernels.gmm import gmm_plain
from repro_torch.launch.serve import serve
from repro_torch.models import forward, init_params, make_cache, \
    model_defs, prefill
from repro_torch.models import moe as tmoe
from repro_torch.optim.transform import tree_items
from repro_torch.training import TrainConfig, make_train_step

TOKENS = (2, 64)        # [B, S] of the moe_apply inputs: T = 128


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The smoke models are tiny: one intra-op thread runs them fastest, and
    the suite's parallel workers do not oversubscribe the cores. Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _configs(name: str, **moe_changes) -> tuple:
    jcfg, tcfg = jconfigs.get_smoke_config(name), \
        configs.get_smoke_config(name)
    if moe_changes:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_changes))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe_changes))
    return jcfg, tcfg


def _both_moe(jcfg, tcfg, dtype: str, params=None, tokens=TOKENS, seed=0):
    """(jax out, jax aux), (port out, port aux) of one MoE layer on the same
    weights (the JAX ``init_params``, cast to ``dtype``) and input."""
    if params is None:
        params = jinit_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    x = np.random.default_rng(seed).standard_normal(
        (*tokens, jcfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(lambda p, v: jmoe.moe_apply(jcfg, p, v))(
        params, jnp.asarray(x, dtype))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            device="cpu")
    tout, taux = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x).to(
        getattr(torch, dtype)))
    return (jout, jaux), (tout, taux)


def _drops(tcfg, params: dict, tokens=TOKENS, seed=0) -> int:
    """Token-expert pairs past their expert's capacity on the ``_both_moe``
    input (float32)."""
    x = np.random.default_rng(seed).standard_normal(
        (*tokens, tcfg.d_model)).astype(np.float32)
    T = tokens[0] * tokens[1]
    logits = torch.from_numpy(x).reshape(T, -1) @ torch.tensor(
        np.asarray(params["router"], np.float32))
    top = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                     stable=True)[1][:, :tcfg.moe.top_k]
    counts = torch.bincount(top.reshape(-1), minlength=tcfg.moe.num_experts)
    return int((counts - tmoe.capacity(tcfg, T)).clamp_min(0).sum())


# ---------------------------------------------------------------------------
# One MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [None, 1.0],
                         ids=["no-drops", "drops"])
@pytest.mark.parametrize("dtype,tol,aux_tol", [("float32", 1e-6, 1e-6),
                                               ("bfloat16", 2.0 ** -6, 1e-6)])
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "arctic-480b"])
def test_moe_apply_matches_reference(name, dtype, tol, aux_tol,
                                     capacity_factor):
    """deepseek-moe-16b (shared experts) and arctic-480b (dense residual)
    smoke configs; capacity factor 1.0 makes tokens drop."""
    changes = {} if capacity_factor is None else \
        {"capacity_factor": capacity_factor}
    jcfg, tcfg = _configs(name, **changes)
    params = jinit_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0))
    if capacity_factor is not None:
        assert _drops(tcfg, params) > 0
    (jout, jaux), (tout, taux) = _both_moe(jcfg, tcfg, dtype, params)
    assert tout.dtype == getattr(torch, dtype)
    assert tout.shape == (*TOKENS, tcfg.d_model)
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert _rel(_np(tout), _np(jout)) <= tol
    assert abs(float(taux) - float(jaux)) <= aux_tol


@pytest.mark.parametrize("capacity_factor", [None, 1.0],
                         ids=["no-drops", "drops"])
def test_bf16_combine_is_bitwise(monkeypatch, capacity_factor):
    """With the experts replaced by the identity in both packages and no
    shared branch, what is left is routing, dispatch and the combine: in
    bfloat16 the port's sequential adds in ascending expert id equal XLA's
    ``.at[st].add`` bit for bit."""
    changes = {"num_shared_experts": 0}
    if capacity_factor is not None:
        changes["capacity_factor"] = capacity_factor
    jcfg, tcfg = _configs("deepseek-moe-16b", **changes)
    monkeypatch.setattr(jmoe, "expert_ffn", lambda p, x: x)
    monkeypatch.setattr(tmoe, "expert_ffn", lambda p, x: x)
    (jout, _), (tout, _) = _both_moe(jcfg, tcfg, "bfloat16")
    assert np.array_equal(_np(tout), _np(jout))


def test_tied_router_probabilities_go_to_the_lower_expert():
    """A zero router ties every expert for every token: both packages send
    each token to experts 0..k-1 (``jax.lax.top_k``'s rule)."""
    jcfg, tcfg = _configs("deepseek-moe-16b")
    params = jinit_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0))
    params["router"] = jnp.zeros_like(params["router"])
    (jout, jaux), (tout, taux) = _both_moe(jcfg, tcfg, "float32", params)
    assert _rel(_np(tout), _np(jout)) <= 1e-6
    assert abs(float(taux) - float(jaux)) <= 1e-6
    # expert 0 alone, weighted by 1/k, is what the routed part sums
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            device="cpu")
    tp["experts"] = {k: v.clone() for k, v in tp["experts"].items()}
    for key in ("gate", "up", "down"):
        tp["experts"][key][1:] = 0
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (*TOKENS, tcfg.d_model)).astype(np.float32))
    out, _ = tmoe.moe_apply(tcfg, tp, x)
    shared = tmoe.ffn_apply(tcfg, tp["shared"], x)
    xf = x.reshape(1, -1, tcfg.d_model)
    e0 = tmoe.expert_ffn({k: v[:1] for k, v in tp["experts"].items()}, xf)
    want = e0.reshape(x.shape) * torch.tensor(1 / 3) + shared
    assert torch.allclose(out, want, rtol=1e-5, atol=1e-6)


def test_the_aligned_config_runs_the_plain_kernel(monkeypatch):
    """d_model 128, expert d_ff 128, 4 experts, top-2, capacity factor 1.0
    at T 256: C = 128, so the JAX package on a TPU would run ``gmm``, and
    the port on the CPU runs ``gmm_plain``, three times (gate, up, down)."""
    base = dict(num_layers=1, d_model=128, num_heads=4, num_kv_heads=4,
                d_ff=128, vocab_size=512, attention="gqa")
    jcfg = jconfigs.get_smoke_config("deepseek-moe-16b")
    jcfg = dataclasses.replace(jcfg, **base, moe=dataclasses.replace(
        jcfg.moe, num_experts=4, top_k=2, d_ff_expert=128,
        num_shared_experts=0, capacity_factor=1.0))
    tcfg = configs.get_smoke_config("deepseek-moe-16b")
    tcfg = dataclasses.replace(tcfg, **base, moe=dataclasses.replace(
        tcfg.moe, num_experts=4, top_k=2, d_ff_expert=128,
        num_shared_experts=0, capacity_factor=1.0))
    assert tmoe.capacity(tcfg, 256) == 128
    calls = []

    def counted(x, w):
        calls.append(tuple(x.shape) + (w.shape[-1],))
        return gmm_plain(x, w)

    monkeypatch.setattr(ops, "gmm_plain", counted)
    (jout, jaux), (tout, taux) = _both_moe(jcfg, tcfg, "float32",
                                           tokens=(2, 128))
    assert calls == [(4, 128, 128, 128)] * 3
    assert _rel(_np(tout), _np(jout)) <= 1e-6
    assert abs(float(taux) - float(jaux)) <= 1e-6


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(name: str):
    jcfg = jconfigs.get_smoke_config(name)
    return jcfg, jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("seq", [128, 32])
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "arctic-480b"])
def test_forward_logits_and_aux_match(name, seq):
    """The layers' aux losses summed in layer order, as the reference's
    scan carries them."""
    jcfg, jparams = _model(name)
    tcfg = configs.get_smoke_config(name)
    tokens = np.random.default_rng(seq).integers(1, tcfg.vocab_size,
                                                 (2, seq))
    want, jaux = jforward(jcfg, jparams, jnp.asarray(tokens))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    with torch.no_grad():
        got, aux = forward(tcfg, params, torch.as_tensor(tokens))
    assert got.shape == want.shape
    assert aux.dtype == torch.float32 and float(jaux) > 1.0
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert _rel(_np(got), _np(want)) <= 1e-4


def test_bf16_prefill_matches_reference():
    jcfg, jparams = _model("deepseek-moe-16b")
    jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(configs.get_smoke_config("deepseek-moe-16b"),
                               param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                     jparams)
    tokens = np.random.default_rng(5).integers(1, 512, (2, 32)).astype(
        np.int32)
    want, _ = jax.jit(lambda p, t, c: jprefill(jcfg, p, t, c))(
        jparams, jnp.asarray(tokens), jmake_cache(jcfg, 2, 40))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    got, cache = prefill(tcfg, params, torch.as_tensor(tokens).long(),
                         make_cache(tcfg, 2, 40, device="cpu"))
    assert got.dtype == cache["k"].dtype == torch.bfloat16
    assert _rel(_np(got), _np(want)) <= 0.1


def test_three_train_steps_match_the_jax_step():
    """``make_train_step`` with the load-balance loss (``aux_weight`` 0.01)
    against the jitted JAX step, from the same parameters and AdamW
    state."""
    jcfg, jparams = _model("deepseek-moe-16b")
    jtx = joptim.adamw(3e-4, weight_decay=0.1)
    jstate = jtx.init(jparams)
    jstep = jax.jit(jmake_train_step(jcfg, jtx, JTrainConfig()))
    tcfg = configs.get_smoke_config("deepseek-moe-16b")
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    state = adamw_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 device="cpu")
    tstep = make_train_step(tcfg, optim.adamw(3e-4, weight_decay=0.1),
                            TrainConfig())
    pipe = TokenPipeline(vocab_size=tcfg.vocab_size, global_batch=4,
                         seq_len=64, seed=0)
    for step in range(3):
        batch = pipe.batch(step)
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()})
        _, state, tm = tstep(params, state, {
            k: torch.as_tensor(v) for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-6 * abs(float(jm["loss"]))
        assert float(jm["aux_loss"]) > 1.0
        assert abs(float(tm["aux_loss"]) - float(jm["aux_loss"])) <= 1e-6
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            2e-3 * float(jm["grad_norm"])
        for path, p in tree_items(params):
            want = _np(_leaf(jparams, path))
            diff = np.abs(_np(p) - want)
            largest = np.abs(want).max()
            assert diff.max() <= 2e-2 * largest, path
            assert (diff > 1e-3 * largest).mean() <= 0.1, path


def test_serve_answers_on_the_cpu(monkeypatch):
    """``serve`` on the deepseek smoke config at a prompt of 128: flash
    prefill, the einsum experts (d_model 64 is not aligned) and decode; the
    greedy tokens reproducible from the seed."""
    cfg = configs.get_smoke_config("deepseek-moe-16b")
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 128))
    res = serve(cfg, prompts, 4, seed=3, device="cpu")
    assert res.tokens.shape == (2, 4)
    assert res.prefill_logits.shape == (2, 1, cfg.vocab_size)
    assert res.cache["k"].shape == (2, 2, 132, 4, 16)
    params = init_params(model_defs(cfg), torch.Generator().manual_seed(3),
                         "cpu")
    again = serve(cfg, prompts, 4, params=params, device="cpu")
    assert torch.equal(again.tokens, res.tokens)
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
