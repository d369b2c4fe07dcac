"""The port's hybrid slice (``repro_torch.models.ssm``, the hybrid branch of
``models.transformer``, ``configs/zamba2_7b.py``) against the JAX package
at zamba2-7b's smoke config (4 Mamba2 blocks, the shared attention after
every 2nd): the JAX ``init_params`` go through ``convert.lm_params_from_jax``,
and both packages run the same numpy inputs. On the CPU the port's scan is
the kernel's plain version (``ssd_scan_plain``) with a float32 state, as
the TPU kernel keeps it; the JAX package off the TPU runs ``ssd_chunked``,
whose state is x's type.

At prompt 128 (chunk 32) the port's shared attention is the flash path (on
the CPU the kernel's plain version) while JAX on the CPU takes ``sdpa_ref``;
at prompt 24 (chunk 24) both take ``sdpa_ref``.

Tolerances, as max|port - jax| / max|jax| (measured on the CPU):
- float32 ``mamba2_apply`` out within 2e-6 (measured 2.5e-7), its state
  within 1e-5 (measured 1.7e-6; the two scans' cumsums differ in order),
  conv tails within 1e-6 (measured 1.8e-7); ``mamba2_decode`` from the same
  float32 state: out within 2e-6 (measured 2.8e-7), state within 1e-6
  (measured 7.3e-8: ``softplus`` and ``exp`` differ by an ulp);
- bfloat16 ``mamba2_apply`` out within 2^-6 (measured 8.3e-3: bf16 rounds
  at other places in the two frameworks, XLA fusing elementwise chains in
  float32) and state within 2^-6 (measured 9.3e-3: the JAX state is
  bf16); ``mamba2_decode`` out within 2^-6 (measured 6.8e-3), state within
  1e-3 (measured 3.0e-4);
- float32 prefill logits and every cache tensor within 1e-4 (measured
  2.2e-6 and 4.2e-6), 3 decode steps' logits and caches within 1e-4
  (measured 9.3e-6 and 4.2e-6; from the carried JAX cache 1.8e-6);
  ``forward`` logits within 1e-4 (measured 2.0e-5);
- bfloat16 prefill (S 128 and 24): logits and caches within 0.1 (measured
  1.2e-2 / 1.5e-2 and 2.4e-2), with the shared attention's wq scaled by
  1/8. At the reference's own init the shared attention's scores have a
  std of ~16 at this size, and the JAX package's two SSD paths
  (``ssd_chunked``, and the kernel in interpret mode) part by 0.09-0.25 in
  bf16 logits from each other (the port: 0.41-0.45 from either), so the
  comparison would hold nothing; with the damped wq they part by 0.009-0.02.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import base as jbase
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import make_cache as jmake_cache
from repro.models import model_defs as jmodel_defs
from repro.models import prefill as jprefill
from repro.models import ssm as jssm
from repro.models.transformer import cache_spec as jcache_spec
from repro_torch import configs
from repro_torch.convert import lm_cache_from_jax, lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.models import base as tbase
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.base import iter_defs

NAME = "zamba2-7b"
BATCH, GEN = 2, 4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _configs(bf16: bool) -> tuple:
    jcfg, tcfg = jconfigs.get_smoke_config(NAME), \
        configs.get_smoke_config(NAME)
    if bf16:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16,
                                   compute_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16,
                                   compute_dtype=torch.bfloat16)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _reference(bf16: bool, damp: float = 1.0):
    """JAX config and parameters (the Mamba2 blocks' dt_bias, A_log, D_skip
    and conv biases made nonzero, so that every term is read; the shared
    attention's wq times ``damp``) and jitted prefill/decode; the port's
    config and the same parameters."""
    jcfg, tcfg = _configs(bf16)
    params = jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0))
    mamba = params["layers"]["mamba"]
    for i, key in enumerate(("dt_bias", "A_log", "D_skip", "conv_x_b",
                             "conv_bc_b")):
        noise = jax.random.normal(jax.random.PRNGKey(10 + i),
                                  mamba[key].shape)
        mamba[key] = (mamba[key] + 0.3 * noise).astype(mamba[key].dtype)
    attn = params["shared_attn"]["attn"]
    attn["wq"] = (attn["wq"] * damp).astype(attn["wq"].dtype)
    pre = jax.jit(lambda p, t, c: jprefill(jcfg, p, t, c))
    dec = jax.jit(lambda p, t, c, i: jdecode_step(jcfg, p, t, c, i))
    tparams = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return jcfg, params, pre, dec, tcfg, tparams


def _prompts(vocab: int, seq: int) -> np.ndarray:
    return np.random.default_rng(seq).integers(
        1, vocab, (BATCH, seq)).astype(np.int32)


def _layer(bf16: bool, index: int = 1) -> tuple:
    """One Mamba2 block's parameters in both packages."""
    jcfg, jp, _, _, tcfg, tp = _reference(bf16)
    return (jcfg, jax.tree_util.tree_map(lambda t: t[index],
                                         jp["layers"]["mamba"]),
            tcfg, {k: v[index] for k, v in tp["layers"]["mamba"].items()})


def _empty_layer_cache(tcfg, batch: int) -> dict:
    spec = tt.cache_spec(tcfg, batch, 8)
    return {k: torch.zeros(spec[k].shape[1:], dtype=spec[k].dtype)
            for k in ("state", "conv_x", "conv_bc")}


# ---------------------------------------------------------------------------
# Definitions
# ---------------------------------------------------------------------------

def _torch_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_model_tree_matches_reference(smoke):
    """Paths, shapes, axes, initializers and dtypes of the parameter and
    cache trees, from the definitions alone (nothing is allocated)."""
    get = "get_smoke_config" if smoke else "get_config"
    jcfg, tcfg = getattr(jconfigs, get)(NAME), getattr(configs, get)(NAME)
    jflat = dict(
        (tuple(k.key for k in path), (tuple(d.shape), tuple(d.axes), d.init,
                                      np.dtype(d.dtype).name))
        for path, d in jax.tree_util.tree_flatten_with_path(
            jmodel_defs(jcfg),
            is_leaf=lambda x: isinstance(x, jbase.ParamDef))[0])
    tflat = {path: (tuple(d.shape), tuple(d.axes), d.init,
                    _torch_name(d.dtype))
             for path, d in iter_defs(tt.model_defs(tcfg))}
    assert tflat == jflat
    jcache = jax.tree_util.tree_map(
        lambda d: (tuple(d.shape), tuple(d.axes), np.dtype(d.dtype).name),
        jcache_spec(jcfg, 3, 40),
        is_leaf=lambda x: isinstance(x, jbase.ParamDef))
    tcache = {k: (tuple(d.shape), tuple(d.axes), _torch_name(d.dtype))
              for k, d in tt.cache_spec(tcfg, 3, 40).items()}
    assert tcache == jcache
    assert tcfg.param_count() == jcfg.param_count()


def test_zamba2_7b_is_the_published_size():
    """81 Mamba2 blocks (d_inner 7,168: 112 heads of 64, state 64, conv 4,
    chunk 256) and one shared GQA block of 32 heads of 112 applied 9 times;
    6,596,986,576 parameters, 13.19 GB in bf16; the serving cache at
    4 x (4096 + 8): a 0.59 GB float32 SSM state and 2.12 GB of k and v."""
    cfg = configs.get_config(NAME)
    s = cfg.ssm
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim, cfg.vocab_size,
            cfg.hybrid_attn_every) == ("hybrid", 81, 3584, 32, 32, 112,
                                       32000, 9)
    assert (s.d_state, s.d_conv, s.expand, s.head_dim, s.chunk,
            s.n_groups) == (64, 4, 2, 64, 256, 1)
    assert tssm.ssm_dims(cfg) == (7168, 112)
    assert not cfg.tie_embeddings
    assert cfg.param_dtype == cfg.compute_dtype == torch.bfloat16
    assert cfg.param_count() == 6_596_986_576
    assert tbase.param_bytes(tt.model_defs(cfg)) == 2 * 6_596_986_576
    cache = tt.abstract_cache(cfg, 4, 4104)
    nbytes = {k: v.numel() * v.element_size() for k, v in cache.items()}
    assert cache["state"].shape == (81, 4, 112, 64, 64)
    assert cache["state"].dtype == torch.float32
    assert nbytes["state"] == 81 * 4 * 112 * 64 * 64 * 4
    assert cache["attn_k"].shape == (9, 4, 4104, 32, 112)
    assert 2.11e9 <= nbytes["attn_k"] + nbytes["attn_v"] <= 2.13e9


# ---------------------------------------------------------------------------
# The Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [64, 24])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_mamba2_apply_matches_reference(bf16, seq):
    """Prefill of one block (chunk 32 at S 64: two chunks; chunk 24 at S
    24): the output, and the state and conv tails it leaves for decode."""
    jcfg, jp, tcfg, tp = _layer(bf16)
    x = np.random.default_rng(seq).standard_normal(
        (BATCH, seq, jcfg.d_model)).astype(np.float32)
    jo, jc = jax.jit(lambda p, x: jssm.mamba2_apply(jcfg, p, x, cache={}))(
        jp, jnp.asarray(x, jcfg.compute_dtype))
    cache = _empty_layer_cache(tcfg, BATCH)
    to, tc = tssm.mamba2_apply(tcfg, tp,
                               torch.from_numpy(x).to(tcfg.compute_dtype),
                               cache=cache)
    assert tc is cache and tc["state"].dtype == torch.float32
    assert to.dtype == tcfg.compute_dtype and tuple(to.shape) == x.shape
    out_tol, state_tol, conv_tol = \
        (2.0 ** -6, 2.0 ** -6, 2.0 ** -6) if bf16 else (2e-6, 1e-5, 1e-6)
    assert _rel(_np32(to), _np32(jo)) <= out_tol
    assert _rel(_np32(tc["state"]), _np32(jc["state"])) <= state_tol
    for key in ("conv_x", "conv_bc"):
        assert _rel(_np32(tc[key]), _np32(jc[key])) <= conv_tol
    assert tssm.mamba2_apply(tcfg, tp, torch.from_numpy(x).to(
        tcfg.compute_dtype))[1] is None


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_mamba2_decode_matches_reference(bf16):
    """One recurrent step from the same float32 state and conv tails."""
    jcfg, jp, tcfg, tp = _layer(bf16)
    rng = np.random.default_rng(7)
    d_inner, H = tssm.ssm_dims(tcfg)
    s = tcfg.ssm
    x = rng.standard_normal((BATCH, 1, tcfg.d_model)).astype(np.float32)
    state = rng.standard_normal((BATCH, H, s.d_state, s.head_dim)) \
        .astype(np.float32)
    conv_x = rng.standard_normal((BATCH, s.d_conv - 1, d_inner)) \
        .astype(np.float32)
    conv_bc = rng.standard_normal((BATCH, s.d_conv - 1, 2 * s.d_state)) \
        .astype(np.float32)
    jdt, tdt = jcfg.compute_dtype, tcfg.compute_dtype
    jo, jc = jax.jit(functools.partial(jssm.mamba2_decode, jcfg))(
        jp, jnp.asarray(x, jdt),
        {"state": jnp.asarray(state), "conv_x": jnp.asarray(conv_x, jdt),
         "conv_bc": jnp.asarray(conv_bc, jdt)})
    # copies: the port writes its cache in place, and JAX may still be
    # reading the numpy buffers it was given
    cache = {"state": torch.tensor(state),
             "conv_x": torch.tensor(conv_x).to(tdt),
             "conv_bc": torch.tensor(conv_bc).to(tdt)}
    to, tc = tssm.mamba2_decode(tcfg, tp, torch.from_numpy(x).to(tdt),
                                cache)
    assert tc is cache and tc["state"].dtype == torch.float32
    assert to.dtype == torch.float32 and jo.dtype == jnp.float32
    assert _rel(_np32(to), _np32(jo)) <= (2.0 ** -6 if bf16 else 2e-6)
    assert _rel(_np32(tc["state"]), _np32(jc["state"])) <= \
        (1e-3 if bf16 else 1e-6)
    for key in ("conv_x", "conv_bc"):
        assert np.array_equal(_np32(tc[key]), _np32(jc[key]))


def test_the_decode_outer_product_is_the_reference_order():
    """``einsum("bn,bh,bhp->bhnp")`` in bf16: XLA multiplies ``(B dt) x``,
    rounding after each product; the port's order is bitwise equal on the
    CPU."""
    rng = np.random.default_rng(3)
    b, n, h, p = 2, 64, 112, 64
    Bm, dt, x = (rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, n), (b, h), (b, h, p)))
    want = jnp.einsum("bn,bh,bhp->bhnp", *(jnp.asarray(a, jnp.bfloat16)
                                           for a in (Bm, dt, x)))
    tb, td, tx = (torch.from_numpy(a).bfloat16() for a in (Bm, dt, x))
    got = (tb[:, None, :, None] * td[:, :, None, None]) * tx[:, :, None, :]
    assert np.array_equal(_np32(got), _np32(want))


# ---------------------------------------------------------------------------
# The hybrid stack
# ---------------------------------------------------------------------------

def _both_prefill(seq, bf16=False, damp=1.0):
    jcfg, jp, pre, _, tcfg, tp = _reference(bf16, damp)
    toks = _prompts(jcfg.vocab_size, seq)
    jl, jc = pre(jp, jnp.asarray(toks), jmake_cache(jcfg, BATCH, seq + GEN))
    tl, tc = tt.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                        tt.make_cache(tcfg, BATCH, seq + GEN, device="cpu"))
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("seq", [128, 24])
def test_prefill_and_decode_match_reference(seq):
    """Prefill, then 3 decode steps teacher-forced with JAX's greedy tokens,
    each package from its own cache; the port also decodes from the JAX
    cache carried across (``lm_cache_from_jax``)."""
    jcfg, jp, _, dec, tcfg, tp = _reference(False)
    (jl, jc), (tl, tc) = _both_prefill(seq)
    assert tl.shape == (BATCH, 1, tcfg.vocab_size)
    assert _rel(_np32(tl), _np32(jl)) <= 1e-4
    assert set(tc) == set(jc)
    for key in tc:
        assert tc[key].dtype == getattr(torch, str(jc[key].dtype))
        assert _rel(_np32(tc[key]), _np32(jc[key])) <= 1e-4, key
    carried = lm_cache_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                device="cpu")
    for i in range(3):
        tok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        jl, jc = dec(jp, tok, jc, jnp.asarray(seq + i, jnp.int32))
        ttok = torch.from_numpy(np.array(tok)).long()
        tl, tc = tt.decode_step(tcfg, tp, ttok, tc, seq + i)
        xl, carried = tt.decode_step(tcfg, tp, ttok, carried, seq + i)
        assert _rel(_np32(tl), _np32(jl)) <= 1e-4
        assert _rel(_np32(xl), _np32(jl)) <= 1e-4
    for key in tc:
        assert _rel(_np32(tc[key]), _np32(jc[key])) <= 1e-4, key


def test_forward_logits_match_reference():
    jcfg, jp, _, _, tcfg, tp = _reference(False)
    toks = _prompts(jcfg.vocab_size, 128)
    jl, jaux = jax.jit(functools.partial(jforward, jcfg))(
        jp, jnp.asarray(toks))
    tl, taux = tt.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert tl.shape == (BATCH, 128, tcfg.vocab_size)
    assert _rel(_np32(tl), _np32(jl)) <= 1e-4
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("seq", [128, 24])
def test_bf16_prefill_matches_reference(seq):
    """bf16 prefill, the shared attention's wq damped (module docstring).
    Off the TPU the JAX package leaves a bf16 SSM state in the cache whose
    ``make_cache`` declares float32 (its ``ssd_chunked`` keeps the state in
    x's type); the port keeps float32, as the TPU kernel does."""
    (jl, jc), (tl, tc) = _both_prefill(seq, bf16=True, damp=0.125)
    assert jmake_cache(_configs(True)[0], 1, 8)["state"].dtype == jnp.float32
    assert jc["state"].dtype == jnp.bfloat16
    assert tc["state"].dtype == torch.float32
    assert _rel(_np32(tl), _np32(jl)) <= 0.1
    for key in tc:
        assert _rel(_np32(tc[key]), _np32(jc[key])) <= 0.1, key


def test_the_stack_scans_each_block_once_and_attends_once_per_group(
        monkeypatch):
    """Per prefill: one SSD scan per Mamba2 block (4) and one attention per
    group (2: the flash path at S 128, none at S 24); a decode step runs no
    scan and no flash attention."""
    jcfg, jp, _, _, tcfg, tp = _reference(False)
    scans, flashes = [], []
    plain_ssd, plain_flash = ops.ssd_scan_plain, ops.flash_attention_fwd_plain

    def counted_ssd(*args, **kw):
        scans.append(kw["chunk"])
        return plain_ssd(*args, **kw)

    def counted_flash(*args, **kw):
        flashes.append(args[0].shape)
        return plain_flash(*args, **kw)

    monkeypatch.setattr(ops, "ssd_scan_plain", counted_ssd)
    monkeypatch.setattr(ops, "flash_attention_fwd_plain", counted_flash)
    for seq, chunk, n_flash in ((128, 32, 2), (24, 24, 0)):
        scans.clear()
        flashes.clear()
        cache = tt.make_cache(tcfg, BATCH, seq + 1, device="cpu")
        _, cache = tt.prefill(tcfg, tp, torch.ones(BATCH, seq,
                                                   dtype=torch.long), cache)
        assert scans == [chunk] * tcfg.num_layers
        assert len(flashes) == n_flash
        tt.decode_step(tcfg, tp, torch.ones(BATCH, 1, dtype=torch.long),
                       cache, seq)
        assert scans == [chunk] * tcfg.num_layers
        assert len(flashes) == n_flash
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tt.prefill(tcfg, tp, torch.ones(1, 48, dtype=torch.long),
                   tt.make_cache(tcfg, 1, 48, device="cpu"))


def test_training_the_hybrid_family_raises():
    _, _, _, _, tcfg, tp = _reference(False)
    with pytest.raises(NotImplementedError, match="A11f"):
        tt.forward(tcfg, tp, torch.ones(1, 32, dtype=torch.long),
                   remat="full")


def test_serve_answers_on_the_cpu():
    """``serve`` at the smoke size: greedy tokens, deterministic, the
    hybrid cache filled (float32 state)."""
    cfg = configs.get_smoke_config(NAME)
    prompts = torch.from_numpy(_prompts(cfg.vocab_size, 32)).long()
    res = serve(cfg, prompts, 4, seed=3, device="cpu")
    assert res.tokens.shape == (BATCH, 4)
    assert bool(torch.isfinite(res.prefill_logits).all())
    assert set(res.cache) == {"state", "conv_x", "conv_bc", "attn_k",
                              "attn_v"}
    assert res.cache["state"].dtype == torch.float32
    assert res.cache["attn_k"].shape[0] == 2
    assert float(res.cache["state"].abs().max()) > 0
    again = serve(cfg, prompts, 4, seed=3, device="cpu")
    assert torch.equal(res.tokens, again.tokens)
