"""The port's LM serving slice (``repro_torch.models``, ``configs``,
``training.steps``, ``launch.serve``) against the JAX package at the smoke
configs of the five registered architectures (three dense, two MoE): the
JAX ``init_params`` go through ``convert.lm_params_from_jax``, and both
packages prefill and decode the same numpy prompts.

At prompt 128 the port's prefill attention is the flash path
(``kernels.ops.attention``: on the CPU the kernel's plain version) while
JAX on the CPU takes ``sdpa_ref``; at prompt 32 both take ``sdpa_ref``.

Tolerances, as max|port - jax| / max|jax| (measured on the CPU):
- float32: prefill logits and cache within 1e-4 (measured 1.5e-5 / 3.5e-6),
  8 greedy decode steps' logits within 2e-4 (measured 4.2e-5), every
  greedy token equal;
- bfloat16 (Yi smoke config with bf16 params and compute): bf16 rounds at
  other places in the two frameworks (XLA fuses elementwise chains in
  float32), so greedy tokens may part; decode is teacher-forced with JAX's
  tokens. Prompt 32, both ``sdpa_ref``: prefill logits within 1e-2
  (measured 3.7e-3), decode logits within 0.1 (measured 3.6e-2). Prompt
  128: the port's ``attn_impl="ref"`` within 1e-2 (measured 4.0e-3), its
  flash path within 0.1 (measured 2.8e-2: the flash numerics keep the
  probabilities in float32 where ``sdpa_ref`` rounds them to bf16);
- ``rmsnorm``, ``apply_rope``, ``ffn_apply`` within 1e-6 (measured
  1.1e-7), bf16 ``rmsnorm`` equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import base as jbase
from repro.models import ffn as jffn
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import make_cache as jmake_cache
from repro.models import model_defs as jmodel_defs
from repro.models import prefill as jprefill
from repro.models.transformer import cache_spec as jcache_spec
from repro_torch import configs
from repro_torch.convert import lm_cache_from_jax, lm_params_from_jax
from repro_torch.launch.serve import serve
from repro_torch.models import attention as tattn
from repro_torch.models import base as tbase
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as tt
from repro_torch.models.base import ArchConfig, MLAConfig, MoEConfig, \
    SSMConfig, init_params, iter_defs

ARCHS = ["yi-9b", "codeqwen1.5-7b", "phi4-mini-3.8b", "deepseek-moe-16b",
         "arctic-480b"]
BATCH, GEN = 2, 8


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _configs(name: str, bf16: bool = False) -> tuple:
    jcfg, tcfg = jconfigs.get_smoke_config(name), \
        configs.get_smoke_config(name)
    if bf16:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16,
                                   compute_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16,
                                   compute_dtype=torch.bfloat16)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _reference(name: str, bf16: bool):
    """JAX config, parameters (the QKV biases made nonzero, so that the
    bias branch is read) and jitted prefill/decode; the port's config and
    the same parameters."""
    jcfg, tcfg = _configs(name, bf16)
    params = jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0))
    attn = params["layers"]["attn"]
    for key in ("bq", "bk", "bv"):
        if key in attn:
            noise = jax.random.normal(jax.random.PRNGKey(1), attn[key].shape)
            attn[key] = (0.5 * noise).astype(attn[key].dtype)
    pre = jax.jit(lambda p, t, c: jprefill(jcfg, p, t, c))
    dec = jax.jit(lambda p, t, c, i: jdecode_step(jcfg, p, t, c, i))
    tparams = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return jcfg, params, pre, dec, tcfg, tparams


def _prompts(vocab: int, seq: int) -> np.ndarray:
    return np.random.default_rng(seq).integers(
        1, vocab, (BATCH, seq)).astype(np.int32)


def _both_prefill(name, seq, bf16=False, attn_impl="auto"):
    jcfg, jp, pre, _, tcfg, tp = _reference(name, bf16)
    toks = _prompts(jcfg.vocab_size, seq)
    jl, jc = pre(jp, jnp.asarray(toks), jmake_cache(jcfg, BATCH, seq + GEN))
    tl, tc = tt.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                        tt.make_cache(tcfg, BATCH, seq + GEN, device="cpu"),
                        attn_impl=attn_impl)
    return (jl, jc), (tl, tc)


# ---------------------------------------------------------------------------
# Definitions
# ---------------------------------------------------------------------------

def _torch_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", ARCHS)
def test_model_tree_matches_reference(name, smoke):
    """Paths, shapes, axes, initializers and dtypes of the parameter and
    cache trees, from the definitions alone (nothing is allocated)."""
    get = "get_smoke_config" if smoke else "get_config"
    jcfg, tcfg = getattr(jconfigs, get)(name), getattr(configs, get)(name)

    def flat(defs, to_name):
        return {path: (tuple(d.shape), tuple(d.axes), d.init,
                       to_name(d.dtype)) for path, d in iter_defs(defs)}

    jflat = dict(
        (tuple(k.key for k in path), (tuple(d.shape), tuple(d.axes), d.init,
                                      np.dtype(d.dtype).name))
        for path, d in jax.tree_util.tree_flatten_with_path(
            jmodel_defs(jcfg),
            is_leaf=lambda x: isinstance(x, jbase.ParamDef))[0])
    assert flat(tt.model_defs(tcfg), _torch_name) == jflat
    jcache = jax.tree_util.tree_map(
        lambda d: (tuple(d.shape), np.dtype(d.dtype).name),
        jcache_spec(jcfg, 3, 40),
        is_leaf=lambda x: isinstance(x, jbase.ParamDef))
    tcache = {k: (tuple(d.shape), _torch_name(d.dtype))
              for k, d in tt.cache_spec(tcfg, 3, 40).items()}
    assert tcache == jcache
    assert tcfg.param_count() == jcfg.param_count()
    meta = tbase.abstract_params(tt.model_defs(tcfg))
    assert meta["embed"]["tok"].device.type == "meta"


def test_yi_9b_is_the_published_size():
    cfg = configs.get_config("yi-9b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (48, 4096, 32, 4, 128, 11008, 64000)
    assert cfg.param_dtype == cfg.compute_dtype == torch.bfloat16
    assert cfg.param_count() == 8_829_407_232
    assert tbase.param_bytes(tt.model_defs(cfg)) == 2 * 8_829_407_232
    assert configs.SHAPES["prefill_32k"].seq == 32768


def test_deepseek_moe_16b_is_the_published_size():
    cfg = configs.get_config("deepseek-moe-16b")
    m = cfg.moe
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.vocab_size) == \
        (28, 2048, 16, 16, 128, 102400)
    assert (m.num_experts, m.top_k, m.d_ff_expert, m.num_shared_experts,
            m.capacity_factor) == (64, 6, 1408, 2, 1.25)
    assert cfg.param_dtype == cfg.compute_dtype == torch.bfloat16
    assert cfg.param_count() == 16_879_568_896
    assert tbase.param_bytes(tt.model_defs(cfg)) == 2 * 16_879_568_896
    assert MoEConfig(4, 2, 32).router_dtype == torch.float32


@pytest.mark.parametrize("name,row", [
    ("minicpm3-4b", "A11"), ("whisper-large-v3", "A11"),
    ("qwen2-vl-72b", "A11")])
def test_unported_architectures_name_their_roadmap_row(name, row):
    for get in (configs.get_config, configs.get_smoke_config):
        with pytest.raises(NotImplementedError, match=row):
            get(name)
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get_config("gpt-2")


@pytest.mark.parametrize("change,row", [
    ({"attention": "mla", "mla": MLAConfig()}, "A11"),
    ({"encoder_layers": 2}, "A11")])
def test_unported_branches_name_their_roadmap_row(change, row):
    cfg = dataclasses.replace(configs.get_smoke_config("yi-9b"), **change)
    assert isinstance(cfg, ArchConfig)
    for fn in (tt.model_defs, lambda c: tt.cache_spec(c, 1, 8)):
        with pytest.raises(NotImplementedError, match=row):
            fn(cfg)


@pytest.mark.parametrize("case", ["arch", "branch"])
def test_the_hybrid_family_is_ported(case):
    """zamba2-7b's configs load, and the hybrid branch builds its defs and
    cache (a dense config turned hybrid: 2 Mamba2 blocks, the shared
    attention after both)."""
    if case == "arch":
        for get in (configs.get_config, configs.get_smoke_config):
            assert get("zamba2-7b").family == "hybrid"
        assert "zamba2-7b" in configs.ARCH_NAMES
        return
    cfg = dataclasses.replace(configs.get_smoke_config("yi-9b"),
                              family="hybrid", ssm=SSMConfig(chunk=32),
                              hybrid_attn_every=2)
    defs = tt.model_defs(cfg)
    assert set(defs) == {"embed", "layers", "shared_attn", "final_norm",
                         "lm_head"}
    assert set(defs["layers"]) == {"norm", "mamba"}
    cache = tt.make_cache(cfg, 1, 8, device="cpu")
    assert set(cache) == {"state", "conv_x", "conv_bc", "attn_k", "attn_v"}
    assert cache["state"].dtype == torch.float32
    assert cache["attn_k"].shape[0] == cfg.num_layers // 2


@pytest.mark.parametrize("case", ["arch", "branch"])
def test_the_rwkv_family_is_ported(case):
    """rwkv6-3b's configs load, and the ``ssm`` branch builds its defs and
    cache (a dense config turned ``ssm``: time mix with the channel mix's
    ``cm_*`` inside it, a float32 WKV state and the token-shift rows)."""
    if case == "arch":
        for get in (configs.get_config, configs.get_smoke_config):
            assert get("rwkv6-3b").family == "ssm"
        assert "rwkv6-3b" in configs.ARCH_NAMES
        assert "rwkv6-3b" not in configs.NOT_PORTED
        return
    cfg = dataclasses.replace(configs.get_smoke_config("yi-9b"),
                              family="ssm", attention="none",
                              rwkv_head_size=16)
    defs = tt.model_defs(cfg)
    assert set(defs) == {"embed", "layers", "final_norm", "lm_head"}
    assert set(defs["layers"]) == {"tm_norm", "time_mix", "cm_norm"}
    assert {"cm_wk", "cm_wv", "cm_wr", "u", "w_lora_a"} <= \
        set(defs["layers"]["time_mix"])
    cache = tt.make_cache(cfg, 1, 8, device="cpu")
    assert set(cache) == {"state", "tm_last", "cm_last"}
    assert cache["state"].dtype == torch.float32
    assert cache["state"].shape == (cfg.num_layers, 1, 4, 16, 16)


def test_init_params_follows_the_reference_scale_rule():
    cfg = configs.get_smoke_config("codeqwen1.5-7b")
    gen = torch.Generator().manual_seed(0)
    p = init_params(tt.model_defs(cfg), gen, "cpu")
    again = init_params(tt.model_defs(cfg),
                        torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["layers"]["attn"]["wq"], again["layers"]["attn"]["wq"])
    assert torch.equal(p["final_norm"]["scale"], torch.ones(64))
    assert torch.equal(p["layers"]["attn"]["bq"], torch.zeros(2, 4, 16))
    # wq [L, D, H, Dh]: fan_in = shape[-2] = H = 4 -> std 0.5
    assert abs(float(p["layers"]["attn"]["wq"].std()) - 0.5) < 0.02
    assert abs(float(p["embed"]["tok"].std()) - 0.02) < 0.001   # "small"
    assert abs(float(p["layers"]["mlp"]["down"].std())
               - 1 / np.sqrt(128)) < 0.005


# ---------------------------------------------------------------------------
# Numerics alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _np32(jbase.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt),
                               1e-5))
    got = _np32(tbase.rmsnorm(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(scale).to(tdt), 1e-5))
    if dtype == "bfloat16":
        assert np.array_equal(got, want)
    else:
        assert _rel(got, want) <= 1e-6
        lw = jbase.layernorm(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(scale) * 0.1, 1e-5)
        lg = tbase.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(scale) * 0.1, 1e-5)
        assert _rel(_np32(lg), _np32(lw)) <= 1e-6


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1)) + 5
    want = np.asarray(jattn.rope_angles(jnp.asarray(pos), 32, theta))
    got = tattn.rope_angles(torch.from_numpy(pos), 32, theta)
    assert _rel(got.numpy(), want) <= 1e-6
    x = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    assert _rel(tattn.apply_rope(torch.from_numpy(x), got).numpy(),
                np.asarray(jattn.apply_rope(jnp.asarray(x),
                                            jnp.asarray(want)))) <= 1e-6
    with pytest.raises(NotImplementedError, match="A11"):
        tattn.rope_angles(torch.from_numpy(pos), 32, theta, (4, 6, 6))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ffn_matches_reference(act):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("yi-9b"), act=act)
    tcfg = dataclasses.replace(configs.get_smoke_config("yi-9b"), act=act)
    params = jinit_params(jffn.ffn_defs(jcfg), jax.random.PRNGKey(1))
    params = {k: v + 0.1 for k, v in params.items()}      # nonzero biases
    x = np.random.default_rng(2).standard_normal((2, 8, 64)).astype(
        np.float32)
    want = np.asarray(jffn.ffn_apply(jcfg, params, jnp.asarray(x)))
    got = tffn.ffn_apply(tcfg, lm_params_from_jax(params, device="cpu"),
                         torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= 1e-6


# ---------------------------------------------------------------------------
# The slice: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [128, 32])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(name, seq):
    (jl, jc), (tl, tc) = _both_prefill(name, seq)
    assert tl.shape == (BATCH, 1, configs.get_smoke_config(name).vocab_size)
    assert _rel(_np32(tl), _np32(jl)) <= 1e-4
    for key in ("k", "v"):
        assert _rel(_np32(tc[key]), _np32(jc[key])) <= 1e-4


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_decode_matches_reference(name):
    """8 greedy steps after a prompt of 128, each from its own package's
    cache: logits within 2e-4, every token equal."""
    jcfg, jp, _, dec, tcfg, tp = _reference(name, False)
    (jl, jc), (tl, tc) = _both_prefill(name, 128)
    # the JAX cache carried across too: the port's decode from it
    tc_from_jax = lm_cache_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                    device="cpu")
    jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], -1)[:, None]
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    for i in range(GEN):
        jl, jc = dec(jp, jtok, jc, jnp.asarray(128 + i, jnp.int32))
        tl, tc = tt.decode_step(tcfg, tp, ttok, tc, 128 + i)
        xl, tc_from_jax = tt.decode_step(tcfg, tp, ttok, tc_from_jax, 128 + i)
        assert _rel(_np32(tl), _np32(jl)) <= 2e-4
        assert _rel(_np32(xl), _np32(jl)) <= 2e-4
        jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1], -1)[:, None]
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), i
    for key in ("k", "v"):
        assert _rel(_np32(tc[key]), _np32(jc[key])) <= 1e-4


@pytest.mark.parametrize("seq", [32, 128])
def test_bf16_prefill_and_decode_match_reference(seq):
    name = "yi-9b"
    jcfg, jp, _, dec, tcfg, tp = _reference(name, True)
    (jl, jc), (tl, tc) = _both_prefill(name, seq, bf16=True)
    assert tl.dtype == tc["k"].dtype == torch.bfloat16
    if seq == 128:
        assert _rel(_np32(tl), _np32(jl)) <= 0.1           # flash vs ref
        (_, _), (rl, tc) = _both_prefill(name, seq, bf16=True,
                                         attn_impl="ref")
        assert _rel(_np32(rl), _np32(jl)) <= 1e-2
        return
    assert _rel(_np32(tl), _np32(jl)) <= 1e-2
    jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    for i in range(GEN):
        jl, jc = dec(jp, jtok, jc, jnp.asarray(seq + i, jnp.int32))
        tl, tc = tt.decode_step(tcfg, tp, torch.from_numpy(
            np.asarray(jtok, np.int64)), tc, seq + i)
        assert torch.isfinite(tl.float()).all()
        assert _rel(_np32(tl), _np32(jl)) <= 0.1
        jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)


def test_attention_dispatch_follows_the_reference_condition():
    """``sdpa`` takes the flash path exactly when the JAX package would take
    its kernel (aligned lengths, no scale/offset/len): on the CPU that is
    the kernel's plain version, bit for bit."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 128, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 128, 2, 16)).astype(
        np.float32))
    from repro_torch.kernels import ops
    assert torch.equal(tattn.sdpa(q, k, k, causal=True),
                       ops.attention(q, k, k, causal=True))
    ref = tattn.sdpa_ref(q, k, k, causal=True)
    assert torch.equal(tattn.sdpa(q, k, k, causal=True, impl="ref"), ref)
    assert torch.equal(tattn.sdpa(q, k, k, causal=True, scale=0.25),
                       tattn.sdpa_ref(q, k, k, causal=True, scale=0.25))
    assert torch.equal(tattn.sdpa(q[:, :32], k[:, :32], k[:, :32],
                                  causal=True),
                       tattn.sdpa_ref(q[:, :32], k[:, :32], k[:, :32],
                                      causal=True))
    with pytest.raises(NotImplementedError, match="chunked"):
        tattn.sdpa(q, k, k, causal=True, impl="chunked")


def test_serve_answers_on_the_cpu():
    """``serve`` on the smoke config: the greedy tokens of its own prefill
    and decode loop, reproducible from the seed."""
    cfg = configs.get_smoke_config("yi-9b")
    prompts = _prompts(cfg.vocab_size, 128)
    res = serve(cfg, prompts, 4, seed=3, device="cpu")
    assert res.tokens.shape == (BATCH, 4)
    assert res.prefill_logits.shape == (BATCH, 1, cfg.vocab_size)
    assert res.cache["k"].shape == (2, BATCH, 132, 1, 16)
    assert res.prefill_seconds > 0 and res.decode_seconds > 0
    params = init_params(tt.model_defs(cfg),
                         torch.Generator().manual_seed(3), "cpu")
    again = serve(cfg, prompts, 4, params=params, device="cpu")
    assert torch.equal(again.tokens, res.tokens)
    plain = serve(cfg, prompts, 4, params=params, attn_impl="ref",
                  device="cpu")
    assert torch.equal(plain.tokens, res.tokens)
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
