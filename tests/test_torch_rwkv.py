"""The port's RWKV6 slice (``repro_torch.models.rwkv``, the ``ssm`` branch of
``models.transformer``, ``configs/rwkv6_3b.py``) against the JAX package
at rwkv6-3b's smoke config (2 layers, d_model 64, 4 heads of 16): the JAX
``init_params`` (with the token-shift, decay and bonus parameters made
nonzero, so that every term is read) go through
``convert.lm_params_from_jax``, and both packages run the same numpy
inputs. The port's forward scans at chunk ``min(64, S)`` through
``ops.wkv6`` (on the CPU the kernel's plain version), where the JAX package
off the TPU falls back to ``wkv_chunked`` at ``min(32, S)``; both packages'
prefills run ``wkv_chunked`` at ``min(64, S)``.

Tolerances, as max|port - jax| / max|jax| (measured on the CPU):
- ``wkv_chunked`` at chunk 32 from a nonzero state: float32 y and state
  within 1e-5 (measured 2.0e-6 and 1.8e-6); bfloat16 within 2^-8 (measured
  1.1e-4 and 0);
- ``rwkv6_time_mix``, float32 within 2e-5: without a cache (the port's
  chunk 64, JAX's 32) measured 6.6e-6 (3.1e-6 with S 100 padded); a
  prefill from a nonzero state, out 4.2e-6 and state 1.4e-6; a decode
  step, out 1.4e-7 and state 1.3e-7. bfloat16 within 2^-5: measured
  8.8e-3 without a cache, 6.4e-3 and 2.1e-3 for a prefill, 2.5e-3 and
  5.3e-5 for a decode step (bf16 rounds at other places in the two
  frameworks, XLA fusing elementwise chains in float32); the last row
  handed over equal;
- ``rwkv6_channel_mix``: float32 within 1e-6 (measured 1.9e-7); bfloat16
  within 2^-6 (measured 4.4e-3);
- ``forward`` logits float32 within 5e-5 (measured 6.5e-6: the scans' two
  chunkings; the JAX package's own two paths, ``wkv_chunked`` at 32 and its
  kernel at 64 in interpret mode, part by 1.2e-5);
- float32 prefill logits and every cache tensor within 1e-4 (measured
  3.9e-6 and 2.0e-6), 3 decode steps' logits within 1e-4 (measured 6.9e-6;
  from the carried JAX cache 1.2e-6), and the caches after them within
  1e-4 (measured 8.7e-7);
- bfloat16 prefill: logits and caches within 0.05 (measured 9.7e-3 and
  1.8e-2); the state's type after the prefill and after a decode step is
  the reference's, bf16 (the JAX package's ``wkv_chunked`` carries the
  state in r's type; ``make_cache`` declares float32).
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
from repro.models import rwkv as jrwkv
from repro.models.transformer import cache_spec as jcache_spec
from repro_torch import configs
from repro_torch.convert import lm_cache_from_jax, lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve
from repro_torch.models import base as tbase
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as tt
from repro_torch.models.base import iter_defs

NAME = "rwkv6-3b"
BATCH, GEN = 2, 4
#: the time mix's parameters that the reference initializes to zero
NONZERO = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "u", "cm_mu_k",
           "cm_mu_r")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
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
def _reference(bf16: bool):
    """JAX config and parameters (``NONZERO`` given noise of 0.3) and jitted
    prefill/decode; the port's config and the same parameters."""
    jcfg, tcfg = _configs(bf16)
    params = jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0))
    tm = params["layers"]["time_mix"]
    for i, key in enumerate(NONZERO):
        noise = jax.random.normal(jax.random.PRNGKey(10 + i), tm[key].shape)
        tm[key] = (tm[key] + 0.3 * noise).astype(tm[key].dtype)
    pre = jax.jit(lambda p, t, c: jprefill(jcfg, p, t, c))
    dec = jax.jit(lambda p, t, c, i: jdecode_step(jcfg, p, t, c, i))
    tparams = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return jcfg, params, pre, dec, tcfg, tparams


def _prompts(vocab: int, seq: int) -> np.ndarray:
    return np.random.default_rng(seq).integers(
        1, vocab, (BATCH, seq)).astype(np.int32)


def _layer(bf16: bool, index: int = 1) -> tuple:
    """One layer's time-mix parameters in both packages."""
    jcfg, jp, _, _, tcfg, tp = _reference(bf16)
    return (jcfg, jax.tree_util.tree_map(lambda t: t[index],
                                         jp["layers"]["time_mix"]),
            tcfg, {k: v[index] for k, v in tp["layers"]["time_mix"].items()})


def _torch_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _walk(tree, prefix=()):
    """``(path, tensor)`` of every leaf of a nested dict of tensors."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------------------
# Definitions
# ---------------------------------------------------------------------------

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


def test_rwkv6_3b_is_the_published_size():
    """32 layers, d_model 2560 (40 heads of 64), d_ff 8960, vocab 65,536,
    untied; 3,073,313,280 parameters (6.15 GB in bf16), counted on the meta
    device; the serving cache at 4 x (4096 + 8): an 84 MB float32 state."""
    cfg = configs.get_config(NAME)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.d_ff,
            cfg.vocab_size, cfg.attention, cfg.rwkv_head_size) == \
        ("ssm", 32, 2560, 8960, 65536, "none", 64)
    assert trwkv.rwkv_dims(cfg) == (40, 64)
    assert not cfg.tie_embeddings
    assert cfg.param_dtype == cfg.compute_dtype == torch.bfloat16
    leaves = [t for _, t in _walk(tbase.abstract_params(tt.model_defs(cfg)))]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == 3_073_313_280
    assert cfg.param_count() == 3_073_313_280
    assert tbase.param_bytes(tt.model_defs(cfg)) == 2 * 3_073_313_280
    cache = tt.abstract_cache(cfg, 4, 4104)
    assert cache["state"].shape == (32, 4, 40, 64, 64)
    assert cache["state"].dtype == torch.float32
    assert cache["state"].numel() * 4 == 83_886_080
    assert cache["tm_last"].shape == cache["cm_last"].shape == (32, 4, 2560)


def test_convert_carries_every_parameter():
    """``lm_params_from_jax`` on the ``ssm`` tree: the same paths, and every
    leaf equal in value and type, bf16 included."""
    for bf16 in (False, True):
        _, jp, _, _, _, tp = _reference(bf16)
        jflat = {tuple(k.key for k in path): leaf for path, leaf in
                 jax.tree_util.tree_flatten_with_path(jp)[0]}
        tflat = dict(_walk(tp))
        assert set(tflat) == set(jflat)
        for path, leaf in jflat.items():
            assert _torch_name(tflat[path].dtype) == np.dtype(leaf.dtype).name
            assert np.array_equal(_np32(tflat[path]), _np32(leaf)), path


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

def _wkv_inputs(B, S, H, c, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, c)) * 0.5 for _ in range(3))
    logw = -np.exp(np.clip(rng.standard_normal((B, S, H, c)), -8, 6))
    u = rng.standard_normal((H, c)) * 0.5
    state = rng.standard_normal((B, H, c, c)) * 0.5
    return [a.astype(np.float32) for a in (r, k, v, logw, u, state)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_wkv_chunked_matches_reference(bf16):
    """Three chunks of 32 from a nonzero state, in the reference's types:
    y and the final state in r's type."""
    r, k, v, logw, u, state = _wkv_inputs(2, 96, 3, 16, seed=5)
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    jy, js = jrwkv.wkv_chunked(*(jnp.asarray(a, jd) for a in (r, k, v)),
                               jnp.asarray(logw), jnp.asarray(u, jd), 32,
                               init_state=jnp.asarray(state))
    ty, ts = trwkv.wkv_chunked(*(torch.from_numpy(a).to(td)
                                 for a in (r, k, v)),
                               torch.from_numpy(logw),
                               torch.from_numpy(u).to(td), 32,
                               init_state=torch.from_numpy(state))
    assert ty.dtype == ts.dtype == td
    assert _torch_name(ts.dtype) == np.dtype(js.dtype).name
    tol = 2.0 ** -8 if bf16 else 1e-5
    assert _rel(_np32(ty), _np32(jy)) <= tol
    assert _rel(_np32(ts), _np32(js)) <= tol


def test_wkv_chunked_takes_the_chunks_in_groups(monkeypatch):
    """Groups of chunks bounded by ``DECAY_ELEMENTS`` (one chunk, two, all
    three) compute the same function bitwise."""
    r, k, v, logw, u, state = (torch.from_numpy(a)
                               for a in _wkv_inputs(2, 96, 3, 16, seed=6))
    outs = []
    for elements in (1, 2 * 2 * 32 * 32 * 3 * 16, 1 << 27):
        monkeypatch.setattr(trwkv, "DECAY_ELEMENTS", elements)
        outs.append(trwkv.wkv_chunked(r, k, v, logw, u, 32,
                                      init_state=state))
    for y, s in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(s, outs[0][1])


def _time_mix_both(bf16, seq, cached):
    jcfg, jp, tcfg, tp = _layer(bf16)
    H, c = trwkv.rwkv_dims(tcfg)
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((BATCH, seq, jcfg.d_model)).astype(np.float32)
    jcache = tcache = None
    if cached:
        state = (rng.standard_normal((BATCH, H, c, c)) * 0.3) \
            .astype(np.float32)
        last = rng.standard_normal((BATCH, jcfg.d_model)).astype(np.float32)
        jcache = {"state": jnp.asarray(state),
                  "last_x": jnp.asarray(last, jcfg.compute_dtype)}
        tcache = {"state": torch.tensor(state),
                  "last_x": torch.tensor(last).to(tcfg.compute_dtype)}
    jo, jc = jax.jit(lambda p, x, c: jrwkv.rwkv6_time_mix(
        jcfg, p, x, cache=c))(jp, jnp.asarray(x, jcfg.compute_dtype), jcache)
    to, tc = trwkv.rwkv6_time_mix(
        tcfg, tp, torch.from_numpy(x).to(tcfg.compute_dtype), cache=tcache)
    return (jo, jc), (to, tc)


@pytest.mark.parametrize("seq,cached", [(128, False), (100, False),
                                        (100, True), (1, True)],
                         ids=["forward", "forward-padded", "prefill",
                              "decode"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_time_mix_matches_reference(bf16, seq, cached):
    """The forward (no cache; S 100 padded to 128 at chunk 64, to 128 at
    chunk 32 in JAX), a prefill from a nonzero state and last row, and one
    decode step: out, and the state and last row it hands over."""
    (jo, jc), (to, tc) = _time_mix_both(bf16, seq, cached)
    assert tuple(to.shape) == tuple(jo.shape)
    assert _torch_name(to.dtype) == np.dtype(jo.dtype).name
    tol = 2.0 ** -5 if bf16 else 2e-5
    assert _rel(_np32(to), _np32(jo)) <= tol
    if not cached:
        assert tc is None and jc is None
        return
    assert set(tc) == set(jc) == {"state", "last_x"}
    for key in tc:
        assert _torch_name(tc[key].dtype) == np.dtype(jc[key].dtype).name
    assert _rel(_np32(tc["state"]), _np32(jc["state"])) <= tol
    assert np.array_equal(_np32(tc["last_x"]), _np32(jc["last_x"]))


@pytest.mark.parametrize("seq,cached", [(64, False), (64, True), (1, True)],
                         ids=["forward", "prefill", "decode"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_channel_mix_matches_reference(bf16, seq, cached):
    jcfg, jp, tcfg, tp = _layer(bf16)
    rng = np.random.default_rng(seq + 7)
    x = rng.standard_normal((BATCH, seq, jcfg.d_model)).astype(np.float32)
    last = rng.standard_normal((BATCH, jcfg.d_model)).astype(np.float32)
    jcache = {"last_x": jnp.asarray(last, jcfg.compute_dtype)} \
        if cached else None
    tcache = {"last_x": torch.tensor(last).to(tcfg.compute_dtype)} \
        if cached else None
    jo, jc = jax.jit(lambda p, x, c: jrwkv.rwkv6_channel_mix(
        jcfg, p, x, cache=c))(jp, jnp.asarray(x, jcfg.compute_dtype), jcache)
    to, tc = trwkv.rwkv6_channel_mix(
        tcfg, tp, torch.from_numpy(x).to(tcfg.compute_dtype), cache=tcache)
    assert _torch_name(to.dtype) == np.dtype(jo.dtype).name
    assert _rel(_np32(to), _np32(jo)) <= (2.0 ** -6 if bf16 else 1e-6)
    if cached:
        assert np.array_equal(_np32(tc["last_x"]), _np32(jc["last_x"]))
    else:
        assert tc is None and jc is None


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------

def _both_prefill(seq, bf16=False):
    jcfg, jp, pre, _, tcfg, tp = _reference(bf16)
    toks = _prompts(jcfg.vocab_size, seq)
    jl, jc = pre(jp, jnp.asarray(toks), jmake_cache(jcfg, BATCH, seq + GEN))
    tl, tc = tt.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                        tt.make_cache(tcfg, BATCH, seq + GEN, device="cpu"))
    return (jl, jc), (tl, tc)


def test_forward_logits_match_reference():
    jcfg, jp, _, _, tcfg, tp = _reference(False)
    toks = _prompts(jcfg.vocab_size, 128)
    jl, jaux = jax.jit(functools.partial(jforward, jcfg))(
        jp, jnp.asarray(toks))
    tl, taux = tt.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert tl.shape == (BATCH, 128, tcfg.vocab_size)
    assert _rel(_np32(tl), _np32(jl)) <= 5e-5
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("seq", [128, 100])
def test_prefill_and_decode_match_reference(seq):
    """Prefill (S 100 pads to 128), then 3 decode steps teacher-forced with
    JAX's greedy tokens, each package from its own cache; the port also
    decodes from the JAX cache carried across (``lm_cache_from_jax``)."""
    jcfg, jp, _, dec, tcfg, tp = _reference(False)
    (jl, jc), (tl, tc) = _both_prefill(seq)
    assert tl.shape == (BATCH, 1, tcfg.vocab_size)
    assert _rel(_np32(tl), _np32(jl)) <= 1e-4
    assert set(tc) == set(jc) == {"state", "tm_last", "cm_last"}
    for key in tc:
        assert _torch_name(tc[key].dtype) == np.dtype(jc[key].dtype).name
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


def test_bf16_prefill_matches_reference_and_keeps_its_state_type():
    """bf16 prefill: the reference's ``wkv_chunked`` carries the state in
    r's type, so its cache leaves the prefill with a bf16 state where
    ``make_cache`` declares float32, and its decode steps keep it bf16. The
    port's state has the reference's type after both."""
    jcfg, jp, _, dec, tcfg, tp = _reference(True)
    (jl, jc), (tl, tc) = _both_prefill(128, bf16=True)
    assert jmake_cache(jcfg, 1, 8)["state"].dtype == jnp.float32
    assert jc["state"].dtype == jnp.bfloat16
    assert tc["state"].dtype == torch.bfloat16
    assert _rel(_np32(tl), _np32(jl)) <= 0.05
    for key in tc:
        assert _torch_name(tc[key].dtype) == np.dtype(jc[key].dtype).name
        assert _rel(_np32(tc[key]), _np32(jc[key])) <= 0.05, key
    tok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    _, jc = dec(jp, tok, jc, jnp.asarray(128, jnp.int32))
    _, tc = tt.decode_step(tcfg, tp, torch.from_numpy(np.array(tok)).long(),
                           tc, 128)
    assert jc["state"].dtype == jnp.bfloat16
    assert tc["state"].dtype == torch.bfloat16


def test_only_the_forward_runs_the_scan_kernel_path(monkeypatch):
    """Per forward: one ``ops.wkv6`` scan per layer (the kernel's plain
    version on the CPU), at chunk 64 (S 128) or 64 after padding (S 100);
    a prefill and a decode step run none (``wkv_chunked`` and the
    recurrence, as in the JAX package)."""
    _, _, _, _, tcfg, tp = _reference(False)
    scans = []
    plain = ops.wkv6_scan_plain

    def counted(*args, chunk):
        scans.append((args[0].shape[1], chunk))
        return plain(*args, chunk=chunk)

    monkeypatch.setattr(ops, "wkv6_scan_plain", counted)
    L = tcfg.num_layers
    for seq, scanned in ((128, 128), (100, 128), (40, 40)):
        scans.clear()
        tt.forward(tcfg, tp, torch.ones(BATCH, seq, dtype=torch.long))
        assert scans == [(scanned, min(64, seq))] * L
        scans.clear()
        cache = tt.make_cache(tcfg, BATCH, seq + 1, device="cpu")
        _, cache = tt.prefill(tcfg, tp, torch.ones(BATCH, seq,
                                                   dtype=torch.long), cache)
        tt.decode_step(tcfg, tp, torch.ones(BATCH, 1, dtype=torch.long),
                       cache, seq)
        assert scans == []


def test_training_the_ssm_family():
    """``remat`` raises naming A11g (RWKV6 training); without it, on the
    CPU, a gradient flows through the forward."""
    _, _, _, _, tcfg, tp = _reference(False)
    toks = torch.ones(1, 64, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="A11g"):
        tt.forward(tcfg, tp, toks, remat="full")
    w = tp["layers"]["time_mix"]["wk"].clone().requires_grad_()
    params = {**tp, "layers": {**tp["layers"], "time_mix": {
        **tp["layers"]["time_mix"], "wk": w}}}
    tt.forward(tcfg, params, toks)[0].float().square().mean().backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())
    assert float(w.grad.abs().max()) > 0


def test_serve_answers_on_the_cpu():
    """``serve`` at the smoke size: greedy tokens, deterministic, the
    RWKV cache filled."""
    cfg = configs.get_smoke_config(NAME)
    prompts = torch.from_numpy(_prompts(cfg.vocab_size, 40)).long()
    res = serve(cfg, prompts, 4, seed=3, device="cpu")
    assert res.tokens.shape == (BATCH, 4)
    assert bool(torch.isfinite(res.prefill_logits).all())
    assert set(res.cache) == {"state", "tm_last", "cm_last"}
    assert res.cache["state"].dtype == torch.float32
    assert float(res.cache["state"].abs().max()) > 0
    again = serve(cfg, prompts, 4, seed=3, device="cpu")
    assert torch.equal(res.tokens, again.tokens)
